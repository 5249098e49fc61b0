"""Minimal JSON-line RPC over TCP — the framework's host control plane (a copy of
``hops_tpu/messaging/rpc.py``: the module imports no JAX, and the port imports nothing
of the JAX package).

Replaces the Spark driver<->executor RPC channel the reference's maggy
driver used for trial dispatch/heartbeats (SURVEY.md §2.4, §3.3). One
driver-side :class:`RpcServer` with named handlers; executors (threads,
subprocesses, or other hosts) connect with :class:`RpcClient`. Wire
format: one JSON object per line, ``{"method": str, "kwargs": {...}}``
-> ``{"ok": bool, "result"|"error": ...}``.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Any, Callable

from hops_tpu_torch.runtime.logging import get_logger

log = get_logger(__name__)


class RpcServer:
    """Threaded JSON-line RPC server bound to an ephemeral local port."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        handlers: dict[str, Callable[..., Any]] = {}
        self._handlers = handlers

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                for line in self.rfile:
                    try:
                        msg = json.loads(line)
                        fn = handlers[msg["method"]]
                        result = fn(**msg.get("kwargs", {}))
                        reply = {"ok": True, "result": result}
                    except Exception as e:  # noqa: BLE001 — reply, don't kill the server
                        reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    self.wfile.write((json.dumps(reply) + "\n").encode())
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    def register(self, method: str, fn: Callable[..., Any]) -> None:
        self._handlers[method] = fn

    def start(self) -> "RpcServer":
        self._thread.start()
        return self

    @property
    def address(self) -> tuple[str, int]:
        return self._server.server_address

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class RpcClient:
    """Blocking JSON-line RPC client; one socket per client, thread-safe."""

    def __init__(self, address: tuple[str, int], timeout: float = 10.0):
        self._sock = socket.create_connection(address, timeout=timeout)
        self._file = self._sock.makefile("rwb")
        self._lock = threading.Lock()

    def call(self, method: str, **kwargs: Any) -> Any:
        payload = (json.dumps({"method": method, "kwargs": kwargs}) + "\n").encode()
        with self._lock:
            self._file.write(payload)
            self._file.flush()
            line = self._file.readline()
        if not line:
            raise ConnectionError("rpc server closed connection")
        reply = json.loads(line)
        if not reply["ok"]:
            raise RuntimeError(f"rpc {method} failed: {reply['error']}")
        return reply["result"]

    def close(self) -> None:
        try:
            self._file.close()
        finally:
            self._sock.close()
