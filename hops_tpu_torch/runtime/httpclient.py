"""Pooled keep-alive HTTP client for the fleet's loopback control plane
(a copy of ``hops_tpu/runtime/httpclient.py``: the module imports no JAX, and
the port imports nothing of the JAX package).

The serving stack's cross-process hops (router→replica forwards,
``/metrics.json`` scrapes, shadow probes, hedges) all used
``urllib.request.urlopen``, which opens and tears down a TCP connection
per call — the dominant per-hop cost once the relay went zero-copy.
This module is the fix: a thread-safe pool of persistent
``http.client.HTTPConnection`` objects keyed by ``(host, port)``.

Semantics the callers rely on:

- **An explicit timeout on every request** (keyword-only — the fleet's
  ``blocking-call-no-deadline`` discipline). The timeout is applied to
  the pooled socket per request, so a connection checked out for a
  30 s forward and later reused for a 0.5 s scrape honors each budget.
- **Status codes are data, not exceptions.** 4xx/5xx return like 2xx
  — exactly the router relay's contract (urllib's ``HTTPError``
  special-casing disappears). Only transport failures raise, and they
  raise ``OSError`` subclasses (``http.client`` protocol errors are
  wrapped), so every existing ``except (OSError, ...)`` retry path
  catches pool errors unchanged.
- **Stale keep-alives retry once.** A server may close an idle pooled
  connection at any time; a send/recv failure on a REUSED connection
  retries once on a fresh one before surfacing. A failure on a fresh
  connection is real and raises immediately. Requests through this
  pool must therefore stay idempotent (predict is; scrapes are) —
  the same contract the router's retry-elsewhere policy already set.
- **Hedging rides the same pool**: a hedge checks out its own
  connection, so the second attempt never pays a handshake and never
  shares a socket with the primary.

The server side of the bargain: the router and serving handlers declare
``protocol_version = "HTTP/1.1"`` and always send Content-Length, so
connections actually survive between requests.

Every exchange first passes the ``transport.send`` fault point
(:func:`faultinject.fire_transport`) under the pool's ``identity`` as
the source — the seam where the deterministic network-partition
simulator cuts links (docs/operations.md "Partition tolerance &
fencing"). Disarmed, that is one ``is None`` test.
"""

from __future__ import annotations

import http.client
import socket
import threading
from typing import Any, Mapping
from urllib.parse import urlsplit

from hops_tpu_torch.runtime import faultinject
from hops_tpu_torch.runtime.logging import get_logger

log = get_logger(__name__)


class HTTPPool:
    """Persistent-connection pool; one instance per client (the router
    owns one). ``max_idle_per_host`` bounds parked connections per
    ``(host, port)`` — extras close instead of parking. ``identity``
    names this pool as the SOURCE side of partition keys
    (``src->dst``); give each logical client its own so asymmetric
    cuts can tell the router from a hostd from a bench client."""

    def __init__(self, max_idle_per_host: int = 8, *,
                 identity: str = "client"):
        self.max_idle_per_host = max_idle_per_host
        self.identity = identity
        self._lock = threading.Lock()
        self._idle: dict[tuple[str, int], list[http.client.HTTPConnection]] = {}  # guarded by: self._lock
        self._closed = False  # guarded by: self._lock
        self.reused = 0  # connections served from the pool (telemetry)
        self.created = 0

    # -- connection checkout/checkin ------------------------------------------

    def _checkout(self, host: str, port: int,
                  timeout_s: float) -> tuple[http.client.HTTPConnection, bool]:
        with self._lock:
            stack = self._idle.get((host, port))
            conn = stack.pop() if stack else None
            if conn is not None:
                self.reused += 1
        if conn is not None:
            conn.timeout = timeout_s
            if conn.sock is not None:
                conn.sock.settimeout(timeout_s)
            return conn, True
        with self._lock:
            self.created += 1
        return http.client.HTTPConnection(host, port, timeout=timeout_s), False

    def _checkin(self, host: str, port: int,
                 conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if not self._closed:
                stack = self._idle.setdefault((host, port), [])
                if len(stack) < self.max_idle_per_host:
                    stack.append(conn)
                    return
        conn.close()

    # -- the request ----------------------------------------------------------

    def request(
        self,
        method: str,
        url: str,
        body: bytes | None = None,
        headers: Mapping[str, str] | None = None,
        *,
        timeout_s: float,
    ) -> tuple[int, bytes, dict[str, str]]:
        """One HTTP exchange; returns ``(status, body, headers)`` with
        4xx/5xx as data. Transport failures raise OSError subclasses."""
        parts = urlsplit(url)
        host = parts.hostname or "127.0.0.1"
        port = parts.port or 80
        path = parts.path or "/"
        if parts.query:
            path = f"{path}?{parts.query}"
        faultinject.fire_transport(self.identity, f"{host}:{port}")
        last_exc: Exception | None = None
        for fresh_retry in (False, True):
            conn, reused = self._checkout(host, port, timeout_s)
            try:
                if conn.sock is None:
                    # http.client sends headers and body as separate
                    # writes; with Nagle on, the body write stalls for
                    # the peer's delayed ACK (~40 ms) once the
                    # connection leaves quickack mode — on reused
                    # keep-alives that stall dwarfs the request itself.
                    conn.connect()
                    conn.sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.request(method, path, body=body, headers=dict(headers or {}))
                resp = conn.getresponse()
                data = resp.read()
                hdrs = dict(resp.headers.items())
                if resp.will_close:
                    conn.close()
                else:
                    self._checkin(host, port, conn)
                return resp.status, data, hdrs
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                if (reused and not fresh_retry
                        and not isinstance(e, TimeoutError)):
                    # A parked keep-alive the server closed under us:
                    # not a peer failure — retry once on a fresh
                    # connection before letting the caller's retry /
                    # breaker policy see anything. A TIMEOUT is
                    # excluded: that is the peer being slow, and a
                    # retry would double the caller's deadline and
                    # re-send the request to the very peer that is
                    # already drowning.
                    last_exc = e
                    continue
                if isinstance(e, http.client.HTTPException):
                    raise ConnectionError(
                        f"http protocol failure talking to "
                        f"{host}:{port}: {type(e).__name__}: {e}"
                    ) from e
                raise
        raise ConnectionError(  # pragma: no cover — loop always returns/raises
            f"connection to {host}:{port} failed: {last_exc}"
        ) from last_exc

    # -- multiplexing: pipelined batches --------------------------------------

    @staticmethod
    def _split(url: str) -> tuple[str, int, str]:
        parts = urlsplit(url)
        path = parts.path or "/"
        if parts.query:
            path = f"{path}?{parts.query}"
        return parts.hostname or "127.0.0.1", parts.port or 80, path

    def pipeline(
        self,
        requests: "list[tuple[str, str, bytes | None, Mapping[str, str] | None]]",
        *,
        timeout_s: float,
    ) -> list[tuple[int, bytes, dict[str, str]]]:
        """In-flight HTTP/1.1 pipelining on ONE pooled connection: every
        request in the batch — ``(method, url, body, headers)`` tuples,
        all on the same ``(host, port)`` — is written back-to-back
        before the first response is read, then responses are read in
        request order. One syscall burst and one connection for a whole
        scrape/probe batch instead of a request-response round trip
        each (the event-loop server core parses and answers pipelined
        requests in order; see ``runtime/httpserver``).

        All-or-nothing: any transport failure raises for the whole
        batch (an ``OSError`` subclass, like :meth:`request`) — callers
        that need per-request isolation use :meth:`get_many`, which
        falls back to sequential requests. Batches must therefore stay
        idempotent, the same contract as the stale-keep-alive retry."""
        if not requests:
            return []
        host, port, _ = self._split(requests[0][1])
        wire = bytearray()
        methods: list[str] = []
        for method, url, body, headers in requests:
            h, p, path = self._split(url)
            if (h, p) != (host, port):
                raise ValueError(
                    f"pipeline batch spans hosts: {host}:{port} vs {h}:{p}")
            methods.append(method)
            lines = [f"{method} {path} HTTP/1.1\r\n", f"Host: {host}:{port}\r\n"]
            for k, v in dict(headers or {}).items():
                lines.append(f"{k}: {v}\r\n")
            if body is not None or method in ("POST", "PUT", "PATCH"):
                lines.append(f"Content-Length: {len(body or b'')}\r\n")
            lines.append("\r\n")
            wire += "".join(lines).encode("latin-1")
            if body:
                wire += body
        faultinject.fire_transport(self.identity, f"{host}:{port}")
        conn, reused = self._checkout(host, port, timeout_s)
        try:
            if conn.sock is None:
                conn.connect()
                conn.sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.sock.settimeout(timeout_s)
            conn.sock.sendall(wire)
            out: list[tuple[int, bytes, dict[str, str]]] = []
            will_close = False
            # One shared buffered reader for the whole batch:
            # a fresh HTTPResponse per response would each wrap the
            # socket in its OWN buffer and swallow the next pipelined
            # response's bytes.
            fp = conn.sock.makefile("rb")
            try:
                for _ in methods:
                    status_line = fp.readline(65536)
                    parts = status_line.split(None, 2)
                    if len(parts) < 2 or not parts[0].startswith(b"HTTP/"):
                        raise http.client.BadStatusLine(
                            status_line.decode("latin-1", "replace"))
                    status = int(parts[1])
                    msg = http.client.parse_headers(fp)
                    if "chunked" in (
                            msg.get("Transfer-Encoding") or "").lower():
                        raise http.client.HTTPException(
                            "chunked responses are not pipelinable here")
                    length = int(msg.get("Content-Length") or 0)
                    data = fp.read(length) if length else b""
                    if length and len(data) < length:
                        raise http.client.IncompleteRead(data, length)
                    out.append((status, data, dict(msg.items())))
                    will_close = will_close or (
                        (msg.get("Connection") or "").lower() == "close"
                        or parts[0] == b"HTTP/1.0")
            finally:
                fp.close()  # drops the buffer; conn still owns the socket
            if will_close:
                conn.close()
            else:
                self._checkin(host, port, conn)
            return out
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            if isinstance(e, http.client.HTTPException):
                raise ConnectionError(
                    f"http protocol failure pipelining to "
                    f"{host}:{port}: {type(e).__name__}: {e}"
                ) from e
            raise

    def get_many(
        self,
        requests: "list[tuple[str, str, bytes | None, Mapping[str, str] | None]]",
        *,
        timeout_s: float,
    ) -> "list[tuple[int, bytes, dict[str, str]] | Exception]":
        """Coalesced batch fetch: requests to the same ``(host, port)``
        are pipelined on one pooled connection; distinct hosts run
        concurrently (one thread per host group). Returns a list
        aligned with ``requests`` where each entry is ``(status, body,
        headers)`` or the ``Exception`` that request raised — one bad
        peer never fails its batch-mates. A pipelined group that fails
        at the transport falls back to per-request :meth:`request`
        (idempotency required, as everywhere in this pool)."""
        results: list[Any] = [None] * len(requests)
        groups: dict[tuple[str, int], list[int]] = {}
        for i, (_, url, _, _) in enumerate(requests):
            host, port, _ = self._split(url)
            groups.setdefault((host, port), []).append(i)

        def run_group(idxs: list[int]) -> None:
            if len(idxs) > 1:
                try:
                    outs = self.pipeline(
                        [requests[i] for i in idxs], timeout_s=timeout_s)
                except OSError:
                    pass  # degrade to per-request isolation below
                else:
                    for i, out in zip(idxs, outs):
                        results[i] = out
                    return
            for i in idxs:
                method, url, body, headers = requests[i]
                try:
                    results[i] = self.request(
                        method, url, body=body, headers=headers,
                        timeout_s=timeout_s)
                except OSError as e:
                    results[i] = e

        grouped = list(groups.values())
        if len(grouped) <= 1:
            for idxs in grouped:
                run_group(idxs)
            return results
        threads = [
            threading.Thread(target=run_group, args=(idxs,), daemon=True)
            for idxs in grouped
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results

    def idle_count(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._idle.values())

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = [c for stack in self._idle.values() for c in stack]
            self._idle.clear()
        for c in conns:
            c.close()
