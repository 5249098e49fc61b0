"""Event-loop HTTP/1.1 server core — the one transport under every
server in the stack (a copy of ``hops_tpu/runtime/httpserver.py``: the
module imports no JAX, and the port imports nothing of the JAX package).

With a zero-copy relay and a client that pools keep-alives, the
dominant per-hop cost left on the CPU tier was the stdlib
``http.server`` transport itself: per-connection thread churn, ``readline``-based
header parsing through a buffered file object, an ``email.parser``
instantiation per request, and a ``strftime`` per response. The same
``ThreadingHTTPServer + BaseHTTPRequestHandler`` pattern was
copy-instantiated at five sites (serving replicas, the fleet router,
hostd, shardd, the metrics server). This module replaces all five with
one selector-based core:

- **One IO event loop** (``selectors.DefaultSelector`` — epoll on
  Linux, kqueue on BSD/mac) owns the listening socket and every
  connection. Accepts, reads, and writes are all non-blocking; a slow
  peer never holds a thread.
- **Incremental parsing into per-connection buffers.** Bytes land in a
  reusable receive buffer (``recv_into``) and accumulate per
  connection; the parser finds complete header blocks / bodies
  incrementally, so a slowloris-shaped client (one header byte per
  RTT) costs one buffer, not one thread — and is evicted by the idle
  sweep when it overstays ``idle_timeout_s``.
- **Persistent connections with pipelined request queuing.** HTTP/1.1
  keep-alive is the default; a client may send N requests
  back-to-back and the parser queues them all. Responses are written
  strictly in request order per connection (the pipelining contract):
  a response that finishes out of order parks until its predecessors
  are on the wire.
- **Responses as preassembled byte vectors.** A handler returns body
  *bytes*; the core writes ``[header block, body]`` as two
  memoryview-tracked segments and never copies or re-serializes the
  body — the zero-copy relay contract (router bodies pass through
  verbatim) survives the transport.
- **A bounded worker pool runs handlers off the IO loop.** ``workers``
  threads drain a shared FIFO of parsed requests, so a slow predict
  stalls neither accepts nor other connections' reads. The pool is the
  explicit capacity bound the thread-per-connection model never had.

The handler contract (one function per server)::

    route(method, path, headers, body) -> (status, headers, body_bytes)

``headers`` in is a case-insensitive read view of the request headers;
``headers`` out is a plain dict — ``Content-Length`` is computed by the
core (framing is the transport's job; everything else relays verbatim).
A route may return a 4-tuple ``(status, headers, body, after)`` where
``after()`` runs in the worker after the response is queued for write
but before the IO loop is woken to send it — the post-reply hook the
capture taps and shadow probes use (the old handlers ran these after
``wfile.write``; queuing-before-hook keeps response assembly off the
hook's clock while still sequencing the hook before the client can
observe the reply).

Observability: ``hops_tpu_http_connections_total`` /
``hops_tpu_http_requests_total`` / ``hops_tpu_http_keepalive_reuse_total``
/ ``hops_tpu_http_pipelined_requests_total`` /
``hops_tpu_http_open_connections`` (docs/operations.md "Serving
transport"). The JAX package's tests/test_httpserver.py pins the
edge cases (slowloris, pipelining order, mid-response disconnect,
keep-alive reuse).
"""

from __future__ import annotations

import json
import selectors
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator, Mapping

from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

_m_connections = REGISTRY.counter(
    "hops_tpu_http_connections_total",
    "TCP connections accepted by the event-loop HTTP core, per server",
    labels=("server",),
)
_m_requests = REGISTRY.counter(
    "hops_tpu_http_requests_total",
    "Requests parsed and dispatched by the event-loop HTTP core",
    labels=("server",),
)
_m_reuse = REGISTRY.counter(
    "hops_tpu_http_keepalive_reuse_total",
    "Requests served on an already-used (kept-alive) connection",
    labels=("server",),
)
_m_pipelined = REGISTRY.counter(
    "hops_tpu_http_pipelined_requests_total",
    "Requests that arrived while an earlier request on the same "
    "connection was still in flight (client-side pipelining)",
    labels=("server",),
)
_m_open = REGISTRY.gauge(
    "hops_tpu_http_open_connections",
    "Currently open connections on the event-loop HTTP core",
    labels=("server",),
)

#: (status, headers, body) or (status, headers, body, after_callable).
RouteResult = tuple
Route = Callable[..., RouteResult]

_REASONS = {
    200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
    403: "Forbidden", 404: "Not Found", 408: "Request Timeout",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 501: "Not Implemented",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


class HeaderView(Mapping[str, str]):
    """Case-insensitive read-only view of one request's headers.

    The stdlib handlers exposed ``email.message.Message`` (case
    insensitive); every ported route keeps that lookup behavior without
    paying an ``email.parser`` per request."""

    __slots__ = ("_d",)

    def __init__(self, items: dict[str, str]):
        self._d = items  # keys already lowercased by the parser

    def get(self, key: str, default: Any = None) -> Any:
        return self._d.get(key.lower(), default)

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()]

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and key.lower() in self._d

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def items(self):  # type: ignore[override]
        return self._d.items()


def assemble(status: int, headers: Mapping[str, str] | None,
             body: bytes) -> list[bytes]:
    """Preassemble one response as ``[header block, body]`` byte
    vectors. ``Content-Length`` and ``Connection`` are the core's
    (framing); caller headers relay verbatim — the body is NEVER
    touched (zero-copy relay contract)."""
    reason = _REASONS.get(status, "Unknown")
    parts = [f"HTTP/1.1 {status} {reason}\r\n"]
    for k, v in (headers or {}).items():
        parts.append(f"{k}: {v}\r\n")
    parts.append(f"Content-Length: {len(body)}\r\n\r\n")
    return ["".join(parts).encode("latin-1"), body]


class _Request:
    __slots__ = ("method", "path", "headers", "body", "close_after", "seq")

    def __init__(self, method: str, path: str, headers: HeaderView,
                 body: bytes, close_after: bool, seq: int):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body
        self.close_after = close_after  # client asked Connection: close
        self.seq = seq  # per-connection order responses must follow


class _Connection:
    """One accepted socket: its parse buffer, its in-order response
    ledger, and its write cursor. All fields are touched only on the IO
    loop thread except ``done`` (workers fill it under the server's
    response lock)."""

    __slots__ = ("sock", "addr", "inbuf", "served", "next_seq", "next_write",
                 "done", "outq", "out_off", "close_when_drained",
                 "last_activity", "inflight", "broken", "partial_since")

    def __init__(self, sock: socket.socket, addr: Any):
        self.sock = sock
        self.addr = addr
        self.inbuf = bytearray()
        self.served = 0  # requests parsed on this connection
        self.next_seq = 0  # seq for the next parsed request
        self.next_write = 0  # seq whose response goes on the wire next
        self.done: dict[int, tuple[list[bytes], bool]] = {}
        self.outq: deque[memoryview] = deque()
        self.out_off = 0  # bytes of outq[0] already sent
        self.close_when_drained = False
        self.last_activity = time.monotonic()
        self.inflight = 0  # requests handed to workers, not yet written
        self.broken = False  # a 400 was queued; parse no further
        self.partial_since: float | None = None  # incomplete request started


class BadRequest(ValueError):
    """The peer sent bytes that do not parse as HTTP/1.1."""


class HTTPServer:
    """The shared selector-based server core (see module docstring).

    ``route`` is the single handler; ``workers`` bounds handler
    concurrency; ``backlog`` is the listen queue; ``max_pipeline``
    bounds requests queued per connection before reads pause
    (pushback on an abusive pipeliner); ``idle_timeout_s`` evicts
    connections with no completed request and no arriving bytes —
    the slowloris bound. Serving starts in ``__init__``; ``stop()``
    tears everything down."""

    def __init__(
        self,
        route: Route,
        *,
        bind: str = "127.0.0.1",
        port: int = 0,
        name: str = "http",
        workers: int = 16,
        backlog: int = 128,
        max_pipeline: int = 64,
        max_header_bytes: int = 64 * 1024,
        max_body_bytes: int = 256 * 1024 * 1024,
        idle_timeout_s: float = 120.0,
    ):
        self.route = route
        self.name = name
        self.max_pipeline = max_pipeline
        self.max_header_bytes = max_header_bytes
        self.max_body_bytes = max_body_bytes
        self.idle_timeout_s = idle_timeout_s
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((bind, port))
        self._listener.listen(backlog)
        self._listener.setblocking(False)
        self.host, self.port = self._listener.getsockname()[:2]
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, None)
        # Self-pipe: workers wake the IO loop when a response is ready.
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._lock = threading.Lock()
        self._stopping = False  # guarded by: self._lock
        self._ready: list[tuple[_Connection, int, list[bytes], bool]] = []  # guarded by: self._lock
        self._conns: set[_Connection] = set()  # IO-loop thread only
        self._qcond = threading.Condition()
        self._queue: deque[tuple[_Connection, _Request]] = deque()  # guarded by: self._qcond
        self._recv_buf = bytearray(256 * 1024)  # one reusable recv window
        self._m_conns = _m_connections.labels(server=name)
        self._m_reqs = _m_requests.labels(server=name)
        self._m_reuse = _m_reuse.labels(server=name)
        self._m_pipe = _m_pipelined.labels(server=name)
        self._m_open = _m_open.labels(server=name)
        self._workers = [
            threading.Thread(target=self._worker, name=f"{name}-worker-{i}",
                             daemon=True)
            for i in range(max(1, workers))
        ]
        for t in self._workers:
            t.start()
        self._io_thread = threading.Thread(
            target=self._io_loop, name=f"{name}-io", daemon=True)
        self._io_thread.start()

    # -- endpoint surface ------------------------------------------------------

    def endpoint(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- the IO loop -----------------------------------------------------------

    def _io_loop(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    break
            try:
                events = self._sel.select(timeout=0.5)
            except OSError:
                break
            for key, mask in events:
                if key.data is None:
                    self._accept()
                elif key.data == "wake":
                    try:
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                else:
                    conn: _Connection = key.data
                    if mask & selectors.EVENT_READ:
                        self._readable(conn)
                    if mask & selectors.EVENT_WRITE and conn.sock.fileno() != -1:
                        self._flush(conn)
            self._drain_ready()
            self._sweep_idle()
        # Teardown on the loop thread: close every socket exactly once.
        for conn in list(self._conns):
            self._close(conn)
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        self._listener.close()
        try:
            self._sel.unregister(self._wake_r)
        except (KeyError, ValueError):
            pass
        self._wake_r.close()
        self._sel.close()

    def _accept(self) -> None:
        for _ in range(64):  # bounded accept burst per wakeup
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Connection(sock, addr)
            self._conns.add(conn)
            self._sel.register(sock, selectors.EVENT_READ, conn)
            self._m_conns.inc()
            self._m_open.set(len(self._conns))

    def _readable(self, conn: _Connection) -> None:
        try:
            n = conn.sock.recv_into(self._recv_buf)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if n == 0:  # orderly EOF from the peer
            if not conn.outq and conn.inflight == 0:
                self._close(conn)
            else:
                conn.close_when_drained = True
            return
        conn.last_activity = time.monotonic()
        if conn.broken:
            return  # a 400 is on its way; discard whatever follows
        conn.inbuf += self._recv_buf[:n]
        try:
            self._parse(conn)
        except BadRequest as e:
            self._respond_now(conn, 400, str(e))
        except Exception as e:  # noqa: BLE001 — a parse bug must not kill the loop
            log.warning("%s: parse failure from %s: %s: %s",
                        self.name, conn.addr, type(e).__name__, e)
            self._respond_now(conn, 400, "malformed request")

    def _parse(self, conn: _Connection) -> None:
        """Lift every complete request out of the connection buffer."""
        while True:
            if conn.inflight >= self.max_pipeline:
                return  # pushback: finish some responses first
            buf = conn.inbuf
            if not buf:
                conn.partial_since = None
                return
            head_end = buf.find(b"\r\n\r\n")
            if head_end < 0:
                if len(buf) > self.max_header_bytes:
                    raise BadRequest("header block too large")
                if conn.partial_since is None:
                    conn.partial_since = time.monotonic()
                return
            head = bytes(buf[:head_end])
            lines = head.split(b"\r\n")
            try:
                method_b, path_b, version_b = lines[0].split(b" ", 2)
            except ValueError:
                raise BadRequest("malformed request line") from None
            if not version_b.startswith(b"HTTP/1."):
                raise BadRequest(f"unsupported version {version_b[:20]!r}")
            headers: dict[str, str] = {}
            for line in lines[1:]:
                if not line:
                    continue
                k, sep, v = line.partition(b":")
                if not sep:
                    raise BadRequest("malformed header line")
                headers[k.decode("latin-1").strip().lower()] = (
                    v.decode("latin-1").strip())
            if "transfer-encoding" in headers:
                # The pool/clients always frame with Content-Length;
                # chunked decode is complexity none of the five sites
                # needs. Refuse loudly rather than misparse.
                raise BadRequest("chunked transfer encoding unsupported")
            try:
                length = int(headers.get("content-length", "0") or "0")
            except ValueError:
                raise BadRequest("malformed Content-Length") from None
            if length < 0 or length > self.max_body_bytes:
                raise BadRequest("body too large")
            total = head_end + 4 + length
            if len(buf) < total:
                if conn.partial_since is None:
                    conn.partial_since = time.monotonic()
                return  # body still arriving
            body = bytes(buf[head_end + 4:total])
            del buf[:total]
            conn.partial_since = None
            close_after = (
                headers.get("connection", "").lower() == "close"
                or version_b == b"HTTP/1.0"
            )
            req = _Request(method_b.decode("latin-1"),
                           path_b.decode("latin-1"), HeaderView(headers),
                           body, close_after, conn.next_seq)
            conn.next_seq += 1
            if conn.served > 0:
                self._m_reuse.inc()
            if conn.inflight > 0:
                self._m_pipe.inc()
            conn.served += 1
            conn.inflight += 1
            self._m_reqs.inc()
            with self._qcond:
                self._queue.append((conn, req))
                self._qcond.notify()

    def _respond_now(self, conn: _Connection, status: int, msg: str) -> None:
        """IO-loop-side error reply (parse failures): queue a canned
        response at the next write slot and close after the drain."""
        body = json.dumps({"error": msg}).encode()
        vec = assemble(status, {"Content-Type": "application/json"}, body)
        with self._lock:
            self._ready.append((conn, conn.next_seq, vec, True))
        conn.next_seq += 1
        conn.inflight += 1
        conn.broken = True
        conn.inbuf.clear()  # poisoned stream: parse no further
        self._drain_ready()

    # -- workers ---------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._qcond:
                while not self._queue:
                    with self._lock:
                        if self._stopping:
                            return
                    self._qcond.wait(timeout=0.5)
                conn, req = self._queue.popleft()
            with self._lock:
                if self._stopping:
                    return
            after = None
            try:
                result = self.route(req.method, req.path, req.headers,
                                    req.body)
                if len(result) == 4:
                    status, hdrs, body, after = result
                else:
                    status, hdrs, body = result
                if not isinstance(body, (bytes, bytearray, memoryview)):
                    raise TypeError(
                        f"route returned {type(body).__name__} body; the "
                        "transport relays bytes only")
                vec = assemble(int(status), hdrs, bytes(body))
            except Exception as e:  # noqa: BLE001 — a handler fault must reach
                # the client as a 500 (breaker food), never kill the worker
                log.warning("%s: handler %s %s failed: %s: %s", self.name,
                            req.method, req.path, type(e).__name__, e)
                body = json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode()
                vec = assemble(500, {"Content-Type": "application/json"}, body)
            with self._lock:
                self._ready.append((conn, req.seq, vec, req.close_after))
            # The post-reply hook runs after the response is queued but
            # BEFORE the IO loop is woken: the client cannot observe the
            # reply until the wake fires, which gives the capture taps a
            # deterministic happens-before against anything the client
            # does next (e.g. finalizing a workload capture the moment
            # its request returns). Hooks are quick by contract — slow
            # work (shadow probes) spawns its own thread.
            if after is not None:
                try:
                    after()
                except Exception as e:  # noqa: BLE001 — post-reply taps are
                    # best-effort; the response is already assembled
                    log.warning("%s: post-reply hook failed: %s: %s",
                                self.name, type(e).__name__, e)
            try:
                self._wake_w.send(b"x")
            except OSError:
                pass

    # -- response sequencing + writes (IO loop thread) -------------------------

    def _drain_ready(self) -> None:
        with self._lock:
            ready, self._ready = self._ready, []
        for conn, seq, vec, close_after in ready:
            conn.done[seq] = (vec, close_after)
        touched = {conn for conn, _, _, _ in ready}
        for conn in touched:
            if conn not in self._conns:
                continue
            # Release every response that is next in line (pipelining:
            # strictly request order, holes park their successors).
            while conn.next_write in conn.done:
                vec, close_after = conn.done.pop(conn.next_write)
                conn.next_write += 1
                conn.inflight -= 1
                for seg in vec:
                    if len(seg):
                        conn.outq.append(memoryview(seg))
                if close_after:
                    conn.close_when_drained = True
            self._flush(conn)

    def _flush(self, conn: _Connection) -> None:
        try:
            while conn.outq:
                seg = conn.outq[0]
                n = conn.sock.send(seg[conn.out_off:])
                conn.out_off += n
                if conn.out_off < len(seg):
                    break  # kernel buffer full: wait for EVENT_WRITE
                conn.outq.popleft()
                conn.out_off = 0
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            # Mid-response disconnect: drop the connection, keep serving
            # everyone else (the worker that produced this response has
            # already moved on).
            self._close(conn)
            return
        conn.last_activity = time.monotonic()
        want = selectors.EVENT_READ
        if conn.outq:
            want |= selectors.EVENT_WRITE
        elif conn.close_when_drained and conn.inflight == 0:
            self._close(conn)
            return
        try:
            self._sel.modify(conn.sock, want, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _sweep_idle(self) -> None:
        if self.idle_timeout_s is None:
            return
        now = time.monotonic()
        for conn in list(self._conns):
            idle = (conn.inflight == 0 and not conn.outq
                    and now - conn.last_activity > self.idle_timeout_s)
            # The slowloris drip keeps last_activity fresh one byte at
            # a time — the clock that matters is how long ONE request
            # has been incomplete, not how recently bytes arrived.
            dripping = (conn.partial_since is not None
                        and now - conn.partial_since > self.idle_timeout_s)
            if idle or dripping:
                self._close(conn)

    def _close(self, conn: _Connection) -> None:
        if conn not in self._conns:
            return
        self._conns.discard(conn)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self._m_open.set(len(self._conns))

    # -- lifecycle -------------------------------------------------------------

    def stop(self) -> None:
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
        with self._qcond:
            self._qcond.notify_all()
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass
        self._io_thread.join(timeout=5)
        for t in self._workers:
            t.join(timeout=5)
        self._wake_w.close()

    # Aliases for the stdlib server surface the five sites grew up on,
    # so ported call sites read naturally during review.
    shutdown = stop

    def server_close(self) -> None:
        pass  # stop() already closed every socket
