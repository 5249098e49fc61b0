"""ctypes binding for the native KV engine (kvstore.cc) (a copy of
``hops_tpu/native/kvstore.py``: the module imports no JAX, and the port
imports nothing of the JAX package).

Exposes the backend protocol of the JAX package's ``online._SqliteKV``,
so the online store (``ROADMAP.md`` Queue 1 item 7) can swap engines
transparently. Its files are the JAX package's, byte for byte.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Iterator

from hops_tpu_torch import native


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes.c_char_p
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    lib.kv_open.restype = ctypes.c_void_p
    lib.kv_open.argtypes = [c]
    lib.kv_put.restype = ctypes.c_int
    lib.kv_put.argtypes = [ctypes.c_void_p, c, u32, c, u32]
    lib.kv_get.restype = ctypes.c_int
    lib.kv_get.argtypes = [
        ctypes.c_void_p, c, u32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)), ctypes.POINTER(u32),
    ]
    lib.kv_delete.restype = ctypes.c_int
    lib.kv_delete.argtypes = [ctypes.c_void_p, c, u32]
    lib.kv_get_many.restype = ctypes.c_int
    lib.kv_get_many.argtypes = [
        ctypes.c_void_p, c, u32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)), ctypes.POINTER(u64),
    ]
    lib.kv_count.restype = u64
    lib.kv_count.argtypes = [ctypes.c_void_p]
    lib.kv_flush.argtypes = [ctypes.c_void_p]
    lib.kv_compact.restype = ctypes.c_int64
    lib.kv_compact.argtypes = [ctypes.c_void_p]
    lib.kv_scan.restype = ctypes.c_void_p
    lib.kv_scan.argtypes = [ctypes.c_void_p]
    lib.kv_scan_next.restype = ctypes.c_int
    lib.kv_scan_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)), ctypes.POINTER(u32),
    ]
    lib.kv_scan_close.argtypes = [ctypes.c_void_p]
    lib.kv_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.kv_close.argtypes = [ctypes.c_void_p]
    return lib


_bind_lock = threading.Lock()
_bound: ctypes.CDLL | None = None  # guarded by: _bind_lock


def _lib() -> ctypes.CDLL:
    # Two threads opening stores concurrently (sharded online store
    # startup) must not race the check-then-bind: an unguarded double
    # _bind would hand one of them a CDLL whose restype/argtypes are
    # being mutated mid-flight.
    global _bound
    with _bind_lock:
        if _bound is None:
            raw = native.load()
            if raw is None:
                raise RuntimeError(
                    "native library unavailable (g++ failed, or HOPS_TPU_DISABLE_NATIVE "
                    "is set); see hops_tpu_torch.native.build"
                )
            _bound = _bind(raw)
        return _bound


def available() -> bool:
    return native.available()


class NativeKV:
    #: The mmap'd log + open-addressing index are NOT reader-safe while
    #: a put grows the log or a compact rewrites it: readers must hold
    #: the owning store's writer lock (see ``OnlineStore._read``).
    reader_safe = False

    def __init__(self, path: str):
        self._lib = _lib()
        self._h = self._lib.kv_open(path.encode())
        if not self._h:
            raise OSError(f"kv_open failed for {path}")

    def put(self, key: str, value: str) -> None:
        k, v = key.encode(), value.encode()
        rc = self._lib.kv_put(self._h, k, len(k), v, len(v))
        if rc != 0:
            raise OSError(f"kv_put failed (rc={rc})")

    def get(self, key: str) -> str | None:
        k = key.encode()
        out = ctypes.POINTER(ctypes.c_char)()
        out_len = ctypes.c_uint32()
        rc = self._lib.kv_get(self._h, k, len(k), ctypes.byref(out), ctypes.byref(out_len))
        if rc != 0:
            return None
        try:
            return ctypes.string_at(out, out_len.value).decode()
        finally:
            self._lib.kv_free(out)

    def delete(self, key: str) -> None:
        k = key.encode()
        self._lib.kv_delete(self._h, k, len(k))

    def get_many(self, keys: list[str]) -> list[str | None]:
        """Batched point lookup in input order (None = miss): the keys
        pack into one buffer, cross the FFI once, and the C side
        resolves the whole batch under ONE lock acquisition — the
        online store's multi-get path stops paying per-key ctypes +
        mutex overhead."""
        if not keys:
            return []
        parts = []
        for key in keys:
            k = key.encode()
            parts.append(struct.pack("<I", len(k)))
            parts.append(k)
        packed = b"".join(parts)
        out = ctypes.POINTER(ctypes.c_char)()
        out_len = ctypes.c_uint64()
        rc = self._lib.kv_get_many(
            self._h, packed, len(keys), ctypes.byref(out), ctypes.byref(out_len)
        )
        if rc != 0:
            raise OSError(f"kv_get_many failed (rc={rc})")
        try:
            blob = ctypes.string_at(out, out_len.value)
        finally:
            self._lib.kv_free(out)
        vals: list[str | None] = []
        pos = 0
        for _ in keys:
            (vlen,) = struct.unpack_from("<I", blob, pos)
            pos += 4
            if vlen == 0xFFFFFFFF:
                vals.append(None)
                continue
            vals.append(blob[pos:pos + vlen].decode())
            pos += vlen
        return vals

    def scan(self) -> Iterator[str]:
        it = self._lib.kv_scan(self._h)
        try:
            out = ctypes.POINTER(ctypes.c_char)()
            out_len = ctypes.c_uint32()
            while self._lib.kv_scan_next(it, ctypes.byref(out), ctypes.byref(out_len)) == 0:
                try:
                    yield ctypes.string_at(out, out_len.value).decode()
                finally:
                    self._lib.kv_free(out)
        finally:
            self._lib.kv_scan_close(it)

    def count(self) -> int:
        return int(self._lib.kv_count(self._h))

    def compact(self) -> int:
        return int(self._lib.kv_compact(self._h))

    def flush(self) -> None:
        self._lib.kv_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None
