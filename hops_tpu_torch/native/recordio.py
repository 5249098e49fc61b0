"""ctypes binding for the native record-IO engine (recordio.cc), with a
pure-Python fallback implementing the same on-disk format (a copy of
``hops_tpu/native/recordio.py``: the module imports no JAX, and the port
imports nothing of the JAX package; its files are the JAX package's)."""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import Iterator

from hops_tpu_torch import native

_HDR = struct.Struct("<I")
_IDX = struct.Struct("<Q")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    lib.rio_writer_open.restype = ctypes.c_void_p
    lib.rio_writer_open.argtypes = [ctypes.c_char_p]
    lib.rio_write.restype = ctypes.c_int
    lib.rio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u32]
    lib.rio_writer_close.restype = u64
    lib.rio_writer_close.argtypes = [ctypes.c_void_p]
    lib.rio_reader_open.restype = ctypes.c_void_p
    lib.rio_reader_open.argtypes = [ctypes.c_char_p]
    lib.rio_num_records.restype = u64
    lib.rio_num_records.argtypes = [ctypes.c_void_p]
    lib.rio_read.restype = ctypes.c_int
    lib.rio_read.argtypes = [
        ctypes.c_void_p, u64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)), ctypes.POINTER(u32),
    ]
    lib.rio_read_batch.restype = ctypes.c_int
    lib.rio_read_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(u64), u32, u32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)), ctypes.POINTER(u64),
        ctypes.POINTER(u64),
    ]
    lib.rio_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.rio_reader_close.argtypes = [ctypes.c_void_p]
    return lib


_bound: ctypes.CDLL | None = None
_bind_failed = False


def _lib() -> ctypes.CDLL | None:
    global _bound, _bind_failed
    if _bound is None and not _bind_failed and native.available():
        try:
            _bound = _bind(native.load())
        except AttributeError:
            # A stale libhops_native.so missing newer symbols must not
            # take down the whole binding — degrade to pure Python (the
            # documented contract) until the library is rebuilt.
            _bind_failed = True
    return _bound


class RecordWriter:
    """Append records; index written on close."""

    def __init__(self, path: str | Path):
        self._path = str(path)
        lib = _lib()
        if lib is not None:
            self._h, self._lib = lib.rio_writer_open(self._path.encode()), lib
            if not self._h:
                raise OSError(f"rio_writer_open failed for {path}")
        else:
            self._lib = None
            self._f = open(self._path, "wb")
            self._offsets: list[int] = []
            self._pos = 0

    def write(self, record: bytes) -> None:
        if self._lib is not None:
            if self._lib.rio_write(self._h, record, len(record)) != 0:
                raise OSError("rio_write failed")
        else:
            self._f.write(_HDR.pack(len(record)))
            self._f.write(record)
            self._offsets.append(self._pos)
            self._pos += _HDR.size + len(record)

    def close(self) -> int:
        if self._lib is not None:
            return int(self._lib.rio_writer_close(self._h))
        self._f.close()
        with open(self._path + ".idx", "wb") as idx:
            for off in self._offsets:
                idx.write(_IDX.pack(off))
        return len(self._offsets)

    def __enter__(self) -> "RecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RecordReader:
    """O(1) random access over a record file.

    Thread-safety: the native path is safe to share across threads
    (``rio_read``/``rio_read_batch`` use positioned ``pread`` — no
    seek state); the pure-Python fallback serializes its shared file
    object's seek+read under a lock, so a reader handed to a decode
    pool (``featurestore/loader.py``) behaves identically on both
    paths — the fallback just doesn't overlap its reads."""

    def __init__(self, path: str | Path):
        self._path = str(path)
        lib = _lib()
        if lib is not None:
            self._h, self._lib = lib.rio_reader_open(self._path.encode()), lib
            if not self._h:
                raise OSError(f"rio_reader_open failed for {path}")
            self._n = int(lib.rio_num_records(self._h))
        else:
            self._lib = None
            import threading

            self._f_lock = threading.Lock()
            self._f = open(self._path, "rb")  # guarded by: self._f_lock
            idx = Path(self._path + ".idx")
            if idx.exists():
                raw = idx.read_bytes()
                self._offsets = [
                    _IDX.unpack_from(raw, i * _IDX.size)[0]
                    for i in range(len(raw) // _IDX.size)
                ]
            else:
                self._offsets = []
                pos = 0
                while True:
                    self._f.seek(pos)
                    hdr = self._f.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        break
                    self._offsets.append(pos)
                    pos += _HDR.size + _HDR.unpack(hdr)[0]
            self._n = len(self._offsets)

    def __len__(self) -> int:
        return self._n

    def read(self, i: int) -> bytes:
        if self._lib is not None:
            out = ctypes.POINTER(ctypes.c_char)()
            out_len = ctypes.c_uint32()
            rc = self._lib.rio_read(self._h, i, ctypes.byref(out), ctypes.byref(out_len))
            if rc != 0:
                raise IndexError(f"record {i} (rc={rc})")
            try:
                return ctypes.string_at(out, out_len.value)
            finally:
                self._lib.rio_free(out)
        off = self._offsets[i]
        with self._f_lock:
            self._f.seek(off)
            (length,) = _HDR.unpack(self._f.read(_HDR.size))
            return self._f.read(length)

    def read_batch(self, indices, n_threads: int = 4) -> list[bytes]:
        """Gather many records in ONE native call.

        The engine packs the records back-to-back via positioned reads
        (pread — no seek contention, no reader mutex) fanned over
        ``n_threads``; record lengths come from consecutive index
        offsets (no header reads except the final record). Measured
        1.2x over per-record reads single-threaded on a 1-core
        warm-cache box; the thread fan-out adds more on multi-core TPU
        hosts and cold storage.
        """
        idx = list(indices)
        if self._lib is None or not idx:
            return [self.read(i) for i in idx]
        n = len(idx)
        arr = (ctypes.c_uint64 * n)(*idx)
        lens = (ctypes.c_uint64 * n)()
        out = ctypes.POINTER(ctypes.c_char)()
        total = ctypes.c_uint64()
        rc = self._lib.rio_read_batch(
            self._h, arr, n, n_threads, ctypes.byref(out),
            ctypes.byref(total), lens,
        )
        if rc == -1:
            raise IndexError(f"batch read: index out of range (n={n})")
        if rc != 0:
            raise OSError(f"batch read of {n} records failed: "
                          f"{'I/O error' if rc in (-2, -4) else 'allocation failure'} "
                          f"(rc={rc})")
        # Slice each record straight out of the native buffer — one copy
        # per record, no whole-buffer bytes intermediate.
        try:
            base = ctypes.addressof(out.contents)
            records, pos = [], 0
            for i in range(n):
                records.append(ctypes.string_at(base + pos, lens[i]))
                pos += lens[i]
        finally:
            self._lib.rio_free(out)
        return records

    def __iter__(self) -> Iterator[bytes]:
        return (self.read(i) for i in range(self._n))

    def close(self) -> None:
        if self._lib is not None:
            if self._h:
                self._lib.rio_reader_close(self._h)
                self._h = None
        else:
            # Under the read lock: closing mid-read would raise a
            # ValueError on whichever decode worker holds the file.
            with self._f_lock:
                self._f.close()

    def __enter__(self) -> "RecordReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
