"""Native (C++) runtime components (counterpart of ``hops_tpu/native``).

The record-IO engine (``recordio.cc``) and the embedded key-value store
(``kvstore.cc``) are copies of the JAX package's sources, compiled into
the port's own ``_build/libhops_native.so`` and reached through
``ctypes``; the port never loads the JAX package's library. The library
is built by ``g++`` at first use (the ``Makefile``'s flags), or ahead of
time with ``make -C hops_tpu_torch/native`` or :func:`build`. It lives
in ``_build/``, outside the package's modules, so that an import sweep
of the package does not take it for an extension module.

Each binding keeps the JAX package's pure-Python fallback for when the
library cannot be built or is disabled (``HOPS_TPU_DISABLE_NATIVE``):
host code on both paths, the same on-disk formats.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

from hops_tpu_torch.runtime.logging import get_logger

log = get_logger(__name__)

_LIB_NAME = "libhops_native.so"
_SOURCES = ("kvstore.cc", "recordio.cc")
_CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None  # guarded by: _lock
_build_failed = False  # guarded by: _lock


_SRC_DIR = Path(__file__).parent


def lib_path() -> Path:
    return _SRC_DIR / "_build" / _LIB_NAME


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any((_SRC_DIR / s).stat().st_mtime > built for s in _SOURCES)


def build() -> Path:
    """Compile the engines into :func:`lib_path` unless a library newer
    than its sources is there already. The compiler
    writes a file of its own, renamed into place when done, so processes
    building at once never load a half-written library. Raises
    ``subprocess.CalledProcessError`` (the compiler's output in
    ``stderr``) or ``OSError`` when ``g++`` (``$CXX``) fails or is missing."""
    lib = lib_path()
    if not _stale(lib):
        return lib
    lib.parent.mkdir(exist_ok=True)
    tmp = lib.with_name(f".{_LIB_NAME}.{os.getpid()}.{threading.get_ident()}")
    srcs = [str(_SRC_DIR / s) for s in _SOURCES]
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-shared", "-o", str(tmp), *srcs,
             "-pthread"],
            check=True, capture_output=True, text=True, timeout=300,
        )
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def load() -> ctypes.CDLL | None:
    """The native library, built first where it is missing or older than
    its sources; None when ``HOPS_TPU_DISABLE_NATIVE`` is set or the build
    failed (logged once; the bindings then take their pure-Python path)."""
    global _lib, _build_failed
    if os.environ.get("HOPS_TPU_DISABLE_NATIVE"):
        return None
    with _lock:
        if _lib is None and not _build_failed:
            try:
                _lib = ctypes.CDLL(str(build()))
            except (OSError, subprocess.SubprocessError) as e:
                _build_failed = True
                detail = getattr(e, "stderr", None) or e
                log.warning("native library unavailable, using the pure-Python "
                            "fallbacks: %s", detail)
        return _lib


def available() -> bool:
    return load() is not None
