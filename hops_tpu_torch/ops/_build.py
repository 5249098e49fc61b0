"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``ops/csrc/`` compiles on its own with ``nvcc`` into a
shared library with a plain C interface: no PyTorch headers and no
``ninja``, so a build takes seconds. The output goes to ``ops/_build/``
(git-ignored), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused. :func:`build` starts one
``nvcc`` per source, all at once. A build or load failure raises; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# kernel name -> (source, C entry point, argtypes)
KERNELS: dict[str, tuple[str, str, list]] = {
    "flash_fwd": (
        "flash_fwd.cu", "hops_flash_fwd",
        # q, k, v, o, lse, bh, seq_q, seq_k, head_dim, is_bf16, sm_scale,
        # causal, q_offset, window, stream
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    ),
    "decode_attention": (
        "decode_attention.cu", "hops_decode_attention",
        # q, k, v, valid_len, o, b, hkv, rows, s, cap, head_dim, is_bf16,
        # sm_scale, window, stream
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes._CFuncPtr] = {}
_error_string: dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``PATH``, else the
    toolkit PyTorch found."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library goes: keyed by its source, the
    shared header and the flags."""
    src, _, _ = KERNELS[name]
    h = hashlib.sha256()
    for path in (CSRC / src, CSRC / "common.cuh"):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` each, all started together. Returns per kernel the
    seconds it took (0 when already built) and the compiler's resource
    report (``-Xptxas=-v``). Raises ``RuntimeError`` with the compiler's
    output when a build fails."""
    names = list(KERNELS) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = None
    procs = {}
    report: dict[str, dict] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            report[name] = {
                "seconds": 0.0, "path": str(out),
                "ptxas": log.read_text() if log.exists() else "",
            }
            continue
        exe = exe or nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(text)
        report[name] = {"seconds": secs, "path": str(out), "ptxas": text}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


def kernel(name: str):
    """The C entry point of kernel ``name``, built at first use."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _loaded:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, KERNELS[name][1])
            fn.argtypes = KERNELS[name][2]
            fn.restype = ctypes.c_int
            err = lib.hops_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _error_string[name] = err
            _loaded[name] = fn
    return _loaded[name]


def check(name: str, code: int) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if code:
        msg = _error_string[name](code).decode(errors="replace")
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")
