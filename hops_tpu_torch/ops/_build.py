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
    "flash_bwd_dq": (
        "flash_bwd_dq.cu", "hops_flash_bwd_dq",
        # q, k, v, do, lse, delta, dq, bh, seq_q, seq_k, head_dim, is_bf16,
        # sm_scale, causal, q_offset, window, stream
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    ),
    "flash_bwd_dkv": (
        "flash_bwd_dkv.cu", "hops_flash_bwd_dkv",
        # q, k, v, do, lse, delta, dk, dv, bh, seq_q, seq_k, head_dim,
        # is_bf16, sm_scale, causal, q_offset, window, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    ),
    "decode_attention": (
        "decode_attention.cu", "hops_decode_attention",
        # q, k, v, valid_len, o, workspace, b, hkv, rows, s, cap, head_dim,
        # is_bf16, sm_scale, window, n_splits, split_keys, stream
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    ),
    "decode_attention_q8": (
        "decode_attention_q8.cu", "hops_decode_attention_q8",
        # q, k, v, k_scale, v_scale, valid_len, o, workspace, b, hkv, rows,
        # s, cap, head_dim, is_bf16, sm_scale, window, n_splits,
        # split_keys, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    ),
    "paged_decode_attention": (
        "paged_decode_attention.cu", "hops_paged_decode_attention",
        # q, k, v, valid_len, pages, o, workspace, b, hkv, rows, s, page,
        # max_blocks, nblocks, head_dim, is_bf16, sm_scale, window,
        # n_splits, split_keys, stream
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    ),
    "paged_decode_attention_q8": (
        "paged_decode_attention_q8.cu", "hops_paged_decode_attention_q8",
        # q, k, v, k_scale, v_scale, valid_len, pages, o, workspace, b,
        # hkv, rows, s, page, max_blocks, nblocks, head_dim, is_bf16,
        # sm_scale, window, n_splits, split_keys, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
         _I, _P],
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
    shared headers and the flags (kernels of one source share it)."""
    src, _, _ = KERNELS[name]
    h = hashlib.sha256()
    for path in (CSRC / src, *sorted(CSRC.glob("*.cuh"))):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns per kernel
    the seconds its source took (0 when already built) and the
    compiler's resource report (``-Xptxas=-v``). Raises ``RuntimeError``
    with the compiler's output when a build fails."""
    names = list(KERNELS) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = None
    procs = {}
    done: dict[Path, dict] = {}
    for out in dict.fromkeys(library_path(n) for n in names):
        if out.exists():
            log = out.with_suffix(".log")
            done[out] = {"seconds": 0.0, "path": str(out),
                         "ptxas": log.read_text() if log.exists() else ""}
            continue
        exe = exe or nvcc()
        src = next(KERNELS[n][0] for n in names if library_path(n) == out)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs[out] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, src, time.perf_counter())
    failures = []
    for out, (proc, tmp, src, t0) in procs.items():
        text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(text)
        done[out] = {"seconds": secs, "path": str(out), "ptxas": text}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {n: done[library_path(n)] for n in names}


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
