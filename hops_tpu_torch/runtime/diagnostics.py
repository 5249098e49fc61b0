"""Tracing, hang detection, determinism and the roofline reader
(counterpart of ``hops_tpu/runtime/diagnostics.py``).

- :func:`trace` — a ``torch.profiler`` trace of the with-block (host ops
  with their shapes, and the card's kernels) exported as a Chrome trace
  into the active run's logdir.
- :class:`Watchdog` — collective-deadlock detector: fires when the step
  loop stops heartbeating, dumps every Python thread's stack, and
  optionally kills the process so the job scheduler can retry.
- :func:`deterministic_mode` — one switch for bitwise-reproducible runs
  (``torch.use_deterministic_algorithms``, cuBLAS's fixed workspace, a
  seeded generator), restored on exit.
- :func:`roofline_report`, :func:`print_roofline`, :func:`top_ops` —
  one device's kernels from a :func:`trace`, by category, against the
  card's peaks (:func:`device_peaks`).
- :class:`FlightRecorder` / :data:`FLIGHT` — the crash/fault flight
  recorder, re-exported from the stdlib-only
  :mod:`hops_tpu_torch.runtime.flight`.
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import re
import sys
import threading
import time
from typing import Iterator

import torch

from hops_tpu_torch.runtime import rundir
from hops_tpu_torch.runtime.flight import (  # noqa: F401 — diagnostics surface
    FLIGHT,
    FlightRecorder,
    install_crash_handler,
)
from hops_tpu_torch.runtime.logging import get_logger

log = get_logger(__name__)


@contextlib.contextmanager
def trace(logdir: str | None = None) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace of the with-block into
    ``logdir`` (default: ``<active run>/trace``) as
    ``trace_<pid>.pt.trace.json``: the host's ops with their input
    shapes (the GEMM FLOPs the reader counts come from them) and, where
    there is a card, its kernels."""
    from torch.profiler import ProfilerActivity, profile

    target = logdir or os.path.join(rundir.logdir(), "trace")
    os.makedirs(target, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=True, with_flops=True)
    prof.start()
    try:
        yield target
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(target, f"trace_{os.getpid()}.pt.trace.json"))


class Watchdog:
    """Detects a stalled step loop (the usual face of a collective deadlock).

    The training loop calls :meth:`heartbeat` once per step; a daemon
    thread fires after ``timeout_s`` without one, logs every thread's
    stack (so the hung collective is visible), and calls ``on_hang`` —
    default: dump + ``os._exit(42)`` when ``fatal`` else just log,
    letting an external supervisor restart the host.

    ``watch_heartbeat_gauge`` reads the telemetry heartbeat gauge
    (maintained by ``runtime.preemption.run_preemptible`` and
    ``telemetry.StepTimer``) instead of requiring explicit
    :meth:`heartbeat` calls. Pass the LOOP NAME (e.g. ``"preemptible"``)
    to watch one loop; ``True`` accepts a beat from any loop in the
    process. The comparison uses the gauge's monotonic twin. Falls back
    to the explicit clock until the gauge first beats.
    """

    def __init__(self, timeout_s: float = 300.0, fatal: bool = False, on_hang=None,
                 watch_heartbeat_gauge: bool | str = False):
        self.timeout_s = timeout_s
        self.fatal = fatal
        self.on_hang = on_hang
        self.watch_heartbeat_gauge = watch_heartbeat_gauge
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._thread: threading.Thread | None = None

    def heartbeat(self) -> None:
        self._last = time.monotonic()

    def _beat_age(self) -> float:
        """Seconds since the newest heartbeat: the explicit clock,
        optionally superseded by the telemetry gauge (whichever beat
        most recently wins)."""
        age = time.monotonic() - self._last
        if self.watch_heartbeat_gauge:
            from hops_tpu_torch.telemetry.metrics import REGISTRY
            from hops_tpu_torch.telemetry.spans import HEARTBEAT_MONO_GAUGE

            want = (
                self.watch_heartbeat_gauge
                if isinstance(self.watch_heartbeat_gauge, str) else None
            )
            gauge = REGISTRY.get(HEARTBEAT_MONO_GAUGE)
            if gauge is not None:
                # Read via samples() — value(loop=...) would CREATE a
                # zero child and pollute the export.
                beats = [
                    v for _s, labels, v in gauge.samples()
                    if v > 0 and (want is None or labels.get("loop") == want)
                ]
                if beats:
                    age = min(age, time.monotonic() - max(beats))
        return age

    @property
    def fired(self) -> bool:
        return self._fired

    def _watch(self) -> None:
        while not self._stop.wait(min(self.timeout_s / 4, 5.0)):
            if self._beat_age() > self.timeout_s:
                self._fired = True
                log.error(
                    "watchdog: no heartbeat for %.0fs — possible collective "
                    "deadlock; dumping thread stacks",
                    self.timeout_s,
                )
                faulthandler.dump_traceback(file=sys.stderr)
                if self.on_hang is not None:
                    self.on_hang()
                elif self.fatal:
                    os._exit(42)
                return

    def start(self) -> "Watchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._watch, daemon=True, name="hops-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


@contextlib.contextmanager
def deterministic_mode(seed: int = 0) -> Iterator[torch.Generator]:
    """Bitwise-reproducible execution for the with-block.

    Turns on ``torch.use_deterministic_algorithms`` (cuDNN deterministic,
    its autotuner off) and sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` when
    unset, which cuBLAS needs to be deterministic and reads when its
    handle is first made (set it before the process's first cuBLAS call
    for it to bind). Yields a CPU ``torch.Generator`` seeded with
    ``seed``. Every setting is restored on exit, so cuBLAS calls after
    the block do not raise for a workspace left unset.
    """
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    if prev[4] is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield torch.Generator().manual_seed(seed)
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[2], prev[3]
        if prev[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


# -- roofline analysis over profiler traces ----------------------------------

#: Published peaks per card (dense bf16 tensor-core FLOP/s, HBM bytes/s):
#: NVIDIA's H100 SXM data sheet at 700 W, as PERF.md §2 uses them.
_PEAKS = {
    "h100": (989e12, 3.35e12),
}


def device_peaks(kind: str | None = None) -> tuple[float, float] | None:
    """(bf16 dense FLOP/s, HBM bytes/s) peaks for a device kind
    (``torch.cuda.get_device_name``; default: card 0's).

    Returns None when the kind isn't tabulated (or there is no card) —
    callers must not guess a roof: a share of the wrong card's peak
    misstates the headline.
    """
    if kind is None:
        if not torch.cuda.is_available():
            return None
        kind = torch.cuda.get_device_name(0)
    return next((v for k, v in _PEAKS.items() if k in kind.lower()), None)


#: Kernel categories by kernel name, first match wins: the hand-written
#: kernels (``hops_tpu_torch/ops/csrc``) by their device symbols, then
#: the library families. K4's wide calls run K1's forward body, under
#: ``flash_fwd`` too.
KERNEL_CATEGORIES: tuple[tuple[str, str], ...] = (
    ("flash_fwd", r"fwd::fwd_kernel<\d+, false>|flash_fwd_kernel"),
    ("flash_fwd_q8", r"fwd::fwd_kernel<\d+, true>"),
    ("flash_bwd_dq", r"tc::dq_kernel|flash_bwd_dq_kernel"),
    ("flash_bwd_dkv", r"tc::dkv_kernel|flash_bwd_dkv_kernel"),
    ("decode_split", r"split::split_kernel|split::combine_kernel"),
    ("decode_chunk", r"chunk::chunk_kernel"),
    ("decode_rows", r"decode_rows_kernel"),
    ("nccl", r"nccl"),
    ("gemm", r"gemm|nvjet|cutlass|sm90_xmma|cublas"),
    ("conv", r"conv|cudnn|implicit|dgrad|wgrad|fprop"),
    ("reduce", r"reduce|Reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
    ("memcpy", r"^Memcpy|^Memset"),
)

#: Operations per visible (query, key) pair per head dim of the
#: hand-written attention kernels (PERF.md §2): K1 4·d, K2 6·d, K3 8·d.
_PAIR_OPS = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}


def category(name: str) -> str:
    """The :data:`KERNEL_CATEGORIES` category of a kernel name, else
    ``"other"``."""
    return next((c for c, pat in KERNEL_CATEGORIES if re.search(pat, name)), "other")


def attention_flops(kernel: str, batch: int, heads: int, seq_q: int, seq_k: int,
                    head_dim: int, causal: bool = True) -> float:
    """The operations of one launch of K1 (``flash_fwd``), K2
    (``flash_bwd_dq``) or K3 (``flash_bwd_dkv``) by PERF.md §2's count:
    ops per visible (query, key) pair × visible pairs (causal: the
    queries end-aligned with the keys)."""
    if causal:
        off = seq_k - seq_q
        pairs = sum(min(seq_k, i + 1 + off) for i in range(seq_q))
    else:
        pairs = seq_q * seq_k
    return float(_PAIR_OPS[kernel] * head_dim * pairs * batch * heads)


def _gemm_flops(name: str, dims: list) -> float:
    """FLOPs of an aten GEMM from its recorded input shapes (the count
    ``with_flops`` makes: 2·M·K·N, times the batch)."""
    try:
        if name in ("aten::mm", "aten::_scaled_mm"):
            (m, k), (_, n) = dims[0], dims[1]
            return 2.0 * m * k * n
        if name == "aten::addmm":
            (m, k), (_, n) = dims[1], dims[2]
            return 2.0 * m * k * n
        if name == "aten::bmm":
            (b, m, k), (_, _, n) = dims[0], dims[1]
            return 2.0 * b * m * k * n
        if name == "aten::baddbmm":
            (b, m, k), (_, _, n) = dims[1], dims[2]
            return 2.0 * b * m * k * n
    except (TypeError, ValueError, IndexError):
        return 0.0
    return 0.0


def _find_trace_file(trace_dir: str) -> str:
    import glob

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json*"), recursive=True))
    if not files:
        raise FileNotFoundError(f"no trace (*.json) under {trace_dir}")
    return files[-1]


def _device_op_rows(trace_dir: str) -> tuple[str, list[dict]]:
    """Parse a :func:`trace` capture into per-kernel rows for ONE device.

    Shared by :func:`roofline_report` and :func:`top_ops`: the kernels
    (and copies) of the lowest device index only — every rank of a run
    traces its own card, and one trace holding several would multiply
    time by their count. A kernel's FLOPs are the launching op's (the
    host op its ``External id`` names: the op's ``flops`` where the
    trace gives them, else the GEMM count from its input shapes), split
    evenly over the op's kernels; copies carry their bytes and no FLOPs,
    and bytes are known for copies only.
    """
    import collections
    import gzip
    import json

    path = _find_trace_file(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    devices = sorted({int((e.get("args") or {}).get("device", 0)) for e in kernels})
    if not devices:
        return "", []
    dev = devices[0]
    kernels = [e for e in kernels if int((e.get("args") or {}).get("device", 0)) == dev]
    props = doc.get("deviceProperties") if isinstance(doc, dict) else None
    device_name = next((p.get("name", "") for p in props or [] if p.get("id") == dev),
                       f"cuda:{dev}")

    ops = {}
    for e in events:
        args = e.get("args") or {}
        if e.get("ph") == "X" and e.get("cat") == "cpu_op" and "External id" in args:
            ops[args["External id"]] = e
    # Copies carry their bytes; only kernels share their op's FLOPs.
    per_op = collections.Counter(
        (e.get("args") or {}).get("External id") for e in kernels if e["cat"] == "kernel")

    rows: dict[str, dict] = {}
    for e in kernels:
        args = e.get("args") or {}
        op = ops.get(args.get("External id"))
        flops = 0.0
        if op is not None and e["cat"] == "kernel":
            op_args = op.get("args") or {}
            flops = float(op_args.get("flops") or 0) or _gemm_flops(
                op["name"], op_args.get("Input Dims") or [])
            flops /= per_op[args.get("External id")]
        row = rows.setdefault(e["name"], {
            "name": e["name"], "category": category(e["name"]), "s": 0.0,
            "flops": 0.0, "bytes": 0.0, "count": 0,
            "source": op["name"] if op is not None else "?",
        })
        row["s"] += float(e.get("dur", 0)) / 1e6  # trace times are in us
        row["flops"] += flops
        row["bytes"] += float(args.get("bytes", 0) or 0)
        row["count"] += 1
    return device_name, list(rows.values())


def roofline_report(
    trace_dir: str,
    peak_flops: float | None = None,
    peak_bw: float | None = None,
    steps: int = 1,
    kernel_flops: dict[str, float] | None = None,
) -> dict:
    """Aggregate a :func:`trace` capture into a per-category roofline.

    Sums one device's kernel time, FLOPs and bytes by category
    (:data:`KERNEL_CATEGORIES`) and reports, for each, achieved FLOP/s
    and bytes/s against the card's roofs. ``kernel_flops`` gives the
    FLOPs per launch of categories the trace cannot count (the
    hand-written kernels: :func:`attention_flops` at the traced shapes).
    A category with neither FLOPs nor bytes is reported with ``bound``
    ``"unknown"`` and no rate or roofline — never as 0 FLOP/s against a
    roof. Bytes are known only for copies, so a compute category's
    ``roofline_ms`` is its FLOP bound alone.

    The peaks default to :func:`device_peaks` of this process's card;
    an untabulated card (or none) raises: pass ``peak_flops`` and
    ``peak_bw``. Returns ``{"steps", "total_ms", "roofline_ms",
    "roofline_fraction", "device", "peak_tflops", "peak_gbps",
    "categories": [{name, count, ms, share, tflops_per_s, gb_per_s, gb,
    bound, roofline_ms, peak_share}, ...]}``; times, counts and bytes
    are per step.
    """
    import collections

    device_name, rows = _device_op_rows(trace_dir)
    if peak_flops is None or peak_bw is None:
        match = device_peaks()
        if match is None:
            raise ValueError("roofline_report: no tabulated peaks for this device; "
                             "pass peak_flops and peak_bw")
        peak_flops, peak_bw = peak_flops or match[0], peak_bw or match[1]

    by_cat = collections.defaultdict(lambda: [0.0, 0.0, 0.0, 0])
    for r in rows:
        agg = by_cat[r["category"]]
        agg[0] += r["s"]
        agg[1] += r["flops"]
        agg[2] += r["bytes"]
        agg[3] += r["count"]
    for cat, per_launch in (kernel_flops or {}).items():
        if cat in by_cat:
            by_cat[cat][1] = per_launch * by_cat[cat][3]

    total_s = sum(v[0] for v in by_cat.values())
    categories = []
    for cat, (dur, fl, by, count) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        if dur <= 0:
            continue
        known = fl > 0 or by > 0
        flop_bound, byte_bound = fl / peak_flops, by / peak_bw
        categories.append({
            "name": cat,
            "count": count / steps,
            "ms": dur * 1e3 / steps,
            "share": dur / total_s,
            "tflops_per_s": fl / dur / 1e12 if fl else None,
            "gb_per_s": by / dur / 1e9 if by else None,
            "gb": by / 1e9 / steps,
            "bound": ("compute" if flop_bound >= byte_bound else "memory") if known
            else "unknown",
            "roofline_ms": max(flop_bound, byte_bound) * 1e3 / steps if known else None,
            "peak_share": max(flop_bound, byte_bound) / dur if known else None,
        })
    total = sum(c["ms"] for c in categories)
    ideal = sum(c["roofline_ms"] or 0.0 for c in categories)
    return {
        "steps": steps,
        "total_ms": total,
        "roofline_ms": ideal,
        "roofline_fraction": ideal / total if total else 0.0,
        "device": device_name,
        "peak_tflops": peak_flops / 1e12,
        "peak_gbps": peak_bw / 1e9,
        "categories": categories,
    }


def print_roofline(report: dict) -> None:
    """Render :func:`roofline_report` as a table (``-`` where a category
    has no count)."""
    def num(v, fmt):
        return format(v, fmt) if v is not None else "-".rjust(len(format(0.0, fmt)))

    print(
        f"device {report['device']}  roofs: {report['peak_tflops']:.0f} TFLOP/s, "
        f"{report['peak_gbps']:.0f} GB/s"
    )
    print(f"{'category':16s}{'launches':>9s}{'ms':>10s}{'share':>7s}{'TFLOP/s':>9s}"
          f"{'GB/s':>7s}  bound    best-case ms  of peak")
    for c in report["categories"]:
        print(
            f"{c['name']:16s}{c['count']:9.0f}{c['ms']:10.3f}{c['share']:7.1%}"
            f"{num(c['tflops_per_s'], '9.1f')}{num(c['gb_per_s'], '7.0f')}  {c['bound']:8s}"
            f"{num(c['roofline_ms'], '13.3f')}  {num(c['peak_share'], '6.1%')}"
        )
    print(
        f"total {report['total_ms']:.3f} ms vs roofline best-case of the counted categories "
        f"{report['roofline_ms']:.3f} ms ({report['roofline_fraction'] * 100:.0f}%)"
    )


def top_ops(trace_dir: str, steps: int = 1, n: int = 15) -> list[dict]:
    """Per-kernel (not per-category) view of a :func:`trace` capture: the
    n heaviest kernels with duration, launches, FLOP/s (where counted),
    bytes and the host op that launched them. Durations, launches and
    bytes are divided by ``steps``."""
    _, rows = _device_op_rows(trace_dir)
    result = []
    for r in sorted(rows, key=lambda r: -r["s"])[:n]:
        ms = r["s"] * 1e3 / steps
        result.append({
            "name": r["name"],
            "category": r["category"],
            "source": r["source"],
            "count": r["count"] / steps,
            "ms": ms,
            "gb": r["bytes"] / 1e9 / steps,
            "tflops_per_s": (r["flops"] / steps) / (ms / 1e3) / 1e12 if r["flops"] else None,
        })
    return result
