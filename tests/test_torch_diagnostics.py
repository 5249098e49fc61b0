"""The port's diagnostics (``hops_tpu_torch.runtime.diagnostics``) on the
CPU: the Watchdog fires and stays quiet as the JAX package's does,
``deterministic_mode`` restores every setting it changes, the peak table
holds the H100 row and nothing else, and the trace reader aggregates a
synthetic ``torch.profiler`` Chrome trace (one device's kernels, GEMM
FLOPs from their host op's shapes, the hand-written kernels' counts from
the caller, unknown categories reported as unknown) and a real CPU trace
of a small train step (which holds no device kernels).
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from hops_tpu.runtime import diagnostics as jax_diagnostics
from hops_tpu_torch.runtime import diagnostics as diag

H100 = "NVIDIA H100 80GB HBM3"


class TestWatchdog:
    @pytest.mark.parametrize("pkg", [jax_diagnostics, diag], ids=["jax", "port"])
    def test_fires_without_heartbeats(self, pkg):
        hung = threading.Event()
        wd = pkg.Watchdog(timeout_s=0.2, on_hang=hung.set).start()
        try:
            assert hung.wait(5)
            assert wd.fired
        finally:
            wd.stop()

    @pytest.mark.parametrize("pkg", [jax_diagnostics, diag], ids=["jax", "port"])
    def test_stays_quiet_while_heartbeating(self, pkg):
        fired = []
        with pkg.Watchdog(timeout_s=1.0, on_hang=lambda: fired.append(1)) as wd:
            for _ in range(30):  # 1.5 s: past the timeout, beating every 50 ms
                time.sleep(0.05)
                wd.heartbeat()
        assert not wd.fired and not fired

    def test_heartbeat_gauge_keeps_it_quiet(self):
        from hops_tpu_torch.telemetry.spans import StepTimer

        fired = []
        timer = StepTimer("wd-test")
        with diag.Watchdog(timeout_s=1.0, on_hang=lambda: fired.append(1),
                           watch_heartbeat_gauge="wd-test") as wd:
            for _ in range(30):
                time.sleep(0.05)
                timer.tick()
        assert not wd.fired and not fired


def test_deterministic_mode_restores_its_settings(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    with diag.deterministic_mode(7) as gen:
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        first = torch.randn(4, generator=gen)
    with diag.deterministic_mode(7) as gen:
        assert torch.equal(torch.randn(4, generator=gen), first)
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == before
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    with diag.deterministic_mode():
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"


def test_device_peaks_hold_the_h100_row_only():
    assert diag.device_peaks(H100) == (989e12, 3.35e12)
    assert diag.device_peaks("NVIDIA H100 PCIe") == (989e12, 3.35e12)
    assert diag.device_peaks("Tesla T4") is None
    assert diag.device_peaks("TPU v5 lite") is None
    if not torch.cuda.is_available():
        assert diag.device_peaks() is None


def test_attention_flops_follow_the_perf_count():
    # Causal 4 x 4: 1 + 2 + 3 + 4 = 10 visible pairs.
    assert diag.attention_flops("flash_fwd", 1, 1, 4, 4, 2) == 4 * 2 * 10
    assert diag.attention_flops("flash_bwd_dq", 2, 3, 4, 4, 2) == 6 * 2 * 10 * 6
    assert diag.attention_flops("flash_bwd_dkv", 1, 1, 4, 4, 2, causal=False) == 8 * 2 * 16


def _event(name, cat, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": args}


FWD = "void fwd::fwd_kernel<128, false>(fwd::Args)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"


def _synthetic_trace(path):
    events = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python"}},
        _event("aten::mm", "cpu_op", 0, 50, **{"External id": 1,
                                               "Input Dims": [[64, 128], [128, 256]]}),
        _event("aten::addmm", "cpu_op", 60, 50, **{"External id": 2,
                                                   "Input Dims": [[256], [64, 128], [128, 256]]}),
        _event("aten::_fused_op", "cpu_op", 120, 10, **{"External id": 3, "flops": 1.0e6}),
        _event(GEMM, "kernel", 10, 10.0, device=0, **{"External id": 1}),
        # One op, two kernels: its FLOPs split between them.
        _event(GEMM, "kernel", 70, 10.0, device=0, **{"External id": 2}),
        _event("cutlass_80_tensorop_splitk_reduce", "kernel", 80, 2.0, device=0,
               **{"External id": 2}),
        _event("fused_kernel", "kernel", 125, 4.0, device=0, **{"External id": 3}),
        *[_event(FWD, "kernel", 200 + 30 * i, 20.0, device=0, **{"External id": 99})
          for i in range(3)],
        _event("void at::native::vectorized_elementwise_kernel<4>", "kernel", 400, 5.0,
               device=0, **{"External id": 4}),
        # A copy launched inside a GEMM's op: its bytes count, no FLOPs.
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 410, 1.0, device=0,
               bytes=1_000_000, **{"External id": 1}),
        # Another card's kernels: not this trace's device.
        _event(GEMM, "kernel", 10, 1000.0, device=1, **{"External id": 1}),
    ]
    path.write_text(json.dumps({"deviceProperties": [{"id": 0, "name": H100}],
                                "traceEvents": events}))


def test_roofline_report_on_a_synthetic_trace(tmp_path):
    _synthetic_trace(tmp_path / "t.pt.trace.json")
    fwd_flops = diag.attention_flops("flash_fwd", 1, 1, 64, 64, 128)
    rep = diag.roofline_report(str(tmp_path), peak_flops=989e12, peak_bw=3.35e12, steps=1,
                               kernel_flops={"flash_fwd": fwd_flops})
    assert rep["device"] == H100
    cats = {c["name"]: c for c in rep["categories"]}
    assert set(cats) == {"flash_fwd", "gemm", "elementwise", "other", "memcpy"}
    mm = 2.0 * 64 * 128 * 256
    assert cats["gemm"]["count"] == 3  # device 1's gemm is not counted
    np.testing.assert_allclose(cats["gemm"]["ms"], 22e-3)
    np.testing.assert_allclose(cats["gemm"]["tflops_per_s"], 2 * mm / 22e-6 / 1e12)
    assert cats["gemm"]["bound"] == "compute"
    assert cats["flash_fwd"]["count"] == 3
    np.testing.assert_allclose(cats["flash_fwd"]["tflops_per_s"], 3 * fwd_flops / 60e-6 / 1e12)
    np.testing.assert_allclose(cats["other"]["tflops_per_s"], 1.0e6 / 4e-6 / 1e12)
    # No count for elementwise kernels: unknown, not 0 FLOP/s.
    ew = cats["elementwise"]
    assert ew["bound"] == "unknown" and ew["tflops_per_s"] is None and ew["roofline_ms"] is None
    assert cats["memcpy"]["bound"] == "memory" and cats["memcpy"]["tflops_per_s"] is None
    np.testing.assert_allclose(cats["memcpy"]["gb_per_s"], 1e-3 / 1e-6)
    assert all(c["peak_share"] is None or c["peak_share"] <= 1.0 for c in cats.values())
    np.testing.assert_allclose(sum(c["share"] for c in cats.values()), 1.0)
    halves = diag.roofline_report(str(tmp_path), peak_flops=989e12, peak_bw=3.35e12, steps=2)
    assert {c["name"]: c["count"] for c in halves["categories"]}["flash_fwd"] == 1.5
    diag.print_roofline(rep)

    top = diag.top_ops(str(tmp_path), n=2)
    assert [t["name"] for t in top] == [FWD, GEMM]
    assert top[0]["tflops_per_s"] is None and top[1]["source"] == "aten::mm"
    assert top[1]["count"] == 2


def test_roofline_report_on_a_real_cpu_trace(tmp_path):
    """A traced CPU train step: the trace lands in the directory and holds
    the step's host ops; with no device kernels the reports are empty."""
    model = torch.nn.Linear(16, 8)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with diag.trace(str(tmp_path / "trace")) as target:
        loss = model(torch.randn(32, 16)).square().mean()
        loss.backward()
        opt.step()
    (path,) = list((tmp_path / "trace").glob("trace_*.pt.trace.json"))
    assert target == str(tmp_path / "trace")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "aten::addmm" in names
    rep = diag.roofline_report(target, peak_flops=989e12, peak_bw=3.35e12)
    assert rep["categories"] == [] and rep["total_ms"] == 0.0
    assert diag.top_ops(target) == []
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="peak"):
            diag.roofline_report(target)
