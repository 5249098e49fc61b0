"""Decode-step profile: where do the milliseconds of KV-cached decoding go?

Counterpart of ``examples/decode_bench.py``, on the card. It times
``generate()`` end to end on a full-width LM with random weights (bf16,
``d_model`` 512 in 8 heads of 64, 6 layers, vocab 32000, batch 8, a
128-token prompt, 64 new tokens, capacity 2048), then traces the run
with ``torch.profiler`` and prints the roofline category table and the
heaviest kernels (``runtime.diagnostics.roofline_report`` / ``top_ops``),
so the bound (HBM, small-op overhead, cache copies) is named, not
guessed. The prefill runs the flash kernel (K1) and the decode steps
the decode kernel (K4; K5 with ``--kv-dtype int8``).

Other modes: ``--continuous`` serves ragged requests through
``LMEngine`` slots against the same workload as padded static batches
(``--horizon``, ``--spec-k``, ``--offline``); ``--valid-sweep`` times
the raw decode kernel against ``valid_len`` at a fixed capacity
(defaults raised to ``d_model`` 1024, heads of 128, capacity 16384):
a time that grows with ``valid_len`` means the kernel reads only the
valid prefix, a flat one that it streams the whole capacity.

Usage: ``python examples_torch/decode_bench.py [--batch 8] [--tokens 64] [--device cpu]``
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

VOCAB = 32000
HEADS = 8


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--prompt", type=int, default=128)
    parser.add_argument("--tokens", type=int, default=64)
    parser.add_argument("--d-model", type=int, default=512)
    parser.add_argument("--layers", type=int, default=6)
    parser.add_argument("--max-decode-len", type=int, default=2048)
    parser.add_argument(
        "--kv-dtype", choices=["bf16", "int8"], default="bf16",
        help="int8: quantized cache, half the decode HBM bytes",
    )
    parser.add_argument(
        "--kv-heads", type=int, default=None,
        help="GQA kv heads (< 8 shrinks the cache by the group factor)",
    )
    parser.add_argument(
        "--window", type=int, default=None,
        help="sliding-window causal attention width",
    )
    parser.add_argument(
        "--continuous", action="store_true",
        help="continuous-batching throughput: ragged requests through "
        "LMEngine slots vs the same workload as padded static batches",
    )
    parser.add_argument(
        "--horizon", type=int, default=1,
        help="LMEngine decode_horizon: steps per dispatch (only used with --continuous)",
    )
    parser.add_argument(
        "--spec-k", type=int, default=0,
        help="speculative engine: a half-depth draft proposes spec_k-1 "
        "tokens per dispatch (greedy; only with --continuous)",
    )
    parser.add_argument(
        "--offline", action="store_true",
        help="drain via LMEngine.run_offline: one fused prefill+decode "
        "dispatch per budget-sorted wave (only with --continuous)",
    )
    parser.add_argument(
        "--valid-sweep", action="store_true",
        help="time raw decode_attention vs valid_len at fixed capacity: "
        "flat times mean capacity-proportional reads, linear-in-valid "
        "times confirm the kernel reads the valid prefix only",
    )
    parser.add_argument("--device", default=None, help="default: the card (cuda:0)")
    return parser


def main(argv: list[str] | None = None, *, device=None) -> dict:
    """Run the mode ``argv`` asks for (default: ``sys.argv``) and return
    its numbers (ms per token step, the sweep's rows, the continuous
    run's rates and streams)."""
    from hops_tpu_torch.runtime.devices import resolve_device
    from hops_tpu_torch.runtime.relaylock import relay_lock

    parser = _parser()
    args = parser.parse_args(argv)
    if args.offline and (args.spec_k or args.horizon > 1):
        # run_offline falls back to the online scheduler for speculative
        # engines (and fuses by wave, ignoring horizon) — silently
        # measuring that would mislabel the numbers.
        parser.error("--offline measures the fused offline drain; it does "
                     "not combine with --spec-k/--horizon (those are "
                     "online-scheduler levers)")
    dev = resolve_device(device if device is not None else args.device)
    words = " ".join(sys.argv[1:] if argv is None else argv) or "(defaults)"
    # Every mode below runs on the one card, so the whole run holds the
    # relay lock: two benchmarks sharing a card would time each other.
    with relay_lock(f"decode_bench {words}"):
        if args.valid_sweep:
            # Sweep defaults (overridable): d_head 128 at capacity 16k puts
            # ~0.5 GB per step in flight at full valid_len, well clear of a
            # launch's fixed cost.
            if args.d_model == parser.get_default("d_model"):
                args.d_model = 1024  # d_head 128 at 8 heads
            if args.max_decode_len == parser.get_default("max_decode_len"):
                args.max_decode_len = 16384
            return _valid_sweep(args, dev)
        if args.continuous:
            return _continuous_bench(args, dev)
        return _decode(args, dev)


def _config(args) -> dict:
    return dict(
        vocab_size=VOCAB, d_model=args.d_model, num_heads=HEADS, num_layers=args.layers,
        dtype="bfloat16", max_decode_len=args.max_decode_len,
        kv_cache_dtype=None if args.kv_dtype == "bf16" else args.kv_dtype,
        num_kv_heads=args.kv_heads, window=args.window,
    )


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _decode(args, dev) -> dict:
    import torch

    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.models.generation import generate
    from hops_tpu_torch.models.transformer import TransformerLM
    from hops_tpu_torch.runtime import diagnostics

    cfg = _config(args)
    model = TransformerLM(**cfg, device=dev).load_flax(random_params(**cfg, seed=1))
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, VOCAB, (args.batch, args.prompt), generator=gen)

    def run():
        with torch.inference_mode():
            out = generate(model, prompt, max_new_tokens=args.tokens, temperature=0.0,
                           device=dev)
        _sync(dev)
        return out

    t0 = time.perf_counter()
    run()
    first_s = time.perf_counter() - t0
    print(f"build+first run: {first_s:.1f}s")
    t0 = time.perf_counter()
    run()
    total = time.perf_counter() - t0
    per_step = total / args.tokens
    print(
        f"decode: {per_step * 1e3:.2f} ms/token-step, "
        f"{args.batch * args.tokens / total:.0f} tokens/s "
        f"(batch {args.batch}, {args.layers} layers, d={args.d_model}, "
        f"cache={args.kv_dtype}, kv_heads={args.kv_heads or HEADS}, "
        f"window={args.window}, on {dev})"
    )
    out = {"mode": f"decode {args.kv_dtype}", "config": {**cfg, "batch": args.batch,
                                                         "prompt": args.prompt,
                                                         "tokens": args.tokens},
           "ms_per_token_step": per_step * 1e3,
           "tokens_per_s": args.batch * args.tokens / total, "first_run_s": first_s,
           "roofline": None, "top_ops": []}
    if dev.type != "cuda":
        print("roofline: not measured (no card: the profile reads device kernels)")
        return out
    trace_dir = tempfile.mkdtemp(prefix="decode_trace_")
    with diagnostics.trace(trace_dir):
        run()
    # The trace covers prefill + all token steps; normalize per token.
    report = diagnostics.roofline_report(trace_dir, steps=args.tokens)
    diagnostics.print_roofline(report)
    print("\nheaviest kernels (per token-step):")
    ops = diagnostics.top_ops(trace_dir, steps=args.tokens, n=12)
    for r in ops:
        rate = f"{r['tflops_per_s']:6.2f}" if r["tflops_per_s"] is not None else "     -"
        print(
            f"{r['ms']:7.3f} ms  {rate} TF/s {r['gb']:7.3f} GB  "
            f"x{r['count']:6.1f} {r['category'][:18]:18s} {r['name'][:60]}"
        )
    out.update(roofline=report, top_ops=ops)
    return out


def _valid_sweep(args, dev) -> dict:
    """Step time of the raw decode kernel (K4) as valid_len grows,
    capacity fixed. The kernel reads keys only below valid_len (and, with
    a window, only the last ``window`` of them), so on a card whose
    decode is bound by HBM bytes the time should scale with valid_len.
    On the card the calls are timed by CUDA events, queued behind a
    device-side sleep so the host's launch rate does not pace them."""
    import torch

    from hops_tpu_torch.ops.attention import decode_attention

    b, h, d, cap = args.batch, HEADS, args.d_model // HEADS, args.max_decode_len
    hkv = args.kv_heads or h
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, h, 1, d, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(b, hkv, cap, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, hkv, cap, d, generator=gen, device=dev).to(torch.bfloat16)
    n_steps = 64

    def time_steps(k_arr, v_arr, valid):
        """(us/step, GB read/step) of ``n_steps`` decode calls at one
        (capacity, valid_len)."""
        vl = torch.full((b,), valid, dtype=torch.int32, device=dev)
        with torch.inference_mode():
            decode_attention(q, k_arr, v_arr, vl, window=args.window)  # warm
            _sync(dev)
            if dev.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda._sleep(50_000_000)
                start.record()
                for _ in range(n_steps):
                    decode_attention(q, k_arr, v_arr, vl, window=args.window)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3 / n_steps
            else:
                t0 = time.perf_counter()
                for _ in range(n_steps):
                    decode_attention(q, k_arr, v_arr, vl, window=args.window)
                dt = (time.perf_counter() - t0) / n_steps
        # Bytes the kernel must read: K and V below valid_len, within the window.
        touched = min(valid, args.window or valid)
        gb = 2 * b * hkv * touched * d * 2 / 1e9
        return dt, gb

    print(f"valid-len sweep @ capacity {cap} "
          f"(b={b}, kv_heads={hkv}, d={d}, window={args.window}, on {dev}):")
    print(f"{'valid':>8} {'us/step':>10} {'GB read':>9} {'GB/s':>8}")
    rows = []
    for frac in (1 / 16, 1 / 8, 1 / 4, 1 / 2, 1.0):
        valid = max(1, int(cap * frac))
        dt, gb = time_steps(k, v, valid)
        rows.append({"valid_len": valid, "us_per_step": dt * 1e6, "gb": gb})
        print(f"{valid:>8} {dt * 1e6:>10.1f} {gb:>9.4f} {gb / dt:>8.1f}")

    # Fixed-valid control: the same valid_len at a capacity 4x smaller. If
    # the kernel reads O(valid) the rows match; if it streamed O(capacity)
    # the small-capacity row would be ~4x faster.
    valid = cap // 4
    dt_big, gb_big = time_steps(k, v, valid)
    ks, vs = k[:, :, : cap // 4].contiguous(), v[:, :, : cap // 4].contiguous()
    dt_small, gb_small = time_steps(ks, vs, valid)
    ratio = dt_big / dt_small
    print(f"control @ fixed valid {valid}:")
    print(f"  capacity {cap:>6}: {dt_big * 1e6:>10.1f} us/step {gb_big:>8.4f} GB")
    print(f"  capacity {cap // 4:>6}: {dt_small * 1e6:>10.1f} us/step {gb_small:>8.4f} GB"
          f"  (ratio {ratio:.2f}x — ~1.0 means O(valid), ~4 means O(cap))")
    return {"mode": "valid-sweep", "capacity": cap, "head_dim": d, "rows": rows,
            "control": {"valid_len": valid, "us_big_cap": dt_big * 1e6,
                        "us_small_cap": dt_small * 1e6, "ratio": ratio}}


def _continuous_bench(args, dev) -> dict:
    """Ragged serving workload: 3x slots requests with mixed prompt
    lengths and budgets. Continuous batching (LMEngine) vs the static
    alternative — arrival-order groups of ``slots`` padded to each
    group's worst case (the head-of-line cost the reference's serving
    model cannot avoid)."""
    import numpy as np
    import torch

    from hops_tpu_torch.modelrepo.lm_engine import LMEngine
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.models.generation import generate
    from hops_tpu_torch.models.transformer import TransformerLM

    cfg = _config(args)
    plain = TransformerLM(**cfg, device=dev).load_flax(random_params(**cfg, seed=1))
    model = plain.clone(ragged_decode=True)

    slots = args.batch
    rs = np.random.RandomState(0)
    lengths = [args.prompt // 4, args.prompt // 2, args.prompt]
    budgets = [args.tokens // 4, args.tokens // 2, args.tokens]
    requests = [
        (rs.randint(0, VOCAB, (lengths[i % 3],)), budgets[(i + 1) % 3])
        for i in range(3 * slots)
    ]
    total_tokens = sum(b for _, b in requests)

    draft = None
    if args.spec_k:
        # Draft with half the layers: same vocab, plausible proposals,
        # roughly half the per-step cost.
        dcfg = {**cfg, "num_layers": max(1, args.layers // 2)}
        draft = TransformerLM(**dcfg, ragged_decode=True, device=dev).load_flax(
            random_params(**dcfg, seed=1))
    engine = LMEngine(model, slots=slots, decode_horizon=args.horizon, draft_model=draft,
                      spec_k=args.spec_k or 4, device=dev)

    def run_engine():
        d0 = engine.dispatches
        tickets = [engine.submit(p, max_new_tokens=b) for p, b in requests]
        with torch.inference_mode():
            results = engine.run_offline() if args.offline else engine.run()
        _sync(dev)
        return engine.dispatches - d0, [results[t] for t in tickets]

    run_engine()  # first pass: kernel builds, allocator warm-up
    t0 = time.perf_counter()
    dispatches, streams = run_engine()
    t_cont = time.perf_counter() - t0

    # Static baseline: arrival-order groups of `slots`, every group
    # padded to its longest prompt and longest budget.
    def run_static():
        n_steps = 0
        for i in range(0, len(requests), slots):
            group = requests[i : i + slots]
            lp = max(len(p) for p, _ in group)
            bud = max(b for _, b in group)
            batch = np.zeros((len(group), lp), np.int64)
            for j, (p, _) in enumerate(group):
                batch[j, lp - len(p):] = p  # left-pad (shared shape)
            with torch.inference_mode():
                generate(plain, batch, max_new_tokens=bud, temperature=0.0, device=dev)
            _sync(dev)
            n_steps += bud
        return n_steps

    static_steps = run_static()  # warm-up
    t0 = time.perf_counter()
    run_static()
    t_stat = time.perf_counter() - t0

    acceptance = (engine.spec_accepted / max(engine.spec_offered, 1)) if args.spec_k else None
    spec_note = f", acceptance {acceptance:.2f}" if args.spec_k else ""
    print(
        f"continuous batching ({len(requests)} ragged requests, "
        f"{slots} slots, {total_tokens} tokens, horizon {args.horizon}, on {dev}):\n"
        f"  engine: {t_cont:.2f}s = {total_tokens / t_cont:7.0f} useful tokens/s "
        f"({dispatches} decode dispatches, {engine.admission_waves} admission "
        f"waves{spec_note})\n"
        f"  static: {t_stat:.2f}s = {total_tokens / t_stat:7.0f} useful tokens/s "
        f"({static_steps} padded steps, head-of-line + pad waste)\n"
        f"  speedup: {t_stat / t_cont:.2f}x"
    )
    return {"mode": "continuous", "engine_s": t_cont, "static_s": t_stat,
            "engine_tokens_per_s": total_tokens / t_cont,
            "static_tokens_per_s": total_tokens / t_stat, "dispatches": dispatches,
            "admission_waves": engine.admission_waves, "acceptance": acceptance,
            "requests": [(p.tolist(), b) for p, b in requests], "streams": streams}


if __name__ == "__main__":
    main()
