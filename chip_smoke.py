#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hops_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root; it needs one CUDA device and ``nvcc``. The
phases run in order, each prints its result on its own line, and any
failure exits non-zero:

1. card     — the card's name and power limit (``nvidia-smi``);
2. build    — both kernels compiled from ``hops_tpu_torch/ops/csrc``;
3. kernels  — each kernel against its plain PyTorch version (fp32) on
   the same seeded inputs: bf16 inputs within ``2e-2 + 2e-2 *
   max|plain|``, fp32 inputs at the same shapes within 1e-4, and the
   flash kernel's lse within 1e-4;
4. slice    — a seeded full-width TransformerLM (vocab 32000, d_model
   1024, 8 heads of 128, 12 layers, bf16, max_decode_len 2048) written
   as an artifact, served by ``LMEnginePredictor`` with 4 slots: 8 greedy
   requests of 16..1500 prompt tokens. Every answer must have its full
   length and both kernels must have launched. For two requests the
   kernel path's logits must match the plain attention versions with
   fp32 weights on the card: within ``1e-4 * ||ref||inf`` on the fp32
   kernels, and on the served bf16 ones within 1.5 times the plain bf16
   model's own distance;
5. timing   — each kernel at the serving path's shapes beside its bound,
   its plain version and one PyTorch library call;
6. profile  — a ``torch.profiler`` trace of 10 engine decode steps:
   device busy time, idle share, and the kernels that take the time.

The second-to-last line is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Nothing of JAX or of the
JAX package is imported.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (dense bf16 tensor-core rate, HBM3).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

MODEL = dict(
    vocab_size=32000, d_model=1024, num_heads=8, num_layers=12,
    dtype="bfloat16", max_decode_len=2048,
)
PROMPT_LENS = (1500, 16, 900, 64, 1300, 200, 1024, 512)
NEW_TOKENS = (64, 32, 48, 40, 56, 32, 64, 48)


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


# Phase 3 bounds. bf16 inputs: 2e-2 + 2e-2 * max|plain| (the kernels keep
# probabilities fp32, the plain version rounds them to bf16). fp32 inputs
# at the same shapes: an absolute 1e-4, tight enough that one dropped key
# tile of a long row fails. lse: an absolute 1e-4 for both.
BF16_ATOL, BF16_REL = 2e-2, 2e-2
FP32_ATOL = 1e-4
LSE_ATOL = 1e-4
# Phase 4 bounds on the logits' distance from the plain fp32 model. fp32
# kernels: 1e-4 * ||ref||inf (three seeds read at most 3.4e-6 relative).
# The served bf16 kernels: 1.5 times the plain bf16 model's own distance
# (three seeds read 0.87 to 1.16 times), which is bf16 rounding over 12
# layers, up to 0.09 of ||ref||inf.
LOGITS_REL_FP32 = 1e-4
BF16_VS_PLAIN = 1.5


def close(out, ref, atol: float, rel: float = 0.0) -> tuple[float, float, bool]:
    """Max abs error of ``out`` against fp32 ``ref`` and the bound ``atol
    + rel * max|ref|``. Entries where the plain version has no value
    (NaN: a row that sees no key) must be 0 in the kernel."""
    import torch

    ref = ref.float()
    ref = torch.where(torch.isnan(ref), torch.zeros_like(ref), ref)
    err = (out.float() - ref).abs().max().item()
    tol = atol + rel * ref.abs().max().item()
    ok = err <= tol and bool(torch.isfinite(out.float()).all())
    return err, tol, ok


def lse_close(out, ref) -> tuple[float, bool]:
    """Max abs lse error; a row that sees no key must be -inf in both."""
    import torch

    masked = torch.isneginf(ref)
    if not torch.equal(masked, torch.isneginf(out)):
        return float("inf"), False
    err = (out - ref).abs().masked_fill(masked, 0.0).max().item()
    return err, err <= LSE_ATOL


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernels(A, torch, gen, dev) -> dict[str, dict[str, float]]:
    """Phase 3. Returns the worst error per kernel and input dtype;
    raises on a miss."""
    worst = {k: {"bfloat16": 0.0, "float32": 0.0} for k in ("flash_fwd", "decode_attention")}
    bad = []

    cases = [(s, s, c, None) for s in (16, 128, 1000, 2048) for c in (True, False)]
    cases += [(2048, 2048, True, 256), (64, 1024, True, None)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).rsplit(".", 1)[-1]
        atol, rel = (BF16_ATOL, BF16_REL) if dtype == torch.bfloat16 else (FP32_ATOL, 0.0)

        def rand(*shape):
            return torch.randn(*shape, generator=gen).to(dev, dtype)

        for d in (128, 64):
            for sq, sk, causal, window in cases:
                q, k, v = rand(2, 8, sq, d), rand(2, 8, sk, d), rand(2, 8, sk, d)
                o, lse = A.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
                torch.cuda.synchronize()
                qf, kf, vf = q.float(), k.float(), v.float()
                ref = A.attention_reference(qf, kf, vf, causal=causal, window=window)
                ref_lse = A.attention_lse_reference(qf, kf, causal=causal, window=window)
                err, tol, ok = close(o, ref, atol, rel)
                lerr, lok = lse_close(lse, ref_lse)
                worst["flash_fwd"][dname] = max(worst["flash_fwd"][dname], err)
                name = (f"flash_fwd {dname} b2 h8 d{d} seq_q {sq} seq_k {sk} "
                        f"causal={causal} window={window}")
                print(f"  {name}: o err {err:.3e} (bound {tol:.3e}), "
                      f"lse err {lerr:.3e} (bound {LSE_ATOL:.0e})", flush=True)
                if not (ok and lok):
                    bad.append(name)
        for d in (128, 64):
            for hkv in (8, 2):
                for s in (1, 5):
                    for window in (None, 256):
                        q = rand(4, 8, s, d)
                        kc, vc = rand(4, hkv, 2048, d), rand(4, hkv, 2048, d)
                        vl = torch.tensor([0, 1, 700, 2048], dtype=torch.int32, device=dev)
                        o = A.decode_attention(q, kc, vc, vl, window=window)
                        torch.cuda.synchronize()
                        ref = A.decode_attention_reference(
                            q.float(), kc.float(), vc.float(), vl, window=window)
                        err, tol, ok = close(o, ref, atol, rel)
                        worst["decode_attention"][dname] = max(worst["decode_attention"][dname], err)
                        name = (f"decode_attention {dname} b4 h8 hkv {hkv} d{d} s {s} cap 2048 "
                                f"valid_len [0,1,700,2048] window={window}")
                        print(f"  {name}: err {err:.3e} (bound {tol:.3e})", flush=True)
                        if not ok:
                            bad.append(name)
    if bad:
        raise AssertionError("kernel disagrees with its plain version: " + "; ".join(bad))
    return worst


def check_logits(model, torch, prompts, answers, dev) -> None:
    """Phase 4 check, for two requests: the logits at the last prompt
    position (a fresh-cache prefill, through flash_fwd) and after the
    first answer token (one decode step, through decode_attention),
    against the full causal forward over prompt + first token with the
    plain attention versions and fp32 weights (the served bf16 weights
    cast up).

    - fp32: the same fp32 weights on the fp32 kernels, within
      ``LOGITS_REL_FP32 * ||ref||inf``. This is the check a kernel fault
      fails.
    - bf16: the served model on the bf16 kernels, within
      ``BF16_VS_PLAIN`` times the distance of the plain bf16 model; its
      first greedy token is the plain argmax up to a near-tie.
    """
    fp32 = model.clone(dtype="float32")
    plain = fp32.clone(attention_impl="reference")
    plain_bf16 = model.clone(attention_impl="reference")
    for i in (0, 3):
        prompt = torch.tensor(prompts[i], dtype=torch.long, device=dev)[None]
        first = answers[i][0]
        nxt = torch.tensor([[first]], device=dev)
        seq = torch.cat([prompt, nxt], dim=1)
        ref = plain(seq)[0, -2:]
        scale = ref.abs().max(dim=-1).values
        noise = (plain_bf16(seq)[0, -2:] - ref).abs().max(dim=-1).values
        for m, bounds in ((fp32, LOGITS_REL_FP32 * scale), (model, BF16_VS_PLAIN * noise)):
            dname = str(m.dtype).rsplit(".", 1)[-1]
            cache = m.init_cache(1)
            got = torch.stack([m(prompt, cache, fresh=True)[0, -1], m(nxt, cache)[0, -1]])
            errs = (got - ref).abs().max(dim=-1).values
            for j, step in enumerate(("prefill", "decode step")):
                err, tol = errs[j].item(), bounds[j].item()
                extra = (f"; plain bf16 model {noise[j].item():.3e}" if m is model else "")
                print(f"  request {i} (prompt {prompt.shape[1]}) {dname}: {step} logits "
                      f"|kernel - plain fp32|inf {err:.3e} (bound {tol:.3e}){extra}; "
                      f"||ref||inf {scale[j].item():.3e}", flush=True)
                if not err <= tol:
                    raise AssertionError(f"request {i} {dname} {step} logits disagree")
        best = int(torch.argmax(ref[0]))
        tie = ref[0].max().item() - ref[0][first].item()
        print(f"  request {i}: first greedy token {first}, plain fp32 argmax {best}", flush=True)
        if first != best and not tie <= 2 * noise[0].item():
            raise AssertionError(f"request {i}: first token {first} != plain argmax {best}")


def time_kernels(A, torch, gen, dev, launches, worst) -> list[dict]:
    """Phase 5: each kernel at the serving path's shapes."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    rows = []

    # flash_fwd: an admission wave of 4 prompts in the 2048 bucket.
    b, h, s, d = 4, 8, 2048, 128
    q, k, v = (torch.randn(b, h, s, d, generator=gen).to(dev, bf16) for _ in range(3))
    pairs = b * h * s * (s + 1) // 2  # visible (query, key) pairs, causal
    flops = 4 * d * pairs
    nbytes = 4 * b * h * s * d * 2 + b * h * s * 4
    rows.append(dict(
        name="flash_fwd", route="cuda", source="hops_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="hops_tpu/ops/attention.py:172",
        shape=f"q,k,v ({b},{h},{s},{d}) bf16 causal",
        launches=launches["flash_fwd"], max_abs_err=worst["flash_fwd"]["bfloat16"],
        ms=cuda_ms(lambda i=0: A.flash_attention(q, k, v, causal=True), 20),
        plain_ms=cuda_ms(lambda i=0: A.attention_reference(q, k, v, causal=True), 5),
        library_ms=cuda_ms(lambda i=0: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20),
        **bound(flops, nbytes),
    ))

    # decode_attention: one decode step of 4 slots, one cache per layer
    # (12 layers, 400 MB) so the reads come from HBM, not the L2 cache.
    b, h, cap, layers = 4, 8, 2048, 12
    vl_host = [p + n // 2 for p, n in zip(PROMPT_LENS[:4], NEW_TOKENS[:4])]
    vl = torch.tensor(vl_host, dtype=torch.int32, device=dev)
    q = torch.randn(b, h, 1, d, generator=gen).to(dev, bf16)
    caches = [(torch.randn(b, h, cap, d, generator=gen).to(dev, bf16),
               torch.randn(b, h, cap, d, generator=gen).to(dev, bf16)) for _ in range(layers)]
    mask = (torch.arange(cap, device=dev)[None, :] < vl[:, None])[:, None, None, :]
    keys = sum(vl_host)
    flops = 4 * d * h * keys
    nbytes = 2 * h * d * 2 * keys + 2 * b * h * d * 2 + b * 4
    rows.append(dict(
        name="decode_attention", route="cuda", source="hops_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="hops_tpu/ops/attention.py:643",
        shape=f"q ({b},{h},1,{d}), cache ({b},{h},{cap},{d}) bf16, valid_len {vl_host}",
        launches=launches["decode_attention"], max_abs_err=worst["decode_attention"]["bfloat16"],
        ms=cuda_ms(lambda i=0: A.decode_attention(q, *caches[i % layers], vl), 120),
        plain_ms=cuda_ms(lambda i=0: A.decode_attention_reference(q, *caches[i % layers], vl), 24),
        library_ms=cuda_ms(
            lambda i=0: F.scaled_dot_product_attention(q, *caches[i % layers], attn_mask=mask), 120),
        **bound(flops, nbytes),
    ))
    return rows


def profile_decode(engine, torch, prompts, steps: int = 10) -> None:
    """Phase 6: a ``torch.profiler`` trace of ``steps`` engine decode
    steps with all 4 slots busy — device busy time per step, the idle
    share of the wall time, and the kernels that take the device time.
    The profiler's own host cost inflates the wall time."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts[:4]:
        engine.submit(p, max_new_tokens=steps + 8)
    for _ in range(4):  # admission, then warm decode steps
        engine.step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    engine.run()
    kernels = [
        (e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy = sum(ms for _, ms, _ in kernels)
    if not busy:
        raise AssertionError("the profiler recorded no device time")
    print(f"phase 6 profile: {steps} decode steps at 4 busy slots: wall {wall_ms:.3f} ms/step "
          f"(profiled), device busy {busy:.3f} ms/step, idle share {1 - busy / wall_ms:.3f}, "
          f"{sum(n for _, _, n in kernels)} kernel launches/step", flush=True)
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:8]:
        print(f"  {ms:.4f} ms/step ({ms / busy:.1%} of busy, {n}/step) {name[:90]}", flush=True)


def bound(flops: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    if not (ROOT / "hops_tpu_torch" / "ops" / "csrc").is_dir():
        return fail(f"no hops_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, save_lm_artifact
    from hops_tpu_torch.ops import _build
    from hops_tpu_torch.ops import attention as A
    from hops_tpu_torch.runtime.devices import card

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card_line = card()
    print("phase 1 card:", flush=True)
    print(card_line, flush=True)

    t0 = time.perf_counter()
    report = _build.build()
    print("phase 2 build: " + ", ".join(
        f"{n} {r['seconds']:.1f} s" for n, r in report.items()
    ) + f" (wall {time.perf_counter() - t0:.1f} s, one nvcc per source, in parallel)", flush=True)
    for name, r in report.items():
        regs = re.findall(r"Used (\d+) registers", r["ptxas"])
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", r["ptxas"])]
        print(f"  {name}: registers per instantiation {regs}, "
              f"spill stores {max(spills, default=0)} bytes", flush=True)

    gen = torch.Generator().manual_seed(args.seed)
    print("phase 3 kernels against plain versions (bf16 and fp32 in, fp32 plain):", flush=True)
    with torch.inference_mode():
        worst = check_kernels(A, torch, gen, dev)
    print("phase 3 ok: worst error " + ", ".join(
        f"{k} {w['bfloat16']:.3e} (bf16) {w['float32']:.3e} (fp32)" for k, w in worst.items()
    ), flush=True)

    art = ROOT / "_smoke" / "artifact"
    predictor = None
    try:
        t0 = time.perf_counter()
        save_lm_artifact(art, MODEL, random_params(**MODEL, seed=args.seed))
        predictor = LMEnginePredictor(art, {"slots": 4})
        print(f"phase 4 slice: artifact written and loaded in "
              f"{time.perf_counter() - t0:.1f} s ({MODEL})", flush=True)
        rng = torch.Generator().manual_seed(args.seed + 1)
        prompts = [torch.randint(0, MODEL["vocab_size"], (n,), generator=rng).tolist()
                   for n in PROMPT_LENS]
        instances = [{"prompt": p, "max_new_tokens": n, "temperature": 0.0}
                     for p, n in zip(prompts, NEW_TOKENS)]
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        answers = predictor.predict(instances)
        wall = time.perf_counter() - t0
        launches = A.launch_counts()
        stats = predictor.stats()
        ttft = predictor.last_ttft_s
        for p, n, ans in zip(PROMPT_LENS, NEW_TOKENS, answers):
            if len(ans) != n:
                return fail(f"request with prompt {p} answered {len(ans)} tokens, not {n}")
        if not all(launches[name] > 0 for name in A.LAUNCHES):
            return fail(f"a kernel of the path never launched: {launches}")
        decode_tok_s = stats["decode_tokens"] / stats["decode_s"]
        print(f"  answers: {[len(a) for a in answers]} tokens; launches {launches}; "
              f"admission waves {stats['admission_waves']}, decode steps {stats['dispatches']}",
              flush=True)
        print(f"  ttft_ms {[round(t * 1e3, 1) for t in ttft]}; decode {decode_tok_s:.1f} tokens/s "
              f"({stats['decode_tokens']} tokens in {stats['decode_s']:.3f} s of decode steps); "
              f"prefill {stats['prefill_s']:.3f} s; wall {wall:.3f} s; card {card_line}", flush=True)
        with torch.inference_mode():
            check_logits(predictor.engine.model, torch, prompts, answers, dev)
        print("phase 4 ok", flush=True)
        with torch.inference_mode():
            rows = time_kernels(A, torch, gen, dev, launches, worst)
        for r in rows:
            print(f"phase 5 {r['name']} at {r['shape']}: {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms; "
                  f"scaled_dot_product_attention {r['library_ms']:.4f} ms; card {card_line}", flush=True)
        predictor.stop()  # the engine is now driven from this thread alone
        profile_decode(predictor.engine, torch, prompts)
    finally:
        if predictor is not None:
            predictor.stop()
        shutil.rmtree(ROOT / "_smoke", ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err",
                           "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
