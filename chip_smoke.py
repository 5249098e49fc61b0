#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hops_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root; it needs one CUDA device and ``nvcc``. The
phases run in order, each prints its result on its own line, and any
failure exits non-zero:

1. card     — the card's name and power limit (``nvidia-smi``);
2. build    — all seven kernels compiled from ``hops_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, six sources), with the build's wall time;
   for the bf16 tensor-core bodies (head dims 64 and 128) the registers
   and spills ptxas reports, the dynamic shared memory they launch with
   and, where ``cuobjdump`` exists, the count of HGMMA instructions in
   their SASS, which must not be 0: the ping-pong forward body of K1 over
   bf16 K/V and of K5's wide calls over int8 K/V (64-key tiles, printed),
   which must neither spill nor have its wgmmas serialized by ptxas
   (warning C7520), K2, K3, and the chunk body of K6 (bf16
   pools) and K7 (int8 pools), which must not spill; for the split-K body of K4,
   K5 (dense) and K6, K7 (paged), over bf16/fp32 and int8 caches, and its
   combine kernel their registers, stack frame, spills and shared memory;
3. kernels  — the forward and decode kernels (K1, K4) against their
   plain PyTorch versions (fp32) on the same seeded inputs: K1's bf16
   tensor-core body per element within its rounding bound (below); K4's
   decode calls (rows <= 16, its split-K body) with bf16 inputs per
   element within ``2**-8 * |plain| + 1e-4``, also across its 128-key
   split boundaries (``DENSE_SPLIT_CASES``), and its wider calls (the
   64-row body) within ``2e-2 + 2e-2 * max|plain|``; fp32 inputs at the
   same shapes within 1e-4, and the flash kernel's lse within 1e-4;
3b. backward — the flash backward kernels (K2 dq, K3 dk/dv) against
   their plain versions on the same (o, lse) from K1, at the same
   shapes plus a negative offset (rows that see no key), a window past
   an offset (keys no query sees) and ragged tails of K2's 128-row and
   64-key tiles: the bf16 tensor-core bodies of K2 and K3 within their
   rounding bounds, fp32 inputs within ``1e-4 * max(1, max|plain|)`` per
   output, and exact zeros in dq for rows that see no key and in dk/dv
   for keys that no query sees (outputs are allocated over freed
   NaN-filled memory first);
3c. caches  — the int8 and paged decode kernels (K5 dense int8, K6 paged
   bf16/fp32 pools, K7 paged int8 pools) against their plain versions:
   d 64/128, MHA and GQA (8 q heads on 2 kv heads), 1 and 256 query
   tokens, ragged valid_len (0, 1, a tile or page boundary ± 1, full
   capacity), window 256, pages of 64, 16 and 24 on shuffled tables whose
   free rows are all zeros, int8 values from ``quantize_kv``; bf16 and
   fp32 queries at the phase-3 bounds, outputs over freed NaN memory,
   and bit-identical outputs when the scratch block 0 holds ±1e30 (NaN
   in fp32 pools; NaN/1e30 scales for int8); then K6's split-K body on
   decode calls across its 128-key split boundaries (valid_len L - 1, L,
   L + 1, full capacity, 0; a window that empties the leading splits;
   GQA rows 4, chunks of rows 5 and 8; pages 16 and 24; capacities 2000
   and 2064, not multiples of L), then K6's bf16 prefill-chunk body
   (``WIDE_CASES``: rows 17, 100 and 256, GQA rows 20 and 100, and s =
   capacity 512; pages 64,
   16 and 24; valid_len 0, below s, a page boundary + 1, past the row's
   allocated blocks (its pad positions read the scratch block) and full
   capacity; window 256; the scratch block at ±1e30 changes no bit of a
   row that does not reach it). K6's decode calls (rows <= 16, the split
   body) with bf16 inputs are held per element to ``2**-8 * |plain| +
   1e-4``: the body computes in fp32 and rounds only its output, so that
   is all the room bf16 gives it; its bf16 prefill chunks to the
   tensor-core rounding bound below (p rounded for p·v). Then the int8
   bodies of K5 (dense) and K7 (paged): the split body on decode calls
   (``Q8_SPLIT_CASES``: valid_len L - 1, L, L + 1, full, 0; a window that
   empties the leading splits; GQA rows 4 and 16; a chunk of rows 5;
   pages 64, 16, 24) with
   bf16 queries per element within ``2**-8 * |plain| + 1e-4`` and fp32
   within 1e-4, and the keys that no row may read (K7: scratch block 0;
   K5: positions past valid_len) poisoned, values at ±127 and scales at
   NaN/1e30, changing no bit; the wide bf16 calls (``WIDE_CASES``: K5
   on the forward body over the dense int8 cache, K7's chunk body on
   pages 64, 16, 24; valid_len 0, below s, full; s = capacity 512 and
   255, full causal; s = 129 against capacity 2048) within the
   tensor-core rounding bound with ``mag`` from the dequantized |v|,
   and K5 at the int8 engine's admission prefill as phase 5 times it (q
   (4, 8, 2048, d), valid_len 2048, causal: 16 row tiles per head). The cases
   and operands come from ``hops_tpu_torch/ops/kernel_checks.py``, which
   the card tests share;
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
   device busy time, idle share, the kernels that take the time, and
   K4's share (its split body and combine must launch, the 64-row body
   must not);
7. train    — the training slice at full width: the same LM with fp32
   master weights and bf16 compute, ``create_train_state`` (Adam 1e-3)
   and ``make_lm_train_step(loss_chunk=512)`` on one seeded batch of
   8 x 2048 tokens, 2 warm-up and 6 timed steps. Every loss must be
   finite, the last below the first, and K1, K2 and K3 must launch 12
   times a step (counts reset just before the timed steps). Prints step
   ms, tokens/s and MFU (``bench.py``'s model-FLOPs accounting against
   989 TFLOP/s) and a ``torch.profiler`` breakdown of one step;
7b. grads   — the same widths at 2 layers, fp32 weights and compute,
   batch 2 x 2048: every parameter gradient of the kernel path within
   ``1e-3 * ||ref||inf`` of the same model on the plain attention
   (``attention_impl="reference"``); then a bf16 row, fp32 weights and
   bf16 compute as in phase 7, over 3 token batches: per parameter, the
   kernel path's 2-norm distance from the plain fp32 gradient at most
   1.5 times the plain bf16 path's own distance;
8. caches   — phase 4's artifact and requests served three more times:
   (a) the int8 cache (K5), (b) the paged cache with 256-token prefill
   chunks and the parity pool (K6), (c) the paged int8 cache on 65
   blocks (K7), where the four largest requests do not fit together, so
   admission queues. Every answer must have its full length, the slice's
   kernel must launch and K1/K4 must not, and (c) must use at least 90%
   of its pool at peak. Prints TTFT, decode tokens/s, prefill chunks,
   preemptions, peak blocks, the persistent KV bytes against phase 4's
   dense cache and how many streams equal phase 4's; then serves the
   same requests again, outside the timed pass, keeping the logits the
   engine draws each token from, and prints that pass's decode tokens/s
   (the cost of keeping them), whether its streams equal the timed
   pass's and, for each stream that differs from phase 4's, the engine's
   own margin at the first difference: its token's logit minus phase 4's
   token's and minus the runner-up's (a near tie that rounding decides
   reads far below the bf16 model's distance from fp32); checks the logits
   of two requests as phase 4 does, against the plain attention
   versions on the same cache type; after (b), a ``torch.profiler``
   trace of one fused prefill-chunk step (device busy, and the share of
   K6's tensor-core chunk body, which must launch where the 64-row body
   must not) and of 10 paged decode steps at 4 busy slots (as phase 6:
   device busy, idle share, launches per step, and K6's share), and the
   same two profiles of (c) with K7's share; after (a), a trace of one
   admission wave (4 prompts), which must run K5's forward body over
   int8 K/V and neither the chunk body nor K1's bf16 instantiation. (a)
   must launch its int8 split body (decode) and forward body (prefill,
   counted as ``decode_attention_q8_chunk``), (b) K6's split body and
   chunk body, (c) K7's int8 split body and chunk body;
8b. parity  — 2 layers at full width in fp32: the paged engine against
   the dense engine of the same cache dtype (fp32 pools, int8 pools) on
   a pool of 5 usable blocks that forces a preemption; greedy streams
   identical unless the dense engine's top-2 logit gap at the first
   difference is under ``1e-4 * ||logits||inf`` (printed);
9. launch   — the experiment launcher and preemption-safe checkpoints:
   (a) ResNet-50 (1000 classes, 224x224x3, bf16 compute, fp32 weights
   and BatchNorm statistics, channels-last, batch 128, SGD with momentum
   0.9 at lr 0.1 on seeded ``SyntheticClassData``) and (b) the LM at
   phase 7's widths on 2 layers (fp32 masters, bf16 compute, dropout
   0.1, batch 8 x 2048, loss chunk 512), each launched three times by
   ``experiment.launch`` with one wrapper that calls
   ``run_preemptible(save_every=4)`` over 8 steps: A straight through;
   B sent a real SIGTERM in its fifth step, so it checkpoints step 4
   and returns; C on B's checkpoint directory, which must resume at
   step 5 and finish. Under ``torch.use_deterministic_algorithms``,
   C's losses and final weights, statistics and optimizer state must
   equal A's bit for bit (where an op warns that it has no
   deterministic implementation, a second uninterrupted run sets the
   distance C may have from A, and the op is named). Every run must be
   registered FINISHED, its ``output.log`` must hold the wrapper's
   prints and its ``metrics.jsonl`` its losses, and every published
   step must verify against its manifest. (a) then plants a corrupt
   newest step, which ``restore_or_init`` must quarantine, falling back
   to the step before it, and profiles one more step with deterministic
   algorithms off (convolutions and matrix products against the rest);
   (b) must launch K1, K2 and K3, and K2 and K3 are each run twice on
   the same inputs to say whether they are bit-reproducible. Prints
   step ms, images or tokens per second, the checkpoint's bytes, the
   time a save holds the loop (the copy to host memory), the background
   write (with publish and checksums) and the restore, beside the
   card's name and power limit.

The rounding bound of a bf16 tensor-core body (K1's and K5's wide o,
K2's dq, K3's dk and dv, K6's and K7's chunk o) is per element ``2**-8 * (mag + |plain|) + slack``: each operand
that the body rounds to bf16 before a product (K1: p in p·v; K2: ds in
ds·k; K3: p^T in dv, ds^T in dk) moves the product by at most 2**-8
(bf16's unit roundoff) times the same product over magnitudes, ``mag``
(p·|v|, |ds|·|k|, p^T·|do|, |ds|^T·|q|); rounding the output adds
``2**-8 * |plain|``, and ``slack`` is the fp32 bound of the same kernel.
Each case prints its worst ratio of error to bound.

Phase 5's rows for K2 and K3 are timed after phase 7, at (8, 8, 2048,
128) bf16 causal, beside the launches per train step; its rows for K5,
K6 and K7 after phase 8b, at phase 5's decode shape, beside their
launches in phase 8, with their split counts; then the wide calls, each
a record of its own beside its launches in phase 8: K6 and K7 at the
width of a 256-token prefill chunk of every slot (their tensor-core
chunk body, ``paged_decode_attention_chunk`` and
``paged_decode_attention_q8_chunk``), and K5 at the int8 engine's
admission prefill, 4 prompts in the 2048 bucket causal over their own
int8 keys (the forward body, ``decode_attention_q8_chunk``). The
second-to-last line is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Nothing of JAX or of the
JAX package is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
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
# Phase 7: bench.py's LM (run_lm_bench) with fp32 masters, at the batch
# of hops_tpu/ops/xent.py's sizing note and bench.py's loss chunk.
TRAIN = dict(MODEL, param_dtype="float32", attention_impl="flash")
TRAIN_BATCH, TRAIN_SEQ, LOSS_CHUNK, LEARNING_RATE = 8, 2048, 512, 1e-3
WARMUP_STEPS, TIMED_STEPS = 2, 6
# Phase 7b: full width at 2 layers, fp32 weights and compute.
GRAD_CHECK = dict(MODEL, num_layers=2, dtype="float32")
GRAD_BATCH = 2
GRAD_REL = 1e-3
# Phase 7b's bf16 row: fp32 weights, bf16 compute (the train step's
# types), over GRAD_SEEDS token batches. A 2-norm over all of them, not
# the largest element of one batch, which swings with the rounding noise.
GRAD_BF16 = dict(dtype="bfloat16", param_dtype="float32")
GRAD_SEEDS = 3
# Phase 2: the bf16 tensor-core bodies, by source and the mangled
# instantiation at head dim {d} in ptxas's entry names: K1's forward body
# (flash_fwd_tc.cuh, bf16 K/V), K2, K3, and the forward body over int8 K/V
# in K5's source.
TC_BODIES = {"flash_fwd": ("3fwd10fwd_kernelILi{d}ELb0E", "forward body, bf16 K/V"),
             "flash_bwd_dq": ("2tc9dq_kernelILi{d}E", "tensor-core body"),
             "flash_bwd_dkv": ("2tc10dkv_kernelILi{d}E", "tensor-core body"),
             "decode_attention_q8": ("3fwd10fwd_kernelILi{d}ELb1E",
                                     "forward body, int8 K/V (64-key tiles)")}
# ... and the prefill-chunk body of K6 (bf16 pools) and K7 (int8 pools).
CHUNK_BODY = "chunk_kernel"
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# The device-kernel names of each, as the profiler reports them (bf16
# tensor-core bodies and fp32 FMA bodies).
TRAIN_KERNEL_NAMES = {"flash_fwd": ("fwd::fwd_kernel", "flash_fwd_kernel"),
                      "flash_bwd_dq": ("tc::dq_kernel", "flash_bwd_dq_kernel"),
                      "flash_bwd_dkv": ("tc::dkv_kernel", "flash_bwd_dkv_kernel")}
# The device kernels of the split-K body and its combine (decode steps
# of K4-K7), the tensor-core chunk body (bf16 prefill of K6, K7), the
# forward body over int8 K/V (bf16 prefill of K5; over bf16 K/V it is
# K1's) and the 64-row body (wider fp32 calls), as the profiler names them.
SPLIT_KERNEL_NAMES = ("split::split_kernel", "split::combine_kernel")
CHUNK_KERNEL_NAME = "chunk::chunk_kernel"
FWD_Q8_KERNEL_NAME = "fwd::fwd_kernel<128, true>"
ROWS_KERNEL_NAME = "decode_rows_kernel"
# Phase 8: (name, lm_config, the kernels it runs, every one of which must
# launch). (c)'s 64 usable blocks hold 4096 tokens, under the ~5000 the
# four largest requests reach.
CACHE_SLICES = (
    ("int8", {"slots": 4, "kv_cache_dtype": "int8"},
     ("decode_attention_q8", "decode_attention_q8_chunk")),
    ("paged", {"slots": 4, "kv_page_size": 64, "prefill_chunk": 256},
     ("paged_decode_attention", "paged_decode_attention_chunk")),
    ("paged-int8", {"slots": 4, "kv_cache_dtype": "int8", "kv_page_size": 64,
                    "kv_pool_blocks": 65, "prefill_chunk": 256},
     ("paged_decode_attention_q8", "paged_decode_attention_q8_chunk")),
)
# The paged engines profiled in phase 8: slice name -> the kernel's label.
PROFILED_SLICES = {"paged": "K6", "paged-int8": "K7"}
PEAK_POOL_SHARE = 0.9
# Phase 3c, K6's split-K body (128-key splits): (page, capacity, kv
# heads of 8 query heads, query tokens, valid_len per row, window).
SPLIT_CASES = (
    (64, 2048, 8, 1, [127, 128, 129, 2048, 0], None),  # L - 1, L, L + 1, full, empty
    (64, 2048, 2, 1, [1000, 700, 513, 2048, 1], 100),  # leading splits empty; GQA rows 4
    (16, 2000, 8, 5, [5, 258, 1531, 2000, 1999], None),  # rows 5; cap not a multiple of L
    (24, 2064, 2, 2, [2064, 255, 257, 0, 1025], 300),  # page 24; rows 8
)
# Phase 3, K4's split-K body (128-key splits) on the dense cache:
# (capacity, kv heads of 8 query heads, query tokens, valid_len per row,
# window).
DENSE_SPLIT_CASES = (
    (2048, 8, 1, [127, 128, 129, 2048, 0], None),  # L - 1, L, L + 1, full, empty
    (2048, 2, 1, [1000, 700, 513, 2048, 1], 100),  # leading splits empty; GQA rows 4
    (2000, 8, 5, [5, 258, 1531, 2000, 1999], None),  # rows 5; cap not a multiple of L
    (2048, 8, 8, [3, 255, 257, 0, 1025], 300),  # rows 8, valid_len 3 < s
)
# Phase 8b: two 60-token prompts with 70 new tokens each need 3 blocks
# of 64 apiece at their deepest write; the pool has 5.
PARITY = dict(MODEL, num_layers=2, dtype="float32")
PARITY_PROMPT, PARITY_NEW, PARITY_PAGE, PARITY_POOL = 60, 70, 64, 6
TIE_REL = 1e-4
# Phase 9: two models through experiment.launch + run_preemptible, three
# launches each (A straight through LAUNCH_STEPS steps; B SIGTERMed in
# step PREEMPT_AT, so it checkpoints that step and returns; C resumes
# from B's checkpoints), saving every SAVE_EVERY steps. (a) ResNet-50 at
# bench.py run_bench's batch and image size; (b) the LM at phase 7's
# widths on 2 layers (a checkpoint of ~1.1 GB: fp32 weights and Adam's
# moments), dropout on.
LAUNCH_STEPS, SAVE_EVERY, PREEMPT_AT = 8, 4, 4
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 128, 224, 1000
LAUNCH_LM = dict(TRAIN, num_layers=2, dropout_rate=0.1)
# The convolutions' kernels (forward, data and weight gradients) and the
# classifier's matrix product, as the profiler names them: cuDNN's own,
# and the cuBLAS GEMMs cuDNN hands 1x1 convolutions to.
CONV_KERNELS = r"conv|cudnn|xmma|implicit|dgrad|wgrad|fprop|gemm|nvjet|cutlass"

# Phase 3c and 5: the cache kernels and the TPU kernels they replace.
CACHE_KERNELS = {
    "decode_attention_q8": ("decode_attention_q8.cu", 1211),
    "decode_attention_q8_chunk": ("flash_fwd_tc.cuh", 1211),
    "paged_decode_attention": ("paged_decode_attention.cu", 916),
    "paged_decode_attention_chunk": ("decode_chunk.cuh", 916),
    "paged_decode_attention_q8": ("paged_decode_attention_q8.cu", 965),
    "paged_decode_attention_q8_chunk": ("decode_chunk.cuh", 965),
}


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


# Phase 3 bounds. bf16 inputs of the kernels that compute in fp32
# (K4-K7): 2e-2 + 2e-2 * max|plain|, room for the bf16 output's rounding;
# the split body of K4 and K6 per element to that rounding
# (output_rounding_close). The bf16 tensor-core bodies of K1, K2, K3 and
# K6's chunks round operands too, and are held per element to the bound
# that rounding allows (rounding_close).
# fp32 inputs at the same shapes: an absolute 1e-4, tight enough that one
# dropped key tile of a long row fails. lse: an absolute 1e-4 for both.
BF16_ATOL, BF16_REL = 2e-2, 2e-2
BF16_U = 2.0 ** -8  # unit roundoff of bf16 (8 significant bits, to nearest)
FP32_ATOL = 1e-4
LSE_ATOL = 1e-4
# Phase 3b, fp32 inputs: 1e-4 * max(1, max|plain|) per output (gradients
# grow with the row length, the forward's output does not).
BWD_FP32_REL = 1e-4
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


def rounding_close(out, ref, mag, slack: float) -> tuple[float, float, bool]:
    """``(max |out - ref|, worst |out - ref| / bound, ok)`` for a bf16
    tensor-core body against fp32 ``ref``, per element ``bound = BF16_U *
    (mag + |ref|) + slack``: ``mag`` is the product whose operand the
    body rounds, over magnitudes. Entries where ``ref`` is NaN (a row that
    sees no key) must be 0 in ``out``."""
    import torch

    ref = torch.nan_to_num(ref.float(), nan=0.0)
    mag = torch.nan_to_num(mag.float(), nan=0.0)
    err = (out.float() - ref).abs()
    ratio = (err / (BF16_U * (mag + ref.abs()) + slack)).max().item()
    return err.max().item(), ratio, ratio <= 1.0 and bool(torch.isfinite(out.float()).all())


def output_rounding_close(out, ref) -> tuple[float, float, bool]:
    """:func:`rounding_close` for a body that computes in fp32 from bf16
    inputs and rounds only its output (K6's split body): per element
    ``BF16_U * |ref| + FP32_ATOL``."""
    return rounding_close(out, ref, ref.new_zeros(()), FP32_ATOL)


def lse_close(out, ref) -> tuple[float, bool]:
    """Max abs lse error; a row that sees no key must be -inf in both."""
    import torch

    masked = torch.isneginf(ref)
    if not torch.equal(masked, torch.isneginf(out)):
        return float("inf"), False
    err = (out - ref).abs().masked_fill(masked, 0.0).max().item()
    return err, err <= LSE_ATOL


def cuda_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn(i)``, over ``iters`` calls. The calls
    queue up behind a device-side sleep (some 25 ms) before the first
    event, so a call whose host work outlasts its kernel does not leave
    the device idle between launches and inflate the time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_entries(text: str) -> dict[str, dict[str, int]]:
    """Registers, stack frame and spill bytes per entry function of a
    ``-Xptxas=-v`` report."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            out[name]["stack"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def hgmma_counts(cuobjdump: str, path: str) -> dict[str, int]:
    """HGMMA instructions per function in a library's SASS ({} without
    ``cuobjdump``)."""
    import subprocess

    if not Path(cuobjdump).exists():
        return {}
    dump = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    return {fn: text.count("HGMMA") for fn, text in re.findall(
        r"Function : (\S+)(.*?)(?=Function : |\Z)", dump, re.S)}


def report_tc_body(name: str, fn: str, e: dict, smem: int, sass: dict, label: str) -> None:
    hgmma = sass.get(fn) if sass else None
    print(f"  {name} {label}: {e['registers']} registers, stack frame {e['stack']} bytes, "
          f"spill stores {e['spill_stores']} bytes, "
          f"spill loads {e['spill_loads']} bytes, dynamic shared memory {smem} bytes, HGMMA "
          "instructions " + ("not counted (no cuobjdump)" if hgmma is None else str(hgmma)),
          flush=True)
    if hgmma == 0:
        raise AssertionError(f"{name} {label}: the bf16 body has no HGMMA instruction")


def report_tc_bodies(_build, report) -> None:
    """Phase 2 for the bf16 tensor-core bodies: K1's forward body over
    bf16 K/V and over int8 K/V (K5's wide calls, 64-key tiles), K2, K3,
    and the prefill-chunk body (K6 over bf16 pools, K7 over int8): per
    head dim the registers and spills from ptxas, the dynamic shared
    memory from the library, and the HGMMA count in the SASS (fails at 0;
    the forward and chunk bodies also fail on a spill, and the forward
    body when ptxas serialized its wgmmas, warning C7520, which a wgmma
    on a branch causes). Then the
    registers, stack frame, spills and shared memory of the split-K body
    of K4, K5 (dense) and K6, K7 (paged), per (query dtype, cache type,
    head dim, rows bucket), and of its combine kernel."""
    import ctypes

    cuobjdump = shutil.which("cuobjdump") or str(Path(_build.nvcc()).parent / "cuobjdump")
    for name, (pattern, what) in TC_BODIES.items():
        r = report[name]
        entries = ptxas_entries(r["ptxas"])
        q8 = name == "decode_attention_q8"
        smem = getattr(ctypes.CDLL(r["path"]),
                       _build.KERNELS[name][1] + ("_chunk_smem_bytes" if q8 else "_smem_bytes"))
        smem.argtypes, smem.restype = [ctypes.c_int] * (1 if q8 else 2), ctypes.c_int
        sass = hgmma_counts(cuobjdump, r["path"])
        for d in (64, 128):
            fn = next(n for n in entries if pattern.format(d=d) in n)
            e = entries[fn]
            label = f"bf16 {what} d{d}"
            report_tc_body(name, fn, e, smem(d) if q8 else smem(d, 1), sass, label)
            if "forward" in what and (e["spill_stores"] or e["spill_loads"]):
                raise AssertionError(f"{name} {label} spills")
            if "forward" in what and any("(C7520)" in line and pattern.format(d=d) in line
                                         for line in r["ptxas"].splitlines()):
                raise AssertionError(f"{name} {label}: ptxas serialized its wgmmas (C7520)")
    # The chunk body: (kernel, cache type as mangled), in the kernel's own
    # source, with its `<entry>_chunk_smem_bytes`.
    for name, kv in (("paged_decode_attention", "13__nv_bfloat16"), ("paged_decode_attention_q8", "a")):
        r = report[name]
        entries = ptxas_entries(r["ptxas"])
        smem = getattr(ctypes.CDLL(r["path"]), _build.KERNELS[name][1] + "_chunk_smem_bytes")
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        sass = hgmma_counts(cuobjdump, r["path"])
        for d in (64, 128):
            fn = next(n for n in entries if f"{CHUNK_BODY}ILi{d}E{kv}E" in n)
            e = entries[fn]
            label = f"tensor-core chunk body, paged {'int8' if kv == 'a' else 'bf16'} K/V, d{d}"
            report_tc_body(name, fn, e, smem(d), sass, label)
            if e["spill_stores"] or e["spill_loads"]:
                raise AssertionError(f"{name} {label} spills")
    split_smem = ctypes.CDLL(report["decode_attention"]["path"]).hops_split_smem_bytes
    split_smem.argtypes, split_smem.restype = [ctypes.c_int] * 3, ctypes.c_int
    for name in ("decode_attention", "decode_attention_q8", "paged_decode_attention",
                 "paged_decode_attention_q8"):
        for fn, e in sorted(ptxas_entries(report[name]["ptxas"]).items()):
            # The cache type after the query's: int8 (a), or the query's own
            # (f, or a substitution of __nv_bfloat16); the combine has none.
            m = re.search(r"(split_kernel|combine_kernel)I(f|13__nv_bfloat16)(f|a|S\d*_)?"
                          r"Li(\d+)E(?:Li(\d+)ELb[01]E)?", fn)
            if m:
                kind, t, kv, d, rows = m.groups()
                cache = "" if kv is None else (" int8 K/V" if kv == "a" else " same-type K/V")
                smem_b = ""
                if kind == "split_kernel":
                    elem = 1 if kv == "a" else (4 if t == "f" else 2)
                    smem_b = f", shared memory {split_smem(elem, int(d), int(rows))} bytes"
                print(f"  {name} {kind} {'bf16' if t != 'f' else 'fp32'} q{cache} d{d}"
                      + (f" rows<={rows}" if rows else "") + f": {e['registers']} registers, "
                      f"stack frame {e['stack']} bytes, spill stores {e['spill_stores']} bytes, "
                      f"spill loads {e['spill_loads']} bytes{smem_b}", flush=True)


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
                if dtype == torch.bfloat16:  # the tensor-core body rounds p for p·v
                    mag = A.attention_reference(qf, kf, vf.abs(), causal=causal, window=window)
                    err, ratio, ok = rounding_close(o, ref, mag, FP32_ATOL)
                    bound_note = f"worst err/rounding bound {ratio:.3f}"
                else:
                    err, tol, ok = close(o, ref, atol, rel)
                    bound_note = f"bound {tol:.3e}"
                lerr, lok = lse_close(lse, ref_lse)
                worst["flash_fwd"][dname] = max(worst["flash_fwd"][dname], err)
                name = (f"flash_fwd {dname} b2 h8 d{d} seq_q {sq} seq_k {sk} "
                        f"causal={causal} window={window}")
                print(f"  {name}: o err {err:.3e} ({bound_note}), "
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
                        if dtype == torch.bfloat16 and (8 // hkv) * s <= A.SPLIT_ROWS:
                            err, ratio, ok = output_rounding_close(o, ref)  # the split body
                            bound_note = f"split body, worst err/rounding bound {ratio:.3f}"
                        else:
                            err, tol, ok = close(o, ref, atol, rel)
                            bound_note = f"bound {tol:.3e}"
                        worst["decode_attention"][dname] = max(worst["decode_attention"][dname], err)
                        name = (f"decode_attention {dname} b4 h8 hkv {hkv} d{d} s {s} cap 2048 "
                                f"valid_len [0,1,700,2048] window={window}")
                        print(f"  {name}: err {err:.3e} ({bound_note})", flush=True)
                        if not ok:
                            bad.append(name)
            # K4's split body across its split boundaries.
            err_split = ratio_split = 0.0
            for cap, hkv, s, valid, window in DENSE_SPLIT_CASES:
                vl = torch.tensor(valid, dtype=torch.int32, device=dev)
                q = rand(len(valid), 8, s, d)
                kc, vc = rand(len(valid), hkv, cap, d), rand(len(valid), hkv, cap, d)
                before = A.launch_counts()["decode_attention"]
                o = A.decode_attention(q, kc, vc, vl, window=window)
                torch.cuda.synchronize()
                ref = A.decode_attention_reference(q.float(), kc.float(), vc.float(), vl,
                                                   window=window)
                if dtype == torch.bfloat16:
                    err, ratio, ok = output_rounding_close(o, ref)
                    ratio_split = max(ratio_split, ratio)
                    miss = f"err/rounding bound {ratio:.3f}"
                else:
                    err, tol, ok = close(o, ref, atol)
                    miss = f"{err:.3e} > {tol:.3e}"
                err_split = max(err_split, err)
                ok = ok and not o[vl == 0].any()
                ok = ok and A.launch_counts()["decode_attention"] == before + 1
                if not ok:
                    bad.append(f"decode_attention split body {dname} d{d} cap {cap} hkv {hkv} "
                               f"s {s} valid_len {valid} window={window}: {miss}")
            worst["decode_attention"][dname] = max(worst["decode_attention"][dname], err_split)
            bound_note = (f"per element 2^-8*|plain| + {FP32_ATOL:.0e}, worst err/bound "
                          f"{ratio_split:.3f}" if dtype == torch.bfloat16 else f"bound {atol:.0e}")
            print(f"  {dname} d{d}: decode_attention split body over {len(DENSE_SPLIT_CASES)} "
                  f"split-boundary cases: worst err {err_split:.3e} ({bound_note})", flush=True)
    if bad:
        raise AssertionError("kernel disagrees with its plain version: " + "; ".join(bad))
    return worst


def unseen(torch, sq, sk, causal, window, q_offset, dev):
    """``(rows that see no key, keys that no query sees)`` as boolean
    ``(sq,)`` and ``(sk,)`` masks of the causal/window band."""
    if not causal:
        return torch.zeros(sq, dtype=torch.bool, device=dev), torch.zeros(sk, dtype=torch.bool, device=dev)
    off = sk - sq if q_offset is None else q_offset
    gap = (torch.arange(sq, device=dev)[:, None] + off) - torch.arange(sk, device=dev)[None, :]
    vis = gap >= 0
    if window:
        vis &= gap < window
    return ~vis.any(1), ~vis.any(0)


def check_bwd_kernels(A, torch, gen, dev) -> dict[str, dict[str, float]]:
    """Phase 3b. Returns the worst error per backward kernel and input
    dtype; raises on a miss."""
    names = ("flash_bwd_dq", "flash_bwd_dkv")
    worst = {k: {"bfloat16": 0.0, "float32": 0.0} for k in names}
    bad = []
    cases = [(s, s, c, None, None) for s in (16, 128, 1000, 2048) for c in (True, False)]
    cases += [(2048, 2048, True, 256, None), (64, 1024, True, None, None),
              (1024, 1024, True, None, -200),  # rows 0..199 see no key
              (1000, 1000, True, 64, 300),  # keys 0..236 seen by no query
              (129, 129, True, None, None), (65, 127, False, None, None)]  # ragged tiles
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).rsplit(".", 1)[-1]

        def rand(*shape):
            return torch.randn(*shape, generator=gen).to(dev, dtype)

        for d in (128, 64):
            for sq, sk, causal, window, q_offset in cases:
                kw = dict(causal=causal, window=window, q_offset=q_offset)
                q, k, v, do = rand(2, 8, sq, d), rand(2, 8, sk, d), rand(2, 8, sk, d), rand(2, 8, sq, d)
                o, lse = A.flash_attention(q, k, v, return_lse=True, **kw)
                delta = (o.float() * do.float()).sum(-1)
                # Free NaN-filled blocks of the outputs' sizes, so the
                # kernels' torch.empty outputs start as NaN, not as 0.
                poison = [torch.full_like(t, float("nan")) for t in (q, k, v)]
                del poison
                dq = A.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
                dk, dv = A.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
                torch.cuda.synchronize()
                f = [t.float() for t in (q, k, v, do)]
                refs = (A.flash_bwd_dq_reference(*f, lse, delta, **kw),
                        *A.flash_bwd_dkv_reference(*f, lse, delta, **kw))
                mags = bwd_magnitudes(A, torch, f, lse, delta, kw) if dtype == torch.bfloat16 else {}
                no_key, no_query = unseen(torch, sq, sk, causal, window, q_offset, dev)
                errs = []
                for out_name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
                    slack = BWD_FP32_REL * max(1.0, ref.abs().max().item())
                    if out_name in mags:  # the bf16 tensor-core bodies
                        err, ratio, ok = rounding_close(out, ref, mags[out_name], slack)
                        bound_note = f"worst err/rounding bound {ratio:.3f}"
                    else:
                        err, tol, ok = close(out, ref, slack)
                        bound_note = f"bound {tol:.3e}"
                    empty = no_key if out_name == "dq" else no_query
                    zeros = int(empty.sum())
                    ok = ok and not out[:, :, empty].any()
                    kname = names[0] if out_name == "dq" else names[1]
                    worst[kname][dname] = max(worst[kname][dname], err)
                    errs.append(f"{out_name} {err:.3e} ({bound_note}, {zeros} rows must be 0)")
                    if not ok:
                        bad.append(f"{out_name} {dname} d{d} {sq}x{sk} {kw}")
                print(f"  flash_bwd {dname} b2 h8 d{d} seq_q {sq} seq_k {sk} causal={causal} "
                      f"window={window} q_offset={q_offset}: " + "; ".join(errs), flush=True)
    if bad:
        raise AssertionError("backward kernel disagrees with its plain version: " + "; ".join(bad))
    return worst


def bwd_magnitudes(A, torch, f, lse, delta, kw) -> dict:
    """The ``mag`` terms of K2's and K3's rounding bounds, fp32: ``|ds|
    |k|`` for dq (ds rounded), ``|ds|^T |q|`` for dk (ds^T rounded) and
    ``p^T |do|`` for dv (p^T rounded)."""
    q, k, v, do = f
    sm_scale, q_offset = A._attention_args(q, k, kw["causal"], None, kw["q_offset"], kw["window"])
    p, ds = A._bwd_probs(q, k, v, do, lse, delta, kw["causal"], sm_scale, q_offset, kw["window"])
    return {"dq": torch.einsum("bhqk,bhkd->bhqd", ds.abs(), k.abs()),
            "dk": torch.einsum("bhqk,bhqd->bhkd", ds.abs(), q.abs()),
            "dv": torch.einsum("bhqk,bhqd->bhkd", p, do.abs())}


def check_cache_kernels(A, torch, gen, dev) -> dict[str, dict[str, float]]:
    """Phase 3c. Returns the worst error per kernel and query dtype;
    raises on a miss or when the scratch block changes an output."""
    from hops_tpu_torch.ops.kernel_checks import shuffled_table

    worst = {k: {"bfloat16": 0.0, "float32": 0.0} for k in CACHE_KERNELS}
    bad = []
    cap, b, h = 2048, 5, 8
    nan = float("nan")

    def run(name, fn, q):
        # Free a NaN-filled block of the output's size first, so the
        # kernel's torch.empty output starts as NaN, not as 0.
        poison = torch.full_like(q, nan)
        del poison
        before = A.launch_counts()[name]
        out = fn()
        torch.cuda.synchronize()
        if A.launch_counts()[name] != before + 1:
            raise AssertionError(f"{name} did not launch its kernel")
        return out

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).rsplit(".", 1)[-1]
        atol, rel = (BF16_ATOL, BF16_REL) if dtype == torch.bfloat16 else (FP32_ATOL, 0.0)
        for d in (128, 64):
            for hkv in (8, 2):
                for s in (1, 256):
                    q = torch.randn(b, h, s, d, generator=gen).to(dev, dtype)
                    errs = {}  # kernel (body) -> worst error of this shape
                    # bf16 decode calls run the split body: held to its
                    # output's rounding alone.
                    split_bf16 = dtype == torch.bfloat16 and (h // hkv) * s <= A.SPLIT_ROWS
                    # bf16 prefill calls run the tensor-core chunk body.
                    chunk_bf16 = dtype == torch.bfloat16 and not split_bf16
                    split_ratio = chunk_ratio = 0.0

                    def held(name, o, ref, mag_fn):
                        """(err, ok, miss) of one output at its body's bound."""
                        nonlocal split_ratio, chunk_ratio
                        if split_bf16:
                            err, ratio, ok = output_rounding_close(o, ref)
                            split_ratio = max(split_ratio, ratio)
                            return err, ok, f"err/rounding bound {ratio:.3f}"
                        if chunk_bf16:
                            err, ratio, ok = rounding_close(o, ref, mag_fn(), FP32_ATOL)
                            chunk_ratio = max(chunk_ratio, ratio)
                            return err, ok, f"err/rounding bound {ratio:.3f}"
                        err, tol, ok = close(o, ref, atol, rel)
                        return err, ok, f"{err:.3e} > {tol:.3e}"

                    # K5: tile boundary +-1 and full capacity.
                    vl = torch.tensor([0, 1, 63, 65, cap], dtype=torch.int32, device=dev)
                    (kq, ks), (vq, vs) = (A.quantize_kv(torch.randn(b, hkv, cap, d, generator=gen)
                                                        .to(dev)) for _ in range(2))
                    name = "decode_attention_q8_chunk" if chunk_bf16 else "decode_attention_q8"
                    for window in (None, 256):
                        o = run(name, lambda: A.decode_attention_q8(
                            q, kq, vq, ks, vs, vl, window=window), q)
                        ref = A.decode_attention_q8_reference(q.float(), kq, vq, ks, vs, vl,
                                                              window=window)
                        err, ok, miss = held(name, o, ref, lambda: A.decode_attention_q8_reference(
                            q.float(), kq, vq.abs(), ks, vs, vl, window=window))
                        errs[name] = max(errs.get(name, 0.0), err)
                        if not ok:
                            bad.append(f"{name} {dname} d{d} hkv {hkv} s {s} window={window}: {miss}")
                    # K6 and K7: page boundary +-1 and full capacity.
                    for page in (64, 16, 24):
                        mb = -(-cap // page)
                        valid = [0, 1, 5 * page - 1, 5 * page + 1, mb * page]
                        vl = torch.tensor(valid, dtype=torch.int32, device=dev)
                        pages, nblocks = shuffled_table(page, cap, valid, gen, dev)
                        pools = [torch.randn(hkv, nblocks, page, d, generator=gen).to(dev)
                                 for _ in range(2)]
                        quant = [A.quantize_kv(p) for p in pools]
                        for name in ("paged_decode_attention", "paged_decode_attention_q8"):
                            if chunk_bf16:
                                name += "_chunk"
                            if "q8" in name:
                                (k, ksc), (v, vsc) = quant
                                scales = dict(k_scale=ksc, v_scale=vsc)
                                plain_kv = (k, v)
                            else:
                                k, v = (p.to(dtype) for p in pools)
                                scales = {}
                                plain_kv = (k.float(), v.float())
                            for window in (None, 256):
                                o = run(name, lambda: A.paged_decode_attention(
                                    q, k, v, vl, pages, window=window, **scales), q)
                                ref = A.paged_decode_attention_reference(
                                    q.float(), *plain_kv, vl, pages, window=window, **scales)
                                err, ok, miss = held(name, o, ref, lambda: (
                                    A.paged_decode_attention_reference(
                                        q.float(), plain_kv[0], plain_kv[1].abs(), vl, pages,
                                        window=window, **scales)))
                                errs[name] = max(errs.get(name, 0.0), err)
                                if not ok:
                                    bad.append(f"{name} {dname} d{d} hkv {hkv} s {s} page {page} "
                                               f"window={window}: {miss}")
                            # The scratch block: garbage there changes nothing.
                            k2, v2 = k.clone(), v.clone()
                            sc2 = {n: t.clone() for n, t in scales.items()}
                            if scales:
                                k2[:, 0], v2[:, 0] = 127, -127
                                sc2["k_scale"][:, 0], sc2["v_scale"][:, 0] = nan, 1e30
                            else:
                                k2[:, 0] = 1e30
                                v2[:, 0] = nan if dtype == torch.float32 else -1e30
                            dirty = run(name, lambda: A.paged_decode_attention(
                                q, k2, v2, vl, pages, **sc2), q)
                            if not torch.equal(dirty, A.paged_decode_attention(
                                    q, k, v, vl, pages, **scales)):
                                bad.append(f"{name} {dname} d{d} hkv {hkv} s {s} page {page}: "
                                           "the scratch block reached an output")
                    for name, err in errs.items():
                        worst[name][dname] = max(worst[name][dname], err)
                    body = ("split body per element 2^-8*|plain| + "
                            f"{FP32_ATOL:.0e}, worst err/bound {split_ratio:.3f}" if split_bf16 else
                            "chunk body per element 2^-8*(p|v| + |plain|) + "
                            f"{FP32_ATOL:.0e}, worst err/bound {chunk_ratio:.3f}" if chunk_bf16 else
                            f"bound {atol:.0e}{' + 2e-2*max|plain|' if rel else ''}")
                    print(f"  {dname} b{b} h8 hkv {hkv} d{d} s {s}: worst err " + ", ".join(
                        f"{n} {e:.3e}" for n, e in errs.items())
                        + f" ({body}); scratch block unreachable", flush=True)
            # K6's split body across its split boundaries.
            err_split = ratio_split = 0.0
            for page, cap, hkv, s, valid, window in SPLIT_CASES:
                vl = torch.tensor(valid, dtype=torch.int32, device=dev)
                pages, nblocks = shuffled_table(page, cap, valid, gen, dev)
                k, v = (torch.randn(hkv, nblocks, page, d, generator=gen).to(dev, dtype)
                        for _ in range(2))
                q = torch.randn(len(valid), h, s, d, generator=gen).to(dev, dtype)
                o = run("paged_decode_attention", lambda: A.paged_decode_attention(
                    q, k, v, vl, pages, window=window), q)
                ref = A.paged_decode_attention_reference(q.float(), k.float(), v.float(), vl,
                                                         pages, window=window)
                if dtype == torch.bfloat16:
                    err, ratio, ok = output_rounding_close(o, ref)
                    ratio_split = max(ratio_split, ratio)
                    miss = f"err/rounding bound {ratio:.3f}"
                else:
                    err, tol, ok = close(o, ref, atol)
                    miss = f"{err:.3e} > {tol:.3e}"
                err_split = max(err_split, err)
                ok = ok and not o[vl == 0].any()
                if not ok:
                    bad.append(f"paged_decode_attention split body {dname} d{d} page {page} "
                               f"cap {cap} hkv {hkv} s {s} valid_len {valid} window={window}: "
                               f"{miss}")
            worst["paged_decode_attention"][dname] = max(
                worst["paged_decode_attention"][dname], err_split)
            bound_note = (f"per element 2^-8*|plain| + {FP32_ATOL:.0e}, worst err/bound "
                          f"{ratio_split:.3f}" if dtype == torch.bfloat16 else f"bound {atol:.0e}")
            print(f"  {dname} d{d}: paged_decode_attention split body over {len(SPLIT_CASES)} "
                  f"split-boundary cases: worst err {err_split:.3e} ({bound_note})", flush=True)
            bad += check_q8_split_body(A, torch, gen, dev, d, dtype, run, worst)
            if dtype == torch.bfloat16:
                bad += check_chunk_body(A, torch, gen, dev, d, run, worst)
                bad += check_q8_chunk_body(A, torch, gen, dev, d, run, worst)
    if bad:
        raise AssertionError("cache kernel disagrees with its plain version: " + "; ".join(bad))
    return worst


def check_chunk_body(A, torch, gen, dev, d: int, run, worst) -> list[str]:
    """Phase 3c for K6's bf16 prefill-chunk body at head dim ``d``: the
    ``WIDE_CASES`` on pages 64, 16 and 24, windows none and 256, against
    the plain version per element within ``2**-8 * (p|v| + |plain|) +
    1e-4``; rows with valid_len 0 and rows before position 0 exactly 0;
    then the scratch block at ±1e30 and the outputs of every row that
    does not reach it bit-identical. Returns the cases that missed."""
    from hops_tpu_torch.ops.kernel_checks import WIDE_CASES, shuffled_table, wide_lengths

    bad = []
    b, h = 5, 8
    name = "paged_decode_attention_chunk"
    for page in (64, 16, 24):
        err_max = ratio_max = 0.0
        for case, (hkv, s, cap) in WIDE_CASES.items():
            valid, alloc = wide_lengths(s, page, cap)
            vl = torch.tensor(valid, dtype=torch.int32, device=dev)
            pages, nblocks = shuffled_table(page, cap, alloc, gen, dev)
            q = torch.randn(b, h, s, d, generator=gen).to(dev, torch.bfloat16)
            k, v = (torch.randn(hkv, nblocks, page, d, generator=gen).to(dev, torch.bfloat16)
                    for _ in range(2))
            kf, vf = k.float(), v.float()
            for window in (None, 256):
                o = run(name, lambda: A.paged_decode_attention(q, k, v, vl, pages, window=window), q)
                ref = A.paged_decode_attention_reference(q.float(), kf, vf, vl, pages, window=window)
                mag = A.paged_decode_attention_reference(q.float(), kf, vf.abs(), vl, pages,
                                                         window=window)
                err, ratio, ok = rounding_close(o, ref, mag, FP32_ATOL)
                err_max, ratio_max = max(err_max, err), max(ratio_max, ratio)
                ok = ok and not o[0].any() and not o[1, :, :s - valid[1]].any()
                if not ok:
                    bad.append(f"{name} d{d} page {page} {case} window={window}: "
                               f"err/rounding bound {ratio:.3f}")
            clean = A.paged_decode_attention(q, k, v, vl, pages)
            k[:, 0], v[:, 0] = 1e30, -1e30
            dirty = run(name, lambda: A.paged_decode_attention(q, k, v, vl, pages), q)
            if not torch.equal(dirty[[0, 1, 2, 4]], clean[[0, 1, 2, 4]]):
                bad.append(f"{name} d{d} page {page} {case}: the scratch block reached a row "
                           "that does not map it")
        worst[name]["bfloat16"] = max(worst[name]["bfloat16"], err_max)
        print(f"  bfloat16 d{d} page {page}: paged_decode_attention_chunk over {len(WIDE_CASES)} "
              f"shapes ({', '.join(WIDE_CASES)}) x windows none/256: worst err {err_max:.3e}, "
              f"worst err/rounding bound {ratio_max:.3f}; scratch block reaches only the row "
              "that maps it", flush=True)
    return bad


def check_q8_split_body(A, torch, gen, dev, d: int, dtype, run, worst) -> list[str]:
    """Phase 3c for the int8 split body of K5 (dense) and K7 (paged) at
    head dim ``d`` and query dtype ``dtype``: the ``Q8_SPLIT_CASES``
    against the plain version, bf16 per element within ``2**-8 * |plain| +
    1e-4`` (fp32 arithmetic, the output rounded), fp32 within 1e-4; rows
    with valid_len 0 exactly 0; then the keys no row may read poisoned
    (values and scales) and every output bit-identical. Returns the cases
    that missed."""
    from hops_tpu_torch.ops.kernel_checks import (Q8_SPLIT_CASES, q8_call, q8_operands,
                                                  q8_plain, q8_poisoned)

    bad = []
    dname = str(dtype).rsplit(".", 1)[-1]
    err_max = {"decode_attention_q8": 0.0, "paged_decode_attention_q8": 0.0}
    ratio_max = dict(err_max)
    for case, (page, cap, hkv, s, valid, window) in Q8_SPLIT_CASES.items():
        if (8 // hkv) * s > A.SPLIT_ROWS:
            raise AssertionError(f"Q8_SPLIT_CASES {case}: hkv {hkv} s {s} is not a decode call")
        vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        q = torch.randn(len(valid), 8, s, d, generator=gen).to(dev, dtype)
        for layout, name in (("dense", "decode_attention_q8"), ("paged", "paged_decode_attention_q8")):
            kv, pages = q8_operands(layout, page, cap, hkv, d, valid, gen, dev)
            o = run(name, lambda: q8_call(q, kv, vl, pages, window), q)
            ref = q8_plain(q, kv, vl, pages, window)
            if dtype == torch.bfloat16:
                err, ratio, ok = output_rounding_close(o, ref)
                ratio_max[name] = max(ratio_max[name], ratio)
                miss = f"err/rounding bound {ratio:.3f}"
            else:
                err, tol, ok = close(o, ref, FP32_ATOL)
                miss = f"{err:.3e} > {tol:.3e}"
            err_max[name] = max(err_max[name], err)
            ok = ok and not o[vl == 0].any()
            dirty = run(name, lambda: q8_call(q, q8_poisoned(kv, vl, pages), vl, pages, window), q)
            if not torch.equal(dirty, o):
                ok, miss = False, "a key no row may read (values or scales) reached an output"
            if not ok:
                bad.append(f"{name} int8 split body {dname} d{d} {case}: {miss}")
    for name, err in err_max.items():
        worst[name][dname] = max(worst[name][dname], err)
        bound_note = (f"per element 2^-8*|plain| + {FP32_ATOL:.0e}, worst err/bound "
                      f"{ratio_max[name]:.3f}" if dtype == torch.bfloat16 else
                      f"bound {FP32_ATOL:.0e}")
        print(f"  {dname} d{d}: {name} int8 split body over {len(Q8_SPLIT_CASES)} split-boundary "
              f"cases ({', '.join(Q8_SPLIT_CASES)}): worst err {err:.3e} ({bound_note}); "
              "poisoned values and scales change no bit", flush=True)
    return bad


def check_q8_chunk_body(A, torch, gen, dev, d: int, run, worst) -> list[str]:
    """Phase 3c for the int8 wide bodies at head dim ``d``, bf16 queries:
    K5 on the dense cache (K1's forward body over int8 K/V) and K7 on
    pages 64, 16 and 24 (the chunk body), the
    ``WIDE_CASES`` at windows none and 256, per element within ``2**-8 *
    (p|v| + |plain|) + 1e-4`` with ``|v|`` dequantized; rows with
    valid_len 0 and rows before position 0 exactly 0; then the keys no row
    may read poisoned (values and scales) and every row that does not map
    them bit-identical (K7's row 3 maps the scratch block below its
    valid length, as the engine's pad rows do). Then K5 at the int8
    engine's admission prefill as phase 5 times it: q (4, 8, 2048, d)
    causal over its own K/V, valid_len 2048 for every row. Prints the
    worst ratio per group; returns the cases that missed."""
    from hops_tpu_torch.ops.kernel_checks import (WIDE_CASES, q8_call, q8_operands, q8_plain,
                                                  q8_poisoned, wide_lengths)

    bad = []
    for layout in ("dense", 64, 16, 24):
        page = 64 if layout == "dense" else layout
        name = "decode_attention_q8_chunk" if layout == "dense" else "paged_decode_attention_q8_chunk"
        err_max = ratio_max = 0.0
        for case, (hkv, s, cap) in WIDE_CASES.items():
            valid, alloc = wide_lengths(s, page, cap)
            vl = torch.tensor(valid, dtype=torch.int32, device=dev)
            kv, pages = q8_operands("dense" if layout == "dense" else "paged", page, cap, hkv, d,
                                    alloc, gen, dev)
            q = torch.randn(len(valid), 8, s, d, generator=gen).to(dev, torch.bfloat16)
            for window in (None, 256):
                o = run(name, lambda: q8_call(q, kv, vl, pages, window), q)
                ref = q8_plain(q, kv, vl, pages, window)
                mag = q8_plain(q, [kv[0], kv[1].abs(), kv[2], kv[3]], vl, pages, window)
                err, ratio, ok = rounding_close(o, ref, mag, FP32_ATOL)
                err_max, ratio_max = max(err_max, err), max(ratio_max, ratio)
                ok = ok and not o[0].any() and not o[1, :, :s - valid[1]].any()
                if not ok:
                    bad.append(f"{name} d{d} {layout} {case} window={window}: "
                               f"err/rounding bound {ratio:.3f}")
            clean = run(name, lambda: q8_call(q, kv, vl, pages), q)
            dirty = run(name, lambda: q8_call(q, q8_poisoned(kv, vl, pages), vl, pages), q)
            keep = [0, 1, 2, 4] if layout != "dense" else list(range(len(valid)))
            if not torch.equal(dirty[keep], clean[keep]):
                bad.append(f"{name} d{d} {layout} {case}: a key no row may read reached an output")
        worst[name]["bfloat16"] = max(worst[name]["bfloat16"], err_max)
        where = "dense cache" if layout == "dense" else f"page {page}"
        print(f"  bfloat16 d{d} {where}: {name} over {len(WIDE_CASES)} shapes "
              f"({', '.join(WIDE_CASES)}) x windows none/256: worst err {err_max:.3e}, worst "
              f"err/rounding bound {ratio_max:.3f}; poisoned values and scales change no row "
              "that does not map them", flush=True)

    # The admission prefill's own shape: every row full causal at s = cap.
    name, b, sw = "decode_attention_q8_chunk", 4, 2048
    vl = torch.full((b,), sw, dtype=torch.int32, device=dev)
    kv, _ = q8_operands("dense", 64, sw, 8, d, [sw] * b, gen, dev)
    q = torch.randn(b, 8, sw, d, generator=gen).to(dev, torch.bfloat16)
    o = run(name, lambda: q8_call(q, kv, vl, None), q)
    ref = q8_plain(q, kv, vl, None)
    mag = q8_plain(q, [kv[0], kv[1].abs(), kv[2], kv[3]], vl, None)
    err, ratio, ok = rounding_close(o, ref, mag, FP32_ATOL)
    del ref, mag
    worst[name]["bfloat16"] = max(worst[name]["bfloat16"], err)
    print(f"  bfloat16 d{d} dense cache: {name} at the admission prefill q ({b},8,{sw},{d}), "
          f"valid_len {sw} (causal, {sw // 128} row tiles per head): err {err:.3e}, "
          f"err/rounding bound {ratio:.3f}", flush=True)
    if not ok:
        bad.append(f"{name} d{d} admission prefill ({b},8,{sw},{d}): err/rounding bound {ratio:.3f}")
    return bad


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


def cached_logits(m, torch, prompt, nxt, chunk: int | None):
    """``(2, vocab)`` logits of ``m`` at the last prompt position and
    after one decode step, on a fresh batch-1 cache of ``m``'s type: a
    dense cache takes the prompt in one fresh prefill; a paged one maps
    blocks 1.. and takes it in ``chunk``-token chunks, as the engine."""
    cache = m.init_cache(1)
    if m.paged_decode:
        need = -(-(prompt.shape[1] + 1) // m.kv_page_size)
        cache.pages[0, :need] = torch.arange(1, need + 1, dtype=torch.int32)
        for c0 in range(0, prompt.shape[1], chunk):
            last = m(prompt[:, c0:c0 + chunk], cache)[0, -1]
    else:
        last = m(prompt, cache, fresh=True)[0, -1]
    return torch.stack([last, m(nxt, cache)[0, -1]])


@contextlib.contextmanager
def plain_attention():
    """Run the model's cached attention on the plain versions: swap the
    kernel entry points that ``hops_tpu_torch.models.transformer`` calls
    (K1, K4, K5, K6/K7) for their ``*_reference`` counterparts, cast to
    the query's dtype as the kernels return it."""
    import hops_tpu_torch.models.transformer as TM
    from hops_tpu_torch.ops import attention as A

    def cast(ref):
        return lambda q, *args, **kw: ref(q, *args, **kw).to(q.dtype)

    swaps = {
        "flash_attention": cast(A.attention_reference),
        "decode_attention": cast(A.decode_attention_reference),
        "decode_attention_q8": cast(A.decode_attention_q8_reference),
        "paged_decode_attention": cast(A.paged_decode_attention_reference),
    }
    real = {name: getattr(TM, name) for name in swaps}
    for name, fn in swaps.items():
        setattr(TM, name, fn)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(TM, name, fn)


@contextlib.contextmanager
def int8_tape(tape: list, replay: bool):
    """Record what the model's ``quantize_kv`` returns, call by call, or
    replay a recording: two runs whose fp32 K/V differ by rounding then
    store the same int8 bytes and scales, where they would otherwise
    round a few values to the next int8 step."""
    import hops_tpu_torch.models.transformer as TM

    real, calls = TM.quantize_kv, iter(tape)

    def record(x):
        tape.append(real(x))
        return tape[-1]

    def play(x):
        values, scales = next(calls)
        assert values.shape == x.shape, "replayed int8 K/V out of step"
        return values, scales

    TM.quantize_kv = play if replay else record
    try:
        yield
    finally:
        TM.quantize_kv = real


def check_cache_logits(model, torch, prompts, answers, dev, chunk) -> None:
    """Phase 8 check, for two requests: ``model`` (the engine's, with
    its int8 or paged cache) on its kernels against the same model type
    on the plain attention versions (:func:`plain_attention`), on the
    same kind of cache filled the same way, as in phase 4. fp32
    weights within ``LOGITS_REL_FP32 * ||ref||inf``: for an int8 cache
    the kernel run stores the int8 bytes the plain run stored
    (:func:`int8_tape`), so both attend the same cache contents. The
    served bf16 model within ``BF16_VS_PLAIN`` times the plain bf16
    model's distance from the plain fp32 one (both quantize their own
    K/V)."""
    fp32 = model.clone(dtype="float32")
    for i in (0, 3):
        prompt = torch.tensor(prompts[i], dtype=torch.long, device=dev)[None]
        nxt = torch.tensor([[answers[i][0]]], device=dev)
        tape: list = []
        with plain_attention():
            with int8_tape(tape, replay=False):
                ref = cached_logits(fp32, torch, prompt, nxt, chunk)
            plain_bf16 = cached_logits(model, torch, prompt, nxt, chunk)
        scale = ref.abs().max(dim=-1).values
        noise = (plain_bf16 - ref).abs().max(dim=-1).values
        for m, bounds in ((fp32, LOGITS_REL_FP32 * scale), (model, BF16_VS_PLAIN * noise)):
            with int8_tape(tape, replay=True) if m is fp32 else contextlib.nullcontext():
                got = cached_logits(m, torch, prompt, nxt, chunk)
            errs = (got - ref).abs().max(dim=-1).values
            for j, step in enumerate(("prefill", "decode step")):
                err, tol = errs[j].item(), bounds[j].item()
                dname = str(m.dtype).rsplit(".", 1)[-1]
                extra = f"; plain bf16 model {noise[j].item():.3e}" if m is model else ""
                print(f"  request {i} (prompt {prompt.shape[1]}) {dname}: {step} logits "
                      f"|kernel - plain fp32|inf {err:.3e} (bound {tol:.3e}){extra}; "
                      f"||ref||inf {scale[j].item():.3e}", flush=True)
                if not err <= tol:
                    raise AssertionError(f"request {i} {dname} {step} logits disagree")


@contextlib.contextmanager
def drawn_logits(engine, taps: dict):
    """Keep the logits the ``engine`` draws each token from, in its own
    batch: ``taps[(ticket, j)]`` is the ``(vocab,)`` row that token j of
    that ticket came from. Wraps ``logits`` of the engine's model
    instance while the block runs. Paged engines draw every token from
    one ``(slots, vocab)`` call; the dense engine draws a wave's first
    tokens from ``(wave, vocab)`` and decode tokens from ``(slots, 1,
    vocab)``."""
    model = engine.model
    real = model.logits
    paged = engine.stats()["cache_layout"] == "paged"

    def tap(hidden):
        out = real(hidden)
        if paged and out.dim() == 2:  # the engine's (slots, vocab) draw
            for r, st in enumerate(engine._slot_state):
                if st is None or (st.pending is not None and st.pending.size > engine.prefill_chunk):
                    continue  # a free row, or a prompt chunk before the last
                taps[(st.ticket, 0 if st.pending is not None else len(st.emitted))] = out[r]
        elif not paged and out.dim() == 2:  # an admission wave, in _admitting's order
            for i, req in enumerate(engine._admitting):
                taps[(req.ticket, 0)] = out[i]
        elif not paged:  # a decode step over every slot
            for r, st in enumerate(engine._slot_state):
                if st is not None:
                    taps[(st.ticket, len(st.emitted))] = out[r, -1]
        return out

    model.logits = tap
    try:
        yield
    finally:
        del model.logits


def first_difference_margins(torch, taps: dict, answers, dense_answers) -> list[str]:
    """For each stream that differs from phase 4's, at its first differing
    token j, from the logits the engine drew token j from
    (:func:`drawn_logits`): its token's logit minus phase 4's token's, and
    minus the runner-up's (the top-2 gap), each also over
    ``||logits||inf``. A gap far below the bf16 model's distance from fp32
    (phase 4) is a near tie that rounding decides."""
    tickets = sorted({t for t, _ in taps})
    if len(tickets) != len(answers):
        raise AssertionError(f"logits kept for {len(tickets)} tickets, not {len(answers)}")
    notes = []
    for i, (a, d) in enumerate(zip(answers, dense_answers)):
        j = next((k for k, (x, y) in enumerate(zip(a, d)) if x != y), None)
        if j is None:
            continue
        logits = taps[(tickets[i], j)].float()
        if int(torch.argmax(logits)) != a[j]:
            raise AssertionError(f"stream {i} token {j}: the kept logits do not give its token")
        top2 = torch.topk(logits, 2).values
        gap, top, scale = ((logits[a[j]] - logits[d[j]]).item(), (top2[0] - top2[1]).item(),
                           logits.abs().max().item())
        notes.append(f"stream {i} at token {j}: over phase 4's token {gap:.3e}, top-2 gap "
                     f"{top:.3e} ({gap / scale:.1e}, {top / scale:.1e} of ||logits||inf)")
    return notes


def kv_bytes(cache) -> int:
    """Persistent bytes of a KV cache: values, scales, page table, index."""
    tensors = [*cache.k, *cache.v, *(cache.k_scale or []), *(cache.v_scale or []), cache.idx]
    return sum(t.nbytes for t in tensors) + (cache.pages.nbytes if hasattr(cache, "pages") else 0)


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
        n_splits=A.decode_splits(1, cap, b * h)[0], **bound(flops, nbytes),
    ))
    return rows


def time_redesigned(A, torch, gen, dev) -> dict[str, float]:
    """Device ms of the two calls this tree's forward body serves, at
    phase 5's shapes, through the package ``A`` belongs to: K1 on q, k, v
    (4, 8, 2048, 128) bf16 causal, and K5's wide call at the int8 engine's
    admission prefill (the same q over int8 K/V of its own 2048 keys).
    It takes the package as an argument so that another checkout's
    package (an earlier design of the two) can be timed by the same code
    in the same call."""
    b, h, s, d = 4, 8, 2048, 128
    q, k, v = (torch.randn(b, h, s, d, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
    (k8, ks), (v8, vs) = (A.quantize_kv(torch.randn(b, h, s, d, generator=gen).to(dev))
                          for _ in range(2))
    return {"flash_fwd": cuda_ms(lambda i=0: A.flash_attention(q, k, v, causal=True), 20),
            "decode_attention_q8_chunk": cuda_ms(
                lambda i=0: A.decode_attention_q8(q, k8, v8, ks, vs, s), 20)}


def time_bwd_kernels(A, torch, gen, dev, launches, worst, steps: int) -> list[dict]:
    """Phase 5 rows for K2 and K3 at the training path's shapes, with
    the backward of ``scaled_dot_product_attention`` (dq, dk and dv in
    one call) as the library yardstick of both."""
    F = torch.nn.functional
    b, h, s, d = TRAIN_BATCH, MODEL["num_heads"], TRAIN_SEQ, MODEL["d_model"] // MODEL["num_heads"]
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to(dev, torch.bfloat16) for _ in range(4))
    o, lse = A.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = (o.float() * do.float()).sum(-1)
    pairs = b * h * s * (s + 1) // 2
    bhsd, bhs = b * h * s * d, b * h * s
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    library_ms = cuda_ms(lambda i=0: torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True), 10)
    args = (q, k, v, do, lse, delta)
    rows = []
    for name, line, fn, ref, flops, nbytes in (
        ("flash_bwd_dq", 218, A.flash_bwd_dq, A.flash_bwd_dq_reference,
         6 * d * pairs, 5 * bhsd * 2 + 2 * bhs * 4),
        ("flash_bwd_dkv", 260, A.flash_bwd_dkv, A.flash_bwd_dkv_reference,
         8 * d * pairs, 6 * bhsd * 2 + 2 * bhs * 4),
    ):
        rows.append(dict(
            name=name, route="cuda", source=f"hops_tpu_torch/ops/csrc/{name}.cu",
            replaces=f"hops_tpu/ops/attention.py:{line}",
            shape=f"q,k,v,do ({b},{h},{s},{d}) bf16 causal",
            launches=launches[name], launches_per_step=launches[name] // steps,
            max_abs_err=worst[name]["bfloat16"],
            ms=cuda_ms(lambda i=0, fn=fn: fn(*args, causal=True), 10),
            plain_ms=cuda_ms(lambda i=0, ref=ref: ref(*args, causal=True), 3),
            library_ms=library_ms, **bound(flops, nbytes),
        ))
    return rows


def time_cache_kernels(A, torch, gen, dev, launches, worst) -> list[dict]:
    """Phase 5 rows for K5, K6 and K7 at K4's serving shape: one decode
    step of 4 slots, 12 layer caches in turn, page 64 on a shuffled
    table. The yardstick is ``scaled_dot_product_attention`` on the
    gathered (paged) and dequantized (int8) bf16 tensors; the gather and
    the dequantization are not timed. Then the wide calls, each a record
    of its own: K6 and K7 at the width of a 256-token prefill chunk of
    every slot (their tensor-core chunk body), and K5 at the int8
    engine's admission prefill (4 prompts in the 2048 bucket, causal over
    their own int8 keys, valid_len 2048)."""
    from hops_tpu_torch.ops.kernel_checks import shuffled_table

    F = torch.nn.functional
    bf16 = torch.bfloat16
    b, h, d, cap, layers, page = 4, 8, 128, 2048, 12, 64
    vl_host = [p + n // 2 for p, n in zip(PROMPT_LENS[:4], NEW_TOKENS[:4])]
    vl = torch.tensor(vl_host, dtype=torch.int32, device=dev)
    q = torch.randn(b, h, 1, d, generator=gen).to(dev, bf16)
    mask = (torch.arange(cap, device=dev)[None, :] < vl[:, None])[:, None, None, :]
    keys = sum(vl_host)
    blocks = sum(-(-n // page) for n in vl_host)
    flops = 4 * d * h * keys
    io = 2 * b * h * d * 2 + b * 4  # q, o and valid_len
    pages, nblocks = shuffled_table(page, cap, vl_host, gen, dev)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def deq(t, sc):
        return A.dequantize_kv(t, sc, bf16)

    q8 = [[*A.quantize_kv(rand(b, h, cap, d)), *A.quantize_kv(rand(b, h, cap, d))]
          for _ in range(layers)]
    pools = [[rand(h, nblocks, page, d).to(bf16) for _ in range(2)] for _ in range(layers)]
    qpools = [[*A.quantize_kv(rand(h, nblocks, page, d)), *A.quantize_kv(rand(h, nblocks, page, d))]
              for _ in range(layers)]
    cases = {
        "decode_attention_q8": (
            lambda i: A.decode_attention_q8(q, q8[i][0], q8[i][2], q8[i][1], q8[i][3], vl),
            lambda i: A.decode_attention_q8_reference(q, q8[i][0], q8[i][2], q8[i][1], q8[i][3], vl),
            [(deq(c[0], c[1]), deq(c[2], c[3])) for c in q8],
            "int8 cache (4,8,2048,128) + fp32 scales",
            2 * h * (d + 4) * keys + io,
        ),
        "paged_decode_attention": (
            lambda i: A.paged_decode_attention(q, *pools[i], vl, pages),
            lambda i: A.paged_decode_attention_reference(q, *pools[i], vl, pages),
            [tuple(A.paged_gather_kv(p, pages) for p in pl) for pl in pools],
            f"bf16 pools ({h},{nblocks},{page},{d}), page table ({b},{cap // page})",
            2 * h * d * 2 * keys + io + blocks * 4,
        ),
        "paged_decode_attention_q8": (
            lambda i: A.paged_decode_attention(q, qpools[i][0], qpools[i][2], vl, pages,
                                               k_scale=qpools[i][1], v_scale=qpools[i][3]),
            lambda i: A.paged_decode_attention_reference(q, qpools[i][0], qpools[i][2], vl, pages,
                                                         k_scale=qpools[i][1], v_scale=qpools[i][3]),
            [(deq(A.paged_gather_kv(c[0], pages), A.paged_gather_scales(c[1], pages)),
              deq(A.paged_gather_kv(c[2], pages), A.paged_gather_scales(c[3], pages)))
             for c in qpools],
            f"int8 pools ({h},{nblocks},{page},{d}) + fp32 scale pools, page table ({b},{cap // page})",
            2 * h * (d + 4) * keys + io + blocks * 4,
        ),
    }
    rows = []
    for name, (fn, plain, dense, what, nbytes) in cases.items():
        src, line = CACHE_KERNELS[name]
        rows.append(dict(
            name=name, route="cuda", source=f"hops_tpu_torch/ops/csrc/{src}",
            replaces=f"hops_tpu/ops/attention.py:{line}",
            shape=f"q ({b},{h},1,{d}) bf16, {what}, valid_len {vl_host}",
            launches=launches.get(name, 0), max_abs_err=worst[name]["bfloat16"],
            ms=cuda_ms(lambda i=0, fn=fn: fn(i % layers), 120),
            plain_ms=cuda_ms(lambda i=0, plain=plain: plain(i % layers), 24),
            library_ms=cuda_ms(lambda i=0, dense=dense: F.scaled_dot_product_attention(
                q, *dense[i % layers], attn_mask=mask), 120),
            n_splits=A.decode_splits(1, cap, b * h)[0], **bound(flops, nbytes),
        ))

    # K6 and K7 at a prefill chunk's width: 256 query rows per slot, the
    # chunk at positions valid_len - 256 .. valid_len - 1.
    sq = 256
    vlc_host = [max(n, sq) for n in vl_host]
    vlc = torch.tensor(vlc_host, dtype=torch.int32, device=dev)
    qc = torch.randn(b, h, sq, d, generator=gen).to(dev, bf16)
    pos = vlc[:, None] - sq + torch.arange(sq, device=dev)[None, :]
    maskc = (torch.arange(cap, device=dev)[None, None, :] <= pos[:, :, None])[:, None]
    pagesc, nblocksc = shuffled_table(page, cap, vlc_host, gen, dev)
    poolsc = [[rand(h, nblocksc, page, d).to(bf16) for _ in range(2)] for _ in range(layers)]
    qpoolsc = [[*A.quantize_kv(rand(h, nblocksc, page, d)), *A.quantize_kv(rand(h, nblocksc, page, d))]
               for _ in range(layers)]
    pairs = sum(sq * (n - sq) + sq * (sq + 1) // 2 for n in vlc_host)
    io_c = 2 * b * h * sq * d * 2 + b * 4 + sum(-(-n // page) for n in vlc_host) * 4
    chunk_cases = {
        "paged_decode_attention_chunk": (
            lambda i: A.paged_decode_attention(qc, *poolsc[i], vlc, pagesc),
            lambda i: A.paged_decode_attention_reference(qc, *poolsc[i], vlc, pagesc),
            [tuple(A.paged_gather_kv(p, pagesc) for p in pl) for pl in poolsc],
            f"bf16 pools ({h},{nblocksc},{page},{d})",
            2 * h * d * 2 * sum(vlc_host) + io_c,
        ),
        "paged_decode_attention_q8_chunk": (
            lambda i: A.paged_decode_attention(qc, qpoolsc[i][0], qpoolsc[i][2], vlc, pagesc,
                                               k_scale=qpoolsc[i][1], v_scale=qpoolsc[i][3]),
            lambda i: A.paged_decode_attention_reference(qc, qpoolsc[i][0], qpoolsc[i][2], vlc,
                                                         pagesc, k_scale=qpoolsc[i][1],
                                                         v_scale=qpoolsc[i][3]),
            [(deq(A.paged_gather_kv(c[0], pagesc), A.paged_gather_scales(c[1], pagesc)),
              deq(A.paged_gather_kv(c[2], pagesc), A.paged_gather_scales(c[3], pagesc)))
             for c in qpoolsc],
            f"int8 pools ({h},{nblocksc},{page},{d}) + fp32 scale pools",
            h * (2 * d + 8) * sum(vlc_host) + io_c,
        ),
    }
    for name, (fn, plain, dense, what, nbytes) in chunk_cases.items():
        src, line = CACHE_KERNELS[name]
        rows.append(dict(
            name=name, route="cuda", source=f"hops_tpu_torch/ops/csrc/{src}",
            replaces=f"hops_tpu/ops/attention.py:{line}",
            shape=f"q ({b},{h},{sq},{d}) bf16, {what}, valid_len {vlc_host}",
            launches=launches.get(name, 0), max_abs_err=worst[name]["bfloat16"],
            ms=cuda_ms(lambda i=0, fn=fn: fn(i % layers), 60),
            plain_ms=cuda_ms(lambda i=0, plain=plain: plain(i % layers), 12),
            library_ms=cuda_ms(lambda i=0, dense=dense: F.scaled_dot_product_attention(
                qc, *dense[i % layers], attn_mask=maskc), 60),
            **bound(4 * d * h * pairs, nbytes),
        ))
    del qpoolsc, poolsc

    # K5 at the int8 engine's admission prefill: a wave of 4 prompts in
    # the 2048 bucket reads its freshly quantized K/V back, causal.
    sw = 2048
    qw = torch.randn(b, h, sw, d, generator=gen).to(dev, bf16)
    wide = [[*A.quantize_kv(rand(b, h, sw, d)), *A.quantize_kv(rand(b, h, sw, d))]
            for _ in range(2)]
    dense_w = [(deq(c[0], c[1]), deq(c[2], c[3])) for c in wide]
    pairs = b * h * sw * (sw + 1) // 2
    nbytes = b * h * sw * (2 * d + 8) + 2 * b * h * sw * d * 2 + b * 4
    name = "decode_attention_q8_chunk"
    src, line = CACHE_KERNELS[name]
    rows.append(dict(
        name=name, route="cuda", source=f"hops_tpu_torch/ops/csrc/{src}",
        replaces=f"hops_tpu/ops/attention.py:{line}",
        shape=f"q ({b},{h},{sw},{d}) bf16, int8 K/V ({b},{h},{sw},{d}) + fp32 scales, "
              f"valid_len {sw} (causal)",
        launches=launches.get(name, 0), max_abs_err=worst[name]["bfloat16"],
        ms=cuda_ms(lambda i=0: A.decode_attention_q8(qw, wide[i % 2][0], wide[i % 2][2],
                                                     wide[i % 2][1], wide[i % 2][3], sw), 20),
        plain_ms=cuda_ms(lambda i=0: A.decode_attention_q8_reference(
            qw, wide[i % 2][0], wide[i % 2][2], wide[i % 2][1], wide[i % 2][3], sw), 3),
        library_ms=cuda_ms(lambda i=0: F.scaled_dot_product_attention(
            qw, *dense_w[i % 2], is_causal=True), 20),
        **bound(4 * d * pairs, nbytes),
    ))
    return rows


def serve_cache_slices(A, torch, art, prompts, instances, dense_answers, dense_bytes,
                       dev, card_line) -> dict[str, dict[str, int]]:
    """Phase 8: serve phase 4's requests with each of ``CACHE_SLICES``;
    returns each slice's launch counts."""
    from hops_tpu_torch.modelrepo.serving import LMEnginePredictor

    out = {}
    for name, cfg, kernels in CACHE_SLICES:
        predictor = LMEnginePredictor(art, cfg)
        engine = predictor.engine
        taps: dict = {}
        try:
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
                    raise AssertionError(f"{name}: prompt {p} answered {len(ans)} tokens, not {n}")
            others = {k: n for k, n in launches.items() if k not in kernels and n}
            if not all(launches[k] for k in kernels) or others:
                raise AssertionError(f"{name}: {', '.join(kernels)} must launch and no other "
                                     f"attention kernel: {launches}")
            paged = stats["cache_layout"] == "paged"
            if paged and name == "paged-int8" and (
                    stats["blocks_peak_used"] < PEAK_POOL_SHARE * stats["blocks_total"]):
                raise AssertionError(f"{name}: peak pool use {stats['blocks_peak_used']} of "
                                     f"{stats['blocks_total']} blocks")
            same = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
                    for a, b in zip(answers, dense_answers)]
            nbytes = kv_bytes(engine._cache)
            print(f"phase 8 {name} {cfg}: answers {[len(a) for a in answers]} tokens; "
                  f"launches {', '.join(f'{k} {launches[k]}' for k in kernels)}, others none; "
                  f"{sum(n == len(a) for n, a in zip(same, answers))} of {len(answers)} streams "
                  f"equal phase 4's (equal leading tokens {same})", flush=True)
            pool = (f"; prefill chunks {stats['prefill_chunks']}, preemptions "
                    f"{stats['preemptions']}, peak blocks {stats['blocks_peak_used']} of "
                    f"{stats['blocks_total']}" if paged else "")
            print(f"  ttft_ms {[round(t * 1e3, 1) for t in ttft]}; decode "
                  f"{stats['decode_tokens'] / stats['decode_s']:.1f} tokens/s "
                  f"({stats['decode_tokens']} tokens in {stats['decode_s']:.3f} s of decode-only "
                  f"steps); {stats['dispatches']} steps, prefill {stats['prefill_s']:.3f} s; "
                  f"wall {wall:.3f} s{pool}; persistent KV {nbytes} bytes "
                  f"({nbytes / dense_bytes:.3f} of phase 4's dense bf16 cache, {dense_bytes} "
                  f"bytes); card {card_line}", flush=True)
            with torch.inference_mode():
                check_cache_logits(engine.model, torch, prompts, answers, dev,
                                   cfg.get("prefill_chunk"))
            # The logits each token was drawn from, kept in a second pass
            # of the same requests outside the timed one.
            with drawn_logits(engine, taps):
                tapped = predictor.predict(instances)
            tapped_stats = predictor.stats()
            tapped_rate = ((tapped_stats["decode_tokens"] - stats["decode_tokens"])
                           / (tapped_stats["decode_s"] - stats["decode_s"]))
            notes = first_difference_margins(torch, taps, tapped, dense_answers)
            print(f"  logit-keeping pass: decode {tapped_rate:.1f} tokens/s; streams "
                  f"{'identical to' if tapped == answers else 'NOT identical to'} the timed "
                  "pass's; first differences from phase 4's streams, from the logits the "
                  "engine drew each token from, its token's logit: "
                  + ("; ".join(notes) or "none"), flush=True)
            del taps
            out[name] = launches
            if name in PROFILED_SLICES:
                predictor.stop()  # the engine is now driven from this thread alone
                profile_paged_decode(engine, torch, prompts, name, PROFILED_SLICES[name])
            elif name == "int8":
                predictor.stop()
                profile_admission(engine, torch, prompts)
        finally:
            predictor.stop()
        del predictor, engine
        torch.cuda.empty_cache()
    return out


def engine_parity(torch, params, dev) -> None:
    """Phase 8b: the paged engine against the dense engine of the same
    cache dtype, fp32 at full width and 2 layers, on a pool small enough
    to preempt."""
    from hops_tpu_torch.models.transformer import TransformerLM
    from hops_tpu_torch.modelrepo.lm_engine import LMEngine

    model = TransformerLM(**PARITY, ragged_decode=True, device=dev)
    names = {n.replace(".", "/") for n in model.state_dict()}
    model.load_flax({n: a for n, a in params.items() if n in names})
    rng = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, PARITY["vocab_size"], (PARITY_PROMPT,), generator=rng).tolist()
               for _ in range(2)]
    for dt in (None, "int8"):
        m = model if dt is None else model.clone(kv_cache_dtype=dt)
        dense = LMEngine(m, slots=2, device=dev)
        paged = LMEngine(m, slots=2, kv_page_size=PARITY_PAGE, kv_pool_blocks=PARITY_POOL,
                         device=dev)
        streams = []
        for engine in (dense, paged):
            tickets = [engine.submit(p, max_new_tokens=PARITY_NEW) for p in prompts]
            res = engine.run()
            streams.append([res[t] for t in tickets])
        stats = paged.stats()
        if not stats["preemptions"]:
            raise AssertionError(f"phase 8b {dt}: the pool of {PARITY_POOL} blocks never preempted")
        notes = []
        for p, a, b in zip(prompts, *streams):
            if a == b:
                continue
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            # The dense engine's logits at the first difference, replayed
            # on a batch-1 dense cache.
            with torch.inference_mode():
                cache = m.init_cache(1)
                seq = torch.tensor([p + a[:j]], dtype=torch.long, device=dev)
                logits = m(seq, cache, fresh=True)[0, -1]
            top2 = torch.topk(logits, 2).values
            gap, scale = (top2[0] - top2[1]).item(), logits.abs().max().item()
            notes.append(f"streams differ at token {j}: dense top-2 gap {gap:.3e} "
                         f"(near tie below {TIE_REL * scale:.3e})")
            if not gap < TIE_REL * scale:
                raise AssertionError(f"phase 8b {dt}: paged and dense streams differ at token {j} "
                                     f"without a near tie ({gap:.3e})")
        print(f"phase 8b parity {dt or 'fp32'} pools: 2 requests of {PARITY_PROMPT} + "
              f"{PARITY_NEW} tokens, page {PARITY_PAGE}, pool {PARITY_POOL} blocks: preemptions "
              f"{stats['preemptions']}, peak blocks {stats['blocks_peak_used']}; "
              + ("; ".join(notes) if notes else "greedy streams identical"), flush=True)


def profile_decode(engine, torch, prompts, steps: int = 10) -> None:
    """Phase 6: a ``torch.profiler`` trace of ``steps`` engine decode
    steps with all 4 slots busy — device busy time per step, the idle
    share of the wall time, and the kernels that take the device time.
    The profiler's own host cost inflates the wall time."""
    for p in prompts[:4]:
        engine.submit(p, max_new_tokens=steps + 8)
    for _ in range(4):  # admission, then warm decode steps
        engine.step()

    def run():
        for _ in range(steps):
            engine.step()

    wall_ms, busy, kernels = device_profile(torch, run, steps)
    engine.run()
    k4 = [(ms, n) for key, ms, n in kernels if any(k in key for k in SPLIT_KERNEL_NAMES)]
    k4_ms = sum(ms for ms, _ in k4)
    print(f"phase 6 profile: {steps} decode steps at 4 busy slots: wall {wall_ms:.3f} ms/step "
          f"(profiled), device busy {busy:.3f} ms/step, idle share {1 - busy / wall_ms:.3f}, "
          f"{sum(n for _, _, n in kernels)} kernel launches/step; K4 (split body and combine) "
          f"{k4_ms:.4f} ms/step ({k4_ms / busy:.1%} of busy, {sum(n for _, n in k4)} "
          "launches/step)", flush=True)
    if not k4 or any(ROWS_KERNEL_NAME in key for key, _, _ in kernels):
        raise AssertionError("phase 6: K4's decode steps must run its split body, not the 64-row body")
    for name, ms, n in kernels[:8]:
        print(f"  {ms:.4f} ms/step ({ms / busy:.1%} of busy, {n}/step) {name[:90]}", flush=True)


def profile_admission(engine, torch, prompts) -> None:
    """Phase 8 (a)'s profile: one admission wave of the int8 engine (its
    4 slots take the first 4 prompts in one prefill), whose K5 wide calls
    must run the tensor-core forward body over int8 K/V, and neither the
    chunk body nor K1's bf16 instantiation of the same body."""
    for p in prompts[:4]:
        engine.submit(p, max_new_tokens=4)
    wall_ms, busy, kernels = device_profile(torch, engine.step)
    engine.run()
    fwd = [(ms, n) for key, ms, n in kernels if FWD_Q8_KERNEL_NAME in key]
    fwd_ms = sum(ms for ms, _ in fwd)
    print(f"phase 8 int8 profile: one admission wave (4 prompts): wall {wall_ms:.3f} ms "
          f"(profiled), device busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}, "
          f"{sum(n for _, _, n in kernels)} kernel launches; K5's wide calls on the forward body "
          f"over int8 K/V {fwd_ms:.4f} ms ({fwd_ms / busy:.1%} of busy, "
          f"{sum(n for _, n in fwd)} launches)", flush=True)
    for kname, ms, n in kernels[:6]:
        print(f"  {ms:.4f} ms ({ms / busy:.1%} of busy, {n}) {kname[:90]}", flush=True)
    others = [key for key, _, _ in kernels
              if CHUNK_KERNEL_NAME in key or "fwd::fwd_kernel<128, false>" in key]
    if not fwd or others:
        raise AssertionError("phase 8 int8: the admission wave must run K5's forward body over "
                             f"int8 K/V and no other attention body: {others}")


def profile_paged_decode(engine, torch, prompts, name: str, label: str, steps: int = 10) -> None:
    """Phase 8's profiles of the paged engine of slice ``name`` (its
    kernel ``label``: K6 over bf16 pools, K7 over int8): one fused
    prefill-chunk step (the second step after admission: two slots take
    their next 256-token chunk, two decode), with the share of the
    tensor-core chunk body; then, as phase 6, ``steps`` decode steps with
    all 4 slots busy, taken once every prompt is prefilled, plus the
    kernel's share of the device time (split body and combine)."""
    for p in prompts[:4]:
        engine.submit(p, max_new_tokens=steps + 40)
    engine.step()  # admission and the first chunks
    pending = sum(st is not None and st.pending is not None for st in engine._slot_state)
    wall_ms, busy, kernels = device_profile(torch, engine.step)
    chunk = [(ms, n) for key, ms, n in kernels if CHUNK_KERNEL_NAME in key]
    chunk_ms = sum(ms for ms, _ in chunk)
    print(f"phase 8 {name} profile: one fused prefill-chunk step ({pending} slots prefilling, "
          f"{4 - pending} decoding): wall {wall_ms:.3f} ms (profiled), device busy {busy:.3f} ms, "
          f"idle share {1 - busy / wall_ms:.3f}, {sum(n for _, _, n in kernels)} kernel launches; "
          f"{label}'s chunk body {chunk_ms:.4f} ms ({chunk_ms / busy:.1%} of busy, "
          f"{sum(n for _, n in chunk)} launches)", flush=True)
    for kname, ms, n in kernels[:8]:
        print(f"  {ms:.4f} ms ({ms / busy:.1%} of busy, {n}) {kname[:90]}", flush=True)
    if not pending or not chunk or any(ROWS_KERNEL_NAME in key for key, _, _ in kernels):
        raise AssertionError(f"phase 8 {name}: a bf16 prefill-chunk step must run {label}'s chunk "
                             "body, not the 64-row body")
    while any(st is not None and st.pending is not None for st in engine._slot_state):
        engine.step()
    for _ in range(2):  # warm decode steps
        engine.step()

    def run():
        for _ in range(steps):
            engine.step()

    wall_ms, busy, kernels = device_profile(torch, run, steps)
    slots_busy = engine.stats()["slots_busy"]
    engine.run()
    if slots_busy != 4:
        raise AssertionError(f"phase 8 {name} profile: {slots_busy} busy slots, not 4")
    split = [(ms, n) for key, ms, n in kernels if any(k in key for k in SPLIT_KERNEL_NAMES)]
    split_ms = sum(ms for ms, _ in split)
    print(f"phase 8 {name} profile: {steps} decode steps at 4 busy slots: wall {wall_ms:.3f} "
          f"ms/step (profiled), device busy {busy:.3f} ms/step, idle share "
          f"{1 - busy / wall_ms:.3f}, {sum(n for _, _, n in kernels)} kernel launches/step; "
          f"{label} (split body and combine) {split_ms:.4f} ms/step ({split_ms / busy:.1%} of busy, "
          f"{sum(n for _, n in split)} launches/step)", flush=True)
    for kname, ms, n in kernels[:8]:
        print(f"  {ms:.4f} ms/step ({ms / busy:.1%} of busy, {n}/step) {kname[:90]}", flush=True)
    if not split or any(ROWS_KERNEL_NAME in key for key, _, _ in kernels):
        raise AssertionError(f"phase 8 {name}: decode steps must run {label}'s split body, not "
                             "the 64-row body")


def device_profile(torch, run, steps: int = 1) -> tuple[float, float, list]:
    """``torch.profiler`` over ``run()``: host wall ms and device busy ms
    per step, and ``(name, ms per step, launches per step)`` of each
    device kernel, largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = sorted((
        (e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)  # ranges such as Adam.step
    ), key=lambda k: -k[1])
    busy = sum(ms for _, ms, _ in kernels)
    if not busy:
        raise AssertionError("the profiler recorded no device time")
    return wall_ms, busy, kernels


def train_slice(A, torch, np, params, dev, seed: int, card_line: str) -> dict:
    """Phase 7: the full-width train step, timed; returns the launch
    counts of the timed steps."""
    from hops_tpu_torch.models.common import create_train_state
    from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step

    model = TransformerLM(**TRAIN, device=dev).load_flax(params)
    state = create_train_state(model, seed=seed, learning_rate=LEARNING_RATE)
    step = make_lm_train_step(loss_chunk=LOSS_CHUNK)
    tokens = np.random.default_rng(seed + 2).integers(
        0, TRAIN["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    losses = []
    for _ in range(WARMUP_STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = A.launch_counts()
    losses = [float(x) for x in losses]
    layers = TRAIN["num_layers"]
    print(f"  losses {[round(x, 4) for x in losses]}; launches over {TIMED_STEPS} timed steps "
          f"{launches}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    for name in TRAIN_KERNELS:
        if launches[name] != layers * TIMED_STEPS:
            raise AssertionError(f"{name} launched {launches[name]} times in {TIMED_STEPS} steps, "
                                 f"not {layers} a step")
    # bench.py run_lm_bench: 6 * N_matmul per token plus causal attention.
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = model.embed.embedding.numel()
    flops_per_token = 3 * (2 * (n_params - n_embed)
                           + 2 * TRAIN["d_model"] * TRAIN_SEQ * layers)
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * TIMED_STEPS / elapsed
    step_ms = elapsed / TIMED_STEPS * 1e3
    mfu = tokens_per_s * flops_per_token / PEAK_BF16_FLOPS
    print(f"phase 7 train: {n_params / 1e6:.1f}M params ({(n_params - n_embed) / 1e6:.1f}M matmul), "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}: step {step_ms:.3f} ms, {tokens_per_s:.1f} tokens/s, "
          f"MFU {mfu:.4f} ({tokens_per_s * flops_per_token / 1e12:.2f} model TFLOP/s of 989); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card_line}",
          flush=True)
    wall, busy, kernels = device_profile(torch, lambda: step(state, batch))
    groups = {n: 0.0 for n in (*TRAIN_KERNELS, "matmul", "other")}
    for key, ms, _ in kernels:
        group = next((n for n, names in TRAIN_KERNEL_NAMES.items()
                      if any(k in key for k in names)), None)
        if group is None:
            group = "matmul" if re.search(r"gemm|nvjet|cutlass|sm90_xmma", key) else "other"
        groups[group] += ms
    print(f"  profiled step: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}, {sum(c for _, _, c in kernels)} kernel launches; "
          + ", ".join(f"{n} {ms:.3f} ms ({ms / busy:.1%})" for n, ms in groups.items()),
          flush=True)
    for name, ms, n in kernels[:12]:
        print(f"  {ms:.4f} ms/step ({ms / busy:.1%} of busy, {n}/step) {name[:90]}", flush=True)
    return launches


def check_grads(A, torch, np, params, dev, seed: int) -> None:
    """Phase 7b. fp32: per parameter, ``||g_kernel - g_plain||inf <=
    GRAD_REL * ||g_plain||inf``. bf16 (``GRAD_BF16``, the same weights),
    over ``GRAD_SEEDS`` token batches: per parameter, ``||g_kernel -
    g_ref||_2 <= BF16_VS_PLAIN * ||g_plain - g_ref||_2``, each norm over
    all the batches, with ``g_ref`` the plain fp32 gradient."""
    from hops_tpu_torch.models.transformer import TransformerLM
    from hops_tpu_torch.ops.xent import chunked_softmax_xent

    model = TransformerLM(**GRAD_CHECK, device=dev)
    names = {n.replace(".", "/") for n in model.state_dict()}
    model.load_flax({n: a for n, a in params.items() if n in names})
    names = [n for n, _ in model.named_parameters()]

    def grads(m, i):
        tokens = torch.from_numpy(np.random.default_rng(seed + 3 + i).integers(
            0, GRAD_CHECK["vocab_size"], (GRAD_BATCH, TRAIN_SEQ + 1))).to(dev)
        hidden = m(tokens[:, :-1], train=True, return_hidden=True)
        loss = chunked_softmax_xent(hidden, m.unembed.kernel, tokens[:, 1:], chunk=LOSS_CHUNK)
        return torch.autograd.grad(loss, list(m.parameters()))

    # Both clones share the fp32 weights.
    plain = model.clone(attention_impl="reference")
    ref = grads(plain, 0)
    got = grads(model, 0)
    worst, worst_name = 0.0, ""
    for name, g, r in zip(names, got, ref):
        ratio = (g - r).abs().max().item() / r.abs().max().item()
        if not ratio <= GRAD_REL:
            raise AssertionError(f"{name}: ||kernel - plain||inf / ||plain||inf = {ratio:.3e}")
        if ratio >= worst:
            worst, worst_name = ratio, name
    print(f"phase 7b grads fp32: {len(got)} parameter tensors, worst ||kernel - plain||inf / "
          f"||plain||inf {worst:.3e} ({worst_name}; bound {GRAD_REL:.0e})", flush=True)
    del got

    kernel_bf16 = model.clone(**GRAD_BF16)
    plain_bf16 = kernel_bf16.clone(attention_impl="reference")
    sums = torch.zeros(3, len(names), dtype=torch.float64)  # kernel, plain bf16, ref
    for i in range(GRAD_SEEDS):
        if i:
            ref = grads(plain, i)
        for j, (g, p, r) in enumerate(zip(grads(kernel_bf16, i), grads(plain_bf16, i), ref)):
            sums[:, j] += torch.stack([(g - r).double().square().sum(), (p - r).double().square().sum(),
                                       r.double().square().sum()]).cpu()
    dk, dp, norm = sums.sqrt()
    ratios = [a / b if b else (0.0 if a == 0 else math.inf) for a, b in zip(dk.tolist(), dp.tolist())]
    j = max(range(len(names)), key=ratios.__getitem__)
    print(f"phase 7b grads bf16 ({GRAD_BF16}, {GRAD_SEEDS} token batches): {len(names)} parameter "
          f"tensors, ||kernel - plain fp32||_2 / ||plain bf16 - plain fp32||_2 worst {ratios[j]:.3f} "
          f"({names[j]}; bound {BF16_VS_PLAIN}), median {sorted(ratios)[len(ratios) // 2]:.3f}, "
          f"per parameter [{' '.join(f'{x:.3f}' for x in ratios)}]; kernel path's largest "
          f"distance {(dk / norm).max().item():.3e} of ||plain fp32||_2", flush=True)
    bad = [f"{n} {x:.3f}" for n, x in zip(names, ratios) if not x <= BF16_VS_PLAIN]
    if bad:
        raise AssertionError(f"bf16 gradients over {BF16_VS_PLAIN} x the plain bf16 path's "
                             f"distance: {', '.join(bad)}")


def bound(flops: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _hist(REGISTRY, name: str) -> tuple[float, float]:
    """(sum, count) of an unlabelled histogram of the port's registry."""
    rows = {n: v for n, _, v in REGISTRY.get(name).samples() if n in ("_sum", "_count")}
    return rows.get("_sum", 0.0), rows.get("_count", 0.0)


def _state_tensors(state) -> dict:
    """A train state's weights, buffers and optimizer state by name."""
    out = dict(state.model.state_dict())
    for i, per_param in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in per_param.items()
                    if hasattr(v, "shape")})
    return out


def _distance(torch, a: dict, b: dict) -> float:
    """Largest ``||a - b||inf / ||b||inf`` over the tensors of two states."""
    worst = 0.0
    for k, v in b.items():
        ref = v.double().abs().max().item() or 1.0
        worst = max(worst, (a[k].double() - v.double()).abs().max().item() / ref)
    return worst


def preempt_and_resume(torch, name: str, make_state, step_fn, batches, work: Path,
                       per_step: int, unit: str, card_line: str) -> dict:
    """Phase 9 for one model: launches A, B and C of one wrapper (and a
    second uninterrupted run only if C differs from A), the checks that
    hold them together, and the checkpoint timings. Returns the runs."""
    import os
    import signal
    import warnings

    from hops_tpu_torch import experiment
    from hops_tpu_torch.experiment import registry, tensorboard
    from hops_tpu_torch.runtime import checkpoint
    from hops_tpu_torch.runtime.logging import read_metrics
    from hops_tpu_torch.runtime.preemption import run_preemptible
    from hops_tpu_torch.telemetry.metrics import REGISTRY

    runs: dict[str, dict] = {}

    def wrapper(tag: str, directory: Path, preempt_at):
        def train():
            state = make_state()
            losses, times = {}, []

            def step(state, batch):
                if preempt_at is not None and state.step == preempt_at:
                    os.kill(os.getpid(), signal.SIGTERM)  # honoured at the step boundary
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses[state.step - 1] = metrics["loss"]
                return state, metrics

            state, metrics, done = run_preemptible(step, state, batches,
                                                   directory=str(directory),
                                                   save_every=SAVE_EVERY)
            for s, loss in sorted(losses.items()):
                tensorboard.scalar(s, "loss", float(loss))
            print(f"phase 9 {name} run {tag}: steps {min(losses)}..{max(losses)} of "
                  f"{LAUNCH_STEPS}, completed {done}, losses "
                  f"{[round(float(x), 5) for _, x in sorted(losses.items())]}", flush=True)
            runs[tag] = dict(state=state, losses=losses, times=times, done=done)
            return {"loss": float(metrics["loss"]), "steps": done}
        return train

    def launch(tag: str, directory: Path, preempt_at=None) -> None:
        before = {m: _hist(REGISTRY, f"hops_tpu_checkpoint_{m}_seconds")
                  for m in ("snapshot", "write", "restore")}
        bytes0 = REGISTRY.get("hops_tpu_checkpoint_bytes_total").value()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            path, metrics = experiment.launch(wrapper(tag, directory, preempt_at), name=name)
        run = runs[tag]
        run["nondeterministic"] = sorted({str(w.message).split(" does not have")[0]
                                          for w in caught
                                          if "deterministic implementation" in str(w.message)})
        run["ckpt"] = {m: tuple(x - y for x, y in zip(
            _hist(REGISTRY, f"hops_tpu_checkpoint_{m}_seconds"), before[m])) for m in before}
        run["bytes"] = REGISTRY.get("hops_tpu_checkpoint_bytes_total").value() - bytes0
        log = Path(metrics["log"]).read_text()
        if f"phase 9 {name} run {tag}:" not in log:
            raise AssertionError(f"phase 9 {name} {tag}: output.log lacks the wrapper's print")
        logged = sorted(e["step"] for e in read_metrics(Path(path) / "metrics.jsonl")
                        if e["tag"] == "loss")
        if logged != sorted(run["losses"]):
            raise AssertionError(f"phase 9 {name} {tag}: metrics.jsonl holds steps {logged}")
        with checkpoint.CheckpointManager(directory) as mgr:
            bad = {s: r for s in mgr.all_steps() if (r := mgr.verify_step(s))}
            if bad or not mgr.all_steps():
                raise AssertionError(f"phase 9 {name} {tag}: steps {mgr.all_steps()}, failing "
                                     f"verification {bad}")
            run["steps"] = mgr.all_steps()

    launch("A", work / "a")
    launch("B", work / "bc", preempt_at=PREEMPT_AT)
    launch("C", work / "bc")
    a, b, c = runs["A"], runs["B"], runs["C"]
    if (a["done"], b["done"], c["done"]) != (LAUNCH_STEPS, PREEMPT_AT + 1, LAUNCH_STEPS):
        raise AssertionError(f"phase 9 {name}: completed steps A {a['done']}, B {b['done']}, "
                             f"C {c['done']}")
    if min(c["losses"]) != PREEMPT_AT + 1:
        raise AssertionError(f"phase 9 {name}: C resumed at step {min(c['losses'])}")
    losses_bc = {**b["losses"], **c["losses"]}
    if not all(math.isfinite(float(x)) for x in a["losses"].values()):
        raise AssertionError(f"phase 9 {name}: a loss is not finite")
    ta, tc = _state_tensors(a["state"]), _state_tensors(c["state"])
    same = (sorted(losses_bc) == sorted(a["losses"])
            and all(torch.equal(losses_bc[k], v) for k, v in a["losses"].items())
            and ta.keys() == tc.keys() and all(torch.equal(tc[k], v) for k, v in ta.items()))
    nondet = sorted({op for r in runs.values() for op in r["nondeterministic"]})
    if same:
        print(f"phase 9 {name}: C's losses and final weights, statistics and optimizer state "
              f"({len(ta)} tensors) equal A's bit for bit; ops without a deterministic "
              f"implementation: {nondet or 'none'}", flush=True)
    else:
        launch("A2", work / "a2")
        t2 = _state_tensors(runs["A2"]["state"])
        d_ca, d_aa = _distance(torch, tc, ta), _distance(torch, t2, ta)
        print(f"phase 9 {name}: C differs from A by {d_ca:.3e}, a second uninterrupted run by "
              f"{d_aa:.3e} (largest ||x - A||inf / ||A||inf); ops without a deterministic "
              f"implementation: {nondet or 'none'}", flush=True)
        if not (d_aa > 0 and d_ca <= 2 * d_aa):
            raise AssertionError(f"phase 9 {name}: the resumed run is not within twice the "
                                 "distance of two uninterrupted runs")
    records = registry.list_runs(name)
    if len(records) != len(runs) or any(r["status"] != "FINISHED" for r in records):
        raise AssertionError(f"phase 9 {name}: registry holds "
                             f"{[(r['run_id'], r['status']) for r in records]}")
    step_s = sorted(a["times"][1:])[len(a["times"][1:]) // 2]
    snap = [r["ckpt"]["snapshot"] for r in runs.values()]
    write = [r["ckpt"]["write"] for r in runs.values()]
    restore = c["ckpt"]["restore"]
    n_saves = sum(n for _, n in write)
    print(f"phase 9 {name}: step {step_s * 1e3:.3f} ms (median of A's steps 1-7), "
          f"{per_step / step_s:.1f} {unit}/s; checkpoint {sum(r['bytes'] for r in runs.values()) / n_saves / 2**20:.1f} MiB; "
          f"save holds the loop {sum(t for t, _ in snap) / n_saves * 1e3:.1f} ms (copy to host), "
          f"background write + publish + checksums {sum(t for t, _ in write) / n_saves * 1e3:.1f} ms "
          f"(mean of {n_saves:.0f} saves); C's restore {restore[0] / max(restore[1], 1) * 1e3:.1f} ms; "
          f"registry {len(records)} runs FINISHED, steps kept {c['steps']}; card {card_line}",
          flush=True)
    return runs


def launch_phase(A, torch, dev, seed: int, card_line: str) -> dict[str, int]:
    """Phase 9; returns the launch counts of the LM's three launches."""
    from hops_tpu_torch.models.common import (
        SyntheticClassData, create_bn_train_state, create_train_state, make_bn_train_step,
        step_seed,
    )
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.models.resnet import ResNet50
    from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
    from hops_tpu_torch.runtime import checkpoint, config, faultinject

    work = ROOT / "_smoke" / "launch"
    config.configure(workspace=str(work / "workspace"), project="chip_smoke")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        # (a) ResNet-50.
        data = SyntheticClassData(num_classes=RESNET_CLASSES,
                                  shape=(RESNET_IMAGE, RESNET_IMAGE, 3), seed=seed, device=dev)

        def resnet_state():
            return create_bn_train_state(ResNet50(RESNET_CLASSES, device=dev, seed=seed))

        runs = preempt_and_resume(
            torch, "resnet50", resnet_state, make_bn_train_step(),
            lambda k: data.batches(RESNET_BATCH, LAUNCH_STEPS, start=k), work / "resnet50",
            RESNET_BATCH, "images", card_line)
        template = resnet_state()
        bc = work / "resnet50" / "bc"
        newest = max(runs["C"]["steps"])
        faultinject.corrupt_directory(bc / str(newest))
        restored, start = checkpoint.restore_or_init(template, bc)
        want = _state_tensors(runs["B"]["state"])
        got = _state_tensors(restored)
        if not (start == PREEMPT_AT + 1 and (bc / f"corrupt_{newest}.quarantined").is_dir()
                and all(torch.equal(got[k], v) for k, v in want.items())):
            raise AssertionError(f"phase 9 resnet50: a corrupt step {newest} gave start {start}")
        print(f"phase 9 resnet50: the corrupt newest step {newest} was quarantined and "
              f"restore_or_init fell back to step {start - 1}, B's final state", flush=True)
        # Where a step's time goes: the restored state takes one more step,
        # as a user runs it (deterministic algorithms also fill every new
        # allocation, and pick cuDNN's algorithms differently).
        batch = next(data.batches(RESNET_BATCH, LAUNCH_STEPS, start=start))
        step = make_bn_train_step()
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        wall, busy, kernels = device_profile(torch, lambda: step(restored, batch))
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        convs = [(ms, n) for key, ms, n in kernels if re.search(CONV_KERNELS, key)]
        conv = sum(ms for ms, _ in convs)
        print(f"phase 9 resnet50 profiled step: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
              f"idle share {1 - busy / wall:.3f}, {sum(c for _, _, c in kernels)} kernel "
              f"launches; convolutions and the matrix product {conv:.3f} ms ({conv / busy:.1%}, "
              f"{sum(n for _, n in convs)} launches), the rest (BatchNorm, activations, loss, "
              f"SGD) {busy - conv:.3f} ms", flush=True)
        for key, ms, n in kernels[:8]:
            print(f"  {ms:.4f} ms/step ({ms / busy:.1%} of busy, {n}/step) {key[:90]}", flush=True)
        del runs, template, restored, want, got, batch
        torch.cuda.empty_cache()

        # (b) the LM.
        params = random_params(**LAUNCH_LM, seed=seed)

        def lm_state():
            model = TransformerLM(**LAUNCH_LM, device=dev).load_flax(params)
            return create_train_state(model, seed=seed, learning_rate=LEARNING_RATE)

        def lm_batches(start):
            g = torch.Generator(device=dev)
            for i in range(start, LAUNCH_STEPS):
                g.manual_seed(step_seed(seed, i))
                yield {"tokens": torch.randint(0, LAUNCH_LM["vocab_size"],
                                               (TRAIN_BATCH, TRAIN_SEQ + 1), generator=g,
                                               device=dev)}

        torch.cuda.synchronize()
        A.reset_launch_counts()
        preempt_and_resume(torch, "lm", lm_state, make_lm_train_step(loss_chunk=LOSS_CHUNK),
                           lm_batches, work / "lm", TRAIN_BATCH * TRAIN_SEQ, "tokens", card_line)
        launches = A.launch_counts()
        missing = [k for k in TRAIN_KERNELS if not launches[k]]
        if missing:
            raise AssertionError(f"phase 9 lm: {missing} never launched through experiment.launch")
        print(f"phase 9 lm: launches through experiment.launch "
              f"{ {k: launches[k] for k in TRAIN_KERNELS} }", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(work, ignore_errors=True)
    b, h, d = TRAIN_BATCH, LAUNCH_LM["num_heads"], LAUNCH_LM["d_model"] // LAUNCH_LM["num_heads"]
    gen = torch.Generator().manual_seed(seed + 9)
    q, k, v, do = (torch.randn(b, h, TRAIN_SEQ, d, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(4))
    o, lse = A.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = (o.float() * do.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    repro = {}
    for name, fn in (("flash_bwd_dq", A.flash_bwd_dq), ("flash_bwd_dkv", A.flash_bwd_dkv)):
        outs = [fn(*args, causal=True) for _ in range(2)]
        outs = [(out,) if torch.is_tensor(out) else tuple(out) for out in outs]
        repro[name] = all(torch.equal(x, y) for x, y in zip(*outs))
    print(f"phase 9: bit-reproducible on two calls at ({b},{h},{TRAIN_SEQ},{d}) bf16 causal: "
          + ", ".join(f"{n} {r}" for n, r in repro.items()), flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # cuBLAS is deterministic on one stream only with a fixed workspace
    # (phase 9 runs under torch.use_deterministic_algorithms); set before
    # the first cuBLAS call. 8 x 4 MiB is PyTorch's own size on Hopper.
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    if not (ROOT / "hops_tpu_torch" / "ops" / "csrc").is_dir():
        return fail(f"no hops_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import numpy as np

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
    report_tc_bodies(_build, report)

    gen = torch.Generator().manual_seed(args.seed)
    print("phase 3 kernels against plain versions (bf16 and fp32 in, fp32 plain):", flush=True)
    with torch.inference_mode():
        worst = check_kernels(A, torch, gen, dev)
    print("phase 3 ok: worst error " + ", ".join(
        f"{k} {w['bfloat16']:.3e} (bf16) {w['float32']:.3e} (fp32)" for k, w in worst.items()
    ), flush=True)
    print("phase 3b backward kernels against plain versions (bf16 and fp32 in, fp32 plain):",
          flush=True)
    with torch.inference_mode():
        worst.update(check_bwd_kernels(A, torch, gen, dev))
    print("phase 3b ok: worst error " + ", ".join(
        f"{k} {worst[k]['bfloat16']:.3e} (bf16) {worst[k]['float32']:.3e} (fp32)"
        for k in ("flash_bwd_dq", "flash_bwd_dkv")
    ), flush=True)
    print("phase 3c int8 and paged decode kernels against plain versions (bf16 and fp32 in, "
          "fp32 plain):", flush=True)
    with torch.inference_mode():
        worst.update(check_cache_kernels(A, torch, gen, dev))
    print("phase 3c ok: worst error " + ", ".join(
        f"{k} {worst[k]['bfloat16']:.3e} (bf16) {worst[k]['float32']:.3e} (fp32)"
        for k in CACHE_KERNELS
    ), flush=True)

    art = ROOT / "_smoke" / "artifact"
    predictor = None
    try:
        t0 = time.perf_counter()
        params = random_params(**MODEL, seed=args.seed)
        save_lm_artifact(art, MODEL, params)
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
        if not (launches["flash_fwd"] > 0 and launches["decode_attention"] > 0):
            return fail(f"a kernel of the serving path never launched: {launches}")
        decode_tok_s = stats["decode_tokens"] / stats["decode_s"]
        print(f"  answers: {[len(a) for a in answers]} tokens; launches {launches}; "
              f"admission waves {stats['admission_waves']}, decode steps {stats['dispatches']}",
              flush=True)
        print(f"  ttft_ms {[round(t * 1e3, 1) for t in ttft]}; decode {decode_tok_s:.1f} tokens/s "
              f"({stats['decode_tokens']} tokens in {stats['decode_s']:.3f} s of decode steps); "
              f"prefill {stats['prefill_s']:.3f} s; wall {wall:.3f} s; card {card_line}", flush=True)
        with torch.inference_mode():
            check_logits(predictor.engine.model, torch, prompts, answers, dev)
        dense_bytes = kv_bytes(predictor.engine._cache)
        print("phase 4 ok", flush=True)
        with torch.inference_mode():
            rows = time_kernels(A, torch, gen, dev, launches, worst)
        for r in rows:
            print(f"phase 5 {r['name']} at {r['shape']}: {r['ms']:.4f} ms"
                  + (f" ({r['n_splits']} splits)" if "n_splits" in r else "")
                  + f"; bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms; "
                  f"scaled_dot_product_attention {r['library_ms']:.4f} ms; card {card_line}", flush=True)
        predictor.stop()  # the engine is now driven from this thread alone
        profile_decode(predictor.engine, torch, prompts)
        del predictor
        predictor = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        print("phase 7 training slice:", flush=True)
        train_launches = train_slice(A, torch, np, params, dev, args.seed, card_line)
        print("phase 7 ok", flush=True)
        torch.cuda.empty_cache()
        check_grads(A, torch, np, params, dev, args.seed)
        print("phase 7b ok", flush=True)
        torch.cuda.empty_cache()
        bwd_rows = time_bwd_kernels(A, torch, gen, dev, train_launches, worst, TIMED_STEPS)
        for r in bwd_rows:
            print(f"phase 5 {r['name']} at {r['shape']}: {r['ms']:.4f} ms; "
                  f"{r['launches_per_step']} launches per train step; bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms; backward of "
                  f"scaled_dot_product_attention (dq, dk, dv) {r['library_ms']:.4f} ms; "
                  f"card {card_line}", flush=True)
        torch.cuda.empty_cache()
        slice_launches = serve_cache_slices(A, torch, art, prompts, instances, answers,
                                            dense_bytes, dev, card_line)
        print("phase 8 ok", flush=True)
        engine_parity(torch, params, dev)
        print("phase 8b ok", flush=True)
        torch.cuda.empty_cache()
        cache_launches = {k: n for launches in slice_launches.values()
                          for k, n in launches.items() if k in CACHE_KERNELS and n}
        with torch.inference_mode():
            cache_rows = time_cache_kernels(A, torch, gen, dev, cache_launches, worst)
        for r in cache_rows:
            print(f"phase 5 {r['name']} at {r['shape']}: {r['ms']:.4f} ms"
                  + (f" ({r['n_splits']} splits)" if "n_splits" in r else "")
                  + f"; {r['launches']} launches in phase 8; bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms; scaled_dot_product_attention "
                  f"on the gathered/dequantized bf16 tensors {r['library_ms']:.4f} ms; "
                  f"card {card_line}", flush=True)
        torch.cuda.empty_cache()
        print("phase 9 launch:", flush=True)
        launch_launches = launch_phase(A, torch, dev, args.seed, card_line)
        print("phase 9 ok", flush=True)
        k1 = rows[0]
        k1["launches_by_path"] = {"serving": k1["launches"], "training": train_launches["flash_fwd"],
                                  "launch": launch_launches["flash_fwd"]}
        k1["launches"] += train_launches["flash_fwd"] + launch_launches["flash_fwd"]
        for r in bwd_rows:
            r["launches_by_path"] = {"training": r["launches"],
                                     "launch": launch_launches[r["name"]]}
            r["launches"] += launch_launches[r["name"]]
        rows = [k1, *bwd_rows, rows[1], *cache_rows]
    finally:
        if predictor is not None:
            predictor.stop()
        shutil.rmtree(ROOT / "_smoke", ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "launches_by_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
