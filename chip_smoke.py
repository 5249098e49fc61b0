#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hops_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root; it needs one CUDA device and ``nvcc``.
Where the interpreter writes no bytecode, the script keeps a cache of it
under ``_smoke/pycache`` for itself and every process it starts
(``bytecode_cache``). The phases run in order, each prints its result on
its own line, and any failure exits non-zero:

1. card     — the card's name and power limit (``nvidia-smi``);
2. build    — all seven kernels compiled from ``hops_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, six sources), with the build's wall time;
   for the bf16 tensor-core bodies (head dims 64 and 128) the registers
   and spills ptxas reports, the dynamic shared memory they launch with
   and, where ``cuobjdump`` exists, the count of HGMMA instructions in
   their SASS, which must not be 0: the ping-pong forward body of K1 over
   bf16 K/V, of K4's wide calls over bf16 K/V (its own instantiation in
   K4's source) and of K5's wide calls over int8 K/V (64-key tiles,
   printed), which must neither spill nor have its wgmmas serialized by
   ptxas (warning C7520), K2, K3, and the chunk body of K6 (bf16
   pools) and K7 (int8 pools), which must not spill; for the split-K body of K4,
   K5 (dense) and K6, K7 (paged), over bf16/fp32 and int8 caches, and its
   combine kernel their registers, stack frame, spills and shared memory;
3. kernels  — the forward and decode kernels (K1, K4) against their
   plain PyTorch versions (fp32) on the same seeded inputs: K1's bf16
   tensor-core body per element within its rounding bound (below); K4's
   decode calls (rows <= 16, its split-K body) with bf16 inputs per
   element within ``2**-8 * |plain| + 1e-4``, also across its 128-key
   split boundaries (``DENSE_SPLIT_CASES``), and its wider bf16 calls
   (K1's forward body over the bf16 cache) per element within the
   tensor-core rounding bound (below), also on every ``WIDE_CASES``
   shape with ``wide_lengths`` valid lengths (0, below s, a tile edge +
   1, 1300, full), windows none and 256, and with NaN and +-1e30 planted
   in K and V at or past valid_len changing no bit; fp32 inputs at the
   same shapes within 1e-4 (wider fp32 calls: the 64-row body), and the
   flash kernel's lse within 1e-4;
3b. backward — the flash backward kernels (K2 dq, K3 dk/dv) against
   their plain versions on the same (o, lse) from K1, at the same
   shapes plus a negative offset (rows that see no key), a window past
   an offset (keys no query sees) and ragged tails of K2's 128-row and
   64-key tiles: the bf16 tensor-core bodies of K2 and K3 within their
   rounding bounds, fp32 inputs within ``1e-4 * max(1, max|plain|)`` per
   output, and exact zeros in dq for rows that see no key and in dk/dv
   for keys that no query sees (outputs are allocated over freed
   NaN-filled memory first); then K1, K2 and K3 at head_dim 8, 16 and
   32 (``kernel_checks.narrow_head_checks``: zero-padded to 64 at the
   entry points), bf16 and fp32, within the same bounds, one launch each;
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
   (4, 8, 2048, d), valid_len 2048, causal: 16 row tiles per head). Last,
   K4-K7 at head_dim 8, 16 and 32 on their split and wide bodies
   (zero-padded to 64), each once on caches at the narrow dim and once
   on caches allocated at 64 with zero pad columns, which must give the
   same bits. The cases and operands come from
   ``hops_tpu_torch/ops/kernel_checks.py``, which the card tests share;
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
   card's name and power limit;
10. levers — phase 4's artifact and layer-skip drafts (the target's
   embedding, first blocks, final norm and head: 2 blocks, and 11) are
   registered in the port's model registry, and the predictor and the
   engine serve at full width: (a) dense speculation with the 2-block
   draft by name, ``spec_k`` 4, on phase 4's requests (acceptance,
   tokens per dispatch, decode tokens/s, TTFT, and a profiled dispatch
   at 4 busy slots); the target as its own draft must accept at least
   0.9; the 11-block draft on 4 requests; (b) ``decode_horizon`` 8 on the
   dense engine and on phase 8 (b)'s paged engine, whose streams on
   phase 4's first 4 requests (one admission wave) must equal horizon
   1's bit for bit, with dispatches, read-backs per token, decode
   tokens/s and a profiled horizon dispatch; (c) a 300-token prefix (4
   pages of 64 and 44 tokens) in front of phase 4's prompts, on the
   dense engine and on the paged one with the 2-block draft, bf16 and
   int8: the
   first request prefills the prefix, the other 7 must hit it, a shared
   page must reach refcount 2, streams are held to the dense engine of
   the same cache dtype on the full prompts, and the layout's kernels
   must launch (K4's wide calls on the forward body for the dense bf16
   suffix appends; the prefix hits' TTFT p50 is printed); (d) priority
   admission on 2 slots, 6 batch requests
   then 2 interactive ones, the interactive ones admitted first; (e)
   ``run_offline`` on phase 4's requests; (f) ``generate_speculative``
   (batch 2, k 4) against greedy ``generate``, ``beam_search`` with beam
   1 equal to greedy and, with beam 4, scores within ``1e-2 * |score|``
   of the fp32 plain model's log-probability of the returned tokens. A
   stream may leave its reference only at a near tie: the two tokens'
   logits under the plain attention over the common prefix within
   ``NEAR_TIE_REL * ||logits||inf``. Every kernel of the path must launch.
11. serving — the HTTP serving host (``modelrepo.serving``) in its own
   workspace: (a) phase 4's artifact, registered in the port's registry,
   behind an ``LM`` endpoint (4 slots, phase 10's prefix as ``"sys"``):
   phase 4's 8 requests from 8 concurrent client threads through
   ``make_inference_request``, then its first 4 again with ``"prefix_id":
   "sys"`` from 4 threads; each stream must equal phase 4's (the prefix
   requests: phase 10 (c)'s dense bf16 engine on the full prompts) up to
   the near-tie rule; prints the client-seen latency p50/p99 and the
   engine's TTFT p50, and K1, K4 and K4's wide calls must launch; (b)
   ResNet-50 (phase 9's model at 224x224, bf16, seeded weights with
   redrawn BatchNorm statistics) saved as a classifier bundle behind a
   ``batching_enabled`` endpoint (``max_batch_size`` 16): two rounds of
   16 concurrent one-image requests in packed frames (the first meets
   cuDNN cold), the predictor alone on the 16 rows timed and profiled,
   each row's argmax (second round) equal to the
   module's own eval forward of the 16 rows (bar near ties), the logits'
   distance from the fp32 forward within ``CLASSIFIER_REL`` times the
   bf16 forward's own, fewer batches than requests, and a packed reply
   (``Accept``) that decodes to the JSON reply of the same rows; (c)
   ``/healthz`` 200, ``/metrics`` with the request counter and the batch
   fill histogram, and a request past ``max_inflight`` answered 503 with
   ``Retry-After``; (d) the model at 2 layers started with
   ``standalone=True``: a ``serving_host`` process of its own on the
   card answers one request as the in-process endpoint does, and
   ``stop`` ends the process and closes its port.
12. distribute — the distribution layer, within ``PHASE12_BUDGET_S``:
   (a) a child process started by ``python -m hops_tpu_torch.launch
   --coordinator 127.0.0.1:<port> --num-processes 1 --process-id 0
   chip_smoke.py --distribute-worker <spec>`` (a NCCL group of one rank,
   left in the child) trains phase 7's LM from phase 7's weights, batch
   and seed: 8 steps through ``experiment.collective_all_reduce`` (DDP,
   composable ``replicate``), whose losses must equal phase 7's bit for
   bit (one rank's all-reduce is a copy, its divide by 1), then 8 steps of
   ``ShardedStrategy(fsdp=-1)`` (FSDP2) from the same weights, each loss
   within ``FSDP_LOSS_REL`` of DDP's; K1-K3 launch ``num_layers`` times
   a step on both; (b) ``diagnostics.trace`` around 2 more DDP steps, then
   ``roofline_report`` against ``device_peaks`` of the card's name (K1-K3
   counted by PERF.md §2's count at their shapes) and ``top_ops``: the
   trace's kernel count of each of K1-K3 must equal its ``LAUNCHES``
   delta, and no category may read over 100% of a peak; (c)
   ``lm_generate_with_model`` on phase 4's registered artifact with phase
   4's requests, greedy (streams equal phase 4's up to the near-tie rule;
   K1 and K4 launch), and ``predict_with_model`` on phase 11's ResNet-50
   bundle over 100 images at ``per_chip_batch`` 32 (each argmax equal to
   the module's direct forward bar near ties, as phase 11 (b)); (d)
   ``experiment.launch`` trains ``WideAndDeep`` at the taxi pipeline's
   vocabularies (embed 8, hidden (128, 64), bf16) 50 Adam steps on
   ``make_taxi_batch`` 1024 (the loss must fall), and ``batch_predict`` of
   10 000 feature vectors must equal the direct forward within bf16
   rounding.
13. scale-out — gradient communication, sequence parallelism and MoE,
   within ``PHASE13_BUDGET_S``, all in a child started as phase 12
   starts its own (``chip_smoke.py --scaleout-worker <spec>``, one NCCL
   rank): (a) ResNet-50 (phase 9's model) through
   ``experiment.collective_all_reduce`` for ``SCALEOUT_STEPS`` steps in
   each of ``SCALEOUT_MODES`` under deterministic algorithms: at one rank
   every mode's losses must equal ``none``'s (DDP) bit for bit (``hier``
   takes the one-rank path and builds no process group); each mode's
   step ms beside ``none``'s, and its ``hops_tpu_grad_comms_*`` counter
   deltas must equal ``wire_bytes`` times the steps; (b)
   ``quantize_blockwise`` on the card over ResNet-50's gradient buckets:
   int8 blocks and scales equal the CPU's bit for bit, each element's
   round trip within half its block's step (plus one fp32 ulp of the
   block's largest value); (c) phase 7's LM with
   ``attention_impl="ulysses"`` on a one-rank seq mesh for ``SP_STEPS``
   steps (losses equal ``flash``'s bit for bit, K1-K3 ``num_layers``
   launches a step), then ``"ring"`` at ``RING_BATCH`` rows (its losses'
   distance from the fp32 plain path within ``RING_REL`` times the bf16
   flash path's); (d) the LM with ``moe_every=2`` (``MOE_TRAIN``: 8
   experts, top 2, capacity 1.25, hidden 4096) trained ``MOE_STEPS``
   steps at phase 7's batch (the loss must fall; aux loss, step ms,
   tokens/s, and a ``diagnostics.trace`` of one step with the
   dispatch/combine share), then phase 4's first ``MOE_REQUESTS``
   requests through ``LMEnginePredictor`` (4 slots) on the bf16 and the
   int8 cache, each
   against the same engine under the plain attention in bf16 and in
   fp32, teacher-forced to the served tokens and routing (the same call
   shapes, so the same capacity cuts): every drawn token's logits within
   ``MOE_TOKEN_REL`` times the plain bf16 run's distance from fp32 (the
   median within ``MOE_MEDIAN_REL``), each token the plain bf16 argmax
   up to a near tie, each flip of that run's router within
   ``ROUTER_MARGIN``; K1, K4 and K5 must launch; TTFT p50 and decode
   tokens/s.
14. model parallel — tensor and pipeline parallelism across two ranks on
   the one card, within ``PHASE14_BUDGET_S``: two children of this script
   (``--model-parallel-worker <spec> --rank 0|1``) form a gloo group (NCCL
   refuses two ranks on one card), so every CUDA tensor that crosses ranks
   goes through host buffers (``grad_comms.via_host``; the bytes are
   printed) while the arithmetic and every kernel stay on the card; the
   times are gloo-over-host times, not NVLink ones. (a) phase 4's
   artifact serving phase 4's first ``TP_REQUESTS`` requests through
   ``LMEngine(mesh=)`` at tp=2 on the dense bf16,
   int8, paged and paged int8 caches (``TP_CACHES``): both ranks' streams
   identical bit for bit, each equal to phase 4's (dense) or phase 8's
   (same cache) one-rank stream up to the near-tie rule, each cache's
   kernels launching on each rank (K1, K4, K5 and its wide calls, K6,
   K7); TTFT p50 and decode tokens/s; then ``tp_generate`` of
   ``TP_GEN_ROWS`` prompts against one-rank ``generate``; (b) the pp=2
   path: phase 7b's bf16 gradient rule with the pipeline as the kernel
   path (2 layers, one a stage, ``PP_GRAD_MICRO`` microbatches,
   ``GRAD_SEEDS`` batches), then phase 7's LM and weights through
   ``make_pp_lm_train_step`` at batch 8 x 2048, ``PP_MICRO``
   microbatches, ``PP_STEPS`` steps on the ring and on ``1f1b``: the
   1f1b losses equal the ring's bit for bit, the loss falls, each within
   ``FSDP_LOSS_REL`` of the one-rank dense step (same loss, weights,
   batch and Adam), K1-K3 ``num_layers / 2 * PP_MICRO`` launches a step
   a rank; step ms and the bubble gauge; (c) ``ShardedStrategy(model=2)``
   on phase 7's LM (the Megatron layout) for ``SHARDED_STEPS`` steps of
   phase 7's step: the loss falls, each within ``FSDP_LOSS_REL`` of
   phase 7's, K1-K3 ``num_layers`` launches a step. NCCL across two or
   more cards stays unverified.
15. search — hyperparameter search fed by the input pipeline, within
   ``PHASE15_BUDGET_S``: (a) ``SEARCH_ROWS`` seeded documents packed into
   rows of ``TRAIN_SEQ + 1`` tokens (``pack_documents``) and written to
   RecordIO by the native writer; ``DataLoader`` (batch ``TRAIN_BATCH``,
   2 workers, queue 4, ``reuse_buffers``) behind ``device_iterator(size=2)``
   onto the card: ``SEARCH_BATCHES`` batches equal to the host stream bit
   for bit, the native reader must read them; the consumer's wait per
   batch, the prefetch depth and the reader's backend are printed. (b)
   ``experiment.grid_search`` over ``SEARCH_LRS`` on phase 7's LM (each
   trial fed by its own loader over (a)'s file, ``SEARCH_WARMUP`` +
   ``SEARCH_STEPS`` steps, under ``torch.use_deterministic_algorithms``):
   finite losses, K1-K3 ``num_layers`` launches a step in each trial (the
   counts' deltas over the trial), the first trial's losses equal a
   direct run of the same wrapper outside the driver bit for bit (or, where
   an op has no deterministic implementation, within twice a second
   direct run's distance), ``result.json``, each ``trial.json`` without an
   error and the registry's FINISHED record, ``best_config`` the trial of
   the lowest final loss; per trial the step ms, tokens/s, loader wait and
   allocated bytes at its start and after it returned (no growth beyond
   ``TRIAL_WORKSPACE_BYTES``), and the driver's overhead (search wall
   minus the trials' walls). (c) ``experiment.lagom`` with an explicit
   ``GridSearch`` over ``LAGOM_LRS`` at phase 7's widths on 2 layers,
   direction min, ``es_min=2``, heartbeats every step over the driver's
   RPC server (counted): the lr-1.0 trial must be stopped early at a step
   boundary before its last step.
16. feature store — the taxi pipeline end to end, within
   ``PHASE16_BUDGET_S``: (a) ``FS_TRIPS`` seeded trips into the feature
   group ``taxi_trips`` (expectation ``fare_positive``, validation ALL,
   statistics), a second commit of ``FS_UPDATES`` updated trips, the
   frame ``as_of`` the first commit equal to the first save, and the
   training dataset ``taxi_tips`` (Parquet, splits 0.8/0.2); (b)
   WideAndDeep at the taxi vocabularies (embed 8, hidden (128, 64), bf16)
   trained through ``experiment.launch`` for ``FS_EPOCHS`` epochs of the
   train split, fed by ``td.tf_data(..., feature_names=FS_ORDER).loader``
   and ``device_iterator`` (the first batch must be the split's rows in
   ``FS_ORDER``): the loss falls, test accuracy beats the majority
   class's share, and the weights become a ``PYTHON`` model directory;
   (c) the test split through a pubsub topic and the ``Materializer`` into
   a native ``ShardedOnlineStore`` of ``FS_SHARDS`` shards (every shard
   native, ``FS_READBACK`` trip IDs equal the offline rows); (d) a
   batching endpoint with ``feature_config`` driven by ``FS_CLIENTS``
   threads over HTTP with trip IDs only (argmax and distance from fp32
   against the predictor's direct forward on the offline vectors, as
   phase 11 (b); fewer batches than requests), then an unbatched one
   whose ``FS_UNBATCHED_IDS``-ID request equals the direct forward bit for
   bit. It launches no hand-written kernel.
17. fleet — the serving fleet, placement and the closed loop, within
   ``PHASE17_BUDGET_S`` (router with hedging and brownout off,
   ``FLEET_OPTIONS``; the autoscaler heals below 2 replicas): (a) phase
   4's artifact behind ``fleet.start_fleet`` with 2 process replicas
   (``python -m hops_tpu_torch.modelrepo.serving_host --fleet-worker``,
   read from ``/proc/<pid>/cmdline``; process workers start side by side,
   later ones warm from the manager's or agent's spare, counted in the
   output): phase 4's 8 requests concurrently
   through the router (streams equal phase 4's under the near-tie rule,
   client p50/p99 beside phase 11's direct endpoint), then a rollout to
   v2 (the same weights) under 2 clients with a ready replica SIGKILLed
   2 s in: completed, zero client errors, healed to 2, no worker alive
   after the fleet stops; (b) two ``Hostd`` agents with process units, a
   ``PlacementClient`` and the fleet with ``placement=``: 4 requests equal
   (a)'s streams, then one host killed (``chaos_kill``: its units with
   it) and partitioned under 2 clients, re-placed on the survivor with
   zero client errors, ``invariants.audit`` clean, no unit alive after;
   (c) ``LOOP_ROWS`` rows of ``TRAIN_SEQ + 1`` counting tokens published
   by a producer thread onto a pubsub topic, trained by
   ``pipeline.run_continuous`` (``StreamingSource`` -> ``SpanStream``,
   ``LOOP_SPAN`` rows a span, one ``pubsub.poll`` fault armed) at phase
   7's widths on 2 layers (``LOOP_LM``), gates every ``LOOP_EVAL_EVERY``
   steps on a held-out loss (``mode="min"``, gate 2 poisoned), passing
   candidates exported by ``registry.save_lm`` and rolled into an
   in-process fleet of 2 replicas under ``LOOP_CLIENTS`` clients, one
   replica killed in the first rollout: ledger of ``LOOP_ROWS`` records,
   contiguous and disjoint, a recovery, one failed gate, a completed
   cutover, zero client errors, served versions among v1 and the passed
   gates', every export's weights equal to its gate's bit for bit, and
   the fleet's streams after the last cutover equal to a direct engine on
   the last export.
18. jobs — the reference's Airflow shape (``airflow/launch_jobs.py:79-130``)
   through the port's job API and ``hops`` compat shims, within
   ``PHASE18_BUDGET_S``, holding the relay lock (at a path under its own
   workspace, ``HOPS_TPU_RELAY_LOCK``) throughout: (a) ``compat.tls``
   material in the phase's workspace (a real CA and client certificate
   where ``openssl`` exists) and ``compat.kafka.get_security_protocol``;
   (b) a DAG ``train >> sensor >> gate >> serve``: ``train`` a
   ``JobLaunchOperator`` whose job runs this script as its app
   (``chip_smoke.py --jobs-worker <spec>``, a child process on the card
   inheriting ``CUBLAS_WORKSPACE_CONFIG``) and trains phase 7's LM from
   phase 4's weights on phase 7's batch and seed ``JOBS_TRAIN_STEPS``
   steps through ``compat.experiment.launch`` (losses equal to phase
   7's bit for bit, K1-K3 ``num_layers`` launches a step, counted in the
   child), the trained weights registered through ``compat.model``;
   ``sensor`` a ``JobSuccessSensor``; ``gate`` a
   ``FeatureValidationResult`` on a feature group of the batch's token
   extremes; ``serve`` a ``PythonOperator`` that serves the artifact
   through ``compat.serving`` for phase 4's first ``JOBS_REQUESTS``
   requests, greedy (streams equal to a direct ``LMEnginePredictor`` on
   the artifact under the near-tie rule; K1 and K4 launch); then a second
   DAG whose gate reads the batch with its ids offset past the
   vocabulary: the gate FAILED, its two
   downstream tasks SKIPPED; (c) a failing job ends FAILED with its exit
   code (twice, ``get_executions`` newest first), a running job stopped
   by ``stop_job`` ends KILLED within ``JOBS_STOP_S``; (d) the served and
   direct answers through a pubsub topic into a ``StreamingRunner``'s
   parquet sink, stopped and restarted from its checkpoint: each record
   exactly once; (e) ``plotting.plot_metrics`` renders the train job's
   logged losses into its run directory.
19. examples — the example suite (``examples_torch/``, the notebook
   twins) on the card, within ``PHASE19_BUDGET_S``, holding the relay
   lock at a path under its own workspace: every example's ``main`` in
   this process (the feature-store tour also as a job with
   ``--td-version 2``, ``pi`` as a staged job), each held to the
   assertions of ``tests/test_docs_and_examples.py``; what the machine
   lacks (``importlib.util.find_spec``: matplotlib for
   ``plotting_tour``, sklearn for ``golden_parity``, ``torch_mnist`` and
   ``iris_sklearn``) is named on a line of its own and those examples
   left out. ``decode_bench`` runs at its own defaults on K1, K4 and K5
   in four modes (bf16, ``--kv-dtype int8``, ``--continuous --horizon
   8``, ``--valid-sweep`` at ``d_model`` 1024 and capacity 16384): its
   ms per token step, the sweep's times against ``valid_len`` and its
   roofline tables, each on a line beside the card's name and power
   limit. K1-K5 must each launch in the phase; the counts go under
   ``launches_by_path``, ``examples``.

The rounding bound of a bf16 tensor-core body (K1's, K4's and K5's wide
o, K2's dq, K3's dk and dv, K6's and K7's chunk o) is per element ``2**-8 * (mag + |plain|) + slack``: each operand
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
int8 keys (the forward body, ``decode_attention_q8_chunk``). After phase
10, K4's wide calls (``decode_attention_chunk``, the forward body over
the bf16 cache) at a dense prefix's suffix append, beside their
launches in phase 10, and at a GQA speculative verify (2 kv heads, 5
tokens, 20 rows; its own line, and under ``gqa_verify`` in the record);
the records of K1 and K4-K7 add phase 10's launches, and those of K1,
K4 and K4's wide calls phase 11's (under ``launches_by_path``, ``http``), and
those of K1-K4 phase 12's (``distribute``), and every record phase
13's Ulysses steps (``sp``) and MoE training and serving (``moe``) and
phase 14's rank-0 launches: tensor-parallel serving and training
(``tp``) and pipeline training (``pp``), and those of K1-K3 phase 15's
search trials (``search``), and those of K1-K4 phase 17's trainer and
in-process fleet (``fleet``; process replicas count in their own
processes), and those of K1-K4 phase 18's train job child and serve task
(``jobs``), and every record phase 19's (``examples``). The
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
import statistics
import sys
import threading
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
# (flash_fwd_tc.cuh, bf16 K/V), K2, K3, and the forward body over bf16 K/V
# in K4's source and over int8 K/V in K5's (their wide calls).
TC_BODIES = {"flash_fwd": ("3fwd10fwd_kernelILi{d}ELb0E", "forward body, bf16 K/V"),
             "flash_bwd_dq": ("2tc9dq_kernelILi{d}E", "tensor-core body"),
             "flash_bwd_dkv": ("2tc10dkv_kernelILi{d}E", "tensor-core body"),
             "decode_attention": ("3fwd10fwd_kernelILi{d}ELb0E",
                                  "forward body, bf16 K/V (wide calls)"),
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
# K1's and K4's wide calls') and the 64-row body (wider fp32 calls), as
# the profiler names them.
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
    (64, 2048, 8, 4, [4, 130, 1303, 2047, 2048], None),  # a verify call of spec_k 4, ragged
)
# Phase 3, K4's split-K body (128-key splits) on the dense cache:
# (capacity, kv heads of 8 query heads, query tokens, valid_len per row,
# window).
DENSE_SPLIT_CASES = (
    (2048, 8, 1, [127, 128, 129, 2048, 0], None),  # L - 1, L, L + 1, full, empty
    (2048, 2, 1, [1000, 700, 513, 2048, 1], 100),  # leading splits empty; GQA rows 4
    (2000, 8, 5, [5, 258, 1531, 2000, 1999], None),  # rows 5; cap not a multiple of L
    (2048, 8, 8, [3, 255, 257, 0, 1025], 300),  # rows 8, valid_len 3 < s
    (2048, 8, 4, [4, 130, 1303, 2047, 2048], None),  # a verify call of spec_k 4, ragged
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

# Phase 10: the engine's levers on phase 4's artifact. The draft is the
# target cut to its first DRAFT_LAYERS blocks (embedding, blocks, final
# norm and head shared); PREFIX_LEN prefix tokens are 4 full pages of 64
# and 44 more, so a prefix hit recomputes from an incomplete page.
SPEC_K, DRAFT_LAYERS, HORIZON, PREFIX_LEN = 4, 2, 8, 300
# At random weights the 2-layer draft's proposals are almost never the
# target's; a draft of the first 11 blocks accepts some and rejects
# others, so (a) also runs rows that rewind by different counts.
NEAR_DRAFT_LAYERS = 11
PAGED_CFG = CACHE_SLICES[1][1]  # phase 8 (b)'s paged engine
PERFECT_ACCEPTANCE = 0.9
# A stream may leave phase 4's only at a near tie: the two tokens' logits
# (plain attention over the common prefix) within this share of the
# largest logit, about the bf16 model's own distance from fp32.
NEAR_TIE_REL = 3e-2  # about 4 bf16 units in the last place of the largest logit
PRIORITY_SLOTS, PRIORITY_BATCH, PRIORITY_INTERACTIVE, PRIORITY_NEW = 2, 6, 2, 8
SPEC_NEW, BEAM, BEAM_NEW, BEAM_PROMPT, BEAM_REL = 48, 4, 32, 16, 1e-2
# Phase 11: the serving host. CLASSIFIER_REQUESTS one-image requests
# against a batcher capped at CLASSIFIER_BATCH rows and an endpoint
# admitting as many at once; the served logits' distance from the fp32
# forward within CLASSIFIER_REL times the bf16 forward's own (as phase 4
# holds the LM's logits). The standalone host serves phase 4's model cut
# to STANDALONE_LAYERS blocks.
CLASSIFIER_REQUESTS = CLASSIFIER_BATCH = 16
CLASSIFIER_REL = 1.5
STANDALONE_LAYERS = 2
SERVING_KERNELS = ("flash_fwd", "decode_attention", "decode_attention_chunk")
# Phase 12: the FSDP2 steps against the DDP steps (bf16 compute; the two
# gather and reduce their weights and gradients through other buffers,
# so a cuBLAS product may round differently), per step, relative.
FSDP_LOSS_REL = 1e-3
TRACED_STEPS = 2
BATCH_IMAGES, BATCH_PER_CHIP = 100, 32  # a ragged tail of 4 rows
TAXI_VOCAB = [24, 7, 100]  # examples/taxi_pipeline.py
TAXI_BATCH, TAXI_STEPS, TAXI_ROWS, TAXI_LR = 1024, 50, 10_000, 1e-2
PHASE12_BUDGET_S = 60.0
# Phase 13: scale-out. (a) ResNet-50 (phase 9's model) through
# experiment.collective_all_reduce for SCALEOUT_STEPS steps in each
# grad-comms mode; at one rank each must equal "none" (DDP) bit for bit.
SCALEOUT_MODES = ("none", "allreduce", "quantized", "quantized+overlap", "zero1", "zero2",
                  "zero3", "hier")
SCALEOUT_STEPS = 4
# (c) Ulysses on phase 7's step, SP_STEPS steps, equal to flash's bit for
# bit; ring at RING_BATCH rows (its fp32 scores hold (RING_BATCH, 8, 2048,
# 2048) per layer), within RING_REL times the bf16 flash path's distance
# from the fp32 plain path over RING_STEPS steps.
SP_STEPS, RING_BATCH, RING_STEPS, RING_REL = 3, 2, 2, 1.5
# (d) the JAX defaults' MoE LM at phase 7's widths: every second block of
# 8 experts, top 2, capacity factor 1.25, hidden 4096 (0.40 B expert
# parameters); MOE_STEPS training steps at phase 7's batch, then phase 4's
# requests served on the bf16 and int8 caches, then the plain-attention
# engine (the same call shapes) in bf16 and in fp32, teacher-forced to
# the served tokens and routing. A served token may differ from the
# plain bf16 run's argmax only at a logit near tie (NEAR_TIE_REL); where
# that run's own router would pick other experts, the k-th and (k+1)-th
# probabilities lie within ROUTER_MARGIN (bf16 rounding of the router's
# input moves a probability by about 1e-3 of itself; 5e-3 absolute is
# ~4% of a top-2 probability of 8).
MOE_TRAIN = dict(TRAIN, moe_every=2, num_experts=8, moe_top_k=2)
MOE_SERVE = dict(MODEL, moe_every=2, num_experts=8, moe_top_k=2)
MOE_STEPS = 6
# The MoE serving check serves phase 4's first MOE_REQUESTS requests (one
# admission wave of the 4 slots; the full 8 took 45 s of phase 13's 106).
MOE_REQUESTS = 4
ROUTER_MARGIN = 5e-3
# Each drawn token is compared on the served history (teacher forcing):
# its logits' distance from the plain fp32 engine's within MOE_TOKEN_REL
# times the plain bf16 engine's own, and the median token's ratio within
# MOE_MEDIAN_REL. The served and the plain bf16 runs round alike, so the
# ratio's median is about 1 (0.987 on the bf16 cache, seed 0, 384
# tokens; its largest 1.446).
MOE_TOKEN_REL, MOE_MEDIAN_REL = 2.0, 1.25
PHASE13_BUDGET_S = 180.0
# The kernels phase 10 must launch, by launch-count name.
LEVER_KERNELS = ("flash_fwd", "decode_attention", "decode_attention_chunk", "decode_attention_q8",
                 "decode_attention_q8_chunk", "paged_decode_attention",
                 "paged_decode_attention_chunk", "paged_decode_attention_q8",
                 "paged_decode_attention_q8_chunk")


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


# Phase 3 bounds. bf16 inputs: the split body of K4-K7, which computes
# in fp32, per element to its output's rounding (output_rounding_close);
# the bf16 tensor-core bodies (K1, K2, K3, the wide calls of K4-K7) round
# operands too, and are held per element to the bound that rounding
# allows (rounding_close). fp32 inputs at the same shapes: an absolute
# 1e-4, tight enough that one dropped key tile of a long row fails. lse:
# an absolute 1e-4 for both.
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
    the device idle between launches and inflate the time. ``fn`` must
    not synchronize: a host integer ``valid_len`` would (its copy to the
    card waits for the stream), so the timed calls pass device tensors."""
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
    bf16 K/V (K1, and K4's wide calls in K4's source) and over int8 K/V
    (K5's wide calls, 64-key tiles), K2, K3,
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
        wide = name.startswith("decode_attention")  # K4's and K5's wide calls
        smem = getattr(ctypes.CDLL(r["path"]),
                       _build.KERNELS[name][1] + ("_chunk_smem_bytes" if wide else "_smem_bytes"))
        smem.argtypes, smem.restype = [ctypes.c_int] * (1 if wide else 2), ctypes.c_int
        sass = hgmma_counts(cuobjdump, r["path"])
        for d in (64, 128):
            fn = next(n for n in entries if pattern.format(d=d) in n)
            e = entries[fn]
            label = f"bf16 {what} d{d}"
            report_tc_body(name, fn, e, smem(d) if wide else smem(d, 1), sass, label)
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
    worst = {k: {"bfloat16": 0.0, "float32": 0.0}
             for k in ("flash_fwd", "decode_attention", "decode_attention_chunk")}
    bad = []

    cases = [(s, s, c, None) for s in (16, 128, 1000, 2048) for c in (True, False)]
    cases += [(2048, 2048, True, 256), (64, 1024, True, None)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).rsplit(".", 1)[-1]
        atol = FP32_ATOL  # the fp32 rows' bound; bf16 rows are held to their rounding

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
                    err, tol, ok = close(o, ref, atol)
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
                        f = [t.float() for t in (q, kc, vc)]
                        ref = A.decode_attention_reference(*f, vl, window=window)
                        split = (8 // hkv) * s <= A.SPLIT_ROWS
                        if dtype == torch.bfloat16 and split:
                            err, ratio, ok = output_rounding_close(o, ref)  # the split body
                            bound_note = f"split body, worst err/rounding bound {ratio:.3f}"
                        elif dtype == torch.bfloat16:  # K1's forward body rounds p for p·v
                            mag = A.decode_attention_reference(*f[:2], f[2].abs(), vl,
                                                               window=window)
                            err, ratio, ok = rounding_close(o, ref, mag, FP32_ATOL)
                            bound_note = f"forward body, worst err/rounding bound {ratio:.3f}"
                        else:
                            err, tol, ok = close(o, ref, atol)
                            bound_note = f"bound {tol:.3e}"
                        # Wider bf16 calls run the forward body, counted apart.
                        key = ("decode_attention_chunk"
                               if dtype == torch.bfloat16 and not split else "decode_attention")
                        worst[key][dname] = max(worst[key][dname], err)
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
            if dtype == torch.bfloat16:
                bad += check_dense_wide_body(A, torch, gen, dev, d, worst)
    if bad:
        raise AssertionError("kernel disagrees with its plain version: " + "; ".join(bad))
    return worst


def check_dense_wide_body(A, torch, gen, dev, d: int, worst) -> list[str]:
    """Phase 3 for K4's wide bf16 calls at head dim ``d`` (K1's forward
    body over the dense bf16 cache): the ``WIDE_CASES`` with
    ``wide_lengths`` valid lengths at windows none and 256, per element
    within ``2**-8 * (p|v| + |plain|) + 1e-4``; rows with valid_len 0 and
    rows before position 0 exactly 0; one launch each under
    ``decode_attention_chunk``; then NaN and +-1e30 in K and V at or past
    every row's valid_len and every output bit-identical. Returns the
    cases that missed."""
    from hops_tpu_torch.ops.kernel_checks import WIDE_CASES, dense_poisoned, wide_lengths

    bad = []
    name = "decode_attention_chunk"
    err_max = ratio_max = 0.0
    for case, (hkv, s, cap) in WIDE_CASES.items():
        valid, _ = wide_lengths(s, 64, cap)
        vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        q = torch.randn(len(valid), 8, s, d, generator=gen).to(dev, torch.bfloat16)
        k, v = (torch.randn(len(valid), hkv, cap, d, generator=gen).to(dev, torch.bfloat16)
                for _ in range(2))
        f = [t.float() for t in (q, k, v)]
        dirty_kv = dense_poisoned(k, v, vl)
        for window in (None, 256):
            before = A.launch_counts()
            o = A.decode_attention(q, k, v, vl, window=window)
            torch.cuda.synchronize()
            after = A.launch_counts()
            ref = A.decode_attention_reference(*f, vl, window=window)
            mag = A.decode_attention_reference(*f[:2], f[2].abs(), vl, window=window)
            err, ratio, ok = rounding_close(o, ref, mag, FP32_ATOL)
            err_max, ratio_max = max(err_max, err), max(ratio_max, ratio)
            ok = ok and not o[0].any() and not o[1, :, :s - valid[1]].any()
            ok = ok and after[name] == before[name] + 1
            ok = ok and sum(after.values()) == sum(before.values()) + 1
            if not ok:
                bad.append(f"{name} d{d} {case} window={window}: err/rounding bound {ratio:.3f}")
            if not torch.equal(A.decode_attention(q, *dirty_kv, vl, window=window), o):
                bad.append(f"{name} d{d} {case} window={window}: a slot at or past valid_len "
                           "reached an output")
    worst[name]["bfloat16"] = max(worst[name]["bfloat16"], err_max)
    print(f"  bfloat16 d{d}: {name} (K4 wide, forward body) over {len(WIDE_CASES)} shapes "
          f"({', '.join(WIDE_CASES)}) x windows none/256: worst err {err_max:.3e}, worst "
          f"err/rounding bound {ratio_max:.3f}; NaN/+-1e30 past valid_len change no bit",
          flush=True)
    return bad


def check_narrow_heads(A, torch, gen, dev, part: str, worst) -> None:
    """Phases 3b (``part`` "flash": K1, K2, K3) and 3c (``part``
    "cache": K4-K7) at the head dims below the kernels' 64 that the
    examples use (``kernel_checks.NARROW_HEAD_DIMS``, zero-padded at the
    entry points), bf16 and fp32 queries: each call one launch of its own
    kernel, within its body's bound (``kernel_checks.held``), and the
    cache kernels on caches padded once at allocation bit-identical to
    caches padded per call. Folds the errors into ``worst``; raises on a
    miss."""
    from hops_tpu_torch.ops.kernel_checks import NARROW_HEAD_DIMS, held, narrow_head_checks

    bad = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).rsplit(".", 1)[-1]
        for d in NARROW_HEAD_DIMS:
            errs, ratio_max, n = {}, 0.0, 0
            for case, counter, launched, out, ref, mag, slack in narrow_head_checks(
                    d, dtype, gen, dev, part):
                torch.cuda.synchronize()
                err, ratio, ok = held(out, ref, mag, slack)
                n += 1
                if slack:  # not a bit-identity check
                    errs[counter] = max(errs.get(counter, 0.0), err)
                    ratio_max = max(ratio_max, ratio)
                    if counter in worst:
                        worst[counter][dname] = max(worst[counter][dname], err)
                if not (ok and launched and out.shape == ref.shape):
                    bad.append(f"{dname} {case}: err {err:.3e}, err/bound {ratio:.3f}, "
                               f"launched {launched}")
            print(f"  {dname} d{d} ({part}, zero-padded to {A.kernel_head_dim(d)}): {n} checks; "
                  "worst err " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                  + f"; worst err/bound {ratio_max:.3f}; padded caches bit-identical",
                  flush=True)
    if bad:
        raise AssertionError("kernel at a narrow head dim disagrees with its plain version: "
                             + "; ".join(bad))


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
        atol = FP32_ATOL  # the fp32 rows' bound; bf16 rows are held to their rounding
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
                        err, tol, ok = close(o, ref, atol)
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
                            f"bound {atol:.0e}")
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
    instance while the block runs. Decode steps draw from ``(slots, 1,
    vocab)``; a paged engine's fused prompt-chunk calls from ``(slots,
    vocab)``, and the dense engine's admission waves from ``(wave,
    vocab)``."""
    model = engine.model
    real = model.logits
    paged = engine.stats()["cache_layout"] == "paged"

    def tap(hidden):
        out = real(hidden)
        if out.dim() == 3:  # a decode step over every slot
            for r, st in enumerate(engine._slot_state):
                if st is not None:
                    taps[(st.ticket, len(st.emitted))] = out[r, -1]
        elif paged:  # a fused prompt-chunk call's (slots, vocab) draw
            for r, st in enumerate(engine._slot_state):
                if st is None or (st.pending is not None and st.pending.size > engine.prefill_chunk):
                    continue  # a free row, or a prompt chunk before the last
                taps[(st.ticket, 0 if st.pending is not None else len(st.emitted))] = out[r]
        else:  # an admission wave, in _admitting's order
            for i, req in enumerate(engine._admitting):
                taps[(req.ticket, 0)] = out[i]
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
    return (sum(t.nbytes for t in [*cache.tensors(), cache.idx])
            + (cache.pages.nbytes if hasattr(cache, "pages") else 0))


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
    vl = torch.full((b,), s, dtype=torch.int32, device=dev)
    return {"flash_fwd": cuda_ms(lambda i=0: A.flash_attention(q, k, v, causal=True), 20),
            "decode_attention_q8_chunk": cuda_ms(
                lambda i=0: A.decode_attention_q8(q, k8, v8, ks, vs, vl), 20)}


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
    vlw = torch.full((b,), sw, dtype=torch.int32, device=dev)
    name = "decode_attention_q8_chunk"
    src, line = CACHE_KERNELS[name]
    rows.append(dict(
        name=name, route="cuda", source=f"hops_tpu_torch/ops/csrc/{src}",
        replaces=f"hops_tpu/ops/attention.py:{line}",
        shape=f"q ({b},{h},{sw},{d}) bf16, int8 K/V ({b},{h},{sw},{d}) + fp32 scales, "
              f"valid_len {sw} (causal)",
        launches=launches.get(name, 0), max_abs_err=worst[name]["bfloat16"],
        ms=cuda_ms(lambda i=0: A.decode_attention_q8(qw, wide[i % 2][0], wide[i % 2][2],
                                                     wide[i % 2][1], wide[i % 2][3], vlw), 20),
        plain_ms=cuda_ms(lambda i=0: A.decode_attention_q8_reference(
            qw, wide[i % 2][0], wide[i % 2][2], wide[i % 2][1], wide[i % 2][3], vlw), 3),
        library_ms=cuda_ms(lambda i=0: F.scaled_dot_product_attention(
            qw, *dense_w[i % 2], is_causal=True), 20),
        **bound(4 * d * pairs, nbytes),
    ))
    return rows


def serve_cache_slices(A, torch, art, prompts, instances, dense_answers, dense_bytes,
                       dev, card_line, streams: dict | None = None) -> dict[str, dict[str, int]]:
    """Phase 8: serve phase 4's requests with each of ``CACHE_SLICES``;
    returns each slice's launch counts (and puts its streams into
    ``streams``, which phase 14 holds its tensor-parallel engines to)."""
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
            if streams is not None:
                streams[name] = answers
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


def train_slice(A, torch, np, params, dev, seed: int, card_line: str,
                out: dict | None = None) -> dict:
    """Phase 7: the full-width train step, timed; returns the launch
    counts of the timed steps (and puts the per-step losses and the step
    ms into ``out``, which phase 12 holds its steps to)."""
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
    if out is not None:
        out.update(losses=losses, step_ms=step_ms)
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


def near_ties(model, torch, prompts, got, want, dev, what: str) -> list[str]:
    """For each stream of ``got`` that leaves ``want``: at its first
    differing token j, the gap between the two tokens' logits under a
    full forward of ``model`` with the plain attention over the prompt
    and ``want``'s first j tokens. Raises unless the gap is a near tie
    (``NEAR_TIE_REL * ||logits||inf``)."""
    plain = model.clone(attention_impl="reference")
    notes = []
    for i, (a, d) in enumerate(zip(got, want)):
        if len(a) != len(d):
            raise AssertionError(f"{what}: stream {i} has {len(a)} tokens, not {len(d)}")
        j = next((k for k, (x, y) in enumerate(zip(a, d)) if x != y), None)
        if j is None:
            continue
        seq = torch.tensor(list(prompts[i]) + list(d[:j]), device=dev)[None]
        with torch.inference_mode():
            logits = plain(seq)[0, -1].float()
        gap, scale = (logits[a[j]] - logits[d[j]]).abs().item(), logits.abs().max().item()
        notes.append(f"stream {i} at token {j}: gap {gap:.3e} ({gap / scale:.1e} of "
                     "||logits||inf)")
        if not gap <= NEAR_TIE_REL * scale:
            raise AssertionError(f"{what}: stream {i} leaves the reference at token {j} "
                                 f"without a near tie ({notes[-1]})")
    del plain
    return notes


def same_lead(got, want) -> list[int]:
    """Per stream, how many leading tokens equal the reference's."""
    return [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
            for a, b in zip(got, want)]


def profile_dispatch(engine, torch, prompts, what: str, per_dispatch: int) -> str:
    """One decode dispatch of ``engine`` at 4 busy slots (every prompt
    prefilled, two warm dispatches first) under ``torch.profiler``:
    device busy, idle share, launches, and the split body's share (K4-K7
    decode calls). ``per_dispatch``: the most tokens a dispatch emits per
    row; the budgets cover the prefill steps, three dispatches and the
    profiled one at that rate."""
    for p in prompts[:4]:
        engine.submit(p, max_new_tokens=16 + 4 * per_dispatch)
    while any(st is None or st.pending is not None for st in engine._slot_state):
        engine.step()
    for _ in range(2):
        engine.step()
    busy_slots, before = engine.stats()["slots_busy"], engine.tokens_emitted
    wall_ms, busy, kernels = device_profile(torch, engine.step)
    emitted = engine.tokens_emitted - before
    engine.run()
    if busy_slots != 4:
        raise AssertionError(f"phase 10 {what} profile: {busy_slots} busy slots, not 4")
    split = [(ms, n) for key, ms, n in kernels if any(k in key for k in SPLIT_KERNEL_NAMES)]
    split_ms = sum(ms for ms, _ in split)
    line = (f"wall {wall_ms:.3f} ms (profiled), device busy {busy:.3f} ms, idle share "
            f"{1 - busy / wall_ms:.3f}, {sum(n for _, _, n in kernels)} kernel launches, "
            f"{emitted} tokens; split body and combine {split_ms:.4f} ms ({split_ms / busy:.1%} "
            f"of busy, {sum(n for _, n in split)} launches)")
    print(f"phase 10 {what} profile: one dispatch at 4 busy slots: {line}", flush=True)
    for key, ms, n in kernels[:5]:
        print(f"  {ms:.4f} ms ({ms / busy:.1%} of busy, {n}) {key[:90]}", flush=True)
    if not split or any(ROWS_KERNEL_NAME in key for key, _, _ in kernels):
        raise AssertionError(f"phase 10 {what}: decode dispatches must run the split body")
    return line


def serve(art, cfg, batches, torch):
    """A predictor on ``cfg`` answering each list of ``batches`` in turn;
    returns (answers, stats, ttft, wall, predictor), the predictor
    stopped so that its engine can be driven from this thread."""
    from hops_tpu_torch.modelrepo.serving import LMEnginePredictor

    predictor = LMEnginePredictor(art, cfg)
    answers, ttft = [], []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            answers += predictor.predict(batch)
            ttft += predictor.last_ttft_s
        wall = time.perf_counter() - t0
        stats = predictor.stats()
    finally:
        predictor.stop()
    return answers, stats, ttft, wall, predictor


def describe(stats, ttft, wall) -> str:
    spec = (f"acceptance {stats['spec_acceptance']}, " if "spec_acceptance" in stats else "")
    return (f"{spec}{stats['tokens_per_dispatch']} tokens per dispatch, {stats['dispatches']} "
            f"dispatches, {stats['readbacks']} decode read-backs for {stats['decode_tokens']} "
            f"decode tokens ({stats['readbacks'] / max(stats['decode_tokens'], 1):.3f} per token), "
            f"decode {stats['decode_tokens'] / stats['decode_s']:.1f} tokens/s, ttft_ms "
            f"{[round(t * 1e3, 1) for t in ttft]}, wall {wall:.3f} s")


def levers_phase(A, torch, art, params, prompts, instances, answers, dev,
                 card_line, keep: dict | None = None) -> dict[str, int]:
    """Phase 10; returns its launch counts. ``keep`` receives the prefix
    (``"prefix"``) and the dense bf16 engine's streams on the full
    prompts (``"prefix_want"``), which phase 11 holds its prefix hits to."""
    from hops_tpu_torch.models.generation import beam_search, generate, generate_speculative
    from hops_tpu_torch.modelrepo import registry
    from hops_tpu_torch.modelrepo.lm_engine import LMEngine
    from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, load_lm_artifact
    from hops_tpu_torch.runtime import config

    config.configure(workspace=str(ROOT / "_smoke" / "registry"), project="chip_smoke")
    target = registry.export(art, "smoke-lm", metrics={"layers": MODEL["num_layers"]})

    def layer_skip(layers: int, name: str) -> dict:
        keep = {k: v for k, v in params.items()
                if not re.match(r"block_\d+/", k) or int(k.split("/")[0][6:]) < layers}
        return registry.save_lm(dict(MODEL, num_layers=layers), keep, name,
                                metrics={"layers": layers})

    draft = layer_skip(DRAFT_LAYERS, "smoke-draft")
    layer_skip(NEAR_DRAFT_LAYERS, "smoke-draft-near")
    print(f"phase 10 registry: {target['name']} v{target['version']} ({MODEL['num_layers']} "
          f"layers), {draft['name']} v{draft['version']} (the target's first {DRAFT_LAYERS} "
          f"blocks, embedding, final norm and head); best by layers: "
          f"{registry.get_best_model('smoke-lm', 'layers')['version']}", flush=True)
    spec = {"draft_model": "smoke-draft", "spec_k": SPEC_K}
    torch.cuda.synchronize()
    A.reset_launch_counts()
    t_phase = time.perf_counter()

    def delta(before):
        after = A.launch_counts()
        return {k: after[k] - before[k] for k in after if after[k] != before[k]}

    # (a) dense speculation.
    got, stats, ttft, wall, pred = serve(art, dict(slots=4, **spec), [instances], torch)
    notes = near_ties(pred.engine.model, torch, prompts, got, answers, dev, "phase 10 (a)")
    print(f"phase 10 (a) dense speculation, draft smoke-draft, spec_k {SPEC_K}: "
          f"{describe(stats, ttft, wall)}; streams equal phase 4's: leading tokens "
          f"{same_lead(got, answers)}; " + ("; ".join(notes) or "all identical")
          + f"; card {card_line}", flush=True)
    profile_dispatch(pred.engine, torch, prompts, "(a) speculative", SPEC_K)
    del pred
    target_model = load_lm_artifact(art, dev)
    for name, what in (("smoke-lm", "the target as its own draft"),
                       ("smoke-draft-near", f"the first {NEAR_DRAFT_LAYERS} blocks as the draft")):
        got, stats, ttft, wall, pred = serve(
            art, dict(slots=4, draft_model=name, spec_k=SPEC_K), [instances[:4]], torch)
        del pred
        notes = near_ties(target_model, torch, prompts, got, answers[:4], dev, "phase 10 (a)")
        print(f"phase 10 (a) {what} (4 requests): {describe(stats, ttft, wall)}; "
              + ("; ".join(notes) or "streams identical to phase 4's"), flush=True)
        if name == "smoke-lm" and not stats["spec_acceptance"] >= PERFECT_ACCEPTANCE:
            raise AssertionError(f"phase 10 (a): the target as its own draft accepted "
                                 f"{stats['spec_acceptance']}")
    del target_model
    torch.cuda.empty_cache()

    # (b) decode horizons: 4 requests fill the 4 slots in one wave, so
    # horizon 1 and HORIZON see the same admissions.
    batches = [instances[:4]]
    for name, cfg in (("dense", {"slots": 4}), ("paged", PAGED_CFG)):
        one, stats1, ttft1, wall1, pred1 = serve(art, cfg, batches, torch)
        del pred1
        many, stats8, ttft8, wall8, pred8 = serve(art, dict(cfg, decode_horizon=HORIZON),
                                                  batches, torch)
        if many != one:
            raise AssertionError(f"phase 10 (b) {name}: horizon {HORIZON} streams differ from "
                                 f"horizon 1's: leading tokens {same_lead(many, one)}")
        print(f"phase 10 (b) {name}: horizon {HORIZON} streams bit-identical to horizon 1's; "
              f"horizon 1: {describe(stats1, ttft1, wall1)}; horizon {HORIZON}: "
              f"{describe(stats8, ttft8, wall8)}; card {card_line}", flush=True)
        profile_dispatch(pred8.engine, torch, prompts, f"(b) {name} horizon {HORIZON}", HORIZON)
        del pred8
        torch.cuda.empty_cache()

    # (c) prefixes, dense and paged (with the draft), bf16 and int8,
    # against the dense engine of the same cache dtype on the full
    # prompts. The dense prefix runs without the draft (the CPU tests
    # hold the two together): its suffix appends are K4's wide calls.
    rng = torch.Generator().manual_seed(len(prompts))
    prefix = torch.randint(0, MODEL["vocab_size"], (PREFIX_LEN,), generator=rng).tolist()
    full = [prefix + p for p in prompts]
    full_instances = [dict(i, prompt=f) for i, f in zip(instances, full)]
    sfx_instances = [dict(i, prefix_id="system") for i in instances]
    for dtype in ("bfloat16", "int8"):
        cache = {} if dtype == "bfloat16" else {"kv_cache_dtype": "int8"}
        want, stats, ttft, wall, pred = serve(art, dict(slots=4, **cache), [full_instances],
                                              torch)
        del pred
        if keep is not None and dtype == "bfloat16":
            keep.update(prefix=prefix, prefix_want=want)
        print(f"phase 10 (c) dense {dtype}, full prompts ({PREFIX_LEN} + prompt), no draft: "
              f"{describe(stats, ttft, wall)}", flush=True)
        for layout, base in (("dense", {"slots": 4}), ("paged", dict(PAGED_CFG, **spec))):
            cfg = dict(base, **cache, prefixes={"system": prefix})
            before = A.launch_counts()
            # The first request prefills the prefix (paged: and publishes
            # its complete pages); the other 7 hit it.
            got, stats, ttft, wall, pred = serve(art, cfg, [sfx_instances[:1]], torch)
            engine = pred.engine
            tickets = [engine.submit(**LMEnginePredictor._parse(i)) for i in sfx_instances[1:]]
            peak_ref = 0
            t0 = time.perf_counter()
            while engine.has_work:
                engine.step()
                entry = engine._prefixes["system"]
                if layout == "paged" and entry.blocks:
                    peak_ref = max(peak_ref, max(engine._pool.refcount(b) for b in entry.blocks))
            wall += time.perf_counter() - t0
            ttft += [engine.ttft_s.get(t) for t in tickets]
            got += [engine.take_result(t) for t in tickets]
            stats = engine.stats()
            launched = delta(before)
            notes = near_ties(engine.model, torch, full, got, want, dev, f"phase 10 (c) {layout}")
            hit_ttft = statistics.median(ttft[1:]) * 1e3  # the 7 requests after the first
            print(f"phase 10 (c) {layout} {dtype} + prefix {PREFIX_LEN}"
                  + (" + draft" if layout == "paged" else "") + ": prefix hits "
                  f"{stats['prefix_hits']} of {len(instances)}, TTFT p50 of the later 7 "
                  f"{hit_ttft:.1f} ms"
                  + (f", peak refcount of a shared block {peak_ref}" if layout == "paged" else "")
                  + f"; {describe(stats, ttft, wall)}; streams equal the dense {dtype} engine's "
                  f"on the full prompts: leading tokens {same_lead(got, want)}; "
                  + ("; ".join(notes) or "all identical") + f"; launches {launched}", flush=True)
            if stats["prefix_hits"] < len(instances) - 1:
                raise AssertionError(f"phase 10 (c) {layout} {dtype}: {stats['prefix_hits']} "
                                     "prefix hits")
            if layout == "paged" and peak_ref < 2:
                raise AssertionError(f"phase 10 (c) paged {dtype}: no shared block reached "
                                     "refcount 2")
            kernel = {("dense", "bfloat16"): ("decode_attention", "decode_attention_chunk"),
                      ("dense", "int8"): ("decode_attention_q8", "decode_attention_q8_chunk"),
                      ("paged", "bfloat16"): ("paged_decode_attention",
                                              "paged_decode_attention_chunk"),
                      ("paged", "int8"): ("paged_decode_attention_q8",
                                          "paged_decode_attention_q8_chunk")}[layout, dtype]
            if not all(launched.get(k) for k in kernel):
                raise AssertionError(f"phase 10 (c) {layout} {dtype}: {kernel} must launch: "
                                     f"{launched}")
            del pred, engine
            torch.cuda.empty_cache()

    # (d) priority admission on 2 slots: 6 batch requests, then 2
    # interactive ones.
    model = load_lm_artifact(art, dev, ragged_decode=True)
    engine = LMEngine(model, slots=PRIORITY_SLOTS)
    short = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[:4]
    kinds = ["batch"] * PRIORITY_BATCH + ["interactive"] * PRIORITY_INTERACTIVE
    tickets = {engine.submit(prompts[short[i % 4]], max_new_tokens=PRIORITY_NEW,
                             priority=kind): kind for i, kind in enumerate(kinds)}
    order = []
    while engine.has_work:
        engine.step()
        for st in engine._slot_state:
            if st is not None and st.ticket not in order:
                order.append(st.ticket)
    results = engine.run()
    print(f"phase 10 (d) priority: {PRIORITY_BATCH} batch then {PRIORITY_INTERACTIVE} interactive "
          f"requests on {PRIORITY_SLOTS} slots, admission order "
          f"{[f'{t}:{tickets[t]}' for t in order]}", flush=True)
    if set(order[:PRIORITY_INTERACTIVE]) != {t for t, k in tickets.items() if k == "interactive"}:
        raise AssertionError("phase 10 (d): the interactive requests were not admitted first")
    if sorted(order) != sorted(tickets) or any(len(results[t]) != PRIORITY_NEW for t in tickets):
        raise AssertionError("phase 10 (d): a batch request did not complete")
    del engine

    # (e) run_offline.
    engine = LMEngine(model, slots=4)
    tickets = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, NEW_TOKENS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run_offline()
    wall = time.perf_counter() - t0
    got = [results[t] for t in tickets]
    notes = near_ties(model, torch, prompts, got, answers, dev, "phase 10 (e)")
    print(f"phase 10 (e) run_offline: {engine.dispatches} dispatches ({engine.admission_waves} "
          f"waves, {engine.readbacks} read-backs), {engine.tokens_emitted} tokens in {wall:.3f} s "
          f"({engine.tokens_emitted / wall:.1f} tokens/s, prefill included); leading tokens "
          f"equal phase 4's {same_lead(got, answers)}; " + ("; ".join(notes) or "all identical")
          + f"; card {card_line}", flush=True)
    del engine, model
    torch.cuda.empty_cache()

    # (f) generate_speculative and beam_search.
    plain = load_lm_artifact(art, dev)
    small = load_lm_artifact(registry.lm_artifact("smoke-draft"), dev)
    pp = [p[:BEAM_PROMPT] for p in prompts[:2]]
    batch = torch.tensor(pp, device=dev)
    greedy = generate(plain, batch, max_new_tokens=SPEC_NEW, temperature=0.0)
    t0 = time.perf_counter()
    fast = generate_speculative(plain, small, batch, max_new_tokens=SPEC_NEW, k=SPEC_K)
    wall = time.perf_counter() - t0
    g_list = greedy[:, BEAM_PROMPT:].tolist()
    notes = near_ties(plain, torch, pp, fast[:, BEAM_PROMPT:].tolist(), g_list, dev,
                      "phase 10 (f) generate_speculative")
    print(f"phase 10 (f) generate_speculative (batch 2, k {SPEC_K}, {SPEC_NEW} new tokens, "
          f"{wall:.3f} s): leading tokens equal greedy generate's "
          f"{same_lead(fast[:, BEAM_PROMPT:].tolist(), g_list)}; "
          + ("; ".join(notes) or "identical"), flush=True)
    one, _ = beam_search(plain, batch, max_new_tokens=BEAM_NEW, beam_size=1)
    if not torch.equal(one, greedy[:, : BEAM_PROMPT + BEAM_NEW]):
        raise AssertionError("phase 10 (f): beam_search with beam 1 differs from greedy generate")
    t0 = time.perf_counter()
    beams, scores = beam_search(plain, batch, max_new_tokens=BEAM_NEW, beam_size=BEAM)
    wall = time.perf_counter() - t0
    fp32 = plain.clone(dtype="float32", attention_impl="reference")
    with torch.inference_mode():
        logp = torch.log_softmax(fp32(beams)[:, BEAM_PROMPT - 1: -1].float(), dim=-1)
    ref = torch.gather(logp, 2, beams[:, BEAM_PROMPT:, None])[..., 0].sum(-1)
    err = (scores - ref).abs()
    print(f"phase 10 (f) beam_search (beam {BEAM}, 2 prompts, {BEAM_NEW} new tokens, {wall:.3f} "
          f"s): beam 1 equals greedy; scores {[round(x, 4) for x in scores.tolist()]}, fp32 plain "
          f"log-probabilities {[round(x, 4) for x in ref.tolist()]}, |diff| "
          f"{[round(x, 4) for x in err.tolist()]} (bound {BEAM_REL} * |score|)", flush=True)
    if not bool((err <= BEAM_REL * scores.abs()).all()):
        raise AssertionError("phase 10 (f): a beam's score is not its log-probability")
    del plain, small, fp32
    torch.cuda.empty_cache()
    launches = A.launch_counts()
    missing = [k for k in LEVER_KERNELS if not launches[k]]
    print(f"phase 10 launches: { {k: launches[k] for k in LEVER_KERNELS} } "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    if missing:
        raise AssertionError(f"phase 10: {missing} never launched")
    return launches


def _concurrently(fn, args: list) -> list:
    """``fn(arg)`` for each of ``args`` on a thread of its own, all
    started together; the results in order. Raises the first error."""

    out: list = [None] * len(args)
    errors: list = []

    def run(i):
        try:
            out[i] = fn(args[i])
        except BaseException as e:  # re-raised below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise AssertionError("phase 11: a client thread did not finish in 300 s")
    if errors:
        raise errors[0]
    return out


def _http(port: int, path: str, body: bytes | None = None, headers: dict | None = None):
    """(status, body, headers) of a request to the endpoint on ``port``."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _timed(fn):
    """``fn`` wrapped to return (its result, its wall seconds)."""
    def run(arg):
        t0 = time.perf_counter()
        out = fn(arg)
        return out, time.perf_counter() - t0
    return run


def _pcts(seconds) -> str:
    ms = sorted(x * 1e3 for x in seconds)
    return (f"p50 {statistics.median(ms):.1f} ms, p99 "
            f"{ms[min(len(ms) - 1, math.ceil(0.99 * len(ms)) - 1)]:.1f} ms")


def serving_phase(A, torch, art, params, prompts, instances, answers, prefix, prefix_want,
                  dev, seed: int, card_line: str, keep: dict | None = None) -> dict[str, int]:
    """Phase 11; returns the launch counts of (a) (and puts (a)'s client
    latencies, seconds, into ``keep["http_s"]`` for phase 17)."""
    import numpy as np

    from hops_tpu_torch.models.convert import params_to_flax
    from hops_tpu_torch.models.layers import BatchNorm
    from hops_tpu_torch.models.resnet import ResNet50
    from hops_tpu_torch.modelrepo import registry, serving
    from hops_tpu_torch.modelrepo.serving import load_lm_artifact
    from hops_tpu_torch.runtime import config, faultinject, wirecodec

    config.configure(workspace=str(ROOT / "_smoke" / "serving"), project="chip_smoke")
    t_phase = time.perf_counter()

    # (a) the LM endpoint.
    registry.export(art, "smoke-lm", metrics={"layers": MODEL["num_layers"]})
    serving.create_or_update("smoke-lm", model_name="smoke-lm", model_server="LM",
                             lm_config={"slots": 4, "prefixes": {"sys": prefix}})
    torch.cuda.synchronize()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    cfg = serving.start("smoke-lm")  # loads the model and prefills the prefix
    start_s = time.perf_counter() - t0
    ttfts: list[float] = []
    try:
        engine = serving._servers["smoke-lm"].predictor.engine
        observe = engine._observe_ttft

        def keep_ttft(req):  # the engine drops a ticket's TTFT when its result is taken
            observe(req)
            ttfts.append(engine.ttft_s[req.ticket])

        engine._observe_ttft = keep_ttft
        ask = _timed(lambda inst: serving.make_inference_request(
            "smoke-lm", {"instances": [inst]})["predictions"][0])
        plain = _concurrently(ask, instances)
        sfx = _concurrently(ask, [dict(i, prefix_id="sys") for i in instances[:4]])
        torch.cuda.synchronize()
        launches = A.launch_counts()
        stats = serving.get_model_status("smoke-lm")["engine"]
    finally:
        serving.stop("smoke-lm")
    got, got_sfx = [a for a, _ in plain], [a for a, _ in sfx]
    if keep is not None:
        keep["http_s"] = [t for _, t in plain]
    model = load_lm_artifact(art, dev)
    notes = near_ties(model, torch, prompts, got, answers, dev, "phase 11 (a)")
    full = [prefix + p for p in prompts[:4]]
    notes_sfx = near_ties(model, torch, full, got_sfx, prefix_want[:4], dev,
                          "phase 11 (a) prefix")
    del model
    torch.cuda.empty_cache()
    missing = [k for k in SERVING_KERNELS if not launches[k]]
    print(f"phase 11 (a) LM endpoint on port {cfg['port']} (start {start_s:.1f} s, prefix "
          f"{len(prefix)} tokens): 8 concurrent requests, client latency "
          f"{_pcts([t for _, t in plain])}; 4 concurrent prefix requests, client latency "
          f"{_pcts([t for _, t in sfx])}; engine TTFT p50 of the 8 "
          f"{statistics.median(ttfts[:8]) * 1e3:.1f} ms, of the 4 prefix hits "
          f"{statistics.median(ttfts[8:]) * 1e3:.1f} ms; prefix hits {stats['prefix_hits']}, "
          f"{stats['dispatches']} dispatches, admission waves {stats['admission_waves']}; "
          f"streams equal phase 4's: leading tokens {same_lead(got, answers)}; "
          + ("; ".join(notes) or "all identical") + "; prefix streams equal phase 10 (c)'s: "
          f"leading tokens {same_lead(got_sfx, prefix_want[:4])}; "
          + ("; ".join(notes_sfx) or "all identical")
          + f"; launches { {k: launches[k] for k in SERVING_KERNELS} }; card {card_line}",
          flush=True)
    if missing:
        raise AssertionError(f"phase 11 (a): {missing} never launched")
    if len(ttfts) != 12 or stats["prefix_hits"] < 4:
        raise AssertionError(f"phase 11 (a): {len(ttfts)} TTFTs, {stats['prefix_hits']} "
                             "prefix hits")

    # (b) ResNet-50 behind a batching classifier endpoint.
    model = ResNet50(RESNET_CLASSES, device=dev, seed=seed)
    g = torch.Generator().manual_seed(seed + 11)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm):
                m.mean.copy_(torch.randn(m.mean.shape, generator=g) * 0.1)
                m.var.copy_(torch.rand(m.var.shape, generator=g) + 0.5)
                if name.endswith("BatchNorm_2"):  # zero-initialised: open the branch
                    m.scale.copy_(torch.rand(m.scale.shape, generator=g) * 0.2)
    model.eval()
    fields = {"stage_sizes": [3, 4, 6, 3], "num_classes": RESNET_CLASSES, "dtype": "bfloat16"}
    registry.save_classifier("ResNet", fields, params_to_flax(model), "smoke-resnet")
    serving.create_or_update("smoke-resnet", model_name="smoke-resnet", batching_enabled=True,
                             batching_config={"max_batch_size": CLASSIFIER_BATCH},
                             # More handler threads than admitted requests, so that
                             # one past the cap reaches admission and is shed.
                             resilience_config={"max_inflight": CLASSIFIER_REQUESTS,
                                                "http_workers": 2 * CLASSIFIER_REQUESTS})
    x = torch.randn(CLASSIFIER_REQUESTS, RESNET_IMAGE, RESNET_IMAGE, 3, generator=g).numpy()
    t0 = time.perf_counter()
    cfg = serving.start("smoke-resnet")
    start_s = time.perf_counter() - t0
    port = cfg["port"]
    packed = {"Content-Type": wirecodec.MEDIA_TYPE}
    path = "/v1/models/smoke-resnet:predict"

    def classify(i):
        code, body, _ = _http(port, path, wirecodec.encode_instances(x[i:i + 1]), packed)
        if code != 200:
            raise AssertionError(f"phase 11 (b): request {i} answered {code}: {body[:200]}")
        return json.loads(body)["predictions"][0]

    try:
        batcher = serving._servers["smoke-resnet"].batcher
        # Two rounds: the first meets cuDNN and the allocator cold.
        cold = _concurrently(_timed(classify), list(range(CLASSIFIER_REQUESTS)))
        cold_batches = batcher.batches_run
        rows = _concurrently(_timed(classify), list(range(CLASSIFIER_REQUESTS)))
        batches = batcher.batches_run - cold_batches
        code_j, body_j, _ = _http(port, path, wirecodec.encode_instances(x[:2]), packed)
        code_p, body_p, hdrs = _http(port, path, wirecodec.encode_instances(x[:2]),
                                     {**packed, "Accept": wirecodec.MEDIA_TYPE})
        # (c) routes, on the same endpoint.
        code_h, _, _ = _http(port, "/healthz")
        code_m, metrics, _ = _http(port, "/metrics")
        metrics = metrics.decode()
        faultinject.arm(f"serving.handle=latency:1.0@times={CLASSIFIER_REQUESTS}")
        try:
            held = []
            holders = threading.Thread(target=lambda: held.append(_concurrently(
                lambda i: _http(port, path, wirecodec.encode_instances(x[i:i + 1]), packed)[0],
                list(range(CLASSIFIER_REQUESTS)))))
            holders.start()
            time.sleep(0.5)  # every slot is held inside the handler
            code_o, _, hdrs_o = _http(port, path, wirecodec.encode_instances(x[:1]), packed)
            holders.join(timeout=300)
        finally:
            faultinject.disarm()
        # Where a warm request's time goes: the predictor alone on the 16
        # rows (this thread, no HTTP, no batcher), timed and profiled.
        predictor = serving._servers["smoke-resnet"].predictor
        direct_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            predictor.predict(x)  # ends in a copy to the host
            direct_s.append(time.perf_counter() - t0)
        wall_p, busy_p, kernels_p = device_profile(torch, lambda: predictor.predict(x))
    finally:
        serving.stop("smoke-resnet")
    served = torch.tensor([r for r, _ in rows])
    with torch.inference_mode():
        xt = torch.from_numpy(x).to(dev)
        direct = model(xt).float().cpu()
        ref = ResNet50(RESNET_CLASSES, dtype="float32", device=dev)
        ref.load_state_dict(model.state_dict())
        ref32 = ref.eval()(xt).float().cpu()
    del model, ref, xt
    torch.cuda.empty_cache()
    d_bf16 = (direct - ref32).abs().max().item()
    d_served = (served - ref32).abs().max().item()
    top2 = direct.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]) <= 2 * d_bf16
    differ = (served.argmax(1) != direct.argmax(1))
    json_rows = np.asarray(json.loads(body_j)["predictions"])
    print(f"phase 11 (b) ResNet-50 endpoint (batching, max_batch_size {CLASSIFIER_BATCH}; start "
          f"{start_s:.1f} s): {CLASSIFIER_REQUESTS} concurrent one-image packed requests in "
          f"{batches} batches, client latency {_pcts([t for _, t in rows])} (the first round, "
          f"cold: {cold_batches} batches, {_pcts([t for _, t in cold])}); argmax differs "
          f"from the direct eval forward in {int(differ.sum())} rows ({int((differ & near).sum())} "
          f"at a near tie); ||served - fp32||inf {d_served:.4e}, ||bf16 forward - fp32||inf "
          f"{d_bf16:.4e} (bound {CLASSIFIER_REL}x); packed reply {hdrs.get('Content-Type')}; "
          f"card {card_line}", flush=True)
    if bool((differ & ~near).any()):
        raise AssertionError("phase 11 (b): an argmax differs from the direct forward's "
                             "without a near tie")
    if not d_served <= CLASSIFIER_REL * d_bf16:
        raise AssertionError(f"phase 11 (b): served logits {d_served:.4e} from fp32, over "
                             f"{CLASSIFIER_REL} x {d_bf16:.4e}")
    if not batches < CLASSIFIER_REQUESTS:
        raise AssertionError(f"phase 11 (b): {batches} batches for {CLASSIFIER_REQUESTS} "
                             "requests")
    if not (code_j == code_p == 200 and hdrs.get("Content-Type") == wirecodec.MEDIA_TYPE
            and np.array_equal(wirecodec.decode_predictions(body_p), json_rows)):
        raise AssertionError("phase 11 (b): the packed reply does not decode to the JSON reply")
    convs = sum(ms for key, ms, _ in kernels_p if re.search(CONV_KERNELS, key))
    print(f"phase 11 (b) the predictor alone on the {CLASSIFIER_REQUESTS} rows: "
          f"{statistics.median(direct_s) * 1e3:.1f} ms (median of 3, host clock); profiled: wall "
          f"{wall_p:.1f} ms, device busy {busy_p:.3f} ms, idle share {1 - busy_p / wall_p:.3f}, "
          f"{sum(n for _, _, n in kernels_p)} launches, convolutions and the matrix product "
          f"{convs:.3f} ms ({convs / busy_p:.1%} of busy); card {card_line}", flush=True)
    fill = re.search(r'^hops_tpu_serving_batch_fill_ratio_count\{[^}]*model="smoke-resnet"\} '
                     r'(\S+)', metrics, re.M)
    count = re.search(r'^hops_tpu_serving_requests_total\{[^}]*model="smoke-resnet"\} (\S+)',
                      metrics, re.M)
    print(f"phase 11 (c) routes: /healthz {code_h}; /metrics {code_m}, requests_total "
          f"{count and count.group(1)}, batch fill observations {fill and fill.group(1)}; a "
          f"request past max_inflight {CLASSIFIER_REQUESTS} (each slot held 1 s by an injected "
          f"latency): {code_o}, Retry-After {hdrs_o.get('Retry-After')}; the holders answered "
          f"{held}", flush=True)
    if not (code_h == code_m == 200 and fill and count and code_o == 503
            and hdrs_o.get("Retry-After") and held == [[200] * CLASSIFIER_REQUESTS]):
        raise AssertionError("phase 11 (c): a route answered wrong")

    # (d) a standalone host on the card, at 2 layers.
    keep = {k: v for k, v in params.items()
            if not re.match(r"block_\d+/", k) or int(k.split("/")[0][6:]) < STANDALONE_LAYERS}
    registry.save_lm(dict(MODEL, num_layers=STANDALONE_LAYERS), keep, "smoke-lm-2")
    serving.create_or_update("smoke-lm-2", model_name="smoke-lm-2", model_server="LM",
                             lm_config={"slots": 4})
    serving.start("smoke-lm-2")
    try:
        want = serving.make_inference_request("smoke-lm-2", {"instances": instances[1:2]})
    finally:
        serving.stop("smoke-lm-2")
    t0 = time.perf_counter()
    cfg = serving.start("smoke-lm-2", standalone=True, timeout_s=300)
    up_s = time.perf_counter() - t0
    pid, port = cfg["pid"], cfg["port"]
    try:
        got = serving.make_inference_request("smoke-lm-2", {"instances": instances[1:2]})
    finally:
        serving.stop("smoke-lm-2")
    alive, listening = serving._pid_alive(pid), serving._port_alive(port)
    print(f"phase 11 (d) standalone host: pid {pid} up on port {port} in {up_s:.1f} s "
          f"(its own interpreter and CUDA context); its answer "
          f"{'equals' if got == want else 'differs from'} the in-process endpoint's "
          f"({len(got['predictions'][0])} tokens); after stop: process alive {alive}, port "
          f"open {listening} ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    if got != want:
        model = load_lm_artifact(registry.lm_artifact("smoke-lm-2"), dev)
        near_ties(model, torch, prompts[1:2], got["predictions"], want["predictions"], dev,
                  "phase 11 (d)")
        del model
    if alive or listening:
        raise AssertionError("phase 11 (d): stop left the standalone host running")
    return launches


def distribute_worker(spec_path: str) -> int:
    """Phase 12 (a) and (b), in the child that ``python -m
    hops_tpu_torch.launch`` started as rank 0 of a one-rank NCCL group:
    phase 7's train step through ``experiment.collective_all_reduce``
    (DDP), 8 steps from phase 7's weights, then 2 more under
    ``diagnostics.trace``; then 8 steps of ``ShardedStrategy(fsdp=-1)``
    (FSDP2) from the same weights. Writes what it saw to
    ``result.json`` beside the spec; the parent checks it."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from hops_tpu_torch import experiment
    from hops_tpu_torch.models.common import create_train_state
    from hops_tpu_torch.models.convert import load_npz
    from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
    from hops_tpu_torch.ops import attention as A
    from hops_tpu_torch.parallel import ShardedStrategy, get_strategy, multihost
    from hops_tpu_torch.runtime import config, diagnostics

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(spec_path).read_text())
    work = Path(spec["work"])
    config.configure(workspace=str(work / "workspace"), project="chip_smoke")
    params = load_npz(spec["params"])
    seed = spec["seed"]
    tokens = np.random.default_rng(seed + 2).integers(
        0, TRAIN["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ + 1))
    kind = torch.cuda.get_device_name(0)
    peaks = diagnostics.device_peaks(kind)
    if peaks is None:
        raise AssertionError(f"no tabulated peaks for {kind}")
    shape = (TRAIN_BATCH, TRAIN["num_heads"], TRAIN_SEQ, TRAIN_SEQ,
             TRAIN["d_model"] // TRAIN["num_heads"])
    kernel_flops = {k: diagnostics.attention_flops(k, *shape) for k in TRAIN_KERNELS}
    out: dict = {"backend": dist.get_backend(), "world": multihost.process_count(),
                 "device": str(multihost.device())}
    path_launches = {k: 0 for k in A.launch_counts()}

    def take() -> dict[str, int]:
        """The counts since the last take, added to the path's, reset."""
        got = A.launch_counts()
        for k, n in got.items():
            path_launches[k] += n
        A.reset_launch_counts()
        return got

    def train(strategy, prepare) -> tuple:
        model = TransformerLM(**TRAIN, device=strategy.device).load_flax(params)
        state = prepare(create_train_state(model, seed=seed, learning_rate=LEARNING_RATE))
        step = strategy.step(make_lm_train_step(loss_chunk=LOSS_CHUNK))
        batch = strategy.distribute_batch({"tokens": tokens})
        losses = []
        for _ in range(WARMUP_STEPS):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        take()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        return state, step, batch, {"losses": [float(x) for x in losses], "step_ms": ms,
                                    "launches": take()}

    def ddp_fn():
        s = get_strategy()
        state, step, batch, out["ddp"] = train(s, s.replicate)
        out["ddp"]["strategy"] = type(s).__name__
        out["ddp"]["wrapped"] = getattr(state.model, "_hops_tpu_parallel", None)
        with diagnostics.trace(str(work / "trace")) as target:
            for _ in range(TRACED_STEPS):
                state, _ = step(state, batch)
        traced = take()
        report = diagnostics.roofline_report(target, *peaks, steps=TRACED_STEPS,
                                             kernel_flops=kernel_flops)
        out["trace"] = {"launches": traced, "report": report,
                        "top": diagnostics.top_ops(target, steps=TRACED_STEPS, n=8)}
        return {"loss": out["ddp"]["losses"][-1]}

    A.reset_launch_counts()
    experiment.collective_all_reduce(ddp_fn, name="distribute")
    gc.collect()
    torch.cuda.empty_cache()
    s = ShardedStrategy(fsdp=-1)
    with s.scope():
        state, _, _, out["fsdp"] = train(s, s.shard_state)
        out["fsdp"]["mesh"] = s.mesh.shape
        out["fsdp"]["dtensor"] = type(state.model.unembed.kernel).__name__
    del state
    take()
    out["path_launches"] = path_launches
    (work / "result.json").write_text(json.dumps(out))
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def distribute_phase(A, torch, art, prompts, answers, dev, seed: int, card_line: str,
                     phase7: dict) -> dict[str, int]:
    """Phase 12; returns the launch counts of its path: (a) and (b) in a
    child process (its own NCCL group of one rank, so none is left alive
    in this one), (c) and (d) here."""
    import subprocess

    import numpy as np

    from hops_tpu_torch import experiment
    from hops_tpu_torch.models.common import cross_entropy_loss
    from hops_tpu_torch.models.resnet import ResNet50
    from hops_tpu_torch.models.widedeep import WideAndDeep, make_taxi_batch
    from hops_tpu_torch.modelrepo import registry
    from hops_tpu_torch.modelrepo.batch import (
        batch_predict,
        lm_generate_with_model,
        predict_with_model,
    )
    from hops_tpu_torch.modelrepo.serving import load_lm_artifact
    from hops_tpu_torch.parallel import Strategy
    from hops_tpu_torch.runtime import config

    t_phase = time.perf_counter()
    work = ROOT / "_smoke" / "distribute"
    work.mkdir(parents=True, exist_ok=True)
    (work / "spec.json").write_text(json.dumps(
        {"params": str(art / "params.npz"), "seed": seed, "work": str(work)}))
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "hops_tpu_torch.launch", "--coordinator",
           f"127.0.0.1:{_free_port()}", "--num-processes", "1", "--process-id", "0",
           str(ROOT / "chip_smoke.py"), "--distribute-worker", str(work / "spec.json")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 12 (a) worker exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    res = json.loads((work / "result.json").read_text())
    ddp, fsdp, tr = res["ddp"], res["fsdp"], res["trace"]
    layers = TRAIN["num_layers"]
    same = [a == b for a, b in zip(ddp["losses"], phase7["losses"])]
    rel = [abs(a - b) / abs(b) for a, b in zip(fsdp["losses"], ddp["losses"])]
    print(f"phase 12 (a) launch CLI child ({child_s:.1f} s): {res['backend']} group of "
          f"{res['world']} rank on {res['device']}; DDP ({ddp['strategy']}, module wrapped "
          f"{ddp['wrapped']}) losses {[round(x, 4) for x in ddp['losses']]}, equal phase 7's bit "
          f"for bit at {sum(same)} of {len(same)} steps; step {ddp['step_ms']:.3f} ms "
          f"(phase 7 {phase7['step_ms']:.3f} ms); FSDP2 (mesh {fsdp['mesh']}, parameters "
          f"{fsdp['dtensor']}) losses {[round(x, 4) for x in fsdp['losses']]}, worst relative "
          f"distance from DDP's {max(rel):.3e} (bound {FSDP_LOSS_REL:.0e}); step "
          f"{fsdp['step_ms']:.3f} ms; launches over {TIMED_STEPS} timed steps DDP "
          f"{ {k: ddp['launches'][k] for k in TRAIN_KERNELS} }, FSDP2 "
          f"{ {k: fsdp['launches'][k] for k in TRAIN_KERNELS} }; card {card_line}", flush=True)
    if res["backend"] != "nccl" or res["world"] != 1:
        raise AssertionError(f"phase 12 (a): backend {res['backend']}, world {res['world']}")
    if not all(same):
        raise AssertionError(f"phase 12 (a): DDP losses {ddp['losses']} differ from phase 7's "
                             f"{phase7['losses']}")
    if not max(rel) <= FSDP_LOSS_REL:
        raise AssertionError(f"phase 12 (a): FSDP2 losses {fsdp['losses']} over "
                             f"{FSDP_LOSS_REL} from DDP's")
    for name in TRAIN_KERNELS:
        for what, got in (("DDP", ddp), ("FSDP2", fsdp)):
            if got["launches"][name] != layers * TIMED_STEPS:
                raise AssertionError(f"phase 12 (a) {what}: {name} launched "
                                     f"{got['launches'][name]} times in {TIMED_STEPS} steps")

    rep = tr["report"]
    cats = {c["name"]: c for c in rep["categories"]}
    print(f"phase 12 (b) diagnostics.trace over {TRACED_STEPS} DDP steps on {rep['device']} "
          f"(roofs {rep['peak_tflops']:.0f} TFLOP/s, {rep['peak_gbps']:.0f} GB/s): "
          f"{rep['total_ms']:.3f} device ms per step; " + "; ".join(
              f"{c['name']} {c['ms']:.3f} ms ({c['share']:.1%}, {c['count']:.0f} launches"
              + (f", {c['tflops_per_s']:.1f} TFLOP/s" if c["tflops_per_s"] is not None else "")
              + (f", {c['gb_per_s']:.1f} GB/s" if c["gb_per_s"] is not None else "")
              + (f", {c['peak_share']:.1%} of the {c['bound']} peak"
                 if c["peak_share"] is not None else ", bound unknown") + ")"
              for c in rep["categories"]) + f"; card {card_line}", flush=True)
    for op in tr["top"]:
        print(f"  {op['ms']:.4f} ms/step ({op['count']:.0f}/step, {op['category']}, from "
              f"{op['source']}) {op['name'][:90]}", flush=True)
    for name in TRAIN_KERNELS:
        got = cats.get(name, {}).get("count", 0) * TRACED_STEPS
        if got != tr["launches"][name] or not got:
            raise AssertionError(f"phase 12 (b): the trace counts {got} {name} kernels, "
                                 f"LAUNCHES {tr['launches'][name]}")
    over = [c["name"] for c in rep["categories"] if (c["peak_share"] or 0) > 1.0]
    if over:
        raise AssertionError(f"phase 12 (b): {over} read over 100% of a peak")

    # (c) batch inference from the registry phase 11 filled.
    config.configure(workspace=str(ROOT / "_smoke" / "serving"), project="chip_smoke")
    torch.cuda.synchronize()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    got = lm_generate_with_model("smoke-lm", prompts, max_new_tokens=list(NEW_TOKENS),
                                 slots=4, device=dev)
    lm_s = time.perf_counter() - t0
    launches = A.launch_counts()
    model = load_lm_artifact(art, dev)
    notes = near_ties(model, torch, prompts, got, answers, dev, "phase 12 (c)")
    del model
    torch.cuda.empty_cache()
    print(f"phase 12 (c) lm_generate_with_model: {sum(len(a) for a in got)} tokens for "
          f"{len(got)} prompts in {lm_s:.2f} s (registry load included); streams equal phase "
          f"4's: leading tokens {same_lead(got, answers)}; " + ("; ".join(notes) or
                                                                "all identical")
          + f"; launches { {k: launches[k] for k in SERVING_KERNELS} }", flush=True)
    if not (launches["flash_fwd"] and launches["decode_attention"]):
        raise AssertionError(f"phase 12 (c): a kernel of the LM path never launched: {launches}")
    g = torch.Generator().manual_seed(seed + 12)
    x = torch.randn(BATCH_IMAGES, RESNET_IMAGE, RESNET_IMAGE, 3, generator=g).numpy()
    strategy = Strategy(device=dev)
    t0 = time.perf_counter()
    preds = predict_with_model("smoke-resnet", x, per_chip_batch=BATCH_PER_CHIP,
                               strategy=strategy)
    cold_s = time.perf_counter() - t0
    clf = registry.load_classifier("smoke-resnet", device=dev)
    t0 = time.perf_counter()
    batch_predict(clf, x, BATCH_PER_CHIP, strategy)
    warm_s = time.perf_counter() - t0
    with torch.inference_mode():
        xt = torch.from_numpy(x).to(dev)
        direct = clf(xt).float().cpu()
        ref = ResNet50(RESNET_CLASSES, dtype="float32", device=dev)
        ref.load_state_dict(clf.state_dict())
        ref32 = ref.eval()(xt).float().cpu()
    del clf, ref, xt
    torch.cuda.empty_cache()
    d_bf16 = (direct - ref32).abs().max().item()
    top2 = direct.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]) <= 2 * d_bf16
    differ = torch.from_numpy(preds).argmax(1) != direct.argmax(1)
    print(f"phase 12 (c) predict_with_model: ResNet-50 over {BATCH_IMAGES} images at "
          f"per_chip_batch {BATCH_PER_CHIP}: {cold_s:.2f} s with the registry load, "
          f"{BATCH_IMAGES / warm_s:.1f} images/s warm (batch_predict alone, host clock); "
          f"argmax differs from the direct forward in {int(differ.sum())} rows "
          f"({int((differ & near).sum())} at a near tie); card {card_line}", flush=True)
    if preds.shape != (BATCH_IMAGES, RESNET_CLASSES) or bool((differ & ~near).any()):
        raise AssertionError("phase 12 (c): batch predictions differ from the direct forward")

    # (d) wide-and-deep through experiment.launch.
    config.configure(workspace=str(work / "workspace"), project="chip_smoke")
    keep: dict = {}

    def taxi_fn():
        model = WideAndDeep(TAXI_VOCAB, device=dev, seed=seed)
        opt = torch.optim.Adam(model.parameters(), lr=TAXI_LR)
        gen = torch.Generator(device=dev).manual_seed(seed)
        losses = []
        for _ in range(TAXI_STEPS):
            b = make_taxi_batch(gen, TAXI_BATCH, TAXI_VOCAB, device=dev)
            loss = cross_entropy_loss(model(b), b["label"])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        keep["model"] = model.eval()
        return {"first": float(losses[0]), "last": float(torch.stack(losses[-5:]).mean())}

    t0 = time.perf_counter()
    _, metrics = experiment.launch(taxi_fn, name="widedeep")
    train_s = time.perf_counter() - t0
    model = keep["model"]
    rows = make_taxi_batch(torch.Generator(device=dev).manual_seed(seed + 1), TAXI_ROWS,
                           TAXI_VOCAB, device=dev)
    vectors = torch.cat([rows["dense"], rows["categorical"].float()], 1).cpu().numpy()
    nd = rows["dense"].shape[1]

    def apply(t):
        return model({"dense": t[:, :nd], "categorical": t[:, nd:].long()})

    t0 = time.perf_counter()
    got_wd = batch_predict(apply, vectors, BATCH_PER_CHIP, strategy)
    wd_s = time.perf_counter() - t0
    with torch.inference_mode():
        direct_wd = model(rows).float().cpu().numpy()
    diff = float(np.abs(got_wd - direct_wd).max())
    bound = 2 ** -7 * float(np.abs(direct_wd).max())
    print(f"phase 12 (d) WideAndDeep {TAXI_VOCAB} (embed 8, hidden (128, 64), bf16): "
          f"{TAXI_STEPS} Adam steps at batch {TAXI_BATCH} through experiment.launch in "
          f"{train_s:.2f} s, loss {metrics['first']:.4f} -> {metrics['last']:.4f} (mean of the "
          f"last 5); batch_predict of {TAXI_ROWS} rows in {wd_s:.2f} s "
          f"({TAXI_ROWS / wd_s:.0f} rows/s, host clock), ||batched - direct||inf {diff:.3e} "
          f"(bound {bound:.3e}, bf16 rounding; {'bit-identical' if diff == 0 else 'not bit-identical'})",
          flush=True)
    if not metrics["last"] < metrics["first"]:
        raise AssertionError(f"phase 12 (d): the loss did not fall: {metrics}")
    if got_wd.shape != direct_wd.shape or not diff <= bound:
        raise AssertionError(f"phase 12 (d): batch_predict {diff:.3e} from the direct forward")
    del keep, model
    torch.cuda.empty_cache()
    total = {k: n + launches.get(k, 0) for k, n in res["path_launches"].items()}
    phase_s = time.perf_counter() - t_phase
    print(f"phase 12 took {phase_s:.1f} s (budget {PHASE12_BUDGET_S:.0f} s); launches of the "
          f"path {total}", flush=True)
    if phase_s > PHASE12_BUDGET_S:
        raise AssertionError(f"phase 12 took {phase_s:.1f} s, over {PHASE12_BUDGET_S:.0f} s")
    return total


def _trace_share(trace_dir: str, tokens: int, capacity: tuple[int, ...],
                 steps: int) -> tuple[float, float, int]:
    """From a ``diagnostics.trace`` capture: the device ms per step of the
    kernels whose launching op has the token count and one of
    ``capacity`` (C, or E·C where an einsum folds the experts into it)
    among its input dims — the MoE dispatch/combine einsums, their
    backward and the ``(T, E, C)`` mask ops — the device ms per step of
    all kernels, and those kernels' launches per step."""
    from hops_tpu_torch.runtime.diagnostics import _find_trace_file

    doc = json.loads(Path(_find_trace_file(trace_dir)).read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    ops = {(e.get("args") or {}).get("External id"): e for e in events
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"}
    total = hit = 0.0
    count = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        dur = float(e.get("dur", 0)) / 1e3
        total += dur
        op = ops.get((e.get("args") or {}).get("External id"))
        dims = {int(x) for d in ((op or {}).get("args") or {}).get("Input Dims") or []
                if isinstance(d, list) for x in d if isinstance(x, int)}
        if tokens in dims and dims & set(capacity):
            hit += dur
            count += 1
    return hit / steps, total / steps, count // steps


def _moe_taps(engine, torch, taps: dict, calls: list, force: dict | None = None):
    """Record each model call of ``engine`` (a forward pre-hook opens
    it): per MoE layer, the routing its router's logits give (the
    ``probs >= k-th`` mask and each token's k-th minus (k+1)-th
    probability), and per drawn token its fp32 logits and call,
    ``taps[(ticket, j)] = (logits, call)``.

    ``force`` makes the run teacher-forced: each router's logits are
    masked to ``force["routing"]``'s mask of the same call and layer (the
    layer then selects those experts, at its own gate values, and the
    capacity cut follows from them), and each draw returns logits whose
    argmax is ``force["tokens"][(ticket, j)]``. Returns the hook handles."""
    import functools

    from hops_tpu_torch.models.moe import MoEMLP

    model = engine.model

    def on_call(_mod, _args):
        calls.append([])

    def on_router(top_k, _mod, _args, out):
        probs = torch.softmax(out.float(), dim=-1)
        top = torch.topk(probs, top_k + 1, dim=-1).values
        calls[-1].append((probs >= top[:, top_k - 1:top_k], top[:, top_k - 1] - top[:, top_k]))
        if force is None:
            return None
        c, layer = len(calls) - 1, len(calls[-1]) - 1
        if c >= len(force["routing"]) or layer >= len(force["routing"][c]):
            raise AssertionError(f"phase 13 (d): call {c} layer {layer} has no forced routing")
        mask = force["routing"][c][layer][0]
        if tuple(mask.shape) != tuple(out.shape):
            raise AssertionError(f"phase 13 (d): call {c} routes {tuple(out.shape)}, the served "
                                 f"run {tuple(mask.shape)}")
        forced = out.masked_fill(~mask, float("-inf"))
        fp = torch.softmax(forced.float(), dim=-1)
        if not torch.equal(fp >= torch.topk(fp, top_k, dim=-1).values[:, -1:], mask):
            raise AssertionError(f"phase 13 (d): call {c} layer {layer}: the forced routing "
                                 "does not select the served run's experts")
        return forced

    real = model.logits

    def tap(hidden):
        out = real(hidden)
        call = len(calls) - 1
        if out.dim() == 3:  # a decode step over every slot
            last = out[:, -1]
            rows = [(r, (st.ticket, len(st.emitted)))
                    for r, st in enumerate(engine._slot_state) if st is not None]
        else:  # an admission wave, in _admitting's order
            last = out
            rows = [(i, (req.ticket, 0)) for i, req in enumerate(engine._admitting)]
        for r, key in rows:
            taps[key] = (last[r].float(), call)
        if force is None:
            return out
        out = out.clone()
        last = out[:, -1] if out.dim() == 3 else out
        for r, key in rows:
            last[r] = float("-inf")
            last[r, force["tokens"][key]] = 0.0
        return out

    model.logits = tap
    return [model.register_forward_pre_hook(on_call)] + [
        m.router.register_forward_hook(functools.partial(on_router, m.top_k))
        for m in model.modules() if isinstance(m, MoEMLP)]


def _moe_forced_run(torch, model, prompts, got, got_calls, dev) -> tuple[dict, list, list]:
    """``model`` in an engine of the served shape (4 slots) under the plain
    attention, teacher-forced to the served run: ``got``'s tokens and
    ``got_calls``' routing. Returns its taps keyed ``(request, j)``, its
    calls and its streams."""
    from hops_tpu_torch.modelrepo.lm_engine import LMEngine

    engine = LMEngine(model, slots=4, device=dev)
    taps, calls, force = {}, [], {"routing": got_calls, "tokens": {}}
    hooks = _moe_taps(engine, torch, taps, calls, force)
    with torch.inference_mode(), plain_attention():
        tickets = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, NEW_TOKENS)]
        for t, stream in zip(tickets, got):
            force["tokens"].update({(t, j): tok for j, tok in enumerate(stream)})
        res = engine.run()
    for h in hooks:
        h.remove()
    index = {t: i for i, t in enumerate(tickets)}
    return ({(index[t], j): v for (t, j), v in taps.items()}, calls, [res[t] for t in tickets])


def _moe_check(torch, got, got_taps, got_calls, plain, fp32) -> dict:
    """Phase 13 (d)'s serving check against two teacher-forced runs of the
    same model under the plain attention (:func:`_moe_forced_run`):
    ``plain`` in bf16, ``fp32`` with the weights cast up. Both see the
    served run's tokens and routing, so every drawn token is compared on
    the same history:

    - calls: the same count, and per MoE layer the same token count;
    - routing: where the forced bf16 run's own router would pick other
      experts than the served run did, the k-th and (k+1)-th
      probabilities lie within ``ROUTER_MARGIN`` in one of the two runs
      (the fp32 run's flips are counted);
    - logits: per draw, ``||served - fp32||inf`` within
      ``MOE_TOKEN_REL`` times ``||plain - fp32||inf`` (the plain bf16
      model's own distance from fp32), and the median draw's ratio
      within ``MOE_MEDIAN_REL``;
    - tokens: each served token is the plain bf16 run's argmax, or within
      ``NEAR_TIE_REL * ||logits||inf`` of it (a near tie).

    Returns the counts and the worst ratios; raises on a failed check."""
    order = sorted({t for t, _ in got_taps})
    got_taps = {(order.index(t), j): v for (t, j), v in got_taps.items()}
    out = {"tokens": sum(len(a) for a in got), "held": 0, "near_ties": [], "flips": {},
           "margin": {}, "ratios": [], "direct": []}
    for name, (_, calls, streams) in (("bf16", plain), ("fp32", fp32)):
        if streams != got:
            raise AssertionError(f"phase 13 (d): the forced {name} run drew other tokens")
        if len(calls) != len(got_calls):
            raise AssertionError(f"phase 13 (d): the forced {name} run made {len(calls)} calls, "
                                 f"the served run {len(got_calls)}")
        flips, widest = 0, 0.0
        for c, (mine, theirs) in enumerate(zip(calls, got_calls)):
            if len(mine) != len(theirs):
                raise AssertionError(f"phase 13 (d): call {c} has {len(mine)} MoE layers, "
                                     f"not {len(theirs)}")
            for (ma, mm), (ga, gm) in zip(mine, theirs):
                rows = (ma != ga).any(dim=1).nonzero().flatten()
                flips += len(rows)
                if len(rows):
                    worst = torch.minimum(mm[rows], gm[rows]).max().item()
                    widest = max(widest, worst)
                    # The bf16 run differs from the served one in its
                    # attention alone; the fp32 run (the logits' noise
                    # scale) in every rounding, so its router moves more.
                    if name == "bf16" and worst > ROUTER_MARGIN:
                        raise AssertionError(
                            f"phase 13 (d): the forced {name} run routes {len(rows)} tokens of "
                            f"call {c} elsewhere, widest k-th vs (k+1)-th margin {worst:.2e}")
        out["flips"][name], out["margin"][name] = flips, widest
    bad = []
    for i, stream in enumerate(got):
        for j, tok in enumerate(stream):
            g, p, f = (t[(i, j)][0] for t in (got_taps, plain[0], fp32[0]))
            err, noise = (g - f).abs().max().item(), (p - f).abs().max().item()
            out["ratios"].append(err / noise if noise else math.inf)
            out["direct"].append((g - p).abs().max().item() / noise if noise else math.inf)
            if not err <= MOE_TOKEN_REL * noise:
                bad.append(f"request {i} token {j}: |served - fp32|inf {err:.3e}, plain bf16's "
                           f"{noise:.3e}")
            best = int(torch.argmax(p))
            if best != tok:
                gap, scale = (p[best] - p[tok]).item(), p.abs().max().item()
                if not gap <= NEAR_TIE_REL * scale:
                    bad.append(f"request {i} token {j}: served {tok}, plain argmax {best}, gap "
                               f"{gap / scale:.1e} of ||logits||inf")
                    continue
                out["near_ties"].append(f"request {i} token {j}: gap {gap / scale:.1e}")
            out["held"] += 1
    for key in ("ratios", "direct"):
        r = sorted(out[key])
        out[f"{key}_q"] = (r[len(r) // 2], r[min(len(r) - 1, int(0.99 * len(r)))], r[-1])
    if not out["ratios_q"][0] <= MOE_MEDIAN_REL:
        bad.append(f"the median token's |served - fp32|inf is {out['ratios_q'][0]:.3f} times the "
                   f"plain bf16's")
    out["bad"] = bad
    return out


def scaleout_worker(spec_path: str) -> int:
    """Phase 13, in the child that ``python -m hops_tpu_torch.launch``
    started as rank 0 of a one-rank NCCL group: (a) ResNet-50 through
    ``experiment.collective_all_reduce`` in every grad-comms mode, (b)
    the quantized wire format on the card, (c) Ulysses and ring attention
    in the LM, (d) the MoE LM trained and served. Prints its lines, raises
    on a failed check, and writes the launch counts of the sp and moe
    paths to ``result.json`` beside the spec."""
    import gc as gcollect

    import numpy as np
    import torch
    import torch.distributed as dist

    from hops_tpu_torch import experiment
    from hops_tpu_torch.models.common import (
        SyntheticClassData, create_bn_train_state, create_train_state, make_bn_train_step,
    )
    from hops_tpu_torch.models.convert import load_npz
    from hops_tpu_torch.models.resnet import ResNet50
    from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
    from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, load_lm_artifact
    from hops_tpu_torch.ops import attention as A
    from hops_tpu_torch.parallel import get_strategy, mesh as mesh_lib, multihost
    from hops_tpu_torch.parallel import grad_comms as gc
    from hops_tpu_torch.runtime import config
    from hops_tpu_torch.telemetry.metrics import REGISTRY

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(spec_path).read_text())
    work, seed, card_line = Path(spec["work"]), spec["seed"], spec["card"]
    config.configure(workspace=str(work / "workspace"), project="chip_smoke")
    dev = multihost.device()
    out: dict = {"backend": dist.get_backend(), "world": multihost.process_count()}
    if out["backend"] != "nccl" or out["world"] != 1:
        raise AssertionError(f"phase 13: backend {out['backend']}, world {out['world']}")

    # (a) grad comms on ResNet-50, deterministic.
    marks = {"start": time.perf_counter()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    data = SyntheticClassData(num_classes=RESNET_CLASSES, shape=(RESNET_IMAGE, RESNET_IMAGE, 3),
                              seed=seed, device=dev)
    batches = list(data.batches(RESNET_BATCH, SCALEOUT_STEPS))
    pre_c = REGISTRY.counter("hops_tpu_grad_comms_bytes_pre_total", labels=("mode",))
    post_c = REGISTRY.counter("hops_tpu_grad_comms_bytes_post_total", labels=("mode",))
    ratio_g = REGISTRY.gauge("hops_tpu_grad_comms_compression_ratio", labels=("mode",))
    runs, keep = {}, {}
    for mode in SCALEOUT_MODES:
        cfg = gc.GradCommsConfig.parse(mode)
        label = cfg.mode if cfg is not None else None
        before = (pre_c.value(mode=label), post_c.value(mode=label)) if label else None

        def train_fn():
            s = get_strategy()
            state = s.replicate(create_bn_train_state(ResNet50(RESNET_CLASSES, device=dev,
                                                               seed=seed)))
            if cfg is not None and cfg.update_sharding == "zero3":
                state = gc.zero3_init(state, s.mesh)
            step = s.step(make_bn_train_step(grad_comms=s.grad_comms))
            losses, times = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, b)
                losses.append(m["loss"])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            runs[mode] = {"losses": [float(x) for x in losses],
                          "ms": statistics.median(times[1:]) * 1e3}
            if mode == "allreduce":
                keep["model"] = state.model
            elif mode == "zero3":
                keep["zero3_meta"] = state.shards.meta
            return {"loss": runs[mode]["losses"][-1]}

        experiment.collective_all_reduce(train_fn, name=f"scaleout-{mode}", grad_comms=cfg)
        if label:
            tree = ([torch.empty((m[3],), dtype=m[1], device="meta") for m in keep["zero3_meta"]]
                    if mode == "zero3" else keep["model"])
            want = [x * SCALEOUT_STEPS for x in gc.wire_bytes(tree, cfg)]
            got = [pre_c.value(mode=label) - before[0], post_c.value(mode=label) - before[1]]
            runs[mode].update(pre=got[0], post=got[1], ratio=ratio_g.value(mode=label))
            if got != want:
                raise AssertionError(f"phase 13 (a) {mode}: counted {got} wire bytes, "
                                     f"wire_bytes gives {want}")
        gcollect.collect()
        torch.cuda.empty_cache()
    ref = runs["none"]
    print(f"phase 13 (a) ResNet-50 (batch {RESNET_BATCH}, {RESNET_IMAGE}x{RESNET_IMAGE}, bf16, "
          f"seeded weights) through experiment.collective_all_reduce, {SCALEOUT_STEPS} steps a "
          f"mode, deterministic algorithms, one NCCL rank: losses (none, DDP) "
          f"{[round(x, 5) for x in ref['losses']]}; step ms (median of steps 2-"
          f"{SCALEOUT_STEPS}) none {ref['ms']:.3f}, " + ", ".join(
              f"{m} {r['ms']:.3f}" for m, r in runs.items() if m != "none")
          + f"; card {card_line}", flush=True)
    for mode, r in runs.items():
        if "pre" in r:
            print(f"  {mode}: hops_tpu_grad_comms_bytes_pre_total +{r['pre']:.0f}, "
                  f"_post_total +{r['post']:.0f}, compression ratio {r['ratio']:.4f} "
                  f"(= wire_bytes x {SCALEOUT_STEPS})", flush=True)
        if r["losses"] != ref["losses"]:
            raise AssertionError(f"phase 13 (a): {mode}'s losses {r['losses']} differ from "
                                 f"none's {ref['losses']}")

    # (b) the wire format on the card, over ResNet-50's gradient buckets.
    model = keep.pop("model")
    model.zero_grad(set_to_none=True)
    b = batches[0]
    logits = model(b["image"], train=True)
    torch.nn.functional.cross_entropy(logits.float(), b["label"]).backward()
    grads = [p.grad for p in model.parameters()]
    bufs, _ = gc.flatten_buckets(grads, gc.DEFAULT_BUCKET_BYTES)
    worst, n_el, cfg_q = 0.0, 0, gc.GradCommsConfig(quantize=True)
    for buf in bufs:
        q, s = gc.quantize_blockwise(buf, cfg_q.block_size)
        cq, cs = gc.quantize_blockwise(buf.cpu(), cfg_q.block_size)
        if not (torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)):
            raise AssertionError("phase 13 (b): int8 blocks or scales differ from the CPU's")
        back = gc.dequantize_blockwise(q, s, buf.numel(), tuple(buf.shape), buf.dtype)
        err = (back - buf).abs().reshape(-1)
        pad = (-buf.numel()) % cfg_q.block_size
        ratio = (torch.cat([err, err.new_zeros(pad)]).reshape(-1, cfg_q.block_size) / s).max()
        worst = max(worst, ratio.item())
        n_el += buf.numel()
    # Half a step of the int8 grid, plus the fp32 rounding of q * scale:
    # one ulp of the block's largest value, 127 scales.
    bound = 0.5 + 127 * 2.0 ** -23
    print(f"phase 13 (b) quantize_blockwise on the card over ResNet-50's {len(bufs)} gradient "
          f"buckets ({n_el} elements, block {cfg_q.block_size}): int8 values and fp32 scales "
          f"equal the CPU's bit for bit; worst round-trip error {worst:.7f} of its block's "
          f"scale (bound {bound:.7f})", flush=True)
    if worst > bound:
        raise AssertionError(f"phase 13 (b): round-trip error {worst} of a block's scale")
    del model, grads, bufs, logits, keep
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    gcollect.collect()
    torch.cuda.empty_cache()

    # (c) sequence parallelism on a one-rank seq mesh.
    marks["(a)-(b)"] = time.perf_counter()
    params = load_npz(spec["params"])
    tokens = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, TRAIN["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ + 1))).to(dev)
    seq_mesh = mesh_lib.make_mesh({"seq": 1})

    def train(cfg, batch, steps):
        model = TransformerLM(**cfg, device=dev,
                              mesh=seq_mesh if cfg["attention_impl"] in ("ring", "ulysses")
                              else None).load_flax(params)
        state = create_train_state(model, seed=seed, learning_rate=LEARNING_RATE)
        step = make_lm_train_step(loss_chunk=LOSS_CHUNK)
        losses = []
        for _ in range(steps):
            state, m = step(state, {"tokens": batch})
            losses.append(float(m["loss"]))
        del model, state
        gcollect.collect()
        torch.cuda.empty_cache()
        return losses

    flash = train(TRAIN, tokens, SP_STEPS)
    torch.cuda.synchronize()
    A.reset_launch_counts()
    uly = train(dict(TRAIN, attention_impl="ulysses"), tokens, SP_STEPS)
    torch.cuda.synchronize()
    sp_launches = A.launch_counts()
    print(f"phase 13 (c) Ulysses (phase 7's LM, batch {TRAIN_BATCH} x {TRAIN_SEQ}, one-rank seq "
          f"mesh): losses {[round(x, 5) for x in uly]}, flash's {[round(x, 5) for x in flash]}; "
          f"launches over {SP_STEPS} steps { {k: sp_launches[k] for k in TRAIN_KERNELS} }",
          flush=True)
    if uly != flash:
        raise AssertionError(f"phase 13 (c): Ulysses losses {uly} differ from flash's {flash}")
    for k in TRAIN_KERNELS:
        if sp_launches[k] != TRAIN["num_layers"] * SP_STEPS:
            raise AssertionError(f"phase 13 (c): {k} launched {sp_launches[k]} times in "
                                 f"{SP_STEPS} Ulysses steps")
    small = tokens[:RING_BATCH]
    ring = train(dict(TRAIN, attention_impl="ring"), small, RING_STEPS)
    flash2 = train(TRAIN, small, RING_STEPS)
    fp32 = train(dict(TRAIN, dtype="float32", attention_impl="reference"), small, RING_STEPS)
    d_ring = max(abs(a - b) for a, b in zip(ring, fp32))
    d_flash = max(abs(a - b) for a, b in zip(flash2, fp32))
    print(f"phase 13 (c) ring (batch {RING_BATCH}): losses {[round(x, 5) for x in ring]}; the "
          f"bf16 flash path {[round(x, 5) for x in flash2]}, the fp32 plain path "
          f"{[round(x, 5) for x in fp32]}: ring's distance {d_ring:.3e}, flash's {d_flash:.3e} "
          f"(bound {RING_REL} x flash's)", flush=True)
    if not d_ring <= RING_REL * d_flash:
        raise AssertionError(f"phase 13 (c): ring's losses {d_ring:.3e} from fp32, over "
                             f"{RING_REL} x flash's {d_flash:.3e}")

    # (d) the MoE LM, trained and served.
    marks["(c)"] = time.perf_counter()
    art = Path(spec["moe_artifact"])
    moe_params = load_npz(art / "params.npz")
    A.reset_launch_counts()
    moe_run = _train_moe(torch, moe_params, tokens, dev, seed, work, A)
    moe_train = moe_run["launches"]
    losses, share = moe_run["losses"], moe_run["share"]
    rep = moe_run["report"]
    print(f"phase 13 (d) MoE LM (moe_every {MOE_TRAIN['moe_every']}: "
          f"{MOE_TRAIN['num_layers'] // MOE_TRAIN['moe_every']} MoE blocks of "
          f"{MOE_TRAIN['num_experts']} experts, top {MOE_TRAIN['moe_top_k']}, "
          f"capacity factor 1.25, hidden {moe_run['hidden']}; {moe_run['experts'] / 1e9:.3f} B "
          f"expert parameters) at batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses {[round(x, 4) for x in losses]}, aux loss {moe_run['aux']:.4f}; step "
          f"{moe_run['ms']:.3f} ms, {moe_run['tokens_s']:.1f} tokens/s; peak memory "
          f"{moe_run['peak_gib']:.2f} GiB; launches over {MOE_STEPS} steps "
          f"{ {k: moe_train[k] for k in TRAIN_KERNELS} }; card {card_line}", flush=True)
    print(f"phase 13 (d) diagnostics.trace of one MoE step: {rep['total_ms']:.3f} device ms; "
          f"dispatch/combine (the (T, E, C) einsums and mask ops, {share[2]} launches) "
          f"{share[0]:.3f} ms ({share[0] / share[1]:.1%} of kernel time); " + "; ".join(
              f"{c['name']} {c['ms']:.3f} ms ({c['share']:.1%})" for c in rep["categories"]),
          flush=True)
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"phase 13 (d): the MoE loss did not fall: {losses}")
    for k in TRAIN_KERNELS:
        if not moe_train[k]:
            raise AssertionError(f"phase 13 (d): {k} never launched in MoE training")
    gcollect.collect()
    torch.cuda.empty_cache()

    del moe_params
    marks["(d) training"] = time.perf_counter()
    prompts = spec["prompts"][:MOE_REQUESTS]
    instances = [{"prompt": p, "max_new_tokens": n, "temperature": 0.0}
                 for p, n in zip(prompts, NEW_TOKENS)]
    serve_launches = {k: 0 for k in A.launch_counts()}
    for kv in (None, "int8"):
        name = "int8" if kv else "bf16"
        predictor = LMEnginePredictor(art, {"slots": 4, "kv_cache_dtype": kv}, device=dev)
        got_taps, got_calls = {}, []
        hooks = _moe_taps(predictor.engine, torch, got_taps, got_calls)
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        got = predictor.predict(instances)
        wall = time.perf_counter() - t0
        launches = A.launch_counts()
        stats = predictor.stats()
        ttft = [t for t in predictor.last_ttft_s if t is not None]
        predictor.stop()
        for h in hooks:
            h.remove()
        del predictor
        gcollect.collect()
        torch.cuda.empty_cache()
        for k, n in launches.items():
            serve_launches[k] += n
        ref_model = load_lm_artifact(art, dev, ragged_decode=True, kv_cache_dtype=kv)
        plain = _moe_forced_run(torch, ref_model, prompts, got, got_calls, dev)
        fp32 = _moe_forced_run(torch, ref_model.clone(dtype="float32"), prompts, got, got_calls,
                               dev)
        del ref_model
        gcollect.collect()
        torch.cuda.empty_cache()
        chk = _moe_check(torch, got, got_taps, got_calls, plain, fp32)
        kernels = ("flash_fwd", "decode_attention") if kv is None else ("decode_attention_q8",)
        print(f"phase 13 (d) MoE serving, {name} cache (LMEnginePredictor, 4 slots, phase 4's "
              f"{len(prompts)} greedy requests): {chk['tokens']} tokens in {wall:.2f} s; "
              f"TTFT p50 {statistics.median(ttft) * 1e3:.1f} ms, decode "
              f"{stats['decode_tokens'] / stats['decode_s']:.1f} tokens/s, admission waves "
              f"{stats['admission_waves']}; against the plain attention teacher-forced to the "
              f"served tokens and routing over {len(got_calls)} calls: tokens held "
              f"{chk['held']} of {chk['tokens']}; per token |served - fp32|inf / |plain bf16 - "
              f"fp32|inf p50, p99, max {['%.3f' % x for x in chk['ratios_q']]} (bounds: p50 "
              f"{MOE_MEDIAN_REL}, each {MOE_TOKEN_REL}), |served - plain bf16|inf / |plain bf16 - fp32|inf "
              f"{['%.3f' % x for x in chk['direct_q']]}; near ties "
              f"{len(chk['near_ties'])}"
              + (" (" + "; ".join(chk["near_ties"]) + ")" if chk["near_ties"] else "")
              + f"; router flips the forced runs would make: bf16 {chk['flips']['bf16']} (widest "
              f"margin {chk['margin']['bf16']:.2e}, bound {ROUTER_MARGIN}), fp32 "
              f"{chk['flips']['fp32']} (widest {chk['margin']['fp32']:.2e}); launches { {k: n for k, n in launches.items() if n} }; "
              f"card {card_line}", flush=True)
        if chk["bad"]:
            raise AssertionError(f"phase 13 (d) {name}: {len(chk['bad'])} tokens not held: "
                                 + "; ".join(chk["bad"][:10]))
        missing = [k for k in kernels if not launches[k]]
        if missing:
            raise AssertionError(f"phase 13 (d) {name}: {missing} never launched: {launches}")
    marks["(d) serving"] = time.perf_counter()
    stamps = list(marks.values())
    print("phase 13 seconds by part: " + ", ".join(
        f"{k} {b - a:.1f}" for k, a, b in zip(list(marks)[1:], stamps, stamps[1:])), flush=True)
    moe = {k: moe_train.get(k, 0) + serve_launches.get(k, 0) for k in serve_launches}
    (work / "result.json").write_text(json.dumps({"sp": sp_launches, "moe": moe}))
    return 0


def _train_moe(torch, params, tokens, dev, seed: int, work: Path, A) -> dict:
    """Phase 13 (d)'s training: ``MOE_STEPS`` steps of the MoE LM, timed
    after the first (their kernel launches in ``launches``), then one
    step under ``diagnostics.trace``."""
    import gc as gcollect

    from hops_tpu_torch.models.common import create_train_state
    from hops_tpu_torch.models.moe import MoEMLP, sum_sown_losses
    from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
    from hops_tpu_torch.runtime import diagnostics

    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(**MOE_TRAIN, device=dev).load_flax(params)
    try:
        state = create_train_state(model, seed=seed, learning_rate=LEARNING_RATE)
        step = make_lm_train_step(loss_chunk=LOSS_CHUNK)
        batch = {"tokens": tokens}
        losses = []
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MOE_STEPS - 1):
            state, m = step(state, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) / (MOE_STEPS - 1)
        launches = A.launch_counts()
        aux = float(torch.as_tensor(sum_sown_losses(model)).detach())
        peak = torch.cuda.max_memory_allocated() / 2**30
        with diagnostics.trace(str(work / "moe_trace")) as target:
            step(state, batch)
        experts = sum(m.w_in.numel() + m.w_out.numel() for m in model.modules()
                      if isinstance(m, MoEMLP))
        hidden = next(m.w_in.shape[2] for m in model.modules() if isinstance(m, MoEMLP))
    finally:
        del model
        state = None
        gcollect.collect()
        torch.cuda.empty_cache()
    n_tok = tokens.shape[0] * TRAIN_SEQ
    capacity = max(1, int(1.25 * n_tok * MOE_TRAIN["moe_top_k"] / MOE_TRAIN["num_experts"]))
    kind = torch.cuda.get_device_name(0)
    return {
        "losses": [float(x) for x in losses], "aux": aux, "ms": elapsed * 1e3, "launches": launches,
        "tokens_s": n_tok / elapsed, "peak_gib": peak, "experts": experts, "hidden": hidden,
        "report": diagnostics.roofline_report(target, *diagnostics.device_peaks(kind)),
        "share": _trace_share(target, n_tok, (capacity, capacity * MOE_TRAIN["num_experts"]), 1),
    }


def scaleout_phase(A, torch, art: Path, prompts, seed: int, card_line: str) -> dict[str, dict]:
    """Phase 13; returns the launch counts of its sp and moe paths. The
    whole phase runs in a child process (its own NCCL group of one rank)
    started through the launch CLI; its lines are printed here."""
    import subprocess

    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.modelrepo.serving import save_lm_artifact

    t_phase = time.perf_counter()
    work = ROOT / "_smoke" / "scaleout"
    work.mkdir(parents=True, exist_ok=True)
    save_lm_artifact(work / "moe_artifact", MOE_SERVE, random_params(**MOE_SERVE, seed=seed))
    (work / "spec.json").write_text(json.dumps({
        "params": str(art / "params.npz"), "moe_artifact": str(work / "moe_artifact"),
        "seed": seed, "work": str(work), "card": card_line,
        "prompts": [list(map(int, p)) for p in prompts]}))
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "hops_tpu_torch.launch", "--coordinator",
           f"127.0.0.1:{_free_port()}", "--num-processes", "1", "--process-id", "0",
           str(ROOT / "chip_smoke.py"), "--scaleout-worker", str(work / "spec.json")]
    proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith(("phase 13", "  ")):
            print(line, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"phase 13 worker exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    res = json.loads((work / "result.json").read_text())
    shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    print(f"phase 13 took {phase_s:.1f} s (budget {PHASE13_BUDGET_S:.0f} s); launches of the "
          f"sp path { {k: n for k, n in res['sp'].items() if n} }, of the moe path "
          f"{ {k: n for k, n in res['moe'].items() if n} }", flush=True)
    if phase_s > PHASE13_BUDGET_S:
        raise AssertionError(f"phase 13 took {phase_s:.1f} s, over {PHASE13_BUDGET_S:.0f} s")
    return res


# Phase 14: two ranks on the one card in a gloo group (NCCL refuses two
# ranks on one card); CUDA tensors cross ranks through host buffers.
PHASE14_BUDGET_S = 300.0
TP_CACHES = (("dense", {"slots": 4}, ("flash_fwd", "decode_attention")), *CACHE_SLICES)
TP_GEN_ROWS, TP_GEN_PROMPT, TP_GEN_NEW = 4, 16, 16  # the shortest prompt has 16 tokens
# (a) serves phase 4's first TP_REQUESTS requests on each cache (one
# admission wave); (b) and (c) train PP_STEPS and SHARDED_STEPS steps.
# Cut from 8 requests and 3 steps each to hold the script's time.
TP_REQUESTS = 4
PP_MICRO, PP_STEPS, PP_GRAD_MICRO = 4, 2, 2
SHARDED_STEPS = 2


def model_parallel_worker(spec_path: str, rank: int) -> int:
    """Phase 14, in one of the two child processes: joins the gloo group
    of two ranks on the card, then (a) serves phase 4's artifact
    tensor-parallel, (b) trains phase 7's LM through the pipeline, (c)
    trains it under ``ShardedStrategy(model=2)``. Both ranks hold their
    results to each other; rank 0 holds them to the one-rank references
    and writes ``result.json`` beside the spec."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from hops_tpu_torch.models.common import create_train_state, cross_entropy_loss
    from hops_tpu_torch.models.convert import load_npz
    from hops_tpu_torch.models.generation import generate
    from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
    from hops_tpu_torch.modelrepo.lm_engine import LMEngine
    from hops_tpu_torch.ops import attention as A
    from hops_tpu_torch.parallel import ShardedStrategy, mesh as mesh_lib
    from hops_tpu_torch.parallel import pipeline as pp
    from hops_tpu_torch.parallel.tp_inference import tp_generate
    from hops_tpu_torch.telemetry.metrics import REGISTRY

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(spec_path).read_text())
    work = Path(spec["work"])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                            world_size=2, rank=rank)
    dev = torch.device(spec.get("device", "cuda:0"))
    params = load_npz(spec["params"])
    seed = int(spec["seed"])
    prompts, answers = spec["prompts"], spec["answers"]
    host = REGISTRY.counter("hops_tpu_gloo_host_bytes_total")
    out: dict = {"backend": dist.get_backend(), "rank": rank, "errors": [], "host_bytes": {},
                 "launches": {}}
    lines: list[str] = []

    def say(line: str) -> None:
        lines.append(line)
        if rank == 0:
            print(line, flush=True)

    def same_on_both(value, what: str) -> None:
        got = [None, None]
        dist.all_gather_object(got, value)
        if got[0] != got[1]:
            raise AssertionError(f"{what}: the two ranks differ")

    def held(check, what: str) -> None:
        """Rank 0's check against a one-rank reference; a failure is
        recorded (the other rank carries on to the next collective)."""
        if rank:
            return
        try:
            check()
        except AssertionError as e:
            out["errors"].append(f"{what}: {e}")

    def host_mark() -> float:
        return host.value()

    mesh = mesh_lib.make_mesh({"model": 2})
    plain_model = TransformerLM(**MODEL, device=dev).load_flax(params)

    # (a) tensor-parallel serving on four caches.
    t_a = time.perf_counter()
    tp_launch = {k: 0 for k in A.launch_counts()}
    for name, cfg, kernels in TP_CACHES:
        model = TransformerLM(**MODEL, ragged_decode=True, device=dev,
                              kv_cache_dtype=cfg.get("kv_cache_dtype")).load_flax(params)
        engine = LMEngine(model, slots=cfg["slots"], mesh=mesh, device=dev,
                          kv_page_size=cfg.get("kv_page_size"),
                          kv_pool_blocks=cfg.get("kv_pool_blocks"),
                          prefill_chunk=cfg.get("prefill_chunk"))
        del model
        b0 = host_mark()
        served = prompts[:TP_REQUESTS]
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        tickets = [engine.submit(p, max_new_tokens=n) for p, n in zip(served, NEW_TOKENS)]
        res = engine.run()
        wall = time.perf_counter() - t0
        launches = A.launch_counts()
        for k, n in launches.items():
            tp_launch[k] += n
        stats = engine.stats()
        streams = [res[t] for t in tickets]
        ttft = sorted(engine.ttft_s[t] for t in tickets)
        same_on_both(streams, f"phase 14 (a) {name} streams")
        missing = [k for k in kernels if not launches[k]]
        if missing:
            raise AssertionError(f"phase 14 (a) {name}: {missing} never launched: {launches}")
        shards = engine._cache.k[0].shape
        say(f"phase 14 (a) tp=2 {name}: streams identical on both ranks; launches on this rank "
            f"{', '.join(f'{k} {launches[k]}' for k in kernels)}; per-rank cache "
            f"{tuple(shards)}; ttft p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms; decode "
            f"{stats['decode_tokens'] / stats['decode_s']:.1f} tokens/s; wall {wall:.3f} s; "
            f"{(host_mark() - b0) / 2**20:.1f} MiB through the host (gloo)")
        want = (answers if name == "dense" else spec["cache_answers"][name])[:TP_REQUESTS]

        def check(streams=streams, want=want, served=served, name=name):
            notes = near_ties(plain_model, torch, served, streams, want, dev,
                              f"phase 14 (a) {name}")
            say(f"  {name}: {len(notes)} of {len(streams)} streams leave the one-rank "
                f"{'phase 4' if name == 'dense' else 'phase 8'} stream, each at a near tie"
                + (f" ({'; '.join(notes)})" if notes else ""))

        held(check, f"(a) {name}")
        out.setdefault("serving", {})[name] = {
            "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
            "decode_tok_s": stats["decode_tokens"] / stats["decode_s"], "wall_s": wall}
        del engine
        torch.cuda.empty_cache()
    rows = torch.tensor([p[:TP_GEN_PROMPT] for p in prompts[:TP_GEN_ROWS]], device=dev)
    A.reset_launch_counts()
    tp_tokens = tp_generate(plain_model, rows, mesh, max_new_tokens=TP_GEN_NEW,
                            temperature=0.0).tolist()
    for k, n in A.launch_counts().items():
        tp_launch[k] += n
    one = generate(plain_model, rows, max_new_tokens=TP_GEN_NEW, temperature=0.0,
                   device=dev).tolist()
    same_on_both(tp_tokens, "phase 14 (a) tp_generate")

    def check_generate():
        got = [t[TP_GEN_PROMPT:] for t in tp_tokens]
        want = [t[TP_GEN_PROMPT:] for t in one]
        notes = near_ties(plain_model, torch, [p[:TP_GEN_PROMPT] for p in prompts], got, want,
                          dev, "phase 14 (a) tp_generate")
        say(f"phase 14 (a) tp_generate of {TP_GEN_ROWS} prompts of {TP_GEN_PROMPT} tokens, "
            f"{TP_GEN_NEW} new: {TP_GEN_ROWS - len(notes)} of {TP_GEN_ROWS} rows equal one-rank "
            "generate" + (f", the rest at near ties ({'; '.join(notes)})" if notes else ""))

    held(check_generate, "(a) tp_generate")
    out["launches"]["tp_serving"] = tp_launch
    out["a_s"] = time.perf_counter() - t_a
    del plain_model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) pipeline parallelism: phase 7b's gradient rule at 2 layers, then
    # phase 7's LM trained at pp=2 on the ring and on 1f1b.
    t_b = time.perf_counter()
    stage_mesh = mesh_lib.make_mesh({"stage": 2})
    small = dict(TRAIN, num_layers=2)
    params2 = {n: a for n, a in params.items()
               if not n.startswith("block_") or int(n.split("/")[0][6:]) < 2}
    ppm = TransformerLM(**small, device=dev).load_flax(params2)
    sums = None
    if rank == 0:
        ref32 = TransformerLM(**dict(small, dtype="float32", attention_impl="reference"),
                              device=dev).load_flax(params2)
        plain16 = ref32.clone(dtype="bfloat16")
    for i in range(GRAD_SEEDS):
        tokens = torch.from_numpy(np.random.default_rng(seed + 3 + i).integers(
            0, TRAIN["vocab_size"], (GRAD_BATCH, TRAIN_SEQ + 1))).to(dev)
        ppm.zero_grad(set_to_none=True)
        pp.lm_loss_and_grads(ppm, tokens, stage_mesh, num_microbatches=PP_GRAD_MICRO)
        if rank == 0:
            got = [p.grad for p in ppm.parameters()]
            refs = []
            for m in (ref32, plain16):
                loss = cross_entropy_loss(m(tokens[:, :-1]), tokens[:, 1:])
                refs.append(torch.autograd.grad(loss, list(m.parameters())))
            part = torch.stack([torch.stack([(g - r).double().square().sum(),
                                             (q - r).double().square().sum()])
                                for g, q, r in zip(got, refs[1], refs[0])]).cpu()
            sums = part if sums is None else sums + part
    if rank == 0:
        names = [n for n, _ in ppm.named_parameters()]
        dk, dp = sums.sqrt().T.tolist()
        ratios = [a / b if b else (0.0 if a == 0 else math.inf) for a, b in zip(dk, dp)]
        j = max(range(len(ratios)), key=ratios.__getitem__)
        say(f"phase 14 (b) pp=2 gradients at 2 layers ({GRAD_SEEDS} batches of {GRAD_BATCH} x "
            f"{TRAIN_SEQ}, {PP_GRAD_MICRO} microbatches): ||pp - plain fp32||_2 / ||plain bf16 - "
            f"plain fp32||_2 worst {ratios[j]:.3f} ({names[j]}; bound {BF16_VS_PLAIN}), median "
            f"{sorted(ratios)[len(ratios) // 2]:.3f}")
        bad = [f"{n} {x:.3f}" for n, x in zip(names, ratios) if not x <= BF16_VS_PLAIN]
        if bad:
            out["errors"].append(f"(b) pp gradients over {BF16_VS_PLAIN} x the plain bf16 "
                                 f"path's distance: {', '.join(bad)}")
        del ref32, plain16
    del ppm
    gc.collect()
    torch.cuda.empty_cache()
    batch = {"tokens": torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, TRAIN["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ + 1))).to(dev)}
    bubble = REGISTRY.gauge("hops_tpu_pp_bubble_fraction", labels=("schedule",))
    pp_runs = {}
    pp_launch = {k: 0 for k in A.launch_counts()}
    for schedule in (None, "1f1b"):
        model = TransformerLM(**TRAIN, device=dev).load_flax(params)
        state = create_train_state(model, seed=seed, learning_rate=LEARNING_RATE)
        step = pp.make_pp_lm_train_step(model, stage_mesh, num_microbatches=PP_MICRO,
                                        schedule=schedule)
        losses, times, counts = [], [], []
        b0 = host_mark()
        for _ in range(PP_STEPS):
            torch.cuda.synchronize()
            A.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts.append(A.launch_counts())
        for c in counts:
            for k, n in c.items():
                pp_launch[k] += n
        per = TRAIN["num_layers"] // 2 * PP_MICRO
        for k in TRAIN_KERNELS:
            if any(c[k] != per for c in counts):
                raise AssertionError(f"phase 14 (b) {schedule}: {k} launched "
                                     f"{[c[k] for c in counts]} times a step, not {per}")
        label = schedule or "ring"
        pp_runs[label] = losses
        extra = (f"; bubble gauge {bubble.value(schedule=schedule):.4f}" if schedule else "")
        say(f"phase 14 (b) pp=2 {label}: batch {TRAIN_BATCH} x {TRAIN_SEQ}, {PP_MICRO} "
            f"microbatches, losses {losses}; step ms {[round(t, 3) for t in times]} (median "
            f"{sorted(times)[len(times) // 2]:.3f}, gloo over the host); K1-K3 {per} launches a "
            f"step on this rank; {(host_mark() - b0) / 2**20 / PP_STEPS:.1f} MiB a step through "
            f"the host{extra}")
        out.setdefault("pp", {})[label] = {"losses": losses, "step_ms": times}
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
    same_on_both(pp_runs, "phase 14 (b) losses")
    if pp_runs["1f1b"] != pp_runs["ring"]:
        raise AssertionError(f"phase 14 (b): 1f1b losses {pp_runs['1f1b']} are not the ring's "
                             f"{pp_runs['ring']} bit for bit")
    if not pp_runs["ring"][-1] < pp_runs["ring"][0]:
        raise AssertionError(f"phase 14 (b): the loss did not fall: {pp_runs['ring']}")

    def check_dense():
        model = TransformerLM(**TRAIN, device=dev).load_flax(params)
        state = create_train_state(model, seed=seed, learning_rate=LEARNING_RATE)
        step = make_lm_train_step()
        dense = [float(step(state, batch)[1]["loss"]) for _ in range(PP_STEPS)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(pp_runs["ring"], dense))
        say(f"phase 14 (b) one-rank dense step (the same loss, weights, batch and Adam): losses "
            f"{dense}; pp's largest relative distance {rel:.2e} (bound {FSDP_LOSS_REL:.0e})")
        if not rel <= FSDP_LOSS_REL:
            raise AssertionError(f"pp losses {pp_runs['ring']} vs dense {dense}")

    held(check_dense, "(b) dense")
    dist.barrier()
    out["launches"]["pp"] = pp_launch
    out["b_s"] = time.perf_counter() - t_b
    gc.collect()
    torch.cuda.empty_cache()

    # (c) ShardedStrategy(model=2): the Megatron layout of phase 7's LM.
    t_c = time.perf_counter()
    st = ShardedStrategy(model=2, device=dev)
    model = TransformerLM(**TRAIN, device=dev).load_flax(params)
    state = st.shard_state(create_train_state(model, seed=seed,
                                              learning_rate=LEARNING_RATE))
    step = st.step(make_lm_train_step(loss_chunk=LOSS_CHUNK))
    local = st.distribute_batch(batch)
    losses, times = [], []
    A.reset_launch_counts()
    b0 = host_mark()
    for _ in range(SHARDED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, local)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = A.launch_counts()
    out["launches"]["sharded"] = launches
    heads = state.model.block_0.attn.num_heads
    same_on_both(losses, "phase 14 (c) losses")
    for k in TRAIN_KERNELS:
        if launches[k] != TRAIN["num_layers"] * SHARDED_STEPS:
            raise AssertionError(f"phase 14 (c): {k} launched {launches[k]} times in "
                                 f"{SHARDED_STEPS} steps")
    ref = spec["phase7_losses"][:SHARDED_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    say(f"phase 14 (c) ShardedStrategy(model=2) {st.mesh.shape}: {heads} heads a rank; losses "
        f"{losses} against phase 7's {ref} (largest relative distance {rel:.2e}, bound "
        f"{FSDP_LOSS_REL:.0e}); step ms {[round(t, 3) for t in times]} (gloo over the host); "
        f"{(host_mark() - b0) / 2**20 / SHARDED_STEPS:.1f} MiB a step through the host")
    if not rel <= FSDP_LOSS_REL or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 14 (c): losses {losses} vs phase 7's {ref}")
    out["sharded"] = {"losses": losses, "step_ms": times}
    out["c_s"] = time.perf_counter() - t_c
    out["host_bytes_total"] = host_mark()
    dist.barrier()
    (work / f"result{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def model_parallel_phase(A, torch, art: Path, prompts, answers, cache_answers, seed: int,
                         card_line: str, phase7: dict) -> dict[str, dict]:
    """Phase 14; returns the launch counts of rank 0's tp and pp paths.
    Starts two children of this script on the card, ranks 0 and 1 of a
    gloo group, and prints rank 0's lines."""
    import subprocess

    t_phase = time.perf_counter()
    work = ROOT / "_smoke" / "model_parallel"
    work.mkdir(parents=True, exist_ok=True)
    (work / "spec.json").write_text(json.dumps({
        "params": str(art / "params.npz"), "seed": seed, "work": str(work),
        "port": _free_port(), "prompts": [list(map(int, p)) for p in prompts],
        "answers": answers, "cache_answers": cache_answers,
        "phase7_losses": phase7["losses"]}))
    torch.cuda.empty_cache()
    cmds = [[sys.executable, str(ROOT / "chip_smoke.py"), "--model-parallel-worker",
             str(work / "spec.json"), "--rank", str(r)] for r in range(2)]
    logs = [(open(work / f"out{r}.txt", "w"), open(work / f"err{r}.txt", "w")) for r in range(2)]
    procs = [subprocess.Popen(c, cwd=str(ROOT), stdout=o, stderr=e, text=True)
             for c, (o, e) in zip(cmds, logs)]
    deadline = time.monotonic() + PHASE14_BUDGET_S + 300
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                time.sleep(5)  # the other rank's group notices the closed peer
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for o, e in logs:
            o.close()
            e.close()
    outs = [((work / f"out{r}.txt").read_text(), (work / f"err{r}.txt").read_text())
            for r in range(2)]
    for line in outs[0][0].splitlines():
        if line.startswith(("phase 14", "  ")):
            print(line, flush=True)
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"phase 14 rank {r} exited {p.returncode}:\n{so[-3000:]}\n"
                                 f"{se[-6000:]}")
    res = [json.loads((work / f"result{r}.json").read_text()) for r in range(2)]
    shutil.rmtree(work, ignore_errors=True)
    errors = res[0]["errors"]
    if errors:
        raise AssertionError("phase 14: " + "; ".join(errors))
    phase_s = time.perf_counter() - t_phase
    tp = {k: res[0]["launches"]["tp_serving"].get(k, 0) + res[0]["launches"]["sharded"].get(k, 0)
          for k in res[0]["launches"]["tp_serving"]}
    print(f"phase 14 took {phase_s:.1f} s (budget {PHASE14_BUDGET_S:.0f} s; (a) "
          f"{res[0]['a_s']:.1f} s, (b) {res[0]['b_s']:.1f} s, (c) {res[0]['c_s']:.1f} s); "
          f"backend {res[0]['backend']}, two ranks on one card, "
          f"{res[0]['host_bytes_total'] / 2**30:.2f} GiB (rank 0) and "
          f"{res[1]['host_bytes_total'] / 2**30:.2f} GiB (rank 1) through host buffers; "
          f"launches on rank 0 of the tp path { {k: n for k, n in tp.items() if n} }, of the "
          f"pp path { {k: n for k, n in res[0]['launches']['pp'].items() if n} }; "
          f"card {card_line}", flush=True)
    if phase_s > PHASE14_BUDGET_S:
        raise AssertionError(f"phase 14 took {phase_s:.1f} s, over {PHASE14_BUDGET_S:.0f} s")
    return {"tp": tp, "pp": res[0]["launches"]["pp"]}


PHASE15_BUDGET_S = 180.0
SEARCH_ROWS = 64  # packed rows of TRAIN_SEQ + 1 tokens in phase 15's RecordIO file
SEARCH_LOADER = dict(num_workers=2, queue_depth=4, reuse_buffers=True)
SEARCH_BATCHES = 16  # (a): batches held to the host stream
SEARCH_LRS = (1e-3, 3e-4)
SEARCH_WARMUP, SEARCH_STEPS = 2, 4
LAGOM_LM = dict(TRAIN, num_layers=2)
LAGOM_LRS = (1e-3, 3e-4, 1.0)
LAGOM_STEPS = 12
# A trial thread's first cuBLAS call takes a workspace for its handle
# (CUBLAS_WORKSPACE_CONFIG ":4096:8", 32 MiB; cuBLAS and cuBLASLt): the
# only device memory a returned trial may leave behind.
TRIAL_WORKSPACE_BYTES = 2 * 8 * 4096 * 1024


def search_phase(A, torch, np, params, dev, seed: int, card_line: str) -> dict[str, int]:
    """Phase 15; returns K1-K3's launches in the search trials ((b) and (c))."""
    import gc
    import warnings

    from hops_tpu_torch import experiment, native
    from hops_tpu_torch.experiment import registry
    from hops_tpu_torch.featurestore.feed import pack_documents
    from hops_tpu_torch.featurestore.loader import DataLoader, RecordIOSource
    from hops_tpu_torch.models.common import create_train_state
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
    from hops_tpu_torch.native import recordio
    from hops_tpu_torch.runtime import config, devices
    from hops_tpu_torch.search import GridSearch, Searchspace, TrialStopped, drivers
    from hops_tpu_torch.telemetry.metrics import REGISTRY

    t_phase = time.perf_counter()
    work = ROOT / "_smoke" / "search"
    work.mkdir(parents=True, exist_ok=True)
    config.configure(workspace=str(work / "workspace"), project="chip_smoke")

    # (a) seeded documents, packed and written by the native writer, read
    # back through the loader onto the card.
    rng = np.random.default_rng(seed + 15)
    row = TRAIN_SEQ + 1
    docs, n_tokens = [], 0
    while n_tokens < SEARCH_ROWS * row:
        docs.append(rng.integers(1, TRAIN["vocab_size"], int(rng.integers(64, 4096))))
        n_tokens += len(docs[-1]) + 1
    rows = pack_documents(docs, seq_len=TRAIN_SEQ, eos_id=0)[:SEARCH_ROWS]
    path = work / "tokens.rio"
    with recordio.RecordWriter(path) as w:
        for r in rows:
            w.write(r.astype(np.int32).tobytes())
    with recordio.RecordReader(path) as r:
        backend = "native" if r._lib is not None else "pure Python"
        if r._lib is None or len(r) != SEARCH_ROWS:
            raise AssertionError(f"phase 15 (a): {len(r)} records read by the {backend} "
                                 f"reader (the native library must read them; built: "
                                 f"{native.available()})")

    def decode(raw: bytes) -> dict:
        return {"tokens": np.frombuffer(raw, np.int32)}

    def loader(name: str, **kw) -> DataLoader:
        return DataLoader(RecordIOSource([path], decode=decode), TRAIN_BATCH, num_epochs=None,
                          seed=seed, name=name, **{**SEARCH_LOADER, **kw})

    host = [b["tokens"].copy() for _, b in zip(range(SEARCH_BATCHES),
                                                loader("smoke-host", num_workers=0,
                                                       reuse_buffers=False))]
    depth = REGISTRY.gauge("hops_tpu_feed_prefetch_depth", labels=("pipeline",))
    it = loader("smoke-feed").device_iterator(size=2, device=dev)
    got, waits, depths = [], [], []
    for _ in range(SEARCH_BATCHES):
        t0 = time.perf_counter()
        got.append(next(it)["tokens"])
        waits.append(time.perf_counter() - t0)
        depths.append(int(depth.value(pipeline="smoke-feed")))
    it.close()
    torch.cuda.synchronize()
    bad = [i for i, (g, h) in enumerate(zip(got, host))
           if g.device != dev or not torch.equal(g.cpu(), torch.from_numpy(h))]
    if bad:
        raise AssertionError(f"phase 15 (a): batches {bad} on the card differ from the host "
                             "stream")
    print(f"phase 15 (a) loader: {SEARCH_BATCHES} batches of {TRAIN_BATCH} x {row} int32 "
          f"tokens from {SEARCH_ROWS} packed rows in RecordIO, read by the {backend} reader, "
          f"equal the host stream bit for bit on {dev} (workers 2, queue 4, reuse_buffers, "
          f"prefetch 2); consumer wait per batch median "
          f"{statistics.median(waits) * 1e3:.3f} ms, max {max(waits) * 1e3:.3f} ms (the "
          f"first {waits[0] * 1e3:.3f}); prefetch depth {depths}; card {card_line}",
          flush=True)
    del got, host

    # (b) grid_search over the learning rate, the full-width LM in each trial.
    layers = TRAIN["num_layers"]
    steps = SEARCH_WARMUP + SEARCH_STEPS

    def lm_trial(log: dict):
        def train(lr):
            tdev = devices.resolve_device(None)  # the trial's card
            t0 = time.perf_counter()
            torch.cuda.synchronize(tdev)
            start = torch.cuda.memory_allocated(tdev)
            before = A.launch_counts()
            record = _train_trial(lr, tdev)
            torch.cuda.synchronize(tdev)
            record.update(start=start, end=torch.cuda.memory_allocated(tdev),
                          wall_s=time.perf_counter() - t0,
                          launches={k: A.launch_counts()[k] - before[k] for k in TRAIN_KERNELS})
            log[lr] = record
            return {"loss": record["losses"][-1]}
        return train

    def _train_trial(lr, tdev) -> dict:
        model = TransformerLM(**TRAIN, device=tdev).load_flax(params)
        state = create_train_state(model, seed=seed, learning_rate=lr)
        step = make_lm_train_step(loss_chunk=LOSS_CHUNK)
        batches = loader("smoke-trial").device_iterator(size=2)
        losses, waits = [], []
        for i in range(steps):
            if i == SEARCH_WARMUP:
                torch.cuda.synchronize(tdev)
                t0 = time.perf_counter()
            w0 = time.perf_counter()
            batch = next(batches)
            waits.append(time.perf_counter() - w0)
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
        torch.cuda.synchronize(tdev)
        steps_s = time.perf_counter() - t0
        batches.close()
        return dict(losses=[float(x) for x in losses], steps_s=steps_s,
                    waits=waits[SEARCH_WARMUP:])

    def nondeterministic(caught) -> list[str]:
        return sorted({str(w.message).split(" does not have")[0] for w in caught
                       if "deterministic implementation" in str(w.message)})

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        trials: dict = {}
        gc.collect()
        torch.cuda.synchronize()
        A.reset_launch_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            path_b, summary = experiment.grid_search(
                lm_trial(trials), {"lr": list(SEARCH_LRS)}, direction="min",
                optimization_key="loss", name="smoke-grid")
            search_s = time.perf_counter() - t0
        grid_launches = A.launch_counts()
        torch.cuda.synchronize()
        after_b = torch.cuda.memory_allocated()
        nondet = nondeterministic(caught)
        direct: dict = {}
        lm_trial(direct)(lr=SEARCH_LRS[0])  # the same wrapper outside the driver
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    tokens = TRAIN_BATCH * TRAIN_SEQ * SEARCH_STEPS
    for lr in SEARCH_LRS:
        rec = trials[lr]
        print(f"phase 15 (b) grid_search trial lr {lr:g}: losses "
              f"{[round(x, 5) for x in rec['losses']]}; step "
              f"{rec['steps_s'] / SEARCH_STEPS * 1e3:.3f} ms (mean of {SEARCH_STEPS} after "
              f"{SEARCH_WARMUP} warm-up), {tokens / rec['steps_s']:.1f} tokens/s; loader wait "
              f"per step median {statistics.median(rec['waits']) * 1e3:.3f} ms; trial wall "
              f"{rec['wall_s']:.3f} s; allocated at its start {rec['start']} B, after it "
              f"returned {rec['end']} B; launches {rec['launches']}; card {card_line}",
              flush=True)
    errors = _search_records(path_b, summary, "smoke-grid", len(SEARCH_LRS))
    for lr, rec in trials.items():
        if not all(math.isfinite(x) for x in rec["losses"]):
            errors.append(f"trial lr {lr:g} has a loss that is not finite: {rec['losses']}")
        for name in TRAIN_KERNELS:
            if rec["launches"][name] != layers * steps:
                errors.append(f"trial lr {lr:g}: {name} launched {rec['launches'][name]} "
                              f"times in {steps} steps, not {layers} a step")
    best = min(trials, key=lambda lr: trials[lr]["losses"][-1])
    if summary["best_config"] != {"lr": best}:
        errors.append(f"best_config {summary['best_config']}, but lr {best:g} has the lowest "
                      "final loss")
    errors += _flat_memory([trials[lr] for lr in SEARCH_LRS] + [direct[SEARCH_LRS[0]]], after_b)
    same = direct[SEARCH_LRS[0]]["losses"] == trials[SEARCH_LRS[0]]["losses"]
    if same:
        print(f"phase 15 (b): the lr {SEARCH_LRS[0]:g} trial's losses equal a direct run of "
              f"the wrapper outside the driver bit for bit; ops without a deterministic "
              f"implementation: {nondet or 'none'}", flush=True)
    else:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            again: dict = {}
            lm_trial(again)(lr=SEARCH_LRS[0])
        finally:
            torch.use_deterministic_algorithms(False)
        want = direct[SEARCH_LRS[0]]["losses"]
        d_trial = max(abs(a - b) for a, b in zip(trials[SEARCH_LRS[0]]["losses"], want))
        d_direct = max(abs(a - b) for a, b in zip(again[SEARCH_LRS[0]]["losses"], want))
        print(f"phase 15 (b): the lr {SEARCH_LRS[0]:g} trial differs from the direct run by "
              f"{d_trial:.3e}, a second direct run by {d_direct:.3e} (largest loss "
              f"difference); ops without a deterministic implementation: {nondet or 'none'}",
              flush=True)
        if not (nondet and d_direct > 0 and d_trial <= 2 * d_direct):
            errors.append("the trial's losses are not within twice the distance of two "
                          "direct runs")
    overhead_b = search_s - sum(rec["wall_s"] for rec in trials.values())
    print(f"phase 15 (b): search wall {search_s:.3f} s, driver overhead {overhead_b:.3f} s "
          f"(wall minus the trials' {sum(r['wall_s'] for r in trials.values()):.3f} s); "
          f"allocated after the search {after_b} B; launches "
          f"{ {k: grid_launches[k] for k in TRAIN_KERNELS} }; card {card_line}", flush=True)
    if errors:
        raise AssertionError("phase 15 (b): " + "; ".join(errors))
    del trials, direct
    gc.collect()
    torch.cuda.empty_cache()

    # (c) lagom with an explicit grid at 2 layers: heartbeats over RPC, the
    # diverging trial stopped early at a step boundary.
    small = random_params(**LAGOM_LM, seed=seed)
    lagom_log: dict = {}
    heartbeats: list = []

    def lagom_trial(lr, reporter):
        tdev = devices.resolve_device(None)
        t0 = time.perf_counter()
        torch.cuda.synchronize(tdev)
        start = torch.cuda.memory_allocated(tdev)
        before = A.launch_counts()
        rec = {"losses": [], "step_s": [], "start": start}
        lagom_log[lr] = rec
        stopped = False
        try:
            _lagom_steps(lr, reporter, tdev, rec)
        except TrialStopped:
            stopped = True  # raised again below, once the steps' frames are gone
        torch.cuda.synchronize(tdev)
        rec.update(end=torch.cuda.memory_allocated(tdev), wall_s=time.perf_counter() - t0,
                   launches={k: A.launch_counts()[k] - before[k] for k in TRAIN_KERNELS})
        if stopped:
            raise TrialStopped(reporter.trial_id)
        return {"loss": rec["losses"][-1]}

    def _lagom_steps(lr, reporter, tdev, rec) -> None:
        model = TransformerLM(**LAGOM_LM, device=tdev).load_flax(small)
        state = create_train_state(model, seed=seed, learning_rate=lr)
        step = make_lm_train_step(loss_chunk=LOSS_CHUNK)
        batches = loader("smoke-lagom").device_iterator(size=2)
        try:
            for i in range(LAGOM_STEPS):
                t0 = time.perf_counter()
                state, metrics = step(state, next(batches))
                loss = float(metrics["loss"])  # the step's end: its loss on the host
                rec["step_s"].append(time.perf_counter() - t0)
                rec["losses"].append(loss)
                # The median rule cannot rank a NaN: a diverged loss is
                # reported as the worst value.
                reporter.broadcast(metric=loss if math.isfinite(loss) else math.inf, step=i)
        finally:
            batches.close()

    real_heartbeat = drivers.TrialDriver._on_heartbeat

    def counted(self, trial_id, step, metric):
        heartbeats.append((trial_id, step))
        return real_heartbeat(self, trial_id, step, metric)

    drivers.TrialDriver._on_heartbeat = counted
    try:
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        summary_c = experiment.lagom(
            lagom_trial, searchspace=Searchspace(lr=("DISCRETE", list(LAGOM_LRS))),
            optimizer=GridSearch({"lr": list(LAGOM_LRS)}, "min"), direction="min",
            name="smoke-lagom", es_min=2, hb_interval=0, es_interval=0.05)
        lagom_s = time.perf_counter() - t0
        lagom_launches = A.launch_counts()
        torch.cuda.synchronize()
        after_c = torch.cuda.memory_allocated()
    finally:
        drivers.TrialDriver._on_heartbeat = real_heartbeat
    errors = _search_records(summary_c["path"], summary_c, "smoke-lagom", len(LAGOM_LRS))
    for lr in LAGOM_LRS:
        rec = lagom_log[lr]
        n = len(rec["losses"])
        step_s = statistics.median(rec["step_s"][1:] or rec["step_s"])
        print(f"phase 15 (c) lagom trial lr {lr:g}: {n} of {LAGOM_STEPS} steps, losses "
              f"{[round(x, 4) for x in rec['losses']]}; step {step_s * 1e3:.3f} ms (median "
              f"after the first, each ending in its loss's read-back), "
              f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.1f} tokens/s; trial wall "
              f"{rec['wall_s']:.3f} s; allocated at its start {rec['start']} B, after it "
              f"returned {rec['end']} B; launches {rec['launches']}; card {card_line}",
              flush=True)
        for name in TRAIN_KERNELS:
            if rec["launches"][name] != LAGOM_LM["num_layers"] * n:
                errors.append(f"trial lr {lr:g}: {name} launched {rec['launches'][name]} "
                              f"times in {n} steps")
    stopped = {t["params"]["lr"] for t in summary_c["trials"].values() if t["stopped_early"]}
    if summary_c["early_stopped"] < 1 or LAGOM_LRS[-1] not in stopped:
        errors.append(f"the diverging lr {LAGOM_LRS[-1]:g} trial was not stopped early "
                      f"(stopped: {sorted(stopped)})")
    if len(lagom_log[LAGOM_LRS[-1]]["losses"]) >= LAGOM_STEPS:
        errors.append(f"the lr {LAGOM_LRS[-1]:g} trial ran all {LAGOM_STEPS} steps")
    for lr in LAGOM_LRS[:-1]:
        if len(lagom_log[lr]["losses"]) != LAGOM_STEPS or lr in stopped:
            errors.append(f"trial lr {lr:g} did not run its {LAGOM_STEPS} steps")
    if not heartbeats or {t for t, _ in heartbeats} != set(summary_c["trials"]):
        errors.append(f"heartbeats reached the driver from {sorted({t for t, _ in heartbeats})}"
                      f", not every trial")
    errors += _flat_memory([lagom_log[lr] for lr in LAGOM_LRS], after_c)
    overhead_c = lagom_s - sum(rec["wall_s"] for rec in lagom_log.values())
    print(f"phase 15 (c): {len(heartbeats)} heartbeats reached the driver's RPC server; "
          f"early_stopped {summary_c['early_stopped']} ({sorted(stopped)}); best "
          f"{summary_c['best_config']} at {summary_c['best_metric']:.5f}; search wall "
          f"{lagom_s:.3f} s, driver overhead {overhead_c:.3f} s; allocated after the search "
          f"{after_c} B; launches { {k: lagom_launches[k] for k in TRAIN_KERNELS} }; "
          f"card {card_line}", flush=True)
    if errors:
        raise AssertionError("phase 15 (c): " + "; ".join(errors))
    shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    launches = {k: grid_launches[k] + lagom_launches[k] for k in TRAIN_KERNELS}
    print(f"phase 15 took {phase_s:.1f} s (budget {PHASE15_BUDGET_S:.0f} s); launches of the "
          f"search path {launches}", flush=True)
    if phase_s > PHASE15_BUDGET_S:
        raise AssertionError(f"phase 15 took {phase_s:.1f} s, over {PHASE15_BUDGET_S:.0f} s")
    return launches


def _search_records(path, summary: dict, name: str, n: int) -> list[str]:
    """What a finished search must leave: ``result.json``, a ``trial.json``
    per trial with no error, and the registry's FINISHED record."""
    from hops_tpu_torch.experiment import registry

    errors = []
    path = Path(path)
    if summary["num_trials"] != n or not (path / "result.json").is_file():
        errors.append(f"{summary['num_trials']} trials (want {n}), result.json "
                      f"{(path / 'result.json').is_file()}")
    metas = [json.loads(p.read_text()) for p in sorted(path.glob("trial_*/trial.json"))]
    if len(metas) != n:
        errors.append(f"{len(metas)} trial.json files, not {n}")
    errors += [f"{m['trial_id']} holds an error: {m['error']}" for m in metas if m["error"]]
    runs = registry.list_runs(name)
    if not runs or runs[-1]["status"] != "FINISHED":
        errors.append(f"registry holds {[(r['run_id'], r['status']) for r in runs]}")
    return errors


def _flat_memory(records: list[dict], after: int) -> list[str]:
    """Allocated bytes must not grow from trial to trial: each trial, and
    the search as a whole (``after``), leaves what the first trial found,
    bar the trial threads' cuBLAS workspaces (``TRIAL_WORKSPACE_BYTES``)."""
    starts = [r["start"] for r in records]
    ends = [r["end"] for r in records]
    limit = starts[0] + TRIAL_WORKSPACE_BYTES
    if max(starts + ends + [after]) > limit:
        return [f"allocated bytes grow across trials: at their starts {starts}, after them "
                f"{ends}, after the search {after} (limit {limit})"]
    return []


# Phase 16: the feature store on the Chicago-Taxi pipeline
# (examples/taxi_pipeline.py), then the JAX package's recommender scenario
# (examples/feature_serving.py) on its online store: trips -> a validated
# feature group -> a training dataset with splits -> WideAndDeep trained
# through experiment.launch from td.tf_data(...).loader -> write-through
# materialization into the sharded online store -> an HTTP endpoint whose
# requests carry trip IDs only.
PHASE16_BUDGET_S = 120.0
FS_TRIPS = 1_000_000  # a month-scale slice of the Chicago Taxi Trips data's shape
FS_UPDATES = 10_000  # the second commit: updated trips
# The feature order of the training vectors and of the serving join:
# batch_from_vectors(num_dense=3) splits the first three off as dense.
FS_ORDER = ["distance", "fare", "duration", "hour", "weekday", "zone"]
FS_NUM_DENSE = 3
FS_BATCH, FS_EPOCHS, FS_LR = 4096, 2, 1e-2
FS_SHARDS = 4
FS_READBACK = 1000  # trip IDs read back from the online store against the offline rows
FS_CLIENTS, FS_REQUESTS, FS_IDS = 8, 64, 32  # client threads x requests x trip IDs
FS_UNBATCHED_IDS = 256
FS_BATCHING = {"max_batch_size": 256, "timeout_ms": 5}
FS_PREDICTOR = '''
import numpy as np
import torch

from hops_tpu_torch.models.convert import params_from_flax
from hops_tpu_torch.models.widedeep import WideAndDeep, batch_from_vectors

VOCAB, NUM_DENSE, DTYPE, DEVICE = {vocab!r}, {num_dense!r}, {dtype!r}, {device!r}


class Predict:
    def __init__(self, dtype=DTYPE):
        self._model = WideAndDeep(VOCAB, num_dense=NUM_DENSE, dtype=dtype, device=DEVICE)
        self._model.load_state_dict(params_from_flax(__file__.rsplit("/", 1)[0] + "/params.npz"))
        self._model.eval()

    @torch.inference_mode()
    def predict(self, instances):
        out = self._model(batch_from_vectors(instances, num_dense=NUM_DENSE))
        return out.cpu().numpy().tolist()
'''


def synthesize_trips(n: int, seed: int):
    """Chicago-Taxi-shaped trips (``examples/taxi_pipeline.py:29-48``):
    hour, weekday and pickup zone, distance, fare, duration, and the
    label ``big_tipper`` (a tip over 20% of the fare), correlated with
    the hour and the distance."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(seed)
    distance = rng.gamma(2.0, 2.0, n)
    duration = distance * rng.uniform(2, 4, n)
    fare = 3 + 2.2 * distance + rng.normal(0, 1, n).clip(-2, 2)
    df = pd.DataFrame(
        {
            "trip_id": np.arange(n),
            "hour": rng.integers(0, 24, n),
            "weekday": rng.integers(0, 7, n),
            "zone": rng.integers(0, 100, n),
            "distance": distance,
            "fare": fare,
            "duration": duration,
        }
    )
    tip_rate = 0.1 + 0.05 * (df.hour > 18) + 0.02 * (distance > 5) + rng.normal(0, 0.05, n)
    df["big_tipper"] = (tip_rate > 0.15).astype(int)
    return df


@contextlib.contextmanager
def _clocked(module, name: str, acc: dict):
    """``module.name`` wrapped to add its wall seconds to ``acc[name]``
    while the block runs."""
    real = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0

    setattr(module, name, timed)
    try:
        yield acc
    finally:
        setattr(module, name, real)


def _hist_read(REGISTRY, name: str, **labels) -> tuple[list[float], list[float], float]:
    """(bucket bounds with +Inf last, cumulative counts, sum) of one
    labelled child of a histogram of the port's registry."""
    bounds, cum, total = [], [], 0.0
    for n, lab, v in REGISTRY.get(name).samples():
        if all(lab.get(k) == str(x) for k, x in labels.items()):
            if n == "_bucket":
                bounds.append(float(lab["le"]))
                cum.append(v)
            elif n == "_sum":
                total = v
    return bounds, cum, total


def _hist_pcts(before, after) -> str:
    """p50 and p99 of the observations between two ``_hist_read``
    readings, as the bucket bounds that hold them (the histogram's
    resolution)."""
    bounds = after[0]
    cum = [a - b for a, b in zip(after[1], before[1] or [0.0] * len(after[1]))]
    out = []
    for q in (0.5, 0.99):
        le = next(le for le, c in zip(bounds, cum) if c >= q * cum[-1])
        out.append(f"<= {le * 1e3:g} ms" if math.isfinite(le) else "> 60 s")
    return f"p50 {out[0]}, p99 {out[1]} ({int(cum[-1])} observations)"


def feature_phase(A, torch, np, dev, seed: int, card_line: str) -> None:
    """Phase 16; raises on a failed check. WideAndDeep launches no
    hand-written kernel (cuBLAS and the embedding gathers): the launch
    counts over the phase are printed, and must stay 0."""
    import importlib.util

    import pandas as pd

    import hops_tpu_torch.featurestore as hsfs
    from hops_tpu_torch import experiment
    from hops_tpu_torch.featurestore import statistics as stats_mod
    from hops_tpu_torch.featurestore import validation as val_mod
    from hops_tpu_torch.featurestore.online_serving import Materializer, ShardedOnlineStore
    from hops_tpu_torch.featurestore.validation import Rule
    from hops_tpu_torch.messaging import pubsub
    from hops_tpu_torch.models.common import cross_entropy_loss
    from hops_tpu_torch.models.convert import params_to_flax, save_npz
    from hops_tpu_torch.models.widedeep import WideAndDeep
    from hops_tpu_torch.modelrepo import serving
    from hops_tpu_torch.native import kvstore
    from hops_tpu_torch.runtime import config
    from hops_tpu_torch.telemetry.metrics import REGISTRY

    t_phase = time.perf_counter()
    A.reset_launch_counts()
    work = ROOT / "_smoke" / "featurestore"
    work.mkdir(parents=True, exist_ok=True)
    config.configure(workspace=str(work / "workspace"), project="chip_smoke")
    fs = hsfs.connection().get_feature_store()

    # (a) feature engineering: a validated, versioned feature group with
    # statistics, a second commit, time travel, a training dataset.
    trips = synthesize_trips(FS_TRIPS, seed)
    exp = fs.create_expectation("fare_positive", features=["fare"], rules=[
        Rule(name="HAS_MIN", level="ERROR", min=0)]).save()
    fg = fs.create_feature_group(
        "taxi_trips", version=1, primary_key=["trip_id"], expectations=[exp],
        validation_type="ALL", description="synthetic Chicago-Taxi-shaped trips",
        statistics_config={"enabled": True, "histograms": True, "correlations": True})
    clocks: dict = {}
    with _clocked(stats_mod, "compute_statistics", clocks), \
            _clocked(val_mod, "validate_dataframe", clocks):
        t0 = time.perf_counter()
        fg.save(trips)
        save_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 16)
    updates = synthesize_trips(FS_UPDATES, seed + 1)
    updates["trip_id"] = rng.choice(FS_TRIPS, FS_UPDATES, replace=False)
    t0 = time.perf_counter()
    fg.insert(updates)
    insert_s = time.perf_counter() - t0
    commits = fg.commit_details()
    first, second = (commits[c] for c in commits)
    t0 = time.perf_counter()
    as_of = fg.read(wallclock_time=list(commits)[0])
    as_of_s = time.perf_counter() - t0
    pd.testing.assert_frame_equal(as_of, trips)  # raises: the first commit read back
    report = fg.get_validations()[-1]
    stats = fg.get_statistics()
    td = fs.create_training_dataset("taxi_tips", version=1, data_format="parquet",
                                    splits={"train": 0.8, "test": 0.2}, seed=seed)
    t0 = time.perf_counter()
    td.save(fg.select_all())
    td_s = time.perf_counter() - t0
    offline = fg.read().set_index("trip_id")
    train_df, test_df = td.read("train"), td.read("test")
    print(f"phase 16 (a) feature group taxi_trips v1 ({FS_TRIPS} trips, {len(trips.columns)} "
          f"columns, validation ALL on fare_positive, statistics with histograms and "
          f"correlations): save {save_s:.2f} s, of which statistics "
          f"{clocks['compute_statistics']:.2f} s and validation "
          f"{clocks['validate_dataframe']:.2f} s; second commit of {FS_UPDATES} updated trips "
          f"{insert_s:.2f} s (commits {first['rowsInserted']} inserted, then "
          f"{second['rowsInserted']} inserted / {second['rowsUpdated']} updated); as_of the "
          f"first commit {as_of_s:.2f} s, equal to the first save; validation "
          f"{report['status']}; training dataset taxi_tips v1 (parquet, splits 0.8/0.2) "
          f"materialized in {td_s:.2f} s: train {len(train_df)} rows, test {len(test_df)} "
          f"rows", flush=True)
    if not (first["rowsInserted"] == FS_TRIPS and second["rowsUpdated"] == FS_UPDATES
            and second["rowsInserted"] == 0):
        raise AssertionError(f"phase 16 (a): commit details {commits}")
    if report["status"] != "SUCCESS" or stats["row_count"] != FS_TRIPS:
        raise AssertionError(f"phase 16 (a): validation {report['status']}, statistics over "
                             f"{stats['row_count']} rows")
    if len(train_df) + len(test_df) != FS_TRIPS or len(offline) != FS_TRIPS:
        raise AssertionError(f"phase 16 (a): splits {len(train_df)} + {len(test_df)} rows of "
                             f"{len(offline)}")

    # (b) WideAndDeep trained on the card from the training dataset,
    # through experiment.launch.
    keep: dict = {}

    def train_fn():
        tds = hsfs.connection().get_feature_store().get_training_dataset("taxi_tips", 1)
        feeder = tds.tf_data(target_name="big_tipper", split="train", feature_names=FS_ORDER)
        loader = feeder.loader(FS_BATCH, seed=seed, num_epochs=FS_EPOCHS, name="taxi")
        model = WideAndDeep(TAXI_VOCAB, num_dense=FS_NUM_DENSE, device=dev, seed=seed)
        opt = torch.optim.Adam(model.parameters(), lr=FS_LR)
        rows = tds.read("train")[FS_ORDER].to_numpy(np.float32)[loader._epoch_order(0)[:FS_BATCH]]
        losses, waits, steps = [], [], []
        it = loader.device_iterator(size=2, device=dev)
        while True:
            t0 = time.perf_counter()
            try:
                x, y = next(it)
            except StopIteration:
                break
            waits.append(time.perf_counter() - t0)
            if not steps and not np.array_equal(x.cpu().numpy(), rows):
                raise AssertionError("phase 16 (b): the first batch is not the split's rows in "
                                     f"{FS_ORDER} at the loader's order")
            t0 = time.perf_counter()
            logits = model({"dense": x[:, :FS_NUM_DENSE], "categorical": x[:, FS_NUM_DENSE:]})
            loss = cross_entropy_loss(logits, y)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        keep.update(model=model.eval(), losses=[float(v) for v in losses], waits=waits,
                    steps=steps, per_epoch=loader.steps_per_epoch)
        return {"first": keep["losses"][0], "last": float(np.mean(keep["losses"][-10:]))}

    t0 = time.perf_counter()
    _, metrics = experiment.launch(train_fn, name="taxi_widedeep")
    launch_s = time.perf_counter() - t0
    model, losses = keep["model"], keep["losses"]
    x_test, y_test = td.tf_data(target_name="big_tipper", split="test",
                                feature_names=FS_ORDER).numpy_arrays()
    with torch.inference_mode():
        xt = torch.from_numpy(x_test).to(dev)
        pred = model({"dense": xt[:, :FS_NUM_DENSE], "categorical": xt[:, FS_NUM_DENSE:]})
        acc = float((pred.argmax(1).cpu().numpy() == y_test).mean())
    majority = max(float(y_test.mean()), 1.0 - float(y_test.mean()))
    first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"phase 16 (b) WideAndDeep {TAXI_VOCAB} (embed 8, hidden (128, 64), bf16) through "
          f"experiment.launch from td.tf_data(target_name='big_tipper', split='train', "
          f"feature_names={FS_ORDER}).loader({FS_BATCH}) -> device_iterator(size=2): "
          f"{len(losses)} Adam steps ({FS_EPOCHS} epochs of {keep['per_epoch']}) in "
          f"{launch_s:.2f} s; loss {first10:.4f} -> {last10:.4f} (means of the first and last "
          f"10 steps); step {statistics.median(keep['steps']) * 1e3:.3f} ms (median, host clock "
          f"ending in synchronize()), loader wait per batch median "
          f"{statistics.median(keep['waits']) * 1e3:.3f} ms (first "
          f"{keep['waits'][0] * 1e3:.1f} ms); test accuracy {acc:.4f} over {len(y_test)} rows "
          f"against the majority class's share {majority:.4f}; card {card_line}", flush=True)
    if not (all(math.isfinite(v) for v in losses) and last10 < first10):
        raise AssertionError(f"phase 16 (b): the loss did not fall: {first10} -> {last10}")
    if len(losses) != FS_EPOCHS * keep["per_epoch"] or not acc > majority:
        raise AssertionError(f"phase 16 (b): {len(losses)} steps, test accuracy {acc:.4f} "
                             f"against the majority share {majority:.4f}")
    model_dir = work / "taxi_model"
    model_dir.mkdir()
    save_npz(model_dir / "params.npz", params_to_flax(model))
    (model_dir / "predictor.py").write_text(FS_PREDICTOR.format(
        vocab=TAXI_VOCAB, num_dense=FS_NUM_DENSE, dtype="bfloat16", device=str(dev)))
    del keep, model, xt, pred
    torch.cuda.empty_cache()

    # (c) write-through materialization of the test split into the
    # sharded online store.
    store = ShardedOnlineStore("taxi_trips", 1, primary_key=["trip_id"], shards=FS_SHARDS)
    try:
        topic = pubsub.create_topic("taxi-trips-updates")
        producer = pubsub.Producer(topic)
        t0 = time.perf_counter()
        t_mark = time.time()
        for rec in test_df.to_dict(orient="records"):
            producer.send({**rec, "event_time": t_mark})
        producer.flush()
        producer.close()
        produce_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        daemon = Materializer(store, topic, event_time="event_time").start()
        try:
            drained = daemon.drain(300.0)
        finally:
            daemon.stop()
        mat_s = time.perf_counter() - t0
        lag = store.freshness_lag_s()
        backends = [type(sh._impl).__name__ for sh in store._shards]
        ids = np.random.default_rng(seed + 17).choice(
            test_df["trip_id"].to_numpy(), FS_READBACK, replace=False)
        got = pd.DataFrame(store.multi_get([{"trip_id": int(i)} for i in ids]))
        count = store.count()
    finally:
        store.close()
    print(f"phase 16 (c) materialized the test split's {len(test_df)} rows through pubsub topic "
          f"{topic} into ShardedOnlineStore taxi_trips v1 ({FS_SHARDS} shards, backends "
          f"{backends}): produced in {produce_s:.2f} s, drained in {mat_s:.2f} s "
          f"({len(test_df) / mat_s:.0f} rows/s materialized), freshness lag {lag:.2f} s after "
          f"the drain; {FS_READBACK} seeded trip IDs read back", flush=True)
    if not drained or count != len(test_df):
        raise AssertionError(f"phase 16 (c): drained {drained}, {count} rows online")
    if not all(sh._impl.__class__ is kvstore.NativeKV for sh in store._shards):
        raise AssertionError(f"phase 16 (c): a shard is not native: {backends}")
    want = offline.loc[ids].reset_index()
    pd.testing.assert_frame_equal(got[list(want.columns)], want)  # raises: online != offline

    # (d) serving by trip ID over HTTP: a batching endpoint and an
    # unbatched one, each joining the online rows into the model's vector.
    feature_config = {"groups": [{"name": "taxi_trips", "version": 1, "primary_key": ["trip_id"],
                                  "features": FS_ORDER, "shards": FS_SHARDS}],
                      "order": FS_ORDER, "missing": "reject"}
    spec = importlib.util.spec_from_file_location("taxi_offline_twin", model_dir / "predictor.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    direct, ref32 = twin.Predict(), twin.Predict(dtype="float32")
    pool = test_df["trip_id"].to_numpy()
    g = np.random.default_rng(seed + 18)
    requests = [[[int(i) for i in g.choice(pool, FS_IDS, replace=False)]
                 for _ in range(FS_REQUESTS)] for _ in range(FS_CLIENTS)]

    def offline_vectors(trip_ids):
        return offline.loc[trip_ids, FS_ORDER].to_numpy(np.float64).tolist()

    hists = {"lookup": ("hops_tpu_online_lookup_seconds", {"store": "taxi_trips_1"}),
             "join": ("hops_tpu_online_join_seconds", {"model": "taxi"}),
             "request": ("hops_tpu_online_request_seconds", {"model": "taxi"})}
    before = {k: _hist_read(REGISTRY, n, **lab) for k, (n, lab) in hists.items()}
    serving.create_or_update("taxi", model_path=str(model_dir), model_server="PYTHON",
                             feature_config=feature_config, batching_enabled=True,
                             batching_config=FS_BATCHING)
    serving.create_or_update("taxi-unbatched", model_path=str(model_dir),
                             model_server="PYTHON", feature_config=feature_config)

    def client(reqs):
        out = []
        for trip_ids in reqs:
            t0 = time.perf_counter()
            resp = serving.make_inference_request(
                "taxi", {"instances": [{"trip_id": i} for i in trip_ids]})
            out.append((resp["predictions"], time.perf_counter() - t0))
        return out

    try:
        serving.start("taxi")
        t0 = time.perf_counter()
        answers = _concurrently(client, requests)
        wall = time.perf_counter() - t0
        batches = serving._servers["taxi"].batcher.batches_run
        after = {k: _hist_read(REGISTRY, n, **lab) for k, (n, lab) in hists.items()}
    finally:
        serving.stop("taxi")
    one = [int(i) for i in g.choice(pool, FS_UNBATCHED_IDS, replace=False)]
    try:
        serving.start("taxi-unbatched")
        alone = serving.make_inference_request(
            "taxi-unbatched", {"instances": [{"trip_id": i} for i in one]})["predictions"]
    finally:
        serving.stop("taxi-unbatched")
    served = torch.tensor([p for a in answers for preds, _ in a for p in preds])
    flat = [i for reqs in requests for trip_ids in reqs for i in trip_ids]
    vectors = offline_vectors(flat)
    want_bf16 = torch.tensor(direct.predict(vectors))
    want_fp32 = torch.tensor(ref32.predict(vectors))
    d_bf16 = (want_bf16 - want_fp32).abs().max().item()
    d_served = (served - want_fp32).abs().max().item()
    top2 = want_bf16.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]) <= 2 * d_bf16
    differ = served.argmax(1) != want_bf16.argmax(1)
    exact = alone == direct.predict(offline_vectors(one))
    n_req = FS_CLIENTS * FS_REQUESTS
    model_s = (after["request"][2] - before["request"][2]) - (after["join"][2] - before["join"][2])
    print(f"phase 16 (d) endpoint taxi (PYTHON predictor: the trained WideAndDeep, bf16, on "
          f"{dev}; feature_config joins taxi_trips v1's {FS_SHARDS} shards in {FS_ORDER}, "
          f"missing reject; batching {FS_BATCHING}): {FS_CLIENTS} client threads x "
          f"{FS_REQUESTS} requests x {FS_IDS} trip IDs in {wall:.2f} s, {batches} batches for "
          f"{n_req} requests; client latency {_pcts([t for a in answers for _, t in a])}; "
          f"hops_tpu_online_lookup_seconds (a shard's batch) "
          f"{_hist_pcts(before['lookup'], after['lookup'])}; hops_tpu_online_join_seconds (a "
          f"coalesced batch) {_hist_pcts(before['join'], after['join'])}; the model's share of "
          f"a joined predict {model_s / (after['request'][2] - before['request'][2]):.1%}; "
          f"argmax differs from the direct forward on the offline vectors in "
          f"{int(differ.sum())} of {len(flat)} rows ({int((differ & near).sum())} at a near "
          f"tie); ||served - fp32||inf {d_served:.4e}, ||bf16 forward - fp32||inf {d_bf16:.4e} "
          f"(bound {CLASSIFIER_REL}x); card {card_line}", flush=True)
    print(f"phase 16 (d) endpoint taxi-unbatched: one request of {FS_UNBATCHED_IDS} trip IDs "
          f"{'equals' if exact else 'differs from'} the direct forward of the same "
          f"{FS_UNBATCHED_IDS} offline vectors bit for bit", flush=True)
    if served.shape != want_bf16.shape or bool((differ & ~near).any()):
        raise AssertionError("phase 16 (d): a served argmax differs from the direct forward's "
                             "without a near tie")
    if not d_served <= CLASSIFIER_REL * d_bf16:
        raise AssertionError(f"phase 16 (d): served logits {d_served:.4e} from fp32, over "
                             f"{CLASSIFIER_REL} x {d_bf16:.4e}")
    if not batches < n_req:
        raise AssertionError(f"phase 16 (d): {batches} batches for {n_req} requests")
    if not exact:
        raise AssertionError("phase 16 (d): the unbatched request's logits are not the direct "
                             "forward's on the offline vectors")
    launches = {k: n for k, n in A.launch_counts().items() if n}
    phase_s = time.perf_counter() - t_phase
    print(f"phase 16 took {phase_s:.1f} s (budget {PHASE16_BUDGET_S:.0f} s); launches of the "
          f"hand-written kernels {launches}", flush=True)
    if launches:
        raise AssertionError(f"phase 16 launched hand-written kernels: {launches}")
    if phase_s > PHASE16_BUDGET_S:
        raise AssertionError(f"phase 16 took {phase_s:.1f} s, over {PHASE16_BUDGET_S:.0f} s")


PHASE17_BUDGET_S = 180.0
FLEET_SLOTS = 4
# The fleets' router runs with hedging and brownout off: an LM request
# lasts seconds, so the default 1 s brownout SLO (a classifier's) would
# cut every stream to the brownout token cap, and a hedge would run a
# whole generation twice. Outlier ejection stays at its default; a
# process replica loads its 12 layers in well under the spawn timeout.
FLEET_OPTIONS = dict(hedge=None, brownout=None, scrape_interval_s=0.1, spawn_timeout_s=300.0)
# The autoscaler only heals (2 to 4 replicas, never down): a scale-down
# drains the least-loaded ready replica, which mid-rollout is the idle
# canary, and a drained canary sees none of the traffic that judges it.
FLEET_HEAL = dict(min_replicas=2, max_replicas=4, target_load=50.0, low_factor=0.0)
FLEET_PLACED_REQUESTS = 4
FLEET_HEAL_S = 180.0  # the longest wait for the autoscaler to restore 2 ready replicas
# (c) the closed loop: phase 9's LAUNCH_LM without dropout, served as bf16.
LOOP_LM = dict(TRAIN, num_layers=2)
LOOP_SERVE = dict(MODEL, num_layers=2)
LOOP_ROWS, LOOP_SPAN = 240, 8
LOOP_SAVE_EVERY, LOOP_EVAL_EVERY = 5, 10
LOOP_PUBLISH_RPS = 400.0  # faster than the trainer takes rows: spans fill
LOOP_PROMPT, LOOP_NEW_TOKENS, LOOP_CLIENTS = 32, 16, 2


def _alive(pid: int) -> bool:
    """Whether process ``pid`` runs (a zombie does not)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] not in ("Z", "X")


def _worker_module(pid: int) -> str:
    """The module a ``python -m`` process runs, from its command line."""
    argv = Path(f"/proc/{pid}/cmdline").read_bytes().decode().split("\0")
    return argv[argv.index("-m") + 1] if "-m" in argv else " ".join(argv)


class _Clients:
    """Closed-loop client threads: ``ask(i)`` for i = 0, 1, ... until
    stopped; every answer, error and completion time recorded."""

    def __init__(self, ask, n: int):
        self.ask, self.answers, self.errors, self.done = ask, [], [], []
        self._lock, self._stop = threading.Lock(), threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(k, n), daemon=True)
                         for k in range(n)]

    def _run(self, k: int, n: int) -> None:
        i = k
        while not self._stop.is_set():
            try:
                out = self.ask(i)
                with self._lock:
                    self.answers.append((i, out))
                    self.done.append(time.perf_counter())
            except Exception as e:  # noqa: BLE001 — counted; the phase requires none
                with self._lock:
                    self.errors.append(f"{type(e).__name__}: {e}")
            i += n

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=600)


def _blip_ms(done: list[float], windows: list[tuple[float, float]]) -> float:
    """The longest gap between successful completions inside any rollout
    window (0.5 s either side), as ``bench.py``'s continuous-loop tier
    measures the cutover blip."""
    blip, done = 0.0, sorted(done)
    for t0, t1 in windows:
        window = [t for t in done if t0 - 0.5 <= t <= t1 + 0.5]
        blip = max([blip] + [(b - a) * 1e3 for a, b in zip(window, window[1:])])
    return blip


def _wait(cond, seconds: float, what: str, phase: int = 17) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"phase {phase}: {what} within {seconds:.0f} s")
        time.sleep(0.05)


def _streams_ok(model, torch, prompts, got, want, dev, what: str) -> str:
    """``got`` held to ``want`` stream by stream under the near-tie rule."""
    notes = near_ties(model, torch, prompts, got, want, dev, what)
    return "; ".join(notes) or "all identical"


def _client_answers(clients, instances, want) -> tuple[list, list, list]:
    """The clients' answers regrouped as (prompts index, got, want)."""
    idx = [i % len(instances) for i, _ in clients.answers]
    return idx, [a for _, a in clients.answers], [want[i] for i in idx]


def fleet_phase(A, torch, np, art, prompts, instances, answers, http_s, dev, seed: int,
                card_line: str) -> dict[str, int]:
    """Phase 17; returns the launch counts of this process over the phase
    (the in-process fleet and the trainer of (c); process replicas count
    in their own processes)."""
    from hops_tpu_torch.jobs import placement
    from hops_tpu_torch.jobs.placement import invariants
    from hops_tpu_torch.modelrepo import fleet, registry, serving
    from hops_tpu_torch.modelrepo.fleet.autoscale import AutoscalePolicy
    from hops_tpu_torch.modelrepo.fleet.replicas import ReplicaManager
    from hops_tpu_torch.modelrepo.serving import load_lm_artifact
    from hops_tpu_torch.runtime import config, faultinject, flight

    t_phase = time.perf_counter()
    work = ROOT / "_smoke" / "fleet"
    config.configure(workspace=str(work / "workspace"), project="chip_smoke")
    heal = AutoscalePolicy(**FLEET_HEAL)
    v1 = registry.export(art, "smoke-fleet", metrics={"layers": MODEL["num_layers"]})["version"]
    v2 = registry.export(art, "smoke-fleet", metrics={"layers": MODEL["num_layers"]})["version"]
    serving.create_or_update("smoke-fleet", model_name="smoke-fleet", model_version=v1,
                             model_server="LM", lm_config={"slots": FLEET_SLOTS})
    model = load_lm_artifact(art, dev)  # the near-tie rule's reference
    spawned: list[int] = []
    spawn_process = ReplicaManager._spawn_process

    def tracked(self, rep, cfg):
        try:
            spawn_process(self, rep, cfg)
        finally:
            if rep.proc is not None:
                spawned.append(rep.proc.pid)

    def ask_fleet(f):
        return lambda i: f.predict([instances[i % len(instances)]],
                                   timeout_s=600.0)["predictions"][0]

    # (a) process replicas of phase 4's artifact behind the router.
    ReplicaManager._spawn_process = tracked
    agents: list = []
    try:
        t0 = time.perf_counter()
        with fleet.start_fleet("smoke-fleet", 2, autoscale=heal, autoscale_interval_s=0.1,
                               **FLEET_OPTIONS) as f:
            spawn_s = time.perf_counter() - t0
            modules = {_worker_module(r.pid) for r in f.manager.ready()}
            if modules != {"hops_tpu_torch.modelrepo.serving_host"}:
                raise AssertionError(f"phase 17 (a): the workers run {modules}")
            timed = _concurrently(_timed(ask_fleet(f)), list(range(len(instances))))
            got_a = [a for a, _ in timed]
            notes_a = _streams_ok(model, torch, prompts, got_a, answers, dev, "phase 17 (a)")
            windows: list = []
            with _Clients(ask_fleet(f), 2) as clients:
                time.sleep(1.0)
                victim = f.manager.ready()[0]
                killer = threading.Timer(2.0, lambda: f.manager.kill(victim.rid))
                killer.start()
                t0 = time.perf_counter()
                summary = f.roll_out(v2, canary_requests=2, canary_window_s=120.0)
                windows.append((t0, time.perf_counter()))
                killer.join()
                _wait(lambda: len(f.manager.ready()) >= 2, FLEET_HEAL_S,
                      "the autoscaler did not heal the fleet to 2 replicas")
                healed = [r.version for r in f.manager.ready()]
            starts_a = (f.manager.starter.warm, f.manager.starter.cold)
            idx, got, want = _client_answers(clients, instances, answers)
            notes_r = _streams_ok(model, torch, [prompts[i] for i in idx], got, want, dev,
                                  "phase 17 (a) rollout")
        left = [p for p in spawned if _alive(p)]
        print(f"phase 17 (a) fleet of 2 process replicas (python -m "
              f"hops_tpu_torch.modelrepo.serving_host --fleet-worker, {FLEET_SLOTS} slots, "
              f"{MODEL['num_layers']} layers bf16) up in {spawn_s:.1f} s, side by side; phase 4's "
              f"8 requests through the router: client latency {_pcts([t for _, t in timed])} "
              f"(phase 11's direct endpoint: {_pcts(http_s)}); streams equal phase 4's: leading "
              f"tokens {same_lead(got_a, answers)}; {notes_a}. Rollout to v{v2} (the same "
              f"weights) under 2 clients with replica {victim.rid} SIGKILLed 2 s in: "
              f"{summary['outcome']} in {summary['duration_s']:.1f} s, blip "
              f"{_blip_ms(clients.done, windows):.0f} ms; {len(clients.answers)} answers, "
              f"{len(clients.errors)} errors ({'; '.join(clients.errors[:3])}); streams: "
              f"{notes_r}; healed to versions {healed}; {len(spawned)} workers spawned, "
              f"{len(left)} alive after stop; worker starts warm from a spare {starts_a[0]}, cold "
              f"{starts_a[1]}; card {card_line}", flush=True)
        if summary["outcome"] != "completed" or clients.errors or left:
            raise AssertionError(f"phase 17 (a): rollout {summary['outcome']}, client errors "
                                 f"{clients.errors[:3]}, workers left alive {left}")

        # (b) the same fleet placed by two host agents.
        placed: list[int] = []
        for i in range(2):
            agent = placement.Hostd(f"h{i}", unit_root=work / f"h{i}", spawn_timeout_s=300.0)
            spawn_unit = agent._spawn_process

            def tracked_unit(unit, cfg, spawn_unit=spawn_unit):
                try:
                    spawn_unit(unit, cfg)
                finally:
                    if unit.proc is not None:
                        placed.append(unit.proc.pid)

            agent._spawn_process = tracked_unit
            agents.append(agent)
        client = placement.PlacementClient(
            placement.HostRegistry(hosts=[a.host() for a in agents]), breaker_failures=2,
            rpc_timeout_s=5.0, spawn_timeout_s=300.0)
        seq0 = flight.FLIGHT.seq
        t0 = time.perf_counter()
        with fleet.start_fleet("smoke-fleet", 2, placement=client, autoscale=heal,
                               autoscale_interval_s=0.1, **FLEET_OPTIONS) as f:
            placed_s = time.perf_counter() - t0
            hosts = sorted(r.unit.host.name for r in f.manager.ready())
            modules = {_worker_module(p) for p in placed if _alive(p)}
            if hosts != ["h0", "h1"] or modules != {"hops_tpu_torch.modelrepo.serving_host"}:
                raise AssertionError(f"phase 17 (b): replicas on {hosts} run {modules}")
            n = FLEET_PLACED_REQUESTS
            got_b = _concurrently(ask_fleet(f), list(range(n)))
            notes_b = _streams_ok(model, torch, prompts[:n], got_b, got_a[:n], dev,
                                  "phase 17 (b)")
            victim = f.manager.ready()[0].unit.host.name
            survivor = next(h for h in hosts if h != victim)
            with _Clients(lambda i: ask_fleet(f)(i % n), 2) as clients:
                time.sleep(1.0)
                t_kill = time.perf_counter()
                faultinject.arm(f"placement.rpc=error:OSError@key={victim}")
                next(a for a in agents if a.name == victim).chaos_kill()
                _wait(lambda: len(f.manager.ready()) >= 2 and all(
                    r.unit is not None and r.unit.host.name == survivor
                    for r in f.manager.ready()), FLEET_HEAL_S,
                    f"the fleet was not re-placed on {survivor}")
                replaced_s = time.perf_counter() - t_kill
                time.sleep(1.0)
            faultinject.disarm()
            idx, got, want = _client_answers(clients, instances[:n], got_a[:n])
            notes_k = _streams_ok(model, torch, [prompts[i] for i in idx], got, want, dev,
                                  "phase 17 (b) host killed")
        violations = invariants.audit(after_seq=seq0)
        starts_b = [sum(a.starter.warm for a in agents), sum(a.starter.cold for a in agents)]
        for a in agents:
            with contextlib.suppress(Exception):  # the killed agent answers nothing
                a.stop()
        left = [p for p in placed if _alive(p)]
        print(f"phase 17 (b) placed fleet on hosts {hosts} (two Hostd agents, process units): "
              f"up in {placed_s:.1f} s, side by side; {n} requests equal (a)'s streams: {notes_b}; host "
              f"{victim} killed under 2 clients: re-placed on {survivor} in {replaced_s:.1f} s, "
              f"{len(clients.answers)} answers, {len(clients.errors)} errors "
              f"({'; '.join(clients.errors[:3])}), streams: {notes_k}; slot invariant "
              f"{'held' if not violations else violations[:3]}; {len(placed)} units spawned, "
              f"{len(left)} alive after stop; unit starts warm from a spare {starts_b[0]}, cold "
              f"{starts_b[1]}; card {card_line}", flush=True)
        if clients.errors or violations or left:
            raise AssertionError(f"phase 17 (b): client errors {clients.errors[:3]}, "
                                 f"violations {violations[:3]}, units left alive {left}")
    finally:
        ReplicaManager._spawn_process = spawn_process
        faultinject.disarm()
        for a in agents:
            with contextlib.suppress(Exception):
                a.stop()
    del model
    torch.cuda.empty_cache()
    launches = loop_closed(A, torch, np, work, dev, seed, card_line)
    missing = [k for k in TRAIN_KERNELS + ("decode_attention",) if not launches.get(k)]
    phase_s = time.perf_counter() - t_phase
    print(f"phase 17 took {phase_s:.1f} s (budget {PHASE17_BUDGET_S:.0f} s); launches in this "
          f"process (the loop's trainer and in-process fleet) {launches}", flush=True)
    if missing:
        raise AssertionError(f"phase 17: {missing} never launched")
    if phase_s > PHASE17_BUDGET_S:
        raise AssertionError(f"phase 17 took {phase_s:.1f} s, over {PHASE17_BUDGET_S:.0f} s")
    return launches


def loop_rows(np, seed: int, n: int):
    """``n`` rows of ``TRAIN_SEQ + 1`` tokens that count up by a stride
    of 1 to 3 from a seeded start: learnable, so the held-out loss falls
    from gate to gate."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, LOOP_LM["vocab_size"], (n, 1))
    stride = rng.integers(1, 4, (n, 1))
    return ((start + stride * np.arange(TRAIN_SEQ + 1)) % LOOP_LM["vocab_size"]).astype(np.int32)


def loop_closed(A, torch, np, work, dev, seed: int, card_line: str) -> dict[str, int]:
    """Phase 17 (c): the closed loop on the card; returns the launch
    counts of its trainer and in-process fleet."""
    from hops_tpu_torch.featurestore.loader import StreamingSource
    from hops_tpu_torch.messaging import pubsub
    from hops_tpu_torch.models.common import create_train_state
    from hops_tpu_torch.models.convert import params_to_flax, random_params
    from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
    from hops_tpu_torch.modelrepo import fleet, registry, serving
    from hops_tpu_torch.modelrepo.fleet.autoscale import AutoscalePolicy
    from hops_tpu_torch.modelrepo.fleet.replicas import ReplicaManager
    from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, load_lm_artifact
    from hops_tpu_torch.ops.xent import chunked_softmax_xent
    from hops_tpu_torch.pipeline import continuous as C
    from hops_tpu_torch.runtime import checkpoint, faultinject
    from hops_tpu_torch.runtime.preemption import PreemptionGuard
    from hops_tpu_torch.runtime.resilience import RetryPolicy
    from hops_tpu_torch.telemetry.metrics import REGISTRY

    t_loop = time.perf_counter()
    params = random_params(**LOOP_LM, seed=seed + 17)
    model = TransformerLM(**LOOP_LM, device=dev).load_flax(params)
    state = create_train_state(model, seed=seed, learning_rate=LEARNING_RATE)
    step = make_lm_train_step(loss_chunk=LOSS_CHUNK)
    v1 = registry.save_lm(LOOP_SERVE, params, "smoke-loop", metrics={"step": 0})
    serving.create_or_update("smoke-loop", model_name="smoke-loop", model_version=v1["version"],
                             model_server="LM", lm_config={"slots": FLEET_SLOTS})
    heldout = torch.from_numpy(loop_rows(np, seed + 1017, TRAIN_BATCH)).to(dev).long()
    requests = [{"prompt": r[:LOOP_PROMPT].tolist(), "max_new_tokens": LOOP_NEW_TOKENS,
                 "temperature": 0.0} for r in loop_rows(np, seed + 2017, 4)]
    topic = "smoke-loop-rows"
    pubsub.create_topic(topic)
    rows = loop_rows(np, seed + 17, LOOP_ROWS)

    def produce():
        prod = pubsub.Producer(topic)
        t0 = time.perf_counter()
        for i, row in enumerate(rows):
            lag = t0 + (i + 1) / LOOP_PUBLISH_RPS - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            prod.send({"tokens": row.tolist()})

    step_s: list[float] = []

    def train_step(s, batch):
        t0 = time.perf_counter()
        s, metrics = step(s, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return s, metrics

    src = StreamingSource(topic, group="smoke-loop", from_beginning=True, name="smoke-loop")
    gate_params, freshness = [], []

    def eval_fn(s):
        freshness.append(src.watermark_lag_s())
        # The check's own copy of the judged weights, on the card.
        gate_params.append({k: v.detach().clone() for k, v in s.model.state_dict().items()})
        if len(gate_params) == 2:
            return float("inf")  # the poisoned candidate: it must never be exported
        inputs, targets = heldout[:, :-1], heldout[:, 1:]
        with torch.no_grad():
            hidden = s.model(inputs, return_hidden=True)
            return float(chunked_softmax_xent(hidden, s.model.unembed.kernel, targets,
                                              chunk=LOSS_CHUNK))

    exports: dict[int, tuple[int, float]] = {}

    def export_fn(s, at, metric):
        t0 = time.perf_counter()
        meta = registry.save_lm(LOOP_SERVE, params_to_flax(s.model), "smoke-loop",
                                metrics={"heldout_loss": metric, "step": at})
        exports[at] = (meta["version"], time.perf_counter() - t0)
        return meta

    versions: dict[str, int] = {}
    spawn = ReplicaManager.spawn

    def tracked(self, *a, **kw):
        rep = spawn(self, *a, **kw)
        versions[rep.rid] = rep.version
        return rep

    snap = REGISTRY.get("hops_tpu_continuous_snapshot_seconds").labels()
    evals = REGISTRY.get("hops_tpu_continuous_eval_gate_seconds").labels()
    snap0, evals0 = (snap.sum, snap.count), (evals.sum, evals.count)
    ck = {m: getattr(checkpoint, f"_m_{m}").labels() for m in ("snapshot", "write", "restore")}
    ck0 = {m: (h.sum, h.count) for m, h in ck.items()}
    windows: list = []
    rollouts: list = []
    ReplicaManager.spawn = tracked
    torch.cuda.synchronize()
    A.reset_launch_counts()
    try:
        with fleet.start_fleet("smoke-loop", 2, inprocess=True,
                               autoscale=AutoscalePolicy(**FLEET_HEAL),
                               autoscale_interval_s=0.1, **FLEET_OPTIONS) as f:

            class _Timed:
                """The fleet, with each rollout's window recorded and a
                ready replica killed 0.05 s into the first one."""

                def roll_out(self, version, **kw):
                    if not windows:
                        victim = f.manager.ready()[0]
                        threading.Timer(0.05, lambda: f.manager.kill(victim.rid)).start()
                    t0 = time.perf_counter()
                    try:
                        out = f.roll_out(version, canary_requests=2, canary_window_s=60.0, **kw)
                        rollouts.append(out)
                        return out
                    finally:
                        windows.append((t0, time.perf_counter()))

            ask = lambda i: f.predict([requests[i % len(requests)]],  # noqa: E731
                                      timeout_s=300.0)["predictions"][0]
            producer = threading.Thread(target=produce, daemon=True)
            faultinject.arm(f"pubsub.poll=error:OSError@times=1,after={LOOP_SPAN * 2}")
            with _Clients(ask, LOOP_CLIENTS) as clients:
                producer.start()
                stream = C.SpanStream(src, work / "loop_ck", collate=lambda vals: {
                    "tokens": torch.from_numpy(np.asarray([v["tokens"] for v in vals], np.int32))},
                    min_records=LOOP_SPAN, max_records=LOOP_SPAN, eval_every=LOOP_EVAL_EVERY,
                    stop_on_idle=True, idle_grace_s=2.0)
                t_train = time.perf_counter()
                res = C.run_continuous(
                    train_step, state, stream, directory=str(work / "loop_ck"),
                    eval_fn=eval_fn, mode="min", save_every=LOOP_SAVE_EVERY, max_recoveries=3,
                    recovery_policy=RetryPolicy(base_delay_s=0.01, seed=0),
                    publisher=C.RegistryFleetPublisher("smoke-loop", export_fn, fleet=_Timed()),
                    guard=PreemptionGuard(install=False))
                train_wall = time.perf_counter() - t_train
                faultinject.disarm()
                _wait(lambda: len(f.manager.ready()) >= 2, FLEET_HEAL_S,
                      "the loop's fleet did not heal to 2 replicas")
            producer.join(timeout=60)
            final = _concurrently(ask, list(range(len(requests))))
            forwards = REGISTRY.counter("hops_tpu_fleet_forwards_total",
                                        labels=("model", "replica"))
            served = {versions[rid] for rid in versions
                      if forwards.value(model="smoke-loop", replica=rid) > 0}
        torch.cuda.synchronize()
        launches = {k: n for k, n in A.launch_counts().items() if n}
    finally:
        ReplicaManager.spawn = spawn
        faultinject.disarm()
    ck_n = {m: h.count - ck0[m][1] for m, h in ck.items()}
    ck_s = {m: h.sum - ck0[m][0] for m, h in ck.items()}
    snap_n = snap.count - snap0[1]
    snap_s = (snap.sum - snap0[0]) / max(snap_n, 1)
    eval_s = (evals.sum - evals0[0]) / max(evals.count - evals0[1], 1)
    passed = [g for g in res.gates if g["outcome"] == "pass"]
    failed = [g for g in res.gates if g["outcome"] == "fail"]
    completed = [c for c in res.cutovers if c["outcome"] == "completed"]
    allowed = {v1["version"]} | {c["version"] for c in res.cutovers}
    # The trap of a torch loop: each export holds the weights its gate judged, bit for bit.
    judged = {g["step"]: p for g, p in zip(res.gates, gate_params)}
    unequal = []
    for c in res.cutovers:
        path = registry.get_model("smoke-loop", c["version"])["path"]
        m = load_lm_artifact(path, dev, dtype="float32")
        exported = m.state_dict()
        unequal += [f"step {c['step']} {k}" for k, v in judged[c["step"]].items()
                    if not torch.equal(exported[k], v)]
        del m, exported
    last = registry.get_model("smoke-loop", res.cutovers[-1]["version"])["path"]
    direct = LMEnginePredictor(last, {"slots": FLEET_SLOTS})
    try:
        want = direct.predict(requests)
    finally:
        direct.stop()
    ref = load_lm_artifact(last, dev)
    notes = _streams_ok(ref, torch, [r["prompt"] for r in requests], final, want, dev,
                        "phase 17 (c) after the last cutover")
    del ref, direct, judged, gate_params
    torch.cuda.empty_cache()
    tok_s = TRAIN_BATCH * TRAIN_SEQ / statistics.median(step_s)
    led = res.ledger
    print(f"phase 17 (c) closed loop: {LOOP_ROWS} rows of {TRAIN_SEQ + 1} tokens published at "
          f"{LOOP_PUBLISH_RPS:.0f} rows/s, trained {led['records']} in {res.steps} steps "
          f"({LOOP_LM['num_layers']} layers, d_model {LOOP_LM['d_model']}, fp32 masters, bf16) "
          f"in {train_wall:.1f} s: step {statistics.median(step_s) * 1e3:.3f} ms median "
          f"({tok_s:.0f} tokens/s); ledger entries {led['entries']}, contiguous "
          f"{led['contiguous']}, disjoint {led['disjoint']}; recoveries {res.recoveries}; "
          f"gates {[(g['step'], g['outcome'], round(g['metric'], 4)) for g in res.gates]}, "
          f"eval {eval_s * 1e3:.1f} ms a gate, gate latency with the wait for the previous "
          f"cutover {[round(g['latency_s'] * 1e3, 1) for g in res.gates]} ms; snapshot on the "
          f"training thread {snap_s * 1e3:.1f} ms a passed gate ({snap_n}); checkpoints: "
          f"{ck_n['write']} writes {ck_s['write']:.2f} s (their copies to host on the training "
          f"thread {ck_s['snapshot']:.2f} s), {ck_n['restore']} restores {ck_s['restore']:.2f} s; "
          f"cutovers "
          f"{[(c['step'], c['version'], c['outcome']) for c in res.cutovers]}, exports "
          f"{[round(s, 2) for _, s in exports.values()]} s, rollouts "
          f"{[round(r['duration_s'], 2) for r in rollouts]} s, blip "
          f"{_blip_ms(clients.done, windows):.0f} ms; freshness lag median "
          f"{statistics.median(freshness):.2f} s, max {max(freshness):.2f} s; clients "
          f"{len(clients.answers)} answers, {len(clients.errors)} errors; served versions "
          f"{sorted(served)} of allowed {sorted(allowed)}; exported weights equal the judged "
          f"ones: {not unequal}; streams after the last cutover against a direct engine: "
          f"{notes} ({time.perf_counter() - t_loop:.1f} s); card {card_line}", flush=True)
    problems = []
    if clients.errors:
        problems.append(f"client errors {clients.errors[:3]}")
    if not (led["records"] == LOOP_ROWS and led["contiguous"] and led["disjoint"]):
        problems.append(f"ledger {led}")
    if res.recoveries < 1:
        problems.append("no recovery")
    if len(failed) != 1 or not completed:
        problems.append(f"{len(failed)} failed gates, {len(completed)} completed cutovers")
    if not served <= allowed:
        problems.append(f"served versions {sorted(served)} outside {sorted(allowed)}")
    if unequal or len(passed) != len(res.cutovers):
        problems.append(f"exports unlike their gates: {unequal[:3]}")
    if problems:
        raise AssertionError("phase 17 (c): " + "; ".join(problems))
    return launches


PHASE18_BUDGET_S = 120.0
JOBS_APP = ROOT / "chip_smoke.py"  # the train job's app: this script, as --jobs-worker
JOBS_TRAIN_STEPS = 3  # held to phase 7's first losses bit for bit
JOBS_REQUESTS = 4  # phase 4's first requests, served by the DAG's serve task
JOBS_STOP_S = 10.0  # stop_job to KILLED
JOBS_WAIT_S = 30.0  # a plain-Python job to a final state
PNG_MAGIC = b"\x89PNG"


def jobs_worker(spec_path: str) -> int:
    """Phase 18 (b)'s train job, run by ``jobs.start_job`` as the job's
    app: phase 7's LM from phase 4's weights on phase 7's batch and seed,
    ``JOBS_TRAIN_STEPS`` steps through ``compat.experiment.launch`` with
    each loss logged by ``compat.tensorboard``; the trained weights saved
    as an LM artifact in the execution's directory and registered as
    ``jobs-lm`` through ``compat.model``. Writes the losses, the launch
    counts, the run directory and the model version to ``result.json``
    there."""
    import os

    import numpy as np
    import torch

    from hops_tpu_torch.compat import experiment, tensorboard
    from hops_tpu_torch.compat import model as compat_model
    from hops_tpu_torch.models.common import create_train_state
    from hops_tpu_torch.models.convert import load_npz, params_to_flax
    from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
    from hops_tpu_torch.modelrepo.serving import save_lm_artifact
    from hops_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(spec_path).read_text())
    out = Path.cwd() / "executions" / os.environ["HOPS_TPU_EXECUTION_ID"]
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device(spec["device"])
    params = load_npz(spec["params"])
    tokens = np.random.default_rng(spec["seed"] + 2).integers(
        0, TRAIN["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ + 1))
    res: dict = {}

    def train():
        model = TransformerLM(**TRAIN, device=dev).load_flax(params)
        state = create_train_state(model, seed=spec["seed"], learning_rate=LEARNING_RATE)
        step = make_lm_train_step(loss_chunk=LOSS_CHUNK)
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        A.reset_launch_counts()
        losses = []
        t0 = time.perf_counter()
        for i in range(JOBS_TRAIN_STEPS):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            tensorboard.scalar(i, "loss", losses[-1])
        res.update(losses=losses, launches=A.launch_counts(),
                   train_s=time.perf_counter() - t0)
        tensorboard.flush()
        save_lm_artifact(out / "artifact", MODEL, params_to_flax(state.model))
        return {"loss": losses[-1]}

    t0 = time.perf_counter()
    run_dir, _ = experiment.launch(train, name="jobs-train", metric_key="loss")
    meta = compat_model.export(out / "artifact", "jobs-lm", metrics={"loss": res["losses"][-1]})
    res.update(run_dir=run_dir, version=meta["version"], path=meta["path"],
               job_s=time.perf_counter() - t0)
    (out / "result.json").write_text(json.dumps(res))
    return 0


def _token_group(store, name: str, tokens, expectation) -> None:
    """A feature group of a token batch's per-row extremes, validated on
    save against ``expectation`` (``validation_type="ALL"`` records the
    report, which ``FeatureValidationResult`` reads)."""
    import pandas as pd

    fg = store.create_feature_group(name, version=1, primary_key=["row"],
                                    expectations=[expectation], validation_type="ALL")
    fg.save(pd.DataFrame({"row": range(len(tokens)), "min_token": tokens.min(axis=1),
                          "max_token": tokens.max(axis=1)}))


def _job_lifecycle(jobs, work: Path) -> str:
    """Phase 18 (c): a failing job ends FAILED with its exit code, twice,
    listed newest first; a running job stopped by ``stop_job`` ends
    KILLED within ``JOBS_STOP_S``."""
    apps = work / "apps"
    apps.mkdir(exist_ok=True)
    (apps / "fails.py").write_text("raise SystemExit(3)\n")
    (apps / "sleeps.py").write_text("import time\nprint('up', flush=True)\ntime.sleep(600)\n")
    jobs.create_job("fails", {"app_file": str(apps / "fails.py")})
    runs = []
    for _ in range(2):
        ex = jobs.start_job("fails")
        runs.append(jobs.wait_for_completion("fails", ex.execution_id, timeout_s=JOBS_WAIT_S))
    if [(r.state, r.exit_code) for r in runs] != [("FAILED", 3)] * 2:
        raise AssertionError(f"phase 18 (c): the failing job ended "
                             f"{[(r.state, r.exit_code) for r in runs]}, not FAILED with 3")
    listed = [e.execution_id for e in jobs.get_executions("fails")]
    if listed != [r.execution_id for r in reversed(runs)]:
        raise AssertionError(f"phase 18 (c): get_executions lists {listed}, not newest first")
    jobs.create_job("sleeps", {"app_file": str(apps / "sleeps.py")})
    ex = jobs.start_job("sleeps")
    _wait(lambda: "up" in ex.stdout(), JOBS_WAIT_S, "the sleeping job started", 18)
    t0 = time.perf_counter()
    jobs.stop_job("sleeps")
    done = jobs.wait_for_completion("sleeps", ex.execution_id, timeout_s=JOBS_STOP_S)
    killed_s = time.perf_counter() - t0
    if done.state != "KILLED" or killed_s > JOBS_STOP_S:
        raise AssertionError(f"phase 18 (c): the stopped job ended {done.state} "
                             f"(exit {done.exit_code}) after {killed_s:.2f} s, not KILLED "
                             f"within {JOBS_STOP_S:.0f} s")
    return (f"failing job FAILED with exit code {runs[0].exit_code} twice, listed newest "
            f"first; the running job KILLED {killed_s:.2f} s after stop_job (exit "
            f"{done.exit_code})")


def _stream_answers(beam, streaming, pubsub, records: list[dict], sink: Path) -> str:
    """Phase 18 (d): ``records`` onto a topic in two halves; a runner
    (``compat.beam``) drains the first into its parquet sink and is
    stopped; a runner of the same name on the same sink, restarted from
    its checkpoint, drains the second. The sink must hold each record
    exactly once."""
    topic = "jobs-answers"
    pubsub.create_topic(topic)
    producer = pubsub.Producer(topic)
    half = len(records) // 2
    for r in records[:half]:
        producer.send(r)
    runner = beam.create_runner("answers", topic=topic, sink_dir=str(sink), poll_interval_s=0.02)
    beam.start_runner("answers")
    _wait(lambda: len(runner.read_sink()) >= half, JOBS_WAIT_S, "the runner drained its topic",
          18)
    streaming.stop_runner("answers")
    for r in records[half:]:
        producer.send(r)
    again = streaming.StreamingRunner("answers", topic, sink_dir=str(sink),
                                      poll_interval_s=0.02).start()
    _wait(lambda: len(again.read_sink()) >= len(records), JOBS_WAIT_S,
          "the restarted runner drained its topic", 18)
    again.stop()
    rows = again.read_sink().sort_values("id")
    got = [(int(i), [int(t) for t in toks]) for i, toks in zip(rows["id"], rows["tokens"])]
    want = [(r["id"], r["tokens"]) for r in records]
    if got != want:
        raise AssertionError(f"phase 18 (d): the sink holds ids {[i for i, _ in got]}, not each "
                             f"of {len(records)} records once")
    parts = sorted(p.name for p in sink.glob("part-*.parquet"))
    return (f"{len(records)} records in {len(parts)} parquet parts, each once across a stop "
            f"and a restart from the checkpoint")


def _plot_run(res: dict, card_line: str) -> None:
    """Phase 18 (e): ``plotting.plot_metrics`` renders the train job's
    logged losses into its run directory."""
    from hops_tpu_torch import plotting

    t0 = time.perf_counter()
    png = plotting.plot_metrics(res["run_dir"], out=Path(res["run_dir"]) / "plots" / "metrics.png")
    head = png.read_bytes()[:24]
    frame = plotting.collect(res["run_dir"])
    losses_logged = frame[frame["tag"] == "loss"].sort_values("step")["value"].tolist()
    print(f"phase 18 (e) plot_metrics wrote {png.relative_to(ROOT)} "
          f"({int.from_bytes(head[16:20], 'big')} x {int.from_bytes(head[20:24], 'big')} px, "
          f"{time.perf_counter() - t0:.2f} s) from the run's {len(frame)} scalars; "
          f"card {card_line}", flush=True)
    if head[:4] != PNG_MAGIC or losses_logged != res["losses"]:
        raise AssertionError(f"phase 18 (e): {png} is not a PNG of the job's losses "
                             f"({losses_logged})")


def jobs_phase(A, torch, np, art, prompts, instances, dev, seed: int, card_line: str,
               phase7: dict) -> dict[str, int]:
    """Phase 18; returns the launch counts of its path: the train job's
    child and this process's serve task together."""
    import importlib.util
    import os

    import hops_tpu_torch.featurestore as hsfs
    from hops_tpu_torch.compat import beam, jobs, kafka, serving, tls
    from hops_tpu_torch.compat import model as compat_model
    from hops_tpu_torch.featurestore.validation import Rule
    from hops_tpu_torch.jobs import dag, streaming
    from hops_tpu_torch.messaging import pubsub
    from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, load_lm_artifact
    from hops_tpu_torch.runtime import config, fs, relaylock

    t_phase = time.perf_counter()
    work = ROOT / "_smoke" / "jobs"
    work.mkdir(parents=True, exist_ok=True)
    config.configure(workspace=str(work / "workspace"), project="chip_smoke")
    lock = work / "relay.lock"
    prior_lock = os.environ.get(relaylock.ENV_LOCK_PATH)
    os.environ[relaylock.ENV_LOCK_PATH] = str(lock)
    try:
        with relaylock.relay_lock("chip_smoke.py phase 18"):
            # (a) the lock, TLS material and the broker's protocol.
            owner = relaylock.current_owner()
            if not (owner and owner["pid"] == os.getpid() and lock.is_file()):
                raise AssertionError(f"phase 18 (a): the relay lock at {lock} is not held by "
                                     f"this process: {owner}")
            t0 = time.perf_counter()
            material = {"ca_chain": tls.get_ca_chain_location(),
                        "client_cert": tls.get_client_certificate_location(),
                        "client_key": tls.get_client_key_location(),
                        "trust_store": tls.get_trust_store(), "key_store": tls.get_key_store()}
            tls_s = time.perf_counter() - t0
            where = Path(fs.project_path(".tls"))
            bad = [k for k, p in material.items()
                   if not (Path(p).is_file() and Path(p).stat().st_size
                           and Path(p).is_relative_to(where))]
            pem = Path(material["ca_chain"]).read_text().startswith("-----BEGIN CERTIFICATE")
            openssl = shutil.which("openssl")
            if bad or (openssl and not pem) or tls.get_trust_store_pwd() != \
                    tls.get_key_store_pwd() or len(tls.get_key_store_pwd()) != 32:
                raise AssertionError(f"phase 18 (a): TLS material under {where}: missing or "
                                     f"empty {bad}; openssl {openssl}, PEM CA {pem}")
            print(f"phase 18 (a) relay lock held at {lock} (pid {owner['pid']}, "
                  f"'{owner['purpose']}'); TLS material under the project's .tls in "
                  f"{tls_s:.2f} s: " + ("a self-signed CA and client certificate from "
                                        f"{openssl}" if pem else "placeholder files (no "
                                                                 "openssl)")
                  + f"; kafka security protocol {kafka.get_security_protocol()!r}; "
                  f"card {card_line}", flush=True)

            # (b) the DAG: train >> sensor >> gate >> serve.
            (work / "spec.json").write_text(json.dumps(
                {"params": str(art / "params.npz"), "seed": seed, "device": str(dev)}))
            jobs.create_job("train-lm", {"app_file": str(JOBS_APP),
                                         "default_args": ["--jobs-worker",
                                                          str(work / "spec.json")]})
            tokens = np.random.default_rng(seed + 2).integers(
                0, TRAIN["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ + 1))
            store = hsfs.connection().get_feature_store()
            ids = store.create_expectation("token_ids", features=["min_token", "max_token"], rules=[
                Rule(name="HAS_MIN", level="ERROR", min=0),
                Rule(name="HAS_MAX", level="ERROR", max=TRAIN["vocab_size"] - 1)]).save()
            _token_group(store, "train_batch", tokens, ids)
            # ids offset past the vocabulary: every row's largest id fails HAS_MAX
            _token_group(store, "train_batch_shifted", tokens + TRAIN["vocab_size"], ids)
            served: dict = {}

            def serve_task():
                serving.create_or_update("jobs-lm", model_name="jobs-lm", model_server="LM",
                                         lm_config={"slots": 4})
                t0 = time.perf_counter()
                serving.start("jobs-lm")
                served["start_s"] = time.perf_counter() - t0
                try:
                    t0 = time.perf_counter()
                    served["answers"] = serving.make_inference_request(
                        "jobs-lm", {"instances": instances[:JOBS_REQUESTS]})["predictions"]
                    served["request_s"] = time.perf_counter() - t0
                finally:
                    serving.stop("jobs-lm")
                return len(served["answers"])

            with dag.DAG("train-then-serve") as d:
                train = dag.JobLaunchOperator("train", "train-lm", timeout_s=PHASE18_BUDGET_S,
                                              dag=d)
                sensor = dag.JobSuccessSensor("sensor", "train-lm", timeout_s=JOBS_WAIT_S, dag=d)
                gate = dag.FeatureValidationResult("gate", "train_batch", dag=d)
                serve = dag.PythonOperator("serve", serve_task, dag=d)
                train >> sensor >> gate >> serve
            torch.cuda.synchronize()
            A.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                d.run()
            except Exception as e:
                exs = jobs.get_executions("train-lm")
                log = exs[0].stdout()[-6000:] if exs else "(no execution)"
                raise AssertionError(f"phase 18 (b): the DAG failed ({e}); tasks "
                                     f"{[(t.task_id, t.state) for t in d.tasks]}; the train "
                                     f"job's log:\n{log}") from e
            dag_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            serve_launches = A.launch_counts()
            [ex] = jobs.get_executions("train-lm")
            res = json.loads((Path(fs.project_path("Jobs")) / "train-lm" / "executions"
                              / ex.execution_id / "result.json").read_text())
            want_losses = phase7["losses"][:JOBS_TRAIN_STEPS]
            layers = TRAIN["num_layers"]
            registered = compat_model.get_model("jobs-lm")
            predictor = LMEnginePredictor(registered["path"], {"slots": 4})
            try:
                want = predictor.predict(instances[:JOBS_REQUESTS])
            finally:
                predictor.stop()
            del predictor
            model = load_lm_artifact(registered["path"], dev)
            notes = _streams_ok(model, torch, prompts[:JOBS_REQUESTS], served["answers"], want,
                                dev, "phase 18 (b)")
            del model
            torch.cuda.empty_cache()
            print(f"phase 18 (b) DAG train >> sensor >> gate >> serve in {dag_s:.1f} s, tasks "
                  f"{[(t.task_id, t.state) for t in d.tasks]}: the train job (execution "
                  f"{ex.execution_id}, {ex.state}, {ex.finished_at - ex.submitted_at:.1f} s "
                  f"from submit to exit; its {JOBS_TRAIN_STEPS} steps {res['train_s']:.2f} s) "
                  f"losses {res['losses']}, equal phase 7's first {JOBS_TRAIN_STEPS} bit for "
                  f"bit: {res['losses'] == want_losses}; its launches "
                  f"{ {k: res['launches'][k] for k in TRAIN_KERNELS} }; registered "
                  f"jobs-lm v{res['version']} through compat.model; the gate read "
                  f"train_batch's validation; the serve task (compat.serving, endpoint start "
                  f"{served['start_s']:.1f} s, {JOBS_REQUESTS} requests {served['request_s']:.2f} "
                  f"s) streams against a direct LMEnginePredictor on the artifact: leading "
                  f"tokens {same_lead(served['answers'], want)}; {notes}; launches "
                  f"{ {k: serve_launches[k] for k in SERVING_KERNELS} }; card {card_line}",
                  flush=True)
            if res["losses"] != want_losses:
                raise AssertionError(f"phase 18 (b): the job's losses {res['losses']} differ from "
                                     f"phase 7's {want_losses}")
            short = [k for k in TRAIN_KERNELS if res["launches"][k] != layers * JOBS_TRAIN_STEPS]
            if short or not (serve_launches["flash_fwd"] and serve_launches["decode_attention"]):
                raise AssertionError(f"phase 18 (b): launches in the child {res['launches']} "
                                     f"(want {layers} a step of each of {TRAIN_KERNELS}), in "
                                     f"the serve task {serve_launches}")
            if res["version"] != registered["version"] or \
                    [t.state for t in d.tasks] != ["SUCCESS"] * 4:
                raise AssertionError(f"phase 18 (b): registered {registered}, tasks "
                                     f"{[(t.task_id, t.state) for t in d.tasks]}")

            def must_not_run():
                raise AssertionError("a task downstream of a failed gate ran")

            with dag.DAG("gate-fails") as d2:
                sensor2 = dag.JobSuccessSensor("sensor", "train-lm", timeout_s=JOBS_WAIT_S,
                                               dag=d2)
                gate2 = dag.FeatureValidationResult("gate", "train_batch_shifted", dag=d2)
                sensor2 >> gate2 >> [dag.PythonOperator("serve", must_not_run, dag=d2),
                                     dag.PythonOperator("notify", must_not_run, dag=d2)]
            try:
                d2.run()
                raise AssertionError("phase 18 (b): the DAG with a failing gate ran to its end")
            except RuntimeError as e:
                failed = str(e)
            states = [(t.task_id, t.state) for t in d2.tasks]
            print(f"phase 18 (b) a second DAG whose gate reads a batch with ids offset past "
                  f"the vocabulary: '{failed}'; tasks {states}", flush=True)
            if [s for _, s in states] != ["SUCCESS", "FAILED", "SKIPPED", "SKIPPED"] or \
                    "validation FAILURE" not in failed:
                raise AssertionError(f"phase 18 (b): the failing gate left tasks {states}")

            # (c) the job lifecycle.
            t0 = time.perf_counter()
            lifecycle = _job_lifecycle(jobs, work)
            print(f"phase 18 (c) {lifecycle} ({time.perf_counter() - t0:.1f} s); card "
                  f"{card_line}", flush=True)

            # (d) a streaming runner drains the served and direct answers.
            t0 = time.perf_counter()
            records = [{"id": i, "source": src, "request": i % JOBS_REQUESTS, "tokens": toks}
                       for i, (src, toks) in enumerate(
                           [("served", a) for a in served["answers"]]
                           + [("direct", a) for a in want])]
            streamed = _stream_answers(beam, streaming, pubsub, records, work / "sink")
            print(f"phase 18 (d) {streamed} ({time.perf_counter() - t0:.1f} s); card "
                  f"{card_line}", flush=True)

            # (e) the train job's metrics plotted into its run directory,
            # where matplotlib is installed (plotting imports it).
            if importlib.util.find_spec("matplotlib") is None:
                print("phase 18 (e) left out: matplotlib is not installed on this machine",
                      flush=True)
            else:
                _plot_run(res, card_line)
    finally:
        if prior_lock is None:
            os.environ.pop(relaylock.ENV_LOCK_PATH, None)
        else:
            os.environ[relaylock.ENV_LOCK_PATH] = prior_lock
    if lock.exists():
        raise AssertionError(f"phase 18 (a): the relay lock {lock} outlived its holder")
    launches = {k: res["launches"].get(k, 0) + serve_launches.get(k, 0)
                for k in set(res["launches"]) | set(serve_launches)}
    phase_s = time.perf_counter() - t_phase
    print(f"phase 18 took {phase_s:.1f} s (budget {PHASE18_BUDGET_S:.0f} s); launches of the "
          f"path (the train job's child and the serve task) "
          f"{ {k: n for k, n in sorted(launches.items()) if n} }; card {card_line}", flush=True)
    if phase_s > PHASE18_BUDGET_S:
        raise AssertionError(f"phase 18 took {phase_s:.1f} s, over {PHASE18_BUDGET_S:.0f} s")
    return launches


PHASE19_BUDGET_S = 150.0
# Phase 19: the kernels every run of the example suite must launch.
EXAMPLE_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "decode_attention",
                   "decode_attention_q8")
# decode_bench's modes in phase 19 (its own defaults otherwise).
DECODE_MODES = {"bf16": [], "int8": ["--kv-dtype", "int8"],
                "continuous": ["--continuous", "--horizon", "8"], "valid-sweep": ["--valid-sweep"]}
# Examples that need a package the card's machine may lack.
EXAMPLE_NEEDS = {"plotting_tour": "matplotlib", "golden_parity": "sklearn",
                 "torch_mnist": "sklearn", "iris_sklearn": "sklearn"}


def _example_checks(torch, np, dev, work: Path, lacking: set[str]):
    """Phase 19's in-process examples other than ``decode_bench``, in
    order: ``(name, run)``, where ``run()`` drives the example on ``dev``
    and raises unless its outcome meets its test's assertions; returns a
    summary. (``pi`` runs as a job only: :func:`_start_example_jobs`.)"""
    import importlib

    import pandas as pd

    from hops_tpu_torch.runtime import config

    def ex(name):
        return importlib.import_module(f"examples_torch.{name}")

    def check(ok, name, got):
        if not ok:
            raise AssertionError(f"phase 19 {name}: {got}")

    def featurestore_tour():
        r = ex("featurestore_tour").main([], device=dev)
        check(r["feature_groups"] == 5 and r["td_splits"]["train"] > 0, "featurestore_tour", r)
        return f"{r['td_splits']}"

    def lm_serving():
        m = ex("lm_serving")
        r = m.main(device=dev)
        cyc = m.CYCLE
        check(r["accuracy"] > 0.9
              and r["continuation"][:8] == [cyc[(4 + i) % len(cyc)] for i in range(8)]
              and r["ragged"]["short"][:4] == [cyc[(2 + i) % 8] for i in range(4)]
              and r["ragged"]["long"][:4] == [cyc[(6 + i) % 8] for i in range(4)],
              "lm_serving", r)
        return f"accuracy {r['accuracy']:.3f}, continuation {r['continuation'][:8]}"

    def continuous_batching():
        r = ex("continuous_batching").main(device=dev)
        check(r["parity"] == r["requests"] == 6 and r["dispatches"] < r["naive_dispatches"]
              and r["spec_parity"] == 6 and r["spec_dispatches"] <= r["dispatches"]
              and r["paged_parity"] == 6, "continuous_batching", r)
        return (f"parity {r['parity']}/6, dispatches {r['dispatches']} (naive "
                f"{r['naive_dispatches']}), speculative {r['spec_parity']}/6, paged "
                f"{r['paged_parity']}/6")

    def preemptible_training():
        r = ex("preemptible_training").main(num_steps=8, preempt_at=3, device=dev)
        got = (r["first"]["steps_completed"], r["second"]["steps_completed"],
               r["second"]["optimizer_steps"])
        check(got == (3, 8, 8), "preemptible_training", r)
        return f"steps {got}"

    def continuous_training():
        r = ex("continuous_training").main(records=24, span_records=4, eval_every=2, device=dev)
        # The example points the runtime at a workspace of its own: back to the phase's.
        config.configure(workspace=str(work / "workspace"), project="chip_smoke_examples")
        outcomes = [o for _, o in r["gates"]]
        check(r["records_trained"] == 24 and r["ledger"]["contiguous"]
              and r["ledger"]["disjoint"] and r["held_back"] == 1
              and r["published_versions"] == outcomes.count("pass"), "continuous_training", r)
        return f"{r['records_trained']} records, gates {r['gates']}"

    def batch_inference():
        r = ex("batch_inference").main(n_images=70, per_chip_batch=4, device=dev)
        df = pd.read_parquet(r["path"])
        check(r["rows"] == 70 and set(df.columns) == {"image_id", "prediction", "probability"}
              and df["prediction"].between(0, 9).all()
              and df["probability"].between(0.0, 1.0).all()
              and r["lm_generated"] == [6, 4, 8], "batch_inference", r)
        return f"{r['rows']} rows, LM tokens {r['lm_generated']}"

    def long_context_lm():
        r = ex("long_context_lm").main(seq_len=256, steps=2, device=dev)
        check(np.isfinite(r["loss"]) and r["mesh"] == {"data": 1, "seq": 1},
              "long_context_lm", r)
        return f"loss {r['loss']:.4f} on {r['mesh']}"

    def golden_parity():
        m = ex("golden_parity")
        r = m.main(device=dev)
        check(r["ffn"] >= m.GOLDEN_FFN and r["cnn"] >= m.GOLDEN_CNN, "golden_parity", r)
        return f"FFN {r['ffn']:.4f} (>= {m.GOLDEN_FFN}), CNN {r['cnn']:.4f} (>= {m.GOLDEN_CNN})"

    def torch_mnist():
        r = ex("torch_mnist").main(generations=1, population=4, device=dev)
        check(r["launch"]["accuracy"] > 0.85 and r["de"]["best_metric"] > 0.85
              and 1e-4 <= r["de"]["best_config"]["lr"] <= 1e-2, "torch_mnist", r)
        return f"launch {r['launch']['accuracy']:.3f}, DE best {r['de']['best_metric']:.3f}"

    def lagom_search():
        r = ex("lagom_search").main(device=dev)
        check(r["best_metric"] > 0.5
              and r["best_config"].keys() == {"kernel", "pool", "dropout"}, "lagom_search", r)
        return f"best {r['best_metric']:.4f} at {r['best_config']}"

    def taxi_pipeline():
        r = ex("taxi_pipeline").main(device=dev)
        check(r["metrics"]["accuracy"] > 0.5 and r["best"]["version"] == 1, "taxi_pipeline", r)
        return f"accuracy {r['metrics']['accuracy']:.3f}"

    def iris_sklearn():
        r = ex("iris_sklearn").main(device=dev)
        check(r["accuracy"] > 0.9 and len(r["predictions"]) == 3, "iris_sklearn", r)
        return f"accuracy {r['accuracy']:.3f}, predictions {r['predictions']}"

    def plotting_tour():
        r = ex("plotting_tour").main(device=dev)
        check(len(r["figures"]) == 3
              and all(Path(f).read_bytes()[:4] == PNG_MAGIC for f in r["figures"]),
              "plotting_tour", r)
        return f"{len(r['figures'])} PNGs"

    def mnist_pipeline():
        r = ex("mnist_pipeline").main(device=dev)
        check(len(r["predictions"]) == 2 and r["logged"] >= 1, "mnist_pipeline", r)
        return f"accuracy {r['metrics']['accuracy']:.3f}, {r['logged']} logged"

    def distributed_training():
        r = ex("distributed_training").main(device=dev)
        check(all(np.isfinite(r[k]["loss"]) for k in ("mirrored", "collective")),
              "distributed_training", r)
        return f"mirrored {r['mirrored']['metric']:.3f}, collective {r['collective']['metric']:.3f}"

    def feature_serving():
        r = ex("feature_serving").main([], device=dev)
        check(r["online_matches_offline"] and len(r["predictions"]) == 3, "feature_serving", r)
        return f"{r['entities']} entities online"

    order = (featurestore_tour, lm_serving, continuous_batching, preemptible_training,
             batch_inference, long_context_lm, golden_parity, torch_mnist, lagom_search,
             taxi_pipeline, iris_sklearn, plotting_tour, mnist_pipeline, distributed_training,
             feature_serving, continuous_training)
    return [(fn.__name__, fn) for fn in order if EXAMPLE_NEEDS.get(fn.__name__) not in lacking]


def _start_example_jobs(work: Path, dev) -> list[tuple[str, str, str, str]]:
    """Phase 19's job children, started first so their interpreters come
    up while the in-process examples run: the feature-store tour with
    ``--td-version 2`` and ``pi`` from a staged workspace. Returns
    ``(example, job, execution id, the line its output must hold)``."""
    from hops_tpu_torch import jobs
    from hops_tpu_torch.jobs import api, dataset

    ws = work / "pi_ws"
    ws.mkdir(parents=True, exist_ok=True)
    for name in ("pi.py", "pi_util.py"):
        (ws / name).write_text((ROOT / "examples_torch" / name).read_text())
    staged = dataset.upload_workspace(ws, "Resources", name="pi_program.zip")
    rundir = dataset.extract(staged, work / "pi_run")
    started = []
    for example, job, app, args, expect in (
            ("featurestore_tour", "fs_tour", ROOT / "examples_torch/featurestore_tour.py",
             ["--td-version", "2"], "tour complete"),
            ("pi", "pi_job", Path(rundir) / "pi.py", ["200000"], "pi is roughly 3.1")):
        jobs.create_job(job, api.JobConfig(app_file=str(app),
                                           default_args=[*args, "--device", str(dev)]))
        started.append((example, job, jobs.start_job(job).execution_id, expect))
    return started


def examples_phase(A, torch, np, dev, card_line: str) -> dict[str, int]:
    """Phase 19; returns the launch counts of its path."""
    import importlib.util
    import os

    from hops_tpu_torch.runtime import config, relaylock

    t_phase = time.perf_counter()
    work = ROOT / "_smoke" / "examples"
    work.mkdir(parents=True, exist_ok=True)
    config.configure(workspace=str(work / "workspace"), project="chip_smoke_examples")
    lacking = {pkg for pkg in set(EXAMPLE_NEEDS.values()) if importlib.util.find_spec(pkg) is None}
    print("phase 19 left out: " + (", ".join(
        f"{name} (needs {pkg}, not installed on this machine)"
        for name, pkg in EXAMPLE_NEEDS.items() if pkg in lacking) or "nothing"), flush=True)
    lock = work / "relay.lock"
    prior_lock = os.environ.get(relaylock.ENV_LOCK_PATH)
    os.environ[relaylock.ENV_LOCK_PATH] = str(lock)
    A.reset_launch_counts()
    try:
        from hops_tpu_torch import jobs

        pending = _start_example_jobs(work, dev)
        for name, run in _example_checks(torch, np, dev, work, lacking):
            t0, before = time.perf_counter(), A.launch_counts()
            summary = run()
            torch.cuda.synchronize()
            delta = {k: n - before[k] for k, n in A.launch_counts().items() if n > before[k]}
            print(f"phase 19 {name}: {summary}; {time.perf_counter() - t0:.1f} s; launches "
                  f"{delta}", flush=True)
        for name, job, execution_id, expect in pending:
            done = jobs.wait_for_completion(job, execution_id, timeout_s=PHASE19_BUDGET_S)
            if not (done.state == "FINISHED" and expect in done.stdout()):
                raise AssertionError(f"phase 19 {name} as a job: {done.state}\n"
                                     f"{done.stdout()[-2000:]}")
            print(f"phase 19 {name} as a job: {done.state}, {done.stdout().strip().splitlines()[-1]!r}; "
                  f"{done.finished_at - done.submitted_at:.1f} s submit to exit (a child on "
                  f"{dev}); card {card_line}", flush=True)
        # decode_bench last: no job child shares the card while it times.
        from examples_torch import decode_bench

        for mode, argv in DECODE_MODES.items():
            t0, before = time.perf_counter(), A.launch_counts()
            r = decode_bench.main(argv, device=dev)
            delta = {k: n - before[k] for k, n in A.launch_counts().items() if n > before[k]}
            took = f"{time.perf_counter() - t0:.1f} s; launches {delta}; card {card_line}"
            if mode == "valid-sweep":
                for row in r["rows"]:
                    print(f"phase 19 decode_bench valid-sweep capacity {r['capacity']} head_dim "
                          f"{r['head_dim']} valid_len {row['valid_len']}: "
                          f"{row['us_per_step']:.1f} us/step, {row['gb']:.4f} GB read "
                          f"({row['gb'] / row['us_per_step'] * 1e6:.1f} GB/s); card "
                          f"{card_line}", flush=True)
                c = r["control"]
                print(f"phase 19 decode_bench valid-sweep control valid_len {c['valid_len']}: "
                      f"capacity {r['capacity']} {c['us_big_cap']:.1f} us/step, capacity "
                      f"{r['capacity'] // 4} {c['us_small_cap']:.1f} us/step (ratio "
                      f"{c['ratio']:.2f}); {took}", flush=True)
            elif mode == "continuous":
                ok = [len(s) for s in r["streams"]] == [b for _, b in r["requests"]]
                if not ok:
                    raise AssertionError(f"phase 19 decode_bench continuous: stream lengths "
                                         f"{[len(s) for s in r['streams']]}")
                print(f"phase 19 decode_bench continuous --horizon 8: engine "
                      f"{r['engine_tokens_per_s']:.1f} tokens/s ({r['dispatches']} dispatches, "
                      f"{r['admission_waves']} admission waves), static "
                      f"{r['static_tokens_per_s']:.1f} tokens/s; {took}", flush=True)
            else:
                c = r["config"]
                print(f"phase 19 decode_bench {mode}: {r['ms_per_token_step']:.3f} ms per token "
                      f"step, {r['tokens_per_s']:.1f} tokens/s (batch {c['batch']}, prompt "
                      f"{c['prompt']}, {c['tokens']} tokens, d_model {c['d_model']}, "
                      f"{c['num_heads']} heads of {c['d_model'] // c['num_heads']}, "
                      f"{c['num_layers']} layers, vocab {c['vocab_size']}, capacity "
                      f"{c['max_decode_len']}, cache {c['kv_cache_dtype'] or c['dtype']}); "
                      f"{took}", flush=True)
                rep = r["roofline"]
                for c in rep["categories"]:
                    rate = ("-" if c["peak_share"] is None
                            else f"{c['peak_share']:.1%} of its roof ({c['bound']})")
                    print(f"phase 19 decode_bench {mode} roofline {c['name']}: {c['count']:.1f} "
                          f"launches, {c['ms']:.4f} ms per token step ({c['share']:.1%}), "
                          f"{rate}; card {card_line}", flush=True)
                print(f"phase 19 decode_bench {mode} roofline total {rep['total_ms']:.4f} ms per "
                      f"token step against a best case of {rep['roofline_ms']:.4f} ms for the "
                      f"counted categories; card {card_line}", flush=True)
        launches = A.launch_counts()
    finally:
        if prior_lock is None:
            os.environ.pop(relaylock.ENV_LOCK_PATH, None)
        else:
            os.environ[relaylock.ENV_LOCK_PATH] = prior_lock
    if lock.exists():
        raise AssertionError(f"phase 19: the relay lock {lock} outlived its holder")
    missing = [k for k in EXAMPLE_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"phase 19: the examples never launched {missing}: {launches}")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 19 took {phase_s:.1f} s (budget {PHASE19_BUDGET_S:.0f} s); launches of the "
          f"path {({k: n for k, n in sorted(launches.items()) if n})}; card {card_line}",
          flush=True)
    if phase_s > PHASE19_BUDGET_S:
        raise AssertionError(f"phase 19 took {phase_s:.1f} s, over {PHASE19_BUDGET_S:.0f} s")
    return launches


def time_prefix_append(A, torch, gen, dev, launches, worst) -> dict:
    """Phase 5's row for K4's wide calls (K1's forward body over the bf16
    cache) at a dense prefix's suffix append: the first request's suffix
    (its 2048 bucket, cut to the room past the prefix) against a cache of
    one row holding the prefix, causal with the offset. Under
    ``gqa_verify``, the same kernel at a GQA speculative verify: 8 query
    heads on 2 kv heads, ``SPEC_K + 1`` tokens (20 rows), 4 slots at
    phase 5's decode lengths; its yardstick runs on the kv heads
    broadcast to the query heads (not timed)."""
    F = torch.nn.functional
    h, d, cap = MODEL["num_heads"], MODEL["d_model"] // MODEL["num_heads"], MODEL["max_decode_len"]
    name = "decode_attention_chunk"

    def held(q, k, v, vl, what):
        o = A.decode_attention(q, k, v, vl)
        f = [t.float() for t in (q, k, v)]
        ref = A.decode_attention_reference(*f, vl)
        mag = A.decode_attention_reference(*f[:2], f[2].abs(), vl)
        err, ratio, ok = rounding_close(o, ref, mag, FP32_ATOL)
        if not ok:
            raise AssertionError(f"{name} at {what}: err/rounding bound {ratio:.3f}")
        worst[name]["bfloat16"] = max(worst[name]["bfloat16"], err)

    s = cap - PREFIX_LEN
    vl = PREFIX_LEN + s
    vlt = torch.tensor([vl], dtype=torch.int32, device=dev)
    q = torch.randn(1, h, s, d, generator=gen).to(dev, torch.bfloat16)
    k, v = (torch.randn(1, h, cap, d, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    held(q, k, v, vlt, "the prefix append")
    rows_q = torch.arange(s, device=dev)[:, None] + (vl - s)
    mask = torch.arange(vl, device=dev)[None, :] <= rows_q
    pairs = h * (s * (vl - s) + s * (s + 1) // 2)
    nbytes = 2 * h * s * d * 2 + 2 * h * vl * d * 2 + 4
    row = dict(
        name=name, route="cuda", source="hops_tpu_torch/ops/csrc/flash_fwd_tc.cuh",
        replaces="hops_tpu/ops/attention.py:643",
        shape=f"q (1,{h},{s},{d}) bf16 against cache (1,{h},{cap},{d}), valid_len {vl} "
              f"(a suffix appended to a {PREFIX_LEN}-token prefix)",
        launches=launches[name],
        ms=cuda_ms(lambda i=0: A.decode_attention(q, k, v, vlt), 20),
        plain_ms=cuda_ms(lambda i=0: A.decode_attention_reference(q, k, v, vlt), 3),
        library_ms=cuda_ms(lambda i=0: F.scaled_dot_product_attention(
            q, k[:, :, :vl], v[:, :, :vl], attn_mask=mask), 20),
        **bound(4 * d * pairs, nbytes),
    )

    # A GQA speculative verify: SPEC_K + 1 tokens of 4 slots, 4 query
    # heads per kv head.
    b, hkv, sv = 4, 2, SPEC_K + 1
    vl_host = [p + n // 2 for p, n in zip(PROMPT_LENS[:4], NEW_TOKENS[:4])]
    vlg = torch.tensor(vl_host, dtype=torch.int32, device=dev)
    qg = torch.randn(b, h, sv, d, generator=gen).to(dev, torch.bfloat16)
    kg, vg = (torch.randn(b, hkv, cap, d, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    held(qg, kg, vg, vlg, "the GQA verify")
    kb, vb = A.repeat_kv(qg, kg, vg)
    qpos = vlg[:, None] - sv + torch.arange(sv, device=dev)[None, :]  # (b, sv)
    maskg = (torch.arange(cap, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
    pairs = h * sum(sv * (n - sv) + sv * (sv + 1) // 2 for n in vl_host)
    nbytes = 2 * b * h * sv * d * 2 + 2 * hkv * d * 2 * sum(vl_host) + 4 * b
    row["gqa_verify"] = dict(
        shape=f"q ({b},{h},{sv},{d}) bf16 against cache ({b},{hkv},{cap},{d}), "
              f"valid_len {vl_host} (rows {h // hkv * sv})",
        ms=cuda_ms(lambda i=0: A.decode_attention(qg, kg, vg, vlg), 60),
        plain_ms=cuda_ms(lambda i=0: A.decode_attention_reference(qg, kg, vg, vlg), 12),
        library_ms=cuda_ms(lambda i=0: F.scaled_dot_product_attention(
            qg, kb, vb, attn_mask=maskg), 60),
        **bound(4 * d * pairs, nbytes),
    )
    row["max_abs_err"] = worst[name]["bfloat16"]
    return row


def bytecode_cache(os) -> Path | None:
    """Where the interpreter writes no bytecode (``PYTHONDONTWRITEBYTECODE``)
    and the installed packages carry none, every Python process compiles
    torch's ~2,100 modules from source, seconds of each start, and this
    script starts dozens (launch ranks, fleet replicas, job children).
    Then it keeps one bytecode cache under ``_smoke/pycache`` for itself
    and every process it starts (they inherit the environment), removed
    with ``_smoke``; the installed packages and the checkout are left as
    they are. Returns the cache's directory, or None where bytecode is
    written already."""
    if not (sys.flags.dont_write_bytecode or os.environ.get("PYTHONDONTWRITEBYTECODE")):
        return None
    pycache = ROOT / "_smoke" / "pycache"
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(pycache)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(pycache)
    return pycache


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distribute-worker", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--scaleout-worker", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--model-parallel-worker", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--jobs-worker", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()

    # cuBLAS is deterministic on one stream only with a fixed workspace
    # (phase 9 runs under torch.use_deterministic_algorithms); set before
    # the first cuBLAS call. 8 x 4 MiB is PyTorch's own size on Hopper.
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    pycache = bytecode_cache(os)
    import torch

    if not torch.cuda.is_available():
        if pycache is not None:
            shutil.rmtree(ROOT / "_smoke", ignore_errors=True)
        return fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    if not (ROOT / "hops_tpu_torch" / "ops" / "csrc").is_dir():
        return fail(f"no hops_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    if args.distribute_worker:  # phase 12's child, under python -m hops_tpu_torch.launch
        return distribute_worker(args.distribute_worker)
    if args.scaleout_worker:  # phase 13's child, likewise
        return scaleout_worker(args.scaleout_worker)
    if args.model_parallel_worker:  # phase 14's children, ranks 0 and 1 of a gloo group
        return model_parallel_worker(args.model_parallel_worker, args.rank)
    if args.jobs_worker:  # phase 18's train job, started by jobs.start_job
        return jobs_worker(args.jobs_worker)
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
        check_narrow_heads(A, torch, gen, dev, "flash", worst)
    print("phase 3b ok: worst error " + ", ".join(
        f"{k} {worst[k]['bfloat16']:.3e} (bf16) {worst[k]['float32']:.3e} (fp32)"
        for k in ("flash_bwd_dq", "flash_bwd_dkv")
    ), flush=True)
    print("phase 3c int8 and paged decode kernels against plain versions (bf16 and fp32 in, "
          "fp32 plain):", flush=True)
    with torch.inference_mode():
        worst.update(check_cache_kernels(A, torch, gen, dev))
        check_narrow_heads(A, torch, gen, dev, "cache", worst)
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
        phase7: dict = {}
        train_launches = train_slice(A, torch, np, params, dev, args.seed, card_line, phase7)
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
        cache_answers: dict = {}
        slice_launches = serve_cache_slices(A, torch, art, prompts, instances, answers,
                                            dense_bytes, dev, card_line, cache_answers)
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
        print("phase 10 levers:", flush=True)
        kept: dict = {}
        lever_launches = levers_phase(A, torch, art, params, prompts, instances, answers,
                                      dev, card_line, kept)
        print("phase 10 ok", flush=True)
        torch.cuda.empty_cache()
        with torch.inference_mode():
            wide_row = time_prefix_append(A, torch, gen, dev, lever_launches, worst)
        for r in (wide_row, wide_row["gqa_verify"]):
            print(f"phase 5 {wide_row['name']} at {r['shape']}: {r['ms']:.4f} ms; "
                  + (f"{r['launches']} launches in phase 10; " if "launches" in r else "")
                  + f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); plain "
                  f"{r['plain_ms']:.4f} ms; scaled_dot_product_attention {r['library_ms']:.4f} ms"
                  + (" (on the broadcast kv heads)" if r is not wide_row else "")
                  + f"; card {card_line}", flush=True)
        torch.cuda.empty_cache()
        print("phase 11 serving:", flush=True)
        http_launches = serving_phase(A, torch, art, params, prompts, instances, answers,
                                      kept["prefix"], kept["prefix_want"], dev, args.seed,
                                      card_line, kept)
        print("phase 11 ok", flush=True)
        torch.cuda.empty_cache()
        print("phase 12 distribute:", flush=True)
        dist_launches = distribute_phase(A, torch, art, prompts, answers, dev, args.seed,
                                         card_line, phase7)
        print("phase 12 ok", flush=True)
        torch.cuda.empty_cache()
        print("phase 13 scale-out:", flush=True)
        scale = scaleout_phase(A, torch, art, prompts, args.seed, card_line)
        print("phase 13 ok", flush=True)
        torch.cuda.empty_cache()
        print("phase 14 model parallel:", flush=True)
        mp = model_parallel_phase(A, torch, art, prompts, answers, cache_answers, args.seed,
                                  card_line, phase7)
        print("phase 14 ok", flush=True)
        torch.cuda.empty_cache()
        print("phase 15 search:", flush=True)
        search_launches = search_phase(A, torch, np, params, dev, args.seed, card_line)
        print("phase 15 ok", flush=True)
        torch.cuda.empty_cache()
        print("phase 16 feature store:", flush=True)
        feature_phase(A, torch, np, dev, args.seed, card_line)
        print("phase 16 ok", flush=True)
        torch.cuda.empty_cache()
        print("phase 17 fleet, placement and the closed loop:", flush=True)
        fleet_launches = fleet_phase(A, torch, np, art, prompts, instances, answers,
                                     kept["http_s"], dev, args.seed, card_line)
        print("phase 17 ok", flush=True)
        torch.cuda.empty_cache()
        print("phase 18 jobs, DAGs, streaming runners, TLS, the relay lock and the compat "
              "shims:", flush=True)
        job_launches = jobs_phase(A, torch, np, art, prompts, instances, dev, args.seed,
                                  card_line, phase7)
        print("phase 18 ok", flush=True)
        torch.cuda.empty_cache()
        print("phase 19 examples:", flush=True)
        example_launches = examples_phase(A, torch, np, dev, card_line)
        print("phase 19 ok", flush=True)
        k1, k4 = rows
        k1["launches_by_path"] = {"serving": k1["launches"], "training": train_launches["flash_fwd"],
                                  "launch": launch_launches["flash_fwd"]}
        k1["launches"] += train_launches["flash_fwd"] + launch_launches["flash_fwd"]
        for r in bwd_rows:
            r["launches_by_path"] = {"training": r["launches"],
                                     "launch": launch_launches[r["name"]]}
            r["launches"] += launch_launches[r["name"]]
        for r, path in ((k1, None), (k4, "serving"), *((r, "caches") for r in cache_rows)):
            if path:
                r["launches_by_path"] = {path: r["launches"]}
            r["launches_by_path"]["levers"] = lever_launches[r["name"]]
            r["launches"] += lever_launches[r["name"]]
        wide_row["launches_by_path"] = {"levers": wide_row["launches"]}
        for r in (k1, k4, wide_row):
            r["launches_by_path"]["http"] = http_launches[r["name"]]
            r["launches"] += http_launches[r["name"]]
        for r in (k1, *bwd_rows, k4, wide_row):
            r["launches_by_path"]["distribute"] = dist_launches[r["name"]]
            r["launches"] += dist_launches[r["name"]]
        for r in (k1, *bwd_rows, k4, wide_row, *cache_rows):
            for path in ("sp", "moe"):
                r["launches_by_path"][path] = scale[path].get(r["name"], 0)
                r["launches"] += scale[path].get(r["name"], 0)
            for path in ("tp", "pp"):
                r["launches_by_path"][path] = mp[path].get(r["name"], 0)
                r["launches"] += mp[path].get(r["name"], 0)
        for r in (k1, *bwd_rows):
            r["launches_by_path"]["search"] = search_launches[r["name"]]
            r["launches"] += search_launches[r["name"]]
        for r in (k1, *bwd_rows, k4):
            r["launches_by_path"]["fleet"] = fleet_launches.get(r["name"], 0)
            r["launches"] += fleet_launches.get(r["name"], 0)
            r["launches_by_path"]["jobs"] = job_launches.get(r["name"], 0)
            r["launches"] += job_launches.get(r["name"], 0)
        rows = [k1, *bwd_rows, k4, wide_row, *cache_rows]
        for r in rows:
            r["launches_by_path"]["examples"] = example_launches.get(r["name"], 0)
            r["launches"] += example_launches.get(r["name"], 0)
    finally:
        if predictor is not None:
            predictor.stop()
        shutil.rmtree(ROOT / "_smoke", ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "launches_by_path", "gqa_verify")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
