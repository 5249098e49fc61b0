"""Pipeline schedule tables: gpipe / 1F1B / interleaved (a copy of
``hops_tpu/parallel/pp_schedule.py``, which imports only numpy).

The scheduled pipeline engine (:func:`hops_tpu_torch.parallel.pipeline.
make_pp_lm_train_step` with ``schedule=...``) runs an explicit
forward/backward tick program instead of differentiating through the
fill-drain ring. This module builds the *static* per-tick action tables
that program follows, entirely host-side:

- a **virtual stage** ``vs`` lives on device ``vs % S`` as chunk
  ``vs // S`` (Megatron interleaved placement; ``v=1`` makes chunk 0 the
  only chunk and reduces to plain stage order);
- each tick every device executes at most one forward and one backward
  *work slot* (masked no-ops when its table entry is ``-1``);
- activations/cotangents hop one device down/up the rotated ring per
  tick, so an action's products are consumable from the next tick on.

Three policies (arXiv:1909.09756's pipelining recipe; 1F1B/interleaved
per Megatron-LM):

- ``gpipe`` — *sequential*: a device starts backward work only after
  ALL its forward microbatches are done (fill, then drain). This is the
  bit-exact reference schedule the others are tested against.
- ``1f1b`` — backward as early as possible, forwards throttled to keep
  at most ``S - s`` microbatches in flight on device ``s`` (the classic
  warmup/steady/cooldown shape, bounding live activations).
- ``interleaved`` — ``v`` chunks per device (default 2): forwards
  proceed chunk-major over groups of ``S`` microbatches, shrinking the
  fill/drain bubble by ~``1/v`` at the price of ``v``× ring traffic.

Backward order is microbatch-ascending per (device, chunk) under every
policy — the property that makes gradients bit-identical across
schedules (float accumulation order never changes, only *when* the work
happens).

The tables double as the bubble model: :attr:`PipelineSchedule.
bubble_fraction` is the fraction of work slots that are idle, exported
as ``hops_tpu_pp_bubble_fraction{schedule=...}``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """Static tick program for the scheduled pipeline engine.

    All tables have shape ``(ticks, n_stages)`` with ``-1`` meaning "no
    action in this slot this tick". ``f_*`` are the forward slot's
    chunk/microbatch, ``b_*`` the backward slot's; ``in_f_*`` /
    ``in_b_*`` describe what the incoming ring message (sent at the
    previous tick) contains, so the engine knows where to store it.
    """

    kind: str
    num_microbatches: int
    n_stages: int
    v: int
    f_chunk: np.ndarray
    f_mb: np.ndarray
    b_chunk: np.ndarray
    b_mb: np.ndarray
    in_f_chunk: np.ndarray
    in_f_mb: np.ndarray
    in_b_chunk: np.ndarray
    in_b_mb: np.ndarray

    @property
    def n_virtual(self) -> int:
        return self.n_stages * self.v

    @property
    def ticks(self) -> int:
        return int(self.f_chunk.shape[0])

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of work slots: each device offers 2 slots per
        tick (one F, one B) and owes ``2 * m * v`` units of work."""
        total = 2 * self.ticks * self.n_stages
        useful = 2 * self.num_microbatches * self.v * self.n_stages
        return 1.0 - useful / total

    def microbatch_work_units(self) -> int:
        """Useful work units per device (F+B per microbatch per chunk) —
        the denominator for per-microbatch step-time attribution."""
        return 2 * self.num_microbatches * self.v

    @property
    def peak_in_flight(self) -> int:
        """Max microbatches any device holds forward-done-backward-
        pending at once — the live-activation high-water mark. 1F1B's
        win over gpipe at equal bubble: O(S) instead of O(m)."""
        peak = 0
        for dev in range(self.n_stages):
            live = 0
            for t in range(self.ticks):
                if self.f_chunk[t, dev] >= 0:
                    live += 1
                if self.b_chunk[t, dev] >= 0:
                    live -= 1
                peak = max(peak, live)
        return peak


def build_pp_schedule(
    kind: str, num_microbatches: int, n_stages: int, v: int | None = None
) -> PipelineSchedule:
    """Simulate the policy into per-tick tables (see module docstring).

    The simulator is dependency-exact: ``F(vs, mb)`` needs ``F(vs-1,
    mb)`` to have completed on an earlier tick (one ring hop), ``B(vs,
    mb)`` needs its own ``F`` (stored activation + loss seed on the
    last virtual stage) and ``B(vs+1, mb)`` from an earlier tick. A
    policy violating its own dependencies would deadlock; this function
    asserts termination.
    """
    m, s_n = num_microbatches, n_stages
    if kind not in ("gpipe", "1f1b", "interleaved"):
        raise ValueError(
            f"schedule must be gpipe|1f1b|interleaved, got {kind!r}")
    v = v if v is not None else (2 if kind == "interleaved" else 1)
    if v < 1:
        raise ValueError(f"virtual stages must be >= 1, got {v}")
    V = s_n * v

    done_f: dict[tuple[int, int], int] = {}  # (vs, mb) -> tick completed
    done_b: dict[tuple[int, int], int] = {}

    def f_ready(vs: int, mb: int, t: int) -> bool:
        return vs == 0 or done_f.get((vs - 1, mb), t) < t

    def b_ready(vs: int, mb: int, t: int) -> bool:
        if done_f.get((vs, mb), t) >= t:
            return False  # activation (and, on the last vs, the seed)
        if vs == V - 1:
            return True
        return done_b.get((vs + 1, mb), t) < t

    def f_order_key(chunk: int, mb: int) -> tuple:
        if kind == "interleaved":
            # Chunk-major over groups of S microbatches (Megatron).
            return (mb // s_n, chunk, mb)
        return (mb, chunk)

    def inflight_cap(dev: int) -> int:
        if kind == "gpipe":
            return m * v
        if kind == "1f1b":
            return s_n - dev
        return (s_n - dev) + (v - 1) * s_n  # interleaved warmup depth

    rows_f, rows_b = [], []
    t = 0
    limit = 8 * (m * v + V) + 16
    while len(done_b) < m * V:
        assert t < limit, f"{kind} schedule did not converge (deadlock?)"
        row_f = [(-1, -1)] * s_n
        row_b = [(-1, -1)] * s_n
        for dev in range(s_n):
            chunks = [j * s_n + dev for j in range(v)]
            # Backward slot: smallest microbatch first, deepest chunk on
            # ties — keeps per-(device, chunk) backward order
            # microbatch-ascending (the bit-identity invariant).
            b_cands = sorted(
                (
                    (mb, -(vs // s_n))
                    for vs in chunks
                    for mb in range(m)
                    if (vs, mb) not in done_b and b_ready(vs, mb, t)
                ),
            )
            if b_cands and (
                kind != "gpipe"
                or all((vs, mb) in done_f for vs in chunks for mb in range(m))
            ):
                mb, negc = b_cands[0]
                row_b[dev] = (-negc, mb)
            # Forward slot, policy-ordered and throttled.
            in_flight = sum(
                1
                for vs in chunks
                for mb in range(m)
                if (vs, mb) in done_f and (vs, mb) not in done_b
            )
            if in_flight < inflight_cap(dev):
                f_cands = sorted(
                    (
                        (f_order_key(vs // s_n, mb), vs // s_n, mb)
                        for vs in chunks
                        for mb in range(m)
                        if (vs, mb) not in done_f and f_ready(vs, mb, t)
                    ),
                )
                if f_cands:
                    _, chunk, mb = f_cands[0]
                    row_f[dev] = (chunk, mb)
        for dev in range(s_n):
            if row_f[dev][0] >= 0:
                c, mb = row_f[dev]
                done_f[(c * s_n + dev, mb)] = t
            if row_b[dev][0] >= 0:
                c, mb = row_b[dev]
                done_b[(c * s_n + dev, mb)] = t
        rows_f.append(row_f)
        rows_b.append(row_b)
        t += 1

    T = len(rows_f)
    f_chunk = np.array([[a for a, _ in r] for r in rows_f], np.int32)
    f_mb = np.array([[b for _, b in r] for r in rows_f], np.int32)
    b_chunk = np.array([[a for a, _ in r] for r in rows_b], np.int32)
    b_mb = np.array([[b for _, b in r] for r in rows_b], np.int32)

    # Incoming-message tables: what the ring delivers at tick t is what
    # the neighbor produced at t-1, retargeted one virtual stage on.
    in_f_chunk = np.full((T, s_n), -1, np.int32)
    in_f_mb = np.full((T, s_n), -1, np.int32)
    in_b_chunk = np.full((T, s_n), -1, np.int32)
    in_b_mb = np.full((T, s_n), -1, np.int32)
    for t in range(1, T):
        for dev in range(s_n):
            src = (dev - 1) % s_n
            c, mb = f_chunk[t - 1, src], f_mb[t - 1, src]
            if c >= 0:
                vs = c * s_n + src
                if vs + 1 <= V - 1:  # the last vs consumes its own output
                    tc = c + 1 if dev == 0 else c
                    if 0 <= tc < v and (tc * s_n + dev) == vs + 1:
                        in_f_chunk[t, dev] = tc
                        in_f_mb[t, dev] = mb
            src = (dev + 1) % s_n
            c, mb = b_chunk[t - 1, src], b_mb[t - 1, src]
            if c >= 0:
                vs = c * s_n + src
                if vs - 1 >= 0:  # vs 0's input cotangent feeds the embed
                    tc = c - 1 if dev == s_n - 1 else c
                    if 0 <= tc < v and (tc * s_n + dev) == vs - 1:
                        in_b_chunk[t, dev] = tc
                        in_b_mb[t, dev] = mb

    return PipelineSchedule(
        kind=kind, num_microbatches=m, n_stages=s_n, v=v,
        f_chunk=f_chunk, f_mb=f_mb, b_chunk=b_chunk, b_mb=b_mb,
        in_f_chunk=in_f_chunk, in_f_mb=in_f_mb,
        in_b_chunk=in_b_chunk, in_b_mb=in_b_mb,
    )
