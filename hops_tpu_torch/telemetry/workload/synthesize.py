"""Scenario synthesis: workload artifacts for what capture can't see
(a copy of ``hops_tpu/telemetry/workload/synthesize.py``).

Capture replays yesterday; these generators write artifacts in the
SAME schema (via :class:`WorkloadRecorder`, so rotation/manifest/
verification are one code path) for the traffic shapes worth testing
before they happen:

- ``diurnal`` — a sinusoidal rate ramp (trough → peak → trough over
  ``duration_s``): does autoscaling track the curve or oscillate?
- ``herd`` — steady load with a thundering-herd burst at the midpoint
  (the post-rollout reconnect stampede): does admission shed or
  collapse?
- ``hot_key`` — feature-join entity IDs with hot-key skew
  (``hot_frac`` of requests hit ``hot_keys`` entities): does the
  online store's sharding melt on one shard?
- ``tenant_spray`` — adversarial unique-tenant-per-request spray: do
  per-tenant rate limits and metric labels stay bounded?

Every generator is fully seeded (SHA-256-derived RNG, the replay
engine's discipline): same params + seed ⇒ byte-identical artifact.
Records carry arrival times, tenants, and payload shapes but no
outcomes (``status``/``latency_ms`` absent) — the recorded-vs-replayed
comparison simply omits its recorded column for synthetic artifacts.
"""

from __future__ import annotations

import hashlib
import math
import random
from pathlib import Path
from typing import Any, Callable

from hops_tpu_torch.telemetry.workload.capture import WorkloadRecorder


def _rng(seed: int, scenario: str) -> random.Random:
    digest = hashlib.sha256(f"synth:{scenario}:{seed}".encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


def _poisson_arrivals(rng: random.Random, rate_fn: Callable[[float], float],
                      duration_s: float, bins: int = 256) -> list[float]:
    """Inhomogeneous Poisson arrivals by per-bin thinning: split
    ``duration_s`` into ``bins``, draw a Poisson-ish count at the
    bin-center rate, place arrivals uniformly inside the bin."""
    arrivals: list[float] = []
    dt = duration_s / bins
    for b in range(bins):
        t_mid = (b + 0.5) * dt
        lam = max(0.0, rate_fn(t_mid)) * dt
        # Knuth's method is exact and stdlib-only; lam stays small
        # because bins are fine-grained.
        n, p, threshold = 0, 1.0, math.exp(-lam)
        while True:
            p *= rng.random()
            if p <= threshold:
                break
            n += 1
        arrivals.extend(b * dt + rng.random() * dt for _ in range(n))
    arrivals.sort()
    return arrivals


def _dense_payload(rng: random.Random, width: int = 4) -> dict[str, Any]:
    return {"instances": [[round(rng.uniform(-1.0, 1.0), 6)
                           for _ in range(width)]]}


def _synth_diurnal(rng: random.Random, p: dict[str, Any]) -> list[dict[str, Any]]:
    duration, base, peak = p["duration_s"], p["base_rps"], p["peak_factor"]

    def rate(t: float) -> float:
        # Trough at t=0 and t=duration, peak at the midpoint.
        return base * (1.0 + (peak - 1.0) * 0.5
                       * (1.0 - math.cos(2.0 * math.pi * t / duration)))

    return [
        {"t": t, "tenant": p["tenants"][i % len(p["tenants"])],
         "payload": _dense_payload(rng)}
        for i, t in enumerate(_poisson_arrivals(rng, rate, duration))
    ]


def _synth_herd(rng: random.Random, p: dict[str, Any]) -> list[dict[str, Any]]:
    duration, base = p["duration_s"], p["base_rps"]
    rows = [
        {"t": t, "tenant": p["tenants"][i % len(p["tenants"])],
         "payload": _dense_payload(rng)}
        for i, t in enumerate(
            _poisson_arrivals(rng, lambda _t: base, duration))
    ]
    # The stampede: burst_size arrivals inside burst_window_s at the
    # midpoint — the reconnect herd after a rollout flips the fleet.
    t_burst = duration * 0.5
    rows.extend(
        {"t": t_burst + rng.random() * p["burst_window_s"],
         "tenant": "herd",
         "payload": _dense_payload(rng)}
        for _ in range(p["burst_size"])
    )
    rows.sort(key=lambda r: r["t"])
    return rows


def _synth_hot_key(rng: random.Random, p: dict[str, Any]) -> list[dict[str, Any]]:
    duration, base = p["duration_s"], p["base_rps"]
    hot = list(range(p["hot_keys"]))
    rows = []
    for i, t in enumerate(_poisson_arrivals(rng, lambda _t: base, duration)):
        entities = []
        for _ in range(p["batch"]):
            if rng.random() < p["hot_frac"]:
                key = hot[rng.randrange(len(hot))]
            else:
                key = rng.randrange(p["entities"])
            entities.append({p["entity_key"]: key})
        rows.append({
            "t": t, "tenant": p["tenants"][i % len(p["tenants"])],
            "payload": {"instances": entities}, "entities": entities,
        })
    return rows


def _synth_tenant_spray(rng: random.Random,
                        p: dict[str, Any]) -> list[dict[str, Any]]:
    duration, base = p["duration_s"], p["base_rps"]
    return [
        {"t": t, "tenant": f"spray-{i:06d}",
         "payload": _dense_payload(rng)}
        for i, t in enumerate(
            _poisson_arrivals(rng, lambda _t: base, duration))
    ]


#: Scenario catalog: name -> (generator, default params). Keep in sync
#: with docs/operations.md "Workload capture & replay".
SCENARIOS: dict[str, tuple[Callable[..., list[dict[str, Any]]],
                           dict[str, Any]]] = {
    "diurnal": (_synth_diurnal, {
        "duration_s": 60.0, "base_rps": 5.0, "peak_factor": 6.0,
        "tenants": ["interactive", "batch"],
    }),
    "herd": (_synth_herd, {
        "duration_s": 30.0, "base_rps": 4.0, "burst_size": 100,
        "burst_window_s": 0.25, "tenants": ["interactive"],
    }),
    "hot_key": (_synth_hot_key, {
        "duration_s": 30.0, "base_rps": 8.0, "entities": 4096,
        "hot_keys": 4, "hot_frac": 0.8, "batch": 8,
        "entity_key": "user_id", "tenants": ["interactive"],
    }),
    "tenant_spray": (_synth_tenant_spray, {
        "duration_s": 20.0, "base_rps": 40.0,
    }),
}


def synthesize(
    scenario: str,
    directory: str | Path,
    *,
    endpoint: str = "synthetic",
    seed: int = 0,
    **params: Any,
) -> Path:
    """Write a ``scenario`` artifact into ``directory`` (created);
    returns the artifact path. ``params`` override the scenario's
    defaults (see :data:`SCENARIOS`); unknown params are rejected so a
    typo'd knob fails here, not as a silently-default workload."""
    if scenario not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {scenario!r}; have {sorted(SCENARIOS)}")
    gen, defaults = SCENARIOS[scenario]
    unknown = set(params) - set(defaults)
    if unknown:
        raise ValueError(
            f"unknown {scenario} params {sorted(unknown)}; "
            f"knobs are {sorted(defaults)}")
    p = {**defaults, **params}
    rng = _rng(seed, scenario)
    rows = gen(rng, p)
    recorder = WorkloadRecorder(
        directory,
        meta={"scenario": scenario, "seed": seed, "params": p,
              "synthetic": True},
    )
    # Fixed synthetic epoch: the segment streams are byte-identical
    # for one (scenario, params, seed) triple (only the manifest's
    # created_wall stamp varies between runs).
    base_wall = 1_700_000_000.0
    for row in rows:
        recorder.record(
            surface="synthetic",
            endpoint=endpoint,
            tenant=row.get("tenant"),
            payload=row["payload"],
            instances=row.get("entities"),
            t_mono=row["t"],
            t_wall=base_wall + row["t"],
        )
    return recorder.stop()
