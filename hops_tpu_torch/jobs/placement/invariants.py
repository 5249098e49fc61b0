"""Post-hoc invariant audit over placement flight events.

The counterpart of ``hops_tpu/jobs/placement/invariants.py``, copied with the port's imports.

"At most one live unit per slot" is the whole point of the fencing
design — and a property no single process can assert at runtime,
because the violation IS two processes disagreeing. So it is audited
after the fact, from the flight recorder's event stream: the
:class:`~hops_tpu_torch.jobs.placement.client.PlacementClient` records every
``generation`` mint/bump, hostd records every ``fence``, and the data
planes record every ``generation_rejected`` refusal. Those events are
totally ordered by the recorder's sequence number, which makes the
invariant checkable:

- a unit is **live** (authoritative for its slot) from its mint until
  a later mint/bump supersedes it — so "one live unit per slot at
  every instant" holds iff each slot's generation events are strictly
  increasing (two live units would require a mint that does NOT
  supersede the previous occupant);
- a generation can be minted at most once (a duplicate would be two
  units claiming the same identity);
- no unit may refuse its OWN token (``have == got`` in a
  ``generation_rejected`` event means the fencing check itself is
  broken).

A superseded unit still *running* — the zombie window between
re-placement and its fence/reap — is fine and expected: it is no
longer live in the invariant's sense, and the stamped-header check
refuses it at the data plane, which is exactly what the
``generation_rejected`` events document.

Chaos drills end with ``assert not audit_slot_invariant(events)``;
the bench's partition leg does the same. See docs/operations.md
"Partition tolerance & fencing".
"""

from __future__ import annotations

from typing import Any, Iterable

from hops_tpu_torch.runtime import flight


def audit_slot_invariant(events: Iterable[dict[str, Any]]) -> list[str]:
    """Replay ``generation``/``generation_rejected`` flight events (in
    recorder order — pass ``FlightRecorder.events()`` output or a
    superset); returns human-readable violations, empty when the
    one-live-unit-per-slot invariant held at every instant."""
    violations: list[str] = []
    latest: dict[str, int] = {}
    minted: dict[tuple[str, int], int] = {}
    for e in events:
        kind = e.get("kind")
        data = e.get("data", {})
        slot = data.get("slot")
        if slot is None:
            continue
        seq = e.get("seq")
        if kind == "generation":
            action = data.get("action")
            if action not in ("mint", "bump"):
                continue
            try:
                gen = int(data.get("generation", 0))
            except (TypeError, ValueError):
                violations.append(
                    f"seq {seq}: slot {slot}: unparseable generation "
                    f"{data.get('generation')!r}")
                continue
            prev = latest.get(slot, 0)
            if gen <= prev:
                violations.append(
                    f"seq {seq}: slot {slot}: {action} of generation {gen} "
                    f"does not supersede {prev} — two live units")
            else:
                latest[slot] = gen
            if action == "mint":
                if (slot, gen) in minted:
                    violations.append(
                        f"seq {seq}: slot {slot}: generation {gen} minted "
                        f"twice (first at seq {minted[(slot, gen)]})")
                minted[(slot, gen)] = seq
        elif kind == "generation_rejected":
            have, got = data.get("have"), data.get("got")
            if have is not None and have == got:
                violations.append(
                    f"seq {seq}: slot {slot}: unit refused its OWN token "
                    f"{have!r} — fencing check broken")
    return violations


def audit(recorder: "flight.FlightRecorder | None" = None,
          after_seq: int = 0) -> list[str]:
    """Audit the process-wide flight recorder (or ``recorder``),
    optionally only events past ``after_seq`` — a drill snapshots
    ``FLIGHT.seq`` first so earlier tests' events stay out."""
    rec = recorder if recorder is not None else flight.FLIGHT
    return audit_slot_invariant(rec.events(after_seq=after_seq))
