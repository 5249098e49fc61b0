"""Justified-findings baseline for graftlint.
(counterpart of ``hops_tpu/analysis/baseline.py``)

A baseline absorbs *known, accepted* findings so the CI gate can demand
zero NEW ones. Every entry must carry a human-written justification —
the file is a reviewable ledger of accepted debt, not a mute button.
Entries match findings by the line-number-free fingerprint
(rule + path + symbol + message), so unrelated edits above a finding
don't invalidate the baseline, while any change to the finding itself
(moved file, changed message, renamed enclosing function) surfaces it
again for re-justification.
"""

from __future__ import annotations

import json
from pathlib import Path

from hops_tpu_torch.analysis.model import Finding

VERSION = 1

#: Placeholder ``--write-baseline`` emits; the loader rejects it so a
#: generated baseline cannot be merged without human justification.
TODO_JUSTIFICATION = "TODO: justify or fix"


class BaselineError(ValueError):
    """Malformed or unjustified baseline — a usage error (exit 2)."""


def _entry_fingerprint(entry: dict) -> str:
    return Finding(
        rule=entry["rule"],
        path=entry["path"],
        line=0,
        col=0,
        message=entry["message"],
        symbol=entry.get("symbol", "<module>"),
    ).fingerprint


class Baseline:
    """Loaded baseline: fingerprint -> entry (with multiplicity)."""

    def __init__(self, entries: list[dict]):
        self.entries = entries
        self.by_fingerprint: dict[str, list[dict]] = {}
        for e in entries:
            self.by_fingerprint.setdefault(_entry_fingerprint(e), []).append(e)

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        try:
            data = json.loads(Path(path).read_text())
        except FileNotFoundError:
            raise BaselineError(f"baseline file not found: {path}")
        except ValueError as e:
            raise BaselineError(f"baseline {path} is not valid JSON: {e}")
        if not isinstance(data, dict) or data.get("version") != VERSION:
            raise BaselineError(
                f"baseline {path}: expected {{'version': {VERSION}, 'entries': [...]}}"
            )
        entries = data.get("entries")
        if not isinstance(entries, list):
            raise BaselineError(f"baseline {path}: 'entries' must be a list")
        for i, e in enumerate(entries):
            for field in ("rule", "path", "message", "justification"):
                if not isinstance(e.get(field), str) or not e.get(field).strip():
                    raise BaselineError(
                        f"baseline {path}: entry {i} missing non-empty {field!r}"
                    )
            if e["justification"].strip() == TODO_JUSTIFICATION:
                raise BaselineError(
                    f"baseline {path}: entry {i} ({e['rule']} in {e['path']}) "
                    f"still carries the generated placeholder justification — "
                    f"write a real one or fix the finding"
                )
        return cls(entries)

    def split(
        self, findings: list[Finding]
    ) -> tuple[list[Finding], list[Finding], list[dict]]:
        """``(new, baselined, stale_entries)`` — stale entries matched no
        current finding and should be deleted from the file.

        Each entry absorbs at most ONE finding: fingerprints carry no
        line number, so a second identical violation appearing in the
        same symbol must surface as new, not vanish behind the entry
        that justified the first."""
        new: list[Finding] = []
        baselined: list[Finding] = []
        remaining = {fp: len(es) for fp, es in self.by_fingerprint.items()}
        for f in findings:
            if remaining.get(f.fingerprint, 0) > 0:
                remaining[f.fingerprint] -= 1
                baselined.append(f)
            else:
                new.append(f)
        stale = [
            e
            for fp, es in self.by_fingerprint.items()
            for e in es[: remaining.get(fp, 0)]
        ]
        return new, baselined, stale


def group_stale(stale: list[dict]) -> list[tuple[str, list[dict]]]:
    """Stale entries grouped by rule, biggest group first (ties break on
    rule name) — with one ledger spanning 17 rules, a flat list hides
    which rule's debt actually rotted."""
    groups: dict[str, list[dict]] = {}
    for e in stale:
        groups.setdefault(e.get("rule", "<unknown>"), []).append(e)
    return sorted(groups.items(), key=lambda kv: (-len(kv[1]), kv[0]))


def write(path: Path, findings: list[Finding]) -> None:
    """Emit a baseline holding ``findings``, merging with any existing
    file at ``path``: entries whose fingerprint still matches keep their
    human-written justification (regeneration must never reset accepted
    debt to placeholders), and existing entries with no matching finding
    are preserved too — a ``--rules``-subset or single-directory run
    cannot see the findings the rest of the ledger covers, so dropping
    them would silently destroy justified entries. Truly stale entries
    are reported by a full run's stale check and deleted by a human."""
    existing: dict[str, list[dict]] = {}
    try:
        old = json.loads(Path(path).read_text())
        for e in old.get("entries", []):
            if isinstance(e, dict) and all(
                isinstance(e.get(k), str) for k in ("rule", "path", "message")
            ):
                existing.setdefault(_entry_fingerprint(e), []).append(e)
    except (FileNotFoundError, ValueError):
        pass  # no previous ledger (or unreadable): start fresh
    entries = []
    for f in findings:
        matched = existing.get(f.fingerprint)
        justification = (
            matched.pop(0)["justification"]
            if matched and matched[0].get("justification", "").strip()
            not in ("", TODO_JUSTIFICATION)
            else TODO_JUSTIFICATION
        )
        entries.append(
            {
                "rule": f.rule,
                "path": f.path,
                "symbol": f.symbol,
                "message": f.message,
                "justification": justification,
            }
        )
    for leftover in existing.values():
        entries.extend(leftover)
    Path(path).write_text(
        json.dumps({"version": VERSION, "entries": entries}, indent=2) + "\n"
    )
