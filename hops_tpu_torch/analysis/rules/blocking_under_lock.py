"""blocking-under-lock: a known-blocking operation reached while a
``threading`` lock is held.
(counterpart of ``hops_tpu/analysis/rules/blocking_under_lock.py``)

A lock held across network I/O, ``subprocess``, ``time.sleep``,
``with_deadline``, kvstore FFI or ``fsync`` turns every peer of that
lock into a hostage of the slowest downstream dependency — the p99
amplifier behind most "everything got slow at once" serving incidents.
The check is interprocedural: ``self._flush()`` called under
``self._lock`` is traced into the blocking write it performs, using the
whole-program blocking summaries from
:mod:`hops_tpu_torch.analysis.concurrency`.

The one sanctioned wait-under-lock is ``cv.wait()`` under ``with cv:``
— the wait *releases* that condition's lock, so holding it is the
consumer protocol, not a stall. Holding any OTHER lock across the wait
is still flagged.

Fix by shrinking the critical section: snapshot state under the lock,
do the slow work outside, re-take the lock to publish.
"""

from __future__ import annotations

from hops_tpu_torch.analysis import concurrency
from hops_tpu_torch.analysis.engine import Context, Rule, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile


@register
class BlockingUnderLockRule(Rule):
    name = "blocking-under-lock"
    description = (
        "a blocking operation (network, subprocess, sleep, FFI, fsync, "
        "foreign cv/event wait) reached while holding a lock"
    )

    def check_project(
        self, files: list[ParsedFile], ctx: Context
    ) -> list[Finding]:
        model = concurrency.get_model(files, ctx)
        by_path = {pf.relpath: pf for pf in files}
        findings: list[Finding] = []
        for hb in model.held_blocks():
            path, line, _ = hb.step
            pf = by_path.get(path)
            if pf is None:
                continue
            findings.append(
                Finding(
                    rule=self.name,
                    path=path,
                    line=line,
                    col=0,
                    message=(
                        f"blocking `{hb.block.label}` reached while holding "
                        f"`{hb.lock.id}` — move it outside the critical "
                        f"section or hand off to a worker"
                    ),
                    symbol=pf.symbol_at(line),
                    detail=concurrency._fmt_chain(hb.chain),
                    related=tuple(sorted(
                        {p for p, _, _ in hb.chain} - {path}
                    )),
                )
            )
        return findings
