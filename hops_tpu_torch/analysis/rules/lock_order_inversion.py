"""lock-order-inversion: cycles in the global lock-acquisition graph.
(counterpart of ``hops_tpu/analysis/rules/lock_order_inversion.py``)

Two code paths that take the same pair of locks in opposite order can
deadlock the moment both run concurrently — the classic inversion, and
invisible to any single-file analysis when (as in the serving stack)
the two acquisitions live in different modules joined by a method call.
The whole-program model (:mod:`hops_tpu_torch.analysis.concurrency`) builds
an edge A→B whenever lock B is acquired — lexically or through a
resolved call — while A is held; any cycle is reported once, with both
acquisition chains spelled out file:line by file:line in the finding
detail.

Fix by picking one order and sticking to it (usually: release the
narrow lock before calling into the other subsystem). Locks here are
``threading`` primitives with stable identities (``file:Class.attr`` /
``file:name``); re-entry of the same lock is out of scope (RLock by
design, and a plain-Lock self-deadlock is a different defect).
"""

from __future__ import annotations

from hops_tpu_torch.analysis import concurrency
from hops_tpu_torch.analysis.engine import Context, Rule, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile


@register
class LockOrderInversionRule(Rule):
    name = "lock-order-inversion"
    description = (
        "two code paths acquire the same pair of locks in opposite order "
        "(cycle in the whole-program lock graph)"
    )

    def check_project(
        self, files: list[ParsedFile], ctx: Context
    ) -> list[Finding]:
        model = concurrency.get_model(files, ctx)
        by_path = {pf.relpath: pf for pf in files}
        findings: list[Finding] = []
        for inv in model.inversions():
            path, line, _ = inv.chain_ab[-1]
            pf = by_path.get(path)
            if pf is None:
                continue
            detail = "acquisition order %s -> %s:\n%s\nconflicting order %s -> %s:\n%s" % (
                inv.a, inv.b, concurrency._fmt_chain(inv.chain_ab),
                inv.b, inv.a, concurrency._fmt_chain(inv.chain_ba),
            )
            findings.append(
                Finding(
                    rule=self.name,
                    path=path,
                    line=line,
                    col=0,
                    message=(
                        f"lock-order inversion: `{inv.a}` then `{inv.b}` in "
                        f"`{inv.func_ab}` conflicts with `{inv.b}` then "
                        f"`{inv.a}` in `{inv.func_ba}`"
                    ),
                    symbol=pf.symbol_at(line),
                    detail=detail,
                    related=tuple(sorted(
                        {p for p, _, _ in inv.chain_ab + inv.chain_ba}
                        - {path}
                    )),
                )
            )
        return findings
