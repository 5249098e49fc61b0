"""unbounded-priority-queue: serving-tier priority queues declare a bound.
(counterpart of ``hops_tpu/analysis/rules/unbounded_priority_queue.py``)

A priority queue without a bound is the quiet version of the overload
the shedders exist to prevent: under sustained pressure the low class
never drains, the queue grows without limit, and the process dies of
memory instead of answering 503s — with the added cruelty that every
queued batch item did its waiting for nothing. The QoS design
(``runtime/qos.py``, docs/operations.md "Tail latency & QoS") therefore
requires every priority queue in the serving tiers to declare a hard
bound and a shed policy (``qos.BoundedPriorityQueue`` is the sanctioned
shape: bound + shed-lowest-class-first + starvation guard).

Flagged, in the serving tiers only (``modelrepo/fleet/``,
``modelrepo/serving.py``, ``modelrepo/lm_engine.py``, and
``runtime/qos.py`` itself):

- ``queue.PriorityQueue(...)`` constructed with no ``maxsize`` (or a
  literal ``maxsize <= 0`` — the stdlib's "unbounded" spelling);
- ``BoundedPriorityQueue(...)`` constructed without a bound argument,
  or with a literal non-positive / ``None`` bound.

A bound passed as a name or expression is accepted (it is config; the
constructor validates positivity at runtime). Non-serving code (offline
tooling, tests) is out of scope — the failure mode being defended
against is serving-path memory collapse.
"""

from __future__ import annotations

import ast

from hops_tpu_torch.analysis.engine import Context, Rule, dotted_name, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile

#: Path fragments that put a file in scope: the serving tiers.
SCOPE = (
    "hops_tpu_torch/modelrepo/fleet/",
    "hops_tpu_torch/modelrepo/serving.py",
    "hops_tpu_torch/modelrepo/lm_engine.py",
    "hops_tpu_torch/runtime/qos.py",
)


def _bound_arg(node: ast.Call) -> ast.expr | None:
    """The bound expression of a priority-queue constructor call: first
    positional, or the ``maxsize=`` / ``bound=`` keyword."""
    if node.args:
        return node.args[0]
    for kw in node.keywords:
        if kw.arg in ("maxsize", "bound"):
            return kw.value
    return None


def _is_unbounded(arg: ast.expr | None) -> bool:
    if arg is None:
        return True
    if isinstance(arg, ast.Constant):
        v = arg.value
        return v is None or (isinstance(v, (int, float)) and v <= 0)
    return False  # a name/expression: config-supplied, validated at runtime


@register
class UnboundedPriorityQueueRule(Rule):
    name = "unbounded-priority-queue"
    description = (
        "priority queue in the serving tiers constructed without a "
        "hard bound — declare one (qos.BoundedPriorityQueue) so "
        "overload sheds instead of growing the queue to OOM"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        if not any(s in pf.relpath for s in SCOPE):
            return []
        findings: list[Finding] = []
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if not name:
                continue
            last = name.split(".")[-1]
            if last not in ("PriorityQueue", "BoundedPriorityQueue"):
                continue
            if _is_unbounded(_bound_arg(node)):
                findings.append(
                    pf.finding(
                        self.name,
                        node,
                        f"{last} constructed without a positive bound — "
                        "serving-tier priority queues must declare a "
                        "bound and shed policy "
                        "(qos.BoundedPriorityQueue(bound, ...))",
                    )
                )
        return findings
