"""metric-name-consistency: the registry, the docs, and every module
agree on what each ``hops_tpu_*`` metric is.
(counterpart of ``hops_tpu/analysis/rules/metric_consistency.py``)

The telemetry registry raises on conflicting re-declarations — but only
when both declarers actually run in one process, which CI never
arranges (the serving host and a training job each import half the
tree). And nothing at all checks docs/operations.md, whose metric
tables are the operator contract dashboards are built on. This
project-level rule closes both gaps statically:

- every literal ``hops_tpu_*`` name registered via
  ``*.counter/gauge/histogram(...)`` must appear in
  ``docs/operations.md`` (resolved module-level string constants count
  as literals);
- a name must have exactly ONE metric type across all modules;
- two *explicit* bucket declarations for one histogram must be
  identical (omitted/``None`` buckets are a read-back and match
  anything — the registry's own convention).

Dynamically-built names (span histograms) are out of static reach and
skipped.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from hops_tpu_torch.analysis.engine import Context, Rule, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile

_METRIC_METHODS = {"counter", "gauge", "histogram"}
_PREFIX = "hops_tpu_"


@dataclasses.dataclass
class _Registration:
    pf: ParsedFile
    node: ast.Call
    name: str
    type: str
    buckets: str | None  # unparsed expression, None when omitted/None


def _receiver_is_registry(node: ast.AST) -> bool:
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover
        return False
    return text.lower().endswith("registry") or text.lower().endswith("registry_")


def _module_str_constants(tree: ast.Module) -> dict[str, str]:
    out: dict[str, str] = {}
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            out[node.targets[0].id] = node.value.value
    return out


def _collect(pf: ParsedFile) -> list[_Registration]:
    consts = _module_str_constants(pf.tree)
    regs: list[_Registration] = []
    for node in ast.walk(pf.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _METRIC_METHODS
            and _receiver_is_registry(node.func.value)
            and node.args
        ):
            continue
        arg = node.args[0]
        name: str | None = None
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name = arg.value
        elif isinstance(arg, ast.Name):
            name = consts.get(arg.id)
        if name is None or not name.startswith(_PREFIX):
            continue
        buckets: str | None = None
        for kw in node.keywords:
            if kw.arg == "buckets" and not (
                isinstance(kw.value, ast.Constant) and kw.value.value is None
            ):
                buckets = ast.unparse(kw.value)
        regs.append(_Registration(pf, node, name, node.func.attr, buckets))
    return regs


@register
class MetricNameConsistencyRule(Rule):
    name = "metric-name-consistency"
    description = (
        "every registered hops_tpu_* metric is documented in "
        "docs/operations.md and has one type/bucket declaration tree-wide"
    )

    def check_project(
        self, files: list[ParsedFile], ctx: Context
    ) -> list[Finding]:
        regs: list[_Registration] = []
        for pf in files:
            regs.extend(_collect(pf))
        findings: list[Finding] = []

        by_name: dict[str, list[_Registration]] = {}
        for r in regs:
            by_name.setdefault(r.name, []).append(r)

        docs = ctx.docs_text()
        for metric, sites in sorted(by_name.items()):
            canonical = sites[0]
            for r in sites[1:]:
                if r.type != canonical.type:
                    findings.append(
                        r.pf.finding(
                            self.name,
                            r.node,
                            f"metric `{metric}` registered as {r.type} here "
                            f"but as {canonical.type} in "
                            f"{canonical.pf.relpath} — one name, one type",
                        )
                    )
            explicit = [r for r in sites if r.buckets is not None]
            for r in explicit[1:]:
                if r.buckets != explicit[0].buckets:
                    findings.append(
                        r.pf.finding(
                            self.name,
                            r.node,
                            f"histogram `{metric}` declared with buckets "
                            f"`{r.buckets}` here but `{explicit[0].buckets}` "
                            f"in {explicit[0].pf.relpath} — quantiles would "
                            "disagree across modules",
                        )
                    )
            # Whole-word match: `hops_tpu_feed` must NOT count as
            # documented just because `hops_tpu_feed_batches_total` is.
            if docs is not None and not re.search(
                rf"\b{re.escape(metric)}\b", docs
            ):
                findings.append(
                    canonical.pf.finding(
                        self.name,
                        canonical.node,
                        f"metric `{metric}` is registered in code but "
                        "missing from docs/operations.md — document it "
                        "(operators dashboard off that file)",
                    )
                )
        return findings
