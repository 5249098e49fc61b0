"""debug-surface-docs: every debug route and flight-recorder event kind
is documented in the operations docs (``docs/operations.md`` and the
port's ``docs/operations_torch.md``).
(counterpart of ``hops_tpu/analysis/rules/debug_surfaces.py``)

Sibling of ``metric-name-consistency``, for the observability surfaces
of the serving host: operators reach for ``GET /debug/*`` and read flight-
recorder dumps DURING incidents — an undocumented route or event kind
is a surface nobody will find at 3am, and the docs' event catalog is
what post-incident tooling greps against. Two statically-checkable
contracts:

- every string literal starting with ``/debug/`` or ``/admin/``
  (route comparisons, clients, tests alike; f-string fragments count)
  must appear — normalized without its trailing slash — in
  ``docs/operations.md`` (admin routes are operator verbs — drain,
  capture start/stop — an undocumented one is a control plane nobody
  can operate);
- every literal event kind passed to ``<receiver ending in
  flight>.record("<kind>", ...)`` (the :mod:`hops_tpu_torch.runtime.flight`
  convention: ``flight.record(...)`` / ``FLIGHT.record(...)``) must
  appear in the docs' flight-recorder event catalog.

Dynamically-built kinds/routes are out of static reach and skipped,
exactly like dynamically-built metric names.
"""

from __future__ import annotations

import ast
import re

from hops_tpu_torch.analysis.engine import Context, Rule, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile


def _receiver_is_flight(node: ast.AST) -> bool:
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover
        return False
    # The final dotted segment must BE the flight module / recorder
    # (`flight`, `FLIGHT`, an aliased `_flight`, `runtime.flight`) —
    # a suffix match would swallow the pervasive `inflight` trackers.
    return text.split(".")[-1].lstrip("_").lower() == "flight"


def _collect(pf: ParsedFile) -> tuple[list[tuple[ast.AST, str]],
                                      list[tuple[ast.AST, str]]]:
    routes: list[tuple[ast.AST, str]] = []
    kinds: list[tuple[ast.AST, str]] = []
    for node in ast.walk(pf.tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith(("/debug/", "/admin/"))):
            route = node.value.rstrip("/")
            if route not in ("/debug", "/admin"):  # a bare prefix is not a route
                routes.append((node, route))
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "record"
            and _receiver_is_flight(node.func.value)
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            kinds.append((node, node.args[0].value))
    return routes, kinds


@register
class DebugSurfaceDocsRule(Rule):
    name = "debug-surface-docs"
    description = (
        "every /debug/* and /admin/* route and flight-recorder event "
        "kind is documented in docs/operations.md"
    )

    def check_project(
        self, files: list[ParsedFile], ctx: Context
    ) -> list[Finding]:
        docs = ctx.docs_text()
        if docs is None:
            return []
        findings: list[Finding] = []
        seen_routes: set[str] = set()
        seen_kinds: set[str] = set()
        for pf in files:
            routes, kinds = _collect(pf)
            for node, route in routes:
                if route in seen_routes:
                    continue
                if route not in docs:
                    seen_routes.add(route)
                    findings.append(pf.finding(
                        self.name, node,
                        f"debug route `{route}` is referenced in code but "
                        "missing from docs/operations.md — document it "
                        "(operators discover debug surfaces from that file)",
                    ))
            for node, kind in kinds:
                if kind in seen_kinds:
                    continue
                if not re.search(rf"\b{re.escape(kind)}\b", docs):
                    seen_kinds.add(kind)
                    findings.append(pf.finding(
                        self.name, node,
                        f"flight-recorder event kind `{kind}` is recorded "
                        "in code but missing from docs/operations.md's "
                        "event catalog — document it (incident tooling "
                        "greps dumps against that catalog)",
                    ))
        return findings
