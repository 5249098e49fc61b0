"""json-on-hot-wire: JSON codec calls on request/response bodies in the
packed-wire tier.
(counterpart of ``hops_tpu/analysis/rules/json_on_hot_wire.py``)

The packed columnar codec (``runtime/wirecodec.py``) is the negotiated
wire format for tensor-shaped bodies on the serving and feature data
planes; ``bench.py --hot-path`` prices its decode at multiples of
``json.loads`` on the same body. This rule keeps JSON from creeping
back onto those hot paths: inside the three wire-tier files, any
``json.loads`` of a request/response body variable and any
``json.dumps(...).encode()`` body serialization is flagged.

Negotiation keeps JSON as the *default* format on purpose, so the
legitimate sites — the negotiated JSON branch, error/debug responses,
control-plane parses — stay, each carrying a
``# graftlint: disable=json-on-hot-wire`` comment whose justification
names WHY that site is exempt. A new un-annotated site is a finding:
either it belongs on the packed path, or it needs to argue its case in
a disable comment.
"""

from __future__ import annotations

import ast

from hops_tpu_torch.analysis.engine import Context, Rule, dotted_name, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile

#: The wire-tier files in scope — the layers a request/response body
#: traverses between client and predictor/shard.
SCOPES = (
    "hops_tpu_torch/modelrepo/serving.py",
    "hops_tpu_torch/modelrepo/fleet/router.py",
    "hops_tpu_torch/featurestore/online_serving.py",
)

#: Variable names that hold raw request/response bodies in the scoped
#: files (the HTTP route/exchange contracts).
BODY_NAMES = frozenset({"body", "raw_body", "body_in", "raw", "data"})


def _is_json_call(node: ast.AST, fn: str) -> bool:
    name = dotted_name(node.func) if isinstance(node, ast.Call) else None
    return (name or "").split(".")[0] == "json" \
        and (name or "").split(".")[-1] == fn


def _names_a_body(expr: ast.AST) -> bool:
    """Does ``expr`` reference a body variable? Catches the bare Name
    and the ``body or b"{}"`` default idiom."""
    if isinstance(expr, ast.Name):
        return expr.id in BODY_NAMES
    if isinstance(expr, ast.BoolOp):
        return any(_names_a_body(v) for v in expr.values)
    return False


@register
class JsonOnHotWireRule(Rule):
    name = "json-on-hot-wire"
    description = (
        "json.loads of a request/response body (or json.dumps(...)"
        ".encode() body serialization) inside the packed-wire serving/"
        "feature tier — use runtime/wirecodec.py, or justify the JSON "
        "fallback in a disable comment"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        if not any(pf.relpath.endswith(scope) for scope in SCOPES):
            return []
        findings: list[Finding] = []
        for node in ast.walk(pf.tree):
            if (_is_json_call(node, "loads") and node.args
                    and _names_a_body(node.args[0])):
                findings.append(pf.finding(
                    self.name, node,
                    "json.loads of a wire body on the packed-codec tier "
                    "— decode via runtime/wirecodec.py, or justify the "
                    "JSON path in a disable comment",
                ))
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "encode"
                and _is_json_call(node.func.value, "dumps")
            ):
                findings.append(pf.finding(
                    self.name, node,
                    "json.dumps(...).encode() body serialization on the "
                    "packed-codec tier — encode via runtime/wirecodec.py, "
                    "or justify the JSON path in a disable comment",
                ))
        return findings
