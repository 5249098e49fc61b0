"""relay-json-roundtrip: parse→re-serialize churn on relay paths.
(counterpart of ``hops_tpu/analysis/rules/relay_json_roundtrip.py``)

The fleet router's forward path used to ``json.loads`` every replica
response just to ``json.dumps`` it straight back to the client — a full
parse + re-serialize per hop (~0.4 ms/request on the bench body,
``bench.py --hot-path``) that changes nothing but byte order of dict
keys. The zero-copy relay removed it; this rule keeps it removed.

Flagged, in fleet/serving code only:

- a variable assigned from ``json.loads(...)`` whose ONLY uses are as
  the serialized argument of ``json.dumps(...)`` — the object was never
  inspected, so the bytes should have been relayed as-is;
- the direct nesting ``json.dumps(json.loads(...))``.

Parsing that actually reads the object (``payload["key"]``, mutation,
a conditional) is the legitimate lazy-parse path and is not flagged.
"""

from __future__ import annotations

import ast

from hops_tpu_torch.analysis.engine import Context, Rule, dotted_name, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile

#: Path fragments that put a file in scope: the serving relay tier.
SCOPES = ("hops_tpu_torch/modelrepo/fleet/", "hops_tpu_torch/modelrepo/serving.py")


def _is_json_call(node: ast.AST, fn: str) -> bool:
    return (
        isinstance(node, ast.Call)
        and (dotted_name(node.func) or "").split(".")[-1] == fn
        and (dotted_name(node.func) or "").split(".")[0] == "json"
    )


def _dumps_arg_ids(func_node: ast.AST) -> set[int]:
    """ids of every expression node that is the first argument of a
    ``json.dumps(...)`` call inside ``func_node``."""
    out: set[int] = set()
    for node in ast.walk(func_node):
        if _is_json_call(node, "dumps") and node.args:
            out.add(id(node.args[0]))
    return out


@register
class RelayJsonRoundtripRule(Rule):
    name = "relay-json-roundtrip"
    description = (
        "json.loads(...) whose result is only re-json.dumps'ed "
        "unmodified on a fleet/serving relay path — relay the bytes "
        "instead of paying a parse + re-serialize per hop"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        if not any(scope in pf.relpath for scope in SCOPES):
            return []
        findings: list[Finding] = []
        for func in ast.walk(pf.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            dumps_args = _dumps_arg_ids(func)
            # Direct nesting: json.dumps(json.loads(x)).
            for node in ast.walk(func):
                if (
                    _is_json_call(node, "loads")
                    and id(node) in dumps_args
                ):
                    findings.append(pf.finding(
                        self.name, node,
                        "json.dumps(json.loads(...)) on a relay path — "
                        "the parsed object is never read; pass the "
                        "bytes through",
                    ))
            # Variable form: x = json.loads(...); every later use of x
            # is json.dumps(x).
            for target, assign in _loads_assignments(func):
                uses = [
                    n for n in ast.walk(func)
                    if isinstance(n, ast.Name)
                    and n.id == target
                    and isinstance(n.ctx, ast.Load)
                ]
                if uses and all(id(u) in dumps_args for u in uses):
                    findings.append(pf.finding(
                        self.name, assign,
                        f"{target!r} is parsed with json.loads but only "
                        "ever re-json.dumps'ed unmodified — relay the "
                        "original bytes instead",
                    ))
        return findings


def _loads_assignments(func: ast.AST):
    """(name, assign-node) for simple ``x = json.loads(...)`` bindings
    directly inside ``func`` (any nesting depth, single Name target)."""
    for node in ast.walk(func):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and _is_json_call(node.value, "loads")
        ):
            yield node.targets[0].id, node
