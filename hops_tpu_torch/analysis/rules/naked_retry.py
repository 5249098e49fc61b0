"""naked-retry-loop: retry loops sleeping a constant, with no backoff.
(counterpart of ``hops_tpu/analysis/rules/naked_retry.py``)

A ``while``/``for`` that catches an exception and ``time.sleep``\\ s a
*constant* before trying again is a retry storm waiting to happen: when
the dependency actually goes down, every worker in the fleet re-dogpiles
it in lockstep at exactly the same cadence (the AWS full-jitter result;
this is why ``runtime/resilience.py`` exists). A relay-lock
incident was this exact shape — a ``FileExistsError`` busy-spin.

Flagged: a loop whose body contains a ``try``/``except`` (the retry
shape) AND a ``time.sleep(<constant>)`` / ``sleep(<constant>)`` call
anywhere inside the loop. Not flagged: poll/wait loops with no
exception handling (sleeping a constant while *watching* for a state
change is fine — nothing failed), computed sleeps (a
``RetryPolicy.delay(...)`` result is a Name, not a Constant), and the
sanctioned backoff homes ``runtime/resilience.py`` and
``runtime/relaylock.py``.

The fix is almost always ``resilience.RetryPolicy(...).call(fn)`` —
bounded attempts, exponential backoff, full jitter, telemetry.
"""

from __future__ import annotations

import ast

from hops_tpu_torch.analysis.engine import Context, Rule, dotted_name, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile

#: Modules allowed to hand-roll sleeps in retry shapes: the policy
#: engine itself, and the relay lock's carefully-reviewed wait loop.
SANCTIONED = (
    "hops_tpu_torch/runtime/resilience.py",
    "hops_tpu_torch/runtime/relaylock.py",
)


def _is_sleep(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    return name in ("time.sleep", "sleep", "_time.sleep")


def _walk_in_loop(loop: ast.AST):
    """Walk a loop's subtree WITHOUT descending into nested def/lambda
    bodies: code there runs when the helper is *called*, not per loop
    iteration, so it is not this loop's retry behavior."""
    stack = [loop]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            stack.append(child)


def _constant_sleeps(loop: ast.AST) -> list[ast.Call]:
    return [
        n for n in _walk_in_loop(loop)
        if _is_sleep(n) and n.args and isinstance(n.args[0], ast.Constant)
    ]


def _has_handler(loop: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Try) and n.handlers for n in _walk_in_loop(loop)
        if n is not loop
    )


@register
class NakedRetryLoopRule(Rule):
    name = "naked-retry-loop"
    description = (
        "retry loop (try/except inside while/for) sleeping a constant — "
        "no backoff or jitter; use runtime.resilience.RetryPolicy"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        if any(pf.relpath.endswith(s) for s in SANCTIONED):
            return []
        matches: list[ast.AST] = [
            node for node in ast.walk(pf.tree)
            if isinstance(node, (ast.While, ast.For))
            and _has_handler(node) and _constant_sleeps(node)
        ]
        findings = []
        for loop in matches:
            # Report the innermost matching loop only: an outer loop
            # wrapping a flagged inner one adds no information.
            if any(
                other is not loop and other in _walk_in_loop(loop)
                for other in matches
            ):
                continue
            sleep = _constant_sleeps(loop)[0]
            findings.append(
                pf.finding(
                    self.name,
                    sleep,
                    "retry loop sleeps a constant "
                    f"{sleep.args[0].value!r}s — a fleet retries in "
                    "lockstep; use resilience.RetryPolicy (exponential "
                    "backoff + full jitter) or justify inline",
                )
            )
        return findings
