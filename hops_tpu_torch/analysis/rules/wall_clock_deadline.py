"""wall-clock-deadline: deadlines and elapsed checks must not use time.time().
(counterpart of ``hops_tpu/analysis/rules/wall_clock_deadline.py``)

``time.time()`` is the WALL clock: NTP slews it, ntpdate and operators
step it, leap smearing bends it. Any deadline minted from it — or any
elapsed/timeout comparison computed with it — inherits those jumps: a
backward step stretches a 5 s drain wait into minutes, a forward step
expires every lease and poll loop in the process at once. The platform
learned this the hard way in the placement tier (a host-clock step aged
out perfectly healthy hosts), which is why registry aging and the hostd
lease run on receiver-side ``time.monotonic()`` arrival time. This rule
keeps the rest of the tree honest.

Flagged, everywhere in the tree:

- **deadline mints**: an assignment whose value is an ``Add`` expression
  containing a ``time.time()`` call — ``deadline = time.time() + ttl``
  is a future instant on a clock that can move underneath it;
- **wall-clock comparisons**: any comparison with a ``time.time()``
  call in an operand — ``while time.time() < deadline`` and
  ``if time.time() - t0 > budget`` both measure duration on the wall
  clock.

NOT flagged: bare timestamp captures (``ts = time.time()`` — event
times and display stamps are exactly what the wall clock is for),
``Sub`` durations outside comparisons (``duration_s = time.time() -
start`` in a result record is display, not control flow), and
``time.time()`` buried in another call's argument list (comparing
``f(time.time())``'s result compares what ``f`` computes). Comparisons
against file mtimes are wall-vs-wall and legitimate — suppress those
with ``# graftlint: disable=wall-clock-deadline`` on the line.

The fix is mechanical: mint and compare with ``time.monotonic()``; keep
``time.time()`` only for values that leave the process (announce
stamps, event times, log records).
"""

from __future__ import annotations

import ast

from hops_tpu_torch.analysis.engine import Context, Rule, dotted_name, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile


def _has_wall_clock_call(node: ast.AST) -> bool:
    """Does this subtree contain a ``time.time()`` call whose VALUE
    reaches the enclosing operator? Argument lists of other calls are
    opaque: comparing ``f(time.time())``'s result is comparing whatever
    ``f`` computes, not the clock."""
    if isinstance(node, ast.Call):
        return dotted_name(node.func) == "time.time"
    return any(_has_wall_clock_call(c) for c in ast.iter_child_nodes(node))


def _is_add_mint(value: ast.AST) -> bool:
    """Is ``value`` an Add expression with ``time.time()`` inside —
    i.e. a future-instant deadline minted on the wall clock?"""
    for sub in ast.walk(value):
        if (isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Add)
                and (_has_wall_clock_call(sub.left)
                     or _has_wall_clock_call(sub.right))):
            return True
    return False


@register
class WallClockDeadlineRule(Rule):
    name = "wall-clock-deadline"
    description = (
        "deadline or elapsed-time check computed with time.time() — an "
        "NTP step or slew moves the deadline; use time.monotonic()"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        findings = []
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Compare):
                operands = [node.left, *node.comparators]
                if any(_has_wall_clock_call(op) for op in operands):
                    findings.append(pf.finding(
                        self.name, node,
                        "comparison measures time with time.time() — a "
                        "clock step breaks the wait/expiry; compare "
                        "time.monotonic() instants instead",
                    ))
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = node.value
                if value is not None and _is_add_mint(value):
                    findings.append(pf.finding(
                        self.name, node,
                        "deadline minted as time.time() + budget — the "
                        "wall clock can jump past (or away from) it; "
                        "mint deadlines from time.monotonic()",
                    ))
        return findings
