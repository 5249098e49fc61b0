"""event-loop-stall: a transitively-blocking call reachable from a
selector IO loop.
(counterpart of ``hops_tpu/analysis/rules/event_loop_stall.py``)

The event-loop server core (``runtime/httpserver.py``) multiplexes
every connection on one thread around ``selector.select()``; anything
that sleeps, dials, forks or waits on that thread stalls ALL
connections at once — the worst failure mode a serving tier has. This
rule finds every selector loop in the tree (a class owning a
``selectors.DefaultSelector()`` attribute, rooted at the method that
calls ``.select()`` on it), walks the conservative call graph from the
root, and flags any blocking operation it can reach.

The sanctioned escape is worker-pool dispatch: parking the request on a
queue under a brief ``Condition`` notify and letting a worker thread
run the handler. Thread targets are not call-graph edges, so the
handoff pattern is structurally invisible to the traversal — exactly
the shape the loop is allowed to use. ``select()`` itself is the loop's
own wait and is never flagged.
"""

from __future__ import annotations

from hops_tpu_torch.analysis import concurrency
from hops_tpu_torch.analysis.engine import Context, Rule, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile


@register
class EventLoopStallRule(Rule):
    name = "event-loop-stall"
    description = (
        "a blocking operation reachable from a selector IO-loop thread "
        "(the loop must dispatch to workers instead)"
    )

    def check_project(
        self, files: list[ParsedFile], ctx: Context
    ) -> list[Finding]:
        model = concurrency.get_model(files, ctx)
        by_path = {pf.relpath: pf for pf in files}
        findings: list[Finding] = []
        for stall in model.loop_stalls():
            path, line, _ = stall.step
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
                        f"blocking `{stall.block.label}` in "
                        f"`{stall.func.qualname}` is reachable on the "
                        f"selector IO loop rooted at `{stall.root.qualname}` "
                        f"— every connection stalls; dispatch to the worker "
                        f"pool instead"
                    ),
                    symbol=pf.symbol_at(line),
                    detail=concurrency._fmt_chain(stall.chain),
                    related=tuple(sorted(
                        {p for p, _, _ in stall.chain} - {path}
                    )),
                )
            )
        return findings
