"""blocking-call-no-deadline: fleet cross-process calls need a budget.
(counterpart of ``hops_tpu/analysis/rules/blocking_call.py``)

The fleet tier (``hops_tpu_torch/modelrepo/fleet/``) is a control plane made
of cross-process HTTP calls: the router forwards to replicas, the
scraper reads their ``/metrics.json``, the replica manager probes
``/healthz`` and posts ``/admin/drain``. A single such call issued
WITHOUT a deadline wedges its thread on a half-dead peer — and these
threads are exactly the ones capacity decisions ride on (a wedged
scraper freezes the load view; a wedged drain probe freezes a
rollout). The kernel's default TCP timeouts are minutes; the fleet's
decision cadence is milliseconds.

Flagged, in fleet-scoped files only: calls to the known blocking
network primitives — ``urllib.request.urlopen`` (and any ``*.urlopen``
/ bare ``urlopen``), ``socket.create_connection``, and the
``requests`` verbs — that neither pass an explicit ``timeout``
argument nor sit lexically inside a ``resilience.with_deadline(...)``
call. The fix is the one the rest of the module already uses: thread a
``timeout=`` through (most of the fleet derives it from
``forward_timeout_s`` / ``scrape_interval_s``), or wrap the call in
``with_deadline`` when the budget spans more than the one syscall.
"""

from __future__ import annotations

import ast

from hops_tpu_torch.analysis.engine import Context, Rule, dotted_name, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile

#: Path fragment that puts a file in scope: the fleet control plane.
SCOPE = "hops_tpu_torch/modelrepo/fleet/"

#: Dotted names (suffix-matched on the last segment for attribute
#: forms) of blocking network calls that accept a ``timeout``.
_BLOCKING_LAST = {"urlopen", "create_connection"}
_REQUESTS_VERBS = {"get", "post", "put", "delete", "head", "patch", "request"}


def _is_blocking_call(node: ast.Call) -> bool:
    name = dotted_name(node.func)
    if not name:
        return False
    last = name.split(".")[-1]
    if last in _BLOCKING_LAST:
        return True
    # requests.get(...) etc. — only the requests module's verbs; a bare
    # get() is dict/queue idiom, not a network call.
    return (
        last in _REQUESTS_VERBS
        and name.split(".")[0] == "requests"
    )


def _has_timeout(node: ast.Call) -> bool:
    if any(kw.arg == "timeout" for kw in node.keywords):
        return True
    name = dotted_name(node.func) or ""
    last = name.split(".")[-1]
    # socket.create_connection((host, port), timeout) — positional form.
    if last == "create_connection" and len(node.args) >= 2:
        return True
    # urlopen(url, data, timeout) — timeout is the third positional.
    if last == "urlopen" and len(node.args) >= 3:
        return True
    return False


def _deadline_wrapped(node: ast.Call, parents: dict[int, ast.AST]) -> bool:
    """Is this call a lexical descendant of a ``with_deadline(...)``
    call (e.g. ``with_deadline(lambda: urlopen(u), 2.0)``)? That budget
    covers the blocking call, so no finding."""
    cur = parents.get(id(node))
    while cur is not None:
        if isinstance(cur, ast.Call):
            name = dotted_name(cur.func) or ""
            if name.split(".")[-1] == "with_deadline":
                return True
        cur = parents.get(id(cur))
    return False


@register
class BlockingCallNoDeadlineRule(Rule):
    name = "blocking-call-no-deadline"
    description = (
        "fleet cross-process HTTP/socket call without an explicit "
        "timeout or with_deadline wrapper — a half-dead peer wedges "
        "the router/autoscaler/rollout thread"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        if SCOPE not in pf.relpath:
            return []
        parents = pf.parents()
        findings = []
        for node in ast.walk(pf.tree):
            if not (isinstance(node, ast.Call) and _is_blocking_call(node)):
                continue
            if _has_timeout(node) or _deadline_wrapped(node, parents):
                continue
            callee = dotted_name(node.func) or "<call>"
            findings.append(
                pf.finding(
                    self.name,
                    node,
                    f"blocking call {callee}(...) in fleet code has no "
                    "deadline — pass timeout= or wrap in "
                    "resilience.with_deadline (a wedged peer must cost "
                    "a bounded wait, not a frozen control plane)",
                )
            )
        return findings
