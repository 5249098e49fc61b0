"""adhoc-http-server: all serving rides the shared event-loop core.
(counterpart of ``hops_tpu/analysis/rules/adhoc_http_server.py``)

The stack spent four PRs converging its five HTTP server sites
(serving replicas, the fleet router, hostd, shardd, the metrics
server) onto ONE selector-based transport
(``runtime/httpserver.HTTPServer``): one IO loop, bounded workers,
pipelining-safe response ordering, keep-alive accounting, slowloris
eviction. A new ``ThreadingHTTPServer`` or ``BaseHTTPRequestHandler``
site would quietly re-grow the thread-per-connection transport the
migration removed — per-connection thread churn, unbounded handler
concurrency, none of the ``hops_tpu_http_*`` observability — and its
behavior under the chaos suites would diverge from every other server
in the process.

Flagged, anywhere in ``hops_tpu_torch/`` EXCEPT ``runtime/httpserver.py``
(the sanctioned core, whose docstring narrates the history):

- instantiating ``ThreadingHTTPServer`` / ``HTTPServer`` /
  ``ThreadingTCPServer`` from ``http.server`` / ``socketserver``
  (dotted spellings included);
- subclassing ``BaseHTTPRequestHandler`` / ``SimpleHTTPRequestHandler``
  (a handler class exists only to feed a stdlib server).

Type annotations and bare imports are NOT flagged —
``telemetry/export.py`` keeps ``handle_metrics_path(handler:
BaseHTTPRequestHandler)`` wrappers for embedders still on the stdlib
transport, and referencing the type is not running a server. Tests and
``bench.py`` are out of scope: the benchmark instantiates the stdlib
transport on purpose, as the *baseline* the event-loop core is measured
against.
"""

from __future__ import annotations

import ast

from hops_tpu_torch.analysis.engine import Context, Rule, dotted_name, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile

#: The one module allowed to speak raw transport (and the only one that
#: may mention the stdlib servers in anger).
SANCTIONED = "hops_tpu_torch/runtime/httpserver.py"

#: Stdlib server classes whose *instantiation* re-grows the
#: thread-per-connection transport.
SERVER_NAMES = frozenset({
    "ThreadingHTTPServer",
    "ThreadingTCPServer",
})

#: Handler base classes whose *subclassing* does the same.
HANDLER_BASES = frozenset({
    "BaseHTTPRequestHandler",
    "SimpleHTTPRequestHandler",
})


def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _http_server_call(name: str, stdlib_http_names: set[str]) -> bool:
    """Is this call an instantiation of a stdlib server class? Plain
    ``HTTPServer(...)`` is ambiguous with the sanctioned core's own
    class name — it counts only when the file imported it from
    ``http.server``/``socketserver`` (tracked in
    ``stdlib_http_names``) or spells the module out."""
    last = _last(name)
    if last in SERVER_NAMES:
        return True
    if last == "HTTPServer":
        return (name in ("http.server.HTTPServer", "server.HTTPServer")
                or "HTTPServer" in stdlib_http_names and "." not in name)
    return False


@register
class AdhocHTTPServerRule(Rule):
    name = "adhoc-http-server"
    description = (
        "stdlib thread-per-connection HTTP server instantiated or "
        "subclassed outside runtime/httpserver.py — serve through the "
        "shared event-loop core (runtime.httpserver.HTTPServer) instead"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        rel = pf.relpath.replace("\\", "/")
        if "hops_tpu_torch/" not in rel or rel.endswith(SANCTIONED):
            return []
        # Names this file imported from the stdlib server modules —
        # disambiguates bare ``HTTPServer(...)`` from the sanctioned
        # core's identically-named class.
        stdlib_http_names: set[str] = set()
        for node in ast.walk(pf.tree):
            if (isinstance(node, ast.ImportFrom)
                    and node.module in ("http.server", "socketserver")):
                stdlib_http_names.update(
                    a.asname or a.name for a in node.names)
        findings: list[Finding] = []
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if name and _http_server_call(name, stdlib_http_names):
                    findings.append(pf.finding(
                        self.name, node,
                        f"{_last(name)} instantiated outside the "
                        "sanctioned transport — serve through "
                        "runtime.httpserver.HTTPServer (one event "
                        "loop, bounded workers, hops_tpu_http_* "
                        "metrics)",
                    ))
            elif isinstance(node, ast.ClassDef):
                for base in node.bases:
                    bname = dotted_name(base)
                    if bname and _last(bname) in HANDLER_BASES:
                        findings.append(pf.finding(
                            self.name, node,
                            f"class {node.name} subclasses "
                            f"{_last(bname)} — stdlib handler classes "
                            "exist only to feed the thread-per-"
                            "connection transport; port the routes to "
                            "a runtime.httpserver route function",
                        ))
                        break
        return findings
