"""hardcoded-loopback: no baked-in loopback URLs on multi-host paths.
(counterpart of ``hops_tpu/analysis/rules/hardcoded_loopback.py``)

The placement layer (``jobs/placement/``) made fleet replicas and
feature-store shards remotely placeable: every router→replica and
store→shard hop now derives its URL from the unit's registered
``host:port``. A literal ``http://127.0.0.1:...`` (or
``http://localhost...``) on one of those paths silently pins the hop to
the local machine — the fleet LOOKS healthy in single-host tests and
then routes every remote replica's traffic to the wrong host in
production. This rule makes that regression loud.

Flagged, on the multi-host serving paths only
(``modelrepo/fleet/`` and ``featurestore/online_serving.py``):

- any string literal that spells a URL at a loopback address — both
  ``http`` and a loopback host (``127.0.0.1`` / ``localhost`` /
  ``::1``) inside ONE literal. F-strings are covered through their
  constant fragments (``f"http://127.0.0.1:{port}"`` carries the
  fragment ``"http://127.0.0.1:"``).

NOT flagged: bare loopback literals with no scheme — bind addresses
(``ThreadingHTTPServer(("127.0.0.1", port), ...)``), defaults for
host fields, log strings. Binding a local server to loopback is
correct; only a URL hardcodes where a REQUEST goes. Deliberately
local hops (a router's own published endpoint) are baselined with a
justification in ``analysis_baseline.json``.
"""

from __future__ import annotations

import ast

from hops_tpu_torch.analysis.engine import Context, Rule, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile

#: Path fragments that put a file in scope: the hops the placement
#: layer can route to a remote host.
SCOPE = (
    "hops_tpu_torch/modelrepo/fleet/",
    "hops_tpu_torch/featurestore/online_serving.py",
)

_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def _is_loopback_url(value: str) -> bool:
    lower = value.lower()
    return "http" in lower and any(h in lower for h in _LOOPBACK)


@register
class HardcodedLoopbackRule(Rule):
    name = "hardcoded-loopback"
    description = (
        "loopback URL literal on a multi-host serving path — derive "
        "the address from the replica/shard registration (placement "
        "layer) instead of pinning the hop to the local machine"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        if not any(s in pf.relpath for s in SCOPE):
            return []
        findings: list[Finding] = []
        for node in ast.walk(pf.tree):
            # F-string fragments are ast.Constant children of
            # JoinedStr, so one Constant check covers both literal
            # shapes.
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            if _is_loopback_url(node.value):
                findings.append(
                    pf.finding(
                        self.name,
                        node,
                        "loopback URL literal on a multi-host path — "
                        "placed replicas/shards live on other hosts; "
                        "build the URL from the unit's registered "
                        "host:port",
                    )
                )
        return findings
