"""Tier-1 gate: graftlint over the port's tree (``hops_tpu_torch/``) must
be clean — the counterpart of ``tests/test_analysis_selfcheck.py``.

Any new host effect under ``torch.compile`` or CUDA graph capture, state
handed to another thread and then updated in place, host sync in a step
loop, unguarded annotated attribute, undocumented or conflicting metric,
or swallowed exception fails CI until it is fixed or baselined with a
written justification in ``analysis_baseline_torch.json``. The port's
baseline and its docs addendum (``docs/operations_torch.md``) are files
of their own, so nothing the JAX gate reads changes.

The tree is linted once per test session (all rules, no baseline, the
port's default docs: the first xdist worker to need it lints, the rest
read its result); each test filters that run by rule.
"""

from __future__ import annotations

import time
from pathlib import Path

import pytest

from hops_tpu_torch import analysis
from hops_tpu_torch.analysis import engine
from hops_tpu_torch.analysis.baseline import Baseline
from hops_tpu_torch.analysis.cli import default_docs, lint_root
from test_torch_grad_comms import shared_once

PACKAGE = Path(analysis.__file__).parents[1]  # hops_tpu_torch/
REPO = PACKAGE.parent
BASELINE = REPO / "analysis_baseline_torch.json"

#: ``tests/test_analysis.py``'s tree cases: rules the tree holds with no
#: baseline entry at all.
CLEAN_WITHOUT_BASELINE = (
    "adhoc-http-server", "blocking-call-no-deadline", "debug-surface-docs",
    "json-on-hot-wire", "relay-json-roundtrip", "wall-clock-deadline",
)


def _lint_tree() -> dict:
    root = lint_root([PACKAGE])
    assert root == REPO
    t0 = time.monotonic()
    findings = engine.run([PACKAGE], root=root, docs_path=default_docs(root))
    return {"findings": findings, "seconds": time.monotonic() - t0}


@pytest.fixture(scope="module")
def tree_lint(tmp_path_factory) -> dict:
    """Every rule's raw findings over the port tree, and the run's wall
    clock: one run per test session."""
    return shared_once(tmp_path_factory, "torch_analysis_tree_lint", _lint_tree)


def _rule(findings, *names: str):
    return [f for f in findings if f.rule in names]


def test_tree_has_zero_nonbaselined_findings(tree_lint):
    new, _, _ = Baseline.load(BASELINE).split(tree_lint["findings"])
    assert not new, (
        "graftlint found new issues in the port (fix them, or baseline with "
        "a written justification in analysis_baseline_torch.json):\n"
        + "\n".join(f.render() for f in new)
    )


def test_baseline_is_justified_and_current(tree_lint):
    """Every entry still matches a real finding and carries a
    justification (Baseline.load raises on a missing or placeholder one)."""
    bl = Baseline.load(BASELINE)
    _, _, stale = bl.split(tree_lint["findings"])
    assert not stale, (
        "stale baseline entries (their findings no longer exist — delete "
        "them):\n" + "\n".join(f"{e['rule']}: {e['path']}: {e['message']}" for e in stale)
    )


def test_docs_metric_tables_match_code_without_baseline(tree_lint):
    """metric-name-consistency holds with NO baseline help, against
    docs/operations.md and the port's docs/operations_torch.md."""
    assert [p.name for p in default_docs(REPO)] == ["operations.md", "operations_torch.md"]
    findings = _rule(tree_lint["findings"], "metric-name-consistency")
    assert not findings, "\n".join(f.render() for f in findings)


def test_concurrency_rules_hold_tree_wide(tree_lint):
    """lock-order-inversion, blocking-under-lock and event-loop-stall:
    zero non-baselined findings across the port."""
    wanted = {"lock-order-inversion", "blocking-under-lock", "event-loop-stall"}
    assert wanted <= {r.name for r in engine.all_rules()}
    findings, _, _ = Baseline.load(BASELINE).split(_rule(tree_lint["findings"], *wanted))
    assert not findings, (
        "new concurrency findings (fix, or baseline with a written "
        "justification):\n" + "\n".join(f.render() for f in findings)
    )


@pytest.mark.parametrize("rule", CLEAN_WITHOUT_BASELINE)
def test_rule_is_clean_without_baseline(tree_lint, rule):
    """The port counterparts of ``tests/test_analysis.py``'s
    ``*_tree_is_clean`` cases: zero findings, no baseline entries."""
    assert rule in {r.name for r in engine.all_rules()}
    findings = _rule(tree_lint["findings"], rule)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_torch_forms_are_clean_without_baseline(tree_lint):
    """The torch forms of host-sync-in-loop, jit-purity and
    use-after-donation find nothing in the port, baseline or not."""
    findings = _rule(tree_lint["findings"], "host-sync-in-loop", "jit-purity",
                     "use-after-donation")
    assert findings == [], "\n".join(f.render() for f in findings)


def test_analyzer_full_tree_wall_clock_bound(tree_lint):
    """The whole-program analysis of the port's tree with ALL rules
    stays well under a minute."""
    assert tree_lint["seconds"] < 60.0, f"full-tree lint took {tree_lint['seconds']:.1f}s"
