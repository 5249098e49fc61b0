"""graftlint — AST-based correctness linter for the hops_tpu_torch tree.
(counterpart of ``hops_tpu/analysis/__init__.py``)

The worst bugs in a traced-and-threaded codebase are invisible to
pytest on CPU: a host effect inside a compiled or captured step, a
busy-spin in a lock acquire path, a live train state handed to another
thread and then updated in place by the next step. This package
machine-checks those invariants: a rule engine over Python ASTs
(:mod:`.engine`), a findings/baseline model with justified suppressions
(:mod:`.model`, :mod:`.baseline`), 18 rules (:mod:`.rules`) — the JAX
package's, with torch forms of ``jit-purity`` (``torch.compile``, CUDA
graph capture), ``use-after-donation`` (a handoff followed by an
in-place step) and ``host-sync-in-loop`` (``.cpu()``, ``.tolist()``,
``torch.cuda.synchronize()``) — and a CLI (:mod:`.cli`,
``python -m hops_tpu_torch.analysis``) whose zero-findings exit code
gates CI via ``tests/test_torch_analysis_selfcheck.py``, against the
port's own baseline (``analysis_baseline_torch.json``) and docs
addendum (``docs/operations_torch.md``).

The analysis code itself is stdlib-only (``ast`` + ``tokenize`` — it
never imports torch or touches a device); note that running it as
``python -m hops_tpu_torch.analysis`` still pays the parent package's
import cost, since ``-m`` imports ``hops_tpu_torch`` first.

Quick use::

    from hops_tpu_torch import analysis
    findings = analysis.lint([Path("hops_tpu_torch")])
    for f in findings:
        print(f.render())
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

from hops_tpu_torch.analysis.baseline import Baseline, BaselineError
from hops_tpu_torch.analysis.engine import Context, Rule, all_rules, register, run
from hops_tpu_torch.analysis.model import Finding, ParsedFile

__all__ = [
    "Baseline",
    "BaselineError",
    "Context",
    "Finding",
    "ParsedFile",
    "Rule",
    "all_rules",
    "lint",
    "register",
    "run",
]


def lint(
    paths: Iterable[Path | str],
    baseline: Path | str | None = None,
    docs_path: Path | str | None = None,
) -> list[Finding]:
    """Lint ``paths`` and return non-baselined findings — the in-process
    equivalent of the CLI (used by the tier-1 self-check test): same
    root resolution, same default docs discovery."""
    from hops_tpu_torch.analysis import cli

    targets = [Path(p) for p in paths]
    root = cli.lint_root(targets)
    docs = Path(docs_path) if docs_path is not None else cli.default_docs(root)
    findings = run(targets, root=root, docs_path=docs)
    if baseline is not None:
        findings, _, _ = Baseline.load(Path(baseline)).split(findings)
    return findings
