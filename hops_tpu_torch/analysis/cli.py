"""graftlint CLI — ``python -m hops_tpu_torch.analysis``.
(counterpart of ``hops_tpu/analysis/cli.py``)

Exit codes follow the CI contract: **0** clean (after baseline), **1**
non-baselined findings, **2** usage error (bad flags, unparsable
target, malformed/unjustified baseline). ``--format json`` emits the
machine schema the self-check test and external tooling consume;
``--write-baseline`` snapshots current findings with placeholder
justifications that the loader refuses until a human replaces them.

With no paths it lints the ``hops_tpu_torch`` package, subtracts
``analysis_baseline_torch.json`` at the repo root, and reads the metric
and debug-surface docs from ``docs/operations.md`` plus the port's
addendum ``docs/operations_torch.md``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Sequence

from hops_tpu_torch.analysis import baseline as baseline_mod
from hops_tpu_torch.analysis import engine

JSON_SCHEMA_VERSION = 1

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2


#: The port's own baseline file, looked up at the lint root before the
#: shared name (a snippet tree, or a checkout that keeps one ledger).
BASELINE_NAMES = ("analysis_baseline_torch.json", "analysis_baseline.json")

#: The operations docs, read as one text: the shared operator contract
#: and the port's addendum for what only the port registers.
DOCS_NAMES = ("operations.md", "operations_torch.md")


def default_target() -> Path:
    """The installed ``hops_tpu_torch`` package directory."""
    import hops_tpu_torch

    return Path(hops_tpu_torch.__file__).parent


def lint_root(paths: list[Path]) -> Path:
    """Directory finding paths are made relative to.

    When every target sits under the repo the ``hops_tpu_torch`` package
    lives in, use that repo root — baseline entries then read
    ``hops_tpu_torch/featurestore/loader.py`` regardless of which subtree was
    linted or where the CLI ran. Anything else (snippet dirs in tests)
    falls back to the targets' common ancestor.
    """
    repo = default_target().parent
    if all(p.resolve().is_relative_to(repo.resolve()) for p in paths):
        return repo
    return engine._common_root(paths)


def default_docs(root: Path) -> tuple[Path, ...] | None:
    """``docs/operations.md`` and ``docs/operations_torch.md`` next to
    the lint root (the first ``docs/`` that holds either), as many as
    are present; the rules read them as one text."""
    for base in (root, root.parent):
        found = tuple(
            base / "docs" / name for name in DOCS_NAMES
            if (base / "docs" / name).is_file()
        )
        if found:
            return found
    return None


def default_baseline(root: Path) -> Path | None:
    """The baseline a run at ``root`` subtracts by default: the first of
    :data:`BASELINE_NAMES` present there."""
    for name in BASELINE_NAMES:
        if (root / name).is_file():
            return root / name
    return None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m hops_tpu_torch.analysis",
        description="graftlint: correctness linter for the hops_tpu_torch tree",
    )
    parser.add_argument(
        "paths", nargs="*", type=Path,
        help="files/directories to lint (default: the hops_tpu_torch package)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format (default: text)",
    )
    parser.add_argument(
        "--baseline", type=Path, default=None,
        help="justified-findings baseline JSON to subtract (default: "
             "analysis_baseline_torch.json at the lint root, else "
             "analysis_baseline.json, when present)",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore any default baseline file",
    )
    parser.add_argument(
        "--write-baseline", type=Path, default=None,
        help="write current findings as a baseline (placeholder "
             "justifications; fill them in before committing)",
    )
    parser.add_argument(
        "--docs", type=Path, default=None,
        help="operations doc for metric-name-consistency "
             "(default: docs/operations.md and docs/operations_torch.md "
             "near the lint root)",
    )
    parser.add_argument(
        "--only", "--rules", dest="rules", default=None,
        help="comma-separated rule names to run (default: all); "
             "--rules is accepted as an alias",
    )
    parser.add_argument(
        "--changed", action="store_true",
        help="lint only files changed vs git HEAD (plus untracked); "
             "whole-program rules still analyze the full tree, with "
             "findings filtered to the changed files",
    )
    parser.add_argument(
        "--graph", choices=("lock",), default=None,
        help="dump the whole-program lock-acquisition graph instead of "
             "linting (DOT on text output, structured with --format json)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    return parser


def changed_paths(root: Path) -> "list[Path] | None":
    """``.py`` files changed vs HEAD plus untracked ones, or None when
    ``root`` is not a usable git checkout."""
    import subprocess

    names: set[str] = set()
    for args in (
        ["diff", "--name-only", "HEAD", "--"],
        ["ls-files", "--others", "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(
                ["git", "-C", str(root), *args],
                capture_output=True, text=True, timeout=30,
            )
        except (OSError, subprocess.SubprocessError):
            return None
        if proc.returncode != 0:
            return None
        names.update(ln.strip() for ln in proc.stdout.splitlines() if ln.strip())
    return [
        root / n for n in sorted(names)
        if n.endswith(".py") and (root / n).is_file()
    ]


def main(argv: Sequence[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    rules = engine.all_rules()
    if args.list_rules:
        for rule in rules:
            print(f"{rule.name}: {rule.description}")
        return EXIT_CLEAN

    if args.rules is not None:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        known = {r.name for r in rules}
        unknown = wanted - known
        if unknown:
            print(
                f"error: unknown rule(s): {', '.join(sorted(unknown))} "
                f"(known: {', '.join(sorted(known))})",
                file=sys.stderr,
            )
            return EXIT_USAGE
        rules = [r for r in rules if r.name in wanted]

    paths = args.paths or [default_target()]
    for p in paths:
        if not p.exists():
            print(f"error: no such lint target: {p}", file=sys.stderr)
            return EXIT_USAGE
    root = lint_root([Path(p) for p in paths])
    docs = args.docs if args.docs is not None else default_docs(root)
    if args.docs is not None and not args.docs.is_file():
        print(f"error: --docs file not found: {args.docs}", file=sys.stderr)
        return EXIT_USAGE

    if args.graph is not None:
        try:
            files = engine.parse_files([Path(p) for p in paths], root)
        except engine.ParseError as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_USAGE
        from hops_tpu_torch.analysis import concurrency
        from hops_tpu_torch.analysis.project import ProjectIndex

        model = concurrency.ConcurrencyModel(ProjectIndex(files))
        if args.format == "json":
            print(json.dumps(model.graph_dict(), indent=2))
        else:
            print(model.graph_dot())
        return EXIT_CLEAN

    focus = None
    if args.changed:
        focus = changed_paths(root)
        if focus is None:
            print(
                f"error: --changed needs a git checkout at {root}",
                file=sys.stderr,
            )
            return EXIT_USAGE
        if not focus:
            if args.format == "json":
                print(json.dumps(report([], [], []), indent=2))
            else:
                print("0 finding(s) (no changed files)", file=sys.stderr)
            return EXIT_CLEAN

    try:
        findings = engine.run(
            paths, root=root, docs_path=docs, rules=rules, focus=focus
        )
    except engine.ParseError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_USAGE

    if args.write_baseline is not None:
        baseline_mod.write(args.write_baseline, findings)
        print(
            f"wrote {len(findings)} finding(s) to {args.write_baseline} — "
            "replace every placeholder justification before committing",
            file=sys.stderr,
        )

    baseline_path = args.baseline
    if args.write_baseline is not None:
        # A regeneration run reports the raw findings it just wrote;
        # subtracting the old (or the freshly written, still-placeholder)
        # baseline here would only obscure what went into the file.
        baseline_path = None
    elif baseline_path is None and not args.no_baseline:
        baseline_path = default_baseline(root)
    baselined: list = []
    stale: list[dict] = []
    if baseline_path is not None:
        try:
            bl = baseline_mod.Baseline.load(baseline_path)
        except baseline_mod.BaselineError as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_USAGE
        findings, baselined, stale = bl.split(findings)
        if args.rules is not None or args.changed:
            # A subset run (--only, --changed) can't see the findings
            # the other rules' / other files' entries match — calling
            # them stale would tell the user to delete entries a full
            # run still needs.
            stale = []

    if args.format == "json":
        print(json.dumps(report(findings, baselined, stale), indent=2))
    else:
        for f in findings:
            print(f.render())
        if stale:
            print(
                f"warning: {len(stale)} stale baseline entrie(s) "
                f"(no matching finding) — delete them from the ledger:",
                file=sys.stderr,
            )
            for rule_name, entries in baseline_mod.group_stale(stale):
                print(f"  {rule_name}: {len(entries)}", file=sys.stderr)
                for e in entries:
                    print(
                        f"    {e['path']} [{e.get('symbol', '<module>')}]: "
                        f"{e['message']}",
                        file=sys.stderr,
                    )
        summary = f"{len(findings)} finding(s)"
        if baselined:
            summary += f", {len(baselined)} baselined"
        if stale:
            summary += f", {len(stale)} stale baseline entrie(s)"
        print(summary, file=sys.stderr)

    return EXIT_FINDINGS if findings else EXIT_CLEAN


def report(findings, baselined, stale) -> dict:
    """The ``--format json`` document."""
    by_rule: dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "version": JSON_SCHEMA_VERSION,
        "findings": [f.to_dict() for f in findings],
        "baselined": [f.to_dict() for f in baselined],
        "stale_baseline_entries": stale,
        "summary": {"count": len(findings), "by_rule": by_rule},
    }


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
