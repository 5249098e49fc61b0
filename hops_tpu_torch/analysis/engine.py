"""graftlint rule engine: walk, parse, run rules, apply suppressions.
(counterpart of ``hops_tpu/analysis/engine.py``)

Rules subclass :class:`Rule` and register with :func:`register`. Two
hooks: :meth:`Rule.check_file` for file-local rules and
:meth:`Rule.check_project` for whole-tree invariants (metric-name
consistency needs every registration site before it can judge any).
The engine is deliberately dumb about ordering — findings are sorted
``(path, line, col, rule)`` at the end so output is stable regardless
of rule registration order.
"""

from __future__ import annotations

import ast
import dataclasses
import tokenize
from pathlib import Path
from typing import Iterable, Iterator

from hops_tpu_torch.analysis.model import Finding, ParsedFile


@dataclasses.dataclass
class Context:
    """Project-level inputs shared by every rule."""

    root: Path  # lint root findings' paths are relative to
    #: The operations doc(s) for metric and debug-surface checks: one
    #: file, or several read as one text (the port's default is
    #: ``docs/operations.md`` joined with ``docs/operations_torch.md``).
    docs_path: Path | tuple[Path, ...] | None = None
    #: Per-run scratch shared across rules — the concurrency rules
    #: memoize one whole-program model here instead of building three.
    cache: dict = dataclasses.field(default_factory=dict)

    def docs_text(self) -> str | None:
        if self.docs_path is None:
            return None
        paths = [self.docs_path] if isinstance(self.docs_path, Path) else self.docs_path
        texts = [p.read_text() for p in paths if p.is_file()]
        return "\n".join(texts) if texts else None


class Rule:
    """One named check. ``name`` is the id used in findings, inline
    ``# graftlint: disable=`` pragmas, and baseline entries."""

    name: str = ""
    description: str = ""

    def check_file(self, pf: ParsedFile, ctx: Context) -> Iterable[Finding]:
        return ()

    def check_project(
        self, files: list[ParsedFile], ctx: Context
    ) -> Iterable[Finding]:
        return ()


_RULES: dict[str, Rule] = {}


def register(rule_cls: type[Rule]) -> type[Rule]:
    """Class decorator: instantiate and register a rule by its name."""
    rule = rule_cls()
    if not rule.name:
        raise ValueError(f"{rule_cls.__name__} has no rule name")
    if rule.name in _RULES:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    _RULES[rule.name] = rule
    return rule_cls


def all_rules() -> list[Rule]:
    """Registered rules, importing the built-in set on first use."""
    import hops_tpu_torch.analysis.rules  # noqa: F401 — registration side effect

    return [_RULES[k] for k in sorted(_RULES)]


def iter_py_files(paths: Iterable[Path]) -> Iterator[Path]:
    seen: set[Path] = set()  # a file named directly AND via its parent dir
    for p in paths:
        if p.is_dir():
            candidates = sorted(
                f for f in p.rglob("*.py") if "__pycache__" not in f.parts
            )
        elif p.suffix == ".py":
            candidates = [p]
        else:
            continue
        for f in candidates:
            key = f.resolve()
            if key not in seen:
                seen.add(key)
                yield f


def parse_files(paths: Iterable[Path], root: Path) -> list[ParsedFile]:
    """Parse every ``.py`` under ``paths``; files that do not parse are
    reported by the caller via :class:`ParseError`."""
    out: list[ParsedFile] = []
    for f in iter_py_files(paths):
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        try:
            # tokenize.open honors PEP 263 coding cookies + BOMs, which
            # plain read_text (always-UTF-8) would crash on.
            with tokenize.open(f) as fh:
                source = fh.read()
            out.append(ParsedFile(f, rel, source))
        except (SyntaxError, ValueError, UnicodeDecodeError, OSError) as e:
            # ValueError: ast.parse on source with NUL bytes.
            raise ParseError(f"{f}: {e}") from e
    return out


class ParseError(RuntimeError):
    """A lint target failed to parse — a usage error, not a finding."""


def run(
    paths: Iterable[Path],
    root: Path | None = None,
    docs_path: Path | tuple[Path, ...] | None = None,
    rules: Iterable[Rule] | None = None,
    focus: Iterable[Path] | None = None,
) -> list[Finding]:
    """Lint ``paths`` and return suppression-filtered findings.

    Baseline filtering is the caller's job (:mod:`.baseline`): the
    engine only honors inline/file pragmas, so ``--write-baseline``
    sees exactly the findings a baseline could absorb.

    ``focus`` (``--changed``) restricts REPORTING to those files while
    keeping the whole-program rules sound: file-local rules simply skip
    unfocused files, but project rules still analyze every parsed file
    (a lock graph built from a diff would miss the cross-file half of
    an inversion) and only their findings are filtered afterwards — a
    project finding survives when its anchor file OR any file in
    ``Finding.related`` (its cross-file evidence) is focused.
    """
    paths = [Path(p) for p in paths]
    if root is None:
        root = _common_root(paths)
    ctx = Context(root=root, docs_path=docs_path)
    files = parse_files(paths, root)
    by_path = {pf.relpath: pf for pf in files}
    focus_keys: set[Path] | None = None
    if focus is not None:
        focus_keys = {Path(p).resolve() for p in focus}
    active = list(rules) if rules is not None else all_rules()
    findings: list[Finding] = []
    for rule in active:
        for pf in files:
            if focus_keys is not None and pf.path.resolve() not in focus_keys:
                continue
            for finding in rule.check_file(pf, ctx):
                if not pf.suppressed(rule.name, finding.line):
                    findings.append(finding)
        for finding in rule.check_project(files, ctx):
            pf = by_path.get(finding.path)
            if pf is not None and pf.suppressed(finding.rule, finding.line):
                continue
            if focus_keys is not None:
                involved = [finding.path, *finding.related]
                if not any(
                    rp in by_path and by_path[rp].path.resolve() in focus_keys
                    for rp in involved
                ):
                    continue
            findings.append(finding)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def _common_root(paths: list[Path]) -> Path:
    resolved = [p.resolve() if p.is_dir() else p.resolve().parent for p in paths]
    if not resolved:
        return Path.cwd()
    root = resolved[0]
    for p in resolved[1:]:
        while not p.is_relative_to(root):
            root = root.parent
    return root


# -- shared AST helpers used by several rules ---------------------------------


def call_name(node: ast.AST) -> str:
    """Terminal name of a call target: ``jax.jit`` -> ``jit``,
    ``print`` -> ``print``; empty string for anything else."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for nested Name/Attribute chains, else ``''``."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def assigned_names(target: ast.AST) -> set[str]:
    """Plain names bound by an assignment target (tuple-unpack aware)."""
    out: set[str] = set()
    for node in ast.walk(target):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


def root_name(node: ast.AST) -> ast.AST:
    """Strip Subscript/Attribute layers: ``metrics['loss']`` ->
    ``metrics`` (the Name), ``step(s, b)[1]`` -> the Call."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node
