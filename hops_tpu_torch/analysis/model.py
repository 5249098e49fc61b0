"""Findings model and parsed-file representation for graftlint.
(counterpart of ``hops_tpu/analysis/model.py``)

A :class:`Finding` is one rule violation anchored to a file/line; its
:attr:`Finding.fingerprint` deliberately excludes the line number so a
baseline entry survives unrelated edits above the finding (the classic
"baseline churn" failure of line-keyed suppression files). A
:class:`ParsedFile` bundles everything a rule needs — source, AST, and
the comment map that carries ``# graftlint: disable=`` pragmas and
``# guarded by:`` lock annotations — parsed once per file, shared by
every rule.

Stdlib-only (``ast`` + ``tokenize``): the analysis modules never import
JAX or torch, and initialize no backend or device of their own.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import re
import tokenize
from pathlib import Path

#: Inline suppression: ``# graftlint: disable=rule-a,rule-b`` on the
#: finding's line silences those rules for that line only.
_DISABLE_RE = re.compile(r"#\s*graftlint:\s*disable=([\w,\s-]+)")
#: Whole-file suppression: ``# graftlint: disable-file=rule-a`` anywhere
#: (conventionally in the module header).
_DISABLE_FILE_RE = re.compile(r"#\s*graftlint:\s*disable-file=([\w,\s-]+)")
#: Lock annotation: ``# guarded by: self._lock`` trailing an attribute
#: assignment (or a ``def`` line — the body then assumes the lock held).
_GUARDED_RE = re.compile(r"#\s*guarded by:\s*([\w.\[\]()'\" ]+?)\s*(?:#|$)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``symbol`` is the enclosing def/class qualname (``<module>`` at top
    level): together with ``rule``, ``path`` and ``message`` it forms
    the line-number-free :attr:`fingerprint` baselines match on.
    """

    rule: str
    path: str  # posix-style, relative to the lint root
    line: int
    col: int
    message: str
    symbol: str = "<module>"
    #: Multi-line evidence (e.g. acquisition chains file:line by
    #: file:line). Excluded from the fingerprint — chains move with
    #: every unrelated edit, and a baseline keyed on them would churn
    #: exactly like a line-keyed one.
    detail: str = ""
    #: Other relpaths the finding's evidence spans (a cross-file
    #: inversion anchors on ONE acquisition site but implicates both).
    #: Engine-internal: ``--changed`` keeps a finding when any related
    #: file is in the changed set; not serialized, not fingerprinted.
    related: tuple = ()

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha256(
            "\x1f".join((self.rule, self.path, self.symbol, self.message)).encode()
        )
        return h.hexdigest()[:16]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "symbol": self.symbol,
            "fingerprint": self.fingerprint,
            "detail": self.detail,
        }

    def render(self) -> str:
        out = f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message} [{self.symbol}]"
        if self.detail:
            out += "".join(f"\n    {ln}" for ln in self.detail.splitlines())
        return out


class ParsedFile:
    """One source file, parsed once and shared by every rule."""

    def __init__(self, path: Path, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        #: line -> full comment text (including the ``#``).
        self.comments: dict[int, str] = {}
        #: line -> rule names disabled on that line.
        self.line_disables: dict[int, set[str]] = {}
        #: rule names disabled for the whole file.
        self.file_disables: set[str] = set()
        #: line -> lock expression from ``# guarded by:``.
        self.guard_comments: dict[int, str] = {}
        self._scan_comments()
        self._symbol_index: list[tuple[int, int, str]] | None = None
        self._parent_map: dict[int, ast.AST] | None = None

    def parents(self) -> dict[int, ast.AST]:
        """``id(child) -> parent`` for every node in the tree, built
        once per file and shared by every rule that walks ancestor
        chains (keyed by ``id`` because AST nodes are unhashable-by-
        value and identity is what an ancestor walk needs)."""
        if self._parent_map is None:
            pm: dict[int, ast.AST] = {}
            for n in ast.walk(self.tree):
                for child in ast.iter_child_nodes(n):
                    pm[id(child)] = n
            self._parent_map = pm
        return self._parent_map

    def _scan_comments(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                line = tok.start[0]
                self.comments[line] = tok.string
                m = _DISABLE_RE.search(tok.string)
                if m:
                    rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                    self.line_disables.setdefault(line, set()).update(rules)
                m = _DISABLE_FILE_RE.search(tok.string)
                if m:
                    self.file_disables.update(
                        r.strip() for r in m.group(1).split(",") if r.strip()
                    )
                m = _GUARDED_RE.search(tok.string)
                if m:
                    self.guard_comments[line] = m.group(1).strip()
        except tokenize.TokenError:
            pass  # ast.parse succeeded; comments best-effort

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_disables:
            return True
        return rule in self.line_disables.get(line, set())

    # -- symbol resolution ----------------------------------------------------

    def _build_symbol_index(self) -> list[tuple[int, int, str]]:
        """``(start, end, qualname)`` spans for every def/class, sorted
        outermost-first so the LAST containing span is the innermost."""
        spans: list[tuple[int, int, str]] = []

        def visit(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                ):
                    qual = f"{prefix}.{child.name}" if prefix else child.name
                    end = getattr(child, "end_lineno", child.lineno) or child.lineno
                    spans.append((child.lineno, end, qual))
                    visit(child, qual)
                else:
                    visit(child, prefix)

        visit(self.tree, "")
        spans.sort()
        return spans

    def symbol_at(self, line: int) -> str:
        """Qualname of the innermost def/class containing ``line``."""
        if self._symbol_index is None:
            self._symbol_index = self._build_symbol_index()
        best = "<module>"
        for start, end, qual in self._symbol_index:
            if start <= line <= end:
                best = qual
        return best

    def finding(
        self, rule: str, node: ast.AST, message: str, detail: str = ""
    ) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(
            rule=rule,
            path=self.relpath,
            line=line,
            col=col,
            message=message,
            symbol=self.symbol_at(line),
            detail=detail,
        )
