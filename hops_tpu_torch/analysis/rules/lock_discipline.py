"""lock-discipline: annotated shared state touched without its lock.
(counterpart of ``hops_tpu/analysis/rules/lock_discipline.py``)

The host-side subsystems (loader worker pools, serving driver threads,
the relay lock breaker) guard shared attributes with plain
``threading`` locks — nothing makes a new code path remember. This
rule turns the convention into a checked contract: a trailing

    ``# guarded by: self._lock``

comment on an attribute's defining assignment declares its lock, and
every other access to that attribute in the class must sit lexically
inside ``with self._lock:``. Module-level names annotated the same way
must be accessed under their lock from any function in the file.

Sanctioned exceptions, because they are single-threaded by
construction:

- the defining assignment itself and everything in ``__init__`` (no
  other thread can hold the object yet);
- module-level statements (imports run once, single-threaded);
- functions whose ``def`` line carries the same ``# guarded by:``
  annotation — the documented "caller holds the lock" helper shape
  (e.g. a ``_child()`` only ever called under the registry lock).
"""

from __future__ import annotations

import ast

from hops_tpu_torch.analysis.engine import Context, Rule, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile


def _norm(expr: str) -> str:
    return "".join(expr.split())


def _stmt_covers(node: ast.stmt, line: int) -> bool:
    return node.lineno <= line <= (getattr(node, "end_lineno", node.lineno) or node.lineno)


@register
class LockDisciplineRule(Rule):
    name = "lock-discipline"
    description = (
        "attributes annotated `# guarded by: <lock>` accessed outside a "
        "`with <lock>:` block"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        if not pf.guard_comments:
            return []
        parents = pf.parents()

        # -- collect declarations --------------------------------------------
        class_guards: dict[int, dict[str, str]] = {}  # id(ClassDef) -> attr -> lock
        class_nodes: dict[int, ast.ClassDef] = {}
        module_guards: dict[str, str] = {}
        fn_holds: dict[int, set[str]] = {}  # id(FunctionDef) -> held locks
        decl_lines: set[int] = set()

        for line, lock in pf.guard_comments.items():
            lock_n = _norm(lock)
            for node in ast.walk(pf.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if node.lineno == line or (
                        node.body and line < node.body[0].lineno and node.lineno <= line
                    ):
                        fn_holds.setdefault(id(node), set()).add(lock_n)
                if not isinstance(node, (ast.Assign, ast.AnnAssign)) or not _stmt_covers(
                    node, line
                ):
                    continue
                targets = (
                    node.targets if isinstance(node, ast.Assign) else [node.target]
                )
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        cls = self._enclosing_class(node, parents)
                        if cls is not None:
                            class_guards.setdefault(id(cls), {})[t.attr] = lock_n
                            class_nodes[id(cls)] = cls
                            decl_lines.add(line)
                    elif isinstance(t, ast.Name) and self._at_module_level(
                        node, parents
                    ):
                        module_guards[t.id] = lock_n
                        decl_lines.add(line)

        findings: list[Finding] = []

        # -- class-attribute guards ------------------------------------------
        # A guard declared on a base class covers its in-file subclasses
        # too (the registry's `_child()` helpers live on subclasses of
        # the `_Metric` that declares `_children`).
        all_classes = [n for n in ast.walk(pf.tree) if isinstance(n, ast.ClassDef)]
        for cls_id, guards in class_guards.items():
            cls = class_nodes[cls_id]
            for scope_cls in self._with_subclasses(cls, all_classes):
                findings.extend(
                    self._check_class(
                        pf, scope_cls, guards, parents, decl_lines, fn_holds
                    )
                )

        # -- module-level guards ---------------------------------------------
        if module_guards:
            for node in ast.walk(pf.tree):
                if not isinstance(node, ast.Name) or node.id not in module_guards:
                    continue
                lock = module_guards[node.id]
                if node.lineno in decl_lines:
                    continue
                if self._at_module_level(node, parents):
                    continue  # import-time init is single-threaded
                if self._held(node, parents, lock, fn_holds, allow_init_of=None):
                    continue
                findings.append(
                    pf.finding(
                        self.name,
                        node,
                        f"`{node.id}` (guarded by `{lock}`) accessed outside "
                        f"`with {lock}:`",
                    )
                )
        return findings

    @staticmethod
    def _with_subclasses(
        cls: ast.ClassDef, all_classes: list[ast.ClassDef]
    ) -> list[ast.ClassDef]:
        """``cls`` plus every in-file class whose base-name chain
        reaches it (name-based, transitive)."""
        out = [cls]
        names = {cls.name}
        changed = True
        while changed:
            changed = False
            for c in all_classes:
                if c in out:
                    continue
                if any(
                    isinstance(b, ast.Name) and b.id in names
                    for b in c.bases
                ):
                    out.append(c)
                    names.add(c.name)
                    changed = True
        return out

    def _check_class(
        self,
        pf: ParsedFile,
        cls: ast.ClassDef,
        guards: dict[str, str],
        parents: dict[int, ast.AST],
        decl_lines: set[int],
        fn_holds: dict[int, set[str]],
    ) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(cls):
            if not isinstance(node, ast.Attribute) or node.attr not in guards:
                continue
            lock = guards[node.attr]
            if node.lineno in decl_lines:
                continue
            if self._held(node, parents, lock, fn_holds, allow_init_of=cls):
                continue
            findings.append(
                pf.finding(
                    self.name,
                    node,
                    f"`{ast.unparse(node)}` (guarded by `{lock}`) accessed "
                    f"outside `with {lock}:`",
                )
            )
        return findings

    @staticmethod
    def _enclosing_class(
        node: ast.AST, parents: dict[int, ast.AST]
    ) -> ast.ClassDef | None:
        cur = parents.get(id(node))
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = parents.get(id(cur))
        return None

    @staticmethod
    def _at_module_level(node: ast.AST, parents: dict[int, ast.AST]) -> bool:
        cur = parents.get(id(node))
        while cur is not None:
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                return False
            cur = parents.get(id(cur))
        return True

    @staticmethod
    def _held(
        node: ast.AST,
        parents: dict[int, ast.AST],
        lock: str,
        fn_holds: dict[int, set[str]],
        allow_init_of: ast.ClassDef | None,
    ) -> bool:
        cur = parents.get(id(node))
        while cur is not None:
            if isinstance(cur, ast.With):
                for item in cur.items:
                    if _norm(ast.unparse(item.context_expr)) == lock:
                        return True
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if lock in fn_holds.get(id(cur), set()):
                    return True
                if (
                    allow_init_of is not None
                    and cur.name == "__init__"
                    and LockDisciplineRule._enclosing_class(cur, parents)
                    is allow_init_of
                ):
                    return True
            cur = parents.get(id(cur))
        return False
