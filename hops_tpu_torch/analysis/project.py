"""Project-wide symbol table and conservative call graph for graftlint.
(counterpart of ``hops_tpu/analysis/project.py``)

The per-file rules see one AST at a time; the concurrency rules
need to know that ``self._pool.request(...)`` in ``router.py`` lands in
``httpclient.HTTPPool.request`` and that ``self._lock`` there is a
different lock than the router's. This module builds that view once per
lint run:

- a :class:`ModuleInfo` per parsed file (imports, classes, functions,
  module-level lock variables);
- a :class:`ClassInfo` per class with its methods, resolved in-project
  bases, inferred attribute types (``self.x = ClassName(...)``,
  annotated assignments/parameters), and lock-typed attributes
  (``threading.Lock/RLock/Condition/Semaphore`` constructions plus
  attributes named by a ``# guarded by:`` annotation);
- call resolution: ``self.m()``, ``self.attr.m()``, ``mod.f()``,
  ``ClassName(...)`` and typed-local ``x.m()`` are resolved to project
  :class:`FuncInfo` targets.

Everything is deliberately an UNDER-approximation: an unresolvable call
contributes no edge. The concurrency layer (:mod:`.concurrency`) builds
its lock graph on top, so a missed edge can only hide a finding, never
invent one — the property a zero-findings CI gate needs.

Types are either a :class:`ClassInfo` (project class) or a string tag
for the small set of stdlib types the concurrency rules care about
(``"lock"``, ``"cond"``, ``"event"``, ``"thread"``, ``"selector"``,
``"popen"``, ...). Stdlib-only, like the rest of the analysis package.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, Union

from hops_tpu_torch.analysis.engine import dotted_name
from hops_tpu_torch.analysis.model import ParsedFile

#: Stdlib constructors / annotations the concurrency layer distinguishes.
BUILTIN_TAGS: dict[str, str] = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "cond",
    "threading.Semaphore": "sem",
    "threading.BoundedSemaphore": "sem",
    "threading.Event": "event",
    "threading.Thread": "thread",
    "subprocess.Popen": "popen",
    "selectors.DefaultSelector": "selector",
    "selectors.BaseSelector": "selector",
    "concurrent.futures.ThreadPoolExecutor": "executor",
    "futures.ThreadPoolExecutor": "executor",
    "queue.Queue": "queue",
    "queue.SimpleQueue": "queue",
}

#: Type tags that make an attribute/variable a lock for graph purposes.
LOCK_TAGS = {"lock", "rlock", "cond", "sem"}

TypeRef = Union["ClassInfo", str]

_AMBIGUOUS = "<ambiguous>"


@dataclasses.dataclass
class FuncInfo:
    """One function or method definition."""

    name: str
    qualname: str  # e.g. ``HTTPPool.request`` or ``with_deadline``
    module: "ModuleInfo"
    node: ast.FunctionDef | ast.AsyncFunctionDef
    cls: "ClassInfo | None" = None

    @property
    def key(self) -> str:
        return f"{self.module.relpath}:{self.qualname}"

    def __hash__(self) -> int:  # identity — one node, one FuncInfo
        return id(self)

    def __eq__(self, other: object) -> bool:
        return self is other


@dataclasses.dataclass
class ClassInfo:
    """One class definition with resolved project bases."""

    name: str
    module: "ModuleInfo"
    node: ast.ClassDef
    methods: dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
    bases: list["ClassInfo"] = dataclasses.field(default_factory=list)
    #: attr name -> inferred type (project class or builtin tag).
    attr_types: dict[str, TypeRef] = dataclasses.field(default_factory=dict)
    #: attr name -> lock kind ("lock"/"rlock"/"cond"/"sem").
    lock_attrs: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.module.relpath}:{self.name}"

    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other: object) -> bool:
        return self is other

    def mro(self) -> Iterator["ClassInfo"]:
        """Self plus in-project bases, left-to-right depth-first."""
        seen: set[int] = set()
        stack = [self]
        while stack:
            c = stack.pop(0)
            if id(c) in seen:
                continue
            seen.add(id(c))
            yield c
            stack = list(c.bases) + stack

    def resolve_method(self, name: str) -> FuncInfo | None:
        for c in self.mro():
            if name in c.methods:
                return c.methods[name]
        return None

    def resolve_attr_type(self, name: str) -> TypeRef | None:
        for c in self.mro():
            t = c.attr_types.get(name)
            if t is not None:
                return None if t == _AMBIGUOUS else t
        return None

    def lock_decl(self, attr: str) -> "tuple[ClassInfo, str] | None":
        """(declaring class, kind) for a lock attribute — the declaring
        class gives the lock a stable identity shared by subclasses."""
        for c in self.mro():
            if attr in c.lock_attrs:
                return c, c.lock_attrs[attr]
        return None


@dataclasses.dataclass
class ModuleInfo:
    """One parsed file plus its import/def surface."""

    pf: ParsedFile
    relpath: str
    modname: str  # dotted module name derived from relpath
    imports: dict[str, str] = dataclasses.field(default_factory=dict)
    from_imports: dict[str, tuple[str, str]] = dataclasses.field(default_factory=dict)
    functions: dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
    classes: dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    #: module-level lock variables: name -> kind.
    module_locks: dict[str, str] = dataclasses.field(default_factory=dict)
    #: module-level variable types (``_PLAN: FaultPlan | None = None``).
    var_types: dict[str, TypeRef] = dataclasses.field(default_factory=dict)


def _modname(relpath: str) -> str:
    name = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = [p for p in name.split("/") if p]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class ProjectIndex:
    """The whole-program view. Build once per lint run (memoized on the
    engine :class:`~hops_tpu_torch.analysis.engine.Context`)."""

    def __init__(self, files: list[ParsedFile]):
        self.modules: dict[str, ModuleInfo] = {}  # relpath -> module
        self.by_modname: dict[str, ModuleInfo] = {}
        for pf in files:
            mod = ModuleInfo(pf=pf, relpath=pf.relpath, modname=_modname(pf.relpath))
            self.modules[pf.relpath] = mod
            self.by_modname[mod.modname] = mod
        for mod in self.modules.values():
            self._scan_module(mod)
        for mod in self.modules.values():
            self._resolve_bases(mod)
        for mod in self.modules.values():
            self._infer_types(mod)
        for mod in self.modules.values():
            self._register_guard_locks(mod)

    # -- pass 1: defs and imports --------------------------------------------

    def _scan_module(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.pf.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    mod.imports[alias.asname or alias.name.split(".")[0]] = alias.name
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for alias in node.names:
                    mod.from_imports[alias.asname or alias.name] = (
                        node.module,
                        alias.name,
                    )
        for stmt in mod.pf.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mod.functions[stmt.name] = FuncInfo(
                    name=stmt.name, qualname=stmt.name, module=mod, node=stmt
                )
            elif isinstance(stmt, ast.ClassDef):
                cls = ClassInfo(name=stmt.name, module=mod, node=stmt)
                mod.classes[stmt.name] = cls
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        cls.methods[sub.name] = FuncInfo(
                            name=sub.name,
                            qualname=f"{stmt.name}.{sub.name}",
                            module=mod,
                            node=sub,
                            cls=cls,
                        )

    # -- pass 2: base classes -------------------------------------------------

    def _resolve_bases(self, mod: ModuleInfo) -> None:
        for cls in mod.classes.values():
            for base in cls.node.bases:
                t = self.resolve_type_expr(base, mod)
                if isinstance(t, ClassInfo):
                    cls.bases.append(t)

    # -- pass 3: attribute / variable types -----------------------------------

    def _infer_types(self, mod: ModuleInfo) -> None:
        for stmt in mod.pf.tree.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
                t = self._annotation_type(stmt.annotation, mod)
                if t is not None:
                    self._record(mod.var_types, stmt.target.id, t)
            elif isinstance(stmt, ast.Assign) and stmt.value is not None:
                t = self._value_type(stmt.value, mod)
                if t is not None:
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            self._record(mod.var_types, tgt.id, t)
        for name, t in mod.var_types.items():
            if isinstance(t, str) and t in LOCK_TAGS:
                mod.module_locks[name] = t
        for cls in mod.classes.values():
            self._infer_class_attrs(cls)

    def _infer_class_attrs(self, cls: ClassInfo) -> None:
        for meth in cls.methods.values():
            params = self._param_types(meth)
            for node in ast.walk(meth.node):
                target = None
                value = None
                ann = None
                if isinstance(node, ast.Assign):
                    value = node.value
                    for t in node.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            target = t.attr
                elif isinstance(node, ast.AnnAssign):
                    t = node.target
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        target = t.attr
                        ann = node.annotation
                        value = node.value
                if target is None:
                    continue
                inferred: TypeRef | None = None
                if ann is not None:
                    inferred = self._annotation_type(ann, cls.module)
                if inferred is None and value is not None:
                    inferred = self._value_type(value, cls.module)
                    if (
                        inferred is None
                        and isinstance(value, ast.Name)
                        and value.id in params
                    ):
                        inferred = params[value.id]
                if inferred is not None:
                    self._record(cls.attr_types, target, inferred)
        for attr, t in cls.attr_types.items():
            if isinstance(t, str) and t in LOCK_TAGS:
                cls.lock_attrs[attr] = t

    @staticmethod
    def _record(table: dict[str, TypeRef], name: str, t: TypeRef) -> None:
        prev = table.get(name)
        if prev is None or prev == t:
            table[name] = t
        elif prev != _AMBIGUOUS:
            table[name] = _AMBIGUOUS

    def _param_types(self, func: FuncInfo) -> dict[str, TypeRef]:
        out: dict[str, TypeRef] = {}
        args = func.node.args
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            if a.annotation is not None:
                t = self._annotation_type(a.annotation, func.module)
                if t is not None:
                    out[a.arg] = t
        return out

    # -- guard-comment locks ---------------------------------------------------
    # ``self._idle = {}  # guarded by: self._lock`` declares ``_lock`` a
    # lock on that class even when its assignment is untyped (e.g.
    # ``self._lock = lock`` from an unannotated parameter).

    def _register_guard_locks(self, mod: ModuleInfo) -> None:
        for line, expr in mod.pf.guard_comments.items():
            try:
                parsed = ast.parse(expr.strip(), mode="eval").body
            except SyntaxError:
                continue
            if (
                isinstance(parsed, ast.Attribute)
                and isinstance(parsed.value, ast.Name)
                and parsed.value.id == "self"
            ):
                cls = self._class_at(mod, line)
                if cls is not None and parsed.attr not in cls.lock_attrs:
                    kind = cls.attr_types.get(parsed.attr)
                    cls.lock_attrs[parsed.attr] = (
                        kind if isinstance(kind, str) and kind in LOCK_TAGS else "lock"
                    )
            elif isinstance(parsed, ast.Name):
                mod.module_locks.setdefault(parsed.id, "lock")

    @staticmethod
    def _class_at(mod: ModuleInfo, line: int) -> ClassInfo | None:
        for cls in mod.classes.values():
            end = getattr(cls.node, "end_lineno", cls.node.lineno) or cls.node.lineno
            if cls.node.lineno <= line <= end:
                return cls
        return None

    # -- type resolution -------------------------------------------------------

    def resolve_type_name(self, dotted: str, mod: ModuleInfo) -> TypeRef | None:
        """Resolve a dotted type name in ``mod``'s namespace."""
        if not dotted:
            return None
        if dotted in BUILTIN_TAGS:
            return BUILTIN_TAGS[dotted]
        head, _, rest = dotted.partition(".")
        if not rest:
            if head in mod.classes:
                return mod.classes[head]
            if head in mod.from_imports:
                src_mod, orig = mod.from_imports[head]
                full = f"{src_mod}.{orig}"
                if full in BUILTIN_TAGS:
                    return BUILTIN_TAGS[full]
                target = self.by_modname.get(src_mod)
                if target is not None:
                    return target.classes.get(orig)
            return None
        if head in mod.imports:
            full = f"{mod.imports[head]}.{rest}"
            if full in BUILTIN_TAGS:
                return BUILTIN_TAGS[full]
            target = self.by_modname.get(mod.imports[head])
            if target is not None and "." not in rest:
                return target.classes.get(rest)
        if head in mod.from_imports:
            # ``from hops_tpu_torch.runtime import httpclient`` style.
            src_mod, orig = mod.from_imports[head]
            full = f"{src_mod}.{orig}.{rest}"
            if full in BUILTIN_TAGS:
                return BUILTIN_TAGS[full]
            target = self.by_modname.get(f"{src_mod}.{orig}")
            if target is not None and "." not in rest:
                return target.classes.get(rest)
        return None

    def resolve_type_expr(self, node: ast.AST, mod: ModuleInfo) -> TypeRef | None:
        return self.resolve_type_name(dotted_name(node), mod)

    def _annotation_type(self, ann: ast.AST, mod: ModuleInfo) -> TypeRef | None:
        """Best-effort type from an annotation: handles string forms,
        ``X | None`` unions, and ``Optional[X]``; containers are skipped."""
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value.strip(), mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            return self._annotation_type(ann.left, mod) or self._annotation_type(
                ann.right, mod
            )
        if isinstance(ann, ast.Subscript):
            base = dotted_name(ann.value)
            if base.split(".")[-1] == "Optional":
                return self._annotation_type(ann.slice, mod)
            return None
        if isinstance(ann, (ast.Name, ast.Attribute)):
            return self.resolve_type_expr(ann, mod)
        return None

    def _value_type(self, value: ast.AST, mod: ModuleInfo) -> TypeRef | None:
        """Type of an assigned value: ``ClassName(...)`` constructions
        and calls to functions with resolvable return annotations."""
        if not isinstance(value, ast.Call):
            return None
        t = self.resolve_type_expr(value.func, mod)
        if t is not None:
            return t
        return None

    # -- expression typing inside a function ----------------------------------

    def local_env(self, func: FuncInfo) -> dict[str, TypeRef]:
        """Parameter annotations plus simple ``x = <typed expr>``
        assignments, in a single forward pass."""
        env = self._param_types(func)
        for node in ast.walk(func.node):
            if isinstance(node, ast.Assign):
                t = self.infer_expr_type(node.value, env, func)
                if t is not None:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            env[tgt.id] = t
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                t = self._annotation_type(node.annotation, func.module)
                if t is not None:
                    env[node.target.id] = t
        return env

    def infer_expr_type(
        self,
        expr: ast.AST,
        env: dict[str, TypeRef],
        func: FuncInfo,
        depth: int = 0,
    ) -> TypeRef | None:
        if depth > 6:
            return None
        mod = func.module
        if isinstance(expr, ast.Name):
            if expr.id == "self" and func.cls is not None:
                return func.cls
            t = env.get(expr.id)
            if t is not None:
                return t
            t = mod.var_types.get(expr.id)
            if t is not None and t != _AMBIGUOUS:
                return t
            return None
        if isinstance(expr, ast.Attribute):
            base = self.infer_expr_type(expr.value, env, func, depth + 1)
            if isinstance(base, ClassInfo):
                return base.resolve_attr_type(expr.attr)
            return None
        if isinstance(expr, ast.Call):
            t = self.resolve_type_expr(expr.func, mod)
            if t is not None:
                return t
            callee = self.resolve_call(expr, func, env)
            if callee is not None and callee.node.returns is not None:
                return self._annotation_type(callee.node.returns, callee.module)
            return None
        return None

    # -- call resolution -------------------------------------------------------

    def resolve_call(
        self, call: ast.Call, func: FuncInfo, env: dict[str, TypeRef]
    ) -> FuncInfo | None:
        """Resolve a call site to a project function, or ``None``.

        ``ClassName(...)`` resolves to the class ``__init__`` (searching
        project bases) so constructor work composes into the graph."""
        f = call.func
        mod = func.module
        if isinstance(f, ast.Name):
            if f.id in mod.functions:
                return mod.functions[f.id]
            t = self.resolve_type_name(f.id, mod)
            if isinstance(t, ClassInfo):
                return t.resolve_method("__init__")
            if f.id in mod.from_imports:
                src_mod, orig = mod.from_imports[f.id]
                target = self.by_modname.get(src_mod)
                if target is not None:
                    return target.functions.get(orig)
            return None
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name):
                alias = f.value.id
                if alias in mod.imports:
                    target = self.by_modname.get(mod.imports[alias])
                    if target is not None:
                        if f.attr in target.functions:
                            return target.functions[f.attr]
                        t = target.classes.get(f.attr)
                        if t is not None:
                            return t.resolve_method("__init__")
                    return None
                if alias in mod.from_imports and alias not in env:
                    src_mod, orig = mod.from_imports[alias]
                    target = self.by_modname.get(f"{src_mod}.{orig}")
                    if target is not None:
                        if f.attr in target.functions:
                            return target.functions[f.attr]
                        t = target.classes.get(f.attr)
                        if t is not None:
                            return t.resolve_method("__init__")
                    return None
            base_t = self.infer_expr_type(f.value, env, func)
            if isinstance(base_t, ClassInfo):
                return base_t.resolve_method(f.attr)
            return None
        return None

    # -- iteration -------------------------------------------------------------

    def functions(self) -> Iterator[FuncInfo]:
        for mod in self.modules.values():
            yield from mod.functions.values()
            for cls in mod.classes.values():
                yield from cls.methods.values()
