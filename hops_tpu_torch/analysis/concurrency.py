"""Global lock-acquisition graph and blocking-call summaries.
(counterpart of ``hops_tpu/analysis/concurrency.py``)

Built on :mod:`.project`, this module computes, once per lint run:

- **Lock identities.** A class-attribute lock is
  ``<declaring file>:<Class>.<attr>`` (declaring class, so subclasses
  share the base's lock identity); a module-level lock is
  ``<file>:<name>``. Locks without a stable global identity (locals,
  unannotated parameters) still count as "a lock is held" for
  blocking-under-lock but never enter the order graph.
- **Per-function summaries** via fixpoint over the call graph:
  ``acquires[f]`` — locks ``f`` takes directly or transitively, and
  ``blocks[f]`` — blocking operations ``f`` can reach, each with a
  witness chain of ``file:line`` steps. A ``cv.wait()`` records the
  condition's own lock as *waived*: waiting releases that lock, so
  holding it across the wait is the sanctioned consumer shape.
- **The lock graph.** While lock A is held (lexically ``with A:`` or a
  ``# guarded by: A`` annotation on the ``def`` line), any lock B
  acquired — directly or through a resolved call — adds edge A→B.
  Cycles are lock-order inversions.
- **Selector-loop reachability.** A class owning a
  ``selectors.DefaultSelector()`` attribute defines an event loop; the
  method calling ``.select()`` on it is the loop root. Everything
  reachable from the root runs on the IO thread and must never block —
  worker-thread handoff (``Thread(target=...)``/queue+notify) is
  invisible to the call graph, which is exactly the sanctioned escape.

Everything here under-approximates: unresolved calls and unknown
receivers contribute nothing, so a missed edge can only hide a finding.
The blocking-operation list is the small closed set the serving stack
actually uses (``HTTPPool``, ``urlopen``/sockets, ``subprocess``,
``time.sleep``, ``with_deadline``, kvstore FFI, ``fsync``, cv/event
waits, ``Thread.join``); everything else (``faultinject.fire`` →
``time.sleep``, ...) is derived transitively.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator

from hops_tpu_torch.analysis.engine import Context, call_name, dotted_name
from hops_tpu_torch.analysis.model import ParsedFile
from hops_tpu_torch.analysis.project import (
    LOCK_TAGS,
    ClassInfo,
    FuncInfo,
    ProjectIndex,
    TypeRef,
)

#: Project functions that ARE blocking primitives: their internals use
#: untyped stdlib objects the inference cannot follow, so name them
#: here instead of relying on derivation. Keyed (module basename,
#: qualname).
PROJECT_BLOCKING: dict[tuple[str, str], str] = {
    ("httpclient", "HTTPPool.request"): "HTTPPool.request (network I/O)",
    ("httpclient", "HTTPPool.pipeline"): "HTTPPool.pipeline (network I/O)",
    ("httpclient", "HTTPPool.get_many"): "HTTPPool.get_many (network I/O)",
    ("resilience", "with_deadline"): "with_deadline (bounded worker wait)",
}

ChainStep = tuple[str, int, str]  # (relpath, line, description)


def _fmt_chain(chain: list[ChainStep]) -> str:
    return "\n".join(f"{p}:{ln}  {txt}" for p, ln, txt in chain)


@dataclasses.dataclass(frozen=True)
class LockRef:
    """One lock as held/acquired at a program point."""

    id: str  # stable id, or a per-function id when not global
    kind: str  # lock/rlock/cond/sem
    global_: bool  # participates in the order graph
    step: ChainStep  # where it was acquired (or the guarded def line)


@dataclasses.dataclass(frozen=True)
class BlockOp:
    label: str
    waived: str | None = None  # lock id released by the wait itself


@dataclasses.dataclass(frozen=True)
class Obs:
    """One observation from the lexical walk of a function body."""

    kind: str  # "acquire" | "call" | "block"
    held: tuple[LockRef, ...]
    step: ChainStep
    lock: LockRef | None = None
    callee: FuncInfo | None = None
    block: BlockOp | None = None


@dataclasses.dataclass
class LoopStall:
    root: FuncInfo
    func: FuncInfo
    block: BlockOp
    step: ChainStep
    chain: list[ChainStep]


@dataclasses.dataclass
class HeldBlock:
    func: FuncInfo
    lock: LockRef
    block: BlockOp
    step: ChainStep
    chain: list[ChainStep]


@dataclasses.dataclass
class Inversion:
    a: str
    b: str
    chain_ab: list[ChainStep]
    chain_ba: list[ChainStep]
    func_ab: str  # qualnames owning each direction
    func_ba: str


class ConcurrencyModel:
    """All concurrency facts for one lint run."""

    def __init__(self, project: ProjectIndex):
        self.project = project
        self.obs: dict[FuncInfo, list[Obs]] = {}
        #: transitively acquired global locks: f -> lock id -> (kind, chain)
        self.acquires: dict[FuncInfo, dict[str, tuple[str, list[ChainStep]]]] = {}
        #: transitively reachable blocking ops: f -> BlockOp -> chain
        self.blocks: dict[FuncInfo, dict[BlockOp, list[ChainStep]]] = {}
        self.calls: dict[FuncInfo, list[tuple[FuncInfo, ChainStep]]] = {}
        #: lock graph: (a, b) -> (chain, qualname of the acquiring function)
        self.edges: dict[tuple[str, str], tuple[list[ChainStep], str]] = {}
        self.lock_kinds: dict[str, str] = {}
        self._anon = 0
        for func in project.functions():
            self.obs[func] = self._scan(func)
        self._fixpoint()
        self._build_edges()

    # -- lexical scan ----------------------------------------------------------

    def _scan(self, func: FuncInfo) -> list[Obs]:
        env = self.project.local_env(func)
        out: list[Obs] = []
        held: list[LockRef] = list(self._entry_holds(func, env))

        def step(node: ast.AST, text: str) -> ChainStep:
            return (func.module.relpath, getattr(node, "lineno", 1), text)

        def classify(call: ast.Call) -> None:
            block = self._blocking(call, func, env)
            if block is not None:
                out.append(
                    Obs(
                        kind="block",
                        held=tuple(held),
                        step=step(call, f"blocking {block.label}"),
                        block=block,
                    )
                )
                return
            callee = self.project.resolve_call(call, func, env)
            if callee is None:
                return
            label = PROJECT_BLOCKING.get(
                (callee.module.modname.split(".")[-1], callee.qualname)
            )
            if label is not None:
                out.append(
                    Obs(
                        kind="block",
                        held=tuple(held),
                        step=step(call, f"blocking {label}"),
                        block=BlockOp(label),
                    )
                )
                return
            out.append(
                Obs(
                    kind="call",
                    held=tuple(held),
                    step=step(call, f"calls {dotted_name(call.func) or callee.name}()"),
                    callee=callee,
                )
            )

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return  # nested scope: analyzed separately, closures unmodeled
            if isinstance(node, (ast.With, ast.AsyncWith)):
                added = 0
                for item in node.items:
                    lk = self._lock_from_expr(
                        item.context_expr, func, env,
                        step(item.context_expr,
                             f"with {dotted_name(item.context_expr) or 'lock'}"),
                    )
                    if lk is not None:
                        out.append(
                            Obs(kind="acquire", held=tuple(held), step=lk.step, lock=lk)
                        )
                        held.append(lk)
                        added += 1
                    else:
                        visit(item.context_expr)
                for stmt in node.body:
                    visit(stmt)
                for _ in range(added):
                    held.pop()
                return
            if isinstance(node, ast.Call):
                classify(node)
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in func.node.body:
            visit(stmt)
        return out

    def _entry_holds(
        self, func: FuncInfo, env: dict[str, TypeRef]
    ) -> Iterator[LockRef]:
        """``# guarded by:`` on the ``def`` line = caller holds the lock
        for the whole body (the lock-discipline helper shape)."""
        pf = func.module.pf
        node = func.node
        first = node.body[0].lineno if node.body else node.lineno
        for line, expr in pf.guard_comments.items():
            if not (node.lineno <= line < max(first, node.lineno + 1)):
                continue
            try:
                parsed = ast.parse(expr.strip(), mode="eval").body
            except SyntaxError:
                continue
            lk = self._lock_from_expr(
                parsed, func, env,
                (pf.relpath, node.lineno, f"def {func.qualname} (guarded by: {expr})"),
            )
            if lk is not None:
                yield lk

    # -- lock identity ---------------------------------------------------------

    def _lock_from_expr(
        self,
        expr: ast.AST,
        func: FuncInfo,
        env: dict[str, TypeRef],
        step: ChainStep,
    ) -> LockRef | None:
        mod = func.module
        if isinstance(expr, ast.Name):
            kind = mod.module_locks.get(expr.id)
            if kind is not None:
                lock_id = f"{mod.relpath}:{expr.id}"
                self.lock_kinds[lock_id] = kind
                return LockRef(lock_id, kind, True, step)
            t = env.get(expr.id)
            if isinstance(t, str) and t in LOCK_TAGS:
                # A lock passed in or created locally: held, but no
                # stable cross-function identity.
                self._anon += 1
                return LockRef(f"{func.key}:<{expr.id}#{self._anon}>", t, False, step)
            return None
        if isinstance(expr, ast.Attribute):
            base_t = self.project.infer_expr_type(expr.value, env, func)
            if isinstance(base_t, ClassInfo):
                decl = base_t.lock_decl(expr.attr)
                if decl is not None:
                    owner, kind = decl
                    lock_id = f"{owner.key}.{expr.attr}"
                    self.lock_kinds[lock_id] = kind
                    return LockRef(lock_id, kind, True, step)
        return None

    # -- blocking primitives ---------------------------------------------------

    def _blocking(
        self, call: ast.Call, func: FuncInfo, env: dict[str, TypeRef]
    ) -> BlockOp | None:
        f = call.func
        dotted = dotted_name(f)
        last = call_name(f)
        mod = func.module
        head = dotted.split(".")[0] if dotted else ""

        def module_is(name: str) -> bool:
            if mod.imports.get(head) == name:
                return True
            src = mod.from_imports.get(last)
            return src is not None and src[0] == name and src[1] == last

        if last == "sleep" and (dotted == "time.sleep" or module_is("time")):
            return BlockOp("time.sleep")
        if last == "urlopen":
            return BlockOp("urlopen (network I/O)")
        if last == "create_connection" and (module_is("socket") or head == "socket"):
            return BlockOp("socket.create_connection")
        if last in ("run", "call", "check_call", "check_output", "Popen") and (
            module_is("subprocess") or head == "subprocess"
        ):
            return BlockOp(f"subprocess.{last}")
        if last == "communicate":
            return BlockOp("Popen.communicate")
        if last == "fsync" and (module_is("os") or head == "os"):
            return BlockOp("os.fsync")
        if last.startswith("kv_") and "._lib." in f"{dotted}.":
            return BlockOp(f"kvstore FFI {last}")
        if isinstance(f, ast.Attribute):
            recv = self.project.infer_expr_type(f.value, env, func)
            if last in ("wait", "wait_for"):
                if recv == "cond":
                    cv = self._lock_from_expr(f.value, func, env, ("", 0, ""))
                    return BlockOp(
                        "Condition.wait", waived=cv.id if cv is not None else None
                    )
                if recv == "event":
                    return BlockOp("Event.wait")
                if recv == "popen":
                    return BlockOp("Popen.wait")
            if last == "join" and recv == "thread":
                return BlockOp("Thread.join")
            if last == "sendall":
                return BlockOp("socket.sendall")
        return None

    # -- fixpoint propagation --------------------------------------------------

    def _fixpoint(self) -> None:
        for func, obs in self.obs.items():
            acq: dict[str, tuple[str, list[ChainStep]]] = {}
            blk: dict[BlockOp, list[ChainStep]] = {}
            calls: list[tuple[FuncInfo, ChainStep]] = []
            for o in obs:
                if o.kind == "acquire" and o.lock is not None and o.lock.global_:
                    acq.setdefault(o.lock.id, (o.lock.kind, [o.step]))
                elif o.kind == "block" and o.block is not None:
                    blk.setdefault(o.block, [o.step])
                elif o.kind == "call" and o.callee is not None:
                    calls.append((o.callee, o.step))
            self.acquires[func] = acq
            self.blocks[func] = blk
            self.calls[func] = calls
        changed = True
        while changed:
            changed = False
            for func in self.obs:
                acq = self.acquires[func]
                blk = self.blocks[func]
                for callee, step in self.calls[func]:
                    if callee not in self.acquires:
                        continue
                    for lock_id, (kind, chain) in self.acquires[callee].items():
                        if lock_id not in acq:
                            acq[lock_id] = (kind, [step] + chain)
                            changed = True
                    for op, chain in self.blocks[callee].items():
                        if op not in blk:
                            blk[op] = [step] + chain
                            changed = True

    # -- the lock graph --------------------------------------------------------

    def _build_edges(self) -> None:
        for func, obs in self.obs.items():
            for o in obs:
                held_global = [h for h in o.held if h.global_]
                if o.kind == "acquire" and o.lock is not None and o.lock.global_:
                    for h in held_global:
                        self._edge(h.id, o.lock.id, [h.step, o.step], func.qualname)
                elif o.kind == "call" and o.callee is not None and held_global:
                    for lock_id, (kind, chain) in self.acquires.get(
                        o.callee, {}
                    ).items():
                        for h in held_global:
                            self._edge(
                                h.id, lock_id, [h.step, o.step] + chain, func.qualname
                            )

    def _edge(
        self, a: str, b: str, chain: list[ChainStep], qualname: str
    ) -> None:
        if a == b:
            return  # re-entry: RLock by design, plain-Lock self-deadlock
            # is a different (single-lock) defect than an order inversion
        key = (a, b)
        if key not in self.edges or len(chain) < len(self.edges[key][0]):
            self.edges[key] = (chain, qualname)

    # -- rule surfaces ---------------------------------------------------------

    def inversions(self) -> list[Inversion]:
        """Cycles in the lock graph. Two-lock cycles (the classic AB/BA
        inversion) are reported pairwise; longer cycles fall out as
        chains of pairwise reports once any two members invert, and any
        remaining pure N-cycle is reported on its lexicographically
        first edge."""
        out: list[Inversion] = []
        seen: set[tuple[str, str]] = set()
        for (a, b), (chain_ab, fn_ab) in sorted(self.edges.items()):
            if (b, a) not in self.edges or (b, a) in seen:
                continue
            seen.add((a, b))
            chain_ba, fn_ba = self.edges[(b, a)]
            out.append(Inversion(a, b, chain_ab, chain_ba, fn_ab, fn_ba))
        covered = {n for inv in out for n in (inv.a, inv.b)}
        for cycle in self._simple_cycles():
            if len(cycle) < 3 or any(n in covered for n in cycle):
                continue  # 2-cycles already reported pairwise above
            covered.update(cycle)
            a, b = cycle[0], cycle[1]
            chain_ab, fn_ab = self.edges[(a, b)]
            back: list[ChainStep] = []
            for x, y in zip(cycle[1:], cycle[2:] + [a]):
                back.extend(self.edges[(x, y)][0])
            out.append(
                Inversion(a, b, chain_ab, back, fn_ab, self.edges[(b, cycle[2])][1])
            )
        return out

    def _simple_cycles(self) -> list[list[str]]:
        adj: dict[str, list[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        sccs: list[list[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            for w in adj.get(v, ()):
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))
        for v in sorted(adj):
            if v not in index:
                strongconnect(v)
        cycles: list[list[str]] = []
        for comp in sccs:
            members = set(comp)
            start = comp[0]
            path = [start]
            seen_nodes = {start}
            node = start
            while True:  # walk any in-SCC successor until we loop
                nxt = next(
                    (w for w in sorted(adj.get(node, ())) if w in members), None
                )
                if nxt is None:
                    break
                if nxt == start:
                    cycles.append(path)
                    break
                if nxt in seen_nodes:
                    cycles.append(path[path.index(nxt):])
                    break
                path.append(nxt)
                seen_nodes.add(nxt)
                node = nxt
        return [c for c in cycles if len(c) > 1]

    def held_blocks(self) -> list[HeldBlock]:
        """Blocking ops reached while a lock is held, one report per
        (function, lock, op label)."""
        out: list[HeldBlock] = []
        seen: set[tuple[str, str, str]] = set()
        for func, obs in self.obs.items():
            for o in obs:
                if not o.held:
                    continue
                if o.kind == "block" and o.block is not None:
                    candidates = [(o.block, [o.step])]
                elif o.kind == "call" and o.callee is not None:
                    candidates = [
                        (op, [o.step] + chain)
                        for op, chain in self.blocks.get(o.callee, {}).items()
                    ]
                else:
                    continue
                for op, chain in candidates:
                    for h in o.held:
                        if op.waived is not None and op.waived == h.id:
                            continue
                        key = (func.key, h.id, op.label)
                        if key in seen:
                            continue
                        seen.add(key)
                        out.append(HeldBlock(func, h, op, o.step, [h.step] + chain))
        return out

    # -- selector-loop reachability -------------------------------------------

    def loop_roots(self) -> list[FuncInfo]:
        roots: list[FuncInfo] = []
        for mod in self.project.modules.values():
            for cls in mod.classes.values():
                sel_attrs = {
                    a for a, t in cls.attr_types.items() if t == "selector"
                }
                if not sel_attrs:
                    continue
                for meth in cls.methods.values():
                    env = self.project.local_env(meth)
                    for node in ast.walk(meth.node):
                        if (
                            isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr == "select"
                            and self.project.infer_expr_type(
                                node.func.value, env, meth
                            )
                            == "selector"
                        ):
                            roots.append(meth)
                            break
        return roots

    def loop_stalls(self) -> list[LoopStall]:
        out: list[LoopStall] = []
        seen: set[tuple[str, str, str]] = set()
        for root in self.loop_roots():
            # BFS with parent pointers for the witness chain.
            parent: dict[FuncInfo, tuple[FuncInfo, ChainStep] | None] = {root: None}
            queue = [root]
            while queue:
                func = queue.pop(0)
                for callee, step in self.calls.get(func, ()):
                    if callee not in parent:
                        parent[callee] = (func, step)
                        queue.append(callee)
            for func in parent:
                for o in self.obs.get(func, ()):
                    if o.kind != "block" or o.block is None:
                        continue
                    key = (root.key, func.key, o.block.label)
                    if key in seen:
                        continue
                    seen.add(key)
                    chain: list[ChainStep] = [o.step]
                    node = func
                    while parent[node] is not None:
                        node, step = parent[node]  # type: ignore[misc]
                        chain.insert(0, step)
                    chain.insert(
                        0,
                        (
                            root.module.relpath,
                            root.node.lineno,
                            f"selector loop root {root.qualname}",
                        ),
                    )
                    out.append(LoopStall(root, func, o.block, o.step, chain))
        return out

    # -- --graph lock dumps ----------------------------------------------------

    def graph_dict(self) -> dict:
        return {
            "locks": [
                {"id": lock_id, "kind": kind}
                for lock_id, kind in sorted(self.lock_kinds.items())
            ],
            "edges": [
                {
                    "from": a,
                    "to": b,
                    "function": qualname,
                    "chain": [
                        {"path": p, "line": ln, "step": txt} for p, ln, txt in chain
                    ],
                }
                for (a, b), (chain, qualname) in sorted(self.edges.items())
            ],
        }

    def graph_dot(self) -> str:
        lines = ["digraph lock_order {"]
        for lock_id, kind in sorted(self.lock_kinds.items()):
            lines.append(f'  "{lock_id}" [label="{lock_id}\\n({kind})"];')
        for (a, b), (chain, qualname) in sorted(self.edges.items()):
            p, ln, _ = chain[-1]
            lines.append(f'  "{a}" -> "{b}" [label="{qualname} {p}:{ln}"];')
        lines.append("}")
        return "\n".join(lines)


def get_model(files: list[ParsedFile], ctx: Context) -> ConcurrencyModel:
    """The per-run memoized model (three rules share one computation)."""
    cached = ctx.cache.get("concurrency")
    if cached is None:
        cached = ConcurrencyModel(ProjectIndex(files))
        ctx.cache["concurrency"] = cached
    return cached
