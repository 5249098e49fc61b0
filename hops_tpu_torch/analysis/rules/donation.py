"""use-after-donation: reading a buffer after handing it to XLA.
(counterpart of ``hops_tpu/analysis/rules/donation.py``)

``donate_argnums`` (and ``Strategy.step``'s default
``donate_state=True``) tells XLA it may overwrite the argument's buffer
in place — the standard trick that halves train-state memory. The
Python name still points at the donated array, and touching it again
raises at best (``Array has been deleted``) and at worst silently reads
repurposed memory on backends that don't track deletion. The correct
pattern rebinds in the same statement (``state, m = step(state, b)``);
everything else is a latent crash that only fires on a real device,
never under pytest on CPU.

Detected shapes, per function (or module) scope:

- ``g = jax.jit(f, donate_argnums=(0,)); g(x); ... x ...`` — ``x``
  read after the donating call without an intervening rebind;
- the same with the jitted callable invoked inline;
- ``step = strategy.step(fn)`` (donation on by default) called inside
  a ``for``/``while`` loop without rebinding the donated argument —
  iteration 2 passes a dead buffer.

The torch form: the port's train steps donate nothing — they update the
state in place — so the trap is the reverse one. A state handed to
another owner (``<queue>.put``/``put_nowait``, ``<executor>.submit``,
``threading.Thread(args=...)`` or ``target=functools.partial(...)``),
whole or by a path rooted at it, and then passed to a step-shaped call
(named like a step, or handed a step function:
``run_preemptible(train_step, state, ...)``) changes under the other
owner while it reads. Flagged, in one scope or around one loop: the
handoff followed by such a step with the same name, unless the name is
rebound in between. A handoff of a copy (``snapshot_state(state)``,
``copy.deepcopy(state)``, ``state.clone()`` — any call) is not the
state, and a handoff after the last step has no step to race.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from hops_tpu_torch.analysis.engine import (
    Context,
    Rule,
    call_name,
    dotted_name,
    register,
    root_name,
)
from hops_tpu_torch.analysis.model import Finding, ParsedFile

#: The step shape of ``host-sync-in-loop``.
_STEP_NAME_RE = re.compile(r"(^|_)step(_|$)|^stepped$")
#: A step FUNCTION handed to a runner (``train_step``, ``step_fn``); a
#: bare ``step`` argument is as often the step number.
_STEP_FN_RE = re.compile(r"^\w+_step$|^(\w+_)?step_fn$")
#: Methods that hand their arguments to another owner's thread.
_HANDOFF_METHODS = {"put", "put_nowait", "submit"}


def _pos(node: ast.AST) -> tuple[int, int]:
    return (node.lineno, node.col_offset)


def _end_pos(node: ast.AST) -> tuple[int, int]:
    return (
        getattr(node, "end_lineno", node.lineno),
        getattr(node, "end_col_offset", node.col_offset),
    )


def _donated_positions(call: ast.Call) -> tuple[int, ...] | None:
    """Donated argument indices if ``call`` builds a donating callable."""
    name = call_name(call.func)
    if name in ("jit", "pjit"):
        for kw in call.keywords:
            if kw.arg == "donate_argnums":
                v = kw.value
                if isinstance(v, ast.Constant) and isinstance(v.value, int):
                    return (v.value,)
                if isinstance(v, (ast.Tuple, ast.List)):
                    out = []
                    for e in v.elts:
                        if isinstance(e, ast.Constant) and isinstance(e.value, int):
                            out.append(e.value)
                        else:
                            return None
                    return tuple(out)
                return None
        return None
    if (
        isinstance(call.func, ast.Attribute)
        and name == "step"
        and call.args
        and isinstance(call.args[0], ast.Name)
    ):
        # Strategy.step(fn): donate_state defaults to True.
        for kw in call.keywords:
            if kw.arg == "donate_state" and isinstance(kw.value, ast.Constant):
                if not kw.value.value:
                    return None
        return (0,)
    return None


def _scope_walk(scope: ast.AST) -> Iterator[ast.AST]:
    """Walk a scope without descending into nested function/class defs."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        if hasattr(node, "lineno"):
            yield node
        if not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
        ):
            stack.extend(ast.iter_child_nodes(node))


@register
class UseAfterDonationRule(Rule):
    name = "use-after-donation"
    description = (
        "an argument read after being passed through donate_argnums/"
        "donate_state — the buffer belongs to XLA now; or a state handed "
        "to another thread and then updated in place by a step"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        findings: list[Finding] = []
        scopes: list[ast.AST] = [pf.tree] + [
            n
            for n in ast.walk(pf.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for scope in scopes:
            findings.extend(self._check_scope(pf, scope))
        return findings

    def _check_scope(self, pf: ParsedFile, scope: ast.AST) -> list[Finding]:
        nodes = list(_scope_walk(scope))
        # The whole-file map works scope-bounded too: every ancestor
        # walk below terminates at `scope` explicitly.
        parents = pf.parents()

        donors: dict[str, tuple[int, ...]] = {}
        donation_calls: list[tuple[ast.Call, tuple[int, ...]]] = []
        for n in sorted(
            (x for x in nodes if isinstance(x, (ast.Assign, ast.Call))),
            key=_pos,
        ):
            if isinstance(n, ast.Assign):
                donated = (
                    _donated_positions(n.value)
                    if isinstance(n.value, ast.Call)
                    else None  # rebound to a non-call: no longer a donor
                )
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        if donated is not None:
                            donors[t.id] = donated
                        else:
                            donors.pop(t.id, None)
            elif isinstance(n, ast.Call):
                if isinstance(n.func, ast.Name) and n.func.id in donors:
                    donation_calls.append((n, donors[n.func.id]))
                elif isinstance(n.func, ast.Call):
                    donated = _donated_positions(n.func)
                    if donated is not None:
                        donation_calls.append((n, donated))

        findings: list[Finding] = []
        for call, positions in donation_calls:
            for i in positions:
                if i < len(call.args) and isinstance(call.args[i], ast.Name):
                    findings.extend(
                        self._check_donated_name(
                            pf, scope, nodes, parents, call, call.args[i].id
                        )
                    )
        findings.extend(self._check_handoffs(pf, scope, nodes, parents))
        return findings

    def _check_handoffs(
        self,
        pf: ParsedFile,
        scope: ast.AST,
        nodes: list[ast.AST],
        parents: dict[int, ast.AST],
    ) -> list[Finding]:
        """The torch form: a handoff, then an in-place step on the same
        name (see the module docstring)."""
        calls = sorted((n for n in nodes if isinstance(n, ast.Call)), key=_pos)
        steps = [(c, _step_args(c)) for c in calls if _is_step_shaped(c)]
        if not steps:
            return []
        stores: dict[str, list[ast.Name]] = {}
        for n in nodes:
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                stores.setdefault(n.id, []).append(n)
        findings: list[Finding] = []
        for hand in calls:
            handed = sorted({
                base.id
                for expr in _handed_exprs(hand)
                if isinstance(base := root_name(expr), ast.Name)
            })
            for var in handed:
                hit = next(
                    (
                        step for step, names in steps
                        if step is not hand and var in names
                        and self._races(scope, parents, stores.get(var, []), hand, step)
                    ),
                    None,
                )
                if hit is None:
                    continue
                findings.append(
                    pf.finding(
                        self.name,
                        hand,
                        f"`{var}` is handed to `{ast.unparse(hand.func)}` and "
                        f"then passed to `{ast.unparse(hit.func)}`, which "
                        "updates it in place while the other owner reads it; "
                        f"hand over a copy (`snapshot_state({var})`, "
                        "`.clone()`)",
                        detail=f"{pf.relpath}:{hand.lineno}: handoff\n"
                               f"{pf.relpath}:{hit.lineno}: in-place step",
                    )
                )
        return findings

    @staticmethod
    def _races(
        scope: ast.AST,
        parents: dict[int, ast.AST],
        var_stores: list[ast.Name],
        hand: ast.Call,
        step: ast.Call,
    ) -> bool:
        """Does ``step`` run on the handed object after ``hand``: later
        in the scope, or earlier in a loop around both (the next
        iteration), with no rebinding of the name on the way?"""
        step_stmt = _statement(step, parents)
        rebinds = [
            n for n in var_stores
            if not _within(n, step_stmt, parents)
        ]
        h_end, s_pos = _end_pos(hand), _pos(step)
        if s_pos > h_end:
            if _exclusive(hand, step, parents):
                return False
            return not any(h_end < _pos(n) < s_pos for n in rebinds)
        loop = _common_loop(hand, step, scope, parents)
        if loop is None:
            return False
        lo, hi = _pos(loop), _end_pos(loop)
        return not any(
            lo <= _pos(n) <= hi and (_pos(n) > h_end or _pos(n) < s_pos)
            for n in rebinds
        )

    def _check_donated_name(
        self,
        pf: ParsedFile,
        scope: ast.AST,
        nodes: list[ast.AST],
        parents: dict[int, ast.AST],
        call: ast.Call,
        var: str,
    ) -> list[Finding]:
        # Does the statement holding the call rebind the name (the
        # sanctioned `state, m = step(state, b)` shape)?
        anc = parents.get(id(call))
        rebinding_stmt = False
        loop: ast.For | ast.While | None = None
        while anc is not None and anc is not scope:
            if isinstance(anc, ast.Assign) and any(
                isinstance(t2, ast.Name) and t2.id == var or var in _store_names(t2)
                for t2 in anc.targets
            ):
                rebinding_stmt = True
            if isinstance(anc, (ast.For, ast.While)) and loop is None:
                loop = anc
            anc = parents.get(id(anc))

        if loop is not None:
            stored_in_loop = any(
                isinstance(n, ast.Name)
                and n.id == var
                and isinstance(n.ctx, ast.Store)
                for n in ast.walk(loop)
            )
            if not stored_in_loop:
                return [
                    pf.finding(
                        self.name,
                        call,
                        f"`{var}` is donated by `{ast.unparse(call.func)}` "
                        "inside a loop but never rebound there — iteration 2 "
                        "passes a deleted buffer; rebind it "
                        f"(`{var}, ... = ...`)",
                    )
                ]
            return []  # rebound somewhere in the loop: stream-carried

        if rebinding_stmt:
            return []
        end = _end_pos(call)
        later_stores = sorted(
            (
                _pos(n)
                for n in nodes
                if isinstance(n, ast.Name)
                and n.id == var
                and isinstance(n.ctx, ast.Store)
                and _pos(n) > end
            ),
        )
        horizon = later_stores[0] if later_stores else (1 << 30, 0)
        out = []
        for n in sorted(nodes, key=_pos):
            if (
                isinstance(n, ast.Name)
                and n.id == var
                and isinstance(n.ctx, ast.Load)
                and end < _pos(n) < horizon
            ):
                out.append(
                    pf.finding(
                        self.name,
                        n,
                        f"`{var}` read after being donated to "
                        f"`{ast.unparse(call.func)}` — the buffer belongs "
                        "to XLA; use the call's result instead",
                    )
                )
        return out


def _store_names(target: ast.AST) -> set[str]:
    return {
        n.id
        for n in ast.walk(target)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)
    }


def _is_step_shaped(call: ast.Call) -> bool:
    """A call named like a step, or one handed a step function."""
    if _STEP_NAME_RE.search(call_name(call.func)):
        return True
    return any(
        isinstance(a, ast.Name) and _STEP_FN_RE.match(a.id) for a in call.args
    )


def _step_args(call: ast.Call) -> set[str]:
    """Names a step-shaped call is passed (the state it updates in place)."""
    return {
        a.id
        for a in [*call.args, *(kw.value for kw in call.keywords)]
        if isinstance(a, ast.Name)
    }


def _handed_exprs(call: ast.Call) -> list[ast.expr]:
    """The expressions ``call`` hands to another owner's thread."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _HANDOFF_METHODS:
        return [*call.args, *(kw.value for kw in call.keywords)]
    if dotted_name(f) not in ("threading.Thread", "Thread"):
        return []
    out: list[ast.expr] = []
    for kw in call.keywords:
        v = kw.value
        if kw.arg == "args" and isinstance(v, (ast.Tuple, ast.List)):
            out.extend(v.elts)
        elif kw.arg == "kwargs" and isinstance(v, ast.Dict):
            out.extend(v.values)
        elif kw.arg == "target" and isinstance(v, ast.Call) \
                and call_name(v.func) == "partial":
            out.extend([*v.args[1:], *(k.value for k in v.keywords)])
    return out


def _statement(node: ast.AST, parents: dict[int, ast.AST]) -> ast.AST:
    """The statement that holds ``node``."""
    while not isinstance(node, ast.stmt) and id(node) in parents:
        node = parents[id(node)]
    return node


def _within(node: ast.AST, ancestor: ast.AST, parents: dict[int, ast.AST]) -> bool:
    while node is not None:
        if node is ancestor:
            return True
        node = parents.get(id(node))
    return False


def _exclusive(a: ast.AST, b: ast.AST, parents: dict[int, ast.AST]) -> bool:
    """Are ``a`` and ``b`` on the two branches of one ``if`` (so one
    pass through the scope runs at most one of them)?"""
    chain: dict[int, ast.AST] = {}
    child, node = a, parents.get(id(a))
    while node is not None:
        chain[id(node)] = child
        child, node = node, parents.get(id(node))
    child, node = b, parents.get(id(b))
    while node is not None and id(node) not in chain:
        child, node = node, parents.get(id(node))
    if not isinstance(node, ast.If):
        return False
    a_side, b_side = chain[id(node)], child
    return (a_side in node.body) != (b_side in node.body) \
        and node.test not in (a_side, b_side)


def _common_loop(
    a: ast.AST, b: ast.AST, scope: ast.AST, parents: dict[int, ast.AST]
) -> ast.For | ast.While | None:
    """The innermost ``for``/``while`` of ``scope`` around both nodes."""
    node = parents.get(id(a))
    while node is not None and node is not scope:
        if isinstance(node, (ast.For, ast.While)) and _within(b, node, parents):
            return node
        node = parents.get(id(node))
    return None
