"""jit-purity: Python side effects reachable inside traced functions.
(counterpart of ``hops_tpu/analysis/rules/jit_purity.py``)

``jax.jit``/``shard_map`` trace a function ONCE and replay the captured
XLA program; Python-level side effects inside the traced body run at
trace time only (or once per recompile) — so a ``print`` shows stale
values, ``time.time()`` freezes the timestamp of the first trace,
stdlib ``random`` draws one constant, a telemetry ``.inc()`` counts
compilations instead of steps, and a ``global`` write mutates host
state on a schedule nobody can predict. A silent fp32->bf16 param
downcast lived exactly here: a traced step quietly doing host-visible
work nobody could see in pytest.

A function is considered traced when it is:

- decorated with ``jit``/``jax.jit``/``pjit``/``shard_map`` (bare,
  called, or via ``functools.partial``),
- passed as the first argument to a ``jit(...)``/``shard_map(...)``
  call or a ``<strategy>.step(...)`` call, or
- defined inside (and thus returned by) a ``make_*step*`` factory —
  the ``make_train_step`` convention this repo compiles via
  ``Strategy.step``.

``jax.debug.print`` / ``jax.debug.callback`` / ``io_callback`` are the
sanctioned escape hatches and are not flagged.

The torch forms. ``torch.compile`` traces a function into graphs whose
replay skips its Python, and a CUDA graph replays the kernels its
capture recorded, so host effects there run once (or once per
recompile) as well — a ``LAUNCHES`` count or a metric does not tick on
replay, a ``flight.record`` logs the capture instead of the step. A
function counts as traced, beside the JAX forms above, when it is:

- decorated with ``torch.compile`` (bare, called, or via
  ``functools.partial``);
- passed as the first argument to ``torch.compile(...)`` or
  ``torch.cuda.make_graphed_callables(...)``;

and the body of a ``with torch.cuda.graph(...)`` block counts as traced
too (every call in it runs once, at capture). The same host effects
are flagged there, plus ``<flight>.record(...)`` (the flight recorder's
events) in every traced body.
"""

from __future__ import annotations

import ast
import re

from hops_tpu_torch.analysis.engine import (
    Context,
    Rule,
    call_name,
    dotted_name,
    register,
)
from hops_tpu_torch.analysis.model import Finding, ParsedFile

_JIT_NAMES = {"jit", "pjit", "shard_map"}
#: Torch calls whose first argument is traced or captured.
_TORCH_TRACE_NAMES = {"torch.compile", "torch.cuda.make_graphed_callables",
                      "cuda.make_graphed_callables", "make_graphed_callables"}
#: Context managers whose body runs once, at CUDA graph capture.
_CAPTURE_NAMES = {"torch.cuda.graph", "cuda.graph"}
_FACTORY_RE = re.compile(r"^make\w*step\w*$")
_METRIC_MUTATORS = {"inc", "dec", "observe", "set_to_current_time"}
_METRIC_RECEIVER_RE = re.compile(
    r"(^|\.)(_?m_\w+|REGISTRY|registry|\w*(metric|counter|gauge|histogram)\w*)",
    re.IGNORECASE,
)


def _is_at_indexer(node: ast.AST) -> bool:
    """``x.at[i]`` — the receiver of JAX's pure functional-update
    ``.set()``/``.add()``, which must never read as a metric mutation
    even on an array named ``metrics``."""
    return (
        isinstance(node, ast.Subscript)
        and isinstance(node.value, ast.Attribute)
        and node.value.attr == "at"
    )


def _is_torch_trace(node: ast.AST) -> bool:
    return dotted_name(node) in _TORCH_TRACE_NAMES


def _is_tracer(node: ast.AST) -> bool:
    return call_name(node) in _JIT_NAMES or _is_torch_trace(node)


def _wraps(node: ast.AST, match) -> bool:
    """``match`` holds for ``node`` as a decorator or call target: bare,
    called, or via ``functools.partial``."""
    if match(node):
        return True
    if isinstance(node, ast.Call):
        if match(node.func):
            return True
        if call_name(node.func) == "partial" and node.args:
            return _wraps(node.args[0], match)
    return False


def _is_jit_expr(node: ast.AST) -> bool:
    """``jit`` / ``jax.jit`` / ``pjit`` / ``shard_map`` /
    ``torch.compile`` / ``make_graphed_callables`` (possibly via
    ``partial(jax.jit, ...)``), as a decorator or call target."""
    return _wraps(node, _is_tracer)


def _torch_traced(node: ast.AST) -> bool:
    """Is this decorator or call target a torch form (its findings
    then speak of compile/capture, not of XLA tracing)?"""
    return _wraps(node, _is_torch_trace)


def _capture_blocks(tree: ast.Module) -> list[ast.With]:
    """``with torch.cuda.graph(...)`` blocks: their bodies run once, at
    capture."""
    return [
        node for node in ast.walk(tree)
        if isinstance(node, (ast.With, ast.AsyncWith))
        and any(
            isinstance(item.context_expr, ast.Call)
            and dotted_name(item.context_expr.func) in _CAPTURE_NAMES
            for item in node.items
        )
    ]


def _collect_traced(tree: ast.Module) -> list[tuple[ast.FunctionDef, bool]]:
    """Function defs whose bodies will be traced, each with whether a
    torch form (``torch.compile``, ``make_graphed_callables``) traces
    it."""
    by_name: dict[str, list[ast.FunctionDef]] = {}
    traced: dict[int, ast.FunctionDef] = {}
    torch_ids: set[int] = set()

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)
            if any(_is_jit_expr(d) for d in node.decorator_list):
                traced[id(node)] = node
                if any(_torch_traced(d) for d in node.decorator_list):
                    torch_ids.add(id(node))
            if _FACTORY_RE.match(node.name):
                # Only the def(s) the factory RETURNS are traced; other
                # inner helpers run at factory (plain Python) time.
                returned = {
                    r.value.id
                    for r in ast.walk(node)
                    if isinstance(r, ast.Return) and isinstance(r.value, ast.Name)
                }
                for child in ast.walk(node):
                    if (
                        isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and child is not node
                        and child.name in returned
                    ):
                        traced[id(child)] = child

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        target: ast.AST | None = None
        if _is_jit_expr(node.func) and not isinstance(node.func, ast.Call):
            target = node.args[0] if node.args else None
        elif isinstance(node.func, ast.Attribute) and node.func.attr == "step":
            # <strategy>.step(fn, ...) compiles fn; only count plain
            # Name args that resolve to a local def (engine.step() and
            # friends take no function argument).
            target = node.args[0] if node.args else None
        if isinstance(target, ast.Name):
            for fn in by_name.get(target.id, ()):
                traced[id(fn)] = fn
                if _torch_traced(node.func):
                    torch_ids.add(id(fn))
        elif isinstance(target, (ast.FunctionDef, ast.Lambda)):
            pass  # lambdas have no statements worth flagging
    return [(fn, id(fn) in torch_ids) for fn in traced.values()]


@register
class JitPurityRule(Rule):
    name = "jit-purity"
    description = (
        "Python side effects (print, time.*, stdlib random, telemetry "
        "mutation, flight records, global writes) inside jit/shard_map/"
        "torch.compile-traced functions and CUDA graph captures"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        # Only treat `time.*`/`random.*` as the stdlib modules when the
        # file actually imports them bare — otherwise `time` may be an
        # array argument (timestep code) and `random` a jax.random alias.
        std_imports = {
            a.name
            for n in ast.walk(pf.tree)
            if isinstance(n, ast.Import)
            for a in n.names
            if a.asname is None
        }
        regions: list[tuple[str, bool, list[ast.AST]]] = [
            (f"traced function `{fn.name}`", is_torch, [fn])
            for fn, is_torch in _collect_traced(pf.tree)
        ] + [
            ("a `torch.cuda.graph` capture block", True, w.body)
            for w in _capture_blocks(pf.tree)
        ]
        findings: list[Finding] = []
        seen: set[tuple[int, int]] = set()
        for where, is_torch, roots in regions:
            for node in (n for r in roots for n in ast.walk(r)):
                check = self._check_torch if is_torch else self._check_node
                f = check(pf, where, node, std_imports)
                if f is not None and (f.line, f.col) not in seen:
                    seen.add((f.line, f.col))
                    findings.append(f)
        return findings

    def _check_torch(
        self,
        pf: ParsedFile,
        where: str,
        node: ast.AST,
        std_imports: set[str],
    ) -> Finding | None:
        """The torch forms: the same host effects, said in terms of a
        compiled graph's or a captured CUDA graph's replay."""
        effect = _host_effect(node, std_imports)
        if effect is None:
            return None
        kind, text = effect
        fix = {
            "global": "return the value instead",
            "print": "print outside the compiled or captured region",
            "time": "take timestamps outside it",
            "random": "draw on the host outside it, or use a torch.Generator",
            "metric": "update metrics outside it",
            "flight": "record outside it",
        }[kind]
        return pf.finding(
            self.name,
            node,
            f"{text} inside {where} runs once, at compile or capture time, "
            f"not on each replay; {fix}",
        )

    def _check_node(
        self,
        pf: ParsedFile,
        where: str,
        node: ast.AST,
        std_imports: set[str],
    ) -> Finding | None:
        """The JAX forms' findings, worded for XLA tracing."""
        effect = _host_effect(node, std_imports)
        if effect is None:
            return None
        kind, text = effect
        message = {
            "global": f"{text} write inside {where} mutates host state at "
                      "trace time only; return the value or use "
                      "jax.debug.callback",
            "print": f"{text} inside {where} runs at trace time only; use "
                     "jax.debug.print for runtime values",
            "time": f"{text} inside {where} freezes the clock at trace time; "
                    "take timestamps outside the step",
            "random": f"stdlib {text} inside {where} draws ONE value at trace "
                      "time; thread a jax.random key instead",
            "metric": f"telemetry mutation {text} inside {where} counts "
                      "trace-time compilations, not steps; update metrics "
                      "outside the traced body",
            "flight": f"{text} inside {where} records at trace time only; "
                      "record outside the traced body",
        }[kind]
        return pf.finding(self.name, node, message)


def _metric_receiver(node: ast.AST) -> bool:
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on exprs
        return False
    return bool(_METRIC_RECEIVER_RE.search(text))


def _host_effect(node: ast.AST, std_imports: set[str]) -> tuple[str, str] | None:
    """``(kind, quoted code)`` when ``node`` is a host effect: a
    ``global`` write, ``print``, stdlib ``time.*``/``random.*`` (when the
    file imports them bare — otherwise ``time`` may be an array argument
    and ``random`` a jax.random alias), a telemetry mutation, or a
    flight-recorder ``record``."""
    if isinstance(node, ast.Global):
        return "global", f"`global {', '.join(node.names)}`"
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    if isinstance(func, ast.Name) and func.id == "print":
        return "print", "`print`"
    dn = dotted_name(func)
    if "time" in std_imports and dn.startswith("time."):
        return "time", f"`{dn}`"
    if "random" in std_imports and dn.startswith("random."):
        return "random", f"`{dn}`"
    if not isinstance(func, ast.Attribute):
        return None
    if (
        (func.attr in _METRIC_MUTATORS or func.attr == "set")
        and not _is_at_indexer(func.value)
        and _metric_receiver(func.value)
    ):
        return "metric", f"`{ast.unparse(func.value)}.{func.attr}(...)`"
    if func.attr == "record" and ast.unparse(func.value).lower().endswith("flight"):
        return "flight", f"`{ast.unparse(func)}(...)`"
    return None
