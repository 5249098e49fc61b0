"""host-sync-in-loop: device->host synchronization inside step loops.
(counterpart of ``hops_tpu/analysis/rules/host_sync.py``)

JAX dispatch is asynchronous: the Python loop runs ahead of the TPU,
which is what keeps the device busy. ``.item()``, ``float(...)``,
``np.asarray(...)``, ``jax.device_get(...)`` and ``block_until_ready``
on a device value force the host to wait for the step to finish — one
per iteration turns the pipeline into lock-step and shows up as idle
accelerator (the exact stall the parallel input pipeline exists to
avoid). Pull values out every N steps, or log asynchronously.

A loop is a *step loop* when its body calls something step-shaped
(``step``, ``train_step``, ``step_fn``, ``stepped``...). Device values
are names bound from those calls (tuple-unpack aware) plus any
subscript/attribute path rooted at them. ``block_until_ready`` /
``jax.device_get`` are flagged on any argument inside a step loop —
their only purpose is synchronization.

The torch forms, with the same step-loop and step-value definitions:
CUDA kernels are queued just as asynchronously, and the same calls
stall them. ``.tolist()``, ``.cpu()``, ``.numpy()`` and ``.item()`` on
a step value, and ``float()``/``int()``/``bool()`` of one, copy it to
the host and wait for the step; ``torch.cuda.synchronize()``,
``<stream>.synchronize()`` and ``<event>.synchronize()`` (any
``.synchronize()`` call) are flagged anywhere in a step loop, as
``block_until_ready`` is. The engine's decode is bound by host dispatch:
one read-back per step is what decode horizons exist to remove.
"""

from __future__ import annotations

import ast
import re

from hops_tpu_torch.analysis.engine import (
    Context,
    Rule,
    assigned_names,
    call_name,
    dotted_name,
    register,
    root_name,
)
from hops_tpu_torch.analysis.model import Finding, ParsedFile

_STEP_NAME_RE = re.compile(r"(^|_)step(_|$)|^stepped$")

#: Tensor methods that copy a value to the host (and so wait for the
#: kernels that produce it).
_TORCH_READBACKS = ("tolist", "cpu", "numpy")


def _is_step_call(node: ast.Call) -> bool:
    return bool(_STEP_NAME_RE.search(call_name(node.func)))


@register
class HostSyncInLoopRule(Rule):
    name = "host-sync-in-loop"
    description = (
        ".item()/.tolist()/.cpu()/.numpy()/float()/np.asarray/"
        "jax.device_get/block_until_ready/torch.cuda.synchronize() on "
        "device values inside for/while step loops"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        findings: list[Finding] = []
        # Outermost step loops only: a nested loop's findings would
        # duplicate under both.
        claimed: set[int] = set()
        for node in ast.walk(pf.tree):
            if isinstance(node, (ast.For, ast.While)) and id(node) not in claimed:
                body = list(ast.walk(node))
                step_calls = [
                    n for n in body if isinstance(n, ast.Call) and _is_step_call(n)
                ]
                if not step_calls:
                    continue
                for inner in body:
                    if isinstance(inner, (ast.For, ast.While)) and inner is not node:
                        claimed.add(id(inner))
                findings.extend(self._check_loop(pf, node, step_calls))
        return findings

    def _check_loop(
        self, pf: ParsedFile, loop: ast.For | ast.While, step_calls: list[ast.Call]
    ) -> list[Finding]:
        step_ids = {id(c) for c in step_calls}
        device_names: set[str] = set()
        for n in ast.walk(loop):
            if isinstance(n, ast.Assign) and id(n.value) in step_ids:
                for t in n.targets:
                    device_names |= assigned_names(t)
            elif isinstance(n, ast.AnnAssign) and n.value is not None and id(n.value) in step_ids:
                device_names |= assigned_names(n.target)

        def is_device_value(expr: ast.AST) -> bool:
            # Method calls on a step value (``out["loss"].detach()``,
            # ``.float()``, ``.to(...)``) still hold a step value.
            while True:
                base = root_name(expr)
                if isinstance(base, ast.Name):
                    return base.id in device_names
                if not isinstance(base, ast.Call):
                    return False
                if _is_step_call(base):
                    return True
                if not isinstance(base.func, ast.Attribute):
                    return False
                expr = base.func.value

        findings: list[Finding] = []
        for n in ast.walk(loop):
            if not isinstance(n, ast.Call):
                continue
            fname = call_name(n.func)
            dn = dotted_name(n.func)
            if fname == "block_until_ready":
                what = (
                    f"`{ast.unparse(n)}`"
                    if len(ast.unparse(n)) < 60
                    else "`block_until_ready`"
                )
                findings.append(
                    pf.finding(
                        self.name,
                        n,
                        f"{what} inside a step loop stalls dispatch every "
                        "iteration; sync once after the loop",
                    )
                )
            elif fname == "synchronize":
                findings.append(
                    pf.finding(
                        self.name,
                        n,
                        f"`{ast.unparse(n.func)}()` inside a step loop waits "
                        "for every queued kernel each iteration; sync once "
                        "after the loop",
                    )
                )
            elif dn in ("jax.device_get", "device_get"):
                findings.append(
                    pf.finding(
                        self.name,
                        n,
                        f"`{dn}` inside a step loop forces a device->host "
                        "sync every iteration; fetch every N steps or "
                        "after the loop",
                    )
                )
            elif fname == "item" and isinstance(n.func, ast.Attribute):
                if is_device_value(n.func.value):
                    findings.append(
                        pf.finding(
                            self.name,
                            n,
                            f"`{ast.unparse(n.func.value)}.item()` on a step "
                            "result blocks on the device every iteration",
                        )
                    )
            elif (
                fname in _TORCH_READBACKS
                and isinstance(n.func, ast.Attribute)
                and is_device_value(n.func.value)
            ):
                findings.append(
                    pf.finding(
                        self.name,
                        n,
                        f"`{ast.unparse(n.func.value)}.{fname}()` copies a "
                        "step result to host every iteration",
                    )
                )
            elif (
                isinstance(n.func, ast.Name)
                and n.func.id in ("float", "int", "bool")
                and n.args
                and is_device_value(n.args[0])
            ):
                findings.append(
                    pf.finding(
                        self.name,
                        n,
                        f"`{n.func.id}({ast.unparse(n.args[0])})` on a step "
                        "result blocks on the device every iteration",
                    )
                )
            elif (
                dn in ("np.asarray", "numpy.asarray")  # jnp.asarray stays on device
                and n.args
                and is_device_value(n.args[0])
            ):
                findings.append(
                    pf.finding(
                        self.name,
                        n,
                        f"`{dn}({ast.unparse(n.args[0])})` copies a step "
                        "result to host every iteration",
                    )
                )
        return findings
