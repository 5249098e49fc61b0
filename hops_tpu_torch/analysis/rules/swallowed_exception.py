"""swallowed-exception: bare ``except:`` and ``except Exception: pass``.
(counterpart of ``hops_tpu/analysis/rules/swallowed_exception.py``)

In the runtime/serving paths an exception swallowed without a trace is
how a serving host keeps answering after its state machine corrupted,
or a preemption handler "succeeds" without checkpointing. Two shapes:

- a bare ``except:`` — catches ``SystemExit``/``KeyboardInterrupt``
  too, so even Ctrl-C and supervisor shutdown get eaten;
- ``except Exception:`` (or ``BaseException``) whose body is only
  ``pass`` — the error vanishes without a log line.

A handler that logs, re-raises, or does anything at all with the
``Exception`` case is fine; suppressions on genuinely-intentional
swallows (interpreter teardown, client-went-away) should say why in
the same comment.
"""

from __future__ import annotations

import ast

from hops_tpu_torch.analysis.engine import Context, Rule, dotted_name, register
from hops_tpu_torch.analysis.model import Finding, ParsedFile

_BROAD = {"Exception", "BaseException"}


def _is_pass_only(body: list[ast.stmt]) -> bool:
    return all(
        isinstance(s, ast.Pass)
        or (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))
        for s in body
    )


@register
class SwallowedExceptionRule(Rule):
    name = "swallowed-exception"
    description = (
        "bare `except:` anywhere, and `except Exception:`/`BaseException:` "
        "whose body is only `pass`"
    )

    def check_file(self, pf: ParsedFile, ctx: Context) -> list[Finding]:
        findings = []
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                findings.append(
                    pf.finding(
                        self.name,
                        node,
                        "bare `except:` catches SystemExit/KeyboardInterrupt; "
                        "name the exception (and handle or log it)",
                    )
                )
                continue
            types = (
                node.type.elts if isinstance(node.type, ast.Tuple) else [node.type]
            )
            broad = [
                dotted_name(t)
                for t in types
                if dotted_name(t).split(".")[-1] in _BROAD
            ]
            exc = broad[0] if broad else ""
            if broad and _is_pass_only(node.body):
                findings.append(
                    pf.finding(
                        self.name,
                        node,
                        f"`except {exc}: pass` swallows the error without a "
                        "trace; log it, narrow the type, or justify with an "
                        "inline disable",
                    )
                )
        return findings
