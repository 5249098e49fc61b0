#!/usr/bin/env python3
"""Docs-site generator for the PyTorch/CUDA port — counterpart of ``make.py``.

The reference walks every notebook, nbconverts it to markdown and feeds
Hugo (make.py:14-27, 79-106; SURVEY.md §2.1 "Docs generator"). Source
format here is code, so the generator walks ``hops_tpu_torch/`` and the
example scripts of ``examples_torch/`` with ``ast`` (nothing is
imported: no torch start-up, no card), renders one markdown page per
module from its docstring and public API signatures, and one per
example script, into ``<out>/content/``; the hand-written guides of
``docs/`` pass through unchanged. Any static-site tool (Hugo included)
can consume the output; ``<out>/content/_index.md`` is the landing page.

Usage: ``python3 make_torch.py [--out site_torch]``
"""

from __future__ import annotations

import argparse
import ast
from pathlib import Path

ROOT = Path(__file__).parent


def _signature(node: ast.FunctionDef | ast.AsyncFunctionDef) -> str:
    args = []
    a = node.args
    defaults = [None] * (len(a.args) - len(a.defaults)) + list(a.defaults)
    for arg, default in zip(a.args, defaults):
        s = arg.arg
        if default is not None:
            s += f"={ast.unparse(default)}"
        args.append(s)
    if a.vararg:
        args.append(f"*{a.vararg.arg}")
    elif a.kwonlyargs:
        args.append("*")
    for arg, default in zip(a.kwonlyargs, a.kw_defaults):
        s = arg.arg
        if default is not None:
            s += f"={ast.unparse(default)}"
        args.append(s)
    if a.kwarg:
        args.append(f"**{a.kwarg.arg}")
    return f"{node.name}({', '.join(args)})"


def _first_line(doc: str | None) -> str:
    return (doc or "").strip().split("\n")[0]


def render_module(path: Path) -> tuple[str, str] | None:
    """Returns ``(page_markdown, docstring_first_line)``, or None for a
    file with neither a docstring nor a function or class."""
    tree = ast.parse(path.read_text())
    moddoc = ast.get_docstring(tree)
    if moddoc is None and not any(
        isinstance(n, (ast.FunctionDef, ast.ClassDef)) for n in tree.body
    ):
        return None
    lines = [f"# `{path.relative_to(ROOT)}`", ""]
    if moddoc:
        lines += [moddoc, ""]
    api = [n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    public = [n for n in api if not n.name.startswith("_")]
    if public:
        lines += ["## Public API", ""]
    for node in public:
        if isinstance(node, ast.ClassDef):
            lines.append(f"### class `{node.name}`")
            doc = _first_line(ast.get_docstring(node))
            if doc:
                lines += ["", doc, ""]
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and not item.name.startswith("_"):
                    lines.append(f"- `{_signature(item)}` — {_first_line(ast.get_docstring(item))}")
            lines.append("")
        else:
            lines.append(f"### `{_signature(node)}`")
            doc = _first_line(ast.get_docstring(node))
            if doc:
                lines += ["", doc]
            lines.append("")
    return "\n".join(lines), _first_line(moddoc)


def build(out_dir: Path) -> list[Path]:
    """Write the site under ``out_dir/content``; returns the pages."""
    content = Path(out_dir) / "content"
    content.mkdir(parents=True, exist_ok=True)
    written = []
    sources = sorted((ROOT / "hops_tpu_torch").rglob("*.py")) + sorted(
        (ROOT / "examples_torch").glob("*.py")
    )
    # Hand-written guides pass through unchanged.
    for guide in sorted((ROOT / "docs").glob("*.md")):
        dst = content / guide.name
        dst.write_text(guide.read_text())
        written.append(dst)
    index = [
        "# hops-tpu on PyTorch and CUDA",
        "",
        "The ML platform framework's port to PyTorch and CUDA for NVIDIA Hopper:",
        "experiment launchers, async parallel search, model registry/serving,",
        "feature store, jobs/orchestration — PyTorch on the compute path, with",
        "hand-written CUDA kernels for attention, and torch.distributed for scale.",
        "",
        "## Modules",
        "",
    ]
    for src in sources:
        rendered = render_module(src)
        if rendered is None:
            continue
        page, first = rendered
        rel = src.relative_to(ROOT)
        slug = str(rel.with_suffix("")).replace("/", ".")
        dst = content / f"{slug}.md"
        dst.write_text(page)
        written.append(dst)
        index.append(f"- [`{rel}`]({slug}.md) — {first}")
    (content / "_index.md").write_text("\n".join(index) + "\n")
    written.append(content / "_index.md")
    return written


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="site_torch")
    args = parser.parse_args()
    pages = build(ROOT / args.out)
    print(f"wrote {len(pages)} pages under {args.out}/content")
