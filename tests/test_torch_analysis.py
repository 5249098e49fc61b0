"""The port's graftlint (``hops_tpu_torch.analysis``) held to the JAX
package's: every snippet case of ``tests/test_analysis.py`` — per-rule
true positives and near-misses, pragmas, baselines, fingerprints, the
CLI and its JSON schema, the whole-program concurrency rules — runs
through both packages in this process (the ``in_both`` harness of
``tests/test_torch_fleet.py``) and must pass the JAX case's assertions
in both and give the same findings (rule, path, line, symbol, message)
and the same CLI output.

The JAX cases' ``hops_tpu/…`` file names are mapped to
``hops_tpu_torch/…`` for the port's run (its path-scoped rules match
port paths only) and mapped back before the comparison. The six
``*_tree_is_clean`` cases lint the JAX tree; their port counterparts are
in ``tests/test_torch_analysis_selfcheck.py``.

Then the port's own cases: each of the seven path-scoped rules fires on
a ``hops_tpu_torch/`` path and not on a ``hops_tpu/`` one; the torch
forms of ``host-sync-in-loop``, ``jit-purity`` and ``use-after-donation``
with true positives and must-not-flag near-misses; three faults planted
in copies of port files; the ``python -m hops_tpu_torch.analysis`` CLI.
"""

from __future__ import annotations

import collections
import contextlib
import inspect
import io
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import test_analysis as jcases
from hops_tpu import analysis as j_analysis
from hops_tpu.analysis import baseline as j_baseline
from hops_tpu.analysis import cli as j_cli
from hops_tpu.analysis import engine as j_engine
from hops_tpu_torch import analysis as t_analysis
from hops_tpu_torch.analysis import baseline as t_baseline
from hops_tpu_torch.analysis import cli as t_cli
from hops_tpu_torch.analysis import engine as t_engine
from test_torch_fleet import in_both

REPO = Path(__file__).resolve().parents[1]

NAMES = {
    "jax": dict(analysis=j_analysis, baseline_mod=j_baseline, cli=j_cli, engine=j_engine),
    "torch": dict(analysis=t_analysis, baseline_mod=t_baseline, cli=t_cli, engine=t_engine),
}
# Bound per run by the harness; these module values only serve linters.
globals().update(NAMES["torch"])
PKG = "hops_tpu_torch"

CaptureResult = collections.namedtuple("CaptureResult", "out err", module="collections")


# -- the JAX cases, run in both packages ---------------------------------------
#
# Each case below is the JAX test's own code object, run with
# ``lint_code``/``lint_tree``/``engine``/``cli``/``baseline_mod``/
# ``analysis`` bound to the package under test. What a case returns to
# the harness is every ``engine.run`` result it produced and everything
# it printed (tmp paths replaced), so the two packages' findings and CLI
# output are compared, not only the case's own assertions.


def _port_path(filename: str) -> str:
    """A JAX case's ``hops_tpu/…`` file name in the package under test."""
    if filename.startswith("hops_tpu/"):
        return PKG + filename[len("hops_tpu"):]
    return filename


def lint_code(tmp_path: Path, code: str, rule: str | None = None,
              docs: str | None = None, filename: str = "snip.py"):
    """``tests/test_analysis.py``'s ``lint_code``, its file name mapped
    to the package under test."""
    target = tmp_path / _port_path(filename)
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(textwrap.dedent(code))
    docs_path = None
    if docs is not None:
        docs_path = tmp_path / "operations.md"
        docs_path.write_text(docs)
    rules = None
    if rule is not None:
        rules = [r for r in engine.all_rules() if r.name == rule]
        assert rules, f"unknown rule {rule}"
    return engine.run([target], root=tmp_path, docs_path=docs_path, rules=rules)


def lint_tree(tmp_path: Path, files: dict[str, str], rule: str | None = None):
    """``tests/test_analysis.py``'s ``lint_tree``, paths mapped."""
    for name, code in files.items():
        target = tmp_path / _port_path(name)
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(textwrap.dedent(code))
    rules = None
    if rule is not None:
        rules = [r for r in engine.all_rules() if r.name == rule]
        assert rules, f"unknown rule {rule}"
    return engine.run([tmp_path], root=tmp_path, rules=rules)


class _Recorder:
    """A package's engine module that keeps each run's findings."""

    def __init__(self, mod, seen: list):
        self._mod, self._seen = mod, seen

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def run(self, *args, **kwargs):
        out = self._mod.run(*args, **kwargs)
        self._seen.append([(f.rule, f.path, f.line, f.symbol, f.message) for f in out])
        return out


class _Capture:
    """``capsys`` for a case run by the harness: stdout and stderr kept
    for ``readouterr`` and, whole, for the comparison."""

    def __init__(self):
        self.out, self.err = io.StringIO(), io.StringIO()
        self._read = (0, 0)

    def readouterr(self) -> CaptureResult:
        out, err = self.out.getvalue(), self.err.getvalue()
        got = CaptureResult(out[self._read[0]:], err[self._read[1]:])
        self._read = (len(out), len(err))
        return got


def _fx_capsys():
    cap = _Capture()
    with contextlib.redirect_stdout(cap.out), contextlib.redirect_stderr(cap.err):
        yield cap


def _words(text: str, engine_mod) -> str:
    """CLI output as compared across the packages: its words, not its
    line breaks (argparse wraps its usage text to the program name's
    length), and each rule's catalog line with its description left out
    (three rules describe their torch forms too; the descriptions are
    compared in ``test_rule_descriptions``)."""
    for r in engine_mod.all_rules():
        text = text.replace(f"{r.name}: {r.description}", f"{r.name}: <description>")
    return " ".join(text.split())


def _replay(case: str, **args):
    """Run JAX case ``case`` against the package bound here; return its
    findings and output with this run's tmp path made neutral."""
    g = globals()  # the harness's bindings for the package under test
    seen: list = []
    g["engine"] = _Recorder(g["engine"], seen)
    ns = dict(vars(jcases))
    ns.update({k: g[k] for k in ("analysis", "baseline_mod", "cli", "engine",
                                 "lint_code", "lint_tree")})
    fn = getattr(jcases, case)
    type(fn)(fn.__code__, ns, fn.__name__, fn.__defaults__, fn.__closure__)(**args)
    out = {"findings": seen}
    if "capsys" in args:
        out["output"] = tuple(_words(s.getvalue(), g["engine"])
                              for s in (args["capsys"].out, args["capsys"].err))
    tmp = str(args["tmp_path"]) if "tmp_path" in args else None

    def neutral(x):
        if isinstance(x, str):
            return x.replace(tmp, "<tmp>") if tmp else x
        if isinstance(x, (list, tuple)):
            return type(x)(neutral(v) for v in x)
        if isinstance(x, dict):
            return {k: neutral(v) for k, v in x.items()}
        return x

    return neutral(out)


TREE_CASES = sorted(n for n in vars(jcases) if n.startswith("test_") and n.endswith("_tree_is_clean"))
SNIPPET_CASES = sorted(
    n for n, v in vars(jcases).items()
    if n.startswith("test_") and inspect.isfunction(v) and n not in TREE_CASES
)

for _case in SNIPPET_CASES:
    _params = list(inspect.signature(getattr(jcases, _case)).parameters)
    exec(
        f"def {_case}({', '.join(_params)}):\n"
        f"    return _replay({_case!r}, {', '.join(f'{p}={p}' for p in _params)})\n",
        globals(),
    )
    globals()[_case] = in_both(globals()[_case])
del _case, _params


def test_every_jax_case_is_replayed():
    """All of ``tests/test_analysis.py`` is covered: its snippet cases
    here, its six tree cases in the port's self-check."""
    assert len(TREE_CASES) == 6
    assert len(SNIPPET_CASES) + len(TREE_CASES) == sum(
        n.startswith("test_") for n in vars(jcases))


# -- path scopes -------------------------------------------------------------

_HTTP_SERVER = """
from http.server import ThreadingHTTPServer

srv = ThreadingHTTPServer(("127.0.0.1", 0), None)
"""
_RETRY = """
import time

def call(fn):
    for attempt in range(3):
        try:
            return fn()
        except OSError:
            time.sleep(0.5)
"""

#: Each path-scoped rule: a snippet, a port path it fires on, and the
#: JAX package's path it must not fire on in the port.
SCOPED = {
    "blocking-call-no-deadline": (
        "import urllib.request\n\ndef fetch(url):\n    return urllib.request.urlopen(url)\n",
        "modelrepo/fleet/snip.py"),
    "relay-json-roundtrip": (
        "import json\n\ndef echo(body):\n    return json.dumps(json.loads(body))\n",
        "modelrepo/serving.py"),
    "json-on-hot-wire": (
        "import json\n\ndef handle(body):\n    return json.loads(body)\n",
        "featurestore/online_serving.py"),
    "hardcoded-loopback": ('PROBE = "http://127.0.0.1:9090/healthz"\n',
                           "modelrepo/fleet/router.py"),
    "unbounded-priority-queue": ("import queue\n\npq = queue.PriorityQueue()\n",
                                 "runtime/qos.py"),
    "adhoc-http-server": (_HTTP_SERVER, "modelrepo/newthing.py"),
}


def _lint_at(tmp_path: Path, rel: str, code: str, rule: str):
    target = tmp_path / rel
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(textwrap.dedent(code))
    rules = [r for r in t_engine.all_rules() if r.name == rule]
    return t_engine.run([target], root=tmp_path, rules=rules)


@pytest.mark.parametrize("rule", sorted(SCOPED))
def test_scoped_rule_fires_on_port_path_only(tmp_path, rule):
    code, rel = SCOPED[rule]
    port = _lint_at(tmp_path, f"hops_tpu_torch/{rel}", code, rule)
    assert [f.rule for f in port] == [rule]
    assert port[0].path == f"hops_tpu_torch/{rel}"
    assert _lint_at(tmp_path, f"hops_tpu/{rel}", code, rule) == []


@pytest.mark.parametrize("sanctioned", ["runtime/resilience.py", "runtime/relaylock.py"])
def test_naked_retry_sanctions_port_paths_only(tmp_path, sanctioned):
    """naked-retry-loop's scope is an exemption: the port's backoff homes
    are exempt, the JAX package's paths are not (in the port's rule)."""
    rule = "naked-retry-loop"
    assert _lint_at(tmp_path, f"hops_tpu_torch/{sanctioned}", _RETRY, rule) == []
    assert [f.rule for f in _lint_at(tmp_path, f"hops_tpu/{sanctioned}", _RETRY, rule)] == [rule]
    assert [f.rule for f in _lint_at(tmp_path, "hops_tpu_torch/runtime/other.py", _RETRY,
                                     rule)] == [rule]


def test_adhoc_http_server_sanctions_the_port_core_only(tmp_path):
    rule = "adhoc-http-server"
    assert _lint_at(tmp_path, "hops_tpu_torch/runtime/httpserver.py", _HTTP_SERVER, rule) == []
    assert _lint_at(tmp_path, "hops_tpu/runtime/httpserver.py", _HTTP_SERVER, rule) == []
    assert len(_lint_at(tmp_path, "hops_tpu_torch/runtime/other.py", _HTTP_SERVER, rule)) == 1


# -- torch forms ---------------------------------------------------------------


def _lint(tmp_path: Path, code: str, rule: str, name: str = "snip.py"):
    return _lint_at(tmp_path, name, code, rule)


def test_host_sync_flags_torch_readbacks_and_synchronize_in_step_loop(tmp_path):
    findings = _lint(tmp_path, """
        import torch

        def train(step, state, batches, stream, done_event):
            for batch in batches:
                state, out = step(state, batch)
                loss = out["loss"].cpu()
                toks = out["tokens"].tolist()
                arr = out["logits"].detach().numpy()
                stop = bool(out["done"])
                torch.cuda.synchronize()
                stream.synchronize()
                done_event.synchronize()
            return state
        """, "host-sync-in-loop")
    messages = [f.message for f in findings]
    assert len(findings) == 7, messages
    assert "`out['loss'].cpu()` copies a step result to host every iteration" in messages
    assert any("out['tokens'].tolist()" in m for m in messages)
    assert any("out['logits'].detach().numpy()" in m for m in messages)
    assert any(m.startswith("`bool(out['done'])`") for m in messages)
    for recv in ("torch.cuda.synchronize", "stream.synchronize", "done_event.synchronize"):
        assert any(m.startswith(f"`{recv}()` inside a step loop") for m in messages), recv
    assert {f.symbol for f in findings} == {"train"}


def test_host_sync_torch_forms_must_not_flag(tmp_path):
    findings = _lint(tmp_path, """
        import torch

        def train(step, state, batches, dev):
            for batch in batches:
                state, out = step(state, batch)
                staged = out["loss"].to(dev, non_blocking=True)  # stays on the card
                rows = batch["x"].cpu()  # a batch is not a step result
            torch.cuda.synchronize()  # once, after the loop
            return float(out["loss"].cpu())

        def host_math(rows):
            total = 0.0
            for r in rows:  # not a step loop
                total += r.cpu().item()
                torch.cuda.synchronize()
            return total
        """, "host-sync-in-loop")
    assert findings == []


def test_host_sync_cpu_planted_in_a_port_step_loop(tmp_path):
    """A ``.cpu()`` of a step value planted in a copy of
    ``run_preemptible``'s step loop (in ``_run_attempt``) is flagged; the
    copy as it is is clean."""
    src = (REPO / "hops_tpu_torch/runtime/preemption.py").read_text()
    step = "            state, metrics = train_step(state, batch)\n"
    anchor = step + "            timer.tick("
    assert src.count(anchor) == 1
    assert _lint(tmp_path, src, "host-sync-in-loop", "preemption.py") == []
    planted = src.replace(anchor, step + '            loss = metrics["loss"].cpu()\n'
                          + "            timer.tick(")
    (f,) = _lint(tmp_path, planted, "host-sync-in-loop", "planted.py")
    assert f.symbol == "_run_attempt"
    assert f.line == src[:src.index(anchor)].count("\n") + 2
    assert "`metrics['loss'].cpu()`" in f.message


def test_jit_purity_flags_host_effects_under_compile_and_capture(tmp_path):
    findings = _lint(tmp_path, """
        import functools
        import random
        import time
        import torch
        from hops_tpu_torch.runtime import flight

        _calls = 0

        @torch.compile
        def fwd(x):
            print(x)
            return x

        @torch.compile(mode="reduce-overhead")
        def fwd2(x):
            return x + time.perf_counter()

        @functools.partial(torch.compile, fullgraph=True)
        def fwd3(x):
            flight.record("step", n=1)
            return x

        def body(x):
            global _calls
            return x

        def seg(x):
            return x * random.random()

        compiled = torch.compile(body)
        graphed = torch.cuda.make_graphed_callables(seg, (torch.ones(1),))

        def capture(g, model, x, _m_steps):
            with torch.cuda.graph(g):
                y = model(x)
                _m_steps.inc()
            return y
        """, "jit-purity")
    by_symbol = {f.symbol: f.message for f in findings}
    assert len(findings) == 6, [f.render() for f in findings]
    assert by_symbol["fwd"].startswith("`print` inside traced function `fwd`")
    assert "`time.perf_counter`" in by_symbol["fwd2"]
    assert "`flight.record(...)`" in by_symbol["fwd3"]
    assert "`global _calls`" in by_symbol["body"]
    assert "`random.random`" in by_symbol["seg"]
    assert by_symbol["capture"].startswith(
        "`_m_steps.inc(...)` inside a `torch.cuda.graph` capture block")
    assert all("compile or capture time" in m for m in by_symbol.values())


def test_jit_purity_torch_forms_must_not_flag(tmp_path):
    findings = _lint(tmp_path, """
        import time
        import torch

        @torch.compile
        def fwd(x):
            return torch.relu(x)

        def host(x):
            print("not compiled", x)
            return time.time()

        def run(g, model, x):
            print("before the capture")
            with torch.cuda.graph(g):
                y = model(x)
            print("after", time.time())
            g.replay()
            with torch.no_grad():
                print("not a capture")
            return y

        compiled = torch.compile(torch.nn.Linear(2, 2))
        """, "jit-purity")
    assert findings == []


def test_jit_purity_print_planted_in_a_compiled_port_function(tmp_path):
    """``@torch.compile`` and a ``print`` planted in a copy of
    ``ops/xent.py``'s ``_mm_f32`` is flagged; the copy as it is, and
    with the decorator alone, is clean."""
    src = (REPO / "hops_tpu_torch/ops/xent.py").read_text()
    anchor = "def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:\n"
    assert src.count(anchor) == 1
    assert _lint(tmp_path, src, "jit-purity", "xent.py") == []
    compiled = src.replace(anchor, "@torch.compile\n" + anchor)
    assert _lint(tmp_path, compiled, "jit-purity", "compiled.py") == []
    planted = compiled.replace(anchor, anchor + '    print("mm", a.shape)\n')
    (f,) = _lint(tmp_path, planted, "jit-purity", "planted.py")
    assert f.symbol == "_mm_f32"
    assert f.message.startswith("`print` inside traced function `_mm_f32` runs once")


def test_donation_flags_handoff_then_in_place_step(tmp_path):
    findings = _lint(tmp_path, """
        import functools
        import threading

        def loop(step, state, batches, q):
            for b in batches:
                state, m = step(state, b)
                q.put(state)  # the next iteration's step updates it in place

        def one_shot(train_step, state, batch, worker):
            worker.submit(state.params, 3)  # a path rooted at the state
            state, m = train_step(state, batch)

        def thread_args(state, batches, export):
            t = threading.Thread(target=export, args=(state,))
            t.start()
            for b in batches:
                state, _ = run_preemptible(train_step, state, b)

        def partial_target(state, b, export):
            threading.Thread(target=functools.partial(export, state)).start()
            lm_step(state, b)
        """, "use-after-donation")
    assert [f.symbol for f in findings] == ["loop", "one_shot", "thread_args", "partial_target"]
    assert findings[0].message.startswith(
        "`state` is handed to `q.put` and then passed to `step`, which updates it in place")
    assert "`run_preemptible`" in findings[2].message
    assert all("snapshot_state(state)" in f.message for f in findings)


def test_donation_handoff_must_not_flag(tmp_path):
    findings = _lint(tmp_path, """
        import copy

        def copies(step, state, batches, q, worker):
            for b in batches:
                state, m = step(state, b)
                q.put(snapshot_state(state))
                worker.submit(copy.deepcopy(state), 1)
                q.put_nowait(state.clone())

        def after_last(step, state, batches, q):
            for b in batches:
                state, m = step(state, b)
            q.put(state)

        def rebound(step, state, batch, q, load):
            q.put(state)
            state = load()
            state, m = step(state, batch)

        def branches(step, state, q, background):
            if background:
                q.put(state)
            else:
                step(state)

        def numbered(self, step, payload, q):
            q.put(payload)
            self._write(step, payload)  # `step` is the step number here
        """, "use-after-donation")
    assert findings == []


def test_donation_planted_in_the_continuous_loop(tmp_path):
    """``worker.submit(judged, …)`` changed back to
    ``worker.submit(state, …)`` in a copy of ``pipeline/continuous.py``
    is flagged; the copy as it is is clean."""
    src = (REPO / "hops_tpu_torch/pipeline/continuous.py").read_text()
    fixed = "worker.submit(judged, done, metric)"
    assert src.count(fixed) == 1
    assert _lint(tmp_path, src, "use-after-donation", "continuous.py") == []
    planted = src.replace(fixed, "worker.submit(state, done, metric)")
    (f,) = _lint(tmp_path, planted, "use-after-donation", "planted.py")
    assert f.symbol == "run_continuous"
    assert f.line == src[:src.index(fixed)].count("\n") + 1
    assert f.message.startswith(
        "`state` is handed to `worker.submit` and then passed to `run_preemptible`")


# -- the CLI and the package ---------------------------------------------------


def _module(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "hops_tpu_torch.analysis", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300)


def test_cli_module_with_no_arguments_is_clean_on_the_port():
    """``python -m hops_tpu_torch.analysis`` lints the port tree against
    ``analysis_baseline_torch.json`` and both docs files, and exits 0."""
    out = _module()
    assert out.returncode == t_cli.EXIT_CLEAN, out.stdout + out.stderr
    assert out.stderr.startswith("0 finding(s), ")


def test_cli_module_exits_1_on_a_snippet_tree(tmp_path):
    (tmp_path / "bad.py").write_text(jcases._FINDING_SNIPPET)
    out = _module(str(tmp_path))
    assert out.returncode == t_cli.EXIT_FINDINGS, out.stderr
    assert "bad.py:" in out.stdout and "swallowed-exception" in out.stdout


def test_cli_list_rules_names_the_18_rules(capsys):
    assert t_cli.main(["--list-rules"]) == t_cli.EXIT_CLEAN
    listed = [ln.split(":", 1)[0] for ln in capsys.readouterr().out.splitlines()]
    assert len(listed) == 18
    assert listed == [r.name for r in j_engine.all_rules()]


TORCH_FORMS = ("host-sync-in-loop", "jit-purity", "use-after-donation")


def test_rule_descriptions():
    """The same 18 rules; the 15 framework-neutral ones described as in
    JAX, the three with torch forms described anew."""
    jax = {r.name: r.description for r in j_engine.all_rules()}
    port = {r.name: r.description for r in t_engine.all_rules()}
    assert sorted(port) == sorted(jax)
    assert {n for n in jax if port[n] != jax[n]} == set(TORCH_FORMS)


def test_importing_main_runs_nothing():
    code = "import hops_tpu_torch.analysis.__main__; print('imported')"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0 and out.stdout == "imported\n", out.stderr


def test_port_has_the_jax_package_paths():
    jax_dir = Path(j_analysis.__file__).parent
    port_dir = Path(t_analysis.__file__).parent
    paths = sorted(p.relative_to(jax_dir).as_posix() for p in jax_dir.rglob("*.py"))
    assert len(paths) == 27
    assert sorted(p.relative_to(port_dir).as_posix() for p in port_dir.rglob("*.py")) == paths


def test_default_docs_and_baseline_are_the_ports():
    root = t_cli.lint_root([t_cli.default_target()])
    assert root == REPO
    assert t_cli.default_docs(root) == (REPO / "docs/operations.md",
                                        REPO / "docs/operations_torch.md")
    assert t_cli.default_baseline(root) == REPO / "analysis_baseline_torch.json"
    ctx = t_engine.Context(root=root, docs_path=t_cli.default_docs(root))
    assert "hops_tpu_gloo_host_bytes_total" in ctx.docs_text()
    assert "## Checkpoint / resume" in ctx.docs_text()
