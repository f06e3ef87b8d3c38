"""The port's static-analysis gate (``howtotrainyourmamlpytorch_tpu_torch.lint``)
on snippets, on the CPU:

- every rule of the port's set: a true positive and a clean negative, the
  torch counterparts each with a snippet of a known fault (a host copy or a
  ``.item()`` in a function handed to ``capture_graph``, a Python ``if`` on
  a tensor in a captured step);
- the rules carried over as they are: the same (rule, path, line) set
  through ``tools.graftlint.run_lint`` and through the port's runner;
- the CLI: rc 0 clean / 1 findings / 2 a usage error, and the root CLI's
  JSON keys (``scripts/lint.py``);
- the registry's isolation: importing and running the port's linter leaves
  ``tools.graftlint.engine.RULES`` as it was.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

import tools.graftlint as jax_lint
from howtotrainyourmamlpytorch_tpu_torch import lint
from howtotrainyourmamlpytorch_tpu_torch.lint.__main__ import main as lint_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_RULES = {"GL101", "GL102", "GL110", "GL120", "GL121", "GL122", "GL130", "GL140", "GL201", "GL202", "GL210",
              "GL211", "GL212", "GL213", "GL301", "GL302", "GL303"}


def _write(root, files):
    for name, source in files.items():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))


def _lint(tmp_path, monkeypatch, files, rules=None, runner=None, paths=None):
    """Write ``files`` under ``tmp_path`` and lint them from there ->
    (active, suppressed) of ``runner`` (default the port's)."""
    _write(tmp_path, files)
    monkeypatch.chdir(tmp_path)
    return (runner or lint.run_lint)(paths or sorted(files), rules)


def _rules(findings):
    return [f.rule for f in findings]


def _lines(findings, rule=None):
    return sorted(f.line for f in findings if rule is None or f.rule == rule)


def _marked(source: str, tag: str):
    """1-based lines of ``source`` (dedented) carrying ``# <tag>``."""
    return [i for i, line in enumerate(textwrap.dedent(source).splitlines(), start=1) if f"# {tag}" in line]


# ---------------------------------------------------------------------------
# GL101 / GL102: capture-reachable code
# ---------------------------------------------------------------------------

CAPTURE_SYNCS = """
import numpy as np
import torch

from core.programs import CapturedStep, GraphProgram, ServingCall, capture_graph


def make(model, x, device, pool, stream):
    def body():
        out = model(x)
        host = out.cpu()                      # SYNC
        n = out.sum().item()                  # SYNC
        k = int(x.shape[0]) + len(x)
        return out, host, n, k

    return capture_graph(body, device, pool, stream)


def step(state, batch):
    loss = (state["w"] * batch["x"]).sum()
    value = float(loss)                       # SYNC
    arr = np.asarray(batch["x"])              # SYNC
    idx = torch.nonzero(batch["x"])           # SYNC
    return helper(state, loss), (value, arr, idx)


def helper(state, loss):
    torch.cuda.synchronize()                  # SYNC
    return {"w": state["w"] - loss}


def serve(master, inputs):
    probs = torch.softmax(inputs["xs"], -1)
    return probs.tolist()                     # SYNC


class System:
    def _graph_step(self):
        def inner(state, batch):
            out = self._impl(state, batch)
            return None, out

        return inner

    def _impl(self, state, batch):
        done = torch.cuda.Event()
        done.synchronize()                    # SYNC
        return state["w"] * batch["x"]

    def build(self, device, buffers):
        a = CapturedStep(step, {}, {}, device, None, None)
        b = ServingCall(serve, {}, {}, buffers, device)
        return a, b, GraphProgram(self._graph_step, device, None, eager=None, stream_for=None)


def eager_only(t):
    return t.cpu(), float(t)                  # not captured: clean
"""


def test_gl101_host_syncs_in_capture_reachable_code(tmp_path, monkeypatch):
    active, _ = _lint(tmp_path, monkeypatch, {"captures.py": CAPTURE_SYNCS}, ["GL101"])
    assert _rules(active) == ["GL101"] * len(_marked(CAPTURE_SYNCS, "SYNC"))
    assert _lines(active) == _marked(CAPTURE_SYNCS, "SYNC")


@pytest.mark.parametrize("call", ["out.cpu()", "out.item()"])
def test_gl101_a_host_copy_handed_to_capture_graph(tmp_path, monkeypatch, call):
    """The fault class a captured step once carried to the card: a host copy
    inside the function a capture records."""
    source = f"""
    from howtotrainyourmamlpytorch_tpu_torch.core.programs import capture_graph

    def capture_step(model, x, device, pool, stream):
        def body():
            out = model(x)
            return out, {call}

        return capture_graph(body, device, pool, stream)
    """
    active, _ = _lint(tmp_path, monkeypatch, {"fault.py": source}, ["GL101"])
    assert _rules(active) == ["GL101"] and active[0].line == 7
    assert "capture-reachable" in active[0].message


CAPTURE_FLOW = """
import torch

from core.programs import CapturedStep


def step(state, batch):
    loss = (state["w"] * batch["x"]).sum()
    if loss > 0:                              # FLOW
        loss = loss * 2
    while loss:                               # FLOW
        loss = loss - 1
    scale = 2.0 if loss.mean() > 1 else 1.0   # FLOW
    picked = loss or state["w"]               # FLOW
    if not batch["y"].any():                  # FLOW
        pass
    if batch is None or isinstance(batch, dict) or "x" in batch:
        pass
    if batch["x"].shape[0] > 1 and batch["x"].dtype == torch.float32:
        pass
    if batch.mesh.processes > 1:
        pass
    return None, (loss, scale, picked)


def build(device):
    return CapturedStep(step, {}, {}, device, None, None)
"""


def test_gl102_control_flow_on_a_tensor_in_a_captured_step(tmp_path, monkeypatch):
    active, _ = _lint(tmp_path, monkeypatch, {"flow.py": CAPTURE_FLOW}, ["GL102"])
    assert _rules(active) == ["GL102"] * 5
    assert _lines(active) == _marked(CAPTURE_FLOW, "FLOW")


def test_gl102_a_python_if_handed_to_capture_graph(tmp_path, monkeypatch):
    source = """
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.core.programs import capture_graph

    def capture(x, device, pool, stream):
        def body(t=x):
            if torch.isfinite(t).all():
                return t * 2
            return t

        return capture_graph(body, device, pool, stream)

    def host_switch(flag, t):
        if flag:                               # not captured: clean
            return t
        return -t
    """
    active, _ = _lint(tmp_path, monkeypatch, {"branch.py": source}, ["GL101", "GL102"])
    assert _rules(active) == ["GL102"] and active[0].line == 7


def test_gl101_gl102_clean_on_unreached_code(tmp_path, monkeypatch):
    source = """
    import torch

    def step(state, batch):
        return state, state["w"] + batch["x"]

    def report(t):
        if t.sum() > 0:
            return float(t.item())
        return t.cpu().numpy()
    """
    active, _ = _lint(tmp_path, monkeypatch, {"plain.py": source}, ["GL101", "GL102"])
    assert active == []


# ---------------------------------------------------------------------------
# GL110: host sync on a hot path
# ---------------------------------------------------------------------------

HOT_RUNNER = """
import numpy as np
import torch


class ExperimentRunner:
    def _train_epoch(self, epoch):
        losses = []
        for batch in self.batches:
            state, out = self.system.train_step(self.state, batch)
            losses.append(out.loss.item())                # HOT
            lr = float(out.learning_rate)                 # HOT
            host = np.asarray(out.loss)                   # HOT
            torch.cuda.synchronize()                      # HOT
            rows = out.loss.cpu()                         # HOT
        profile = bool(self.cfg.profile_dir)
        fixed = np.asarray([np.nan]), int(3)
        return losses, lr, host, rows, profile, fixed

    def _save(self, out):
        return float(out.loss), out.loss.cpu()            # not hot: clean
"""

HOT_PROGRAMS = """
class GraphProgram:
    def __call__(self, state, batches):
        return state.cpu()                                # HOT


class Other:
    def __call__(self, state):
        return state.cpu()                                # not a replay: clean


# graftlint: hot-path
def opted_in(t):
    return t.item()                                       # HOT
"""


@pytest.mark.parametrize("name,source", [("experiment/runner.py", HOT_RUNNER), ("core/programs.py", HOT_PROGRAMS)])
def test_gl110_host_syncs_on_hot_paths(tmp_path, monkeypatch, name, source):
    active, _ = _lint(tmp_path, monkeypatch, {name: source}, ["GL110"])
    assert _rules(active) == ["GL110"] * len(_marked(source, "HOT"))
    assert _lines(active) == _marked(source, "HOT")


def test_gl110_frontend_dispatch_and_suppression(tmp_path, monkeypatch):
    source = """
    class EngineReplica:
        def dispatch(self, batcher, bucket, payload, ctx=None):
            fut = batcher.submit(bucket, payload)
            # deliberate: the request's one host copy  # graftlint: disable=GL110
            out = fut.value.cpu()
            return out.numpy()
    """
    active, suppressed = _lint(tmp_path, monkeypatch, {"serving/pool.py": source}, ["GL110"])
    assert _lines(active) == [7] and _lines(suppressed) == [6]


# ---------------------------------------------------------------------------
# GL121: torch's global generator
# ---------------------------------------------------------------------------


def test_gl121_torch_global_generator(tmp_path, monkeypatch):
    source = """
    import numpy as np
    import torch
    from torch import randn

    g = torch.Generator().manual_seed(0)
    a = torch.rand(3)                      # RNG
    b = torch.randn(2, 2, device="cpu")    # RNG
    c = torch.randint(0, 5, (4,))          # RNG
    d = torch.randperm(8)                  # RNG
    e = torch.randn_like(a)                # RNG
    f = torch.bernoulli(a)                 # RNG
    h = np.random.rand(2)                  # RNG
    ok1 = torch.rand(3, generator=g)
    ok2 = torch.randperm(8, generator=g)
    ok3 = torch.zeros(3).normal_(generator=g)
    ok4 = np.random.RandomState(0).rand(2)
    torch.manual_seed(0)
    """
    active, _ = _lint(tmp_path, monkeypatch, {"draws.py": source}, ["GL121"])
    assert _lines(active) == _marked(source, "RNG")
    assert all("generator" in f.message or "global generator" in f.message for f in active)


# ---------------------------------------------------------------------------
# GL130: donation
# ---------------------------------------------------------------------------

DONATION = """
def loop(system, state, first, batch):
    state, out = system._train_step_impl(state, first, donate=True)
    state = system._train_step_impl(
        state, batch, donate=True)[0]
    y = batch["y_support"]                              # DONATED
    return y, out


def eager(self, state, batch, epoch):
    if epoch is None:
        return self._train_step_impl(state, batch, epoch, donate=True)
    return self._compiled(state, batch, epoch)


def drop(batch):
    _drop_batch(batch)
    return batch["x_support"]                           # DONATED


def write(state, new_state):
    _write_into(state, new_state)
    return state.params                                 # DONATED


def rebind(state, new_state):
    state = _write_into(state, new_state)
    return state.params


def plain(state, batch):
    state, out = step(state, batch)
    return batch, out
"""


def test_gl130_read_after_donation(tmp_path, monkeypatch):
    active, _ = _lint(tmp_path, monkeypatch, {"donate.py": DONATION}, ["GL130"])
    assert _rules(active) == ["GL130"] * 3
    assert _lines(active) == _marked(DONATION, "DONATED")


# ---------------------------------------------------------------------------
# GL140: literal float casts
# ---------------------------------------------------------------------------

CASTS = """
import numpy as np
import torch
from torch import bfloat16


def f(p, g, device):
    a = p.float()                          # CAST
    b = g.half()                           # CAST
    c = p.to(torch.bfloat16)               # CAST
    d = p.to(device, dtype=torch.float16)  # CAST
    e = p.to(device, torch.float32)        # CAST
    h = np.zeros(3).astype(np.float32)     # CAST
    k = p.to(bfloat16)                     # CAST
    ok1 = p.to(g.dtype)
    ok2 = p.to(device)
    ok3 = p.float(g)
    ok4 = p.to(torch.int64)
    return a, b, c, d, e, h, k, ok1, ok2, ok3, ok4
"""


def test_gl140_literal_float_casts_in_hot_path_modules(tmp_path, monkeypatch):
    files = {f"howtotrainyourmamlpytorch_tpu_torch/{d}/m.py": CASTS for d in ("models", "core", "ops", "serving")}
    files["howtotrainyourmamlpytorch_tpu_torch/ops/precision.py"] = CASTS
    files["howtotrainyourmamlpytorch_tpu_torch/data/m.py"] = CASTS
    active, _ = _lint(tmp_path, monkeypatch, files, ["GL140"])
    per_file = {}
    for f in active:
        per_file.setdefault(f.path, []).append(f.line)
    want = _marked(CASTS, "CAST")
    assert per_file == {f"howtotrainyourmamlpytorch_tpu_torch/{d}/m.py": want
                        for d in ("models", "core", "ops", "serving")}


# ---------------------------------------------------------------------------
# GL213: import-light closure with torch as a heavy root
# ---------------------------------------------------------------------------


def test_gl213_torch_triton_and_the_package_roots(tmp_path, monkeypatch):
    files = {
        "light_direct.py": """
            # graftlint: import-light
            import torch
        """,
        "light_triton.py": """
            # graftlint: import-light
            import triton.language as tl
        """,
        "light_chain.py": """
            # graftlint: import-light
            import midmod
        """,
        "midmod.py": """
            from torch import nn
        """,
        "light_port.py": """
            # graftlint: import-light
            from howtotrainyourmamlpytorch_tpu_torch.serving import errors
        """,
        "light_clean.py": """
            # graftlint: import-light
            import json
            try:
                import torch
            except ImportError:
                torch = None

            def lazy():
                import torch
                return torch
        """,
        "heavy_unmarked.py": """
            import torch
        """,
    }
    active, _ = _lint(tmp_path, monkeypatch, files, ["GL213"])
    by_path = {f.path: f for f in active}
    assert sorted(by_path) == ["light_chain.py", "light_direct.py", "light_port.py", "light_triton.py"]
    assert "midmod -> torch" in by_path["light_chain.py"].message


# ---------------------------------------------------------------------------
# GL301 / GL302 / GL303: the port's registries
# ---------------------------------------------------------------------------


@pytest.fixture
def port_contract_tree(tmp_path):
    pkg = tmp_path / "howtotrainyourmamlpytorch_tpu_torch"
    (pkg / "resilience").mkdir(parents=True)
    with open(os.path.join(REPO, "howtotrainyourmamlpytorch_tpu_torch", "exit_codes.py")) as f:
        (pkg / "exit_codes.py").write_text(f.read())
    (pkg / "resilience" / "faults.py").write_text('KINDS = ("raise", "nan-loss", "delay")\n'
                                                  'SEAMS = ("runner.step", "loader.episode")\n')
    # another tree's registries, linted beside the port's: never the source
    other = tmp_path / "other"
    (other / "resilience").mkdir(parents=True)
    (other / "exit_codes.py").write_text("OK = 0\nWEIRD = 42\n")
    (other / "resilience" / "faults.py").write_text('KINDS = ("raise",)\nSEAMS = ("other.seam",)\n')
    return tmp_path


def test_gl301_bare_exit_codes_against_the_port_registry(port_contract_tree, monkeypatch):
    (port_contract_tree / "user.py").write_text(textwrap.dedent("""
        import sys

        def bail(rc):
            if rc in (75, 76):       # GL301 membership test
                sys.exit(75)         # GL301
            sys.exit(42)             # the other tree's code: clean
            raise SystemExit(0)      # generic code: clean
    """))
    monkeypatch.chdir(port_contract_tree)
    active, _ = lint.run_lint(["other", "howtotrainyourmamlpytorch_tpu_torch", "user.py"], ["GL301"])
    assert _rules(active) == ["GL301", "GL301"] and _lines(active) == [5, 6]


def test_gl303_seams_against_the_port_registry(port_contract_tree, monkeypatch):
    (port_contract_tree / "drill.py").write_text(textwrap.dedent("""
        def arm(injector):
            injector.fire("runner.step")          # registered: clean
            injector.fire("other.seam")           # GL303: not the port's
            spec = "loader.episode=raise:nth=1"   # registered: clean
            bad = "runner.stepp=delay:nth=1"      # GL303 typo
            return spec, bad
    """))
    monkeypatch.chdir(port_contract_tree)
    active, _ = lint.run_lint(["other", "howtotrainyourmamlpytorch_tpu_torch", "drill.py"], ["GL303"])
    assert _rules(active) == ["GL303", "GL303"] and _lines(active) == [4, 6]


def test_gl302_rc_table_drift_against_the_port_registry(tmp_path, monkeypatch):
    pkg = tmp_path / "repo" / "howtotrainyourmamlpytorch_tpu_torch"
    pkg.mkdir(parents=True)
    (tmp_path / "repo" / "docs").mkdir()
    (pkg / "exit_codes.py").write_text("OK = 0\nDIVERGED = 3\nPREEMPTED = 75\n"
                                       'TRAIN_PROCESS_RCS = {OK: "completed", DIVERGED: "diverged", '
                                       'PREEMPTED: "preempted"}\n')
    doc = tmp_path / "repo" / "docs" / "OPERATIONS.md"
    doc.write_text("**Exit-code table**:\n\n| rc | Meaning |\n|---|---|\n| 0 | completed |\n| 99 | mystery |\n")
    monkeypatch.chdir(tmp_path)
    active, _ = lint.run_lint([str(pkg)], ["GL302"])
    messages = " ".join(f.message for f in active)
    assert "rc 3" in messages and "rc 75" in messages and "rc 99" in messages
    doc.write_text("**Exit-code table**:\n\n| rc | Meaning |\n|---|---|\n| 0 | completed |\n| 3 | diverged |\n"
                   "| 75 | preempted |\n")
    assert lint.run_lint([str(pkg)], ["GL302"])[0] == []


# ---------------------------------------------------------------------------
# the rules carried over as they are: the JAX linter's findings, line by line
# ---------------------------------------------------------------------------

CARRIED = {
    "GL120": {"seeds.py": """
        import time
        import numpy as np
        rng = np.random.RandomState(int(time.time()))
        other = np.random.default_rng(seed=time.time_ns())
        fine = np.random.RandomState(1234)
    """},
    "GL121": {"draws.py": """
        import random
        import numpy as np
        from random import choice
        a = np.random.rand(2)
        b = random.random()
        c = choice([1, 2])
        d = np.random.RandomState(0).rand(2)
    """},
    "GL122": {"order.py": """
        names = {"b", "a"}
        for n in names | {"c"}:
            pass
        leaves = [x for x in set(names)]
        ok = [x for x in sorted(names)]
    """},
    "GL201": {"worker.py": """
        import threading

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                self.stats = {}
                threading.Thread(target=self._run, daemon=True).start()

            def _run(self):
                self.count += 1
                self.stats["x"] = 1
                with self._lock:
                    self.count += 1
                self.name = "w"

            def _bump_locked(self):
                self.count += 1
    """},
    "GL202": {"waits.py": """
        import queue

        q = queue.Queue()

        def drain(fut, d):
            a = fut.result()
            b = fut.result(timeout=5.0)
            c = q.get()
            e = q.get(timeout=1.0)
            f = d.get("key", None)
            return a, b, c, e, f
    """},
    "GL210": {"order_inv.py": """
        import threading

        class MicroBatcher:
            def __init__(self, pager):
                self._lock = threading.Lock()
                self._pager = pager

            def flush(self):
                with self._lock:
                    with self._pager._lock:
                        pass

            def fine(self):
                with self._pager._lock:
                    pass
    """},
    "GL211": {"guarded.py": """
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._deadline = 0.0

            def arm(self, t):
                self._deadline = t

            def clear(self):
                with self._lock:
                    self._deadline = float("inf")
    """},
    "GL212": {"blocking.py": """
        import threading
        import time

        class Pager:
            def __init__(self):
                self._lock = threading.Lock()

            def page(self, fut, sock):
                with self._lock:
                    time.sleep(0.1)
                    fut.result(timeout=1.0)
                    sock.recv(10)
                fut.result(timeout=1.0)
    """},
    "GL213": {
        "light.py": """
            # graftlint: import-light
            import midmod
            import jax.numpy
        """,
        "midmod.py": """
            import jax
        """,
    },
}


@pytest.mark.parametrize("rule", sorted(CARRIED))
def test_carried_rules_match_the_jax_linter(tmp_path, monkeypatch, rule):
    """Each snippet has findings, and the port's runner reports exactly the
    JAX linter's (rule, path, line) set for the carried rule (GL121: its
    numpy and ``random`` half; GL213: a jax root, heavy to both)."""
    files = CARRIED[rule]
    _write(tmp_path, files)
    monkeypatch.chdir(REPO if rule == "GL210" else tmp_path)  # GL210 reads tools/graftsan/order.toml
    paths = [str(tmp_path / name) for name in sorted(files)] if rule == "GL210" else sorted(files)
    port = {(f.rule, f.path, f.line) for f in lint.run_lint(paths, [rule])[0]}
    jax = {(f.rule, f.path, f.line) for f in jax_lint.run_lint(paths, [rule])[0]}
    assert port and port == jax


@pytest.mark.parametrize("rule", ["GL301", "GL303"])
def test_contract_rules_match_the_jax_linter_on_one_registry(tmp_path, monkeypatch, rule):
    """With one registry in the tree, GL301/GL303 find what the JAX
    linter finds."""
    pkg = tmp_path / "pkg"
    (pkg / "resilience").mkdir(parents=True)
    with open(os.path.join(REPO, "howtotrainyourmamlpytorch_tpu_torch", "exit_codes.py")) as f:
        (pkg / "exit_codes.py").write_text(f.read())
    (pkg / "resilience" / "faults.py").write_text('KINDS = ("raise", "delay")\nSEAMS = ("runner.step",)\n')
    (pkg / "user.py").write_text(textwrap.dedent("""
        import sys

        def bail(rc, injector):
            injector.fire("runner.stepp")
            spec = "runner.step=raise:nth=1;loader.episodee=delay"
            if rc in (75, 76):
                sys.exit(75)
            return spec
    """))
    monkeypatch.chdir(tmp_path)
    port = {(f.rule, f.path, f.line) for f in lint.run_lint(["pkg"], [rule])[0]}
    jax = {(f.rule, f.path, f.line) for f in jax_lint.run_lint(["pkg"], [rule])[0]}
    assert port and port == jax


def test_suppressions_mean_what_they_mean_to_the_jax_linter(tmp_path, monkeypatch):
    source = """
    import numpy as np
    import torch

    a = np.random.rand(2)  # graftlint: disable=GL121
    # a draw whose order does not matter here  # graftlint: disable=GL121
    b = torch.rand(2)
    c = torch.rand(2)  # graftlint: disable=GL122
    """
    active, suppressed = _lint(tmp_path, monkeypatch, {"s.py": source}, ["GL121"])
    assert _lines(active) == [8] and _lines(suppressed) == [5, 7]


# ---------------------------------------------------------------------------
# the registry, the CLI, the isolation
# ---------------------------------------------------------------------------


def test_the_port_registry_is_complete():
    assert set(lint.RULES) == PORT_RULES
    assert all(lint.RULES[r].title for r in PORT_RULES)


def test_cli_rc_contract(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import torch\na = torch.rand(2)\n")
    assert lint_main([str(clean)]) == 0
    assert lint_main([str(dirty)]) == 1
    assert "GL121" in capsys.readouterr().out
    assert lint_main([]) == 2
    assert lint_main([str(tmp_path / "missing")]) == 2
    assert lint_main(["--rule", "GL999", str(clean)]) == 2
    assert lint_main(["--bogus-flag", str(clean)]) == 2
    assert lint_main(["--help"]) == 0
    capsys.readouterr()
    assert lint_main(["--list-rules"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == sorted(PORT_RULES)


def _cli(args, module=True):
    argv = ["-m", "howtotrainyourmamlpytorch_tpu_torch.lint"] if module else [os.path.join(REPO, "scripts",
                                                                                            "lint.py")]
    return subprocess.run([sys.executable, *argv, *args], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))


def test_cli_json_keys_match_the_root_cli(tmp_path):
    """``python -m ...lint --json`` and ``scripts/lint.py --json`` on the
    same file: the same rc, the same payload keys, finding keys and
    counts; ``rule_times_ms`` names the port's rules."""
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import numpy as np\na = np.random.rand(2)\n")
    port, root = _cli(["--json", str(dirty)]), _cli(["--json", str(dirty)], module=False)
    assert port.returncode == root.returncode == 1, (port.stderr, root.stderr)
    mine, theirs = json.loads(port.stdout), json.loads(root.stdout)
    assert set(mine) == set(theirs)
    assert {k: mine[k] for k in ("tool", "version", "counts")} == {k: theirs[k] for k in ("tool", "version", "counts")}
    assert set(mine["findings"][0]) == set(theirs["findings"][0])
    assert set(mine["rule_times_ms"]) == PORT_RULES
    assert _cli(["--rule", "GL999", str(dirty)]).returncode == 2


def test_the_jax_registry_is_left_as_it_was():
    """In a fresh process: the JAX linter's registry, before and after the
    port's linter is imported and run, holds the same rule objects, and the
    JAX self-gate's per-rule timing still names exactly them."""
    code = textwrap.dedent("""
        import json, sys
        import tools.graftlint as g
        from tools.graftlint import engine
        before = {k: id(v) for k, v in engine.RULES.items()}
        from howtotrainyourmamlpytorch_tpu_torch import lint
        lint.run_lint(["howtotrainyourmamlpytorch_tpu_torch/exit_codes.py"])
        g.run_lint(["howtotrainyourmamlpytorch_tpu_torch/exit_codes.py"])
        after = {k: id(v) for k, v in engine.RULES.items()}
        shared = [k for k in lint.RULES if lint.RULES[k] is engine.RULES.get(k)]
        print(json.dumps({"same": before == after, "times": sorted(engine.LAST_RULE_TIMES_MS),
                          "jax": sorted(after), "shared": shared, "jax_loaded": "jax" in sys.modules}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert got["same"] and got["times"] == got["jax"] and got["shared"] == [] and not got["jax_loaded"]
    assert all(lint.RULES[k] is not jax_lint.RULES.get(k) for k in lint.RULES)
