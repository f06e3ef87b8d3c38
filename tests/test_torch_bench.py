"""The port's trainer benchmark (``python -m
howtotrainyourmamlpytorch_tpu_torch.bench``) against the root ``bench.py``
of the JAX package, on the CPU: the knob mappers, the configs they build,
the one-JSON-line emission guarantees (stage watchdog, SIGTERM salvage,
hung card probes, no card), and a CPU shake-out whose report has the JAX
script's keys.

The shake-out runs the bench's ``main`` at a small size (3-way 1-shot, a
2-stage 4-filter VGG, 2 inner steps) by replacing its ``build_system`` in
a child process: the full-width flagship step is run on the card only.
"""

import ast
import dataclasses
import json
import os
import select
import signal
import subprocess
import sys
import time

import pytest

import bench as jbench
from chip_smoke import BENCH_KEYS
from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu_torch import bench as tbench
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "howtotrainyourmamlpytorch_tpu_torch.bench"
# no card and a fast watchdog, whatever machine runs the tests
ENV = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": "", "BENCH_WATCHDOG_POLL_S": "0.2"}

PRECISION_ARMS = ("", "legacy", "f32", "bf16")
REMAT_ARMS = tuple(jcfg.REMAT_POLICIES)
STRATEGY_ARMS = ("", "maml++", "fomaml", "anil")

#: the shake-out's size: the recipe's knobs on a 3-way 1-shot task, 2 inner
#: steps, and a 2-stage 4-filter VGG
SMALL = dict(num_classes_per_set=3, num_samples_per_class=1, num_target_samples=1,
             number_of_training_steps_per_iter=2, number_of_evaluation_steps_per_iter=2)
SMALL_VGG = dict(num_stages=2, cnn_num_filters=4)

# a child that runs the bench's main at the small size
SMALL_MAIN = f"""
import dataclasses, sys
from howtotrainyourmamlpytorch_tpu_torch import bench
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg

def small(cfg, device):
    cfg = dataclasses.replace(cfg, **{SMALL!r})
    return MAMLSystem(cfg, model=build_vgg(cfg.image_shape, 3, **{SMALL_VGG!r}), device=device)

bench.build_system = small
bench.main(sys.argv[1:])
"""


def _only_json_line(text):
    lines = text.strip().splitlines()
    assert len(lines) == 1, f"expected exactly one stdout line, got {lines!r}"
    return json.loads(lines[0])


def _reported_keys(path):
    """The report keys a bench script's source writes: the ``report``
    literal and every ``wd.update(...)`` keyword."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and any(getattr(t, "id", "") == "report" for t in node.targets)
                and isinstance(node.value, ast.Dict)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "update"
                and getattr(node.func.value, "id", "") == "wd"):
            keys |= {kw.arg for kw in node.keywords}
    return keys


@pytest.mark.parametrize("script", ["bench.py", "howtotrainyourmamlpytorch_tpu_torch/bench.py"])
def test_the_report_keys_are_the_jax_scripts(script):
    """Both scripts write exactly the keys chip_smoke.py checks the card's
    line against (the excepthook's stage_error aside)."""
    assert _reported_keys(os.path.join(REPO, script)) - {"stage_error"} == BENCH_KEYS


@pytest.mark.parametrize("arm", PRECISION_ARMS + ("fp8",))
def test_precision_mapper_matches_jax(arm):
    if arm == "fp8":
        for module in (jbench, tbench):
            with pytest.raises(ValueError, match="BENCH_PRECISION"):
                module._precision_overrides(arm)
        return
    assert tbench._precision_overrides(arm) == jbench._precision_overrides(arm)


@pytest.mark.parametrize("arm", REMAT_ARMS + ("everything_saveable",))
def test_remat_mapper_matches_jax(arm):
    kwargs = tbench._remat_overrides(arm)
    assert kwargs == jbench._remat_overrides(arm)
    if arm == "everything_saveable":
        # validation happens at Config construction, in both packages
        with pytest.raises(ValueError):
            jcfg.Config(**kwargs)
        with pytest.raises(ValueError):
            tcfg.Config(**kwargs)


@pytest.mark.parametrize("arm", STRATEGY_ARMS + ("protonet",))
def test_strategy_mapper_matches_jax(arm):
    assert tbench._STRATEGY_KNOBS == jbench._STRATEGY_KNOBS
    if arm == "protonet":
        # forward-only: refused by main() under the rc-2 contract in both
        assert arm not in tbench._STRATEGY_KNOBS
        return
    assert tbench._strategy_overrides(arm) == jbench._strategy_overrides(arm)


def _bench_kwargs(module, precision="", remat="", strategy="", matmul="default", patches=False):
    """The Config kwargs each script's main builds from its knobs."""
    return dict(
        matmul_precision=matmul,
        conv_via_patches=patches,
        **module._precision_overrides(precision),
        **module._remat_overrides(remat),
        **module._strategy_overrides(strategy),
    )


CONFIG_ARMS = ([{"precision": a} for a in PRECISION_ARMS] + [{"remat": a} for a in REMAT_ARMS if a]
               + [{"strategy": a} for a in STRATEGY_ARMS if a]
               + [{"matmul": "high"}, {"matmul": "highest"}, {"patches": True}])


@pytest.mark.parametrize("arm", CONFIG_ARMS, ids=lambda a: "-".join(f"{k}={v}" for k, v in a.items()))
def test_config_matches_jax(arm):
    ours = tcfg.Config(**_bench_kwargs(tbench, **arm))
    theirs = jcfg.Config(**_bench_kwargs(jbench, **arm))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_constants_match_jax():
    assert tbench.METRIC == jbench.METRIC
    assert tbench.REFERENCE_STEPS_PER_SEC == jbench.REFERENCE_STEPS_PER_SEC == 2.6
    assert tbench._RC_USAGE == jbench._RC_USAGE == 2


def _run(code, timeout=120):
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=timeout,
                          cwd=REPO, env=ENV)


def test_stage_deadline_emits_partial_and_exits_zero():
    out = _run(f"""
import time
from howtotrainyourmamlpytorch_tpu_torch import bench
wd = bench._Watchdog({{"metric": bench.METRIC, "value": 1.23, "unit": "u"}}, enabled=True)
wd.enter("stuck-stage", 0.1)
time.sleep(60)  # simulated hang: the watchdog must os._exit(0) with the JSON
""")
    assert out.returncode == 0, out.stderr
    d = _only_json_line(out.stdout)
    assert d["wedged_at"] == "stuck-stage" and d["value"] == 1.23


def test_stage_deadline_before_headline_fails_structured():
    out = _run("""
import time
from howtotrainyourmamlpytorch_tpu_torch import bench
wd = bench._Watchdog({"metric": bench.METRIC, "value": None, "unit": "u"}, enabled=True)
wd.enter("compile+warmup", 0.1)
time.sleep(60)
""")
    assert out.returncode == 2, out.stderr
    d = _only_json_line(out.stdout)
    assert d["value"] is None and "compile+warmup" in d["error"]


def test_sigterm_salvages_measured_headline():
    p = subprocess.Popen([sys.executable, "-c", """
import signal, sys, time
from howtotrainyourmamlpytorch_tpu_torch import bench
wd = bench._Watchdog({"metric": bench.METRIC, "value": 9.87, "unit": "u"}, enabled=True)
signal.signal(signal.SIGTERM, wd.on_sigterm)
wd.enter("some-stage", 9999)
print("READY", file=sys.stderr, flush=True)
time.sleep(60)
"""], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=ENV)
    # raw os.read keeps the deadline real (see tests/test_bench_watchdog.py)
    fd, seen = p.stderr.fileno(), ""
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and "READY" not in seen:
        ready, _, _ = select.select([fd], [], [], 1.0)
        if ready:
            chunk = os.read(fd, 4096).decode(errors="replace")
            if chunk == "":
                break
            seen += chunk
    p.send_signal(signal.SIGTERM)
    out, _ = p.communicate(timeout=30)
    assert p.returncode == 0, seen
    d = _only_json_line(out)
    assert d["value"] == 9.87 and "sigterm" in d["wedged_at"]


def test_disabled_watchdog_never_fires():
    out = _run("""
import time
from howtotrainyourmamlpytorch_tpu_torch import bench
wd = bench._Watchdog({"metric": bench.METRIC, "value": 1.0, "unit": "u"}, enabled=False)  # the CPU
wd.enter("slow-cpu-stage", 0.1)
time.sleep(2)
wd.update(extra=1)
wd.emit_final()
""")
    assert out.returncode == 0, out.stderr
    d = _only_json_line(out.stdout)
    assert d["value"] == 1.0 and d["extra"] == 1 and "wedged_at" not in d


def test_hung_card_probes_give_the_structured_line_at_once():
    """Two consecutive hung card probes end the wait with the one
    structured line and rc 2, without an in-process contact."""
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", MODULE], capture_output=True, text=True, timeout=120, cwd=REPO,
                         env={**ENV, "WAIT_FOR_CARD_PROBE": "import time; time.sleep(60)",
                              "BENCH_STARTUP_TIMEOUT_S": "0.3", "BENCH_PROBE_INTERVAL_S": "0.05",
                              "BENCH_MAX_WEDGED_PROBES": "2", "BENCH_STARTUP_DEADLINE_S": "600"})
    assert out.returncode == 2, out.stderr
    assert time.monotonic() - t0 < 60
    d = _only_json_line(out.stdout)
    assert d["value"] is None and "wedged" in d["error"] and "2 consecutive" in d["error"]


@pytest.mark.parametrize("case", ["no-card", "protonet"])
def test_no_card_and_no_cpu_asked_gives_the_structured_line(case):
    """Without a card the CPU runs only when asked: the card's probes
    fail, the wait ends at its deadline, the contact finds no card, and
    the one structured line exits 2. A refused arm does the same before
    any contact."""
    env = {**ENV, "WAIT_FOR_CARD_PROBE": "import sys; sys.exit(1)", "BENCH_STARTUP_DEADLINE_S": "1",
           "BENCH_PROBE_INTERVAL_S": "0.05"}
    if case == "protonet":
        env["BENCH_STRATEGY"] = "protonet"
    out = subprocess.run([sys.executable, "-m", MODULE], capture_output=True, text=True, timeout=120, cwd=REPO,
                         env=env)
    assert out.returncode == 2, out.stderr
    d = _only_json_line(out.stdout)
    assert set(d) == {"metric", "value", "unit", "vs_baseline", "error"}
    assert d["value"] is None and d["metric"] == jbench.METRIC
    assert ("BENCH_STRATEGY" if case == "protonet" else "--device cpu") in d["error"]


@pytest.fixture(scope="module", params=["--device cpu", "BENCH_ALLOW_CPU=1"])
def shake_out(request):
    env = {**ENV, "BENCH_MEASURE_ITERS": "1", "BENCH_PHASE_ITERS": "1", "BENCH_STEPS_PER_DISPATCH": "2",
           "BENCH_TRACE_ITERS": "1", "BENCH_B16": "0"}
    argv = []
    if request.param == "--device cpu":
        argv = ["--device", "cpu"]
    else:
        env["BENCH_ALLOW_CPU"] = "1"
    return subprocess.run([sys.executable, "-c", SMALL_MAIN, *argv], capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=env)


def test_cpu_shake_out_reports_the_jax_keys(shake_out):
    assert shake_out.returncode == 0, shake_out.stderr
    d = _only_json_line(shake_out.stdout)
    assert set(d) == BENCH_KEYS, sorted(set(d) ^ BENCH_KEYS)
    assert d["value"] > 0 and d["platform"] == "cpu:cpu" and d["metric"] == jbench.METRIC


def test_cpu_shake_out_fields(shake_out):
    out = shake_out
    d = _only_json_line(out.stdout)
    assert d["precision"] == "legacy_bf16" and d["remat_policy"] == "none" and d["strategy"] == "maml++"
    assert set(d["phase_breakdown"]) == {"data_wait", "dispatch", "settle"}
    assert set(d["prewarm"]) == {"programs", "seconds", "cache_hits"} and d["prewarm"]["programs"] == 2
    assert d["steps_per_sec_multi_dispatch"] > 0 and d["multi_dispatch_error"] is None
    assert d["flops_per_step"] > 0 and d["flops_source"] == "flop_counter"
    # the CPU has no peak and its trace no device event: null, with the reasons on stderr
    assert d["mfu"] is None and "mfu unavailable" in out.stderr
    assert d["breakdown"] is None and "breakdown null" in out.stderr
    assert d["bytes_accessed_per_step"] is None and "FlopCounterMode counts no bytes" in out.stderr
    assert d["b16_steps_per_sec"] is None and "BENCH_B16 is off" in out.stderr


#: XLA's cost analysis counts the elementwise ops (batch norm, activations,
#: the inner updates), the flop counter only convolutions and matmuls: at
#: the shake-out's 4 filters JAX's count is 1.414 x the port's (measured on
#: the CPU); a missed or double-counted convolution pass moves it far out
JAX_OVER_PORT_FLOPS = (1.3, 1.55)


@pytest.fixture(scope="module")
def small_step_flops():
    """The small step's FLOPs counted in this process: the port's flop
    counter over one ``train_step``, and JAX's ``jit_cost`` of the program
    the JAX script prices, both at the bench recipe's knobs."""
    import jax
    import jax.numpy as jnp
    import torch

    from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
    from howtotrainyourmamlpytorch_tpu.data.synthetic import synthetic_batch
    from howtotrainyourmamlpytorch_tpu.models.vgg import build_vgg as jax_build_vgg
    from howtotrainyourmamlpytorch_tpu.observability import costs as jax_costs
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
    from howtotrainyourmamlpytorch_tpu_torch.observability import costs

    tc = tcfg.Config(**_bench_kwargs(tbench), **SMALL)
    jc = jcfg.Config(**_bench_kwargs(jbench), **SMALL)
    b = synthetic_batch(tc.batch_size, 3, 1, 1, tc.image_shape, seed=0)
    tsys = MAMLSystem(tc, model=build_vgg(tc.image_shape, 3, **SMALL_VGG), device="cpu")
    port = costs.step_cost(tsys.train_step, tsys.init_train_state(), {k: torch.as_tensor(v) for k, v in b.items()},
                           0)["flops"]
    jsys = JaxMAMLSystem(jc, model=jax_build_vgg(jc.image_shape, 3, **SMALL_VGG))
    step = jsys._compiled_train_step(jsys.use_second_order(0), jsys.msl_active(0))
    ref = jax_costs.jit_cost(step, jsys.init_train_state(), {k: jnp.asarray(v) for k, v in b.items()})["flops"]
    yield port, ref
    jax.clear_caches()


def test_cpu_shake_out_flops_are_the_steps(shake_out, small_step_flops):
    """The line's flops_per_step is one train step's count (no K-chunk or
    rollout counted twice), and JAX's count of the same step lies above it
    by the elementwise ops only."""
    port, ref = small_step_flops
    assert _only_json_line(shake_out.stdout)["flops_per_step"] == port
    assert JAX_OVER_PORT_FLOPS[0] < ref / port < JAX_OVER_PORT_FLOPS[1], ref / port
