"""The port's serving benchmark (``python -m
howtotrainyourmamlpytorch_tpu_torch.bench_serving``) against the root
``bench_serving.py`` of the JAX package, on the CPU: the knobs' rc-2
contracts, the report of the tiny engine (its keys, metric, model,
strategy, precision and compile counts) beside the JAX script's on the
same arguments, the autoscale arm's fleet-surge cycle, and the ``--url``
path against a port frontend served over HTTP in this process.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from chip_smoke import BENCH_SERVING_ARM_KEYS, BENCH_SERVING_KEYS
from howtotrainyourmamlpytorch_tpu_torch.config import Config, ServingConfig
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
from howtotrainyourmamlpytorch_tpu_torch.serving.server import ServingFrontend, make_http_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "howtotrainyourmamlpytorch_tpu_torch.bench_serving"
ENV = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}
REPS = ["--adapt-reps", "2", "--predict-reps", "8"]

#: the port's compile counts add the fused update's launch count (B1),
#: which the card's smoke run reads
PORT_COUNT_KEYS = frozenset({"fused_sgd_launches"})

BAD_KNOBS = [
    ("BENCH_AUTOSCALE", "2"),
    ("BENCH_PRECISION", "fp8"),
    ("BENCH_REMAT", "everything_saveable"),
    ("BENCH_STRATEGY", "reptile"),
    ("BENCH_TENANTS", "-1"),
    ("BENCH_REFINE", "x"),
]


@pytest.mark.parametrize("knob, value", BAD_KNOBS, ids=[k for k, _ in BAD_KNOBS])
def test_a_bad_knob_exits_2_naming_it_before_any_device_work(knob, value):
    """Each bad knob: rc 2, a stderr line naming it, nothing on stdout, as
    the JAX script does. The port runs it without ``--device cpu`` and
    without a card: a device resolved first would raise instead."""
    port = subprocess.run([sys.executable, "-m", MODULE, "--tiny"], capture_output=True, text=True, timeout=120,
                          cwd=REPO, env={**ENV, knob: value})
    jax = subprocess.run([sys.executable, os.path.join(REPO, "bench_serving.py"), "--tiny"], capture_output=True,
                         text=True, timeout=120, cwd=REPO, env={**ENV, "JAX_PLATFORMS": "cpu", knob: value})
    for out in (port, jax):
        assert out.returncode == 2, out.stderr
        assert knob in out.stderr and out.stdout == ""


def test_no_card_without_the_cpu_asked_exits_2():
    out = subprocess.run([sys.executable, "-m", MODULE, "--tiny"], capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=ENV)
    assert out.returncode == 2 and out.stdout == ""
    assert "device='cpu'" in out.stderr


def _only_json_line(text):
    lines = text.strip().splitlines()
    assert len(lines) == 1, f"expected exactly one stdout line, got {lines!r}"
    return json.loads(lines[0])


#: (name, environment): the plain run, and one with a 1 s
#: staircase, a refine arm and two tenants
RUNS = {
    "plain": {"BENCH_SLO_DURATION_S": "0"},
    "arms": {"BENCH_SLO_DURATION_S": "1", "BENCH_SLO_STAIRS": "4", "BENCH_REFINE": "1", "BENCH_TENANTS": "2"},
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def lines(request):
    env = {**ENV, **RUNS[request.param]}
    port = subprocess.run([sys.executable, "-m", MODULE, "--tiny", "--device", "cpu", *REPS], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env)
    jax = subprocess.run([sys.executable, os.path.join(REPO, "bench_serving.py"), "--tiny", *REPS],
                         capture_output=True, text=True, timeout=300, cwd=REPO, env={**env, "JAX_PLATFORMS": "cpu"})
    assert port.returncode == 0, port.stderr[-3000:]
    assert jax.returncode == 0, jax.stderr[-3000:]
    return request.param, _only_json_line(port.stdout), _only_json_line(jax.stdout)


def test_the_key_set_is_the_jax_scripts(lines):
    run, port, jax = lines
    expected = BENCH_SERVING_KEYS | (BENCH_SERVING_ARM_KEYS if run == "arms" else set())
    assert set(jax) == expected, sorted(set(jax) ^ expected)
    assert set(port) == set(jax), sorted(set(port) ^ set(jax))


@pytest.mark.parametrize("key", ["metric", "model", "strategy", "precision", "unit", "n_way", "k_shot", "n_query",
                                 "micro_batch", "remat_policy", "tenants", "replicas"])
def test_the_fields_are_the_jax_scripts(lines, key):
    _, port, jax = lines
    assert port[key] == jax[key]


def test_the_compile_counts_are_the_jax_engines(lines):
    """The same count keys (the port adds B1's launch count, 0 off the
    card and at the recipe's defaults) and the same programs, prewarmed
    as JAX prewarms them."""
    _, port, jax = lines
    counts, jcounts = port["compiled"], jax["compiled"]
    assert set(counts) - PORT_COUNT_KEYS == set(jcounts)
    assert counts["fused_sgd_launches"] == 0
    for key in ("adapt_programs", "predict_programs", "refine_programs", "precision", "strategies", "tenants"):
        assert counts.get(key) == jcounts.get(key)
    assert set(counts["compile_ledger"]["by_program"]) == set(jcounts["compile_ledger"]["by_program"])
    assert port["prewarm"]["programs"] == jax["prewarm"]["programs"] == counts["compile_ledger"]["entries"]
    assert set(port["phase_breakdown"]) == set(jax["phase_breakdown"])


#: the tiny engine's model: 28x28x1 Omniglot images, 2 stages of 3x3
#: convolutions with 4 filters and 2x2 pooling, a 5-way head
TINY_IMG, TINY_FILTERS, TINY_WAY = (28, 28, 1), 4, 5
#: XLA's cost analysis counts the elementwise ops (batch norm, activations,
#: pooling), the flop counter only convolutions and matmuls: at 4 filters
#: JAX's count per query is 1.435 x the port's (measured on the CPU)
JAX_OVER_PORT_FLOPS = (1.3, 1.6)


def _tiny_predict_flops():
    """2 x the multiply-adds of one query through the tiny VGG."""
    h, w, c = TINY_IMG
    macs = h * w * c * TINY_FILTERS * 9  # stage 0 at 28x28
    macs += (h // 2) * (w // 2) * TINY_FILTERS * TINY_FILTERS * 9  # stage 1 at 14x14
    macs += (h // 4) * (w // 4) * TINY_FILTERS * TINY_WAY  # the head on 4 x 7 x 7 features
    return 2 * macs


def test_the_line_is_measured(lines):
    run, port, jax = lines
    assert port["value"] > 0 and port["platform"] == "cpu"
    assert port["mfu"] is None  # no CPU peak
    # mfu's numerator: the convolutions and the head of one query, and JAX's
    # count above it by the elementwise ops only
    assert port["predict_flops_per_query"] == _tiny_predict_flops()
    ratio = jax["predict_flops_per_query"] / port["predict_flops_per_query"]
    assert JAX_OVER_PORT_FLOPS[0] < ratio < JAX_OVER_PORT_FLOPS[1], ratio
    if run == "arms":
        assert port["refine_reps"] == 1 and port["refine_p50_ms"] > 0 and port["page_in_p50_ms"] is not None


def test_the_autoscale_cycle_reports_its_timings():
    """BENCH_AUTOSCALE=1 runs the port's fleet-surge drill (a gateway,
    backends and the supervisor in processes of their own, on the CPU
    here) and lifts its control-plane timings into the line."""
    out = subprocess.run([sys.executable, "-m", MODULE, "--tiny", "--device", "cpu", *REPS], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env={**ENV, "BENCH_AUTOSCALE": "1", "BENCH_SLO_DURATION_S": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    d = _only_json_line(out.stdout)
    assert set(d) == BENCH_SERVING_KEYS
    assert d["scale_up_settle_s"] > 0 and d["surge_recovery_s"] > 0, out.stderr[-2000:]


@pytest.fixture
def served_frontend():
    """A tiny port engine on the CPU behind the HTTP server, in this
    process: the external target ``--url`` drives."""
    cfg = Config(num_classes_per_set=5, num_samples_per_class=1, num_target_samples=3,
                 serving=ServingConfig(support_buckets=[5], query_buckets=[15], max_batch_size=8))
    system = MAMLSystem(cfg, model=build_vgg((28, 28, 1), 5, num_stages=2, cnn_num_filters=4), device="cpu")
    frontend = ServingFrontend(AdaptationEngine(system, system.init_train_state()))
    server = make_http_server(frontend)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        frontend.close()


def test_url_drives_a_running_frontend(served_frontend):
    out = subprocess.run([sys.executable, "-m", MODULE, "--url", served_frontend], capture_output=True, text=True,
                         timeout=120, cwd=REPO, env={**ENV, "BENCH_SLO_DURATION_S": "1", "BENCH_SLO_STAIRS": "8"})
    assert out.returncode == 0, out.stderr[-3000:]
    d = _only_json_line(out.stdout)
    assert d["metric"].endswith("_gateway_5w1s") and d["platform"] == "external" and d["target"] == served_frontend
    assert d["per_backend"] and sum(sum(row.values()) for row in d["per_backend"].values()) > 0
    assert np.isfinite(d["wall_s"])
