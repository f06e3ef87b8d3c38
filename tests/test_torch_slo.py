"""The port's SLO load harness (``observability/slo.py``) and its loadgen
CLI (``python -m howtotrainyourmamlpytorch_tpu_torch.loadgen``) against
the JAX package's, on the CPU:

- ``generate_schedule`` and ``schedule_digest`` equal to JAX's for the same
  seed and arguments (tenants and refine traffic included);
- ``--print-schedule`` bit-identical to JAX's ``scripts/loadgen.py``;
- ``slo_report`` equal to JAX's on the same outcome rows, and its schema;
- ``run_load`` against a tiny port frontend (``tests/test_perf_obs.py``'s
  cases but the AOT one): every scheduled request has an outcome, warmup
  excluded and covering every (bucket x task-batch) shape, latencies from
  the scheduled arrival, an unresolved request costing only its grace;
- the CLI end to end on the CPU, and refusing to fall back to the CPU
  without ``--device cpu``.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from howtotrainyourmamlpytorch_tpu.observability import slo as jax_slo
from howtotrainyourmamlpytorch_tpu_torch import loadgen
from howtotrainyourmamlpytorch_tpu_torch.config import Config, ServingConfig
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.observability import slo
from howtotrainyourmamlpytorch_tpu_torch.serving import AdaptationEngine, ServingFrontend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = (28, 28, 1)

SCHEDULES = {
    "plain": dict(duration_s=30.0, stairs_rps=[2.0, 4.0, 8.0], adapt_frac=0.3),
    "tenants": dict(duration_s=12.0, stairs_rps=[5.0, 10.0], tenants=["t0", "t1", "t2"],
                    tenant_weights=[1.0, 0.5, 0.25]),
    "refine": dict(duration_s=10.0, stairs_rps=[6.0], adapt_frac=0.2, refine_frac=0.3,
                   query_sizes=(5, 10), query_weights=(0.8, 0.2)),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_and_digest_match_jax(name, seed):
    ours = slo.generate_schedule(seed, **SCHEDULES[name])
    theirs = jax_slo.generate_schedule(seed, **SCHEDULES[name])
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in theirs]
    assert slo.schedule_digest(ours) == jax_slo.schedule_digest(theirs)
    assert ours == slo.generate_schedule(seed, **SCHEDULES[name])  # same seed, bit-identical
    assert ours != slo.generate_schedule(seed + 1, **SCHEDULES[name])


def test_schedule_shape():
    a = slo.generate_schedule(7, duration_s=30.0, stairs_rps=[2.0, 4.0, 8.0], adapt_frac=0.3)
    times = [r.t for r in a]
    assert times == sorted(times)
    for r in a:
        assert r.stair * 10.0 <= r.t < (r.stair + 1) * 10.0
        assert r.kind in ("adapt", "predict") and r.n_query in (5, 15, 40)
    for bad in (dict(stairs_rps=[]), dict(duration_s=0.0), dict(stairs_rps=[0.0]),
                dict(adapt_frac=0.8, refine_frac=0.3)):
        kw = {"duration_s": 5.0, "stairs_rps": [2.0], **bad}
        with pytest.raises(ValueError):
            slo.generate_schedule(0, **kw)


def _load_jax_loadgen():
    spec = importlib.util.spec_from_file_location("t_jax_loadgen", os.path.join(REPO, "scripts", "loadgen.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_profile_and_tenant_skew_match_jax():
    jlg = _load_jax_loadgen()
    for stairs, text in (([4.0, 8.0, 16.0], None), ([4.0, 8.0, 16.0], "diurnal"), ([4.0], "diurnal"),
                         ([4.0, 8.0, 16.0], "surge:3")):
        assert loadgen._apply_profile(list(stairs), text) == jlg._apply_profile(list(stairs), text)
    for junk in ("weird", "surge:", "surge:0", "SURGE:3"):
        with pytest.raises(SystemExit):
            loadgen._apply_profile([4.0], junk)
    for text, n in (("uniform", 3), ("zipf:1.2", 4), ("zipf:0", 2), ("uniform", 0)):
        assert loadgen._parse_tenant_skew(text, n) == jlg._parse_tenant_skew(text, n)
    with pytest.raises(SystemExit):
        loadgen._parse_tenant_skew("zipf:x", 3)


@pytest.mark.parametrize("extra", [[], ["--profile", "surge:3", "--tenants", "3", "--tenant-skew", "zipf:1.1",
                                        "--refine-frac", "0.1", "--seed", "5"]])
def test_print_schedule_is_bit_identical_to_jax(extra):
    args = ["--duration-s", "5", "--print-schedule", *extra]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    theirs = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "loadgen.py"), *args],
                            cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    ours = subprocess.run([sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.loadgen", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert theirs.returncode == 0, theirs.stderr
    assert ours.returncode == 0, ours.stderr
    assert len(ours.stdout.strip().splitlines()) == 1  # exactly one line
    assert ours.stdout == theirs.stdout
    payload = json.loads(ours.stdout)
    assert payload["digest"]["n"] == len(payload["schedule"]) > 0


def _rows(schedule):
    rows = []
    for r in schedule:  # stair 0 healthy, stair 1 drowning: half shed, slow p99
        if r.stair == 0:
            rows.append({"stair": 0, "kind": r.kind, "outcome": "ok", "latency_ms": 10.0, "trace_id": f"a{len(rows)}"})
        else:
            outcome = "shed" if len(rows) % 2 else "ok"
            rows.append({"stair": 1, "kind": r.kind, "outcome": outcome, "latency_ms": 900.0 + len(rows),
                         "trace_id": f"b{len(rows)}"})
    return rows


def test_slo_report_matches_jax_and_schema():
    stairs = [2.0, 4.0]
    schedule = slo.generate_schedule(3, 10.0, stairs)
    run = {"rows": _rows(schedule), "wall_s": 10.0, "breaker_trips": 1, "breaker": {"opens": 1},
           "unresolved_by_stair": {1: 1}}
    kw = dict(stairs_rps=stairs, duration_s=10.0, seed=3, slo_p99_ms=500.0, max_shed_rate=0.05,
              metric_suffix="_5w1s", model="x", target="http://gw")
    report = slo.slo_report(schedule, run, **kw)
    assert report == jax_slo.slo_report(jax_slo.generate_schedule(3, 10.0, stairs), run, **kw)
    assert report["metric"] == "serving_slo_sustained_rps_5w1s"
    assert report["unit"] == "req/s within SLO" and report["vs_baseline"] is None
    assert report["value"] == 2.0  # only the healthy stair met the SLO
    s0, s1 = report["stairs"]
    assert s0["slo_met"] and not s1["slo_met"] and s1["unresolved"] == 1
    assert s0["p99_ms"] == 10.0 and s0["shed_rate"] == 0.0
    assert s1["shed"] > 0 and len(s1["worst_requests"]) == slo.DEFAULT_WORST_K
    assert report["requests"] == len(schedule) + 1
    assert report["model"] == "x" and report["target"] == "http://gw"
    json.dumps(report)  # one-line contract: everything serializes


def _tiny_frontend(**serving):
    cfg = Config(num_classes_per_set=5, num_samples_per_class=1, num_target_samples=2,
                 serving=ServingConfig(support_buckets=[5], query_buckets=[5, 10], **serving))
    system = MAMLSystem(cfg, model=build_vgg(IMG, 5, num_stages=2, cnn_num_filters=4), device="cpu")
    return ServingFrontend(AdaptationEngine(system, system.init_train_state()))


def _make_support(seed):
    b = synthetic_batch(1, 5, 1, 2, IMG, seed & 0x7FFFFFFF)
    return b["x_support"][0], b["y_support"][0]


def _make_query(seed, n_query):
    b = synthetic_batch(1, 5, 1, 2, IMG, seed & 0x7FFFFFFF)
    return b["x_target"][0].reshape((-1,) + IMG)[:n_query]


def test_run_load_against_tiny_frontend():
    """A real port ServingFrontend under a short open-loop schedule:
    outcomes for every scheduled request, warmup excluded, and the warmup
    dispatched every (bucket x task-batch bucket) shape the batched
    flushes can hit before the clock started."""
    frontend = _tiny_frontend(max_batch_size=4)
    schedule = slo.generate_schedule(0, 1.5, [4.0], adapt_frac=0.3, query_sizes=(5, 10), query_weights=(0.8, 0.2))
    logs = []
    try:
        run = slo.run_load(frontend, schedule, _make_support, _make_query, log=logs.append)
    finally:
        frontend.close()
    assert len(run["rows"]) == len(schedule)
    assert all(r["outcome"] in ("ok", "shed", "deadline", "error") for r in run["rows"])
    assert sum(1 for r in run["rows"] if r["outcome"] == "ok") >= 1
    assert run["breaker_trips"] == 0 and run["unresolved"] == 0
    engine = frontend.engine
    for b in (1, 2, 4):
        assert ("maml++", 5, b) in engine._adapt_programs
        for n_query in {r.n_query for r in schedule}:
            assert ("maml++", min(q for q in (5, 10) if q >= n_query), b) in engine._predict_programs
    assert any(m.startswith("loadgen: prewarmed") for m in logs), logs
    report = slo.slo_report(schedule, run, stairs_rps=[4.0], duration_s=1.5, seed=0, slo_p99_ms=30_000.0,
                            max_shed_rate=1.0)
    assert report["requests"] == len(schedule)


def test_run_load_with_refines_and_replicas():
    """Refine traffic against a refine-enabled frontend with two replicas:
    the warm refine runs before the clock, and the report carries the
    per-replica story."""
    frontend = _tiny_frontend(refine_enabled=True, refine_regress_tol=100.0, replicas=2)
    schedule = slo.generate_schedule(1, 1.5, [6.0], adapt_frac=0.3, refine_frac=0.3, query_sizes=(5,),
                                     query_weights=(1.0,))
    assert any(r.kind == "refine" for r in schedule)
    try:
        run = slo.run_load(frontend, schedule, _make_support, _make_query)
    finally:
        frontend.close()
    assert len(run["rows"]) == len(schedule) and len(run["replicas"]) == 2
    assert all(r["outcome"] == "ok" for r in run["rows"]), run["rows"]
    report = slo.slo_report(schedule, run, stairs_rps=[6.0], duration_s=1.5, seed=1, slo_p99_ms=30_000.0,
                            max_shed_rate=1.0)
    assert report["replicas"] == 2 and len(report["per_replica"]) == 2


def test_run_load_empty_schedule_raises():
    with pytest.raises(ValueError, match="schedule is empty"):
        slo.run_load(None, [], lambda s: None, lambda s, n: None)


class _Breaker:
    def snapshot(self):
        return {"opens": 0}


class _StubReplica:
    """A pool member: its own breaker, its stats."""

    def __init__(self, breaker_cls):
        self.breaker = breaker_cls(failure_threshold=1)

    def stats(self):
        return {"breaker": self.breaker.snapshot()}


@pytest.mark.parametrize("side", ["port", "jax"])
def test_breaker_trips_count_every_replica(side):
    """A pool of two replicas in which only replica 1's breaker opens during
    the run: ``breaker_trips`` counts it, through
    ``EnginePool.breaker_opens``, in the port as in the JAX package; the
    frontend's own breaker (replica 0's) never opened."""
    if side == "port":
        from howtotrainyourmamlpytorch_tpu_torch.resilience.breaker import CircuitBreaker
        from howtotrainyourmamlpytorch_tpu_torch.serving.pool import EnginePool
        harness = slo
    else:
        from howtotrainyourmamlpytorch_tpu.resilience.breaker import CircuitBreaker
        from howtotrainyourmamlpytorch_tpu.serving.pool import EnginePool
        harness = jax_slo
    pool = EnginePool([_StubReplica(CircuitBreaker), _StubReplica(CircuitBreaker)])

    class PoolFrontend:
        breaker = pool.replicas[0].breaker

        def __init__(self):
            self.pool = pool

        def adapt(self, x, y):
            return {"adaptation_id": "warm"}

        def predict(self, aid, xq):
            if timed.is_set():  # the scheduled request, not the warmup's
                pool.replicas[1].breaker.record_failure()

    timed = threading.Event()
    schedule = [harness.Request(t=0.0, kind="predict", episode_seed=0, n_query=5, stair=0)]
    run = harness.run_load(PoolFrontend(), schedule, lambda s: (None, None), lambda s, n: None,
                           warm_adaptations=1, max_workers=1,
                           log=lambda m: timed.set() if m.startswith("loadgen: warm") else None)
    assert pool.breaker_opens() == 1
    assert run["breaker_trips"] == 1
    assert run["breaker"]["opens"] == 0 and len(run["replicas"]) == 2


def test_run_load_latency_counts_queue_wait_from_scheduled_arrival():
    """With one worker and a slow backend, the second request's latency
    includes the time it queued behind the first (measured from its
    scheduled arrival, not worker pickup)."""

    class SlowFrontend:
        breaker = _Breaker()

        def adapt(self, x, y):
            return {"adaptation_id": "warm"}

        def predict(self, aid, xq):
            time.sleep(0.25)

    schedule = [slo.Request(t=0.0, kind="predict", episode_seed=0, n_query=5, stair=0),
                slo.Request(t=0.01, kind="predict", episode_seed=1, n_query=5, stair=0)]
    run = slo.run_load(SlowFrontend(), schedule, lambda s: (None, None), lambda s, n: None, warm_adaptations=1,
                       max_workers=1)
    lat = sorted(r["latency_ms"] for r in run["rows"])
    assert lat[0] >= 200 and lat[1] >= 400


def test_run_load_unresolved_request_costs_grace_not_report():
    hang = threading.Event()

    class WedgedFrontend:
        breaker = _Breaker()
        predicts = 0

        def adapt(self, x, y):
            return {"adaptation_id": "warm"}

        def predict(self, aid, xq):
            self.predicts += 1
            if self.predicts > 1:  # the warmup predict passes; measured traffic wedges
                hang.wait(timeout=30.0)

    schedule = [slo.Request(t=0.0, kind="predict", episode_seed=0, n_query=5, stair=0)]
    try:
        run = slo.run_load(WedgedFrontend(), schedule, lambda s: (None, None), lambda s, n: None,
                           warm_adaptations=1, max_workers=1, result_grace_s=0.5)
    finally:
        hang.set()
    assert run["unresolved"] == 1 and run["unresolved_by_stair"] == {0: 1}
    report = slo.slo_report(schedule, run, stairs_rps=[1.0], duration_s=1.0, seed=0, slo_p99_ms=1000.0,
                            max_shed_rate=0.5)
    assert report["unresolved"] == 1 and not report["stairs"][0]["slo_met"] and report["value"] is None


def test_loadgen_cli_in_process_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.loadgen", "--device", "cpu", "--tiny",
         "--duration-s", "2", "--stairs", "4", "--refine-frac", "0.1", "--access-log-dir", str(tmp_path / "logs")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    report = json.loads(lines[0])
    assert report["platform"] == "cpu" and report["model"] == "vgg2x4" and report["requests"] > 0
    assert report["ok"] == report["requests"] and report["refine_frac"] == 0.1
    assert report["schedule_digest"]["n"] == report["requests"]
    assert os.path.exists(report["access_log"]["path"]) and os.path.exists(report["trace_path"])


def test_loadgen_cli_never_falls_back_to_the_cpu(tmp_path):
    """Without ``--device cpu`` the in-process engine is the CUDA card: with
    none visible the run fails before any load, naming the flag."""
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.loadgen", "--duration-s", "2"],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "device='cpu'" in proc.stderr
