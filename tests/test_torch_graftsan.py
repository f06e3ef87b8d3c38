"""The lock-discipline sanitizer (``tools/graftsan``) over the port, on the
CPU: the drills of ``tests/test_graftsan.py`` against the port's lock
factory, engine replica, pager, frontend and campaign, and the wiring this
package adds (the runner and the frontend arm it; the gateway and the
autoscaler build their locks through it).

- seeded fixtures are caught deterministically: an ABBA cycle through the
  port's ``utils/locks.py`` factory, a dispatch through a port
  ``EngineReplica`` under a held lock, the declared-order inversion of the
  port's own ``WeightPager`` and ``TenantRegistry`` locks, a thread leaked
  past a port frontend's ``close()``;
- the port's tree is clean: the pager's page-in holds no lock across the
  registry (nor across the card sync), a sanitized 2-episode campaign, an
  armed runner and an armed frontend log zero ``graftsan_violation``;
- off means off: plain stdlib primitives, and the campaign leaves no
  sanitizer block and no ``graftsan.jsonl`` (``test_torch_chaos.py``).

One sanitizer state serves the whole process (the JAX tests share it), so
every test that arms it disarms and resets it on the way out.
"""

import importlib.util
import json
import os
import threading

import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core.train_state import TrainState
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import (
    _serve_config,
    _serve_episode_data,
    run_campaign,
    tiny_serving_system,
)
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
from howtotrainyourmamlpytorch_tpu_torch.serving.registry import TenantRegistry
from howtotrainyourmamlpytorch_tpu_torch.serving.server import ServingFrontend
from howtotrainyourmamlpytorch_tpu_torch.serving.tenancy import WeightPager
from howtotrainyourmamlpytorch_tpu_torch.utils import locks

from tools.graftsan import runtime

from tests.test_torch_runner import runner_config, small_system, toy_dataset  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def armed():
    runtime.arm()
    runtime.reset()
    yield runtime
    runtime.disarm()
    runtime.reset()


def _kinds(rt):
    return [v["kind"] for v in rt.violations()]


def _graftsan_events(logs_dir):
    path = os.path.join(logs_dir, "events.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [e for e in map(json.loads, filter(str.strip, f)) if e.get("event") == "graftsan_violation"]


def _frontend(sanitizer: bool = False, **kw):
    system = tiny_serving_system(_serve_config(resilience=tcfg.ResilienceConfig(sanitizer=sanitizer)), "cpu")
    return ServingFrontend(AdaptationEngine(system, system.init_train_state(1)), **kw)


# -- seeded fixtures: caught, deterministically -----------------------------


def test_abba_cycle_is_caught_without_contention(armed):
    """A then B, later B then A, through the port's lock factory: the cycle
    is flagged on the second edge's insert with both stacks, once."""
    a = locks.san_lock("FixtureA._lock")
    b = locks.san_lock("FixtureB._lock")
    assert isinstance(a, runtime.SanLock)
    for _ in range(2):
        with a:
            with b:
                pass
        with b:
            with a:
                pass
    cycles = [v for v in armed.violations() if v["kind"] == "lock_order_cycle"]
    assert len(cycles) == 1, armed.violations()
    assert {cycles[0]["site_a"], cycles[0]["site_b"]} == {"FixtureA._lock", "FixtureB._lock"}
    assert cycles[0]["stack_b"] and cycles[0]["reverse_edges"][0]["stack"]
    assert cycles[0]["event"] == "graftsan_violation"


def test_held_across_dispatch_is_caught_via_the_replica_seam(armed):
    """A port ``EngineReplica.dispatch`` entered while holding an
    instrumented lock: its ``note_blocking`` seam reports it (and the
    future's patched ``result`` too); the same dispatch with nothing held
    is clean."""
    frontend = _frontend()
    try:
        x_s, y_s, _ = _serve_episode_data(5)
        replica = frontend.pool.replicas[0]
        group = frontend._group("maml++", frontend.engine.support_bucket(x_s.size // (28 * 28)), None)
        replica.dispatch(replica.adapt_batcher, group, (x_s.reshape(-1, 28, 28, 1), y_s.reshape(-1)))
        assert "held_across_blocking" not in _kinds(armed)
        lock = locks.san_lock("FixtureC._lock")
        with lock:
            replica.dispatch(replica.adapt_batcher, group, (x_s.reshape(-1, 28, 28, 1), y_s.reshape(-1)))
    finally:
        frontend.close()
    held = [v for v in armed.violations() if v["kind"] == "held_across_blocking"]
    assert held and all("FixtureC._lock" in v["held"] for v in held), armed.violations()
    assert {v["blocking"] for v in held} >= {"EngineReplica.dispatch", "Future.result"}


def test_declared_order_inversion_is_caught(armed, tmp_path):
    """order.toml ranks the registry before the pager: taking the port
    registry's lock under the port pager's is an inversion with no reverse
    edge recorded yet."""
    registry = TenantRegistry({"acme": {"run_dir": str(tmp_path)}})
    pager = WeightPager(registry, template=None)
    assert isinstance(pager._lock, runtime.SanLock) and isinstance(registry._lock, runtime.SanLock)
    with pager._lock:
        with registry._lock:
            pass
    inversions = [v for v in armed.violations() if v["kind"] == "lock_order_inversion"]
    assert inversions and inversions[0]["site_a"] == "WeightPager._lock", armed.violations()
    assert inversions[0]["site_b"] == "TenantRegistry._lock"


def test_thread_leak_audit_names_the_leak(armed):
    """A non-daemon thread started after a port frontend was built and
    still alive at its ``close()``: the close audit names it."""
    frontend = _frontend(sanitizer=True)
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="leaky-fixture")
    t.start()
    try:
        frontend.close()
        leaks = [v for v in armed.violations() if v["kind"] == "thread_leak"]
        assert leaks and "leaky-fixture" in leaks[0]["threads"], armed.violations()
        assert leaks[0]["context"] == "ServingFrontend.close"
    finally:
        stop.set()
        t.join()
    # joined threads are not leaks
    baseline = {x.ident for x in threading.enumerate()}
    assert armed.audit_thread_leaks("after-join", baseline=baseline) == []


# -- the port's tree: clean under the armed sanitizer -----------------------


def test_weight_pager_page_in_holds_no_lock_across_registry(armed):
    """The port pager fetches the host master outside its lock (the JAX
    package's GL210 repair) and copies it to the device outside it too: a
    registry-locking fake stays inversion-free and no blocking call is
    noted under a lock; the old shape still trips."""

    class FakeRegistry:
        def __init__(self):
            self._lock = locks.san_lock("TenantRegistry._lock")

        def host_state(self, tenant):
            with self._lock:
                w = torch.ones((2, 2))
                return TrainState(params={"w": w}, bn_state={}, inner_hparams={}, opt_state=None,
                                  step=torch.zeros((), dtype=torch.int64)), {"tenant": tenant}

    pager = WeightPager(FakeRegistry(), template=None)
    state = pager.resident("acme")
    assert state is not None and pager.page_ins == 1
    assert pager.resident("acme") is state  # the hit path, still clean
    assert armed.violations() == []
    with pager._lock:  # the pre-repair shape: the registry under the pager
        pager.registry.host_state("evil")
    assert "lock_order_inversion" in _kinds(armed)


def test_sanitized_mini_campaign_reports_zero_violations(toy_dataset, tmp_path):  # noqa: F811
    """A seeded in-process campaign with ``sanitize=True`` on the CPU: a
    zero-violation sanitizer block, the caller's environment restored and
    the sanitizer disarmed on the way out."""
    try:
        verdict = run_campaign(str(tmp_path), episodes=2, seed=0, data_root=toy_dataset, include_subprocess=False,
                               sanitize=True, log=lambda m: None, device="cpu")
        assert verdict["ok"], verdict["violations"]
        san = verdict["sanitizer"]
        assert san["armed"] is True
        assert san["violations"] == 0 and san["by_kind"] == {} and san["torn_lines"] == 0, san
        assert san["log"] == os.path.join(str(tmp_path), "graftsan.jsonl")
        assert os.environ.get("HTYMP_GRAFTSAN") != "1"
        assert "HTYMP_GRAFTSAN_LOG" not in os.environ
        assert not runtime.enabled()
    finally:
        runtime.disarm()
        runtime.reset()


def test_sanitized_campaign_folds_a_finding_into_the_verdict(toy_dataset, tmp_path, monkeypatch):  # noqa: F811
    """A finding recorded while the campaign is armed (here a seeded ABBA
    inside a serve episode) lands in the log and fails the verdict."""
    from howtotrainyourmamlpytorch_tpu_torch.resilience import campaign

    real = campaign._run_serve_episode

    def with_abba(ep, device="cuda"):
        a, b = locks.san_lock("SeedA._lock"), locks.san_lock("SeedB._lock")
        with a, b:
            pass
        with b, a:
            pass
        return real(ep, device)

    monkeypatch.setattr(campaign, "_run_serve_episode", with_abba)
    try:
        verdict = run_campaign(str(tmp_path), episodes=2, seed=0, data_root=toy_dataset, include_subprocess=False,
                               sanitize=True, log=lambda m: None, device="cpu")
    finally:
        runtime.disarm()
        runtime.reset()
    assert not verdict["ok"] and verdict["sanitizer"]["by_kind"] == {"lock_order_cycle": 1}
    assert [v["kind"] for v in verdict["violations"]] == ["graftsan"]
    assert verdict["violations"][0]["violation"].startswith("graftsan lock_order_cycle: ")


def test_armed_runner_logs_no_violation(toy_dataset, tmp_path):  # noqa: F811
    """``resilience.sanitizer`` arms the runner before its loader and
    watchdog build their locks, and adds the run's events.jsonl as a sink:
    one epoch on the CPU logs zero ``graftsan_violation`` events."""
    try:
        cfg = runner_config(toy_dataset, tmp_path, total_epochs=1, total_iter_per_epoch=2,
                            resilience=tcfg.ResilienceConfig(sanitizer=True))
        runner = ExperimentRunner(cfg, system=small_system(cfg))
        # armed before the watchdog built its lock, with the run's events
        # log as a sink
        assert runtime.enabled() and isinstance(runner._watchdog._lock, runtime.SanLock)
        assert runner.events.append in runtime._state.sinks
        runner.run_experiment()
        assert runtime.violations() == []
        assert _graftsan_events(runner.logs_dir) == []
    finally:
        runtime.disarm()
        runtime.reset()


def test_armed_frontend_close_audits_zero_leaks(tmp_path):
    """``resilience.sanitizer`` on a port frontend: its locks are
    instrumented, its findings land in events.jsonl, and a normal close
    (batchers and watchdogs joined) audits zero leaks."""
    try:
        system = tiny_serving_system(_serve_config(resilience=tcfg.ResilienceConfig(sanitizer=True)), "cpu")
        frontend = ServingFrontend(AdaptationEngine(system, system.init_train_state(1)),
                                   access_log_dir=str(tmp_path))
        assert isinstance(frontend._drain_lock, runtime.SanLock) and frontend._graftsan is runtime
        x_s, y_s, x_q = _serve_episode_data(9)
        frontend.predict(frontend.adapt(x_s, y_s)["adaptation_id"], x_q)
        frontend.close()
        assert runtime.violations() == []
        assert _graftsan_events(str(tmp_path)) == []
    finally:
        runtime.disarm()
        runtime.reset()


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("how", ["package", "by_path"])
def test_gateway_and_autoscaler_locks_are_instrumented_when_armed(armed, tmp_path, how):
    """The gateway's and the supervisor's locks are built through
    ``san_lock`` (JAX's site names), imported as package modules or loaded
    by file path as the import-light CLIs load them."""
    if how == "package":
        from howtotrainyourmamlpytorch_tpu_torch.serving import autoscaler, gateway
    else:
        gateway = _load("t_graftsan_gateway", "howtotrainyourmamlpytorch_tpu_torch/serving/gateway.py")
        autoscaler = _load("t_graftsan_autoscaler", "howtotrainyourmamlpytorch_tpu_torch/serving/autoscaler.py")
    gw = gateway.Gateway(["http://127.0.0.1:9"], log_dir=str(tmp_path / "gw"))
    try:
        sites = {gw._lock.site, gw.backends[0]._lock.site, gw.access._lock.site}
        assert sites == {"Gateway._lock", "Backend._lock", "_JsonlLog._lock"}
    finally:
        gw.close()
    sup = autoscaler.Supervisor(str(tmp_path / "fleet_state.json"), autoscaler.Policy(), None,
                                log=lambda m: None)
    assert (sup._lock.site, sup._events_lock.site) == ("Supervisor._lock", "Supervisor._events_lock")


# -- off means off ----------------------------------------------------------


def test_sanitizer_off_hands_out_plain_stdlib_primitives(monkeypatch, tmp_path):
    monkeypatch.delenv("HTYMP_GRAFTSAN", raising=False)
    runtime.disarm()
    assert not runtime.enabled() and locks.GRAFTSAN_AVAILABLE
    assert type(locks.san_lock("Y._lock")) is type(threading.Lock())
    assert type(locks.san_rlock("Y._rlock")) is type(threading.RLock())
    assert type(locks.san_condition("Y._cond")) is threading.Condition
    locks.note_blocking("Y.dispatch")  # a no-op: records nothing
    frontend = _frontend()
    try:
        assert frontend._graftsan is None and type(frontend._drain_lock) is type(threading.Lock())
    finally:
        frontend.close()
    from howtotrainyourmamlpytorch_tpu_torch.serving import gateway

    gw = gateway.Gateway(["http://127.0.0.1:9"], log_dir=str(tmp_path / "gw"))
    try:
        assert type(gw._lock) is type(threading.Lock())
    finally:
        gw.close()
    assert runtime.violations() == []
