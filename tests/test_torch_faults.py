"""The port's fault injector against the JAX package's, on the CPU.

- The fire decisions (``nth``, ``times``/``after``, the seeded ``p``, the
  kinds and their side effects, ``fire_bytes``) call for call equal to
  JAX's ``resilience/faults.py`` for the same specs and seed.
- The serving seams (``serving.dispatch``, ``serving.refine``,
  ``serving.http``): a ``delay``, ``raise`` or ``nan-loss`` at each shows
  in ``/metrics`` as ``injected_faults`` with the counts JAX's frontend
  reports for the same requests, and the poisoned refinement is rolled
  back as JAX's guard rolls it back.
- ``injector_from``: a spec at a training seam the port does not fire yet
  (``runner.step``, ``checkpoint.read``, ``checkpoint.write``) raises
  ``NotImplementedError`` naming ROADMAP A9, from the config and from
  ``HTYMP_FAULTS``; the loader seam fires in the runner's loader.
"""

import json
import os
import threading

import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.resilience import faults as jfaults
from howtotrainyourmamlpytorch_tpu.serving import ServingFrontend as JaxFrontend
from howtotrainyourmamlpytorch_tpu.serving.engine import AdaptationEngine as JaxEngine
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.resilience import faults
from howtotrainyourmamlpytorch_tpu_torch.serving import AdaptationEngine, ServingFrontend, make_http_server

from tests.test_torch_runner import runner_config, small_system, toy_dataset  # noqa: F401
from tests.test_torch_serving import _cfg, _status, episode, port_system, weights  # noqa: F401

SPEC_SETS = {
    "nth": ["serving.dispatch=raise:nth=3", "serving.http=delay:nth=1,delay_s=0.5"],
    "burst": ["serving.dispatch=delay:after=2,times=3,delay_s=0.25"],
    "p": ["serving.dispatch=raise:p=0.3", "serving.refine=nan-loss:p=0.5", "loader.episode=raise:p=0.2"],
    "mixed": ["serving.refine=nan-loss:nth=2", "serving.refine=delay:p=0.4,delay_s=0.1",
              "serving.http=sigterm:nth=4", "checkpoint.read=corrupt-bytes:times=2"],
}
SITES = ("serving.dispatch", "serving.refine", "serving.http", "loader.episode", "checkpoint.read")


def _trace(module, specs, seed, calls=40):
    """Every call's outcome at every site, the sleeps and kills, and the
    stats of an injector of ``module`` over ``specs``."""
    sleeps, kills = [], []
    inj = module.FaultInjector.from_specs(specs, seed=seed, include_env=False, sleep=sleeps.append,
                                          kill=lambda pid, sig: kills.append(int(sig)))
    out = []
    for i in range(calls):
        site = SITES[i % len(SITES)]
        try:
            if site == "checkpoint.read":
                out.append(inj.fire_bytes(site, bytes(range(64))))
            else:
                out.append(inj.fire(site))
        except module.InjectedFault as exc:
            out.append(f"raised: {exc}")
    return out, sleeps, kills, inj.stats()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(SPEC_SETS))
def test_fire_decisions_match_jax(name, seed):
    got = _trace(faults, SPEC_SETS[name], seed)
    want = _trace(jfaults, SPEC_SETS[name], seed)
    assert got == want
    assert got[3], "the spec set fired nothing"


def test_spec_grammar_matches_jax():
    for text in ("serving.dispatch=raise:nth=2,p=0.5", "loader.episode=delay:delay_s=1.5,after=3,times=2"):
        assert vars(faults.FaultSpec.parse(text)) == vars(jfaults.FaultSpec.parse(text))
    for bad in ("serving.dispatch", "serving.dispatch=explode", "serving.dispatch=raise:q=1",
                "serving.dispatch=raise:p=2"):
        with pytest.raises(ValueError):
            faults.FaultSpec.parse(bad)
        with pytest.raises(ValueError):
            jfaults.FaultSpec.parse(bad)
    assert faults.KINDS == jfaults.KINDS
    assert set(faults.UNWIRED_SEAMS) < set(jfaults.SEAMS)


def test_null_injector_is_inert():
    assert not faults.NULL_INJECTOR.enabled
    assert faults.NULL_INJECTOR.fire("serving.dispatch") is None
    assert faults.NULL_INJECTOR.fire_bytes("checkpoint.read", b"abc") == b"abc"
    assert faults.NULL_INJECTOR.stats() == {}


def test_injected_fault_is_an_os_error():
    assert issubclass(faults.InjectedFault, OSError)


@pytest.mark.parametrize("site", ["runner.step", "checkpoint.read", "checkpoint.write"])
def test_training_seams_raise_naming_a9(site, monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    spec = f"{site}=raise:nth=1"
    with pytest.raises(NotImplementedError, match="A9"):
        faults.injector_from(tcfg.ResilienceConfig(faults=[spec]))
    monkeypatch.setenv(faults.ENV_VAR, f"serving.dispatch=delay:nth=1;{spec}")
    with pytest.raises(NotImplementedError, match="A9"):
        faults.injector_from(tcfg.ResilienceConfig())


def test_wired_seams_build_a_real_injector(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "serving.http=raise:nth=2")
    inj = faults.injector_from(tcfg.ResilienceConfig(faults=["serving.dispatch=delay:nth=1", "loader.episode=raise:nth=1"],
                                                     fault_seed=3))
    assert inj.enabled and inj.seed == 3
    assert sorted(inj._by_site) == ["loader.episode", "serving.dispatch", "serving.http"]
    monkeypatch.setenv(faults.ENV_VAR, "serving.http=bogus")
    with pytest.raises(ValueError, match="bad fault spec"):
        faults.injector_from(tcfg.ResilienceConfig())
    monkeypatch.delenv(faults.ENV_VAR)
    assert not faults.injector_from(tcfg.ResilienceConfig()).enabled


# ---------------------------------------------------------------------------
# the serving seams, in the frontends of both packages
# ---------------------------------------------------------------------------


def _frontends(weights, specs, **serving):
    """(JAX frontend, port frontend) over the same weights, each engine with
    an injector over ``specs`` and a recorded (not slept) delay."""
    jsystem, jstate, tstate = weights
    jinj = jfaults.FaultInjector.from_specs(specs, include_env=False, sleep=lambda s: None)
    inj = faults.FaultInjector.from_specs(specs, include_env=False, sleep=lambda s: None)
    jengine = JaxEngine(jsystem, jstate, serving_cfg=_cfg(jcfg, **serving).serving, injector=jinj)
    engine = AdaptationEngine(port_system(**serving), tstate, serving_cfg=_cfg(tcfg, **serving).serving,
                              injector=inj)
    return JaxFrontend(jengine), ServingFrontend(engine)


def test_dispatch_delay_and_raise_show_in_metrics_as_in_jax(weights):
    specs = ["serving.dispatch=delay:nth=1,delay_s=0.3", "serving.dispatch=raise:nth=3"]
    jfront, front = _frontends(weights, specs)
    try:
        x_s, y_s, x_q = episode(1)
        outcomes = []
        for f in (jfront, front):
            row = []
            info = f.adapt(x_s, y_s)  # dispatch call 1: delayed
            row.append(info["cached"])
            f.predict(info["adaptation_id"], x_q)  # call 2
            try:
                f.predict(info["adaptation_id"], x_q)  # call 3: raises
                row.append("ok")
            except Exception as exc:  # noqa: BLE001 — the outcome is compared
                row.append(type(exc).__name__)
            row.append(f.metrics()["resilience"]["injected_faults"])
            outcomes.append(row)
        assert outcomes[0] == outcomes[1]
        assert outcomes[1][-1] == {"serving.dispatch:delay": 1, "serving.dispatch:raise": 1}
        assert outcomes[1][1] != "ok"
    finally:
        front.close()
        jfront.close()


def test_refine_nan_loss_is_rolled_back_as_in_jax(weights):
    specs = ["serving.refine=nan-loss:nth=2"]
    jfront, front = _frontends(weights, specs, refine_enabled=True, refine_regress_tol=100.0)
    try:
        x_s, y_s, x_q = episode(2)
        rows = []
        for f in (jfront, front):
            sid = f.adapt(x_s, y_s)["adaptation_id"]
            first = f.refine(sid, x_s, y_s)  # refine call 1: commits
            before = np.asarray(f.predict(sid, x_q))
            second = f.refine(sid, x_s, y_s)  # call 2: poisoned, rolled back
            after = np.asarray(f.predict(sid, x_q))
            np.testing.assert_array_equal(after, before)  # the cache kept the good weights
            rows.append(((first["rolled_back"], first["refine_count"]),
                         (second["rolled_back"], second["refine_count"], second["score"]),
                         f.metrics()["resilience"]["injected_faults"]))
        assert rows[0] == rows[1]
        assert rows[1][1] == (True, 1, None) and rows[1][2] == {"serving.refine:nan-loss": 1}
    finally:
        front.close()
        jfront.close()


def test_http_seam_raise_is_a_500_and_counted(weights):
    specs = ["serving.http=raise:nth=1", "serving.http=delay:nth=2,delay_s=0.2"]
    _, front = _frontends(weights, specs)
    server = make_http_server(front, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        x_s, y_s, _ = episode(3)
        payload = {"x_support": x_s.tolist(), "y_support": y_s.tolist()}
        assert _status(base, "/adapt", payload) == 500  # the injected handler fault
        assert _status(base, "/adapt", payload) == 200  # delayed, then served
        from tests.test_torch_serving import _call

        injected = _call(base, "/metrics")["resilience"]["injected_faults"]
        assert injected == {"serving.http:raise": 1, "serving.http:delay": 1}
    finally:
        server.shutdown()
        server.server_close()
        front.close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_env_drill_reaches_the_engine(weights, monkeypatch):
    """A drill named in ``HTYMP_FAULTS`` arms the engine's seams (no config
    edit), as in the JAX package."""
    monkeypatch.setenv(faults.ENV_VAR, "serving.dispatch=delay:nth=1,delay_s=0.01")
    engine = AdaptationEngine(port_system(), weights[2])
    x_s, y_s, _ = episode(4)
    engine.adapt(x_s, y_s)
    assert engine.injector.stats() == {"serving.dispatch:delay": 1}


def test_loader_seam_fires_in_the_runner(toy_dataset, tmp_path):  # noqa: F811 — the runner tests' fixture
    """``loader.episode=raise`` reaches the runner's loader: the transient
    fault is retried (resilience.loader_io_retries) and the run finishes."""
    cfg = runner_config(toy_dataset, tmp_path, total_epochs=1, total_iter_per_epoch=2,
                        resilience=tcfg.ResilienceConfig(faults=["loader.episode=raise:nth=1"]))
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    runner.run_experiment()
    assert runner.loader.io_retries_used >= 1
    with open(os.path.join(cfg.run_dir(), "logs", "summary_statistics.csv")) as f:
        assert len(f.read().strip().splitlines()) == 2  # header + one epoch
    assert json.dumps(runner.loader.stats())
