"""The campaign's six in-process serve episodes on the CPU, and the HTTP
strategy menu of ``tests/test_strategies.py`` against the port's
frontend (the JAX weights carried into the port, its answers against the
JAX engine's at atol 1e-5, float32 on both sides as in
``test_torch_serving.py``): per-strategy cache isolation over HTTP, the
in-process menu defaults, the strategy table of the port's
``obs_report``, and the sealed prewarm over the strategy grid.
"""

import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.data.synthetic import synthetic_batch
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu.serving.engine import AdaptationEngine as JaxEngine
from howtotrainyourmamlpytorch_tpu.utils.strictmode import serving_planned_programs as jax_planned
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.observability.context import read_access_log
from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import Episode, _run_serve_episode
from howtotrainyourmamlpytorch_tpu_torch.serving import AdaptationEngine, ServingFrontend, make_http_server
from howtotrainyourmamlpytorch_tpu_torch.serving.errors import UnknownAdaptationError
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import state_from_jax
from howtotrainyourmamlpytorch_tpu_torch.utils.strictmode import (
    RecompileBudgetExceededError,
    serving_planned_programs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = (28, 28, 1)
ATOL = 1e-5
MENU = ["maml++", "protonet", "anil"]
SERVE_EPISODES = ["serve-dispatch-raise", "serve-dispatch-hang", "serve-replica-death", "serve-strategy-mix",
                  "serve-refine-rollback", "serve-tenant-thrash"]


@pytest.mark.parametrize("kind", SERVE_EPISODES)
def test_serve_episode_is_green_on_the_cpu(kind):
    """Each in-process serve episode of the JAX package's campaign, with its
    fault specs and invariants, run by the port on the CPU."""
    assert _run_serve_episode(Episode(kind=kind, mode="serve"), device="cpu") == []


def test_unknown_serve_episode_is_a_violation():
    assert _run_serve_episode(Episode(kind="serve-nope", mode="serve"), device="cpu") == [
        "unknown serve episode kind 'serve-nope'"]


def _config(mod, **kw):
    base = dict(num_classes_per_set=5, num_samples_per_class=2, num_target_samples=3, batch_size=2,
                number_of_training_steps_per_iter=2, number_of_evaluation_steps_per_iter=2, total_iter_per_epoch=4)
    base.update(kw)
    return mod.Config(**base)


def _support(seed):
    epi = synthetic_batch(1, 5, 2, 3, IMG, seed=seed)
    return epi["x_support"][0], epi["y_support"][0], epi["x_target"][0].reshape((-1,) + IMG)


def _systems(**kw):
    """The port's and JAX's systems at one config, the JAX init's weights
    carried into the port."""
    jsystem = JaxMAMLSystem(_config(jcfg, **{k: v[0] for k, v in kw.items()}),
                            model=jax_build_vgg(IMG, 5, num_stages=2, cnn_num_filters=4))
    jstate = jsystem.init_train_state()
    system = MAMLSystem(_config(tcfg, **{k: v[1] for k, v in kw.items()}),
                        model=build_vgg(IMG, 5, num_stages=2, cnn_num_filters=4), device="cpu")
    params, bn_state, hparams = state_from_jax(jstate.params, jstate.bn_state, jstate.inner_hparams,
                                               system.model.feature_shape, device="cpu")
    state = system.init_train_state()._replace(params=params, bn_state=bn_state, inner_hparams=hparams)
    return system, state, jsystem, jstate


def _menu_serving(mod, **kw):
    return mod.ServingConfig(support_buckets=[16], query_buckets=[16], max_batch_size=2, strategies=MENU, **kw)


@pytest.fixture(scope="module")
def menu_frontend(tmp_path_factory):
    system, state, jsystem, jstate = _systems(serving=(_menu_serving(jcfg), _menu_serving(tcfg)))
    access_dir = str(tmp_path_factory.mktemp("access"))
    frontend = ServingFrontend(AdaptationEngine(system, state), access_log_dir=access_dir)
    server = make_http_server(frontend, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield frontend, f"http://127.0.0.1:{server.server_address[1]}", access_dir, JaxEngine(jsystem, jstate)
    server.shutdown()
    server.server_close()
    frontend.close()
    thread.join(timeout=5)


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_http_round_trip_per_strategy_with_cache_isolation(menu_frontend):
    frontend, base, access_dir, jengine = menu_frontend
    x_s, y_s, x_q = _support(seed=13)
    payload = {"x_support": x_s.tolist(), "y_support": y_s.tolist()}
    ids = {}
    for strategy in MENU:
        status, out = _post(base, "/adapt", {**payload, "strategy": strategy})
        assert status == 200 and out["strategy"] == strategy and out["cached"] is False
        ids[strategy] = out["adaptation_id"]
        _, again = _post(base, "/adapt", {**payload, "strategy": strategy})
        assert again["cached"] is True, f"{strategy} repeat adapt missed"
        status, pred = _post(base, "/predict",
                             {"adaptation_id": ids[strategy], "x_query": x_q.tolist(), "strategy": strategy})
        assert status == 200 and len(pred["probs"]) == x_q.shape[0]
        ref = np.asarray(jengine.predict(jengine.adapt(x_s, y_s, strategy=strategy), x_q, strategy=strategy))
        np.testing.assert_allclose(np.asarray(pred["probs"], np.float32), ref, rtol=0, atol=ATOL)
    assert len(set(ids.values())) == 3  # one support set, three distinct sessions
    with pytest.raises(urllib.error.HTTPError) as err:  # wrong strategy: an honest 404
        _post(base, "/predict", {"adaptation_id": ids["protonet"], "x_query": x_q.tolist()})
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:  # unknown strategy: 400 with a request id
        _post(base, "/adapt", {**payload, "strategy": "nope"})
    assert err.value.code == 400
    rid = err.value.headers.get("X-Request-Id")
    assert rid
    with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
        metrics = json.loads(resp.read())
    for strategy in MENU:
        assert metrics["strategies"][strategy]["adapt.ok"] >= 1
        assert metrics["strategies"][strategy]["predict.ok"] >= 1
    assert metrics["compiled"]["strategies"] == MENU
    assert set(metrics["padding"]["by_strategy"]) >= {"maml++", "protonet"}
    records, torn = read_access_log(os.path.join(access_dir, "access.jsonl"))
    assert torn == 0
    assert {r.get("strategy") for r in records} >= set(MENU)
    assert rid in {r.get("trace_id") for r in records}


def test_in_process_strategy_menu_defaults_and_validation(menu_frontend):
    frontend, _, _, _ = menu_frontend
    x_s, y_s, x_q = _support(seed=17)
    assert frontend.adapt(x_s, y_s)["strategy"] == "maml++"  # None = the first entry
    with pytest.raises(ValueError, match="unknown strategy"):
        frontend.adapt(x_s, y_s, strategy="bogus")
    info = frontend.adapt(x_s, y_s, strategy="anil")
    with pytest.raises(UnknownAdaptationError):
        frontend.predict(info["adaptation_id"], x_q, strategy="protonet")


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_obs_report_strategy_table_from_access_log(menu_frontend):
    """The port's ``obs_report`` strategy table over the port frontend's
    access log: a row per strategy, equal to the repo's ``obs_report``."""
    _, base, access_dir, _ = menu_frontend
    x_s, y_s, _ = _support(seed=19)
    for strategy in MENU:
        _post(base, "/adapt", {"x_support": x_s.tolist(), "y_support": y_s.tolist(), "strategy": strategy})
    port = _load("t_chaos_serve_obs_port", "howtotrainyourmamlpytorch_tpu_torch/scripts/obs_report.py")
    repo = _load("t_chaos_serve_obs_repo", "scripts/obs_report.py")
    records, _ = read_access_log(os.path.join(access_dir, "access.jsonl"))
    table = port._strategies_from_access(records)
    assert table is not None and set(table) >= {"maml++", "protonet"}
    for row in table.values():
        assert row["requests"] >= 1 and "by_outcome" in row and "p50_ms" in row
    assert table == repo._strategies_from_access(records)


def test_sealed_guard_prewarm_covers_the_strategy_grid():
    """The prewarm dispatches the whole strategy grid (the same planned set
    as JAX's) and seals the guard; mixed-strategy traffic then stays inside
    it, on the JAX engine's answers; a valid but unconfigured strategy is
    unplanned and refused."""
    knobs = dict(strict_recompile_guard=(True, True), serving=(_menu_serving(jcfg), _menu_serving(tcfg)))
    system, state, jsystem, jstate = _systems(**knobs)
    engine, jengine = AdaptationEngine(system, state), JaxEngine(jsystem, jstate)
    assert serving_planned_programs(system.cfg.serving) == jax_planned(jsystem.cfg.serving)
    summary = engine.prewarm(max_workers=1)
    assert summary["errors"] == 0 and summary["programs"] == len(serving_planned_programs(system.cfg.serving))
    sealed = engine.recompile_guard.snapshot()
    assert sealed["prewarmed"]
    x_s, y_s, x_q = _support(seed=23)
    for strategy in MENU:
        probs = engine.predict(engine.adapt(x_s, y_s, strategy=strategy), x_q, strategy=strategy)
        ref = jengine.predict(jengine.adapt(x_s, y_s, strategy=strategy), x_q, strategy=strategy)
        np.testing.assert_allclose(probs, np.asarray(ref), rtol=0, atol=ATOL)
    snap = engine.recompile_guard.snapshot()
    assert snap["violations"] == [] and snap["lowerings"] == sealed["lowerings"]
    with pytest.raises(RecompileBudgetExceededError):
        engine.adapt(x_s, y_s, strategy="fomaml")
