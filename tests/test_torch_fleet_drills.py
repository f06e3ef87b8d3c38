"""The cross-process fleet drills against the port's backends on the CPU
(the first three of ``tests/test_gateway_fleet.py``'s six; the supervisor
drills are ``tests/test_torch_fleet_supervisor_drills.py``): a real
gateway subprocess (the port's ``scripts/gateway.py``) fronting real port
serve backends (``resilience.campaign.child_serve_main`` through the real
``run_server`` SIGTERM drain), with ``--device``-style ``cpu`` in every
spawn and respawn command, and the JAX drills' assertions unchanged
(bit-identical answers where JAX asserts them):

- kill -9 one of two backends mid-flight: availability never reaches zero,
  the displaced session 404s then re-adapts to bit-identical predictions,
  the flap is in the gateway's events.jsonl;
- SIGTERM mid-load: zero dropped in-flight requests, rc 0, the spill ->
  rehydrate round trip proven by a post-restart cache hit;
- a rolling restart under load by the port's ``scripts/rolling_restart.py``:
  the fleet keeps serving and every non-200 resolves to a gateway access
  line.

The shared template run dir holds the JAX package's init weights of the
drills' tiny model, carried across with ``utils/interop.py`` (the drill
payloads were chosen on them: seed 53's refinement commits under the score
guard), in the port's config and checkpoint format.
"""

import os
import sys

import jax
import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.config import load_config as jax_load_config
from howtotrainyourmamlpytorch_tpu.resilience import campaign as jax_campaign
from howtotrainyourmamlpytorch_tpu_torch.config import load_config
from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import (
    Episode,
    _run_gateway_episode,
    _wait_http_ok,
    _wait_port_file,
    backend_spawn_argv,
    make_serving_run_dir,
    run_campaign,
    spawn_logged,
    tiny_serving_system,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import state_from_jax


def jax_init_template(root: str) -> str:
    """The port's serving run dir ``template`` under ``root``, its
    checkpoint replaced by the JAX package's init of the same tiny model."""
    run_dir = make_serving_run_dir(root, "template")
    cfg = load_config(os.path.join(run_dir, "config.yaml"))
    jstate = jax_campaign.tiny_serving_system(jax_load_config(os.path.join(run_dir, "config.yaml"))).init_train_state()
    system = tiny_serving_system(cfg, device="cpu")
    params, bn_state, hparams = state_from_jax(
        *(jax.tree.map(np.asarray, tree) for tree in (jstate.params, jstate.bn_state, jstate.inner_hparams)),
        system.model.feature_shape, device="cpu",
    )
    state = system.init_train_state()._replace(params=params, bn_state=bn_state, inner_hparams=hparams)
    ckpt.save_named(os.path.join(run_dir, "saved_models"), state, {"epoch": 0}, "latest",
                    feature_shape=system.model.feature_shape)
    return run_dir


@pytest.fixture(scope="module")
def fleet_template(tmp_path_factory):
    """One template run dir shared by the module's drills (each copies it
    byte-for-byte)."""
    return jax_init_template(str(tmp_path_factory.mktemp("fleet_template")))


@pytest.fixture(autouse=True)
def _one_thread_per_backend(monkeypatch):
    # the backends inherit it: several torch processes share this box's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def run_drill(kind, tmp_path, fleet_template):
    violations = _run_gateway_episode(
        Episode(kind=kind, mode="gateway"),
        work_dir=str(tmp_path), template_run=fleet_template, device="cpu",
    )
    assert violations == [], violations


def test_cross_process_kill9_availability_and_honest_failover(tmp_path, fleet_template):
    run_drill("gateway-kill9-backend", tmp_path, fleet_template)


def test_cross_process_sigterm_drain_spill_rehydrate(tmp_path, fleet_template):
    run_drill("gateway-drain-rehydrate", tmp_path, fleet_template)


def test_cross_process_rolling_restart_under_load(tmp_path, fleet_template):
    run_drill("gateway-rolling-restart", tmp_path, fleet_template)


@pytest.mark.parametrize("wait", ["port_file", "http_ok"])
def test_a_child_that_aborts_raises_with_its_log_tail_and_stack(tmp_path, wait):
    """A drill child that dies before it binds, or while it warms up, is
    reported with its rc and the end of its log: what it printed and, as
    the drills' children run with ``-X faulthandler`` (the serving backend's
    spawn command among them), the Python stack of the frame that
    aborted."""
    assert backend_spawn_argv(str(tmp_path), 0, "cpu")[:3] == [sys.executable, "-X", "faulthandler"]
    code = "import os\ndef warm():\n    print('warming the engine', flush=True)\n    os.abort()\nwarm()\n"
    proc = spawn_logged([sys.executable, "-X", "faulthandler", "-c", code], str(tmp_path / "child.log"))
    with pytest.raises(RuntimeError) as err:
        if wait == "port_file":
            _wait_port_file(str(tmp_path / "port"), proc, timeout_s=60.0)
        else:
            _wait_http_ok("http://127.0.0.1:9/healthz", timeout_s=60.0, proc=proc)
    message = str(err.value)
    what = "backend died before binding" if wait == "port_file" else "process died warming up"
    assert message.startswith(f"{what} (rc -6); the end of its log {tmp_path / 'child.log'}:")
    assert "warming the engine" in message and "Fatal Python error: Aborted" in message
    assert 'line 4 in warm' in message


def test_training_episodes_and_the_campaign_raise_naming_a9(tmp_path):
    """The gateway runner refuses the other modes with a pointer to their
    runners: a serve episode to ``_run_serve_episode`` (ported with
    ``run_campaign``, ROADMAP.md A9.6), a training episode to
    ``_run_train_episode``; and ``run_campaign`` runs: one seeded serve
    episode on the CPU, green, in one verdict."""
    with pytest.raises(ValueError, match="_run_serve_episode"):
        _run_gateway_episode(Episode(kind="serve-dispatch-raise", mode="serve"), work_dir=str(tmp_path),
                             device="cpu")
    with pytest.raises(ValueError, match="_run_train_episode"):
        _run_gateway_episode(Episode(kind="nan-step", mode="train"), work_dir=str(tmp_path), device="cpu")
    kinds = [e.kind for e in jax_campaign.sample_episodes(0, 21, include_subprocess=False)]
    seed = next(s for s in range(100) if jax_campaign.sample_episodes(s, 1, False)[0].mode == "serve")
    verdict = run_campaign(str(tmp_path), episodes=1, seed=seed, data_root=str(tmp_path), include_subprocess=False,
                           log=lambda m: None, device="cpu")
    assert verdict["ok"], verdict["violations"]
    assert verdict["episode_results"][0]["mode"] == "serve" and verdict["episode_results"][0]["kind"] in kinds


def test_serving_run_dirs_template_and_perturbation(tmp_path):
    """``template`` copies the checkpoint byte-for-byte (the fleet's
    backends share one fingerprint); ``perturb_seed`` makes distinct,
    deterministic checkpoints of one structure; ``serving_overrides``
    rewrites only the config; AOT is on with the JAX drills' settings (one
    worker, the serving prewarm in the background)."""
    root = str(tmp_path)
    base = make_serving_run_dir(root, "base")
    copy = make_serving_run_dir(root, "copy", template=base, serving_overrides={"refine_enabled": True})
    a = make_serving_run_dir(root, "a", perturb_seed=1)
    again = make_serving_run_dir(root, "again", perturb_seed=1)
    b = make_serving_run_dir(root, "b", perturb_seed=2)

    def blob(run_dir):
        with open(os.path.join(run_dir, "saved_models", "train_model_latest"), "rb") as f:
            return f.read()

    def fingerprint(run_dir):
        return ckpt.load_for_inference(os.path.join(run_dir, "saved_models"), "latest")[0].fingerprint

    assert blob(copy) == blob(base)
    assert load_config(os.path.join(copy, "config.yaml")).serving.refine_enabled
    assert not load_config(os.path.join(base, "config.yaml")).serving.refine_enabled
    aot = load_config(os.path.join(base, "config.yaml")).aot
    assert (aot.enabled, aot.max_workers, aot.serving_background) == (True, 1, True)
    assert fingerprint(a) == fingerprint(again)
    assert len({fingerprint(base), fingerprint(a), fingerprint(b)}) == 3
