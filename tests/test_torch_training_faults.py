"""The training fault seams of the port against the JAX package's, on the
CPU.

- The injector at the runner's seams: the same specs, seed and config in
  both packages' runners (the port's on 8 CPU entries, JAX's on its 8
  virtual devices, dp=2 each) make the same number of calls at
  ``runner.step``, ``checkpoint.write``, ``checkpoint.read`` and
  ``loader.episode`` and fire the same faults: the seams sit where JAX's
  do.
- ``episode_menu`` and ``sample_episodes`` equal JAX's for seeds 0-7: the
  same 21 episodes, kinds, faults, rcs, required events and order.
- The six in-process training episodes (``nan-isolated``,
  ``nan-persistent``, ``sigterm-preempt``, ``loader-transient-io``,
  ``corrupt-latest-read``, ``sigterm-during-async-save``) pass with JAX's
  expected rcs and required events, the checkpoint and event-log
  invariants included (``tests/test_torch_training_drills.py`` runs the
  three that need a fresh interpreter).
"""

import dataclasses

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.experiment import ExperimentRunner as JaxRunner
from howtotrainyourmamlpytorch_tpu.resilience import campaign as jax_campaign
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.resilience import campaign

from .test_torch_runner import THREADS, toy_dataset  # noqa: F401

IN_PROCESS = ("nan-isolated", "nan-persistent", "sigterm-preempt", "loader-transient-io", "corrupt-latest-read",
              "sigterm-during-async-save")
SEAM_FAULTS = ["runner.step=nan-loss:nth=2", "checkpoint.write=delay:delay_s=0,nth=3",
               "loader.episode=delay:delay_s=0,nth=4", "checkpoint.read=delay:delay_s=0,nth=1"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _port_run(cfg):
    runner = ExperimentRunner(cfg, system=campaign.tiny_system(cfg, "cpu"), devices=["cpu"] * 8)
    runner.run_experiment()
    return runner._injector


def _jax_run(cfg):
    runner = JaxRunner(cfg, system=jax_campaign.tiny_system(cfg))
    runner.run_experiment()
    return runner._injector


def test_seams_fire_as_the_jax_runners_do(toy_dataset, tmp_path, monkeypatch):
    monkeypatch.delenv("HTYMP_FAULTS", raising=False)
    calls = {}
    for name, module, run in (("port", campaign, _port_run), ("jax", jax_campaign, _jax_run)):
        root = str(tmp_path / name)
        train = module.campaign_config(toy_dataset, root, "seams", total_epochs=1)
        inj = run(dataclasses.replace(train, resilience=dataclasses.replace(train.resilience, faults=SEAM_FAULTS)))
        resume = module.campaign_config(toy_dataset, root, "seams", total_epochs=2)
        inj2 = run(dataclasses.replace(resume, resilience=dataclasses.replace(resume.resilience, faults=SEAM_FAULTS)))
        calls[name] = (dict(inj._calls), inj.stats(), dict(inj2._calls), inj2.stats())
    assert calls["port"] == calls["jax"]
    first = calls["port"][0]
    assert first["runner.step"] == 3 and first["checkpoint.write"] >= 4 and first["loader.episode"] > 3
    assert calls["port"][2]["checkpoint.read"] >= 3  # a format-3 manifest and its shards


@pytest.mark.parametrize("seed", range(8))
def test_episode_menu_and_sampling_equal_jax(seed):
    menu = campaign.episode_menu(np.random.RandomState(seed))
    jmenu = jax_campaign.episode_menu(np.random.RandomState(seed))
    assert [dataclasses.asdict(e) for e in menu] == [dataclasses.asdict(e) for e in jmenu]
    assert len(menu) == 21
    for n, subprocesses in ((8, True), (30, True), (12, False)):
        got = campaign.sample_episodes(seed, n, subprocesses)
        want = jax_campaign.sample_episodes(seed, n, subprocesses)
        assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in want]
    train_kinds = {e.kind for e in menu if e.mode in campaign.TRAIN_MODES}
    assert train_kinds == set(IN_PROCESS) | {"wedge-hung-step", "device-shrink-resume", "device-grow-resume"}


@pytest.fixture(scope="module")
def episodes():
    return {e.kind: e for e in campaign.episode_menu(np.random.RandomState(0))}


@pytest.mark.parametrize("kind", IN_PROCESS)
def test_training_episode_passes_with_jax_rcs_and_events(kind, episodes, toy_dataset, tmp_path, monkeypatch):
    monkeypatch.delenv("HTYMP_FAULTS", raising=False)
    ep = episodes[kind]
    result = campaign._run_train_episode(ep, str(tmp_path), f"ep_{kind}", data_root=toy_dataset, device="cpu")
    assert result["violations"] == [], result
    assert result["rcs"][0 if ep.mode == "train" else -1] in ep.expected_rcs
    assert all(rc == 0 for rc in result["rcs"][1:])
    seen = campaign._events_in(f"{tmp_path}/exps/ep_{kind}")
    assert set(ep.required_events) <= set(seen)


def test_wrong_mode_is_refused(tmp_path):
    with pytest.raises(ValueError, match="not a training mode"):
        campaign._run_train_episode(campaign.Episode(kind="x", mode="serve"), str(tmp_path), "x", device="cpu")
    assert jcfg.ResilienceConfig().faults == tcfg.ResilienceConfig().faults == []
