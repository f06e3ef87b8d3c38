"""Elastic recovery in the port on the CPU (``tests/test_elastic.py`` and
the degraded-mesh cases of ``tests/test_wedge_watchdog.py``): a mesh of
``cpu`` entries stands in for JAX's virtual devices, an injected device
probe walks the visible count, and a subprocess child sees the device
count it is given.

- placement invariance both ways (host -> dp=4 -> host -> dp=2 -> host,
  bit for bit);
- the epoch-boundary grow (probe 2 -> 8: dp 2 -> 4, ``mesh_grown``), the
  probe inert when healthy, the runner degrading in-process (dp=16 on 8);
- shrink then grow end to end (dp=4 -> 1 device in a child -> 8 in a
  child): the val eval at the grow point within JAX's tolerances of the
  shrink side's (accuracy atol 1e-6, loss rtol 1e-5), ``mesh_grown``
  [1, 1] -> [4, 1], three epochs trained; a dp=4 checkpoint resuming on
  one device with JAX's ``degraded_mesh`` event and tolerances;
- the async writer's one-save lag and error surfacing, the epoch save off
  the step path (a 0.6 s write delay at the ``checkpoint.write`` seam, the
  checkpoint phase under 0.5 s), a kill between shard files never leaving
  a torn checkpoint that loads;
- across the packages: the port's format-2 and format-3 files are the
  JAX package's bytes for the same state (weights carried by
  ``utils/interop.py``), a port-written format-3 run resumes and trains in
  the JAX runner, a JAX-written one in the port's.
"""

import csv
import hashlib
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.experiment import ExperimentRunner as JaxRunner
from howtotrainyourmamlpytorch_tpu.experiment import checkpoint as jax_ckpt
from howtotrainyourmamlpytorch_tpu.resilience import campaign as jax_campaign
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import make_mesh, move_tree, shard_train_state, unreplicate
from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import campaign_config, tiny_system
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import params_to_jax
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten, tree_map

from .test_torch_runner import THREADS, _env, toy_dataset  # noqa: F401
from .test_torch_train import pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _events(run_dir):
    with open(os.path.join(run_dir, "logs", "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _epochs(run_dir):
    with open(os.path.join(run_dir, "logs", "summary_statistics.csv")) as f:
        return {int(float(r["epoch"])) for r in csv.DictReader(f)}


def _runner(cfg, n_devices=8, **kwargs):
    return ExperimentRunner(cfg, system=tiny_system(cfg, "cpu"), devices=["cpu"] * n_devices, **kwargs)


def _leaves(state):
    return tree_flatten({"p": state.params, "b": state.bn_state, "h": state.inner_hparams})[0] + [state.step]


# ---------------------------------------------------------------------------
# placement and the in-process grow
# ---------------------------------------------------------------------------


def test_reshard_is_placement_invariant_both_directions(toy_dataset, tmp_path):
    cfg = campaign_config(toy_dataset, str(tmp_path), "parity")
    state = tiny_system(cfg, "cpu").init_train_state()
    host = lambda s: move_tree(unreplicate(s), "cpu")  # noqa: E731
    down_up = host(shard_train_state(host(shard_train_state(state, make_mesh(tcfg.ParallelConfig(dp=4), CPU8))),
                                     make_mesh(tcfg.ParallelConfig(dp=2), CPU8)))
    for a, b in zip(_leaves(state), _leaves(down_up)):
        assert torch.equal(a, b)


def test_epoch_boundary_grow_reshards_live_state(toy_dataset, tmp_path):
    """Init sees 2 devices (dp=2 of the requested 4); the epoch-boundary
    probe then sees 8: the mesh grows to dp=4 before epoch 1 trains, logs
    ``mesh_grown`` and the run finishes."""
    probes = iter([2, 8, 8, 8, 8])
    cfg = campaign_config(toy_dataset, str(tmp_path), "grow_inproc", batch_size=4,
                          parallel=tcfg.ParallelConfig(dp=4), total_epochs=2)
    runner = _runner(cfg, device_probe=lambda: next(probes))
    assert runner.degraded_mesh == {"requested": [4, 1], "granted": [2, 1], "visible_devices": 2}
    assert runner.mesh.shape["dp"] == 2
    result = runner.run_experiment()
    assert "test_accuracy_mean" in result
    assert runner.mesh.shape["dp"] == 4 and len(runner.state.replicas) == 4
    assert runner.degraded_mesh is None
    grown = [e for e in _events(runner.run_dir) if e.get("event") == "mesh_grown"]
    assert grown and grown[0]["previous"] == [2, 1]
    assert grown[0]["granted"] == [4, 1] == grown[0]["requested"]
    assert grown[0]["visible_devices"] == 8
    assert _epochs(runner.run_dir) == {0, 1}
    _, book = ckpt.load_for_inference(runner.saved_models_dir, "latest")
    assert book["mesh"] == [4, 1]


def test_grow_probe_is_inert_when_healthy(toy_dataset, tmp_path):
    calls = []

    def probe():
        calls.append(1)
        return 8

    cfg = campaign_config(toy_dataset, str(tmp_path), "grow_inert", total_epochs=1)
    runner = _runner(cfg, device_probe=probe)
    assert runner.degraded_mesh is None
    runner.run_experiment()
    assert len(calls) == 1  # init only


def test_runner_degrades_infeasible_mesh_in_process(toy_dataset, tmp_path):
    """dp=16 on 8 visible entries shrinks to the largest feasible dp (2:
    the meta-batch is 2), logs ``degraded_mesh`` and trains to the end."""
    cfg = campaign_config(toy_dataset, str(tmp_path), "toy_degraded16", parallel=tcfg.ParallelConfig(dp=16),
                          total_epochs=1)
    runner = _runner(cfg)
    assert runner.degraded_mesh == {"requested": [16, 1], "granted": [2, 1], "visible_devices": 8}
    assert runner.mesh is not None and runner.mesh.shape["dp"] == 2
    assert "test_accuracy_mean" in runner.run_experiment()
    degraded = [e for e in _events(runner.run_dir) if e.get("event") == "degraded_mesh"]
    assert degraded and degraded[0]["granted"] == [2, 1]


# ---------------------------------------------------------------------------
# shrink and grow across processes
# ---------------------------------------------------------------------------

_CHILD = r"""
import json, sys
import torch
from howtotrainyourmamlpytorch_tpu_torch.config import load_config
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import tiny_system

torch.set_num_threads(2)
cfg, n, mode = load_config(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
make = lambda: ExperimentRunner(cfg, system=tiny_system(cfg, "cpu"), devices=["cpu"] * n)
r = make()
out = {"start_epoch": r.start_epoch, "degraded": r.degraded_mesh, "mesh": r._mesh_shape()}
if mode == "eval_then_train":
    out["val"] = r._eval_split("val")
    r.run_experiment()
else:  # train, then a fresh runner evaluates the checkpoint it wrote
    r.run_experiment()
    r2 = make()
    out["val_after"] = r2._eval_split("val")
    out["start_epoch_after"] = r2.start_epoch
    r2.loader.close()
print("CHILD_JSON " + json.dumps(out))
"""


def _child(cfg, tmp_path, n_devices, mode, name):
    cfg_yaml = str(tmp_path / f"{name}.yaml")
    tcfg.save_config(cfg, cfg_yaml)
    proc = subprocess.run([sys.executable, "-c", _CHILD, cfg_yaml, str(n_devices), mode], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    return next(json.loads(line.split(" ", 1)[1]) for line in proc.stdout.splitlines()
                if line.startswith("CHILD_JSON "))


def test_shrink_then_grow_e2e_parity_and_continued_training(toy_dataset, tmp_path):
    """Train on dp=4, resume on 1 device (shrink), then on 8 (grow). At the
    grow point the restored state's val eval matches the same checkpoint
    evaluated on the shrunken side (accuracy atol 1e-6, loss rtol 1e-5),
    ``mesh_grown`` lands and training continues."""
    base = dict(batch_size=4, parallel=tcfg.ParallelConfig(dp=4), total_epochs=1)
    cfg = campaign_config(toy_dataset, str(tmp_path), "grow_e2e", **base)
    runner = _runner(cfg)
    assert runner.mesh is not None and runner.mesh.shape["dp"] == 4
    runner.run_experiment()

    shrink = _child(campaign_config(toy_dataset, str(tmp_path), "grow_e2e", **{**base, "total_epochs": 2}),
                    tmp_path, 1, "train_then_eval", "grow_shrink")
    assert shrink["degraded"] == {"requested": [4, 1], "granted": [1, 1], "visible_devices": 1}
    assert shrink["start_epoch_after"] == 2
    grow = _child(campaign_config(toy_dataset, str(tmp_path), "grow_e2e", **{**base, "total_epochs": 3}),
                  tmp_path, 8, "eval_then_train", "grow_grow")
    assert grow["start_epoch"] == 2 and grow["degraded"] is None and grow["mesh"] == [4, 1]
    ref, val = shrink["val_after"], grow["val"]
    assert val["val_num_episodes"] == ref["val_num_episodes"]
    np.testing.assert_allclose(val["val_accuracy_mean"], ref["val_accuracy_mean"], atol=1e-6)
    np.testing.assert_allclose(val["val_loss_mean"], ref["val_loss_mean"], rtol=1e-5)
    run_dir = os.path.join(str(tmp_path), "grow_e2e")
    grown = [e for e in _events(run_dir) if e.get("event") == "mesh_grown"]
    assert grown and grown[-1]["previous"] == [1, 1] and grown[-1]["granted"] == [4, 1]
    assert _epochs(run_dir) == {0, 1, 2}


def test_dp4_checkpoint_resumes_and_trains_on_one_device(toy_dataset, tmp_path):
    """A checkpoint written under dp=4 resumes on 1 visible device (the
    ``degraded_mesh`` event, one device), evaluates within JAX's tolerance
    of the dp=4 eval of the same state, and keeps training."""
    base = dict(batch_size=4, parallel=tcfg.ParallelConfig(dp=4), total_epochs=1)
    cfg = campaign_config(toy_dataset, str(tmp_path), "shrink_run", **base)
    runner = _runner(cfg)
    runner.run_experiment()
    ref = _runner(cfg)
    try:
        assert ref.start_epoch == 1 and ref.mesh.shape["dp"] == 4
        ref_val = ref._eval_split("val")
    finally:
        ref.loader.close()
        ref.events.close()
    payload = _child(campaign_config(toy_dataset, str(tmp_path), "shrink_run", **{**base, "total_epochs": 2}),
                     tmp_path, 1, "eval_then_train", "shrink_resume")
    assert payload["start_epoch"] == 1
    assert payload["degraded"] == {"requested": [4, 1], "granted": [1, 1], "visible_devices": 1}
    assert payload["val"]["val_num_episodes"] == ref_val["val_num_episodes"]
    np.testing.assert_allclose(payload["val"]["val_accuracy_mean"], ref_val["val_accuracy_mean"], atol=1e-6)
    np.testing.assert_allclose(payload["val"]["val_loss_mean"], ref_val["val_loss_mean"], rtol=1e-5)
    run_dir = os.path.join(str(tmp_path), "shrink_run")
    assert any(e.get("event") == "degraded_mesh" for e in _events(run_dir))
    assert _epochs(run_dir) == {0, 1}


# ---------------------------------------------------------------------------
# async save: off the step path, never torn
# ---------------------------------------------------------------------------


def test_async_writer_one_save_lag_and_error_surfacing():
    w = ckpt.AsyncCheckpointWriter()
    t0 = time.monotonic()
    done = []
    w.submit(lambda: (time.sleep(0.5), done.append(1)))
    assert time.monotonic() - t0 < 0.3
    assert w.busy
    t1 = time.monotonic()
    w.submit(lambda: done.append(2))  # blocks on the previous save
    assert time.monotonic() - t1 >= 0.2
    assert done[0] == 1
    w.close()
    assert done == [1, 2]

    def boom():
        raise RuntimeError("disk full")

    w.submit(boom)
    with pytest.raises(RuntimeError, match="disk full"):
        w.wait()
    w.close()


def test_runner_epoch_save_is_off_the_step_path(toy_dataset, tmp_path):
    """A 0.6 s delay on two checkpoint writes (the ``checkpoint.write`` seam
    on the async epoch save's files): the checkpoint phase (the host copy,
    then the submit) stays far under one write's delay, and the save lands
    complete."""
    cfg = campaign_config(toy_dataset, str(tmp_path), "async_run", total_epochs=1,
                          resilience=tcfg.ResilienceConfig(faults=["checkpoint.write=delay:delay_s=0.6,after=1,times=2"]))
    runner = _runner(cfg)
    assert runner._ckpt_writer is not None
    runner.run_experiment()
    assert runner._injector.stats() == {"checkpoint.write:delay": 2}
    with open(os.path.join(runner.run_dir, "logs", "telemetry.jsonl")) as f:
        last = [json.loads(line) for line in f if line.strip()][-1]
    assert last["phases"]["checkpoint"]["max_ms"] < 500, last["phases"]["checkpoint"]
    resumed = _runner(campaign_config(toy_dataset, str(tmp_path), "async_run", total_epochs=1))
    assert resumed.start_epoch == 1
    resumed.loader.close()
    resumed.events.close()


def test_kill_during_sharded_save_never_leaves_torn_checkpoint(toy_dataset, tmp_path):
    """The manifest is the commit point: the kill points of an in-flight
    format-3 save, replayed by hand, each leave a checkpoint that the
    fallback chain loads complete."""
    cfg = campaign_config(toy_dataset, str(tmp_path), "torn")
    system = tiny_system(cfg, "cpu")
    fs = system.model.feature_shape
    state, template = system.init_train_state(), system.init_train_state()
    d = str(tmp_path / "saves")
    ckpt.save_checkpoint(d, state, {"epoch": 0}, 0, feature_shape=fs, num_shards=2)

    # kill point A: epoch-1 shards written, no manifest: invisible
    state1 = state._replace(params=tree_map(torch.ones_like, state.params))
    blobs, num_leaves = ckpt._sharded_serialize(state1, 2, fs)
    path1 = ckpt._path(d, 1)
    for k, blob in enumerate(blobs):
        ckpt._write_atomic(ckpt._shard_path(path1, k), blob)
    assert ckpt.available_epochs(d) == [0]
    _, book, _ = ckpt.load_latest_with_fallback(d, template, feature_shape=fs)
    assert int(book["epoch"]) == 0

    # kill point B: epoch-1 manifest committed, 'latest' mid-update (its
    # shard link replaced, its manifest not yet): latest fails its digest,
    # is quarantined, and the chain recovers the new epoch
    entries = [{"file": os.path.basename(ckpt._shard_path(path1, k)), "sha256": hashlib.sha256(blob).hexdigest()}
               for k, blob in enumerate(blobs)]
    ckpt._write_atomic(path1, ckpt._manifest_blob(entries, {"epoch": 1}, num_leaves))
    latest = ckpt._path(d, "latest")
    ckpt._write_atomic(ckpt._shard_path(latest, 0), blobs[0])
    _, book, idx = ckpt.load_latest_with_fallback(d, template, feature_shape=fs)
    assert int(book["epoch"]) == 1 and idx == 1
    assert os.path.exists(latest + ".corrupt")
    restored, _ = ckpt.load_checkpoint(d, 1, template, feature_shape=fs)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(restored), _leaves(state1)))
    restored0, _ = ckpt.load_checkpoint(d, 0, template, feature_shape=fs)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(restored0), _leaves(state)))


# ---------------------------------------------------------------------------
# format 3 across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "vgg"])
def test_checkpoint_files_are_the_jax_packages_bytes(kind):
    """For the same state (weights carried by ``utils/interop.py``) and
    bookkeeping, every format-3 shard, the manifest and the format-2 file
    are the JAX package's bytes."""
    jsys, jstate, tsys, tstate = pair(kind)
    fs = tsys.model.feature_shape
    jblobs, jextra = jax_ckpt._sharded_serialize(jstate, 3)
    tblobs, num_leaves = ckpt._sharded_serialize(tstate, 3, fs)
    assert num_leaves == jextra["num_leaves"] and tblobs == jblobs
    entries = [{"file": f"train_model_2.shard{k}", "sha256": hashlib.sha256(b).hexdigest()}
               for k, b in enumerate(tblobs)]
    book = {"epoch": 2, "mesh": [2, 1], "val_acc_by_epoch": {"0": 0.5}}
    assert ckpt._manifest_blob(entries, book, num_leaves) == jax_ckpt._manifest_blob(entries, book, num_leaves)
    assert ckpt._serialize(tstate, book, fs) == jax_ckpt._serialize(jstate, book)


def _jax_runner(cfg):
    return JaxRunner(cfg, system=jax_campaign.tiny_system(cfg))


def test_port_format_3_checkpoint_resumes_in_jax(toy_dataset, tmp_path):
    """A port run at dp=2 writes format 3 (2 shards, mesh [2, 1]); the JAX
    runner (dp=2 on its virtual devices) resumes it at epoch 1 with the
    port's weights, bit for bit, and trains on."""
    cfg = campaign_config(toy_dataset, str(tmp_path), "port_f3", total_epochs=1)
    runner = _runner(cfg)
    runner.run_experiment()
    saved = sorted(os.listdir(runner.saved_models_dir))
    assert "train_model_latest.shard1" in saved and "train_model_0.shard1" in saved
    port_params = params_to_jax(unreplicate(runner.state).params, runner.system.model.feature_shape)

    jrunner = _jax_runner(jax_campaign.campaign_config(toy_dataset, str(tmp_path), "port_f3", total_epochs=2))
    assert jrunner.start_epoch == 1 and jrunner.mesh.shape["dp"] == 2
    got = jax.tree.map(np.asarray, jax.device_get(jrunner.state.params))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(port_params)):
        np.testing.assert_array_equal(a, b)
    jrunner.run_experiment()
    assert _epochs(runner.run_dir) == {0, 1}


def test_jax_format_3_checkpoint_resumes_and_trains_in_the_port(toy_dataset, tmp_path):
    """A JAX run at dp=2 (format 3, 2 shards) resumes in the port's runner
    on a 2-entry CPU mesh with JAX's weights and trains the next epoch."""
    jcfg_ = jax_campaign.campaign_config(toy_dataset, str(tmp_path), "jax_f3", total_epochs=1)
    jrunner = _jax_runner(jcfg_)
    jrunner.run_experiment()
    assert "train_model_latest.shard1" in os.listdir(jrunner.saved_models_dir)
    jax_params = jax.tree.map(np.asarray, jax.device_get(jrunner.state.params))

    runner = _runner(campaign_config(toy_dataset, str(tmp_path), "jax_f3", total_epochs=2), n_devices=2)
    assert runner.start_epoch == 1 and runner.mesh.shape["dp"] == 2 and runner._resume_prev_mesh == [2, 1]
    got = params_to_jax(unreplicate(runner.state).params, runner.system.model.feature_shape)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax_params)):
        np.testing.assert_array_equal(a, b)
    runner.run_experiment()
    assert _epochs(runner.run_dir) == {0, 1}
    with open(os.path.join(runner.run_dir, "logs", "summary_statistics.csv")) as f:
        assert all(np.isfinite(float(r["train_loss_mean"])) for r in csv.DictReader(f))
