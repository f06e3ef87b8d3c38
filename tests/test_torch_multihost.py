"""Multi-host in the port on the CPU (``tests/test_multihost.py``): the
per-host slicing of the global meta-batch, the host-local half of the
global-batch contract, ``initialize_distributed`` (mocked), the top-K test
ensemble gathered over the group (mocked as JAX's test mocks it), and a
real two-process ``torch.distributed`` group over gloo:

- each process loads a checkpoint written here, builds its slice of the
  batch (``host_shard_bounds``) on a dp=2 mesh of one CPU entry per
  process, and takes the meta-gradient and a train step; the all-reduced
  meta-gradient equals a one-process dp=2 step's (one scale, atol 1e-6 of
  the largest entry; loss rtol 1e-6) and JAX's meta-gradient on the same
  weights (atol 1e-5 of the largest entry, loss rtol 1e-5, JAX's
  ``lax.scan`` program without remat);
- each process evaluates the top-2 test ensemble of a trained run on its
  own copy of the run directory, its loader slicing the test batches: the
  statistics every process reports equal the one-process runner's.

The children join with a timeout on every collective and are killed if
they outlive it. Cards and NCCL are not exercised here (the card machine
has one H100, and NCCL refuses two ranks on one card).
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu import parallel as jpar
from howtotrainyourmamlpytorch_tpu.data import MetaLearningDataLoader as JaxLoader
from howtotrainyourmamlpytorch_tpu.resilience import campaign as jax_campaign
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch import parallel as tpar
from howtotrainyourmamlpytorch_tpu_torch.data import FewShotDataset, MetaLearningDataLoader
from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.experiment import runner as runner_module
from howtotrainyourmamlpytorch_tpu_torch.parallel import mesh as mesh_module
from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import campaign_config, tiny_system
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import trainables_to_jax

from .test_torch_runner import THREADS, _env, toy_dataset  # noqa: F401
from .test_torch_train import jax_meta_gradients, port_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 60


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _toy(module, root):
    return module.Config(
        dataset=module.DatasetConfig(name="omniglot_toy", path=str(root)), num_classes_per_set=3,
        num_samples_per_class=1, num_target_samples=1, batch_size=4, load_into_memory=True,
        num_dataprovider_workers=2, train_val_test_split=(0.5, 0.25, 0.25),
    )


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mh") / "omniglot_toy"
    rng = np.random.RandomState(0)
    for a in range(4):
        for c in range(4):
            d = root / f"alpha{a}" / f"char{c}"
            d.mkdir(parents=True)
            for i in range(6):
                arr = (rng.rand(28, 28) > 0.5).astype(np.uint8) * 255
                Image.fromarray(arr, mode="L").convert("1").save(d / f"{i}.png")
    return root


def test_host_shard_bounds():
    assert tpar.host_shard_bounds(8, 0, 2) == (0, 4)
    assert tpar.host_shard_bounds(8, 1, 2) == (4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.host_shard_bounds(6, 0, 4)


def test_host_sharded_loaders_tile_the_global_batch(toy_root):
    """Two hosts each build their slice; concatenated they equal the batch
    one loader builds, and each slice equals the JAX loader's slice."""
    cfg, jax_cfg = _toy(tcfg, toy_root), _toy(jcfg, toy_root)
    ds = FewShotDataset(cfg)
    full = next(iter(MetaLearningDataLoader(cfg, dataset=ds).val_batches(1)))
    locals_ = [next(iter(MetaLearningDataLoader(cfg, dataset=ds, host_shard=(p, 2)).val_batches(1))) for p in (0, 1)]
    jax_locals = [next(iter(JaxLoader(jax_cfg, host_shard=(p, 2)).val_batches(1))) for p in (0, 1)]
    for key in full:
        assert locals_[0][key].shape[0] == 2
        np.testing.assert_array_equal(np.concatenate([part[key] for part in locals_]), full[key])
        for mine, theirs in zip(locals_, jax_locals):
            np.testing.assert_array_equal(mine[key], theirs[key])
    train = [next(iter(MetaLearningDataLoader(cfg, dataset=ds, current_iter=3, host_shard=(p, 2))
                       .train_batches(1))) for p in (0, 1)]
    whole = next(iter(MetaLearningDataLoader(cfg, dataset=ds, current_iter=3).train_batches(1)))
    np.testing.assert_array_equal(np.concatenate([t["x_support"] for t in train]), whole["x_support"])


def test_global_batch_from_local_single_host(toy_root):
    """With one process the local slice is the whole batch, sharded over
    the local devices in task order."""
    mesh = tpar.make_mesh(tcfg.ParallelConfig(dp=4), ["cpu"] * 4)
    local = next(iter(MetaLearningDataLoader(_toy(tcfg, toy_root), host_shard=(0, 1)).val_batches(1)))
    sharded = tpar.global_batch_from_local(local, mesh)
    assert sharded.spec[0] == "dp" and sharded.num_tasks == sharded.global_tasks == 4
    for key, arr in local.items():
        np.testing.assert_array_equal(torch.cat([s[key] for s in sharded.shards]).numpy(), arr)
    jmesh = jpar.make_mesh(jcfg.ParallelConfig(dp=4))
    jglobal = jpar.global_batch_from_local(local, jmesh)
    np.testing.assert_array_equal(np.asarray(jglobal["x_support"]), local["x_support"])


def test_initialize_distributed_nop_and_mocked(monkeypatch):
    calls = []
    monkeypatch.setattr(mesh_module.dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    tpar.initialize_distributed(num_processes=1)
    tpar.initialize_distributed()
    assert calls == []
    tpar.initialize_distributed(coordinator_address="10.0.0.1:8476", num_processes=4, process_id=2, device="cpu")
    backend, kw = calls[-1]
    assert backend == "gloo"
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == ("tcp://10.0.0.1:8476", 4, 2)
    # torch's own launcher variables stand in for unset arguments
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "c")
    monkeypatch.setenv("MASTER_PORT", "1")
    tpar.initialize_distributed(device="cpu")
    backend, kw = calls[-1]
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == ("tcp://c:1", 2, 1)
    assert tpar.process_count() == 1 and tpar.process_index() == 0  # nothing was joined


@pytest.mark.parametrize("device, card, backend", [
    (None, False, None),  # no card and no CPU asked for: resolve_device's error
    (None, True, "nccl"),
    ("cpu", False, "gloo"),
    ("cpu", True, "gloo"),
    ("cuda", True, "nccl"),
])
def test_initialize_distributed_follows_the_device_rule(monkeypatch, device, card, backend):
    """The backend follows the port's device rule: ``None`` means the card
    (NCCL) and raises where none is visible; only the CPU asked for gives
    gloo."""
    calls = []
    monkeypatch.setattr(mesh_module.dist, "init_process_group", lambda b, **kw: calls.append(b))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    args = dict(coordinator_address="c:1", num_processes=2, process_id=0, device=device)
    if backend is None:
        with pytest.raises(RuntimeError, match="no CUDA device is available; pass device='cpu'"):
            tpar.initialize_distributed(**args)
        assert calls == []
    else:
        tpar.initialize_distributed(**args)
        assert calls == [backend]


def test_multihost_ensemble_gathers_via_the_group(toy_dataset, tmp_path, monkeypatch):
    """Top-K test ensembling on a (mocked) 2-process run: the per-task
    probabilities reach the host only through the task gather, the label
    slices through the host gather, and the gathered path reproduces the
    single-host numbers."""
    cfg = campaign_config(toy_dataset, str(tmp_path), "toy_mh_ensemble", checkpoint_rotation="best_val",
                          test_ensemble_top_k=2, parallel=tcfg.ParallelConfig(dp=1))
    runner = ExperimentRunner(cfg, system=tiny_system(cfg, "cpu"))
    runner.run_experiment()
    single_host = runner.evaluate_test()
    calls = {"tasks": 0, "host": 0}

    def fake_tasks(x):
        calls["tasks"] += 1
        return x

    def fake_host(x):
        calls["host"] += 1
        return np.asarray(x)

    monkeypatch.setattr(runner_module, "all_gather_tasks", fake_tasks)
    monkeypatch.setattr(runner_module, "all_gather_host", fake_host)
    runner._multihost = True
    gathered = runner.evaluate_test()
    n_batches = max(cfg.num_evaluation_tasks // runner.loader.batch_size, 1)
    assert calls["host"] == n_batches
    assert calls["tasks"] == n_batches * gathered["test_ensemble_size"]
    for key in ("test_accuracy_mean", "test_loss_mean", "test_accuracy_std"):
        assert gathered[key] == pytest.approx(single_host[key])
    assert gathered["test_ensemble_size"] == 2


# ---------------------------------------------------------------------------
# a real two-process group
# ---------------------------------------------------------------------------

_CHILD = r"""
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.parallel import (
    host_shard_bounds, initialize_distributed, make_mesh, process_count, replicate, shard_batch)
from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import tiny_system
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten

address, rank, work = sys.argv[1], int(sys.argv[2]), sys.argv[3]
initialize_distributed(address, 2, rank, device="cpu", timeout_s=float(sys.argv[4]))
spec = json.load(open(os.path.join(work, "spec.json")))

cfg = tcfg.load_config(spec["step_cfg"])
system = tiny_system(cfg, "cpu")
state, _ = ckpt.load_checkpoint(spec["state_dir"], "latest", system.init_train_state(),
                                feature_shape=system.model.feature_shape)
batch = dict(np.load(spec["batch"]))
lo, hi = host_shard_bounds(len(batch["x_support"]), rank, process_count())
mesh = make_mesh(cfg.parallel, ["cpu"])
assert mesh.shape == {"dp": 2, "mp": 1} and mesh.local_dp == 1 and mesh.processes == 2
local = shard_batch({k: v[lo:hi] for k, v in batch.items()}, mesh)
assert local.num_tasks == hi - lo and local.global_tasks == len(batch["x_support"])
loss, _, grads = system.meta_gradients(replicate(state, mesh), local, epoch=0)
new, out = system.train_step(replicate(state, mesh), local, epoch=0)
from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import shard_chunk
chunk = {k: np.stack([v[lo:hi], v[lo:hi][::-1]]) for k, v in batch.items()}
chunked, (chunk_losses, _, _) = system.train_step_multi(replicate(state, mesh), shard_chunk(chunk, mesh), 0)
np.savez(os.path.join(work, f"step{rank}.npz"), loss=float(loss), out_loss=float(out.loss),
         step_losses=out.per_task_losses.numpy(), chunk_losses=chunk_losses.numpy(), chunk_step=int(chunked.step),
         **{"g_" + "/".join(p): g.numpy() for g, p in zip(*tree_flatten(grads))},
         **{"p_" + "/".join(p): t.numpy() for t, p in zip(*tree_flatten(new.params))})

run_cfg = tcfg.load_config(spec["run_cfg"])
run_cfg = dataclasses.replace(run_cfg, experiment_root=spec["roots"][rank])
runner = ExperimentRunner(run_cfg, system=tiny_system(run_cfg, "cpu"), devices=["cpu"])
assert runner._multihost and runner.mesh.shape["dp"] == 2 and runner.start_epoch == run_cfg.total_epochs
assert (runner.loader._local_lo, runner.loader._local_hi) == host_shard_bounds(run_cfg.batch_size, rank, 2)
stats = runner.evaluate_test()
runner.loader.close()
runner.events.close()
dist.barrier()
dist.destroy_process_group()
print("CHILD_JSON " + json.dumps(stats), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_process_run(toy_dataset, tmp_path_factory):
    """Start the two gloo processes on a state, a batch and a trained run
    built here; -> (work dir, the children's statistics, the inputs)."""
    work = tmp_path_factory.mktemp("gloo")
    # the step: JAX's tiny system's init weights in the port's layout
    step_cfg = campaign_config(toy_dataset, str(work), "step", batch_size=4)
    jax_step_cfg = jax_campaign.campaign_config(toy_dataset, str(work), "jstep", batch_size=4,
                                                unroll_inner_steps=False, remat_inner_steps=False)
    jsys = jax_campaign.tiny_system(jax_step_cfg)
    jstate = jsys.init_train_state()
    tsys = tiny_system(step_cfg, "cpu")
    tstate = port_state(jstate, tsys)
    state_dir = work / "state"
    ckpt.save_named(str(state_dir), tstate, {"epoch": -1}, "latest", feature_shape=tsys.model.feature_shape)
    batch = learnable_synthetic_batch(4, 3, 2, 2, (28, 28, 1), seed=11)
    np.savez(work / "batch.npz", **batch)
    tcfg.save_config(step_cfg, str(work / "step.yaml"))

    # the ensemble: a trained run, one copy per process
    run_cfg = campaign_config(toy_dataset, str(work / "single"), "ens", checkpoint_rotation="best_val",
                              test_ensemble_top_k=2)
    runner = ExperimentRunner(run_cfg, system=tiny_system(run_cfg, "cpu"), devices=["cpu"] * 2)
    runner.run_experiment()
    single = runner.evaluate_test()
    roots = [str(work / f"host{r}") for r in (0, 1)]
    for root in roots:
        shutil.copytree(runner.run_dir, os.path.join(root, "ens"))
    tcfg.save_config(run_cfg, str(work / "run.yaml"))
    with open(work / "spec.json", "w") as f:
        json.dump({"step_cfg": str(work / "step.yaml"), "state_dir": str(state_dir),
                   "batch": str(work / "batch.npz"), "run_cfg": str(work / "run.yaml"), "roots": roots}, f)

    address = f"127.0.0.1:{_free_port()}"
    env = dict(_env(), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, address, str(rank), str(work), str(JOIN_TIMEOUT_S)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in (0, 1)]
    outs = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=JOIN_TIMEOUT_S * 3)
            assert proc.returncode == 0, (stdout[-3000:], stderr[-3000:])
            outs.append(next(json.loads(line.split(" ", 1)[1]) for line in stdout.splitlines()
                             if line.startswith("CHILD_JSON ")))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"work": work, "stats": outs, "single": single, "tsys": tsys, "tstate": tstate, "batch": batch,
            "jsys": jsys, "jstate": jstate}


def _grads(npz):
    return {k[2:]: npz[k] for k in npz.files if k.startswith("g_")}


def test_two_process_gloo_step_equals_one_process_dp2_and_jax(two_process_run):
    run = two_process_run
    steps = [np.load(run["work"] / f"step{r}.npz") for r in (0, 1)]
    tsys, tstate, batch = run["tsys"], run["tstate"], run["batch"]
    mesh = tpar.make_mesh(tcfg.ParallelConfig(dp=2), ["cpu"] * 2)
    loss, _, grads = tsys.meta_gradients(tpar.replicate(tstate, mesh), tpar.shard_batch(batch, mesh), epoch=0)
    new, out = tsys.train_step(tpar.replicate(tstate, mesh), tpar.shard_batch(batch, mesh), epoch=0)
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten

    want = {"/".join(p): g.numpy() for g, p in zip(*tree_flatten(grads))}
    scale = max(float(np.abs(g).max()) for g in want.values())
    for step in steps:
        np.testing.assert_allclose(float(step["loss"]), float(loss), rtol=1e-6)
        np.testing.assert_allclose(float(step["out_loss"]), float(out.loss), rtol=1e-6)
        got = _grads(step)
        assert sorted(got) == sorted(want)
        for key, g in want.items():
            np.testing.assert_allclose(got[key], g, rtol=0, atol=1e-6 * scale)
    # each process reports its own tasks' losses: rank 0 the first half
    np.testing.assert_allclose(np.concatenate([s["step_losses"] for s in steps]), out.per_task_losses.numpy(),
                               rtol=1e-6)

    jloss, _, jgrads = jax_meta_gradients(run["jsys"], run["jstate"], batch, 0)
    np.testing.assert_allclose(float(steps[0]["loss"]), jloss, rtol=1e-5)
    port_as_jax = trainables_to_jax(grads, tsys.model.feature_shape)
    jflat, pflat = jax.tree.leaves(jgrads), jax.tree.leaves(port_as_jax)
    jscale = max(float(np.abs(np.asarray(g)).max()) for g in jflat)
    for a, b in zip(pflat, jflat):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-5 * jscale)


def test_two_process_chunk_equals_one_process_dp2_chunk(two_process_run):
    """A chunk of K=2 steps on the two-process mesh (the mesh spans
    processes, so the multi-step program runs the sharded eager steps, the
    meta-gradient all-reduced over gloo in each): its losses equal a
    one-process dp=2 chunk's over the same global batches (rtol 1e-6)."""
    from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import shard_chunk

    run = two_process_run
    steps = [np.load(run["work"] / f"step{r}.npz") for r in (0, 1)]
    batch = run["batch"]
    halves = [{k: v[lo:hi] for k, v in batch.items()} for lo, hi in ((0, 2), (2, 4))]
    # each process reversed its own two tasks in the chunk's second batch
    second = {k: np.concatenate([h[k][::-1] for h in halves]) for k in batch}
    chunk = {k: np.stack([batch[k], second[k]]) for k in batch}
    mesh = tpar.make_mesh(tcfg.ParallelConfig(dp=2), ["cpu"] * 2)
    tsys, tstate = run["tsys"], run["tstate"]
    new, (losses, _, _) = tsys.train_step_multi(tpar.replicate(tstate, mesh), shard_chunk(chunk, mesh), 0)
    for step in steps:
        np.testing.assert_allclose(step["chunk_losses"], losses.numpy(), rtol=1e-6)
        assert int(step["chunk_step"]) == int(new.step) == 2


def test_top_k_ensemble_gathered_over_the_group(two_process_run):
    run = two_process_run
    single = run["single"]
    assert single["test_ensemble_size"] == 2
    for stats in run["stats"]:
        assert stats["test_ensemble_size"] == 2 and stats["test_num_episodes"] == single["test_num_episodes"]
        for key in ("test_accuracy_mean", "test_loss_mean", "test_accuracy_std", "test_loss_std"):
            assert stats[key] == pytest.approx(single[key], rel=1e-6, abs=1e-7)


def test_multi_host_run_without_a_mesh_is_refused(toy_dataset, tmp_path, monkeypatch):
    """A multi-host run whose config leaves no mesh (sharding off) would
    train every process alone on its slice: JAX's error."""
    monkeypatch.setattr(runner_module, "process_count", lambda: 2)
    cfg = campaign_config(toy_dataset, str(tmp_path), "mh_nomesh",
                          parallel=dataclasses.replace(tcfg.ParallelConfig(dp=2), shard_meta_batch=False))
    with pytest.raises(RuntimeError, match="no usable device mesh"):
        ExperimentRunner(cfg, system=tiny_system(cfg, "cpu"), devices=["cpu"])
