"""Multi-step dispatch in the port against the JAX package's
``train_step_multi``/``eval_step_multi`` (``tests/test_multi_dispatch.py``)
on the CPU, where the port runs the K (or N) eager steps that a CUDA graph
replays on the card. A small VGG (2 stages, 8 filters, 3-way 2-shot, K=2
inner steps, second order, MSL on) from the same numpy-seeded weights
(carried over with ``utils/interop.py``) and stacked batches, K=3:

- losses, accuracies and lrs, then the final params, lrs and outer Adam
  state, within atol 1e-5 of JAX's ``lax.scan`` program (the tolerance of
  the train parity, ``tests/test_torch_train.py``; conv biases, whose
  meta-gradient is float32 noise under transductive BN, are left out of
  the post-Adam params);
- the eval per-task losses and accuracies;
- the port's chunk equal, bit for bit, to K ``train_step`` calls;
- a chunk that spans a variant flip refused; on a dp=2 mesh over
  ``[cpu, cpu]`` a sharded chunk (``shard_chunk``) equal, bit for bit, to
  K sharded ``train_step`` calls and within the train parity's tolerances
  of JAX's meshless program on the same global batches, and the fused
  eval on the mesh equal to the per-batch sharded eval;
- a runner epoch with K=2 (one chunk and a single step over 3 iterations)
  bit-equal to the K=1 port run and within atol 1e-5 of JAX's runner with
  K=2 (``test_runner_epoch_with_multi_dispatch``'s statistics), and on a
  dp=2 mesh within rtol 1e-5 of K=1;
- a forced ``nan-loss`` under K=2 that discards the chunk and restores the
  state;
- the fused eval's statistics equal to the per-batch ones."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.experiment import ExperimentRunner as JaxRunner
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core.programs import tree_leaves_any
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch, shard_chunk, unreplicate
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import params_to_jax
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

from .test_torch_runner import jax_config, jax_small_system, runner_config, small_system, toy_dataset  # noqa: F401
from .test_torch_train import ATOL, _close, batch, pair, port_state

torch.set_num_threads(2)
K = 3


@pytest.fixture(scope="module")
def chunk():
    """JAX's K-step program and eval program on the stacked batches."""
    jsys, jstate, tsys, tstate = pair("vgg", unroll_inner_steps=False)
    bs = [batch(seed=i) for i in range(K)]
    stacked = {k: np.stack([b[k] for b in bs]) for k in bs[0]}
    jnew, (jl, ja, jr) = jsys.train_step_multi(jstate, {k: jnp.asarray(v) for k, v in stacked.items()}, 0)
    jeval = jsys.eval_step_multi(jstate, {k: jnp.asarray(v) for k, v in stacked.items()})
    return {"tsys": tsys, "tstate": tstate, "jnew": jnew, "outs": (jl, ja, jr), "eval": jeval,
            "batches": bs, "stacked": stacked}


def test_train_step_multi_matches_jax(chunk):
    tsys, jnew = chunk["tsys"], chunk["jnew"]
    new, outs = tsys.train_step_multi(chunk["tstate"], chunk["stacked"], 0)
    assert all(o.shape == (K,) for o in outs)
    for got, want in zip(outs, chunk["outs"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    fs = tsys.model.feature_shape
    got = params_to_jax(new.params, fs)
    # the conv weights, every batch norm and the head; conv biases left out
    for stage in ("stage_0", "stage_1"):
        _close(got[stage]["conv"]["w"], jnew.params[stage]["conv"]["w"])
        _close(got[stage]["bn"], jnew.params[stage]["bn"])
    _close(got["fc"], jnew.params["fc"])
    _close(params_to_jax(new.inner_hparams, fs), jnew.inner_hparams)
    assert int(new.step) == int(jnew.step) == K
    assert int(new.opt_state[0].count) == int(jnew.opt_state[0].count) == K


def test_eval_step_multi_matches_jax(chunk):
    losses, accs = chunk["tsys"].eval_step_multi(chunk["tstate"], chunk["stacked"])
    jl, ja = chunk["eval"]
    assert losses.shape == accs.shape == (K, 2)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    # accuracies are means of 0/1 hits: equal but for the mean's last bit
    np.testing.assert_allclose(accs.numpy(), np.asarray(ja), rtol=0, atol=1e-6)


def test_chunk_equals_sequential_steps_bit_for_bit(chunk):
    tsys, state = chunk["tsys"], chunk["tstate"]
    seq, losses = state, []
    for b in chunk["batches"]:
        seq, out = tsys.train_step(seq, b, epoch=0)
        losses.append(out.loss)
    new, (chunk_losses, _, lrs) = tsys.train_step_multi(state, chunk["stacked"], 0)
    assert torch.equal(torch.stack(losses), chunk_losses)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(seq.params), tree_leaves(new.params)))
    assert torch.equal(lrs[-1], tsys.schedule(torch.tensor(K - 1)))
    ev = torch.stack([tsys.eval_step(state, b).per_task_losses for b in chunk["batches"]])
    assert torch.equal(ev, tsys.eval_step_multi(state, chunk["stacked"])[0])


def _cpu_mesh():
    return make_mesh(tcfg.ParallelConfig(dp=2), [torch.device("cpu")] * 2)


def test_flipping_chunk_and_mesh_batches_are_refused(chunk):
    """The flipping chunk stays refused. The mesh's case, refused until
    ROADMAP.md A10.5 (mesh): a sharded chunk now runs, bit-equal to K
    sharded ``train_step`` calls (one sharded batch is not a chunk and is
    refused)."""
    tsys, state = chunk["tsys"], chunk["tstate"]
    # 4 iterations per epoch, MSL for 3 epochs: steps 10..12 span epochs 2
    # and 3, where the MSL window closes
    late = state._replace(step=torch.tensor(10))
    with pytest.raises(ValueError, match="flips"):
        tsys.train_step_multi(late, chunk["stacked"])
    start, _ = tsys.train_step_multi(state, chunk["stacked"])  # epoch read from the step: 0..2
    assert int(start.step) == K
    mesh = _cpu_mesh()
    with pytest.raises(TypeError, match="shard_chunk"):
        tsys.train_step_multi(state, shard_batch(chunk["batches"][0], mesh), 0)
    seq, losses = replicate(state, mesh), []
    for b in chunk["batches"]:
        seq, out = tsys.train_step(seq, shard_batch(b, mesh), epoch=0)
        losses.append(out.loss)
    new, (chunk_losses, _, _) = tsys.train_step_multi(replicate(state, mesh), shard_chunk(chunk["stacked"], mesh), 0)
    assert torch.equal(torch.stack(losses), chunk_losses)
    got, want = unreplicate(new), unreplicate(seq)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves_any(got), tree_leaves_any(want)))
    assert int(got.step) == K


def test_mesh_chunk_matches_jax_meshless_program(chunk):
    """The dp=2 chunk against JAX's ``train_step_multi`` on the same global
    batches without a mesh: the losses within rtol 1e-5, the state within
    atol 1e-5 (the elastic tests' hold of dp to JAX); conv biases left out,
    as above."""
    tsys, jnew = chunk["tsys"], chunk["jnew"]
    mesh = _cpu_mesh()
    new, (losses, _, _) = tsys.train_step_multi(chunk["tstate"], shard_chunk(chunk["stacked"], mesh), 0)
    np.testing.assert_allclose(losses.numpy(), np.asarray(chunk["outs"][0]), rtol=1e-5, atol=0)
    new, fs = unreplicate(new), tsys.model.feature_shape
    got = params_to_jax(new.params, fs)
    for stage in ("stage_0", "stage_1"):
        _close(got[stage]["conv"]["w"], jnew.params[stage]["conv"]["w"])
        _close(got[stage]["bn"], jnew.params[stage]["bn"])
    _close(got["fc"], jnew.params["fc"])
    _close(params_to_jax(new.inner_hparams, fs), jnew.inner_hparams)
    assert int(new.step) == K


def test_fused_eval_on_a_mesh_equals_the_sharded_eval(chunk):
    tsys, state = chunk["tsys"], chunk["tstate"]
    mesh = _cpu_mesh()
    losses, accs = tsys.eval_step_multi(replicate(state, mesh), shard_chunk(chunk["stacked"], mesh))
    outs = [tsys.eval_step(state, shard_batch(b, mesh)) for b in chunk["batches"]]
    assert torch.equal(losses, torch.stack([o.per_task_losses for o in outs]))
    assert torch.equal(accs, torch.stack([o.per_task_accuracies for o in outs]))


def _epoch(module_runner, cfg, system, start=None):
    """One train epoch of a new runner (from ``start(runner)``'s state where
    given) -> (its statistics, the runner)."""
    runner = module_runner(cfg, system=system)
    if start is not None:
        runner.state = start(runner)
    try:
        stats = runner._train_epoch(0)
    finally:
        runner.loader.close()
        runner.events.close()
    return stats, runner


def test_runner_epoch_with_multi_dispatch(toy_dataset, tmp_path):  # noqa: F811
    """The port's runners start from the JAX runner's initial weights (the
    packages draw their own), over the same episode stream."""
    common = dict(total_epochs=1, total_iter_per_epoch=3, num_evaluation_tasks=2)
    jcfg = jax_config(toy_dataset, tmp_path / "jax", train_steps_per_dispatch=2, **common)
    jax_runner = JaxRunner(jcfg, system=jax_small_system(jcfg))
    jax_start = jax_runner.state
    jax_runner.loader.close()
    jax_runner.events.close()
    out = {}
    for k in (1, 2):
        cfg = runner_config(toy_dataset, tmp_path / f"k{k}", train_steps_per_dispatch=k, **common)
        out[k] = _epoch(ExperimentRunner, cfg, small_system(cfg), lambda r: port_state(jax_start, r.system))
    (s1, r1), (s2, r2) = out[1], out[2]
    for key in ("train_loss_mean", "train_accuracy_mean", "learning_rate"):
        assert s1[key] == s2[key], key
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(r1.state.params), tree_leaves(r2.state.params)))
    assert int(r2.state.step) == 3
    js, jr = _epoch(JaxRunner, jcfg, jax_small_system(jcfg), lambda r: jax_start)
    assert int(jr.state.step) == 3
    for key in ("train_loss_mean", "train_accuracy_mean"):
        np.testing.assert_allclose(s2[key], js[key], rtol=0, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(s2["learning_rate"], js["learning_rate"], rtol=1e-6)
    jax.clear_caches()


def test_runner_epoch_with_multi_dispatch_on_a_mesh(toy_dataset, tmp_path):  # noqa: F811
    """JAX's ``test_runner_epoch_with_multi_dispatch`` on a dp=2 mesh over
    ``[cpu, cpu]``: K=2 (a sharded chunk and a single sharded step) within
    rtol 1e-5 of K=1, the state replicated on the mesh after it."""
    common = dict(total_epochs=1, total_iter_per_epoch=3, num_evaluation_tasks=2, parallel=tcfg.ParallelConfig(dp=2))
    out = {}
    for k in (1, 2):
        cfg = runner_config(toy_dataset, tmp_path / f"k{k}", train_steps_per_dispatch=k, **common)
        runner = ExperimentRunner(cfg, system=small_system(cfg), devices=[torch.device("cpu")] * 2)
        assert runner.mesh is not None and runner.mesh.shape["dp"] == 2
        try:
            out[k] = (runner._train_epoch(0), runner)
        finally:
            runner.loader.close()
            runner.events.close()
    (s1, r1), (s2, r2) = out[1], out[2]
    for key in ("train_loss_mean", "train_accuracy_mean", "learning_rate"):
        np.testing.assert_allclose(s2[key], s1[key], rtol=1e-5, atol=0, err_msg=key)
    assert int(r2.state.step) == 3 and len(r2.state.replicas) == 2
    for a, b in zip(tree_leaves(unreplicate(r1.state).params), tree_leaves(unreplicate(r2.state).params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-7)


def test_nan_under_multi_dispatch_discards_the_chunk(toy_dataset, tmp_path):  # noqa: F811
    cfg = runner_config(toy_dataset, tmp_path, total_epochs=1, total_iter_per_epoch=4, train_steps_per_dispatch=2,
                        resilience=tcfg.ResilienceConfig(faults=["runner.step=nan-loss:nth=2"]))
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    start = [t.clone() for t in tree_leaves(runner.state.params)]
    dispatched = []
    real = runner.system.train_step_multi

    def spy(state, batches, epoch=None):
        dispatched.append(int(state.step))
        return real(state, batches, epoch)

    runner.system.train_step_multi = spy
    try:
        stats = runner._train_epoch(0)
    finally:
        runner.loader.close()
        runner.events.close()
    # chunk 1 (steps 0-1) trains; chunk 2 is poisoned: the state before it
    # is restored, so the epoch ends at step 2 with chunk 1's statistics
    assert dispatched == [0, 2]
    assert int(runner.state.step) == 2 and runner._bad_steps == 1
    assert np.isfinite(stats["train_loss_mean"])
    assert not all(torch.equal(a, b) for a, b in zip(start, tree_leaves(runner.state.params)))
    with open(os.path.join(runner.logs_dir, "events.jsonl")) as f:
        events = [e.get("event") for e in map(json.loads, f)]
    assert events.count("nan_step_skipped") == 1


def test_fused_eval_stats_equal_per_batch_stats(toy_dataset, tmp_path):  # noqa: F811
    stats = {}
    for fused in (False, True):
        cfg = runner_config(toy_dataset, tmp_path / str(fused), eval_fused_dispatch=fused, num_evaluation_tasks=6,
                            total_epochs=1)
        runner = ExperimentRunner(cfg, system=small_system(cfg))
        try:
            stats[fused] = runner._eval_split("val")
        finally:
            runner.loader.close()
            runner.events.close()
    assert stats[True] == stats[False]
    assert stats[True]["val_num_episodes"] == 6


def test_runner_with_every_program_layer_option_writes_the_ledger(toy_dataset, tmp_path):  # noqa: F811
    """K=2, the fused eval and the profiler window together, to the end:
    the ledger holds the chunk, the single step and the fused eval, the
    window's trace is written, the run's test statistics are finite."""
    cfg = runner_config(toy_dataset, tmp_path, total_epochs=2, total_iter_per_epoch=3, train_steps_per_dispatch=2,
                        eval_fused_dispatch=True, profile_dir=str(tmp_path / "prof"))
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    result = runner.run_experiment()
    with open(os.path.join(runner.logs_dir, "compile_ledger.jsonl")) as f:
        names = {json.loads(line)["program"] for line in f}
    # epoch 0 is profiled at K = 1; epoch 1 runs one chunk and one step
    assert names == {"train/True/True", "train_multi/True/True", "eval_multi"}
    assert os.listdir(tmp_path / "prof" / "plugins" / "profile")
    assert np.isfinite(result["test_loss_mean"]) and int(runner.state.step) == 6
