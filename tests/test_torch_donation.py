"""Buffer donation in the port (``donate_train_state``, ``donate_batch``,
``observability/donation.py``) against the JAX package's, on the CPU.

- ``donation_audit`` equals JAX's for the same config and state shapes,
  over the flags and the multi-step chunk;
- a donated ``train_step`` returns the tensors it was given (the same
  storage), bit-equal to the plain step; on one device, on a dp=2 mesh and
  on a dp=2 x mp=2 mesh; ``donate_batch`` empties the batch;
- ``donation_selfcheck`` reads ``clean`` on the port; an arm made to
  corrupt its state reads ``corruption``, and the runner then writes
  ``donation_refused`` and trains without donation;
- the runner under donation: the self-check and audit events, the audit's
  bytes in the compile ledger, the checkpoint writer synchronous, a NaN
  step discarded and training continued from the last good state.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.observability import donation as jax_donation
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch import parallel as tpar
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.core.programs import clone_tree, tree_leaves_any
from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.observability import donation

from .test_torch_runner import THREADS, _events, _jsonl, _nan_drill, runner_config, small_system, toy_dataset  # noqa: F401
from .test_torch_train import _configs, pair

TINY = (8, 8, 1)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("donate_state,donate_batch,k", [(False, False, 1), (True, False, 1), (False, True, 3),
                                                         (True, True, 3)])
def test_donation_audit_equals_jax(donate_state, donate_batch, k):
    flags = dict(donate_train_state=donate_state, donate_batch=donate_batch, train_steps_per_dispatch=k)
    jsys, jstate, tsys, tstate = pair("vgg", **flags)
    # the port's step is int64: JAX's audit of the same shapes gets one
    want = jax_donation.donation_audit(jsys.cfg, jstate._replace(step=np.int64(0)))
    got = donation.donation_audit(tsys.cfg, tstate)
    assert got.pop("graph_state_in_place") is True
    assert got == want
    assert donation.tree_bytes(tstate) == jax_donation.tree_bytes(jstate) + 4
    spec = donation.episode_batch_spec(tsys.cfg)
    assert {k: (v.shape, v.dtype) for k, v in spec.items()} == {
        k: (v.shape, v.dtype) for k, v in jax_donation.episode_batch_spec(jsys.cfg).items()}


def test_compare_arms_and_verdict_equal_jax():
    rng = np.random.RandomState(0)
    params_a = {"fc": {"w": rng.randn(3, 4).astype(np.float32), "b": rng.randn(3).astype(np.float32)}}
    params_b = {"fc": {"w": params_a["fc"]["w"] + 1e-3, "b": params_a["fc"]["b"] * 2}}
    for la, lb in (([1.0, 0.9, 0.8], [1.0, 0.9, 0.8]), ([1.0, 0.5], [1.2, 0.5]), ([1.0, 0.9, 0.1], [1.0, 0.9, 0.9])):
        got = donation.compare_arms(la, params_a, lb, params_b)
        want = jax_donation.compare_arms(la, params_a, lb, params_b)
        assert got == pytest.approx(want) or got == want
        assert donation.verdict_from(got) == jax_donation.verdict_from(want)
    assert (donation.EARLY_LOSS_TOL, donation.CATASTROPHIC_LOSS, donation.CATASTROPHIC_REL) == (
        jax_donation.EARLY_LOSS_TOL, jax_donation.CATASTROPHIC_LOSS, jax_donation.CATASTROPHIC_REL)
    kw = dict(num_classes_per_set=5, batch_size=4, number_of_training_steps_per_iter=4)
    jc, tc = jcfg.Config(**kw), tcfg.Config(**kw)
    for field in ("batch_size", "num_classes_per_set", "number_of_training_steps_per_iter", "unroll_inner_steps",
                  "remat_inner_steps", "remat_policy", "train_steps_per_dispatch"):
        assert getattr(donation._tiny_probe_config(tc), field) == getattr(jax_donation._tiny_probe_config(jc), field)


# ---------------------------------------------------------------------------
# the donated step
# ---------------------------------------------------------------------------


def _small(mesh_kind, **overrides):
    _, tc = _configs(num_classes_per_set=4, batch_size=4, use_pallas_inner_update=True, **overrides)
    if mesh_kind == "dp2mp2":
        tc = dataclasses.replace(tc, parallel=tcfg.ParallelConfig(dp=2, mp=2, tp_convs=True))
    system = MAMLSystem(tc, model=build_vgg(TINY, 4, num_stages=2, cnn_num_filters=8), device="cpu")
    state = system.init_train_state(seed=1)
    if mesh_kind == "single":
        return system, state, lambda b: b
    mesh = tpar.make_mesh(system.cfg.parallel if mesh_kind == "dp2mp2" else tcfg.ParallelConfig(dp=2), ["cpu"] * 4)
    return system, tpar.shard_train_state(state, mesh), lambda b: tpar.shard_batch(b, mesh)


def _tensors(state):
    if isinstance(state, tpar.Replicated):
        return [t for r in state.replicas for t in tree_leaves_any(r)]
    return tree_leaves_any(state)


@pytest.mark.parametrize("mesh_kind", ["single", "dp2", "dp2mp2"])
def test_donated_step_writes_in_place_and_is_bit_equal(mesh_kind):
    b = learnable_synthetic_batch(4, 4, 2, 2, TINY, seed=2)
    system, state, feed = _small(mesh_kind)
    plain_state, plain_out = system.train_step(clone_tree(state), feed(b), epoch=0)
    dsystem, dstate, dfeed = _small(mesh_kind, donate_train_state=True)
    given = _tensors(dstate)
    ptrs = [t.data_ptr() for t in given]
    for _ in range(2):  # twice: the second step reads what the first wrote
        new, out = dsystem.train_step(dstate, dfeed(b), epoch=0)
        assert new is dstate
        plain_state, plain_out = (plain_state, plain_out) if _ == 0 else system.train_step(plain_state, feed(b),
                                                                                           epoch=0)
        assert float(out.loss) == float(plain_out.loss)
        got = _tensors(new)
        assert [t.data_ptr() for t in got] == ptrs and all(a is c for a, c in zip(got, given))
        for a, c in zip(tree_leaves_any(tpar.unreplicate(new)), tree_leaves_any(tpar.unreplicate(plain_state))):
            assert torch.equal(a, c)
    assert int(tpar.unreplicate(new).step) == 2


def test_donate_batch_empties_the_batch_and_changes_nothing_else():
    system, state, _ = _small("single")
    dsystem, dstate, _ = _small("single", donate_batch=True)
    b = learnable_synthetic_batch(4, 4, 2, 2, TINY, seed=4)
    given = {k: torch.as_tensor(v) for k, v in b.items()}
    plain, out = system.train_step(state, dict(given), epoch=0)
    new, dout = dsystem.train_step(dstate, given, epoch=0)
    assert given == {} and float(out.loss) == float(dout.loss)
    for a, c in zip(tree_leaves_any(plain), tree_leaves_any(new)):
        assert torch.equal(a, c)
    mesh = tpar.make_mesh(tcfg.ParallelConfig(dp=2), ["cpu"] * 2)
    sharded = tpar.shard_batch(b, mesh)
    dsystem.train_step(dstate, sharded, epoch=0)
    assert sharded.shards == [{}, {}]


def test_selfcheck_is_clean_and_a_corrupting_arm_is_caught():
    _, tc = _configs(num_classes_per_set=3, batch_size=2, donate_train_state=True)
    result = donation.donation_selfcheck(tc, n_steps=3, device="cpu")
    assert result["verdict"] == "clean" and result["backend"] == "cpu" and result["max_loss_dev"] == 0.0
    assert result["global_param_rel"] == 0.0

    def corrupting(donate):
        """An arm whose donated step lands garbage in the state it wrote
        into, as a donated buffer reused by the next batch's copy would."""
        probe = dataclasses.replace(donation._tiny_probe_config(tc), donate_train_state=donate)
        system = MAMLSystem(probe, device="cpu")
        real = system.train_step

        def step(state, batch, epoch=None):
            new, out = real(state, batch, epoch=epoch)
            if donate:
                for t in tree_leaves_any(new.params):
                    t.add_(0.5)
            return new, out

        system.train_step = step
        return donation.run_donation_arm(probe, 3, 3, system=system)

    bad = donation.donation_selfcheck(tc, run_arm=corrupting, device="cpu")
    assert bad["verdict"] == "corruption" and bad["early_loss_dev"] > donation.EARLY_LOSS_TOL


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def test_runner_under_donation(toy_dataset, tmp_path):
    cfg = runner_config(toy_dataset, tmp_path, experiment_name="toy_donate", donate_train_state=True,
                        total_epochs=1, total_iter_per_epoch=2)
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    assert runner._ckpt_writer is None
    plain = ExperimentRunner(runner_config(toy_dataset, tmp_path, experiment_name="toy_plain"),
                             system=small_system(runner_config(toy_dataset, tmp_path)))
    assert plain._ckpt_writer is not None
    plain.loader.close()
    plain.events.close()
    given = tree_leaves_any(runner.state)
    in_place = []
    real = runner.system.train_step

    def step(state, batch, epoch=None):
        new, out = real(state, batch, epoch=epoch)
        in_place.append(new is state and all(a is c for a, c in zip(tree_leaves_any(new), given)))
        return new, out

    runner.system.train_step = step
    runner.run_experiment()
    events = _events(runner.run_dir)
    (check,) = [e for e in events if e.get("event") == "donation_selfcheck"]
    assert check["verdict"] == "clean"
    (audit,) = [e for e in events if e.get("event") == "donation_audit"]
    assert audit["flags"] == {"donate_train_state": True, "donate_batch": False}
    assert audit["donated_bytes"] == audit["state_bytes"] > 0
    # the state trained in place, and the ledger carries the audit's bytes
    assert in_place == [True, True]
    entries = _jsonl(os.path.join(runner.logs_dir, "compile_ledger.jsonl"))
    assert {e["program"] for e in entries} >= {"train/True/True"}
    summary = runner._compile_ledger.summary() if runner._compile_ledger is not None else None
    if summary is not None:
        assert summary["donated_bytes"] == audit["state_bytes"]


def test_runner_refuses_donation_on_a_corrupting_arm(toy_dataset, tmp_path, monkeypatch):
    real_arm = donation.run_donation_arm

    def corrupting(cfg, n_steps, n_batches=16, system=None, device=None):
        losses, params = real_arm(cfg, n_steps, n_batches, system, device)
        if cfg.donate_train_state:
            losses = [x + 1.0 for x in losses]
        return losses, params

    monkeypatch.setattr(donation, "run_donation_arm", corrupting)
    cfg = runner_config(toy_dataset, tmp_path, experiment_name="toy_refused", donate_train_state=True,
                        total_epochs=1, total_iter_per_epoch=2)
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    in_place = []
    real = runner.system.train_step

    def step(state, batch, epoch=None):
        new, out = real(state, batch, epoch=epoch)
        in_place.append(new is state)
        return new, out

    runner.system.train_step = step
    runner.run_experiment()
    events = _events(runner.run_dir)
    (refused,) = [e for e in events if e.get("event") == "donation_refused"]
    assert refused["verdict"] == "corruption", refused
    assert not [e for e in events if e.get("event") == "donation_selfcheck"]
    # trained without donation: every step made a new state
    assert runner.cfg.donate_train_state is False and in_place == [False, False]
    (audit,) = [e for e in events if e.get("event") == "donation_audit"]
    assert audit["flags"]["donate_train_state"] is False


def test_nan_step_under_donation_restores_the_last_good_state(toy_dataset, tmp_path):
    cfg = runner_config(toy_dataset, tmp_path, experiment_name="toy_donate_nan", donate_train_state=True,
                        donation_selfcheck=False, total_iter_per_epoch=4, resilience=_nan_drill("nth=2"))
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    last_good = [t.clone() for t in tree_leaves_any(runner._last_good)]
    seen = []
    real = runner.system.train_step

    def step(state, batch, epoch=None):
        seen.append([t.clone() for t in tree_leaves_any(state)])
        return real(state, batch, epoch=epoch)

    runner.system.train_step = step
    stats = runner._train_epoch(0)
    # steps 2 and 3 are discarded; step 4 starts from the last good state
    # (the run's start: no checkpoint yet), which the donated steps left alone
    assert len(seen) == 4
    assert all(torch.equal(a, c) for a, c in zip(seen[3], last_good))
    assert all(torch.equal(a, c) for a, c in zip(tree_leaves_any(runner._last_good), last_good))
    assert [e["consecutive"] for e in _events(runner.run_dir) if e.get("event") == "nan_step_skipped"] == [1]
    assert np.isfinite(stats["train_loss_mean"])
    runner.events.close()
    runner.loader.close()


def test_compile_ledger_takes_donated_bytes_from_the_audit():
    """JAX fills a program's ``donated_bytes`` from its compiled
    ``alias_bytes``; the port from the audit, for programs built before
    and after the audit."""
    from howtotrainyourmamlpytorch_tpu_torch.observability.compile_ledger import CompileLedger

    _, _, tsys, tstate = pair("vgg", donate_train_state=True)
    audit = donation.donation_audit(tsys.cfg, tstate)
    ledger = CompileLedger()
    ledger.record(("train", True, True), total_s=0.1)
    ledger.note_donation(audit)
    ledger.record(("train", False, False), total_s=0.1)
    ledger.record(("eval",), total_s=0.1)
    by_program = ledger.summary()["by_program"]
    assert by_program["train/True/True"]["donated_bytes"] == audit["state_bytes"]
    assert by_program["train/False/False"]["donated_bytes"] == audit["state_bytes"]
    assert by_program["eval"]["donated_bytes"] is None
    assert ledger.summary()["donated_bytes"] == audit["state_bytes"]
