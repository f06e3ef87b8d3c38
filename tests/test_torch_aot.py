"""The port's prewarm (``compile/aot.py``) against the JAX package's
(``tests/test_aot.py``), on the CPU, at a small VGG (2 stages, 4 filters,
28x28) from a numpy seed:

- the prewarm plan is exactly ``train_planned_programs(cfg)``, with JAX's
  program names for the same config; every ledger entry is
  ``phase="prewarm"``; after a ``train_step``, an ``eval_step``, a
  ``train_step_multi`` and an ``eval_step_multi`` the guard is sealed with
  zero violations and the ledger holds nothing else;
- the real state is bit-identical before and after the prewarm;
- the manifest: round trip, live match, a fingerprint mismatch with its
  reason, the kernels' build directory's state, the environment fields
  without the device count, its keys and program names equal to JAX's
  manifest for the same config;
- a real dispatch of another signature is recorded under
  ``phase="prewarm_respec"``; a mesh a graph cannot hold runs eager,
  recorded as ``graph: false`` with the reason;
- ``aot.enabled`` off writes no file; the prewarm CLI's usage errors (rc 2,
  one JSON line) and a CPU run of it;
- a prewarmed runner across the MSL flip gives losses bit-equal to an
  unprewarmed one, with zero guard violations."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.compile import aot as jax_aot
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu.observability.compile_ledger import program_name as jax_program_name
from howtotrainyourmamlpytorch_tpu.utils.strictmode import train_planned_programs as jax_planned
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.compile import aot
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.core.programs import GraphProgram, tree_leaves_any
from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.observability.compile_ledger import CompileLedger, program_name
from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import make_mesh, replicate, shard_chunk
from howtotrainyourmamlpytorch_tpu_torch.utils.strictmode import train_planned_programs

from .test_torch_runner import THREADS, _env, _events, _jsonl, runner_config, small_system, toy_dataset  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_IMG = (28, 28, 1)
_PREWARM_CLI = os.path.join(_ROOT, "howtotrainyourmamlpytorch_tpu_torch", "scripts", "prewarm.py")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _kw(**overrides):
    """The small cell: 3-way 1-shot, 2 targets, 2 tasks, K=2 inner steps,
    2 steps per dispatch, 4 eval tasks (2 eval batches), second order and
    MSL on, the strict guard."""
    base = dict(
        num_classes_per_set=3, num_samples_per_class=1, num_target_samples=2, batch_size=2,
        number_of_training_steps_per_iter=2, number_of_evaluation_steps_per_iter=2, num_evaluation_tasks=4,
        train_steps_per_dispatch=2, strict_recompile_guard=True, remat_inner_steps=False,
    )
    base.update(overrides)
    return base


def _port(**overrides):
    cfg = tcfg.Config(**_kw(**overrides))
    system = MAMLSystem(cfg, model=build_vgg(_IMG, 3, num_stages=2, cnn_num_filters=4), device="cpu")
    return cfg, system


def _batch(cfg, seed, n=None):
    """One batch of the cell, or a stack of ``n`` (a leading ``[n]`` axis)."""
    draw = lambda s: learnable_synthetic_batch(cfg.batch_size, cfg.num_classes_per_set,  # noqa: E731
                                               cfg.num_samples_per_class, cfg.num_target_samples, _IMG, seed=s)
    if n is None:
        return draw(seed)
    batches = [draw(seed + i) for i in range(n)]
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def test_train_prewarm_plan_is_exactly_the_guard_planned_set():
    cfg, system = _port()
    entries = []
    ledger = CompileLedger()
    ledger.on_entry = entries.append
    system.attach_compile_ledger(ledger)
    state = system.init_train_state(seed=0)

    summary = system.prewarm(state)

    planned = {program_name(k) for k in train_planned_programs(cfg)}
    jax_cfg = jcfg.Config(**_kw())
    assert planned == {jax_program_name(k) for k in jax_planned(jax_cfg)} and len(planned) == 10
    assert set(summary["by_program"]) == planned
    assert summary["programs"] == len(planned) and summary["errors"] == 0
    assert {"seconds", "compile_s", "cache_hits", "store_hits", "already_warm"} <= set(summary)
    assert entries and all(e.get("phase") == "prewarm" for e in entries)
    assert {e["program"] for e in entries} == planned
    assert all(e["total_s"] is not None and e["total_s"] >= 0 for e in entries)
    snap = system.recompile_guard.snapshot()
    assert snap["prewarmed"] and snap["violations"] == [] and snap["lowerings"] == len(planned)

    # real traffic of every kind dispatches what the prewarm built
    _, out = system.train_step(state, _batch(cfg, 0), epoch=0)
    assert np.isfinite(float(out.loss))
    assert np.isfinite(float(system.eval_step(state, _batch(cfg, 1)).loss))
    _, (losses, _, _) = system.train_step_multi(state, _batch(cfg, 2, n=cfg.train_steps_per_dispatch), 0)
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    n_eval = cfg.num_evaluation_tasks // cfg.batch_size
    eval_losses, _ = system.eval_step_multi(state, _batch(cfg, 5, n=n_eval))
    assert eval_losses.shape == (n_eval, cfg.batch_size)
    assert system.recompile_guard.snapshot()["violations"] == []
    assert len(entries) == len(planned) and all(e.get("phase") == "prewarm" for e in entries)


def test_prewarm_leaves_the_real_state_bit_identical():
    cfg, system = _port()
    state = system.init_train_state(seed=3)
    before = [t.clone() for t in tree_leaves_any(state)]
    system.prewarm(state)
    after = tree_leaves_any(state)
    assert len(before) == len(after) and all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(state.step) == 0


def test_manifest_program_keys_and_layout_equal_jax():
    """JAX's prewarm and the port's on the same first-order config (4
    programs, cheap for XLA on the CPU): the manifests' keys, their
    programs, the cache record's keys, and JAX's per-program keys all in
    the port's rows."""
    overrides = dict(second_order=False, use_multi_step_loss_optimization=False)
    jax_cfg = jcfg.Config(**_kw(**overrides))
    jsys = JaxMAMLSystem(jax_cfg, model=jax_build_vgg(_IMG, 3, num_stages=2, cnn_num_filters=4))
    jax_manifest = jax_aot.build_manifest(train_summary=jsys.prewarm(jsys.init_train_state(), max_workers=1),
                                          mesh_shape=[1, 1])
    _, system = _port(**overrides)
    manifest = aot.build_manifest(train_summary=system.prewarm(system.init_train_state(seed=0)), mesh_shape=[1, 1],
                                  device="cpu")
    assert set(manifest) == set(jax_manifest)
    assert set(manifest["programs"]) == set(jax_manifest["programs"]) and len(manifest["programs"]) == 4
    assert set(manifest["cache"]) == set(jax_manifest["cache"])
    for name, row in jax_manifest["programs"].items():
        assert set(row) <= set(manifest["programs"][name]), name
    assert manifest["version"] == jax_manifest["version"] == aot.MANIFEST_VERSION


# ---------------------------------------------------------------------------
# the manifest (tests/test_aot.py:124-196, on the kernels' build directory)
# ---------------------------------------------------------------------------


def _manifest(tmp_path, entries=2, **fp_overrides):
    d = tmp_path / "build"
    d.mkdir(exist_ok=True)
    for i in range(entries):
        (d / f"libkernel{i}-0123456789abcdef.so").write_bytes(b"x")
    fp = aot.environment_fingerprint([1, 1], device="cpu")
    fp.update(fp_overrides)
    return {"version": aot.MANIFEST_VERSION, "ts": 0.0, "fingerprint": fp, "cache": aot.cache_state(str(d)),
            "programs": {"train/False/False": {"signature": "abc"}}}


def test_verify_manifest_matches_live_environment(tmp_path):
    assert aot.verify_manifest(_manifest(tmp_path), [1, 1], device="cpu") == (True, None)
    # a caller that does not know its mesh yet skips the mesh field only
    assert aot.verify_manifest(_manifest(tmp_path), None, device="cpu") == (True, None)
    fp = aot.environment_fingerprint([2, 1], device="cpu")
    assert set(fp) == {"torch", "cuda", "backend", "device_kind", "n_devices", "mesh"}
    assert fp["torch"] == torch.__version__ and fp["backend"] == "cpu" and fp["mesh"] == [2, 1]


def test_verify_manifest_fingerprint_mismatch_is_cold_with_reason(tmp_path):
    ok, reason = aot.verify_manifest(_manifest(tmp_path, torch="0.0.0"), [1, 1], device="cpu")
    assert not ok and "torch" in reason
    ok, reason = aot.verify_manifest(_manifest(tmp_path, device_kind="NVIDIA H100 80GB HBM3 (sm_90)"), [1, 1],
                                     device="cpu")
    assert not ok and "device_kind" in reason
    ok, reason = aot.verify_manifest(_manifest(tmp_path), [4, 2], device="cpu")
    assert not ok and "mesh" in reason


def test_verify_manifest_build_directory_state(tmp_path):
    manifest = _manifest(tmp_path)
    assert manifest["cache"]["entries"] == 2 and manifest["cache"]["digest"]
    (tmp_path / "build" / "libkernel0-0123456789abcdef.so").unlink()
    ok, reason = aot.verify_manifest(manifest, [1, 1], device="cpu")
    assert not ok and "shrank" in reason
    (tmp_path / "build" / "libkernel1-0123456789abcdef.so").unlink()
    (tmp_path / "build").rmdir()
    ok, reason = aot.verify_manifest(manifest, [1, 1], device="cpu")
    assert not ok and "gone" in reason
    assert aot.verify_manifest(None, [1, 1]) == (False, "no prewarm manifest")
    bad = _manifest(tmp_path)
    bad["version"] = 99
    ok, reason = aot.verify_manifest(bad, [1, 1], device="cpu")
    assert not ok and "version" in reason
    empty = dict(bad, version=aot.MANIFEST_VERSION, cache=aot.cache_state(str(tmp_path / "none")))
    assert empty["cache"]["entries"] == 0
    ok, reason = aot.verify_manifest(empty, [1, 1], device="cpu")
    assert not ok and "no built kernel libraries" in reason


def test_manifest_save_load_round_trip(tmp_path):
    manifest = _manifest(tmp_path)
    path = ckpt.save_prewarm_manifest(str(tmp_path / "saved_models"), manifest)
    assert os.path.basename(path) == "prewarm_manifest.json"
    assert ckpt.load_prewarm_manifest(str(tmp_path / "saved_models")) == manifest
    with open(path, "w") as f:
        f.write("{not json")
    assert ckpt.load_prewarm_manifest(str(tmp_path / "saved_models")) is None
    assert ckpt.load_prewarm_manifest(str(tmp_path / "nope")) is None


def test_verify_manifest_environment_fields_skip_device_count(tmp_path):
    manifest = _manifest(tmp_path, n_devices=8, mesh=[4, 2])
    assert aot.verify_manifest(manifest, None, fields=aot.ENVIRONMENT_FIELDS, device="cpu") == (True, None)
    assert not aot.verify_manifest(manifest, [1, 1], device="cpu")[0]
    ok, reason = aot.verify_manifest(_manifest(tmp_path, cuda="0.0"), None, fields=aot.ENVIRONMENT_FIELDS,
                                     device="cpu")
    assert not ok and "cuda" in reason


# ---------------------------------------------------------------------------
# respec and the mesh's eager decision
# ---------------------------------------------------------------------------


def test_a_dispatch_of_another_signature_is_a_respec():
    cfg, system = _port(strict_recompile_guard=False)
    entries = []
    ledger = CompileLedger()
    ledger.on_entry = entries.append
    system.attach_compile_ledger(ledger)
    state = system.init_train_state(seed=0)
    system.prewarm(state)
    n = len(entries)
    # a batch of 4 tasks where the prewarm built 2
    wide = learnable_synthetic_batch(4, 3, 1, 2, _IMG, seed=9)
    system.eval_step(state, wide)
    assert [(e["program"], e.get("phase")) for e in entries[n:]] == [("eval", "prewarm_respec")]
    system.eval_step(state, wide)
    assert len(entries) == n + 1


def test_sharded_steps_share_one_signature():
    """A sharded batch's abstract signature is its shards' shapes on their
    devices (``ShardedBatch.abstract_signature``), not its identity: three
    sharded train steps through the ledger are one first dispatch (each
    was one, priced by the flop counter, before), and the signature tells a
    sharded batch from a plain one and one mesh from another."""
    from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import shard_batch
    from howtotrainyourmamlpytorch_tpu_torch.utils.strictmode import abstract_signature

    cfg, system = _port(strict_recompile_guard=False)
    entries = []
    ledger = CompileLedger()
    ledger.on_entry = entries.append
    system.attach_compile_ledger(ledger)
    mesh = make_mesh(tcfg.ParallelConfig(dp=2), [torch.device("cpu")] * 2)
    state = replicate(system.init_train_state(seed=0), mesh)
    for seed in range(3):
        state, _ = system.train_step(state, shard_batch(_batch(cfg, seed), mesh), epoch=0)
    assert [e["program"] for e in entries] == ["train/True/True"]
    plain, one = _batch(cfg, 0), shard_batch(_batch(cfg, 0), mesh)
    assert abstract_signature(one) == abstract_signature(shard_batch(_batch(cfg, 1), mesh))
    assert abstract_signature(one) != abstract_signature(plain)
    single = make_mesh(tcfg.ParallelConfig(dp=1), [torch.device("cpu")])
    assert abstract_signature(one) != abstract_signature(shard_batch(plain, single))


def test_a_mesh_no_graph_can_hold_runs_eager_and_says_why():
    """A ``GraphProgram`` given a chunk sharded over a mesh that is not one
    card (here the CPU, named twice) never captures: its warm and its first
    real dispatch are eager, each a ledger entry with ``graph: false`` and
    the reason; the dispatch equals the eager steps bit for bit."""
    cfg, system = _port(strict_recompile_guard=False)
    entries = []
    ledger = CompileLedger()
    ledger.on_entry = entries.append
    program = GraphProgram(system._eval_graph_step, "cpu", lambda: None, eager=system._eval_multi_eager,
                           stream_for=lambda: None)
    program.attach_ledger(ledger, "eval_multi")
    state = system.init_train_state(seed=0)
    mesh = make_mesh(tcfg.ParallelConfig(dp=2), [torch.device("cpu")] * 2)
    chunk = shard_chunk(_batch(cfg, 0, n=2), mesh)
    warm = program.warm(state, chunk)
    assert warm["graph"] is False and not warm["already_warm"]
    assert program.warm(state, chunk)["already_warm"]
    _, outs = program(replicate(state, mesh), chunk)
    _, want = system._eval_multi_eager(replicate(state, mesh), chunk)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(outs, want))
    wide = shard_chunk(_batch(tcfg.Config(**_kw(batch_size=4)), 0, n=2), mesh)
    program(state, wide)
    assert [(e.get("graph"), e.get("phase")) for e in entries] == [(False, "prewarm"), (False, "prewarm_respec")]
    assert all("not a card" in e["reason"] for e in entries) and not program.captures


# ---------------------------------------------------------------------------
# the runner and the CLI
# ---------------------------------------------------------------------------


def test_aot_disabled_writes_no_file(toy_dataset, tmp_path):  # noqa: F811
    cfg = runner_config(toy_dataset, tmp_path, total_epochs=1, total_iter_per_epoch=1)
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    runner.run_experiment()
    assert not os.path.exists(ckpt.prewarm_manifest_path(runner.saved_models_dir))
    events = _events(runner.run_dir)
    assert not [e for e in events if str(e.get("event", "")).startswith("prewarm")]
    assert [e["prewarmed"] for e in events if e.get("event") == "cold_start"] == [False]


def _epoch_losses(run_dir):
    return [(e["epoch"], e["train_loss_mean"], e["val_loss_mean"]) for e in _events(run_dir) if "train_loss_mean" in e]


def test_prewarmed_runner_across_the_msl_flip_matches_a_cold_one(toy_dataset, tmp_path):  # noqa: F811
    """2 epochs of 2 steps at K=2 with the MSL window closing after epoch 0
    (the train variant flips between the epochs), the strict guard on: the
    prewarmed run's losses bit-equal to the unprewarmed one's, no guard
    violation, and every build of the prewarmed run a prewarm entry."""
    runs = {}
    for aot_on in (False, True):
        cfg = runner_config(toy_dataset, tmp_path / str(aot_on), total_epochs=2, total_iter_per_epoch=2,
                            train_steps_per_dispatch=2, multi_step_loss_num_epochs=1, strict_recompile_guard=True,
                            aot=tcfg.AotConfig(enabled=aot_on))
        runner = ExperimentRunner(cfg, system=small_system(cfg))
        runner.run_experiment()
        assert runner.system.recompile_guard.snapshot()["violations"] == []
        runs[aot_on] = runner
    cold, warm = runs[False], runs[True]
    assert _epoch_losses(warm.run_dir) == _epoch_losses(cold.run_dir) and len(_epoch_losses(cold.run_dir)) == 2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves_any(cold.state), tree_leaves_any(warm.state)))
    entries = _jsonl(os.path.join(warm.logs_dir, "compile_ledger.jsonl"))
    assert entries and all(e.get("phase") == "prewarm" for e in entries)
    programs = {e["program"] for e in _jsonl(os.path.join(cold.logs_dir, "compile_ledger.jsonl"))}
    assert {"train_multi/True/True", "train_multi/True/False"} <= programs
    assert warm.system.recompile_guard.prewarmed
    # the port's obs_report reads the prewarm's entries
    spec = importlib.util.spec_from_file_location(
        "t_aot_obs_report", os.path.join(_ROOT, "howtotrainyourmamlpytorch_tpu_torch", "scripts", "obs_report.py"))
    obs_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(obs_report)
    report = obs_report.build_report(warm.run_dir)["prewarm"]
    assert report["programs"] == len(train_planned_programs(warm.cfg)) == 10
    assert report["respecs"] == 0 and report["captures"] == 0  # eager builds on the CPU
    assert "prewarm" not in obs_report.build_report(cold.run_dir)


def _cli(*args):
    proc = subprocess.run([sys.executable, _PREWARM_CLI, *args], cwd=_ROOT, env=_env(), capture_output=True,
                          text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout + proc.stderr
    return proc.returncode, json.loads(lines[0]), proc.stderr


def test_prewarm_cli_usage_errors_are_rc_2_with_one_json_line(tmp_path):
    rc, line, _ = _cli("--no-train")
    assert rc == 2 and line["ok"] is False and "nothing to do" in line["error"]
    rc, line, _ = _cli(str(tmp_path))
    assert rc == 2 and "no config.yaml" in line["error"]
    rc, line, _ = _cli("not_a_key=1", "--device", "cpu")
    assert rc == 2 and "not_a_key" in line["error"]


def test_prewarm_cli_on_a_run_dir_writes_the_manifest(tmp_path):
    """A run directory's config (3-way VGG-64 at 28x28, first order, no
    MSL: 4 programs) prewarmed on the CPU with the serving grid: rc 0, one
    JSON line, the manifest beside the checkpoints naming every program."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    cfg = tcfg.Config(**_kw(second_order=False, use_multi_step_loss_optimization=False,
                            strict_recompile_guard=False, serving=tcfg.ServingConfig(
                                support_buckets=[3], query_buckets=[6], max_batch_size=1)))
    tcfg.save_config(cfg, str(run_dir / "config.yaml"))
    rc, line, err = _cli(str(run_dir), "--serving", "--device", "cpu")
    assert rc == 0, err
    assert line["ok"] and line["platform"] == "cpu" and line["train"]["programs"] == 4
    assert line["train"]["errors"] == 0 and line["serving"]["errors"] == 0 and line["serving"]["programs"] == 2
    manifest = ckpt.load_prewarm_manifest(str(run_dir / "saved_models"))
    assert line["manifest"] == ckpt.prewarm_manifest_path(str(run_dir / "saved_models"))
    assert {program_name(k) for k in train_planned_programs(cfg)} <= set(manifest["programs"])
    assert len(manifest["programs"]) == 6 and manifest["fingerprint"]["backend"] == "cpu"
