"""The port's experiment runner on the CPU at a small size (2 stages, 4
filters, 3-way 2-shot, batch 2, 2 epochs of 3 iterations), on the toy image
folder of ``tests/test_runner.py``. It mirrors that file's tests (artifact
contract and resume, test-only evaluation, named and integer epochs,
per-episode eval statistics, the early abort) and adds: the artifact files
and CSV columns against a JAX runner's run; the NaN sentinel and its
rollback, and SIGTERM in a subprocess (rc 75, then an exact mid-epoch
resume), each drilled through the ``runner.step`` fault seam; the refused
options and those ROADMAP A9 and A10 made run; the CLI in a subprocess; and a run directory resumed
across the packages in both directions (the next step's loss within atol
1e-5, the same loader cursor)."""

import csv
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.experiment import ExperimentRunner as JaxRunner
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.experiment.storage import load_statistics
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 1e-5
# CPU threads for the runs here and in their subprocesses: the suite runs
# on several workers at once, and timing tests elsewhere share the cores
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _env():
    return dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS=str(THREADS))


@pytest.fixture(scope="module")
def toy_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "omniglot_toy"
    rng = np.random.RandomState(0)
    for a in range(4):
        for c in range(5):
            d = root / f"alpha{a}" / f"char{c}"
            d.mkdir(parents=True)
            base = (rng.rand(28, 28) > 0.5).astype(np.uint8) * 255
            for i in range(6):
                noisy = base ^ (rng.rand(28, 28) > 0.95).astype(np.uint8) * 255
                Image.fromarray(noisy, mode="L").convert("1").save(d / f"{i}.png")
    return str(root)


def _base(module, toy_dataset, root):
    return dict(
        dataset=module.DatasetConfig(name="omniglot_toy", path=toy_dataset),
        num_classes_per_set=3,
        num_samples_per_class=2,
        num_target_samples=2,
        batch_size=2,
        total_epochs=2,
        total_iter_per_epoch=3,
        num_evaluation_tasks=4,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
        experiment_root=str(root),
        experiment_name="toy_run",
        load_into_memory=True,
        num_dataprovider_workers=2,
        train_val_test_split=(0.6, 0.2, 0.2),  # 20 toy classes need a real val split
    )


def runner_config(toy_dataset, root, **overrides):
    return tcfg.Config(**{**_base(tcfg, toy_dataset, root), **overrides})


def jax_config(toy_dataset, root, **overrides):
    # one device, patches-GEMM convs: what the JAX runner runs on the CPU;
    # its lax.scan program without remat, the one that agrees with float64
    # on this jax (ROADMAP.md C: the unrolled and remat programs' train-step
    # losses move by ~6e-3 here)
    base = dict(_base(jcfg, toy_dataset, root), parallel=jcfg.ParallelConfig(dp=1), conv_via_patches=True,
                unroll_inner_steps=False, remat_inner_steps=False)
    return jcfg.Config(**{**base, **overrides})


def small_system(cfg):
    model = build_vgg((28, 28, 1), cfg.num_classes_per_set, num_stages=2, cnn_num_filters=4)
    return MAMLSystem(cfg, model=model, device="cpu")


def jax_small_system(cfg):
    model = jax_build_vgg((28, 28, 1), cfg.num_classes_per_set, num_stages=2, cnn_num_filters=4,
                          conv_via_patches=True)
    return JaxMAMLSystem(cfg, model=model)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _events(run_dir):
    return _jsonl(os.path.join(run_dir, "logs", "events.jsonl"))


def _header(path):
    with open(path) as f:
        return next(csv.reader(f))


def _files(run_dir):
    return sorted(
        os.path.relpath(os.path.join(d, name), run_dir)
        for d, _, names in os.walk(run_dir)
        for name in names
    )


# ---------------------------------------------------------------------------
# module-scoped runs: one epoch by each package's runner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run(toy_dataset, tmp_path_factory):
    """One epoch of the JAX runner (the reference run directory)."""
    root = tmp_path_factory.mktemp("jax_run")
    cfg = jax_config(toy_dataset, root, total_epochs=1)
    runner = JaxRunner(cfg, system=jax_small_system(cfg))
    runner.run_experiment()
    return runner.run_dir


@pytest.fixture(scope="module")
def port_run(toy_dataset, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_run")
    cfg = runner_config(toy_dataset, root, total_epochs=1)
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    runner.run_experiment()
    return runner.run_dir


# ---------------------------------------------------------------------------
# the tests of tests/test_runner.py
# ---------------------------------------------------------------------------


def test_end_to_end_artifacts_and_resume(toy_dataset, tmp_path, jax_run):
    cfg = runner_config(toy_dataset, tmp_path)
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    result = runner.run_experiment()

    run_dir = runner.run_dir
    logs = os.path.join(run_dir, "logs")
    assert os.path.isdir(os.path.join(run_dir, "saved_models"))
    assert os.path.isdir(os.path.join(run_dir, "visual_outputs"))
    rows = load_statistics(logs)
    assert len(rows) == 2
    for col in ("epoch", "train_accuracy_mean", "val_accuracy_mean",
                "train_loss_mean", "val_loss_mean", "learning_rate"):
        assert col in rows[0], f"missing column {col}"
    test_rows = load_statistics(logs, "test_summary.csv")
    assert "test_accuracy_mean" in test_rows[0]
    assert os.path.exists(os.path.join(run_dir, "config.yaml"))
    assert os.path.exists(os.path.join(logs, "toy_run.json"))
    with open(os.path.join(run_dir, "lrs.csv")) as f:
        lr_rows = list(csv.reader(f))
    assert len(lr_rows) == 2
    assert "test_accuracy_mean" in result

    # the JAX runner's contract: the same files, the same compile-ledger
    # program names (the first dispatch of the train variant and of eval)
    # and the same CSV columns
    jax_files = _files(jax_run)
    ledger_names = lambda d: sorted({e["program"] for e in _jsonl(os.path.join(d, "logs", "compile_ledger.jsonl"))})  # noqa: E731
    assert ledger_names(run_dir) == ledger_names(jax_run)
    assert _files(run_dir) == [f for f in jax_files if not f.startswith("saved_models")] + sorted(
        os.path.join("saved_models", f"train_model_{i}") for i in (0, 1, "best", "latest"))
    for name in ("summary_statistics.csv", "test_summary.csv"):
        assert _header(os.path.join(logs, name)) == _header(os.path.join(jax_run, "logs", name)), name
    with open(os.path.join(jax_run, "lrs.csv")) as f:
        assert [len(r) for r in lr_rows] == [len(next(csv.reader(f)))] * 2

    # resume: a new runner continues from epoch 2 without retraining
    cfg2 = runner_config(toy_dataset, tmp_path, total_epochs=3)
    runner2 = ExperimentRunner(cfg2, system=small_system(cfg2))
    assert runner2.start_epoch == 2
    assert runner2.loader.train_episodes_produced == 2 * 3 * 2  # epochs*iters*batch
    runner2.run_experiment()
    assert len(load_statistics(logs)) == 3


def test_anil_run_trains_validates_checkpoints_and_resumes(toy_dataset, tmp_path):
    """``strategy=anil`` through the runner: an epoch with validation, its
    checkpoints, the best checkpoint's test; a new runner resumes it and
    trains only the next epoch; the body's weights moved (the outer step
    reaches the body through the forwards)."""
    cfg = runner_config(toy_dataset, tmp_path, strategy="anil", total_epochs=1)
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    assert runner.system.strategy == "anil"
    start = {k: t.clone() for k, t in runner.state.params["stage_0"]["conv"].items()}
    result = runner.run_experiment()
    assert np.isfinite(result["test_loss_mean"])
    assert not torch.equal(runner.state.params["stage_0"]["conv"]["w"], start["w"])
    logs = os.path.join(cfg.run_dir(), "logs")
    assert len(load_statistics(logs)) == 1 and np.isfinite(float(load_statistics(logs)[0]["val_loss_mean"]))
    assert {"train_model_0", "train_model_best", "train_model_latest"} <= set(
        os.listdir(os.path.join(cfg.run_dir(), "saved_models")))
    cfg2 = runner_config(toy_dataset, tmp_path, strategy="anil", total_epochs=2)
    runner2 = ExperimentRunner(cfg2, system=small_system(cfg2))
    assert runner2.start_epoch == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runner2.state.params), tree_leaves(runner.state.params)))
    steps = []
    real = runner2.system.train_step
    runner2.system.train_step = lambda s, b, epoch=None: steps.append(epoch) or real(s, b, epoch=epoch)
    runner2.run_experiment()
    assert steps == [1] * cfg.total_iter_per_epoch
    assert [int(float(r["epoch"])) for r in load_statistics(logs)] == [0, 1]


def test_evaluate_on_test_set_only(toy_dataset, tmp_path):
    cfg = runner_config(toy_dataset, tmp_path, evaluate_on_test_set_only=True, experiment_name="toy_eval_only")
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    stats = runner.run_experiment()
    assert "test_accuracy_mean" in stats
    assert not os.path.exists(os.path.join(runner.run_dir, "logs", "summary_statistics.csv"))


def test_missing_named_epoch_fails_fast(toy_dataset, tmp_path):
    cfg = runner_config(toy_dataset, tmp_path, continue_from_epoch="7")
    with pytest.raises(FileNotFoundError, match="continue_from_epoch"):
        ExperimentRunner(cfg, system=small_system(cfg))


def test_numeric_continue_from_epoch(toy_dataset, tmp_path):
    cfg = runner_config(toy_dataset, tmp_path, experiment_name="toy_numeric")
    ExperimentRunner(cfg, system=small_system(cfg)).run_experiment()
    cfg2 = runner_config(toy_dataset, tmp_path, experiment_name="toy_numeric", total_epochs=3, continue_from_epoch=0)
    runner2 = ExperimentRunner(cfg2, system=small_system(cfg2))
    assert runner2.start_epoch == 1
    assert runner2.loader.train_episodes_produced == 1 * 3 * 2
    cfg3 = runner_config(toy_dataset, tmp_path, experiment_name="toy_numeric", continue_from_epoch=7)
    with pytest.raises(FileNotFoundError, match="continue_from_epoch"):
        ExperimentRunner(cfg3, system=small_system(cfg3))


def test_eval_stats_are_per_episode(toy_dataset, tmp_path):
    cfg = runner_config(toy_dataset, tmp_path, experiment_name="toy_epstats", total_epochs=1)
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    runner.run_experiment()
    logs = os.path.join(runner.run_dir, "logs")
    row = load_statistics(logs)[0]
    for col in ("val_accuracy_std", "val_accuracy_ci95", "val_num_episodes"):
        assert col in row, f"missing column {col}"
    n_eval = (cfg.num_evaluation_tasks // cfg.batch_size) * cfg.batch_size
    assert int(float(row["val_num_episodes"])) == n_eval
    test_row = load_statistics(logs, "test_summary.csv")[0]
    assert int(float(test_row["test_num_episodes"])) == n_eval
    std = float(test_row["test_accuracy_std"])
    ci = float(test_row["test_accuracy_ci95"])
    assert abs(ci - 1.96 * std / np.sqrt(n_eval)) < 1e-9


def test_early_abort_on_divergence(toy_dataset, tmp_path):
    cfg = runner_config(toy_dataset, tmp_path, experiment_name="toy_abort", total_epochs=5,
                        early_abort_train_acc=1.1, early_abort_epoch=2)
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    with pytest.raises(SystemExit) as exc:
        runner.run_experiment()
    assert exc.value.code == 3
    assert len(load_statistics(os.path.join(runner.run_dir, "logs"))) == 2
    assert any(e.get("event") == "early_abort" for e in _events(runner.run_dir))
    assert os.path.exists(os.path.join(runner.run_dir, "saved_models", "train_model_latest"))


# ---------------------------------------------------------------------------
# the NaN sentinel and its ladder
# ---------------------------------------------------------------------------


def _snapshot(state):
    return [t.clone() for t in tree_leaves({"p": state.params, "h": state.inner_hparams})] + [state.step.clone()]


def _equal(state, snapshot):
    return all(torch.equal(a, b) for a, b in zip(_snapshot(state), snapshot))


def _nan_drill(*specs, **resilience):
    """A ``ResilienceConfig`` arming ``runner.step=nan-loss`` drills: the
    seam marks those steps poisoned for the NaN sentinel."""
    return tcfg.ResilienceConfig(faults=[f"runner.step=nan-loss:{spec}" for spec in specs], **resilience)


def _watch(runner):
    """Record every ``train_step`` call's input state, checked unchanged by
    the step."""
    real = runner.system.train_step
    inputs = []

    def step(state, batch, epoch=None):
        before = _snapshot(state)
        new, out = real(state, batch, epoch=epoch)
        assert _equal(state, before), "train_step wrote into its input state"
        inputs.append((state, before))
        return new, out

    runner.system.train_step = step
    return inputs


def test_nan_step_is_discarded_and_the_state_restored(toy_dataset, tmp_path):
    cfg = runner_config(toy_dataset, tmp_path, experiment_name="toy_nan", resilience=_nan_drill("nth=2"))
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    inputs = _watch(runner)
    stats = runner._train_epoch(0)
    # step 2 is judged while step 3 runs on top of it: both are discarded,
    # and the state is the one step 2 was given, bit for bit
    assert len(inputs) == 3
    assert runner.state is inputs[1][0] and _equal(runner.state, inputs[1][1])
    assert [e["consecutive"] for e in _events(runner.run_dir) if e.get("event") == "nan_step_skipped"] == [1]
    assert np.isfinite(stats["train_loss_mean"])
    runner.events.close()
    runner.loader.close()


def test_consecutive_nans_roll_back_to_the_checkpoint_and_scale_the_outer_lr(toy_dataset, tmp_path):
    # the seam poisons every step from the 10th on: the 2nd of epoch 1
    cfg = runner_config(toy_dataset, tmp_path, experiment_name="toy_rollback", total_iter_per_epoch=8,
                        resilience=_nan_drill("after=9"))
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    runner._train_epoch(0)
    runner._save(0)
    runner._drain_ckpt_writer()
    saved, _ = ckpt.load_checkpoint(runner.saved_models_dir, 0, runner.state,
                                    feature_shape=runner.system.model.feature_shape)
    inputs = _watch(runner)
    runner._train_epoch(1)
    events = _events(runner.run_dir)
    # discards at calls 3, 5, 7 (K=3) roll back; the drain's discard starts a new streak
    assert [e["consecutive"] for e in events if e.get("event") == "nan_step_skipped"] == [1, 2, 3, 1]
    rollbacks = [e for e in events if e.get("event") == "nan_rollback"]
    assert [(r["rollback"], r["meta_lr_scale"]) for r in rollbacks] == [(1, 0.5)]
    assert len(inputs) == 8
    # call 8 ran from the checkpointed state
    assert _equal(inputs[7][0], _snapshot(saved))
    assert runner.system.meta_lr_scale == 0.5
    # the outer schedule is scaled as the JAX package's scale_meta_lr scales it
    jcfg_ = jax_config(toy_dataset, tmp_path, total_iter_per_epoch=8)
    jsys = jax_small_system(jcfg_)
    jsys.scale_meta_lr(0.5)
    for step in (0, 8, 9, 16):
        np.testing.assert_allclose(float(runner.system.schedule(torch.tensor(step))), float(jsys.schedule(step)),
                                   rtol=1e-7)
    runner.events.close()
    runner.loader.close()


def test_nan_abort_after_the_rollbacks_are_spent(toy_dataset, tmp_path):
    res = _nan_drill("times=3", max_consecutive_bad_steps=1, max_rollbacks=0)
    cfg = runner_config(toy_dataset, tmp_path, experiment_name="toy_nan_abort", resilience=res)
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    with pytest.raises(SystemExit) as exc:
        runner.run_experiment()
    assert exc.value.code == 3
    assert any(e.get("event") == "nan_abort" for e in _events(runner.run_dir))


# ---------------------------------------------------------------------------
# SIGTERM, refused options, the CLI
# ---------------------------------------------------------------------------

_PREEMPT_SCRIPT = r"""
import json
from howtotrainyourmamlpytorch_tpu_torch import config
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg

kwargs = json.loads({kwargs!r})
kwargs["dataset"] = config.DatasetConfig(**kwargs["dataset"])
# a preemption at the runner.step seam of the {nth}th step
kwargs["resilience"] = config.ResilienceConfig(faults=["runner.step=sigterm:nth={nth}"])
cfg = config.Config(**kwargs)
model = build_vgg((28, 28, 1), cfg.num_classes_per_set, num_stages=2, cnn_num_filters=4)
runner = ExperimentRunner(cfg, system=MAMLSystem(cfg, model=model, device="cpu"))
real = runner.system.train_step
calls = []

def step(state, batch, epoch=None):
    calls.append(epoch)
    return real(state, batch, epoch=epoch)

runner.system.train_step = step
try:
    runner.run_experiment()
finally:
    print("STEPS", calls, flush=True)
"""


def test_sigterm_saves_mid_epoch_and_resume_continues_there(toy_dataset, tmp_path):
    """SIGTERM during epoch 1's second step: the step finishes, the next
    batch is drawn but not trained, and the emergency 'latest' records 2
    iterations of epoch 1; exit 75. A new runner resumes at that iteration
    and trains only the last one."""
    kwargs = dict(_base(tcfg, toy_dataset, tmp_path), experiment_name="toy_preempt")
    kwargs["dataset"] = dataclasses.asdict(kwargs["dataset"])
    script = _PREEMPT_SCRIPT.format(kwargs=json.dumps(kwargs), nth=5)
    env = _env()
    proc = subprocess.run([sys.executable, "-c", script], cwd=_ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 75, proc.stdout + proc.stderr
    assert "PREEMPTED (SIGTERM) at epoch 1 iter 2" in proc.stdout
    assert "STEPS [0, 0, 0, 1, 1]" in proc.stdout
    cfg = runner_config(toy_dataset, tmp_path, experiment_name="toy_preempt")
    saved_models = os.path.join(cfg.run_dir(), "saved_models")
    _, bookkeeping = ckpt.load_for_inference(saved_models, "latest")
    assert (bookkeeping["epoch"], bookkeeping["mid_epoch_iter"]) == (0, 2)
    assert bookkeeping["train_episodes_produced"] == (3 + 2) * 2

    runner = ExperimentRunner(cfg, system=small_system(cfg))
    assert (runner.start_epoch, runner._resume_mid_iter) == (1, 2)
    assert runner.loader.train_episodes_produced == (3 + 2) * 2
    steps = []
    real = runner.system.train_step
    runner.system.train_step = lambda s, b, epoch=None: steps.append(epoch) or real(s, b, epoch=epoch)
    runner.run_experiment()
    assert steps == [1]
    assert [int(float(r["epoch"])) for r in load_statistics(os.path.join(cfg.run_dir(), "logs"))] == [0, 1]


REFUSED = {
    "aot": (dict(aot=tcfg.AotConfig(enabled=True)), "A10.8"),
    "donation": (dict(donate_train_state=True), "A10.7"),
    "dp2_multi_dispatch": (dict(parallel=tcfg.ParallelConfig(dp=2), train_steps_per_dispatch=2), r"A10\.5 \(mesh\)"),
    "mp2": (dict(parallel=tcfg.ParallelConfig(mp=2)), "A12"),
    "tp_convs": (dict(parallel=tcfg.ParallelConfig(dp=2, tp_convs=True)), "A12"),
}


def _ran_multi_dispatch(runner):
    """K = 2 over 3 iterations: one chunk and one single step; the ledger
    priced the chunk program."""
    names = {e["program"] for e in _jsonl(os.path.join(runner.logs_dir, "compile_ledger.jsonl"))}
    assert {"train_multi/True/True", "train/True/True"} <= names
    assert int(runner.state.step) == 3


def _ran_fused_eval(runner):
    names = {e["program"] for e in _jsonl(os.path.join(runner.logs_dir, "compile_ledger.jsonl"))}
    assert "eval_multi" in names and "eval" not in names
    row = load_statistics(runner.logs_dir)[0]
    assert float(row["val_num_episodes"]) == 4 and np.isfinite(float(row["val_loss_mean"]))


def _ran_profile(runner):
    """The window's Chrome trace in the runner's layout; a CPU trace has no
    device time, so the breakdown is None, as JAX's is for a CPU xplane."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.profiling import device_time_breakdown

    prof_dir = runner.cfg.profile_dir
    stamps = os.listdir(os.path.join(prof_dir, "plugins", "profile"))
    assert len(stamps) == 1 and runner._profiled
    (trace,) = os.listdir(os.path.join(prof_dir, "plugins", "profile", stamps[0]))
    assert trace.endswith(".pt.trace.json")
    assert device_time_breakdown(prof_dir) is None


def _ran_sanitized(runner):
    from tools.graftsan import runtime

    assert runtime.violations() == []
    assert "graftsan_violation" not in _events(runner.run_dir)


# options the runner refused until their ROADMAP.md item was ported: each
# case now runs (the sanitizer, A9.7: armed, it logs no violation; multi-step
# dispatch, the fused eval and the profiler window, A10.4-A10.5)
NOW_PORTED = {
    "sanitizer": (dict(resilience=tcfg.ResilienceConfig(sanitizer=True)), _ran_sanitized),
    "multi_dispatch": (dict(train_steps_per_dispatch=2, total_iter_per_epoch=3), _ran_multi_dispatch),
    "eval_fused": (dict(eval_fused_dispatch=True), _ran_fused_eval),
    "profile": (dict(profile_dir="prof"), _ran_profile),
}


@pytest.mark.parametrize("name", sorted(list(REFUSED) + list(NOW_PORTED)))
def test_unported_options_are_refused(toy_dataset, tmp_path, name):
    if name in NOW_PORTED:
        from tools.graftsan import runtime

        overrides, check_run = NOW_PORTED[name]
        if "profile_dir" in overrides:
            overrides = dict(overrides, profile_dir=str(tmp_path / overrides["profile_dir"]))
        cfg = runner_config(toy_dataset, tmp_path, **{"total_epochs": 1, "total_iter_per_epoch": 1, **overrides})
        try:
            runner = ExperimentRunner(cfg, system=small_system(cfg))
            assert runtime.enabled() == (name == "sanitizer")
            runner.run_experiment()
            check_run(runner)
        finally:
            runtime.disarm()
            runtime.reset()
        return
    overrides, item = REFUSED[name]
    cfg = runner_config(toy_dataset, tmp_path, **overrides)
    with pytest.raises(NotImplementedError, match=item):
        ExperimentRunner(cfg, device="cpu")
    assert not os.path.exists(cfg.run_dir())


A6_OPTIONS = {
    "inner_adam": dict(inner_optim=tcfg.InnerOptimConfig(kind="adam")),
    "resnet": dict(net="resnet-4"),
}


@pytest.mark.parametrize("name", sorted(A6_OPTIONS))
def test_a6_options_are_accepted(toy_dataset, tmp_path, name):
    """Inner Adam and the ResNet backbone, refused before ROADMAP.md A6,
    build a runner on the CPU and train an epoch: finite losses, and for
    inner Adam a ``betas.csv`` row of interleaved per-tensor betas."""
    cfg = runner_config(toy_dataset, tmp_path, total_epochs=1, total_iter_per_epoch=1, **A6_OPTIONS[name])
    runner = ExperimentRunner(cfg, device="cpu")
    assert runner.system.inner_opt.name == ("adam" if name == "inner_adam" else "sgd")
    assert runner.system.model.name == ("resnet" if name == "resnet" else "vgg")
    runner.run_experiment()
    rows = load_statistics(os.path.join(cfg.run_dir(), "logs"))
    assert len(rows) == 1 and np.isfinite(float(rows[0]["train_loss_mean"]))
    n_leaves = len(tree_leaves(runner.state.params))
    with open(os.path.join(cfg.run_dir(), "lrs.csv")) as f:
        assert [len(r) for r in csv.reader(f)] == [n_leaves]
    betas = os.path.join(cfg.run_dir(), "betas.csv")
    assert os.path.exists(betas) == (name == "inner_adam")
    if name == "inner_adam":
        with open(betas) as f:
            assert [len(r) for r in csv.reader(f)] == [2 * n_leaves]


A9_OPTIONS = {
    "dp2": dict(parallel=tcfg.ParallelConfig(dp=2)),
    "fault_drill": dict(resilience=tcfg.ResilienceConfig(faults=["runner.step=nan-loss:nth=2"])),
    "sharded_checkpoints": dict(checkpoint_shards=2),
}


@pytest.mark.parametrize("name", sorted(A9_OPTIONS))
def test_a9_options_are_accepted(toy_dataset, tmp_path, name):
    """The options refused before ROADMAP.md A9 train an epoch on the CPU:
    ``dp=2`` on a two-entry CPU mesh (2 shards written, the ``mesh``
    bookkeeping [2, 1]), a ``runner.step`` drill (the poisoned step
    discarded), ``checkpoint_shards=2`` on one device (format 3, mesh
    [1, 1])."""
    devices = ["cpu", "cpu"] if name == "dp2" else None
    cfg = runner_config(toy_dataset, tmp_path, total_epochs=1, **A9_OPTIONS[name])
    runner = ExperimentRunner(cfg, system=small_system(cfg), devices=devices)
    assert (runner.mesh is not None) == (name == "dp2")
    runner.run_experiment()
    rows = load_statistics(os.path.join(cfg.run_dir(), "logs"))
    assert len(rows) == 1 and np.isfinite(float(rows[0]["train_loss_mean"]))
    saved = os.listdir(runner.saved_models_dir)
    shards = sorted(n for n in saved if n.startswith("train_model_latest.shard"))
    assert shards == ([] if name == "fault_drill" else ["train_model_latest.shard0", "train_model_latest.shard1"])
    _, book = ckpt.load_for_inference(runner.saved_models_dir, "latest")
    assert book["mesh"] == ([2, 1] if name == "dp2" else [1, 1])
    skipped = [e for e in _events(runner.run_dir) if e.get("event") == "nan_step_skipped"]
    assert len(skipped) == (1 if name == "fault_drill" else 0)


def test_fault_drill_from_the_environment_is_refused(toy_dataset, tmp_path, monkeypatch):
    """A drill named in ``HTYMP_FAULTS`` reaches the runner's seam (it was
    refused before ROADMAP.md A9); a malformed spec is still refused."""
    monkeypatch.setenv("HTYMP_FAULTS", "runner.step=nan-loss:nth=2")
    cfg = runner_config(toy_dataset, tmp_path, total_epochs=1)
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    runner.run_experiment()
    assert runner._injector.stats() == {"runner.step:nan-loss": 1}
    assert [e["consecutive"] for e in _events(runner.run_dir) if e.get("event") == "nan_step_skipped"] == [1]
    monkeypatch.setenv("HTYMP_FAULTS", "runner.step=bogus")
    with pytest.raises(ValueError, match="bad fault spec"):
        ExperimentRunner(cfg, system=small_system(cfg))


def test_one_device_data_parallel_is_accepted(toy_dataset, tmp_path):
    """``dp=-1`` (the default) resolves to one device here."""
    cfg = runner_config(toy_dataset, tmp_path, parallel=tcfg.ParallelConfig(dp=-1))
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    assert runner.start_epoch == 0
    runner.events.close()
    runner.loader.close()


def _cli(args, cwd):
    env = _env()
    cmd = [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.train", *args]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_trains_and_resumes_on_the_cpu(toy_dataset, tmp_path):
    """``python -m howtotrainyourmamlpytorch_tpu_torch.train --device cpu``
    at the full-width VGG, then a resume that trains only the new epoch."""
    overrides = [
        f'dataset={{"name": "omniglot_toy", "path": "{toy_dataset}"}}',
        "num_classes_per_set=3", "num_samples_per_class=2", "num_target_samples=2", "batch_size=2",
        "total_iter_per_epoch=2", "num_evaluation_tasks=2", "number_of_training_steps_per_iter=2",
        "number_of_evaluation_steps_per_iter=2", f"experiment_root={tmp_path}", "load_into_memory=true",
        "train_val_test_split=[0.6,0.2,0.2]", "num_dataprovider_workers=2",
    ]
    proc = _cli(["--device", "cpu", "--config", os.path.join(_ROOT, "configs", "default.yaml"),
                 "total_epochs=1", *overrides], cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    run_dir = os.path.join(tmp_path, "omniglot_toy.3.2")
    assert f"run dir: {run_dir}" in proc.stdout
    assert "n_params: " in proc.stdout and "epoch 0: train_acc=" in proc.stdout
    proc = _cli(["--device", "cpu", "total_epochs=2", *overrides], cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "resumed: epoch 1, train episodes 4" in proc.stdout
    assert "epoch 1: train_acc=" in proc.stdout and "epoch 0:" not in proc.stdout
    assert len(load_statistics(os.path.join(run_dir, "logs"))) == 2
    assert load_statistics(os.path.join(run_dir, "logs"), "test_summary.csv")


def test_cli_without_a_card_raises(tmp_path):
    code = ("import torch, sys; torch.cuda.is_available = lambda: False; "
            "from howtotrainyourmamlpytorch_tpu_torch.train import main; sys.exit(main([]))")
    env = _env()
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# a run directory across the packages
# ---------------------------------------------------------------------------


def _copy_run(run_dir, root):
    target = os.path.join(root, os.path.basename(run_dir))
    shutil.copytree(run_dir, target)
    return target


def _first_step_losses(toy_dataset, tmp_path, run_dir):
    """Resume ``run_dir`` (copied) in both packages' runners at
    ``total_epochs=2``; each runner's first train step after the resume on
    its own loader's next batch -> (port loss, JAX loss), and the cursors."""
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    _copy_run(run_dir, port_root)
    _copy_run(run_dir, jax_root)
    cfg = runner_config(toy_dataset, port_root, total_epochs=2)
    runner = ExperimentRunner(cfg, system=small_system(cfg))
    jcfg_ = jax_config(toy_dataset, jax_root, total_epochs=2)
    jrunner = JaxRunner(jcfg_, system=jax_small_system(jcfg_))
    assert runner.start_epoch == jrunner.start_epoch == 1
    cursors = (runner.loader.train_episodes_produced, jrunner.loader.train_episodes_produced)
    batch = next(iter(runner.loader.train_batches(1)))
    jbatch = next(iter(jrunner.loader.train_batches(1)))
    for key in batch:
        np.testing.assert_array_equal(batch[key], jbatch[key])
    _, out = runner.system.train_step(runner.state, batch, epoch=1)
    _, jout = jrunner.system.train_step(jrunner.state, jrunner._put(jbatch), epoch=1)
    for r in (runner, jrunner):
        r.events.close()
        r.loader.close()
    return float(out.loss), float(jout.loss), cursors


def test_jax_run_resumes_in_the_port(toy_dataset, tmp_path, jax_run):
    loss, jax_loss, cursors = _first_step_losses(toy_dataset, tmp_path, jax_run)
    assert cursors == (3 * 2, 3 * 2)
    assert abs(loss - jax_loss) <= LOSS_ATOL, (loss, jax_loss)


def test_port_run_resumes_in_jax(toy_dataset, tmp_path, port_run):
    loss, jax_loss, cursors = _first_step_losses(toy_dataset, tmp_path, port_run)
    assert cursors == (3 * 2, 3 * 2)
    assert abs(loss - jax_loss) <= LOSS_ATOL, (loss, jax_loss)


# ---------------------------------------------------------------------------
# run analysis without jax (the port's analysis.py and results_archive.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["jax_run", "port_run"])
def test_analysis_reports_a_run_of_either_package_as_jax_does(which, request, tmp_path):
    """The port's ``write_report`` over the experiment root of a run by
    each package's runner writes the JAX package's tables byte for byte
    (markdown, LaTeX, JSON), lists the run and aggregates its test
    accuracy."""
    from howtotrainyourmamlpytorch_tpu import analysis as jax_analysis
    from howtotrainyourmamlpytorch_tpu_torch import analysis

    root = os.path.dirname(request.getfixturevalue(which))
    got = analysis.write_report(root, str(tmp_path / "port"))
    want = jax_analysis.write_report(root, str(tmp_path / "jax"))
    assert (got["runs"], got["table_rows"]) == (want["runs"], want["table_rows"]) == (1, 1)
    assert [os.path.basename(p) for p in got["plots"]] == [os.path.basename(p) for p in want["plots"]]
    for name in ("test_accuracy.md", "test_accuracy.tex", "test_accuracy.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    runs = analysis.collect_runs(root)
    assert len(runs) == 1 and runs[0].lrs is not None and runs[0].lrs.shape[0] == 1


def test_analysis_cli_and_results_archive(port_run, tmp_path):
    """``python -m howtotrainyourmamlpytorch_tpu_torch.analysis ROOT OUT``
    reports the port's run (rc 0) and exits 2 over an empty root; the
    archive packs the run's logs and config without its checkpoints."""
    import tarfile

    from howtotrainyourmamlpytorch_tpu_torch.utils import results_archive

    root = os.path.dirname(port_run)
    cmd = [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.analysis", root, str(tmp_path / "out")]
    proc = subprocess.run(cmd, cwd=_ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout[: proc.stdout.rindex("}") + 1])["runs"] == 1
    empty = subprocess.run(cmd[:3] + [str(tmp_path / "none"), str(tmp_path / "out2")], cwd=_ROOT, env=_env(),
                           capture_output=True, text=True, timeout=300)
    assert empty.returncode == 2 and "0 runs matched" in empty.stderr
    path = results_archive.pack_run(port_run, str(tmp_path / "archives"))
    with tarfile.open(path) as tar:
        names = tar.getnames()
    assert any(n.endswith("summary_statistics.csv") for n in names) and any(n.endswith("config.yaml") for n in names)
    assert not any("saved_models" in n for n in names)
    assert results_archive.list_archives(str(tmp_path / "archives")) == [path]
    results_archive.delete_archive(path)
    assert results_archive.list_archives(str(tmp_path / "archives")) == []
