"""The ablation sweep launcher and the RESULTS.md row of the port
(``howtotrainyourmamlpytorch_tpu_torch/launch_all.py``,
``scripts/summarize_run.py``) against the repository's ``launch_all.py``
and the JAX package's ``scripts/summarize_run.py``: the same 324 jobs with
the same names and overrides, one selected job run through the port's
training CLI on the CPU (1 epoch of 1 step on a toy Omniglot-layout
folder), and the same row printed for its run directory."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from howtotrainyourmamlpytorch_tpu_torch import launch_all
from howtotrainyourmamlpytorch_tpu_torch.scripts import summarize_run

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(_ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def root_launcher():
    return _load("launch_all.py", "root_launch_all")


def test_jobs_equal_the_root_launchers(root_launcher):
    assert list(launch_all.jobs()) == list(root_launcher.jobs())
    assert launch_all.GRID == root_launcher.GRID
    assert len(list(launch_all.jobs())) == 6 * 6 * 3 * 3


def test_dry_run_lists_the_same_324_jobs(root_launcher):
    outs = []
    for module in (launch_all, root_launcher):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert module.main(["--dry-run", "inner_loop_optim_learning_rate=0.01"]) == 0
        outs.append(buf.getvalue().splitlines())
    port, root = outs
    assert len(port) == len(root) == 324
    for p, r in zip(port, root):
        p_head, p_cmd = p.split(": ", 1)
        r_head, r_cmd = r.split(": ", 1)
        assert p_head == r_head  # "[i/324] name"
        # the same overrides after each package's entry point
        assert p_cmd.split("howtotrainyourmamlpytorch_tpu_torch.train --device cuda ", 1)[1] == \
            r_cmd.split("train_maml_system.py ", 1)[1]
    assert port[0].endswith("inner_loop_optim_learning_rate=0.01")


def test_select_and_device_flags(capsys):
    assert launch_all.main(["--select", "0", "5", "--device", "cpu", "--dry-run", "total_epochs=1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(": ")[0] for ln in lines] == ["[1/2] omniglot.5.1.vgg.gd.0", "[2/2] omniglot.5.1.vgg.adam.2"]
    assert all("-m howtotrainyourmamlpytorch_tpu_torch.train --device cpu " in ln for ln in lines)
    assert all(ln.endswith("total_epochs=1") for ln in lines)


@pytest.fixture(scope="module")
def toy_omniglot(tmp_path_factory):
    """6 alphabets x 5 characters x 4 images, Omniglot's layout at 28x28
    (30 classes: a 0.6/0.2/0.2 split leaves 6 for a 5-way episode)."""
    root = tmp_path_factory.mktemp("sweep_data") / "toy_omniglot"
    rng = np.random.RandomState(0)
    for a in range(6):
        for c in range(5):
            d = root / f"alpha{a}" / f"char{c}"
            d.mkdir(parents=True)
            base = (rng.rand(28, 28) > 0.5).astype(np.uint8) * 255
            for i in range(4):
                noisy = base ^ (rng.rand(28, 28) > 0.95).astype(np.uint8) * 255
                Image.fromarray(noisy, mode="L").convert("1").save(d / f"{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def selected_run(toy_omniglot, tmp_path_factory):
    """Job 0 (omniglot.5.1.vgg.gd.0) through the launcher and the port's
    training CLI in a child process, on the CPU: 1 epoch of 1 step."""
    exps = tmp_path_factory.mktemp("sweep_exps")
    overrides = [
        "dataset=" + json.dumps({"name": "omniglot_dataset", "path": toy_omniglot}),
        f"index_cache_dir={exps / 'idx'}", "train_val_test_split=[0.6,0.2,0.2]", f"experiment_root={exps}",
        "total_epochs=1", "total_iter_per_epoch=1", "batch_size=2", "num_evaluation_tasks=2",
        "number_of_training_steps_per_iter=1", "number_of_evaluation_steps_per_iter=1",
        "use_pallas_inner_update=true",
    ]
    code = ("import sys; from howtotrainyourmamlpytorch_tpu_torch import launch_all; "
            "sys.exit(launch_all.main(sys.argv[1:]))")
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code, "--select", "0", "--device", "cpu", *overrides],
                          cwd=_ROOT, env=env, capture_output=True, text=True, timeout=600)
    return proc, str(exps / "omniglot.5.1.vgg.gd.0")


def test_select_runs_one_job_through_the_training_cli(selected_run):
    proc, run_dir = selected_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[1/1] omniglot.5.1.vgg.gd.0:" in proc.stdout
    assert os.path.isdir(run_dir), proc.stdout[-2000:]
    for name in ("config.yaml", "logs/summary_statistics.csv", "logs/test_summary.csv", "logs/events.jsonl"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    with open(os.path.join(run_dir, "config.yaml")) as f:
        text = f.read()
    assert "experiment_name: omniglot.5.1.vgg.gd.0" in text and "num_classes_per_set: 5" in text


def test_summarize_run_prints_the_jax_scripts_row(selected_run, capsys):
    _, run_dir = selected_run
    jax_script = _load(os.path.join("scripts", "summarize_run.py"), "jax_summarize_run")
    want = jax_script.row(run_dir)
    assert summarize_run.row(run_dir) == want
    assert want.startswith("| omniglot.5.1.vgg.gd.0 | (ref: BASELINE.md) |") and "(n=2)" in want
    assert summarize_run.main([run_dir, "/no/such/run"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [want, jax_script.row("/no/such/run")]


def test_in_process_job_runs_the_training_cli_main(toy_omniglot, tmp_path, capsys):
    """``--in-process``: the selected job through ``train.main`` in this
    process, with the launcher's ``--device``."""
    overrides = [
        "dataset=" + json.dumps({"name": "omniglot_dataset", "path": toy_omniglot}),
        f"index_cache_dir={tmp_path / 'idx'}", "train_val_test_split=[0.6,0.2,0.2]", f"experiment_root={tmp_path}",
        "total_epochs=1", "total_iter_per_epoch=1", "batch_size=2", "num_evaluation_tasks=2",
        "number_of_training_steps_per_iter=1", "number_of_evaluation_steps_per_iter=1", "load_into_memory=false",
    ]
    assert launch_all.main(["--select", "1", "--in-process", "--device", "cpu", *overrides]) == 0
    out = capsys.readouterr().out
    assert "[1/1] omniglot.5.1.vgg.gd.1:" in out and "run dir:" in out
    assert os.path.exists(tmp_path / "omniglot.5.1.vgg.gd.1" / "logs" / "test_summary.csv")
