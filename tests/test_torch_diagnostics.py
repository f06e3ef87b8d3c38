"""The card-against-CPU diagnostics of the port (``scripts/`` of
``howtotrainyourmamlpytorch_tpu_torch``) against the JAX package's
scripts, on the CPU at a small size: VGG with 2 stages of 4 filters,
3-way 2-shot (1-shot for the descent probe, as its JAX config), meta-batch
2, K=2, on a toy Omniglot-layout folder and a tiny Mini-ImageNet tree.
JAX parameters are carried into the port with ``utils/interop.py``.

Where a JAX script has a function (``grad_precision_probe.meta_grads``,
``checkpoint_autopsy.tensor_stats``) the port is held to it; where it has
only a ``main`` with hard-coded paths, to the same sequence of JAX package
calls. Tolerances:

- meta-gradients, port against JAX in float32: 1e-5 absolute (the
  meta-gradient tolerance of ``tests/test_torch_train.py``), cosine 1 - 1e-6;
- the bf16 operand emulation, port against JAX's: both round the same
  operands to bf16, but a float32 last-bit difference upstream can move an
  operand across a bf16 rounding boundary (2^-8 relative), so the whole
  meta-gradient is held at cosine >= 0.999 and each leaf of norm above
  1e-3 of the largest at >= 0.99;
- losses of train and eval steps: 1e-5 absolute (the cross-package
  resume tolerance of ``tests/test_torch_runner.py``); eval accuracies
  equal; the descent probe's 4 outer steps, 5e-5 relative: the first
  losses differ by ~2e-6 relative and Adam's updates carry that into the
  parameters (measured 1.0e-5 relative at the fourth step);
- checkpoint statistics: float64 norms, maxima and means of the same
  float32 values in another order, 1e-12 relative;
- batches and the donation probe's arms on the CPU: bit-equal; the arms
  step under the deterministic algorithms.
"""

import dataclasses
import importlib.util
import io
import json
import os
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.data import FewShotDataset as JaxFewShotDataset
from howtotrainyourmamlpytorch_tpu.data import MetaLearningDataLoader as JaxLoader
from howtotrainyourmamlpytorch_tpu.experiment import checkpoint as jckpt
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.core.train_state import TrainState
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.models import layers
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.scripts import (
    checkpoint_autopsy,
    descent_probe,
    donation_probe,
    grad_precision_probe,
    imagenet_at_scale,
    stream_replay_probe,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import opt_state_from_jax, state_from_jax

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = 2
GRAD_ATOL = 1e-5
LOSS_ATOL = 1e-5
DESCENT_RTOL = 5e-5
STATS_RTOL = 1e-12
SMALL = dict(num_classes_per_set=3, num_samples_per_class=2, num_target_samples=2, batch_size=2,
             number_of_training_steps_per_iter=2, number_of_evaluation_steps_per_iter=2)
SMALL_OVERRIDES = [f"{k}={v}" for k, v in SMALL.items()]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(_ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_vgg(img=(28, 28, 1), n_way=3):
    return build_vgg(img, n_way, num_stages=2, cnn_num_filters=4)


def jax_vgg(img=(28, 28, 1), n_way=3):
    return jax_build_vgg(img, n_way, num_stages=2, cnn_num_filters=4, conv_via_patches=True)


def port_state(jstate, feature_shape):
    params, bn_state, hparams = state_from_jax(
        *(jax.tree.map(np.asarray, t) for t in (jstate.params, jstate.bn_state, jstate.inner_hparams)), feature_shape)
    return TrainState(params, bn_state, hparams,
                      opt_state_from_jax(jax.tree.map(np.asarray, jstate.opt_state), feature_shape),
                      torch.tensor(int(jstate.step), dtype=torch.int64))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def toy_dataset(tmp_path_factory):
    """4 alphabets x 5 characters x 6 images, Omniglot's layout at 28x28."""
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


def _run_fields(toy_dataset, root):
    return dict(SMALL, total_epochs=2, total_iter_per_epoch=3, num_evaluation_tasks=4, experiment_root=str(root),
                experiment_name="toy_run", load_into_memory=False, num_dataprovider_workers=2,
                train_val_test_split=(0.6, 0.2, 0.2))


def jax_config(toy_dataset, **fields):
    """The JAX program that agrees with float64 on this jax: ``lax.scan``
    without remat (ROADMAP.md C), patches-GEMM convs on one device."""
    return jcfg.Config(**{"dataset": jcfg.DatasetConfig(name="omniglot_toy", path=toy_dataset),
                          "parallel": jcfg.ParallelConfig(dp=1), "conv_via_patches": True,
                          "unroll_inner_steps": False, "remat_inner_steps": False, **fields})


@pytest.fixture(scope="module")
def port_run(toy_dataset, tmp_path_factory):
    """Two epochs of 3 steps by the port's runner: checkpoints 0, 1,
    latest and best, format 2."""
    root = tmp_path_factory.mktemp("port_run")
    cfg = tcfg.Config(dataset=tcfg.DatasetConfig(name="omniglot_toy", path=toy_dataset),
                      **_run_fields(toy_dataset, root))
    runner = ExperimentRunner(cfg, system=MAMLSystem(cfg, model=port_vgg(), device="cpu"))
    runner.run_experiment()
    return runner.run_dir


# ---------------------------------------------------------------------------
# grad_precision_probe
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_probe(monkeypatch):
    """The JAX script's ``meta_grads`` at the small size: its Config and
    MAMLSystem patched where it imports them (the small VGG, the program
    that agrees with float64); its layer patch undone afterwards."""
    from howtotrainyourmamlpytorch_tpu import core as jcore
    from howtotrainyourmamlpytorch_tpu.models import layers as jlayers

    script = _jax_script("grad_precision_probe")
    fields = dict(SMALL, unroll_inner_steps=False, remat_inner_steps=False, conv_via_patches=True)
    real = jcfg.Config
    monkeypatch.setattr(jcfg, "Config", lambda **kw: real(**{**fields, **kw}))
    monkeypatch.setattr(jcore, "MAMLSystem", lambda cfg: JaxMAMLSystem(cfg, model=jax_vgg()))
    monkeypatch.setattr(jlayers, "conv2d", jlayers.conv2d)
    monkeypatch.setattr(jlayers, "linear", jlayers.linear)
    jstate = JaxMAMLSystem(real(**fields), model=jax_vgg()).init_train_state()
    return script, jstate


def _port_probe_grads(jstate, emulate=None):
    cfg = grad_precision_probe.probe_config(3, 2, batch_size=2, overrides=SMALL_OVERRIDES)
    model = port_vgg()
    with grad_precision_probe.operand_emulation(emulate):
        return grad_precision_probe.meta_grads(cfg, "cpu", port_state(jstate, model.feature_shape), model=model)


def _vec(flat):
    return np.concatenate([flat[k].ravel() for k in sorted(flat)])


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_save_meta_grads_equal_jax_meta_grads(jax_probe):
    script, jstate = jax_probe
    want = script.meta_grads(n_way=3, k_shot=2)
    got = _port_probe_grads(jstate)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=GRAD_ATOL, err_msg=name)
    assert _cos(_vec(got), _vec(want)) >= 1 - 1e-6


def test_bf16_emulation_equals_jax_mxu_default_emulation(jax_probe):
    script, jstate = jax_probe
    want = script.meta_grads(n_way=3, k_shot=2, compute_dtype="mxu_default")
    got = _port_probe_grads(jstate, "bf16")
    exact = _port_probe_grads(jstate)
    assert layers.OPERAND_ROUNDING is None  # the context undid the emulation
    assert _cos(_vec(got), _vec(want)) >= 0.999
    scale = max(np.linalg.norm(v) for v in want.values())
    for name in want:
        if np.linalg.norm(want[name]) > 1e-3 * scale:
            assert _cos(got[name].ravel(), want[name].ravel()) >= 0.99, name
    # the emulation changes the gradient: bf16 operands are not float32's
    assert max(float(np.abs(got[n] - exact[n]).max()) for n in got) > 10 * GRAD_ATOL


def test_tf32_rounding_keeps_ten_mantissa_bits():
    ulp = 2.0 ** -10
    # ties go to the even mantissa; 2 - ulp/2 carries into the exponent
    values = torch.tensor([1.0, 1 + ulp / 2, 1 + 3 * ulp / 2, 1 + ulp / 2 + 2.0 ** -20, 1 + ulp / 4,
                           -(1 + 3 * ulp / 2), 2 - ulp / 2, float("inf"), float("-inf"), 0.0, 1.5 * 2.0 ** 20],
                          dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1 + 2 * ulp, 1 + ulp, 1.0, -(1 + 2 * ulp), 2.0, float("inf"),
                         float("-inf"), 0.0, 1.5 * 2.0 ** 20], dtype=torch.float32)
    got = grad_precision_probe.round_tf32(values)
    assert torch.equal(got, want), (got, want)
    assert bool(torch.isnan(grad_precision_probe.round_tf32(torch.tensor([float("nan")]))).all())
    bits = got[torch.isfinite(got)].view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0  # 13 low mantissa bits clear
    # the gradient is rounded the same way
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    (g,) = torch.autograd.grad(grad_precision_probe.round_tf32(x), x, torch.tensor([1 + 3 * ulp / 2, 1 + ulp / 4]))
    assert torch.equal(g, torch.tensor([1 + 2 * ulp, 1.0]))


def test_save_and_compare_cli_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "grads.npz")
    common = ["3", "--k-shot", "1", "--batch-size", "2", "--device", "cpu",
              "--override", "number_of_training_steps_per_iter=2"]
    assert grad_precision_probe.main(["save", path] + common) == 0
    out = str(tmp_path / "compare.json")
    assert grad_precision_probe.main(["compare", path] + common + ["--precision", "highest", "--json", out]) == 0
    with open(out) as f:
        result = json.load(f)
    arm = result["arms"]["highest"]
    assert arm["global_cosine"] == pytest.approx(1.0, abs=1e-12)
    assert len(arm["tensors"]) == len(np.load(path).files)
    assert "worst cosine vs the saved reference" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# checkpoint_autopsy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run_dir(toy_dataset, tmp_path_factory):
    """A JAX-written format-2 checkpoint after one train step (Adam moments
    not zero), with the run's config.yaml."""
    run_dir = tmp_path_factory.mktemp("jax_ckpt") / "run"
    (run_dir / "saved_models").mkdir(parents=True)
    cfg = jax_config(toy_dataset, **_run_fields(toy_dataset, run_dir.parent))
    system = JaxMAMLSystem(cfg, model=jax_vgg())
    state = system.init_train_state()
    loader = JaxLoader(cfg, current_iter=0)
    batch = next(iter(loader.train_batches(1, augment_images=True)))
    state, _ = system.train_step(state, _jnp(batch), epoch=0)
    jckpt.save_checkpoint(str(run_dir / "saved_models"), state, {"epoch": 0, "train_episodes_produced": 2}, 0)
    jcfg.save_config(cfg, str(run_dir / "config.yaml"))
    return str(run_dir), cfg, system


def _parse(lines):
    """{name: (shape, norm, max, mean)} of a printed statistics table."""
    rows = {}
    for line in lines:
        if "shape=" not in line:
            continue
        name, rest = line.split(" shape=", 1)
        shape, rest = rest.split(" |x|=", 1)
        norm, rest = rest.split(" max|x|=", 1)
        mx, mean = rest.split(" mean=", 1)
        rows[name.strip()] = (shape.strip(), float(norm), float(mx), float(mean))
    return rows


def test_autopsy_statistics_and_cpu_eval_equal_jax(jax_run_dir):
    run_dir, cfg, jsystem = jax_run_dir
    # the JAX script's sequence, without its hard-coded paths
    jstate, book = jckpt.load_checkpoint(os.path.join(run_dir, "saved_models"), "0", jsystem.init_train_state())
    script = _jax_script("checkpoint_autopsy")
    want = {}
    for label, tree in (("params", jstate.params), ("bn_state", jstate.bn_state),
                        ("inner_hparams (learned lrs)", jstate.inner_hparams)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            script.tensor_stats(tree, label)
        want[label] = _parse(buf.getvalue().splitlines())
    loader = JaxLoader(dataclasses.replace(cfg, load_into_memory=False), current_iter=0)
    batches = [b for _, b in zip(range(2), loader.val_batches(2))]
    jevals = [jsystem.eval_step(jstate, _jnp(b)) for b in batches]

    lines = []
    report = checkpoint_autopsy.autopsy(run_dir, ["0"], eval_batches=2, device="cpu", compare_cpu=[],
                                        model=port_vgg(), out=lines.append)
    entry = report["checkpoints"]["0"]
    assert entry["epoch"] == book["epoch"] and entry["step"] == int(jstate.step) == 1
    for label, rows in want.items():
        got = _parse(checkpoint_autopsy.format_stats(entry["stats"][label], label))
        assert sorted(got) == sorted(rows)
        for name, (shape, *nums) in rows.items():
            assert got[name][0] == shape, name
            np.testing.assert_allclose(got[name][1:], nums, rtol=STATS_RTOL, err_msg=name)
    # the table the JAX script prints, row for row (3 significant digits)
    assert [ln for ln in lines if "shape=" in ln][:len(want["params"])] == [
        ln for ln in checkpoint_autopsy.format_stats(entry["stats"]["params"], "params")[1:]]
    assert set(entry["stats"]) >= {"outer adam mu", "outer adam nu"}
    assert any(r["norm"] > 0 for r in entry["stats"]["outer adam mu"])
    ev = entry["eval"]["cpu"]
    np.testing.assert_allclose(ev["loss"], np.mean([float(o.loss) for o in jevals]), rtol=0, atol=LOSS_ATOL)
    assert ev["per_batch_accuracy"] == pytest.approx([float(o.accuracy) for o in jevals], abs=1e-6)


# ---------------------------------------------------------------------------
# stream_replay_probe
# ---------------------------------------------------------------------------


def test_stream_replay_sees_the_jax_loaders_batches_and_losses(port_run, toy_dataset):
    lines = []
    out = stream_replay_probe.replay(port_run, "0", 3, "cpu", model=port_vgg(), print_every=1, out=lines.append)
    cfg = jax_config(toy_dataset, **_run_fields(toy_dataset, os.path.dirname(port_run)))
    assert out["epoch"] == 0 and out["cursor"] == cfg.total_iter_per_epoch * cfg.batch_size
    loader = JaxLoader(dataclasses.replace(cfg, load_into_memory=False), current_iter=cfg.total_iter_per_epoch)
    batches = [b for _, b in zip(range(3), loader.train_batches(3, augment_images=True))]
    assert [s["digest"] for s in out["steps"]] == [stream_replay_probe.batch_digest(b) for b in batches]
    jsystem = JaxMAMLSystem(cfg, model=jax_vgg())
    jstate, _ = jckpt.load_checkpoint(os.path.join(port_run, "saved_models"), "0", jsystem.init_train_state())
    losses = []
    for b in batches:
        jstate, o = jsystem.train_step(jstate, _jnp(b), epoch=1)
        losses.append(float(o.loss))
    np.testing.assert_allclose([s["loss"] for s in out["steps"]], losses, rtol=0, atol=LOSS_ATOL)
    assert sum("batch=" in ln for ln in lines) == 3


def test_stream_replay_cli_with_tf32_operands(port_run, tmp_path):
    """The CLI on the CPU with ``--emulate tf32``: the same batches as the
    plain replay, finite losses; the emulation off afterwards."""
    path = str(tmp_path / "replay.json")
    assert stream_replay_probe.main([port_run, "init", "2", "--emulate", "tf32", "--device", "cpu",
                                     "--json", path]) == 0
    with open(path) as f:
        result = json.load(f)
    assert result["cursor"] == 0 and result["emulate"] == "tf32" and len(result["steps"]) == 2
    assert all(np.isfinite(s["loss"]) for s in result["steps"])
    assert layers.OPERAND_ROUNDING is None


# ---------------------------------------------------------------------------
# descent_probe, donation_probe
# ---------------------------------------------------------------------------


def test_descent_losses_equal_jax_rolled_program(toy_dataset, tmp_path):
    fields = dict(SMALL, num_target_samples=1, load_into_memory=False, index_cache_dir=str(tmp_path / "jidx"),
                  train_val_test_split=(0.6, 0.2, 0.2))
    jc = jax_config(toy_dataset, **fields)
    jc = dataclasses.replace(jc, dataset=jcfg.DatasetConfig(name="omniglot_dataset", path=toy_dataset))
    loader = JaxLoader(jc, current_iter=0)
    batches = [_jnp(b) for _, b in zip(range(2), loader.train_batches(2, augment_images=True))]
    jsystem = JaxMAMLSystem(jc, model=jax_vgg())
    jstate = jsystem.init_train_state()
    start = jstate
    losses = []
    for i in range(4):
        jstate, o = jsystem.train_step(jstate, batches[i % 2], epoch=0)
        losses.append(float(o.loss))
    finals = [float(jsystem.train_step(jstate, b, epoch=0)[1].loss) for b in batches]

    cfg = descent_probe.descent_config(3, toy_dataset, str(tmp_path / "idx"), k_shot=2, batch_size=2,
                                       overrides=["number_of_training_steps_per_iter=2",
                                                  "train_val_test_split=[0.6,0.2,0.2]"])
    model = port_vgg()
    out = descent_probe.descend(cfg, 4, 2, "cpu", model=model, state=port_state(start, model.feature_shape),
                                out=lambda *_: None)
    np.testing.assert_allclose([s["loss"] for s in out["steps"]], losses, rtol=DESCENT_RTOL, atol=0)
    np.testing.assert_allclose([f["loss"] for f in out["final"]], finals, rtol=DESCENT_RTOL, atol=0)


def test_donation_probe_arms_bit_equal_and_clean_on_the_cpu():
    cfg = donation_probe.probe_config(3, 2, 2, overrides=["number_of_training_steps_per_iter=2"])
    out = donation_probe.ab(cfg, 3, "cpu", model=port_vgg(), out=lambda *_: None)
    assert out["verdict"] == "clean"
    assert out["losses"]["donate"] == out["losses"]["plain"]
    assert out["global_param_rel"] == 0.0 and out["max_loss_dev"] == 0.0


@pytest.mark.parametrize("entry", ["probe", "runner_selfcheck"])
def test_donation_arms_step_under_the_deterministic_algorithms(monkeypatch, entry):
    """Both arms of the A/B (the probe's and the runner's startup gate's,
    through ``observability/donation.py::run_donation_arm``) take every
    train step under torch's deterministic algorithms and cuDNN's
    deterministic convolutions, and leave the prior settings as they were."""
    from howtotrainyourmamlpytorch_tpu_torch.observability import donation

    seen = []
    real = MAMLSystem.train_step

    def train_step(self, *args, **kwargs):
        seen.append((torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(MAMLSystem, "train_step", train_step)
    cfg = donation_probe.probe_config(3, 2, 2, overrides=["number_of_training_steps_per_iter=2"])
    prior = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic)
    if entry == "probe":
        out = donation_probe.ab(cfg, 2, "cpu", model=port_vgg(), out=lambda *_: None)
    else:
        out = donation.donation_selfcheck(cfg, n_steps=2, device="cpu")
    assert out["verdict"] == "clean"
    assert len(seen) == 4 and all(flags == (True, True) for flags in seen)
    assert (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic) == prior


def test_donation_selfcheck_is_self_reproducible_on_the_cpu():
    cfg = donation_probe.probe_config(3, 2, 2, overrides=["number_of_training_steps_per_iter=2"])
    out = donation_probe.selfcheck(cfg, 2, "cpu", model=port_vgg(), out=lambda *_: None)
    assert out["donate"]["deterministic"] and out["plain"]["deterministic"]
    assert out["cross_worst_param_rel"] == 0.0


# ---------------------------------------------------------------------------
# imagenet_at_scale
# ---------------------------------------------------------------------------


def test_imagenet_at_scale_tiny_tree_against_the_jax_loader(tmp_path):
    root = str(tmp_path / "synth")
    model = port_vgg((84, 84, 3), 5)
    report = imagenet_at_scale.run(root, steps=1, assembly_batches=2, classes=32, per_class=6, device="cpu",
                                   model=model, overrides=["number_of_training_steps_per_iter=1"],
                                   out=lambda *_: None)
    assert set(report["stages"]) == {"tree_generation", "bootstrap_plus_ram_cache", "cached_bootstrap",
                                     "episode_assembly", "meta_steps"}
    assert all(s["seconds"] >= 0 and s["peak_rss_gb"] > 0 for s in report["stages"].values())
    assert report["images_generated"] == report["ram_cache_images"] == 32 * 6
    assert report["split"] == {"train": 20, "val": 5, "test": 7} == report["ram_cache_classes"]
    assert report["assembly_batches"] == 2 and report["meta_steps"]["finite"]
    data_dir = os.path.join(root, "mini_imagenet_full_size")
    jc = jcfg.Config(dataset=jcfg.DatasetConfig(name="mini_imagenet_full_size", path=data_dir),
                     index_cache_dir=str(tmp_path / "jidx"), load_into_memory=True, sets_are_pre_split=True,
                     num_classes_per_set=5, num_samples_per_class=5, num_target_samples=1, batch_size=8)
    ds = JaxFewShotDataset(jc)
    assert {k: len(v) for k, v in ds.datasets.items()} == report["ram_cache_classes"]
    batch = next(iter(JaxLoader(jc, dataset=ds).train_batches(1, augment_images=True)))
    assert {k: list(v.shape) for k, v in batch.items()} == report["episode_shapes"]
    assert report["episode_shapes"]["x_support"] == [8, 5, 5, 84, 84, 3]
    # a second run finds the tree complete and does not generate it again
    again = imagenet_at_scale.run(root, assembly_batches=1, classes=32, per_class=6, device="cpu",
                                  out=lambda *_: None)
    assert "tree_generation" not in again["stages"]


def test_imagenet_split_refuses_too_few_classes():
    assert imagenet_at_scale.split_counts(100) == {"train": 64, "val": 16, "test": 20}
    with pytest.raises(ValueError, match="every split needs 5 classes"):
        imagenet_at_scale.split_counts(20)


# ---------------------------------------------------------------------------
# every entry point: the card by default, never the CPU on its own
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["grad_precision_probe", "checkpoint_autopsy", "stream_replay_probe",
                                   "descent_probe", "donation_probe", "imagenet_at_scale"])
def test_entry_points_need_the_card_unless_the_cpu_is_asked_for(entry, port_run, toy_dataset, tmp_path,
                                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {
        "grad_precision_probe": ["save", str(tmp_path / "g.npz"), "3"],
        "checkpoint_autopsy": [port_run],
        "stream_replay_probe": [port_run, "0", "1"],
        "descent_probe": ["0", "3", "1", "--dataset-path", toy_dataset],
        "donation_probe": ["1", "3", "2", "2"],
        "imagenet_at_scale": ["--root", str(tmp_path / "never")],
    }[entry]
    module = globals()[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)
    assert not os.path.exists(tmp_path / "never")


# ---------------------------------------------------------------------------
# remat_probe
# ---------------------------------------------------------------------------


def test_remat_probe_arms_agree_and_count_the_dispatch_modes(tmp_path):
    """The probe's arms from one state and batch give one first loss; the
    profiler sees no ``__torch_dispatch__`` under ``none``, ``full`` and
    ``dots_saveable`` (whose record and replay are the C++ hook's), and one
    per op of the whole step under the pass-through arm."""
    from howtotrainyourmamlpytorch_tpu_torch.scripts import remat_probe

    path = str(tmp_path / "report.json")
    overrides = ["num_classes_per_set=3", "num_samples_per_class=1", "num_target_samples=1", "batch_size=2",
                 "number_of_training_steps_per_iter=2", "use_pallas_inner_update=true"]
    argv = ["--config", os.path.join(_ROOT, "configs", "default.yaml"), "--rounds", "1", "--chunk", "0",
            "--profile", "--device", "cpu", "--json", path, "--arms", "none", "full", "dots_saveable",
            "full+passthrough"]
    for o in overrides:
        argv += ["--override", o]
    assert remat_probe.main(argv) == 0
    with open(path) as f:
        arms = json.load(f)["arms"]
    assert len({a["first_loss"] for a in arms.values()}) == 1
    calls = {name: a["torch_dispatch"]["calls"] for name, a in arms.items()}
    assert calls["none"] == calls["full"] == calls["dots_saveable"] == 0 < calls["full+passthrough"]
    assert all(len(a["wall_ms"]) == 1 and a["wall_ms_median"] > 0 for a in arms.values())
