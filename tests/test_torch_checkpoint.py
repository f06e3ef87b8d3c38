"""Checkpoints between the packages. The port reads the JAX package's: a run
directory written by ``experiment.checkpoint.save_checkpoint`` serves
through the port's ``AdaptationEngine.from_run_dir`` with the JAX engine's
probabilities (atol 1e-5, the slice tolerance of test_torch_slice), and a
damaged file raises ``CheckpointCorruptError``. Training resumes across
them in both directions, formats 2 and 3 (linear model of
test_torch_train: the next step agrees at atol 1e-5); the port writes
both formats. ``save_named`` files load in the JAX package, a corrupt
``latest`` is quarantined and the newest valid epoch resumes, and the async
writer keeps one save in flight."""

import os
import threading

import jax
import msgpack
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.experiment import checkpoint as jax_ckpt
from howtotrainyourmamlpytorch_tpu.serving.engine import AdaptationEngine as JaxEngine
from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten

from .test_torch_slice import jax_serve, jax_system_and_state, port_serve, port_system, requests
from .test_torch_train import _jnp, _outputs_close, _state_close, batch, pair


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A JAX-written run directory (config + format-2 checkpoint) and the
    JAX engine's probabilities for the slice's requests."""
    system, state = jax_system_and_state()
    root = tmp_path_factory.mktemp("jax_run")
    save_dir = root / "saved_models"
    save_dir.mkdir()
    jcfg.save_config(system.cfg, str(root / "config.yaml"))
    jax_ckpt.save_checkpoint(str(save_dir), state, {"epoch": 0}, epoch=0)
    supports, queries = requests()
    _, probs = jax_serve(JaxEngine(system, state), supports, queries)
    return root, probs


def _copy_run(src, dst):
    (dst / "saved_models").mkdir(parents=True)
    (dst / "config.yaml").write_bytes((src / "config.yaml").read_bytes())
    return dst / "saved_models" / "train_model_latest"


def test_from_run_dir_serves_the_jax_checkpoint(run_dir):
    root, jax_probs = run_dir
    engine = AdaptationEngine.from_run_dir(str(root), "best", system=port_system())
    state, _ = jax_ckpt.load_for_inference(str(root / "saved_models"), "latest")
    assert engine.fingerprint == state.fingerprint  # 'best' fell back to 'latest'
    supports, queries = requests()
    _, probs = port_serve(engine, supports, queries)
    for p, jp in zip(probs, jax_probs):
        np.testing.assert_allclose(p, np.asarray(jp), rtol=0, atol=1e-5)


def test_pre_format_2_checkpoint_loads_unverified(run_dir, tmp_path):
    root, jax_probs = run_dir
    with open(root / "saved_models" / "train_model_0", "rb") as f:
        outer = msgpack.unpackb(f.read(), raw=False)
    target = _copy_run(root, tmp_path)
    target.write_bytes(outer["body"])  # the bare payload, as before format 2
    engine = AdaptationEngine.from_run_dir(str(tmp_path), "latest", system=port_system())
    supports, queries = requests()
    _, probs = port_serve(engine, supports, queries)
    np.testing.assert_allclose(probs[0], np.asarray(jax_probs[0]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("damage", ["flipped_byte", "truncated"])
def test_damaged_checkpoint_raises(run_dir, tmp_path, damage):
    root, _ = run_dir
    blob = bytearray((root / "saved_models" / "train_model_latest").read_bytes())
    if damage == "flipped_byte":
        blob[len(blob) // 2] ^= 0xFF
    else:
        blob = blob[: len(blob) // 3]
    _copy_run(root, tmp_path).write_bytes(bytes(blob))
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_for_inference(str(tmp_path / "saved_models"), "latest")
    with pytest.raises(ckpt.CheckpointCorruptError):
        AdaptationEngine.from_run_dir(str(tmp_path), "latest", system=port_system())


def test_format_3_writing_is_refused_naming_a9(tmp_path):
    """Format 3, refused (naming ROADMAP A9) before the port wrote it, is
    written: two shard files and a manifest per name, which the JAX package
    loads to the same state and the port loads back bit for bit."""
    jsys, jstate, tsys, tstate = pair("linear")
    ckpt.save_checkpoint(str(tmp_path), tstate, {"epoch": 1}, epoch=1,
                         feature_shape=tsys.model.feature_shape, num_shards=2)
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"train_model_{i}{s}" for i in (1, "latest") for s in ("", ".shard0", ".shard1"))
    restored, book = jax_ckpt.load_checkpoint(str(tmp_path), "latest", jstate)
    assert book == {"epoch": 1}
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back, _ = ckpt.load_checkpoint(str(tmp_path), 1, tstate, feature_shape=tsys.model.feature_shape)
    for a, b in zip(tree_flatten(_as_dict(back))[0], tree_flatten(_as_dict(tstate))[0]):
        assert torch.equal(a, b)


def _as_dict(tree):
    """A NamedTuple/tuple state as a dict tree, for ``tree_flatten``."""
    if isinstance(tree, tuple):
        return {str(i): _as_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _as_dict(v) for k, v in tree.items()}
    return tree


def _train(system, state, seeds, jax_side=False):
    for seed in seeds:
        b = batch(seed=seed)
        state, _ = system.train_step(state, _jnp(b) if jax_side else b, epoch=0)
    return state


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The port trains 2 steps and saves; the JAX package's
    ``load_checkpoint`` (with its template) resumes it, and its next step
    equals the port's next step."""
    jsys, jstate, tsys, tstate = pair("linear")
    tstate = _train(tsys, tstate, (20, 21))
    bookkeeping = {"epoch": 0, "mid_epoch_iter": 2, "best_val_acc": 0.5}
    ckpt.save_checkpoint(str(tmp_path), tstate, bookkeeping, epoch=0, feature_shape=tsys.model.feature_shape)
    restored, got_bk = jax_ckpt.load_checkpoint(str(tmp_path), "latest", jsys.init_train_state())
    assert got_bk == bookkeeping and int(restored.step) == 2
    b = batch(seed=30)
    jnew, jout = jsys.train_step(restored, _jnp(b), epoch=0)
    new, out = tsys.train_step(tstate, b, epoch=0)
    _outputs_close(out, jout)
    _state_close(tsys, new, jnew)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The other way round: JAX trains 2 steps and saves (format 2); the
    port resumes the full state, outer Adam included, on its own template,
    and its next step equals JAX's."""
    jsys, jstate, tsys, _ = pair("linear")
    jstate = _train(jsys, jstate, (40, 41), jax_side=True)
    jax_ckpt.save_checkpoint(str(tmp_path), jstate, {"epoch": 0}, epoch=0)
    tstate, bookkeeping = ckpt.load_checkpoint(
        str(tmp_path), 0, tsys.init_train_state(), feature_shape=tsys.model.feature_shape
    )
    assert bookkeeping == {"epoch": 0} and tstate.step.dtype == torch.int64 and int(tstate.step) == 2
    _state_close(tsys, tstate, jstate, atol=0.0)  # the bytes JAX wrote
    b = batch(seed=50)
    jnew, jout = jsys.train_step(jstate, _jnp(b), epoch=0)
    new, out = tsys.train_step(tstate, b, epoch=0)
    _outputs_close(out, jout)
    _state_close(tsys, new, jnew)


@pytest.fixture
def sharded(tmp_path):
    """A format-3 checkpoint written by JAX ``save_checkpoint(num_shards=2)``
    after one step: the linear model has an empty ``bn_state``, stored as
    one ``__empty_dict__`` key."""
    jsys, jstate, tsys, _ = pair("linear")
    jstate = _train(jsys, jstate, (60,), jax_side=True)
    jax_ckpt.save_checkpoint(str(tmp_path), jstate, {"epoch": 1}, epoch=1, num_shards=2)
    assert os.path.exists(tmp_path / "train_model_1.shard1")
    return tmp_path, jstate, tsys


def test_jax_sharded_checkpoint_resumes_in_port(sharded):
    save_dir, jstate, tsys = sharded
    tstate, bookkeeping = ckpt.load_checkpoint(
        str(save_dir), 1, tsys.init_train_state(), feature_shape=tsys.model.feature_shape
    )
    assert bookkeeping == {"epoch": 1} and tstate.bn_state == {}
    _state_close(tsys, tstate, jstate, atol=0.0)
    served, _ = ckpt.load_for_inference(str(save_dir), "latest")
    np.testing.assert_array_equal(served.params["fc"]["w"], np.asarray(jstate.params["fc"]["w"]))


def test_flipped_byte_in_a_shard_raises(sharded):
    save_dir, _, tsys = sharded
    shard = save_dir / "train_model_1.shard0"
    blob = bytearray(shard.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    shard.write_bytes(bytes(blob))
    with pytest.raises(ckpt.CheckpointCorruptError, match="shard"):
        ckpt.load_checkpoint(str(save_dir), 1, tsys.init_train_state(), feature_shape=tsys.model.feature_shape)
    with pytest.raises(ckpt.CheckpointCorruptError, match="shard"):
        ckpt.load_for_inference(str(save_dir), 1)


def test_save_named_best_loads_in_jax(tmp_path):
    """``save_named(..., "best")`` writes the JAX package's file: its
    ``load_checkpoint`` restores the state byte for byte."""
    jsys, _, tsys, tstate = pair("linear")
    tstate = _train(tsys, tstate, (70,))
    bookkeeping = {"epoch": 3, "best_val_accuracy": 0.75}
    path = ckpt.save_named(str(tmp_path), tstate, bookkeeping, "best", feature_shape=tsys.model.feature_shape)
    assert path == str(tmp_path / "train_model_best") and ckpt.available_epochs(str(tmp_path)) == []
    restored, got_bk = jax_ckpt.load_checkpoint(str(tmp_path), "best", jsys.init_train_state())
    assert got_bk == bookkeeping
    _state_close(tsys, tstate, restored, atol=0.0)


def test_corrupt_latest_is_quarantined_and_the_newest_epoch_resumes(tmp_path):
    _, _, tsys, tstate = pair("linear")
    fs = tsys.model.feature_shape
    states = []
    for epoch, seed in enumerate((80, 81, 82)):
        tstate = _train(tsys, tstate, (seed,))
        states.append(tstate)
        ckpt.save_checkpoint(str(tmp_path), tstate, {"epoch": epoch}, epoch, feature_shape=fs)
    for idx in ("latest", 2):  # a torn 'latest' and a torn newest epoch
        blob = bytearray((tmp_path / f"train_model_{idx}").read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        (tmp_path / f"train_model_{idx}").write_bytes(bytes(blob))
    state, bookkeeping, used = ckpt.load_latest_with_fallback(str(tmp_path), tsys.init_train_state(), feature_shape=fs)
    assert used == 1 and bookkeeping == {"epoch": 1}
    assert all(torch.equal(a, b) for a, b in zip(_leaves(state), _leaves(states[1])))
    assert sorted(os.listdir(tmp_path)) == [
        "train_model_0", "train_model_1", "train_model_2.corrupt", "train_model_latest.corrupt"]
    assert not ckpt.checkpoint_exists(str(tmp_path), "latest") and ckpt.quarantine(str(tmp_path), "latest") is None
    for idx in (0, 1):
        (tmp_path / f"train_model_{idx}").write_bytes(b"not a checkpoint")
    with pytest.raises(ckpt.CheckpointCorruptError, match="no valid checkpoint"):
        ckpt.load_latest_with_fallback(str(tmp_path), tsys.init_train_state(), feature_shape=fs)


def _leaves(state):
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    return tree_leaves({"p": state.params, "h": state.inner_hparams}) + [state.step]


def test_async_writer_keeps_one_save_in_flight_and_drains():
    """``submit`` returns while its save runs; the next ``submit`` first
    waits for it (the one-save lag); ``wait`` drains; a failed save
    re-raises once, at the next call."""
    writer = ckpt.AsyncCheckpointWriter()
    release, order = threading.Event(), []

    def slow():
        assert release.wait(timeout=30)
        order.append("first")

    writer.submit(slow)
    assert writer.busy and order == []
    timer = threading.Timer(0.2, release.set)
    timer.start()
    writer.submit(lambda: order.append("second"))  # blocks until "first" lands
    assert order[0] == "first"
    writer.wait()
    assert order == ["first", "second"] and not writer.busy

    def fail():
        raise OSError("disk full")

    writer.submit(fail)
    with pytest.raises(OSError, match="disk full"):
        writer.wait()
    writer.close()  # the error was reported once
    timer.join(timeout=5)
    assert not timer.is_alive()
