"""The port's episode data layer against the JAX package's: the same toy
image folder (``tests/test_runner.py``'s layout) gives bit-equal batches
(train with and without augmentation, val, test) on the native C++ path, the
in-memory numpy path and the from-disk path; the train cursor matches after
N batches and after ``continue_from_iter``; an index JSON written by either
package is read by the other; the native engine builds under the port's
``build/`` directory."""

import os

import numpy as np
import pytest
from PIL import Image

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu import native as jax_native
from howtotrainyourmamlpytorch_tpu.data import MetaLearningDataLoader as JaxLoader
from howtotrainyourmamlpytorch_tpu.data import index as jax_index
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch import native
from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningDataLoader
from howtotrainyourmamlpytorch_tpu_torch.data import index as port_index

_PACKAGE = os.path.dirname(os.path.abspath(native.__file__))


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


def _config(module, toy_dataset, **overrides):
    base = dict(
        dataset=module.DatasetConfig(name="omniglot_toy", path=toy_dataset),
        num_classes_per_set=3,
        num_samples_per_class=2,
        num_target_samples=2,
        batch_size=2,
        load_into_memory=True,
        num_dataprovider_workers=2,
        train_val_test_split=(0.6, 0.2, 0.2),
    )
    base.update(overrides)
    return module.Config(**base)


PATHS = {
    "native": {},
    "numpy": {},  # in memory, the engine switched off in both packages
    "disk": {"load_into_memory": False},
}


@pytest.fixture(params=sorted(PATHS))
def loaders(request, toy_dataset, monkeypatch):
    path = request.param
    if path != "native":
        monkeypatch.setattr(jax_native, "load_engine", lambda: None)
        monkeypatch.setattr(native, "load_engine", lambda: None)
    elif native.load_engine() is None:
        pytest.fail("g++ did not build the native episode engine")
    port = MetaLearningDataLoader(_config(tcfg, toy_dataset, **PATHS[path]))
    ref = JaxLoader(_config(jcfg, toy_dataset, **PATHS[path]))
    yield path, port, ref
    port.close()
    ref.close()


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("augment", [True, False])
def test_train_batches_bit_equal(loaders, augment):
    path, port, ref = loaders
    _assert_batches_equal(list(port.train_batches(4, augment_images=augment)),
                          list(ref.train_batches(4, augment_images=augment)))
    stats = port.stats()
    assert stats["train_episodes_produced"] == ref.train_episodes_produced == 4 * 2
    want_native = 4 if path == "native" else 0
    assert (stats["native_batches"], stats["numpy_batches"]) == (want_native, 4 - want_native)


@pytest.mark.parametrize("split", ["val", "test"])
def test_eval_batches_bit_equal(loaders, split):
    _, port, ref = loaders
    got = list(getattr(port, f"{split}_batches")(3))
    _assert_batches_equal(got, list(getattr(ref, f"{split}_batches")(3)))
    # fixed-seed streams: the same episodes every epoch
    _assert_batches_equal(list(getattr(port, f"{split}_batches")(3)), got)
    assert port.train_episodes_produced == 0


def test_batch_shapes_are_nhwc(loaders):
    _, port, _ = loaders
    batch = next(iter(port.train_batches(1)))
    assert batch["x_support"].shape == (2, 3, 2, 28, 28, 1)
    assert batch["x_target"].shape == (2, 3, 2, 28, 28, 1)
    assert batch["y_support"].shape == (2, 3, 2) and batch["y_support"].dtype == np.int32


def test_resume_cursor_matches(toy_dataset):
    """After N batches, and from ``continue_from_iter`` (a new loader's
    ``current_iter``), both packages sit at the same cursor and draw the
    same next batches, which are the uninterrupted stream's."""
    port = MetaLearningDataLoader(_config(tcfg, toy_dataset))
    ref = JaxLoader(_config(jcfg, toy_dataset))
    stream = list(port.train_batches(5))
    list(ref.train_batches(3))
    assert port.train_episodes_produced == 10 and ref.train_episodes_produced == 6
    port.continue_from_iter(3)
    assert port.train_episodes_produced == ref.train_episodes_produced == 6
    _assert_batches_equal(list(port.train_batches(2)), list(ref.train_batches(2)))
    resumed = MetaLearningDataLoader(_config(tcfg, toy_dataset), current_iter=3)
    assert resumed.train_episodes_produced == 6
    _assert_batches_equal(list(resumed.train_batches(2)), stream[3:])
    for loader in (port, ref, resumed):
        loader.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_json_is_shared(toy_dataset, tmp_path, monkeypatch, writer):
    """An index one package writes, the other reads as written: its reader
    never rebuilds."""
    modules = {"jax": jax_index, "port": port_index}
    reader = modules["port" if writer == "jax" else "jax"]
    built = modules[writer].load_or_build_index(toy_dataset, "omniglot_toy", cache_dir=str(tmp_path))
    assert len(built[0]) == 20 and all(len(v) == 6 for v in built[0].values())

    def no_rebuild(*args, **kwargs):
        raise AssertionError("the index was rebuilt, not read")

    monkeypatch.setattr(reader, "build_index", no_rebuild)
    assert reader.load_or_build_index(toy_dataset, "omniglot_toy", cache_dir=str(tmp_path)) == built
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(os.path.basename(p) for p in port_index.index_paths(toy_dataset, "omniglot_toy", str(tmp_path)))


def test_native_engine_builds_under_the_port_build_dir():
    if native.load_engine() is None:
        pytest.fail("g++ did not build the native episode engine")
    assert native._LIB == os.path.join(os.path.dirname(_PACKAGE), "build", "episode_engine.so")
    assert os.path.isfile(native._LIB)
    assert not [name for name in os.listdir(_PACKAGE) if name.endswith(".so")]
    cache = np.arange(2 * 4 * 4, dtype=np.float32).reshape(2, 4, 4, 1)
    out = native.assemble_episodes(cache, np.array([[[1], [0]]], np.int64), np.array([[1, 0]], np.int32))
    np.testing.assert_array_equal(out[0, 0, 0], np.rot90(cache[1], 1, axes=(0, 1)))
    np.testing.assert_array_equal(out[0, 1, 0], cache[0])
