"""Session spill files across the packages, on the CPU.

The port writes a spilled session with its own flax-msgpack encoder, in the
JAX layout (``serving/sessions.py``): the tree blob is byte-identical to
``flax.serialization.to_bytes`` of the same weights, and a session spilled
by either package's ``ServingFrontend`` drain rehydrates in the other's
with its lineage (refine count, score trail, held-out probe, rollback
ring) and its predictions within atol 1e-5 (float32 on both sides, as in
``test_torch_serving.py``). Small size: VGG with 2 stages and 4 filters on
14x14x1 images, 5-way 2-shot, K=2; the JAX weights carried into the port.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from howtotrainyourmamlpytorch_tpu.serving.sessions import SessionStore as JaxSessionStore
from howtotrainyourmamlpytorch_tpu_torch.serving.cache import SessionLineage
from howtotrainyourmamlpytorch_tpu_torch.serving.sessions import (
    SessionStore,
    decode_lineage,
    encode_lineage,
    tree_from_bytes,
    tree_to_bytes,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import params_from_jax, params_to_jax
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten

from tests.test_torch_serving import ATOL, episode, jax_frontend, port_frontend, port_system, weights  # noqa: F401

torch.set_num_threads(2)


def _feature_shape():
    return port_system().model.feature_shape


def test_tree_bytes_equal_flax_to_bytes(weights):
    jsystem, jstate, state = weights
    feature_shape = _feature_shape()
    blob = tree_to_bytes(state.params, feature_shape)
    assert blob == serialization.to_bytes(jax.tree.map(np.asarray, jstate.params))
    back = tree_from_bytes(state.params, blob, feature_shape)
    for got, want in zip(tree_flatten(back)[0], tree_flatten(state.params)[0]):
        assert torch.equal(got, want)
    # flax restores the port's bytes against the JAX template
    restored = serialization.from_bytes(jstate.params, blob)
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_tree_from_bytes_refuses_another_structure(weights):
    _, _, state = weights
    feature_shape = _feature_shape()
    params = dict(state.params)
    params.pop("fc")
    with pytest.raises(ValueError, match="keys"):
        tree_from_bytes(state.params, tree_to_bytes(params, feature_shape), feature_shape)


def test_lineage_round_trip(weights):
    _, _, state = weights
    feature_shape = _feature_shape()
    lineage = SessionLineage(snapshot_ring=2)
    lineage.set_baseline(1.5)
    lineage.commit(state.params, 1.25)
    lineage.reject()
    lineage.probe = (np.ones((3, 14, 14, 1), np.float32), np.arange(3, dtype=np.int32))
    back = decode_lineage(encode_lineage(lineage, feature_shape), state.params, feature_shape)
    assert back.summary() == lineage.summary()
    assert back.scores == lineage.scores
    np.testing.assert_array_equal(back.probe[0], lineage.probe[0])
    np.testing.assert_array_equal(back.probe[1], lineage.probe[1])
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(back.snapshots[0])[0],
                                                 tree_flatten(state.params)[0]))
    assert decode_lineage({"snapshots": [b"junk"]}, state.params, feature_shape) is None


def _spill(front, x_s, y_s):
    """Adapt and refine one session -> its id."""
    sid = front.adapt(x_s, y_s)["adaptation_id"]
    assert front.refine(sid, x_s, y_s)["refine_count"] == 1
    return sid


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_session_spilled_by_one_package_rehydrates_in_the_other(weights, tmp_path, writer):
    x_s, y_s, x_q = episode(4)
    serving = dict(save_dir=tmp_path, refine_enabled=True, refine_regress_tol=100.0)
    make_writer, make_reader = (jax_frontend, port_frontend) if writer == "jax" else (port_frontend, jax_frontend)
    src = make_writer(weights, **serving)
    sid = _spill(src, x_s, y_s)
    before = np.asarray(src.predict(sid, x_q))
    lineage = src._lineage_for(src._cache_key(sid, "maml++"))
    assert src.begin_drain(reason="test")["spilled_sessions"] == 1
    assert len(os.listdir(tmp_path / "sessions")) == 1

    reader = make_reader(weights, **serving)
    try:
        assert reader._session_stats["rehydrated"] == 1
        got = reader._lineage_for(reader._cache_key(sid, "maml++"))
        assert got is not None
        assert (got.refine_count, got.scores, len(got.snapshots)) == (
            lineage.refine_count, lineage.scores, len(lineage.snapshots))
        np.testing.assert_array_equal(got.probe[0], lineage.probe[0])
        np.testing.assert_array_equal(got.probe[1], lineage.probe[1])
        np.testing.assert_allclose(np.asarray(reader.predict(sid, x_q)), before, rtol=0, atol=ATOL)
        assert reader.adapt(x_s, y_s)["cached"] is True
        assert reader.refine(sid, x_s, y_s)["refine_count"] == 2
    finally:
        reader.close()


def test_corrupt_and_foreign_sessions_are_not_served(weights, tmp_path):
    _, _, state = weights
    feature_shape = _feature_shape()
    store = SessionStore(str(tmp_path), feature_shape)
    good = store.spill("a" * 64, state.params, "ck", age_s=0.0, ttl_s=600.0)
    store.spill("b" * 64, state.params, "other-ck", age_s=0.0, ttl_s=600.0)
    store.spill("c" * 64, state.params, "ck", age_s=700.0, ttl_s=600.0)
    bad = store.spill("d" * 64, state.params, "ck", age_s=0.0, ttl_s=600.0)
    blob = bytearray(open(bad, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(bad, "wb").write(bytes(blob))
    entries, stats = store.load_all("ck", state.params)
    assert stats == {"loaded": 1, "stale": 1, "corrupt": 1, "foreign": 1}
    assert [e[0] for e in entries] == ["a" * 64] and not os.path.exists(good)
    assert os.path.exists(bad + ".corrupt")
    # the JAX reader takes the port's file, the port's reader JAX's
    jax_params = jax.tree.map(np.asarray, params_to_jax(state.params, feature_shape))
    path = store.spill("e" * 64, state.params, "ck", age_s=0.0, ttl_s=600.0)
    jentries, jstats = JaxSessionStore(str(tmp_path)).load_all("ck", jax_params)
    assert jstats["loaded"] == 1 and not os.path.exists(path)
    JaxSessionStore(str(tmp_path)).spill("f" * 64, jentries[0][1], "ck", age_s=0.0, ttl_s=600.0)
    entries, _ = store.load_all("ck", state.params)
    want = params_from_jax(jax_params, feature_shape)
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(entries[0][1])[0], tree_flatten(want)[0]))
