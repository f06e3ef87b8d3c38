"""The serving slice end to end: the port's ``AdaptationEngine`` against the
JAX package's, on the same weights (carried over in memory) and the same
requests, with the fused inner update on (JAX: Pallas in interpret mode;
port: the kernel's plain twin, since the tensors lie on the CPU).

Small shapes: VGG with 2 stages and 8 filters on 8x8x1 images, 3-way, K=2
inner steps. One flush of 3 requests with two support sizes (6 and 3), so
both the support bucket (8) and the task-batch bucket (4) pad.

Tolerance atol 1e-5 for adapted weights and probabilities: float32 on both
sides, with convolution/reduction sums in another order, and the JAX
interpret-mode update contracted into an FMA (see test_torch_fused_update),
carried through K=2 steps."""

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu.serving.engine import AdaptationEngine as JaxEngine
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.core.train_state import TrainState
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import params_to_jax, state_from_jax

torch.set_num_threads(1)

N_WAY, IMG, STEPS = 3, (8, 8, 1), 2
SUPPORT_SIZES, QUERY_SIZES = (6, 6, 3), (5, 8, 3)


def _cfg(module, fused=True, bf16=False):
    return module.Config(
        num_classes_per_set=N_WAY,
        num_samples_per_class=2,
        number_of_evaluation_steps_per_iter=STEPS,
        use_pallas_inner_update=fused,
        precision=module.PrecisionConfig(enabled=bf16),
        serving=module.ServingConfig(support_buckets=[4, 8], query_buckets=[8], max_batch_size=4),
    )


def requests(seed=0):
    rng = np.random.RandomState(seed)
    supports = [
        (rng.rand(s, *IMG).astype(np.float32), (np.arange(s) % N_WAY).astype(np.int32))
        for s in SUPPORT_SIZES
    ]
    queries = [rng.rand(q, *IMG).astype(np.float32) for q in QUERY_SIZES]
    return supports, queries


def jax_system_and_state(bf16=False):
    system = JaxMAMLSystem(_cfg(jcfg, bf16=bf16), model=jax_build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=8))
    state = system.init_train_state()
    # distinct per-tensor lrs: a leaf-order slip in the packed lr column shows
    leaves, treedef = jax.tree.flatten(state.inner_hparams["lr"])
    lrs = [np.float32(0.02 * (i + 1)) for i in range(len(leaves))]
    return system, state._replace(inner_hparams={"lr": jax.tree.unflatten(treedef, lrs)})


def jax_serve(engine, supports, queries):
    fws = engine.adapt_batch(supports)
    probs = engine.predict_batch(list(zip(fws, queries)))
    return [jax.tree.map(np.asarray, fw) for fw in fws], probs


def port_system(fused=True, bf16=False):
    model = build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=8)
    return MAMLSystem(_cfg(tcfg, fused, bf16), model=model, device="cpu")


def port_state(jax_state, system):
    params, bn_state, hparams = state_from_jax(
        jax.tree.map(np.asarray, jax_state.params),
        jax.tree.map(np.asarray, jax_state.bn_state),
        jax.tree.map(np.asarray, jax_state.inner_hparams),
        system.model.feature_shape,
    )
    return TrainState(params, bn_state, hparams, None, torch.zeros((), dtype=torch.int64))


def port_serve(engine, supports, queries):
    fws = engine.adapt_batch(supports)
    return fws, engine.predict_batch(list(zip(fws, queries)))


@pytest.fixture(scope="module")
def reference():
    system, state = jax_system_and_state()
    supports, queries = requests()
    fws, probs = jax_serve(JaxEngine(system, state), supports, queries)
    return state, supports, queries, fws, probs


def test_port_engine_matches_jax_engine(reference):
    jax_state, supports, queries, jax_fws, jax_probs = reference
    system = port_system()
    engine = AdaptationEngine(system, port_state(jax_state, system))
    fws, probs = port_serve(engine, supports, queries)
    for fw, jfw in zip(fws, jax_fws):
        got = params_to_jax(fw, system.model.feature_shape)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jfw)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for p, jp, q in zip(probs, jax_probs, QUERY_SIZES):
        assert p.shape == (q, N_WAY)
        np.testing.assert_allclose(p, np.asarray(jp), rtol=0, atol=1e-5)
    counts = engine.compile_counts()
    assert (counts["adapt_shapes"], counts["predict_shapes"]) == (1, 1)


def test_bf16_inner_policy_matches_jax_engine():
    """``precision.enabled``: the fast weights and the fused update run in
    bf16 in both packages. bf16 rounds at other places in the two
    frameworks (inside the convolutions, at the casts). The head's weights
    agree within a few bf16 ulps (rtol 2**-5, atol 2**-7). The conv weights,
    and with them the probabilities, are not compared: at a random init
    their gradients pass through each BN's mean/scale removal, small
    differences of large terms, and in bf16 that rounding noise reaches tens
    of percent of the update in either framework. The probabilities are
    checked to be float32 distributions."""
    system, state = jax_system_and_state(bf16=True)
    supports, queries = requests()
    jax_fws, jax_probs = jax_serve(JaxEngine(system, state), supports, queries)
    port = port_system(bf16=True)
    assert port.precision.name == "bf16_inner"
    fws, probs = port_serve(AdaptationEngine(port, port_state(state, port)), supports, queries)
    for fw, jfw in zip(fws, jax_fws):
        assert all(leaf.dtype == torch.bfloat16 for leaf in jax.tree.leaves(fw))
        got = params_to_jax(fw, port.model.feature_shape)
        for key in ("w", "b"):
            np.testing.assert_allclose(
                got["fc"][key], np.asarray(jfw["fc"][key], np.float32), rtol=2.0**-5, atol=2.0**-7
            )
    for p, jp in zip(probs, jax_probs):
        assert p.dtype == np.float32 and p.shape == np.asarray(jp).shape
        np.testing.assert_allclose(p.sum(-1), 1.0, rtol=0, atol=1e-6)


def test_fused_and_unfused_port_paths_are_bit_identical(reference):
    """On the CPU the fused update's twin is the unfused per-leaf update bit
    for bit (f32), so the whole slice agrees exactly; no kernel launches."""
    jax_state, supports, queries, _, _ = reference
    out = {}
    fused_update.reset_launch_counts()
    for fused in (True, False):
        system = port_system(fused)
        out[fused] = port_serve(AdaptationEngine(system, port_state(jax_state, system)), supports, queries)[1]
    assert fused_update.launch_counts["fused_sgd"] == 0
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)


def test_request_alone_equals_its_place_in_the_padded_flush(reference):
    jax_state, supports, queries, _, _ = reference
    system = port_system()
    engine = AdaptationEngine(system, port_state(jax_state, system))
    _, flush_probs = port_serve(engine, supports, queries)
    alone = engine.predict(engine.adapt(*supports[2]), queries[2])
    np.testing.assert_allclose(alone, flush_probs[2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(alone.sum(-1), 1.0, rtol=0, atol=1e-6)
    assert engine.compile_counts()["adapt_shapes"] == 2  # (bucket 8, batch 4) and (4, 1)


def test_unported_paths_raise(reference):
    jax_state, supports, _, _, _ = reference
    system = port_system()
    engine = AdaptationEngine(system, port_state(jax_state, system))
    # anil serves since ROADMAP.md A7: the head adapted, the body unchanged
    anil = engine.adapt_batch(supports, strategy="anil")
    assert len(anil) == len(supports)
    assert all(torch.equal(fw["stage_0"]["conv"]["w"], engine.state.params["stage_0"]["conv"]["w"]) for fw in anil)
    assert not torch.equal(anil[0]["fc"]["w"], engine.state.params["fc"]["w"])
    # tenants serve since ROADMAP.md A8.4, through a registry: an engine
    # without one refuses a tenant as the JAX package's does
    with pytest.raises(ValueError, match="no tenant registry"):
        engine.adapt_batch(supports, tenant="t1")
    # refine sessions serve since ROADMAP.md A8.3: the engine constructs
    refine = _cfg(tcfg)
    refine.serving.refine_enabled = True
    assert "refine_programs" in AdaptationEngine(system, engine.state, serving_cfg=refine.serving).compile_counts()
    # inner Adam and the ResNet backbone (ROADMAP.md A6) construct
    assert MAMLSystem(tcfg.load_config(None, ["inner_optim=adam"]), device="cpu").inner_opt.name == "adam"
    assert MAMLSystem(tcfg.load_config(None, ["net=resnet-4"]), device="cpu").model.name == "resnet"
