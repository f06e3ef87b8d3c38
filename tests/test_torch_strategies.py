"""The strategy registry (``core/strategies.py``) of the port against the
JAX package's, mirroring ``tests/test_strategies.py`` and the engine tests
of ``tests/test_sessions_refine.py``: the same seeded numpy inputs and the
JAX parameters (carried over by ``utils/interop.py``) through both
packages on the CPU. The JAX side runs its ``lax.scan`` program without
remat (``unroll_inner_steps=False``): on this jax the unrolled and remat
second-order programs are far from float64 (ROADMAP.md C), the scan one
is not. The port's fused update runs on the kernels' plain twins (the
tensors lie on the CPU).

Small shapes: VGG with 2 stages and 8 filters on 8x8x1 images, 3-way,
K=2. Tolerances, stated per test: the head/body partition exactly; adapted
weights and probabilities atol 1e-5 (the serving slice's tolerance);
losses 1e-5; meta-gradients within 1e-5 of their largest element (one
scale for every leaf: VGG conv-bias meta-gradients are float32 noise,
exactly zero under transductive BN); the state after the outer Adam 1e-5,
conv biases left out (Adam turns their noise into +-lr steps).
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.core import strategies as jax_strategies
from howtotrainyourmamlpytorch_tpu.experiment import checkpoint as jax_ckpt
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu.serving.engine import AdaptationEngine as JaxEngine
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core import maml as tmaml
from howtotrainyourmamlpytorch_tpu_torch.core import strategies
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.models.registry import build_model
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import params_to_jax, trainables_to_jax
from howtotrainyourmamlpytorch_tpu_torch.utils.seeding import model_init_generator
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten, tree_leaves, tree_map

from .test_torch_slice import port_state as serving_state
from .test_torch_train import IMG, N_WAY, _close, _jnp, batch, jax_meta_gradients, pair
from .test_torch_train import port_state as train_state

torch.set_num_threads(1)

ATOL = 1e-5
STRATEGIES = ["maml++", "fomaml", "anil", "protonet"]
SUPPORT_SIZES, QUERY_SIZES = (6, 6, 3), (5, 8, 3)


# ---------------------------------------------------------------------------
# the head/body partition: exact
# ---------------------------------------------------------------------------


def test_head_body_partition_is_exact_and_matches_jax():
    params, _ = build_model("vgg", (28, 28, 1), N_WAY).init(model_init_generator(0))
    head, body = strategies.split_head_body(params)
    assert set(head) == {"fc"} and set(body) == set(params) - {"fc"}
    merged = strategies.merge_head_body(head, body)
    assert tree_flatten(merged)[1] == tree_flatten(params)[1]
    assert all(a is b for a, b in zip(tree_leaves(merged), tree_leaves(params)))
    # DenseNet names its head "classifier"
    dense, _ = build_model("densenet-8", (28, 28, 1), N_WAY).init(model_init_generator(0))
    assert set(strategies.split_head_body(dense)[0]) == {"classifier"}
    # the derived trees, as the JAX package slices them
    derived = [
        {"lr": {"stage_0": 0.1, "fc": 0.2}},
        {"step": {"stage_0": 0, "fc": 0}, "exp_avg": {"stage_0": 1, "fc": 2}},
        (),
        {"lr": {"stage_0": {"w": 1}, "classifier": {"w": 2, "b": 3}}},
    ]
    for tree in derived:
        assert strategies.take_head(tree) == jax_strategies.take_head(tree)
    toy = {"stage_0": {"conv": 1}, "stage_1": {"conv": 2}, "fc": {"w": 3}}
    assert strategies.split_head_body(toy) == jax_strategies.split_head_body(toy)
    for bad in ({"stage_0": 1}, [1, 2]):
        with pytest.raises(ValueError, match="head"):
            strategies.split_head_body(bad)


# ---------------------------------------------------------------------------
# serving: every strategy through both engines
# ---------------------------------------------------------------------------


def _serving_cfg(module, strategy="maml++", menu=STRATEGIES, support_buckets=(4, 8), fused=True, **kw):
    return module.Config(
        num_classes_per_set=N_WAY, num_samples_per_class=2, number_of_evaluation_steps_per_iter=2,
        use_pallas_inner_update=fused, strategy=strategy, unroll_inner_steps=False, remat_inner_steps=False,
        serving=module.ServingConfig(support_buckets=list(support_buckets), query_buckets=[8, 16],
                                     max_batch_size=4, strategies=list(menu)),
        **kw,
    )


def _jax_serving(strategy="maml++", **kw):
    cfg = _serving_cfg(jcfg, strategy, **kw)
    system = JaxMAMLSystem(cfg, model=jax_build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=8))
    state = system.init_train_state()
    leaves, treedef = jax.tree.flatten(state.inner_hparams["lr"])
    lrs = [np.float32(0.02 * (i + 1)) for i in range(len(leaves))]
    return system, state._replace(inner_hparams={"lr": jax.tree.unflatten(treedef, lrs)})


def _port_serving(jax_state, strategy="maml++", **kw):
    system = MAMLSystem(_serving_cfg(tcfg, strategy, **kw), model=build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=8),
                        device="cpu")
    return system, serving_state(jax_state, system)


def _requests(seed=0, sizes=SUPPORT_SIZES, queries=QUERY_SIZES):
    rng = np.random.RandomState(seed)
    supports = [(rng.rand(s, *IMG).astype(np.float32), (np.arange(s) % N_WAY).astype(np.int32)) for s in sizes]
    return supports, [rng.rand(q, *IMG).astype(np.float32) for q in queries]


@pytest.fixture(scope="module")
def served():
    """The JAX engine's adapted trees and probabilities for every strategy
    on one flush of 3 requests (support 6, 6, 3: both buckets pad)."""
    system, state = _jax_serving()
    engine = JaxEngine(system, state)
    supports, queries = _requests()
    out = {}
    for strategy in STRATEGIES:
        fws = engine.adapt_batch(supports, strategy=strategy)
        out[strategy] = ([jax.tree.map(np.asarray, fw) for fw in fws],
                         [np.asarray(p) for p in engine.predict_batch(list(zip(fws, queries)), strategy=strategy)])
    return state, supports, queries, out


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_serves_every_strategy_like_jax(served, strategy):
    """Adapted trees and probabilities within 1e-5 of the JAX engine's;
    under anil the body bit-unchanged (views of the masters) and the head
    moved; under protonet a ``[n_way, n_way]`` table per request."""
    jax_state, supports, queries, out = served
    jax_fws, jax_probs = out[strategy]
    system, state = _port_serving(jax_state)
    engine = AdaptationEngine(system, state)
    fws = engine.adapt_batch(supports, strategy=strategy)
    probs = engine.predict_batch(list(zip(fws, queries)), strategy=strategy)
    for fw, jfw in zip(fws, jax_fws):
        if strategy == "protonet":
            assert set(fw) == {"prototypes"}
            assert tuple(fw["prototypes"].shape) == strategies.protonet_prototype_shape(N_WAY)
            _close(fw["prototypes"].numpy(), jfw["prototypes"])
            continue
        _close(params_to_jax(fw, system.model.feature_shape), jfw)
        if strategy == "anil":
            head, body = strategies.split_head_body(fw)
            for a, b in zip(tree_leaves(body), tree_leaves(strategies.split_head_body(state.params)[1])):
                assert torch.equal(a, b)
            assert not torch.equal(head["fc"]["w"], state.params["fc"]["w"])
    for p, jp, q in zip(probs, jax_probs, QUERY_SIZES):
        assert p.shape == (q, N_WAY)
        np.testing.assert_allclose(p, jp, rtol=0, atol=ATOL)


def test_fomaml_serving_is_maml_plus_plus_bitwise(served):
    """Serving adaptation is first order, so the two strategies are one
    rollout."""
    jax_state, supports, queries, _ = served
    engine = AdaptationEngine(*_port_serving(jax_state))
    a, b = (engine.adapt_batch(supports, strategy=s) for s in ("maml++", "fomaml"))
    for fa, fb in zip(a, b):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(fa), tree_leaves(fb)))


def test_protonet_matches_numpy_reference(served):
    """``tests/test_strategies.py::test_protonet_matches_numpy_reference``:
    embed through the master network's logits, per-class means, negative
    squared Euclidean distance, softmax, in numpy (float64): within 1e-5."""
    jax_state, supports, queries, _ = served
    system, state = _port_serving(jax_state)
    engine = AdaptationEngine(system, state)
    x_s, y_s = supports[0]
    fw = engine.adapt(x_s, y_s, strategy="protonet")
    probs = engine.predict(fw, queries[0], strategy="protonet")

    def embed(x):
        masters = tree_map(lambda a: a.unsqueeze(0), state.params)
        return system.predict_logits(masters, state.bn_state, x[None])[0].numpy().astype(np.float64)

    z_s = embed(x_s)
    protos = np.stack([z_s[y_s == k].mean(axis=0) for k in range(N_WAY)])
    np.testing.assert_allclose(fw["prototypes"].numpy(), protos, rtol=0, atol=ATOL)
    d2 = ((embed(queries[0])[:, None, :] - protos[None]) ** 2).sum(-1)
    e = np.exp(-d2 - (-d2).max(axis=-1, keepdims=True))
    np.testing.assert_allclose(probs, e / e.sum(axis=-1, keepdims=True), rtol=0, atol=ATOL)


def test_protonet_bucket_padding_is_prediction_invariant(served):
    """Support 10 padded to a 16-bucket gives the exact-shape prototypes
    and probabilities within 1e-5 (masked means, masked BN)."""
    jax_state, _, _, _ = served
    supports, queries = _requests(seed=9, sizes=(10,), queries=(15,))
    got = {}
    for bucket in (10, 16):
        engine = AdaptationEngine(*_port_serving(jax_state, menu=["protonet"], support_buckets=(bucket,)))
        assert engine.support_bucket(10) == bucket
        fw = engine.adapt(*supports[0])
        got[bucket] = (fw["prototypes"].numpy(), engine.predict(fw, queries[0]))
    np.testing.assert_allclose(got[16][0], got[10][0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[16][1], got[10][1], rtol=0, atol=ATOL)


def test_protonet_is_refused_as_train_rollout_and_refine_strategy(served):
    jax_state, supports, _, _ = served
    with pytest.raises(ValueError, match="serving-only|forward-only"):
        tcfg.Config(strategy="protonet")
    system, state = _port_serving(jax_state)
    x = np.zeros((1, 6) + IMG, np.float32)
    y = np.zeros((1, 6), np.int64)
    with pytest.raises(ValueError, match="protonet"):
        system.adapt_fast_weights(state, x, y, strategy="protonet")
    fw = system.adapt_fast_weights(state, x, y)
    with pytest.raises(ValueError, match="protonet"):
        system.refine_fast_weights(state, fw, x, y, strategy="protonet")
    engine = AdaptationEngine(system, state)
    with pytest.raises(ValueError, match="protonet"):
        engine.refine(engine.adapt(*supports[0], strategy="protonet"), *supports[0], strategy="protonet")
    cfg = _serving_cfg(tcfg)
    cfg.strategy = "protonet"
    with pytest.raises(ValueError, match="protonet"):
        MAMLSystem(cfg, device="cpu")


@pytest.mark.parametrize("strategy", ["maml++", "anil"])
def test_engine_refine_matches_jax_refine_fast_weights(served, strategy):
    """The port's ``refine_batch`` from its own adapt against the JAX
    engine's (``refine_fast_weights`` under ``vmap``) from JAX's adapt:
    refined weights and probabilities within 1e-5; refining moved them."""
    jax_state, supports, queries, out = served
    jax_system, _ = _jax_serving()
    jengine = JaxEngine(jax_system, jax_state)
    jfws = jengine.adapt_batch(supports, strategy=strategy)
    jref = jengine.refine_batch([(fw, x, y) for fw, (x, y) in zip(jfws, supports)], strategy=strategy)
    jprobs = jengine.predict_batch(list(zip(jref, queries)), strategy=strategy)
    system, state = _port_serving(jax_state)
    engine = AdaptationEngine(system, state)
    fws = engine.adapt_batch(supports, strategy=strategy)
    refined = engine.refine_batch([(fw, x, y) for fw, (x, y) in zip(fws, supports)], strategy=strategy)
    probs = engine.predict_batch(list(zip(refined, queries)), strategy=strategy)
    for fw, jfw in zip(refined, jref):
        _close(params_to_jax(fw, system.model.feature_shape), jax.tree.map(np.asarray, jfw))
    for p, jp in zip(probs, jprobs):
        np.testing.assert_allclose(p, np.asarray(jp), rtol=0, atol=ATOL)
    assert not np.allclose(probs[0], out[strategy][1][0], atol=1e-4)


@pytest.mark.parametrize("strategy", ["maml++", "anil"])
def test_engine_refine_batch_matches_singles(served, strategy):
    jax_state, supports, queries, _ = served
    engine = AdaptationEngine(*_port_serving(jax_state))
    fws = engine.adapt_batch(supports[:2], strategy=strategy)
    batched = engine.refine_batch([(fw, x, y) for fw, (x, y) in zip(fws, supports)], strategy=strategy)
    for fw, refined, (x, y), q in zip(fws, batched, supports, queries):
        single = engine.refine(fw, x, y, strategy=strategy)
        np.testing.assert_allclose(engine.predict(refined, q, strategy=strategy),
                                   engine.predict(single, q, strategy=strategy), rtol=0, atol=ATOL)


def test_jax_anil_run_dir_serves_in_the_port(tmp_path):
    """A run directory the JAX package wrote with ``strategy=anil``
    (config and format-2 checkpoint) serves through the port's
    ``from_run_dir`` with the JAX engine's anil probabilities (1e-5)."""
    system, state = _jax_serving("anil", menu=["anil", "protonet"])
    (tmp_path / "saved_models").mkdir()
    jcfg.save_config(system.cfg, str(tmp_path / "config.yaml"))
    jax_ckpt.save_checkpoint(str(tmp_path / "saved_models"), state, {"epoch": 0}, epoch=0)
    supports, queries = _requests(seed=4)
    jengine = JaxEngine(system, state)
    want = jengine.predict_batch(list(zip(jengine.adapt_batch(supports), queries)))
    port = MAMLSystem(tcfg.load_config(str(tmp_path / "config.yaml")),
                      model=build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=8), device="cpu")
    engine = AdaptationEngine.from_run_dir(str(tmp_path), "latest", system=port)
    assert port.strategy == "anil" and engine.strategies == ("anil", "protonet")
    got = engine.predict_batch(list(zip(engine.adapt_batch(supports), queries)))
    for p, jp in zip(got, want):
        np.testing.assert_allclose(p, np.asarray(jp), rtol=0, atol=ATOL)


def test_request_strategy_resolution_matches_jax(served):
    """``None`` is the first configured strategy, an unknown name raises
    ``ValueError``, and a valid name outside the menu is served (the JAX
    engine without its strict guard does the same)."""
    for name in (None, *STRATEGIES):
        for menu in (("maml++",), ("anil", "protonet")):
            assert strategies.validate_request_strategy(name, menu) == \
                jax_strategies.validate_request_strategy(name, menu)
    with pytest.raises(ValueError, match="unknown strategy"):
        strategies.validate_request_strategy("bogus", ("maml++",))
    jax_state, supports, queries, out = served
    engine = AdaptationEngine(*_port_serving(jax_state, menu=["maml++"]))
    assert engine.strategies == ("maml++",)
    probs = engine.predict_batch(list(zip(engine.adapt_batch(supports, strategy="anil"), queries)), strategy="anil")
    for p, jp in zip(probs, out["anil"][1]):
        np.testing.assert_allclose(p, jp, rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="unknown strategy"):
        engine.adapt_batch(supports, strategy="bogus")


def test_dispatch_spans_and_request_contexts(served):
    """Each dispatch is one span of the engine's tracer, ending the flows
    of the request contexts it carries, which get its seconds."""
    from howtotrainyourmamlpytorch_tpu_torch.observability.context import new_request_context
    from howtotrainyourmamlpytorch_tpu_torch.observability.trace import SpanTracer

    jax_state, supports, queries, _ = served
    tracer = SpanTracer()
    system, state = _port_serving(jax_state)
    engine = AdaptationEngine(system, state, tracer=tracer)
    ctxs = [new_request_context() for _ in supports]
    fws = engine.adapt_batch(supports, ctxs=ctxs, strategy="anil")
    engine.refine_batch([(fw, x, y) for fw, (x, y) in zip(fws, supports)], ctxs=ctxs, strategy="anil")
    engine.predict_batch(list(zip(fws, queries)), ctxs=ctxs, strategy="anil")
    names = [r["name"] for r in tracer.records()]
    assert names == ["serve.adapt_dispatch", "serve.refine_dispatch", "serve.predict_dispatch"]
    assert all(r["tags"]["strategy"] == "anil" and r["tags"]["batch"] == 3 for r in tracer.records())
    assert all(c.dispatch_s is not None and c.dispatch_s > 0 for c in ctxs)
    events = tracer.to_chrome_trace()["traceEvents"]
    assert sum(1 for e in events if e.get("ph") == "f") == 3 * len(ctxs)
    assert set(engine.compile_counts()) == {"adapt_programs", "predict_programs", "precision", "strategies",
                                            "fused_sgd_launches"}


# ---------------------------------------------------------------------------
# training: the anil meta-step against JAX's lax.scan program
# ---------------------------------------------------------------------------

#: (overrides, state.step, host epoch): second and first order, MSL on
#: (epoch 0) and past its window (epoch 3 of multi_step_loss_num_epochs=3).
#: Past the window the JAX side runs op by op (``jax.disable_jit``): there
#: jax 0.9.0's jitted CPU program puts the body's meta-gradient 0.21 away
#: (on a scale of 0.25) from central finite differences of the loss both
#: packages compute, while the same function evaluated op by op agrees
#: with them, and with the port, to 3e-7 (ROADMAP.md C). In the MSL window
#: the jitted program agrees.
TRAIN_VARIANTS = {
    "second_order_msl": ({}, 0, 0),
    "second_order_past_msl": ({}, 12, 3),
    "first_order_msl": ({"second_order": False}, 0, 0),
    "first_order_past_msl": ({"second_order": False}, 12, 3),
}


def _grads_close(got, want, rtol=ATOL):
    """Every element within ``rtol`` of the largest one (of either tree)."""
    got_l = [np.asarray(a, np.float64) for a in jax.tree.leaves(got)]
    want_l = [np.asarray(a, np.float64) for a in jax.tree.leaves(want)]
    assert [a.shape for a in got_l] == [b.shape for b in want_l]
    scale = max(float(np.abs(b).max()) for b in want_l)
    for a, b in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def _state_close(tsys, tstate, jstate, atol=ATOL):
    """Params (conv biases left out), lrs, the outer Adam's moments and
    counts, step."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.interop import opt_state_to_jax

    fs = tsys.model.feature_shape

    def no_conv_bias(tree):
        return {k: ({n: v for n, v in sub.items() if not (n == "conv")} if k != "fc" else sub)
                for k, sub in tree.items()}

    got = params_to_jax(tstate.params, fs)
    want = jax.tree.map(np.asarray, jstate.params)
    _close(no_conv_bias(got), no_conv_bias(want), atol)
    for stage in (k for k in got if k != "fc"):
        np.testing.assert_allclose(got[stage]["conv"]["w"], want[stage]["conv"]["w"], rtol=0, atol=atol)
    _close(params_to_jax(tstate.inner_hparams, fs), jax.tree.map(np.asarray, jstate.inner_hparams), atol)
    got_opt, want_opt = opt_state_to_jax(tstate.opt_state, fs), jax.tree.map(np.asarray, jstate.opt_state)
    assert int(got_opt[0].count) == int(want_opt[0].count)
    _close(got_opt[0].mu, want_opt[0].mu, atol)
    _close(got_opt[0].nu, want_opt[0].nu, atol)
    assert int(tstate.step) == int(jstate.step)


def _anil_pair(step=0, **overrides):
    overrides.setdefault("unroll_inner_steps", False)
    return pair("vgg", step=step, strategy="anil", **overrides)


@pytest.mark.parametrize("variant", sorted(TRAIN_VARIANTS))
def test_anil_train_step_matches_jax(variant):
    """Loss 1e-5; meta-gradient of head and body within 1e-5 of its largest
    element, the body's nonzero (it flows through the forwards, and under
    second order through the head's inner gradients); the state after the
    outer Adam 1e-5."""
    overrides, step, epoch = TRAIN_VARIANTS[variant]
    jsys, jstate, tsys, tstate = _anil_pair(step=step, **overrides)
    assert tsys.use_second_order(epoch) == jsys.use_second_order(epoch) == ("second_order" not in overrides)
    assert tsys.msl_active(epoch) == jsys.msl_active(epoch) == ("past" not in variant)
    b = batch(seed=1)
    with jax.disable_jit("past" in variant):
        jloss, _, jgrads = jax_meta_gradients(jsys, jstate, b, epoch)
        jnew, jout = jsys.train_step(jstate, _jnp(b), epoch=epoch)
    loss, _, grads = tsys.meta_gradients(tstate, b, epoch)
    np.testing.assert_allclose(float(loss), jloss, rtol=0, atol=ATOL)
    got = trainables_to_jax(grads, tsys.model.feature_shape)
    _grads_close(got, jgrads)
    assert float(np.abs(got["params"]["stage_0"]["conv"]["w"]).max()) > 0
    assert float(np.abs(got["params"]["fc"]["w"]).max()) > 0
    new, out = tsys.train_step(tstate, b, epoch=epoch)
    np.testing.assert_allclose(float(out.loss), float(jout.loss), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.per_task_target_logits.numpy(), np.asarray(jout.per_task_target_logits),
                               rtol=0, atol=1e-4)
    _state_close(tsys, new, jnew)


def test_anil_body_meta_gradient_matches_finite_differences():
    """The port's second-order anil meta-gradient of the first conv (the
    body) in float64, past the MSL window, against central differences of
    the same float64 loss (step 1e-6): within 1e-7 of the largest
    element. An independent check of the body path, beside JAX."""
    from .test_torch_train import _Float64System, _configs, _models

    _, _, tsys, tstate = _anil_pair(step=12)
    f64 = _Float64System(_configs(strategy="anil")[1], model=_models("vgg")[1], device="cpu")
    st = tstate._replace(opt_state=None, **{k: tree_map(lambda t: t.double(), getattr(tstate, k))
                                            for k in ("params", "bn_state", "inner_hparams")})
    b = batch(seed=1)
    grad = f64.meta_gradients(st, b, 3)[2]["params"]["stage_0"]["conv"]["w"].reshape(-1)

    def loss(idx, delta):
        params = tree_map(torch.clone, st.params)
        params["stage_0"]["conv"]["w"].view(-1)[idx] += delta
        return float(f64.meta_objective(st._replace(params=params), b, 3)[0])

    scale = float(grad.abs().max())
    for idx in (0, 5, 17, 40):
        fd = (loss(idx, 1e-6) - loss(idx, -1e-6)) / 2e-6
        assert abs(fd - float(grad[idx])) <= 1e-7 * max(scale, 1.0)


def test_anil_body_meta_gradient_differs_between_orders():
    """Second order adds the path through the head's inner gradients to the
    body's meta-gradient: the two orders' body gradients differ, as in
    JAX (both held to JAX above)."""
    out = {}
    for second_order in (True, False):
        _, _, tsys, tstate = _anil_pair(second_order=second_order)
        out[second_order] = tsys.meta_gradients(tstate, batch(seed=1), 0)[2]["params"]["stage_0"]["conv"]["w"]
    assert not torch.allclose(out[True], out[False], atol=1e-7)


def test_anil_eval_step_matches_jax():
    jsys, jstate, tsys, tstate = _anil_pair()
    b = batch(seed=2)
    out, jout = tsys.eval_step(tstate, b), jsys.eval_step(jstate, _jnp(b))
    np.testing.assert_allclose(float(out.loss), float(jout.loss), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.per_task_target_logits.numpy(), np.asarray(jout.per_task_target_logits),
                               rtol=0, atol=1e-4)


#: anil composed with the options of the training path: the port's side
#: (its remat policy) and the JAX side (lax.scan, no remat: the same
#: function)
COMPOSED = {
    "lslr_per_step": {"lslr_per_step": True},
    "inner_adam": {"inner_optim": "adam"},
    "remat_full": {"port_remat": "full"},
    "fused": {"fused": True},
}


@pytest.mark.parametrize("name", sorted(COMPOSED))
def test_anil_composes_with_training_options(name):
    """Loss 1e-5 and meta-gradient within 1e-5 of its largest element
    against JAX (second order, MSL on)."""
    overrides = dict(COMPOSED[name])
    remat = overrides.pop("port_remat", None)
    if overrides.pop("inner_optim", None) == "adam":
        jsys, jstate, tsys, tstate = _anil_pair_with(jcfg.InnerOptimConfig(kind="adam"),
                                                     tcfg.InnerOptimConfig(kind="adam"))
    elif overrides.get("lslr_per_step"):
        jsys, jstate, tsys, tstate = _anil_pair_with(**overrides)
    else:
        jsys, jstate, tsys, tstate = _anil_pair(**overrides)
    if remat:
        tsys.remat_policy = remat
    b = batch(seed=3)
    jloss, _, jgrads = jax_meta_gradients(jsys, jstate, b, 0)
    loss, _, grads = tsys.meta_gradients(tstate, b, 0)
    np.testing.assert_allclose(float(loss), jloss, rtol=0, atol=ATOL)
    _grads_close(trainables_to_jax(grads, tsys.model.feature_shape), jgrads)


def _anil_pair_with(jinner=None, tinner=None, **overrides):
    """``_anil_pair`` with the hparams of ``init_train_state`` (``[K]`` lrs
    under ``lslr_per_step``) and optionally an inner optimizer config per
    package (inner Adam: learnable betas, moments warm-started from the
    outer Adam's)."""
    from .test_torch_train import _configs, _models

    jc, tc = _configs(strategy="anil", unroll_inner_steps=False, **overrides)
    if jinner is not None:
        jc.inner_optim, tc.inner_optim = jinner, tinner
    jmodel, tmodel = _models("vgg")
    jsys = JaxMAMLSystem(jc, model=jmodel)
    jstate = jsys.init_train_state()
    tsys = MAMLSystem(tc, model=tmodel, device="cpu")
    return jsys, jstate, tsys, train_state(jstate, tsys)


def test_anil_remat_full_equals_none_in_the_port():
    """Remat recomputes the head steps in the backward: the same loss and a
    meta-gradient within 1e-5 of its largest element."""
    _, _, tsys, tstate = _anil_pair()
    b = batch(seed=4)
    loss, _, grads = tsys.meta_gradients(tstate, b, 0)
    tsys.remat_policy = "full"
    loss_r, _, grads_r = tsys.meta_gradients(tstate, b, 0)
    assert float(loss_r) == float(loss)
    _grads_close(trainables_to_jax(grads_r, tsys.model.feature_shape),
                 trainables_to_jax(grads, tsys.model.feature_shape))


def test_fomaml_train_step_is_second_order_false_bitwise():
    """fomaml is the full rollout with the second-order switch pinned off:
    the port's train step equals maml++ with ``second_order=false`` bit for
    bit (loss, target logits, new state)."""
    results = []
    for overrides in ({"strategy": "fomaml"}, {"second_order": False}):
        _, _, tsys, tstate = pair("vgg", **overrides)
        assert tsys.use_second_order(50) is False
        results.append(tsys.train_step(tstate, batch(seed=5), epoch=0))
    (s_fo, o_fo), (s_so, o_so) = results
    assert torch.equal(o_fo.loss, o_so.loss)
    assert torch.equal(o_fo.per_task_target_logits, o_so.per_task_target_logits)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s_fo.params), tree_leaves(s_so.params)))


# ---------------------------------------------------------------------------
# Config.matmul_precision
# ---------------------------------------------------------------------------


@pytest.fixture
def restore_precision():
    before = tmaml.fp32_precision_flags()
    yield
    torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision = before


@pytest.mark.parametrize("value, flag", [("default", "ieee"), ("high", "tf32"), ("highest", "ieee")])
def test_matmul_precision_sets_matmul_and_convolution_flags(restore_precision, value, flag):
    cfg = _serving_cfg(tcfg, matmul_precision=value)
    torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision = tmaml._STARTUP_FP32_FLAGS
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # from the import's flags: no warning
        MAMLSystem(cfg, device="cpu")
    assert tmaml.fp32_precision_flags() == (flag, flag)
    assert tmaml.FP32_PRECISION[value] == flag


def test_matmul_precision_warns_when_it_changes_a_set_value(restore_precision):
    tmaml.apply_matmul_precision("default")
    with pytest.warns(UserWarning, match="'tf32'"):
        MAMLSystem(_serving_cfg(tcfg, matmul_precision="high"), device="cpu")
    with pytest.warns(UserWarning, match="'ieee'"):
        MAMLSystem(_serving_cfg(tcfg, matmul_precision="highest"), device="cpu")
    assert tmaml.fp32_precision_flags() == ("ieee", "ieee")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the same value again: no warning
        MAMLSystem(_serving_cfg(tcfg, matmul_precision="default"), device="cpu")
    with pytest.raises(ValueError, match="matmul_precision"):
        tmaml.apply_matmul_precision("tf32")
