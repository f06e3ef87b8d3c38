"""The port's meta-training step (``MAMLSystem.train_step`` / ``eval_step``)
against the JAX package's, on the same weights (carried over with
``utils/interop.py``) and the same numpy batches.

The JAX side runs with ``remat_inner_steps=False, unroll_inner_steps=True``
(what a Python loop without remat computes) unless a test says otherwise;
its fused update runs in Pallas interpret mode, the port's on the kernels'
plain twins (the tensors lie on the CPU).

- A linear model (the port-side twin of ``tests/test_maml_core.py::
  tiny_linear_model``, keyed ``fc`` so the interop head rule applies):
  everything at atol 1e-5 (float32, sums in other orders).
- A small VGG (2 stages, 8 filters, 3-way 2-shot, K=2): the loss within
  1e-5 relative. Its meta-gradient is compared twice. Against the unrolled
  JAX program the bound is a cosine of 0.99: on this setup that program's
  meta-gradient is itself only at cosine 0.9942 from a float64 evaluation of
  the same function, and the other unrolled or rematerialised JAX variants
  land at 0.75-0.9941, while the ``lax.scan`` programs without remat, and
  the port, agree with float64 to 8e-7 (``python -m tests.test_torch_train``
  prints the table). So the cosine the two packages can share is the
  spread of the reference's programs, not of the port. Against the
  ``lax.scan`` JAX program without remat the port holds atol 1e-5 on every
  component, and the eval step's logits 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.core import cosine_epoch_schedule as jax_cosine_schedule
from howtotrainyourmamlpytorch_tpu.models import Model as JaxModel
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu.ops import msl as jax_msl
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem, cosine_epoch_schedule
from howtotrainyourmamlpytorch_tpu_torch.core.train_state import TrainState
from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch.models.model import Model
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update, msl
from howtotrainyourmamlpytorch_tpu_torch.ops.outer_adam import adam_init, adam_update
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_to_jax,
    state_from_jax,
    trainables_to_jax,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

IMG, N_WAY = (8, 8, 1), 3
ATOL = 1e-5


def _kw(**overrides):
    base = dict(
        num_classes_per_set=N_WAY, num_samples_per_class=2, num_target_samples=2, batch_size=2,
        number_of_training_steps_per_iter=2, number_of_evaluation_steps_per_iter=2,
        total_iter_per_epoch=4, total_epochs=5, multi_step_loss_num_epochs=3, seed=0,
        remat_inner_steps=False, unroll_inner_steps=True,
    )
    base.update(overrides)
    return base


def _configs(bf16=False, imagenet=False, inner_lr=None, **overrides):
    out = []
    for module in (jcfg, tcfg):
        kw = _kw(**overrides)
        kw["precision"] = module.PrecisionConfig(enabled=bf16)
        if imagenet:
            kw["dataset"] = module.DatasetConfig(name="mini_imagenet_full_size")
        if inner_lr is not None:
            kw["inner_optim"] = module.InnerOptimConfig(kind="sgd", lr=inner_lr)
        out.append(module.Config(**kw))
    return out


def jax_linear_model():
    """``tests/test_maml_core.py::tiny_linear_model`` with its weights under
    ``fc``."""
    d = int(np.prod(IMG))

    def init(key):
        return {"fc": {"w": 0.1 * jax.random.normal(key, (d, N_WAY)), "b": jnp.zeros((N_WAY,))}}, {}

    def apply(params, state, x, *, use_batch_stats=True, update_running=False, **_):
        return x.reshape((x.shape[0], -1)) @ params["fc"]["w"] + params["fc"]["b"], state

    return JaxModel(init=init, apply=apply, name="tiny")


def port_linear_model():
    """The port's twin: ``[out, in]`` weights over the NCHW flatten."""
    h, w, c = IMG

    def init(gen):
        return {"fc": {"w": torch.zeros(N_WAY, h * w * c), "b": torch.zeros(N_WAY)}}, {}

    def apply(params, state, x, *, use_batch_stats=True, sample_weight=None, stat_dtype=None):
        flat = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        return F.linear(flat, params["fc"]["w"], params["fc"]["b"]), state

    return Model(init=init, apply=apply, name="tiny", feature_shape=(c, h, w))


def _models(kind):
    if kind == "linear":
        return jax_linear_model(), port_linear_model()
    return (
        jax_build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=8),
        build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=8),
    )


def port_state(jax_state, system):
    fs = system.model.feature_shape
    params, bn_state, hparams = state_from_jax(
        *(jax.tree.map(np.asarray, t) for t in (jax_state.params, jax_state.bn_state, jax_state.inner_hparams)), fs
    )
    return TrainState(
        params, bn_state, hparams, opt_state_from_jax(jax.tree.map(np.asarray, jax_state.opt_state), fs),
        torch.tensor(int(jax_state.step), dtype=torch.int64),
    )


def pair(kind="linear", fused=False, step=0, **overrides):
    """A JAX system and state (distinct per-tensor lrs, so a leaf-order slip
    shows) and the port's system and state with the same weights."""
    jc, tc = _configs(use_pallas_inner_update=fused, **overrides)
    jmodel, tmodel = _models(kind)
    jsys = JaxMAMLSystem(jc, model=jmodel)
    jstate = jsys.init_train_state()._replace(step=jnp.int32(step))
    if jstate.inner_hparams:
        leaves, treedef = jax.tree.flatten(jstate.inner_hparams["lr"])
        lrs = [np.float32(0.05 + 0.03 * i) for i in range(len(leaves))]
        jstate = jstate._replace(inner_hparams={"lr": jax.tree.unflatten(treedef, lrs)})
    jstate = jstate._replace(opt_state=jsys.outer_opt.init({"params": jstate.params, "hparams": jstate.inner_hparams}))
    tsys = MAMLSystem(tc, model=tmodel, device="cpu")
    return jsys, jstate, tsys, port_state(jstate, tsys)


def batch(seed=0, k=2, t=2):
    return learnable_synthetic_batch(2, N_WAY, k, t, IMG, seed=seed)


def _jnp(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def jax_meta_gradients(jsys, jstate, b, epoch):
    """The JAX package's meta-objective and its gradient, as ``train_step``
    takes them (the MSL weights follow ``state.step``)."""
    cfg = jsys.cfg
    so, msl_on = jsys.use_second_order(epoch), jsys.msl_active(epoch)
    K = cfg.number_of_training_steps_per_iter

    def objective(trainables, bt, ep):
        return jsys._meta_objective(trainables, jstate.bn_state, jstate.opt_state, bt, ep, so, K, msl_on)

    fn = jax.jit(jax.value_and_grad(objective, has_aux=True))
    trainables = {"params": jstate.params, "hparams": jstate.inner_hparams}
    (loss, aux), grads = fn(trainables, _jnp(b), jstate.step // cfg.total_iter_per_epoch)
    return float(loss), aux, grads


def _close(got, want, atol=ATOL, rtol=0.0):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _state_close(tsys, tstate, jstate, atol=ATOL):
    """Params, lrs, Adam moments and counts, step."""
    fs = tsys.model.feature_shape
    _close(params_to_jax(tstate.params, fs), jstate.params, atol)
    _close(params_to_jax(tstate.inner_hparams, fs), jstate.inner_hparams, atol)
    got = opt_state_to_jax(tstate.opt_state, fs)
    want = jax.tree.map(np.asarray, jstate.opt_state)
    assert int(got[0].count) == int(want[0].count) and int(got[1].count) == int(want[1].count)
    _close(got[0].mu, want[0].mu, atol)
    _close(got[0].nu, want[0].nu, atol)
    assert int(tstate.step) == int(jstate.step)


def _outputs_close(out, jout, atol=ATOL):
    for name in ("loss", "accuracy", "per_task_losses", "per_task_accuracies",
                 "per_task_target_logits", "loss_importance_vector", "learning_rate"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name), np.float64), np.asarray(getattr(jout, name), np.float64),
            rtol=0, atol=atol, err_msg=name,
        )


# ---------------------------------------------------------------------------
# MSL weights and the outer Adam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_steps", [2, 5])
def test_msl_weights_equal_jax(num_steps):
    for epoch in range(13):
        got = msl.per_step_loss_importance(epoch, num_steps, 10)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_msl.per_step_loss_importance(epoch, num_steps, 10)))
    np.testing.assert_array_equal(msl.final_step_only(num_steps).numpy(), np.asarray(jax_msl.final_step_only(num_steps)))


def test_outer_adam_and_cosine_schedule_match_optax():
    """6 steps across epoch boundaries (2 iterations per epoch): params
    within 1e-6, moments and counts equal in layout."""
    rng = np.random.RandomState(0)
    params = {"params": {"fc": {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}},
              "hparams": {"lr": {"fc": {"w": np.float32(0.1), "b": np.float32(0.2)}}}}
    jsched = jax_cosine_schedule(1e-2, 1e-4, 4, 2)
    opt = optax.adam(learning_rate=jsched)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jp)
    tp = jax.tree.map(torch.as_tensor, params)
    tstate = adam_init(tp)
    tsched = cosine_epoch_schedule(1e-2, 1e-4, 4, 2)
    for step in range(6):
        g = jax.tree.map(lambda a: np.asarray(rng.randn(*np.shape(a)), np.float32), params)
        np.testing.assert_allclose(float(tsched(torch.tensor(step))), float(jsched(step)), rtol=1e-7)
        updates, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        with torch.no_grad():
            tp, tstate = adam_update(jax.tree.map(torch.as_tensor, g), tstate, tp, tsched)
        _close(jax.tree.map(np.asarray, tp), jp, atol=1e-6)
    assert int(tstate[0].count) == int(jstate[0].count) == 6 and int(tstate[1].count) == 6
    _close(jax.tree.map(np.asarray, tstate[0].mu), jstate[0].mu, atol=1e-6)
    _close(jax.tree.map(np.asarray, tstate[0].nu), jstate[0].nu, atol=1e-6)


# ---------------------------------------------------------------------------
# linear model: one train step and a 5-step trajectory, atol 1e-5
# ---------------------------------------------------------------------------

#: (overrides, state.step, host epoch)
VARIANTS = {
    "second_order_msl": ({}, 0, 0),
    "past_msl_window": ({}, 12, 3),
    "first_order": ({"second_order": False}, 0, 0),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_linear_train_step_matches_jax(fused, variant):
    overrides, step, epoch = VARIANTS[variant]
    jsys, jstate, tsys, tstate = pair("linear", fused=fused, step=step, **overrides)
    b = batch(seed=1)
    assert tsys.use_second_order(epoch) == jsys.use_second_order(epoch)
    assert tsys.msl_active(epoch) == jsys.msl_active(epoch) == (variant != "past_msl_window")
    jloss, jaux, jgrads = jax_meta_gradients(jsys, jstate, b, epoch)
    loss, aux, grads = tsys.meta_gradients(tstate, b, epoch)
    np.testing.assert_allclose(float(loss), jloss, rtol=0, atol=ATOL)
    _close(trainables_to_jax(grads, tsys.model.feature_shape), jgrads)
    # the lr gradients are real (second order reaches them through the
    # update, first order through the last step's target loss)
    assert all(float(abs(g)) > 0 for g in tree_leaves(grads["hparams"]))
    jnew, jout = jsys.train_step(jstate, _jnp(b), epoch=epoch)
    new, out = tsys.train_step(tstate, b, epoch=epoch)
    _outputs_close(out, jout)
    _state_close(tsys, new, jnew)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_linear_five_step_trajectory_matches_jax(fused):
    """5 outer steps over fresh batches, 2 iterations per epoch (so the MSL
    weights and the schedule move), then one eval step."""
    jsys, jstate, tsys, tstate = pair("linear", fused=fused, total_iter_per_epoch=2)
    fused_update.reset_launch_counts()
    for i in range(5):
        b = batch(seed=10 + i)
        epoch = i // 2
        jstate, jout = jsys.train_step(jstate, _jnp(b), epoch=epoch)
        tstate, out = tsys.train_step(tstate, b, epoch=epoch)
        _outputs_close(out, jout)
    _state_close(tsys, tstate, jstate)
    b = batch(seed=99)
    _outputs_close(tsys.eval_step(tstate, b), jsys.eval_step(jstate, _jnp(b)))
    assert fused_update.launch_counts == {"fused_sgd": 0, "fused_sgd_bwd": 0}  # CPU: twins only


# ---------------------------------------------------------------------------
# small VGG
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vgg():
    """Second order, MSL on, epoch 0: the JAX meta-gradient from the
    unrolled program and from the ``lax.scan`` program, and the eval-step
    target logits of the ``lax.scan`` program (the unrolled eval program
    is 1.1 away from JAX's own adapt + predict path on this setup, the
    ``lax.scan`` one 4.2e-7; see the module docstring)."""
    jsys, jstate, tsys, tstate = pair("vgg")
    b = batch(seed=0)
    jloss, _, jgrads = jax_meta_gradients(jsys, jstate, b, 0)
    jscan, jscan_state, _, _ = pair("vgg", unroll_inner_steps=False)
    _, _, jgrads_scan = jax_meta_gradients(jscan, jscan_state, b, 0)
    jeval = jscan.eval_step(jscan_state, _jnp(b))
    return {"jstate": jstate, "batch": b, "loss": jloss, "grads": jgrads, "grads_scan": jgrads_scan,
            "eval_logits": np.asarray(jeval.per_task_target_logits)}


def _flat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in jax.tree.leaves(tree)])


def test_small_vgg_loss_and_meta_gradient_match_jax(vgg):
    tsys = MAMLSystem(_configs()[1], model=_models("vgg")[1], device="cpu")
    loss, _, grads = tsys.meta_gradients(port_state(vgg["jstate"], tsys), vgg["batch"], epoch=0)
    np.testing.assert_allclose(float(loss), vgg["loss"], rtol=1e-5)
    got = trainables_to_jax(grads, tsys.model.feature_shape)
    a, b = _flat(got), _flat(vgg["grads"])
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.99
    _close(got, vgg["grads_scan"], atol=ATOL)


def test_small_vgg_eval_step_logits_match_jax(vgg):
    tsys = MAMLSystem(_configs()[1], model=_models("vgg")[1], device="cpu")
    out = tsys.eval_step(port_state(vgg["jstate"], tsys), vgg["batch"])
    assert out.per_task_target_logits.shape == (2, N_WAY * 2, N_WAY)
    np.testing.assert_allclose(out.per_task_target_logits.numpy(), vgg["eval_logits"], rtol=0, atol=1e-4)


def test_small_vgg_port_fused_equals_unfused(vgg):
    """The twin is the unfused update bit for bit in f32, so the rollout's
    fast weights and eval logits agree exactly; the meta-gradients agree
    within 1e-6 relative (the lr cotangent sums each row in another
    order)."""
    out = {}
    for fused in (False, True):
        tsys = MAMLSystem(_configs(use_pallas_inner_update=fused)[1], model=_models("vgg")[1], device="cpu")
        st = port_state(vgg["jstate"], tsys)
        b = vgg["batch"]
        fast = tsys.adapt_fast_weights(st, b["x_support"].reshape(2, -1, *IMG), b["y_support"].reshape(2, -1))
        _, _, grads = tsys.meta_gradients(st, b, epoch=0)
        out[fused] = (fast, tsys.eval_step(st, b).per_task_target_logits, grads)
    for a, b in zip(tree_leaves(out[True][0]), tree_leaves(out[False][0])):
        assert torch.equal(a, b)
    assert torch.equal(out[True][1], out[False][1])
    for a, b in zip(tree_leaves(out[True][2]), tree_leaves(out[False][2])):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# bf16_inner and the ImageNet clamp
# ---------------------------------------------------------------------------


def test_bf16_inner_train_step_fused_matches_plain():
    """The tolerances of tests/test_pallas_update.py::
    test_full_meta_step_parity_fused_vs_plain_bf16_inner: losses within bf16
    tolerance, masters stay f32, params and lrs close."""
    results = {}
    for fused in (False, True):
        _, _, tsys, tstate = pair("linear", fused=fused, bf16=True)
        assert tsys.precision.name == "bf16_inner"
        new, out = tsys.train_step(tstate, batch(seed=3), epoch=0)
        results[fused] = (float(out.loss), new)
    (loss_p, state_p), (loss_f, state_f) = results[False], results[True]
    np.testing.assert_allclose(loss_f, loss_p, rtol=2e-2)
    for a in tree_leaves(state_f.params):
        assert a.dtype == torch.float32
    for a, b in zip(tree_leaves({"p": state_f.params, "h": state_f.inner_hparams}), tree_leaves({"p": state_p.params, "h": state_p.inner_hparams})):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-2, atol=5e-3)


def test_imagenet_clamps_classifier_grads_to_ten():
    """ImageNet clamps the params' grads element-wise to +-10 before Adam,
    so the first moment is 0.1 * clip(g). With the inner loop frozen (inner
    lr 0, not learnable) and the head at zero, the softmax stays at 1/3, so
    inputs scaled by 100 push the head's grads past 10 without saturating
    it; both packages then hold the same moments. (Params are not compared:
    Adam's first step is g / (|g| + 1e-8), which the exactly-cancelling
    bias grads would decide by their last bits.)"""
    jsys, jstate, tsys, _ = pair("linear", imagenet=True, inner_lr=0.0, learnable_inner_opt_params=False)
    jstate = jstate._replace(params=jax.tree.map(jnp.zeros_like, jstate.params))
    tstate = port_state(jstate, tsys)
    b = batch(seed=4)
    b = dict(b, x_support=b["x_support"] * 100.0, x_target=b["x_target"] * 100.0)
    _, _, grads = tsys.meta_gradients(tstate, b, epoch=0)
    g = grads["params"]["fc"]["w"].numpy()
    assert np.abs(g).max() > 10.0 and (np.abs(g) < 10.0).any()
    new, _ = tsys.train_step(tstate, b, epoch=0)
    np.testing.assert_allclose(new.opt_state[0].mu["params"]["fc"]["w"].numpy(), 0.1 * np.clip(g, -10, 10), rtol=1e-6)
    jnew, _ = jsys.train_step(jstate, _jnp(b), epoch=0)
    got, want = opt_state_to_jax(new.opt_state, tsys.model.feature_shape), jnew.opt_state
    _close(got[0].mu, want[0].mu, atol=1e-5)
    _close(got[0].nu, want[0].nu, atol=1e-5)


# ---------------------------------------------------------------------------
# the reference's spread: python -m tests.test_torch_train
# ---------------------------------------------------------------------------


class _Float64System(MAMLSystem):
    """The port's plain path (unfused update, no precision casts) in
    float64."""

    def _apply_forward(self, params, bn_state, x, sample_weight=None):
        return self.model.apply(params, bn_state, x, use_batch_stats=True)[0]

    def _batch(self, b, device=None):
        out = super()._batch(b, device)
        return dict(out, x_support=out["x_support"].double(), x_target=out["x_target"].double())


def reference_spread():
    """The small VGG's meta-gradient (second order, MSL on, epoch 0) from
    each JAX program variant and from the port, against a float64
    evaluation of the same function: one JSON line per variant with its
    loss, cosine and max abs distance from float64."""
    import json

    jsys, jstate, tsys, tstate = pair("vgg")
    b = batch(seed=0)
    f64 = _Float64System(_configs()[1], model=_models("vgg")[1], device="cpu")
    st64 = tstate._replace(**{k: jax.tree.map(lambda t: t.double(), getattr(tstate, k))
                              for k in ("params", "bn_state", "inner_hparams")}, opt_state=None)
    loss64, _, g64 = f64.meta_gradients(st64, b, epoch=0)
    exact = _flat(trainables_to_jax(g64, tsys.model.feature_shape))

    def line(name, loss, grads):
        got = _flat(grads)
        print(json.dumps({"variant": name, "loss": float(loss), "cosine_vs_f64": float(got @ exact / (np.linalg.norm(got) * np.linalg.norm(exact))),
                          "max_abs_vs_f64": float(np.abs(got - exact).max())}), flush=True)

    print(json.dumps({"variant": "port float64", "loss": float(loss64)}), flush=True)
    for fused in (False, True):
        sys_ = MAMLSystem(_configs(use_pallas_inner_update=fused)[1], model=_models("vgg")[1], device="cpu")
        loss, _, grads = sys_.meta_gradients(port_state(jstate, sys_), b, epoch=0)
        line(f"port f32 {'fused' if fused else 'unfused'}", loss, trainables_to_jax(grads, sys_.model.feature_shape))
    variants = {
        "jax unrolled, no remat": {},
        "jax lax.scan, no remat": {"unroll_inner_steps": False},
        "jax unrolled, fused (Pallas interpret)": {"fused": True},
        "jax lax.scan, fused (Pallas interpret)": {"fused": True, "unroll_inner_steps": False},
        "jax unrolled, remat=full": {"remat_inner_steps": True},
        "jax lax.scan, remat=full": {"remat_inner_steps": True, "unroll_inner_steps": False},
    }
    for name, overrides in variants.items():
        js, jst, _, _ = pair("vgg", **overrides)
        loss, _, grads = jax_meta_gradients(js, jst, b, 0)
        line(name, loss, grads)
    # the eval step's target logits against JAX's own adapt + predict path
    # and against the port's eval step
    xs, ys = _jnp(b)["x_support"].reshape(2, -1, *IMG), _jnp(b)["y_support"].reshape(2, -1)
    xt = _jnp(b)["x_target"].reshape(2, -1, *IMG)
    port_logits = tsys.eval_step(tstate, b).per_task_target_logits.numpy()
    for name, overrides in (("unrolled", {}), ("lax.scan", {"unroll_inner_steps": False})):
        js, jst, _, _ = pair("vgg", **overrides)
        steps = js.cfg.number_of_evaluation_steps_per_iter
        fast = jax.vmap(lambda x, y: js.adapt_fast_weights(jst, x, y, num_steps=steps))(xs, ys)
        served = np.asarray(jax.vmap(lambda f, x: js.predict_logits(f, jst.bn_state, x))(fast, xt))
        logits = np.asarray(js.eval_step(jst, _jnp(b)).per_task_target_logits)
        print(json.dumps({"eval_step": f"jax {name}", "max_abs_vs_jax_adapt_predict": float(np.abs(logits - served).max()),
                          "max_abs_vs_port_eval_step": float(np.abs(logits - port_logits).max())}), flush=True)


if __name__ == "__main__":
    reference_spread()
