"""The remat policies (core/remat.py) and the bf16_inner policy
(ops/precision.py) on the training path, on the small VGG of
tests/test_torch_train.py (2 stages, 8 filters, 8x8x1, 3-way 2-shot, K=2,
second order).

- Each remat policy against the port's ``"none"``: the loss bit-equal (the
  forward is the same program) and the meta-gradient within 1e-6 of the
  largest |g| (the recompute adds the same terms in another order).
- ``"full"`` against the JAX package's ``lax.scan`` program without remat
  at atol 1e-5: on jax 0.9.0 its remat programs disagree with float64
  (ROADMAP.md C), so the port's remat is held to the reference's exact
  program, not to its remat.
- The fused update under remat: B1's twin runs twice per inner step of a
  train step (forward, then the recompute), B2's once.
- bf16_inner against the port's own float32, with the thresholds of
  tests/test_precision.py::test_bf16_meta_grad_cosine_vs_f32 (per-tensor
  cosine >= 0.99 where the float32 gradient is not negligible, global
  cosine >= 0.995), and against the JAX package's bf16_inner ``lax.scan``
  program at the bound stated in :func:`test_bf16_inner_matches_jax_bf16_inner`.
"""

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.core.remat import apply_remat_policy
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import trainables_to_jax
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten, tree_leaves

from .test_torch_train import ATOL, _close, _configs, _flat, _models, batch, jax_meta_gradients, pair, port_state

torch.set_num_threads(1)

POLICIES = ("full", "dots_saveable", "dots_with_no_batch_dims_saveable")


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's state and its ``lax.scan`` program's meta-gradient
    without remat (second order, MSL on, epoch 0), in f32 and bf16_inner."""
    b = batch(seed=0)
    out = {"batch": b}
    for bf16 in (False, True):
        jsys, jstate, _, _ = pair("vgg", unroll_inner_steps=False, bf16=bf16)
        loss, _, grads = jax_meta_gradients(jsys, jstate, b, 0)
        out[bf16] = (jstate, loss, grads)
    return out


def port(jstate, policy="none", fused=False, bf16=False, **overrides):
    tsys = MAMLSystem(
        _configs(bf16=bf16, remat_policy=policy, use_pallas_inner_update=fused, **overrides)[1],
        model=_models("vgg")[1], device="cpu",
    )
    return tsys, port_state(jstate, tsys)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        apply_remat_policy(lambda *a: a, "everything_saveable")


@pytest.mark.parametrize("msl", [True, False], ids=["msl", "final_step"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_equals_none(jax_reference, policy, fused, msl):
    jstate = jax_reference[False][0]
    b = jax_reference["batch"]
    out = {}
    for pol in ("none", policy):
        tsys, tstate = port(jstate, pol, fused, use_multi_step_loss_optimization=msl)
        assert tsys.remat_policy == pol and tsys.msl_active(0) == msl
        loss, _, grads = tsys.meta_gradients(tstate, b, epoch=0)
        out[pol] = (loss, grads)
    (loss_ref, g_ref), (loss, g) = out["none"], out[policy]
    assert torch.equal(loss, loss_ref)
    scale = max(float(t.abs().max()) for t in tree_leaves(g_ref))
    for a, r in zip(tree_leaves(g), tree_leaves(g_ref)):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_policy_equals_none_with_per_step_lrs(jax_reference, fused):
    """``lslr_per_step``: each step's lr is a 0-d view of its ``[K]`` tensor,
    passed through the recompute; its meta-gradient lands in that step's
    element under ``"full"`` as without remat."""
    b = jax_reference["batch"]
    out = {}
    for pol in ("none", "full"):
        tsys = MAMLSystem(_configs(remat_policy=pol, use_pallas_inner_update=fused, lslr_per_step=True)[1],
                          model=_models("vgg")[1], device="cpu")
        loss, _, grads = tsys.meta_gradients(tsys.init_train_state(0), b, epoch=0)
        out[pol] = (loss, grads["hparams"])
    assert torch.equal(out["full"][0], out["none"][0])
    K = 2
    for a, r in zip(tree_leaves(out["full"][1]), tree_leaves(out["none"][1])):
        assert a.shape == (K,) and bool((r.abs() > 0).all())
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-6, atol=1e-9)


def test_default_config_resolves_to_full_remat():
    tsys = MAMLSystem(_configs(remat_inner_steps=True)[1], model=_models("vgg")[1], device="cpu")
    assert tsys.remat_policy == "full"


def test_full_remat_matches_jax_scan_without_remat(jax_reference):
    jstate, jloss, jgrads = jax_reference[False]
    tsys, tstate = port(jstate, "full")
    loss, _, grads = tsys.meta_gradients(tstate, jax_reference["batch"], epoch=0)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _close(trainables_to_jax(grads, tsys.model.feature_shape), jgrads, atol=ATOL)


@pytest.mark.parametrize("policy", ["none", "full", "dots_saveable"])
def test_fused_update_launches_under_remat(jax_reference, monkeypatch, policy):
    """A train step's inner steps run B1 once each without remat and twice
    with it (the recompute runs the update again), B2 once each; the eval
    step, under ``no_grad``, once. Counted on the twins the CPU runs."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fused_update.fused_sgd_tree_reference, fused_update.fused_sgd_tree_bwd_reference

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)

        return wrapped

    monkeypatch.setattr(fused_update, "fused_sgd_tree_reference", count("fwd", fwd))
    monkeypatch.setattr(fused_update, "fused_sgd_tree_bwd_reference", count("bwd", bwd))
    tsys, tstate = port(jax_reference[False][0], policy, fused=True)
    K = tsys.cfg.number_of_training_steps_per_iter
    tsys.train_step(tstate, jax_reference["batch"], epoch=0)
    assert calls == {"fwd": K * (1 if policy == "none" else 2), "bwd": K}
    calls.update(fwd=0, bwd=0)
    tsys.eval_step(tstate, jax_reference["batch"])
    assert calls == {"fwd": tsys.cfg.number_of_evaluation_steps_per_iter, "bwd": 0}


# ---------------------------------------------------------------------------
# bf16_inner
# ---------------------------------------------------------------------------


def _cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bf16_inner_meta_grad_cosine_vs_f32(jax_reference, fused):
    """Conv biases drop out by the norm floor: under transductive BN their
    exact gradient is 0, so both arms hold roundoff there."""
    jstate = jax_reference[False][0]
    b = jax_reference["batch"]
    grads = {}
    for bf16 in (False, True):
        tsys, tstate = port(jstate, fused=fused, bf16=bf16)
        assert tsys.precision.name == ("bf16_inner" if bf16 else "f32")
        _, _, grads[bf16] = tsys.meta_gradients(tstate, b, epoch=0)
    leaves_f32, paths = tree_flatten(grads[False])
    leaves_bf16 = tree_leaves(grads[True])
    assert all(t.dtype == torch.float32 for t in leaves_bf16)  # f32 masters
    norms = [float(t.double().norm()) for t in leaves_f32]
    floor = max(norms) * 1e-5
    checked = 0
    for path, a, c, norm in zip(paths, leaves_f32, leaves_bf16, norms):
        if norm < floor:
            continue
        checked += 1
        cos = _cosine(a.double().numpy().ravel(), c.double().numpy().ravel())
        assert cos >= 0.99, ("/".join(path), cos)
    assert checked >= 12
    assert _cosine(_flat(grads[False]), _flat(grads[True])) >= 0.995


def test_bf16_inner_matches_jax_bf16_inner(jax_reference):
    """The port's bf16_inner meta-gradient against JAX's bf16_inner
    ``lax.scan`` program on the same weights. The two round to bf16 in
    other places (XLA fuses casts around its convolutions and reductions,
    torch's CPU kernels round each op's output), so they agree as two bf16
    evaluations of one float32 function can: the loss within 2e-2 relative
    (the bf16_inner loss tolerance of tests/test_torch_train.py) and the
    global cosine of the two meta-gradients >= 0.99 (measured: 0.9937). The
    port also holds the reference's own bar against float32 (cosine >=
    0.995; measured 0.9962), which JAX's program misses on jax 0.9.0
    (0.9927 here; its test_precision::test_bf16_meta_grad_cosine_vs_f32
    is a reference caveat, ROADMAP.md C), so it is held only to no worse
    than the port's distance allows (>= 0.99)."""
    jstate, jloss, jgrads = jax_reference[True]
    b = jax_reference["batch"]
    tsys, tstate = port(jstate, bf16=True)
    loss, _, grads = tsys.meta_gradients(tstate, b, epoch=0)
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-2)
    fs = tsys.model.feature_shape
    got, want = _flat(trainables_to_jax(grads, fs)), _flat(jgrads)
    f32_sys, f32_state = port(jstate)
    exact = _flat(trainables_to_jax(f32_sys.meta_gradients(f32_state, b, epoch=0)[2], fs))
    assert np.isfinite(want).all()
    assert _cosine(got, want) >= 0.99
    assert _cosine(got, exact) >= 0.995
    assert _cosine(want, exact) >= 0.99
