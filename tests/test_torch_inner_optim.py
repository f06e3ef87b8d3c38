"""The port's inner optimizers (ops/inner_optim.py: adam, rprop), the inner
Adam warm start and ``lslr_per_step`` (core/maml.py) against the JAX
package's, on the same numpy inputs.

- The update math, mirroring tests/test_inner_optim.py: several steps of
  each optimizer against the JAX one (and torch.optim as an independent
  oracle), with and without a leading task axis on params and state; the
  hyperparameters' gradients; a finite second order at exactly-zero
  gradient elements; the projection. float32, atol 1e-6.
- The meta-step on the linear model of tests/test_torch_train.py: one train
  step and a 5-step trajectory against JAX's ``lax.scan`` program
  (``unroll_inner_steps=False, remat_inner_steps=False``) at atol 1e-5, for
  inner Adam warm-started from a nonzero outer Adam state, inner Rprop, and
  ``lslr_per_step`` (fused and unfused).
- One train step of a small ResNet (resnet-4 on 8x8x1, 3-way 2-shot, K=2):
  the loss within 1e-5 relative, the meta-gradient on one scale for all
  leaves at atol 5e-5 x the largest |g|. Through ten BNs this second-order
  meta-gradient is ill-conditioned in float32: against a float64
  evaluation of the same function the port lies 1.1e-5 and JAX's
  ``lax.scan`` program 2.5e-5 of that scale away (3.4e-5 from each other),
  so 1e-5 is not attainable. The test also holds the port's distance from
  float64 to at most JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.models import build_model as jax_build_model
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu.ops import build_inner_optimizer as jax_build_inner_optimizer
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem, _task_stack
from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch.models.registry import build_model
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update
from howtotrainyourmamlpytorch_tpu_torch.ops.inner_optim import build_inner_optimizer
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import trainables_to_jax
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves, tree_map

from .test_torch_train import (
    IMG,
    N_WAY,
    _close,
    _flat,
    _Float64System,
    _configs,
    _jnp,
    _models,
    _outputs_close,
    _state_close,
    batch,
    jax_meta_gradients,
    port_state,
)

torch.set_num_threads(1)

ATOL = 1e-5
KWARGS = {"sgd": dict(lr=0.1), "adam": dict(lr=0.1, beta1=0.5, beta2=0.5), "rprop": dict(lr=0.1)}
TORCH_OPTIM = {
    "sgd": (torch.optim.SGD, dict(lr=0.1)),
    "adam": (torch.optim.Adam, dict(lr=0.1, betas=(0.5, 0.5))),
    "rprop": (torch.optim.Rprop, dict(lr=0.1)),
}


# ---------------------------------------------------------------------------
# the update math
# ---------------------------------------------------------------------------


def _steps(kind, tasks, n_steps=5, seed=0):
    """``n_steps`` updates of a two-leaf tree from each package -> (port,
    JAX) params after every step. With ``tasks``, the port runs the tasks
    stacked on a leading axis (params and state), JAX vmaps one task."""
    rng = np.random.RandomState(seed)
    lead = (tasks,) if tasks else ()
    p0 = {"a": rng.randn(*lead, 4, 3).astype(np.float32), "b": rng.randn(*lead, 5).astype(np.float32)}
    grads = [jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32), p0) for _ in range(n_steps)]
    unbatched = jax.tree.map(lambda p: p[0] if tasks else p, p0)

    jopt = jax_build_inner_optimizer(kind, **KWARGS[kind])
    jhp = jopt.init_hparams(jax.tree.map(jnp.asarray, unbatched))

    def jax_run(p, gs):
        state = jopt.init_state(p, jhp)
        out = []
        for g in gs:
            p, state = jopt.update(g, state, p, jhp)
            out.append(p)
        return out

    jp = jax.tree.map(jnp.asarray, p0)
    jgs = [jax.tree.map(jnp.asarray, g) for g in grads]
    if tasks:
        jout = jax.vmap(lambda p, *gs: jax_run(p, gs))(jp, *jgs)
    else:
        jout = jax_run(jp, jgs)

    opt = build_inner_optimizer(kind, **KWARGS[kind])
    tp = tree_map(torch.from_numpy, p0)
    hp = opt.init_hparams(tree_map(torch.from_numpy, unbatched))
    state = opt.init_state(tree_map(torch.from_numpy, unbatched), hp)
    if tasks:  # the state stacked over the tasks, as core/maml.py does
        state = _task_stack(state, tasks)
    tout = []
    for g in grads:
        tp, state = opt.update(tree_map(torch.from_numpy, g), state, tp, hp)
        tout.append(tp)
    return tout, jout, p0, grads


@pytest.mark.parametrize("tasks", [0, 3], ids=["one_task", "task_axis"])
@pytest.mark.parametrize("kind", ["sgd", "adam", "rprop"])
def test_update_matches_jax_and_torch_optim(kind, tasks):
    tout, jout, p0, grads = _steps(kind, tasks)
    for got, want in zip(tout, jout):
        _close(jax.tree.map(lambda t: t.numpy(), got), want, atol=1e-6)
    # torch.optim on each leaf (and task) alone, the independent oracle
    cls, kw = TORCH_OPTIM[kind]
    for name in ("a", "b"):
        for t in range(max(tasks, 1)):
            pick = (lambda a: a[t]) if tasks else (lambda a: a)
            p = torch.tensor(pick(p0[name]), requires_grad=True)
            optim = cls([p], **kw)
            for i, g in enumerate(grads):
                optim.zero_grad()
                p.grad = torch.tensor(pick(g[name]))
                optim.step()
                np.testing.assert_allclose(pick(tout[i][name].numpy()), p.detach().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,hparam", [("sgd", "lr"), ("adam", "lr"), ("adam", "beta1"), ("adam", "beta2"), ("rprop", "lr")])
def test_hparam_gradient_matches_jax(kind, hparam):
    """d(sum of squares after two steps)/d(hparam) through the state: the
    LSLR lrs and Adam's betas are learnable (distinct grads, so beta1's
    gradient is not cancelled by the bias correction)."""
    p = {"w": np.array([1.0, 2.0, -0.5], np.float32)}
    g1, g2 = {"w": np.array([0.3, -0.2, 0.1], np.float32)}, {"w": np.array([-0.7, 0.4, 0.2], np.float32)}

    def run(opt, hp, p, g1, g2, value):
        hp = dict(hp, **{hparam: {"w": value}})
        state = opt.init_state(p, hp)
        p1, state = opt.update(g1, state, p, hp)
        p2, _ = opt.update(g2, state, p1, hp)
        return (p2["w"] ** 2).sum()

    jopt = jax_build_inner_optimizer(kind, **KWARGS[kind])
    jp = jax.tree.map(jnp.asarray, p)
    jhp = jopt.init_hparams(jp)
    start = float(jhp[hparam]["w"])
    want = jax.grad(lambda v: run(jopt, jhp, jp, _jnp(g1), _jnp(g2), v))(jnp.asarray(start))
    opt = build_inner_optimizer(kind, **KWARGS[kind])
    tp = tree_map(torch.from_numpy, p)
    value = torch.tensor(start, requires_grad=True)
    run(opt, opt.init_hparams(tp), tp, tree_map(torch.from_numpy, g1), tree_map(torch.from_numpy, g2), value).backward()
    assert np.isfinite(float(value.grad))
    np.testing.assert_allclose(float(value.grad), float(want), rtol=1e-5, atol=1e-7)
    if kind != "rprop":  # rprop's path to its lr is the initial step size only
        assert float(value.grad) != 0.0


def test_adam_second_order_finite_at_zero_grad_elements():
    """The first inner Adam step at an element whose inner gradient is
    exactly 0 (v = 0 there) keeps the second-order meta-gradient finite
    (sqrt clamped away from 0), and equals JAX's."""

    def meta_grad(grad_fn, opt, params):
        def meta_loss(p):
            g = grad_fn(lambda q: q["w"][0] ** 2)(p)
            hp = opt.init_hparams(p)
            p1, _ = opt.update(g, opt.init_state(p, hp), p, hp)
            return (p1["w"] ** 2).sum()

        return grad_fn(meta_loss)(params)["w"]

    w = np.array([0.7, -0.3], np.float32)
    want = meta_grad(jax.grad, jax_build_inner_optimizer("adam", **KWARGS["adam"]), {"w": jnp.asarray(w)})
    got = meta_grad(torch.func.grad, build_inner_optimizer("adam", **KWARGS["adam"]), {"w": torch.from_numpy(w)})
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["sgd", "adam", "rprop"])
def test_projection_matches_jax(kind):
    values = np.array([-1.0, 0.0, 5e-5, 0.5, 0.995, 2.0], np.float32)
    names = [f"t{i}" for i in range(len(values))]
    hp = {key: dict(zip(names, values)) for key in (("lr", "beta1", "beta2") if kind == "adam" else ("lr",))}
    want = jax_build_inner_optimizer(kind).project_hparams(jax.tree.map(jnp.asarray, hp))
    got = build_inner_optimizer(kind).project_hparams(tree_map(torch.tensor, hp))
    _close(jax.tree.map(lambda t: t.numpy(), got), want, atol=0.0)


# ---------------------------------------------------------------------------
# the meta-step: linear model against JAX's lax.scan program
# ---------------------------------------------------------------------------


def scan_pair(kind="sgd", fused=False, model="linear", **overrides):
    """A JAX system and state running its ``lax.scan`` program without
    remat, and the port's with the same weights; distinct values in every
    hparam leaf (per step under ``lslr_per_step``), and for inner Adam a
    nonzero outer Adam state (count 3, seeded moments) to warm-start from."""
    jc, tc = _configs(use_pallas_inner_update=fused, unroll_inner_steps=False, **overrides)
    if kind != "sgd":
        jc.inner_optim = jcfg.InnerOptimConfig(kind=kind, **({"beta1": 0.5, "beta2": 0.6} if kind == "adam" else {}))
        tc.inner_optim = tcfg.InnerOptimConfig(kind=kind, **({"beta1": 0.5, "beta2": 0.6} if kind == "adam" else {}))
    jmodel, tmodel = _models(model) if model in ("linear", "vgg") else (
        jax_build_model(model, IMG, N_WAY), build_model(model, IMG, N_WAY))
    jsys = JaxMAMLSystem(jc, model=jmodel)
    jstate = jsys.init_train_state()
    rng = np.random.RandomState(7)

    def distinct(tree, base, spread):
        leaves, treedef = jax.tree.flatten(tree)
        return jax.tree.unflatten(treedef, [
            jnp.asarray(base + spread * (i + np.arange(np.size(a)).reshape(np.shape(a)) / 7.0), jnp.float32)
            for i, a in enumerate(leaves)
        ])

    hp = dict(jstate.inner_hparams)
    hp["lr"] = distinct(hp["lr"], 0.05, 0.01)
    if kind == "adam":
        hp["beta1"] = distinct(hp["beta1"], 0.4, 0.01)
        hp["beta2"] = distinct(hp["beta2"], 0.6, 0.01)
    jstate = jstate._replace(inner_hparams=hp)
    opt_state = jsys.outer_opt.init({"params": jstate.params, "hparams": jstate.inner_hparams})
    if kind == "adam":
        adam = opt_state[0]
        seeded = lambda tree, f: jax.tree.map(lambda a: jnp.asarray(f(rng.rand(*np.shape(a))), jnp.float32), tree)  # noqa: E731
        adam = adam._replace(count=jnp.int32(3), mu=seeded(adam.mu, lambda r: 0.02 * (r - 0.5)),
                             nu=seeded(adam.nu, lambda r: 1e-3 * r))
        opt_state = (adam,) + tuple(opt_state[1:])
    jstate = jstate._replace(opt_state=opt_state)
    tsys = MAMLSystem(tc, model=tmodel, device="cpu")
    return jsys, jstate, tsys, port_state(jstate, tsys)


#: (inner optimizer, use_pallas_inner_update, config overrides)
VARIANTS = {
    "adam_warm_start": ("adam", False, {}),
    "rprop": ("rprop", False, {}),
    "lslr_per_step_unfused": ("sgd", False, {"lslr_per_step": True}),
    "lslr_per_step_fused": ("sgd", True, {"lslr_per_step": True}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_linear_train_step_matches_jax_scan(variant):
    kind, fused, overrides = VARIANTS[variant]
    jsys, jstate, tsys, tstate = scan_pair(kind, fused, **overrides)
    if variant == "adam_warm_start":
        warm = tsys._initial_inner_state(tstate.params, tstate.inner_hparams, tstate.opt_state)
        assert float(warm["step"]["fc"]["w"]) == 3.0 and float(warm["exp_avg"]["fc"]["w"].abs().sum()) > 0
    if overrides.get("lslr_per_step"):
        K = tsys.cfg.number_of_training_steps_per_iter
        assert all(tuple(a.shape) == (K,) for a in tree_leaves(tstate.inner_hparams))
    b = batch(seed=1)
    jloss, _, jgrads = jax_meta_gradients(jsys, jstate, b, 0)
    loss, _, grads = tsys.meta_gradients(tstate, b, 0)
    np.testing.assert_allclose(float(loss), jloss, rtol=0, atol=ATOL)
    _close(trainables_to_jax(grads, tsys.model.feature_shape), jgrads)
    # every learned hparam gets a real meta-gradient (per step under
    # lslr_per_step: B2's dlr lands in its step's element)
    for g in tree_leaves(grads["hparams"]):
        assert bool((g.abs() > 0).all()), g
    jnew, jout = jsys.train_step(jstate, _jnp(b), epoch=0)
    new, out = tsys.train_step(tstate, b, epoch=0)
    _outputs_close(out, jout)
    _state_close(tsys, new, jnew)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_linear_five_step_trajectory_matches_jax_scan(variant):
    """5 outer steps over fresh batches, 2 iterations per epoch (the MSL
    weights and the schedule move), then one eval step; Adam's betas stay
    in [1e-4, 0.99] after the projection."""
    kind, fused, overrides = VARIANTS[variant]
    jsys, jstate, tsys, tstate = scan_pair(kind, fused, total_iter_per_epoch=2, **overrides)
    fused_update.reset_launch_counts()
    for i in range(5):
        b = batch(seed=10 + i)
        jstate, jout = jsys.train_step(jstate, _jnp(b), epoch=i // 2)
        tstate, out = tsys.train_step(tstate, b, epoch=i // 2)
        _outputs_close(out, jout)
    _state_close(tsys, tstate, jstate)
    b = batch(seed=99)
    _outputs_close(tsys.eval_step(tstate, b), jsys.eval_step(jstate, _jnp(b)))
    if kind == "adam":
        for beta in tree_leaves({k: tstate.inner_hparams[k] for k in ("beta1", "beta2")}):
            assert 1e-4 <= float(beta) <= 0.99
    assert fused_update.launch_counts == {"fused_sgd": 0, "fused_sgd_bwd": 0}  # CPU: twins only


def test_fused_update_refuses_adam_and_rprop():
    for kind in ("adam", "rprop"):
        with pytest.raises(ValueError, match="only supports the sgd/gd"):
            scan_pair(kind, fused=True)


# ---------------------------------------------------------------------------
# a small ResNet
# ---------------------------------------------------------------------------


RESNET_GRAD_RTOL = 5e-5  # of the largest |g| over all leaves


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_small_resnet_train_step_matches_jax_scan(fused):
    """resnet-4 on 8x8x1, 3-way 2-shot, K=2, second order with MSL: the
    loss within 1e-5 relative, the meta-gradient at atol 5e-5 x the largest
    |g| over all leaves (module docstring); unfused, the port no further
    from float64 than JAX."""
    jsys, jstate, tsys, tstate = scan_pair("sgd", fused, model="resnet-4")
    assert len(tree_leaves(tstate.params)) == 38
    b = batch(seed=2)
    jloss, _, jgrads = jax_meta_gradients(jsys, jstate, b, 0)
    loss, _, grads = tsys.meta_gradients(tstate, b, 0)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    fs = tsys.model.feature_shape
    got = trainables_to_jax(grads, fs)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(jgrads))
    _close(got, jgrads, atol=RESNET_GRAD_RTOL * scale)
    if not fused:
        f64 = _Float64System(tsys.cfg, model=tsys.model, device="cpu")
        st64 = tstate._replace(opt_state=None, **{
            k: tree_map(lambda t: t.double(), getattr(tstate, k)) for k in ("params", "bn_state", "inner_hparams")
        })
        exact = _flat(trainables_to_jax(f64.meta_gradients(st64, b, epoch=0)[2], fs))
        assert np.abs(_flat(got) - exact).max() <= np.abs(_flat(jgrads) - exact).max()


# ---------------------------------------------------------------------------
# inner Adam at a reduced omniglot.20.5.vgg.adam: five outer steps
# ---------------------------------------------------------------------------


def test_vgg_inner_adam_five_outer_steps_follow_jax():
    """The fleet row omniglot.20.5.vgg.adam of configs/default.yaml (inner
    Adam at lr 0.1 with betas 0.5 learnable and warm-started from the outer
    Adam; 20-way 5-shot, 28x28, K=5, second order, MSL), reduced to VGG
    with 8 filters and 2 tasks: 5 outer steps of the JAX package on one
    batch, and at each the port's step from JAX's state carried over. The
    step's loss within 1e-6 (JAX casts its logits and loss to float32, whose
    ulp at 2.3 is 2.4e-7) and the next params, lrs and betas within 1e-6.

    Both packages run in float64 (JAX under ``jax.enable_x64``, the port's
    plain path): here JAX's float32 program puts the first step's loss 3e-4
    from float64 (the port's 5e-7), and the trajectory is chaotic, since
    each inner Adam step is near sign(g) at lr 0.1 and the warm start feeds
    the outer moments into it, so free-running trajectories part after one
    step at any precision. Holding each step from the same state compares
    the function. The JAX trajectory itself rises after its second step,
    as inner Adam did on the card: the rise belongs to the configuration."""
    overrides = ["inner_optim=adam", "batch_size=2", "num_samples_per_class=5",
                 "unroll_inner_steps=false", "remat_inner_steps=false"]
    default = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "default.yaml")
    jc, tc = jcfg.load_config(default, overrides), tcfg.load_config(default, overrides)
    assert (jc.num_classes_per_set, jc.number_of_training_steps_per_iter, jc.inner_optim.lr) == (20, 5, 0.1)
    jsys = JaxMAMLSystem(jc, model=jax_build_vgg(jc.image_shape, 20, cnn_num_filters=8))
    tsys = _Float64System(tc, model=build_vgg(tc.image_shape, 20, cnn_num_filters=8), device="cpu")
    b = learnable_synthetic_batch(2, 20, 5, jc.num_target_samples, jc.image_shape, seed=7)
    fs = tsys.model.feature_shape
    to64 = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)
    jlosses, jstate = [], jsys.init_train_state(0)
    with jax.enable_x64(True):
        jstate = jstate._replace(**{k: to64(getattr(jstate, k)) for k in ("params", "bn_state", "inner_hparams",
                                                                          "opt_state")})
        b64 = _jnp({k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in b.items()})
        for _ in range(5):
            tstate = _double(port_state(jax.tree.map(np.asarray, jstate), tsys))
            jstate, jout = jsys.train_step(jstate, b64, epoch=0)
            jlosses.append(float(jout.loss))
            new, out = tsys.train_step(tstate, b, epoch=0)
            np.testing.assert_allclose(float(out.loss), jlosses[-1], rtol=0, atol=1e-6)
            want = jax.tree.map(np.asarray, jstate)
            _close(trainables_to_jax({"params": new.params, "hparams": new.inner_hparams}, fs),
                   {"params": want.params, "hparams": want.inner_hparams}, atol=1e-6)
    assert set(new.inner_hparams) == {"lr", "beta1", "beta2"}
    assert all(np.isfinite(jlosses)) and max(jlosses[2:]) > jlosses[1]


def _double(state):
    return jax.tree.map(lambda t: t.double() if t.is_floating_point() else t, state)
