"""The port's ResNet and DenseNet backbones (models/resnet.py,
models/densenet.py, models/layers.py) against the JAX package's
``build_model(...).apply``, on JAX weights moved through the carry-over
(utils/interop.py), and the carry-over of every backbone.

Small shapes: 16x16x3 images, 3-way, 6 samples. Logits and the gradient of
the support loss with respect to the input at atol 1e-5, the parameter
gradients at atol 2e-5 on one scale for all leaves (2e-5 x the largest
|g|): both sides run float32 on the CPU, and only the order of the
convolution and reduction sums differs. (At 1e-5 x the scale one element
of 32,768 fails: a weight gradient of the last stage's 1x1 stride-2
downsample lands 1.31e-5 apart on a scale of 1.27, 2e-5 relative.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.experiment import checkpoint as jax_ckpt
from howtotrainyourmamlpytorch_tpu.models import build_model as jax_build_model
from howtotrainyourmamlpytorch_tpu.ops.losses import cross_entropy as jax_cross_entropy
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.models import layers
from howtotrainyourmamlpytorch_tpu_torch.models.registry import MODEL_NAMES, build_model
from howtotrainyourmamlpytorch_tpu_torch.ops.losses import cross_entropy
from howtotrainyourmamlpytorch_tpu_torch.utils import seeding
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import (
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten, tree_leaves, tree_map

torch.set_num_threads(1)

IMG, N_WAY, N = (16, 16, 3), 3, 6
ATOL = 1e-5
GRAD_RTOL = 2e-5  # of the largest |g| over all leaves


def _jax_init(net, img=IMG, n_way=N_WAY, seed=1):
    jm = jax_build_model(net, img, n_way)
    params, bn_state = jm.init(jax.random.PRNGKey(seed))
    return jm, build_model(net, img, n_way), params, bn_state


def _inputs(masked, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(N, *IMG).astype(np.float32)
    y = (np.arange(N) % N_WAY).astype(np.int32)
    w = np.array([1, 1, 1, 1, 1, 0], np.float32) if masked else None
    return x, y, w


def _port(tree, model):
    return params_from_jax(jax.tree.map(np.asarray, tree), model.feature_shape)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("net", ["resnet-4", "densenet-8"])
def test_backbone_logits_and_grads_match_jax(net, masked):
    jm, tm, params, bn_state = _jax_init(net)
    x, y, w = _inputs(masked)
    jw = None if w is None else jnp.asarray(w)

    def jax_loss(p, xx):
        logits, _ = jm.apply(p, bn_state, xx, use_batch_stats=True, sample_weight=jw)
        return jax_cross_entropy(logits, jnp.asarray(y), sample_weight=jw), logits

    (_, jax_logits), (jax_pgrads, jax_xgrad) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x)
    )
    t_bn = _port(bn_state, tm)
    tw = None if w is None else torch.from_numpy(w)

    def torch_loss(p, xx):
        logits, _ = tm.apply(p, t_bn, xx, use_batch_stats=True, sample_weight=tw)
        return cross_entropy(logits, torch.from_numpy(y).long(), sample_weight=tw), logits

    (t_pgrads, t_xgrad), t_logits = grad(torch_loss, argnums=(0, 1), has_aux=True)(
        _port(params, tm), torch.from_numpy(x)
    )
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(jax_logits), rtol=0, atol=ATOL)
    np.testing.assert_allclose(t_xgrad.numpy(), np.asarray(jax_xgrad), rtol=0, atol=ATOL)
    got, want = jax.tree.leaves(params_to_jax(t_pgrads, tm.feature_shape)), jax.tree.leaves(jax_pgrads)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=GRAD_RTOL * scale)


@pytest.mark.parametrize("net", ["resnet-12", "densenet-12"])
def test_deep_backbones_forward_match_jax(net):
    """atol 1e-5 on the logits' scale (their largest |value|, at least 1):
    through ResNet-12's 12 BNs each float32 side drifts from a float64
    evaluation by about that much (the port's own float64 forward; the
    port held no further from it than twice JAX's distance)."""
    jm, tm, params, bn_state = _jax_init(net)
    x, _, _ = _inputs(False)
    want, _ = jm.apply(params, bn_state, jnp.asarray(x), use_batch_stats=True)
    got, _ = tm.apply(_port(params, tm), _port(bn_state, tm), torch.from_numpy(x))
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL * scale)
    f64 = lambda tree: tree_map(lambda t: t.double(), _port(tree, tm))  # noqa: E731
    exact, _ = tm.apply(f64(params), f64(bn_state), torch.from_numpy(x).double())
    exact = exact.numpy()
    assert np.abs(got.numpy() - exact).max() <= 2 * np.abs(np.asarray(want, np.float64) - exact).max() + 1e-7


#: leaves and parameters at 28x28x1, 20-way (JAX ``build_model``)
TREE_SIZES = {
    "vgg": (18, 113_236), "resnet-4": (38, 1_221_780), "resnet-8": (62, 2_790_420),
    "resnet-12": (86, 4_359_060), "densenet-8": (61, 12_942), "densenet-12": (85, 21_790),
}


@pytest.mark.parametrize("net", MODEL_NAMES)
def test_weight_carry_over_round_trips_every_backbone(net):
    """JAX weights -> port -> JAX, exact, at the repository's Omniglot
    shape; the port's own init has the JAX tree's paths and shapes."""
    jm, tm, params, _ = _jax_init(net, img=(28, 28, 1), n_way=20, seed=0)
    np_params = jax.tree.map(np.asarray, params)
    t_params = params_from_jax(np_params, tm.feature_shape)
    back = params_to_jax(t_params, tm.feature_shape)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    own, _ = tm.init(seeding.model_init_generator(0))
    own_leaves, own_paths = tree_flatten(own)
    carried, carried_paths = tree_flatten(t_params)
    assert own_paths == carried_paths
    assert [tuple(t.shape) for t in own_leaves] == [tuple(t.shape) for t in carried]
    assert (len(own_leaves), sum(t.numel() for t in own_leaves)) == TREE_SIZES[net]
    head = "classifier" if net.startswith("densenet") else "fc"
    assert tuple(t_params[head]["w"].shape) == (20, tm.feature_shape[0])
    if net.startswith("resnet"):  # HWIO -> OIHW on conv1/conv2 and downsample/conv
        block = t_params["layer2"]["block_0"]
        assert tuple(block["conv1"]["w"].shape) == (64, 32, 3, 3)
        assert tuple(block["downsample"]["conv"]["w"].shape) == (64, 32, 1, 1)
        np.testing.assert_array_equal(
            block["conv2"]["w"].permute(2, 3, 1, 0).numpy(), np_params["layer2"]["block_0"]["conv2"]["w"]
        )


def test_relu_tie_gradient_is_half():
    """``layers.relu`` is ``max(x, 0)`` with JAX's tie rule (gradient 0.5 at
    exactly 0), where ``torch.relu``'s is 0."""
    x = torch.tensor([-1.0, 0.0, 0.0, 2.0], requires_grad=True)
    layers.relu(x).sum().backward()
    assert x.grad.tolist() == [0.0, 0.5, 0.5, 1.0]
    jx = jax.grad(lambda v: jnp.maximum(v, 0).sum())(jnp.asarray([-1.0, 0.0, 0.0, 2.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jx))


def test_jax_resnet_checkpoint_loads_in_the_port(tmp_path):
    """A run directory the JAX package wrote for a resnet-4 system: the
    port's ``load_checkpoint`` (full state, outer Adam included) and
    ``load_for_inference`` give the JAX weights in the port's layout, and
    the port writes them back in the JAX layout."""
    jc = jcfg.Config(net="resnet-4", num_classes_per_set=N_WAY, seed=0)
    tc = tcfg.Config(net="resnet-4", num_classes_per_set=N_WAY, seed=0)
    jsys = JaxMAMLSystem(jc)
    jstate = jsys.init_train_state()
    rng = np.random.RandomState(3)
    moments = lambda: jax.tree.map(lambda a: jnp.asarray(rng.rand(*np.shape(a)), jnp.float32), jstate.opt_state[0].mu)  # noqa: E731
    jstate = jstate._replace(opt_state=(jstate.opt_state[0]._replace(mu=moments(), nu=moments()), jstate.opt_state[1]))
    save_dir = tmp_path / "saved_models"
    save_dir.mkdir()
    jax_ckpt.save_checkpoint(str(save_dir), jstate, {"epoch": 0}, epoch=0)

    tsys = MAMLSystem(tc, device="cpu")
    fs = tsys.model.feature_shape
    assert fs == (256, 1, 1)
    state, book = ckpt.load_checkpoint(str(save_dir), "latest", tsys.init_train_state(), feature_shape=fs)
    assert book["epoch"] == 0
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), fs)
    for a, b in zip(tree_leaves(state.params), tree_leaves(want)):
        assert torch.equal(a, b)
    got = opt_state_to_jax(state.opt_state, fs)
    for a, b in zip(jax.tree.leaves(got[0].nu), jax.tree.leaves(jstate.opt_state[0].nu)):
        np.testing.assert_array_equal(a, np.asarray(b))
    inference, _ = ckpt.load_for_inference(str(save_dir), "latest")
    for a, b in zip(jax.tree.leaves(inference.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ckpt.save_checkpoint(str(tmp_path / "port"), state, {"epoch": 1}, epoch=1, feature_shape=fs)
    back, _ = jax_ckpt.load_for_inference(str(tmp_path / "port"), "latest")
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
