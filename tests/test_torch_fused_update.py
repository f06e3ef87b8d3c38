"""The port's fused LSLR update (ops/fused_update.py): packing, the plain
twins of B1 and B2 against the JAX package's Pallas update and its
``custom_vjp`` (interpret mode on the CPU), the bf16 rounding contracts, the
``autograd.Function`` around them, and the wrapper's dispatch rules. The
CUDA kernels themselves run only on the card: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ops.pallas_update import fused_sgd_update as jax_fused_sgd_update
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
from howtotrainyourmamlpytorch_tpu_torch.ops.inner_optim import build_inner_optimizer
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves, tree_map

torch.set_num_threads(1)

# the shapes of tests/test_pallas_update.py::_tree
_SHAPES = {"conv": {"w": (3, 3, 4, 8), "b": (8,)}, "head": {"w": (200, 5), "b": (5,)}}


def _np_tree(seed, batch=()):
    rng = np.random.RandomState(seed)
    return tree_map(lambda s: rng.randn(*batch, *s).astype(np.float32), _SHAPES)


def _np_lrs(base=0.1):
    leaves = tree_leaves(_SHAPES)
    it = iter(np.float32(base * (i + 1)) for i in range(len(leaves)))
    return tree_map(lambda _: next(it), _SHAPES)


def _torch(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(dtype), tree)


def _assert_tree_equal(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("batch", [(), (3,)], ids=["tree", "task_stacked"])
def test_pack_unpack_roundtrip(batch):
    tree = _torch(_np_tree(0, batch))
    layout = fu.build_layout(tree, batch_dims=len(batch))
    buf = fu.pack(tree, layout)
    # conv.b, conv.w (288 -> 3 rows), head.b, head.w (1000 -> 8 rows)
    assert layout.leaf_rows == (1, 3, 1, 8) and layout.rows == 13
    assert buf.shape == (int(np.prod(batch or (1,))) * 13, fu.LANE) and buf.is_contiguous()
    _assert_tree_equal(fu.unpack(buf, layout), tree)
    # padding lanes are zero
    assert torch.count_nonzero(buf) == sum(a.numel() for a in tree_leaves(tree))


def _assert_close_to_jax(got, want, grads, lrs):
    """rtol 1e-6, plus half an ulp of ``lr * g``: on the CPU the JAX
    package's interpret-mode kernel contracts ``p - lr * g`` into one fused
    multiply-add, while the port (twin and CUDA kernel alike) rounds the
    product first, as the plain JAX update does. The two differ by at most
    the product's rounding, 2**-24 * |lr * g|."""
    for g_t, w, gr, lr in zip(tree_leaves(got), jax.tree.leaves(want), tree_leaves(grads), tree_leaves(lrs)):
        got_np, want_np = g_t.numpy(), np.asarray(w)
        assert got_np.shape == want_np.shape
        bound = 1e-6 * np.abs(want_np) + 2.0**-24 * np.abs(np.float32(lr) * gr)
        assert np.all(np.abs(got_np - want_np) <= bound)


def test_twin_matches_jax_fused_update_f32():
    params, grads, lrs = _np_tree(0), _np_tree(1), _np_lrs()
    want = jax_fused_sgd_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, lrs),
    )
    got = fu.fused_sgd_update(_torch(params), _torch(grads), _torch(lrs))
    _assert_close_to_jax(got, want, grads, lrs)


def test_twin_equals_jax_unfused_update_bitwise():
    """In f32 the twin is the JAX package's unfused per-leaf update
    (``inner_optim.sgd(fused=False)``) bit for bit."""
    params, grads, lrs = _np_tree(0), _np_tree(1), _np_lrs()
    want = jax.tree.map(
        lambda p, g, a: jnp.asarray(p) - jnp.asarray(a) * jnp.asarray(g), params, grads, lrs
    )
    got = fu.fused_sgd_update(_torch(params), _torch(grads), _torch(lrs))
    for g_t, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(w))


def test_twin_matches_jax_fused_update_task_stacked():
    """The serving engine's shape: JAX vmaps the per-task update over the
    task axis; the port packs all tasks into one launch's rows."""
    T = 4
    params, grads, lrs = _np_tree(0, (T,)), _np_tree(1, (T,)), _np_lrs(0.05)
    want = jax.vmap(jax_fused_sgd_update, in_axes=(0, 0, None))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, lrs),
    )
    tp, tg = _torch(params), _torch(grads)
    layout = fu.build_layout(tp, batch_dims=1)
    got = fu.fused_sgd_update(tp, tg, _torch(lrs), layout)
    assert all(leaf.shape[0] == T for leaf in tree_leaves(got))
    _assert_close_to_jax(got, want, grads, lrs)


def _bf16_round_np(x32: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits, round to nearest even (finite inputs)."""
    bits = x32.view(np.uint32).astype(np.uint64)
    bias = ((bits >> 16) & 1) + 0x7FFF
    return ((bits + bias) >> 16).astype(np.uint16)


def test_twin_bf16_matches_written_contract_bitwise():
    """bf16 operands: f32 multiply, f32 subtract, ONE round-to-nearest-even
    to bf16 (the contract of ops/pallas_update.py's docstring), computed in
    numpy."""
    rows = 64
    rng = np.random.RandomState(3)
    p = torch.from_numpy(rng.randn(rows, fu.LANE).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.randn(rows, fu.LANE).astype(np.float32)).to(torch.bfloat16)
    lr = torch.from_numpy(rng.uniform(1e-3, 0.5, rows).astype(np.float32))
    got = fu.fused_sgd_rows(p, g, lr)
    assert got.dtype == torch.bfloat16
    p32, g32 = p.float().numpy(), g.float().numpy()
    prod = (lr.numpy()[:, None] * g32).astype(np.float32)
    want = _bf16_round_np((p32 - prod).astype(np.float32))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


def test_wrapper_takes_twin_on_cpu_without_counting():
    p, g = torch.randn(10, fu.LANE), torch.randn(10, fu.LANE)
    lr = torch.full((10,), 0.1)
    fu.reset_launch_counts()
    out = fu.fused_sgd_rows(p, g, lr)
    assert fu.launch_counts["fused_sgd"] == 0
    assert torch.equal(out, fu.fused_sgd_rows_reference(p, g, lr))


@pytest.mark.parametrize("which", ["p", "g", "lr_rows"])
def test_wrapper_gradient_per_input_equals_twin(which):
    """The wrapper takes inputs that require grad; each input's gradient is
    its part of the twin VJP (``dp = ct``, ``dg``, ``dlr_rows``)."""
    gen = torch.Generator().manual_seed(5)
    args = {"p": torch.randn(4, fu.LANE, generator=gen), "g": torch.randn(4, fu.LANE, generator=gen),
            "lr_rows": torch.rand(4, generator=gen)}
    ct = torch.randn(4, fu.LANE, generator=gen)
    args[which].requires_grad_(True)
    (fu.fused_sgd_rows(args["p"], args["g"], args["lr_rows"]) * ct).sum().backward()
    dg, dlr = fu.fused_sgd_bwd_reference(ct, args["g"].detach(), args["lr_rows"].detach())
    want = {"p": ct, "g": dg, "lr_rows": dlr}[which]
    assert torch.equal(args[which].grad, want)


@pytest.mark.parametrize(
    "p,g,lr,err",
    [
        (torch.randn(4, 64), torch.randn(4, 64), torch.ones(4), ValueError),
        (torch.randn(4, 128), torch.randn(4, 128), torch.ones(5), ValueError),
        (torch.randn(4, 128).double(), torch.randn(4, 128).double(), torch.ones(4), TypeError),
        (torch.randn(4, 128), torch.randn(4, 128).bfloat16(), torch.ones(4), TypeError),
        (torch.randn(4, 128), torch.randn(4, 128), torch.ones(4).double(), ValueError),
    ],
    ids=["narrow_rows", "lr_length", "float64", "mixed_dtypes", "lr_dtype"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(p, g, lr, err):
    with pytest.raises(err):
        fu.fused_sgd_rows(p, g, lr)


def test_inner_optimizer_fused_equals_unfused_f32():
    opt_f = build_inner_optimizer("sgd", lr=0.1, fused=True)
    opt_p = build_inner_optimizer("sgd", lr=0.1)
    params, grads = _torch(_np_tree(0, (2,))), _torch(_np_tree(1, (2,)))
    hp = opt_f.init_hparams(tree_map(lambda a: a[0], params))
    fused, _ = opt_f.update(grads, (), params, hp, batch_dims=1)
    plain, _ = opt_p.update(grads, (), params, hp, batch_dims=1)
    _assert_tree_equal(fused, plain)


# ---------------------------------------------------------------------------
# the backward: FusedSGD's VJP (B2's twin) against JAX and the unfused form
# ---------------------------------------------------------------------------


def _objective_weights(batch=()):
    rng = np.random.RandomState(7)
    return tree_map(lambda sh: rng.randn(*batch, *sh).astype(np.float32), _SHAPES)


def _port_grads(params, grads, lrs, weights, fused=True, batch_dims=0):
    """Gradients of sum(update(p, g, lr) * W) in the port: fused (the
    Function) or unfused (``p - lr * g`` per leaf under autograd)."""
    req = lambda tree: tree_map(lambda a: _torch_leaf(a).requires_grad_(True), tree)  # noqa: E731
    tp, tg, tl = req(params), req(grads), req(lrs)
    if fused:
        layout = fu.build_layout(tp, batch_dims=batch_dims)
        out = fu.fused_sgd_update(tp, tg, tl, layout)
    else:
        out = tree_map(lambda p, g, a: p - a * g, tp, tg, tl)
    total = sum((o * _torch_leaf(w)).sum() for o, w in zip(tree_leaves(out), tree_leaves(weights)))
    total.backward()
    return tuple(tree_map(lambda t: t.grad, tree) for tree in (tp, tg, tl))


def _torch_leaf(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("tasks", [0, 3], ids=["tree", "task_stacked"])
def test_function_gradients_match_jax_custom_vjp(tasks):
    """Gradients of sum(out * W) w.r.t. p, g and the per-tensor lrs against
    ``jax.grad`` through the JAX package's fused update (rtol 1e-5). With a
    task axis the JAX update is vmapped and the lr gradient sums over the
    tasks; in the port that sum is autograd's transpose of ``lr_rows_for``."""
    batch = (tasks,) if tasks else ()
    params, grads, lrs, weights = _np_tree(0, batch), _np_tree(1, batch), _np_lrs(), _objective_weights(batch)
    update = jax_fused_sgd_update if not tasks else jax.vmap(jax_fused_sgd_update, in_axes=(0, 0, None))

    def objective(p, g, lr):
        out = update(p, g, lr)
        return sum(jnp.sum(o * w) for o, w in zip(jax.tree.leaves(out), jax.tree.leaves(weights)))

    want = jax.grad(objective, argnums=(0, 1, 2))(
        *(jax.tree.map(jnp.asarray, t) for t in (params, grads, lrs))
    )
    got = _port_grads(params, grads, lrs, weights, batch_dims=len(batch))
    for got_tree, want_tree in zip(got, want):
        for a, b in zip(tree_leaves(got_tree), jax.tree.leaves(want_tree)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_function_gradients_equal_unfused_autograd():
    """Against ``p - lr * g`` per leaf under autograd: ``dp`` and ``dg`` bit
    for bit (the same products), the lr gradients within 1e-6 relative (the
    row sums run in another order than the per-leaf sum)."""
    params, grads, lrs, weights = _np_tree(0, (2,)), _np_tree(1, (2,)), _np_lrs(), _objective_weights((2,))
    lrs_b = tree_map(lambda a: np.float32(a), lrs)
    fused = _port_grads(params, grads, lrs_b, weights, batch_dims=1)
    plain = _port_grads(params, grads, lrs_b, weights, fused=False)
    for i in (0, 1):
        _assert_tree_equal(fused[i], plain[i])
    for a, b in zip(tree_leaves(fused[2]), tree_leaves(plain[2])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def _dlr_bound(ct32, g32):
    """Per-row bound on two f32 sums of 128 products that add in different
    orders: each is within 128 * 2**-24 * sum|ct * g| of the exact sum (one
    rounding per product and per addition, at most 128 deep), so they are
    within twice that of each other, or of a float64 sum."""
    return 2 * 128 * 2.0**-24 * np.abs(ct32.astype(np.float64) * g32).sum(1)


def test_backward_bf16_matches_written_contract():
    """bf16 operands: ``dp`` and ``dg`` come back bf16, ``dlr_rows`` f32.
    ``dg`` is ONE f32 product ``-lr * ct`` rounded once to bf16 (computed in
    numpy), bit for bit; ``dlr_rows`` is within :func:`_dlr_bound` of a
    float64 sum."""
    rows = 64
    rng = np.random.RandomState(4)
    p = torch.from_numpy(rng.randn(rows, fu.LANE).astype(np.float32)).to(torch.bfloat16).requires_grad_(True)
    g = torch.from_numpy(rng.randn(rows, fu.LANE).astype(np.float32)).to(torch.bfloat16).requires_grad_(True)
    lr = torch.from_numpy(rng.uniform(1e-3, 0.5, rows).astype(np.float32)).requires_grad_(True)
    ct = torch.from_numpy(rng.randn(rows, fu.LANE).astype(np.float32)).to(torch.bfloat16)
    out = fu.fused_sgd_rows(p, g, lr)
    out.backward(ct)
    assert p.grad.dtype == g.grad.dtype == torch.bfloat16 and lr.grad.dtype == torch.float32
    assert torch.equal(p.grad, ct)
    ct32, g32 = ct.float().numpy(), g.detach().float().numpy()
    want_dg = _bf16_round_np((-lr.detach().numpy()[:, None] * ct32).astype(np.float32))
    np.testing.assert_array_equal(g.grad.view(torch.int16).numpy().view(np.uint16), want_dg)
    exact = -(ct32.astype(np.float64) * g32).sum(1)
    assert np.all(np.abs(lr.grad.numpy() - exact) <= _dlr_bound(ct32, g32))


def test_double_backward_raises():
    """The backward is the VJP only (the meta-gradient needs no more):
    differentiating through it raises instead of returning wrong values."""
    p = torch.randn(3, fu.LANE, requires_grad=True)
    g = torch.randn(3, fu.LANE, requires_grad=True)
    lr = torch.full((3,), 0.1, requires_grad=True)
    out = fu.fused_sgd_rows(p, g, lr)
    (dg,) = torch.autograd.grad((out * out).sum(), g, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        dg.sum().backward()


def test_lr_column_transpose_is_the_segment_sum_over_leaves_and_tasks():
    """``lr_rows_for`` builds the per-row column with ``cat`` and ``expand``;
    autograd's transpose of it sums each leaf's rows, over every task, into
    that leaf's lr: the segment-sum XLA does outside the JAX kernel."""
    T = 3
    layout = fu.build_layout(_torch(_np_tree(0, (T,))), batch_dims=1)
    lrs = tree_map(lambda a: torch.tensor(float(a), requires_grad=True), _np_lrs())
    cot = torch.randn(T * layout.rows, generator=torch.Generator().manual_seed(2))
    (fu.lr_rows_for(lrs, layout) * cot).sum().backward()
    per_task = cot.reshape(T, layout.rows).sum(0)
    start = 0
    for lr, n_rows in zip(tree_leaves(lrs), layout.leaf_rows):
        torch.testing.assert_close(lr.grad, per_task[start : start + n_rows].sum(), rtol=1e-6, atol=0)
        start += n_rows
