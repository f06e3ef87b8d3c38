"""The port's fused LSLR update (ops/fused_update.py): the leaf records a
launch passes to the kernels, the plain twins of B1 and B2 against the JAX package's
Pallas update and its ``custom_vjp`` (interpret mode on the CPU), the bf16
rounding contracts, the ``autograd.Function`` around them, and the
wrapper's checks and dispatch rules. The CUDA kernels themselves run only on
the card: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ops import pallas_update as jax_pallas
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


# ---------------------------------------------------------------------------
# the host side of a launch: the leaf records the C functions take
# ---------------------------------------------------------------------------


def _record_leaves(kind):
    """(first operands, second operands, the leaves a launch must copy) of a
    tree of the test's shapes, of its task stack, or of leaves that are not
    contiguous: a stride-0 expansion (a ``.sum()``'s cotangent), a strided
    slice and the transpose of the last two dims (a batched linear layer's
    weight cotangent), beside a leaf 4 bytes past a 16-byte boundary."""
    gen = torch.Generator().manual_seed(3)
    if kind != "non_contiguous":
        batch = (3,) if kind == "task_stacked" else ()
        ps = [torch.randn(*batch, *s, generator=gen) for s in tree_leaves(_SHAPES)]
        gs = [torch.randn(*batch, *s, generator=gen) for s in tree_leaves(_SHAPES)]
        ps[1], gs[1] = torch.randn(ps[1].numel() + 1, generator=gen)[1:].view(ps[1].shape), gs[1]
        return ps, gs, 0
    ps = [
        torch.randn((), generator=gen).expand(4, 6),
        torch.randn(4, 10, generator=gen)[:, ::2],
        torch.randn(2, 5, 3, generator=gen).transpose(1, 2),
        torch.randn(130, generator=gen)[1:],
    ]
    gs = [torch.randn(p.shape, generator=gen) for p in ps]
    return ps, gs, 3


@pytest.mark.parametrize("kind", ["tree", "task_stacked", "non_contiguous"])
def test_leaf_records_and_outputs_on_the_host(kind):
    """``_prepare`` (which needs no card): per leaf one record of five
    words, the pointers of the operands the launch reads, the output and
    the lr, and the element count; outputs contiguous on 16-byte
    boundaries; a leaf off a 16-byte boundary passed where it lies (the
    kernels read it element by element); a leaf that is not contiguous
    copied, counted, and returned, so that the caller holds the copy the
    record points at until the launch."""
    ps, gs, copies = _record_leaves(kind)
    lrs = [torch.tensor(0.1 * (i + 1)) for i in range(len(ps))]
    fu.reset_launch_counts()
    a_leaves, b_leaves, outs, records = fu._prepare(ps, gs, lrs)
    assert fu.contiguous_copies == copies and fu.launch_counts == {"fused_sgd": 0, "fused_sgd_bwd": 0}
    words = list(records)
    assert len(words) == 5 * len(ps)
    for i, (p, g, a, b, out, lr) in enumerate(zip(ps, gs, a_leaves, b_leaves, outs, lrs)):
        assert a.is_contiguous() and b.is_contiguous() and torch.equal(a, p) and torch.equal(b, g)
        assert (a is p) == p.is_contiguous() and b is g
        assert out.shape == p.shape and out.dtype == p.dtype and out.is_contiguous() and out.data_ptr() % 16 == 0
        assert words[5 * i : 5 * i + 5] == [a.data_ptr(), b.data_ptr(), out.data_ptr(), lr.data_ptr(), p.numel()]
    assert any(w % 16 for w in words[0::5])  # one leaf lies off a 16-byte boundary


# ---------------------------------------------------------------------------
# B1's twin against the JAX package
# ---------------------------------------------------------------------------


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
    task axis; the port's leaves carry it, in one launch. In f32 the twin is
    also the JAX unfused update bit for bit."""
    T = 4
    params, grads, lrs = _np_tree(0, (T,)), _np_tree(1, (T,)), _np_lrs(0.05)
    jp, jg, jl = (jax.tree.map(jnp.asarray, t) for t in (params, grads, lrs))
    want = jax.vmap(jax_fused_sgd_update, in_axes=(0, 0, None))(jp, jg, jl)
    got = fu.fused_sgd_update(_torch(params), _torch(grads), _torch(lrs))
    assert all(leaf.shape[0] == T for leaf in tree_leaves(got))
    _assert_close_to_jax(got, want, grads, lrs)
    unfused = jax.tree.map(lambda p, g, a: p - a * g, jp, jg, jl)
    for g_t, w in zip(tree_leaves(got), jax.tree.leaves(unfused)):
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(w))


def _bf16_round_np(x32: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits, round to nearest even (finite inputs)."""
    bits = x32.view(np.uint32).astype(np.uint64)
    bias = ((bits >> 16) & 1) + 0x7FFF
    return ((bits + bias) >> 16).astype(np.uint16)


def _bf16_tree(seed):
    rng = np.random.RandomState(seed)
    return tree_map(lambda s: torch.from_numpy(rng.randn(3, *s).astype(np.float32)).to(torch.bfloat16), _SHAPES)


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def test_twin_bf16_matches_written_contract_bitwise():
    """bf16 operands: f32 multiply, f32 subtract, ONE round-to-nearest-even
    to bf16 (the contract of ops/pallas_update.py's docstring), computed in
    numpy, leaf by leaf with each leaf's own f32 lr."""
    p, g = _bf16_tree(3), _bf16_tree(4)
    lrs = _torch(_np_lrs(0.07))
    got = fu.fused_sgd_update(p, g, lrs)
    for out, pl, gl, lr in zip(tree_leaves(got), tree_leaves(p), tree_leaves(g), tree_leaves(lrs)):
        assert out.dtype == torch.bfloat16
        prod = (np.float32(lr) * gl.float().numpy()).astype(np.float32)
        want = _bf16_round_np((pl.float().numpy() - prod).astype(np.float32))
        np.testing.assert_array_equal(_bits(out), want)


def test_wrapper_takes_twin_on_cpu_without_counting():
    params, grads, lrs = _torch(_np_tree(0, (2,))), _torch(_np_tree(1, (2,))), _torch(_np_lrs())
    fu.reset_launch_counts()
    out = fu.fused_sgd_update(params, grads, lrs)
    assert fu.launch_counts == {"fused_sgd": 0, "fused_sgd_bwd": 0} and fu.contiguous_copies == 0
    want = fu.fused_sgd_tree_reference(tree_leaves(params), tree_leaves(grads), tree_leaves(lrs))
    for a, b in zip(tree_leaves(out), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["p", "g", "lr"])
def test_wrapper_gradient_per_input_equals_twin(which):
    """The wrapper takes inputs that require grad; each input's gradient is
    its part of the twin VJP (``dp = ct``, ``dg``, ``dlr``)."""
    gen = torch.Generator().manual_seed(5)
    shapes = [(4, 7), (3,), (2, 2, 5)]
    args = {
        "p": [torch.randn(s, generator=gen) for s in shapes],
        "g": [torch.randn(s, generator=gen) for s in shapes],
        "lr": [torch.rand((), generator=gen) for _ in shapes],
    }
    cts = [torch.randn(s, generator=gen) for s in shapes]
    for t in args[which]:
        t.requires_grad_(True)
    outs = fu.FusedSGD.apply(len(shapes), *args["p"], *args["g"], *args["lr"])
    sum((o * c).sum() for o, c in zip(outs, cts)).backward()
    dg, dlr = fu.fused_sgd_tree_bwd_reference(cts, [t.detach() for t in args["g"]], [t.detach() for t in args["lr"]])
    want = {"p": cts, "g": dg, "lr": list(dlr.unbind())}[which]
    for t, w in zip(args[which], want):
        assert torch.equal(t.grad, w)


def _case(p_dtype=torch.float32, g_dtype=torch.float32, g_shape=(4, 3), lr=None, device="cpu", leaves=1):
    ps = [torch.randn(4, 3, dtype=p_dtype) for _ in range(leaves)]
    gs = [torch.randn(g_shape, dtype=g_dtype, device=device) for _ in range(leaves)]
    lrs = [torch.tensor(0.1) if lr is None else lr for _ in range(leaves)]
    return ps, gs, lrs


@pytest.mark.parametrize(
    "case,err",
    [
        (_case(g_dtype=torch.bfloat16), TypeError),
        (_case(p_dtype=torch.float64, g_dtype=torch.float64), TypeError),
        (_case(g_shape=(3, 4)), ValueError),
        (_case(lr=torch.tensor(0.1, dtype=torch.float64)), ValueError),
        (_case(lr=torch.tensor([0.1])), ValueError),
        (_case(device="meta"), ValueError),
        (_case(leaves=fu.MAX_LEAVES + 1), ValueError),
    ],
    ids=["mixed_dtypes", "float64", "mismatched_shapes", "lr_dtype", "lr_not_0d", "mixed_devices", "too_many_leaves"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(case, err):
    ps, gs, lrs = case
    names = [str(i) for i in range(len(ps))]
    tree = lambda leaves: dict(zip(names, leaves))  # noqa: E731
    with pytest.raises(err):
        fu.fused_sgd_update(tree(ps), tree(gs), tree(lrs))
    with pytest.raises(err):
        fu.FusedSGD.apply(len(ps), *ps, *gs, *lrs)
    with pytest.raises(err):
        fu.fused_sgd_tree_backward(ps, gs, lrs)


def test_inner_optimizer_fused_equals_unfused_f32():
    opt_f = build_inner_optimizer("sgd", lr=0.1, fused=True)
    opt_p = build_inner_optimizer("sgd", lr=0.1)
    params, grads = _torch(_np_tree(0, (2,))), _torch(_np_tree(1, (2,)))
    hp = opt_f.init_hparams(tree_map(lambda a: a[0], params))
    fused, _ = opt_f.update(grads, (), params, hp)
    plain, _ = opt_p.update(grads, (), params, hp)
    _assert_tree_equal(fused, plain)


# ---------------------------------------------------------------------------
# the backward: FusedSGD's VJP (B2's twin) against JAX and the unfused form
# ---------------------------------------------------------------------------


def _objective_weights(batch=()):
    rng = np.random.RandomState(7)
    return tree_map(lambda sh: rng.randn(*batch, *sh).astype(np.float32), _SHAPES)


def _torch_leaf(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _port_grads(params, grads, lrs, weights, fused=True):
    """Gradients of sum(update(p, g, lr) * W) in the port: fused (the
    Function) or unfused (``p - lr * g`` per leaf under autograd)."""
    req = lambda tree: tree_map(lambda a: _torch_leaf(a).requires_grad_(True), tree)  # noqa: E731
    tp, tg, tl = req(params), req(grads), req(lrs)
    if fused:
        out = fu.fused_sgd_update(tp, tg, tl)
    else:
        out = tree_map(lambda p, g, a: p - a * g, tp, tg, tl)
    total = sum((o * _torch_leaf(w)).sum() for o, w in zip(tree_leaves(out), tree_leaves(weights)))
    total.backward()
    return tuple(tree_map(lambda t: t.grad, tree) for tree in (tp, tg, tl))


@pytest.mark.parametrize("tasks", [0, 3], ids=["tree", "task_stacked"])
def test_function_gradients_match_jax_custom_vjp(tasks):
    """Gradients of sum(out * W) w.r.t. p, g and the per-tensor lrs against
    ``jax.grad`` through the JAX package's fused update (rtol 1e-5). With a
    task axis the JAX update is vmapped and the lr gradient sums over the
    tasks. The lr gradient is a sum in another order on each side (JAX sums
    each 128-lane row, then the rows of a leaf; the twin sums the leaf's
    elements and tasks at once); 1e-5 relative is far above float32's
    rounding for these few thousand terms."""
    batch = (tasks,) if tasks else ()
    params, grads, lrs, weights = _np_tree(0, batch), _np_tree(1, batch), _np_lrs(), _objective_weights(batch)
    update = jax_fused_sgd_update if not tasks else jax.vmap(jax_fused_sgd_update, in_axes=(0, 0, None))

    def objective(p, g, lr):
        out = update(p, g, lr)
        return sum(jnp.sum(o * w) for o, w in zip(jax.tree.leaves(out), jax.tree.leaves(weights)))

    want = jax.grad(objective, argnums=(0, 1, 2))(
        *(jax.tree.map(jnp.asarray, t) for t in (params, grads, lrs))
    )
    got = _port_grads(params, grads, lrs, weights)
    for got_tree, want_tree in zip(got, want):
        for a, b in zip(tree_leaves(got_tree), jax.tree.leaves(want_tree)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_function_gradients_equal_unfused_autograd():
    """Against ``p - lr * g`` per leaf under autograd: ``dp`` and ``dg`` bit
    for bit (the same products), the lr gradients within 1e-6 relative (the
    twin's one sum per leaf runs in another order than autograd's
    reduction of the broadcast lr)."""
    params, grads, lrs, weights = _np_tree(0, (2,)), _np_tree(1, (2,)), _np_lrs(), _objective_weights((2,))
    fused = _port_grads(params, grads, lrs, weights)
    plain = _port_grads(params, grads, lrs, weights, fused=False)
    for i in (0, 1):
        _assert_tree_equal(fused[i], plain[i])
    for a, b in zip(tree_leaves(fused[2]), tree_leaves(plain[2])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def _float32_sum_bound(prod64: np.ndarray) -> float:
    """Any float32 sum of these n products, in any order, is within
    (n - 1) * 2**-24 * sum|x| of the exact sum (one rounding per addition;
    the products of bf16 or f32 values are exact in float64)."""
    return max(prod64.size - 1, 0) * 2.0**-24 * float(np.abs(prod64).sum())


def test_backward_bf16_matches_written_contract():
    """bf16 operands: ``dp`` and ``dg`` come back bf16, the lr gradients
    f32. ``dg`` is ONE f32 product ``-lr * ct`` rounded once to bf16
    (computed in numpy), bit for bit; each ``dlr`` is within
    :func:`_float32_sum_bound` of a float64 sum over the leaf and its tasks."""
    p, g, ct = _bf16_tree(3), _bf16_tree(4), _bf16_tree(5)
    lrs = tree_map(lambda a: torch.tensor(float(a)).requires_grad_(True), _np_lrs(0.03))
    for leaf in tree_leaves(p) + tree_leaves(g):
        leaf.requires_grad_(True)
    out = fu.fused_sgd_update(p, g, lrs)
    torch.autograd.backward(tree_leaves(out), tree_leaves(ct))
    for pl, gl, cl, lr in zip(tree_leaves(p), tree_leaves(g), tree_leaves(ct), tree_leaves(lrs)):
        assert pl.grad.dtype == gl.grad.dtype == torch.bfloat16 and lr.grad.dtype == torch.float32
        assert torch.equal(pl.grad, cl)
        ct32, g32 = cl.float().numpy(), gl.detach().float().numpy()
        want_dg = _bf16_round_np((-lr.detach().numpy() * ct32).astype(np.float32))
        np.testing.assert_array_equal(_bits(gl.grad), want_dg)
        prod = ct32.astype(np.float64) * g32
        assert abs(float(lr.grad) - (-prod.sum())) <= _float32_sum_bound(prod)


def test_double_backward_raises():
    """The backward is the VJP only (the meta-gradient needs no more):
    differentiating through it raises instead of returning wrong values."""
    p = {"a": torch.randn(3, 5, requires_grad=True)}
    g = {"a": torch.randn(3, 5, requires_grad=True)}
    lr = {"a": torch.tensor(0.1, requires_grad=True)}
    out = fu.fused_sgd_update(p, g, lr)
    (dg,) = torch.autograd.grad((out["a"] * out["a"]).sum(), g["a"], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        dg.sum().backward()


def test_twin_dlr_is_the_segment_sum_of_jax_row_cotangents():
    """The JAX package's backward kernel gives one lr cotangent per 128-lane
    row of the packed tree, and XLA segment-sums them over the rows of each
    leaf (and the vmap over the tasks). The twin's ``dlr`` of the
    task-stacked tree equals that segment sum (taken here in float64) within
    the two sums' bounds: the rows' float32 sums of 128 products, and the
    twin's one float32 sum over the leaf and its tasks."""
    T = 3
    grads, cts = _np_tree(1, (T,)), _np_tree(2, (T,))
    lrs = _np_lrs()
    layout = jax_pallas.build_layout(jax.tree.map(lambda a: jnp.asarray(a[0]), grads))
    lr_vec = jnp.stack([jnp.asarray(x) for x in jax.tree.leaves(lrs)])
    lr_rows = lr_vec[jnp.asarray(layout.row_map)][:, None]
    segment = np.zeros(len(layout.leaf_rows))
    for t in range(T):
        g_buf = jax_pallas.pack(jax.tree.map(lambda a: jnp.asarray(a[t]), grads), layout)
        ct_buf = jax_pallas.pack(jax.tree.map(lambda a: jnp.asarray(a[t]), cts), layout)
        _, vjp = jax.vjp(jax_pallas._fused_sgd, g_buf, g_buf, lr_rows)
        dlr_rows = np.asarray(vjp(ct_buf)[2], np.float64)[: layout.rows, 0]
        np.add.at(segment, layout.row_map[: layout.rows], dlr_rows)
    _, dlr = fu.fused_sgd_tree_bwd_reference(
        tree_leaves(_torch(cts)), tree_leaves(_torch(grads)), tree_leaves(_torch(lrs))
    )
    for i, (c, g) in enumerate(zip(tree_leaves(cts), tree_leaves(grads))):
        prod = c.astype(np.float64) * g
        rows_bound = 127 * 2.0**-24 * float(np.abs(prod).sum())
        assert abs(float(dlr[i]) - segment[i]) <= _float32_sum_bound(prod) + rows_bound


# ---------------------------------------------------------------------------
# trees past the small table: ResNet-12 (86 leaves) and DenseNet-12 (85)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", ["resnet-12", "densenet-12"])
def test_deep_tree_records_and_twins_match_jax(net):
    """The leaf trees the large table takes (more than SMALL_TABLE_LEAVES,
    at most MAX_LEAVES): one record of five words per leaf, and the twins
    against the JAX package's fused update and its ``custom_vjp``
    (Pallas interpret mode) over the whole tree, as in the tests above."""
    from howtotrainyourmamlpytorch_tpu_torch.models.registry import build_model
    from howtotrainyourmamlpytorch_tpu_torch.utils import seeding

    params, _ = build_model(net, (28, 28, 1), 20).init(seeding.model_init_generator(0))
    shapes = tree_map(lambda t: tuple(t.shape), params)
    n = len(tree_leaves(shapes))
    assert fu.SMALL_TABLE_LEAVES < n <= fu.MAX_LEAVES
    rng = np.random.RandomState(5)
    p, g, w = (tree_map(lambda s: rng.randn(*s).astype(np.float32), shapes) for _ in range(3))
    leaves = tree_leaves(shapes)
    lr_it = iter(np.float32(0.01 + 0.002 * i) for i in range(n))
    lrs = tree_map(lambda _: next(lr_it), shapes)

    ps, gs, lr_t = tree_leaves(_torch(p)), tree_leaves(_torch(g)), tree_leaves(_torch(lrs))
    a_leaves, _, outs, records = fu._prepare(ps, gs, lr_t)
    words = list(records)
    assert len(words) == 5 * n and words[4::5] == [int(np.prod(s)) for s in leaves]

    want = jax_fused_sgd_update(*(jax.tree.map(jnp.asarray, t) for t in (p, g, lrs)))
    got = fu.fused_sgd_update(_torch(p), _torch(g), _torch(lrs))
    _assert_close_to_jax(got, want, g, lrs)

    def objective(pp, gg, ll):
        out = jax_fused_sgd_update(pp, gg, ll)
        return sum(jnp.sum(o * jnp.asarray(x)) for o, x in zip(jax.tree.leaves(out), jax.tree.leaves(w)))

    jgrads = jax.grad(objective, argnums=(1, 2))(*(jax.tree.map(jnp.asarray, t) for t in (p, g, lrs)))
    dg, dlr = fu.fused_sgd_tree_bwd_reference(tree_leaves(_torch(w)), gs, lr_t)
    for a, b in zip(dg, jax.tree.leaves(jgrads[0])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    # each side a float32 sum of the leaf's products in its own order
    for got_lr, want_lr, ct, gg in zip(dlr.numpy(), jax.tree.leaves(jgrads[1]), tree_leaves(w), tree_leaves(g)):
        prod = np.asarray(ct, np.float64) * np.asarray(gg, np.float64)
        assert abs(float(got_lr) - float(want_lr)) <= 2 * _float32_sum_bound(prod)
