"""The port's CUDA kernels on the card: the fused LSLR update (B1) and its
backward (B2), one launch each over a parameter tree, against their plain
twins, and the serving slice and a train step with the kernels against the
same code on the CPU. Every test here
needs a CUDA card and skips without one. The file imports no jax, so that
it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.config import Config, PrecisionConfig, ServingConfig
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem, apply_matmul_precision
from howtotrainyourmamlpytorch_tpu_torch.core.train_state import TrainState
from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch.models.registry import build_model
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
from howtotrainyourmamlpytorch_tpu_torch.utils.seeding import model_init_generator
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten, tree_leaves, tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    apply_matmul_precision("highest")  # IEEE float32 matmuls and convolutions, no TF32
    return torch.device("cuda")


# the VGG-64 tree of configs/default.yaml (18 leaves, 113,236 parameters)
_VGG64 = [s for cin in (1, 64, 64, 64) for s in ((64, cin, 3, 3), (64,), (64,), (64,))] + [(20, 64), (20,)]
# its head, the tree the fused update covers under anil (2 leaves, 1,300)
_ANIL_HEAD = [(20,), (20, 64)]


def _resnet12_shapes():
    """The ResNet-12 tree of the fleet row omniglot.20.1.resnet-12.gd (86
    leaves, 4,359,060 parameters), past the kernels' 64-leaf table."""
    params, _ = build_model("resnet-12", (28, 28, 1), 20).init(model_init_generator(0))
    return [tuple(t.shape) for t in tree_leaves(params)]


#: leaves of the synthetic tree with more than 200 small leaves
_MANY = [1 + (37 * i) % 3000 for i in range(220)]


def _tree(kind, dtype, device, seed):
    """(first operands, second operands, lrs) of a tree: one element; a
    ragged tree of 1, 3, 20, 129 and 4,097 elements (every rest length; the
    129-element leaf's operands both 4 bytes past a 16-byte boundary and
    the 4,097-element leaf's first operand alone: read element by element);
    the VGG-64 tree over 8 tasks; its anil head over 8 tasks (2 leaves,
    10,400 elements); the ResNet-12 tree over 8 tasks (86 leaves,
    34,872,480 elements); or 220 leaves of 1 to 3,000 elements."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shift = 4 // torch.empty((), dtype=dtype).element_size()

    def rand(*shape, offset=False):
        n = int(np.prod(shape))
        flat = torch.randn(n + (shift if offset else 0), device=device, generator=gen).to(dtype)
        return flat[shift if offset else 0 :].view(shape)

    if kind == "one_element":
        a, b = [rand(1)], [rand(1)]
    elif kind == "ragged":
        sizes = (1, 3, 20, 129, 4097)
        a = [rand(n, offset=n in (129, 4097)) for n in sizes]
        b = [rand(n, offset=n == 129) for n in sizes]
    elif kind == "many_220":
        a, b = [rand(n) for n in _MANY], [rand(n) for n in _MANY]
    else:
        shapes = {"vgg64_8_tasks": _VGG64, "anil_head_8_tasks": _ANIL_HEAD}.get(kind) or _resnet12_shapes()
        a, b = [rand(8, *s) for s in shapes], [rand(8, *s) for s in shapes]
    lrs = list(torch.rand(len(a), device=device, generator=gen).unbind())
    return a, b, lrs


_TREES = pytest.mark.parametrize(
    "tree", ["one_element", "ragged", "vgg64_8_tasks", "anil_head_8_tasks", "resnet12_8_tasks", "many_220"])
_DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


@_DTYPES
@_TREES
def test_kernel_equals_twin_bitwise(cuda, dtype, tree):
    """B1, one launch over the tree, bit-equal to its twin; no leaf copied
    (leaves off a 16-byte boundary read where they lie)."""
    ps, gs, lrs = _tree(tree, dtype, cuda, 1)
    fu.reset_launch_counts()
    outs = fu.FusedSGD.apply(len(ps), *ps, *gs, *lrs)
    torch.cuda.synchronize()
    assert fu.launch_counts == {"fused_sgd": 1, "fused_sgd_bwd": 0} and fu.contiguous_copies == 0
    want = fu.fused_sgd_tree_reference(ps, gs, lrs)
    assert all(out.dtype == dtype and torch.equal(out, w) for out, w in zip(outs, want))


def _dlr_bound(cts, gs):
    """Per leaf, the exact lr cotangent in float64 and B2's bound against it:
    (longest chain of roundings + 1) * 2**-24 * sum|ct * g|."""
    exact, bound = [], []
    starts = fu.chunk_starts(cts, gs)
    for i, (ct, g) in enumerate(zip(cts, gs)):
        prod = ct.double() * g.double()
        chain = fu.dlr_rounding_chain(starts[i + 1] - starts[i], ct.element_size())
        exact.append(-float(prod.sum()))
        bound.append((chain + 1) * 2.0**-24 * float(prod.abs().sum()))
    return torch.tensor(exact, dtype=torch.float64), torch.tensor(bound, dtype=torch.float64)


def test_one_launch_per_call_and_nothing_copied(cuda):
    """The Function's forward and backward on the card: one B1 and one B2
    launch, ``dp = ct`` returned as it is, and no contiguous leaf copied."""
    ps, gs, lrs = _tree("ragged", torch.float32, cuda, 3)
    ps = [p.detach().contiguous().requires_grad_(True) for p in ps]
    lrs = [lr.detach().requires_grad_(True) for lr in lrs]
    cts = [torch.randn_like(p) for p in ps]
    fu.reset_launch_counts()
    outs = fu.FusedSGD.apply(len(ps), *ps, *gs, *lrs)
    torch.autograd.backward(outs, cts)
    torch.cuda.synchronize()
    assert fu.launch_counts == {"fused_sgd": 1, "fused_sgd_bwd": 1} and fu.contiguous_copies == 0
    assert all(p.grad is ct or torch.equal(p.grad, ct) for p, ct in zip(ps, cts))


def _non_contiguous(dtype, device, seed):
    """(first operands, second operands, lrs, copies) of leaves that are not
    contiguous, as a launch may be handed them: a stride-0 expansion (the
    cotangent of a ``.sum()``), strided slices and the transpose of the last
    two dims (a batched linear layer's weight cotangent), beside contiguous
    leaves; ``copies`` of them must be copied."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: torch.randn(*shape, device=device, generator=gen).to(dtype)  # noqa: E731
    a = [rand(()).expand(8, 4097), rand(8, 258)[:, ::2], rand(2, 64, 20).transpose(1, 2), rand(1000)]
    b = [rand(8, 4097), rand(8, 129), rand(2, 20, 64), rand(2000)[::2]]
    lrs = list(torch.rand(len(a), device=device, generator=gen).unbind())
    return a, b, lrs, 4


@_DTYPES
def test_non_contiguous_leaves_are_copied_and_counted(cuda, dtype):
    """A leaf that is not contiguous is copied before the launch and counted
    in ``contiguous_copies``, once per copy, in B1 and in B2; the copies
    live until their launch is enqueued, so the results equal the twins':
    B1 and B2's ``dg`` bit for bit, ``dlr`` within its bound."""
    a, b, lrs, copies = _non_contiguous(dtype, cuda, 4)
    fu.reset_launch_counts()
    outs = fu.FusedSGD.apply(len(a), *a, *b, *lrs)
    dg, dlr = fu.fused_sgd_tree_backward(a, b, lrs)
    torch.cuda.synchronize()
    assert fu.launch_counts == {"fused_sgd": 1, "fused_sgd_bwd": 1} and fu.contiguous_copies == 2 * copies
    assert all(o.dtype == dtype and torch.equal(o, w) for o, w in zip(outs, fu.fused_sgd_tree_reference(a, b, lrs)))
    want_dg, _ = fu.fused_sgd_tree_bwd_reference(a, b, lrs)
    assert all(x.is_contiguous() and torch.equal(x, w) for x, w in zip(dg, want_dg))
    exact, bound = _dlr_bound(a, b)
    assert bool(((dlr.double().cpu() - exact).abs() <= bound).all())


def test_slice_with_kernel_matches_cpu(cuda):
    """A small engine on the card (kernel) against the same engine on the
    CPU (twin): probabilities within 1e-5 (float32 on both, TF32 off; the
    convolutions sum in another order), one launch per inner step."""
    cfg = Config(
        num_classes_per_set=3, num_samples_per_class=2, number_of_evaluation_steps_per_iter=2,
        use_pallas_inner_update=True,
        serving=ServingConfig(support_buckets=[8], query_buckets=[8], max_batch_size=4),
    )
    model = build_vgg((8, 8, 1), 3, num_stages=2, cnn_num_filters=8)
    gpu = MAMLSystem(cfg, model=model, device=cuda)
    state = gpu.init_train_state()
    cpu = MAMLSystem(cfg, model=model, device="cpu")
    cpu_state = TrainState(*(tree_map(lambda t: t.cpu(), s) for s in state[:3]), None, state.step.cpu())
    rng = np.random.RandomState(0)
    supports = [(rng.rand(s, 8, 8, 1).astype(np.float32), np.arange(s) % 3) for s in (6, 6, 3)]
    queries = [rng.rand(q, 8, 8, 1).astype(np.float32) for q in (5, 8, 3)]
    probs = {}
    fu.reset_launch_counts()
    for name, system, st in (("gpu", gpu, state), ("cpu", cpu, cpu_state)):
        engine = AdaptationEngine(system, st)
        fws = engine.adapt_batch(supports)
        probs[name] = engine.predict_batch(list(zip(fws, queries)))
    assert fu.launch_counts["fused_sgd"] == cfg.number_of_evaluation_steps_per_iter
    for a, b in zip(probs["gpu"], probs["cpu"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_bf16_inner_slice_runs_the_kernel_in_bf16(cuda):
    """Under ``precision.enabled`` the fast weights, and so the kernel's
    operands, are bf16: one launch per inner step, bf16 fast weights,
    float32 probabilities that sum to 1."""
    cfg = Config(
        num_classes_per_set=3, num_samples_per_class=2, number_of_evaluation_steps_per_iter=2,
        use_pallas_inner_update=True, precision=PrecisionConfig(enabled=True),
        serving=ServingConfig(support_buckets=[8], query_buckets=[8], max_batch_size=4),
    )
    system = MAMLSystem(cfg, model=build_vgg((8, 8, 1), 3, num_stages=2, cnn_num_filters=8), device=cuda)
    engine = AdaptationEngine(system, system.init_train_state())
    rng = np.random.RandomState(1)
    fu.reset_launch_counts()
    fws = engine.adapt_batch([(rng.rand(6, 8, 8, 1).astype(np.float32), np.arange(6) % 3)])
    probs = engine.predict(fws[0], rng.rand(5, 8, 8, 1).astype(np.float32))
    assert fu.launch_counts["fused_sgd"] == cfg.number_of_evaluation_steps_per_iter
    assert fws[0]["fc"]["w"].dtype == torch.bfloat16
    assert probs.dtype == np.float32 and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=0, atol=1e-6)


@_DTYPES
@_TREES
def test_backward_kernel_matches_twin(cuda, dtype, tree):
    """B2, one launch over the tree: ``dg`` bit for bit; ``dlr`` within the
    bound of the kernel's summation tree from a float64 sum
    (``fu.dlr_rounding_chain``), and bit-identical across two launches."""
    cts, gs, lrs = _tree(tree, dtype, cuda, 2)
    fu.reset_launch_counts()
    dg, dlr = fu.fused_sgd_tree_backward(cts, gs, lrs)
    torch.cuda.synchronize()
    assert fu.launch_counts == {"fused_sgd": 0, "fused_sgd_bwd": 1} and fu.contiguous_copies == 0
    want_dg, _ = fu.fused_sgd_tree_bwd_reference(cts, gs, lrs)
    assert all(a.dtype == dtype and torch.equal(a, b) for a, b in zip(dg, want_dg))
    assert dlr.dtype == torch.float32 and dlr.shape == (len(cts),)
    exact, bound = _dlr_bound(cts, gs)
    assert bool(((dlr.double().cpu() - exact).abs() <= bound).all())
    _, again = fu.fused_sgd_tree_backward(cts, gs, lrs)
    assert torch.equal(dlr, again)


def test_train_step_with_kernels_matches_cpu(cuda):
    """One second-order train step (MSL on) of a small VGG on the card (B1
    forward, B2 in the backward, one launch each per inner step) against
    the same step on the CPU (the twins): float32 on both, TF32 off, sums
    in other orders. At this size the meta-gradient is well conditioned:
    loss within 1e-5 relative, meta-gradients within 1e-4 of the largest
    element of any leaf, updated params (but the conv biases) within
    1e-5."""
    cfg = Config(
        num_classes_per_set=3, num_samples_per_class=2, num_target_samples=2, batch_size=2,
        number_of_training_steps_per_iter=2, use_pallas_inner_update=True, remat_inner_steps=False,
    )
    model = build_vgg((8, 8, 1), 3, num_stages=2, cnn_num_filters=8)
    gpu = MAMLSystem(cfg, model=model, device=cuda)
    cpu = MAMLSystem(cfg, model=model, device="cpu")
    state = gpu.init_train_state()
    to_cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    cpu_state = TrainState(to_cpu(state.params), to_cpu(state.bn_state), to_cpu(state.inner_hparams),
                           cpu.init_train_state().opt_state, state.step.cpu())
    batch = learnable_synthetic_batch(2, 3, 2, 2, (8, 8, 1), seed=0)
    fu.reset_launch_counts()
    loss, _, grads = gpu.meta_gradients(state, batch, epoch=0)
    new, out = gpu.train_step(state, batch, epoch=0)
    torch.cuda.synchronize()
    K = cfg.number_of_training_steps_per_iter
    assert fu.launch_counts == {"fused_sgd": 2 * K, "fused_sgd_bwd": 2 * K}
    cpu_loss, _, cpu_grads = cpu.meta_gradients(cpu_state, batch, epoch=0)
    cpu_new, cpu_out = cpu.train_step(cpu_state, batch, epoch=0)
    assert abs(float(loss) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss))
    # one scale for all: the conv biases' grads are exactly zero in exact
    # arithmetic (each BN removes its channel's mean), float32 noise here
    scale = max(float(b.abs().max()) for b in tree_leaves(cpu_grads))
    for a, b in zip(tree_leaves(grads), tree_leaves(cpu_grads)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-4 * scale)
    # Adam's first step is g / (|g| + 1e-8): for those noise grads it is
    # noise of the size of the meta lr, so the conv biases are left out
    got, paths = tree_flatten(new.params)
    for path, a, b in zip(paths, got, tree_leaves(cpu_new.params)):
        if path[-2:] != ("conv", "b"):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(out.loss), float(cpu_out.loss), rtol=1e-5)


def test_sharded_train_step_on_one_card_matches_dp1(cuda):
    """A dp=2 mesh of ``[cuda:0, cuda:0]`` (the data-parallel code path on
    one card): the meta-gradient against dp=1 on the same card (one scale,
    1e-4 of the largest element, as against the CPU above; cuDNN
    deterministic), B1 and B2 launched 2 x K times per step, and the step's
    new state replicated on both entries."""
    from howtotrainyourmamlpytorch_tpu_torch.config import ParallelConfig
    from howtotrainyourmamlpytorch_tpu_torch.parallel import make_mesh, replicate, shard_batch

    cfg = Config(
        num_classes_per_set=3, num_samples_per_class=2, num_target_samples=2, batch_size=4,
        number_of_training_steps_per_iter=2, use_pallas_inner_update=True, remat_inner_steps=False,
    )
    system = MAMLSystem(cfg, model=build_vgg((8, 8, 1), 3, num_stages=2, cnn_num_filters=8), device=cuda)
    state = system.init_train_state()
    batch = learnable_synthetic_batch(4, 3, 2, 2, (8, 8, 1), seed=0)
    card = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(ParallelConfig(dp=2), [card, card])
    torch.backends.cudnn.deterministic = True
    try:
        loss1, _, g1 = system.meta_gradients(state, batch, epoch=0)
        fu.reset_launch_counts()
        loss2, _, g2 = system.meta_gradients(replicate(state, mesh), shard_batch(batch, mesh), epoch=0)
        new, out = system.train_step(replicate(state, mesh), shard_batch(batch, mesh), epoch=0)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    K = cfg.number_of_training_steps_per_iter
    assert fu.launch_counts == {"fused_sgd": 2 * 2 * K, "fused_sgd_bwd": 2 * 2 * K}
    assert abs(float(loss2) - float(loss1)) <= 1e-5 * abs(float(loss1))
    scale = max(float(g.abs().max()) for g in tree_leaves(g1))
    for a, b in zip(tree_leaves(g2), tree_leaves(g1)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0, atol=1e-4 * scale)
    assert len(new.replicas) == 2 and new.replicas[0] is new.replicas[1] and int(new.step) == 1
    assert out.per_task_losses.shape == (4,)


def test_wrapper_refuses_more_leaves_than_the_largest_table(cuda):
    """Above MAX_LEAVES the wrapper raises before any launch; at it, one
    launch of the large table."""
    for n, ok in ((fu.MAX_LEAVES, True), (fu.MAX_LEAVES + 1, False)):
        ps = [torch.randn(3, device=cuda) for _ in range(n)]
        gs = [torch.randn(3, device=cuda) for _ in range(n)]
        lrs = list(torch.rand(n, device=cuda).unbind())
        fu.reset_launch_counts()
        if ok:
            outs = fu.FusedSGD.apply(n, *ps, *gs, *lrs)
            torch.cuda.synchronize()
            assert all(torch.equal(o, r) for o, r in zip(outs, fu.fused_sgd_tree_reference(ps, gs, lrs)))
        else:
            with pytest.raises(ValueError, match="largest table"):
                fu.FusedSGD.apply(n, *ps, *gs, *lrs)
        assert fu.launch_counts == {"fused_sgd": int(ok), "fused_sgd_bwd": 0}


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
def test_remat_train_step_matches_no_remat_and_relaunches_b1(cuda, policy):
    """A second-order meta-gradient of a small ResNet (resnet-4, 16x16x1,
    3-way 2-shot, K=2) under remat against the same without it, both on the card with cuDNN deterministic: the loss equal,
    the meta-gradient within 1e-5 of its largest element; B1 launches twice
    per inner step under remat (the recompute), B2 once."""
    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for pol in ("none", policy):
            cfg = Config(
                num_classes_per_set=3, num_samples_per_class=2, num_target_samples=2, batch_size=2,
                number_of_training_steps_per_iter=2, use_pallas_inner_update=True, remat_policy=pol,
            )
            system = MAMLSystem(cfg, model=build_model("resnet-4", (16, 16, 1), 3), device=cuda)
            state = system.init_train_state()
            fu.reset_launch_counts()
            loss, _, grads = system.meta_gradients(state, learnable_synthetic_batch(2, 3, 2, 2, (16, 16, 1), seed=0), 0)
            torch.cuda.synchronize()
            out[pol] = (loss, grads, dict(fu.launch_counts))
    finally:
        torch.backends.cudnn.deterministic = False
    K = 2
    assert out["none"][2] == {"fused_sgd": K, "fused_sgd_bwd": K}
    assert out[policy][2] == {"fused_sgd": 2 * K, "fused_sgd_bwd": K}
    assert torch.equal(out["none"][0], out[policy][0])
    scale = max(float(g.abs().max()) for g in tree_leaves(out["none"][1]))
    for a, b in zip(tree_leaves(out[policy][1]), tree_leaves(out["none"][1])):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("policy", ["none", "full"])
def test_anil_train_step_runs_the_kernels_over_the_head(cuda, policy):
    """A second-order anil meta-gradient (MSL on) of a small VGG on the card
    against the same on the CPU: B1 K launches per step (2 K under remat
    ``full``, the recompute) and B2 K, over the head's 2 leaves; the loss
    within 1e-5 relative and the meta-gradient of head and body within
    1e-4 of its largest element (as the maml++ step above)."""
    cfg = Config(
        num_classes_per_set=3, num_samples_per_class=2, num_target_samples=2, batch_size=2, strategy="anil",
        number_of_training_steps_per_iter=2, use_pallas_inner_update=True, remat_policy=policy,
    )
    model = build_vgg((8, 8, 1), 3, num_stages=2, cnn_num_filters=8)
    gpu = MAMLSystem(cfg, model=model, device=cuda)
    cpu = MAMLSystem(cfg, model=model, device="cpu")
    state = gpu.init_train_state()
    cpu_state = TrainState(*(tree_map(lambda t: t.cpu(), s) for s in state[:3]), None, state.step.cpu())
    batch = learnable_synthetic_batch(2, 3, 2, 2, (8, 8, 1), seed=0)
    seen = []
    launch = fu._launch_forward
    fu._launch_forward = lambda ps, gs, lrs: seen.append(len(ps)) or launch(ps, gs, lrs)
    try:
        fu.reset_launch_counts()
        loss, _, grads = gpu.meta_gradients(state, batch, epoch=0)
        torch.cuda.synchronize()
    finally:
        fu._launch_forward = launch
    K = cfg.number_of_training_steps_per_iter
    assert fu.launch_counts == {"fused_sgd": (1 if policy == "none" else 2) * K, "fused_sgd_bwd": K}
    assert set(seen) == {2}
    cpu_loss, _, cpu_grads = cpu.meta_gradients(cpu_state, batch, epoch=0)
    assert abs(float(loss) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss))
    scale = max(float(b.abs().max()) for b in tree_leaves(cpu_grads))
    for a, b in zip(tree_leaves(grads), tree_leaves(cpu_grads)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-4 * scale)
    assert float(grads["params"]["stage_0"]["conv"]["w"].abs().max()) > 0


def test_every_strategy_serves_on_the_card_as_on_the_cpu(cuda):
    """The engine serving maml++, fomaml, anil and protonet on the card
    against the same engine on the CPU: probabilities within 1e-5; one B1
    launch per inner step of every adapt and refine flush (none for
    protonet)."""
    cfg = Config(
        num_classes_per_set=3, num_samples_per_class=2, number_of_evaluation_steps_per_iter=2,
        use_pallas_inner_update=True,
        serving=ServingConfig(support_buckets=[8], query_buckets=[8], max_batch_size=4,
                              strategies=["maml++", "fomaml", "anil", "protonet"]),
    )
    model = build_vgg((8, 8, 1), 3, num_stages=2, cnn_num_filters=8)
    gpu = MAMLSystem(cfg, model=model, device=cuda)
    state = gpu.init_train_state()
    cpu = MAMLSystem(cfg, model=model, device="cpu")
    cpu_state = TrainState(*(tree_map(lambda t: t.cpu(), s) for s in state[:3]), None, state.step.cpu())
    rng = np.random.RandomState(2)
    supports = [(rng.rand(s, 8, 8, 1).astype(np.float32), np.arange(s) % 3) for s in (6, 6, 3)]
    queries = [rng.rand(q, 8, 8, 1).astype(np.float32) for q in (5, 8, 3)]
    steps = cfg.number_of_evaluation_steps_per_iter
    for strategy in cfg.serving.strategies:
        probs = {}
        for name, system, st in (("gpu", gpu, state), ("cpu", cpu, cpu_state)):
            engine = AdaptationEngine(system, st)
            fu.reset_launch_counts()
            fws = engine.adapt_batch(supports, strategy=strategy)
            if strategy != "protonet":
                fws = engine.refine_batch([(fw, x, y) for fw, (x, y) in zip(fws, supports)], strategy=strategy)
            probs[name] = engine.predict_batch(list(zip(fws, queries)), strategy=strategy)
            if name == "gpu":
                assert fu.launch_counts["fused_sgd"] == (0 if strategy == "protonet" else 2 * steps), strategy
        for a, b in zip(probs["gpu"], probs["cpu"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_serving_frontend_on_the_card_matches_the_cpu(cuda):
    """``ServingFrontend`` on the card against the same frontend on the
    CPU, at a small size with 5 inner steps: 3 adapts sent at once from 3
    threads (the batcher's worker threads launch B1 on the card), a cache
    hit, predictions within 1e-5, one refine; B1 launched 5 times per adapt
    and refine flush, none for the cache hit."""
    import threading

    from howtotrainyourmamlpytorch_tpu_torch.serving import ServingFrontend

    cfg = Config(
        num_classes_per_set=3, num_samples_per_class=2, number_of_evaluation_steps_per_iter=5,
        use_pallas_inner_update=True,
        serving=ServingConfig(support_buckets=[8], query_buckets=[8], max_batch_size=4, refine_enabled=True,
                              refine_regress_tol=100.0),
    )
    model = build_vgg((8, 8, 1), 3, num_stages=2, cnn_num_filters=8)
    gpu = MAMLSystem(cfg, model=model, device=cuda)
    state = gpu.init_train_state()
    cpu = MAMLSystem(cfg, model=model, device="cpu")
    cpu_state = TrainState(*(tree_map(lambda t: t.cpu(), s) for s in state[:3]), None, state.step.cpu())
    rng = np.random.RandomState(3)
    supports = [(rng.rand(6, 8, 8, 1).astype(np.float32), np.arange(6) % 3) for _ in range(3)]
    queries = [rng.rand(5, 8, 8, 1).astype(np.float32) for _ in range(3)]
    probs, ids = {}, {}
    for name, system, st in (("gpu", gpu, state), ("cpu", cpu, cpu_state)):
        frontend = ServingFrontend(AdaptationEngine(system, st))
        try:
            fu.reset_launch_counts()
            out = [None] * 3
            threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, frontend.adapt(*supports[i])))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            ids[name] = [o["adaptation_id"] for o in out]
            before = fu.launch_counts["fused_sgd"]
            assert frontend.adapt(*supports[0])["cached"]
            assert fu.launch_counts["fused_sgd"] == before
            frontend.refine(ids[name][0], *supports[0])
            probs[name] = [frontend.predict(i, q) for i, q in zip(ids[name], queries)]
            metrics = frontend.metrics()
            flushes = metrics["adapt_batcher"]["flushes"] + metrics["refine_batcher"]["flushes"]
            launches = metrics["compiled"]["fused_sgd_launches"]
            assert launches == (5 * flushes if name == "gpu" else 0), (launches, flushes)
            assert frontend.healthz()["platform"] == ("cuda" if name == "gpu" else "cpu")
        finally:
            frontend.close()
    assert ids["gpu"] == ids["cpu"]
    for a, b in zip(probs["gpu"], probs["cpu"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_tenant_page_in_from_pinned_memory_and_eviction_frees_it(cuda, tmp_path):
    """Multi-tenant serving on the card: the registry's host masters are
    pinned, a page-in lands on the card (B1 launched over the tenant's
    paged parameters, the answer within 1e-5 of the same tenant on the
    CPU), and an eviction lowers ``memory_allocated`` by the master's
    bytes as the caching allocator rounds them (512-byte blocks), so the
    watermark's headroom recovers."""
    from howtotrainyourmamlpytorch_tpu_torch.observability.memory import MemoryWatermarks
    from howtotrainyourmamlpytorch_tpu_torch.serving.registry import synthetic_registry
    from howtotrainyourmamlpytorch_tpu_torch.serving.tenancy import master_bytes

    cfg = Config(num_classes_per_set=3, num_samples_per_class=2, number_of_evaluation_steps_per_iter=5,
                 use_pallas_inner_update=True,
                 serving=ServingConfig(support_buckets=[8], query_buckets=[8], max_batch_size=4))
    model = build_vgg((8, 8, 1), 3, num_stages=2, cnn_num_filters=8)
    gpu = MAMLSystem(cfg, model=model, device=cuda)
    state = gpu.init_train_state()
    registry = synthetic_registry(["acme"], state, str(tmp_path), feature_shape=model.feature_shape)
    engine = AdaptationEngine(gpu, state, registry=registry)
    host, _ = registry.host_state("acme")
    assert all(leaf.is_pinned() for leaf in tree_leaves(host.params))
    rng = np.random.RandomState(4)
    x, y = rng.rand(6, 8, 8, 1).astype(np.float32), np.arange(6) % 3
    q = rng.rand(5, 8, 8, 1).astype(np.float32)
    fu.reset_launch_counts()
    probs = engine.predict(engine.adapt(x, y, tenant="acme"), q, tenant="acme")
    assert fu.launch_counts["fused_sgd"] == 5
    paged = engine.pager.resident("acme")
    assert all(leaf.device.type == "cuda" for leaf in tree_leaves(paged.params))
    cpu = AdaptationEngine(MAMLSystem(cfg, model=model, device="cpu"), ckpt_state(tmp_path / "acme"))
    np.testing.assert_allclose(probs, cpu.predict(cpu.adapt(x, y), q), rtol=0, atol=1e-5)
    stats = engine.pager.stats()
    assert stats["page_ins"] == 1 and stats["resident_bytes"] == master_bytes(paged) and stats["page_in_p50_ms"] > 0
    rounded = sum(-(-leaf.numel() * leaf.element_size() // 512) * 512
                  for tree in (paged.params, paged.bn_state, paged.inner_hparams) for leaf in tree_leaves(tree))
    del paged
    torch.cuda.synchronize()
    watermarks = MemoryWatermarks()
    before, headroom = torch.cuda.memory_allocated(), watermarks.snapshot()["headroom_frac_min"]
    assert engine.pager.evict("acme")
    drop = before - torch.cuda.memory_allocated()
    assert master_bytes(host) <= drop == rounded
    assert watermarks.snapshot()["headroom_frac_min"] > headroom


def ckpt_state(run_dir):
    """The tenant checkpoint under ``run_dir`` as the engine reads it."""
    from howtotrainyourmamlpytorch_tpu_torch.experiment.checkpoint import load_for_inference

    return load_for_inference(str(run_dir / "saved_models"), "latest")[0]


def _vgg_chunk_system(cuda, k=3):
    cfg = Config(
        num_classes_per_set=3, num_samples_per_class=2, num_target_samples=2, batch_size=2,
        number_of_training_steps_per_iter=2, use_pallas_inner_update=True, remat_inner_steps=False,
    )
    system = MAMLSystem(cfg, model=build_vgg((8, 8, 1), 3, num_stages=2, cnn_num_filters=8), device=cuda)
    batches = [learnable_synthetic_batch(2, 3, 2, 2, (8, 8, 1), seed=i) for i in range(k)]
    return system, batches, {key: np.stack([b[key] for b in batches]) for key in batches[0]}


def test_graph_chunk_matches_eager_steps(cuda):
    """A chunk of 3 train steps replayed from a CUDA graph of the step (B1
    and B2 captured inside it) against the 3 eager steps from the same
    state, under the deterministic algorithms: bit-equal losses and
    params. The returned state is the graph's own, updated in place."""
    from howtotrainyourmamlpytorch_tpu_torch.core.programs import clone_tree
    from howtotrainyourmamlpytorch_tpu_torch.utils.seeding import deterministic_algorithms

    with deterministic_algorithms():
        system, batches, stacked = _vgg_chunk_system(cuda)
        start = system.init_train_state()
        eager, losses = start, []
        for b in batches:
            eager, out = system.train_step(eager, b, epoch=0)
            losses.append(out.loss)
        graph, (graph_losses, _, _) = system.train_step_multi(clone_tree(start), stacked, 0)
        again, _ = system.train_step_multi(clone_tree(start), stacked, 0)
        assert again is graph  # the static buffers, written in place
        torch.cuda.synchronize()
        assert torch.equal(torch.stack(losses), graph_losses)
        for a, b in zip(tree_leaves(eager.params), tree_leaves(graph.params)):
            assert torch.equal(a, b)
        assert int(graph.step) == 3


def test_b1_and_b2_run_inside_one_replay(cuda):
    """The profiler sees B1 and B2 launched by a graph replay, and the
    wrappers' counts gain the tally the graph's capture recorded (no Python
    wrapper runs in a replay)."""
    from torch.profiler import ProfilerActivity, profile

    system, _, stacked = _vgg_chunk_system(cuda, k=1)
    state = system.init_train_state()
    system.train_step_multi(state, stacked, 0)  # captures
    fu.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        system.train_step_multi(state, stacked, 0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    b2 = sum(e.count for e in kernels if "fused_sgd_bwd" in e.key)
    b1 = sum(e.count for e in kernels if "fused_sgd" in e.key) - b2
    assert b1 == 2 and b2 == 2, [e.key for e in kernels][:20]
    assert fu.launch_counts == fu.replayed_counts == {"fused_sgd": 2, "fused_sgd_bwd": 2}
