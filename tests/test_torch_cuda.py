"""The port's CUDA kernels on the card: the fused LSLR update (B1) and its
backward (B2) against their plain twins, and the serving slice and a train
step with the kernels against the same code on the CPU. Every test here
needs a CUDA card and skips without one. The file imports no jax, so that
it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.config import Config, PrecisionConfig, ServingConfig
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.core.train_state import TrainState
from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update as fu
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten, tree_leaves, tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 13, 8 * 892], ids=["one_row", "ragged", "vgg64_8_tasks"])
def test_kernel_equals_twin_bitwise(cuda, dtype, rows):
    gen = torch.Generator(device=cuda).manual_seed(rows)
    p = torch.randn(rows, fu.LANE, device=cuda, generator=gen).to(dtype)
    g = torch.randn(rows, fu.LANE, device=cuda, generator=gen).to(dtype)
    lr = torch.rand(rows, device=cuda, generator=gen)
    fu.reset_launch_counts()
    out = fu.fused_sgd_rows(p, g, lr)
    torch.cuda.synchronize()
    assert fu.launch_counts["fused_sgd"] == 1
    assert out.dtype == dtype and torch.equal(out, fu.fused_sgd_rows_reference(p, g, lr))


def test_wrapper_refuses_misaligned_cuda_input(cuda):
    buf = torch.zeros(2 * 4 * fu.LANE + 1, device=cuda)
    p = buf[1:].view(-1, fu.LANE)  # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        fu.fused_sgd_rows(p, p.clone(), torch.ones(p.shape[0], device=cuda))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 13, 8 * 892], ids=["one_row", "ragged", "vgg64_8_tasks"])
def test_backward_kernel_matches_twin(cuda, dtype, rows):
    """B2: ``dg`` bit for bit; ``dlr_rows`` within 2 * 128 * 2**-24 *
    sum|ct * g| per row (two f32 sums of 128 products in different orders,
    each within half that of the exact sum)."""
    gen = torch.Generator(device=cuda).manual_seed(rows + 1)
    ct = torch.randn(rows, fu.LANE, device=cuda, generator=gen).to(dtype)
    g = torch.randn(rows, fu.LANE, device=cuda, generator=gen).to(dtype)
    lr = torch.rand(rows, device=cuda, generator=gen)
    fu.reset_launch_counts()
    dg, dlr = fu.fused_sgd_rows_backward(ct, g, lr)
    torch.cuda.synchronize()
    assert fu.launch_counts["fused_sgd_bwd"] == 1
    want_dg, want_dlr = fu.fused_sgd_bwd_reference(ct, g, lr)
    assert dg.dtype == dtype and dlr.dtype == torch.float32
    assert torch.equal(dg, want_dg)
    bound = 2 * 128 * 2.0**-24 * (ct.double() * g.double()).abs().sum(1)
    assert bool(((dlr.double() - want_dlr.double()).abs() <= bound).all())


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
        number_of_training_steps_per_iter=2, use_pallas_inner_update=True,
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
