"""The port's costs (``observability/costs.py``) against hand counts and the
JAX package's ``observability/costs.py``: the flop counter's FLOPs of the
small VGG forward (exactly 2 x the multiply-adds of its convolutions and
head), the train step's count (positive, doubling with the meta-batch),
the nulls with a reason for a call that raises, the peak table and MFU with
JAX's reason strings, and the program memory's keys. The ratio of the
port's train-step FLOPs to JAX's ``jit_cost`` at one config is printed (the
counter counts no elementwise op, XLA does): run with ``-s`` to read it."""

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.observability import costs as jax_costs
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.observability import costs

from .test_torch_train import IMG, N_WAY, _configs, _jnp, _models, batch, pair

torch.set_num_threads(2)

FILTERS = 8


def _hand_flops(n: int) -> int:
    """2 x the multiply-adds of the small VGG forward on ``n`` images
    (8x8x1, 2 stages of 3x3 convs with 8 filters and 2x2 pooling, then the
    head): biases, batch norm, activations and pooling are not counted."""
    h, w = IMG[:2]
    macs = n * h * w * FILTERS * IMG[2] * 9  # stage 0 at 8x8
    macs += n * (h // 2) * (w // 2) * FILTERS * FILTERS * 9  # stage 1 at 4x4
    macs += n * FILTERS * (h // 4) * (w // 4) * N_WAY  # the head on 8 x 2 x 2 features
    return 2 * macs


def test_vgg_forward_flops_equal_the_hand_count():
    model = build_vgg(IMG, N_WAY, num_stages=2, cnn_num_filters=FILTERS)
    params, state = model.init(torch.Generator().manual_seed(0))
    x = torch.randn(6, *IMG)
    cost = costs.step_cost(lambda: model.apply(params, state, x))
    assert cost["source"] == "flop_counter" and cost["error"] is None
    assert cost["flops"] == _hand_flops(6)
    assert cost["bytes_accessed"] is None and cost["bytes_accessed_reason"] == costs.NO_BYTES_REASON


def _train_flops(batch_size: int) -> float:
    cfg = _configs(batch_size=batch_size)[1]
    system = MAMLSystem(cfg, model=_models("vgg")[1], device="cpu")
    state = system.init_train_state()
    b = learnable_synthetic_batch(batch_size, N_WAY, 2, 2, IMG, seed=0)
    return costs.step_cost(system.train_step, state, b, 0)["flops"]


def test_train_step_flops_positive_and_double_with_the_meta_batch():
    one, two = _train_flops(2), _train_flops(4)
    assert one > 0
    assert two == pytest.approx(2 * one, rel=1e-2)


def test_a_raising_call_gives_nulls_with_a_reason():
    def boom():
        raise RuntimeError("inside the step")

    cost = costs.step_cost(boom)
    assert cost["flops"] is None and cost["bytes_accessed"] is None and cost["source"] is None
    assert "RuntimeError: inside the step" in cost["error"]
    with pytest.raises(RuntimeError, match="inside the step"):
        costs.priced_call(boom)
    out, cost = costs.priced_call(lambda a, b: a @ b, torch.ones(2, 3), torch.ones(3, 4))
    assert out.shape == (2, 4) and cost["flops"] == 2 * 2 * 3 * 4


@pytest.mark.parametrize("kind, peak", [
    ("NVIDIA H100 80GB HBM3", 989.4e12),
    ("NVIDIA H100 PCIe", 756e12),
    ("cpu", None),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_table_and_mfu_with_jax_reasons(kind, peak):
    assert costs.peak_flops_per_sec(kind) == peak
    value, reason = costs.mfu(1e12, 2.0, kind)
    if peak is None:
        assert value is None
        # an unknown kind's reason is the JAX module's, word for word
        assert reason == jax_costs.mfu(1e12, 2.0, kind)[1]
    else:
        assert reason is None and value == round(2e12 / peak, 5)
    # the JAX arithmetic and reasons around a known or measured peak
    assert costs.mfu(1e12, 2.0, kind, peak=4e12) == jax_costs.mfu(1e12, 2.0, kind, peak=4e12) == (0.5, None)
    assert costs.mfu(None, 2.0, kind) == jax_costs.mfu(None, 2.0, kind)
    assert costs.mfu(1e12, 0.0, kind) == jax_costs.mfu(1e12, 0.0, kind)


def test_program_memory_keeps_the_jax_keys():
    off_card = costs.program_memory(costs.pool_bytes("cpu", (0, 1)))
    assert set(off_card) == set(jax_costs.program_memory(object()))
    assert off_card["peak_bytes"] is None and off_card["error"]
    stats = costs.program_memory(2 << 20)
    assert stats["peak_bytes"] == 2 << 20
    assert all(stats[f"{f}_bytes"] is None for f in costs.MEMORY_FIELDS) and stats["error"]


def test_train_step_flops_against_jax_cost_analysis():
    """Printed, not asserted: XLA's count includes elementwise FLOPs, the
    flop counter's does not."""
    jsys, jstate, tsys, tstate = pair("vgg")
    b = batch(seed=0)
    port = costs.step_cost(tsys.train_step, tstate, b, 0)["flops"]
    step = jsys._compiled_train_step(jsys.use_second_order(0), jsys.msl_active(0))
    ref = jax_costs.jit_cost(step, jstate, _jnp(b))["flops"]
    assert port > 0
    print(f"\nsmall VGG train step FLOPs: port (flop counter) {port:.6g}, JAX (XLA cost analysis) "
          f"{ref if ref is None else format(ref, '.6g')}, ratio {port / ref if ref else None}")
    assert np.isfinite(port)
    jax.clear_caches()
