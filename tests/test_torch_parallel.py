"""The port's data-parallel mesh against the JAX package's
(``tests/test_parallel.py`` without its ``mp``/``tp_convs`` cases), on the
CPU, where a mesh of 8 ``cpu`` entries stands in for JAX's 8 virtual CPU
devices.

- mesh shapes; ``pp=2`` rejected as JAX rejects it (``mp=2`` and
  ``tp_convs``: ``tests/test_torch_tensor_parallel.py``);
- the dp=8 sharded train step of the linear model against the port's
  single-device step and against JAX's dp=8 step on its 8 virtual devices
  (JAX's tolerances: loss rtol 1e-5, weights rtol 1e-5 / atol 1e-6), the
  fused update's plain twin too;
- a small VGG at dp=4 on one device against dp=1: the meta-gradient with
  one scale for all leaves (atol 1e-5 of the largest entry), the eval
  outputs, and the input state untouched (replicas on one device share
  their tensors, and no step writes into them; ``bn_state`` passes
  through);
- sharded convergence over 16 steps, as JAX's test runs it without tensor
  parallelism;
- the plan arithmetic (``requested_mesh_shape``, ``degraded_mesh_plan``,
  ``grow_mesh_plan``, ``host_shard_bounds``) equal to JAX's over a grid,
  and the cases of ``tests/test_elastic.py`` and
  ``tests/test_wedge_watchdog.py``.
"""

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu import parallel as jpar
from howtotrainyourmamlpytorch_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch import parallel as tpar
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch, synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten, tree_leaves

from .test_torch_train import IMG, N_WAY, _jnp, pair

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_virtual_devices_present():
    """JAX's 8 virtual devices, and a mesh of 8 CPU entries in the port."""
    assert len(jax.devices()) == 8
    mesh = tpar.make_mesh(tcfg.ParallelConfig(dp=-1), devices=CPU8)
    assert mesh.devices == [torch.device("cpu")] * 8 and mesh.local_dp == 8


def test_make_mesh_shapes():
    assert tpar.make_mesh(tcfg.ParallelConfig(dp=-1, mp=1), devices=CPU8).shape == {"dp": 8, "mp": 1}
    assert tpar.make_mesh(tcfg.ParallelConfig(dp=4), devices=CPU8).shape == {"dp": 4, "mp": 1}
    assert tpar.make_mesh(tcfg.ParallelConfig(dp=4), devices=CPU8).size == 4
    with pytest.raises(ValueError):
        tpar.make_mesh(tcfg.ParallelConfig(dp=16), devices=CPU8)
    with pytest.raises(ValueError):
        jpar.make_mesh(jcfg.ParallelConfig(dp=16))


def test_pp_hook_rejects_multi_stage_and_tensor_parallelism_is_refused():
    """``pp=2`` is rejected as JAX rejects it. (Tensor parallelism is no
    longer refused: ``tests/test_torch_tensor_parallel.py``.)"""
    assert tcfg.ParallelConfig().pp == 1
    for module in (tcfg, jcfg):
        with pytest.raises(ValueError, match="pipeline parallelism"):
            module.ParallelConfig(pp=2)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_train_step_matches_single_device(fused):
    """dp=8 of the linear model: the port's sharded step against its own
    single-device step and against JAX's dp=8 step, at JAX's tolerances."""
    jsys, jstate, tsys, tstate = pair("linear", fused=fused, batch_size=8)
    b = synthetic_batch(8, N_WAY, 2, 2, IMG, seed=5)
    state_a, out_a = tsys.train_step(tstate, b, epoch=0)

    mesh = tpar.make_mesh(tcfg.ParallelConfig(dp=8), devices=CPU8)
    sharded = tpar.shard_batch(b, mesh)
    assert sharded.spec == ("dp",) and len(sharded.shards) == 8 and sharded.num_tasks == 8
    state_b, out_b = tsys.train_step(tpar.replicate(tstate, mesh), sharded, epoch=0)
    assert isinstance(state_b, tpar.Replicated) and len(state_b.replicas) == 8

    jmesh = jpar.make_mesh(jcfg.ParallelConfig(dp=8))
    jb = _jnp(jax_synthetic_batch(8, N_WAY, 2, 2, IMG, seed=5))
    np.testing.assert_array_equal(np.asarray(jb["x_support"]), b["x_support"])
    jstate_b, jout_b = jsys.train_step(jpar.replicate(jstate, jmesh), jpar.shard_batch(jb, jmesh), epoch=0)

    np.testing.assert_allclose(float(out_a.loss), float(out_b.loss), rtol=1e-5)
    np.testing.assert_allclose(float(jout_b.loss), float(out_b.loss), rtol=1e-5)
    np.testing.assert_allclose(out_b.per_task_losses.numpy(), out_a.per_task_losses.numpy(), rtol=1e-5, atol=1e-6)
    w_a, w_b = state_a.params["fc"]["w"].numpy(), state_b.params["fc"]["w"].numpy()
    np.testing.assert_allclose(w_a, w_b, rtol=1e-5, atol=1e-6)
    # the JAX head is [in, out] over the NHWC flatten; the linear model's
    # image is one channel, so the port's [out, in] is its transpose
    np.testing.assert_allclose(np.asarray(jstate_b.params["fc"]["w"]).T, w_b, rtol=1e-5, atol=1e-6)
    assert int(state_b.step) == int(jstate_b.step) == 1


@pytest.fixture(scope="module")
def small_vgg():
    cfg = tcfg.Config(num_classes_per_set=3, num_samples_per_class=2, num_target_samples=2, batch_size=8,
                      number_of_training_steps_per_iter=2, number_of_evaluation_steps_per_iter=2,
                      use_pallas_inner_update=True, remat_inner_steps=False)
    system = MAMLSystem(cfg, model=build_vgg((28, 28, 1), 3, num_stages=2, cnn_num_filters=8), device="cpu")
    return system, system.init_train_state(seed=3), learnable_synthetic_batch(8, 3, 2, 2, (28, 28, 1), seed=1)


def _snapshot(state):
    return [t.clone() for t in tree_leaves({"p": state.params, "h": state.inner_hparams})]


def test_sharded_meta_gradient_of_a_vgg_matches_and_leaves_the_state_alone(small_vgg):
    """dp=4 on one device against dp=1: the meta-gradient (one scale for all
    leaves: VGG conv-bias gradients are float32 noise), the loss and the
    per-task outputs; the replicas alias the input state's tensors and none
    of them is written."""
    system, state, b = small_vgg
    before = _snapshot(state)
    loss_a, aux_a, grads_a = system.meta_gradients(state, b, epoch=0)
    mesh = tpar.make_mesh(tcfg.ParallelConfig(dp=4), devices=CPU8)
    replicated = tpar.replicate(state, mesh)
    assert all(r.params["fc"]["w"] is state.params["fc"]["w"] for r in replicated.replicas)
    loss_b, aux_b, grads_b = system.meta_gradients(replicated, tpar.shard_batch(b, mesh), epoch=0)
    np.testing.assert_allclose(float(loss_b), float(loss_a), rtol=1e-5)
    ga, gb = tree_flatten(grads_a)[0], tree_flatten(grads_b)[0]
    scale = max(float(g.abs().max()) for g in ga)
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(aux_b["target_logits"].numpy(), aux_a["target_logits"].detach().numpy(), atol=1e-5)
    new, _ = system.train_step(replicated, tpar.shard_batch(b, mesh), epoch=0)
    assert all(torch.equal(x, y) for x, y in zip(_snapshot(state), before))
    assert int(new.step) == int(state.step) + 1
    # batch norm runs on each task's own statistics: no running statistic
    # crosses a shard, and the step leaves bn_state as it was given
    assert all(x is y for x, y in zip(tree_leaves(new.bn_state), tree_leaves(state.bn_state)))


def test_sharded_eval_step_and_objective_match_single_device(small_vgg):
    system, state, b = small_vgg
    mesh = tpar.make_mesh(tcfg.ParallelConfig(dp=2), devices=CPU8)
    out_a, out_b = system.eval_step(state, b), system.eval_step(state, tpar.shard_batch(b, mesh))
    for key in ("per_task_losses", "per_task_accuracies", "per_task_target_logits"):
        np.testing.assert_allclose(getattr(out_b, key).numpy(), getattr(out_a, key).numpy(), atol=1e-5)
    np.testing.assert_allclose(float(out_b.loss), float(out_a.loss), rtol=1e-5)
    np.testing.assert_allclose(float(out_b.accuracy), float(out_a.accuracy), rtol=1e-6)
    loss_a, _ = system.meta_objective(state, b, epoch=0)
    loss_b, _ = system.meta_objective(tpar.replicate(state, mesh), tpar.shard_batch(b, mesh), epoch=0)
    np.testing.assert_allclose(float(loss_b), float(loss_a), rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.shard_batch(learnable_synthetic_batch(3, 3, 2, 2, (28, 28, 1), seed=0), mesh)


def test_sharded_convergence_matches_single_device():
    """JAX's convergence test without tensor parallelism: 4 epochs of 4
    steps at dp=4 on a 1-step, lr 0.01 inner loop (so the accuracy climb is
    the outer updates'), the same stream for both arms: the val accuracy
    climbs, in lockstep with the single-device run, and the final val
    logits agree to 1e-4."""
    n_way, k, t = 4, 2, 2
    cfg = tcfg.Config(num_classes_per_set=n_way, num_samples_per_class=k, num_target_samples=t, batch_size=4,
                      number_of_training_steps_per_iter=1, number_of_evaluation_steps_per_iter=1,
                      meta_learning_rate=0.003, total_iter_per_epoch=4, total_epochs=5,
                      multi_step_loss_num_epochs=3, inner_optim=tcfg.InnerOptimConfig(kind="sgd", lr=0.01),
                      parallel=tcfg.ParallelConfig(dp=4), remat_inner_steps=False)
    model = build_vgg(IMG, n_way, num_stages=2, cnn_num_filters=8, max_pooling=False)
    system = MAMLSystem(cfg, model=model, device="cpu")
    mesh = tpar.make_mesh(cfg.parallel, devices=CPU8)
    val = learnable_synthetic_batch(4, n_way, k, t, IMG, seed=100)

    def run(sharded: bool):
        state = system.init_train_state(seed=0)
        if sharded:
            state = tpar.shard_train_state(state, mesh)
        vb = tpar.shard_batch(val, mesh) if sharded else val
        accs, step = [float(system.eval_step(state, vb).per_task_accuracies.mean())], 0
        for epoch in range(4):
            for _ in range(4):
                batch = learnable_synthetic_batch(4, n_way, k, t, IMG, seed=step)
                state, _ = system.train_step(state, tpar.shard_batch(batch, mesh) if sharded else batch, epoch=epoch)
                step += 1
            accs.append(float(system.eval_step(state, vb).per_task_accuracies.mean()))
        return accs, system.eval_step(state, vb).per_task_target_logits.numpy()

    accs_single, logits_single = run(False)
    accs_sharded, logits_sharded = run(True)
    assert accs_sharded[-1] >= accs_sharded[0] + 0.25, accs_sharded
    np.testing.assert_allclose(accs_sharded, accs_single, atol=0.05)
    np.testing.assert_allclose(logits_sharded, logits_single, atol=1e-4)


# ---------------------------------------------------------------------------
# the plans: JAX's arithmetic
# ---------------------------------------------------------------------------

CURRENTS = [(1, 1), (2, 1), (4, 1), (2, 2), (8, 1)]
BATCHES = [1, 2, 3, 4, 6, 8, 12, 16]


@pytest.mark.parametrize("dp,mp", list(itertools.product([-1, 1, 2, 3, 4, 8, 16], [1, 2, 8])))
def test_plans_equal_jax_over_the_grid(dp, mp):
    tp, jp = tcfg.ParallelConfig(dp=dp, mp=mp), jcfg.ParallelConfig(dp=dp, mp=mp)
    for n_devices in range(1, 10):
        assert tpar.requested_mesh_shape(tp, n_devices) == jpar.requested_mesh_shape(jp, n_devices)
        for batch in BATCHES:
            assert tpar.degraded_mesh_plan(tp, n_devices, batch) == jpar.degraded_mesh_plan(jp, n_devices, batch)
            for current in CURRENTS:
                assert (tpar.grow_mesh_plan(tp, n_devices, batch, current)
                        == jpar.grow_mesh_plan(jp, n_devices, batch, current))
    for batch in BATCHES:
        for hosts in (1, 2, 3, 4):
            for index in range(hosts):
                try:
                    want = jpar.host_shard_bounds(batch, index, hosts)
                except ValueError:
                    with pytest.raises(ValueError, match="not divisible"):
                        tpar.host_shard_bounds(batch, index, hosts)
                    continue
                assert tpar.host_shard_bounds(batch, index, hosts) == want


def test_grow_mesh_plan_arithmetic():
    """``tests/test_elastic.py::test_grow_mesh_plan_arithmetic``."""
    P = tcfg.ParallelConfig
    assert tpar.grow_mesh_plan(P(dp=4), 8, 4, (1, 1)) == (4, 1)
    assert tpar.grow_mesh_plan(P(dp=4, mp=2), 8, 4, (2, 1)) == (4, 2)
    assert tpar.grow_mesh_plan(P(dp=8), 4, 8, (2, 1)) == (4, 1)
    assert tpar.grow_mesh_plan(P(dp=4), 2, 4, (2, 1)) is None
    assert tpar.grow_mesh_plan(P(dp=4), 1, 4, (1, 1)) is None
    assert tpar.grow_mesh_plan(P(dp=8), 6, 4, (2, 1)) == (4, 1)
    assert tpar.grow_mesh_plan(P(dp=2), 8, 8, (1, 1)) == (2, 1)
    assert tpar.grow_mesh_plan(P(dp=2, mp=1), 2, 2, (2, 1)) is None


def test_degraded_mesh_plan_shrinks_dp_keeps_mp_or_falls_back():
    """``tests/test_wedge_watchdog.py``'s case of the same name."""
    P = tcfg.ParallelConfig
    assert tpar.degraded_mesh_plan(P(dp=4, mp=2), 8, 8) is None
    assert tpar.degraded_mesh_plan(P(dp=-1, mp=2), 8, 8) is None
    assert tpar.degraded_mesh_plan(P(dp=4), 2, 4) == (2, 1)
    assert tpar.degraded_mesh_plan(P(dp=8), 3, 8) == (2, 1)
    assert tpar.degraded_mesh_plan(P(dp=4, mp=2), 4, 4) == (2, 2)
    assert tpar.degraded_mesh_plan(P(dp=1, mp=8), 2, 4) == (1, 1)
    assert tpar.degraded_mesh_plan(P(dp=4, mp=8), 2, 4) == (2, 1)
    assert tpar.degraded_mesh_plan(P(dp=4), 2, 3) == (1, 1)
    assert tpar.degraded_mesh_plan(P(dp=2), 1, 2) == (1, 1)


def test_replicate_places_one_copy_per_distinct_device():
    """Replicas on one device are one tree; ``on(device)`` and attribute
    reads find it; ``unreplicate`` returns it."""
    state = {"w": torch.arange(6.0).reshape(2, 3)}
    mesh = tpar.make_mesh(tcfg.ParallelConfig(dp=4), devices=CPU8)
    rep = tpar.replicate(state, mesh)
    assert len(rep.replicas) == 4 and all(r is rep.replicas[0] for r in rep.replicas)
    assert rep.on("cpu") is rep.replicas[0] is tpar.unreplicate(rep)
    assert tpar.replicate(rep, mesh).replicas[0]["w"] is state["w"]
    nt = dataclasses.make_dataclass("S", [("x", int)])(x=3)
    assert tpar.replicate(torch.ones(2), mesh).shape == (2,) and tpar.unreplicate(nt) is nt
