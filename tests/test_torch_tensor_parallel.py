"""Tensor parallelism in the port (``parallel.mp > 1``, ``parallel.tp_convs``)
against the JAX package's (``tests/test_parallel.py``'s TP cases and
``parallel/mesh.py``: ``_param_spec``, ``train_state_shardings``), on the
CPU, where a mesh of ``cpu`` entries stands in for JAX's 8 virtual devices.

- ``param_spec`` equals JAX's ``_param_spec`` over a grid of shapes, names,
  ``mp`` and ``tp_convs``, read on the port's layout (a dense ``[out, in]``,
  a conv OIHW: JAX's split axis is the port's dim 0);
- the placement of a VGG, ResNet-12 and DenseNet-8 state equals
  ``train_state_shardings`` leaf by leaf, and the placed entries hold the
  blocks it names;
- the second-order meta-gradient of the small strided VGG of
  ``tests/test_parallel.py`` at dp=4 x mp=2 on ``[cpu]*8`` (with
  ``tp_convs``, and without: the head alone split) against JAX's
  single-device meta-gradient at that test's tolerance (rtol 1e-3, atol
  1e-5 of the largest entry), a conv block holding half the output
  channels, the new state keeping its placement; the fused update launched
  dp x mp x K times (B1, the twin on the CPU) in a train and an eval step;
- the convergence test of ``tests/test_parallel.py`` with the port's TP arm
  against the port's and JAX's single-device arms;
- the runner at dp=2 x mp=2 with ``tp_convs``: a format-3 ``latest`` of 4
  shards whose files are the JAX package's ``_sharded_serialize`` of the
  state JAX reads from them, resumed degraded on 2 entries ([1, 2]) and on
  one ([1, 1]), and grown back at an epoch boundary;
- two gloo processes at dp=2 x mp=2 against one process.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from howtotrainyourmamlpytorch_tpu import config as jcfg
from howtotrainyourmamlpytorch_tpu import parallel as jpar
from howtotrainyourmamlpytorch_tpu.core import MAMLSystem as JaxMAMLSystem
from howtotrainyourmamlpytorch_tpu.experiment import checkpoint as jax_ckpt
from howtotrainyourmamlpytorch_tpu.models import build_vgg as jax_build_vgg
from howtotrainyourmamlpytorch_tpu.parallel.mesh import _param_spec, train_state_shardings
from howtotrainyourmamlpytorch_tpu.resilience import campaign as jax_campaign
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch import parallel as tpar
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update
from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import shard_blocks, shard_index
from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import campaign_config, tiny_system
from howtotrainyourmamlpytorch_tpu_torch.utils.interop import trainables_to_jax

from .test_torch_runner import THREADS, _env, toy_dataset  # noqa: F401
from .test_torch_train import _configs, _jnp, jax_meta_gradients, port_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
TINY = (8, 8, 1)
N_WAY = 4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _whole(tree):
    """A row's tree with each split leaf (a dict of blocks) concatenated."""
    if isinstance(tree, dict):
        if tree and all(shard_index(k) is not None for k in tree):
            return torch.cat([b.detach() for b in shard_blocks(tree)])
        return {k: _whole(v) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# the placement: JAX's rule, JAX's shardings
# ---------------------------------------------------------------------------


def _port_layout(jax_spec, rank):
    """A JAX spec of a leaf in JAX's layout as the port's: the split axis is
    dim 0 for a dense and a conv kernel alike."""
    return ("mp",) + (None,) * (rank - 1) if "mp" in tuple(jax_spec) else ()


@pytest.mark.parametrize("mp", [1, 2, 3, 4, 8])
def test_param_spec_equals_jax_over_a_grid(mp):
    dense = [(16, 8), (8, 16), (7, 16), (16, 7), (4, 2), (2, 4), (1, 1), (64, 20), (20, 64)]
    convs = [(3, 3, 4, 8), (3, 3, 8, 4), (1, 1, 64, 128), (3, 3, 1, 6), (3, 3, 6, 1), (1, 1, 3, 2)]
    for name in ("w", "b", "embedding", "table", "scale", None):
        for tp_convs in (False, True):
            for shape in dense:
                want = _port_layout(_param_spec(shape, mp, tp_convs, leaf_name=name), 2)
                assert tpar.param_spec(shape[::-1], mp, tp_convs, name) == want, (shape, name, mp, tp_convs)
            for shape in convs:  # HWIO -> OIHW
                h, w, i, o = shape
                want = _port_layout(_param_spec(shape, mp, tp_convs, leaf_name=name), 4)
                assert tpar.param_spec((o, i, h, w), mp, tp_convs, name) == want, (shape, name, mp, tp_convs)
            for shape in [(8,), (16,), ()]:
                assert tpar.param_spec(shape, mp, tp_convs, name) == ()


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise AssertionError(k)


def _jax_specs(shardings):
    flat = jax.tree_util.tree_flatten_with_path(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {tuple(_key(k) for k in path): tuple(sh.spec) for path, sh in flat}


def _is_spec(node):
    return isinstance(node, tuple) and not hasattr(node, "_fields") and all(
        isinstance(x, str) or x is None for x in node)


def _port_specs(tree, prefix=()):
    if _is_spec(tree):
        return {prefix: tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:
        items = list(enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_port_specs(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("net", ["vgg", "resnet-12", "densenet-8"])
@pytest.mark.parametrize("tp_convs", [False, True])
def test_placement_equals_train_state_shardings(net, tp_convs):
    kw = dict(net=net, num_classes_per_set=4, batch_size=4)
    jsys = JaxMAMLSystem(jcfg.Config(**kw))
    jstate = jsys.init_train_state()
    want = _jax_specs(train_state_shardings(jstate, jpar.make_mesh(jcfg.ParallelConfig(dp=4, mp=2)), tp_convs))
    system = MAMLSystem(tcfg.Config(**kw), device="cpu")
    state = system.init_train_state(seed=0)
    mesh = tpar.make_mesh(tcfg.ParallelConfig(dp=4, mp=2, tp_convs=tp_convs), CPU8)
    placed = tpar.shard_train_state(state, mesh, tp_convs=tp_convs)
    got = _port_specs(tpar.placement(placed))
    assert set(got) == set(want)
    shapes = {path: leaf for path, leaf in _port_specs_leaves(state).items()}
    for path, spec in want.items():
        assert got[path] == _port_layout(spec, len(shapes[path].shape)), path
    split = [p for p, s in got.items() if s]
    assert split and (any(len(shapes[p].shape) == 4 for p in split) == tp_convs)
    # every entry holds block j of a split leaf and the whole of the others
    for k, replica in enumerate(placed.replicas):
        mine = _port_specs_leaves(replica)
        for path, leaf in shapes.items():
            if got[path]:
                n = leaf.shape[0] // 2
                assert torch.equal(mine[path], leaf[(k % 2) * n:(k % 2 + 1) * n])
            else:
                assert mine[path] is leaf
    for path, leaf in _port_specs_leaves(tpar.unreplicate(placed)).items():
        assert torch.equal(leaf, shapes[path])


def _port_specs_leaves(tree, prefix=()):
    if torch.is_tensor(tree):
        return {prefix: tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:
        items = list(enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_port_specs_leaves(v, prefix + (k,)))
    return out


# ---------------------------------------------------------------------------
# the sharded meta-gradient against JAX's single-device one
# ---------------------------------------------------------------------------


def _tp_pair(tp_convs, fused=False, **overrides):
    """JAX's single-device system on the small strided VGG of
    ``tests/test_parallel.py`` (its lax.scan program without remat), and
    the port's on a dp=4 x mp=2 config, with the same weights."""
    jc, tc = _configs(num_classes_per_set=N_WAY, batch_size=4, unroll_inner_steps=False, use_pallas_inner_update=fused,
                      **overrides)
    jsys = JaxMAMLSystem(jc, model=jax_build_vgg(TINY, N_WAY, num_stages=2, cnn_num_filters=8, max_pooling=False))
    jstate = jsys.init_train_state()
    tc = dataclasses.replace(tc, parallel=tcfg.ParallelConfig(dp=4, mp=2, tp_convs=tp_convs))
    tsys = MAMLSystem(tc, model=build_vgg(TINY, N_WAY, num_stages=2, cnn_num_filters=8, max_pooling=False),
                      device="cpu")
    return jsys, jstate, tsys, port_state(jstate, tsys)


@pytest.mark.parametrize("tp_convs", [True, False])
def test_tp_meta_gradient_matches_jax_single_device(tp_convs):
    jsys, jstate, tsys, tstate = _tp_pair(tp_convs)
    b = learnable_synthetic_batch(4, N_WAY, 2, 2, TINY, seed=7)
    jloss, _, jgrads = jax_meta_gradients(jsys, jstate, b, 0)
    mesh = tpar.make_mesh(tsys.cfg.parallel, CPU8)
    placed = tpar.shard_train_state(tstate, mesh, tp_convs=tp_convs)
    conv_w = placed.replicas[1].params["stage_0"]["conv"]["w"]
    assert conv_w.shape[0] == (4 if tp_convs else 8)
    assert placed.replicas[1].params["fc"]["w"].shape[0] == N_WAY // 2
    loss, _, grads = tsys.meta_gradients(placed, tpar.shard_batch(b, mesh), epoch=0)
    # the meta-gradient of a split leaf stays split: a dict of its blocks
    assert isinstance(grads["params"]["fc"]["w"], dict) and len(grads["params"]["fc"]["w"]) == 2
    assert isinstance(grads["params"]["stage_0"]["conv"]["w"], dict) == tp_convs
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    flat_a = [np.asarray(x) for x in jax.tree.leaves(jgrads)]
    flat_b = [np.asarray(x) for x in jax.tree.leaves(trainables_to_jax(_whole(grads), tsys.model.feature_shape))]
    g_scale = max(float(np.max(np.abs(a))) for a in flat_a)
    assert len(flat_a) == len(flat_b)
    for a, g in zip(flat_a, flat_b):
        np.testing.assert_allclose(g, a, rtol=1e-3, atol=1e-5 * g_scale)
    # the step keeps the placement it came in with
    new, out = tsys.train_step(placed, tpar.shard_batch(b, mesh), epoch=0)
    assert np.isfinite(float(out.loss)) and new.specs == placed.specs and int(new.step) == 1
    assert new.replicas[3].params["stage_0"]["conv"]["w"].shape == conv_w.shape


def test_tp_step_launches_the_update_per_mesh_entry():
    """The fused update (B1; its twin here) launches dp x mp x K times in a
    train step, one launch per mesh entry per inner step, each over one
    entry's leaves (entry 0 also takes the replicated ones), and the eval
    step likewise; the step's loss is the unsharded fused step's."""
    _, _, tsys, tstate = _tp_pair(True, fused=True)
    b = learnable_synthetic_batch(4, N_WAY, 2, 2, TINY, seed=3)
    mesh = tpar.make_mesh(tsys.cfg.parallel, CPU8)
    groups = []
    real = fused_update.FusedSGD.apply

    def counting(n, *leaves):
        groups.append(n)
        assert len({t.device for t in leaves}) == 1
        return real(n, *leaves)

    K = tsys.cfg.number_of_training_steps_per_iter
    fused_update.FusedSGD.apply = counting
    try:
        _, out_single = tsys.train_step(tstate, b, epoch=0)
        assert groups == [10] * K
        groups.clear()
        new, out = tsys.train_step(tpar.shard_train_state(tstate, mesh), tpar.shard_batch(b, mesh), epoch=0)
        # 4 rows x 2 entries x K: 3 split leaves' blocks, entry 0 also the
        # 7 replicated leaves
        assert len(groups) == 4 * 2 * K and sorted(set(groups)) == [3, 10]
        groups.clear()
        tsys.eval_step(new, tpar.shard_batch(b, mesh))
        assert len(groups) == 4 * 2 * tsys.cfg.number_of_evaluation_steps_per_iter
    finally:
        fused_update.FusedSGD.apply = real
    np.testing.assert_allclose(float(out.loss), float(out_single.loss), rtol=1e-5)
    assert fused_update.launch_groups([("fc", "b"), ("fc", "w", "mp1"), ("fc", "w", "mp0")]) == [[0, 2], [1]]


def test_tp_convergence_matches_single_device_and_jax():
    """``tests/test_parallel.py::test_sharded_convergence_matches_single_device``
    with the port's dp=4 x mp=2 ``tp_convs`` arm against the port's and
    JAX's single-device arms on the same stream: the val accuracy climbs,
    in lockstep (atol 0.05), the final val logits within 1e-4 of the port's
    single-device arm (JAX's tolerance) and within 1e-3 of JAX's (two
    packages' float32 programs after 16 Adam steps), the state split all
    along."""
    n_way, k, t = 4, 2, 2
    kw = dict(num_classes_per_set=n_way, num_samples_per_class=k, num_target_samples=t, batch_size=4,
              number_of_training_steps_per_iter=1, number_of_evaluation_steps_per_iter=1, meta_learning_rate=0.003,
              total_iter_per_epoch=4, total_epochs=5, multi_step_loss_num_epochs=3, remat_inner_steps=False,
              unroll_inner_steps=False)
    tc = tcfg.Config(**kw, inner_optim=tcfg.InnerOptimConfig(kind="sgd", lr=0.01),
                     parallel=tcfg.ParallelConfig(dp=4, mp=2, tp_convs=True))
    jc = jcfg.Config(**kw, inner_optim=jcfg.InnerOptimConfig(kind="sgd", lr=0.01))
    system = MAMLSystem(tc, model=build_vgg(TINY, n_way, num_stages=2, cnn_num_filters=8, max_pooling=False),
                        device="cpu")
    jsys = JaxMAMLSystem(jc, model=jax_build_vgg(TINY, n_way, num_stages=2, cnn_num_filters=8, max_pooling=False))
    jstate0 = jsys.init_train_state()
    mesh = tpar.make_mesh(tc.parallel, CPU8)
    val = learnable_synthetic_batch(4, n_way, k, t, TINY, seed=100)

    def run(arm):
        if arm == "jax":
            state, ev = jstate0, (lambda st: jsys.eval_step(st, _jnp(val)))
            step = lambda st, b, e: jsys.train_step(st, _jnp(b), epoch=e)  # noqa: E731
        else:
            state = port_state(jstate0, system)
            if arm == "tp":
                state = tpar.shard_train_state(state, mesh)
            feed = (lambda b: tpar.shard_batch(b, mesh)) if arm == "tp" else (lambda b: b)
            ev = lambda st: system.eval_step(st, feed(val))  # noqa: E731
            step = lambda st, b, e: system.train_step(st, feed(b), epoch=e)  # noqa: E731
        accs, n = [float(np.mean(np.asarray(ev(state).per_task_accuracies)))], 0
        for epoch in range(4):
            for _ in range(4):
                state, _ = step(state, learnable_synthetic_batch(4, n_way, k, t, TINY, seed=n), epoch)
                n += 1
            accs.append(float(np.mean(np.asarray(ev(state).per_task_accuracies))))
        return state, accs, np.asarray(ev(state).per_task_target_logits)

    state_tp, accs_tp, logits_tp = run("tp")
    _, accs_single, logits_single = run("single")
    _, accs_jax, logits_jax = run("jax")
    assert accs_tp[-1] >= accs_tp[0] + 0.25, accs_tp
    np.testing.assert_allclose(accs_tp, accs_single, atol=0.05)
    np.testing.assert_allclose(accs_tp, accs_jax, atol=0.05)
    np.testing.assert_allclose(logits_tp, logits_single, atol=1e-4)
    np.testing.assert_allclose(logits_tp, logits_jax, atol=1e-3)
    assert tpar.placement(state_tp).params["stage_0"]["conv"]["w"] == ("mp", None, None, None)


# ---------------------------------------------------------------------------
# the runner: format 3 of dp x mp shards, shrink and grow back
# ---------------------------------------------------------------------------


def _tp_runner_cfg(toy_dataset, root, **overrides):
    return campaign_config(toy_dataset, str(root), "tp", parallel=tcfg.ParallelConfig(dp=2, mp=2, tp_convs=True),
                           checkpoint_shards=0, **overrides)


def _events(run_dir):
    with open(os.path.join(run_dir, "logs", "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_runner_at_dp2_mp2_writes_jax_shards_shrinks_and_grows_back(toy_dataset, tmp_path):
    cfg = _tp_runner_cfg(toy_dataset, tmp_path, total_epochs=1)
    runner = ExperimentRunner(cfg, system=tiny_system(cfg, "cpu"), devices=["cpu"] * 4)
    assert runner.mesh.shape == {"dp": 2, "mp": 2}
    assert tpar.placement(runner.state).params["stage_0"]["conv"]["w"] == ("mp", None, None, None)
    runner.run_experiment()
    assert isinstance(runner.state, tpar.Replicated) and runner.state.specs is not None
    save_dir = runner.saved_models_dir
    shards = sorted(n for n in os.listdir(save_dir) if n.startswith("train_model_latest.shard"))
    assert shards == [f"train_model_latest.shard{k}" for k in range(4)]
    _, book = ckpt.load_for_inference(save_dir, "latest")
    assert book["mesh"] == [2, 2]
    # the files are JAX's bytes for the state JAX reads from them
    jcfg_ = jax_campaign.campaign_config(toy_dataset, str(tmp_path), "tp", total_epochs=1)
    template = jax_campaign.tiny_system(jcfg_).init_train_state()
    jstate, _ = jax_ckpt.load_checkpoint(save_dir, "latest", template)
    blobs, _ = jax_ckpt._sharded_serialize(jstate, 4)
    for k, blob in enumerate(blobs):
        with open(os.path.join(save_dir, f"train_model_latest.shard{k}"), "rb") as f:
            assert f.read() == blob
    whole = tpar.unreplicate(runner.state)

    # resume degraded on 2 entries (mp kept), then on 1
    for n_visible, granted, epochs in ((2, [1, 2], 2), (1, [1, 1], 3)):
        cfg_n = _tp_runner_cfg(toy_dataset, tmp_path, total_epochs=epochs)
        shrunk = ExperimentRunner(cfg_n, system=tiny_system(cfg_n, "cpu"), devices=["cpu"] * n_visible,
                                  device_probe=lambda n=n_visible: n)
        assert shrunk.degraded_mesh == {"requested": [2, 2], "granted": granted, "visible_devices": n_visible}
        if n_visible == 2:
            assert shrunk.mesh.shape == {"dp": 1, "mp": 2} and shrunk.state.specs is not None
            restored = tpar.unreplicate(shrunk.state)
            for a, b in zip(jax.tree.leaves(restored.params), jax.tree.leaves(whole.params)):
                assert torch.equal(a, b)
        else:
            assert shrunk.mesh is None
        shrunk.run_experiment()
        event = [e for e in _events(shrunk.run_dir) if e.get("event") == "degraded_mesh"][-1]
        assert event["granted"] == granted
        assert ckpt.load_for_inference(save_dir, "latest")[1]["mesh"] == granted

    # grow back at the epoch boundary: the probe sees 1, then 4
    probes = iter([1])
    cfg_g = _tp_runner_cfg(toy_dataset, tmp_path, total_epochs=4)
    grow = ExperimentRunner(cfg_g, system=tiny_system(cfg_g, "cpu"), devices=["cpu"] * 4,
                            device_probe=lambda: next(probes, 4))
    assert grow.mesh is None and grow.start_epoch == 3
    grow.run_experiment()
    grown = [e for e in _events(grow.run_dir) if e.get("event") == "mesh_grown"][-1]
    assert grown["previous"] == [1, 1] and grown["granted"] == [2, 2]
    assert grow.mesh.shape == {"dp": 2, "mp": 2} and grow.state.specs is not None
    _, book = ckpt.load_for_inference(save_dir, "latest")
    assert book["mesh"] == [2, 2] and book["epoch"] == 3
    assert len([n for n in os.listdir(save_dir) if n.startswith("train_model_latest.shard")]) == 4


# ---------------------------------------------------------------------------
# two processes
# ---------------------------------------------------------------------------

_CHILD = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch
from howtotrainyourmamlpytorch_tpu_torch.models.vgg import build_vgg
from howtotrainyourmamlpytorch_tpu_torch.parallel import (
    host_shard_bounds, initialize_distributed, make_mesh, process_count, shard_batch, shard_train_state,
    unreplicate)

address, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
initialize_distributed(address, 2, rank, device="cpu", timeout_s=60.0)
cfg = tcfg.Config(num_classes_per_set=4, num_samples_per_class=2, num_target_samples=2, batch_size=4,
                  number_of_training_steps_per_iter=2, number_of_evaluation_steps_per_iter=2,
                  use_pallas_inner_update=True, remat_inner_steps=False,
                  parallel=tcfg.ParallelConfig(dp=2, mp=2, tp_convs=True))
system = MAMLSystem(cfg, model=build_vgg((8, 8, 1), 4, num_stages=2, cnn_num_filters=8, max_pooling=False),
                    device="cpu")
state = system.init_train_state(seed=0)
batch = learnable_synthetic_batch(4, 4, 2, 2, (8, 8, 1), seed=5)
lo, hi = host_shard_bounds(4, rank, process_count())
mesh = make_mesh(cfg.parallel, ["cpu"] * 2)
assert mesh.shape == {"dp": 2, "mp": 2} and mesh.local_dp == 1 and mesh.processes == 2
placed = shard_train_state(state, mesh)
new, step_out = system.train_step(placed, shard_batch({k: v[lo:hi] for k, v in batch.items()}, mesh), epoch=0)
whole = unreplicate(new)
np.savez(out, loss=float(step_out.loss), **{"/".join(p): t.numpy() for t, p in
         zip(*__import__("howtotrainyourmamlpytorch_tpu_torch.utils.trees", fromlist=["x"]).tree_flatten(whole.params))})
dist.barrier()
dist.destroy_process_group()
print("CHILD_OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_at_dp2_mp2_match_one_process(tmp_path):
    """Two gloo processes, each one dp row of two mp entries on the CPU: the
    all-reduced step's loss and new params equal one process's dp=2 x mp=2
    step (one scale, atol 1e-6 of the largest entry; loss rtol 1e-6)."""
    address = f"127.0.0.1:{_free_port()}"
    env = dict(_env(), OMP_NUM_THREADS="1")
    outs = [str(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, address, str(r), outs[r]], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=240)
            assert proc.returncode == 0 and "CHILD_OK" in stdout, (stdout[-3000:], stderr[-3000:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cfg = tcfg.Config(num_classes_per_set=4, num_samples_per_class=2, num_target_samples=2, batch_size=4,
                      number_of_training_steps_per_iter=2, number_of_evaluation_steps_per_iter=2,
                      use_pallas_inner_update=True, remat_inner_steps=False,
                      parallel=tcfg.ParallelConfig(dp=2, mp=2, tp_convs=True))
    system = MAMLSystem(cfg, model=build_vgg(TINY, 4, num_stages=2, cnn_num_filters=8, max_pooling=False),
                        device="cpu")
    mesh = tpar.make_mesh(cfg.parallel, ["cpu"] * 4)
    batch = learnable_synthetic_batch(4, 4, 2, 2, TINY, seed=5)
    new, out = system.train_step(tpar.shard_train_state(system.init_train_state(seed=0), mesh),
                                 tpar.shard_batch(batch, mesh), epoch=0)
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten

    leaves, paths = tree_flatten(tpar.unreplicate(new).params)
    scale = max(float(t.abs().max()) for t in leaves)
    for r in (0, 1):
        got = np.load(outs[r])
        np.testing.assert_allclose(float(got["loss"]), float(out.loss), rtol=1e-6)
        for t, p in zip(leaves, paths):
            np.testing.assert_allclose(got["/".join(p)], t.numpy(), rtol=0, atol=1e-6 * scale)
