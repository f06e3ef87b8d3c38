"""Buffer donation: the audit table and the runtime self-check (JAX package
``observability/donation.py``).

Two jobs, one module:

- :func:`donation_audit`: for every planned train program, which
  donatable inputs (the ``TrainState``, the episode batch) are donated
  under the current config, and the bytes each undonated one leaves on the
  table. Host arithmetic over leaf shapes and dtypes, the same table as
  JAX's for the same config and state shapes (the port's ``step`` is int64,
  4 bytes more than JAX's int32). On the card a multi-step program keeps
  its state in place in any case (``core/programs.py``: the graph writes
  the new state into its static buffers), which the table says in
  ``graph_state_in_place``.
- :func:`donation_selfcheck`: a small in-process A/B, the donated and the
  plain eager train step (``core/maml.py``: the donated one writes the new
  state into the tensors it was given) over the same streamed batches,
  each copied to the device afresh every step. The runner runs it before
  the first step whenever ``donate_train_state`` is on and trains without
  donation unless the verdict is ``clean``. The thresholds are JAX's.

Eval programs are absent from the audit, as in JAX: their state input is
reused across batches, so it is not donatable.
"""

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.trees import tree_flatten, tree_leaves, tree_map


class TensorSpec(NamedTuple):
    """A leaf's shape and dtype without its data (JAX's
    ``ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: Any


# ---------------------------------------------------------------------------
# byte arithmetic
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts, tuples and lists (a placed state's
    whole state); a :class:`TensorSpec` is a leaf."""
    from ..parallel.mesh import Replicated, unreplicate

    if isinstance(tree, Replicated):
        return _leaves(unreplicate(tree))
    if isinstance(tree, TensorSpec):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def tree_bytes(tree: Any) -> int:
    """Total bytes of every array-shaped leaf (shape x itemsize) of a tree
    of tensors, numpy arrays or :class:`TensorSpec`s (a placed state counts
    its whole state); leaves without a shape and a dtype count 0."""
    total = 0
    for leaf in _leaves(tree):
        shape, dtype = getattr(leaf, "shape", None), getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            continue
        itemsize = dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize
        total += int(np.prod(tuple(shape), dtype=np.int64)) * itemsize
    return total


def episode_batch_spec(cfg) -> Dict[str, TensorSpec]:
    """The shapes and dtypes of one episode batch as the loader stacks it
    (``x: [B, n_way, k, H, W, C]`` float32, ``y: [B, n_way, k]`` int32),
    ``B`` the runner's global meta-batch. Nothing is made."""
    b = cfg.batch_size * cfg.samples_per_iter
    n, k, t = cfg.num_classes_per_set, cfg.num_samples_per_class, cfg.num_target_samples
    h, w, c = cfg.image_shape
    f32, i32 = np.dtype(np.float32), np.dtype(np.int32)
    return {
        "x_support": TensorSpec((b, n, k, h, w, c), f32),
        "y_support": TensorSpec((b, n, k), i32),
        "x_target": TensorSpec((b, n, t, h, w, c), f32),
        "y_target": TensorSpec((b, n, t), i32),
    }


def donation_audit(cfg, state, batch: Optional[Any] = None) -> Dict[str, Any]:
    """Per planned train program: donatable inputs, donated or not under
    the current config, and the bytes each undonated one leaves on the
    table. ``state`` is the live state (placed or not); ``batch`` defaults
    to the config's episode spec. The multi-step chunk counts the batch
    ``train_steps_per_dispatch`` times."""
    from ..utils.strictmode import train_planned_programs

    state_bytes = tree_bytes(state)
    batch_bytes = tree_bytes(batch if batch is not None else episode_batch_spec(cfg))
    donated_flags = {"state": bool(cfg.donate_train_state), "batch": bool(cfg.donate_batch)}
    k_chunk = int(cfg.train_steps_per_dispatch)
    rows: List[Dict[str, Any]] = []
    for key in sorted((k for k in train_planned_programs(cfg) if k[0] in ("train", "train_multi")), key=repr):
        donatable = {"state": state_bytes, "batch": batch_bytes * (k_chunk if key[0] == "train_multi" else 1)}
        undonated = [name for name in donatable if not donated_flags[name]]
        rows.append({
            "program": "/".join(str(p) for p in key),
            "donatable_bytes": donatable,
            "donated": sorted(n for n in donatable if donated_flags[n]),
            "not_donated": sorted(undonated),
            "donated_bytes": sum(b for name, b in donatable.items() if donated_flags[name]),
            "left_on_table_bytes": sum(donatable[n] for n in undonated),
        })
    return {
        "flags": {"donate_train_state": donated_flags["state"], "donate_batch": donated_flags["batch"]},
        "state_bytes": state_bytes,
        "batch_bytes": batch_bytes,
        "rows": rows,
        "donated_bytes": max((r["donated_bytes"] for r in rows), default=0),
        "left_on_table_bytes": max((r["left_on_table_bytes"] for r in rows), default=0),
        # the train_multi programs on the card update the state in place
        # whatever the flags say
        "graph_state_in_place": True,
    }


# ---------------------------------------------------------------------------
# the A/B arm
# ---------------------------------------------------------------------------


def run_donation_arm(cfg, n_steps: int, n_batches: int = 16, system=None, device=None) -> Tuple[List[float], Any]:
    """One arm of the A/B: ``n_steps`` eager train steps, each on a fresh
    device copy of a (cycled) synthetic batch, as the runner's loader
    feeds them. -> (per-step losses, the final params as host arrays).

    The steps run under the deterministic algorithms
    (``utils/seeding.py::deterministic_algorithms``): with cuDNN's default
    convolutions two runs of one plain arm at 20-way 5-shot differed by
    1.37e-2 in a first step's loss on an H100, past
    :data:`EARLY_LOSS_TOL`, so the verdict would read kernel choice as
    corruption."""
    from ..core.maml import MAMLSystem
    from ..data.synthetic import synthetic_batch
    from ..utils.seeding import deterministic_algorithms

    system = system or MAMLSystem(cfg, device=device)
    state = system.init_train_state()
    losses: List[float] = []
    with deterministic_algorithms(True):
        for i in range(n_steps):
            host = synthetic_batch(cfg.batch_size, cfg.num_classes_per_set, cfg.num_samples_per_class,
                                   cfg.num_target_samples, cfg.image_shape, seed=i % n_batches)
            batch = {k: torch.as_tensor(np.asarray(v)).to(system.device) for k, v in host.items()}
            state, out = system.train_step(state, batch, epoch=0)
            losses.append(float(out.loss))
    return losses, tree_map(lambda t: t.detach().cpu().numpy().copy(), state.params)


def param_divergences(params_a, params_b) -> List[Tuple[str, float]]:
    """[(path, rel ||a-b||/||b||)] per leaf of two trees of one structure;
    paths spelled as JAX's ``keystr``."""
    leaves_a, paths = tree_flatten(params_a)
    out = []
    for path, leaf_a, leaf_b in zip(paths, leaves_a, tree_leaves(params_b)):
        a, b = np.asarray(leaf_a, np.float64), np.asarray(leaf_b, np.float64)
        rel = np.linalg.norm(a - b) / (np.linalg.norm(b) or 1.0)
        out.append(("".join(f"['{k}']" for k in path), float(rel)))
    return out


def compare_arms(losses_a: List[float], params_a, losses_b: List[float], params_b) -> Dict[str, Any]:
    """The comparison: per-step loss deviations (worst overall, worst over
    the first two steps, the first step past 1e-5), the global parameter
    divergence ``||a-b||/||b||`` over the concatenated trees, and the
    per-leaf table (diagnostic only)."""
    max_loss_dev = max((abs(a - b) for a, b in zip(losses_a, losses_b)), default=0.0)
    early_loss_dev = max((abs(a - b) for a, b in zip(losses_a[:2], losses_b[:2])), default=0.0)
    first_dev = next((i for i, (a, b) in enumerate(zip(losses_a, losses_b)) if abs(a - b) > 1e-5), None)
    divs = param_divergences(params_a, params_b)
    worst = max((rel for _, rel in divs), default=0.0)

    def flat(params):
        leaves = tree_leaves(params)
        return np.concatenate([np.asarray(x, np.float64).ravel() for x in leaves]) if leaves else np.zeros(1)

    flat_a, flat_b = flat(params_a), flat(params_b)
    global_rel = float(np.linalg.norm(flat_a - flat_b) / (np.linalg.norm(flat_b) or 1.0))
    return {
        "max_loss_dev": max_loss_dev,
        "early_loss_dev": early_loss_dev,
        "first_step_deviating": first_dev,
        "global_param_rel": global_rel,
        "worst_param_rel": worst,
        "diverged_leaves": [(p, rel) for p, rel in divs if rel > 1e-4],
    }


#: JAX's verdict thresholds: corruption shows at once and large (early
#: loss deviations of ~1e-1, parameters ~3e-1 off), reorder noise between
#: two programs starts at ~1e-6 and grows with the horizon (a chaotic
#: second-order objective), so the verdict keys on the first two steps and
#: on catastrophic magnitudes
EARLY_LOSS_TOL = 1e-2  # loss deviation within the first two steps
CATASTROPHIC_LOSS = 0.3  # loss deviation anywhere in the horizon
CATASTROPHIC_REL = 0.1  # global param divergence


def verdict_from(comparison: Dict[str, Any]) -> str:
    """``"corruption"`` or ``"clean"`` from a :func:`compare_arms` result."""
    if (
        comparison["early_loss_dev"] > EARLY_LOSS_TOL
        or comparison["max_loss_dev"] > CATASTROPHIC_LOSS
        or comparison["global_param_rel"] > CATASTROPHIC_REL
    ):
        return "corruption"
    return "clean"


# ---------------------------------------------------------------------------
# the startup gate
# ---------------------------------------------------------------------------


def _tiny_probe_config(cfg):
    """The run's config cut to a seconds-long A/B (JAX's cut): a donated
    buffer read back is a property of the runtime, not of the shapes; the
    image shape, the inner optimizer and the precision policy are the
    run's."""
    return dataclasses.replace(
        cfg,
        batch_size=2,
        samples_per_iter=1,
        num_classes_per_set=min(cfg.num_classes_per_set, 3),
        num_samples_per_class=min(cfg.num_samples_per_class, 2),
        num_target_samples=min(cfg.num_target_samples, 2),
        number_of_training_steps_per_iter=min(cfg.number_of_training_steps_per_iter, 2),
        unroll_inner_steps=True,
        remat_inner_steps=False,
        remat_policy="none",
        strict_recompile_guard=False,
        train_steps_per_dispatch=1,
    )


def donation_selfcheck(
    cfg,
    n_steps: int = 6,
    n_batches: int = 3,
    run_arm: Optional[Callable[[bool], Tuple[List[float], Any]]] = None,
    device=None,
) -> Dict[str, Any]:
    """The donated and the plain arm on ``device`` (default the card) ->
    the verdict dict (``verdict`` ``"clean"`` or ``"corruption"``, the
    device type as ``backend``, and the :func:`compare_arms` evidence).
    ``run_arm(donate) -> (losses, params)`` is injectable: a test fakes a
    corrupting arm with it."""
    from ..core.maml import resolve_device

    device = resolve_device(device)
    if run_arm is None:
        probe_cfg = _tiny_probe_config(cfg)

        def run_arm(donate: bool):
            return run_donation_arm(dataclasses.replace(probe_cfg, donate_train_state=donate), n_steps=n_steps,
                                    n_batches=n_batches, device=device)

    losses_d, params_d = run_arm(True)
    losses_n, params_n = run_arm(False)
    comparison = compare_arms(losses_d, params_d, losses_n, params_n)
    return {
        "verdict": verdict_from(comparison),
        "backend": device.type,
        "n_steps": int(n_steps),
        "tolerances": {"early_loss": EARLY_LOSS_TOL, "catastrophic_loss": CATASTROPHIC_LOSS,
                       "catastrophic_rel": CATASTROPHIC_REL},
        **{k: v for k, v in comparison.items() if k != "diverged_leaves"},
        "diverged_leaves": comparison["diverged_leaves"][:8],
    }
