"""Weight carry-over between the JAX package's trees and the port's tensors.

Torch's generator cannot reproduce ``jax.random`` init, so a parity check,
or a server loading a checkpoint the JAX package wrote, moves the JAX
weights into the port. The trees map by key path, never by leaf position:

- a conv kernel (the 4-d ``w`` under a ``conv``, ``conv1`` or ``conv2``
  key: VGG's ``stage_i/conv``, ResNet's ``conv1``/``conv2`` and
  ``downsample/conv``, DenseNet's ``conv1``/``conv2`` and
  ``transition_i/conv``) goes from HWIO to OIHW;
- the head (the 2-d ``w`` of ``fc`` or ``classifier``) goes from
  ``[in, out]`` to ``[out, in]``. Where the activation it reads has H·W > 1
  (the VGG at 84x84, ``feature_shape`` (64, 5, 5)) its input rows also go
  from the JAX flatten order ``(h, w, c)`` (NHWC) to the port's
  ``(c, h, w)`` (NCHW); without that reordering the logits are wrong while
  every shape still checks. ResNet and DenseNet end in a global average
  pool (``feature_shape`` (C, 1, 1)), so their head is only transposed;
- every other leaf (biases, BN scale/shift and statistics, per-tensor lrs,
  counters) keeps its values and shape.

The rules key on the path inside a params-shaped tree, so a tree that nests
params under a prefix (the outer Adam's ``mu``/``nu`` over
``{"params", "hparams"}``) is converted subtree by subtree
(:func:`trainables_from_jax`, :func:`opt_state_from_jax`). The inputs may be
numpy arrays or tensors; a leading task axis on every leaf
(``batch_dims=1``) is carried through.
"""

from typing import Tuple

import numpy as np
import torch

from ..ops.outer_adam import ScaleByAdamState, ScaleByScheduleState
from .trees import Path, tree_flatten, tree_unflatten


CONV_KEYS = ("conv", "conv1", "conv2")
HEAD_KEYS = ("fc", "classifier")


def _kind(path: Path, ndim: int) -> str:
    if len(path) >= 2 and path[-1] == "w" and path[-2] in CONV_KEYS and ndim == 4:
        return "conv"
    if len(path) == 2 and path[0] in HEAD_KEYS and path[1] == "w" and ndim == 2:
        return "head"
    if ndim > 1:
        raise ValueError(f"no layout rule for the {ndim}-d leaf {'/'.join(path)}")
    return "copy"


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def params_from_jax(tree, feature_shape: Tuple[int, int, int], device=None, batch_dims: int = 0):
    """JAX-layout params (or grads, or any tree of their shape) -> the
    port's layout on ``device``. ``feature_shape`` is the model's
    ``(C, H, W)`` before the head (``Model.feature_shape``)."""
    c, h, w = feature_shape
    leaves, paths = tree_flatten(tree)
    out = []
    for path, leaf in zip(paths, leaves):
        t = _as_tensor(leaf)
        b = tuple(t.shape[:batch_dims])
        kind = _kind(path, t.dim() - batch_dims)
        if kind == "conv":  # [*b, kh, kw, i, o] -> [*b, o, i, kh, kw]
            n = len(b)
            t = t.permute(*range(n), n + 3, n + 2, n, n + 1)
        elif kind == "head":  # [*b, h*w*c, o] -> [*b, o, c*h*w]
            o = t.shape[-1]
            n = len(b)
            t = t.reshape(*b, h, w, c, o).permute(*range(n), n + 3, n + 2, n, n + 1)
            t = t.reshape(*b, o, c * h * w)
        out.append(t.contiguous().to(device))
    return tree_unflatten(paths, out)


def params_to_jax(tree, feature_shape: Tuple[int, int, int], batch_dims: int = 0):
    """The inverse of :func:`params_from_jax`: port tensors -> JAX-layout
    numpy arrays (float32 for floating leaves)."""
    c, h, w = feature_shape
    leaves, paths = tree_flatten(tree)
    out = []
    for path, t in zip(paths, leaves):
        t = t.detach().cpu()
        b = tuple(t.shape[:batch_dims])
        n = len(b)
        kind = _kind(path, t.dim() - batch_dims)
        if kind == "conv":  # [*b, o, i, kh, kw] -> [*b, kh, kw, i, o]
            t = t.permute(*range(n), n + 2, n + 3, n + 1, n)
        elif kind == "head":  # [*b, o, c*h*w] -> [*b, h*w*c, o]
            o = t.shape[n]
            t = t.reshape(*b, o, c, h, w).permute(*range(n), n + 2, n + 3, n + 1, n)
            t = t.reshape(*b, h * w * c, o)
        if t.is_floating_point():
            t = t.float()
        out.append(t.contiguous().numpy())
    return tree_unflatten(paths, out)


def state_from_jax(params, bn_state, inner_hparams, feature_shape, device=None):
    """The three trees a server needs, JAX layout -> port tensors on
    ``device``. BN statistics and per-tensor hparams are keyed like params
    but hold only scalars and vectors, so they copy as they are."""
    return (
        params_from_jax(params, feature_shape, device),
        params_from_jax(bn_state, feature_shape, device),
        params_from_jax(inner_hparams, feature_shape, device),
    )


def trainables_from_jax(tree, feature_shape, device=None):
    """``{"params", "hparams"}`` (a meta-gradient, an Adam moment) -> port
    tensors, each subtree with its own rules."""
    return {
        "params": params_from_jax(tree["params"], feature_shape, device),
        "hparams": params_from_jax(tree["hparams"], feature_shape, device),
    }


def trainables_to_jax(tree, feature_shape):
    return {
        "params": params_to_jax(tree["params"], feature_shape),
        "hparams": params_to_jax(tree["hparams"], feature_shape),
    }


def _adam_parts(opt_state):
    """(adam count, mu, nu, schedule count) of an optax-layout state: the
    optax/port NamedTuples, or flax's state dict of them
    (``{"0": {"count", "mu", "nu"}, "1": {"count"}}``)."""
    if isinstance(opt_state, dict):
        adam, sched = opt_state["0"], opt_state["1"]
        return adam["count"], adam["mu"], adam["nu"], sched["count"]
    adam, sched = opt_state
    return adam.count, adam.mu, adam.nu, sched.count


def _count(value, device=None) -> torch.Tensor:
    return torch.tensor(int(np.asarray(value)), dtype=torch.int32, device=device)


def opt_state_from_jax(opt_state, feature_shape, device=None):
    """The JAX package's outer Adam state -> the port's
    (``ops/outer_adam.py``): moments converted per subtree, counts as int32
    integers."""
    count, mu, nu, sched_count = _adam_parts(opt_state)
    return (
        ScaleByAdamState(
            count=_count(count, device),
            mu=trainables_from_jax(mu, feature_shape, device),
            nu=trainables_from_jax(nu, feature_shape, device),
        ),
        ScaleByScheduleState(count=_count(sched_count, device)),
    )


def opt_state_to_jax(opt_state, feature_shape):
    """The inverse of :func:`opt_state_from_jax`: numpy leaves in the JAX
    layout, int32 0-d counts, in the optax NamedTuple structure."""
    count, mu, nu, sched_count = _adam_parts(opt_state)
    as_count = lambda c: np.asarray(int(c), dtype=np.int32)  # noqa: E731
    return (
        ScaleByAdamState(
            count=as_count(count),
            mu=trainables_to_jax(mu, feature_shape),
            nu=trainables_to_jax(nu, feature_shape),
        ),
        ScaleByScheduleState(count=as_count(sched_count)),
    )
