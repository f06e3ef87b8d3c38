"""The outer (meta) optimizer: Adam on a schedule, as plain functions over
dict trees, matching the JAX package's ``optax.adam(learning_rate=schedule)``
(``core/maml.py:182``, ``:686-687``).

The state keeps optax's layout, so a checkpoint carries it between the two
packages unchanged: ``(ScaleByAdamState(count, mu, nu),
ScaleByScheduleState(count))``, with ``mu`` and ``nu`` trees of the
trainables' structure and int32 counts. One update:

- ``mu = (1 - b1) * g + b1 * mu``; ``nu = (1 - b2) * g**2 + b2 * nu``;
- ``count += 1``; ``mu_hat = mu / (1 - b1**count)``,
  ``nu_hat = nu / (1 - b2**count)``;
- ``u = mu_hat / (sqrt(nu_hat) + eps)``;
- ``p += -schedule(schedule_count) * u``, the schedule read at the count
  BEFORE its increment.

This is ``torch.optim.Adam``'s algorithm too, but written out: the state is
a tree shaped like optax's rather than one entry per parameter, and every
operation is float32 in optax's order.
"""

from typing import Any, Callable, NamedTuple

import torch

from ..utils.trees import tree_leaves, tree_map
from .precision import as_f32

# optax.adam's defaults, which the JAX package uses
B1, B2, EPS = 0.9, 0.999, 1e-8


class ScaleByAdamState(NamedTuple):
    count: Any  # int32 0-d tensor
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: Any  # int32 0-d tensor


def adam_init(trainables):
    """Zero moments and counts for a tree of trainables."""
    device = tree_leaves(trainables)[0].device
    zeros = lambda t: torch.zeros_like(t)  # noqa: E731
    count = lambda: torch.zeros((), dtype=torch.int32, device=device)  # noqa: E731
    return (
        ScaleByAdamState(count=count(), mu=tree_map(zeros, trainables), nu=tree_map(zeros, trainables)),
        ScaleByScheduleState(count=count()),
    )


def adam_update(grads, state, params, schedule: Callable):
    """One Adam step -> ``(new_params, new_state)``. ``schedule(count)``
    returns the learning rate for an int32 count tensor. Nothing here is
    differentiated: call it under ``torch.no_grad()``."""
    adam, sched = state
    mu = tree_map(lambda g, m: (1 - B1) * g + B1 * m, grads, adam.mu)
    nu = tree_map(lambda g, v: (1 - B2) * (g * g) + B2 * v, grads, adam.nu)
    count = adam.count + 1
    countf = as_f32(count)
    # torch.full, not torch.tensor: a fill kernel, no host-to-device copy
    # (a CUDA graph captures the step)
    bc1 = 1 - torch.full((), B1, dtype=torch.float32, device=countf.device) ** countf
    bc2 = 1 - torch.full((), B2, dtype=torch.float32, device=countf.device) ** countf
    step_size = -1 * schedule(sched.count)
    # the scalars go to each leaf's device (a tensor-parallel block may lie
    # on another card than the counts; on the same device .to is a no-op)
    new_params = tree_map(
        lambda p, m, v: p + step_size.to(p.device, p.dtype) * ((m / bc1.to(p.device))
                                                                / (torch.sqrt(v / bc2.to(p.device)) + EPS)),
        params, mu, nu,
    )
    return new_params, (ScaleByAdamState(count=count, mu=mu, nu=nu), ScaleByScheduleState(count=sched.count + 1))
