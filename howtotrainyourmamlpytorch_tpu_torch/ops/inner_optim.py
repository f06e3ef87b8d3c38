"""Inner-loop optimizers as pure functions over dict trees (JAX package
``ops/inner_optim.py``).

Hyperparameters are per parameter tensor (LSLR: one scalar lr per leaf,
reference ``few_shot_learning_system.py:94-107``). This slice ports SGD, the
default ``gd`` preset; ``adam`` and ``rprop`` come with the training path's
breadth slice (ROADMAP.md, A6).

The JAX package hides the task axis behind ``jax.vmap``; here params and
grads carry it as their leading axis, and the fused update covers every
task of a meta-batch in one kernel launch (the task axis is part of each
leaf).

Both forms are differentiable in params, grads and lrs, so the
second-order meta-gradient flows through every inner step: the unfused one
through autograd's elementwise ops, the fused one through
``ops/fused_update.py::FusedSGD`` (backward: the B2 kernel on the card).
"""

from typing import Any, Callable, NamedTuple

import torch

from ..utils.trees import tree_map, tree_scalars_like


class InnerOptimizer(NamedTuple):
    """``init_hparams(params)``, ``init_state(params, hparams)``,
    ``update(grads, state, params, hparams) -> (params, state)``
    and ``project_hparams(hparams)``."""

    name: str
    init_hparams: Callable[[Any], Any]
    init_state: Callable[[Any, Any], Any]
    update: Callable[..., Any]
    project_hparams: Callable[[Any], Any]


def sgd(lr: float = 0.1, fused: bool = False) -> InnerOptimizer:
    """``fused=True`` routes the step through the fused kernel
    (``ops/fused_update.py``: one launch over the tree's leaves, one more
    for its backward); otherwise one elementwise ``p - lr * g`` per leaf, the
    unfused form the JAX package compiles."""

    def init_hparams(params):
        return {"lr": tree_scalars_like(params, lr)}

    def init_state(params, hparams):
        return ()

    def update(grads, state, params, hparams):
        if fused:
            from .fused_update import fused_sgd_update

            return fused_sgd_update(params, grads, hparams["lr"]), state
        # the lr stays an f32 master and is cast to the fast-weight dtype at
        # use: a no-op in f32, and under bf16_inner it keeps the update in bf16
        new_params = tree_map(lambda p, g, a: p - a.to(p.dtype) * g, params, grads, hparams["lr"])
        return new_params, state

    def project_hparams(hparams):
        return {"lr": tree_map(lambda a: torch.clamp(a, min=1e-4), hparams["lr"])}

    return InnerOptimizer("sgd", init_hparams, init_state, update, project_hparams)


def _not_ported(kind: str):
    def build(**kwargs):
        raise NotImplementedError(
            f"inner optimizer {kind!r} is not ported to PyTorch yet "
            "(ROADMAP.md A6); this slice serves the sgd/gd preset"
        )

    return build


_BUILDERS = {"sgd": sgd, "gd": sgd, "adam": _not_ported("adam"), "rprop": _not_ported("rprop")}


def build_inner_optimizer(kind: str, **kwargs) -> InnerOptimizer:
    if kind not in _BUILDERS:
        raise ValueError(f"unknown inner optimizer {kind!r}; expected one of {sorted(_BUILDERS)}")
    return _BUILDERS[kind](**kwargs)
