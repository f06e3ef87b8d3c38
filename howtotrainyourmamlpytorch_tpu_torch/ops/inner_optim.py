"""Inner-loop optimizers as pure functions over dict trees (JAX package
``ops/inner_optim.py``).

SGD, Adam and Rprop with ``torch.optim``'s step math. Hyperparameters are
per parameter tensor (LSLR: one scalar lr per leaf, and for Adam one scalar
beta1 and beta2 per leaf, reference ``few_shot_learning_system.py:94-107``),
f32 masters cast to the fast-weight dtype at use, and differentiable, so the
outer loop learns them. ``project_hparams`` clamps them after each outer
step: lr >= 1e-4, Adam's betas in [1e-4, 0.99].

The JAX package hides the task axis behind ``jax.vmap``; here params, grads
and the optimizer state carry it as their leading axis (a per-leaf 0-d
state such as Adam's step count becomes ``[T]``, and broadcasts against
its leaf's trailing axes), and the fused update covers every task of a
meta-batch in one kernel launch (the task axis is part of each leaf).

Every update is differentiable in params, grads, state and hparams, so the
second-order meta-gradient flows through every inner step: through
autograd's elementwise ops, or for the fused SGD through
``ops/fused_update.py::FusedSGD`` (backward: the B2 kernel on the card).
Only SGD has a fused form (``Config.use_pallas_inner_update``).
"""

from typing import Any, Callable, NamedTuple

import torch

from ..utils.trees import tree_flatten, tree_map, tree_scalars_like, tree_unflatten


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


def _lead(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-leaf state scalar (0-d, or ``[T]`` with the task axis) shaped
    to broadcast against its leaf's trailing axes."""
    return t.reshape(tuple(t.shape) + (1,) * (like.dim() - t.dim()))


def _leafwise(fn, n_out, *trees):
    """``fn`` over the matching leaves of ``trees`` (the first one's key
    order) -> ``n_out`` trees of its outputs."""
    leaves, paths = tree_flatten(trees[0])
    rest = [tree_flatten(t)[0] for t in trees[1:]]
    outs = [fn(*args) for args in zip(leaves, *rest)]
    return [tree_unflatten(paths, [o[i] for o in outs]) for i in range(n_out)]


def adam(lr: float = 0.1, beta1: float = 0.5, beta2: float = 0.5, eps: float = 1e-8) -> InnerOptimizer:
    """torch.optim.Adam's step (eps 1e-8) with per-tensor learnable lr,
    beta1 and beta2 (the reference's ``adam`` preset, config.yaml:80-85)."""

    def init_hparams(params):
        return {
            "lr": tree_scalars_like(params, lr),
            "beta1": tree_scalars_like(params, beta1),
            "beta2": tree_scalars_like(params, beta2),
        }

    def init_state(params, hparams):
        return {
            "step": tree_scalars_like(params, 0.0),
            "exp_avg": tree_map(torch.zeros_like, params),
            "exp_avg_sq": tree_map(torch.zeros_like, params),
        }

    def leaf(p, g, m, v, t, a, b1, b2):
        a, b1, b2 = (h.to(p.dtype) for h in (a, b1, b2))
        t = t + 1.0
        tb = _lead(t, p)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        bc1 = 1.0 - b1**tb
        bc2 = 1.0 - b2**tb
        # sqrt clamped away from 0, as in the JAX package: the update must be
        # twice differentiable, and an element whose inner gradient is
        # exactly 0 at the first step (v = 0) would put sqrt'(0) = inf, and
        # inf * 0 = NaN, into the second-order meta-gradient. Forward equal
        # to torch.optim.Adam in f32 (sqrt(1e-24) is 4 orders below eps).
        denom = torch.sqrt(torch.clamp(v, min=1e-24)) / torch.sqrt(bc2) + eps
        return p - (a / bc1) * m / denom, m, v, t

    def update(grads, state, params, hparams):
        new_params, m, v, t = _leafwise(
            leaf, 4, params, grads, state["exp_avg"], state["exp_avg_sq"], state["step"],
            hparams["lr"], hparams["beta1"], hparams["beta2"],
        )
        return new_params, {"exp_avg": m, "exp_avg_sq": v, "step": t}

    def project_hparams(hparams):
        clip_beta = lambda b: torch.clamp(b, 1e-4, 0.99)  # noqa: E731
        return {
            "lr": tree_map(lambda a: torch.clamp(a, min=1e-4), hparams["lr"]),
            "beta1": tree_map(clip_beta, hparams["beta1"]),
            "beta2": tree_map(clip_beta, hparams["beta2"]),
        }

    return InnerOptimizer("adam", init_hparams, init_state, update, project_hparams)


def rprop(
    lr: float = 0.1,
    eta_minus: float = 0.5,
    eta_plus: float = 1.2,
    step_size_min: float = 1e-6,
    step_size_max: float = 50.0,
) -> InnerOptimizer:
    """torch.optim.Rprop's step (the reference's ``rprop`` preset,
    config.yaml:75-78). The per-element step size starts at the per-tensor
    lr, so the lr's meta-gradient flows through the state."""

    def init_hparams(params):
        return {"lr": tree_scalars_like(params, lr)}

    def init_state(params, hparams):
        return {
            "prev": tree_map(torch.zeros_like, params),
            "step_size": tree_map(lambda p, a: torch.ones_like(p) * a, params, hparams["lr"]),
        }

    def leaf(p, g, prev, step_size):
        sign = torch.sign(g * prev)
        factor = torch.where(sign > 0, eta_plus, torch.where(sign < 0, eta_minus, 1.0)).to(step_size.dtype)
        step_size = torch.clamp(step_size * factor, step_size_min, step_size_max)
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        return p - torch.sign(g_eff) * step_size, g_eff, step_size

    def update(grads, state, params, hparams):
        new_params, prev, step_size = _leafwise(leaf, 3, params, grads, state["prev"], state["step_size"])
        return new_params, {"prev": prev, "step_size": step_size}

    def project_hparams(hparams):
        return {"lr": tree_map(lambda a: torch.clamp(a, min=1e-4), hparams["lr"])}

    return InnerOptimizer("rprop", init_hparams, init_state, update, project_hparams)


_BUILDERS = {"sgd": sgd, "gd": sgd, "adam": adam, "rprop": rprop}


def build_inner_optimizer(kind: str, **kwargs) -> InnerOptimizer:
    if kind not in _BUILDERS:
        raise ValueError(f"unknown inner optimizer {kind!r}; expected one of {sorted(_BUILDERS)}")
    return _BUILDERS[kind](**kwargs)
