"""The adaptation strategies other than the full MAML++ rollout (JAX
package ``core/strategies.py``).

``core/maml.py`` owns the full rollout (``maml++``, and ``fomaml``, which is
that rollout with the second-order switch pinned off); this module owns
what the other two strategies do differently:

- ``anil`` (Raghu et al., "Rapid Learning or Feature Reuse?"): the inner
  loop adapts only the classifier head, chosen by top-level name
  (:data:`HEAD_KEYS`: VGG and ResNet call it ``fc``, DenseNet
  ``classifier``). The head carries the task axis; the body is one tree,
  shared by every task, that each forward reads unbatched
  (``torch.func.vmap`` with ``in_dims=None``), so the inner gradient and
  the fused update (B1, and B2 in the outer backward) cover the head's
  leaves only. In ``train_step`` the body still requires grad: its
  meta-gradient flows through every forward, and under second order
  through the head's inner gradients too, as in the JAX package. The
  hparams and the inner optimizer's state arrive as full trees and are
  sliced to the head here (:func:`take_head`), so the ``TrainState`` and
  every checkpoint are the same for every strategy.
- ``protonet`` (Snell et al.): serving only. Adapt is one embedding forward
  and a masked per-class mean (the prototype table ``[n_way, D]``,
  ``D = n_way``: the network's float32 logits are the embedding); predict
  scores a query by the negative squared Euclidean distance to each
  prototype.

Every function here is task-batched like the rest of the port: support
``[T, S, H, W, C]``, labels ``[T, S]``, ``support_weight`` ``[T, S]``.
"""

from typing import Any, Dict, Optional, Tuple

import torch
from torch.func import grad, vmap

from ..config import SERVING_STRATEGIES
from ..ops.losses import cross_entropy
from ..utils.trees import tree_map
from .remat import apply_remat_policy

#: top-level parameter names of the classifier head
HEAD_KEYS = ("fc", "classifier")


# ---------------------------------------------------------------------------
# ANIL: the head/body partition
# ---------------------------------------------------------------------------


def split_head_body(params: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Partition a parameter tree into (head, body) by top-level name;
    raises where the tree has no entry named in :data:`HEAD_KEYS`."""
    if not isinstance(params, dict):
        raise ValueError(f"ANIL needs a dict parameter tree with a named head; got {type(params).__name__}")
    head = {k: v for k, v in params.items() if k in HEAD_KEYS}
    if not head:
        raise ValueError(
            f"ANIL head/body partition found no head entry (looked for {list(HEAD_KEYS)} among top-level "
            f"keys {sorted(params)}); name the classifier head 'fc' or 'classifier'"
        )
    body = {k: v for k, v in params.items() if k not in HEAD_KEYS}
    return head, body


def merge_head_body(head: Dict[str, Any], body: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`split_head_body`."""
    return {**body, **head}


def take_head(tree: Any) -> Any:
    """The head's part of a tree derived from the params (the hparams
    ``{"lr": params-like}``, Adam's state ``{"exp_avg": params-like,
    ...}``): a dict holding a head key is a params-like level and is
    filtered there; other containers recurse; leaves and SGD's empty state
    pass through."""
    if isinstance(tree, dict):
        if any(k in tree for k in HEAD_KEYS):
            return {k: v for k, v in tree.items() if k in HEAD_KEYS}
        return {k: take_head(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(take_head(v) for v in tree)
    return tree


def _expand(tree, tasks: int):
    """Every leaf as a ``[tasks, ...]`` view of itself (no copy)."""
    return tree_map(lambda a: a.unsqueeze(0).expand(tasks, *a.shape), tree)


# ---------------------------------------------------------------------------
# ANIL: head-only rollouts (the counterparts of MAMLSystem._adapt_loop and
# of the MSL branch of MAMLSystem._rollout)
# ---------------------------------------------------------------------------


def _anil_start(system, params, inner_state, hparams, tasks: int, stacked: bool):
    """The head carry, the body and the head's hparams and inner state at
    rollout entry, cast once by the precision policy. The head and the
    inner state get the task axis (``MAMLSystem._rollout_start``); so has
    the body where ``stacked`` (fast weights that already carry it:
    refinement), else it stays one tree."""
    head, body = split_head_body(params)
    head, head_state = system._rollout_start(head, take_head(inner_state), tasks, stacked)
    return head, system.precision.cast_fast_weights(body), head_state, take_head(hparams)


def _anil_inner_update(system, bn_state, x_support, y_support, second_order: bool,
                       support_weight=None, body_dim=None):
    """``inner_update(head, opt_state, hp, body) -> (head', opt_state')``:
    one support-set gradient step of every task's head. The gradient is
    taken with respect to the head alone; the body goes into every forward
    (unbatched where ``body_dim`` is None). Second order keeps the inner
    gradients' graph, which reaches the body too; first order detaches
    them."""

    def support_loss(h, body, x, y, w):
        logits = system._apply_forward(merge_head_body(h, body), bn_state, x, w)
        return cross_entropy(logits, y, sample_weight=w)

    task_grads = vmap(grad(support_loss),
                      in_dims=(0, body_dim, 0, 0, None if support_weight is None else 0))

    def inner_update(h, opt_s, hp, body):
        grads = task_grads(h, body, x_support, y_support, support_weight)
        if not second_order:
            grads = tree_map(torch.Tensor.detach, grads)
        return system.inner_opt.update(grads, opt_s, h, hp)

    return inner_update


def anil_adapt_loop(system, params, bn_state, hparams, inner_state, x_support, y_support,
                    second_order: bool, num_steps: int, support_weight=None, stacked: bool = False):
    """ANIL's ``_adapt_loop``: ``num_steps`` head-only support updates ->
    the full fast-weight tree with a leading ``T`` on every leaf (the
    adapted head over the body, which is an expanded view of the one
    body unless ``params`` was ``stacked``). ``hparams`` and
    ``inner_state`` are the full trees."""
    tasks = x_support.shape[0]
    head, body, opt_s, head_hp = _anil_start(system, params, inner_state, hparams, tasks, stacked)
    step = apply_remat_policy(
        _anil_inner_update(system, bn_state, x_support, y_support, second_order, support_weight,
                           body_dim=0 if stacked else None),
        system.remat_policy,
    )
    for hp in system._hparam_sequence(head_hp, num_steps):
        head, opt_s = step(head, opt_s, hp, body)
    return merge_head_body(head, body if stacked else _expand(body, tasks))


def _forward_head_tasks(system, head, body, bn_state, x):
    """Task-stacked heads over the one body, queries ``[T, N, ...]`` -> f32
    logits ``[T, N, n_way]``."""
    return vmap(lambda h, xq: system._apply_forward(merge_head_body(h, body), bn_state, xq))(head, x)


def anil_rollout(system, params, bn_state, hparams, inner_state, x_support, y_support, x_target,
                 y_target, loss_weights, second_order: bool, num_steps: int, per_step_target: bool):
    """ANIL's ``_rollout``: the same (per-task losses ``[T]``, final target
    logits ``[T, Q, n_way]``) with the head-only loop. In the MSL window
    (``per_step_target``) every head update's target loss is weighted as
    in maml++."""
    tasks = x_support.shape[0]
    task_ce = vmap(cross_entropy)
    head, body, opt_s, head_hp = _anil_start(system, params, inner_state, hparams, tasks, stacked=False)
    inner_update = _anil_inner_update(system, bn_state, x_support, y_support, second_order)
    if per_step_target:

        def msl_step(h, opt_s, hp, weight, body):
            h, opt_s = inner_update(h, opt_s, hp, body)
            logits = _forward_head_tasks(system, h, body, bn_state, x_target)
            return h, opt_s, logits, weight * task_ce(logits, y_target)

        step = apply_remat_policy(msl_step, system.remat_policy)
        weighted = []
        for i, hp in enumerate(system._hparam_sequence(head_hp, num_steps)):
            head, opt_s, logits, loss = step(head, opt_s, hp, loss_weights[i], body)
            weighted.append(loss)
        return torch.stack(weighted).sum(0), logits
    step = apply_remat_policy(inner_update, system.remat_policy)
    for hp in system._hparam_sequence(head_hp, num_steps):
        head, opt_s = step(head, opt_s, hp, body)
    logits = _forward_head_tasks(system, head, body, bn_state, x_target)
    return task_ce(logits, y_target), logits


# ---------------------------------------------------------------------------
# ProtoNet: a forward-only adapt (the prototype table) and a distance predict
# ---------------------------------------------------------------------------


def _embed_tasks(system, params, bn_state, x, sample_weight):
    """The master params' f32 logits of every task's batch ``[T, N, ...]``
    -> ``[T, N, D]``, transductive BN per task (padding masked out)."""
    forward = vmap(lambda xt, wt: system._apply_forward(params, bn_state, xt, wt),
                   in_dims=(0, None if sample_weight is None else 0))
    return forward(x, sample_weight)


def protonet_prototypes(system, params, bn_state, x_support, y_support, support_weight=None) -> Dict[str, Any]:
    """ProtoNet ``adapt``: one embedding forward of every task's support
    set and a masked per-class mean -> ``{"prototypes": [T, n_way, D]}``.
    ``support_weight`` masks padded samples out of the means and of the BN
    statistics, so padding never changes the table."""
    z = _embed_tasks(system, params, bn_state, x_support, support_weight)
    one_hot = torch.nn.functional.one_hot(y_support, system.cfg.num_classes_per_set).to(z.dtype)
    if support_weight is not None:
        one_hot = one_hot * support_weight[..., None].to(z.dtype)
    counts = one_hot.sum(1)  # [T, n_way]
    sums = one_hot.transpose(1, 2) @ z  # [T, n_way, D]
    return {"prototypes": sums / torch.clamp(counts, min=1.0)[..., None]}


def protonet_logits(system, params, bn_state, prototypes: Dict[str, Any], x_query, sample_weight=None):
    """ProtoNet ``predict``: the queries ``[T, Q, ...]`` embedded through the
    master params, scored against each task's table as ``-|z - c|^2`` ->
    ``[T, Q, n_way]``. The squared distance is summed from the differences
    (not expanded as ``|z|^2 - 2 z.c + |c|^2``, which cancels digits)."""
    z = _embed_tasks(system, params, bn_state, x_query, sample_weight)
    c = prototypes["prototypes"]
    return -((z[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)


def protonet_prototype_shape(num_classes: int) -> Tuple[int, int]:
    """The shape of one task's prototype table."""
    return (num_classes, num_classes)


# ---------------------------------------------------------------------------
# the strategy of a request
# ---------------------------------------------------------------------------


def validate_request_strategy(name: Optional[str], configured) -> str:
    """``None`` resolves to the deployment's default (the first configured
    entry); an unknown name raises ``ValueError``. A valid name that is not
    configured passes: configuring a strategy plans its programs, and
    without a strict guard (the JAX package's default) an unplanned
    strategy is served on demand."""
    if name is None:
        return configured[0]
    if name not in SERVING_STRATEGIES:
        raise ValueError(f"unknown strategy {name!r}; valid: {list(SERVING_STRATEGIES)}")
    return name
