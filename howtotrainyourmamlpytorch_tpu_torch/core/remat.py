"""Rematerialisation of one inner step (JAX package
``core/maml.py::apply_remat_policy``): the activations of a step are
recomputed in the outer backward instead of kept from the forward.

``torch.utils.checkpoint`` does not serve here. Its non-reentrant form
works through saved-tensor hooks, which ``torch.func.vmap`` and
``torch.func.grad`` (the step's per-task support gradients) refuse; its
reentrant form accumulates into ``.grad`` and so cannot sit under the
meta-step's ``torch.autograd.grad``. So :class:`_Recompute` is the
reentrant design with ``torch.autograd.grad``: its forward runs the step
without recording it and keeps the step's inputs; its backward runs the
step again with autograd on and differentiates the recomputed outputs.
Inside the recompute the step's own second-order graph is built as in a
step without remat, so the meta-gradient is the same function.

The selective policies keep the outputs of the convolutions and matrix
products (:data:`DOT_OPS`): a dispatch mode records them in the forward, and
in the recompute the same ops, met in the same order, return the recorded
tensors instead of computing again (autograd above the mode still records
each op, with its inputs). A recompute that meets another op sequence raises.
"""

import functools
from typing import Callable, List

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

#: the ops whose outputs the two selective policies keep: the
#: convolutions and matrix products (XLA's "dots")
DOT_OPS = (
    torch.ops.aten.convolution.default,
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default,
)
POLICIES = ("none", "full", "dots_saveable", "dots_with_no_batch_dims_saveable")


class _RecordDots(TorchDispatchMode):
    """Runs every op, and keeps the outputs of :data:`DOT_OPS` in order."""

    def __init__(self):
        super().__init__()
        self.saved: List[torch.Tensor] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in DOT_OPS:
            self.saved.append(out)
        return out


class _ReplayDots(TorchDispatchMode):
    """Returns the recorded output for each of :data:`DOT_OPS`, in order;
    runs every other op."""

    def __init__(self, saved: List[torch.Tensor]):
        super().__init__()
        self.saved = saved
        self.i = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in DOT_OPS:
            return func(*args, **(kwargs or {}))
        if self.i >= len(self.saved):
            raise RuntimeError(f"remat: the recompute met more dot ops than the forward ({func})")
        out = self.saved[self.i]
        self.i += 1
        return out


class _Recompute(torch.autograd.Function):
    """``apply(run, dots, *inputs) -> outputs``: ``run`` maps a list of
    tensors to a tuple of tensors. Forward: ``run`` without recording;
    backward: ``run`` again (replaying the recorded dot outputs when
    ``dots``) and the VJP of its outputs."""

    @staticmethod
    def forward(ctx, run, dots, *inputs):
        ctx.run = run
        ctx.record = _RecordDots() if dots else None
        if ctx.record is None:
            outs = run(list(inputs))
        else:
            with ctx.record:
                outs = run(list(inputs))
        ctx.save_for_backward(*inputs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cts):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            if ctx.record is None:
                outs = ctx.run(inputs)
            else:
                replay = _ReplayDots(ctx.record.saved)
                with replay:
                    outs = ctx.run(inputs)
                if replay.i != len(replay.saved):
                    raise RuntimeError("remat: the recompute met fewer dot ops than the forward")
        pairs = [(o, c) for o, c in zip(outs, cts) if c is not None and o.requires_grad]
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(
            torch.autograd.grad([o for o, _ in pairs], wanted, [c for _, c in pairs], allow_unused=True)
            if pairs and wanted else [None] * len(wanted)
        )
        return (None, None, *(next(grads) if t.requires_grad else None for t in inputs))


def apply_remat_policy(step: Callable, policy: str) -> Callable:
    """One inner step wrapped per ``Config.resolved_remat_policy``.

    ``"none"`` keeps every activation of the step for the outer backward.
    ``"full"`` keeps only the step's inputs and recomputes the rest in the
    outer backward: the recompute runs the step's ``vmap(grad(...))`` and
    its inner update again (so B1 launches once more per step).
    ``"dots_saveable"`` and ``"dots_with_no_batch_dims_saveable"`` also
    keep the outputs of the convolutions and matrix products. XLA tells the
    two apart by the batch dimensions of a dot; torch's convolutions and
    matrix products have none in that sense, so here they are one policy.
    Every policy computes the same function: remat trades bytes for
    recompute, never the result. The wrapper applies only where autograd
    records the step; under ``torch.no_grad`` (eval, serving) the step runs
    as it is. ``step`` takes and returns trees of tensors (dicts, tuples)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; expected one of {POLICIES}")
    if policy == "none":
        return step
    dots = policy != "full"

    @functools.wraps(step)
    def remat_step(*args):
        leaves, spec = pytree.tree_flatten(args)
        if not torch.is_grad_enabled() or not any(t.requires_grad for t in leaves):
            return step(*args)
        out_spec = []

        def run(flat):
            outs, spec_out = pytree.tree_flatten(step(*pytree.tree_unflatten(flat, spec)))
            out_spec[:] = [spec_out]
            return tuple(outs)

        outs = _Recompute.apply(run, dots, *leaves)
        return pytree.tree_unflatten(list(outs), out_spec[0])

    return remat_step
