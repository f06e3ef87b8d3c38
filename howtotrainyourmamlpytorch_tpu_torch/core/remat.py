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
products (:data:`DOT_OPS`). A dispatch mode (:class:`_Dots`) records them in
the forward, and in the recompute the same ops, met in the same order,
return the recorded tensors instead of computing again (autograd above the
mode still records each op, with its inputs). A recompute that meets
another op sequence raises. The mode is entered only at the call sites of
the convolutions and matrix products (:func:`dot`, which
``models/layers.py`` calls around each), never around the whole step: so
it sees the dot op and the views and copy the batching rule of ``vmap``
makes around it, and no other op of the step. A convolution's output is
recorded without the mode: it is the base of the view the site returns,
below the wrappers of ``vmap`` and ``grad``, so only the recompute enters
the mode at a convolution. The outputs of the support gradient's VJP
(``aten.convolution_backward``), which JAX's ``dots_saveable`` keeps too,
are recomputed: keeping them cost more memory and was no faster.
"""

import functools
import threading
from typing import Callable, List, Optional

import torch
from torch._C import _functorch
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
_DOT_SET = frozenset(DOT_OPS)
_CONV = torch.ops.aten.convolution.default
POLICIES = ("none", "full", "dots_saveable", "dots_with_no_batch_dims_saveable")


class _Site(threading.local):
    """The record or replay mode of the step this thread runs, if any."""

    dots: Optional["_Dots"] = None


_SITE = _Site()


class _Dots(TorchDispatchMode):
    """Records (``saved`` None) or replays the outputs of :data:`DOT_OPS`
    met while it is entered; any other op (a view of ``vmap``'s batching
    rule) runs as it is. ``ops`` counts every op it saw."""

    def __init__(self, saved: Optional[List] = None):
        super().__init__()
        self.replaying = saved is not None
        self.saved = [] if saved is None else saved
        self.i = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if not self.replaying:
            out = func(*args, **(kwargs or {}))
            if func in _DOT_SET:
                self.saved.append((func, out))
            return out
        if func not in _DOT_SET:
            return func(*args, **(kwargs or {}))
        if self.i >= len(self.saved):
            raise RuntimeError(f"remat: the recompute met more dot ops than the forward ({func})")
        recorded, out = self.saved[self.i]
        if recorded is not func:
            raise RuntimeError(f"remat: the recompute met {func} where the forward met {recorded}")
        if func is _CONV and tuple(out.shape) != _conv_shape(*args):
            raise RuntimeError(f"remat: a recorded convolution has shape {tuple(out.shape)}, the recompute's "
                               f"{_conv_shape(*args)}")
        self.i += 1
        return out


def _conv_shape(x, w, b, stride, padding, dilation, transposed, output_padding, groups):
    """``aten.convolution``'s output shape (not transposed)."""
    spatial = [(n + 2 * p - d * (k - 1) - 1) // s + 1
               for n, k, s, p, d in zip(x.shape[2:], w.shape[2:], stride, padding, dilation)]
    return (x.shape[0], w.shape[0], *spatial)


def _dispatched(t: torch.Tensor) -> torch.Tensor:
    """The tensor below the wrappers of ``vmap`` and ``grad``."""
    while _functorch.is_functorch_wrapped_tensor(t):
        t = _functorch.get_unwrapped(t)
    return t


def dot(fn: Callable, x, w, b, bias_view=(-1,), conv: bool = False, **kwargs):
    """A convolution (``conv``) or matrix product ``fn(x, w, b,
    **kwargs)``, inside the record or replay mode of a selective remat step
    where this thread runs one (a global lookup otherwise). There the bias
    is added after ``fn`` (``b.reshape(bias_view)``), outside the mode:
    ``vmap``'s batching rules add a batched bias in a separate op in any
    case, so the values are the same, and the mode sees fewer ops."""
    dots = _SITE.dots
    if dots is None:
        return fn(x, w, b, **kwargs)
    if conv and not dots.replaying:
        out = fn(x, w, None, **kwargs)
        plain = _dispatched(out)
        dots.saved.append((_CONV, plain if plain._base is None else plain._base))
    else:
        with dots:
            out = fn(x, w, None, **kwargs)
    return out if b is None else out + b.reshape(bias_view)


def _run_at_sites(dots: _Dots, run, inputs):
    outer, _SITE.dots = _SITE.dots, dots
    try:
        return run(inputs)
    finally:
        _SITE.dots = outer


class _Recompute(torch.autograd.Function):
    """``apply(run, dots, *inputs) -> outputs``: ``run`` maps a list of
    tensors to a tuple of tensors. Forward: ``run`` without recording;
    backward: ``run`` again (replaying the recorded dot outputs when
    ``dots``) and the VJP of its outputs."""

    @staticmethod
    def forward(ctx, run, dots, *inputs):
        ctx.run = run
        ctx.record = _Dots() if dots else None
        if ctx.record is None:
            outs = run(list(inputs))
        else:
            outs = _run_at_sites(ctx.record, run, list(inputs))
        ctx.save_for_backward(*inputs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cts):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            if ctx.record is None:
                outs = ctx.run(inputs)
            else:
                replay = _Dots(ctx.record.saved)
                outs = _run_at_sites(replay, ctx.run, inputs)
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
