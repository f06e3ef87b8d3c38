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
products (:data:`DOT_OPS`). A C++ dispatch hook (``csrc/remat_dots.cpp``, on
the ``ADInplaceOrView`` key of those four ops alone: below autograd and
below ``vmap``'s batching rule) records them in the forward, and in the
recompute the same ops, met in the same order, return the recorded tensors
instead of computing again (autograd above the hook still records each op,
with its inputs). A recompute that meets another op sequence raises. The
hook acts only inside the convolution and matrix-product call sites
(:func:`dot`, which ``models/layers.py`` calls around each; a ctypes call
arms and disarms the site), never on the step's other dots. No op of the
step reaches Python. The outputs of the support gradient's VJP
(``aten.convolution_backward``), which JAX's ``dots_saveable`` keeps too,
are recomputed: keeping them cost more memory and was no faster. The hook is
built with g++ at first use (:func:`dot_hook`); a selective policy raises
where it cannot be built.
"""

import ctypes
import functools
import hashlib
import os
import threading
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

#: the ops whose outputs the two selective policies keep: the
#: convolutions and matrix products (XLA's "dots"), in the order of
#: ``csrc/remat_dots.cpp``'s op codes
DOT_OPS = (
    torch.ops.aten.convolution.default,
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default,
)
POLICIES = ("none", "full", "dots_saveable", "dots_with_no_batch_dims_saveable")

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOOK_SOURCE = os.path.join(_PACKAGE, "csrc", "remat_dots.cpp")
HOOK_CFLAGS = ("-O2",)
_hook_lock = threading.Lock()
_hook: Optional[Callable[[int], None]] = None


def _hook_name() -> str:
    """The hook's library name, and its build directory's under the
    package's ``build/`` (listed in ``.gitignore``): it hashes the source,
    the flags and torch's version, so a library built against another torch
    is never loaded."""
    digest = hashlib.sha256(" ".join((torch.__version__, *HOOK_CFLAGS)).encode())
    with open(HOOK_SOURCE, "rb") as f:
        digest.update(f.read())
    return f"remat_dots_{digest.hexdigest()[:16]}"


def dot_hook() -> Callable[[int], None]:
    """The dispatch hook of ``csrc/remat_dots.cpp``, built with g++ at the
    first call in a process (``torch.utils.cpp_extension``: some seconds;
    later processes load the built library) and loaded once. Returns the
    site switch (``remat_dots_site(on)``, through ctypes). Raises
    ``RuntimeError`` where the hook cannot be built or loaded."""
    global _hook
    with _hook_lock:
        if _hook is None:
            name = _hook_name()
            build_dir = os.path.join(_PACKAGE, "build", name)
            try:
                from torch.utils import cpp_extension

                os.makedirs(build_dir, exist_ok=True)
                path = cpp_extension.load(name=name, sources=[HOOK_SOURCE], build_directory=build_dir,
                                          extra_cflags=list(HOOK_CFLAGS), is_python_module=False, verbose=False)
                site = ctypes.CDLL(path).remat_dots_site
            except Exception as exc:  # a missing compiler, a failed build or load: nothing else computes the policy
                raise RuntimeError(f"remat: the selective policies run through the C++ dispatch hook "
                                   f"{HOOK_SOURCE}, which could not be built or loaded in {build_dir} "
                                   f"(g++ and ninja, at first use): {exc}") from exc
            site.argtypes, site.restype = [ctypes.c_int], None
            _hook = site
    return _hook


class _Site(threading.local):
    """The site switch of the record or replay this thread runs, if any."""

    site: Optional[Callable[[int], None]] = None


_SITE = _Site()


def dot(fn: Callable, x, w, b, bias_view=(-1,), **kwargs):
    """A convolution or matrix product ``fn(x, w, b, **kwargs)``, at an
    armed call site of the dispatch hook where this thread records or
    replays a selective remat step (a thread-local lookup otherwise). There
    the bias is added after ``fn`` (``b.reshape(bias_view)``), outside the
    site: ``vmap``'s batching rules add a batched bias in a separate op in
    any case, so the values are the same."""
    site = _SITE.site
    if site is None:
        return fn(x, w, b, **kwargs)
    site(1)
    try:
        out = fn(x, w, None, **kwargs)
    finally:
        site(0)
    return out if b is None else out + b.reshape(bias_view)


def _run_at_sites(run, inputs, tape=None):
    """``run(inputs)`` recording this thread's dots at their sites
    (``tape`` None) or replaying ``tape``. Returns the outputs, the tape
    (the recorded outputs and their op codes; empty after a replay) and
    how many entries it recorded or replayed."""
    site, hook = dot_hook(), torch.ops.remat_dots
    if tape is None:
        hook.record()
    else:
        hook.replay(*tape)
    _SITE.site = site
    try:
        outs = run(inputs)
    finally:
        _SITE.site = None
        outs_t, kinds, count = hook.finish()
    return outs, (outs_t, kinds), count


class _Recompute(torch.autograd.Function):
    """``apply(run, dots, *inputs) -> outputs``: ``run`` maps a list of
    tensors to a tuple of tensors. Forward: ``run`` without recording;
    backward: ``run`` again (replaying the recorded dot outputs when
    ``dots``) and the VJP of its outputs."""

    @staticmethod
    def forward(ctx, run, dots, *inputs):
        ctx.run, ctx.tape = run, None
        if not dots:
            outs = run(list(inputs))
        else:
            outs, ctx.tape, _ = _run_at_sites(run, list(inputs))
        ctx.save_for_backward(*inputs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cts):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            if ctx.tape is None:
                outs = ctx.run(inputs)
            else:
                outs, _, replayed = _run_at_sites(ctx.run, inputs, ctx.tape)
                if replayed != len(ctx.tape[1]):
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
    if dots:
        dot_hook()  # built (or refused) here, before the first step

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
