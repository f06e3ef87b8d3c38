"""The fused LSLR inner update, ``p <- p - lr_t * g`` with one learned lr per
parameter tensor, as ONE kernel launch over the whole parameter tree, and
its backward as one more (JAX package ``ops/pallas_update.py``; the CUDA
kernels are ``csrc/fused_sgd.cu``, B1, and ``csrc/fused_sgd_bwd.cu``, B2).

Layout: every leaf is flattened and padded to whole 128-lane rows, and the
leaves are laid end to end in sorted-key order, so a tree becomes one
``[rows, 128]`` buffer; a tree whose leaves share a leading task axis ``T``
becomes ``[T * rows, 128]`` (task-major), and the task axis is simply more
rows. The lr travels as one f32 per row, gathered from the per-tensor lr
vector. Unlike the TPU kernels there is no padding of the row count to a
tile multiple: the CUDA kernels walk the rows with a grid-stride loop.

Numerics (the JAX docstring's contract): accumulate in f32, the lr's dtype,
and round once to the operand dtype on store. With f32 operands the forward
is the plain ``p - lr * g``. The backward gives ``dp = ct``,
``dg = -lr * ct`` (one rounding to the operand dtype) and the per-row lr
cotangent ``-sum(ct * g)`` in f32.

:func:`fused_sgd_rows` is ``FusedSGD.apply``, an ``autograd.Function``
whose forward is B1 and whose backward is B2: the second-order meta-gradient
flows through it into the fast weights, the inner gradients and the lrs.
For CUDA tensors each launches its kernel or raises; for CPU tensors each
computes its plain PyTorch twin (:func:`fused_sgd_rows_reference`,
:func:`fused_sgd_bwd_reference`), because the tensors lie on the CPU. The
per-row lr column is built differentiably (:func:`lr_rows_for`: ``cat`` and
``expand``), so autograd's transpose of it segment-sums the row cotangents
over leaves and tasks into the per-tensor lr gradients, the step XLA does
outside the JAX backward kernel.
"""

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.trees import Path, tree_flatten, tree_leaves, tree_unflatten
from .precision import as_f32

LANE = 128
KERNEL_SOURCE = "fused_sgd.cu"
BWD_KERNEL_SOURCE = "fused_sgd_bwd.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last :func:`reset_launch_counts` (CPU calls,
#: which take the twin, do not count)
launch_counts = {"fused_sgd": 0, "fused_sgd_bwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class PackedLayout(NamedTuple):
    """Static description of the tree -> ``[batch * rows, 128]`` packing."""

    paths: Tuple[Path, ...]
    shapes: Tuple[Tuple[int, ...], ...]  # per-task leaf shapes
    leaf_rows: Tuple[int, ...]  # 128-lane rows each leaf occupies
    rows: int  # rows per task
    batch: Tuple[int, ...]  # leading task axes shared by every leaf: () or (T,)


def build_layout(tree, batch_dims: int = 0) -> PackedLayout:
    """Layout of ``tree``; its leaves' first ``batch_dims`` axes are task
    axes, packed as extra rows."""
    leaves, paths = tree_flatten(tree)
    batch = tuple(leaves[0].shape[:batch_dims]) if leaves else ()
    shapes = []
    for leaf in leaves:
        if tuple(leaf.shape[:batch_dims]) != batch:
            raise ValueError(f"leaves disagree on the task axes: {batch} vs {tuple(leaf.shape)}")
        shapes.append(tuple(leaf.shape[batch_dims:]))
    leaf_rows = tuple(max(1, -(-math.prod(s) // LANE)) for s in shapes)
    return PackedLayout(tuple(paths), tuple(shapes), leaf_rows, sum(leaf_rows), batch)


def pack(tree, layout: PackedLayout) -> torch.Tensor:
    """Tree -> contiguous ``[batch * rows, 128]`` buffer (zeros in padding)."""
    parts = []
    for leaf, n_rows in zip(tree_leaves(tree), layout.leaf_rows):
        flat = leaf.reshape(*layout.batch, -1)
        parts.append(F.pad(flat, (0, n_rows * LANE - flat.shape[-1])))
    return torch.cat(parts, dim=-1).reshape(-1, LANE)


def unpack(buf: torch.Tensor, layout: PackedLayout):
    """``[batch * rows, 128]`` buffer -> tree whose leaves are views into it."""
    flat = buf.reshape(*layout.batch, layout.rows * LANE)
    leaves, offset = [], 0
    for shape, n_rows in zip(layout.shapes, layout.leaf_rows):
        size = math.prod(shape)
        leaves.append(flat[..., offset : offset + size].reshape(*layout.batch, *shape))
        offset += n_rows * LANE
    return tree_unflatten(list(layout.paths), leaves)


def lr_rows_for(lr_tree, layout: PackedLayout) -> torch.Tensor:
    """Per-row f32 lr column ``[batch * rows]``: each leaf's scalar lr
    repeated over that leaf's rows, then over the task axis."""
    per_task = torch.cat(
        [
            as_f32(lr.reshape(1)).expand(n_rows)
            for lr, n_rows in zip(tree_leaves(lr_tree), layout.leaf_rows)
        ]
    )
    tasks = math.prod(layout.batch)
    return per_task.expand(tasks, layout.rows).reshape(-1)


def fused_sgd_rows_reference(p_buf, g_buf, lr_rows):
    """B1's plain twin: f32 multiply, f32 subtract, one rounding to the
    operand dtype."""
    return (p_buf.float() - lr_rows[:, None] * g_buf.float()).to(p_buf.dtype)


def fused_sgd_bwd_reference(ct, g_buf, lr_rows):
    """B2's plain twin -> ``(dg, dlr_rows)``: ``dg = -lr_row * ct`` as one
    f32 product rounded once to the operand dtype, ``dlr_row = -sum(ct * g)``
    over the row's lanes in f32."""
    dg = (-lr_rows[:, None] * ct.float()).to(ct.dtype)
    dlr_rows = -(ct.float() * g_buf.float()).sum(1)
    return dg, dlr_rows


def _check(p_buf, g_buf, lr_rows, names=("p", "g")) -> None:
    """Shape, dtype and device checks shared by both kernels' wrappers:
    two ``[rows, 128]`` operands of one dtype (float32 or bfloat16) and a
    float32 ``[rows]`` lr column, all on one device."""
    a, b = names
    if p_buf.dim() != 2 or p_buf.shape[1] != LANE or g_buf.shape != p_buf.shape:
        raise ValueError(
            f"fused_sgd: {a} and {b} must both be [rows, {LANE}], got "
            f"{tuple(p_buf.shape)} and {tuple(g_buf.shape)}"
        )
    if lr_rows.shape != (p_buf.shape[0],) or lr_rows.dtype != torch.float32:
        raise ValueError(
            f"fused_sgd: lr_rows must be float32 [{p_buf.shape[0]}], got "
            f"{lr_rows.dtype} {tuple(lr_rows.shape)}"
        )
    if p_buf.dtype not in _DTYPE_CODES or g_buf.dtype != p_buf.dtype:
        raise TypeError(
            f"fused_sgd: {a} and {b} must share a dtype in float32/bfloat16, "
            f"got {p_buf.dtype} and {g_buf.dtype}"
        )
    if not (p_buf.device == g_buf.device == lr_rows.device):
        raise ValueError(f"fused_sgd: {a}, {b} and lr_rows must be on one device")


def _cuda_operands(**tensors) -> None:
    """The kernels take contiguous, 16-byte aligned CUDA tensors only."""
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"fused_sgd: no kernel for device {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_sgd: {name} must be contiguous and 16-byte aligned")


def _launch_forward(p_buf, g_buf, lr_rows):
    """B1 (csrc/fused_sgd.cu), one launch on the current stream."""
    _cuda_operands(p=p_buf, g=g_buf, lr_rows=lr_rows)
    from ._kernels import library

    lib = library(KERNEL_SOURCE)
    out = torch.empty_like(p_buf)
    with torch.cuda.device(p_buf.device):
        err = lib.fused_sgd_forward(
            p_buf.data_ptr(),
            g_buf.data_ptr(),
            lr_rows.data_ptr(),
            out.data_ptr(),
            p_buf.shape[0],
            _DTYPE_CODES[p_buf.dtype],
            torch.cuda.current_stream(p_buf.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_sgd_forward failed: cudaError_t {err}")
    launch_counts["fused_sgd"] += 1
    return out


def _launch_backward(ct, g_buf, lr_rows):
    """B2 (csrc/fused_sgd_bwd.cu), one launch on the current stream."""
    _cuda_operands(ct=ct, g=g_buf, lr_rows=lr_rows)
    from ._kernels import library

    lib = library(BWD_KERNEL_SOURCE)
    dg = torch.empty_like(g_buf)
    dlr_rows = torch.empty_like(lr_rows)
    with torch.cuda.device(ct.device):
        err = lib.fused_sgd_backward(
            ct.data_ptr(),
            g_buf.data_ptr(),
            lr_rows.data_ptr(),
            dg.data_ptr(),
            dlr_rows.data_ptr(),
            ct.shape[0],
            _DTYPE_CODES[ct.dtype],
            torch.cuda.current_stream(ct.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_sgd_backward failed: cudaError_t {err}")
    launch_counts["fused_sgd_bwd"] += 1
    return dg, dlr_rows


def fused_sgd_rows_backward(ct, g_buf, lr_rows):
    """B2's wrapper -> ``(dg, dlr_rows)``: the CUDA kernel for CUDA tensors
    (one launch, counted), the plain twin for CPU tensors."""
    _check(ct, g_buf, lr_rows, names=("ct", "g"))
    if ct.device.type == "cpu":
        return fused_sgd_bwd_reference(ct, g_buf, lr_rows)
    return _launch_backward(ct, g_buf, lr_rows)


class FusedSGD(torch.autograd.Function):
    """``out = p - lr_rows[:, None] * g`` with its VJP, as the JAX package's
    ``jax.custom_vjp`` ``_fused_sgd`` gives it: forward B1, backward B2
    (``dp = ct``, returned as it is). CPU tensors take the twins. The
    backward is the VJP only: differentiating it again raises."""

    @staticmethod
    def forward(p_buf, g_buf, lr_rows):
        if p_buf.device.type == "cpu":
            return fused_sgd_rows_reference(p_buf, g_buf, lr_rows)
        return _launch_forward(p_buf, g_buf, lr_rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, g_buf, lr_rows = inputs
        ctx.save_for_backward(g_buf, lr_rows)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        g_buf, lr_rows = ctx.saved_tensors
        if not (ctx.needs_input_grad[1] or ctx.needs_input_grad[2]):
            return ct, None, None
        dg, dlr_rows = fused_sgd_rows_backward(ct.contiguous(), g_buf, lr_rows)
        return ct, dg, dlr_rows


def fused_sgd_rows(p_buf, g_buf, lr_rows):
    """``out = p - lr_rows[:, None] * g`` over packed buffers, differentiable
    in all three: B1 for CUDA tensors (one launch, counted) with B2 as its
    backward, the plain twins for CPU tensors."""
    _check(p_buf, g_buf, lr_rows)
    return FusedSGD.apply(p_buf, g_buf, lr_rows)


def fused_sgd_update(params, grads, lr_tree, layout: PackedLayout = None):
    """One LSLR SGD step ``p - lr_t * g`` over the whole tree as one kernel
    launch, differentiable in params, grads and lrs. ``lr_tree`` holds one scalar per leaf. The leaves of ``params``
    and ``grads`` may share one leading task axis (``layout`` built with
    ``batch_dims=1``): the tasks of a flush then update in the same launch.
    Returns a tree of views into the kernel's output buffer."""
    if layout is None:
        layout = build_layout(params)
    out = fused_sgd_rows(
        pack(params, layout), pack(grads, layout), lr_rows_for(lr_tree, layout)
    )
    return unpack(out, layout)
