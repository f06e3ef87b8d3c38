"""The fused LSLR inner update, ``p <- p - lr_t * g`` with one learned lr per
parameter tensor, as ONE kernel launch over the parameter tree where its
leaves lie, and its backward as one more (JAX package
``ops/pallas_update.py``; the CUDA kernels are ``csrc/fused_sgd.cu``, B1,
and ``csrc/fused_sgd_bwd.cu``, B2).

Interface: ``L`` parameter leaves ``p_i`` of any shapes (with or without a
leading task axis), ``L`` gradient leaves ``g_i`` of the same shapes and
one dtype (float32 or bfloat16), and ``L`` float32 0-d lrs ``lr_i``. Each
kernel takes a table of the leaves' pointers in its launch parameters and
reads every lr in the kernel: nothing is packed, padded, gathered or copied
around a launch. The JAX package packs the tree into ``[rows, 128]`` tiles
for the TPU's VMEM and leaves the lr gather and the lr segment-sum to XLA;
here the kernels work on the leaves as they lie and sum the lr gradient
themselves.

Numerics (the JAX docstring's contract): accumulate in f32, the lr's dtype,
and round once to the operand dtype on store. The forward is
``out_i = p_i - lr_i * g_i`` with the product rounded before the
difference. The backward gives ``dp_i = ct_i`` (as it is), ``dg_i =
-lr_i * ct_i`` (one rounding to the operand dtype) and the per-tensor lr
cotangent ``dlr_i = -sum(ct_i * g_i)`` over all of the leaf's elements and
tasks, in f32.

:class:`FusedSGD` is an ``autograd.Function`` whose forward is B1 and whose
backward is B2: the second-order meta-gradient flows through it into the
fast weights, the inner gradients and the lrs. For CUDA tensors each
launches its kernel or raises; for CPU tensors each computes its plain
PyTorch twin (:func:`fused_sgd_tree_reference`,
:func:`fused_sgd_tree_bwd_reference`), because the tensors lie on the CPU.

A tensor-parallel row's tree (``parallel/mesh.py``: a split leaf is a dict
of blocks, each on its mesh entry's device) is launched once per mesh
entry: block ``j`` of every split leaf in launch ``j``, the other leaves in
launch 0, with the row's first entry. A launch never reads a leaf on
another device; the twins take the same groups.

Trees of up to :data:`MAX_LEAVES` leaves: the C functions launch with a
64-leaf table in the classic 4 KB parameter space where it holds the tree
(the VGG trees), else with a 256-leaf table (ResNet-12's 86 leaves,
DenseNet-12's 85) in the larger space CUDA 12.1 gives sm_70 and newer.

Work split: the kernels cut each leaf into chunks of 16 KB per operand
(four 16-byte vectors for each of a block's 256 threads); no chunk crosses
a leaf. A leaf whose operands start on 16-byte boundaries has a vector
body and a scalar rest of fewer than one vector; any other leaf is read
element by element, in the same launch. The split is made in C, from each
leaf's pointers and element count (csrc/tree_chunks.cuh ``fill_table``);
:func:`chunk_starts` reads it back. A leaf that is not contiguous (a
stride-0 cotangent, a slice, the transposed cotangent a batched linear
layer's backward gives its weight) is copied first and counted in
``contiguous_copies``.
"""

import contextlib
import threading
from typing import Dict, Iterator, List, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..parallel.mesh import shard_index
from ..utils.trees import tree_flatten, tree_unflatten
from .precision import as_f32

KERNEL_SOURCE = "fused_sgd.cu"
BWD_KERNEL_SOURCE = "fused_sgd_bwd.cu"
#: leaves the kernels' large table holds (csrc/tree_chunks.cuh kLargeLeaves,
#: 11.8 KB in Hopper's 32 KB launch parameter space); a tree of at most
#: SMALL_TABLE_LEAVES leaves launches with the 4 KB table (kSmallLeaves)
MAX_LEAVES = 256
SMALL_TABLE_LEAVES = 64
#: elements of one leaf the kernels index in 32 bits
MAX_LEAF_ELEMENTS = (1 << 31) - 1
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last :func:`reset_launch_counts` (CPU calls,
#: which take the twin, do not count), the launches of replayed CUDA graphs
#: included (:func:`count_replay`)
launch_counts = {"fused_sgd": 0, "fused_sgd_bwd": 0}
#: the part of ``launch_counts`` that replayed graphs launched
replayed_counts = {"fused_sgd": 0, "fused_sgd_bwd": 0}
#: launches recorded into CUDA graphs under capture, ever (a capture
#: launches nothing: its launches run at each replay). ``core/programs.py``
#: takes each graph's own tally through :func:`capture_tally`.
captured_counts = {"fused_sgd": 0, "fused_sgd_bwd": 0}
#: non-contiguous leaves the CUDA wrappers copied before a launch, since the
#: last :func:`reset_launch_counts`
contiguous_copies = 0
# the counts are updated under this lock: a server's batcher workers
# launch from several threads
_count_lock = threading.Lock()
# capture stream -> the launches recorded into its graph (:func:`capture_tally`)
_tallies: Dict[int, Dict[str, int]] = {}


def reset_launch_counts() -> None:
    global contiguous_copies
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = replayed_counts[name] = 0
        contiguous_copies = 0


@contextlib.contextmanager
def capture_tally(stream) -> Iterator[Dict[str, int]]:
    """-> name -> the launches recorded into the graph captured on
    ``stream`` inside the block: one graph's tally, whatever is captured
    meanwhile on other streams (an engine per card captures on its own).
    Keyed by the stream, not the thread: autograd runs a captured
    backward's launches (B2, a remat recompute's B1) on its own thread."""
    tally = {name: 0 for name in captured_counts}
    with _count_lock:
        _tallies[stream.cuda_stream] = tally
    try:
        yield tally
    finally:
        with _count_lock:
            del _tallies[stream.cuda_stream]


def _count_launch(name: str) -> None:
    with _count_lock:
        # a torch without CUDA has no capture to ask about
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            captured_counts[name] += 1
            tally = _tallies.get(torch.cuda.current_stream().cuda_stream)
            if tally is not None:
                tally[name] += 1
        else:
            launch_counts[name] += 1


def count_replay(tally) -> None:
    """One replay of a graph whose capture recorded ``tally`` (name ->
    launches): those kernels ran again, without a Python wrapper."""
    with _count_lock:
        for name, n in tally.items():
            launch_counts[name] += n
            replayed_counts[name] += n


def dlr_rounding_chain(chunks: int, element_size: int) -> int:
    """The longest chain of roundings a product ``ct * g`` passes in B2's sum
    over a leaf of ``chunks`` chunks (csrc/fused_sgd_bwd.cu): 4 V + 1 fused
    multiply-adds in a thread (four 16-byte vectors of V elements and a rest
    element), 5 shuffle levels in its warp and 3 over the block's 8 warps
    give a chunk's partial; then ceil(chunks / 32) additions in a lane and 5
    shuffle levels in the last block. So B2's ``dlr`` lies within
    (chain + 1) * 2**-24 * sum|ct * g| of the exact sum."""
    return (4 * (16 // element_size) + 1) + 5 + 3 + -(-chunks // 32) + 5


# ---------------------------------------------------------------------------
# plain twins (CPU tensors; chip_smoke.py holds the kernels against them)
# ---------------------------------------------------------------------------


def fused_sgd_tree_reference(ps, gs, lrs) -> List[torch.Tensor]:
    """B1's plain twin, per leaf: f32 multiply, f32 subtract, one rounding
    to the operand dtype."""
    return [(as_f32(p) - lr * as_f32(g)).to(p.dtype) for p, g, lr in zip(ps, gs, lrs)]


def fused_sgd_tree_bwd_reference(cts, gs, lrs) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """B2's plain twin -> ``(dg, dlr)``: per leaf ``dg = -lr * ct`` as one
    f32 product rounded once to the operand dtype, and ``dlr [L]`` with
    ``dlr_i = -sum(ct_i * g_i)``, one float32 ``sum`` over the leaf."""
    dgs = [(-lr * as_f32(ct)).to(ct.dtype) for ct, lr in zip(cts, lrs)]
    dlr = torch.stack([-(as_f32(ct) * as_f32(g)).sum() for ct, g in zip(cts, gs)])
    return dgs, dlr


# ---------------------------------------------------------------------------
# checks and launches
# ---------------------------------------------------------------------------


def _check(ps, gs, lrs, names=("p", "g")) -> None:
    """What both kernels take: 1 to MAX_LEAVES leaves, operands of one dtype
    (float32 or bfloat16) with equal shapes per leaf, 0-d float32 lrs, all
    on one device."""
    a, b = names
    if not (len(ps) == len(gs) == len(lrs)) or not ps:
        raise ValueError(f"fused_sgd: {len(ps)} {a}, {len(gs)} {b} and {len(lrs)} lr leaves")
    if len(ps) > MAX_LEAVES:
        raise ValueError(
            f"fused_sgd: {len(ps)} leaves, the kernels' largest table holds {MAX_LEAVES} "
            "(csrc/tree_chunks.cuh kLargeLeaves)"
        )
    dtype, device = ps[0].dtype, ps[0].device
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_sgd: operands must be float32 or bfloat16, got {dtype}")
    for i, (p, g, lr) in enumerate(zip(ps, gs, lrs)):
        if p.dtype != dtype or g.dtype != dtype:
            raise TypeError(f"fused_sgd: leaf {i}: {a} {p.dtype} and {b} {g.dtype}, expected {dtype}")
        if p.shape != g.shape:
            raise ValueError(f"fused_sgd: leaf {i}: {a} {tuple(p.shape)} and {b} {tuple(g.shape)} differ")
        if p.numel() > MAX_LEAF_ELEMENTS:
            raise ValueError(f"fused_sgd: leaf {i} has {p.numel()} elements, the kernels take {MAX_LEAF_ELEMENTS}")
        if lr.dtype != torch.float32 or lr.dim() != 0:
            raise ValueError(f"fused_sgd: leaf {i}: lr must be a 0-d float32 tensor, got {lr.dtype} {tuple(lr.shape)}")
        if not (p.device == g.device == lr.device == device):
            raise ValueError(f"fused_sgd: leaf {i}: {a}, {b} and lr must all be on {device}")


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    global contiguous_copies
    if t.is_contiguous():
        return t
    with _count_lock:
        contiguous_copies += 1
    return t.contiguous()


def _prepare(a_leaves, b_leaves, lrs):
    """For one launch -> ``(a_leaves, b_leaves, outs, records)``: the
    operands as the kernels read them (a leaf that is not contiguous is
    copied and counted in ``contiguous_copies``), the outputs, and the leaf
    records the C functions take (per leaf ``a, b, out, lr, numel``:
    csrc/tree_chunks.cuh). The records hold bare pointers: the caller keeps
    the returned operands alive until the launch is enqueued, or a copy's
    memory could go to another tensor of the stream first."""
    import ctypes

    a_leaves = [_contiguous(a) for a in a_leaves]
    b_leaves = [_contiguous(b) for b in b_leaves]
    outs = [torch.empty(b.shape, dtype=b.dtype, device=b.device) for b in b_leaves]
    records = []
    for a, b, out, lr in zip(a_leaves, b_leaves, outs, lrs):
        records += [a.data_ptr(), b.data_ptr(), out.data_ptr(), lr.data_ptr(), a.numel()]
    return a_leaves, b_leaves, outs, (ctypes.c_uint64 * len(records))(*records)


def _library(source: str, device: torch.device):
    if device.type != "cuda":
        raise ValueError(f"fused_sgd: no kernel for device {device}")
    from ._kernels import library

    return library(source)


def _launch_forward(ps, gs, lrs) -> List[torch.Tensor]:
    """B1 (csrc/fused_sgd.cu), one launch on the current stream."""
    device = ps[0].device
    lib = _library(KERNEL_SOURCE, device)
    ps, gs, outs, records = _prepare(ps, gs, lrs)
    with torch.cuda.device(device):
        err = lib.fused_sgd_forward(
            records, len(lrs), _DTYPE_CODES[ps[0].dtype], torch.cuda.current_stream(device).cuda_stream
        )
    if err != 0:
        raise RuntimeError(f"fused_sgd_forward failed: cudaError_t {err}")
    _count_launch("fused_sgd")
    return outs


def _launch_backward(cts, gs, lrs):
    """B2 (csrc/fused_sgd_bwd.cu), one launch on the current stream -> ``dg``
    per leaf and ``dlr [L]``. The kernel writes one partial sum per chunk
    into scratch and its last block adds them up."""
    device = cts[0].device
    lib = _library(BWD_KERNEL_SOURCE, device)
    cts, gs, dgs, records = _prepare(cts, gs, lrs)
    code = _DTYPE_CODES[cts[0].dtype]
    n_chunks = lib.fused_sgd_chunks(records, len(lrs), code, None)
    if n_chunks <= 0:
        raise RuntimeError(f"fused_sgd_chunks failed: {n_chunks}")
    partial = torch.empty(n_chunks, dtype=torch.float32, device=device)
    dlr = torch.empty(len(lrs), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.fused_sgd_backward(
            records, len(lrs), partial.data_ptr(), n_chunks, dlr.data_ptr(), code,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_sgd_backward failed: cudaError_t {err}")
    _count_launch("fused_sgd_bwd")
    return dgs, dlr


def chunk_starts(a_leaves, b_leaves) -> List[int]:
    """The split a launch over these CUDA leaves makes (csrc/tree_chunks.cuh
    ``fill_table``): where each leaf's chunks start, then the chunk count.
    For the error bound of B2's ``dlr`` (:func:`dlr_rounding_chain`); it
    launches nothing."""
    import ctypes

    lrs = [torch.zeros((), device=a_leaves[0].device)] * len(a_leaves)
    _check(a_leaves, b_leaves, lrs)
    lib = _library(BWD_KERNEL_SOURCE, a_leaves[0].device)
    a_leaves, b_leaves, _, records = _prepare(a_leaves, b_leaves, lrs)
    starts = (ctypes.c_int32 * (len(a_leaves) + 1))()
    if lib.fused_sgd_chunks(records, len(a_leaves), _DTYPE_CODES[a_leaves[0].dtype], starts) <= 0:
        raise RuntimeError("fused_sgd_chunks failed")
    return list(starts)


def fused_sgd_tree_backward(cts, gs, lrs):
    """B2's wrapper -> ``(dg per leaf, dlr [L])``: the CUDA kernel for CUDA
    tensors (one launch, counted), the plain twin for CPU tensors."""
    _check(cts, gs, lrs, names=("ct", "g"))
    if cts[0].device.type == "cpu":
        return fused_sgd_tree_bwd_reference(cts, gs, lrs)
    return _launch_backward(cts, gs, lrs)


class FusedSGD(torch.autograd.Function):
    """``apply(n, *p, *g, *lr) -> tuple(out)``, ``out_i = p_i - lr_i * g_i``
    over ``n`` leaves, with its VJP, as the JAX package's ``jax.custom_vjp``
    ``_fused_sgd`` gives it: forward B1, backward B2 (``dp = ct``, returned
    as it is; ``dlr`` as 0-d views of B2's ``[n]`` output). CPU tensors take
    the twins. The backward is the VJP only: differentiating it again
    raises."""

    @staticmethod
    def forward(n, *leaves):
        ps, gs, lrs = leaves[:n], leaves[n : 2 * n], leaves[2 * n :]
        _check(ps, gs, lrs)
        if ps[0].device.type == "cpu":
            return tuple(fused_sgd_tree_reference(ps, gs, lrs))
        return tuple(_launch_forward(ps, gs, lrs))

    @staticmethod
    def setup_context(ctx, inputs, output):
        n = inputs[0]
        ctx.n = n
        ctx.save_for_backward(*inputs[1 + n :])

    @staticmethod
    @once_differentiable
    def backward(ctx, *cts):
        n = ctx.n
        saved = ctx.saved_tensors
        gs, lrs = saved[:n], saved[n:]
        if not any(ctx.needs_input_grad[1 + n :]):
            return (None, *cts) + (None,) * (2 * n)
        dgs, dlr = fused_sgd_tree_backward(cts, gs, lrs)
        return (None, *cts, *dgs, *dlr.unbind())


def launch_groups(paths) -> List[List[int]]:
    """The leaves (by index) of each launch over a tree with these key
    paths: one group, or one per mesh entry of a tensor-parallel row
    (block ``j`` of a split leaf in group ``j``, every other leaf in group
    0)."""
    entries = [shard_index(path[-1]) or 0 for path in paths]
    return [[i for i, e in enumerate(entries) if e == j] for j in range(max(entries) + 1)]


def fused_sgd_update(params, grads, lr_tree):
    """One LSLR SGD step ``p - lr_t * g`` over the whole tree as one kernel
    launch (one per mesh entry of a tensor-parallel row:
    :func:`launch_groups`), differentiable in params, grads and lrs (B2 in
    the backward). ``lr_tree`` holds one scalar per leaf. The leaves of
    ``params`` and ``grads`` may carry a leading task axis: the tasks of a
    flush then update in the same launch. Returns a tree of new
    tensors."""
    ps, paths = tree_flatten(params)
    gs, g_paths = tree_flatten(grads)
    lrs, lr_paths = tree_flatten(lr_tree)
    if not (paths == g_paths == lr_paths):
        raise ValueError("fused_sgd: params, grads and lrs must have the same tree structure")
    out = [None] * len(ps)
    for group in launch_groups(paths):
        pick = lambda leaves: [leaves[i] for i in group]  # noqa: E731
        for i, new in zip(group, FusedSGD.apply(len(group), *pick(ps), *pick(gs), *pick(lrs))):
            out[i] = new
    return tree_unflatten(paths, out)
