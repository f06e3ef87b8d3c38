"""Functional NN primitives over dict trees, the subset the VGG, ResNet and
DenseNet backbones use (JAX package ``models/layers.py``).

Each layer is a pair of plain functions: ``init_*`` returning a params dict
(and, for batch-norm, a state dict) and an apply function on tensors, so the
inner loop's fast weights are just another params dict and need no module
patching.

Layout: the JAX package runs NHWC activations with HWIO kernels; this port
runs NCHW activations with OIHW kernels and ``[out, in]`` linear weights,
PyTorch's own layouts. Models convert NHWC input at their entry.
``utils/interop.py`` converts JAX weights, including the flatten order of the
first linear layer (JAX flattens ``(h, w, c)``, this port ``(c, h, w)``).

Tensor parallelism (``parallel/mesh.py``): a conv or linear ``w`` given as
a dict of blocks of its output channels (``{"mp0": ..., "mp1": ...}``, each
on its mesh entry's device) is column-parallel: each block's output
channels are computed on its device from the whole input, with its slice
of the (whole) bias, and the blocks' outputs are concatenated in channel
order on the input's device. A plain ``w`` runs the single-device code.

Initializers draw from the JAX package's distribution families (torch's
defaults: kaiming-uniform with a=sqrt(5) for conv and linear weights, fan-in
uniform biases; kaiming-normal fan_out for ResNet's convs and fan_in for
DenseNet's) with an explicit ``torch.Generator``.

Every convolution and matrix product runs through :func:`_dot`: inside a
selective remat step it enters that step's record or replay mode
(``core/remat.py::dot``), and where :data:`OPERAND_ROUNDING` is set its
operands are rounded first (``scripts/grad_precision_probe.py``'s
emulation of a reduced-precision product accumulated in float32).
"""

import math

import torch
import torch.nn.functional as F

from ..core.remat import dot
from ..parallel.mesh import shard_blocks

#: ``round(t) -> t``, applied to the input and the weight of every
#: convolution and matrix product (not the bias), or None
OPERAND_ROUNDING = None

# ---------------------------------------------------------------------------
# Initializers (torch-default distributions)
# ---------------------------------------------------------------------------


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def init_conv(gen, kh, kw, cin, cout, bias=True, init="torch_default"):
    """``torch_default``: Conv2d's kaiming_uniform_(a=sqrt(5)) =>
    U(+-1/sqrt(fan_in)); ``kaiming_normal_fan_out`` / ``_fan_in``:
    N(0, 2 / fan) (ResNet, DenseNet)."""
    fan_in, fan_out = cin * kh * kw, cout * kh * kw
    shape = (cout, cin, kh, kw)
    if init == "torch_default":
        w = _uniform(gen, shape, math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in))
    elif init in ("kaiming_normal_fan_out", "kaiming_normal_fan_in"):
        fan = fan_out if init == "kaiming_normal_fan_out" else fan_in
        w = math.sqrt(2.0 / fan) * torch.randn(shape, generator=gen)
    else:
        raise ValueError(init)
    params = {"w": w}
    if bias:
        params["b"] = _uniform(gen, (cout,), 1.0 / math.sqrt(fan_in))
    return params


def init_linear(gen, cin, cout, zero_bias=False):
    bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / cin)
    w = _uniform(gen, (cout, cin), bound)
    b = torch.zeros(cout) if zero_bias else _uniform(gen, (cout,), 1.0 / math.sqrt(cin))
    return {"w": w, "b": b}


def init_batch_norm(c):
    params = {"scale": torch.ones(c), "bias": torch.zeros(c)}
    state = {"mean": torch.zeros(c), "var": torch.ones(c), "count": torch.zeros(())}
    return params, state


# ---------------------------------------------------------------------------
# Conv / Linear
# ---------------------------------------------------------------------------


def _dot(fn, x, w, b, **kwargs):
    rnd = OPERAND_ROUNDING
    if rnd is not None:
        x, w = rnd(x), rnd(w)
    return dot(fn, x, w, b, **kwargs)


def _conv(x, w, b, stride, padding):
    return _dot(F.conv2d, x, w, b, bias_view=(-1, 1, 1), stride=stride, padding=padding)


def _column_parallel(fn, x, blocks, b, dim):
    """``fn(x, w_block, b_slice)`` per block of output channels, each on
    its block's device, concatenated along ``dim`` on ``x``'s device."""
    outs, lo = [], 0
    for w in shard_blocks(blocks):
        hi = lo + w.shape[0]
        outs.append(fn(x.to(w.device), w, None if b is None else b[lo:hi].to(w.device)).to(x.device))
        lo = hi
    return torch.cat(outs, dim=dim)


def conv2d(params, x, stride=1, padding=0):
    """Conv over NCHW with an OIHW kernel; ``padding`` is a symmetric int."""
    if not isinstance(padding, int):
        raise TypeError(f"conv2d supports symmetric int padding only, got {padding!r}")
    w, b = params["w"], params.get("b")
    if isinstance(w, dict):
        return _column_parallel(lambda xs, ws, bs: _conv(xs, ws, bs, stride, padding), x, w, b, 1)
    return _conv(x, w, b, stride, padding)


def linear(params, x):
    w, b = params["w"], params["b"]
    if isinstance(w, dict):
        return _column_parallel(lambda xs, ws, bs: _dot(F.linear, xs, ws, bs), x, w, b, -1)
    return _dot(F.linear, x, w, b)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------


def _channel_view(v, ndim):
    return v.reshape((1, -1) + (1,) * (ndim - 2))


def _batch_stats(x, dims, sample_weight):
    """Per-channel batch mean/var (biased) in ``x``'s dtype. The weighted
    branch is the shape-bucketing mask: statistics over real samples only."""
    if sample_weight is None:
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        return mean, var
    w = sample_weight.to(x.dtype).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    spatial = x.numel() // (x.shape[0] * x.shape[1])
    denom = torch.clamp(sample_weight.sum() * spatial, min=1.0).to(x.dtype)
    mean = (w * x).sum(dim=dims) / denom
    var = (w * torch.square(x - _channel_view(mean, x.dim()))).sum(dim=dims) / denom
    return mean, var


def batch_norm(params, state, x, use_batch_stats=True, eps=1e-5, sample_weight=None, stat_dtype=None):
    """Batch-norm over NCHW (reduce N, H, W) or NC (reduce N).

    Transductive, as in the reference: normalisation uses the current
    batch's statistics, and the running statistics are never updated on this
    path (JAX package ``models/layers.py:264-271``), so ``state`` comes back
    unchanged. ``sample_weight`` ([N], 1 = real, 0 = padding) reduces the
    statistics over real samples only. ``stat_dtype`` computes statistics and
    normalisation in that dtype and casts back to ``x``'s dtype before the
    scale and shift."""
    dims = (0,) + tuple(range(2, x.dim()))
    sx = x if stat_dtype is None else x.to(stat_dtype)
    if use_batch_stats:
        mean, var = _batch_stats(sx, dims, sample_weight)
    else:
        mean, var = state["mean"].to(sx.dtype), state["var"].to(sx.dtype)
    mean, inv = _channel_view(mean, x.dim()), _channel_view(torch.rsqrt(var + eps), x.dim())
    scale, bias = _channel_view(params["scale"], x.dim()), _channel_view(params["bias"], x.dim())
    if stat_dtype is None:
        out = (x - mean) * inv * scale + bias
    else:
        out = ((sx - mean) * inv).to(x.dtype) * scale + bias
    return out, state


# ---------------------------------------------------------------------------
# Pooling / activations
# ---------------------------------------------------------------------------


def max_pool(x, window=2, *, force_reduce_window=False):
    """Non-overlapping MaxPool2d(window, stride=window), floor mode, NCHW.

    As in the JAX package, a window's gradient splits evenly among tied
    maxima (``amax``'s backward); ``force_reduce_window`` sends it all to the
    first maximum instead (torch's ``max_pool2d``, the JAX package's
    ``Config.max_pool_reduce_window``)."""
    if force_reduce_window:
        return F.max_pool2d(x, window)
    b, c, h, w = x.shape
    ho, wo = h // window, w // window
    x = x[:, :, : ho * window, : wo * window]
    return x.reshape(b, c, ho, window, wo, window).amax(dim=(3, 5))


def avg_pool(x, window=2):
    """Non-overlapping AvgPool2d(window, stride=window), floor mode, NCHW."""
    b, c, h, w = x.shape
    ho, wo = h // window, w // window
    x = x[:, :, : ho * window, : wo * window]
    return x.reshape(b, c, ho, window, wo, window).mean(dim=(3, 5))


def global_avg_pool(x):
    """AdaptiveAvgPool2d((1, 1)) + flatten: NCHW -> NC."""
    return x.mean(dim=(2, 3))


def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def relu(x):
    """``max(x, 0)``, as the JAX package's ``jnp.maximum(x, 0)``: at exactly
    0 the gradient is 0.5 (``torch.maximum`` splits a tie evenly), where
    ``torch.relu``'s is 0. Transductive BN makes exact zeros reachable (a
    channel that is constant over the batch normalises to its bias)."""
    return torch.maximum(x, torch.zeros_like(x))


def flatten(x):
    return x.reshape(x.shape[0], -1)
