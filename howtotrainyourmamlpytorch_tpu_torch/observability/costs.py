"""Program FLOPs, the card's peak and MFU arithmetic (JAX package
``observability/costs.py``).

The contract is the JAX module's: every entry point **degrades to None with
a reason, never raises**. A cost probe must not cost a run its telemetry.

Pieces:

- :func:`step_cost` — ``{flops, bytes_accessed, source, error,
  bytes_accessed_reason}`` of one call of a step callable, the counterpart of
  ``jit_cost``/``program_cost``: the call runs once under
  ``torch.utils.flop_counter.FlopCounterMode``. :func:`priced_call` gives the
  call's output beside the cost, so that a first dispatch is priced without
  an extra step.
- :func:`program_memory` — a captured CUDA graph's pool bytes
  (:func:`pool_bytes`), the nearest counterpart of XLA's
  ``memory_analysis()``.
- :func:`peak_flops_per_sec` — the dense bf16 peak per card, keyed by a
  lowercase substring of ``torch.cuda.get_device_name``.
- :func:`mfu` — ``(value, reason)``: FLOPs per step times steps per second
  over the peak, with the reason spelled out whenever the value is None.

What the counter counts: the aten matmuls and convolutions a call runs,
forward and backward, with the double backward of a second-order step
included through ``convolution_backward``; two FLOPs per multiply-add.
torch's formula for ``convolution_backward`` counts a grouped convolution's
weight gradient as if it were dense, ``groups`` times too many, and
``torch.func.vmap`` runs the per-task convolutions of the inner loop as
grouped ones (one group per task), so that term is divided by the groups
here (:func:`_conv_backward_flop`). It counts no elementwise operation (activations, batch norm, softmax, the
outer Adam). B1 and B2 are not aten operations, so they are not counted
either: they hold 0.01-0.02% of the train step's device time. XLA's cost
analysis counts elementwise FLOPs too, so the JAX package's count and this
one differ in definition, not only in value.

The port trains in float32 at ``matmul_precision: highest`` (IEEE float32,
no TF32) by default, so its MFU against the bf16 peak of this table is
small by construction. There is no precision-aware peak: the JAX package
has none.
"""

from typing import Any, Callable, Dict, List, Optional, Tuple

#: Dense bf16 peak FLOP/s per card, keyed by a substring of the device name
#: (lowercased). First match wins, so the more specific rows come first.
#: Source: NVIDIA's H100 datasheet, dense rates without sparsity (the SXM5
#: card reports itself as "NVIDIA H100 80GB HBM3").
PEAK_FLOPS_TABLE: List[Tuple[str, float]] = [
    ("h100 pcie", 756e12),
    ("h100", 989.4e12),
]

#: why ``bytes_accessed`` is always None here
NO_BYTES_REASON = "FlopCounterMode counts no bytes"

#: the JAX module's memory fields; a captured graph fills ``peak_bytes`` only
MEMORY_FIELDS = ("argument", "output", "temp", "generated_code", "alias")


def peak_flops_per_sec(device_kind: Optional[str]) -> Optional[float]:
    """Table lookup by device-name substring; None for unknown kinds (the
    CPU, cards not in the table): the caller reports why mfu is null."""
    if not device_kind:
        return None
    kind = str(device_kind).lower()
    for sub, peak in PEAK_FLOPS_TABLE:
        if sub in kind:
            return peak
    return None


def _nulls(error: str) -> Dict[str, Any]:
    return {"flops": None, "bytes_accessed": None, "source": None, "error": error,
            "bytes_accessed_reason": NO_BYTES_REASON}


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed,
                        output_padding, groups, output_mask, out_shape, **kwargs) -> int:
    """torch's ``convolution_backward`` count with the weight gradient's
    term divided by ``groups`` (torch counts it as a dense convolution)."""
    from torch.utils.flop_counter import conv_backward_flop

    # the registered formula is wrapped to take tensors; its shape version
    formula = getattr(conv_backward_flop, "__wrapped__", conv_backward_flop)
    args = (grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed, output_padding, groups)
    total = formula(*args, output_mask, out_shape=out_shape, **kwargs)
    if groups > 1 and output_mask[1]:
        weight = formula(*args, [False, True, False], out_shape=out_shape, **kwargs)
        total -= weight - weight // groups
    return total


def _counted(fn: Callable, args, kwargs):
    """``fn(*args, **kwargs)`` under the flop counter -> ``(cost, output,
    raised)``. Never raises: an exception in ``fn`` (or in the counter)
    becomes the cost's ``error`` and ``raised`` is True."""
    try:
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False,
                                  custom_mapping={torch.ops.aten.convolution_backward: _conv_backward_flop})
    except Exception as exc:
        return _nulls(f"FlopCounterMode unavailable: {type(exc).__name__}: {exc}"), None, True
    try:
        with counter:
            out = fn(*args, **kwargs)
    except Exception as exc:
        return _nulls(f"counted call failed: {type(exc).__name__}: {exc}"), None, True
    try:
        flops = float(counter.get_total_flops())
    except Exception as exc:
        return _nulls(f"get_total_flops: {type(exc).__name__}: {exc}"), out, False
    if flops <= 0:
        return _nulls("the call ran no counted matmul or convolution"), out, False
    return ({"flops": flops, "bytes_accessed": None, "source": "flop_counter", "error": None,
             "bytes_accessed_reason": NO_BYTES_REASON}, out, False)


def step_cost(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """FLOPs of one call ``fn(*args, **kwargs)``, run once under the
    counter. Never raises: on an exception the nulls carry the reason."""
    cost, _, _ = _counted(fn, args, kwargs)
    return cost


def priced_call(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` priced on the way -> ``(output, cost)``. Where
    the counted call raised, ``fn`` runs once more without the counter, so
    that ``fn``'s own exception reaches the caller and a fault of the
    counter costs only the price."""
    cost, out, raised = _counted(fn, args, kwargs)
    if raised:
        out = fn(*args, **kwargs)
    return out, cost


def pool_bytes(device, pool) -> Optional[int]:
    """The bytes of the CUDA caching allocator's segments that belong to the
    graph memory pool ``pool`` (``torch.cuda.graph_pool_handle()``) on
    ``device``, from ``torch.cuda.memory_snapshot()``; None off a card or
    where the snapshot has no pool ids."""
    try:
        import torch

        device = torch.device(device)
        if device.type != "cuda" or pool is None:
            return None
        index = device.index if device.index is not None else torch.cuda.current_device()
        segments = torch.cuda.memory_snapshot()
        return sum(int(seg["total_size"]) for seg in segments
                   if seg.get("device") == index and tuple(seg.get("segment_pool_id", ())) == tuple(pool))
    except Exception:
        return None


def program_memory(graph_pool_bytes: Optional[int]) -> Dict[str, Any]:
    """A captured graph's memory in the JAX module's keys. torch has no
    ``memory_analysis()``: ``peak_bytes`` is the graph pool's bytes after the
    capture (:func:`pool_bytes`), the blocks that hold the step's working
    set for as long as the graph lives (graphs that share one pool report
    the pool). The other fields stay None, with the reason in ``error``.
    Never raises."""
    nulls: Dict[str, Any] = {f"{f}_bytes": None for f in MEMORY_FIELDS}
    nulls["peak_bytes"] = None
    if graph_pool_bytes is None:
        return {**nulls, "error": "no graph pool bytes (not a card, or no pool ids in the allocator's snapshot)"}
    return {**nulls, "peak_bytes": int(graph_pool_bytes),
            "error": "torch has no memory_analysis: peak_bytes is the graph pool's bytes after the capture"}


def mfu(
    flops_per_step: Optional[float],
    steps_per_sec: Optional[float],
    device_kind: Optional[str] = None,
    peak: Optional[float] = None,
) -> Tuple[Optional[float], Optional[str]]:
    """Model FLOPs utilization as ``(value, reason)``: exactly one of the
    two is None. ``peak`` (FLOP/s) wins over the ``device_kind`` table
    lookup when both are given."""
    if not flops_per_step or flops_per_step <= 0:
        return None, "flops_per_step unknown (cost model unavailable)"
    if not steps_per_sec or steps_per_sec <= 0:
        return None, "steps_per_sec unknown or zero"
    if peak is None:
        peak = peak_flops_per_sec(device_kind)
        if peak is None:
            return None, (
                f"no peak-FLOPs table entry for device_kind {device_kind!r} "
                "(and no measured peak given)"
            )
    return round(float(flops_per_step) * float(steps_per_sec) / float(peak), 5), None
