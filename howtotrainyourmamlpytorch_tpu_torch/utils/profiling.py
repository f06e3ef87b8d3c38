"""Device-time breakdown from a ``torch.profiler`` trace (JAX package
``utils/profiling.py``).

The runner's ``profile_dir`` window writes a Chrome trace
(``prof.export_chrome_trace``) under ``profile_dir/plugins/profile/<ts>/``
as ``*.pt.trace.json``, the layout ``jax.profiler`` gives its xplanes. This
module reads the newest one and splits the card's time into compute, data
movement and other, in the JAX module's keys.

Device events are the trace's complete events (``ph == "X"``) of the card's
timeline: the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` categories, and
any other event that names a CUDA stream in its ``args``, except
``gpu_user_annotation`` ranges, which span the kernels they annotate (the
JAX module reads the op line and skips the hierarchical lines for the same
reason). Classification:

- ``kernel`` is compute, except names with ``nccl`` or ``memcpy`` (a
  collective, a copy kernel), which are data movement;
- ``gpu_memcpy`` and ``gpu_memset`` are data movement;
- anything else is other.

``device_busy_ms`` is the sum of the device events' durations, as JAX sums
the op line (overlapping streams count twice). A trace with no device event
(a CPU-only trace) gives None, as JAX's does. The trace carries no per-op
FLOPs, so ``flops_total`` and ``model_flops_total`` are None;
``peak_flops_per_sec`` comes from ``observability/costs.py``'s table by the
trace's ``deviceProperties`` name.

:func:`device_busy` reads the same device events as intervals: the union
of their spans is the time the card was busy (a moment two events overlap
counts once), beside the summed durations ``device_busy_ms`` reports.
"""

import glob
import json
import os
from typing import Any, Dict, Optional

#: device categories, lowercased
COMPUTE_CATEGORIES = ("kernel",)
DMA_CATEGORIES = ("gpu_memcpy", "gpu_memset")
#: kernel-name substrings that make a kernel data movement
DMA_KERNEL_SUBSTRINGS = ("nccl", "memcpy")
#: device ranges that span other device events (never summed)
SPAN_CATEGORIES = ("gpu_user_annotation",)
TRACE_GLOB = "*.pt.trace.json"


def _is_device_event(event: Dict[str, Any]) -> bool:
    if event.get("ph") != "X" or "dur" not in event:
        return False
    cat = str(event.get("cat", "")).lower()
    if cat in SPAN_CATEGORIES:
        return False
    if cat in COMPUTE_CATEGORIES or cat in DMA_CATEGORIES:
        return True
    args = event.get("args")
    return isinstance(args, dict) and "stream" in args


def _categorize(event: Dict[str, Any]) -> str:
    cat = str(event.get("cat", "")).lower()
    if cat in COMPUTE_CATEGORIES:
        name = str(event.get("name", "")).lower()
        return "dma" if any(sub in name for sub in DMA_KERNEL_SUBSTRINGS) else "compute"
    if cat in DMA_CATEGORIES:
        return "dma"
    return "other"


def _device_name(trace: Dict[str, Any]) -> Optional[str]:
    props = trace.get("deviceProperties")
    if isinstance(props, list) and props and isinstance(props[0], dict):
        return props[0].get("name")
    return None


def _peak_flops_per_sec(device_kind: Optional[str]) -> Optional[float]:
    """``observability/costs.py``'s table lookup; loaded by file path where
    this module was (``scripts/obs_report.py`` imports no package)."""
    try:
        from ..observability.costs import peak_flops_per_sec
    except ImportError:
        import importlib.util

        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "observability", "costs.py")
        spec = importlib.util.spec_from_file_location("htymp_torch_costs", path)
        costs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(costs)
        peak_flops_per_sec = costs.peak_flops_per_sec
    return peak_flops_per_sec(device_kind)


def breakdown_from_trace(path: str) -> Optional[Dict[str, Any]]:
    """Aggregate the device events of one Chrome trace file. Returns None
    when the file has no device event (a CPU-only trace)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    per_op_us: Dict[str, float] = {}
    cat_us = {"compute": 0.0, "dma": 0.0, "other": 0.0}
    n_events = 0
    for event in events:
        if not isinstance(event, dict) or not _is_device_event(event):
            continue
        dur = float(event["dur"])
        n_events += 1
        cat_us[_categorize(event)] += dur
        name = str(event.get("name", "?"))
        per_op_us[name] = per_op_us.get(name, 0.0) + dur
    total_us = sum(cat_us.values())
    if n_events == 0 or total_us == 0:
        return None
    top = sorted(per_op_us.items(), key=lambda kv: -kv[1])[:8]
    result: Dict[str, Any] = {
        "compute_frac": round(cat_us["compute"] / total_us, 4),
        "dma_frac": round(cat_us["dma"] / total_us, 4),
        "other_frac": round(cat_us["other"] / total_us, 4),
        "device_busy_ms": round(total_us / 1e3, 3),
        "n_events": n_events,
        "flops_total": None,
        "model_flops_total": None,
        "peak_flops_per_sec": _peak_flops_per_sec(_device_name(trace if isinstance(trace, dict) else {})),
        "top_ops": [{"op": name[:80], "ms": round(us / 1e3, 3)} for name, us in top],
    }
    if cat_us["other"] == total_us:
        # nothing matched a device category: the fractions would be 0/0/1
        # as if measured; say so instead
        result["classification_failed"] = True
    return result


def device_busy(path: str) -> Optional[Dict[str, Any]]:
    """The device events of one Chrome trace as intervals: ``union_ms``,
    the time at least one ran; ``sum_ms``, their summed durations;
    ``span_ms``, the first start to the last end; ``streams``, the streams
    they name. None when the file has no device event."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    spans, streams = [], set()
    for event in events:
        if isinstance(event, dict) and _is_device_event(event):
            start = float(event.get("ts", 0.0))
            spans.append((start, start + float(event["dur"])))
            args = event.get("args")
            streams.add(args.get("stream") if isinstance(args, dict) else None)
    if not spans:
        return None
    spans.sort()
    union_us, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            union_us += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    union_us += hi - lo
    return {"union_ms": union_us / 1e3, "sum_ms": sum(e - s for s, e in spans) / 1e3,
            "span_ms": (max(e for _, e in spans) - spans[0][0]) / 1e3,
            "streams": sorted(streams, key=str), "n_events": len(spans)}


def trace_path(trace_dir: str, stamp: str, host: str = "host") -> str:
    """Where a trace window writes its Chrome trace: ``trace_dir/plugins/
    profile/<stamp>/<host>.pt.trace.json``, the directory made."""
    out_dir = os.path.join(trace_dir, "plugins", "profile", stamp)
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{host}.pt.trace.json")


def device_time_breakdown(trace_dir: str) -> Optional[Dict[str, Any]]:
    """Breakdown of the newest Chrome trace under ``trace_dir``
    (``plugins/profile/<ts>/*.pt.trace.json``), or None when there is no
    trace or no device event in it."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", TRACE_GLOB)), key=os.path.getmtime)
    if not paths:
        return None
    return breakdown_from_trace(paths[-1])
