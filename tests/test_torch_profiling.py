"""The port's device-time breakdown (``utils/profiling.py``), mirroring
``tests/test_profiling.py`` on a Chrome trace this test writes in
``torch.profiler``'s schema: kernels (one of them a memcpy kernel, one an
NCCL collective), a ``gpu_memcpy``, a ``gpu_memset``, a device event of an
unknown category, an annotation range over them (never summed) and host
events (never device time). Then the trace-directory discovery of the
runner's layout, ``classification_failed`` when no device category matches,
and None for a real CPU-only ``torch.profiler`` trace."""

import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from howtotrainyourmamlpytorch_tpu_torch.utils.profiling import (
    breakdown_from_trace,
    device_busy,
    device_time_breakdown,
    trace_path,
)


def _device(cat, name, dur, ts=0.0):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"device": 0, "stream": 7, "correlation": 1}}


def _trace(events, name="NVIDIA H100 80GB HBM3"):
    host = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 0.0, "dur": 500.0},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 0, "dur": 5.0}]
    return {"deviceProperties": [{"id": 0, "name": name}], "traceEvents": host + events}


EVENTS = [
    _device("kernel", "void fused_sgd_kernel<64, float>(tree::Table<64>)", 60.0),
    _device("kernel", "ampere_sgemm_128x64_nn", 20.0),
    _device("kernel", "ncclDevKernel_AllReduce_Sum_f32", 5.0),
    _device("kernel", "void at::native::memcpy_kernel<float>", 5.0),
    _device("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 6.0),
    _device("gpu_memset", "Memset (Device)", 2.0),
    _device("gpu_mystery", "something new", 2.0),
    {**_device("gpu_user_annotation", "replay", 1000.0)},
]


def _write(tmp_path, trace, stamp="a"):
    path = trace_path(str(tmp_path), stamp)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def test_chrome_trace_classifies(tmp_path):
    b = breakdown_from_trace(_write(tmp_path, _trace(EVENTS)))
    assert b["n_events"] == 7  # the annotation range and the host events are not device time
    assert b["device_busy_ms"] == pytest.approx(0.1)
    assert b["compute_frac"] == pytest.approx(0.8)
    assert b["dma_frac"] == pytest.approx(0.18)  # nccl + memcpy kernels, memcpy, memset
    assert b["other_frac"] == pytest.approx(0.02)
    assert b["flops_total"] is None and b["model_flops_total"] is None
    assert b["peak_flops_per_sec"] == 989.4e12
    assert b["top_ops"][0] == {"op": "void fused_sgd_kernel<64, float>(tree::Table<64>)", "ms": 0.06}
    assert "classification_failed" not in b
    # the JAX module's keys
    assert set(b) == {"compute_frac", "dma_frac", "other_frac", "device_busy_ms", "n_events", "flops_total",
                      "model_flops_total", "peak_flops_per_sec", "top_ops"}


def test_trace_dir_discovery(tmp_path):
    assert device_time_breakdown(str(tmp_path)) is None
    _write(tmp_path, _trace(EVENTS[:1]), "old")
    time.sleep(0.01)
    newest = _write(tmp_path, _trace(EVENTS[1:2], name="NVIDIA H100 PCIe"), "new")
    os.utime(newest)
    assert newest.endswith(os.path.join("plugins", "profile", "new", "host.pt.trace.json"))
    b = device_time_breakdown(str(tmp_path))
    assert b["n_events"] == 1 and b["top_ops"][0]["op"] == "ampere_sgemm_128x64_nn"
    assert b["peak_flops_per_sec"] == 756e12


def test_all_unknown_flags_classification_failure(tmp_path):
    b = breakdown_from_trace(_write(tmp_path, _trace([_device("gpu_mystery", "x", 3.0),
                                                        _device("gpu_other", "y", 1.0)])))
    assert b["classification_failed"] is True
    assert (b["compute_frac"], b["dma_frac"], b["other_frac"]) == (0.0, 0.0, 1.0)


def test_cpu_only_profiler_trace_is_none(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    prof.export_chrome_trace(trace_path(str(tmp_path), "cpu"))
    assert device_time_breakdown(str(tmp_path)) is None


def test_device_busy_is_the_union_of_intervals(tmp_path):
    """Busy time counts a moment once however many device events overlap
    it: two kernels on two streams over [0, 10) and [5, 20), a memset
    inside the first, and a gap before a memcpy over [30, 36): the union is
    26 us, the summed durations 33 us, the span 36 us. The annotation range
    and the host events are not device intervals."""
    def on(stream, event):
        return {**event, "args": {**event["args"], "stream": stream}}

    events = [on(7, _device("kernel", "a", 10.0, ts=0.0)), on(9, _device("kernel", "b", 15.0, ts=5.0)),
              on(7, _device("gpu_memset", "Memset (Device)", 2.0, ts=3.0)),
              on(7, _device("gpu_memcpy", "Memcpy DtoD", 6.0, ts=30.0)),
              _device("gpu_user_annotation", "replay", 1000.0)]
    busy = device_busy(_write(tmp_path, _trace(events)))
    assert busy["union_ms"] == pytest.approx(0.026)
    assert busy["sum_ms"] == pytest.approx(0.033)
    assert busy["span_ms"] == pytest.approx(0.036)
    assert busy["streams"] == [7, 9] and busy["n_events"] == 4
    assert device_busy(_write(tmp_path, _trace([]), stamp="b")) is None
