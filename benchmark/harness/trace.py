"""A traced sub-window: ``torch.profiler`` over CPU and CUDA, its Chrome
trace written under ``TMPDIR``, read, and deleted.

What is read from it:

- the device's busy seconds: the union of the intervals of its kernels,
  copies and sets (two that overlap count once), inside the window;
- the seconds of each kernel by name;
- the idle gaps between busy intervals, each labelled with the harness
  span (``bench.*``, any thread's) that was open on the host when it
  began, the latest to start of them, a client's request span last.

The profiler records the ranges of the thread that started it only; the
harness's own spans (``runtime.Spans``, every thread's, on
``time.perf_counter``) are placed on the trace's timeline by the window's
span, which both record.
"""

import json
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"
#: a client's span, open nearly all the time under load: the label of last resort
REQUEST_SPAN = "bench.request"


class Trace:
    """``events``: the Chrome trace's; ``spans``: the harness's records
    ``(name, start s, end s, thread)`` of the traced window."""

    def __init__(self, events: List[Dict[str, Any]], spans: List[Tuple[str, float, float, int]]):
        kind = lambda e: str(e.get("cat", "")).lower() if e.get("ph") == "X" else ""  # noqa: E731
        self.device = [e for e in events if kind(e) in DEVICE_CATEGORIES]
        marks = [e for e in events if kind(e) == "user_annotation" and e.get("name") == WINDOW_SPAN]
        window = [r for r in spans if r[0] == WINDOW_SPAN]
        if marks and window:
            self.lo, self.hi = float(marks[0]["ts"]), float(marks[0]["ts"]) + float(marks[0]["dur"])
            offset = self.lo - 1e6 * window[-1][1]
        else:  # no window mark: the device events' extent, no host span placed
            self.lo = min((float(e["ts"]) for e in self.device), default=0.0)
            self.hi = max((float(e["ts"]) + float(e["dur"]) for e in self.device), default=0.0)
            offset, spans = 0.0, []
        self.spans = [(n, 1e6 * a + offset, 1e6 * b + offset, tid) for n, a, b, tid in spans if n != WINDOW_SPAN]

    def _intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((max(float(e["ts"]), self.lo), min(float(e["ts"]) + float(e["dur"]), self.hi))
                       for e in self.device)
        merged: List[List[float]] = []
        for start, end in spans:
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._intervals()) / 1e6

    def kernel_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.device:
            out[e["name"]] = out.get(e["name"], 0.0) + float(e["dur"]) / 1e6
        return out

    def kernels(self, substring: str) -> List[float]:
        """Durations (s) of the kernels whose name contains ``substring``."""
        return [float(e["dur"]) / 1e6 for e in self.device if substring in e["name"]]

    def _open_span(self, ts: float) -> str:
        open_spans = [(name != REQUEST_SPAN, a, name) for name, a, b, _ in self.spans if a <= ts < b]
        return max(open_spans)[2] if open_spans else "none"

    def idle_gaps(self) -> List[Tuple[str, float]]:
        gaps, prev = [], self.lo
        for start, end in self._intervals():
            if start > prev:
                gaps.append((prev, start))
            prev = max(prev, end)
        if self.hi > prev:
            gaps.append((prev, self.hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [(self._open_span(a), (b - a) / 1e6) for a, b in gaps[:10]]

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        top = sorted(self.kernel_seconds().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name, sec] for name, sec in top],
                "idle_gaps": [[name, sec] for name, sec in self.idle_gaps()]}


def traced(fn: Callable[[], Any], spans, device) -> Tuple[Any, Trace]:
    """``fn()`` under the profiler, inside the span ``bench.window`` ->
    (its result, the trace read back). The window closes with the card
    idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    start = time.perf_counter()
    spans.annotate = True
    try:
        with profile(activities=activities) as prof:
            with spans.span(WINDOW_SPAN):
                out = fn()
                if on_card:
                    torch.cuda.synchronize()
    finally:
        spans.annotate = False
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    return out, Trace([e for e in events if isinstance(e, dict)], spans.since(start))
