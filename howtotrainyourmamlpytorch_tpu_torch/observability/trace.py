"""Low-overhead thread-safe span tracer with Chrome-trace export.

The training hot loop dispatches thousands of steps per epoch; the serving
path flushes micro-batches from worker threads. Both need *where does the
time go* answered without perturbing what they measure, so the tracer is
deliberately minimal: a ``span(name)`` context manager costs two clock reads
and two lock acquisitions, completed spans land in a bounded ring buffer
(old spans evicted, never an unbounded list growing for 150 epochs), and
nesting depth is tracked per thread so exported traces render as a proper
flame graph. The clock is injectable so tests walk time deterministically.

Export is the Chrome trace-event JSON format (``{"traceEvents": [...]}``,
complete ``"ph": "X"`` events with microsecond ``ts``/``dur``), which both
``chrome://tracing`` and Perfetto (https://ui.perfetto.dev) open directly.
Complete events are balanced by construction — a span only reaches the ring
when its ``__exit__`` ran — and :func:`validate_chrome_trace` re-checks that
plus the schema, which the chaos campaign runs over every exported trace.
"""

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

try:
    from ..utils.locks import san_lock
except ImportError:  # file-path-loaded (trace_merge toy fleets run this
    # module standalone): take the repo-root import, else a plain primitive
    try:
        from tools.graftsan.runtime import san_lock
    except ImportError:

        def san_lock(site=None):
            return threading.Lock()


class _NullSpan:
    """Shared no-op context manager: the disabled tracer's ``span()`` must
    cost one attribute lookup and nothing else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Inert tracer: every hook is a no-op. Instrumented code holds one of
    these when observability is disabled, so call sites never branch."""

    enabled = False

    def span(self, name: str, flows: Optional[Sequence] = None, **tags):
        return _NULL_SPAN

    def records(self) -> List[dict]:
        return []

    def durations_s(self, name: str) -> List[float]:
        return []

    def open_spans(self) -> int:
        return 0

    def to_chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": []}

    def export(self, path: str) -> None:
        pass


NULL_TRACER = NullTracer()


class _Span:
    """Live span handed out by :meth:`SpanTracer.span`; records itself into
    the tracer's ring on exit. ``duration_s`` is set on exit so wrappers
    (the hub's phase histograms) reuse the span's own clock pair instead of
    reading the clock again — one measurement, two consumers. ``flows`` is
    a sequence of ``(flow_id, role)`` pairs (role in ``s``/``t``/``f``)
    exported as Chrome *flow events* anchored to this span, linking a
    request's spans across threads (observability/context.py builds them)."""

    __slots__ = ("_tracer", "name", "tags", "flows", "_t0", "_depth", "duration_s")

    def __init__(
        self,
        tracer: "SpanTracer",
        name: str,
        tags: Dict[str, Any],
        flows: Optional[Sequence] = None,
    ):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self.flows = tuple(flows) if flows else None

    def __enter__(self):
        self._depth = self._tracer._enter()
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._clock()
        self.duration_s = t1 - self._t0
        self._tracer._exit_record(
            self.name, self._t0, t1, self._depth, self.tags, self.flows
        )
        return False


class SpanTracer:
    """Bounded-ring span recorder.

    ``capacity`` bounds the completed-span ring; evictions are counted in
    ``dropped`` so a truncated export is visible as truncated rather than
    passing for the whole run. ``clock`` must be monotonic; tests inject a
    fake. Completed spans are ``(name, t0, t1, thread_name, depth, tags,
    flows)`` tuples relative to the tracer's epoch (construction time).
    ``epoch_unix`` anchors that epoch to the wall clock so
    ``scripts/trace_merge.py`` can align traces from different processes
    on one timeline.
    """

    enabled = True

    def __init__(
        self,
        capacity: int = 8192,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
    ):
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._clock = clock
        self._epoch = clock()
        self.epoch_unix = wall_clock()
        self._lock = san_lock("SpanTracer._lock")
        self._ring: deque = deque(maxlen=self.capacity)
        self._local = threading.local()
        self.dropped = 0
        self._open = 0

    # -- span lifecycle (called from _Span) ----------------------------

    def _enter(self) -> int:
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        with self._lock:
            self._open += 1
        return depth

    def _exit_record(self, name, t0, t1, depth, tags, flows=None) -> None:
        self._local.depth = depth
        rec = (name, t0 - self._epoch, t1 - self._epoch,
               threading.current_thread().name, depth, tags, flows)
        with self._lock:
            self._open -= 1
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(rec)

    # -- public API ----------------------------------------------------

    def span(self, name: str, flows: Optional[Sequence] = None, **tags) -> _Span:
        """``with tracer.span("dispatch", epoch=3): ...``; ``flows`` links
        this span into cross-thread request arcs (see :class:`_Span`)."""
        return _Span(self, name, tags, flows=flows)

    def open_spans(self) -> int:
        """Spans entered but not yet exited, across all threads — zero when
        every ``with`` block has unwound (the balance invariant)."""
        with self._lock:
            return self._open

    def records(self) -> List[dict]:
        """Snapshot of the ring as dicts (seconds relative to tracer epoch)."""
        with self._lock:
            ring = list(self._ring)
        return [
            {"name": n, "t0_s": t0, "t1_s": t1, "dur_s": t1 - t0,
             "thread": thread, "depth": depth, "tags": tags, "flows": flows}
            for n, t0, t1, thread, depth, tags, flows in ring
        ]

    def durations_s(self, name: str) -> List[float]:
        with self._lock:
            ring = list(self._ring)
        return [t1 - t0 for n, t0, t1, *_ in ring if n == name]

    # -- export --------------------------------------------------------

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object. Only completed (balanced) spans
        are exported; in-flight spans and ring evictions are surfaced as
        metadata so a partial trace reads as partial. Spans recorded with
        ``flows`` additionally emit flow events (``ph: s/t/f``, one shared
        name+cat per the format's flow-binding rule, id = the trace id)
        anchored at the span's start, so a request renders as one linked
        arc across threads in Perfetto."""
        with self._lock:
            ring = list(self._ring)
            open_spans = self._open
            dropped = self.dropped
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        tids: Dict[str, int] = {}
        for name, t0, t1, thread, depth, tags, flows in ring:
            tid = tids.setdefault(thread, len(tids))
            ts = round(t0 * 1e6, 3)
            event = {
                "name": name,
                "cat": "host",
                "ph": "X",
                "ts": ts,
                "dur": round((t1 - t0) * 1e6, 3),
                "pid": pid,
                "tid": tid,
            }
            if tags:
                # viewer 'args' values must be JSON scalars; stringify the rest
                event["args"] = {
                    k: (v if isinstance(v, (int, float, bool, str, type(None))) else str(v))
                    for k, v in tags.items()
                }
            events.append(event)
            for flow_id, role in flows or ():
                flow = {
                    "name": "request",
                    "cat": "request",
                    "ph": role,
                    "id": flow_id,
                    "ts": ts,
                    "pid": pid,
                    "tid": tid,
                }
                if role in ("t", "f"):
                    # bind to the ENCLOSING slice (this span), not the next
                    flow["bp"] = "e"
                events.append(flow)
        for thread, tid in tids.items():
            events.append(
                {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": thread}}
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "open_spans": open_spans,
                "dropped_spans": dropped,
                "pid": pid,
                "epoch_unix": self.epoch_unix,
            },
        }

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


# ---------------------------------------------------------------------------
# trace validation (the chaos-campaign invariant)
# ---------------------------------------------------------------------------

_REQUIRED_X_KEYS = ("name", "ph", "ts", "dur", "pid", "tid")


def validate_chrome_trace(trace: Dict[str, Any]) -> List[str]:
    """Schema + balance check of an exported trace; returns violations
    (empty = valid). Accepts the object form (``{"traceEvents": [...]}``).
    Balance means: every duration event is complete (``"X"`` with a
    non-negative ``dur``), any ``"B"``/``"E"`` pairs match per (pid, tid),
    and the exporter left no span open. Flow events (``s``/``t``/``f``)
    must carry an ``id`` and pair up: a finish (or step) whose flow never
    started is a violation. A start with no finish is NOT — that is what a
    request that never reached a device dispatch (cache hit, shed,
    breaker rejection) legitimately looks like."""
    problems: List[str] = []
    if not isinstance(trace, dict) or not isinstance(trace.get("traceEvents"), list):
        return ["trace is not an object with a traceEvents list"]
    begin_depth: Dict[Tuple[Any, Any], int] = {}
    flow_started: set = set()
    flow_continued: Dict[Any, str] = {}
    for i, ev in enumerate(trace["traceEvents"]):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        ph = ev.get("ph")
        if ph == "M":
            continue
        if ph in ("s", "t", "f"):
            if "id" not in ev:
                problems.append(f"event {i}: flow event ({ph}) without an id")
                continue
            if ph == "s":
                flow_started.add(ev["id"])
            else:
                flow_continued.setdefault(ev["id"], ph)
            continue
        if ph == "i":
            # instant events (trace_merge's access-log / fleet-event marks)
            if not isinstance(ev.get("ts"), (int, float)):
                problems.append(f"event {i} (instant) has bad ts {ev.get('ts')!r}")
            continue
        if ph == "X":
            missing = [k for k in _REQUIRED_X_KEYS if k not in ev]
            if missing:
                problems.append(f"event {i} missing keys {missing}")
                continue
            if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
                problems.append(f"event {i} has bad ts {ev['ts']!r}")
            if not isinstance(ev["dur"], (int, float)) or ev["dur"] < 0:
                problems.append(f"event {i} has negative/bad dur {ev['dur']!r}")
        elif ph == "B":
            key = (ev.get("pid"), ev.get("tid"))
            begin_depth[key] = begin_depth.get(key, 0) + 1
        elif ph == "E":
            key = (ev.get("pid"), ev.get("tid"))
            depth = begin_depth.get(key, 0) - 1
            if depth < 0:
                problems.append(f"event {i}: 'E' without matching 'B' on {key}")
            begin_depth[key] = depth
        else:
            problems.append(f"event {i} has unsupported ph {ph!r}")
    for key, depth in begin_depth.items():
        if depth > 0:
            problems.append(f"{depth} unclosed 'B' span(s) on {key}")
    # order-independent pairing: the ring orders events by span COMPLETION,
    # so a request's "f" (dispatch span, exits first) legitimately precedes
    # its "s" (the enclosing HTTP span) in the event list
    for flow_id, ph in flow_continued.items():
        if flow_id not in flow_started:
            problems.append(f"flow {flow_id!r} has '{ph}' but no start ('s')")
    open_spans = (trace.get("otherData") or {}).get("open_spans", 0)
    if open_spans:
        problems.append(f"exporter reported {open_spans} span(s) still open")
    return problems


def load_and_validate_trace(path: str) -> List[str]:
    """Parse + validate an exported trace file; unparseable JSON is itself
    the violation."""
    try:
        with open(path) as f:
            trace = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        return [f"trace unreadable: {exc}"]
    return validate_chrome_trace(trace)
