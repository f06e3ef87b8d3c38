"""TelemetryHub: one process-level seam joining tracer + registry + jsonl.

The hub owns a :class:`~.trace.SpanTracer` and a
:class:`~.metrics.MetricsRegistry` and periodically snapshots them to
``logs/telemetry.jsonl`` — per epoch and (optionally) per-N steps — so a run
leaves behind a machine-readable record of *where step time went*
(step-phase histograms: data-wait / dispatch / settle / checkpoint / eval),
throughput in episodes/s, and whatever live components register as
providers (recompile-guard snapshot, watchdog beat age, breaker state,
loader stats). ``scripts/obs_report.py`` joins this with ``events.jsonl``
and the xplane device-time breakdown into one run report.

Disabled (``Config.observability.enabled=false``) the hub is fully inert:
``span``/``phase`` return a shared no-op context manager, snapshots return
``{}`` without touching disk, and no file is ever created — the run is
bit-identical to a build without the subsystem (test-asserted).

Snapshot records are JSON lines shaped::

    {"ts": ..., "kind": "epoch"|"step"|"final", "epoch": ..., "steps": N,
     "episodes": M, "episodes_per_s": ..., "interval_episodes_per_s": ...,
     "phases": {phase: {count, window, mean_ms, p50_ms, p95_ms, p99_ms,
                        max_ms, sum_ms}},  # cumulative count/sum, windowed pcts
     "counters": {...}, "gauges": {...}, "providers": {...}}
"""

import os
import time
from typing import Any, Callable, Dict, Optional

from .metrics import DEFAULT_WINDOW, MetricsRegistry
from .trace import NULL_TRACER, SpanTracer

PHASE_PREFIX = "phase."


class _PhaseSpan:
    """Span + histogram observation in one context manager (the per-step
    instrumentation unit: shows up both in the Chrome trace and in the
    telemetry.jsonl percentiles). The histogram reuses the span's own
    duration — one clock pair per phase, trace and percentiles always
    agree."""

    __slots__ = ("_hub", "_name", "_span")

    def __init__(self, hub: "TelemetryHub", name: str, tags: Dict[str, Any]):
        self._hub = hub
        self._name = name
        self._span = hub.tracer.span(name, **tags)

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        result = self._span.__exit__(*exc)
        self._hub.registry.observe(
            PHASE_PREFIX + self._name,
            self._span.duration_s,
            window=self._hub.window,
        )
        return result


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


class TelemetryHub:
    def __init__(
        self,
        enabled: bool = True,
        logs_dir: Optional[str] = None,
        window: int = DEFAULT_WINDOW,
        trace_capacity: int = 8192,
        snapshot_every_steps: int = 0,
        export_chrome_trace: bool = True,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
    ):
        self.enabled = bool(enabled)
        self.window = int(window)
        self.snapshot_every_steps = int(snapshot_every_steps)
        self.export_chrome_trace = bool(export_chrome_trace)
        self._clock = clock
        self._wall_clock = wall_clock
        self.tracer = (
            SpanTracer(capacity=trace_capacity, clock=clock)
            if self.enabled
            else NULL_TRACER
        )
        self.registry = MetricsRegistry(default_window=self.window)
        self._providers: Dict[str, Callable[[], Any]] = {}
        # per-process session id stamped into every snapshot: a resumed run
        # APPENDS a new session to the same telemetry.jsonl and its
        # cumulative counters restart, so readers (obs_report) must split
        # sessions exactly, not by heuristics on counter resets
        self.session_id = f"{int(wall_clock() * 1e3):x}-{os.getpid()}"
        self._log = None
        self.trace_path: Optional[str] = None
        if self.enabled and logs_dir:
            # storage.EventLog: every append written whole + flushed, handle
            # closed on every exit path — telemetry must survive ugly deaths
            # exactly like events.jsonl does
            from ..experiment.storage import EventLog

            self._log = EventLog(logs_dir, filename="telemetry.jsonl")
            self.trace_path = os.path.join(logs_dir, "trace.json")
            if os.path.exists(self.trace_path):
                # a previous session's trace — possibly the rc=76 wedge
                # post-mortem — must not be clobbered by this session's
                # export at close; archive it under a unique name
                archived = os.path.join(
                    logs_dir,
                    f"trace-{int(os.path.getmtime(self.trace_path))}"
                    f"-{os.getpid()}.json",
                )
                try:
                    os.replace(self.trace_path, archived)
                except OSError:
                    pass  # unarchivable beats uncloseable; export still wins
        self._t_start = clock()
        self._steps = 0
        self._episodes = 0
        self._last_snap_t = self._t_start
        self._last_snap_episodes = 0
        self._last_snap_steps = 0
        self._next_snap_step = self.snapshot_every_steps
        self._closed = False

    @classmethod
    def from_config(cls, obs_cfg, logs_dir: Optional[str] = None) -> "TelemetryHub":
        """Build from a ``Config.observability`` block (duck-typed so the
        package stays importable without the config module)."""
        return cls(
            enabled=getattr(obs_cfg, "enabled", True),
            logs_dir=logs_dir,
            window=getattr(obs_cfg, "histogram_window", DEFAULT_WINDOW),
            trace_capacity=getattr(obs_cfg, "trace_capacity", 8192),
            snapshot_every_steps=getattr(obs_cfg, "snapshot_every_steps", 0),
            export_chrome_trace=getattr(obs_cfg, "export_chrome_trace", True),
        )

    # -- instrumentation hooks ----------------------------------------

    def span(self, name: str, flows=None, **tags):
        """Trace-only span (no phase histogram) — fine-grained serving
        spans. ``flows`` links the span into a request's cross-thread arc
        (observability/context.py flow helpers)."""
        if not self.enabled:
            return _NULL_PHASE
        return self.tracer.span(name, flows=flows, **tags)

    def phase(self, name: str, **tags):
        """Span + ``phase.<name>`` histogram observation — the per-step unit."""
        if not self.enabled:
            return _NULL_PHASE
        return _PhaseSpan(self, name, tags)

    def add_provider(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a zero-arg callable whose return value is embedded in
        every snapshot under ``providers.<name>`` (recompile guard, watchdog
        beat age, breaker state...). Provider errors are contained: a broken
        provider reports its error string, never kills the run."""
        if self.enabled:
            self._providers[name] = fn

    def step_completed(self, episodes: int = 0, steps: int = 1) -> None:
        """One settled dispatch (``episodes`` = meta-batch episodes it
        carried, ``steps`` = meta-steps it ran — K for a multi-step
        dispatch, so ``interval_steps_per_s`` and the MFU it feeds stay in
        meta-steps regardless of dispatch chunking). Drives the per-N-step
        snapshot cadence."""
        if not self.enabled:
            return
        self._steps += steps
        self._episodes += episodes
        # crossing check, not modulo: a K-step jump must not hop over the
        # cadence boundary
        if self.snapshot_every_steps > 0 and self._steps >= self._next_snap_step:
            self._next_snap_step = self._steps + self.snapshot_every_steps
            self.snapshot("step")

    # -- snapshots -----------------------------------------------------

    def _provider_values(self) -> Dict[str, Any]:
        out = {}
        for name, fn in self._providers.items():
            try:
                out[name] = fn()
            except Exception as exc:  # noqa: BLE001 — telemetry must not kill the run
                out[name] = {"provider_error": repr(exc)}
        return out

    def snapshot(self, kind: str, **extra) -> Dict[str, Any]:
        """Build one snapshot record; appended to telemetry.jsonl when the
        hub owns a log. ``extra`` lands at the top level (e.g. the runner's
        per-epoch stats)."""
        if not self.enabled:
            return {}
        now = self._clock()
        interval_s = now - self._last_snap_t
        interval_eps = self._episodes - self._last_snap_episodes
        interval_steps = self._steps - self._last_snap_steps
        self._last_snap_t = now
        self._last_snap_episodes = self._episodes
        self._last_snap_steps = self._steps
        elapsed = now - self._t_start
        record: Dict[str, Any] = {
            "ts": self._wall_clock(),
            "kind": kind,
            "session": self.session_id,
            "elapsed_s": round(elapsed, 3),
            "steps": self._steps,
            "episodes": self._episodes,
            "episodes_per_s": round(self._episodes / elapsed, 3) if elapsed > 0 else None,
            "interval_episodes_per_s": (
                round(interval_eps / interval_s, 3) if interval_s > 0 else None
            ),
            "interval_steps_per_s": (
                round(interval_steps / interval_s, 3) if interval_s > 0 else None
            ),
            "phases": self.registry.summaries(PHASE_PREFIX),
            "counters": self.registry.counters(),
            "gauges": self.registry.gauges(),
            "providers": self._provider_values(),
            "dropped_spans": getattr(self.tracer, "dropped", 0),
        }
        # live MFU: the flops_per_step gauge (set by the runner's compile-
        # ledger observer once the cost model prices the train program)
        # times the interval step rate over the chip-peak gauge. Null with
        # the gauges absent — notably peak on CPU, where the reason rides
        # the mfu_unavailable_reason gauge instead.
        fps = self.registry.gauge("flops_per_step")
        peak = self.registry.gauge("peak_flops_per_sec")
        steps_ps = record["interval_steps_per_s"]
        if steps_ps is None:
            steps_ps = round(self._steps / elapsed, 3) if elapsed > 0 else None
        if fps:
            # a zero-step interval (eval/checkpoint-dominated snapshot) is
            # honestly mfu=0.0, not a fall-back to the lifetime average
            record["mfu"] = (
                round(fps * steps_ps / peak, 5)
                if peak and steps_ps is not None
                else None
            )
        record.update(extra)
        if self._log is not None:
            self._log.append(record)
        return record

    # -- shutdown ------------------------------------------------------

    def close(self) -> None:
        """Final snapshot + Chrome-trace export + log close. Idempotent, and
        safe on every runner exit path (the wedge path's ``os._exit`` skips
        it — telemetry.jsonl is already flushed per append, only the trace
        export is lost, which needs a live main thread anyway)."""
        if not self.enabled or self._closed:
            return
        self._closed = True
        self.snapshot("final")
        if self.trace_path and self.export_chrome_trace:
            try:
                self.tracer.export(self.trace_path)
            except OSError:
                pass  # a full disk must not turn a finished run into a crash
        if self._log is not None:
            self._log.close()


#: Shared inert hub for call sites that want unconditional ``hub.phase(...)``
#: without holding config (bench helpers, bare engines).
NULL_HUB = TelemetryHub(enabled=False)
