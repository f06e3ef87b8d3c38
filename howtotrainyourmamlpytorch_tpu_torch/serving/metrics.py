"""Serving latency metrics: thin adapters over the shared MetricsRegistry.

Same request-path surface as before (``LatencyStats`` per-phase p50/p95/p99,
``EventCounters`` for the resilience counts) and the exact same ``/metrics``
payload schema, but the storage now lives in one
:class:`~..observability.metrics.MetricsRegistry` — the same registry the
TelemetryHub snapshots — instead of a private island. The registry also
fixes the old lock shape: ``summary()`` used to compute numpy percentiles
*inside* the recording lock, so every recorder thread (HTTP handlers,
batcher workers) blocked behind a ``/metrics`` scrape; the registry copies
each phase window under the lock and runs the percentile math after
releasing it.
"""

import time
from typing import Any, Dict, Optional

from ..observability.metrics import MetricsRegistry

#: registry namespaces the adapters write under — one registry can host both
#: (plus the hub's ``phase.*`` histograms) without key collisions
LATENCY_PREFIX = "serving.latency."
EVENTS_PREFIX = "serving.events."


class LatencyStats:
    """Per-phase latency percentiles ("adapt", "adapt_cached", "predict",
    "queue"): a bounded window of wall-clock seconds per phase, exact
    percentiles over the recent window (cold-start compiles forgotten at
    window pace). ``summary()`` is the ``/metrics`` payload — schema
    unchanged from the pre-registry implementation."""

    def __init__(self, window: int = 2048, registry: Optional[MetricsRegistry] = None):
        self.window = int(window)
        self.registry = registry if registry is not None else MetricsRegistry()

    def record(self, phase: str, seconds: float) -> None:
        self.registry.observe(LATENCY_PREFIX + phase, seconds, window=self.window)

    def time(self, phase: str):
        """Context manager: ``with stats.time("adapt"): ...``"""
        return _Timer(self, phase)

    def summary(self) -> Dict[str, Dict[str, Any]]:
        out = self.registry.summaries(LATENCY_PREFIX)
        for stats in out.values():
            # the registry adds a cumulative sum; /metrics keeps its
            # historical per-phase key set exactly
            stats.pop("sum_ms", None)
        return out


class EventCounters:
    """Thread-safe named counters for the resilience surface (shed requests,
    deadline misses, breaker rejections, dispatch failures) — the numbers the
    OPERATIONS.md degraded-modes runbook reads off ``/metrics``."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()

    def inc(self, name: str, n: int = 1) -> None:
        self.registry.inc(EVENTS_PREFIX + name, n)

    def get(self, name: str) -> int:
        return self.registry.counter(EVENTS_PREFIX + name)

    def snapshot(self) -> Dict[str, int]:
        return self.registry.counters(EVENTS_PREFIX)


class _Timer:
    def __init__(self, stats: LatencyStats, phase: str):
        self._stats = stats
        self._phase = phase

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._stats.record(self._phase, time.monotonic() - self._t0)
        return False
