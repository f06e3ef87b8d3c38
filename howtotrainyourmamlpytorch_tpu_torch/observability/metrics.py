"""Shared metrics registry: counters, gauges, windowed histograms.

One registry instance backs every telemetry surface of a process — the
runner's step-phase histograms, serving's request-latency percentiles
(``serving/metrics.py``'s ``LatencyStats``/``EventCounters`` are thin
adapters over this), resilience event counts — so a snapshot is one call and
one schema instead of three islands.

Histograms keep a bounded window of raw observations (exact percentiles over
the recent window, cold-start outliers forgotten at window pace — the same
design ``LatencyStats`` shipped with) plus *cumulative* count and sum, so
rate/coverage math over a whole run survives window eviction. Percentile
math happens OUTSIDE the registry lock: ``summaries()`` copies each window
under the lock and releases it before numpy runs, so recorder threads never
block behind ``/metrics`` percentile crunching.
"""

import re
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils.locks import san_lock

DEFAULT_WINDOW = 2048


class _Histogram:
    """Mutated only under the registry lock."""

    __slots__ = ("window", "values", "count", "total")

    def __init__(self, window: int):
        self.window = int(window)
        self.values: deque = deque(maxlen=self.window)
        self.count = 0  # cumulative observations (window evicts, this doesn't)
        self.total = 0.0  # cumulative sum, same lifetime


class MetricsRegistry:
    def __init__(self, default_window: int = DEFAULT_WINDOW):
        if default_window < 1:
            raise ValueError(f"default_window must be >= 1, got {default_window}")
        self.default_window = int(default_window)
        self._lock = san_lock("MetricsRegistry._lock")
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, Any] = {}
        self._hists: Dict[str, _Histogram] = {}

    # -- counters ------------------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def counters(self, prefix: str = "") -> Dict[str, int]:
        """Counters whose name starts with ``prefix`` (stripped off keys)."""
        with self._lock:
            items = list(self._counters.items())
        return {k[len(prefix):]: v for k, v in items if k.startswith(prefix)}

    # -- gauges --------------------------------------------------------

    def set_gauge(self, name: str, value: Any) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge(self, name: str, default: Any = None) -> Any:
        with self._lock:
            return self._gauges.get(name, default)

    def gauges(self) -> Dict[str, Any]:
        """All gauges (copy) — cheap, no histogram math (snapshot() would
        recompute every percentile summary just to reach this dict)."""
        with self._lock:
            return dict(self._gauges)

    # -- histograms ----------------------------------------------------

    def observe(self, name: str, value: float, window: Optional[int] = None) -> None:
        """Record one observation. ``window`` only applies on first use of
        ``name`` (a histogram's window is fixed at creation)."""
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = _Histogram(window or self.default_window)
            hist.values.append(float(value))
            hist.count += 1
            hist.total += float(value)

    def timer(self, name: str, clock=None) -> "_Timer":
        """``with registry.timer("phase.settle"): ...`` — records seconds."""
        import time

        return _Timer(self, name, clock or time.monotonic)

    def window_values(self, name: str) -> List[float]:
        with self._lock:
            hist = self._hists.get(name)
            return list(hist.values) if hist is not None else []

    def summaries(self, prefix: str = "", scale: float = 1e3, suffix: str = "_ms") -> Dict[str, Dict[str, Any]]:
        """Percentile summaries of every histogram under ``prefix`` (prefix
        stripped from keys). The window copy happens under the lock; the
        numpy percentile math runs after it is released, so threads recording
        observations never serialize behind a metrics scrape."""
        with self._lock:
            copies: List[Tuple[str, List[float], int, float]] = [
                (name[len(prefix):], list(h.values), h.count, h.total)
                for name, h in self._hists.items()
                if name.startswith(prefix)
            ]
        out: Dict[str, Dict[str, Any]] = {}
        for key, values, count, total in copies:
            if not values:
                continue
            arr = np.asarray(values, np.float64) * scale
            p50, p95, p99 = np.percentile(arr, [50, 95, 99])
            out[key] = {
                "count": count,
                "window": len(arr),
                f"mean{suffix}": round(float(arr.mean()), 3),
                f"p50{suffix}": round(float(p50), 3),
                f"p95{suffix}": round(float(p95), 3),
                f"p99{suffix}": round(float(p99), 3),
                f"max{suffix}": round(float(arr.max()), 3),
                f"sum{suffix}": round(float(total * scale), 3),
            }
        return out

    def histogram_windows(self) -> List[Tuple[str, List[float], int, float]]:
        """``(name, window copy, cumulative count, cumulative sum)`` per
        histogram, copied under the lock — the raw-value surface for
        renderers (``prometheus_text``) that need full precision rather
        than ``summaries()``'s rounded ms table."""
        with self._lock:
            return [
                (name, list(h.values), h.count, h.total)
                for name, h in sorted(self._hists.items())
            ]

    def snapshot(self) -> Dict[str, Any]:
        """Whole-registry snapshot: counters + gauges verbatim, histograms as
        ms-scaled percentile summaries."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": self.summaries(),
        }


#: Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*; everything else
#: (the registry's dotted names) collapses to underscores
_PROM_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")
#: summary quantiles exposed per histogram (matches summaries()'s p50/95/99)
_PROM_QUANTILES = (0.5, 0.95, 0.99)


def _prom_name(namespace: str, name: str) -> str:
    sanitized = _PROM_BAD_CHARS.sub("_", name)
    if sanitized and sanitized[0].isdigit():
        sanitized = "_" + sanitized
    return f"{namespace}_{sanitized}" if namespace else sanitized


def prometheus_text(registry: "MetricsRegistry", namespace: str = "htymp") -> str:
    """Prometheus/OpenMetrics text exposition of the registry — counters
    (``_total``), numeric gauges, and histograms as summaries (quantile
    series in base-unit SECONDS, plus ``_count``/``_sum``), each with a
    ``# TYPE`` line. Serves ``/metrics?format=prom`` alongside the JSON
    form; the key set is schema-pinned by test. Non-numeric gauges (state
    strings, nested snapshots) are JSON-only — Prometheus samples are
    float64, full stop."""
    lines: List[str] = []
    for name, value in sorted(registry.counters().items()):
        metric = _prom_name(namespace, name) + "_total"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {value}")
    for name, value in sorted(registry.gauges().items()):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        metric = _prom_name(namespace, name)
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {value}")
    # windows copied under the registry lock (inside histogram_windows),
    # percentile math outside it — the same discipline as summaries()
    for name, values, count, total in registry.histogram_windows():
        metric = _prom_name(namespace, name)
        lines.append(f"# TYPE {metric} summary")
        if values:
            arr = np.asarray(values, np.float64)
            for q, v in zip(_PROM_QUANTILES, np.percentile(arr, [100 * q for q in _PROM_QUANTILES])):
                lines.append(f'{metric}{{quantile="{q}"}} {round(float(v), 9)}')
        lines.append(f"{metric}_count {count}")
        lines.append(f"{metric}_sum {round(total, 9)}")
    return "\n".join(lines) + "\n"


class _Timer:
    __slots__ = ("_registry", "_name", "_clock", "_t0")

    def __init__(self, registry: MetricsRegistry, name: str, clock: Callable[[], float]):
        self._registry = registry
        self._name = name
        self._clock = clock

    def __enter__(self):
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc):
        self._registry.observe(self._name, self._clock() - self._t0)
        return False
