"""Run telemetry: span tracing (:mod:`trace`), the metrics registry
(:mod:`metrics`), the hub that snapshots both to ``logs/telemetry.jsonl``
(:mod:`telemetry`) and the serving request context (:mod:`context`),
copies of the JAX package's stdlib and numpy modules, and the device
memory watermarks (:mod:`memory`, over the CUDA caching allocator's
counters).

The XLA-specific modules of the JAX package's ``observability/`` (the
compile ledger, ``costs`` and ``donation``) are not ported (ROADMAP.md
A10).
"""

from .metrics import MetricsRegistry  # noqa: F401
from .telemetry import NULL_HUB, TelemetryHub  # noqa: F401
from .trace import NULL_TRACER, SpanTracer  # noqa: F401
