"""Run telemetry: span tracing (:mod:`trace`), the metrics registry
(:mod:`metrics`) and the hub that snapshots both to ``logs/telemetry.jsonl``
(:mod:`telemetry`), copies of the JAX package's stdlib and numpy modules.

The XLA-specific modules of the JAX package's ``observability/`` (the
compile ledger, ``costs``, ``memory`` and ``donation``) and the serving
request context are not ported (ROADMAP.md A10, A8).
"""

from .metrics import MetricsRegistry  # noqa: F401
from .telemetry import NULL_HUB, TelemetryHub  # noqa: F401
from .trace import NULL_TRACER, SpanTracer  # noqa: F401
