"""Run telemetry: span tracing (:mod:`trace`), the metrics registry
(:mod:`metrics`), the hub that snapshots both to ``logs/telemetry.jsonl``
(:mod:`telemetry`) and the serving request context (:mod:`context`),
copies of the JAX package's stdlib and numpy modules, and the device
memory watermarks (:mod:`memory`, over the CUDA caching allocator's
counters).

The program layer's modules: :mod:`costs` (FLOPs by the flop counter, the
H100 peak table, MFU) and :mod:`compile_ledger` (every CUDA-graph capture,
first eager dispatch and ``nvcc`` build, priced) and :mod:`donation`
(the donation audit and the A/B self-check that gates
``donate_train_state``).
"""

from .metrics import MetricsRegistry  # noqa: F401
from .telemetry import NULL_HUB, TelemetryHub  # noqa: F401
from .trace import NULL_TRACER, SpanTracer  # noqa: F401
