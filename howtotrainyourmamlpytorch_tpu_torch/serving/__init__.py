"""Few-shot adaptation serving (JAX package ``serving/``): a trained
checkpoint as a request engine on the card.

- :mod:`engine` — ``AdaptationEngine``: adapt / refine / predict with shape
  bucketing (padded + masked, so padding never changes predictions);
- :mod:`cache` — ``AdaptedWeightCache``: content-addressed LRU of adapted
  parameter trees (byte budget, TTL), and ``support_digest``, the
  adaptation id both packages compute alike;
- :mod:`batcher` — ``MicroBatcher``: deadline/max-batch micro-batching —
  continuous under load — of concurrent requests into device dispatches;
- :mod:`pool` — ``EnginePool``/``EngineReplica``: replicas, each with its
  own batchers, breaker and cache, sharing one engine per card (a clone of
  the engine on every card but its own);
- :mod:`registry` — ``TenantRegistry``: tenant ids -> checkpoints, masters
  loaded lazily into pinned host RAM;
- :mod:`tenancy` — ``WeightPager`` (tenant masters paged onto the card
  under a byte budget and the memory watermark) and ``TenantQuotas``;
- :mod:`router` — ``Router``: cache-affinity routing (rendezvous hashing)
  + admission control shed;
- :mod:`sessions` — ``SessionStore``: sessions spilled at a drain and
  rehydrated at the next start, in the JAX package's file format;
- :mod:`metrics` — ``LatencyStats``: per-phase p50/p95/p99;
- :mod:`server` — ``ServingFrontend`` (in-process API) + a stdlib
  ``ThreadingHTTPServer`` JSON front-end (``python -m
  howtotrainyourmamlpytorch_tpu_torch.serve``).

- :mod:`gateway` — ``Gateway``: the multi-host load balancer in front of
  N serve processes (membership hysteresis, session affinity, retry with
  exclusion, admission), stdlib only;
- :mod:`fleetctl` and :mod:`autoscaler` — the fleet-state journal,
  spawn/drain primitives and the autoscaling ``Supervisor``, stdlib only
  and loaded by file path (``scripts/fleet_serve.py``,
  ``scripts/rolling_restart.py``), never by this package's import.
"""

from .batcher import MicroBatcher, QueueFullError  # noqa: F401
from .cache import AdaptedWeightCache, support_digest, tree_bytes  # noqa: F401
from .engine import AdaptationEngine  # noqa: F401
from .errors import ServiceUnavailableError, UnknownAdaptationError  # noqa: F401
from .gateway import Gateway, make_gateway_server  # noqa: F401
from .metrics import EventCounters, LatencyStats  # noqa: F401
from .pool import EnginePool, EngineReplica  # noqa: F401
from .router import NoRoutableReplicaError, Router, rendezvous_score  # noqa: F401
from .server import (  # noqa: F401
    ServingFrontend,
    drain_exit_code,
    frontend_from_run_dir,
    make_http_server,
    run_server,
    serve_forever,
)
from .sessions import SessionStore  # noqa: F401
