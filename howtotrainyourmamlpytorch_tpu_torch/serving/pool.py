"""Replicated serving: ``AdaptationEngine`` replicas behind one frontend
(JAX package ``serving/pool.py``).

The fleet layer between the frontend and the engine. Each
:class:`EngineReplica` owns everything whose failure domain is one device:
the engine, its adapt/predict (and, under ``serving.refine_enabled``,
refine) micro-batchers (continuous batching — ``serving/batcher.py``), its
circuit breaker, its adapted-weight cache (the affinity target the router
keeps sessions sticky to), and its outcome counters. :class:`EnginePool`
spawns the replicas, replica k on card ``k % n``: every replica on the
engine's card SHARES the one engine object — separate batchers, breakers,
and caches over one state on the card — and every other card gets one
clone of the engine (``AdaptationEngine.clone_for_device``), shared by the
replicas landing there.

Dispatch guarding (breaker + queue shed + per-request deadline + timeout
attribution) lives on the replica; the router (``serving/router.py``)
decides WHICH replica, this module whether that replica may safely take
the work.
"""

import concurrent.futures
import time
from typing import Any, Dict, List, Optional

import torch

from ..resilience.breaker import CircuitBreaker
from ..resilience.retry import DeadlineExceededError
from .batcher import MicroBatcher, QueueFullError
from .cache import AdaptedWeightCache
from .errors import ServiceUnavailableError

from ..utils.locks import note_blocking, san_lock


def _key_strategy(key) -> "str | None":
    """Strategy component of a batcher group key: ``(strategy, bucket)``
    and ``(tenant, strategy, bucket)`` tuples carry one; bare buckets
    (tests) mean the engine default (None)."""
    if isinstance(key, tuple) and len(key) == 3:
        return key[1]
    if isinstance(key, tuple) and len(key) == 2 and isinstance(key[0], str):
        return key[0]
    return None


def _key_tenant(key) -> "str | None":
    """Tenant component of a batcher group key: only the 3-tuple
    ``(tenant, strategy, bucket)`` form carries one — default-tenant
    traffic keeps the 2-tuple keys, so a flush never mixes tenants."""
    if isinstance(key, tuple) and len(key) == 3:
        return key[0]
    return None


def _indexed(device) -> torch.device:
    """``device`` with its index: ``torch.device("cuda")`` (what
    ``resolve_device`` returns) is the current card, and is not equal to
    ``cuda:0`` until the index is filled in."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _visible_devices(device) -> List[torch.device]:
    """The cards a pool over an engine on ``device`` spreads across: every
    visible CUDA card, or the one CPU (replicas on the CPU share one
    device, as the JAX package's do)."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


class EngineReplica:
    """One serving failure domain: engine + batchers + breaker + cache."""

    def __init__(
        self,
        index: int,
        engine,
        serving_cfg,
        resilience_cfg,
        counters,
        tracer=None,
        clock=time.monotonic,
        solo: bool = False,
    ):
        self.index = int(index)
        self.engine = engine
        self.serving = serving_cfg
        self.resilience = resilience_cfg
        # shared frontend-level EventCounters (global /metrics totals); the
        # per-replica story lives in _counts below
        self.counters = counters
        self.breaker = CircuitBreaker(
            failure_threshold=resilience_cfg.breaker_failure_threshold,
            cooldown_s=resilience_cfg.breaker_cooldown_s,
            half_open_probes=resilience_cfg.breaker_half_open_probes,
            timeout_threshold=resilience_cfg.breaker_timeout_threshold,
            clock=clock,
        )
        self.cache = AdaptedWeightCache(
            max_bytes=serving_cfg.cache_max_bytes, ttl_s=serving_cfg.cache_ttl_s
        )
        # solo (single-replica) pools keep the pre-fleet batcher names:
        # trace span names (serve.flush.adapt) and watchdog labels are part
        # of the observability contract single-replica consumers pin
        suffix = "" if solo else f"-r{self.index}"
        continuous = getattr(serving_cfg, "continuous_batching", False)
        # the batcher group key is (strategy, bucket) from the frontend:
        # requests of different adaptation strategies never share a flush
        self.adapt_batcher = MicroBatcher(
            lambda key, payloads, ctxs: self.engine.adapt_batch(
                payloads, ctxs=ctxs, strategy=_key_strategy(key), tenant=_key_tenant(key)
            ),
            max_batch=serving_cfg.max_batch_size,
            deadline_ms=serving_cfg.batch_deadline_ms,
            name=f"adapt{suffix}",
            max_queue_depth=resilience_cfg.max_queue_depth,
            tracer=tracer,
            pass_contexts=True,
            continuous=continuous,
        )
        self.predict_batcher = MicroBatcher(
            lambda key, payloads, ctxs: self.engine.predict_batch(
                payloads, ctxs=ctxs, strategy=_key_strategy(key), tenant=_key_tenant(key)
            ),
            max_batch=serving_cfg.max_batch_size,
            deadline_ms=serving_cfg.batch_deadline_ms,
            name=f"predict{suffix}",
            max_queue_depth=resilience_cfg.max_queue_depth,
            tracer=tracer,
            pass_contexts=True,
            continuous=continuous,
        )
        # the refine batcher exists ONLY when refinement is configured on —
        # with refine_enabled=False the replica's thread census, stats
        # schema, and watchdog labels are byte-identical to pre-refinement
        self.refine_batcher: Optional[MicroBatcher] = None
        if getattr(serving_cfg, "refine_enabled", False):
            self.refine_batcher = MicroBatcher(
                lambda key, payloads, ctxs: self.engine.refine_batch(
                    payloads, ctxs=ctxs, strategy=_key_strategy(key), tenant=_key_tenant(key)
                ),
                max_batch=serving_cfg.max_batch_size,
                deadline_ms=serving_cfg.batch_deadline_ms,
                name=f"refine{suffix}",
                max_queue_depth=resilience_cfg.max_queue_depth,
                tracer=tracer,
                pass_contexts=True,
                continuous=continuous,
            )
        self._lock = san_lock("EngineReplica._lock")
        self._alive = True
        self._death_reason: Optional[str] = None
        self._counts: Dict[str, int] = {}

    # -- liveness ------------------------------------------------------

    @property
    def alive(self) -> bool:
        with self._lock:
            return self._alive

    def kill(self, reason: str = "killed") -> None:
        """Mark this replica dead (chaos drills, operator action): the
        router stops routing to it immediately; a request already submitted
        keeps its future (an in-flight flush resolves honestly — correct
        result or failure, never a silent drop)."""
        with self._lock:
            self._alive = False
            self._death_reason = reason

    def routable(self) -> bool:
        """May the router send NEW work here? Dead and breaker-OPEN
        replicas are routed around; half-open stays routable — probe
        traffic is the only way the breaker can close again."""
        return self.alive and self.breaker.state != "open"

    def load(self) -> int:
        """Requests queued or mid-flush across the replica's batchers — the
        admission-control signal the router sheds on."""
        load = self.adapt_batcher.pending() + self.predict_batcher.pending()
        if self.refine_batcher is not None:
            load += self.refine_batcher.pending()
        return load

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    # -- the guarded dispatch ------------------------------------------

    def dispatch(self, batcher: MicroBatcher, bucket, payload, ctx=None):
        """One guarded device dispatch: circuit breaker (fail fast while
        the device path is known-bad), queue-depth shed (bounded tail
        latency), per-request deadline (no caller waits forever on a wedged
        device). Dispatch failures/successes feed the breaker, and so do
        deadline timeouts that look like a hang (zero flushes completed
        across the whole wait) — under their own
        (breaker_timeout_threshold) streak, since a wedged backend never
        raises. Pure client-side refusals (shed, breaker-open, deadline
        expiry on a worker that is visibly making progress) do not — they
        say nothing about device health."""
        res = self.resilience
        if not self.alive:
            self._count("dead_rejected")
            raise ServiceUnavailableError(
                f"replica {self.index} is dead ({self._death_reason})",
                retry_after_s=res.shed_retry_after_s,
            )
        permit = self.breaker.allow()
        if permit is None:
            self.counters.inc("breaker_rejected")
            self._count("breaker_rejected")
            raise ServiceUnavailableError(
                f"replica {self.index} circuit breaker {self.breaker.state}; "
                "retry after cooldown",
                retry_after_s=res.breaker_cooldown_s,
            )
        # worker-progress mark, read BEFORE submit: any flush completing
        # while we wait counts as progress when attributing a timeout below
        progress_mark = batcher.flushes_completed()
        # graftsan seam: a caller entering the (blocking) engine dispatch
        # while holding any instrumented lock stalls every thread behind
        # that lock for up to request_deadline_s — report it, armed
        note_blocking("EngineReplica.dispatch")
        try:
            fut = batcher.submit(bucket, payload, ctx=ctx)
        except QueueFullError as exc:
            # never dispatched: a half-open probe slot this call consumed
            # must be returned or the breaker wedges in half_open (the
            # permit makes this a no-op unless this exact call took the slot)
            self.breaker.release_probe(permit)
            self.counters.inc("shed")
            self._count("shed")
            raise ServiceUnavailableError(
                str(exc), retry_after_s=res.shed_retry_after_s
            ) from exc
        try:
            result = fut.result(timeout=res.request_deadline_s)
        except concurrent.futures.TimeoutError as exc:
            fut.cancel()  # drop it if still queued; a racing flush is harmless
            # attribute the expiry before feeding the breaker. The worker
            # completing ANY flush while we waited means the device is
            # making progress and this expiry is queue-wait (or a one-off
            # slow dispatch) on a busy device — overload evidence, not
            # wedge evidence, so only the probe slot (if any) is returned.
            # Zero flushes completed across the whole deadline is the hang
            # signature: a timed-out probe re-opens the breaker (its slot
            # is reclaimed by the trip), and repeated closed-state timeouts
            # trip it at breaker_timeout_threshold.
            if batcher.flushes_completed() != progress_mark:
                self.breaker.release_probe(permit)
                self.counters.inc("queue_wait_expired")
            else:
                self.breaker.record_timeout(permit)
            self.counters.inc("deadline_exceeded")
            self._count("deadline")
            raise DeadlineExceededError(
                f"request exceeded the {res.request_deadline_s}s deadline"
            ) from exc
        except Exception:
            self.counters.inc("dispatch_failures")
            self._count("dispatch_failures")
            self.breaker.record_failure(permit)
            raise
        self.breaker.record_success(permit)
        self._count("ok")
        return result

    # -- observability -------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            counts = dict(self._counts)
            alive = self._alive
            reason = self._death_reason
        out = {
            "replica": self.index,
            "alive": alive,
            "device": str(getattr(self.engine, "device", None) or "default"),
            "breaker": self.breaker.snapshot(),
            "cache": self.cache.stats(),
            "adapt_batcher": self.adapt_batcher.stats(),
            "predict_batcher": self.predict_batcher.stats(),
            "load": self.load(),
            "counts": counts,
        }
        if self.refine_batcher is not None:
            out["refine_batcher"] = self.refine_batcher.stats()
        if reason is not None:
            out["death_reason"] = reason
        return out

    def close(self, join_timeout_s: float = None) -> None:
        self.adapt_batcher.close(join_timeout_s)
        self.predict_batcher.close(join_timeout_s)
        if self.refine_batcher is not None:
            self.refine_batcher.close(join_timeout_s)


class EnginePool:
    """The replica set one frontend serves through.

    ``n_replicas=0`` means one per visible device. Replicas on the
    engine's card share its engine object (and so its state on the card);
    replicas on OTHER cards share one clone per card
    (``AdaptationEngine.clone_for_device``)."""

    def __init__(self, replicas: List[EngineReplica]):
        if not replicas:
            raise ValueError("EnginePool needs at least one replica")
        self.replicas = replicas

    @classmethod
    def build(
        cls,
        engine,
        n_replicas: int,
        serving_cfg,
        resilience_cfg,
        counters,
        tracer=None,
        clock=time.monotonic,
        devices: Optional[List[Any]] = None,
    ) -> "EnginePool":
        """Replica k on ``devices[k % len(devices)]`` (default:
        :func:`_visible_devices`): the engine's own card reuses the engine,
        every other card gets ONE clone, never one per replica."""
        devices = [_indexed(d) for d in (devices if devices is not None else _visible_devices(engine.device))]
        n = int(n_replicas) if n_replicas else len(devices)
        if n < 1:
            raise ValueError(f"n_replicas must be >= 1 (or 0 = per device), got {n_replicas}")
        engine_by_device: Dict[torch.device, Any] = {_indexed(engine.device): engine}
        replicas: List[EngineReplica] = []
        for k in range(n):
            target = devices[k % len(devices)]
            rep_engine = engine_by_device.get(target)
            if rep_engine is None:
                rep_engine = engine.clone_for_device(target, k)
                engine_by_device[target] = rep_engine
            replicas.append(
                EngineReplica(
                    k,
                    rep_engine,
                    serving_cfg,
                    resilience_cfg,
                    counters,
                    tracer=tracer,
                    clock=clock,
                    solo=(n == 1),
                )
            )
        return cls(replicas)

    def __len__(self) -> int:
        return len(self.replicas)

    def engines(self) -> List[Any]:
        """The distinct engines behind the replicas (shared-engine replicas
        dedup to one entry)."""
        seen: List[Any] = []
        for r in self.replicas:
            if not any(r.engine is e for e in seen):
                seen.append(r.engine)
        return seen

    def batcher_stats(self, kind: str) -> Dict[str, Any]:
        """Fleet-aggregate batcher stats under the single-batcher schema
        (counts summed, ``mean_batch`` recomputed) — /metrics keeps its
        historical ``adapt_batcher``/``predict_batcher`` keys. ``refine``
        aggregates the refine batchers (present only with
        ``refine_enabled``); replicas without one contribute nothing."""
        if kind == "refine":
            rows = [
                r.refine_batcher.stats()
                for r in self.replicas
                if r.refine_batcher is not None
            ]
            if not rows:
                return {}
        else:
            rows = [
                (r.adapt_batcher if kind == "adapt" else r.predict_batcher).stats()
                for r in self.replicas
            ]
        out: Dict[str, Any] = {}
        for row in rows:
            for key, value in row.items():
                if key != "mean_batch":
                    out[key] = out.get(key, 0) + value
        out["mean_batch"] = (
            (out["requests"] / out["flushes"]) if out.get("flushes") else 0.0
        )
        return out

    def cache_stats(self) -> Dict[str, Any]:
        """Fleet-aggregate cache stats under the single-cache schema."""
        rows = [r.cache.stats() for r in self.replicas]
        out = {
            key: sum(row[key] for row in rows)
            for key in ("entries", "bytes", "max_bytes", "hits", "misses",
                        "evictions", "expirations")
        }
        total = out["hits"] + out["misses"]
        out["hit_rate"] = (out["hits"] / total) if total else 0.0
        return out

    def pager_stats(self) -> Optional[Dict[str, Any]]:
        """Fleet-aggregate weight-pager stats (serving/tenancy.py), or None
        when the fleet is single-tenant: counts summed across the distinct
        engines' pagers, resident tenants the union (each card owns its
        own resident set)."""
        pagers = [e.pager for e in self.engines() if getattr(e, "pager", None) is not None]
        if not pagers:
            return None
        rows = [p.stats() for p in pagers]
        out: Dict[str, Any] = {
            key: sum(row[key] for row in rows) for key in ("resident", "resident_bytes", "page_ins", "evictions")
        }
        out["budget_bytes"] = rows[0]["budget_bytes"]
        out["resident_tenants"] = sorted({t for row in rows for t in row["resident_tenants"]})
        p50s = [row["page_in_p50_ms"] for row in rows if row["page_in_p50_ms"] is not None]
        out["page_in_p50_ms"] = round(sorted(p50s)[len(p50s) // 2], 3) if p50s else None
        return out

    def stats(self) -> List[Dict[str, Any]]:
        return [r.stats() for r in self.replicas]

    def close(self, join_timeout_s: float = None) -> None:
        for r in self.replicas:
            r.close(join_timeout_s)
