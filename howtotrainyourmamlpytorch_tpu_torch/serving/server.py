"""The serving front-end: in-process API + a thin stdlib HTTP JSON layer
(JAX package ``serving/server.py``).

``ServingFrontend`` wires the pieces together — engine (adapt / refine /
predict on the card), adapted-weight cache, micro-batchers, latency metrics
— behind the request API a client sees:

- ``adapt(x_support, y_support) -> {adaptation_id, cached, ...}``: run (or
  skip, on cache hit) the inner loop; the returned id names the cached
  adapted weights.
- ``refine(session_id, x_support, y_support)``: continue a session's
  rollout from its cached weights, guarded by a held-out probe (commit,
  rollback, quarantine), under ``serving.refine_enabled``.
- ``predict(adaptation_id, x_query) -> probs``: forward queries through the
  cached adapted weights.
- ``adapt_predict(...)``: both in one call, for one-shot clients.
- ``metrics() / healthz()``: the observability surface.

Every request may name a tenant (``serving/registry.py``): with a tenant
registry the engine pages that tenant's master onto the card
(``serving/tenancy.py::WeightPager``), per-tenant quotas shed 429 +
``Retry-After`` at admission, the cache key carries the tenant's checkpoint
fingerprint (so one tenant never resolves another's adaptation id), and
``/metrics`` gains a ``tenants`` block. With observability on, the device
memory watermarks (``observability/memory.py``) are the ``memory`` block
and the pagers' eviction signal.

The HTTP layer (``ThreadingHTTPServer`` + JSON bodies) is stdlib-only and
thin: every handler parses JSON, calls the frontend, serializes the result.
Concurrency comes from the threaded server (one thread per in-flight
request) feeding the batchers, whose worker threads dispatch to the card:
the engine names its device on every tensor and kernel launch, so a worker
thread needs no current-device state of its own.

Under ``aot.enabled`` the frontend runs the engine's serving prewarm
(``AdaptationEngine.prewarm``: every planned shape dispatched once) at
construction, in the background when ``aot.serving_background`` is set, and
``/healthz`` answers 503 ``warming`` until it returns, so that a gateway
holds traffic off a cold backend. The lock-discipline sanitizer
(``resilience.sanitizer`` or ``HTYMP_GRAFTSAN=1``, ``tools/graftsan``) is
armed before the frontend builds its locks; its findings go to the events
log, and ``close()`` audits the threads the frontend started. With
telemetry on, the engine gets a collector-only compile ledger
(``observability/compile_ledger.py``): each planned shape's first dispatch
is a row of the ``compile_ledger`` hub provider and of ``/metrics``
``compiled.compile_ledger``.
"""

import contextlib
import json
import os
import signal
import sys
import threading
import time
import urllib.parse
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..config import Config, ResilienceConfig, ServingConfig
from ..core.strategies import validate_request_strategy
from ..exit_codes import DRAIN_DEADLINE, HTTP_DEADLINE, HTTP_UNAVAILABLE, OK
from ..observability import TelemetryHub
from ..observability.context import (
    AccessLog,
    RequestContext,
    flow_start,
    format_traceparent,
    new_request_context,
    parse_traceparent,
)
from ..observability.memory import MemoryWatermarks
from ..observability.metrics import prometheus_text
from ..observability.trace import NULL_TRACER
from ..resilience.retry import DeadlineExceededError
from ..resilience.watchdog import HeartbeatWatchdog
from .cache import SessionLineage, support_digest
from .engine import AdaptationEngine
from .errors import (  # noqa: F401 — re-exported, as the JAX package does
    ServiceUnavailableError,
    SessionQuarantinedError,
    UnknownAdaptationError,
)
from .metrics import EventCounters, LatencyStats
from .pool import EnginePool
from .router import Router, rendezvous_score
from .sessions import SessionStore, decode_lineage, encode_lineage
from .tenancy import QuotaExceededError, TenantQuotas, validate_request_tenant

from ..utils.locks import san_condition, san_lock


class _LazyTenantFingerprints:
    """Mapping view the session rehydrator hands ``SessionStore.load_all``:
    ``get(tenant)`` resolves a REGISTERED tenant's checkpoint fingerprint on
    demand (loading its master into host RAM only then), so rehydrating a
    run dir with zero spilled tenant sessions never touches a tenant
    checkpoint — the registry stays lazy."""

    def __init__(self, registry):
        self._registry = registry

    def get(self, tenant, default=None):
        if tenant not in self._registry:
            return default
        try:
            return self._registry.fingerprint(tenant)
        except Exception:  # noqa: BLE001 — an unloadable tenant is foreign
            return default


class ServingFrontend:
    def __init__(
        self,
        engine: AdaptationEngine,
        serving_cfg: Optional[ServingConfig] = None,
        resilience_cfg: Optional[ResilienceConfig] = None,
        clock=time.monotonic,
        wedge_exit=None,
        hub: Optional[TelemetryHub] = None,
        access_log_dir: Optional[str] = None,
        replicas: Optional[int] = None,
    ):
        self.engine = engine
        self.serving = serving_cfg or engine.serving
        # fleet size: explicit arg > Config.serving.replicas; 0 = one
        # replica per visible device (serving/pool.py)
        self._n_replicas = int(replicas) if replicas is not None else int(self.serving.replicas)
        # resilience knobs ride the run config like the serving knobs do;
        # clock is injectable so breaker tests walk cooldowns without waiting
        self.resilience = resilience_cfg or engine.cfg.resilience
        # graftsan: arm the lock-discipline sanitizer BEFORE this frontend
        # constructs its locks, pool and batchers, so they come out
        # instrumented (locks built earlier stay plain unless
        # HTYMP_GRAFTSAN=1 armed the whole process)
        self._graftsan = None
        if self.resilience.sanitizer or os.environ.get("HTYMP_GRAFTSAN") == "1":
            try:
                from tools.graftsan import runtime as _graftsan_runtime

                _graftsan_runtime.arm()
                self._graftsan = _graftsan_runtime
            except ImportError:  # packaged without tools/: sanitizer off
                self._graftsan = None
        # close-audit baseline: threads alive before this frontend spawned
        # any; a non-daemon thread that outlives close() beyond these is a
        # leak this frontend owns
        self._graftsan_thread_baseline = {t.ident for t in threading.enumerate()}
        # one TelemetryHub per frontend (no logs dir — a server owns no run
        # directory; tracer + registry only, snapshot on demand). The SAME
        # registry backs the LatencyStats/EventCounters adapters, so the
        # /metrics payload and the hub read one set of numbers.
        self.hub = hub if hub is not None else TelemetryHub.from_config(engine.cfg.observability)
        self.latency = LatencyStats(self.serving.latency_window, registry=self.hub.registry)
        self.counters = EventCounters(registry=self.hub.registry)
        self._memory: Optional[MemoryWatermarks] = None
        # structured access log (observability/context.py): one JSON line
        # per request in <access_log_dir>/access.jsonl, and serving events
        # (drain milestones, session spill/rehydrate) in events.jsonl — only
        # with a log dir AND observability on
        self.access_log: Optional[AccessLog] = None
        self.events = None
        if self.hub.enabled and access_log_dir:
            obs_cfg = engine.cfg.observability
            if obs_cfg.access_log:
                self.access_log = AccessLog(access_log_dir, sample=obs_cfg.access_log_sample)
            from ..experiment.storage import EventLog

            self.events = EventLog(access_log_dir)
        if self._graftsan is not None and self.events is not None:
            # sanitizer findings land as graftsan_violation records next to
            # the serving events they implicate
            self._graftsan.add_sink(self.events.append)
        if self.hub.enabled:
            # trace the engine's device dispatches and the batchers' flushes
            # through the hub's tracer (engines built standalone keep their
            # own tracer if one was injected)
            if self.engine.tracer is NULL_TRACER:
                self.engine.tracer = self.hub.tracer
            self.hub.add_provider("breaker", lambda: self.breaker.snapshot())
            obs_cfg = engine.cfg.observability
            # collector-only compile ledger (a server owns no run dir): each
            # planned shape's first dispatch shows in /metrics.compiled and
            # in every hub snapshot
            if self.engine.compile_ledger is None and obs_cfg.compile_ledger:
                from ..observability.compile_ledger import CompileLedger

                self.engine.compile_ledger = CompileLedger(session=self.hub.session_id)
            if self.engine.compile_ledger is not None:
                self.hub.add_provider("compile_ledger", self.engine.compile_ledger.summary)
            if obs_cfg.memory_watermarks:
                self._memory = MemoryWatermarks(obs_cfg.hbm_headroom_warn_frac)
                self.hub.add_provider("memory", self._memory.snapshot)
        # --- the fleet: pool + router (serving/pool.py, serving/router.py)
        # One EngineReplica per requested replica, each with its own
        # batchers (continuous batching), circuit breaker, and adapted-
        # weight cache; the router keeps sessions affine to the replica
        # holding their fast weights and sheds at admission.
        self.pool = EnginePool.build(
            engine,
            self._n_replicas,
            serving_cfg=self.serving,
            resilience_cfg=self.resilience,
            counters=self.counters,
            tracer=self.hub.tracer,
            clock=clock,
        )
        self.router = Router(
            self.pool.replicas,
            max_queued_per_replica=self.serving.router_max_queued_per_replica,
            shed_retry_after_s=self.resilience.shed_retry_after_s,
        )
        # --- multi-tenant serving (serving/registry.py + tenancy.py) ------
        # quotas and the watermark eviction signal only exist when the
        # engine carries a registry; single-tenant frontends pay nothing
        self.quotas: Optional[TenantQuotas] = None
        if engine.registry is not None:
            self.quotas = TenantQuotas(
                max_inflight=self.serving.tenant_max_inflight,
                rate_rps=self.serving.tenant_rate_rps,
                max_resident_bytes=self.serving.tenant_max_resident_bytes,
            )
            if self._memory is not None:
                # real per-card memory pressure preempts the static budget
                for e in self.pool.engines():
                    if e.pager is not None:
                        e.pager.watermarks = self._memory
        # single-replica views (tests, operator tools): the primary's objects
        primary = self.pool.replicas[0]
        self.breaker = primary.breaker
        self.cache = primary.cache
        self._adapt_batcher = primary.adapt_batcher
        self._predict_batcher = primary.predict_batcher
        if self.hub.enabled and len(self.pool) > 1:
            self.hub.add_provider("router", self.router.stats)
        self._started = time.monotonic()
        self._closed = False
        # --- graceful drain state (begin_drain / run_server) -------------
        # one lock guards the draining flag and the in-flight request count;
        # the condition lets the drain thread sleep until the count reaches
        # zero instead of polling
        self._drain_lock = san_lock("ServingFrontend._drain_lock")
        self._drain_zero = san_condition("ServingFrontend._drain_zero", self._drain_lock)
        self._draining = False
        self._inflight = 0
        self._drain_info: Dict[str, Any] = {}
        # set once the FIRST drain fully completes (verdict recorded) — a
        # second SIGTERM blocks on it instead of racing ahead
        self._drain_done = threading.Event()
        # --- refinement lineage (serving/cache.py::SessionLineage) --------
        # per-session refinement history, keyed by the full cache key.
        # Bounded LRU: an evicted lineage costs nothing but history — the
        # next refine re-seeds a baseline. Empty with refine_enabled=false.
        self._lineage_lock = san_lock("ServingFrontend._lineage_lock")
        self._lineages: "OrderedDict[Tuple[str, str, str], Any]" = OrderedDict()
        self._max_lineages = 4096
        # --- session spill/rehydrate (serving/sessions.py) ----------------
        # run-dir engines spill hot adapted sessions at drain and rehydrate
        # them here at startup, so a restart keeps its sessions warm
        self.session_store = None
        self._session_stats: Dict[str, int] = {}
        if self.serving.session_spill and getattr(engine, "save_dir", None):
            self.session_store = SessionStore(
                os.path.join(engine.save_dir, "sessions"), engine.system.model.feature_shape
            )
            self._rehydrate_sessions()
        # --- the serving prewarm (Config.aot; AdaptationEngine.prewarm) ---
        # dispatch the full (bucket x batch-bucket) grid before (or, in the
        # background, while) the frontend accepts work: /healthz answers 503
        # "warming" until it returns, DISTINCT from the breaker's
        # "degraded", so a gateway holds traffic off a replica whose first
        # requests would pay every shape's first dispatch
        self._prewarm_lock = san_lock("ServingFrontend._prewarm_lock")
        self._prewarm: Dict[str, Any] = {"status": "disabled"}
        self._prewarm_thread: Optional[threading.Thread] = None
        aot_cfg = engine.cfg.aot
        if aot_cfg.enabled:
            with self._prewarm_lock:
                self._prewarm = {"status": "warming"}
            if aot_cfg.serving_background:
                self._prewarm_thread = threading.Thread(target=self._run_prewarm, name="serving-prewarm", daemon=True)
                self._prewarm_thread.start()
            else:
                self._run_prewarm()
        # wedge watchdogs over the batcher flush workers (poll mode): work
        # pending with zero completed flushes across the whole deadline
        # means that worker is parked in a hung device dispatch. The breaker
        # fail-fasts clients on that signature; only a process restart can
        # un-hang the worker, so the watchdog dumps stacks and exits rc=76.
        # One watchdog per batcher: progress is per worker.
        self._watchdogs: list = []
        wd_cfg = self.resilience.watchdog
        if wd_cfg.enabled and wd_cfg.serve_enabled:
            batchers = [
                b
                for r in self.pool.replicas
                for b in (r.adapt_batcher, r.predict_batcher, r.refine_batcher)
                if b is not None
            ]
            for batcher in batchers:
                wd = HeartbeatWatchdog(
                    deadline_s=wd_cfg.serve_deadline_s,
                    poll_s=wd_cfg.poll_s,
                    on_wedge=self._on_wedge,
                    exit_code=wd_cfg.wedge_exit_code,
                    exit_fn=wedge_exit if wedge_exit is not None else os._exit,
                    progress_fn=batcher.flushes_completed,
                    pending_fn=batcher.pending,
                    name=f"serving-{batcher.name}",
                )
                wd.arm(batcher.name)
                self._watchdogs.append(wd)

    def _run_prewarm(self) -> None:
        """Dispatch the planned serving grid (``engine.prewarm``, or
        ``pool.prewarm`` over every distinct engine of a fleet) and publish
        the outcome. Runs on the background prewarm thread (or inline when
        ``aot.serving_background=false``); a failure degrades to cold first
        dispatches with the error visible in /metrics, never a dead
        server."""
        t0 = time.monotonic()
        try:
            summary = self.pool.prewarm() if len(self.pool) > 1 else self.engine.prewarm()
            result = {
                "status": "warm",
                "programs": summary["programs"],
                "seconds": summary["seconds"],
                "cache_hits": summary["cache_hits"],
                "store_hits": summary.get("store_hits", 0),
                "compile_errors": summary["errors"],
            }
            if "replicas" in summary:
                result["replicas"] = summary["replicas"]
        except Exception as exc:  # noqa: BLE001 — prewarm must not kill serving
            result = {
                "status": "error",
                "seconds": round(time.monotonic() - t0, 3),
                "error": f"{type(exc).__name__}: {exc}",
            }
        with self._prewarm_lock:
            self._prewarm = result
        print(
            f"serving prewarm: {result['status']} in {result['seconds']}s"
            + (
                f" ({result['programs']} programs, {result['cache_hits']} persistent-cache hits)"
                if result["status"] == "warm"
                else f" ({result.get('error')})"
            ),
            flush=True,
        )

    def prewarm_status(self) -> Dict[str, Any]:
        with self._prewarm_lock:
            return dict(self._prewarm)

    def wait_prewarm(self, timeout_s: float = 600.0) -> Dict[str, Any]:
        """Block until the background prewarm settles (bounded), then return
        its status: the readiness hook for supervisors and tests."""
        thread = self._prewarm_thread
        if thread is not None:
            thread.join(timeout=timeout_s)
        return self.prewarm_status()

    def _on_wedge(self, info: Dict[str, Any]) -> None:
        """Serving wedge post-mortem: one structured JSON line + per-thread
        stacks on stderr, then the watchdog exits with the wedge code."""
        self.counters.inc("wedged")
        print(
            json.dumps(
                {
                    "event": "wedged",
                    "component": "serving",
                    "stage": info["stage"],
                    "stall_s": info["stall_s"],
                    "adapt_batcher": self.pool.batcher_stats("adapt"),
                    "predict_batcher": self.pool.batcher_stats("predict"),
                }
            ),
            file=sys.stderr,
            flush=True,
        )
        for label, stack in info["threads"].items():
            print(f"--- thread {label} ---", file=sys.stderr)
            for line in stack:
                print(line, file=sys.stderr)
        sys.stderr.flush()

    # ------------------------------------------------------------------

    def _cache_key(self, digest: str, strategy: str, tenant: Optional[str] = None) -> Tuple[str, str, str]:
        """Adapted-session cache key: (checkpoint fingerprint, strategy,
        adaptation id). The strategy is an explicit component — a ProtoNet
        prototype table and a MAML fast-weight tree for the same support
        set must never collide — on top of being folded into the digest
        itself (serving/cache.py::support_digest). A non-default tenant's
        key carries THAT tenant's checkpoint fingerprint, so a cross-tenant
        predict (tenant B naming tenant A's adaptation id) misses into the
        honest 404 — it can never resolve to another tenant's weights."""
        fp = self.engine.registry.fingerprint(tenant) if tenant is not None else self.engine.fingerprint
        return (fp, strategy, digest)

    # -- refinement lineage (serving/cache.py::SessionLineage) ----------

    def _lineage_for(self, key: Tuple[str, str, str], create: bool = False):
        """The session's lineage record (None when it has none and
        ``create`` is false), in a bounded LRU table."""
        with self._lineage_lock:
            lineage = self._lineages.get(key)
            if lineage is not None:
                self._lineages.move_to_end(key)
            elif create:
                lineage = SessionLineage(snapshot_ring=self.serving.refine_snapshot_ring)
                self._lineages[key] = lineage
                while len(self._lineages) > self._max_lineages:
                    self._lineages.popitem(last=False)
            return lineage

    def _pop_lineage(self, key: Tuple[str, str, str]):
        with self._lineage_lock:
            return self._lineages.pop(key, None)

    def _quarantined(self, key: Tuple[str, str, str]) -> bool:
        with self._lineage_lock:
            lineage = self._lineages.get(key)
        return lineage is not None and lineage.quarantined

    def _count_strategy(self, strategy: str, verb: str, outcome: str) -> None:
        """Per-strategy outcome tally (the /metrics ``strategies`` block):
        one increment per request, keyed
        ``serving.strategy.<name>.<verb>.<outcome>``."""
        self.hub.registry.inc(f"serving.strategy.{strategy}.{verb}.{outcome}")

    def _count_tenant(self, tenant: Optional[str], verb: str, outcome: str) -> None:
        """Per-tenant outcome tally, keyed
        ``serving.tenant.<id>.<verb>.<outcome>`` — only in tenant mode, so
        a single-tenant deployment's counter namespace is unchanged."""
        if self.engine.registry is None:
            return
        self.hub.registry.inc(f"serving.tenant.{tenant or 'default'}.{verb}.{outcome}")

    def _acquire_quota(self, tenant: Optional[str]) -> Optional[str]:
        """Per-tenant admission (rate + inflight token): returns the quota
        label to release, or None when quotas are off. A breach becomes the
        shed contract — 429 + honest ``Retry-After`` — and is per-tenant by
        construction: other tenants' admission never sees it."""
        if self.quotas is None or not self.quotas.enabled:
            return None
        label = tenant or "default"
        try:
            self.quotas.acquire(label)
        except QuotaExceededError as exc:
            self.counters.inc("tenant_quota_rejected")
            raise ServiceUnavailableError(str(exc), retry_after_s=exc.retry_after_s, status=429) from exc
        return label

    def _check_resident_quota(self, tenant: Optional[str], fingerprint: str) -> None:
        """Before an adapt inserts NEW bytes: the tenant's live adapted-
        session bytes (summed over every replica cache, from the entries,
        not counters) must fit its quota."""
        if self.quotas is None or not self.quotas.max_resident_bytes:
            return
        resident = sum(r.cache.bytes_for_fingerprint(fingerprint) for r in self.pool.replicas)
        try:
            self.quotas.check_resident_bytes(tenant or "default", resident)
        except QuotaExceededError as exc:
            self.counters.inc("tenant_quota_rejected")
            raise ServiceUnavailableError(str(exc), retry_after_s=exc.retry_after_s, status=429) from exc

    def _sweep_pagers(self) -> None:
        """Watermark eviction sweep: ask each engine's pager to evict its
        LRU tenant while the tightest per-card headroom sits below the
        configured floor (free when the knob is off), then forward the
        pagers' page-in/eviction records to events.jsonl. Called after
        tenant-mode dispatches."""
        for e in self.pool.engines():
            pager = e.pager
            if pager is None:
                continue
            pager.check_watermark()
            for rec in pager.drain_events():
                if rec["event"] == "tenant_evicted":
                    self.counters.inc("tenant_evictions")
                    if rec.get("reason") == "hbm_watermark":
                        self.counters.inc("tenant_watermark_evictions")
                self._event(rec.pop("event"), **rec)

    def _request_ctx(self, ctx: Optional[RequestContext]) -> Optional[RequestContext]:
        """The per-request trace identity: adopt the caller's, mint one when
        observability is on, stay None when it is off."""
        if ctx is not None or not self.hub.enabled:
            return ctx
        return new_request_context()

    def _record_access(
        self, ctx: Optional[RequestContext], verb: str, outcome: str, status: int, total_s: float
    ) -> None:
        if ctx is None or self.access_log is None:
            return
        self.access_log.record(ctx, verb, outcome, status, total_s, breaker=self.breaker.state)

    def log_http_access(
        self, ctx: Optional[RequestContext], verb: str, outcome: str, status: int, total_s: float
    ) -> None:
        """HTTP-layer seam for requests the frontend methods never saw —
        parse errors, unknown paths, handler-level faults, degraded
        /healthz. ``ctx.access_logged`` guards double-logging."""
        if ctx is None or ctx.access_logged:
            return
        self._record_access(ctx, verb, outcome, status, total_s)

    @staticmethod
    def _failure_of(exc: BaseException) -> Tuple[str, int]:
        """Map a request-path exception to its (outcome, HTTP status) pair
        — the access log's taxonomy, identical in-process and over HTTP."""
        if isinstance(exc, SessionQuarantinedError):
            return "quarantined", exc.status
        if isinstance(exc, ServiceUnavailableError):
            return "shed", exc.status
        if isinstance(exc, DeadlineExceededError):
            return "deadline", HTTP_DEADLINE
        if isinstance(exc, UnknownAdaptationError):
            return "unknown_id", 404
        return "error", 500

    def _note_padding(self, verb: str, true_size: int, bucket, strategy: Optional[str] = None) -> None:
        """Padding-waste accounting: device work scales with the PADDED
        sample count, so the wasted fraction over traffic is
        ``1 - true_samples / padded_samples``. Called after a dispatch
        returns, so only work actually done is counted."""
        if not isinstance(bucket, (int, np.integer)) or bucket <= 0:
            return
        reg = self.hub.registry
        reg.inc(f"serving.padding.{verb}.true_samples", int(true_size))
        reg.inc(f"serving.padding.{verb}.padded_samples", int(bucket))
        # per-bucket tallies: the traffic histogram serving/buckets.py tunes from
        reg.inc(f"serving.padding.{verb}.bucket.{int(bucket)}.count", 1)
        reg.inc(f"serving.padding.{verb}.bucket.{int(bucket)}.true_samples", int(true_size))
        if strategy:
            reg.inc(f"serving.padding.strategy.{strategy}.{verb}.true_samples", int(true_size))
            reg.inc(f"serving.padding.strategy.{strategy}.{verb}.padded_samples", int(bucket))
        verbs = ("adapt", "predict", "refine")
        true_total = sum(reg.counter(f"serving.padding.{v}.true_samples") for v in verbs)
        padded_total = sum(reg.counter(f"serving.padding.{v}.padded_samples") for v in verbs)
        if padded_total:
            reg.set_gauge("serving.padding_waste_frac", round(1.0 - true_total / padded_total, 4))

    def padding_stats(self) -> Dict[str, Any]:
        """The /metrics ``padding`` block: per-verb true vs padded sample
        totals and waste fractions, per bucket and per strategy."""
        reg = self.hub.registry
        out: Dict[str, Any] = {}
        true_total = padded_total = 0
        # the refine verb joins the block only once refine traffic exists
        verbs = ["adapt", "predict"]
        if reg.counter("serving.padding.refine.padded_samples"):
            verbs.append("refine")
        for verb in verbs:
            t = reg.counter(f"serving.padding.{verb}.true_samples")
            p = reg.counter(f"serving.padding.{verb}.padded_samples")
            true_total += t
            padded_total += p
            out[verb] = {
                "true_samples": t,
                "padded_samples": p,
                "padding_waste_frac": round(1.0 - t / p, 4) if p else None,
            }
        out["padding_waste_frac"] = round(1.0 - true_total / padded_total, 4) if padded_total else None
        by_bucket: Dict[str, Dict[str, Dict[str, int]]] = {}
        for verb in verbs:
            rows: Dict[str, Dict[str, int]] = {}
            for name, value in reg.counters(f"serving.padding.{verb}.bucket.").items():
                bucket_id, _, field = name.partition(".")
                if field in ("count", "true_samples"):
                    rows.setdefault(bucket_id, {})[field] = value
            if rows:
                by_bucket[verb] = rows
        if by_bucket:
            out["by_bucket"] = by_bucket
        by_strategy: Dict[str, Dict[str, Any]] = {}
        for name, value in reg.counters("serving.padding.strategy.").items():
            s, _, rest = name.partition(".")  # rest = "<verb>.<field>"
            _, _, field = rest.partition(".")
            row = by_strategy.setdefault(s, {"true_samples": 0, "padded_samples": 0})
            if field in row:
                row[field] += value
        for row in by_strategy.values():
            row["padding_waste_frac"] = (
                round(1.0 - row["true_samples"] / row["padded_samples"], 4) if row["padded_samples"] else None
            )
        if by_strategy:
            out["by_strategy"] = by_strategy
        return out

    def strategy_stats(self) -> Dict[str, Any]:
        """The /metrics ``strategies`` block: per-strategy request/outcome
        tallies (one ``<verb>.<outcome>`` counter bump per request)."""
        out: Dict[str, Any] = {}
        for name, value in self.hub.registry.counters("serving.strategy.").items():
            s, _, rest = name.partition(".")  # rest = "<verb>.<outcome>"
            row = out.setdefault(s, {"requests": 0})
            row[rest] = row.get(rest, 0) + value
            row["requests"] += value
        return out

    def tenant_stats(self) -> Dict[str, Any]:
        """Per-tenant request/outcome tallies (same schema as
        :meth:`strategy_stats`, keyed ``serving.tenant.<id>.<verb>.<outcome>``)
        — the ``by_tenant`` half of the /metrics ``tenants`` block."""
        out: Dict[str, Any] = {}
        for name, value in self.hub.registry.counters("serving.tenant.").items():
            t, _, rest = name.partition(".")  # rest = "<verb>.<outcome>"
            row = out.setdefault(t, {"requests": 0})
            row[rest] = row.get(rest, 0) + value
            row["requests"] += value
        return out

    def kill_replica(self, index: int, reason: str = "operator") -> None:
        """Mark one replica dead (chaos drills, operator action): the
        router stops routing to it from the next request on, the rest of
        the fleet keeps serving, and the death lands in events.jsonl and in
        the access log as a synthetic ``replica_death`` line, the
        access-log-resolvable event the chaos invariant looks for."""
        replica = self.pool.replicas[index]
        replica.kill(reason)
        self.counters.inc("replica_deaths")
        self._event(
            "replica_death",
            replica=index,
            reason=reason,
            routable=sum(1 for r in self.pool.replicas if r.routable()),
        )
        if self.access_log is not None:
            ctx = new_request_context()
            ctx.replica = index
            self.access_log.record(ctx, "replica_death", "dead", None, None, replica=index, reason=reason)

    # ------------------------------------------------------------------
    # graceful drain + session spill/rehydrate
    # ------------------------------------------------------------------

    def _event(self, name: str, **fields: Any) -> None:
        """One structured serving event into <logs>/events.jsonl (no-op
        without a log dir); a failed append must never fail a request."""
        if self.events is None:
            return
        try:
            self.events.append({"ts": time.time(), "event": name, "component": "serving", **fields})
        except OSError:
            pass

    def _enter_request(self) -> None:
        """Admission gate + in-flight accounting: a request arriving after
        drain began is refused 503 + Retry-After."""
        with self._drain_lock:
            if self._draining:
                raise ServiceUnavailableError(
                    "backend is draining (shutting down); retry against another backend",
                    retry_after_s=self.resilience.shed_retry_after_s,
                )
            self._inflight += 1

    def _exit_request(self) -> None:
        with self._drain_lock:
            self._inflight -= 1
            if self._inflight <= 0:
                self._drain_zero.notify_all()

    def _wait_inflight_drained(self, deadline_s: float) -> bool:
        """Block until every in-flight request completes, bounded by
        ``deadline_s``. True = drained clean."""
        end = time.monotonic() + deadline_s
        with self._drain_lock:
            while self._inflight > 0:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return False
                self._drain_zero.wait(timeout=remaining)
        return True

    def draining(self) -> bool:
        with self._drain_lock:
            return self._draining

    @contextlib.contextmanager
    def http_scope(self):
        """Context manager the HTTP handler wraps one WHOLE request in
        (parse -> frontend call -> response write): the drain's in-flight
        gate covers the socket write, so a drain cannot let the process
        exit mid-write."""
        self._enter_request()
        try:
            yield
        finally:
            self._exit_request()

    def begin_drain(self, deadline_s: Optional[float] = None, reason: str = "sigterm") -> Dict[str, Any]:
        """Graceful drain: stop taking new work (healthz flips to
        ``draining``), let in-flight AND queued work complete under
        ``deadline_s`` (default ``serving.drain_deadline_s``), spill hot
        sessions to the run dir, close batchers and logs. Idempotent: a
        second call returns the first drain's verdict. ``deadline_exceeded``
        means the process should exit ``exit_codes.DRAIN_DEADLINE``."""
        if deadline_s is None:
            deadline_s = float(self.serving.drain_deadline_s)
        with self._drain_lock:
            already = self._draining
            self._draining = True
        if already:
            self._drain_done.wait(timeout=deadline_s + 30.0)
            with self._drain_lock:
                return dict(self._drain_info)
        t0 = time.monotonic()
        inflight_at_start = self._inflight
        self._event("drain_begin", reason=reason, deadline_s=deadline_s, inflight=inflight_at_start)
        drained = self._wait_inflight_drained(deadline_s)
        spilled = 0
        spill_error = None
        if self.session_store is not None:
            try:
                spilled = self._spill_sessions()
            except Exception as exc:  # noqa: BLE001 — spill is best-effort
                spill_error = f"{type(exc).__name__}: {exc}"
        info: Dict[str, Any] = {
            "ok": drained and spill_error is None,
            "deadline_exceeded": not drained,
            "deadline_s": deadline_s,
            "inflight_at_drain": inflight_at_start,
            "spilled_sessions": spilled,
            "seconds": round(time.monotonic() - t0, 3),
        }
        if spill_error is not None:
            info["spill_error"] = spill_error
        with self._drain_lock:
            self._drain_info = info
        self._drain_done.set()
        self._event("drain_complete", **info)
        # bounded close on the deadline path: a worker parked in a hung
        # dispatch must not also hang the exiting process
        self.close(join_timeout_s=None if drained else 2.0)
        return info

    def _spill_sessions(self) -> int:
        """Spill every live adapted session (all replicas' caches) to the
        run dir, content-addressed + digest-wrapped (serving/sessions.py),
        each with its refinement lineage."""
        count = 0
        ttl_s = float(self.serving.cache_ttl_s)
        feature_shape = self.session_store.feature_shape
        # reverse fingerprint -> tenant map: only a LOADED tenant master can
        # have adapted sessions in any cache, so hosted_fingerprints covers
        # every spillable tenant entry without touching cold checkpoints
        tenant_by_fp: Dict[str, str] = {}
        if self.engine.registry is not None:
            tenant_by_fp = {fp: t for t, fp in self.engine.registry.hosted_fingerprints().items()}
        for replica in self.pool.replicas:
            for key, tree, age_s in replica.cache.snapshot_entries():
                fingerprint, strategy, digest = key
                tenant = None
                if fingerprint != self.engine.fingerprint:
                    tenant = tenant_by_fp.get(fingerprint)
                    if tenant is None:
                        continue
                if strategy == "protonet":
                    # a prototype table is one forward pass to recompute —
                    # not worth a spill file (and not a parameter tree)
                    continue
                lineage = self._lineage_for(key)
                self.session_store.spill(
                    digest, tree, fingerprint, age_s=age_s, ttl_s=ttl_s, strategy=strategy, tenant=tenant,
                    lineage=encode_lineage(lineage, feature_shape) if lineage is not None else None,
                )
                count += 1
        if count:
            self._event("sessions_spilled", count=count, dir=self.session_store.root)
        return count

    def _rehydrate_sessions(self) -> None:
        """Load spilled sessions (digest-verified, fingerprint-matched,
        TTL-honored — serving/sessions.py) into the replica each key is
        rendezvous-affine to. Anything unsafe is ignored: the fallback is
        the honest 404 + re-adapt, never a stale answer."""
        lineage_raw: Dict[str, Dict[str, Any]] = {}
        template = self.engine.state.params
        registry = self.engine.registry
        entries, stats = self.session_store.load_all(
            fingerprint=self.engine.fingerprint, template=template,
            tenant_fingerprints=_LazyTenantFingerprints(registry) if registry is not None else None,
            lineage_sink=lineage_raw,
        )
        for digest, tree, lived_s, strategy, tenant in entries:
            replica = max(self.pool.replicas, key=lambda r: rendezvous_score(digest, r.index))
            key = self._cache_key(digest, strategy, tenant)
            # back-date by the TTL budget already consumed: a restart must
            # never extend a session's original expiry
            replica.cache.put(key, tree, age_s=lived_s)
            raw = lineage_raw.get(digest)
            if raw is not None:
                lineage = decode_lineage(raw, template, self.session_store.feature_shape)
                if lineage is not None:
                    with self._lineage_lock:
                        self._lineages[key] = lineage
        self._session_stats = dict(stats, rehydrated=stats["loaded"])
        if any(stats.values()):
            self._event("sessions_rehydrated", **stats)
            print(
                "serving sessions: rehydrated "
                f"{stats['loaded']} (stale {stats['stale']}, corrupt "
                f"{stats['corrupt']}, foreign {stats['foreign']})",
                flush=True,
            )

    def _resolve(self, strategy: Optional[str], tenant: Optional[str], ctx):
        """Request strategy and tenant, resolved BEFORE the logged/gated
        section: an unknown strategy or tenant raises ValueError, which the
        HTTP layer maps to 400 (a tenant is unknown without a registry
        naming it)."""
        strategy = validate_request_strategy(strategy, self.engine.strategies)
        tenant = validate_request_tenant(tenant, self.engine.registry)
        ctx = self._request_ctx(ctx)
        if ctx is not None:
            ctx.strategy = strategy
            ctx.tenant = tenant
        return strategy, tenant, ctx

    @staticmethod
    def _group(strategy: str, bucket, tenant: Optional[str]):
        """A dispatch's batcher group key: the strategy and bucket, and for
        a non-default tenant the tenant first — requests of different
        strategies or tenants never share a flush."""
        return (tenant, strategy, bucket) if tenant is not None else (strategy, bucket)

    def adapt(
        self,
        x_support,
        y_support,
        ctx: Optional[RequestContext] = None,
        strategy: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> Dict[str, Any]:
        strategy, tenant, ctx = self._resolve(strategy, tenant, ctx)
        t0 = time.monotonic()
        entered = False
        quota_label = None
        try:
            # drain gate + in-flight accounting: a request that passes here
            # completes (or fails honestly) before a drain lets the process exit
            self._enter_request()
            entered = True
            # per-tenant admission: a tenant over its rate or inflight quota
            # sheds 429 here, before any queue or dispatch
            quota_label = self._acquire_quota(tenant)
            # the request's flow starts here; the batcher flush steps it and
            # the engine dispatch finishes it
            with self.hub.span("serve.adapt", flows=flow_start(ctx), trace=ctx.trace_id if ctx else None):
                x, y = self.engine._flatten_support(x_support, y_support)
                digest = support_digest(x, y, self.engine.num_steps, strategy, tenant=tenant)
                key = self._cache_key(digest, strategy, tenant)
                # affinity on the cache key: this session's fast weights
                # live (or will live) on exactly this replica's cache
                replica = self.router.route(digest, ctx=ctx)
                cached = replica.cache.get(key, ctx=ctx) is not None
                if cached and self._quarantined(key):
                    # the one exit from quarantine: an explicit re-adapt from
                    # the masters; the poisoned entry is recomputed below and
                    # its lineage discarded
                    cached = False
                    if ctx is not None:
                        ctx.cache_hit = False
                    self._pop_lineage(key)
                    self.counters.inc("session_readapts")
                    self._event("session_readapted", session=digest, strategy=strategy)
                if not cached:
                    # shed at the router BEFORE the request queues at the
                    # replica (a cache hit costs nothing)
                    self.router.admit(replica)
                    self._check_resident_quota(tenant, key[0])
                    bucket = self.engine.support_bucket(x.shape[0])
                    if ctx is not None:
                        ctx.bucket = bucket
                        ctx.true_size = int(x.shape[0])
                    fast_weights = replica.dispatch(
                        replica.adapt_batcher, self._group(strategy, bucket, tenant), (x, y), ctx
                    )
                    self._note_padding("adapt", x.shape[0], bucket, strategy)
                    replica.cache.put(key, fast_weights)
                    # a fresh adapt is version zero: no earlier lineage of
                    # this key guards the new weights
                    self._pop_lineage(key)
                    if tenant is not None:
                        self._sweep_pagers()
        except BaseException as exc:
            outcome, status = self._failure_of(exc)
            self._count_strategy(strategy, "adapt", outcome)
            self._count_tenant(tenant, "adapt", outcome)
            self._record_access(ctx, "adapt", outcome, status, time.monotonic() - t0)
            raise
        finally:
            if quota_label is not None:
                self.quotas.release(quota_label)
            if entered:
                self._exit_request()
        elapsed = time.monotonic() - t0
        self.latency.record("adapt_cached" if cached else "adapt", elapsed)
        if strategy != self.engine.strategies[0]:
            # non-default strategies get their own latency phase on top of
            # the aggregate
            self.latency.record(f"adapt@{strategy}", elapsed)
        self._count_strategy(strategy, "adapt", "ok")
        self._count_tenant(tenant, "adapt", "ok")
        self._record_access(ctx, "adapt", "ok", 200, elapsed)
        out = {
            "adaptation_id": digest,
            "cached": cached,
            "strategy": strategy,
            "support_size": int(x.shape[0]),
            "latency_ms": round(elapsed * 1e3, 3),
        }
        if tenant is not None:
            out["tenant"] = tenant
        if ctx is not None:
            out["trace_id"] = ctx.trace_id
            out["timing"] = ctx.timing_ms(elapsed)
        return out

    def _probe_score(self, replica, fast_weights, x_probe, y_probe, strategy, tenant, ctx) -> float:
        """Held-out cross-entropy of ``fast_weights`` on the session's
        probe — the refinement guard's yardstick, scored through the
        ordinary predict batcher. Non-finite weights score non-finite:
        numpy propagates NaN, so a poisoned tree never looks like a pass."""
        bucket = self.engine.query_bucket(x_probe.shape[0])
        probs = replica.dispatch(
            replica.predict_batcher, self._group(strategy, bucket, tenant), (fast_weights, x_probe), ctx
        )
        p = np.asarray(probs, np.float64)
        idx = np.asarray(y_probe, np.int64)
        picked = p[np.arange(idx.shape[0]), idx]
        return float(np.mean(-np.log(np.maximum(picked, 1e-12))))

    def _carve_probe(self, lineage, x, y):
        """-> the (x, y) a refine trains on. The first refine carves the
        session's persistent held-out probe from its support set at evenly
        spaced indices (support sets arrive class-major: a contiguous tail
        would hold out a whole class); later refines train on their full
        support set against the same probe."""
        with self._lineage_lock:
            if lineage.probe is not None:
                return x, y
            n = int(x.shape[0])
            if n < 2:
                raise ValueError("refinement needs >= 2 support samples (one must be held out for the guard)")
            n_hold = min(max(1, int(round(n * float(self.serving.refine_holdout_frac)))), n - 1)
            stride = max(1, n // n_hold)
            hold = np.zeros(n, bool)
            hold[np.arange(n)[stride - 1::stride][:n_hold]] = True
            lineage.probe = (np.asarray(x[hold]), np.asarray(y[hold]))
            return x[~hold], y[~hold]

    def refine(
        self,
        session_id: str,
        x_support,
        y_support,
        ctx: Optional[RequestContext] = None,
        strategy: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Guarded online refinement of a persistent session: continue the
        K-step rollout from the session's CACHED fast weights
        (``engine.refine_batch``), then score the candidate on the session's
        held-out probe before committing. A non-finite or regressed (past
        ``serving.refine_regress_tol``) candidate is discarded — the cache
        keeps the last-good version, the response says ``rolled_back:
        true`` — and ``serving.refine_quarantine_after`` consecutive
        regressions quarantine the session (409 + Retry-After; the only
        exit is an explicit re-adapt). ProtoNet sessions recompute their
        prototypes through the adapt batcher, under the same guard."""
        if not self.serving.refine_enabled:
            # -> the HTTP 400 branch: refinement must be configured on
            raise ValueError("refinement is disabled (serving.refine_enabled=false)")
        strategy, tenant, ctx = self._resolve(strategy, tenant, ctx)
        t0 = time.monotonic()
        entered = False
        quota_label = None
        rolled_back = False
        score: Optional[float] = None
        try:
            self._enter_request()
            entered = True
            quota_label = self._acquire_quota(tenant)
            with self.hub.span("serve.refine", flows=flow_start(ctx), trace=ctx.trace_id if ctx else None):
                key = self._cache_key(session_id, strategy, tenant)
                # same affinity key as the adapt that cached the session
                replica = self.router.route(session_id, ctx=ctx)
                fast_weights = replica.cache.get(key, ctx=ctx)
                if fast_weights is None:
                    raise UnknownAdaptationError(
                        f"unknown or expired session {session_id!r} for strategy {strategy!r}; "
                        "re-send the support set via /adapt"
                    )
                lineage = self._lineage_for(key, create=True)
                if lineage.quarantined:
                    raise SessionQuarantinedError(
                        f"session {session_id!r} is quarantined after "
                        f"{lineage.consecutive_regressions} consecutive regressed refinements; "
                        "re-adapt from the masters via /adapt",
                        retry_after_s=self.resilience.shed_retry_after_s,
                    )
                self.router.admit(replica)
                x, y = self.engine._flatten_support(x_support, y_support)
                x_train, y_train = self._carve_probe(lineage, x, y)
                probe_x, probe_y = lineage.probe
                if lineage.last_good_score is None:
                    # baseline: what the CURRENT weights score — the first
                    # guard comparison needs a last-good to regress against
                    base = self._probe_score(replica, fast_weights, probe_x, probe_y, strategy, tenant, ctx)
                    if np.isfinite(base):
                        with self._lineage_lock:
                            lineage.set_baseline(base)
                bucket = self.engine.support_bucket(x_train.shape[0])
                if ctx is not None:
                    ctx.bucket = bucket
                    ctx.true_size = int(x_train.shape[0])
                group = self._group(strategy, bucket, tenant)
                if strategy == "protonet":
                    refined = replica.dispatch(replica.adapt_batcher, group, (x_train, y_train), ctx)
                else:
                    refined = replica.dispatch(replica.refine_batcher, group, (fast_weights, x_train, y_train), ctx)
                self._note_padding("refine", x_train.shape[0], bucket, strategy)
                score = self._probe_score(replica, refined, probe_x, probe_y, strategy, tenant, ctx)
                tol = float(self.serving.refine_regress_tol)
                last_good = lineage.last_good_score
                regressed = (not np.isfinite(score)) or (last_good is not None and score > last_good + tol)
                if regressed:
                    with self._lineage_lock:
                        streak = lineage.reject()
                    rolled_back = True
                    self.counters.inc("refine_rollbacks")
                    self._event(
                        "refine_rollback", session=session_id, strategy=strategy,
                        score=float(score) if np.isfinite(score) else None, last_good=last_good, streak=streak,
                        **({"tenant": tenant} if tenant else {}),
                    )
                    if streak >= int(self.serving.refine_quarantine_after):
                        with self._lineage_lock:
                            lineage.quarantined = True
                        self.counters.inc("session_quarantines")
                        self._event("session_quarantined", session=session_id, strategy=strategy, streak=streak)
                        raise SessionQuarantinedError(
                            f"session {session_id!r} quarantined after {streak} consecutive regressed "
                            "refinements; re-adapt from the masters via /adapt",
                            retry_after_s=self.resilience.shed_retry_after_s,
                        )
                else:
                    with self._lineage_lock:
                        lineage.commit(fast_weights, score)
                    replica.cache.put(key, refined)
                    self.counters.inc("refines")
                    self._event(
                        "refine_commit", session=session_id, strategy=strategy, score=float(score),
                        refine_count=lineage.refine_count, **({"tenant": tenant} if tenant else {}),
                    )
                if tenant is not None:
                    self._sweep_pagers()
        except BaseException as exc:
            outcome, status = self._failure_of(exc)
            self._count_strategy(strategy, "refine", outcome)
            self._count_tenant(tenant, "refine", outcome)
            self._record_access(ctx, "refine", outcome, status, time.monotonic() - t0)
            raise
        finally:
            if quota_label is not None:
                self.quotas.release(quota_label)
            if entered:
                self._exit_request()
        elapsed = time.monotonic() - t0
        self.latency.record("refine", elapsed)
        if strategy != self.engine.strategies[0]:
            self.latency.record(f"refine@{strategy}", elapsed)
        self._count_strategy(strategy, "refine", "ok")
        self._count_tenant(tenant, "refine", "ok")
        self._record_access(ctx, "refine", "ok", 200, elapsed)
        out = {
            "adaptation_id": session_id,
            "refined": True,
            # a rolled-back refinement is still a 200 (the session is
            # servable, at its last-good version) but says so
            "rolled_back": rolled_back,
            "refine_count": lineage.refine_count,
            "consecutive_regressions": lineage.consecutive_regressions,
            "score": float(score) if score is not None and np.isfinite(score) else None,
            "strategy": strategy,
            "support_size": int(x_train.shape[0]),
            "latency_ms": round(elapsed * 1e3, 3),
        }
        if tenant is not None:
            out["tenant"] = tenant
        if ctx is not None:
            out["trace_id"] = ctx.trace_id
            out["timing"] = ctx.timing_ms(elapsed)
        return out

    def predict(
        self,
        adaptation_id: str,
        x_query,
        ctx: Optional[RequestContext] = None,
        strategy: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> np.ndarray:
        strategy, tenant, ctx = self._resolve(strategy, tenant, ctx)
        t0 = time.monotonic()
        entered = False
        quota_label = None
        try:
            self._enter_request()
            entered = True
            quota_label = self._acquire_quota(tenant)
            with self.hub.span("serve.predict", flows=flow_start(ctx), trace=ctx.trace_id if ctx else None):
                # same affinity key as the adapt that cached these weights
                # (the adaptation id IS the support digest). A predict naming
                # the wrong strategy — or the wrong tenant (the key carries
                # the tenant's checkpoint fingerprint) — for its id misses
                # the key the honest way.
                replica = self.router.route(adaptation_id, ctx=ctx)
                key = self._cache_key(adaptation_id, strategy, tenant)
                fast_weights = replica.cache.get(key, ctx=ctx)
                if fast_weights is None:
                    raise UnknownAdaptationError(
                        f"unknown or expired adaptation_id {adaptation_id!r} for strategy {strategy!r}; "
                        "re-send the support set via /adapt"
                    )
                if self._quarantined(key):
                    raise SessionQuarantinedError(
                        f"session {adaptation_id!r} is quarantined after consecutive regressed "
                        "refinements; re-adapt from the masters via /adapt",
                        retry_after_s=self.resilience.shed_retry_after_s,
                    )
                self.router.admit(replica)
                x = np.asarray(x_query, np.float32)
                bucket = self.engine.query_bucket(x.shape[0])
                if ctx is not None:
                    ctx.bucket = bucket
                    ctx.true_size = int(x.shape[0])
                probs = replica.dispatch(
                    replica.predict_batcher, self._group(strategy, bucket, tenant), (fast_weights, x), ctx
                )
                self._note_padding("predict", x.shape[0], bucket, strategy)
                if tenant is not None:
                    self._sweep_pagers()
        except BaseException as exc:
            outcome, status = self._failure_of(exc)
            self._count_strategy(strategy, "predict", outcome)
            self._count_tenant(tenant, "predict", outcome)
            self._record_access(ctx, "predict", outcome, status, time.monotonic() - t0)
            raise
        finally:
            if quota_label is not None:
                self.quotas.release(quota_label)
            if entered:
                self._exit_request()
        elapsed = time.monotonic() - t0
        self.latency.record("predict", elapsed)
        if strategy != self.engine.strategies[0]:
            self.latency.record(f"predict@{strategy}", elapsed)
        self._count_strategy(strategy, "predict", "ok")
        self._count_tenant(tenant, "predict", "ok")
        self._record_access(ctx, "predict", "ok", 200, elapsed)
        return probs

    def adapt_predict(
        self,
        x_support,
        y_support,
        x_query,
        ctx: Optional[RequestContext] = None,
        strategy: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> Dict[str, Any]:
        # one client call, two hops: both access-log lines share the trace id
        ctx = self._request_ctx(ctx)
        t0 = time.monotonic()
        info = self.adapt(x_support, y_support, ctx=ctx, strategy=strategy, tenant=tenant)
        if ctx is not None:
            ctx.access_logged = False  # the predict hop logs its own line
        probs = self.predict(info["adaptation_id"], x_query, ctx=ctx, strategy=strategy, tenant=tenant)
        if ctx is not None:
            # the response describes the WHOLE request (queue/dispatch from
            # the predict hop — the adapt hop's detail is its access line)
            info["timing"] = ctx.timing_ms(time.monotonic() - t0)
        return {**info, "probs": probs}

    # ------------------------------------------------------------------

    def healthz(self) -> Dict[str, Any]:
        # degraded = serving, but with a replica dead or its breaker open or
        # half-open; the HTTP layer answers 503 only while no replica is
        # routable or the server drains
        solo = len(self.pool) == 1
        degraded = []
        for replica in self.pool.replicas:
            tag = "" if solo else f":r{replica.index}"
            if not replica.alive:
                degraded.append(f"replica_dead{tag}")
            elif replica.breaker.state != "closed":
                degraded.append(f"breaker_{replica.breaker.state}{tag}")
        routable = sum(1 for r in self.pool.replicas if r.routable())
        prewarm = self.prewarm_status()
        # exactly one of four statuses: "ok" (route), "degraded" (route
        # unless routable == 0), "warming" (alive, hold NEW traffic until
        # the prewarm lands), "draining" (finishing in-flight work; takes
        # precedence over everything)
        if self.draining():
            status = "draining"
        elif prewarm["status"] == "warming":
            status = "warming"
        else:
            status = "degraded" if degraded else "ok"
        return {
            "status": status,
            "degraded": degraded,
            "replicas": len(self.pool),
            "routable": routable,
            "prewarm": prewarm,
            "breaker": self.breaker.snapshot(),
            # the engine's torch device type ("cuda" on the card)
            "platform": self.engine.device.type,
            "checkpoint_fingerprint": self.engine.fingerprint,
            "model": self.engine.system.model.name,
            "num_classes": self.engine.num_classes,
            "adapt_steps": self.engine.num_steps,
            "uptime_s": round(time.monotonic() - self._started, 1),
        }

    def metrics(self) -> Dict[str, Any]:
        out = {
            "prewarm": self.prewarm_status(),
            "latency": self.latency.summary(),
            # fleet aggregates under the single-replica keys (counts summed,
            # rates recomputed); the per-replica story is "replicas"
            "cache": self.pool.cache_stats(),
            "adapt_batcher": self.pool.batcher_stats("adapt"),
            "predict_batcher": self.pool.batcher_stats("predict"),
            "compiled": self.engine.compile_counts(),
            "router": self.router.stats(),
            "replicas": self.pool.stats(),
            "padding": self.padding_stats(),
            "strategies": self.strategy_stats(),
            "resilience": {
                **self.counters.snapshot(),
                "breaker": self.breaker.snapshot(),
                "injected_faults": self.engine.injector.stats(),
            },
            "uptime_s": round(time.monotonic() - self._started, 1),
        }
        if self.engine.registry is not None:
            # the multi-tenant surface: registry, pager, quotas and the
            # per-tenant tallies under one block
            tenants_block: Dict[str, Any] = {
                "registry": self.engine.registry.stats(),
                "by_tenant": self.tenant_stats(),
            }
            pager = self.pool.pager_stats()
            if pager is not None:
                tenants_block["pager"] = pager
            if self.quotas is not None and self.quotas.enabled:
                tenants_block["quotas"] = self.quotas.stats()
            out["tenants"] = tenants_block
        with self._drain_lock:
            out["drain"] = {"draining": self._draining, "inflight": self._inflight, **self._drain_info}
        if self.session_store is not None:
            out["sessions"] = {**self._session_stats, "pending_on_disk": self.session_store.pending()}
        if self.serving.refine_enabled:
            # the refinement guard's scoreboard (only with the feature on)
            events = self.counters.snapshot()
            with self._lineage_lock:
                lineages = list(self._lineages.values())
            out.setdefault("sessions", {})["refine"] = {
                "refines": events.get("refines", 0),
                "rollbacks": events.get("refine_rollbacks", 0),
                "quarantines": events.get("session_quarantines", 0),
                "readapts": events.get("session_readapts", 0),
                "active_lineages": len(lineages),
                "quarantined": sum(1 for lin in lineages if lin.quarantined),
                "snapshot_bytes": sum(lin.snapshot_bytes() for lin in lineages),
            }
            out["refine_batcher"] = self.pool.batcher_stats("refine")
        if self.access_log is not None:
            out["access_log"] = self.access_log.stats()
        if self._memory is not None:
            # the device memory watermarks on the scrape surface too, not
            # only inside hub snapshots
            out["memory"] = self._memory.snapshot()
        return out

    def metrics_prometheus(self) -> str:
        """The ``/metrics?format=prom`` body: OpenMetrics text over the one
        registry that backs every serving number."""
        return prometheus_text(self.hub.registry)

    def close(self, join_timeout_s: float = None) -> None:
        if self._closed:
            return
        self._closed = True
        for wd in self._watchdogs:
            wd.stop()
        self.pool.close(join_timeout_s)
        if self._graftsan is not None:
            # thread-leak audit: workers and watchdogs this frontend spawned
            # must all be joined by now (reported as thread_leak events)
            self._graftsan.audit_thread_leaks("ServingFrontend.close", baseline=self._graftsan_thread_baseline)
        if self.access_log is not None:
            self.access_log.close()
        if self.events is not None:
            self.events.close()


def frontend_from_run_dir(
    run_dir: str,
    checkpoint_idx="best",
    cfg: Optional[Config] = None,
    replicas: Optional[int] = None,
    device=None,
) -> ServingFrontend:
    """A frontend over a run directory (``AdaptationEngine.from_run_dir``);
    it owns the run's ``logs/`` (access.jsonl, events.jsonl). ``device``
    defaults to the card."""
    engine = AdaptationEngine.from_run_dir(run_dir, checkpoint_idx, cfg=cfg, device=device)
    return ServingFrontend(engine, access_log_dir=os.path.join(run_dir, "logs"), replicas=replicas)


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------


def _retry_after(exc) -> Dict[str, str]:
    # Retry-After is integer seconds (RFC 9110); round up so a sub-second
    # hint doesn't become an immediate retry storm
    return {"Retry-After": str(max(1, int(round(exc.retry_after_s))))}


class _Handler(BaseHTTPRequestHandler):
    # the frontend is attached to the server instance by make_http_server
    protocol_version = "HTTP/1.1"
    # per-request context/clock, reset by _begin_request at the top of every
    # handler (one instance serves a keep-alive connection sequentially)
    _ctx: Optional[RequestContext] = None
    _t0: float = 0.0

    def _send_json(self, code: int, payload: Dict[str, Any], headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self._ctx is not None:
            # every response names its request: the handle joining the
            # wire, access.jsonl and the exported trace flows
            self.send_header("X-Request-Id", self._ctx.trace_id)
            self.send_header("traceparent", format_traceparent(self._ctx))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, body: str, content_type: str) -> None:
        raw = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        if self._ctx is not None:
            self.send_header("X-Request-Id", self._ctx.trace_id)
        self.end_headers()
        self.wfile.write(raw)

    def _read_json(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0:
            return {}
        return json.loads(self.rfile.read(length))

    def _begin_request(self, frontend: "ServingFrontend"):
        """Adopt/mint the request context (W3C ``traceparent``) and start
        the per-request clock. None when observability is off."""
        self._t0 = time.monotonic()
        self._ctx = parse_traceparent(self.headers.get("traceparent")) if frontend.hub.enabled else None
        return self._ctx

    def _log_http(self, frontend, outcome: str, status: int) -> None:
        """Access-log a terminal HTTP outcome the frontend methods never saw."""
        frontend.log_http_access(self._ctx, self.path, outcome, status, time.monotonic() - self._t0)

    def log_message(self, fmt, *args):
        # quiet: the structured access log carries what these lines would
        pass

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        frontend: ServingFrontend = self.server.frontend  # type: ignore[attr-defined]
        self._begin_request(frontend)
        try:
            split = urllib.parse.urlsplit(self.path)
            query = urllib.parse.parse_qs(split.query)
            if split.path == "/healthz":
                health = frontend.healthz()
                # 503 while NO replica is routable, while the prewarm is
                # still running (body status "warming") or while draining;
                # a partially degraded fleet answers 200, the body naming
                # what is down
                code = (
                    HTTP_UNAVAILABLE
                    if health["routable"] == 0 or health["status"] in ("warming", "draining")
                    else 200
                )
                if code != 200:
                    self._log_http(frontend, health["status"], code)
                self._send_json(code, health)
            elif split.path == "/metrics":
                if query.get("format") == ["prom"]:
                    self._send_text(200, frontend.metrics_prometheus(), "text/plain; version=0.0.4; charset=utf-8")
                else:
                    self._send_json(200, frontend.metrics())
            else:
                self._log_http(frontend, "not_found", 404)
                self._send_json(404, {"error": f"unknown path {self.path}"})
        except Exception as exc:  # noqa: BLE001 — keep the server alive
            self._log_http(frontend, "error", 500)
            self._send_json(500, {"error": f"internal error: {exc!r}"})

    def do_POST(self):  # noqa: N802
        frontend: ServingFrontend = self.server.frontend  # type: ignore[attr-defined]
        ctx = self._begin_request(frontend)
        try:
            # the whole request — body parse through RESPONSE WRITE — sits
            # inside the drain gate
            with frontend.http_scope():
                req = self._read_json()
                # fault seam for handler-level drills (raise -> 500, delay),
                # fired AFTER the body is read so an injected 500 on a
                # keep-alive connection leaves no unread body bytes behind
                frontend.engine.injector.fire("serving.http")
                # optional per-request strategy and tenant: absent = the
                # deployment default; an unknown name => ValueError => 400
                strategy = req.get("strategy")
                tenant = req.get("tenant")
                if self.path == "/adapt":
                    if req.get("refine"):
                        # refinement rides /adapt: a truthy "refine" +
                        # "session_id" continues the named session in place
                        out = frontend.refine(
                            req["session_id"], req["x_support"], req["y_support"], ctx=ctx,
                            strategy=strategy, tenant=tenant,
                        )
                    else:
                        out = frontend.adapt(
                            req["x_support"], req["y_support"], ctx=ctx, strategy=strategy, tenant=tenant
                        )
                    self._send_json(200, out)
                elif self.path == "/predict":
                    probs = frontend.predict(
                        req["adaptation_id"], req["x_query"], ctx=ctx, strategy=strategy, tenant=tenant
                    )
                    body = {"probs": probs.tolist()}
                    if ctx is not None:
                        body["trace_id"] = ctx.trace_id
                        body["timing"] = ctx.timing_ms(time.monotonic() - self._t0)
                    self._send_json(200, body)
                elif self.path == "/adapt_predict":
                    out = frontend.adapt_predict(
                        req["x_support"], req["y_support"], req["x_query"], ctx=ctx, strategy=strategy, tenant=tenant
                    )
                    out["probs"] = out["probs"].tolist()
                    self._send_json(200, out)
                else:
                    self._log_http(frontend, "not_found", 404)
                    self._send_json(404, {"error": f"unknown path {self.path}"})
        except SessionQuarantinedError as exc:
            # the refinement guard's quarantine: 409 + Retry-After
            self._send_json(
                exc.status, {"error": str(exc), "retry_after_s": exc.retry_after_s, "quarantined": True},
                headers=_retry_after(exc),
            )
        except ServiceUnavailableError as exc:
            # load shed / breaker open / draining (503) or router admission
            # (429): tell the client when to come back
            self._send_json(exc.status, {"error": str(exc), "retry_after_s": exc.retry_after_s},
                            headers=_retry_after(exc))
        except DeadlineExceededError as exc:
            self._send_json(HTTP_DEADLINE, {"error": str(exc)})
        except UnknownAdaptationError as exc:
            self._send_json(404, {"error": str(exc)})
        except (KeyError, ValueError, TypeError) as exc:
            self._log_http(frontend, "bad_request", 400)
            self._send_json(400, {"error": f"bad request: {exc!r}"})
        except Exception as exc:  # noqa: BLE001 — keep the server alive
            self._log_http(frontend, "error", 500)
            self._send_json(500, {"error": f"internal error: {exc!r}"})


def make_http_server(frontend: ServingFrontend, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral, for tests) but do not serve; the caller owns
    ``serve_forever`` / ``shutdown``."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.frontend = frontend  # type: ignore[attr-defined]
    server.daemon_threads = True
    return server


def _banner(frontend: ServingFrontend, addr) -> str:
    return (
        f"serving on http://{addr[0]}:{addr[1]} "
        f"(checkpoint {frontend.engine.fingerprint[:12]}, "
        f"platform {frontend.engine.device.type}, "
        f"{len(frontend.pool)} replica(s))"
    )


def serve_forever(frontend: ServingFrontend, host: str, port: int) -> None:
    server = make_http_server(frontend, host, port)
    print(_banner(frontend, server.server_address), flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        frontend.close()


def drain_exit_code(info: Dict[str, Any]) -> int:
    """The process rc for one drain verdict: 0 for a clean drain,
    ``exit_codes.DRAIN_DEADLINE`` when in-flight work outlived the deadline."""
    return DRAIN_DEADLINE if info.get("deadline_exceeded") else OK


def run_server(
    frontend: ServingFrontend,
    host: str,
    port: int,
    install_signal_handlers: bool = True,
    on_bound=None,
) -> int:
    """Serve until SIGTERM/SIGINT, then drain gracefully and return the
    process rc (``drain_exit_code``): the signal flips /healthz to
    ``draining``, in-flight + queued requests complete under
    ``serving.drain_deadline_s``, hot sessions spill to the run dir, logs
    close, and a clean drain exits 0. ``on_bound(host, port)`` fires after
    bind."""
    server = make_http_server(frontend, host, port)
    addr = server.server_address
    rc_box = {"rc": OK}

    def _drain_and_stop(reason: str) -> None:
        info = frontend.begin_drain(reason=reason)
        rc_box["rc"] = drain_exit_code(info)
        print(
            f"serving drain: {'clean' if info.get('ok') else 'DEADLINE EXCEEDED'} "
            f"in {info.get('seconds')}s "
            f"({info.get('spilled_sessions', 0)} session(s) spilled)",
            flush=True,
        )
        server.shutdown()

    def _on_signal(signum, frame):  # noqa: ARG001 — signal contract
        name = signal.Signals(signum).name.lower()
        # the handler returns at once; the drain runs on its own thread
        # while serve_forever keeps answering in-flight work
        threading.Thread(target=_drain_and_stop, args=(name,), name="serving-drain", daemon=True).start()

    if install_signal_handlers:
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
    print(_banner(frontend, addr), flush=True)
    if on_bound is not None:
        on_bound(addr[0], addr[1])
    try:
        server.serve_forever()
    finally:
        server.server_close()
        frontend.close()
    return rc_box["rc"]
