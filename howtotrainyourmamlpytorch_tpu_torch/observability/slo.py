"""Open-loop SLO load harness: seeded schedules, stairs, one-line reports
(the JAX package's ``observability/slo.py``).

"Handles N req/s within SLO" needs three pieces this module owns:

- :func:`generate_schedule` — a **deterministic** open-loop request
  schedule: heavy-tailed (lognormal) inter-arrivals over an offered-load
  staircase, mixed adapt/refine/predict traffic, bucket-skewed query
  sizes. Same
  seed, same arguments => bit-identical schedule (test-pinned), so two load
  tests across a code change offer *exactly* the same traffic.
- :func:`run_load` — drive a live ``ServingFrontend`` (in-process; the HTTP
  layer adds a constant that says nothing about the engine) open-loop:
  requests launch at their scheduled offsets whether or not earlier ones
  returned — the harness never self-throttles onto the backend's rhythm,
  which is exactly the closed-loop mistake that hides queueing collapse.
- :func:`slo_report` — the one-JSON-line verdict: per-stair p50/p99 vs
  offered load, shed rate, 503/504 counts, breaker trips; headline = the
  highest offered load whose stair met the SLO.

Outcome taxonomy matches the frontend's failure modes: ``ok``, ``shed``
(``ServiceUnavailableError`` — queue full or breaker open; HTTP 503),
``deadline`` (``DeadlineExceededError``; HTTP 504), ``error`` (anything
else). CLI: ``python -m howtotrainyourmamlpytorch_tpu_torch.loadgen``.
Schedules are the JAX package's, draw for draw (numpy's generator).
"""

import concurrent.futures
import dataclasses
import inspect
import json
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .context import format_traceparent, new_request_context, read_access_log

from ..utils.locks import san_lock

#: how many worst request ids a failing stair names in the SLO report —
#: enough to grep their flow traces, small enough to stay one JSON line
DEFAULT_WORST_K = 5

#: heavy-tail shape for inter-arrivals: lognormal sigma. 1.0 gives a burst
#: profile where ~10% of gaps are >2.5x the mean — enough to exercise the
#: queue/shed machinery without degenerating into one mega-burst.
DEFAULT_TAIL_SIGMA = 1.0


@dataclasses.dataclass(frozen=True)
class Request:
    """One scheduled request. ``t`` is seconds from test start; ``episode_seed``
    determines the payload (support/query content) deterministically."""

    t: float
    kind: str  # "adapt" | "predict" | "refine"
    episode_seed: int
    n_query: int
    stair: int  # index into the offered-load staircase
    # None = the default tenant (single-tenant schedules stay byte-identical)
    tenant: Optional[str] = None


def generate_schedule(
    seed: int,
    duration_s: float,
    stairs_rps: Sequence[float],
    adapt_frac: float = 0.25,
    query_sizes: Sequence[int] = (5, 15, 40),
    query_weights: Sequence[float] = (0.7, 0.2, 0.1),
    tail_sigma: float = DEFAULT_TAIL_SIGMA,
    tenants: Optional[Sequence[str]] = None,
    tenant_weights: Optional[Sequence[float]] = None,
    refine_frac: float = 0.0,
) -> List[Request]:
    """Deterministic open-loop schedule: ``duration_s`` split evenly across
    ``stairs_rps`` offered-load stages; within a stage, inter-arrivals are
    lognormal with mean ``1/rps`` (heavy-tailed: sigma in log space), kinds
    drawn ``adapt`` with probability ``adapt_frac``, query sizes skewed by
    ``query_weights`` (the bucket-skew knob: most traffic hits the small
    buckets, a tail hits the big ones). With ``tenants``, each request
    additionally draws a tenant id, skewed by ``tenant_weights`` (uniform
    when None); without, no extra RNG draws happen, so pre-tenancy seeds
    keep bit-identical schedules. ``refine_frac`` carves session-refinement
    traffic (kind ``"refine"``: a new support set against an existing
    adaptation id) out of the predict share using the SAME uniform draw
    that picks adapt-vs-predict, so 0.0 keeps pre-refinement seeds
    bit-identical."""
    if not stairs_rps:
        raise ValueError("stairs_rps must name at least one offered load")
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    if refine_frac < 0 or adapt_frac + refine_frac > 1:
        raise ValueError(
            f"refine_frac must satisfy 0 <= refine_frac <= 1 - adapt_frac, "
            f"got refine_frac={refine_frac} adapt_frac={adapt_frac}"
        )
    weights = np.asarray(query_weights, np.float64)
    weights = weights / weights.sum()
    t_weights = None
    if tenants:
        t_weights = (
            np.asarray(tenant_weights, np.float64)
            if tenant_weights is not None
            else np.ones(len(tenants), np.float64)
        )
        if len(t_weights) != len(tenants):
            raise ValueError(
                f"tenant_weights names {len(t_weights)} weights for "
                f"{len(tenants)} tenants"
            )
        t_weights = t_weights / t_weights.sum()
    rng = np.random.default_rng(int(seed))
    per_stair = float(duration_s) / len(stairs_rps)
    schedule: List[Request] = []
    for stair, rps in enumerate(stairs_rps):
        if rps <= 0:
            raise ValueError(f"offered load must be > 0 req/s, got {rps}")
        t = stair * per_stair
        end = (stair + 1) * per_stair
        # lognormal with mean 1/rps: mu = ln(mean) - sigma^2/2
        mu = np.log(1.0 / float(rps)) - tail_sigma**2 / 2.0
        while True:
            t += float(rng.lognormal(mu, tail_sigma))
            if t >= end:
                break
            # ONE uniform draw splits adapt / refine / predict: at
            # refine_frac=0 the second band is empty and the draw count and
            # thresholds are exactly the historical adapt-vs-predict split,
            # so pre-refinement seeds stay bit-identical
            u = rng.random()
            if u < adapt_frac:
                kind = "adapt"
            elif u < adapt_frac + refine_frac:
                kind = "refine"
            else:
                kind = "predict"
            schedule.append(
                Request(
                    t=round(t, 6),
                    kind=kind,
                    episode_seed=int(rng.integers(0, 2**31)),
                    n_query=int(query_sizes[int(rng.choice(len(weights), p=weights))]),
                    stair=stair,
                    tenant=(
                        str(tenants[int(rng.choice(len(t_weights), p=t_weights))])
                        if t_weights is not None
                        else None
                    ),
                )
            )
    return schedule


def schedule_digest(schedule: List[Request]) -> Dict[str, Any]:
    """Compact, JSON-able fingerprint of a schedule (the determinism
    contract surface: two same-seed generators must produce identical
    digests AND identical entry lists)."""
    return {
        "n": len(schedule),
        "kinds": {
            # the refine key only appears on schedules that carry refines:
            # refine-off digests stay byte-identical to pre-refinement ones
            k: sum(1 for r in schedule if r.kind == k)
            for k in ("adapt", "predict")
            + (("refine",) if any(r.kind == "refine" for r in schedule) else ())
        },
        "per_stair": [
            sum(1 for r in schedule if r.stair == s)
            for s in range(max((r.stair for r in schedule), default=-1) + 1)
        ],
        "first_t": schedule[0].t if schedule else None,
        "last_t": schedule[-1].t if schedule else None,
        # only multi-tenant schedules grow the extra key: single-tenant
        # digests stay byte-identical to pre-tenancy ones
        **(
            {
                "per_tenant": {
                    t: sum(1 for r in schedule if r.tenant == t)
                    for t in sorted({r.tenant for r in schedule if r.tenant})
                }
            }
            if any(r.tenant for r in schedule)
            else {}
        ),
    }


class _NullBreaker:
    """Breaker stand-in for external-process targets: the remote breaker's
    trips ride the remote /metrics, not this snapshot."""

    @staticmethod
    def snapshot() -> Dict[str, Any]:
        return {}


class _NullHub:
    enabled = False


class HttpFrontend:
    """The ServingFrontend request API over a live gateway (or single
    backend) URL — what ``loadgen --url`` drives, so the SAME open-loop
    harness measures an external-process fleet.

    Failure mapping mirrors the wire contract in reverse (429/503 ->
    ``ServiceUnavailableError``, 504 -> ``DeadlineExceededError``, 404 ->
    ``UnknownAdaptationError``), so :func:`run_load`'s outcome taxonomy is
    identical in-process and over HTTP. Every response's
    ``X-Gateway-Backend`` header is tallied per outcome — the per-backend
    story of the SLO report (``per_backend``)."""

    def __init__(self, base_url: str, timeout_s: float = 120.0):
        from ..exit_codes import (
            HTTP_DEADLINE,
            HTTP_TOO_MANY_REQUESTS,
            HTTP_UNAVAILABLE,
        )
        from ..resilience.retry import DeadlineExceededError
        from ..serving.errors import ServiceUnavailableError, UnknownAdaptationError

        self._shed_codes = (HTTP_TOO_MANY_REQUESTS, HTTP_UNAVAILABLE)
        self._deadline_code = HTTP_DEADLINE

        self.base = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self._unavailable = ServiceUnavailableError
        self._deadline = DeadlineExceededError
        self._unknown = UnknownAdaptationError
        self._lock = san_lock("HttpFrontend._lock")
        self._by_backend: Dict[str, Dict[str, int]] = {}
        self.breaker = _NullBreaker()
        self.hub = _NullHub()
        self.access_log = None
        self.engine = None  # run_load's prewarm degrades to a logged skip

    def _note(self, backend: Optional[str], outcome: str) -> None:
        with self._lock:
            row = self._by_backend.setdefault(backend or "unknown", {})
            row[outcome] = row.get(outcome, 0) + 1

    def _post(self, path: str, payload: Dict[str, Any], ctx) -> Dict[str, Any]:
        headers = {"Content-Type": "application/json"}
        if ctx is not None:
            # the loadgen-minted trace id rides the wire: gateway + backend
            # adopt it, so one request id greps across every process's logs
            headers["traceparent"] = format_traceparent(ctx)
        req = urllib.request.Request(
            self.base + path, data=json.dumps(payload).encode(), headers=headers
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                self._note(resp.headers.get("X-Gateway-Backend"), "ok")
                return json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            backend = exc.headers.get("X-Gateway-Backend")
            body = exc.read()
            try:
                message = json.loads(body).get("error") or f"HTTP {exc.code}"
            except ValueError:
                message = f"HTTP {exc.code}"
            retry_after = 1.0
            if exc.headers.get("Retry-After"):
                try:
                    retry_after = float(exc.headers["Retry-After"])
                except ValueError:
                    pass
            if exc.code in self._shed_codes:
                self._note(backend, "shed")
                raise self._unavailable(
                    message, retry_after_s=retry_after, status=exc.code
                ) from exc
            if exc.code == self._deadline_code:
                self._note(backend, "deadline")
                raise self._deadline(message) from exc
            if exc.code == 404:
                self._note(backend, "unknown_id")
                raise self._unknown(message) from exc
            self._note(backend, "error")
            raise RuntimeError(f"{path}: {message}") from exc
        except urllib.error.URLError as exc:
            # connection-level failure (target down mid-test): an honest
            # "error" row, never a crash of the harness
            self._note(None, "error")
            raise RuntimeError(f"{path}: {exc.reason}") from exc

    def adapt(self, x_support, y_support, ctx=None, tenant=None) -> Dict[str, Any]:
        payload = {
            "x_support": np.asarray(x_support, np.float32).tolist(),
            "y_support": np.asarray(y_support, np.int32).tolist(),
        }
        if tenant is not None:
            payload["tenant"] = tenant
        return self._post("/adapt", payload, ctx)

    def refine(
        self, session_id: str, x_support, y_support, ctx=None, tenant=None
    ) -> Dict[str, Any]:
        """Guarded in-place refinement of an existing session: POST /adapt
        with ``refine: true`` + ``session_id`` (the wire shape the gateway's
        session affinity keys on). A quarantined session's 409 lands in the
        generic ``error`` outcome bucket — honest load-test failure, never a
        silent retry."""
        payload = {
            "session_id": session_id,
            "refine": True,
            "x_support": np.asarray(x_support, np.float32).tolist(),
            "y_support": np.asarray(y_support, np.int32).tolist(),
        }
        if tenant is not None:
            payload["tenant"] = tenant
        return self._post("/adapt", payload, ctx)

    def predict(self, adaptation_id: str, x_query, ctx=None, tenant=None) -> np.ndarray:
        payload = {
            "adaptation_id": adaptation_id,
            "x_query": np.asarray(x_query, np.float32).tolist(),
        }
        if tenant is not None:
            payload["tenant"] = tenant
        out = self._post("/predict", payload, ctx)
        return np.asarray(out["probs"], np.float32)

    def per_backend(self) -> Dict[str, Dict[str, int]]:
        """Outcome counts per X-Gateway-Backend — the SLO report's
        ``per_backend`` block for external-process targets."""
        with self._lock:
            return {k: dict(v) for k, v in self._by_backend.items()}

    def close(self) -> None:
        pass


class _Results:
    """Thread-safe per-request outcome recorder (worker threads land their
    verdicts here; aggregation happens after the run)."""

    def __init__(self):
        self._lock = san_lock("_Results._lock")
        self._rows: List[Dict[str, Any]] = []

    def add(
        self,
        stair: int,
        kind: str,
        outcome: str,
        latency_ms: float,
        trace_id: Optional[str] = None,
    ) -> None:
        with self._lock:
            self._rows.append(
                {
                    "stair": stair,
                    "kind": kind,
                    "outcome": outcome,
                    "latency_ms": latency_ms,
                    "trace_id": trace_id,
                }
            )

    def rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._rows)


def _warm_batch_buckets(frontend, schedule, make_support, make_query, log) -> None:
    """Dispatch the full (bucket x task-batch bucket) grid the batched
    flushes will hit, before the clock starts, by delegating to
    ``AdaptationEngine.prewarm()``: the same planned-set warm a serving
    replica runs under ``aot.enabled``. Under concurrency the batchers
    dispatch task batches of 2, 4, ... ``max_batch_size`` requests that the
    single-request warmup never ran, and the first dispatch of a shape on
    the card pays cuDNN's algorithm choice and the allocator's first blocks:
    a cold shape inside a measured stair would bill that to its p99.
    Degrades to a logged skip on frontends without a prewarm-capable engine
    (``HttpFrontend``, test doubles): the single-request warmup already
    ran."""
    engine = getattr(frontend, "engine", None)
    prewarm = getattr(engine, "prewarm", None)
    # a fleet frontend warms EVERY replica's engine (pool.prewarm dedups
    # shared-engine replicas); single-replica and engine-only paths keep
    # the direct engine warm
    pool = getattr(frontend, "pool", None)
    if pool is not None and len(pool) > 1 and prewarm is not None:
        prewarm = pool.prewarm
    if engine is None or prewarm is None:
        log("loadgen: batch-bucket warmup skipped (frontend has no engine)")
        return
    try:
        summary = prewarm()
        log(
            f"loadgen: prewarmed {summary['programs']} serving programs in "
            f"{summary['seconds']}s ({summary['cache_hits']} persistent-cache "
            f"hits, {summary['errors']} errors)"
        )
    except Exception as exc:  # noqa: BLE001 — warmup must not kill the test
        log(
            "loadgen: batch-bucket warmup failed (continuing): "
            f"{type(exc).__name__}: {exc}"
        )


def run_load(
    frontend,
    schedule: List[Request],
    make_support: Callable[[int], Any],
    make_query: Callable[[int, int], Any],
    warm_adaptations: int = 2,
    max_workers: int = 16,
    result_grace_s: float = 60.0,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    log: Callable[[str], None] = lambda m: None,
) -> Dict[str, Any]:
    """Drive ``frontend`` through ``schedule`` open-loop and return the raw
    outcome rows + breaker delta.

    ``make_support(episode_seed) -> (x_support, y_support)`` and
    ``make_query(episode_seed, n_query) -> x_query`` build payloads — kept
    injectable so this module never imports the data stack. Warmup
    (``warm_adaptations`` adapt calls + one predict per distinct query size
    in the schedule, compiling every serving program the traffic will hit
    and seeding the adaptation-id pool predict traffic draws from) runs
    before the clock starts and is excluded from every number.

    Latencies are measured from each request's SCHEDULED arrival, not from
    worker pickup: when the backend (or the harness's own ``max_workers``
    in-flight cap) falls behind, the queue wait lands in the measured
    latency instead of being coordinated-omitted — the open-loop point."""
    if not schedule:
        raise ValueError("schedule is empty — lengthen duration_s or raise stairs_rps")
    results = _Results()
    # adaptation-id pools are PER TENANT (None = default): an adaptation id
    # carries its tenant's checkpoint fingerprint, so a predict naming a
    # different tenant's id is an honest 404, never load-test traffic.
    # Entries are (adaptation_id, episode_seed) so refine traffic can
    # re-send the SESSION'S OWN task data (steady-state refinement): a
    # refine carrying some other episode's support is a different task,
    # which the regression guard correctly rolls back — a rollback storm
    # is the fault drill's job, not the load test's.
    ids: Dict[Optional[str], List[tuple]] = {None: []}
    ids_lock = san_lock("slo.run_load.ids_lock")

    # -- warmup: compile + seed the adaptation pool (excluded). One predict
    # per distinct scheduled query size: a cold bucket compile inside a
    # measured stair would bill seconds of XLA time to that stair's p99.
    for i in range(max(warm_adaptations, 1)):
        x_s, y_s = make_support(-(i + 1))
        info = frontend.adapt(x_s, y_s)
        with ids_lock:
            ids[None].append((info["adaptation_id"], -(i + 1)))
    for n_query in sorted({r.n_query for r in schedule}):
        frontend.predict(ids[None][0][0], make_query(-1, n_query))
    # one warm adapt per scheduled tenant: seeds each tenant's id pool so
    # every scheduled predict has a same-tenant adaptation to resolve
    # (pages the tenant in, which is exactly one host->device transfer —
    # page-in thrash mid-test still shows up, the budget decides residency)
    for j, tenant in enumerate(sorted({r.tenant for r in schedule if r.tenant})):
        x_s, y_s = make_support(-1001 - j)
        info = frontend.adapt(x_s, y_s, tenant=tenant)
        with ids_lock:
            ids.setdefault(tenant, []).append((info["adaptation_id"], -1001 - j))
    # one warm refine per tenant the refine traffic names: settles the
    # session's probe carve + baseline probe score before the clock starts
    # (refine-free schedules change NOTHING — no extra warm calls)
    refine_fn = getattr(frontend, "refine", None)
    for tenant in sorted(
        {r.tenant for r in schedule if r.kind == "refine"},
        key=lambda t: (t is not None, t or ""),
    ):
        if refine_fn is None:
            log("loadgen: refine warmup skipped (frontend has no refine)")
            break
        warm_id, warm_seed = ids[tenant][0]
        x_s, y_s = make_support(warm_seed)
        refine_fn(
            warm_id, x_s, y_s, **({"tenant": tenant} if tenant else {})
        )
    _warm_batch_buckets(frontend, schedule, make_support, make_query, log)
    log(
        "loadgen: warm "
        f"({sum(len(v) for v in ids.values())} adaptations cached, "
        f"{len(ids) - 1} tenant(s))"
    )
    breaker_before = frontend.breaker.snapshot()
    opens_before = _breaker_opens_total(frontend, breaker_before)

    from ..resilience.retry import DeadlineExceededError
    from ..serving.errors import ServiceUnavailableError

    # loadgen-minted trace ids: every scheduled request carries its own
    # RequestContext through the frontend, so a failing stair's worst
    # request ids (slo_report) resolve to access-log lines and flow-linked
    # span chains in the exported trace. Doubles without the ctx parameter
    # (older/fake frontends) are driven exactly as before.
    def _takes_ctx(fn) -> bool:
        try:
            return "ctx" in inspect.signature(fn).parameters
        except (TypeError, ValueError):
            return False

    adapt_takes_ctx = _takes_ctx(frontend.adapt)
    predict_takes_ctx = _takes_ctx(frontend.predict)
    refine_takes_ctx = refine_fn is not None and _takes_ctx(refine_fn)

    def one(req: Request, sched_t: float) -> None:
        ctx = new_request_context()
        # the tenant kwarg only appears on multi-tenant requests: doubles
        # without the parameter keep working for single-tenant schedules
        tenant_kw = {"tenant": req.tenant} if req.tenant else {}
        try:
            if req.kind == "adapt":
                x_s, y_s = make_support(req.episode_seed)
                if adapt_takes_ctx:
                    info = frontend.adapt(x_s, y_s, ctx=ctx, **tenant_kw)
                else:
                    info = frontend.adapt(x_s, y_s, **tenant_kw)
                with ids_lock:
                    ids.setdefault(req.tenant, []).append(
                        (info["adaptation_id"], req.episode_seed)
                    )
                outcome = "ok"
            elif req.kind == "refine":
                # refine an existing session (same id-pool draw as predict)
                # with ITS OWN task's support — the steady-state
                # online-refinement workload; a rollback is still an "ok"
                # response (the guard's honest 200), a quarantine 409 lands
                # in "error"
                with ids_lock:
                    pool_ids = ids[req.tenant]
                    sid, sseed = pool_ids[req.episode_seed % len(pool_ids)]
                x_s, y_s = make_support(sseed)
                if refine_takes_ctx:
                    refine_fn(sid, x_s, y_s, ctx=ctx, **tenant_kw)
                else:
                    frontend.refine(sid, x_s, y_s, **tenant_kw)
                outcome = "ok"
            else:
                with ids_lock:
                    pool_ids = ids[req.tenant]
                    aid = pool_ids[req.episode_seed % len(pool_ids)][0]
                query = make_query(req.episode_seed, req.n_query)
                if predict_takes_ctx:
                    frontend.predict(aid, query, ctx=ctx, **tenant_kw)
                else:
                    frontend.predict(aid, query, **tenant_kw)
                outcome = "ok"
        except ServiceUnavailableError:
            outcome = "shed"
        except DeadlineExceededError:
            outcome = "deadline"
        except Exception as exc:  # noqa: BLE001 — the report carries the count
            log(f"loadgen: request error: {type(exc).__name__}: {exc}")
            outcome = "error"
        results.add(
            req.stair,
            req.kind,
            outcome,
            round((clock() - sched_t) * 1e3, 3),
            trace_id=ctx.trace_id,
        )

    # -- open loop: launch at schedule time, never wait for completions --
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=max_workers)
    futures = []
    unresolved_by_stair: Dict[int, int] = {}
    start = clock()
    try:
        for req in schedule:
            delay = req.t - (clock() - start)
            if delay > 0:
                sleep(delay)
            futures.append(pool.submit(one, req, start + req.t))
        # one shared grace window past the end of the schedule: a request a
        # wedged backend never answers (exactly what a load test exists to
        # surface) costs at most the grace and an ``unresolved`` count in
        # the report — never the report itself
        grace_deadline = time.monotonic() + result_grace_s
        for req, fut in zip(schedule, futures):
            try:
                fut.result(timeout=max(0.0, grace_deadline - time.monotonic()))
            except concurrent.futures.TimeoutError:
                unresolved_by_stair[req.stair] = (
                    unresolved_by_stair.get(req.stair, 0) + 1
                )
    finally:
        pool.shutdown(wait=False)
    wall_s = clock() - start
    unresolved = sum(unresolved_by_stair.values())
    if unresolved:
        log(f"loadgen: {unresolved} requests unresolved after {result_grace_s}s grace")
    breaker_after = frontend.breaker.snapshot()
    run: Dict[str, Any] = {
        "rows": results.rows(),
        "unresolved_by_stair": unresolved_by_stair,
        "unresolved": unresolved,
        "wall_s": round(wall_s, 3),
        # fleet-aware: trips summed across every replica's breaker (a pool
        # frontend), falling back to the single breaker on doubles
        "breaker_trips": _breaker_opens_total(frontend, breaker_after)
        - opens_before,
        "breaker": breaker_after,
    }
    pool = getattr(frontend, "pool", None)
    if pool is not None and len(pool) > 1:
        # the per-replica story the fleet headline needs: outcome counts,
        # breaker trips, and cache hit rates per failure domain
        run["replicas"] = pool.stats()
        router = getattr(frontend, "router", None)
        if router is not None:
            run["router"] = router.stats()
    return run


def _breaker_opens_total(frontend, breaker_snapshot: Dict[str, Any]) -> int:
    """Lifetime breaker trips: summed across the pool
    (``EnginePool.breaker_opens``) when the frontend has one, else the lone
    breaker's count (test doubles, ``HttpFrontend``)."""
    pool = getattr(frontend, "pool", None)
    if pool is not None:
        try:
            return int(pool.breaker_opens())
        except Exception:  # noqa: BLE001 — doubles with a stub pool
            pass
    return int(breaker_snapshot.get("opens", 0))


def _percentiles(latencies: List[float]) -> Dict[str, Optional[float]]:
    if not latencies:
        return {"p50_ms": None, "p99_ms": None}
    arr = np.asarray(latencies, np.float64)
    p50, p99 = np.percentile(arr, [50, 99])
    return {"p50_ms": round(float(p50), 3), "p99_ms": round(float(p99), 3)}


def _worst_requests(
    mine: List[Dict[str, Any]],
    worst_k: int,
    access_index: Dict[str, Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """The K worst requests of a stair (by measured latency — deadline
    misses carry deadline+queue, exactly the tail under investigation),
    each joined with its access-log line's per-hop breakdown when one
    landed. A bad p99 becomes one ``grep <trace_id>`` from its flow trace."""
    ranked = sorted(mine, key=lambda r: r["latency_ms"], reverse=True)[:worst_k]
    out = []
    for r in ranked:
        entry = {
            "trace_id": r.get("trace_id"),
            "kind": r["kind"],
            "outcome": r["outcome"],
            "latency_ms": r["latency_ms"],
        }
        access = access_index.get(r.get("trace_id"))
        if access is not None:
            entry.update(
                {
                    k: access.get(k)
                    for k in ("queue_wait_ms", "dispatch_ms", "flush_batch", "bucket")
                }
            )
        out.append(entry)
    return out


def _load_access_index(path: Optional[str]) -> Dict[str, Dict[str, Any]]:
    if not path:
        return {}
    try:
        records, _ = read_access_log(path)
    except OSError:
        return {}
    # last line per id wins (adapt_predict logs two hops; the later hop is
    # the one whose timing closed the request)
    return {r["trace_id"]: r for r in records if r.get("trace_id")}


def slo_report(
    schedule: List[Request],
    run: Dict[str, Any],
    stairs_rps: Sequence[float],
    duration_s: float,
    seed: int,
    slo_p99_ms: float,
    max_shed_rate: float,
    metric_suffix: str = "",
    platform: Optional[str] = None,
    worst_k: int = DEFAULT_WORST_K,
    access_log_path: Optional[str] = None,
    **extra: Any,
) -> Dict[str, Any]:
    """Aggregate raw outcomes into the one-JSON-line SLO report (BENCH-line
    contract: ``metric``/``value``/``unit``/``vs_baseline`` + diagnostics).
    Headline value = the highest offered load (req/s) whose stair met the
    SLO (p99 <= ``slo_p99_ms`` on completed requests AND shed+error rate <=
    ``max_shed_rate``); None when no stair qualified. Every FAILING stair
    names its ``worst_k`` worst request ids (joined with the access log at
    ``access_log_path`` when given) so a bad p99 is one grep from its
    per-request flow trace."""
    rows = run["rows"]
    access_index = _load_access_index(access_log_path)
    unresolved_by_stair = run.get("unresolved_by_stair") or {}
    per_stair_s = float(duration_s) / len(stairs_rps)
    stairs: List[Dict[str, Any]] = []
    sustained: Optional[float] = None
    for idx, rps in enumerate(stairs_rps):
        mine = [r for r in rows if r["stair"] == idx]
        offered = [r for r in schedule if r.stair == idx]
        counts = {
            k: sum(1 for r in mine if r["outcome"] == k)
            for k in ("ok", "shed", "deadline", "error")
        }
        unresolved = int(unresolved_by_stair.get(idx, 0))
        n = len(mine)
        ok_lat = [r["latency_ms"] for r in mine if r["outcome"] == "ok"]
        shed_rate = (counts["shed"] + counts["error"]) / n if n else None
        pcts = _percentiles(ok_lat)
        # an unresolved request outlived the whole grace window — worse
        # than a deadline miss, so it disqualifies the stair outright
        met = (
            n > 0
            and counts["ok"] > 0
            and counts["deadline"] == 0
            and unresolved == 0
            and shed_rate is not None
            and shed_rate <= max_shed_rate
            and pcts["p99_ms"] is not None
            and pcts["p99_ms"] <= slo_p99_ms
        )
        if met and (sustained is None or rps > sustained):
            sustained = float(rps)
        stair_row = {
            "offered_rps": float(rps),
            "achieved_rps": round(counts["ok"] / per_stair_s, 3),
            "n_offered": len(offered),
            **counts,
            "unresolved": unresolved,
            "shed_rate": round(shed_rate, 4) if shed_rate is not None else None,
            **pcts,
            "slo_met": met,
        }
        if not met and mine and worst_k > 0:
            stair_row["worst_requests"] = _worst_requests(
                mine, worst_k, access_index
            )
        stairs.append(stair_row)
    totals = {
        k: sum(s[k] for s in stairs) for k in ("ok", "shed", "deadline", "error")
    }
    n_total = sum(totals.values())
    total_unresolved = sum(s["unresolved"] for s in stairs)
    report = {
        "metric": f"serving_slo_sustained_rps{metric_suffix}",
        "value": sustained,
        "unit": "req/s within SLO",
        "vs_baseline": None,  # no reference serving path to compare against
        "platform": platform,
        "seed": int(seed),
        "duration_s": float(duration_s),
        "slo_p99_ms": float(slo_p99_ms),
        "max_shed_rate": float(max_shed_rate),
        "requests": n_total + total_unresolved,
        **totals,
        "unresolved": total_unresolved,
        "shed_rate": (
            round((totals["shed"] + totals["error"]) / n_total, 4) if n_total else None
        ),
        "breaker_trips": run["breaker_trips"],
        "stairs": stairs,
        "wall_s": run["wall_s"],
    }
    if access_log_path:
        report["access_log"] = {
            "path": access_log_path,
            "lines": len(access_index),
        }
    if "replicas" in run:
        # the fleet headline's supporting cast: per-replica outcome counts,
        # breaker trips, and cache hit rates, plus the router's verdicts
        report["replicas"] = len(run["replicas"])
        report["per_replica"] = [
            {
                "replica": r["replica"],
                "alive": r["alive"],
                "counts": r["counts"],
                "breaker_opens": int(r["breaker"].get("opens", 0)),
                "cache_hit_rate": r["cache"].get("hit_rate"),
                "mean_batch": r["predict_batcher"].get("mean_batch"),
            }
            for r in run["replicas"]
        ]
        report["router"] = run.get("router")
    report.update(extra)
    return report
