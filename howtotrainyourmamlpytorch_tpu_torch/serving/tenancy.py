"""Tenant weight paging + quotas: many masters under one device budget
(JAX package ``serving/tenancy.py``).

The registry (``serving/registry.py``) holds tenant master states in pinned
host RAM; the :class:`WeightPager` here pages them onto the serving card on
demand under a byte budget, with LRU eviction of cold tenants back to host.
Master state is immutable, so device->host is free — eviction is just
dropping the pager's reference to the device copy; the host master stays
warm and the next request costs one host->device copy. A flush that still
holds an evicted tenant's tensors keeps them alive, and the caching
allocator hands a freed block to a new allocation only in stream order, so
eviction never races a kernel reading the master.

Two eviction signals compose:

- the **byte budget** (``serving.tenant_budget_bytes``): after a page-in,
  evict LRU tenants until resident bytes fit (the default tenant's state is
  the engine's own — pinned, never paged, never counted);
- the **device-memory watermark** (``serving.tenant_min_headroom_frac``,
  ``observability/memory.py::MemoryWatermarks``): when the tightest
  per-device headroom fraction drops below the floor, evict LRU tenants —
  real memory pressure preempts the static budget.

:class:`TenantQuotas` enforces per-tenant max-inflight, request-rate
(token bucket with an honest computed ``Retry-After``), and
max-resident-adapted-bytes; breaches raise :class:`QuotaExceededError`,
which the frontend maps onto the shed contract (HTTP 429 +
``Retry-After``).
"""

import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..config import DEFAULT_TENANT
from ..core.train_state import TrainState
from ..utils.locks import san_lock
from ..utils.trees import tree_map
from .cache import tree_bytes

#: the page-in samples kept for the percentiles
_PAGE_IN_SAMPLES = 256


def normalize_tenant(tenant: Optional[str]) -> Optional[str]:
    """Request tenant -> internal identity. Absent, empty, and the explicit
    default all collapse to ``None``, so a client naming ``"default"`` gets
    byte-identical digests/ids to one omitting the field entirely."""
    if tenant is None:
        return None
    if not isinstance(tenant, str):
        raise ValueError(f"tenant must be a string, got {type(tenant).__name__}")
    tenant = tenant.strip()
    if tenant in ("", DEFAULT_TENANT):
        return None
    return tenant


def validate_request_tenant(tenant: Optional[str], registry) -> Optional[str]:
    """Normalize + admit a request's tenant. A non-default tenant needs a
    registry naming it; unknown tenants are a client error (HTTP 400), not
    a silent fall-through to someone else's weights."""
    tenant = normalize_tenant(tenant)
    if tenant is None:
        return None
    if registry is None:
        raise ValueError(
            f"request names tenant {tenant!r} but no tenant registry is "
            "configured (serving.tenant_registry)"
        )
    if tenant not in registry:
        raise ValueError(
            f"unknown tenant {tenant!r}; registered: {list(registry.tenants())}"
        )
    return tenant


class QuotaExceededError(Exception):
    """A per-tenant quota breach. ``retry_after_s`` is honest: for rate
    breaches it is the token-bucket refill time, for inflight/byte breaches
    a short constant (the resource frees on request completion /
    TTL-eviction, not on a schedule)."""

    def __init__(self, tenant: str, reason: str, retry_after_s: float):
        super().__init__(f"tenant {tenant!r} over {reason} quota")
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


def master_bytes(state: TrainState) -> int:
    """Bytes a master occupies on the card: its params, BN state and inner
    hyperparameters (the step counter stays on the host)."""
    return tree_bytes(state.params) + tree_bytes(state.bn_state) + tree_bytes(state.inner_hparams)


def page_to(state: TrainState, device) -> TrainState:
    """``state``'s served trees copied to ``device`` on its current stream
    (asynchronous from pinned host memory; the caller synchronizes)."""
    move = lambda t: t.to(device, non_blocking=True)  # noqa: E731
    return state._replace(
        params=tree_map(move, state.params),
        bn_state=tree_map(move, state.bn_state),
        inner_hparams=tree_map(move, state.inner_hparams),
        opt_state=None,
    )


class WeightPager:
    """LRU pager of tenant master states between host RAM and the card.

    ``template`` is the engine's own (default-tenant) state — resident on
    the card, never counted against the budget. ``resident(None)`` returns
    it; ``resident(tenant)`` returns the tenant's device-resident state,
    paging it in from the registry's host master on a miss. ``watermarks``
    is attachable after construction (the frontend owns the provider)."""

    def __init__(
        self,
        registry,
        template: Any,
        device=None,
        budget_bytes: int = 0,
        min_headroom_frac: float = 0.0,
        watermarks=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.registry = registry
        self.template = template
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.budget_bytes = int(budget_bytes)
        self.min_headroom_frac = float(min_headroom_frac)
        self.watermarks = watermarks
        self._clock = clock
        self._lock = san_lock("WeightPager._lock")
        # tenant -> (device state, nbytes); OrderedDict order = LRU order
        self._resident: "OrderedDict[str, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self.page_ins = 0
        self.evictions = 0
        self._page_in_ms: List[float] = []
        # page-in / eviction records awaiting the frontend's drain — the
        # pager runs on the dispatch path and has no event sink of its own
        self._pending_events: List[Dict[str, Any]] = []

    # -- residency -------------------------------------------------------

    def resident(self, tenant: Optional[str]) -> Any:
        """The device-resident master state for ``tenant`` (None = the
        engine's own). Pages in on a miss; evicts LRU tenants while over
        the byte budget."""
        if tenant is None:
            return self.template
        with self._lock:
            entry = self._resident.get(tenant)
            if entry is not None:
                self._resident.move_to_end(tenant)
                return entry[0]
        # miss: load the host master OUTSIDE the pager lock — host_state
        # takes the registry lock (an earlier tier in the lock order, so
        # holding ours across it would invert it) and may read a checkpoint
        # from disk, which would park every concurrent page-in behind I/O
        host_state, _ = self.registry.host_state(tenant)
        with self._lock:
            entry = self._resident.get(tenant)
            if entry is not None:
                # raced page-in while we fetched; keep theirs, drop ours
                self._resident.move_to_end(tenant)
                return entry[0]
            t0 = self._clock()
            state = page_to(host_state, self.device)
            if self.device.type == "cuda":
                # settle the copy inside the page-in measurement: the next
                # dispatch must not silently pay it, and the time is the
                # transfer's, not its launch's
                torch.cuda.synchronize(self.device)
            self._page_in_ms.append((self._clock() - t0) * 1e3)
            if len(self._page_in_ms) > _PAGE_IN_SAMPLES:
                del self._page_in_ms[:-_PAGE_IN_SAMPLES]
            nbytes = master_bytes(state)
            self._resident[tenant] = (state, nbytes)
            self._bytes += nbytes
            self.page_ins += 1
            self._pending_events.append({"event": "tenant_paged_in", "tenant": tenant, "bytes": nbytes})
            self._evict_over_budget_locked(keep=tenant)
            return state

    def _evict_over_budget_locked(self, keep: Optional[str] = None) -> None:
        while (
            self.budget_bytes > 0
            and self._bytes > self.budget_bytes
            and len(self._resident) > (1 if keep in self._resident else 0)
        ):
            self._evict_lru_locked(keep=keep, reason="byte_budget")

    def _evict_lru_locked(self, keep: Optional[str] = None, reason: str = "byte_budget") -> Optional[str]:
        for tenant in self._resident:
            if tenant != keep:
                _, nbytes = self._resident.pop(tenant)
                self._bytes -= nbytes
                self.evictions += 1
                self._pending_events.append(
                    {"event": "tenant_evicted", "tenant": tenant, "bytes": nbytes, "reason": reason}
                )
                return tenant
        return None

    def evict(self, tenant: str) -> bool:
        """Drop one tenant's device copy (masters are immutable — the host
        master in the registry stays warm)."""
        with self._lock:
            entry = self._resident.pop(tenant, None)
            if entry is None:
                return False
            self._bytes -= entry[1]
            self.evictions += 1
            self._pending_events.append(
                {"event": "tenant_evicted", "tenant": tenant, "bytes": entry[1], "reason": "explicit"}
            )
            return True

    def drain_events(self) -> List[Dict[str, Any]]:
        """Pending page-in/eviction records, cleared on read — the frontend
        forwards them to events.jsonl so paging is post-hoc auditable."""
        with self._lock:
            out, self._pending_events = self._pending_events, []
            return out

    def check_watermark(self) -> Optional[str]:
        """Evict the LRU tenant when the watermark provider reports the
        tightest per-device headroom below the configured floor. Called by
        the frontend's sweeper; returns the evicted tenant id (or None)."""
        if self.watermarks is None or self.min_headroom_frac <= 0:
            return None
        headroom = self.watermarks.snapshot().get("headroom_frac_min")
        if headroom is None or headroom >= self.min_headroom_frac:
            return None
        with self._lock:
            return self._evict_lru_locked(reason="hbm_watermark")

    # -- introspection ---------------------------------------------------

    def is_resident(self, tenant: str) -> bool:
        with self._lock:
            return tenant in self._resident

    def page_in_ms(self) -> List[float]:
        """The last page-in times (ms, at most 256), oldest first."""
        with self._lock:
            return list(self._page_in_ms)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            samples = sorted(self._page_in_ms)
            return {
                "resident": len(self._resident),
                "resident_tenants": list(self._resident),
                "resident_bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "page_ins": self.page_ins,
                "evictions": self.evictions,
                "page_in_p50_ms": round(samples[len(samples) // 2], 3) if samples else None,
            }


class TenantQuotas:
    """Per-tenant admission quotas riding the shed/429 contract.

    All three quotas are 0-disabled. ``acquire`` runs at admission (after
    the request is known well-formed, before it queues): rate first (token
    bucket, ``retry_after_s`` = time until one token refills), then
    inflight; ``release`` pairs with every successful acquire.
    ``check_resident_bytes`` is separate — the frontend calls it before an
    *adapt* inserts new bytes, against the honest per-fingerprint sum from
    the adapted-weight caches."""

    def __init__(
        self,
        max_inflight: int = 0,
        rate_rps: float = 0.0,
        max_resident_bytes: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_inflight = int(max_inflight)
        self.rate_rps = float(rate_rps)
        self.max_resident_bytes = int(max_resident_bytes)
        # burst capacity = one second of offered rate (>= 1 token), so a
        # well-behaved client at exactly rate_rps never sheds
        self.burst = max(1.0, self.rate_rps)
        self._clock = clock
        self._lock = san_lock("TenantQuotas._lock")
        self._inflight: Dict[str, int] = {}
        # tenant -> (tokens, last refill time)
        self._buckets: Dict[str, Tuple[float, float]] = {}
        self.rejections: Dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return bool(self.max_inflight or self.rate_rps or self.max_resident_bytes)

    def _reject_locked(self, tenant: str, reason: str, retry_after_s: float):
        key = f"{tenant}.{reason}"
        self.rejections[key] = self.rejections.get(key, 0) + 1
        raise QuotaExceededError(tenant, reason, retry_after_s)

    def acquire(self, tenant: str) -> None:
        now = self._clock()
        with self._lock:
            if self.rate_rps > 0:
                tokens, last = self._buckets.get(tenant, (self.burst, now))
                tokens = min(self.burst, tokens + (now - last) * self.rate_rps)
                if tokens < 1.0:
                    self._buckets[tenant] = (tokens, now)
                    self._reject_locked(tenant, "rate", (1.0 - tokens) / self.rate_rps)
                self._buckets[tenant] = (tokens - 1.0, now)
            if self.max_inflight > 0:
                inflight = self._inflight.get(tenant, 0)
                if inflight >= self.max_inflight:
                    self._reject_locked(tenant, "inflight", 1.0)
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1

    def release(self, tenant: str) -> None:
        with self._lock:
            n = self._inflight.get(tenant, 0)
            if n <= 1:
                self._inflight.pop(tenant, None)
            else:
                self._inflight[tenant] = n - 1

    def check_resident_bytes(self, tenant: str, resident_bytes: int) -> None:
        if self.max_resident_bytes > 0 and resident_bytes > self.max_resident_bytes:
            with self._lock:
                self._reject_locked(tenant, "resident_bytes", 5.0)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "max_inflight": self.max_inflight,
                "rate_rps": self.rate_rps,
                "max_resident_bytes": self.max_resident_bytes,
                "inflight": dict(self._inflight),
                "rejections": dict(self.rejections),
            }
