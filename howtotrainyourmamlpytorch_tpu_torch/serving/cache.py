"""Content-addressed LRU cache of adapted parameter trees.

The serving workload is adapt-once / predict-many: a client uploads a support
set, the engine runs the inner loop, then answers query requests against the
adapted weights. Repeat clients (same support set, same checkpoint) are the
common case — the cache keys adapted weights by
``(checkpoint fingerprint, support-set digest)`` so they skip the inner loop
entirely. Bounded by a byte budget (LRU eviction) and a TTL; hit / miss /
eviction / expiration counters feed the ``/metrics`` endpoint.

The JAX package's module without jax: trees are dicts of tensors, and
``support_digest`` hashes the same bytes as the JAX package's, so an
adaptation id (the session's cache key, routing key and spill-file name) is
the same in both packages for the same request.
"""

import hashlib
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..utils.locks import san_lock
from ..utils.trees import tree_leaves

# (checkpoint fingerprint, adaptation strategy, support-set digest)
CacheKey = Tuple[str, str, str]


def support_digest(
    x_support, y_support, num_steps: int, strategy: str = "maml++",
    tenant: Optional[str] = None,
) -> str:
    """Content hash of one adapt request: support tensors + shapes + dtypes +
    the inner-step horizon (the same support set adapted for a different
    number of steps is a different cache entry) + the adaptation strategy —
    a ProtoNet prototype table and a MAML fast-weight tree for the same
    support set are different sessions, so their adaptation ids (and with
    them every cache key, session-spill file, and gateway affinity hash)
    never collide. ``tenant`` folds in the same way (serving/tenancy.py):
    the same support set adapted against two tenants' masters is two
    sessions, and the gateway's body-hash affinity separates them for free.
    The default strategy and the default/absent tenant contribute nothing
    to the hash, so every pre-tenancy adaptation id is unchanged."""
    h = hashlib.sha256()
    for arr in (x_support, y_support):
        a = np.ascontiguousarray(arr)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    h.update(str(int(num_steps)).encode())
    if strategy != "maml++":
        h.update(f"strategy:{strategy}".encode())
    if tenant:
        h.update(f"tenant:{tenant}".encode())
    return h.hexdigest()


def tree_bytes(tree: Any) -> int:
    """Bytes of a dict tree's leaves: ``numel() * element_size()`` per
    tensor, ``nbytes`` per numpy array."""
    return sum(
        leaf.numel() * leaf.element_size() if hasattr(leaf, "element_size") else leaf.nbytes
        for leaf in tree_leaves(tree)
    )


class SessionLineage:
    """Versioned session state for guarded update-in-place refinement:
    a cache entry that has been refined is no longer a one-shot
    memo but a VERSION, and this record carries its history — committed
    refinement count, held-out score trail, a bounded ring of previously
    committed fast-weight versions (the rollback targets), the
    consecutive-regression streak, and the quarantine flag. The frontend
    (``serving/server.py::ServingFrontend.refine``) owns the guard POLICY;
    this is the bookkeeping that rides ``SessionStore`` spill/rehydrate so
    lineage survives drains and rolling restarts. Not thread-safe by
    itself — the frontend serializes mutations under its lineage lock."""

    #: held-out score history bound: enough for a trend, never unbounded
    MAX_SCORES = 32

    def __init__(self, snapshot_ring: int = 2):
        self.snapshot_ring = max(1, int(snapshot_ring))
        self.refine_count = 0
        self.rollbacks = 0
        self.consecutive_regressions = 0
        self.quarantined = False
        self.scores: list = []  # committed held-out scores, oldest first
        self.snapshots: list = []  # previous committed trees, oldest first
        # persistent held-out probe (x, y): carved from the FIRST refine's
        # support set, so every later refinement is scored against the same
        # yardstick — scores stay comparable across the session's life
        self.probe = None

    @property
    def last_good_score(self):
        return self.scores[-1] if self.scores else None

    def set_baseline(self, score: float) -> None:
        """Seed the score trail with the PRE-refinement weights' held-out
        score (first refine only): the first guard comparison needs a
        last-good to regress against."""
        if not self.scores:
            self.scores.append(float(score))

    def commit(self, previous_tree: Any, score: float) -> None:
        """A refinement passed the guard: the previously committed weights
        join the (bounded) snapshot ring, the score joins the trail, and
        the regression streak resets."""
        self.snapshots.append(previous_tree)
        while len(self.snapshots) > self.snapshot_ring:
            self.snapshots.pop(0)
        self.scores.append(float(score))
        while len(self.scores) > self.MAX_SCORES:
            self.scores.pop(0)
        self.refine_count += 1
        self.consecutive_regressions = 0

    def reject(self) -> int:
        """A refinement failed the guard (non-finite or regressed past
        tolerance): the candidate is discarded, the session stays at its
        last-good version. Returns the new consecutive-regression streak —
        the frontend quarantines at ``serving.refine_quarantine_after``."""
        self.rollbacks += 1
        self.consecutive_regressions += 1
        return self.consecutive_regressions

    def snapshot_bytes(self) -> int:
        """Bytes held by the rollback ring — the honest extra footprint a
        refined session carries beyond its live cache entry."""
        return sum(tree_bytes(t) for t in self.snapshots)

    def summary(self) -> Dict[str, Any]:
        return {
            "refine_count": self.refine_count,
            "rollbacks": self.rollbacks,
            "consecutive_regressions": self.consecutive_regressions,
            "quarantined": self.quarantined,
            "snapshots": len(self.snapshots),
            "snapshot_bytes": self.snapshot_bytes(),
            "last_good_score": self.last_good_score,
        }


class AdaptedWeightCache:
    """Thread-safe LRU of adapted parameter pytrees.

    ``max_bytes`` bounds the sum of leaf sizes (an entry that alone exceeds
    the budget is rejected — counted as an eviction); ``ttl_s`` expires
    entries lazily on access and on insert. ``clock`` is injectable so tests
    exercise TTL without sleeping."""

    def __init__(
        self,
        max_bytes: int,
        ttl_s: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._lock = san_lock("AdaptedWeightCache._lock")
        # key -> (tree, nbytes, inserted_at); OrderedDict order = LRU order
        self._entries: "OrderedDict[CacheKey, Tuple[Any, int, float]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0

    def _expire_locked(self, now: float) -> None:
        if self.ttl_s <= 0:
            return
        dead = [
            key
            for key, (_, _, t) in self._entries.items()
            if now - t > self.ttl_s
        ]
        for key in dead:
            _, nbytes, _ = self._entries.pop(key)
            self._bytes -= nbytes
            self.expirations += 1

    def get(self, key: CacheKey, ctx=None) -> Optional[Any]:
        """``ctx`` (observability/context.py RequestContext) gets the per-
        request hit verdict stamped on it — the access log's ``cache_hit``
        field, attributed at the seam that knows, not re-derived upstream."""
        now = self._clock()
        with self._lock:
            self._expire_locked(now)
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                if ctx is not None:
                    ctx.cache_hit = False
                return None
            self._entries.move_to_end(key)
            self.hits += 1
        if ctx is not None:
            ctx.cache_hit = True
        return entry[0]

    def put(self, key: CacheKey, tree: Any, age_s: float = 0.0) -> None:
        """``age_s`` back-dates the entry (rehydration after a drain: a
        session restored with 1s of TTL budget left must expire in 1s, not
        get a fresh full TTL)."""
        nbytes = tree_bytes(tree)
        now = self._clock()
        with self._lock:
            self._expire_locked(now)
            if key in self._entries:
                _, old_bytes, _ = self._entries.pop(key)
                self._bytes -= old_bytes
            if nbytes > self.max_bytes:
                # one entry over the whole budget: caching it would evict
                # everything and still bust the bound — refuse
                self.evictions += 1
                return
            self._entries[key] = (tree, nbytes, now - float(age_s))
            self._bytes += nbytes
            while self._bytes > self.max_bytes:
                _, (_, evicted_bytes, _) = self._entries.popitem(last=False)
                self._bytes -= evicted_bytes
                self.evictions += 1

    def bytes_for_fingerprint(self, fingerprint: str) -> int:
        """Live adapted-session bytes keyed under one checkpoint fingerprint
        — the honest denominator for a per-tenant resident-bytes quota
        (serving/tenancy.py::TenantQuotas): summed from the actual entries,
        not estimated from counters."""
        now = self._clock()
        with self._lock:
            self._expire_locked(now)
            return sum(
                nbytes
                for key, (_, nbytes, _) in self._entries.items()
                if key[0] == fingerprint
            )

    def snapshot_entries(self):
        """``[(key, tree, age_s)]`` of every live (unexpired) entry, LRU
        order, under the lock — the graceful-drain spill's source
        (serving/sessions.py). ``age_s`` lets the spill preserve each
        entry's ORIGINAL TTL budget across a restart."""
        now = self._clock()
        with self._lock:
            self._expire_locked(now)
            return [
                (key, tree, now - inserted)
                for key, (tree, _, inserted) in self._entries.items()
            ]

    def __contains__(self, key: CacheKey) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0,
                "evictions": self.evictions,
                "expirations": self.expirations,
            }
