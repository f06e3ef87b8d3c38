"""Cache-affinity router + admission control over an :class:`EnginePool`.

MAML++-style serving gives every session sticky state — the adapted fast
weights cached under ``(checkpoint fingerprint, support digest)`` — so
routing is not load balancing over stateless workers: a session served by
the replica that already holds its fast weights skips the whole inner loop.
The router keys on exactly that cache key via **rendezvous (highest-random-
weight) hashing**: every (key, replica) pair gets a deterministic score,
the routable replica with the highest score wins. Same key => same replica
as long as it is routable (affinity); a replica dying or tripping its
breaker only remaps the keys it owned (the consistent-hashing property —
no global reshuffle); when it recovers, its keys come home.

Admission control sheds **at the router**: when the chosen replica already
holds ``max_queued_per_replica`` undispatched requests, the request is
refused with HTTP 429 + Retry-After BEFORE it queues — under overload the
router is the cheap place to say no, and the per-replica batcher's own
queue-depth shed (503) stays as the inner backstop. ``0`` disables router
admission (the pre-fleet behavior).

Thread safety: ``route``/``admit`` run on every HTTP handler thread
concurrently; all mutable router state (per-replica routed counts,
routed-around/shed counters) is guarded by one lock. Scoring itself is
pure (hashlib over immutable fields) and runs outside it.
"""

from typing import Any, Dict, List, Optional

from ..exit_codes import HTTP_TOO_MANY_REQUESTS
from .errors import ServiceUnavailableError
# the single rendezvous implementation: the gateway owns it, so the
# in-process router and every gateway of a fleet agree where a session lives
from .gateway import rendezvous_score
from .pool import EngineReplica

from ..utils.locks import san_lock


class NoRoutableReplicaError(ServiceUnavailableError):
    """Every replica is dead or breaker-open — the whole-fleet outage
    signal (HTTP 503; distinct type so drills can assert it)."""


class Router:
    def __init__(
        self,
        replicas: List[EngineReplica],
        max_queued_per_replica: int = 0,
        shed_retry_after_s: float = 1.0,
    ):
        self.replicas = replicas
        self.max_queued_per_replica = int(max_queued_per_replica)
        self.shed_retry_after_s = float(shed_retry_after_s)
        self._lock = san_lock("Router._lock")
        self._routed = [0] * len(replicas)
        self._routed_around = 0
        self._router_shed = 0
        self._no_replica = 0

    # ------------------------------------------------------------------

    def route(self, affinity_key: str, ctx=None) -> EngineReplica:
        """The replica that serves ``affinity_key``: highest rendezvous
        score among ROUTABLE replicas. Death is a hard exclusion;
        breaker-open is soft — when NO replica is routable the affinity
        winner among the ALIVE ones is returned anyway so its breaker can
        fail-fast (counted ``breaker_rejected``, half-open probe semantics
        preserved) and its cached sessions still hit: exactly the
        single-replica pre-fleet behavior. Only an all-dead fleet raises
        :class:`NoRoutableReplicaError`. Counts a ``routed_around``
        whenever the affinity winner over ALL replicas was skipped for
        being dead/open — the signal that sessions are being displaced
        (and will re-adapt on their fallback replica)."""
        best: Optional[EngineReplica] = None
        best_score = -1
        alive_best: Optional[EngineReplica] = None
        alive_best_score = -1
        top: Optional[EngineReplica] = None
        top_score = -1
        for replica in self.replicas:
            score = rendezvous_score(affinity_key, replica.index)
            if score > top_score:
                top, top_score = replica, score
            if replica.alive and score > alive_best_score:
                alive_best, alive_best_score = replica, score
            if replica.routable() and score > best_score:
                best, best_score = replica, score
        if best is None:
            best = alive_best
        if best is None:
            with self._lock:
                self._no_replica += 1
            raise NoRoutableReplicaError(
                f"no routable replica ({len(self.replicas)} total: all dead)",
                retry_after_s=self.shed_retry_after_s,
            )
        with self._lock:
            self._routed[best.index] += 1
            if top is not best:
                self._routed_around += 1
        if ctx is not None:
            ctx.replica = best.index
        return best

    def admit(self, replica: EngineReplica) -> None:
        """Router admission control: shed (429 + Retry-After) when the
        routed replica's queue is already at the admission bound, BEFORE
        the request costs it anything. No-op when disabled (bound 0)."""
        if self.max_queued_per_replica <= 0:
            return
        if replica.load() >= self.max_queued_per_replica:
            with self._lock:
                self._router_shed += 1
            raise ServiceUnavailableError(
                f"replica {replica.index} at admission bound "
                f"({self.max_queued_per_replica} queued) — shed at router",
                retry_after_s=self.shed_retry_after_s,
                status=HTTP_TOO_MANY_REQUESTS,
            )

    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "replicas": len(self.replicas),
                "routable": sum(1 for r in self.replicas if r.routable()),
                "routed": list(self._routed),
                "routed_around": self._routed_around,
                "router_shed": self._router_shed,
                "no_routable_replica": self._no_replica,
                "max_queued_per_replica": self.max_queued_per_replica,
            }
