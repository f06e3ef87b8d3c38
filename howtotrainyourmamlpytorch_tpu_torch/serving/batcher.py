"""Micro-batching scheduler for concurrent adapt / predict requests.

Concurrent requests whose tensors pad to the same shape bucket are stacked
along the task axis — the axis ``MAMLSystem`` already vmaps over — and
dispatched to the device as ONE compiled call. A group flushes when it
reaches ``max_batch`` requests or when its oldest request has waited
``deadline_ms`` (a few ms: long enough to coalesce a concurrent burst, short
enough to be invisible next to an inner-loop rollout). One worker thread owns
all flushes, so device dispatch is serialized — no jit-cache races, no
interleaved transfers.

``continuous=True`` adds the Orca lesson (iteration-level scheduling; Yu et
al., OSDI'22) at this batcher's granularity: requests arriving while a flush
is in flight are admitted into the NEXT flush the moment the worker frees,
instead of waiting out their own deadline window. Under load the worker runs
back-to-back flushes whose sizes grow toward ``max_batch``; at light load
nothing changes — an idle worker still holds a lone request for
``deadline_ms`` hoping to coalesce a burst, so the deadline semantics
stragglers rely on are preserved.
"""

import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Dict, Hashable, List, Tuple

from ..observability.context import flow_step
from ..observability.trace import NULL_TRACER

from ..utils.locks import san_condition, san_lock


class QueueFullError(RuntimeError):
    """submit() refused: the batcher already holds ``max_queue_depth``
    undispatched requests. Load-shedding at the queue (rather than letting it
    grow unboundedly and time every request out) keeps tail latency bounded
    under overload; the HTTP layer maps this to 503 + ``Retry-After``."""


class MicroBatcher:
    """Groups submitted payloads by bucket key and flushes each group through
    ``flush_fn(bucket_key, payloads) -> results`` (one result per payload, in
    order). ``submit`` returns a ``Future``; a ``flush_fn`` exception fails
    every future of its group. ``max_queue_depth`` (None = unbounded, the
    pre-resilience behavior) sheds submits beyond that many queued requests
    with :class:`QueueFullError`, counted in ``stats()['shed']``."""

    def __init__(
        self,
        flush_fn: Callable[[Hashable, List[Any]], List[Any]],
        max_batch: int,
        deadline_ms: float,
        name: str = "batcher",
        max_queue_depth: int = None,
        tracer=None,
        pass_contexts: bool = False,
        continuous: bool = False,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._flush_fn = flush_fn
        # flush spans on the worker thread (observability/trace.py); the
        # shared NULL_TRACER default keeps the un-instrumented path free
        self._tracer = tracer if tracer is not None else NULL_TRACER
        # pass_contexts=True widens the flush contract to
        # ``flush_fn(bucket_key, payloads, ctxs)`` so the engine can finish
        # each request's flow at its dispatch span (the frontend opts in;
        # the 2-arg default keeps every existing flush_fn working)
        self._pass_contexts = bool(pass_contexts)
        self.max_batch = int(max_batch)
        self.deadline_s = float(deadline_ms) / 1000.0
        self.max_queue_depth = None if max_queue_depth is None else int(max_queue_depth)
        self.continuous = bool(continuous)
        self.name = name
        self._lock = san_lock("MicroBatcher._lock")
        self._wake = san_condition("MicroBatcher._wake", self._lock)
        # bucket key -> list of (payload, future, enqueue_time, ctx);
        # insertion-ordered so the group with the oldest head is flushed
        # first on deadline. ctx (observability/context.py RequestContext,
        # or None) rides the queue so the flush can stamp each request's
        # queue wait + flush batch and link its trace flow.
        self._groups: "OrderedDict[Hashable, List[Tuple[Any, Future, float, Any]]]" = OrderedDict()
        self._closed = False
        self.requests = 0
        self.shed = 0  # submits refused at max_queue_depth
        self.flushes_full = 0
        self.flushes_deadline = 0
        # continuous-mode flushes: requests admitted while the previous
        # flush was in flight, dispatched the moment the worker freed —
        # under load these dominate and the deadline never paces a flush
        self.flushes_continuous = 0
        # set after every completed flush, cleared when the worker finds the
        # queue empty: only requests that queued DURING a flush skip their
        # deadline window (a straggler arriving at an idle worker does not)
        self._just_flushed = False
        # flushes whose flush_fn RETURNED (result or exception) — the
        # worker-progress signal server._dispatch uses to tell a backlogged
        # worker from a wedged one when a queued request's deadline expires
        self.flushes_done = 0
        # requests currently INSIDE flush_fn (no longer queued, not yet
        # resolved): queue_depth + in_flight is the wedge watchdog's
        # "work pending" signal — a worker parked forever in a hung device
        # dispatch has queue_depth 0 but in_flight > 0
        self.in_flight = 0
        self.batched_requests = 0  # requests that shared a flush with others
        self._worker = threading.Thread(
            target=self._run, name=f"{name}-flush", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------------

    def submit(self, bucket_key: Hashable, payload: Any, ctx=None) -> Future:
        fut: Future = Future()
        with self._wake:
            if self._closed:
                raise RuntimeError(f"{self.name} is closed")
            if (
                self.max_queue_depth is not None
                and sum(len(g) for g in self._groups.values()) >= self.max_queue_depth
            ):
                # shed under the same lock the depth is read under — no race
                # between the check and the enqueue
                self.shed += 1
                raise QueueFullError(
                    f"{self.name} queue full ({self.max_queue_depth} requests "
                    "undispatched) — shedding"
                )
            self._groups.setdefault(bucket_key, []).append(
                (payload, fut, time.monotonic(), ctx)
            )
            self.requests += 1
            self._wake.notify()
        return fut

    def queue_depth(self) -> int:
        with self._lock:
            return sum(len(g) for g in self._groups.values())

    def flushes_completed(self) -> int:
        with self._lock:
            return self.flushes_done

    def pending(self) -> int:
        """Requests queued or mid-flush — nonzero means the worker has work
        it is accountable for making progress on."""
        with self._lock:
            return sum(len(g) for g in self._groups.values()) + self.in_flight

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            flushes = (
                self.flushes_full + self.flushes_deadline + self.flushes_continuous
            )
            return {
                "requests": self.requests,
                "shed": self.shed,
                "flushes": flushes,
                "flushes_full": self.flushes_full,
                "flushes_deadline": self.flushes_deadline,
                "flushes_continuous": self.flushes_continuous,
                "flushes_done": self.flushes_done,
                "batched_requests": self.batched_requests,
                "mean_batch": (self.requests / flushes) if flushes else 0.0,
                "queue_depth": sum(len(g) for g in self._groups.values()),
                "in_flight": self.in_flight,
            }

    def close(self, join_timeout_s: float = None) -> None:
        """Flush everything still queued, then stop the worker.
        ``join_timeout_s`` bounds the wait (the drain-deadline-exceeded
        path: a worker parked in a hung dispatch must not also hang the
        exiting process — it is a daemon thread and dies with it)."""
        with self._wake:
            if self._closed:
                return
            self._closed = True
            self._wake.notify()
        self._worker.join(timeout=join_timeout_s)

    # ------------------------------------------------------------------

    def _take_locked(self, key: Hashable) -> List[Tuple[Any, Future, float, Any]]:
        """Pop at most ``max_batch`` items off a group's head; the remainder
        stays queued with its own enqueue times (its head ages toward the
        deadline like any other group)."""
        group = self._groups[key]
        if len(group) <= self.max_batch:
            return self._groups.pop(key)
        taken, rest = group[: self.max_batch], group[self.max_batch :]
        self._groups[key] = rest
        return taken

    def _pop_ready_locked(self, now: float):
        """The next batch due for flush: any group at max_batch, else — in
        continuous mode, right after a flush — the oldest-head group (its
        requests queued while the worker was busy; making them wait out a
        deadline on top would be pure idle time), else one whose head has
        passed the deadline; None when nothing is due."""
        for key, group in self._groups.items():
            if len(group) >= self.max_batch:
                self.flushes_full += 1
                return key, self._take_locked(key)
        if self.continuous and self._just_flushed and self._groups:
            key = min(self._groups, key=lambda k: self._groups[k][0][2])
            self.flushes_continuous += 1
            return key, self._take_locked(key)
        for key, group in list(self._groups.items()):
            if now - group[0][2] >= self.deadline_s:
                self.flushes_deadline += 1
                return key, self._take_locked(key)
        return None

    def _run(self) -> None:
        while True:
            with self._wake:
                while True:
                    now = time.monotonic()
                    if self._closed and not self._groups:
                        return
                    if self._closed:
                        # drain: every remaining group is due immediately
                        key = next(iter(self._groups))
                        self.flushes_deadline += 1
                        ready = (key, self._take_locked(key))
                        break
                    ready = self._pop_ready_locked(now)
                    if ready is not None:
                        break
                    if self._groups:
                        next_due = (
                            min(g[0][2] for g in self._groups.values())
                            + self.deadline_s
                        )
                        self._wake.wait(timeout=max(next_due - now, 0.0))
                    else:
                        # queue drained: the next arrival meets an idle
                        # worker and gets the full coalescing window
                        self._just_flushed = False
                        self._wake.wait()
                if len(ready[1]) > 1:
                    self.batched_requests += len(ready[1])
            key, group = ready
            # a future cancelled while queued (request-deadline shed,
            # serving/server.py::_dispatch) must not consume device work —
            # and completing it would raise InvalidStateError and kill this
            # worker thread
            group = [(p, fut, t, c) for p, fut, t, c in group if not fut.cancelled()]
            if not group:
                # dropping an all-cancelled group is still worker liveness:
                # without counting it, a deadline tight enough to cancel
                # every queued request reads as zero progress and the wedge
                # watchdog rc=76s a demonstrably live worker
                with self._lock:
                    self.flushes_done += 1
                    # arm continuous pickup ONLY for requests that queued
                    # while this flush was in flight; a later straggler at
                    # the then-idle worker keeps its coalescing deadline
                    self._just_flushed = bool(self._groups)
                continue
            payloads = [p for p, _, _, _ in group]
            # stamp each request's journey through this flush BEFORE the
            # dispatch: queue wait (enqueue -> worker pickup) and how many
            # flush-mates it shares the device call with — the numbers a
            # continuous-batching p99 investigation needs per request
            pickup = time.monotonic()
            ctxs = []
            for _, _, t_enq, c in group:
                if c is not None:
                    c.queue_wait_s = pickup - t_enq
                    c.flush_batch = len(group)
                ctxs.append(c)
            flows = flow_step(ctxs)
            with self._lock:
                self.in_flight = len(group)
            try:
                with self._tracer.span(
                    f"serve.flush.{self.name}", flows=flows,
                    batch=len(group), bucket=key,
                ):
                    if self._pass_contexts:
                        results = self._flush_fn(key, payloads, ctxs)
                    else:
                        results = self._flush_fn(key, payloads)
                if len(results) != len(group):
                    raise RuntimeError(
                        f"{self.name} flush_fn returned {len(results)} results "
                        f"for {len(group)} payloads"
                    )
            except BaseException as exc:  # noqa: BLE001 — fail the futures, keep serving
                with self._lock:
                    self.flushes_done += 1  # an exception is still progress
                    self.in_flight = 0
                    self._just_flushed = bool(self._groups)
                for _, fut, _, _ in group:
                    self._complete(fut, exc=exc)
                continue
            with self._lock:
                self.flushes_done += 1
                self.in_flight = 0
                self._just_flushed = bool(self._groups)
            for (_, fut, _, _), res in zip(group, results):
                self._complete(fut, result=res)

    @staticmethod
    def _complete(fut: Future, result=None, exc=None) -> None:
        """Set a future's outcome, tolerating a cancel that raced the flush
        (the caller already gave up on it; the worker must survive)."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except InvalidStateError:
            pass
