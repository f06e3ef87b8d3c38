"""Request-scoped tracing: trace ids end to end + the structured access log.

Aggregate observability (PRs 5 and 7) answers "where does time go" for the
*population*; this module answers it for *one request* — the Dapper lesson
(Sigelman et al., 2010) that sampled per-request traces, not histograms, are
what debug tail latency in a batched serving tier. Continuous batching makes
the need sharper: one request's latency is a function of its flush-mates
(Orca; Yu et al., OSDI 2022), so a bad p99 can only be explained by seeing
*that request's* queue wait and flush batch, not the percentile it landed in.

Three pieces:

- :class:`RequestContext` — the per-request identity (128-bit trace id +
  64-bit span id, W3C ``traceparent``-compatible) and the mutable timing
  slots the serving path fills in as the request moves HTTP thread ->
  batcher queue -> worker flush -> engine dispatch. Accepted/echoed via the
  ``traceparent`` header (:func:`parse_traceparent` /
  :func:`format_traceparent`), minted when absent
  (:func:`new_request_context` — ``os.urandom``, no seeded RNG).
- Flow helpers (:func:`flow_start` etc.) — build the ``flows`` argument
  ``SpanTracer.span`` records so the Chrome/Perfetto export links a
  request's spans across threads as one arc (``ph: s/t/f`` flow events).
- :class:`AccessLog` — the sampled structured access log
  (``logs/access.jsonl``, one JSON line per request: trace id, verb,
  bucket, flush batch, queue-wait/dispatch/total ms, cache hit, outcome,
  breaker state). Sampling is deterministic on the trace id so every
  process of a fleet keeps or drops the same request; non-``ok`` outcomes
  are ALWAYS logged regardless of the sample rate — the chaos-campaign
  invariant "every non-200 response has an access line" must hold at any
  sampling level.

``scripts/trace_merge.py`` joins per-process traces + access logs into one
Perfetto timeline; OPERATIONS.md "Tracing a request" is the runbook.
"""

import dataclasses
import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.locks import san_lock

#: W3C traceparent: version "00" - 16-byte trace id - 8-byte parent span id
#: - 2-hex flags (bit 0 = sampled). All-zero ids are invalid per spec.
_TRACEPARENT_RE = re.compile(
    r"^00-(?!0{32})([0-9a-f]{32})-(?!0{16})([0-9a-f]{16})-([0-9a-f]{2})$"
)


@dataclasses.dataclass
class RequestContext:
    """One request's identity + the timing slots each hop fills in.

    The identity fields are immutable in spirit; the timing slots are
    written by exactly one later hop each (batcher worker: queue wait /
    flush batch; engine: dispatch seconds; cache: hit flag), each a single
    GIL-atomic attribute store. For a request that RESOLVES, the
    ``Future.result`` edge is the happens-before and the reader sees every
    stamp. For a request the caller abandons at its deadline, the worker
    may still be stamping while the failure line is logged — that line
    shows whichever hops had completed by logging time (e.g. queue wait
    without dispatch), which is the honest journey of an abandoned
    request, so no lock is spent on it."""

    trace_id: str  # 32 lowercase hex chars (16 bytes)
    span_id: str  # 16 lowercase hex chars (8 bytes), minted per server hop
    parent_id: Optional[str] = None  # upstream span id from traceparent
    sampled: bool = True  # traceparent sampled flag, echoed downstream
    # -- filled in as the request moves through the serving path --------
    bucket: Any = None  # shape bucket the frontend routed to
    true_size: Optional[int] = None  # pre-padding sample count (waste acct)
    strategy: Optional[str] = None  # adaptation strategy the request named
    tenant: Optional[str] = None  # tenant the request named (None = default)
    replica: Optional[int] = None  # pool replica the router chose
    flush_batch: Optional[int] = None  # requests sharing the flush
    queue_wait_s: Optional[float] = None  # submit -> worker pickup
    dispatch_s: Optional[float] = None  # engine device dispatch
    program: Optional[str] = None  # the engine program the flush ran ("serve_adapt/100/8")
    cache_hit: Optional[bool] = None  # adapted-weight cache verdict
    access_logged: bool = False  # the double-log guard (HTTP layer)

    def timing_ms(self, total_s: Optional[float] = None) -> Dict[str, Any]:
        """The per-request breakdown returned in response bodies and logged
        to access.jsonl (``None`` for hops the request never reached)."""

        def ms(v):
            return round(v * 1e3, 3) if v is not None else None

        return {
            "queue_wait_ms": ms(self.queue_wait_s),
            "dispatch_ms": ms(self.dispatch_s),
            "total_ms": ms(total_s),
        }


def new_request_context() -> RequestContext:
    """Mint a fresh root context (``os.urandom`` — collision-safe across
    processes, never a seeded RNG)."""
    return RequestContext(
        trace_id=os.urandom(16).hex(), span_id=os.urandom(8).hex()
    )


def parse_traceparent(header: Optional[str]) -> RequestContext:
    """Adopt an incoming ``traceparent`` (the caller's trace id becomes
    ours, their span id becomes our parent) or mint a fresh context when
    the header is absent or malformed — a bad header must never 4xx a
    request over plumbing the client may not even know it sends."""
    if header:
        m = _TRACEPARENT_RE.match(header.strip().lower())
        if m:
            trace_id, parent_id, flags = m.groups()
            return RequestContext(
                trace_id=trace_id,
                span_id=os.urandom(8).hex(),
                parent_id=parent_id,
                sampled=bool(int(flags, 16) & 1),
            )
    return new_request_context()


def format_traceparent(ctx: RequestContext) -> str:
    """The outgoing header: our span id is the downstream's parent."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


# ---------------------------------------------------------------------------
# flow helpers: the ``flows`` argument SpanTracer.span records
# ---------------------------------------------------------------------------


def flow_start(ctx: Optional[RequestContext]) -> Optional[Tuple]:
    """Flow origin (``ph: "s"``) — the request's entry span (HTTP thread).
    A start with no finish is legitimate: the request never reached a
    device dispatch (cache hit, shed, breaker rejection)."""
    return ((ctx.trace_id, "s"),) if ctx is not None else None


def flow_step(ctxs: Sequence[Optional[RequestContext]]) -> Optional[Tuple]:
    """Flow step (``ph: "t"``) — the batcher flush span, one step per
    request the flush carries (two requests, one flush span, two flows)."""
    steps = tuple((c.trace_id, "t") for c in ctxs if c is not None)
    return steps or None


def flow_end(ctxs: Sequence[Optional[RequestContext]]) -> Optional[Tuple]:
    """Flow finish (``ph: "f"``) — the engine dispatch span."""
    ends = tuple((c.trace_id, "f") for c in ctxs if c is not None)
    return ends or None


# ---------------------------------------------------------------------------
# the structured access log
# ---------------------------------------------------------------------------


class AccessLog:
    """Sampled per-request JSON lines in ``<log_dir>/access.jsonl``.

    Storage rides :class:`~..experiment.storage.EventLog` (whole-line
    writes, flushed per append, lock-protected — HTTP handler threads and
    the in-process API log concurrently), so a hard-killed server leaves at
    worst one torn final line. Sampling is a deterministic function of the
    trace id — every process of a fleet keeps or drops the SAME request, so
    a cross-process ``trace_merge`` never sees half a journey — and
    non-``ok`` outcomes bypass it entirely."""

    def __init__(
        self,
        log_dir: str,
        sample: float = 1.0,
        filename: str = "access.jsonl",
        wall_clock: Callable[[], float] = time.time,
    ):
        from ..experiment.storage import EventLog

        os.makedirs(log_dir, exist_ok=True)
        self._log = EventLog(log_dir, filename=filename)
        self.path = self._log.path
        self.sample = float(sample)
        self._wall_clock = wall_clock
        self._lock = san_lock("AccessLog._lock")
        self.lines = 0
        self.sampled_out = 0

    def should_sample(self, trace_id: str) -> bool:
        """Deterministic keep/drop from the id's leading 32 bits."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return int(trace_id[:8], 16) / float(1 << 32) < self.sample

    def record(
        self,
        ctx: RequestContext,
        verb: str,
        outcome: str,
        status: Optional[int],
        total_s: Optional[float],
        **fields: Any,
    ) -> bool:
        """Append one line (or count it sampled out). Marks the context
        logged either way so the HTTP layer never double-logs. Returns
        whether a line was written."""
        ctx.access_logged = True
        if outcome == "ok" and not self.should_sample(ctx.trace_id):
            with self._lock:
                self.sampled_out += 1
            return False
        rec: Dict[str, Any] = {
            "ts": self._wall_clock(),
            "trace_id": ctx.trace_id,
            "parent_id": ctx.parent_id,
            "verb": verb,
            "outcome": outcome,
            "status": status,
            "bucket": ctx.bucket,
            "true_size": ctx.true_size,
            "strategy": ctx.strategy,
            "tenant": ctx.tenant,
            "replica": ctx.replica,
            "flush_batch": ctx.flush_batch,
            "cache_hit": ctx.cache_hit,
            "program": ctx.program,
            **ctx.timing_ms(total_s),
        }
        rec.update(fields)
        self._log.append(rec)
        with self._lock:
            self.lines += 1
        return True

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "path": self.path,
                "lines": self.lines,
                "sampled_out": self.sampled_out,
                "sample": self.sample,
            }

    def close(self) -> None:
        self._log.close()


def read_access_log(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Parse an access.jsonl, skipping (and counting) torn lines — readers
    (SLO report join, trace_merge, the chaos invariant) must degrade on a
    hard-killed server's log, never die on it."""
    records: List[Dict[str, Any]] = []
    torn = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                torn += 1
    return records, torn
