"""Multi-host serving gateway: a stdlib HTTP load balancer over N backends
(a copy of the JAX package's ``serving/gateway.py``).

One ``python -m howtotrainyourmamlpytorch_tpu_torch.serve`` process per
card or host sits behind this load-balancer process. The gateway owns three
things:

- **Live membership.** A poller thread probes every backend's ``/healthz``
  with hysteresis: ``fail_threshold`` consecutive non-routable probes take a
  backend OUT of rotation, ``pass_threshold`` consecutive routable probes
  bring it back IN. A reachable backend whose body says ``warming`` or
  ``draining`` is alive but **not routable for new work** — exactly the
  states a rolling restart moves a backend through. Connection failures on
  proxied requests feed the same streaks, so a kill -9'd backend is routed
  around within (at most) the hysteresis window, usually sooner.
- **Session-affine routing.** The affinity key is the adaptation id — the
  same process-stable rendezvous (HRW) scoring ``serving/router.py`` uses
  inside one process (:func:`rendezvous_score` lives HERE and the router
  imports it, so the two layers cannot drift). ``/predict`` routes on the
  request's ``adaptation_id``; ``/adapt`` routes on a content hash of the
  request body (a repeat upload of the same support set lands on the same
  backend => its adapted-weight cache hit survives the extra hop), and the
  backend's response teaches the gateway the ``adaptation_id -> backend``
  binding so the session's predicts follow its fast weights.
- **Failure containment.** Connection failure / HTTP 5xx from a backend =>
  retry-with-exclusion against the next-ranked live backend; a 503 whose
  body says ``draining``/``warming`` is also retried (the backend refused
  BEFORE doing work, so a retry is safe). Backend 429/503(load)/504 pass
  through unchanged with their ``Retry-After``. Gateway-level admission
  control sheds 429 when ``max_inflight`` proxied requests are already in
  flight. Every request gets one gateway access-log line carrying a
  ``backend`` field, so ``scripts/trace_merge.py`` joins the request arc
  across processes, and membership flaps land in the gateway's
  ``events.jsonl``.

Import-light BY CONTRACT: this module is pure stdlib (no torch, no numpy,
no package-relative imports) so ``scripts/gateway.py`` of this package can
load it by file path and run on a gateway-only host with no accelerator
stack installed. The traceparent grammar below is deliberately kept in sync
with ``observability/context.py`` (which this module must not import).
"""

import hashlib
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

# Locks are plain threading.Lock: the lock-discipline sanitizer (tools/graftsan)
# is not ported (ROADMAP.md A9.7), and this module must stay stdlib-only.

#: healthz body ``status`` values that mean "alive but do not route NEW
#: work here" — the drain/warm half of the membership state machine
NOT_ROUTABLE_STATUSES = ("warming", "draining")


def _load_http_codes():
    """The serving HTTP degradation codes from the port's ``exit_codes.py``,
    loaded BY FILE PATH (this module must stay import-light — no package
    import); a standalone copy falls back to the historical literals."""
    import importlib.util

    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir, "exit_codes.py"
    )
    try:
        spec = importlib.util.spec_from_file_location("htymp_torch_exit_codes_gw", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.HTTP_TOO_MANY_REQUESTS, mod.HTTP_UNAVAILABLE, mod.HTTP_DEADLINE
    except Exception:  # noqa: BLE001 — standalone copy of the file
        return 429, 503, 504


HTTP_TOO_MANY_REQUESTS, HTTP_UNAVAILABLE, HTTP_DEADLINE = _load_http_codes()


def rendezvous_score(key: str, replica_index: int) -> int:
    """Deterministic (key, replica) weight: leading 64 bits of
    blake2b(key | replica). Stable across processes and runs — every router
    (in-process ``serving/router.py``) and every gateway of a fleet agrees
    where a session lives. THE single implementation; the router imports
    it from here."""
    h = hashlib.blake2b(f"{key}|{replica_index}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


# ---------------------------------------------------------------------------
# W3C traceparent (kept in sync with observability/context.py — import-light)
# ---------------------------------------------------------------------------

_TRACEPARENT_RE = re.compile(
    r"^00-(?!0{32})([0-9a-f]{32})-(?!0{16})([0-9a-f]{16})-([0-9a-f]{2})$"
)


def _parse_traceparent(header: Optional[str]) -> Tuple[str, str, Optional[str]]:
    """-> (trace_id, our_span_id, parent_id). Adopt the caller's trace id,
    mint our own span; a malformed header mints a fresh root (never a 4xx
    over plumbing the client may not know it sends)."""
    if header:
        m = _TRACEPARENT_RE.match(header.strip().lower())
        if m:
            return m.group(1), os.urandom(8).hex(), m.group(2)
    return os.urandom(16).hex(), os.urandom(8).hex(), None


def _format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


# ---------------------------------------------------------------------------
# tiny durable JSON-lines log (the EventLog contract, stdlib-only)
# ---------------------------------------------------------------------------


class _JsonlLog:
    """Flushed-per-append JSON-lines file (the ``experiment/storage.py``
    EventLog contract, re-implemented here because this module must stay
    loadable by file path with no package context). A hard-killed gateway
    leaves at worst one torn final line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._handle = None
        self._closed = False
        self.lines = 0

    def append(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record) + "\n"
        with self._lock:
            if self._closed:
                with open(self.path, "a") as f:
                    f.write(line)
                self.lines += 1
                return
            if self._handle is None:
                self._handle = open(self.path, "a")
            self._handle.write(line)
            self._handle.flush()
            self.lines += 1

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._handle is not None:
                try:
                    self._handle.flush()
                    self._handle.close()
                finally:
                    self._handle = None


# ---------------------------------------------------------------------------
# backend membership
# ---------------------------------------------------------------------------


class Backend:
    """One serve process behind the gateway: url + membership state.

    Membership is hysteretic over ROUTABILITY observations (health probes
    AND proxied-request connection failures): ``fail_threshold`` consecutive
    non-routable observations => OUT, ``pass_threshold`` consecutive
    routable probes => IN. A backend starts OUT ("unknown") and must pass
    its way in — a gateway never routes to a backend it has not seen
    healthy."""

    def __init__(self, index: int, url: str, fail_threshold: int, pass_threshold: int):
        self.index = int(index)
        self.url = url.rstrip("/")
        self.name = f"b{index}"
        self._fail_threshold = max(1, int(fail_threshold))
        self._pass_threshold = max(1, int(pass_threshold))
        self._lock = threading.Lock()
        self._in = False
        self._consec_fail = 0
        self._consec_pass = 0
        self.flaps = 0  # OUT->IN and IN->OUT transitions after the first IN
        self._ever_in = False
        self.last_status = "unknown"
        self.routed = 0
        self.retried_away = 0  # requests that failed here and moved on
        self.passthrough_errors = 0  # backend-refusal statuses passed through

    @property
    def is_in(self) -> bool:
        with self._lock:
            return self._in

    def note_observation(self, routable: bool, status: str) -> Optional[str]:
        """Feed one routability observation; returns ``"in"``/``"out"`` when
        membership flips, else None."""
        with self._lock:
            self.last_status = status
            if routable:
                self._consec_pass += 1
                self._consec_fail = 0
                if not self._in and self._consec_pass >= self._pass_threshold:
                    self._in = True
                    if self._ever_in:
                        self.flaps += 1
                    self._ever_in = True
                    return "in"
            else:
                self._consec_fail += 1
                self._consec_pass = 0
                if self._in and self._consec_fail >= self._fail_threshold:
                    self._in = False
                    self.flaps += 1
                    return "out"
        return None

    def note_routed(self) -> None:
        with self._lock:
            self.routed += 1

    def note_retried_away(self) -> None:
        with self._lock:
            self.retried_away += 1

    def note_passthrough_error(self) -> None:
        with self._lock:
            self.passthrough_errors += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "backend": self.name,
                "index": self.index,
                "url": self.url,
                "in": self._in,
                "state": "in" if self._in else "out",
                "last_status": self.last_status,
                "consecutive_fails": self._consec_fail,
                "consecutive_passes": self._consec_pass,
                "flaps": self.flaps,
                "routed": self.routed,
                "retried_away": self.retried_away,
                "passthrough_errors": self.passthrough_errors,
            }


# ---------------------------------------------------------------------------
# the gateway
# ---------------------------------------------------------------------------


class Gateway:
    """Membership + routing + proxy state for one gateway process. The HTTP
    handler below is a thin shell over :meth:`proxy`; everything here is
    unit-testable without sockets (``probe`` and request I/O are
    injectable)."""

    def __init__(
        self,
        backend_urls: List[str],
        health_interval_s: float = 1.0,
        fail_threshold: int = 2,
        pass_threshold: int = 1,
        max_inflight: int = 0,
        retry_after_s: float = 1.0,
        probe_timeout_s: float = 3.0,
        request_timeout_s: float = 120.0,
        log_dir: Optional[str] = None,
        session_table_size: int = 4096,
        wall_clock=time.time,
    ):
        if not backend_urls:
            raise ValueError("gateway needs at least one backend url")
        self.backends = [
            Backend(i, url, fail_threshold, pass_threshold)
            for i, url in enumerate(backend_urls)
        ]
        self.health_interval_s = float(health_interval_s)
        self.max_inflight = int(max_inflight)
        self.retry_after_s = float(retry_after_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self._wall = wall_clock
        self._started = time.monotonic()
        self._lock = threading.Lock()
        # adaptation_id -> backend index, learned from adapt responses;
        # bounded LRU so a long-lived gateway cannot grow without bound.
        # Rendezvous on the id is the cross-gateway-stable fallback (and the
        # only mechanism after a gateway restart).
        self._sessions: "OrderedDict[str, int]" = OrderedDict()
        self._session_table_size = int(session_table_size)
        self._inflight = 0
        self.requests = 0
        self.retries = 0
        self.admission_shed = 0  # gateway 429s
        self.no_backend = 0  # 503s for "no live backend"
        self.access: Optional[_JsonlLog] = None
        self.events: Optional[_JsonlLog] = None
        if log_dir:
            self.access = _JsonlLog(os.path.join(log_dir, "access.jsonl"))
            self.events = _JsonlLog(os.path.join(log_dir, "events.jsonl"))
        self._stop = threading.Event()
        self._poller = threading.Thread(
            target=self._poll_loop, name="gateway-health", daemon=True
        )

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self._poller.start()

    def close(self) -> None:
        self._stop.set()
        if self._poller.is_alive():
            self._poller.join(timeout=self.probe_timeout_s + self.health_interval_s)
        if self.access is not None:
            self.access.close()
        if self.events is not None:
            self.events.close()

    def _event(self, name: str, **fields: Any) -> None:
        if self.events is None:
            return
        self.events.append(
            {"ts": self._wall(), "event": name, "component": "gateway", **fields}
        )

    # -- health membership ---------------------------------------------

    def probe(self, backend: Backend) -> Tuple[bool, str]:
        """One /healthz observation -> (routable_for_new_work, status).
        200 => routable (``ok`` or partially ``degraded`` — the backend's
        own contract: 200 means it can still serve). A 503 is classified by
        its body ``status`` (warming/draining/degraded); connection failure
        is ``unreachable``. Overridable in tests."""
        try:
            with urllib.request.urlopen(
                backend.url + "/healthz", timeout=self.probe_timeout_s
            ) as resp:
                body = _safe_json(resp.read())
                return True, str(body.get("status", "ok"))
        except urllib.error.HTTPError as exc:
            body = _safe_json(exc.read())
            status = str(body.get("status", f"http-{exc.code}"))
            return False, status
        except (urllib.error.URLError, OSError, ValueError):
            return False, "unreachable"

    def observe(self, backend: Backend, routable: bool, status: str) -> None:
        """Feed one observation through the hysteresis and log a flap."""
        flip = backend.note_observation(routable, status)
        if flip is not None:
            self._event(
                f"backend_{flip}",
                backend=backend.name,
                url=backend.url,
                status=status,
                in_count=self.in_count(),
            )

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            for backend in self.backends:
                routable, status = self.probe(backend)
                self.observe(backend, routable, status)
            self._stop.wait(self.health_interval_s)

    def in_count(self) -> int:
        return sum(1 for b in self.backends if b.is_in)

    # -- routing -------------------------------------------------------

    def route(self, key: str, exclude: Optional[set] = None) -> Optional[Backend]:
        """Highest-rendezvous-score IN backend for ``key`` (minus
        ``exclude``); None when no live backend remains."""
        exclude = exclude or set()
        best: Optional[Backend] = None
        best_score = -1
        for backend in self.backends:
            if backend.index in exclude or not backend.is_in:
                continue
            score = rendezvous_score(key, backend.index)
            if score > best_score:
                best, best_score = backend, score
        return best

    def _session_backend(self, adaptation_id: str) -> Optional[Backend]:
        with self._lock:
            idx = self._sessions.get(adaptation_id)
            if idx is not None:
                self._sessions.move_to_end(adaptation_id)
        if idx is None:
            return None
        backend = self.backends[idx]
        return backend if backend.is_in else None

    def _learn_session(self, adaptation_id: str, backend: Backend) -> None:
        with self._lock:
            self._sessions[adaptation_id] = backend.index
            self._sessions.move_to_end(adaptation_id)
            while len(self._sessions) > self._session_table_size:
                self._sessions.popitem(last=False)

    def affinity_key(self, path: str, body: bytes) -> Tuple[str, Optional[Backend]]:
        """The routing key for one request + the session-table preference
        (predicts follow the backend that adapted their session). Adapt-ish
        requests key on a content hash of the body, so a repeat upload of
        the same support set stays affine without the gateway re-deriving
        the server-side support digest. A REFINE request (``/adapt`` with
        ``refine`` + ``session_id``) is session traffic, not content
        traffic: it must reach the backend holding the session's cached
        fast weights, so it keys on the session id exactly like a predict —
        a body hash would scatter refines of one session across the fleet
        whenever the new support set differs from the original."""
        if path == "/predict":
            payload = _safe_json(body)
            aid = payload.get("adaptation_id")
            if isinstance(aid, str) and aid:
                return aid, self._session_backend(aid)
        if path == "/adapt":
            payload = _safe_json(body)
            sid = payload.get("session_id")
            if payload.get("refine") and isinstance(sid, str) and sid:
                return sid, self._session_backend(sid)
        return hashlib.blake2b(body, digest_size=16).hexdigest(), None

    # -- the proxy -----------------------------------------------------

    def send(
        self, backend: Backend, method: str, path: str, body: Optional[bytes],
        headers: Dict[str, str],
    ) -> Tuple[int, Dict[str, str], bytes]:
        """One upstream HTTP exchange -> (status, headers, body). HTTP
        errors are returned as statuses; connection-level failures raise
        OSError. Overridable in tests."""
        req = urllib.request.Request(
            backend.url + path, data=body, headers=headers, method=method
        )
        try:
            with urllib.request.urlopen(req, timeout=self.request_timeout_s) as resp:
                return resp.status, dict(resp.headers.items()), resp.read()
        except urllib.error.HTTPError as exc:
            return exc.code, dict(exc.headers.items()), exc.read()
        except urllib.error.URLError as exc:
            raise OSError(f"{backend.url}{path}: {exc.reason}") from exc

    def _retryable(self, status: int, body: bytes) -> bool:
        """May this failure be safely retried on another backend? Plain 5xx
        (500/502: the backend broke mid-request on an idempotent API — both
        adapt and predict are) and 503s whose body says the backend refused
        BEFORE doing work (draining/warming). Backend load-refusals (plain
        503 shed/breaker, 429, 504) pass through: retrying overload onto the
        rest of the fleet is how overload spreads."""
        if status in (500, 502):
            return True
        if status == 503:
            return _safe_json(body).get("status") in NOT_ROUTABLE_STATUSES or (
                "draining" in (_safe_json(body).get("error") or "")
            )
        return False

    def proxy(
        self, path: str, body: bytes, traceparent: Optional[str]
    ) -> Tuple[int, Dict[str, str], bytes]:
        """Route + forward one POST; returns (status, response headers,
        response body). All gateway response headers (X-Request-Id,
        X-Gateway-Backend, traceparent, Retry-After) are in the returned
        header dict."""
        t0 = time.monotonic()
        trace_id, span_id, parent_id = _parse_traceparent(traceparent)
        # the tenant the request names (serving/tenancy.py) rides every
        # gateway access line — parsed lazily, only when lines are written
        # (a local, not instance state: the threaded handler proxies
        # concurrently)
        tenant = (
            _safe_json(body).get("tenant") if self.access is not None else None
        )
        out_headers: Dict[str, str] = {
            "X-Request-Id": trace_id,
            "traceparent": _format_traceparent(trace_id, span_id),
        }
        with self._lock:
            self.requests += 1
            if self.max_inflight > 0 and self._inflight >= self.max_inflight:
                self.admission_shed += 1
                shed = True
            else:
                self._inflight += 1
                shed = False
        if shed:
            out_headers["Retry-After"] = str(max(1, int(round(self.retry_after_s))))
            payload = json.dumps(
                {"error": "gateway at max_inflight — shed at admission",
                 "retry_after_s": self.retry_after_s}
            ).encode()
            self._access(trace_id, parent_id, path, "shed", 429, None, 0, t0,
                         tenant=tenant)
            return 429, out_headers, payload
        try:
            return self._proxy_routed(
                path, body, trace_id, span_id, parent_id, out_headers, t0,
                tenant=tenant,
            )
        finally:
            with self._lock:
                self._inflight -= 1

    def _proxy_routed(
        self, path, body, trace_id, span_id, parent_id, out_headers, t0,
        tenant=None,
    ) -> Tuple[int, Dict[str, str], bytes]:
        key, preferred = self.affinity_key(path, body)
        fwd_headers = {
            "Content-Type": "application/json",
            "traceparent": _format_traceparent(trace_id, span_id),
        }
        tried: set = set()
        retries = 0
        backend = preferred if preferred is not None else self.route(key)
        while backend is not None:
            try:
                status, up_headers, resp_body = self.send(
                    backend, "POST", path, body, fwd_headers
                )
            except OSError:
                # connection-level failure: hard evidence against the
                # backend — feed the hysteresis AND move on immediately
                self.observe(backend, False, "unreachable")
                backend.note_retried_away()
                tried.add(backend.index)
                retries += 1
                with self._lock:
                    self.retries += 1
                backend = self.route(key, exclude=tried)
                continue
            if status < 400:
                backend.note_routed()
                self._learn_from_response(path, resp_body, backend)
                out_headers["X-Gateway-Backend"] = backend.name
                self._access(
                    trace_id, parent_id, path, "ok", status, backend, retries,
                    t0, tenant=tenant,
                )
                return status, out_headers, resp_body
            if self._retryable(status, resp_body):
                backend.note_retried_away()
                tried.add(backend.index)
                retries += 1
                with self._lock:
                    self.retries += 1
                backend = self.route(key, exclude=tried)
                continue
            # backend refusal (429/503 load/504/404/400/...) passes through
            # unchanged, Retry-After included
            backend.note_passthrough_error()
            out_headers["X-Gateway-Backend"] = backend.name
            if "Retry-After" in up_headers:
                out_headers["Retry-After"] = up_headers["Retry-After"]
            self._access(
                trace_id, parent_id, path, _outcome_of(status), status, backend,
                retries, t0, tenant=tenant,
            )
            return status, out_headers, resp_body
        # every live backend tried (or none was live)
        with self._lock:
            self.no_backend += 1
        out_headers["Retry-After"] = str(max(1, int(round(self.retry_after_s))))
        payload = json.dumps(
            {
                "error": f"no live backend ({self.in_count()} in / "
                f"{len(self.backends)} total, {retries} retried)",
                "retry_after_s": self.retry_after_s,
            }
        ).encode()
        self._access(trace_id, parent_id, path, "no_backend", 503, None, retries,
                     t0, tenant=tenant)
        return 503, out_headers, payload

    def _learn_from_response(self, path: str, resp_body: bytes, backend: Backend) -> None:
        if path in ("/adapt", "/adapt_predict"):
            aid = _safe_json(resp_body).get("adaptation_id")
            if isinstance(aid, str) and aid:
                self._learn_session(aid, backend)

    def _access(
        self, trace_id, parent_id, verb, outcome, status, backend, retries, t0,
        tenant=None,
    ) -> None:
        if self.access is None:
            return
        self.access.append(
            {
                "ts": self._wall(),
                "trace_id": trace_id,
                "parent_id": parent_id,
                "verb": verb,
                "outcome": outcome,
                "status": status,
                "tenant": tenant,
                "backend": backend.name if backend is not None else None,
                "retries": retries,
                "total_ms": round((time.monotonic() - t0) * 1e3, 3),
            }
        )

    # -- observability surfaces ----------------------------------------

    def healthz(self) -> Tuple[int, Dict[str, Any]]:
        in_count = self.in_count()
        if in_count == len(self.backends):
            status = "ok"
        elif in_count > 0:
            status = "degraded"
        else:
            status = "no_backend"
        body = {
            "status": status,
            "gateway": True,
            "backends_in": in_count,
            "backends_total": len(self.backends),
            "backends": [b.snapshot() for b in self.backends],
            "uptime_s": round(time.monotonic() - self._started, 1),
        }
        return (200 if in_count > 0 else 503), body

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            sessions = len(self._sessions)
            counters = {
                "requests": self.requests,
                "retries": self.retries,
                "admission_shed": self.admission_shed,
                "no_backend": self.no_backend,
                "inflight": self._inflight,
            }
        out: Dict[str, Any] = {
            "gateway": True,
            **counters,
            "sessions": sessions,
            "backends_in": self.in_count(),
            "backends": [b.snapshot() for b in self.backends],
            "max_inflight": self.max_inflight,
            "uptime_s": round(time.monotonic() - self._started, 1),
        }
        if self.access is not None:
            out["access_log"] = {"path": self.access.path, "lines": self.access.lines}
        return out


def _safe_json(blob: bytes) -> Dict[str, Any]:
    try:
        out = json.loads(blob)
        return out if isinstance(out, dict) else {}
    except (ValueError, TypeError):
        return {}


def _outcome_of(status: int) -> str:
    """The access-log outcome taxonomy, matched to the backend's own
    (observability/context.py): 503/429 shed, 504 deadline, 404 unknown_id,
    400 bad_request, else error."""
    if status in (HTTP_TOO_MANY_REQUESTS, HTTP_UNAVAILABLE):
        return "shed"
    if status == HTTP_DEADLINE:
        return "deadline"
    if status == 404:
        return "unknown_id"
    if status == 400:
        return "bad_request"
    return "error"


# ---------------------------------------------------------------------------
# HTTP shell
# ---------------------------------------------------------------------------


class _GatewayHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass  # the structured gateway access log carries these lines

    def _reply(self, code: int, headers: Dict[str, str], body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers.items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        gateway: Gateway = self.server.gateway  # type: ignore[attr-defined]
        try:
            if self.path == "/healthz":
                code, body = gateway.healthz()
                self._reply(code, {}, json.dumps(body).encode())
            elif self.path.startswith("/metrics"):
                self._reply(200, {}, json.dumps(gateway.metrics()).encode())
            else:
                self._reply(404, {}, json.dumps(
                    {"error": f"unknown path {self.path}"}).encode())
        except Exception as exc:  # noqa: BLE001 — keep the gateway alive
            self._reply(500, {}, json.dumps(
                {"error": f"gateway error: {exc!r}"}).encode())

    def do_POST(self):  # noqa: N802
        gateway: Gateway = self.server.gateway  # type: ignore[attr-defined]
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length > 0 else b""
            code, headers, resp = gateway.proxy(
                self.path, body, self.headers.get("traceparent")
            )
            self._reply(code, headers, resp)
        except Exception as exc:  # noqa: BLE001 — keep the gateway alive
            self._reply(500, {}, json.dumps(
                {"error": f"gateway error: {exc!r}"}).encode())


def make_gateway_server(
    gateway: Gateway, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral) but do not serve; starts the gateway's
    health poller. The caller owns ``serve_forever``/``shutdown``."""
    server = ThreadingHTTPServer((host, port), _GatewayHandler)
    server.gateway = gateway  # type: ignore[attr-defined]
    server.daemon_threads = True
    gateway.start()
    return server


def run_gateway(
    gateway: Gateway,
    host: str,
    port: int,
    install_signal_handlers: bool = True,
    on_bound=None,
) -> int:
    """Serve until SIGTERM/SIGINT; clean shutdown (poller stopped, logs
    flushed) exits 0. ``on_bound(host, port)`` fires after bind — the
    ephemeral-port discovery hook for drills."""
    import signal

    server = make_gateway_server(gateway, host, port)
    addr = server.server_address

    def _stop(signum, frame):  # noqa: ARG001 — signal contract
        threading.Thread(target=server.shutdown, daemon=True).start()

    if install_signal_handlers:
        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)
    print(
        f"gateway on http://{addr[0]}:{addr[1]} "
        f"({len(gateway.backends)} backend(s): "
        + ", ".join(b.url for b in gateway.backends)
        + ")",
        flush=True,
    )
    if on_bound is not None:
        on_bound(addr[0], addr[1])
    try:
        server.serve_forever()
    finally:
        server.server_close()
        gateway.close()
    return 0
