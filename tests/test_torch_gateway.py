"""The port's fleet front (``serving/gateway.py``) against the JAX
package's, on the CPU: the cases of ``tests/test_gateway_fleet.py``
(membership hysteresis, rendezvous routing and exclusion, draining, retry
with exclusion and session learning, refine affinity, admission 429,
``HttpFrontend``'s outcome mapping, the drain cases and the healthz schema),
each gateway case once per package. Added:

- ``rendezvous_score`` and the gateway's backend choice equal to JAX's over
  a grid of keys, backend counts, memberships and exclusions;
- the three import-light CLIs of the port (``scripts/gateway.py``,
  ``scripts/fleet_serve.py``, ``scripts/rolling_restart.py``, run by path):
  after ``--help`` none of ``torch``, ``numpy`` or ``jax`` is loaded;
- ``scripts/obs_top.py``, run unchanged as a subprocess, renders the frame
  of a live port gateway and of a live port supervisor.
"""

import hashlib
import importlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.serving import gateway as jax_gateway
from howtotrainyourmamlpytorch_tpu_torch import exit_codes
from howtotrainyourmamlpytorch_tpu_torch.observability.slo import HttpFrontend
from howtotrainyourmamlpytorch_tpu_torch.resilience.faults import FaultInjector
from howtotrainyourmamlpytorch_tpu_torch.serving import (
    AdaptationEngine,
    Gateway,
    ServiceUnavailableError,
    ServingFrontend,
    UnknownAdaptationError,
    drain_exit_code,
    make_gateway_server,
)
from howtotrainyourmamlpytorch_tpu_torch.serving import gateway as gateway_mod
from howtotrainyourmamlpytorch_tpu_torch.serving import router as router_mod

from tests.test_torch_serving import episode, port_system, weights  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = os.path.join(REPO, "howtotrainyourmamlpytorch_tpu_torch", "scripts")
PACKAGES = {"jax": "howtotrainyourmamlpytorch_tpu", "torch": "howtotrainyourmamlpytorch_tpu_torch"}


@pytest.fixture(params=sorted(PACKAGES))
def gw(request):
    """One package's gateway module."""
    return importlib.import_module(f"{PACKAGES[request.param]}.serving.gateway")


def test_rendezvous_has_one_implementation():
    """The in-process router and the gateway agree where a session lives:
    the router's rendezvous_score IS the gateway's."""
    assert router_mod.rendezvous_score is gateway_mod.rendezvous_score
    assert gateway_mod.rendezvous_score("digest001", 0) == int.from_bytes(
        hashlib.blake2b(b"digest001|0", digest_size=8).digest(), "big"
    )


def test_traceparent_grammar_in_sync_with_context():
    """The gateway keeps its own copy of the W3C traceparent grammar (it
    must not import the package); it stays the port's ``context.py``'s."""
    from howtotrainyourmamlpytorch_tpu_torch.observability import context

    assert gateway_mod._TRACEPARENT_RE.pattern == context._TRACEPARENT_RE.pattern
    header = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
    trace_id, span_id, parent_id = gateway_mod._parse_traceparent(header)
    ctx = context.parse_traceparent(header)
    assert (trace_id, parent_id) == (ctx.trace_id, ctx.parent_id) and len(span_id) == 16
    assert gateway_mod._parse_traceparent("garbage")[2] is None


@pytest.mark.parametrize("n_backends", [1, 2, 3, 5])
def test_rendezvous_and_backend_choice_match_jax(n_backends):
    keys = [f"k{i:03d}" for i in range(80)] + ["f" * 64, "d1673d2ac57a7b56", ""]
    for key in keys:
        for i in range(n_backends):
            assert gateway_mod.rendezvous_score(key, i) == jax_gateway.rendezvous_score(key, i)
    urls = [f"http://h{i}" for i in range(n_backends)]
    ours, theirs = Gateway(urls), jax_gateway.Gateway(urls)
    try:
        # every membership: each backend IN or OUT
        for mask in range(1 << n_backends):
            for g in (ours, theirs):
                for b in g.backends:
                    up = bool(mask >> b.index & 1)
                    for _ in range(2):
                        g.observe(b, up, "ok" if up else "unreachable")
            for key in keys:
                for exclude in (set(), {0}, {n_backends - 1}):
                    a, b = ours.route(key, exclude=exclude), theirs.route(key, exclude=exclude)
                    assert (a and a.index) == (b and b.index)
    finally:
        ours.close()
        theirs.close()


# ---------------------------------------------------------------------------
# membership hysteresis (pure units, no sockets)
# ---------------------------------------------------------------------------


def test_backend_membership_hysteresis_and_flaps(gw):
    b = gw.Backend(0, "http://x", fail_threshold=2, pass_threshold=2)
    assert not b.is_in  # starts OUT: never seen healthy
    assert b.note_observation(True, "ok") is None  # 1/2 passes
    assert b.note_observation(True, "ok") == "in"
    assert b.is_in and b.flaps == 0  # first admission is not a flap
    assert b.note_observation(False, "unreachable") is None  # one failure is not enough
    assert b.is_in
    assert b.note_observation(True, "ok") is None  # a pass resets the failure streak
    assert b.note_observation(False, "unreachable") is None
    assert b.note_observation(False, "unreachable") == "out"
    assert not b.is_in and b.flaps == 1
    assert b.note_observation(True, "ok") is None
    assert b.note_observation(True, "ok") == "in"
    assert b.flaps == 2
    snap = b.snapshot()
    assert snap["state"] == "in" and snap["flaps"] == 2


def test_gateway_routing_rendezvous_and_exclusion(gw):
    g = gw.Gateway(["http://a", "http://b", "http://c"], pass_threshold=1)
    for backend in g.backends:
        g.observe(backend, True, "ok")
    keys = [f"k{i:03d}" for i in range(120)]
    owners = {k: g.route(k).index for k in keys}
    assert set(owners.values()) == {0, 1, 2}
    assert all(g.route(k).index == owners[k] for k in keys)  # deterministic
    for k in keys:  # exclusion remaps ONLY the excluded backend's keys
        alt = g.route(k, exclude={owners[k]})
        assert alt is not None and alt.index != owners[k]
    other = {k: g.route(k).index for k in keys if owners[k] != 0}
    g.observe(g.backends[0], False, "unreachable")
    g.observe(g.backends[0], False, "unreachable")
    assert not g.backends[0].is_in
    assert all(g.route(k).index == other[k] for k in other)  # no reshuffle
    g.close()


def test_gateway_draining_warming_are_not_routable_new_work(gw):
    g = gw.Gateway(["http://a", "http://b"], pass_threshold=1, fail_threshold=2)
    for backend in g.backends:
        g.observe(backend, True, "ok")
    assert g.in_count() == 2
    for _ in range(2):
        g.observe(g.backends[0], False, "draining")
    assert g.in_count() == 1
    assert g.backends[0].snapshot()["last_status"] == "draining"
    code, body = g.healthz()
    assert code == 200 and body["status"] == "degraded"
    for _ in range(2):
        g.observe(g.backends[1], False, "warming")
    code, body = g.healthz()
    assert code == 503 and body["status"] == "no_backend"
    g.close()


def test_outcome_taxonomy_and_retry_rules_match_jax():
    bodies = [b"", b"{}", json.dumps({"status": "draining"}).encode(), json.dumps({"status": "warming"}).encode(),
              json.dumps({"error": "server draining"}).encode(), json.dumps({"error": "queue full"}).encode()]
    ours, theirs = Gateway(["http://a"]), jax_gateway.Gateway(["http://a"])
    try:
        for status in (400, 404, 409, 429, 500, 502, 503, 504):
            assert gateway_mod._outcome_of(status) == jax_gateway._outcome_of(status)
            for body in bodies:
                assert ours._retryable(status, body) == theirs._retryable(status, body)
    finally:
        ours.close()
        theirs.close()
    assert (gateway_mod.HTTP_TOO_MANY_REQUESTS, gateway_mod.HTTP_UNAVAILABLE, gateway_mod.HTTP_DEADLINE) == (
        exit_codes.HTTP_TOO_MANY_REQUESTS, exit_codes.HTTP_UNAVAILABLE, exit_codes.HTTP_DEADLINE)


# ---------------------------------------------------------------------------
# proxy behavior over real sockets (fake backends)
# ---------------------------------------------------------------------------


class _FakeServe(BaseHTTPRequestHandler):
    """Scriptable fake serve backend: behavior comes from server.script."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def _send(self, code, body, headers=None):
        raw = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(raw)

    def do_GET(self):  # noqa: N802
        self._send(200, {"status": "ok"})

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", 0))
        self.rfile.read(n)
        code, body, headers = self.server.script(self.server.name, self.path)
        if self.server.delay_s:
            time.sleep(self.server.delay_s)
        self._send(code, body, headers)


def _spawn_fake(name, script, delay_s=0.0):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _FakeServe)
    srv.name, srv.script, srv.delay_s = name, script, delay_s
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, payload, headers=None, timeout=10):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers.items())


def test_gateway_retry_with_exclusion_session_learning_and_access_log(gw, tmp_path):
    """A 500 from the routed backend retries against the next-ranked live
    backend; the adapt response teaches the session table; every request
    logs ONE gateway access line with the backend; backend refusals (503
    shed) pass through with Retry-After."""
    calls = {"s0": 0, "s1": 0}

    def script(name, path):
        calls[name] += 1
        if name == "s0":
            return 500, {"error": "boom"}, None
        if path == "/adapt":
            return 200, {"adaptation_id": "aid-9", "cached": False}, None
        return 200, {"probs": [[1.0]]}, None

    s0, u0 = _spawn_fake("s0", script)
    s1, u1 = _spawn_fake("s1", script)
    g = gw.Gateway([u0, u1], health_interval_s=30.0, pass_threshold=1, log_dir=str(tmp_path))
    for backend in g.backends:
        g.observe(backend, True, "ok")
    server = gw.make_gateway_server(g, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        saw_retry = False
        for i in range(8):
            code, body, headers = _post(base + "/adapt", {"x_support": [i], "y_support": [i]})
            assert code == 200
            assert headers["X-Gateway-Backend"] == "b1"  # s0 always 500s
            assert len(headers["X-Request-Id"]) == 32
            if g.metrics()["retries"] > 0:
                saw_retry = True
                break
        assert saw_retry, "no adapt ever routed to the failing backend first"
        s0_calls = calls["s0"]
        code, body, headers = _post(base + "/predict", {"adaptation_id": "aid-9", "x_query": [1]})
        assert code == 200 and headers["X-Gateway-Backend"] == "b1"
        assert calls["s0"] == s0_calls
        s1.script = lambda name, path: (503, {"error": "queue full — shedding"}, {"Retry-After": "7"})
        s0.script = s1.script
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/predict", {"adaptation_id": "aid-9", "x_query": [1]})
        assert err.value.code == 503
        assert err.value.headers["Retry-After"] == "7"
        g.access.close()
        with open(os.path.join(str(tmp_path), "access.jsonl")) as f:
            records = [json.loads(line) for line in f if line.strip()]
        assert all("backend" in r and "trace_id" in r for r in records)
        ok_lines = [r for r in records if r["outcome"] == "ok"]
        assert ok_lines and all(r["backend"] == "b1" for r in ok_lines)
        shed_lines = [r for r in records if r["outcome"] == "shed"]
        assert shed_lines and shed_lines[-1]["status"] == 503
    finally:
        server.shutdown()
        server.server_close()
        g.close()
        for srv in (s0, s1):
            srv.shutdown()
            srv.server_close()


def test_gateway_refine_requests_follow_session_affinity(gw):
    g = gw.Gateway(["http://a", "http://b"], health_interval_s=30.0)
    for backend in g.backends:
        g.observe(backend, True, "ok")
    sid = "sess-42"
    refine_body = json.dumps({"refine": True, "session_id": sid, "x_support": [1], "y_support": [2]}).encode()
    key, preferred = g.affinity_key("/adapt", refine_body)
    assert key == sid and preferred is None  # rendezvous fallback pre-learn
    other_body = json.dumps({"refine": True, "session_id": sid, "x_support": [9, 9], "y_support": [0]}).encode()
    assert g.affinity_key("/adapt", other_body)[0] == sid
    g._learn_from_response("/adapt", json.dumps({"adaptation_id": sid, "refined": True}).encode(), g.backends[1])
    assert g.affinity_key("/adapt", refine_body)[1] is g.backends[1]
    predict_body = json.dumps({"adaptation_id": sid, "x_query": [1]}).encode()
    assert g.affinity_key("/predict", predict_body)[1] is g.backends[1]
    plain_body = json.dumps({"x_support": [1], "y_support": [2]}).encode()
    key, preferred = g.affinity_key("/adapt", plain_body)
    assert key != sid and preferred is None
    g.close()


def test_gateway_admission_control_sheds_429(gw):
    s0, u0 = _spawn_fake("s0", lambda n, p: (200, {"probs": [[1.0]]}, None), delay_s=0.6)
    g = gw.Gateway([u0], health_interval_s=30.0, pass_threshold=1, max_inflight=1)
    g.observe(g.backends[0], True, "ok")
    server = gw.make_gateway_server(g, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    outcomes = []
    lock = threading.Lock()

    def one():
        try:
            code, _, headers = _post(base + "/predict", {"adaptation_id": "a", "x_query": [1]}, timeout=30)
            row = (code, None)
        except urllib.error.HTTPError as exc:
            row = (exc.code, exc.headers.get("Retry-After"))
        with lock:
            outcomes.append(row)

    threads = [threading.Thread(target=one) for _ in range(3)]
    threads[0].start()
    time.sleep(0.15)
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=30)
    try:
        assert not any(t.is_alive() for t in threads)
        codes = sorted(c for c, _ in outcomes)
        assert 200 in codes and 429 in codes, outcomes
        assert all(ra is not None for c, ra in outcomes if c == 429)
        assert g.metrics()["admission_shed"] >= 1
    finally:
        server.shutdown()
        server.server_close()
        g.close()
        s0.shutdown()
        s0.server_close()


def test_cli_scripts_are_import_light():
    """The CLIs run on a gateway-only host: run by path, their ``--help``
    loads none of torch, numpy or jax."""
    probe = (
        "import runpy, sys\n"
        "sys.argv = [sys.argv[1], '--help']\n"
        "try:\n"
        "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert exc.code in (0, None), exc.code\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy', 'jax', 'jaxlib',\n"
        "                                                            'howtotrainyourmamlpytorch_tpu',\n"
        "                                                            'howtotrainyourmamlpytorch_tpu_torch'))\n"
        "print('HEAVY', heavy)\n"
        "assert not heavy, heavy\n"
    )
    for name in ("gateway.py", "fleet_serve.py", "rolling_restart.py"):
        proc = subprocess.run([sys.executable, "-c", probe, os.path.join(PORT_SCRIPTS, name)],
                              cwd=REPO, capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, (name, proc.stdout[-2000:], proc.stderr[-2000:])
        assert "HEAVY []" in proc.stdout and "usage" in proc.stdout.lower()


# ---------------------------------------------------------------------------
# HttpFrontend (loadgen --url): wire -> outcome taxonomy
# ---------------------------------------------------------------------------


def test_http_frontend_outcome_mapping_and_per_backend_counts():
    state = {"mode": "ok"}

    def script(name, path):
        if state["mode"] == "shed":
            return 503, {"error": "shed"}, {"Retry-After": "3"}
        if state["mode"] == "unknown":
            return 404, {"error": "unknown id"}, None
        if path == "/adapt":
            return 200, {"adaptation_id": "aid-1"}, None
        return 200, {"probs": [[0.25, 0.75]]}, None

    srv, url = _spawn_fake("s0", lambda name, path: (
        lambda code, body, headers: (code, body, {**(headers or {}), "X-Gateway-Backend": "b0"}))(
        *script(name, path)))
    frontend = HttpFrontend(url, timeout_s=10)
    try:
        info = frontend.adapt(np.zeros((2, 2)), np.zeros(2, np.int32))
        assert info["adaptation_id"] == "aid-1"
        assert frontend.predict("aid-1", np.zeros((1, 2))).shape == (1, 2)
        state["mode"] = "shed"
        with pytest.raises(ServiceUnavailableError) as err:
            frontend.predict("aid-1", np.zeros((1, 2)))
        assert err.value.status == 503 and err.value.retry_after_s == 3.0
        state["mode"] = "unknown"
        with pytest.raises(UnknownAdaptationError):
            frontend.predict("aid-1", np.zeros((1, 2)))
        counts = frontend.per_backend()["b0"]
        assert counts["ok"] == 2 and counts["shed"] == 1 and counts["unknown_id"] == 1
        assert frontend.breaker.snapshot() == {}  # run_load contract
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# drain semantics + healthz status schema (tiny real engine)
# ---------------------------------------------------------------------------


def _engine(weights, **serving):
    return AdaptationEngine(port_system(**serving), weights[2])


def test_drain_completes_inflight_and_queued_then_refuses(weights):
    """SIGTERM semantics at the unit level: requests in flight (and queued
    behind them) when the drain begins ALL complete; a request arriving
    after the drain starts is refused 503 + Retry-After; healthz flips to
    'draining'."""
    engine = _engine(weights)
    engine.injector = FaultInjector.from_specs(["serving.dispatch=delay:delay_s=0.25,p=1.0"], include_env=False)
    frontend = ServingFrontend(engine)
    try:
        x_s, y_s, x_q = episode(5)
        info = frontend.adapt(x_s, y_s)
        results = []
        lock = threading.Lock()

        def one():
            try:
                row = ("ok", np.asarray(frontend.predict(info["adaptation_id"], x_q)))
            except Exception as exc:  # noqa: BLE001 — the row is the verdict
                row = (type(exc).__name__, None)
            with lock:
                results.append(row)

        threads = [threading.Thread(target=one) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.1)  # in flight: first mid-dispatch, rest queued
        drain_box = {}
        drainer = threading.Thread(target=lambda: drain_box.update(frontend.begin_drain(reason="unit")))
        drainer.start()
        time.sleep(0.05)
        assert frontend.healthz()["status"] == "draining"
        with pytest.raises(ServiceUnavailableError) as err:
            frontend.predict(info["adaptation_id"], x_q)
        assert err.value.status == 503 and err.value.retry_after_s > 0
        for t in threads:
            t.join(timeout=60)
        drainer.join(timeout=60)
        assert [r[0] for r in results] == ["ok", "ok", "ok"], results
        assert drain_box["ok"] is True and drain_box["deadline_exceeded"] is False
        assert drain_exit_code(drain_box) == exit_codes.OK
        assert engine.injector.stats()["serving.dispatch:delay"] >= 2
    finally:
        frontend.close()


def test_drain_deadline_expiry_takes_the_registered_rc(weights):
    engine = _engine(weights)
    engine.injector = FaultInjector.from_specs(["serving.dispatch=delay:delay_s=1.2,p=1.0"], include_env=False)
    frontend = ServingFrontend(engine)
    try:
        x_s, y_s, _ = episode(6)
        box = {}

        def adapt_slow():
            try:
                box["info"] = frontend.adapt(x_s, y_s)
            except Exception as exc:  # noqa: BLE001
                box["error"] = exc

        t = threading.Thread(target=adapt_slow)
        t.start()
        time.sleep(0.2)
        info = frontend.begin_drain(deadline_s=0.2, reason="unit")
        assert info["deadline_exceeded"] is True and info["ok"] is False
        rc = drain_exit_code(info)
        assert rc == exit_codes.DRAIN_DEADLINE == 77
        assert rc not in (exit_codes.OK, exit_codes.WEDGED, exit_codes.PREEMPTED)
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        frontend.close()


def test_healthz_status_schema_pinned(weights):
    """The port's healthz takes three of JAX's four status values: ``ok``,
    ``degraded`` (a dead replica, still routable) and ``draining``. It has
    no ``warming``: with no AOT prewarm (ROADMAP.md A10) a backend serves as
    soon as it binds, and nothing fakes the state."""
    frontend = ServingFrontend(_engine(weights), replicas=2)
    observed = set()
    try:
        observed.add(frontend.healthz()["status"])
        frontend.pool.replicas[0].kill(reason="schema-pin")
        health = frontend.healthz()
        assert health["status"] == "degraded" and health["routable"] == 1
        observed.add(health["status"])
        assert frontend.healthz()["prewarm"] == {"status": "disabled"}
        frontend.begin_drain(reason="schema-pin")
        observed.add(frontend.healthz()["status"])
        assert observed == {"ok", "degraded", "draining"}
    finally:
        frontend.close()


# ---------------------------------------------------------------------------
# obs_top, unchanged, on a live port gateway and a live port supervisor
# ---------------------------------------------------------------------------


def _obs_top(url):
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "obs_top.py"), "--url", url, "--once"],
                          cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_obs_top_renders_the_port_gateway_frame():
    g = Gateway(["http://127.0.0.1:9", "http://127.0.0.1:10"], health_interval_s=30.0, pass_threshold=1)
    g.observe(g.backends[0], True, "ok")
    g.observe(g.backends[1], True, "ok")
    for _ in range(2):
        g.observe(g.backends[1], False, "draining")
    g._stop.set()  # no health poller: membership stays as observed above
    server = make_gateway_server(g, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        rendered = _obs_top(f"http://127.0.0.1:{server.server_address[1]}")
    finally:
        server.shutdown()
        server.server_close()
        g.close()
    assert "b0" in rendered and "IN" in rendered
    assert "b1" in rendered and "OUT" in rendered and "draining" in rendered


def test_obs_top_renders_the_port_supervisor_frame(tmp_path):
    autoscaler = _load_port_autoscaler()
    slots = [{"url": f"http://127.0.0.1:{9100 + i}", "port": 9100 + i,
              "respawn": ["python", "-m", "howtotrainyourmamlpytorch_tpu_torch.serve", "run", "--port",
                          str(9100 + i), "--device", "cpu"]} for i in range(2)]
    sup = autoscaler.Supervisor(
        str(tmp_path / "fleet_state.json"), autoscaler.Policy(min_backends=1, max_backends=2), None,
        events_path=str(tmp_path / "events.jsonl"), spawn=lambda entry, extra: 4_500_000 + entry["slot"],
        probe=lambda url: (200, {"status": "ok"}), pid_alive=lambda pid: True, sleep=lambda s: None,
        log=lambda m: None,
    )
    sup.load_or_init(slots)
    assert sup.tick() == "spawn_retry"  # bootstrap to min_backends
    server, port = autoscaler.run_supervisor_http(sup, "127.0.0.1", 0)
    try:
        rendered = _obs_top(f"http://127.0.0.1:{port}")
    finally:
        server.shutdown()
        server.server_close()
    assert "1/1" in rendered and "min 1 max 2" in rendered
    assert "scale_up" in rendered and "capacity_repair" in rendered


def test_rolling_restart_waits_for_the_gateway_to_admit_the_respawned_backend(monkeypatch):
    """A backend's own /healthz 200 is not the gateway's admission: the
    roll's gate waits until the gateway's /metrics lists the respawned
    backend IN, so the next drain never finds the gateway with no backend
    to route to. Without ``gateway_url`` the gate stays the /healthz one."""
    from howtotrainyourmamlpytorch_tpu_torch.serving import fleetctl

    url = "http://127.0.0.1:9"
    g = Gateway([url, "http://127.0.0.1:10"], health_interval_s=30.0, pass_threshold=1)
    g._stop.set()  # no health poller: membership moves only as observed here
    server = make_gateway_server(g, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    gw_url = f"http://127.0.0.1:{server.server_address[1]}"
    monkeypatch.setattr(fleetctl, "drain_backend", lambda entry, timeout_s, log: {"drain": "sigterm_sent"})
    monkeypatch.setattr(fleetctl, "spawn_backend", lambda entry: type("P", (), {"pid": 4_500_001})())
    monkeypatch.setattr(fleetctl, "wait_healthy", lambda u, timeout_s: True)
    entry = {"url": url, "pid": 4_500_000, "respawn": ["true"]}
    try:
        assert not fleetctl.gateway_admits(gw_url, url)
        row = fleetctl.restart_backend(entry, 1.0, 0.5, gateway_url=gw_url, log=lambda m: None)
        assert not row["ok"] and "did not admit" in row["error"] and row["admit_s"] >= 0.4
        assert fleetctl.restart_backend(entry, 1.0, 0.5, log=lambda m: None)["ok"]  # no gateway: no wait
        admit = threading.Timer(0.3, lambda: g.observe(g.backends[0], True, "ok"))
        admit.start()
        row = fleetctl.restart_backend(entry, 1.0, 30.0, gateway_url=gw_url, log=lambda m: None)
        admit.join()
        assert row["ok"] and 0.2 <= row["admit_s"] < 10.0, row
        assert fleetctl.gateway_admits(gw_url, url + "/")
        assert not fleetctl.gateway_admits(gw_url, "http://127.0.0.1:10")
        assert not fleetctl.gateway_admits("http://127.0.0.1:9", url)  # no gateway there
    finally:
        server.shutdown()
        server.server_close()
        g.close()


def _load_port_autoscaler():
    spec = importlib.util.spec_from_file_location(
        "t_port_autoscaler_gw", os.path.join(REPO, "howtotrainyourmamlpytorch_tpu_torch", "serving", "autoscaler.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_serving_package_exports_the_gateway():
    serving = importlib.import_module("howtotrainyourmamlpytorch_tpu_torch.serving")
    jax_serving = importlib.import_module("howtotrainyourmamlpytorch_tpu.serving")
    for name in ("Gateway", "make_gateway_server", "drain_exit_code"):
        assert hasattr(serving, name) and hasattr(jax_serving, name)
    # the supervisor is loaded by file path only: importing the package
    # never loads it
    assert "howtotrainyourmamlpytorch_tpu_torch.serving.autoscaler" not in sys.modules
