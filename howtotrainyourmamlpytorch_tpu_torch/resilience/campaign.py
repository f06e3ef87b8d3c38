"""The gateway half of the JAX package's chaos campaign
(``resilience/campaign.py``): the cross-process fleet drills, each a REAL
gateway subprocess (``scripts/gateway.py`` of this package) fronting REAL
serve-backend subprocesses (:func:`child_serve_main`, the real
``run_server`` SIGTERM-drain path), driven over the wire, with the
autoscaling supervisor (``scripts/fleet_serve.py``) and the rolling restart
(``scripts/rolling_restart.py``) as subprocesses too:

- ``gateway-kill9-backend``: kill -9 one of two backends mid-flight —
  availability never reaches zero, the displaced session 404s then
  re-adapts to the same predictions, the flap is in the gateway's
  events.jsonl;
- ``gateway-drain-rehydrate``: SIGTERM mid-load — zero dropped in-flight
  requests, rc 0, a spill -> rehydrate round trip proven by a post-restart
  cache hit;
- ``gateway-rolling-restart``: both backends drained and respawned one at a
  time under load, every non-200 resolvable to a gateway access line;
- ``serve-refine-across-drain``: a refined session's lineage survives a
  drain and a kill -9 of the gateway;
- ``fleet-surge``: a slowed backend under surging load makes the supervisor
  spawn the second slot, then drain it back (rc 0);
- ``fleet-crashloop``: a die-on-spawn slot walks the backoff ladder into
  quarantine; a supervisor kill -9'd mid-spawn restarts and settles the
  journaled spawn without a double spawn.

Every backend runs on the ``device`` the caller names, and every respawn
command carries it (``--device``-style: ``cpu`` in the CPU tests, ``cuda``
on the card). The training episodes and :func:`run_campaign` are ROADMAP.md
A9: they raise ``NotImplementedError``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from .. import exit_codes

from ..utils.locks import san_lock

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PACKAGE)
# the import-light CLIs, run by path (the package's __init__ imports torch)
_SCRIPTS = os.path.join(_PACKAGE, "scripts")

@dataclass
class Episode:
    """One chaos episode: its kind and its mode (the JAX package's record,
    cut to what the port runs: the ``gateway`` mode)."""

    kind: str
    mode: str  # train | resume | shrink | grow | serve | gateway


def tiny_serving_system(cfg, device=None):
    """The shrunken 2-stage/4-filter backbone the serving drills load —
    deliberately NOT reconstructible from config alone, which is why
    :func:`child_serve_main` (not the serve CLI) is the drill backend
    entry: it rebuilds the same model the checkpoint was saved from.
    ``device`` defaults to the card."""
    from ..core.maml import MAMLSystem
    from ..models.vgg import build_vgg

    return MAMLSystem(
        cfg,
        model=build_vgg(
            (28, 28, 1), cfg.num_classes_per_set, num_stages=2, cnn_num_filters=4
        ),
        device=device,
    )


def make_serving_run_dir(
    root: str,
    name: str,
    template: Optional[str] = None,
    perturb_seed: Optional[int] = None,
    serving_overrides: Optional[Dict[str, Any]] = None,
) -> str:
    """A toy SERVING run dir a backend subprocess can load: config.yaml +
    an init-state checkpoint (format 2, the JAX layout) + logs/. ``template``
    copies another run dir's config + checkpoint byte-for-byte (same
    fingerprint => the fleet's backends agree about every session's cache
    key — exactly the deployed shape, where every host serves the same
    pushed checkpoint). ``perturb_seed`` deterministically perturbs the init
    params (in the JAX layout and leaf order, through ``utils/interop.py``)
    before saving, so multi-tenant drills get DISTINCT checkpoints that
    share one tree structure. ``serving_overrides`` patches the run's
    ServingConfig (e.g. ``refine_enabled``); with a ``template`` the
    checkpoint is still copied byte-for-byte (same fingerprint), only the
    config is rewritten. The state is built on the CPU: writing a
    checkpoint needs no card. AOT stays off: the port has no prewarm
    (ROADMAP.md A10), so a backend answers /healthz ``ok`` as soon as it
    binds."""
    import shutil

    run_dir = os.path.join(root, name)
    save_dir = os.path.join(run_dir, "saved_models")
    os.makedirs(save_dir, exist_ok=True)
    os.makedirs(os.path.join(run_dir, "logs"), exist_ok=True)
    if template is not None:
        if serving_overrides:
            from ..config import load_config, save_config

            tcfg = load_config(os.path.join(template, "config.yaml"))
            tcfg = dataclasses.replace(
                tcfg,
                serving=dataclasses.replace(tcfg.serving, **serving_overrides),
                experiment_root=root,
                experiment_name=name,
            )
            save_config(tcfg, os.path.join(run_dir, "config.yaml"))
        else:
            shutil.copy(
                os.path.join(template, "config.yaml"),
                os.path.join(run_dir, "config.yaml"),
            )
        shutil.copy(
            os.path.join(template, "saved_models", "train_model_latest"),
            os.path.join(save_dir, "train_model_latest"),
        )
        return run_dir
    from ..config import Config, ServingConfig, save_config
    from ..experiment import checkpoint as ckpt

    cfg = Config(
        num_classes_per_set=5,
        num_samples_per_class=2,
        num_target_samples=3,
        batch_size=2,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
        serving=ServingConfig(
            support_buckets=[16], query_buckets=[16], max_batch_size=2,
            cache_ttl_s=600.0, **(serving_overrides or {}),
        ),
        experiment_root=root,
        experiment_name=name,
    )
    save_config(cfg, os.path.join(run_dir, "config.yaml"))
    system = tiny_serving_system(cfg, device="cpu")
    state = system.init_train_state()
    feature_shape = system.model.feature_shape
    if perturb_seed is not None:
        from ..utils.interop import params_from_jax, params_to_jax
        from ..utils.trees import tree_map

        rng = np.random.default_rng(perturb_seed)

        def _perturb(a):
            if not np.issubdtype(a.dtype, np.floating):
                return a
            return a + (0.01 * rng.standard_normal(a.shape)).astype(a.dtype)

        master = params_to_jax(state.params, feature_shape)
        state = state._replace(
            params=params_from_jax(tree_map(_perturb, master), feature_shape, device="cpu")
        )
    ckpt.save_named(save_dir, state, {"epoch": 0}, "latest", feature_shape=feature_shape)
    return run_dir


def child_serve_main(run_dir: str, port_file: str, port: int = 0, device: str = "cuda") -> int:
    """Backend subprocess entry for the fleet drills: load the toy run dir
    on ``device``, serve it through the REAL ``run_server`` path (SIGTERM =>
    graceful drain => spill => rc), and publish the bound port to
    ``port_file``. Importable (not ``__main__``) so the parent spawns it
    with a one-line ``-c``."""
    from ..config import load_config
    from ..serving.engine import AdaptationEngine
    from ..serving.server import ServingFrontend, run_server

    cfg = load_config(os.path.join(run_dir, "config.yaml"))
    engine = AdaptationEngine.from_run_dir(
        run_dir, "latest", cfg=cfg, system=tiny_serving_system(cfg, device=device)
    )
    frontend = ServingFrontend(
        engine, access_log_dir=os.path.join(run_dir, "logs")
    )

    def _announce(host, bound_port):
        tmp = f"{port_file}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(bound_port))
        os.replace(tmp, port_file)

    return run_server(frontend, "127.0.0.1", port, on_bound=_announce)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_CHILD_SERVE = (
    "import sys;"
    "from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import child_serve_main;"
    "sys.exit(child_serve_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]))"
)


def _child_env() -> Dict[str, str]:
    """The caller's environment with the repository root importable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO_ROOT, env.get("PYTHONPATH")) if p
    )
    return env


def spawn_serve_backend(run_dir: str, port: int = 0, env_extra=None, device: str = "cuda"):
    """Fork one serving backend over ``run_dir`` on ``device``; returns
    (proc, port_file). stdout/stderr land in <run_dir>/serve_stdout.log
    (pipe-fill-proof)."""
    port_file = os.path.join(run_dir, "serve_port")
    try:
        os.remove(port_file)
    except FileNotFoundError:
        pass
    env = _child_env()
    env.update(env_extra or {})
    log_handle = open(os.path.join(run_dir, "serve_stdout.log"), "ab")
    proc = subprocess.Popen(
        backend_spawn_argv(run_dir, port, device),
        cwd=_REPO_ROOT,
        env=env,
        stdout=log_handle,
        stderr=subprocess.STDOUT,
    )
    log_handle.close()  # the child holds its own descriptor
    return proc, port_file


def backend_spawn_argv(run_dir: str, port: int, device: str = "cuda") -> List[str]:
    """The respawn command a rolling restart or the supervisor gets for one
    drill backend (the entry :func:`spawn_serve_backend` forks), with its
    device explicit: every respawn lands where the first spawn did."""
    return [
        sys.executable, "-c", _CHILD_SERVE, run_dir,
        os.path.join(run_dir, "serve_port"), str(port), device,
    ]


def _wait_port_file(port_file: str, proc, timeout_s: float = 240.0) -> int:
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(
                f"backend died (rc {proc.returncode}) before binding"
            )
        if os.path.exists(port_file):
            with open(port_file) as f:
                text = f.read().strip()
            if text:
                return int(text)
        time.sleep(0.1)
    raise RuntimeError(f"no port file {port_file} within {timeout_s}s")


def _http_json(url: str, payload=None, timeout_s: float = 60.0):
    """-> (status, body dict, headers). HTTP errors return their status;
    connection failures raise OSError."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, _loads_or_empty(resp.read()), dict(resp.headers.items())
    except urllib.error.HTTPError as exc:
        return exc.code, _loads_or_empty(exc.read()), dict(exc.headers.items())
    except urllib.error.URLError as exc:
        raise OSError(str(exc.reason)) from exc


def _loads_or_empty(blob: bytes):
    try:
        out = json.loads(blob)
        return out if isinstance(out, dict) else {}
    except ValueError:
        return {}


def _wait_http_ok(url: str, timeout_s: float, proc=None) -> None:
    end = time.monotonic() + timeout_s
    last = None
    while time.monotonic() < end:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"process died (rc {proc.returncode}) warming up")
        try:
            code, _, _ = _http_json(url, timeout_s=5.0)
            last = code
            if code == 200:
                return
        except OSError as exc:
            last = str(exc)
        time.sleep(0.25)
    raise RuntimeError(f"{url} never answered 200 ({last!r}) in {timeout_s}s")


def spawn_gateway(backend_urls: List[str], log_dir: str, **knobs):
    """Fork this package's ``scripts/gateway.py`` over ``backend_urls``;
    returns (proc, base_url)."""
    os.makedirs(log_dir, exist_ok=True)
    port_file = os.path.join(log_dir, "gateway_port")
    try:
        os.remove(port_file)
    except FileNotFoundError:
        pass
    argv = [
        sys.executable, os.path.join(_SCRIPTS, "gateway.py"),
        "--backends", ",".join(backend_urls),
        "--port", "0", "--port-file", port_file, "--log-dir", log_dir,
        "--health-interval-s", str(knobs.get("health_interval_s", 0.25)),
        "--fail-threshold", str(knobs.get("fail_threshold", 2)),
        "--pass-threshold", str(knobs.get("pass_threshold", 1)),
        "--request-timeout-s", str(knobs.get("request_timeout_s", 120.0)),
    ]
    log_handle = open(os.path.join(log_dir, "gateway_stdout.log"), "ab")
    proc = subprocess.Popen(
        argv, cwd=_REPO_ROOT, stdout=log_handle, stderr=subprocess.STDOUT
    )
    log_handle.close()
    port = _wait_port_file(port_file, proc, timeout_s=30.0)
    return proc, f"http://127.0.0.1:{port}"


def _kill_quiet(proc) -> None:
    if proc is None or proc.poll() is not None:
        return
    try:
        proc.kill()
        proc.wait(timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        pass


def _adapt_payload(seed: int):
    from ..data.synthetic import synthetic_batch

    b = synthetic_batch(1, 5, 2, 3, (28, 28, 1), seed=seed)
    return (
        {"x_support": b["x_support"][0].tolist(),
         "y_support": b["y_support"][0].tolist()},
        b["x_target"][0].reshape((-1, 28, 28, 1)).tolist(),
    )


def _run_gateway_episode(
    ep: Episode, work_dir: Optional[str] = None, template_run: Optional[str] = None,
    device: str = "cuda",
) -> List[str]:
    """One cross-process fleet drill: a REAL gateway subprocess fronting
    REAL serve-backend subprocesses on ``device``, driven over the wire.
    Returns violations (empty = green). ``template_run`` (a previously
    built run dir) lets the tests share one checkpoint across drills. An
    episode of another mode (a training or in-process serve episode) is
    ROADMAP.md A9 and raises."""
    import tempfile

    if ep.mode != "gateway":
        raise NotImplementedError(
            f"chaos episode {ep.kind!r} (mode {ep.mode!r}) is not ported to PyTorch yet "
            "(ROADMAP.md A9); the port runs the gateway drills only"
        )
    violations: List[str] = []
    root = tempfile.mkdtemp(prefix=f"chaos_{ep.kind.replace('-', '_')}_",
                            dir=work_dir)
    procs: List[Any] = []
    try:
        if ep.kind == "gateway-kill9-backend":
            violations += _drill_kill9(root, template_run, procs, device)
        elif ep.kind == "gateway-drain-rehydrate":
            violations += _drill_drain_rehydrate(root, template_run, procs, device)
        elif ep.kind == "gateway-rolling-restart":
            violations += _drill_rolling_restart(root, template_run, procs, device)
        elif ep.kind == "serve-refine-across-drain":
            violations += _drill_refine_across_drain(root, template_run, procs, device)
        elif ep.kind == "fleet-surge":
            violations += _drill_fleet_surge(root, template_run, procs, device)
        elif ep.kind == "fleet-crashloop":
            violations += _drill_fleet_crashloop(root, template_run, procs, device)
        else:
            violations.append(f"unknown gateway episode kind {ep.kind!r}")
    except Exception as exc:  # noqa: BLE001 — a drill crash is the finding
        violations.append(f"{ep.kind} drill crashed: {type(exc).__name__}: {exc}")
    finally:
        for proc in procs:
            _kill_quiet(proc)
    return violations


def _spawn_fleet(root: str, template_run: Optional[str], procs: List[Any], n: int, device: str):
    """n backends (fixed ports, warm) + one gateway; returns
    (run_dirs, ports, backend_procs, gateway_proc, gateway_url, log_dir)."""
    template = template_run or make_serving_run_dir(root, "template")
    run_dirs, ports, backend_procs = [], [], []
    for i in range(n):
        run_dir = make_serving_run_dir(root, f"b{i}", template=template)
        port = _free_port()
        proc, port_file = spawn_serve_backend(run_dir, port=port, device=device)
        procs.append(proc)
        run_dirs.append(run_dir)
        ports.append(port)
        backend_procs.append(proc)
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    for url, proc in zip(urls, backend_procs):
        # /healthz 200 before the drill clock (the port has no warming state)
        _wait_http_ok(url + "/healthz", timeout_s=300.0, proc=proc)
    gw_log_dir = os.path.join(root, "gateway", "logs")
    gw_proc, gw_url = spawn_gateway(urls, gw_log_dir)
    procs.append(gw_proc)
    _wait_http_ok(gw_url + "/healthz", timeout_s=30.0, proc=gw_proc)
    return run_dirs, ports, backend_procs, gw_proc, gw_url, gw_log_dir


def _drill_kill9(root, template_run, procs, device) -> List[str]:
    """kill -9 one backend mid-flight: the gateway routes around it within
    the hysteresis window (availability never reaches zero), the displaced
    session re-adapts — NEVER a stale answer — and the membership flap is
    events-resolvable."""
    violations: List[str] = []
    run_dirs, ports, backends, gw_proc, gw_url, gw_logs = _spawn_fleet(
        root, template_run, procs, n=2, device=device
    )
    support, query = _adapt_payload(31)
    code, body, headers = _http_json(gw_url + "/adapt", support)
    if code != 200:
        return [f"warm adapt failed: {code} {body}"]
    aid = body["adaptation_id"]
    owner = headers.get("X-Gateway-Backend")  # "b0" / "b1"
    code, body, _ = _http_json(
        gw_url + "/predict", {"adaptation_id": aid, "x_query": query}
    )
    if code != 200:
        return [f"warm predict failed: {code} {body}"]
    probs_before = body["probs"]
    owner_idx = int(owner[1:])
    os.kill(backends[owner_idx].pid, 9)  # SIGKILL: no drain, no goodbye
    # drive load THROUGH the kill: fresh adapts must keep succeeding (the
    # gateway retries connection failures against the survivor), so
    # availability never reaches zero
    ok = fail = 0
    deadline = time.monotonic() + 20.0
    seed = 100
    while time.monotonic() < deadline:
        s, _ = _adapt_payload(seed)
        seed += 1
        try:
            code, _, _ = _http_json(gw_url + "/adapt", s, timeout_s=30.0)
        except OSError:
            code = None
        if code == 200:
            ok += 1
        else:
            fail += 1
        if ok >= 6:
            break
        time.sleep(0.2)
    if ok < 6:
        violations.append(
            f"availability lost after kill -9: {ok} ok / {fail} failed"
        )
    # the displaced session must NOT be served stale: predict resolves 404
    # (the survivor never adapted it), then a re-adapt + predict must be
    # bit-identical to the pre-kill answer
    code = None
    for _ in range(20):
        try:
            code, body, _ = _http_json(
                gw_url + "/predict", {"adaptation_id": aid, "x_query": query},
                timeout_s=30.0,
            )
        except OSError:
            code = None
        if code in (200, 404):
            break
        time.sleep(0.3)
    if code == 200:
        violations.append(
            "displaced session predict returned 200 without re-adapt — "
            "possible stale/wrong answer after backend death"
        )
    elif code != 404:
        violations.append(f"displaced predict never resolved (last {code})")
    code, body, headers = _http_json(gw_url + "/adapt", support, timeout_s=60.0)
    if code != 200:
        violations.append(f"re-adapt failed: {code}")
    else:
        if headers.get("X-Gateway-Backend") == owner:
            violations.append("re-adapt routed to the killed backend")
        code, body, _ = _http_json(
            gw_url + "/predict", {"adaptation_id": aid, "x_query": query},
            timeout_s=60.0,
        )
        if code != 200 or body.get("probs") != probs_before:
            violations.append(
                "post-failover predictions differ from the healthy fleet's"
            )
    # membership: the dead backend is OUT and the flap is events-resolvable
    code, metrics, _ = _http_json(gw_url + "/metrics", timeout_s=30.0)
    rows = {b["backend"]: b for b in metrics.get("backends", [])}
    if rows.get(owner, {}).get("in") is not False:
        violations.append(f"dead backend {owner} still IN: {rows.get(owner)}")
    events_path = os.path.join(gw_logs, "events.jsonl")
    flaps = []
    if os.path.exists(events_path):
        with open(events_path) as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    if rec.get("event") == "backend_out":
                        flaps.append(rec.get("backend"))
    if owner not in flaps:
        violations.append(
            f"backend_out event for {owner} missing from gateway events.jsonl"
        )
    return violations


def _drill_drain_rehydrate(root, template_run, procs, device) -> List[str]:
    """SIGTERM mid-load: zero dropped in-flight requests, clean rc 0, and a
    digest-verified spill -> rehydrate round-trip proven by a post-restart
    predict WITHOUT re-adapt (the session survived the restart)."""
    violations: List[str] = []
    template = template_run or make_serving_run_dir(root, "template")
    run_dir = make_serving_run_dir(root, "b0", template=template)
    port = _free_port()
    # injected 0.5s dispatch delay: requests are genuinely in flight when
    # the SIGTERM lands, so "zero dropped" is actually exercised
    env = {"HTYMP_FAULTS": "serving.dispatch=delay:delay_s=0.5,p=1.0"}
    proc, _ = spawn_serve_backend(run_dir, port=port, env_extra=env, device=device)
    procs.append(proc)
    url = f"http://127.0.0.1:{port}"
    _wait_http_ok(url + "/healthz", timeout_s=300.0, proc=proc)
    gw_logs = os.path.join(root, "gateway", "logs")
    gw_proc, gw_url = spawn_gateway([url], gw_logs)
    procs.append(gw_proc)
    _wait_http_ok(gw_url + "/healthz", timeout_s=30.0, proc=gw_proc)
    support, query = _adapt_payload(47)
    code, body, _ = _http_json(gw_url + "/adapt", support, timeout_s=60.0)
    if code != 200:
        return [f"warm adapt failed: {code} {body}"]
    aid = body["adaptation_id"]
    code, body, _ = _http_json(
        gw_url + "/predict", {"adaptation_id": aid, "x_query": query},
        timeout_s=60.0,
    )
    if code != 200:
        return [f"warm predict failed: {code}"]
    probs_before = body["probs"]
    # in-flight load: 3 concurrent predicts (0.5s dispatch each, serialized
    # by the worker) — then SIGTERM lands mid-flight
    results: List[Any] = []
    lock = san_lock("campaign._drill_drain_rehydrate.lock")

    def one_predict():
        try:
            c, b, _ = _http_json(
                gw_url + "/predict", {"adaptation_id": aid, "x_query": query},
                timeout_s=90.0,
            )
        except OSError as exc:
            c, b = None, {"error": str(exc)}
        with lock:
            results.append((c, b))

    threads = [threading.Thread(target=one_predict) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.3)  # let them reach the backend and queue/dispatch
    proc.send_signal(15)  # SIGTERM: graceful drain
    # a NEW request during the drain must be refused with Retry-After,
    # never silently dropped (single-backend fleet: the gateway has
    # nowhere to retry it)
    try:
        code, _, headers = _http_json(
            gw_url + "/predict", {"adaptation_id": aid, "x_query": query},
            timeout_s=60.0,
        )
        if code == 200:
            pass  # raced ahead of the drain flag — legitimate
        elif code in (
            exit_codes.HTTP_UNAVAILABLE, exit_codes.HTTP_TOO_MANY_REQUESTS
        ):
            if "Retry-After" not in headers:
                violations.append(f"drain-window {code} without Retry-After")
        else:
            violations.append(f"drain-window request got undocumented {code}")
    except OSError:
        violations.append("drain-window request got a dropped connection")
    for t in threads:
        t.join(timeout=120)
    dropped = [r for r in results if r[0] != 200]
    if len(results) != 3 or dropped:
        violations.append(
            f"in-flight requests dropped by drain: {results}"
        )
    try:
        rc = proc.wait(timeout=90)
    except subprocess.TimeoutExpired:
        violations.append("drained backend never exited")
        return violations
    if rc != 0:
        violations.append(f"clean drain exited rc {rc} (want 0)")
    sessions_dir = os.path.join(run_dir, "saved_models", "sessions")
    spilled = (
        [n for n in os.listdir(sessions_dir) if n.startswith("session_")]
        if os.path.isdir(sessions_dir)
        else []
    )
    if not spilled:
        violations.append("drain spilled no sessions")
    # respawn the SAME run dir on the SAME port: the replica must rehydrate
    # and serve the old session without a re-adapt
    proc2, _ = spawn_serve_backend(run_dir, port=port, device=device)
    procs.append(proc2)
    _wait_http_ok(url + "/healthz", timeout_s=300.0, proc=proc2)
    # wait for the gateway to readmit it
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        code, m, _ = _http_json(gw_url + "/metrics", timeout_s=10.0)
        if m.get("backends_in") == 1:
            break
        time.sleep(0.3)
    code, body, _ = _http_json(
        gw_url + "/predict", {"adaptation_id": aid, "x_query": query},
        timeout_s=90.0,
    )
    if code != 200:
        violations.append(
            f"post-restart predict for the spilled session failed: {code} "
            "(rehydration lost the session)"
        )
    elif body.get("probs") != probs_before:
        violations.append("rehydrated session served DIFFERENT predictions")
    code, metrics, _ = _http_json(url + "/metrics", timeout_s=30.0)
    sessions = metrics.get("sessions") or {}
    if int(sessions.get("rehydrated", 0)) < 1:
        violations.append(f"backend reports no rehydrated sessions: {sessions}")
    cache = metrics.get("cache") or {}
    if int(cache.get("hits", 0)) < 1:
        violations.append(f"rehydrated predict was not a cache hit: {cache}")
    return violations


def _drill_rolling_restart(root, template_run, procs, device) -> List[str]:
    """Full rolling restart under load via scripts/rolling_restart.py: both
    backends drained + respawned warm one at a time, the fleet never
    refuses all traffic, and every non-200 the client saw resolves to a
    gateway access line by request id."""
    violations: List[str] = []
    run_dirs, ports, backends, gw_proc, gw_url, gw_logs = _spawn_fleet(
        root, template_run, procs, n=2, device=device
    )
    # background client: steady adapt/predict mix; record every outcome
    stop = threading.Event()
    outcomes: List[Any] = []
    lock = san_lock("campaign._drill_rolling_restart.lock")

    def drive():
        seed = 500
        aid = None
        while not stop.is_set():
            try:
                if aid is None or seed % 3 == 0:
                    s, q = _adapt_payload(seed % 40)
                    c, b, h = _http_json(gw_url + "/adapt", s, timeout_s=60.0)
                    if c == 200:
                        aid = b.get("adaptation_id")
                else:
                    _, q = _adapt_payload(seed % 40)
                    c, b, h = _http_json(
                        gw_url + "/predict",
                        {"adaptation_id": aid, "x_query": q},
                        timeout_s=60.0,
                    )
                    if c == 404:
                        aid = None  # displaced session: re-adapt next turn
                rid = h.get("X-Request-Id")
            except OSError as exc:
                c, rid = None, None
            with lock:
                outcomes.append((c, rid))
            seed += 1
            stop.wait(0.15)

    client = threading.Thread(target=drive, daemon=True)
    client.start()
    time.sleep(1.0)
    # reap each original backend the moment its drain exits: without this
    # they linger as zombies of THIS process and rolling_restart's
    # pid-liveness probe (os.kill(pid, 0)) would never see them die
    for proc in backends:
        threading.Thread(target=proc.wait, daemon=True).start()
    fleet_spec = [
        {
            "url": f"http://127.0.0.1:{port}",
            "pid": proc.pid,
            "respawn": backend_spawn_argv(run_dir, port, device),
            "cwd": _REPO_ROOT,
            "log": os.path.join(run_dir, "serve_stdout.log"),
        }
        for run_dir, port, proc in zip(run_dirs, ports, backends)
    ]
    fleet_path = os.path.join(root, "fleet.json")
    with open(fleet_path, "w") as f:
        json.dump(fleet_spec, f)
    roll = subprocess.run(
        [
            sys.executable, os.path.join(_SCRIPTS, "rolling_restart.py"),
            "--fleet", fleet_path, "--drain-timeout-s", "90",
            "--warm-timeout-s", "300",
        ],
        cwd=_REPO_ROOT,
        env=_child_env(),
        capture_output=True,
        text=True,
        timeout=900,
    )
    time.sleep(1.0)
    stop.set()
    client.join(timeout=120)
    verdict = None
    for line in reversed(roll.stdout.strip().splitlines()):
        try:
            parsed = json.loads(line)
        except ValueError:
            continue
        if parsed.get("rolling_restart"):
            verdict = parsed
            break
    if roll.returncode != 0 or verdict is None or not verdict.get("ok"):
        violations.append(
            f"rolling restart failed: rc {roll.returncode} verdict {verdict} "
            f"stderr tail: {roll.stderr[-500:]}"
        )
    else:
        # the respawned pids are tracked for cleanup
        for row in verdict["rows"]:
            procs.append(_FakeProc(row.get("new_pid")))
    with lock:
        seen = list(outcomes)
    oks = sum(1 for c, _ in seen if c == 200)
    conn_drops = sum(1 for c, _ in seen if c is None)
    if oks < 5:
        violations.append(f"fleet served only {oks} oks through the roll: {seen}")
    if conn_drops:
        violations.append(
            f"{conn_drops} dropped connections during the roll (gateway must "
            "absorb backend restarts)"
        )
    # every non-200 the client saw resolves to a gateway access line
    access_path = os.path.join(gw_logs, "access.jsonl")
    logged = set()
    if os.path.exists(access_path):
        with open(access_path) as f:
            for line in f:
                if line.strip():
                    try:
                        logged.add(json.loads(line).get("trace_id"))
                    except ValueError:
                        pass
    for c, rid in seen:
        if c is not None and c != 200:
            if rid is None:
                violations.append(f"non-200 ({c}) without X-Request-Id")
            elif rid not in logged:
                violations.append(
                    f"non-200 ({c}) request {rid} has no gateway access line"
                )
    return violations


def _drill_refine_across_drain(root, template_run, procs, device) -> List[str]:
    """Long-lived refined session across process deaths: adapt -> refine
    (lineage committed) -> SIGTERM drain (spill carries the lineage) ->
    respawn (rehydrate) -> predict bit-identical WITHOUT re-adapt and the
    next refine CONTINUES the lineage (refine_count 2, never a reset) ->
    kill -9 the gateway and front the same backend with a fresh one ->
    session still bit-identical and still refining (lineage lives with the
    session, not the gateway)."""
    violations: List[str] = []
    template = template_run or make_serving_run_dir(root, "template")
    # same checkpoint bytes as the fleet template (same fingerprint), but
    # the run's OWN config turns the stateful-session path on
    run_dir = make_serving_run_dir(
        root, "b0", template=template,
        serving_overrides={"refine_enabled": True},
    )
    port = _free_port()
    proc, _ = spawn_serve_backend(run_dir, port=port, device=device)
    procs.append(proc)
    url = f"http://127.0.0.1:{port}"
    _wait_http_ok(url + "/healthz", timeout_s=300.0, proc=proc)
    gw_logs = os.path.join(root, "gateway", "logs")
    gw_proc, gw_url = spawn_gateway([url], gw_logs)
    procs.append(gw_proc)
    _wait_http_ok(gw_url + "/healthz", timeout_s=30.0, proc=gw_proc)
    support, query = _adapt_payload(53)
    code, body, _ = _http_json(gw_url + "/adapt", support, timeout_s=60.0)
    if code != 200:
        return [f"warm adapt failed: {code} {body}"]
    sid = body["adaptation_id"]
    refine_body = {**support, "refine": True, "session_id": sid}
    code, body, _ = _http_json(gw_url + "/adapt", refine_body, timeout_s=60.0)
    if code != 200 or not body.get("refined") or body.get("rolled_back"):
        return [f"warm refine failed: {code} {body}"]
    if body.get("refine_count") != 1:
        violations.append(f"first refine count != 1: {body}")
    code, body, _ = _http_json(
        gw_url + "/predict", {"adaptation_id": sid, "x_query": query},
        timeout_s=60.0,
    )
    if code != 200:
        return [f"warm predict failed: {code}"]
    probs_refined = body["probs"]
    # SIGTERM: graceful drain must spill the session WITH its lineage
    proc.send_signal(15)
    try:
        rc = proc.wait(timeout=90)
    except subprocess.TimeoutExpired:
        return violations + ["drained backend never exited"]
    if rc != 0:
        violations.append(f"clean drain exited rc {rc} (want 0)")
    # respawn the SAME run dir on the SAME port: rehydration must restore
    # the refined weights AND the lineage
    proc2, _ = spawn_serve_backend(run_dir, port=port, device=device)
    procs.append(proc2)
    _wait_http_ok(url + "/healthz", timeout_s=300.0, proc=proc2)
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        code, m, _ = _http_json(gw_url + "/metrics", timeout_s=10.0)
        if m.get("backends_in") == 1:
            break
        time.sleep(0.3)
    code, body, _ = _http_json(
        gw_url + "/predict", {"adaptation_id": sid, "x_query": query},
        timeout_s=90.0,
    )
    if code != 200:
        violations.append(
            f"post-drain predict for the refined session failed: {code} "
            "(rehydration lost the session)"
        )
    elif body.get("probs") != probs_refined:
        violations.append(
            "rehydrated session served predictions differing from its "
            "refined weights — the refinement was lost in the spill"
        )
    code, body, _ = _http_json(gw_url + "/adapt", refine_body, timeout_s=90.0)
    if code != 200 or body.get("rolled_back"):
        violations.append(f"post-drain refine failed: {code} {body}")
    elif body.get("refine_count") != 2:
        violations.append(
            f"post-drain refine did not CONTINUE the lineage "
            f"(refine_count {body.get('refine_count')}, want 2) — the "
            "spill dropped the session's history"
        )
    code, metrics, _ = _http_json(url + "/metrics", timeout_s=30.0)
    sessions = metrics.get("sessions") or {}
    if int(sessions.get("rehydrated", 0)) < 1:
        violations.append(f"backend reports no rehydrated sessions: {sessions}")
    refine_stats = sessions.get("refine") or {}
    if int(refine_stats.get("active_lineages", 0)) < 1:
        violations.append(
            f"no active lineage after rehydrate: {refine_stats}"
        )
    probs_after_refine2 = None
    code, body, _ = _http_json(
        gw_url + "/predict", {"adaptation_id": sid, "x_query": query},
        timeout_s=60.0,
    )
    if code == 200:
        probs_after_refine2 = body["probs"]
    # kill -9 the GATEWAY: the session and its lineage live with the
    # backend, so a fresh gateway over the same backend must serve the
    # session bit-identically and keep refining it
    os.kill(gw_proc.pid, 9)
    gw_proc2, gw_url2 = spawn_gateway([url], os.path.join(root, "gateway2", "logs"))
    procs.append(gw_proc2)
    _wait_http_ok(gw_url2 + "/healthz", timeout_s=30.0, proc=gw_proc2)
    code, body, _ = _http_json(
        gw_url2 + "/predict", {"adaptation_id": sid, "x_query": query},
        timeout_s=90.0,
    )
    if code != 200:
        violations.append(
            f"post-gateway-kill predict failed through the new gateway: {code}"
        )
    elif probs_after_refine2 is not None and body.get("probs") != probs_after_refine2:
        violations.append(
            "predictions changed across the gateway failover — the session "
            "was silently reset or displaced"
        )
    code, body, _ = _http_json(gw_url2 + "/adapt", refine_body, timeout_s=90.0)
    if code != 200 or body.get("refine_count") != 3:
        violations.append(
            f"refine through the new gateway did not continue the lineage: "
            f"{code} {body}"
        )
    return violations


# ---------------------------------------------------------------------------
# fleet supervisor drills
# ---------------------------------------------------------------------------


def _spawn_fleet_supervisor(
    root, name, state_path, gw_url, events_path, procs,
    slots_path=None, **knobs
):
    """Fork this package's ``scripts/fleet_serve.py``; returns (proc,
    metrics_base_url)."""
    port_file = os.path.join(root, f"{name}_port")
    try:
        os.remove(port_file)
    except FileNotFoundError:
        pass
    argv = [
        sys.executable, os.path.join(_SCRIPTS, "fleet_serve.py"),
        "--state", state_path, "--gateway-url", gw_url,
        "--events", events_path, "--metrics-port", "0",
        "--port-file", port_file,
    ]
    if slots_path:
        argv += ["--slots", slots_path]
    for knob, val in knobs.items():
        argv += ["--" + knob.replace("_", "-"), str(val)]
    log_handle = open(os.path.join(root, f"{name}_stdout.log"), "ab")
    proc = subprocess.Popen(
        argv, cwd=_REPO_ROOT, env=_child_env(),
        stdout=log_handle, stderr=subprocess.STDOUT,
    )
    log_handle.close()
    procs.append(proc)
    port = _wait_port_file(port_file, proc, timeout_s=60.0)
    return proc, f"http://127.0.0.1:{port}"


def _read_jsonl(path):
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    return out


def _read_fleet_state(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _wait_until(fn, timeout_s, desc, poll_s=0.2):
    """Poll ``fn`` until it returns truthy; raise RuntimeError on timeout."""
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        val = fn()
        if val:
            return val
        time.sleep(poll_s)
    raise RuntimeError(f"timeout waiting for {desc}")


def _stop_supervisor(sup_proc, violations, label):
    """SIGTERM stops the control loop ONLY (rc 0, backends untouched)."""
    if sup_proc.poll() is not None:
        violations.append(
            f"{label} supervisor exited early (rc {sup_proc.returncode})"
        )
        return
    sup_proc.send_signal(15)
    try:
        rc = sup_proc.wait(timeout=120)
        if rc != 0:
            violations.append(f"{label} supervisor SIGTERM rc {rc} (want 0)")
    except subprocess.TimeoutExpired:
        violations.append(f"{label} supervisor never exited on SIGTERM")


def _adopt_state_pids(state_path, procs):
    """Track every pid the supervisor journaled so cleanup reaps them."""
    state = _read_fleet_state(state_path) or {}
    for slot in state.get("slots") or []:
        if slot.get("pid"):
            procs.append(_FakeProc(slot["pid"]))


def _drill_fleet_surge(root, template_run, procs, device) -> List[str]:
    """Traffic-adaptive autoscaling end to end: a slowed backend under
    surging load breaches the queue signal -> the supervisor spawns the
    pre-provisioned second slot (healthz-gated, gateway admits it) -> load
    stops -> consecutive clear polls scale back down via a graceful drain
    (rc 0 observed + reported). Zero dropped connections across the whole
    cycle and a refined session's lineage survives it intact."""
    violations: List[str] = []
    template = template_run or make_serving_run_dir(root, "template")
    run0 = make_serving_run_dir(
        root, "b0", template=template,
        serving_overrides={"refine_enabled": True},
    )
    run1 = make_serving_run_dir(
        root, "b1", template=template,
        serving_overrides={"refine_enabled": True},
    )
    port0, port1 = _free_port(), _free_port()
    url0 = f"http://127.0.0.1:{port0}"
    url1 = f"http://127.0.0.1:{port1}"
    # slot 0: a real backend slowed by an injected 0.4s dispatch delay, so
    # concurrent load genuinely queues (the scale-up trigger). The
    # supervisor-spawned slot 1 inherits the supervisor's clean env — the
    # added capacity is FAST, which is the point of scaling up.
    env = {"HTYMP_FAULTS": "serving.dispatch=delay:delay_s=0.4,p=1.0"}
    proc0, _ = spawn_serve_backend(run0, port=port0, env_extra=env, device=device)
    procs.append(proc0)
    _wait_http_ok(url0 + "/healthz", timeout_s=300.0, proc=proc0)
    # reap on exit so a supervisor drain's pid-liveness probe sees death
    threading.Thread(target=proc0.wait, daemon=True).start()
    gw_logs = os.path.join(root, "gateway", "logs")
    # BOTH slot urls are pre-registered: the gateway's backend list is
    # static; the un-spawned slot simply stays OUT until the supervisor
    # fills it
    gw_proc, gw_url = spawn_gateway([url0, url1], gw_logs)
    procs.append(gw_proc)
    _wait_http_ok(gw_url + "/healthz", timeout_s=30.0, proc=gw_proc)
    # a refined session whose lineage must ride out the whole cycle (seed 53:
    # a support set whose refinement COMMITS under the score guard — the
    # same payload the across-drain drill proves to refine_count 3)
    support, query = _adapt_payload(53)
    code, body, _ = _http_json(gw_url + "/adapt", support, timeout_s=60.0)
    if code != 200:
        return [f"warm adapt failed: {code} {body}"]
    sid = body["adaptation_id"]
    refine_body = {**support, "refine": True, "session_id": sid}
    code, body, _ = _http_json(gw_url + "/adapt", refine_body, timeout_s=60.0)
    if code != 200 or body.get("refine_count") != 1:
        return [f"warm refine failed: {code} {body}"]
    code, body, _ = _http_json(
        gw_url + "/predict", {"adaptation_id": sid, "x_query": query},
        timeout_s=60.0,
    )
    if code != 200:
        return [f"warm predict failed: {code}"]
    probs_refined = body["probs"]

    slots = [
        {"url": url0, "port": port0, "pid": proc0.pid,
         "respawn": backend_spawn_argv(run0, port0, device), "cwd": _REPO_ROOT,
         "log": os.path.join(run0, "serve_stdout.log"), "run_dir": run0},
        {"url": url1, "port": port1,
         "respawn": backend_spawn_argv(run1, port1, device), "cwd": _REPO_ROOT,
         "log": os.path.join(run1, "serve_stdout.log"), "run_dir": run1},
    ]
    slots_path = os.path.join(root, "slots.json")
    with open(slots_path, "w") as f:
        json.dump(slots, f)
    state_path = os.path.join(root, "fleet_state.json")
    events_path = os.path.join(root, "supervisor_events.jsonl")
    sup_proc, sup_url = _spawn_fleet_supervisor(
        root, "supervisor", state_path, gw_url, events_path, procs,
        slots_path=slots_path,
        min_backends=1, max_backends=2, poll_interval_s=0.3,
        up_polls=2, down_polls=4, cooldown_up_s=1.0, cooldown_down_s=2.0,
        queue_high=2.0, queue_low=1.0, warm_timeout_s=300.0,
        warm_poll_s=0.25, drain_timeout_s=90.0,
    )
    try:
        code, sup_metrics, _ = _http_json(sup_url + "/metrics", timeout_s=10.0)
        if code != 200 or not sup_metrics.get("supervisor"):
            violations.append(f"supervisor /metrics broken: {code} {sup_metrics}")
        # surge: concurrent predict streams against the 0.4s-dispatch
        # backend — the batcher queue climbs past queue_high
        stop = threading.Event()
        outcomes: List[Any] = []
        lock = san_lock("campaign._drill_fleet_surge.lock")

        def drive(seed0):
            seed = seed0
            aid = None
            while not stop.is_set():
                try:
                    if aid is None:
                        s, _ = _adapt_payload(seed % 40)
                        c, b, _h = _http_json(gw_url + "/adapt", s,
                                              timeout_s=60.0)
                        if c == 200:
                            aid = b.get("adaptation_id")
                    else:
                        _, q = _adapt_payload(seed % 40)
                        c, b, _h = _http_json(
                            gw_url + "/predict",
                            {"adaptation_id": aid, "x_query": q},
                            timeout_s=60.0,
                        )
                        if c == 404:
                            aid = None  # displaced by membership change
                except OSError:
                    c = None
                with lock:
                    outcomes.append(c)
                seed += 1

        clients = [
            threading.Thread(target=drive, args=(1000 * (i + 1),), daemon=True)
            for i in range(6)
        ]
        for t in clients:
            t.start()
        # scale-up: the supervisor must spawn slot 1 and the gateway must
        # admit it (healthz-gated). With no "warming" state (the port has
        # no AOT prewarm, ROADMAP.md A10) the gateway's poller can admit
        # the new backend a poll before the supervisor's warm gate settles
        # and journals it, so the wait takes both
        try:
            _wait_until(
                lambda: _http_json(gw_url + "/metrics", timeout_s=10.0)[1]
                .get("backends_in") == 2
                and any(e.get("event") == "scale_up" for e in _read_jsonl(events_path)),
                timeout_s=300.0, desc="scale-up to 2 backends",
            )
        except RuntimeError as exc:
            violations.append(f"surge never scaled up: {exc}")
        up_events = [e for e in _read_jsonl(events_path)
                     if e.get("event") == "scale_up"]
        if not up_events:
            violations.append("no scale_up event in supervisor events.jsonl")
        elif up_events[0].get("outcome") != "up" or not up_events[0].get("reason"):
            violations.append(f"malformed scale_up event: {up_events[0]}")
        # SLO recovery: with doubled capacity the fleet keeps answering —
        # collect a post-scale-up window, then stop the surge
        time.sleep(2.0)
        with lock:
            n_at_scaleup = len(outcomes)
        _wait_until(
            lambda: len(outcomes) >= n_at_scaleup + 8,
            timeout_s=120.0, desc="post-scale-up traffic window",
        )
        stop.set()
        for t in clients:
            t.join(timeout=90)
        with lock:
            seen = list(outcomes)
        oks = sum(1 for c in seen if c == 200)
        drops = sum(1 for c in seen if c is None)
        if drops:
            violations.append(
                f"{drops} dropped connections during the surge cycle "
                f"(of {len(seen)})"
            )
        if oks < 10:
            violations.append(f"only {oks} 200s through the surge: {seen}")
        # scale-down: clear polls -> graceful drain of the added backend,
        # never below min_backends
        try:
            _wait_until(
                lambda: any(e.get("event") == "scale_down"
                            for e in _read_jsonl(events_path)),
                timeout_s=120.0, desc="scale-down drain",
            )
        except RuntimeError as exc:
            violations.append(f"never scaled back down: {exc}")
        else:
            (down,) = [e for e in _read_jsonl(events_path)
                       if e.get("event") == "scale_down"][:1]
            if down.get("slot") != 1:
                violations.append(f"scale-down drained the wrong slot: {down}")
            if down.get("drain_rc") != 0:
                violations.append(
                    f"drain rc not observed clean: {down.get('drain')} "
                    f"rc {down.get('drain_rc')}"
                )
            try:
                _wait_until(
                    lambda: _http_json(gw_url + "/metrics", timeout_s=10.0)[1]
                    .get("backends_in") == 1,
                    timeout_s=60.0, desc="gateway sees the drained slot OUT",
                )
            except RuntimeError as exc:
                violations.append(str(exc))
        state = _read_fleet_state(state_path) or {}
        up_slots = [s for s in state.get("slots", [])
                    if s.get("state") == "up"]
        if [s.get("slot") for s in up_slots] != [0]:
            violations.append(
                f"post-cycle fleet state wrong: {state.get('slots')}"
            )
        # the refined session's lineage is intact: the next refine
        # CONTINUES at refine_count 2 and its pre-surge predictions held
        code, body, _ = _http_json(
            gw_url + "/predict", {"adaptation_id": sid, "x_query": query},
            timeout_s=90.0,
        )
        if code != 200 or body.get("probs") != probs_refined:
            violations.append(
                f"refined session not intact after the cycle: {code}"
            )
        code, body, _ = _http_json(gw_url + "/adapt", refine_body,
                                   timeout_s=90.0)
        if code != 200 or body.get("refine_count") != 2:
            violations.append(
                f"refine lineage broken across the surge cycle: {code} "
                f"{body.get('refine_count')}"
            )
        # supervisor frame: counters + marker for obs_top auto-detect
        code, sup_metrics, _ = _http_json(sup_url + "/metrics", timeout_s=10.0)
        if (
            sup_metrics.get("counters", {}).get("scale_ups", 0) < 1
            or sup_metrics.get("counters", {}).get("scale_downs", 0) < 1
        ):
            violations.append(
                f"supervisor counters missing the cycle: "
                f"{sup_metrics.get('counters')}"
            )
    finally:
        _stop_supervisor(sup_proc, violations, "surge")
        _adopt_state_pids(state_path, procs)
    return violations


def _drill_fleet_crashloop(root, template_run, procs, device) -> List[str]:
    """Crash-safe control, both halves. (A) A die-on-spawn backend walks
    the bounded exponential-backoff ladder into quarantine — never
    respawned hot — while the fleet stays routable. (B) A supervisor
    kill -9'd mid-spawn (intent + pid journaled, warm gate unfinished)
    restarts, adopts the live fleet from the write-ahead journal, and
    settles the interrupted spawn — same pid, no double-spawn, no orphan."""
    violations: List[str] = []
    template = template_run or make_serving_run_dir(root, "template")
    run0 = make_serving_run_dir(root, "b0", template=template)
    run2 = make_serving_run_dir(root, "b2", template=template)
    port0, port1, port2 = _free_port(), _free_port(), _free_port()
    url0 = f"http://127.0.0.1:{port0}"
    url1 = f"http://127.0.0.1:{port1}"
    url2 = f"http://127.0.0.1:{port2}"
    proc0, _ = spawn_serve_backend(run0, port=port0, device=device)
    procs.append(proc0)
    _wait_http_ok(url0 + "/healthz", timeout_s=300.0, proc=proc0)
    threading.Thread(target=proc0.wait, daemon=True).start()
    gw_logs = os.path.join(root, "gateway", "logs")
    gw_proc, gw_url = spawn_gateway([url0, url1, url2], gw_logs)
    procs.append(gw_proc)
    _wait_http_ok(gw_url + "/healthz", timeout_s=30.0, proc=gw_proc)

    # --- leg A: crash-loop containment -------------------------------
    slots_a = [
        {"url": url0, "port": port0, "pid": proc0.pid,
         "respawn": backend_spawn_argv(run0, port0, device), "cwd": _REPO_ROOT,
         "log": os.path.join(run0, "serve_stdout.log"), "run_dir": run0},
        # slot 1 dies the instant it spawns: the ladder's worst case
        {"url": url1, "port": port1,
         "respawn": [sys.executable, "-c", "import sys; sys.exit(1)"],
         "cwd": _REPO_ROOT,
         "log": os.path.join(root, "crashloop_stdout.log")},
    ]
    slots_a_path = os.path.join(root, "slots_a.json")
    with open(slots_a_path, "w") as f:
        json.dump(slots_a, f)
    state_a = os.path.join(root, "fleet_state_a.json")
    events_a = os.path.join(root, "supervisor_events_a.jsonl")
    sup_a, _sup_a_url = _spawn_fleet_supervisor(
        root, "supervisor_a", state_a, gw_url, events_a, procs,
        slots_path=slots_a_path,
        # min_backends 2 forces spawn attempts into the crash-looping slot
        min_backends=2, max_backends=2, poll_interval_s=0.2,
        crash_max=3, crash_window_s=60.0,
        backoff_base_s=0.2, backoff_max_s=1.0, warm_timeout_s=30.0,
    )
    try:
        try:
            _wait_until(
                lambda: any(e.get("event") == "quarantine"
                            for e in _read_jsonl(events_a)),
                timeout_s=60.0, desc="crash-loop quarantine",
            )
        except RuntimeError as exc:
            violations.append(str(exc))
        events = _read_jsonl(events_a)
        crash_events = [e for e in events if e.get("event") == "spawn_crash"]
        if len(crash_events) != 2:  # crash_max 3 = 2 backoffs + quarantine
            violations.append(
                f"expected 2 spawn_crash events before quarantine, got "
                f"{len(crash_events)}"
            )
        backoffs = [e.get("backoff_s") for e in crash_events]
        if backoffs != sorted(backoffs) or len(set(backoffs)) != len(backoffs):
            violations.append(f"backoff ladder not increasing: {backoffs}")
        # quarantined means NEVER respawned hot: the event log must go
        # quiet for this slot
        before = len(_read_jsonl(events_a))
        time.sleep(2.0)
        after_events = _read_jsonl(events_a)
        new = [e for e in after_events[before:]
               if e.get("slot") == 1 and e.get("event") != "supervisor_stop"]
        if new:
            violations.append(f"quarantined slot kept getting actions: {new}")
        state = _read_fleet_state(state_a) or {}
        slot1 = next((s for s in state.get("slots", [])
                      if s.get("slot") == 1), {})
        if slot1.get("state") != "quarantined":
            violations.append(f"slot 1 not quarantined on disk: {slot1}")
        # the fleet is still routable around the quarantined slot
        s, _ = _adapt_payload(67)
        code, _b, _h = _http_json(gw_url + "/adapt", s, timeout_s=60.0)
        if code != 200:
            violations.append(f"fleet not routable during crash-loop: {code}")
    finally:
        _stop_supervisor(sup_a, violations, "crashloop-A")

    # --- leg B: kill -9 the supervisor mid-spawn ----------------------
    slots_b = [
        {"url": url0, "port": port0, "pid": proc0.pid,
         "respawn": backend_spawn_argv(run0, port0, device), "cwd": _REPO_ROOT,
         "log": os.path.join(run0, "serve_stdout.log"), "run_dir": run0},
        {"url": url2, "port": port2,
         "respawn": backend_spawn_argv(run2, port2, device), "cwd": _REPO_ROOT,
         "log": os.path.join(run2, "serve_stdout.log"), "run_dir": run2},
    ]
    slots_b_path = os.path.join(root, "slots_b.json")
    with open(slots_b_path, "w") as f:
        json.dump(slots_b, f)
    state_b = os.path.join(root, "fleet_state_b.json")
    events_b = os.path.join(root, "supervisor_events_b.jsonl")
    sup_b1, _ = _spawn_fleet_supervisor(
        root, "supervisor_b1", state_b, gw_url, events_b, procs,
        slots_path=slots_b_path,
        min_backends=2, max_backends=2, poll_interval_s=0.2,
        warm_timeout_s=300.0, warm_poll_s=0.25,
    )

    def _mid_spawn():
        # the pid is journaled right after Popen, long before the warm
        # gate settles — catching state "spawning" with a pid IS mid-spawn
        state = _read_fleet_state(state_b) or {}
        for slot in state.get("slots", []):
            if slot.get("slot") == 1 and slot.get("state") == "spawning" \
                    and slot.get("pid"):
                return slot["pid"]
        return None

    try:
        spawned_pid = _wait_until(_mid_spawn, timeout_s=120.0,
                                  desc="mid-spawn journal window",
                                  poll_s=0.02)
    except RuntimeError as exc:
        _stop_supervisor(sup_b1, violations, "crashloop-B1")
        _adopt_state_pids(state_b, procs)
        return violations + [str(exc)]
    procs.append(_FakeProc(spawned_pid))
    os.kill(sup_b1.pid, 9)  # the controller dies; the fleet must not care
    sup_b1.wait(timeout=30)
    state = _read_fleet_state(state_b) or {}
    if not (state.get("intent") or {}).get("action") == "spawn":
        violations.append(
            f"journal lost the in-flight spawn intent: {state.get('intent')}"
        )
    try:
        os.kill(spawned_pid, 0)
    except ProcessLookupError:
        violations.append("spawned backend died with its supervisor")
    # restart: the journal (not the slots file) is the source of truth
    sup_b2, _sup_b2_url = _spawn_fleet_supervisor(
        root, "supervisor_b2", state_b, gw_url, events_b, procs,
        min_backends=2, max_backends=2, poll_interval_s=0.2,
        warm_timeout_s=300.0, warm_poll_s=0.25,
    )
    try:
        try:
            _wait_until(
                lambda: (_read_fleet_state(state_b) or {}).get("intent") is None
                and next(
                    (s for s in (_read_fleet_state(state_b) or {}).get(
                        "slots", [])
                     if s.get("slot") == 1), {}
                ).get("state") == "up",
                timeout_s=300.0, desc="adopt-and-settle of the orphaned spawn",
            )
        except RuntimeError as exc:
            violations.append(str(exc))
        state = _read_fleet_state(state_b) or {}
        slot1 = next((s for s in state.get("slots", [])
                      if s.get("slot") == 1), {})
        if slot1.get("pid") != spawned_pid:
            violations.append(
                f"adopt respawned instead of settling: pid {slot1.get('pid')}"
                f" != journaled {spawned_pid} (double-spawn)"
            )
        rollforward = [e for e in _read_jsonl(events_b)
                       if e.get("event") == "adopt_rollforward"]
        if not any(e.get("outcome") == "spawn_settled" for e in rollforward):
            violations.append(
                f"no spawn_settled roll-forward event: {rollforward}"
            )
        try:
            _wait_until(
                lambda: _http_json(gw_url + "/metrics", timeout_s=10.0)[1]
                .get("backends_in") == 2,
                timeout_s=120.0, desc="gateway admits the adopted backend",
            )
        except RuntimeError as exc:
            violations.append(str(exc))
    finally:
        _stop_supervisor(sup_b2, violations, "crashloop-B2")
        _adopt_state_pids(state_b, procs)
    return violations


class _FakeProc:
    """pid-only handle so cleanup can SIGKILL processes we did not spawn
    directly (rolling_restart's respawned backends)."""

    def __init__(self, pid):
        self.pid = pid

    def poll(self):
        if self.pid is None:
            return 0
        try:
            os.kill(self.pid, 0)
        except (ProcessLookupError, PermissionError):
            return 0
        return None

    def kill(self):
        if self.pid is not None:
            try:
                os.kill(self.pid, 9)
            except (ProcessLookupError, PermissionError):
                pass

    def wait(self, timeout=None):
        deadline = time.monotonic() + (timeout or 0)
        while self.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        return 0


def run_campaign(work_dir: str, episodes: int = 8, seed: int = 0, **kwargs) -> Dict[str, Any]:
    """The seeded campaign over train / resume / serve episodes: not ported
    (ROADMAP.md A9: it needs the training fault seams). The gateway drills
    run one at a time through :func:`_run_gateway_episode`."""
    raise NotImplementedError(
        "the chaos campaign's training episodes and run_campaign are not ported to "
        "PyTorch yet (ROADMAP.md A9); run the gateway drills with _run_gateway_episode"
    )
