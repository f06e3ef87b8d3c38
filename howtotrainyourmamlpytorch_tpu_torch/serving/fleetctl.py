"""Fleet control-plane helpers (a copy of the JAX package's
``serving/fleetctl.py``): one fleet-state schema + one set of spawn / drain
/ liveness primitives shared by this package's ``scripts/rolling_restart.py``
and the autoscaling supervisor (``serving/autoscaler.py``).

Import-light BY CONTRACT: stdlib only — no torch, no package import, no
yaml — so it loads on a gateway-only host.  Callers file-path-load this
module (see ``scripts/rolling_restart.py`` / ``scripts/fleet_serve.py`` of
this package); it must never grow an import that drags the model stack in.

fleet_state.json schema (version 1)::

    {"version": 1,
     "updated": <wall-clock ts of last write>,
     "slots": [{"slot": 0,
                "url": "http://127.0.0.1:8101",
                "port": 8101,
                "pid": 12345 | null,
                "state": "up" | "down" | "spawning" | "draining" | "quarantined",
                "respawn": ["python", "-m",
                            "howtotrainyourmamlpytorch_tpu_torch.serve",
                            "exps/run", "--port", "8101"],
                "log": "/path/backend0.log",      # optional
                "cwd": "/repo",                   # optional
                "crashes": [<monotonic-ish ts>, ...],  # supervisor bookkeeping
                "overrides": ["serving.support_buckets=[...]", ...]},
               ...],
     "intent": null | {"id": 7, "action": "spawn" | "drain", "slot": 2,
                       "ts": <wall ts>}}

The legacy ``fleet.json`` format (a bare JSON list of
``{"url", "pid", "respawn", ...}`` entries, as rolling_restart.py consumes
it) normalizes losslessly into the dict form:
each entry becomes a slot with ``state: "up"``.  Every write is atomic
(tmp + ``os.replace``) so a reader — or a supervisor restarting after
kill -9 — never sees a torn file.
"""

# graftlint: import-light — file-path-loaded by scripts/rolling_restart.py on ops hosts (GL213 gates the closure)
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

FLEET_STATE_VERSION = 1

_VALID_SLOT_STATES = ("up", "down", "spawning", "draining", "quarantined")


def _load_by_path(name: str, path: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


try:
    _exit_codes = _load_by_path(
        "htymp_torch_exit_codes_fleetctl",
        os.path.join(
            os.path.dirname(os.path.abspath(__file__)), os.pardir, "exit_codes.py"
        ),
    )
    RC_OK, RC_USAGE = _exit_codes.OK, _exit_codes.USAGE
    RC_DRAIN_DEADLINE = _exit_codes.DRAIN_DEADLINE
except Exception:  # standalone copy: the historical literals hold
    RC_OK, RC_USAGE, RC_DRAIN_DEADLINE = 0, 2, 77


# ---------------------------------------------------------------------------
# fleet_state.json


def write_atomic(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically (tmp + rename): a concurrent
    reader sees the old file or the new file, never a torn one."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def normalize_fleet_state(raw) -> dict:
    """Accept either schema — version-1 dict or legacy bare list — and
    return the dict form.  Raises ValueError on anything else."""
    if isinstance(raw, list):
        if not raw:
            raise ValueError("fleet list must be non-empty")
        slots = []
        for i, entry in enumerate(raw):
            if not isinstance(entry, dict) or "url" not in entry:
                raise ValueError(f"fleet entry {i} must be a dict with 'url'")
            slot = dict(entry)
            slot.setdefault("slot", i)
            slot.setdefault("state", "up")
            slot.setdefault("pid", entry.get("pid"))
            slots.append(slot)
        return {"version": FLEET_STATE_VERSION, "slots": slots, "intent": None}
    if isinstance(raw, dict):
        version = raw.get("version")
        if version != FLEET_STATE_VERSION:
            raise ValueError(f"unsupported fleet_state version {version!r}")
        slots = raw.get("slots")
        if not isinstance(slots, list) or not slots:
            raise ValueError("fleet_state.slots must be a non-empty list")
        for i, slot in enumerate(slots):
            if not isinstance(slot, dict) or "url" not in slot:
                raise ValueError(f"fleet_state slot {i} must be a dict with 'url'")
            slot.setdefault("slot", i)
            state = slot.setdefault("state", "down")
            if state not in _VALID_SLOT_STATES:
                raise ValueError(f"slot {i} has unknown state {state!r}")
        raw.setdefault("intent", None)
        return raw
    raise ValueError(f"fleet state must be a list or dict, got {type(raw).__name__}")


def load_fleet_state(path: str) -> dict:
    """Load + normalize ``path`` (either schema).  OSError / ValueError
    propagate — callers own the usage-error surface."""
    with open(path) as f:
        raw = json.load(f)
    return normalize_fleet_state(raw)


def save_fleet_state(path: str, state: dict) -> None:
    state = dict(state)
    state["version"] = FLEET_STATE_VERSION
    state["updated"] = time.time()
    write_atomic(path, json.dumps(state, indent=1, sort_keys=True))


# ---------------------------------------------------------------------------
# liveness primitives


def healthz(url: str, timeout_s: float = 3.0):
    """-> (code, body dict) or (None, {}) when unreachable."""
    try:
        with urllib.request.urlopen(
            url.rstrip("/") + "/healthz", timeout=timeout_s
        ) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        try:
            return exc.code, json.loads(exc.read())
        except ValueError:
            return exc.code, {}
    except (urllib.error.URLError, OSError, ValueError):
        return None, {}


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def wait_pid_gone(pid: int, timeout_s: float, poll_s: float = 0.2):
    """-> (gone, rc). ``rc`` is the drain exit code when observable — only
    for pids that are OUR children; for a pid owned by a previous supervisor
    it stays None and the backend's own logs/events carry the drain verdict."""
    rc = None
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        # reap if it is our child (spawned this process); harmless otherwise
        try:
            reaped, status = os.waitpid(pid, os.WNOHANG)
            if reaped == pid:
                rc = os.waitstatus_to_exitcode(status)
        except ChildProcessError:
            pass
        if not pid_alive(pid):
            return True, rc
        time.sleep(poll_s)
    return not pid_alive(pid), rc


def wait_healthy(url: str, timeout_s: float, poll_s: float = 0.5) -> bool:
    """Poll /healthz until 200 (past 'warming'/'draining') or timeout."""
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        code, _ = healthz(url)
        if code == 200:
            return True
        time.sleep(poll_s)
    return False


def gateway_admits(gateway_url: str, url: str, timeout_s: float = 3.0) -> bool:
    """Does the gateway's ``/metrics`` list the backend at ``url`` IN?"""
    try:
        with urllib.request.urlopen(
            gateway_url.rstrip("/") + "/metrics", timeout=timeout_s
        ) as resp:
            backends = json.loads(resp.read()).get("backends") or []
    except (urllib.error.URLError, OSError, ValueError):
        return False
    return any(b.get("url") == url.rstrip("/") and b.get("in") for b in backends)


def wait_admitted(
    gateway_url: str, url: str, timeout_s: float, poll_s: float = 0.1
) -> bool:
    """Poll the gateway until it routes to ``url`` again or timeout. A
    backend's own /healthz 200 is not the gateway's admission: that waits
    for the gateway's next health probe, and a roll that drains the next
    backend in between leaves the gateway no backend to route to."""
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if gateway_admits(gateway_url, url):
            return True
        time.sleep(poll_s)
    return False


# ---------------------------------------------------------------------------
# spawn / drain


def spawn_backend(entry: dict, extra_argv=None) -> subprocess.Popen:
    """Spawn ``entry["respawn"]`` (+ optional ``extra_argv``, e.g. prewarm
    bucket overrides) detached from the caller's stdio.

    The spawned backend must NOT inherit the caller's stdout/stderr: it
    outlives us, and an inherited pipe would keep a test-runner's capture
    open forever.  Its output goes to ``entry["log"]`` or /dev/null.
    """
    respawn = list(entry["respawn"])
    if extra_argv:
        respawn += list(extra_argv)
    log_path = entry.get("log")
    out = open(log_path, "ab") if log_path else subprocess.DEVNULL
    try:
        return subprocess.Popen(
            respawn,
            cwd=entry.get("cwd") or None,
            stdin=subprocess.DEVNULL,
            stdout=out,
            stderr=subprocess.STDOUT if log_path else subprocess.DEVNULL,
        )
    finally:
        if log_path:
            out.close()


def drain_backend(
    entry: dict,
    drain_timeout_s: float,
    log=lambda m: print(m, file=sys.stderr, flush=True),
) -> dict:
    """SIGTERM ``entry["pid"]``, wait for it to exit, escalate to SIGKILL
    past the deadline.  Returns a verdict row: ``drain`` is one of
    already_gone / sigterm_sent / deadline_exceeded / killed_after_timeout,
    ``drain_rc`` carries the exit code when observable (rc 0 clean, rc 77 =
    the backend's own drain deadline fired — lossy last seconds)."""
    url, pid = entry["url"], int(entry["pid"])
    row = {"url": url, "old_pid": pid}
    t0 = time.monotonic()
    log(f"fleetctl: draining {url} (pid {pid})")
    try:
        os.kill(pid, signal.SIGTERM)
    except ProcessLookupError:
        row["drain"] = "already_gone"
    else:
        row["drain"] = "sigterm_sent"
    gone, drain_rc = wait_pid_gone(pid, drain_timeout_s)
    if not gone:
        # a backend that ignores its drain deadline is wedged — escalate;
        # its sessions (if spilled) still rehydrate on respawn
        log(f"fleetctl: {url} pid {pid} outlived drain timeout — SIGKILL")
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        wait_pid_gone(pid, 10.0)
        row["drain"] = "killed_after_timeout"
    elif drain_rc is not None:
        row["drain_rc"] = drain_rc
        if drain_rc == RC_DRAIN_DEADLINE:
            row["drain"] = "deadline_exceeded"
            log(f"fleetctl: {url} drain exceeded its deadline (rc "
                f"{drain_rc}) — lossy last seconds")
    row["drain_s"] = round(time.monotonic() - t0, 2)
    return row


def restart_backend(
    entry: dict,
    drain_timeout_s: float,
    warm_timeout_s: float,
    gateway_url=None,
    log=lambda m: print(m, file=sys.stderr, flush=True),
) -> dict:
    """Drain + respawn + warm-gate ONE backend; returns its verdict row.
    With ``gateway_url`` the gate also waits, within ``warm_timeout_s``,
    until that gateway routes to the backend again (``admit_s``)."""
    url = entry["url"]
    row = drain_backend(entry, drain_timeout_s, log=log)
    respawn = entry.get("respawn")
    if not respawn:
        row["ok"] = False
        row["error"] = "no respawn command"
        return row
    log(f"fleetctl: respawning {url}")
    proc = spawn_backend(entry)
    row["new_pid"] = proc.pid
    t1 = time.monotonic()
    healthy = wait_healthy(url, warm_timeout_s)
    row["warm_s"] = round(time.monotonic() - t1, 2)
    row["ok"] = healthy
    if not healthy:
        row["error"] = f"/healthz not 200 within {warm_timeout_s}s"
    elif gateway_url:
        t2 = time.monotonic()
        row["ok"] = wait_admitted(
            gateway_url, url, max(0.0, warm_timeout_s - row["warm_s"])
        )
        row["admit_s"] = round(time.monotonic() - t2, 2)
        if not row["ok"]:
            row["error"] = f"the gateway did not admit it within {warm_timeout_s}s"
    return row
