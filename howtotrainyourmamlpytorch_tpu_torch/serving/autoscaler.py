"""Self-healing fleet supervisor (a copy of the JAX package's
``serving/autoscaler.py``): traffic-adaptive autoscaling with crash-safe
control and predictive bucket retunes.

One single-threaded control loop owns backend lifecycle end to end:

- **Reactive.** Each tick polls the gateway's ``/metrics`` (shed/429 rate,
  per-backend membership + flaps) and every IN backend's ``/metrics``
  (batcher queue depth, ``tenants.pager`` evictions / ``page_in_p50_ms``)
  through hysteresis windows — ``up_polls`` consecutive breach ticks to
  scale up, ``down_polls`` consecutive clear ticks to scale down — with
  independent per-direction cooldowns so noise cannot flap the fleet.
  Scale-up spawns into a pre-provisioned port slot and gates on ``/healthz``
  200 past "warming"; a spawn that dies is retried on a bounded exponential
  backoff ladder, and a slot that crashes ``crash_max`` times inside
  ``crash_window_s`` is quarantined with an event and never respawned hot.
  Scale-down gracefully drains the lowest-ranked backend (highest slot
  index), observes + reports the drain rc (0 clean / 77 deadline) and the
  session spill, and never goes below ``min_backends``. A backend that
  disappears without being asked (kill -9) is seen as a dead pid / gateway
  OUT transition and replaced through the same ladder.

- **Crash-safe.** Every intended action is journaled write-ahead to
  ``fleet_state.json`` (atomic tmp+rename via ``fleetctl``): intent → act →
  settle. A supervisor killed mid-spawn or mid-drain restarts, adopts
  still-running backends by pid/port liveness probe, rolls the interrupted
  intent forward (settle the spawn, re-issue the drain) or reaps/adopts the
  orphan a dead supervisor left on a slot's port. The controller is allowed
  to die; the fleet must not care — backends are never killed on supervisor
  exit.

- **Predictive.** Every ``forecast_interval_s`` the (bucket × verb) traffic
  mix is re-read from ``access.jsonl`` over a sliding window; when the
  tuned edges (``buckets.py`` exact DP solver) would cut padding waste past
  ``retune_waste_improvement``, the override strings are parked for the
  NEXT spawned backend (``serving.*_buckets=[...]``, positional overrides
  of ``python -m howtotrainyourmamlpytorch_tpu_torch.serve``) — a live
  backend never changes its buckets.

Import-light BY CONTRACT (stdlib only, like the gateway): file-path-loads
its siblings ``fleetctl.py`` and ``buckets.py``; never imports torch, yaml,
or the package. Every collaborator (clock, sleep, HTTP fetch, spawn, drain,
pid probe) is injectable so the tests drive the whole decision matrix on a
fake clock with zero subprocesses.
"""

import json
import os
import signal as _signal
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

# Locks are plain threading.Lock: the lock-discipline sanitizer (tools/graftsan)
# is not ported (ROADMAP.md A9.7), and this module must stay stdlib-only.

_HERE = os.path.dirname(os.path.abspath(__file__))


def _load_by_path(name: str, path: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


fleetctl = _load_by_path("htymp_torch_fleetctl_as", os.path.join(_HERE, "fleetctl.py"))
buckets = _load_by_path("htymp_torch_buckets_as", os.path.join(_HERE, "buckets.py"))

RC_OK, RC_USAGE = fleetctl.RC_OK, fleetctl.RC_USAGE


class Policy:
    """The supervisor's knobs — a validated attribute bag (stdlib, no
    dataclasses-with-yaml: the import-light contract). Defaults are pinned
    equal to ``config.AutoscaleConfig`` by test so the two can't drift."""

    DEFAULTS = dict(
        min_backends=1,
        max_backends=4,
        poll_interval_s=2.0,
        up_polls=2,
        down_polls=5,
        cooldown_up_s=10.0,
        cooldown_down_s=60.0,
        queue_high=8.0,
        queue_low=1.0,
        shed_high=0.05,
        evict_high=5,
        page_in_p50_high_ms=0.0,
        warm_timeout_s=300.0,
        warm_poll_s=0.5,
        drain_timeout_s=60.0,
        crash_max=3,
        crash_window_s=60.0,
        backoff_base_s=0.5,
        backoff_max_s=30.0,
        forecast_interval_s=30.0,
        forecast_window_s=300.0,
        forecast_min_requests=20,
        retune_waste_improvement=0.10,
        max_buckets=4,
    )

    def __init__(self, **overrides):
        unknown = set(overrides) - set(self.DEFAULTS)
        if unknown:
            raise ValueError(f"unknown policy knobs: {sorted(unknown)}")
        for key, default in self.DEFAULTS.items():
            setattr(self, key, overrides.get(key, default))
        if self.min_backends < 0:
            raise ValueError("min_backends must be >= 0")
        if self.max_backends < max(1, self.min_backends):
            raise ValueError("max_backends must be >= max(1, min_backends)")
        for knob in ("up_polls", "down_polls", "crash_max"):
            if getattr(self, knob) < 1:
                raise ValueError(f"{knob} must be >= 1")
        for knob in ("poll_interval_s", "warm_timeout_s", "drain_timeout_s",
                     "backoff_base_s", "crash_window_s"):
            if getattr(self, knob) <= 0:
                raise ValueError(f"{knob} must be > 0")


def _default_fetch(url: str, timeout_s: float = 3.0) -> Optional[Dict[str, Any]]:
    """GET ``url`` as JSON; None on any transport/parse failure — the
    supervisor treats an unreachable scrape as 'no signal', never a crash."""
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            out = json.loads(resp.read())
            return out if isinstance(out, dict) else None
    except (urllib.error.URLError, OSError, ValueError):
        return None


def find_pid_by_port(port: int) -> Optional[int]:
    """Locate the pid LISTENing on ``port`` via /proc (Linux): the
    port-liveness half of adopt-on-restart, for the orphan a supervisor
    killed between Popen and journaling the pid left behind. None when the
    scan is unavailable (non-Linux) or nothing is listening."""
    try:
        inodes = set()
        for path in ("/proc/net/tcp", "/proc/net/tcp6"):
            try:
                with open(path) as f:
                    lines = f.read().splitlines()[1:]
            except OSError:
                continue
            for line in lines:
                parts = line.split()
                if len(parts) < 10 or parts[3] != "0A":  # 0A = LISTEN
                    continue
                try:
                    local_port = int(parts[1].rsplit(":", 1)[1], 16)
                except (IndexError, ValueError):
                    continue
                if local_port == int(port):
                    inodes.add(parts[9])
        if not inodes:
            return None
        targets = {f"socket:[{inode}]" for inode in inodes}
        for pid_dir in os.listdir("/proc"):
            if not pid_dir.isdigit():
                continue
            fd_dir = os.path.join("/proc", pid_dir, "fd")
            try:
                fds = os.listdir(fd_dir)
            except OSError:
                continue
            for fd in fds:
                try:
                    link = os.readlink(os.path.join(fd_dir, fd))
                except OSError:
                    continue
                if link in targets:
                    return int(pid_dir)
    except Exception:
        return None
    return None


class Supervisor:
    """The control loop. All state mutations happen under ``self._lock``
    (the /metrics endpoint reads from another thread); blocking waits
    (warm gate, drain) run with the lock released."""

    def __init__(
        self,
        state_path: str,
        policy: Policy,
        gateway_url: Optional[str] = None,
        *,
        events_path: Optional[str] = None,
        access_log: Optional[str] = None,
        current_support: Optional[List[int]] = None,
        current_query: Optional[List[int]] = None,
        clock=time.monotonic,
        wall=time.time,
        sleep=time.sleep,
        fetch=_default_fetch,
        spawn=None,
        drain=None,
        probe=fleetctl.healthz,
        pid_alive=None,
        kill9=None,
        port_pid=find_pid_by_port,
        log=lambda m: print(m, file=sys.stderr, flush=True),
    ):
        self.state_path = state_path
        self.policy = policy
        self.gateway_url = gateway_url.rstrip("/") if gateway_url else None
        self.events_path = events_path
        self.access_log = access_log
        self.current_support = list(current_support or [])
        self.current_query = list(current_query or [])
        self.clock, self.wall, self.sleep = clock, wall, sleep
        self.fetch = fetch
        self.spawn = spawn or self._default_spawn
        self.drain = drain or self._default_drain
        self.probe = probe
        self.pid_alive = pid_alive or self._default_pid_alive
        self.kill9 = kill9 or self._default_kill9
        self.port_pid = port_pid
        self.log = log

        self._lock = threading.Lock()
        self._events_lock = threading.Lock()
        self.state: Dict[str, Any] = {"slots": [], "intent": None, "target": 0}
        self.counters = {
            "ticks": 0, "scale_ups": 0, "scale_downs": 0, "crashes": 0,
            "quarantines": 0, "replacements": 0, "retunes": 0, "adopted": 0,
        }
        self._stop = threading.Event()
        self._started = self.clock()
        self._up_streak = 0
        self._down_streak = 0
        self._last_up_ts: Optional[float] = None
        self._last_down_ts: Optional[float] = None
        self._last_forecast_ts: Optional[float] = None
        self._last_signals: Dict[str, Any] = {}
        self._last_decision: Optional[Dict[str, Any]] = None
        self._pending_overrides: List[str] = []
        self._prev_gw: Optional[Dict[str, int]] = None
        self._prev_evictions: Optional[int] = None
        self._reaped_rcs: Dict[int, int] = {}

    # -- default collaborators (real processes) ------------------------

    def _default_spawn(self, entry: Dict[str, Any], extra_argv) -> int:
        return fleetctl.spawn_backend(entry, extra_argv).pid

    def _default_drain(self, entry: Dict[str, Any], timeout_s: float) -> dict:
        return fleetctl.drain_backend(entry, timeout_s, log=self.log)

    def _default_pid_alive(self, pid: int) -> bool:
        # reap first: an unreaped child zombie still answers kill(pid, 0)
        try:
            reaped, status = os.waitpid(pid, os.WNOHANG)
            if reaped == pid:
                with self._lock:
                    self._reaped_rcs[pid] = os.waitstatus_to_exitcode(status)
                return False
        except (ChildProcessError, OSError):
            pass
        if pid in self._reaped_rcs:
            return False
        return fleetctl.pid_alive(pid)

    def _default_kill9(self, pid: int) -> None:
        try:
            os.kill(pid, _signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    # -- state / journal -----------------------------------------------

    def load_or_init(self, slots: Optional[List[Dict[str, Any]]] = None) -> str:
        """Resume from an existing journal (adopt the live fleet, roll the
        interrupted intent forward) or initialize from a slot template.
        Returns "adopted" or "initialized"."""
        if os.path.exists(self.state_path):
            state = fleetctl.load_fleet_state(self.state_path)
            with self._lock:
                self.state = state
            self.adopt()
            return "adopted"
        if not slots:
            raise ValueError(f"no fleet state at {self.state_path} and no slots")
        norm = []
        for i, slot in enumerate(slots):
            entry = dict(slot)
            entry.setdefault("slot", i)
            entry.setdefault("state", "up" if entry.get("pid") else "down")
            entry.setdefault("pid", None)
            norm.append(entry)
        with self._lock:
            self.state = {
                "version": fleetctl.FLEET_STATE_VERSION,
                "slots": norm,
                "intent": None,
                "target": max(
                    self.policy.min_backends,
                    sum(1 for s in norm if s["state"] == "up"),
                ),
            }
        self._save()
        self._event("supervisor_start", slots=len(norm),
                    target=self.state["target"], mode="initialized")
        return "initialized"

    def _save(self) -> None:
        with self._lock:
            state = dict(self.state)
        fleetctl.save_fleet_state(self.state_path, state)

    def _event(self, name: str, **fields) -> None:
        record = {"ts": self.wall(), "event": name,
                  "component": "supervisor", **fields}
        if name in ("scale_up", "scale_down", "spawn_crash", "quarantine",
                    "backend_died", "retune", "adopt_rollforward"):
            with self._lock:
                self._last_decision = record
        if self.events_path:
            with self._events_lock:
                with open(self.events_path, "a") as f:
                    f.write(json.dumps(record) + "\n")

    def _begin_intent(self, action: str, slot_id: int) -> None:
        with self._lock:
            next_id = int(self.state.get("next_intent_id", 0))
            self.state["next_intent_id"] = next_id + 1
            self.state["intent"] = {
                "id": next_id, "action": action, "slot": slot_id,
                "ts": self.wall(),
            }
        self._save()

    def _settle_intent(self) -> None:
        with self._lock:
            self.state["intent"] = None
        self._save()

    def _slot_by_id(self, slot_id: int) -> Optional[Dict[str, Any]]:
        for slot in self.state["slots"]:
            if slot.get("slot") == slot_id:
                return slot
        return None

    def _running(self) -> int:
        return sum(
            1 for s in self.state["slots"] if s.get("state") in ("up", "spawning")
        )

    # -- signal collection ---------------------------------------------

    def collect_signals(self) -> Dict[str, Any]:
        s: Dict[str, Any] = {
            "gateway": False, "backends_in": None, "requests_delta": 0,
            "shed_delta": 0, "shed_rate": None, "flap_delta": 0,
            "queue_depth": None, "evict_delta": 0, "page_in_p50_ms": None,
            "out_urls": [],
        }
        if self.gateway_url:
            gm = self.fetch(self.gateway_url + "/metrics")
            if gm and gm.get("gateway"):
                s["gateway"] = True
                s["backends_in"] = gm.get("backends_in")
                requests = int(gm.get("requests", 0))
                shed = int(gm.get("admission_shed", 0)) + int(gm.get("no_backend", 0))
                flaps = sum(
                    int(b.get("flaps", 0)) for b in gm.get("backends") or []
                    if isinstance(b, dict)
                )
                if self._prev_gw is not None:
                    s["requests_delta"] = max(0, requests - self._prev_gw["requests"])
                    s["shed_delta"] = max(0, shed - self._prev_gw["shed"])
                    s["flap_delta"] = max(0, flaps - self._prev_gw["flaps"])
                    denom = s["requests_delta"]
                    s["shed_rate"] = (
                        round(s["shed_delta"] / denom, 4) if denom else
                        (1.0 if s["shed_delta"] else 0.0)
                    )
                self._prev_gw = {"requests": requests, "shed": shed, "flaps": flaps}
                s["out_urls"] = [
                    b.get("url") for b in gm.get("backends") or []
                    if isinstance(b, dict) and b.get("state") == "out"
                ]
        queue_max: Optional[float] = None
        evictions = 0
        saw_pager = False
        p50s: List[float] = []
        with self._lock:
            up_slots = [dict(s2) for s2 in self.state["slots"]
                        if s2.get("state") == "up"]
        for slot in up_slots:
            bm = self.fetch(slot["url"].rstrip("/") + "/metrics")
            if not bm:
                continue
            for kind in ("adapt_batcher", "predict_batcher"):
                depth = (bm.get(kind) or {}).get("queue_depth")
                if isinstance(depth, (int, float)):
                    queue_max = max(queue_max or 0, depth)
            pager = (bm.get("tenants") or {}).get("pager") or {}
            if isinstance(pager.get("evictions"), int):
                saw_pager = True
                evictions += pager["evictions"]
            if isinstance(pager.get("page_in_p50_ms"), (int, float)):
                p50s.append(pager["page_in_p50_ms"])
        s["queue_depth"] = queue_max
        if saw_pager:
            if self._prev_evictions is not None:
                s["evict_delta"] = max(0, evictions - self._prev_evictions)
            self._prev_evictions = evictions
        if p50s:
            s["page_in_p50_ms"] = max(p50s)
        with self._lock:
            self._last_signals = s
        return s

    def _breach_reasons(self, s: Dict[str, Any]) -> List[str]:
        p = self.policy
        reasons = []
        if s["queue_depth"] is not None and s["queue_depth"] >= p.queue_high:
            reasons.append(f"queue_depth {s['queue_depth']} >= {p.queue_high}")
        if s["shed_rate"] is not None and s["shed_delta"] > 0 \
                and s["shed_rate"] >= p.shed_high:
            reasons.append(f"shed_rate {s['shed_rate']} >= {p.shed_high}")
        if p.evict_high > 0 and s["evict_delta"] >= p.evict_high:
            reasons.append(f"pager_evictions +{s['evict_delta']} >= {p.evict_high}")
        if p.page_in_p50_high_ms > 0 and s["page_in_p50_ms"] is not None \
                and s["page_in_p50_ms"] >= p.page_in_p50_high_ms:
            reasons.append(
                f"page_in_p50_ms {s['page_in_p50_ms']} >= {p.page_in_p50_high_ms}"
            )
        return reasons

    def _is_clear(self, s: Dict[str, Any]) -> bool:
        return bool(
            s["gateway"]
            and s["queue_depth"] is not None
            and s["queue_depth"] <= self.policy.queue_low
            and s["shed_delta"] == 0
            and s["evict_delta"] == 0
        )

    # -- actions --------------------------------------------------------

    def _spawnable_slot(self) -> Optional[Dict[str, Any]]:
        now = self.wall()
        with self._lock:
            for slot in self.state["slots"]:
                if slot.get("state") != "down":
                    continue
                if not slot.get("respawn"):
                    continue
                if slot.get("next_spawn_ts") and now < slot["next_spawn_ts"]:
                    continue
                return slot
        return None

    def _accepts_overrides(self, slot: Dict[str, Any]) -> bool:
        """Does the slot's respawn command take ``key=value`` overrides?
        The serve CLIs do: this package's ``python -m
        howtotrainyourmamlpytorch_tpu_torch.serve`` and a ``serve.py``."""
        if "accepts_overrides" in slot:
            return bool(slot["accepts_overrides"])
        return any(
            "serve.py" in str(part)
            or str(part) == "howtotrainyourmamlpytorch_tpu_torch.serve"
            for part in slot.get("respawn") or []
        )

    def _await_warm(self, slot: Dict[str, Any]) -> str:
        """Block until the spawned backend answers /healthz 200 (past
        "warming"), dies, or times out. -> "up" | "crash" | "warm_timeout"."""
        deadline = self.clock() + self.policy.warm_timeout_s
        while self.clock() < deadline:
            if self._stop.is_set():
                return "interrupted"
            pid = slot.get("pid")
            if pid and not self.pid_alive(pid):
                return "crash"
            code, _ = self.probe(slot["url"])
            if code == 200:
                return "up"
            self.sleep(self.policy.warm_poll_s)
        return "warm_timeout"

    def _record_crash(self, slot: Dict[str, Any], reason: str) -> str:
        """Crash-ladder bookkeeping: prune the window, add this death,
        quarantine at ``crash_max`` or schedule the backed-off retry."""
        p = self.policy
        now = self.wall()
        with self._lock:
            crashes = [t for t in slot.get("crashes", [])
                       if now - t <= p.crash_window_s]
            crashes.append(now)
            slot["crashes"] = crashes
            slot["pid"] = None
            self.counters["crashes"] += 1
            attempts = len(crashes)
            if attempts >= p.crash_max:
                slot["state"] = "quarantined"
                self.counters["quarantines"] += 1
            else:
                slot["state"] = "down"
                backoff = min(p.backoff_max_s,
                              p.backoff_base_s * (2 ** (attempts - 1)))
                slot["next_spawn_ts"] = now + backoff
        if attempts >= p.crash_max:
            self._event("quarantine", slot=slot["slot"], reason=reason,
                        crashes=attempts, window_s=p.crash_window_s)
            self.log(f"autoscaler: slot {slot['slot']} QUARANTINED after "
                     f"{attempts} crashes in {p.crash_window_s}s ({reason})")
            return "quarantined"
        self._event("spawn_crash", slot=slot["slot"], reason=reason,
                    crashes=attempts, backoff_s=round(backoff, 3))
        return "backoff"

    def _spawn_into(self, slot: Dict[str, Any], reason: str,
                    signals: Optional[Dict[str, Any]] = None) -> str:
        """Write-ahead journaled spawn + warm gate. -> "up" | "backoff" |
        "quarantined"."""
        extra = None
        applied_overrides = None
        with self._lock:
            if self._pending_overrides and self._accepts_overrides(slot):
                extra = list(self._pending_overrides)
                applied_overrides = extra
            slot["state"] = "spawning"
        self._begin_intent("spawn", slot["slot"])  # one write-ahead save
        # carries both the intent and the slot's "spawning" state
        t0 = self.clock()
        try:
            pid = int(self.spawn(slot, extra))
        except Exception as exc:
            outcome = self._record_crash(slot, reason=f"spawn raised: {exc}")
            self._settle_intent()
            return outcome
        with self._lock:
            slot["pid"] = pid
        self._save()  # the pid is journaled before the warm wait: a
        # supervisor killed here restarts and adopts this backend by pid
        warm = self._await_warm(slot)
        settle_s = round(self.clock() - t0, 2)
        if warm == "up":
            with self._lock:
                slot["state"] = "up"
                slot["crashes"] = []
                slot.pop("next_spawn_ts", None)
                if applied_overrides:
                    slot["overrides"] = applied_overrides
            if applied_overrides:
                self._apply_retune(applied_overrides)
            self._settle_intent()
            self._event("scale_up", slot=slot["slot"], reason=reason,
                        signals=signals, outcome="up", settle_s=settle_s,
                        pid=pid, overrides=applied_overrides or [])
            self.log(f"autoscaler: slot {slot['slot']} up (pid {pid}, "
                     f"{settle_s}s) [{reason}]")
            return "up"
        if warm == "interrupted":
            # shutting down mid-spawn: leave the intent + pid journaled —
            # the backend lives on and the next supervisor's adopt rolls
            # the spawn forward (never kill a backend on supervisor exit)
            return "interrupted"
        if warm == "warm_timeout":
            self.kill9(pid)
            fleetctl.wait_pid_gone(pid, 10.0)
        outcome = self._record_crash(slot, reason=f"{reason}: {warm}")
        self._settle_intent()
        return outcome

    def _apply_retune(self, overrides: List[str]) -> None:
        """A tuned grid reached a live backend: it is now the fleet's
        reference grid — clear the parked overrides and move the forecast
        baseline so the next divergence is measured against it."""
        with self._lock:
            self._pending_overrides = []
            for item in overrides:
                key, _, value = item.partition("=")
                try:
                    edges = json.loads(value)
                except ValueError:
                    continue
                if key == "serving.support_buckets":
                    self.current_support = list(edges)
                elif key == "serving.query_buckets":
                    self.current_query = list(edges)

    def _drain_slot(self, slot: Dict[str, Any], reason: str,
                    signals: Optional[Dict[str, Any]] = None) -> dict:
        """Write-ahead journaled graceful drain of one backend."""
        self._begin_intent("drain", slot["slot"])
        with self._lock:
            slot["state"] = "draining"
        self._save()
        t0 = self.clock()
        row = self.drain(slot, self.policy.drain_timeout_s)
        spilled = self._count_spilled(slot)
        with self._lock:
            slot["pid"] = None
            slot["state"] = "down"
            slot.pop("next_spawn_ts", None)
        self._settle_intent()
        self._event(
            "scale_down", slot=slot["slot"], reason=reason, signals=signals,
            outcome="down", settle_s=round(self.clock() - t0, 2),
            drain=row.get("drain"), drain_rc=row.get("drain_rc"),
            spilled_sessions=spilled,
        )
        self.log(f"autoscaler: slot {slot['slot']} drained "
                 f"({row.get('drain')}, rc {row.get('drain_rc')}) [{reason}]")
        return row

    def _count_spilled(self, slot: Dict[str, Any]) -> Optional[int]:
        run_dir = slot.get("run_dir")
        if not run_dir:
            return None
        spill_dir = os.path.join(run_dir, "saved_models", "sessions")
        try:
            return len([n for n in os.listdir(spill_dir)
                        if not n.startswith(".")])
        except OSError:
            return 0

    # -- adopt-on-restart ----------------------------------------------

    def adopt(self) -> None:
        """Reconcile the journal against reality after a restart: adopt
        live backends by pid/port probe, roll the interrupted intent
        forward, reap what is actually dead."""
        with self._lock:
            intent = self.state.get("intent")
            slots = list(self.state["slots"])
        intent_slot = intent["slot"] if intent else None
        adopted = found_dead = 0
        for slot in slots:
            if slot.get("slot") == intent_slot:
                continue  # the interrupted action owns this slot (below)
            pid = slot.get("pid")
            if not pid:
                if slot.get("state") in ("up", "spawning", "draining"):
                    with self._lock:
                        slot["state"] = "down"
                continue
            if self.pid_alive(pid):
                code, _ = self.probe(slot["url"])
                if code == 200:
                    with self._lock:
                        slot["state"] = "up"
                    adopted += 1
                    self._event("adopt", slot=slot["slot"], pid=pid)
                else:
                    # alive but not healthy: re-enter the warm gate
                    with self._lock:
                        slot["state"] = "spawning"
                    if self._await_warm(slot) == "up":
                        with self._lock:
                            slot["state"] = "up"
                        adopted += 1
                        self._event("adopt", slot=slot["slot"], pid=pid,
                                    warmed=True)
                    else:
                        self._record_crash(slot, reason="adopt: never warmed")
            else:
                with self._lock:
                    slot["pid"] = None
                    if slot.get("state") != "quarantined":
                        slot["state"] = "down"
                found_dead += 1
                self._event("adopt_found_dead", slot=slot["slot"], pid=pid)
        if intent:
            self._roll_forward(intent)
        with self._lock:
            self.counters["adopted"] += adopted
            self.state["intent"] = None
            running = sum(1 for s in self.state["slots"]
                          if s.get("state") in ("up", "spawning"))
            self.state["target"] = max(
                self.policy.min_backends,
                int(self.state.get("target") or 0) or running,
            )
        self._save()
        self._event("supervisor_start", mode="adopted", adopted=adopted,
                    found_dead=found_dead,
                    rolled_forward=intent["action"] if intent else None,
                    target=self.state["target"])

    def _roll_forward(self, intent: Dict[str, Any]) -> None:
        slot = self._slot_by_id(intent["slot"])
        if slot is None:
            return
        action = intent["action"]
        pid = slot.get("pid")
        if action == "spawn":
            if pid and self.pid_alive(pid):
                # the spawn survived the dead supervisor: finish its warm
                # gate and settle — do NOT double-spawn
                with self._lock:
                    slot["state"] = "spawning"
                if self._await_warm(slot) == "up":
                    with self._lock:
                        slot["state"] = "up"
                        slot["crashes"] = []
                    self._event("adopt_rollforward", slot=slot["slot"],
                                action="spawn", outcome="spawn_settled",
                                pid=pid)
                else:
                    self._record_crash(slot, reason="rollforward: never warmed")
            elif pid:
                self._record_crash(slot, reason="rollforward: spawn died")
                self._event("adopt_rollforward", slot=slot["slot"],
                            action="spawn", outcome="spawn_crashed", pid=pid)
            else:
                # killed between Popen and journaling the pid: probe the
                # slot's port for the orphan
                code, _ = self.probe(slot["url"])
                if code is None:
                    # nothing is listening — the spawn never happened; the
                    # capacity gap re-spawns through the normal ladder
                    with self._lock:
                        slot["state"] = "down"
                    self._event("adopt_rollforward", slot=slot["slot"],
                                action="spawn", outcome="respawn_pending")
                    return
                orphan = self.port_pid(slot.get("port")) if slot.get("port") else None
                if orphan:
                    with self._lock:
                        slot["pid"] = int(orphan)
                        slot["state"] = "spawning"
                    if self._await_warm(slot) == "up":
                        with self._lock:
                            slot["state"] = "up"
                            slot["crashes"] = []
                        self._event("adopt_rollforward", slot=slot["slot"],
                                    action="spawn", outcome="orphan_adopted",
                                    pid=int(orphan))
                    else:
                        self._record_crash(slot, reason="orphan never warmed")
                else:
                    # something answers on the port but its pid is beyond
                    # reach: never spawn on top of it
                    with self._lock:
                        slot["state"] = "quarantined"
                    self._event("adopt_rollforward", slot=slot["slot"],
                                action="spawn", outcome="orphan_unmanaged")
        elif action == "drain":
            if pid and self.pid_alive(pid):
                self._event("adopt_rollforward", slot=slot["slot"],
                            action="drain", outcome="drain_reissued", pid=pid)
                row = self.drain(slot, self.policy.drain_timeout_s)
                with self._lock:
                    slot["pid"] = None
                    slot["state"] = "down"
                self._event("scale_down", slot=slot["slot"],
                            reason="rollforward", outcome="down",
                            drain=row.get("drain"),
                            drain_rc=row.get("drain_rc"),
                            spilled_sessions=self._count_spilled(slot))
            else:
                with self._lock:
                    slot["pid"] = None
                    slot["state"] = "down"
                self._event("adopt_rollforward", slot=slot["slot"],
                            action="drain", outcome="drain_settled")

    # -- predictive loop -----------------------------------------------

    def _forecast_histograms(self) -> Dict[str, Dict[int, int]]:
        """Per-verb true-size histograms over the sliding window of
        access.jsonl (outcome ok only — the buckets.py rule); lines without
        a parseable ts count conservatively."""
        out: Dict[str, Dict[int, int]] = {"adapt": {}, "predict": {}}
        horizon = self.wall() - self.policy.forecast_window_s
        try:
            with open(self.access_log) as f:
                lines = f.read().splitlines()
        except OSError:
            return out
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            verb, size = rec.get("verb"), rec.get("true_size")
            if verb not in out or size is None or rec.get("outcome") != "ok":
                continue
            ts = rec.get("ts")
            if isinstance(ts, (int, float)) and ts < horizon:
                continue
            hist = out[verb]
            hist[int(size)] = hist.get(int(size), 0) + 1
        return out

    def forecast_and_retune(self) -> Optional[Dict[str, Any]]:
        """Re-tune the bucket grid against the windowed traffic mix; when
        the waste cut clears the threshold, park the overrides for the next
        spawn. Returns the tune result when a retune was parked."""
        if not self.access_log or not (self.current_support or self.current_query):
            return None
        traffic = self._forecast_histograms()
        total = sum(sum(h.values()) for h in traffic.values())
        if total < self.policy.forecast_min_requests:
            return None
        result = buckets.tune(
            traffic, self.current_support, self.current_query,
            max_buckets=self.policy.max_buckets,
        )
        before = result.get("padding_waste_frac_before")
        after = result.get("padding_waste_frac_after")
        if before is None or after is None:
            return None
        improvement = round(before - after, 4)
        if improvement < self.policy.retune_waste_improvement:
            return None
        overrides = result.get("overrides") or []
        with self._lock:
            if overrides == self._pending_overrides:
                return None
            self._pending_overrides = list(overrides)
            self.counters["retunes"] += 1
        self._event("retune", overrides=overrides, requests=total,
                    waste_frac_before=before, waste_frac_after=after,
                    improvement=improvement,
                    window_s=self.policy.forecast_window_s)
        self.log(f"autoscaler: retune parked for next spawn "
                 f"(waste {before} -> {after}): {overrides}")
        return result

    # -- the control loop ----------------------------------------------

    def tick(self) -> str:
        """One control iteration. Returns the decision taken (for tests):
        "scale_up" | "scale_down" | "replace" | "spawn_retry" | "idle" |
        a spawn outcome ("backoff" / "quarantined")."""
        p = self.policy
        with self._lock:
            self.counters["ticks"] += 1
        now = self.clock()
        if self.access_log and (
            self._last_forecast_ts is None
            or now - self._last_forecast_ts >= p.forecast_interval_s
        ):
            self._last_forecast_ts = now
            self.forecast_and_retune()
        signals = self.collect_signals()

        # 1. a backend that disappeared without being asked is replaced
        dead = self._find_dead(signals)
        if dead is not None:
            with self._lock:
                pid = dead.get("pid")
                dead["pid"] = None
                dead["state"] = "down"
                self.counters["replacements"] += 1
            if pid and self.pid_alive(pid):
                # gateway-OUT + /healthz unreachable with the process still
                # standing: wedged beyond recovery — clear the slot hard
                self.kill9(pid)
                fleetctl.wait_pid_gone(pid, 10.0)
            self._event("backend_died", slot=dead["slot"], pid=pid,
                        signals=signals,
                        drain_rc=self._reaped_rcs.get(pid))
            self.log(f"autoscaler: slot {dead['slot']} died unasked "
                     f"(pid {pid}) — replacing")
            self._save()
            return "replace"

        # 2. capacity repair: running below target (bootstrap, a replaced
        # death, a crashed spawn past its backoff) — not cooldown-gated
        with self._lock:
            running = self._running()
            target = int(self.state.get("target", 0))
        if running < target:
            slot = self._spawnable_slot()
            if slot is not None:
                self._spawn_into(slot, reason="capacity_repair",
                                 signals=signals)
                return "spawn_retry"
            return "idle"

        # 3. hysteresis + per-direction cooldowns
        reasons = self._breach_reasons(signals)
        with self._lock:
            if reasons:
                self._up_streak += 1
                self._down_streak = 0
            elif self._is_clear(signals):
                self._down_streak += 1
                self._up_streak = 0
            else:
                self._up_streak = 0
                self._down_streak = 0

        if reasons and self._up_streak >= p.up_polls and running < p.max_backends:
            if self._last_up_ts is None or now - self._last_up_ts >= p.cooldown_up_s:
                slot = self._spawnable_slot()
                if slot is not None:
                    with self._lock:
                        self.state["target"] = min(p.max_backends, target + 1)
                        self.counters["scale_ups"] += 1
                    outcome = self._spawn_into(
                        slot, reason="; ".join(reasons), signals=signals
                    )
                    self._last_up_ts = self.clock()
                    self._up_streak = 0
                    return "scale_up" if outcome == "up" else outcome
        if self._down_streak >= p.down_polls and running > p.min_backends:
            if self._last_down_ts is None or now - self._last_down_ts >= p.cooldown_down_s:
                victim = None
                with self._lock:
                    ups = [s for s in self.state["slots"]
                           if s.get("state") == "up"]
                    if ups:
                        victim = max(ups, key=lambda s: s.get("slot", 0))
                if victim is not None:
                    with self._lock:
                        self.state["target"] = max(p.min_backends, target - 1)
                        self.counters["scale_downs"] += 1
                    self._drain_slot(
                        victim,
                        reason=f"clear for {self._down_streak} polls",
                        signals=signals,
                    )
                    self._last_down_ts = self.clock()
                    self._down_streak = 0
                    return "scale_down"
        return "idle"

    def _find_dead(self, signals: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        with self._lock:
            up_slots = [s for s in self.state["slots"] if s.get("state") == "up"]
        for slot in up_slots:
            pid = slot.get("pid")
            if pid and not self.pid_alive(pid):
                return slot
            if slot.get("url") in (signals.get("out_urls") or []):
                # the gateway already hysteresis-proved this backend OUT;
                # if it is also unreachable from here it is gone or wedged
                # (pid may survive as an unreapable zombie of another parent)
                code, _ = self.probe(slot["url"])
                if code is None:
                    return slot
        return None

    def run(self, max_ticks: int = 0) -> None:
        ticks = 0
        while not self._stop.is_set():
            self.tick()
            ticks += 1
            if max_ticks and ticks >= max_ticks:
                return
            self.sleep(self.policy.poll_interval_s)

    def stop(self) -> None:
        self._stop.set()

    # -- observability --------------------------------------------------

    def metrics_snapshot(self) -> Dict[str, Any]:
        p = self.policy
        now = self.clock()
        wall_now = self.wall()

        def _cooldown_left(last_ts, cooldown_s):
            if last_ts is None:
                return 0.0
            return round(max(0.0, cooldown_s - (now - last_ts)), 2)

        with self._lock:
            slots = [
                {
                    "slot": s.get("slot"),
                    "url": s.get("url"),
                    "state": s.get("state"),
                    "pid": s.get("pid"),
                    "crashes_in_window": len([
                        t for t in s.get("crashes", [])
                        if wall_now - t <= p.crash_window_s
                    ]),
                    "next_spawn_in_s": (
                        round(max(0.0, s["next_spawn_ts"] - wall_now), 2)
                        if s.get("next_spawn_ts") else None
                    ),
                }
                for s in self.state["slots"]
            ]
            return {
                "supervisor": True,
                "uptime_s": round(now - self._started, 1),
                "gateway_url": self.gateway_url,
                "target": self.state.get("target"),
                "running": self._running(),
                "min_backends": p.min_backends,
                "max_backends": p.max_backends,
                "streaks": {"up": self._up_streak, "down": self._down_streak},
                "cooldowns": {
                    "up_remaining_s": _cooldown_left(self._last_up_ts,
                                                     p.cooldown_up_s),
                    "down_remaining_s": _cooldown_left(self._last_down_ts,
                                                       p.cooldown_down_s),
                },
                "last_decision": self._last_decision,
                "signals": dict(self._last_signals),
                "pending_overrides": list(self._pending_overrides),
                "counters": dict(self.counters),
                "intent": self.state.get("intent"),
                "slots": slots,
            }


# ---------------------------------------------------------------------------
# the /metrics + /healthz endpoint (fleet_serve.py mounts this)


def run_supervisor_http(supervisor: Supervisor, host: str, port: int):
    """Serve the supervisor's /metrics + /healthz on a daemon thread;
    returns (server, bound_port)."""

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/metrics":
                code, body = 200, supervisor.metrics_snapshot()
            elif self.path == "/healthz":
                code, body = 200, {
                    "status": "ok", "supervisor": True,
                    "running": supervisor.metrics_snapshot()["running"],
                }
            else:
                code, body = 404, {"error": f"unknown path {self.path}"}
            blob = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def log_message(self, fmt, *args):  # quiet by default
            pass

    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="supervisor-http")
    thread.start()
    return server, server.server_address[1]
