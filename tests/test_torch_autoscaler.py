"""The port's fleet supervisor (``serving/autoscaler.py``, with
``serving/fleetctl.py``) against the JAX package's, on the CPU: the
decision matrix of ``tests/test_autoscaler.py`` on a fake clock with zero
subprocesses — hysteresis windows + per-direction cooldowns, min/max
clamps, the crash-loop backoff ladder -> quarantine, dead-backend
replacement, write-ahead journaling + adopt-on-restart per interrupted
action, forecast -> retune -> overrides on the next spawn, and the Policy
<-> ``config.AutoscaleConfig`` defaults pin — each case once per package
(the autouse ``package`` fixture loads that package's module by file path,
as its CLI does). Added: the same scripted fleet drives both packages'
supervisors to the same decisions and journal, and the signal collector
reads the ``/metrics`` of a real port server (tenant mode, so the pager
keys are there) behind a real port gateway.

Every collaborator (clock, wall, sleep, fetch, spawn, drain, probe,
pid_alive, kill9, port_pid) is injected, so each test drives the real
control loop deterministically.
"""

import dataclasses
import importlib
import importlib.util
import json
import os
import socket
import sys
import threading
import time
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": "howtotrainyourmamlpytorch_tpu", "torch": "howtotrainyourmamlpytorch_tpu_torch"}


def _load_by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MODULES = {
    key: _load_by_path(f"t_autoscaler_{key}", os.path.join(REPO, pkg, "serving", "autoscaler.py"))
    for key, pkg in PACKAGES.items()
}
autoscaler = fleetctl = None  # the package under test, set per test below


@pytest.fixture(params=sorted(PACKAGES), autouse=True)
def package(request):
    """Run each case against one package's supervisor."""
    global autoscaler, fleetctl
    autoscaler = MODULES[request.param]
    fleetctl = autoscaler.fleetctl
    yield request.param
    autoscaler = fleetctl = None


GW_URL = "http://127.0.0.1:9099"
BASE_PORT = 9100
# fake pids above the Linux default pid_max (4194304): they can never name a
# real process, so the few real liveness probes (fleetctl.wait_pid_gone in
# the kill9 escalation paths) resolve "gone" instantly
FAKE_PID_BASE = 4_500_000


class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.wall0 = 1_000_000.0

    def clock(self):
        return self.t

    def wall(self):
        return self.wall0 + self.t

    def sleep(self, s):
        self.t += s


class FakeFleet:
    """A fake process estate: scripted per-slot spawn behavior
    ('ok' | 'die' | 'never_warm'), pid liveness/health sets, canned gateway
    and backend /metrics payloads, and a journal snapshot taken at every
    spawn call (to prove write-ahead ordering)."""

    def __init__(self):
        self.next_pid = FAKE_PID_BASE
        self.behavior = {}
        self.slot_pid = {}
        self.alive = set()
        self.healthy = set()
        self.force_healthy_ports = set()
        self.spawns = []
        self.drains = []
        self.kills = []
        self.gateway_metrics = None
        self.backend_metrics = {}
        self.journal_at_spawn = []
        self.state_path = None

    def preoccupy(self, slot_id):
        """A backend that is already running + healthy on this slot."""
        pid = self.next_pid
        self.next_pid += 1
        self.slot_pid[slot_id] = pid
        self.alive.add(pid)
        self.healthy.add(pid)
        return pid

    def die(self, slot_id):
        """kill -9 the backend on this slot (unasked, out of band)."""
        pid = self.slot_pid[slot_id]
        self.alive.discard(pid)
        self.healthy.discard(pid)
        return pid

    def spawn(self, entry, extra):
        self.spawns.append((entry["slot"], list(extra) if extra else None))
        if self.state_path and os.path.exists(self.state_path):
            with open(self.state_path) as f:
                self.journal_at_spawn.append(json.load(f))
        pid = self.next_pid
        self.next_pid += 1
        self.slot_pid[entry["slot"]] = pid
        behavior = self.behavior.get(entry["slot"], "ok")
        if behavior != "die":
            self.alive.add(pid)
        if behavior == "ok":
            self.healthy.add(pid)
        return pid

    def drain(self, entry, timeout_s):
        self.drains.append(entry["slot"])
        self.alive.discard(entry.get("pid"))
        self.healthy.discard(entry.get("pid"))
        return {"url": entry["url"], "old_pid": entry.get("pid"),
                "drain": "sigterm_sent", "drain_rc": 0, "drain_s": 0.1}

    def pid_alive(self, pid):
        return pid in self.alive

    def kill9(self, pid):
        self.kills.append(pid)
        self.alive.discard(pid)
        self.healthy.discard(pid)

    def probe(self, url):
        port = int(url.rstrip("/").rsplit(":", 1)[1])
        if port in self.force_healthy_ports:
            return 200, {"status": "ok"}
        pid = self.slot_pid.get(port - BASE_PORT)
        if pid is not None and pid in self.healthy:
            return 200, {"status": "ok"}
        return None, {}

    def fetch(self, url):
        if url.startswith(GW_URL):
            return self.gateway_metrics
        port = int(url.split("//", 1)[1].split("/", 1)[0].rsplit(":", 1)[1])
        return self.backend_metrics.get(port - BASE_PORT)


def gw(requests=0, shed=0, backends=None, backends_in=None):
    return {"gateway": True, "requests": requests, "admission_shed": shed,
            "no_backend": 0, "backends_in": backends_in,
            "backends": backends or []}


def _slots(n):
    return [
        {"url": f"http://127.0.0.1:{BASE_PORT + i}", "port": BASE_PORT + i,
         "respawn": ["python", "scripts/serve.py", "exps/run",
                     "--port", str(BASE_PORT + i)]}
        for i in range(n)
    ]


def make_supervisor(tmp_path, fleet=None, clk=None, n_slots=3, pids_for=(),
                    port_pid=None, access_log=None, support=None, query=None,
                    **policy):
    clk = clk or FakeClock()
    fleet = fleet or FakeFleet()
    slots = _slots(n_slots)
    for i in pids_for:
        slots[i]["pid"] = fleet.preoccupy(i)
    state_path = os.path.join(str(tmp_path), "fleet_state.json")
    fleet.state_path = state_path
    sup = autoscaler.Supervisor(
        state_path,
        autoscaler.Policy(**policy),
        GW_URL,
        events_path=os.path.join(str(tmp_path), "events.jsonl"),
        access_log=access_log,
        current_support=support,
        current_query=query,
        clock=clk.clock, wall=clk.wall, sleep=clk.sleep,
        fetch=fleet.fetch, spawn=fleet.spawn, drain=fleet.drain,
        probe=fleet.probe, pid_alive=fleet.pid_alive, kill9=fleet.kill9,
        port_pid=port_pid or (lambda port: None),
        log=lambda m: None,
    )
    return sup, fleet, clk, slots


def _events(tmp_path, name=None):
    path = os.path.join(str(tmp_path), "events.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        out = [json.loads(line) for line in f if line.strip()]
    return [e for e in out if name is None or e["event"] == name]


def _disk_state(sup):
    with open(sup.state_path) as f:
        return json.load(f)


def _queue(fleet, depth, *slots):
    for i in slots:
        fleet.backend_metrics[i] = {"adapt_batcher": {"queue_depth": depth}}


# ---------------------------------------------------------------------------
# policy + config cross-pins
# ---------------------------------------------------------------------------


def test_policy_validates_knobs():
    autoscaler.Policy()  # defaults are self-consistent
    with pytest.raises(ValueError, match="unknown policy knobs"):
        autoscaler.Policy(replicas=3)
    with pytest.raises(ValueError, match="min_backends"):
        autoscaler.Policy(min_backends=-1)
    with pytest.raises(ValueError, match="max_backends"):
        autoscaler.Policy(min_backends=3, max_backends=2)
    with pytest.raises(ValueError, match="up_polls"):
        autoscaler.Policy(up_polls=0)
    with pytest.raises(ValueError, match="poll_interval_s"):
        autoscaler.Policy(poll_interval_s=0)


def test_policy_defaults_pinned_to_autoscale_config(package):
    """The import-light Policy and the yaml-facing config.AutoscaleConfig
    of the same package document the same knobs with the same defaults —
    pinned so they cannot drift apart."""
    AutoscaleConfig = importlib.import_module(f"{PACKAGES[package]}.config").AutoscaleConfig

    cfg = AutoscaleConfig()
    assert cfg.enabled is False  # the off-switch default
    cfg_fields = {f.name for f in dataclasses.fields(AutoscaleConfig)}
    assert cfg_fields - {"enabled"} == set(autoscaler.Policy.DEFAULTS)
    for knob, default in autoscaler.Policy.DEFAULTS.items():
        assert getattr(cfg, knob) == default, knob


def test_off_switch_package_import_never_loads_supervisor(package):
    """Disabled-by-default means disabled-by-construction: importing the
    package (or its serving subpackage) must not load the supervisor — with
    autoscaling off there is no new module, file, thread, or process."""
    name = PACKAGES[package]
    serving = importlib.import_module(f"{name}.serving")
    assert f"{name}.serving.autoscaler" not in sys.modules
    assert f"{name}.serving.fleetctl" not in sys.modules
    assert not hasattr(serving, "Supervisor")


# ---------------------------------------------------------------------------
# fleetctl: the shared fleet-state schema
# ---------------------------------------------------------------------------


def test_fleet_state_legacy_list_normalizes_and_round_trips(tmp_path):
    legacy = [{"url": "http://a", "pid": 11, "respawn": ["x"]},
              {"url": "http://b", "pid": 22, "respawn": ["y"]}]
    state = fleetctl.normalize_fleet_state(legacy)
    assert state["version"] == fleetctl.FLEET_STATE_VERSION
    assert [s["slot"] for s in state["slots"]] == [0, 1]
    assert all(s["state"] == "up" for s in state["slots"])
    assert state["intent"] is None
    path = str(tmp_path / "fleet_state.json")
    fleetctl.save_fleet_state(path, state)
    again = fleetctl.load_fleet_state(path)
    assert [s["url"] for s in again["slots"]] == ["http://a", "http://b"]


def test_fleet_state_rejects_garbage():
    with pytest.raises(ValueError, match="non-empty"):
        fleetctl.normalize_fleet_state([])
    with pytest.raises(ValueError, match="version"):
        fleetctl.normalize_fleet_state({"version": 99, "slots": [{}]})
    with pytest.raises(ValueError, match="unknown state"):
        fleetctl.normalize_fleet_state({
            "version": 1, "slots": [{"url": "http://a", "state": "zombie"}],
        })
    with pytest.raises(ValueError, match="list or dict"):
        fleetctl.normalize_fleet_state("nope")


def test_find_pid_by_port_locates_our_listener():
    sock = socket.socket()
    try:
        sock.bind(("127.0.0.1", 0))
        sock.listen(1)
        port = sock.getsockname()[1]
        found = autoscaler.find_pid_by_port(port)
        if found is None:
            pytest.skip("/proc scan unavailable on this platform")
        assert found == os.getpid()
    finally:
        sock.close()
    assert autoscaler.find_pid_by_port(1) is None  # nothing listens there


# ---------------------------------------------------------------------------
# reactive loop: capacity, hysteresis, cooldowns, clamps
# ---------------------------------------------------------------------------


def test_bootstrap_spawns_up_to_min_backends(tmp_path):
    sup, fleet, clk, slots = make_supervisor(tmp_path, min_backends=2)
    assert sup.load_or_init(slots) == "initialized"
    assert sup.tick() == "spawn_retry"
    assert sup.tick() == "spawn_retry"
    assert sup.tick() == "idle"
    assert [s for s, _ in fleet.spawns] == [0, 1]
    disk = _disk_state(sup)
    assert disk["intent"] is None
    assert [s["state"] for s in disk["slots"]] == ["up", "up", "down"]
    assert disk["slots"][0]["pid"] == fleet.slot_pid[0]


def test_scale_up_needs_consecutive_breach_polls(tmp_path):
    sup, fleet, clk, _slots_ = make_supervisor(
        tmp_path, pids_for=(0,), up_polls=2, queue_high=8.0,
    )
    sup.load_or_init(_slots_)
    fleet.gateway_metrics = gw()
    _queue(fleet, 10, 0)  # breach
    assert sup.tick() == "idle"  # streak 1/2
    _queue(fleet, 0, 0)  # a clear tick resets the streak
    assert sup.tick() == "idle"
    _queue(fleet, 10, 0)
    assert sup.tick() == "idle"  # streak back to 1/2
    assert sup.tick() == "scale_up"
    assert [s for s, _ in fleet.spawns] == [1]
    (event,) = _events(tmp_path, "scale_up")
    assert "queue_depth" in event["reason"]
    assert event["signals"]["queue_depth"] == 10
    assert event["pid"] == fleet.slot_pid[1]
    assert isinstance(event["settle_s"], float)


def test_scale_up_cooldown_blocks_then_releases(tmp_path):
    sup, fleet, clk, _slots_ = make_supervisor(
        tmp_path, pids_for=(0,), up_polls=1, cooldown_up_s=10.0,
    )
    sup.load_or_init(_slots_)
    fleet.gateway_metrics = gw()
    _queue(fleet, 10, 0, 1, 2)
    assert sup.tick() == "scale_up"
    for _ in range(3):  # still breaching, but inside the cooldown
        assert sup.tick() == "idle"
    assert len(fleet.spawns) == 1
    clk.sleep(10.1)
    assert sup.tick() == "scale_up"
    assert [s for s, _ in fleet.spawns] == [1, 2]


def test_scale_up_never_exceeds_max_backends(tmp_path):
    sup, fleet, clk, _slots_ = make_supervisor(
        tmp_path, n_slots=2, pids_for=(0, 1), max_backends=2, up_polls=1,
    )
    sup.load_or_init(_slots_)
    fleet.gateway_metrics = gw()
    _queue(fleet, 50, 0, 1)
    for _ in range(5):
        assert sup.tick() == "idle"
    assert fleet.spawns == []


def test_scale_down_clear_polls_victim_rank_and_min_floor(tmp_path):
    sup, fleet, clk, _slots_ = make_supervisor(
        tmp_path, pids_for=(0, 1, 2), min_backends=1, down_polls=3,
        cooldown_down_s=5.0,
    )
    sup.load_or_init(_slots_)
    fleet.gateway_metrics = gw()
    _queue(fleet, 0, 0, 1, 2)  # clear on every backend
    assert sup.tick() == "idle"
    assert sup.tick() == "idle"
    assert sup.tick() == "scale_down"
    assert fleet.drains == [2]  # the lowest-ranked backend (highest slot)
    assert sup.tick() == "idle"  # streak restarts at 1; cooldown active
    clk.sleep(5.1)
    assert sup.tick() == "idle"  # streak 2 (a cooldown does not reset it)
    assert sup.tick() == "scale_down"  # streak 3, cooldown elapsed
    assert fleet.drains == [2, 1]
    clk.sleep(5.1)
    for _ in range(6):  # at the min_backends floor: never drains the last
        assert sup.tick() == "idle"
    assert fleet.drains == [2, 1]
    down_events = _events(tmp_path, "scale_down")
    assert [e["slot"] for e in down_events] == [2, 1]
    assert all(e["drain_rc"] == 0 for e in down_events)


def test_breach_reasons_cover_all_signals(tmp_path):
    sup, _, _, _ = make_supervisor(tmp_path, page_in_p50_high_ms=50.0)
    base = {"queue_depth": None, "shed_rate": None, "shed_delta": 0,
            "evict_delta": 0, "page_in_p50_ms": None}
    assert sup._breach_reasons(base) == []
    reasons = sup._breach_reasons({
        **base, "queue_depth": 9.0, "shed_rate": 0.5, "shed_delta": 3,
        "evict_delta": 7, "page_in_p50_ms": 80.0,
    })
    assert len(reasons) == 4
    assert any("queue_depth" in r for r in reasons)
    assert any("shed_rate" in r for r in reasons)
    assert any("evictions" in r for r in reasons)
    assert any("page_in" in r for r in reasons)
    # shed below threshold or with no shed volume is not a breach
    assert sup._breach_reasons({**base, "shed_rate": 0.01, "shed_delta": 1}) == []
    assert sup._breach_reasons({**base, "shed_rate": 1.0, "shed_delta": 0}) == []


def test_collect_signals_gateway_deltas_and_out_urls(tmp_path):
    sup, fleet, clk, _slots_ = make_supervisor(tmp_path, pids_for=(0,))
    sup.load_or_init(_slots_)
    fleet.gateway_metrics = gw(requests=100, shed=0)
    first = sup.collect_signals()
    assert first["gateway"] and first["shed_rate"] is None  # no delta yet
    fleet.gateway_metrics = gw(
        requests=120, shed=6,
        backends=[{"url": "http://127.0.0.1:9101", "state": "out",
                   "flaps": 2}],
    )
    second = sup.collect_signals()
    assert second["requests_delta"] == 20
    assert second["shed_delta"] == 6
    assert second["shed_rate"] == 0.3
    assert second["out_urls"] == ["http://127.0.0.1:9101"]


# ---------------------------------------------------------------------------
# crash-loop ladder + dead-backend replacement
# ---------------------------------------------------------------------------


def test_crash_loop_backoff_ladder_then_quarantine(tmp_path):
    sup, fleet, clk, _slots_ = make_supervisor(
        tmp_path, n_slots=1, min_backends=1, crash_max=3,
        backoff_base_s=0.5, backoff_max_s=30.0, crash_window_s=60.0,
    )
    fleet.behavior[0] = "die"
    sup.load_or_init(_slots_)
    assert sup.tick() == "spawn_retry"  # attempt 1 dies
    assert len(fleet.spawns) == 1
    assert sup.tick() == "idle"  # backoff not elapsed: NO hot respawn
    assert len(fleet.spawns) == 1
    disk = _disk_state(sup)
    assert disk["slots"][0]["next_spawn_ts"] == pytest.approx(
        clk.wall() + 0.5, abs=1e-6
    )
    clk.sleep(0.6)
    assert sup.tick() == "spawn_retry"  # attempt 2: backoff doubled
    assert _disk_state(sup)["slots"][0]["next_spawn_ts"] == pytest.approx(
        clk.wall() + 1.0, abs=1e-6
    )
    clk.sleep(1.1)
    sup.tick()  # attempt 3 -> quarantine
    assert len(fleet.spawns) == 3
    assert _disk_state(sup)["slots"][0]["state"] == "quarantined"
    assert sup.counters["quarantines"] == 1
    for _ in range(5):  # quarantined is never respawned hot
        clk.sleep(60.0)
        assert sup.tick() == "idle"
    assert len(fleet.spawns) == 3
    assert len(_events(tmp_path, "spawn_crash")) == 2
    (q,) = _events(tmp_path, "quarantine")
    assert q["slot"] == 0 and q["crashes"] == 3


def test_warm_timeout_walks_the_same_ladder(tmp_path):
    sup, fleet, clk, _slots_ = make_supervisor(
        tmp_path, n_slots=1, min_backends=1,
        warm_timeout_s=2.0, warm_poll_s=0.5,
    )
    fleet.behavior[0] = "never_warm"
    sup.load_or_init(_slots_)
    sup.tick()
    pid = fleet.spawns and fleet.slot_pid[0]
    assert fleet.kills == [pid]  # a never-warm spawn is cleared hard
    (crash,) = _events(tmp_path, "spawn_crash")
    assert "warm_timeout" in crash["reason"]
    assert _disk_state(sup)["slots"][0]["state"] == "down"


def test_dead_backend_is_replaced_through_capacity_repair(tmp_path):
    sup, fleet, clk, _slots_ = make_supervisor(
        tmp_path, pids_for=(0, 1), min_backends=1,
    )
    sup.load_or_init(_slots_)
    old_pid = fleet.die(0)  # kill -9, out of band
    assert sup.tick() == "replace"
    (died,) = _events(tmp_path, "backend_died")
    assert died["slot"] == 0 and died["pid"] == old_pid
    assert sup.counters["replacements"] == 1
    assert sup.tick() == "spawn_retry"  # running 1 < target 2, no cooldown
    assert _disk_state(sup)["slots"][0]["state"] == "up"
    assert _disk_state(sup)["slots"][0]["pid"] != old_pid


def test_wedged_backend_gateway_out_probe_dead_is_killed_and_replaced(tmp_path):
    """A pid that still answers kill(pid, 0) but is OUT at the gateway and
    unreachable over HTTP (wedged / unreapable zombie) must be cleared
    hard and replaced."""
    sup, fleet, clk, _slots_ = make_supervisor(tmp_path, pids_for=(0, 1))
    sup.load_or_init(_slots_)
    pid = fleet.slot_pid[0]
    fleet.healthy.discard(pid)  # alive but wedged: probe now fails
    fleet.gateway_metrics = gw(
        backends=[{"url": "http://127.0.0.1:9100", "state": "out", "flaps": 1}],
    )
    assert sup.tick() == "replace"
    assert fleet.kills == [pid]
    (died,) = _events(tmp_path, "backend_died")
    assert died["slot"] == 0


# ---------------------------------------------------------------------------
# crash-safe control: write-ahead journal + adopt-on-restart
# ---------------------------------------------------------------------------


def test_spawn_is_journaled_write_ahead(tmp_path):
    """At the moment the spawn actually happens, the intent is already on
    disk — a supervisor killed inside spawn() leaves a rollable journal."""
    sup, fleet, clk, _slots_ = make_supervisor(tmp_path, min_backends=1)
    sup.load_or_init(_slots_)
    sup.tick()
    (snap,) = fleet.journal_at_spawn
    assert snap["intent"]["action"] == "spawn"
    assert snap["intent"]["slot"] == 0
    assert snap["slots"][0]["state"] == "spawning"
    assert snap["slots"][0]["pid"] is None  # pid lands right after Popen
    assert _disk_state(sup)["intent"] is None  # settled after warm


def test_interrupted_spawn_leaves_journal_and_next_supervisor_settles(tmp_path):
    """Stop mid-warm (SIGTERM during a spawn): the backend is NOT killed,
    the intent + pid stay journaled, and the next supervisor's adopt rolls
    the spawn forward without double-spawning."""
    sup, fleet, clk, _slots_ = make_supervisor(
        tmp_path, n_slots=1, min_backends=1,
    )
    fleet.behavior[0] = "never_warm"
    sup.load_or_init(_slots_)
    sup.stop()
    sup.tick()
    pid = fleet.slot_pid[0]
    disk = _disk_state(sup)
    assert disk["intent"]["action"] == "spawn"
    assert disk["slots"][0]["pid"] == pid
    assert pid in fleet.alive  # never killed on supervisor exit
    # --- restart: the backend has finished warming in the meantime
    fleet.healthy.add(pid)
    sup2, fleet, clk, _ = make_supervisor(
        tmp_path, fleet=fleet, n_slots=1, min_backends=1,
    )
    assert sup2.load_or_init(None) == "adopted"
    assert len(fleet.spawns) == 1  # no double-spawn
    assert _disk_state(sup2)["intent"] is None
    assert _disk_state(sup2)["slots"][0]["state"] == "up"
    (rf,) = _events(tmp_path, "adopt_rollforward")
    assert rf["outcome"] == "spawn_settled" and rf["pid"] == pid


def _craft_state(tmp_path, slots, intent=None, target=None):
    path = os.path.join(str(tmp_path), "fleet_state.json")
    fleetctl.save_fleet_state(path, {
        "version": 1, "slots": slots, "intent": intent,
        "target": target if target is not None else None,
    })
    return path


def test_adopt_live_and_dead_backends(tmp_path):
    fleet = FakeFleet()
    live_pid = fleet.preoccupy(0)
    slots = _slots(2)
    slots[0].update(slot=0, pid=live_pid, state="up")
    slots[1].update(slot=1, pid=FAKE_PID_BASE + 77, state="up")  # dead
    _craft_state(tmp_path, slots, target=2)
    sup, fleet, clk, _ = make_supervisor(tmp_path, fleet=fleet, min_backends=1)
    assert sup.load_or_init(None) == "adopted"
    assert sup.counters["adopted"] == 1
    disk = _disk_state(sup)
    assert disk["slots"][0]["state"] == "up"
    assert disk["slots"][1]["state"] == "down"
    assert disk["slots"][1]["pid"] is None
    (dead,) = _events(tmp_path, "adopt_found_dead")
    assert dead["slot"] == 1
    (start,) = _events(tmp_path, "supervisor_start")
    assert start["mode"] == "adopted" and start["found_dead"] == 1
    assert sup.tick() == "spawn_retry"  # target 2: the gap is repaired


def test_rollforward_spawn_with_no_pid_and_silent_port_respawns(tmp_path):
    """Killed between intent-write and Popen: nothing listens on the slot's
    port -> the spawn never happened; capacity repair re-spawns it."""
    slots = _slots(1)
    slots[0].update(slot=0, state="spawning", pid=None)
    _craft_state(tmp_path, slots, intent={"id": 0, "action": "spawn",
                                          "slot": 0, "ts": 1.0}, target=1)
    sup, fleet, clk, _ = make_supervisor(tmp_path, n_slots=1, min_backends=1)
    sup.load_or_init(None)
    (rf,) = _events(tmp_path, "adopt_rollforward")
    assert rf["outcome"] == "respawn_pending"
    assert sup.tick() == "spawn_retry"
    assert len(fleet.spawns) == 1


def test_rollforward_adopts_orphan_by_port(tmp_path):
    """Killed between Popen and journaling the pid: the orphan is found by
    port -> pid probe and adopted — never spawned on top of."""
    orphan_pid = FAKE_PID_BASE + 900
    slots = _slots(1)
    slots[0].update(slot=0, state="spawning", pid=None)
    _craft_state(tmp_path, slots, intent={"id": 0, "action": "spawn",
                                          "slot": 0, "ts": 1.0}, target=1)
    fleet = FakeFleet()
    fleet.force_healthy_ports.add(BASE_PORT)
    fleet.alive.add(orphan_pid)
    sup, fleet, clk, _ = make_supervisor(
        tmp_path, fleet=fleet, n_slots=1, min_backends=1,
        port_pid=lambda port: orphan_pid if port == BASE_PORT else None,
    )
    sup.load_or_init(None)
    (rf,) = _events(tmp_path, "adopt_rollforward")
    assert rf["outcome"] == "orphan_adopted" and rf["pid"] == orphan_pid
    disk = _disk_state(sup)
    assert disk["slots"][0]["state"] == "up"
    assert disk["slots"][0]["pid"] == orphan_pid
    assert fleet.spawns == []


def test_rollforward_unmanageable_orphan_quarantines_the_slot(tmp_path):
    """Something answers on the slot's port but its pid is beyond reach:
    never spawn onto an occupied port."""
    slots = _slots(1)
    slots[0].update(slot=0, state="spawning", pid=None)
    _craft_state(tmp_path, slots, intent={"id": 0, "action": "spawn",
                                          "slot": 0, "ts": 1.0}, target=1)
    fleet = FakeFleet()
    fleet.force_healthy_ports.add(BASE_PORT)
    sup, fleet, clk, _ = make_supervisor(
        tmp_path, fleet=fleet, n_slots=1, min_backends=1,
    )
    sup.load_or_init(None)
    (rf,) = _events(tmp_path, "adopt_rollforward")
    assert rf["outcome"] == "orphan_unmanaged"
    assert _disk_state(sup)["slots"][0]["state"] == "quarantined"
    assert sup.tick() == "idle"  # never spawns over it
    assert fleet.spawns == []


def test_rollforward_reissues_interrupted_drain(tmp_path):
    fleet = FakeFleet()
    pid = fleet.preoccupy(1)
    slots = _slots(2)
    slots[0].update(slot=0, pid=fleet.preoccupy(0), state="up")
    slots[1].update(slot=1, pid=pid, state="draining")
    _craft_state(tmp_path, slots, intent={"id": 3, "action": "drain",
                                          "slot": 1, "ts": 1.0}, target=1)
    sup, fleet, clk, _ = make_supervisor(tmp_path, fleet=fleet, min_backends=1)
    sup.load_or_init(None)
    assert fleet.drains == [1]
    (rf,) = _events(tmp_path, "adopt_rollforward")
    assert rf["outcome"] == "drain_reissued" and rf["pid"] == pid
    disk = _disk_state(sup)
    assert disk["slots"][1]["state"] == "down"
    assert disk["intent"] is None


# ---------------------------------------------------------------------------
# predictive loop: forecast -> retune -> prewarm on next spawn
# ---------------------------------------------------------------------------


def _write_access(tmp_path, rows):
    path = os.path.join(str(tmp_path), "access.jsonl")
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return path


def test_forecast_retune_parks_and_prewarms_next_spawn(tmp_path):
    clk = FakeClock()
    # 30 ok adapt requests of true size 2 against a [16] grid: waste 0.875;
    # the tuned [2] grid wastes 0 — far past the 0.10 improvement gate
    access = _write_access(tmp_path, [
        {"ts": clk.wall0, "verb": "adapt", "true_size": 2, "outcome": "ok"}
        for _ in range(30)
    ])
    sup, fleet, clk, _slots_ = make_supervisor(
        tmp_path, clk=clk, n_slots=1, min_backends=1,
        access_log=access, support=[16], query=[16],
        forecast_interval_s=5.0, forecast_min_requests=20,
    )
    sup.load_or_init(_slots_)
    sup.tick()  # forecast runs first, then capacity repair spawns slot 0
    (retune,) = _events(tmp_path, "retune")
    assert retune["overrides"] == ["serving.support_buckets=[2]"]
    assert retune["requests"] == 30
    assert retune["improvement"] == pytest.approx(0.875, abs=1e-4)
    # the tuned grid rode the spawn argv — prewarm, never a live recompile
    assert fleet.spawns == [(0, ["serving.support_buckets=[2]"])]
    # the applied grid is the new forecast baseline; nothing stays parked
    assert sup.current_support == [2]
    assert sup._pending_overrides == []
    assert _disk_state(sup)["slots"][0]["overrides"] == [
        "serving.support_buckets=[2]"
    ]


def test_forecast_below_improvement_or_volume_parks_nothing(tmp_path):
    clk = FakeClock()
    # marginal win: sizes 15/16 on a [16] grid -> ~0.03 improvement < 0.10
    access = _write_access(tmp_path, (
        [{"ts": clk.wall0, "verb": "adapt", "true_size": 15, "outcome": "ok"}]
        * 15
        + [{"ts": clk.wall0, "verb": "adapt", "true_size": 16, "outcome": "ok"}]
        * 15
    ))
    sup, fleet, clk, _ = make_supervisor(
        tmp_path, clk=clk, n_slots=1, access_log=access, support=[16],
        query=[16],
    )
    assert sup.forecast_and_retune() is None
    assert sup._pending_overrides == []
    # volume gate: plenty of waste but too few requests to trust
    access2 = _write_access(tmp_path, [
        {"ts": clk.wall0, "verb": "adapt", "true_size": 2, "outcome": "ok"}
        for _ in range(5)
    ])
    sup.access_log = access2
    assert sup.forecast_and_retune() is None
    assert _events(tmp_path, "retune") == []


def test_forecast_window_excludes_stale_traffic(tmp_path):
    clk = FakeClock()
    clk.t = 1000.0  # so wall() - window stays positive and meaningful
    stale_ts = clk.wall() - 10_000.0
    access = _write_access(tmp_path, [
        {"ts": stale_ts, "verb": "adapt", "true_size": 2, "outcome": "ok"}
        for _ in range(50)
    ] + [
        {"ts": clk.wall(), "verb": "adapt", "true_size": 8, "outcome": "ok"}
        for _ in range(25)
    ])
    sup, fleet, clk, _ = make_supervisor(
        tmp_path, clk=clk, n_slots=1, access_log=access, support=[16],
        query=[16], forecast_window_s=300.0,
    )
    hist = sup._forecast_histograms()
    assert hist["adapt"] == {8: 25}  # the stale size-2 burst is gone
    result = sup.forecast_and_retune()
    assert result is not None
    assert sup._pending_overrides == ["serving.support_buckets=[8]"]


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def test_metrics_snapshot_shape_and_marker(tmp_path):
    sup, fleet, clk, _slots_ = make_supervisor(
        tmp_path, pids_for=(0,), min_backends=1, up_polls=1,
    )
    sup.load_or_init(_slots_)
    fleet.gateway_metrics = gw()
    _queue(fleet, 10, 0)
    sup.tick()  # scale_up
    snap = sup.metrics_snapshot()
    assert snap["supervisor"] is True  # the obs_top auto-detect marker
    assert snap["running"] == 2 and snap["target"] == 2
    assert snap["last_decision"]["event"] == "scale_up"
    assert snap["cooldowns"]["up_remaining_s"] > 0
    assert snap["counters"]["scale_ups"] == 1
    assert snap["intent"] is None
    states = {s["slot"]: s["state"] for s in snap["slots"]}
    assert states == {0: "up", 1: "up", 2: "down"}
    json.dumps(snap)  # the whole payload must be wire-serializable


# ---------------------------------------------------------------------------
# the port against JAX on one script; the port's serve CLI; a real payload
# ---------------------------------------------------------------------------


def _scripted_run(module, tmp_path):
    """A fixed script through one package's supervisor: bootstrap, a queue
    breach, a kill -9, a die-on-spawn slot, then clear polls. Returns the
    tick decisions, the events without their timestamps and the journal."""
    global autoscaler, fleetctl
    saved = autoscaler, fleetctl
    autoscaler, fleetctl = module, module.fleetctl
    try:
        sup, fleet, clk, slots = make_supervisor(
            tmp_path, n_slots=4, min_backends=1, max_backends=3, up_polls=2, down_polls=2,
            cooldown_up_s=0.0, cooldown_down_s=0.0, crash_max=2, backoff_base_s=0.5,
        )
        sup.load_or_init(slots)
        decisions = []

        def tick(n=1):
            for _ in range(n):
                decisions.append(sup.tick())
                clk.sleep(1.0)

        fleet.gateway_metrics = gw(requests=10)
        _queue(fleet, 0, 0)
        tick(2)  # bootstrap slot 0, then idle
        _queue(fleet, 12, 0)
        tick(3)  # breach x2 -> scale up into slot 1
        _queue(fleet, 0, 0, 1)
        fleet.die(1)
        tick(2)  # replace, then respawn slot 1
        fleet.behavior[2] = "die"
        _queue(fleet, 12, 0, 1)
        tick(4)  # breach -> slot 2 dies on spawn: the ladder
        _queue(fleet, 0, 0, 1)
        fleet.gateway_metrics = gw(requests=20)
        tick(4)  # clear polls -> scale down
        events = [{k: v for k, v in e.items() if k != "ts"} for e in _events(tmp_path)]
        journal = _disk_state(sup)
        journal.pop("updated", None)
        return decisions, events, journal, fleet.spawns, fleet.drains
    finally:
        autoscaler, fleetctl = saved


def test_same_script_same_decisions_as_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _scripted_run(MODULES["jax"], tmp_path / "jax")
    got = _scripted_run(MODULES["torch"], tmp_path / "torch")
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert json.dumps(got[2], sort_keys=True).replace(str(tmp_path / "torch"), "ROOT") == json.dumps(
        want[2], sort_keys=True).replace(str(tmp_path / "jax"), "ROOT")
    assert got[3:] == want[3:]
    assert {"scale_up", "backend_died", "spawn_crash", "scale_down"} <= {e["event"] for e in got[1]}


def test_port_serve_cli_takes_parked_overrides(tmp_path, package):
    """A retune's overrides ride the next spawn of a slot whose respawn is
    the port's serve CLI (``python -m howtotrainyourmamlpytorch_tpu_torch.serve``
    takes ``key=value`` overrides after its flags); JAX's supervisor knows
    only its own ``serve.py``."""
    sup, fleet, clk, slots = make_supervisor(tmp_path, n_slots=1)
    slot = {**slots[0], "respawn": [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.serve", "run",
                                    "--port", "9100", "--device", "cpu"]}
    assert sup._accepts_overrides(slot) == (package == "torch")
    assert sup._accepts_overrides({**slot, "accepts_overrides": False}) is False


def test_collect_signals_reads_a_real_port_server(tmp_path):
    """The supervisor's signal collector over the /metrics of a real port
    server (tenant mode, a budget of one master, so tenants evict) behind a
    real port gateway: the batcher queue depths, the pager's evictions and
    page-in p50, and the gateway's request, shed and membership keys are
    where the collector reads them."""
    from howtotrainyourmamlpytorch_tpu_torch.serving import (
        AdaptationEngine,
        Gateway,
        ServingFrontend,
        make_gateway_server,
        make_http_server,
    )
    from howtotrainyourmamlpytorch_tpu_torch.serving.registry import synthetic_registry
    from howtotrainyourmamlpytorch_tpu_torch.serving.tenancy import master_bytes
    from tests.test_torch_tenancy import _episode, _system

    system = _system(support_buckets=[16], query_buckets=[16])
    state = system.init_train_state()
    registry = synthetic_registry(["t0", "t1"], state, str(tmp_path / "tenants"), seed=3,
                                  feature_shape=system.model.feature_shape)
    engine = AdaptationEngine(system, state, registry=registry)
    engine.pager.budget_bytes = master_bytes(registry.host_state("t0")[0])
    frontend = ServingFrontend(engine)
    backend = make_http_server(frontend, "127.0.0.1", 0)
    threading.Thread(target=backend.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{backend.server_address[1]}"
    dead = "http://127.0.0.1:9"  # nothing listens: a pre-provisioned empty slot
    gateway = Gateway([url, dead], health_interval_s=0.1, fail_threshold=1)
    gw_server = make_gateway_server(gateway, "127.0.0.1", 0)
    threading.Thread(target=gw_server.serve_forever, daemon=True).start()
    gw_url = f"http://127.0.0.1:{gw_server.server_address[1]}"
    try:
        deadline = time.monotonic() + 30
        while gateway.in_count() < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert gateway.in_count() == 1
        sup = autoscaler.Supervisor(
            str(tmp_path / "fleet_state.json"), autoscaler.Policy(evict_high=1), gw_url, log=lambda m: None)
        sup.load_or_init([{"url": url, "port": backend.server_address[1], "pid": os.getpid()},
                          {"url": dead, "port": 9}])
        first = sup.collect_signals()
        assert first["gateway"] is True and first["backends_in"] == 1 and first["out_urls"] == [dead]
        assert first["queue_depth"] == 0 and first["evict_delta"] == 0
        for seed, tenant in enumerate(("t0", "t1", "t0")):  # one resident master: two evictions
            x, y, _ = _episode(5 + seed)
            payload = json.dumps({"x_support": x.tolist(), "y_support": y.tolist(), "tenant": tenant}).encode()
            req = urllib.request.Request(gw_url + "/adapt", data=payload, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
        second = sup.collect_signals()
        assert second["requests_delta"] == 3 and second["shed_delta"] == 0 and second["shed_rate"] == 0.0
        assert second["evict_delta"] == 2 and second["queue_depth"] == 0
        assert isinstance(second["page_in_p50_ms"], float) and second["page_in_p50_ms"] > 0
        assert sup._breach_reasons(second) == ["pager_evictions +2 >= 1"]
    finally:
        gw_server.shutdown()
        gw_server.server_close()
        gateway.close()
        backend.shutdown()
        backend.server_close()
        frontend.close()
