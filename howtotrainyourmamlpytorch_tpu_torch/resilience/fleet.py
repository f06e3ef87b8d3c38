"""Fleet campaign scheduler: a config x seed matrix run unattended (the JAX
package's ``resilience/fleet.py``).

The harness policy (which exit codes restart, how long a silent log means
"wedged", how many restarts a run gets) lives here in Python, where it
consumes the rc registry directly and is unit-testable with injected child
processes and clocks:

- **rc policy** (``exit_codes.py``, the single source): ``0`` done;
  ``DIVERGED`` (3) is permanent — mark the cell diverged and move on;
  ``RESTARTABLE_RCS`` (75 preemption / 76 wedge) relaunch with exact resume,
  bounded by ``restart_budget`` without burning an attempt; anything else
  burns one of ``max_restarts`` attempts. ``TPU_WAIT_DEADLINE``/
  ``TPU_WAIT_WEDGED`` (64/65) from the *gate*
  (``scripts/wait_for_card.py``) pause the queue until the card answers.
- **stall watchdog**: a run whose output log goes silent past
  ``stall_deadline_s`` is killed and relaunched (resume is exact) — the
  harness-side defense for a client wedged so hard its own watchdog never
  fires.
- **budgets**: per-cell wall-clock (``cell_timeout_s``) across attempts, an
  optional fleet-wide ``deadline_epoch`` after which no new cell starts.
- **aggregation**: each finished cell's ``telemetry.jsonl``/``events.jsonl``
  are summarized through this package's ``scripts/obs_report.py``
  ``build_report`` (one code path for the per-run and the fleet view), and
  the whole matrix lands in one ``fleet_report.json`` + a
  ``fleet_events.jsonl`` stream.

Every cell trains on the spec's ``device`` (``--device cuda|cpu`` of the
training CLI; the card by default). A ``cpu`` fleet has no card to gate on,
the counterpart of the JAX package's ``JAX_PLATFORMS=cpu``.

Import-light by design (stdlib + the dependency-free rc registry; no
torch): the scheduler must run on a box whose card is the thing being
waited on. It is loadable both as a package module and by file path
(``scripts/fleet_run.py`` does the latter to skip the package import).
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)


def _load_by_path(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


try:  # package context (tests, in-process embedding)
    from .. import exit_codes
except ImportError:  # file-path load from scripts/fleet_run.py
    exit_codes = _load_by_path(
        "htymp_torch_exit_codes", os.path.join(_PKG_DIR, "exit_codes.py")
    )


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------


@dataclass
class FleetSpec:
    """A config x seed matrix plus the harness policy knobs. YAML form::

        fleet:
          name: accuracy_omniglot_r6
          base_overrides: [dataset=omniglot, inner_optim=gd, ...]
          configs:
            - {name: omniglot.5.1.vgg.gd, overrides: [num_classes_per_set=5]}
          seeds: [0, 1, 2]
          stall_deadline_s: 420
          max_restarts: 8

    ``seed_overrides`` is the per-seed template (``{seed}`` substituted);
    the default pins all three stream seeds, matching the accuracy-matrix
    contract. Every policy default mirrors the retired bash harness."""

    name: str = "fleet"
    configs: List[Dict[str, Any]] = field(default_factory=list)
    seeds: List[int] = field(default_factory=lambda: [0])
    base_overrides: List[str] = field(default_factory=list)
    seed_overrides: List[str] = field(
        default_factory=lambda: ["seed={seed}", "train_seed={seed}", "val_seed={seed}"]
    )
    experiment_root: str = "exps"
    # harness policy (previously hardcoded in sweep.sh)
    stall_deadline_s: float = 420.0
    poll_s: float = 5.0
    max_restarts: int = 8  # hard-failure attempts per cell
    restart_budget: int = 0  # 0 = auto: 3 * max_restarts (the sweep bound)
    cell_timeout_s: float = 0.0  # 0 = unbounded wall clock per cell
    max_parallel: int = 1  # >1 only off the single-client chip
    deadline_epoch: float = 0.0  # 0 = none; wall-clock (epoch s) start cutoff
    # card gate pause (64/65 from scripts/wait_for_card.py). tpu_gate=false
    # skips the gate entirely; a cpu fleet skips it automatically either way.
    tpu_gate: bool = True
    gate_retry_s: float = 30.0
    gate_give_up_s: float = 3600.0
    # where every cell trains (the training CLI's --device)
    device: str = "cuda"

    def __post_init__(self):
        if not self.configs:
            raise ValueError("fleet spec needs at least one config")
        names = [c.get("name") for c in self.configs]
        if len(set(names)) != len(names) or not all(names):
            raise ValueError(f"fleet config names must be unique and non-empty: {names}")
        for bad in ("/", " "):
            for n in names:
                if bad in n:
                    raise ValueError(f"fleet config name {n!r} contains {bad!r}")
        if self.max_restarts < 0 or self.max_parallel < 1:
            raise ValueError("max_restarts must be >= 0 and max_parallel >= 1")
        if self.restart_budget == 0:
            self.restart_budget = 3 * self.max_restarts
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"fleet device must be 'cuda' or 'cpu', got {self.device!r}")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "FleetSpec":
        data = dict(data.get("fleet", data))
        known = {f for f in cls.__dataclass_fields__}  # noqa: E501
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown fleet spec keys: {sorted(unknown)}")
        configs = []
        for c in data.get("configs", []):
            if isinstance(c, str):
                # "name override override..." shorthand (the sweep.sh job form)
                parts = c.split()
                c = {"name": parts[0], "overrides": parts[1:]}
            configs.append({"name": c["name"], "overrides": list(c.get("overrides", []))})
        data["configs"] = configs
        return cls(**data)

    def cells(self) -> List["FleetCell"]:
        # seed overrides sit BETWEEN base and per-config overrides: the
        # matrix seed is the default, but a job that pins its own seed in
        # its override string (the retired sweep.sh scripts did exactly
        # that) must win — load_config applies overrides last-wins, and
        # silently clobbering an explicit seed would relabel its science
        return [
            FleetCell(
                name=f"{c['name']}.s{seed}",
                config=c["name"],
                seed=int(seed),
                overrides=(
                    list(self.base_overrides)
                    + [o.format(seed=seed) for o in self.seed_overrides]
                    + list(c["overrides"])
                ),
            )
            for c in self.configs
            for seed in self.seeds
        ]


@dataclass
class FleetCell:
    name: str
    config: str
    seed: int
    overrides: List[str]
    status: str = "pending"  # running|done|diverged|failed|skipped
    reason: str = ""
    rcs: List[int] = field(default_factory=list)
    attempts: int = 0  # hard-failure attempts spent
    restarts: int = 0  # free (75/76) restarts spent
    stall_kills: int = 0
    wall_s: float = 0.0
    obs: Optional[Dict[str, Any]] = None

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "config": self.config,
            "seed": self.seed,
            "overrides": list(self.overrides),
            "status": self.status,
            "reason": self.reason,
            "rcs": list(self.rcs),
            "attempts": self.attempts,
            "restarts": self.restarts,
            "stall_kills": self.stall_kills,
            "wall_s": round(self.wall_s, 1),
            "obs": self.obs,
        }


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


def _default_launcher(cell: FleetCell, attempt: int, exps_root: str, device: str = "cuda"):
    """Spawn one training run for ``cell``: ``python -u -m
    howtotrainyourmamlpytorch_tpu_torch.train --device <device>`` with the
    cell's overrides, stdout/stderr appended to the cell's .out file (the
    stall watchdog's liveness signal, hence -u)."""
    out_path = os.path.join(exps_root, f"{cell.name}.out")
    out = open(out_path, "ab")
    cmd = [
        sys.executable,
        "-u",
        "-m",
        "howtotrainyourmamlpytorch_tpu_torch.train",
        "--device",
        device,
        *cell.overrides,
        f"experiment_name={cell.name}",
        f"experiment_root={exps_root}",
    ]
    proc = subprocess.Popen(cmd, cwd=_REPO_ROOT, stdout=out, stderr=subprocess.STDOUT)
    out.close()
    return proc, out_path


def _default_gate(device: str = "cuda") -> int:
    """The card gate (``scripts/wait_for_card.py``, the rc contract of the
    JAX package's ``wait_for_tpu.py``). A cpu fleet has no card to gate on:
    probing for one there would block the queue for the full gate deadline
    with no way to succeed."""
    if device == "cpu":
        return exit_codes.OK
    return subprocess.run(
        [sys.executable, "-u", os.path.join(_PKG_DIR, "scripts", "wait_for_card.py")],
        cwd=_REPO_ROOT,
    ).returncode


def _default_obs(run_dir: str) -> Optional[Dict[str, Any]]:
    """Per-run observability summary through this package's obs_report
    ``build_report``: the fleet view and the per-run report share one code
    path."""
    try:
        obs_report = _load_by_path(
            "htymp_torch_obs_report", os.path.join(_PKG_DIR, "scripts", "obs_report.py")
        )
        report = obs_report.build_report(run_dir)
        return json.loads(obs_report.oneline(report))
    except Exception as exc:  # noqa: BLE001 — a missing report never fails a cell
        return {"error": f"obs_report failed: {exc!r}"}


class FleetScheduler:
    """Drive a :class:`FleetSpec` to completion. Every effectful dependency
    (child launcher, card gate, clocks, sleep) is injectable, so the full rc
    policy — bounded restarts, stall kills, gate pauses, budgets — is
    testable in milliseconds with fake children."""

    def __init__(
        self,
        spec: FleetSpec,
        launcher: Optional[Callable] = None,
        gate: Optional[Callable[[], int]] = None,
        obs: Optional[Callable[[str], Optional[Dict[str, Any]]]] = None,
        clock: Callable[[], float] = time.monotonic,
        walltime: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
        log: Callable[[str], None] = lambda m: print(m, file=sys.stderr, flush=True),
    ):
        self.spec = spec
        self.exps_root = spec.experiment_root
        self._launcher = launcher or (
            lambda cell, attempt: _default_launcher(cell, attempt, self.exps_root, spec.device)
        )
        if gate is not None:
            self._gate = gate
        elif spec.tpu_gate:
            self._gate = lambda: _default_gate(spec.device)
        else:
            self._gate = lambda: exit_codes.OK
        self._obs = obs if obs is not None else _default_obs
        self._clock = clock
        self._walltime = walltime
        self._sleep = sleep
        self._log = log
        self.cells = spec.cells()
        self._events_path = os.path.join(self.exps_root, "fleet_events.jsonl")

    # -- plumbing ----------------------------------------------------------

    def _event(self, event: str, **fields) -> None:
        record = {"ts": self._walltime(), "event": event, **fields}
        try:
            with open(self._events_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        except OSError:
            pass
        self._log(f"fleet: {event} " + " ".join(f"{k}={v}" for k, v in fields.items()))

    def _warm_manifest(self, cell: FleetCell) -> Optional[Dict[str, Any]]:
        """Warm-spawn readiness: the JAX runner writes an AOT prewarm
        manifest next to the checkpoints, and a relaunch of a cell that
        carries one records it at launch. The port's training runner writes
        no manifest (its AOT prewarm is ROADMAP.md A10), so this is None
        for a port cell; kept so that a fleet over JAX run directories
        reads the same. Pure JSON read."""
        path = os.path.join(
            self.exps_root, cell.name, "saved_models", "prewarm_manifest.json"
        )
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return None
        fingerprint = manifest.get("fingerprint") or {}
        return {
            "programs": len(manifest.get("programs") or {}),
            "device_kind": fingerprint.get("device_kind"),
            "jaxlib": fingerprint.get("jaxlib"),
            "cache_entries": (manifest.get("cache") or {}).get("entries"),
        }

    def _liveness_age_s(self, out_path: Optional[str]) -> float:
        if not out_path or not os.path.exists(out_path):
            return 0.0
        try:
            return max(0.0, self._walltime() - os.stat(out_path).st_mtime)
        except OSError:
            return 0.0

    # -- policy ------------------------------------------------------------

    def _gate_wait(self) -> None:
        """Pause the queue until the card gate clears (64/65 = the card
        does not answer). Bounded by ``gate_give_up_s``: past it, launch
        anyway; the child's own startup is the next line of defense."""
        start = self._clock()
        while True:
            rc = int(self._gate())
            if rc not in (exit_codes.TPU_WAIT_DEADLINE, exit_codes.TPU_WAIT_WEDGED):
                if rc != exit_codes.OK:
                    self._event("gate_nonzero", rc=rc, action="launching anyway")
                return
            waited = self._clock() - start
            if waited >= self.spec.gate_give_up_s:
                self._event(
                    "gate_give_up", rc=rc, waited_s=round(waited, 1),
                    action="launching anyway",
                )
                return
            self._event("gate_paused", rc=rc, retry_in_s=self.spec.gate_retry_s)
            self._sleep(self.spec.gate_retry_s)

    def _finish(self, cell: FleetCell, status: str, reason: str = "") -> None:
        cell.status = status
        cell.reason = reason
        if status in ("done", "diverged", "failed"):
            cell.obs = self._obs(os.path.join(self.exps_root, cell.name))
            try:
                with open(
                    os.path.join(self.exps_root, cell.name, "fleet_cell.json"), "w"
                ) as f:
                    json.dump(cell.as_dict(), f, indent=1)
            except OSError:
                pass
        self._event(
            "cell_" + status, cell=cell.name, rcs=cell.rcs,
            restarts=cell.restarts, attempts=cell.attempts, reason=reason,
        )

    def _classify(self, cell: FleetCell, rc: int) -> Optional[str]:
        """Apply the rc registry to a finished attempt. Returns a terminal
        status, or None to relaunch the cell."""
        cell.rcs.append(rc)
        if rc == exit_codes.OK:
            return "done"
        if rc == exit_codes.DIVERGED:
            # permanent: retrying resumes the same collapsing trajectory
            return "diverged"
        if rc in exit_codes.RESTARTABLE_RCS:
            # preemption/wedge: emergency checkpoint written, resume is
            # exact — a free restart, bounded so a wedge-every-epoch tunnel
            # can't loop forever
            cell.restarts += 1
            if cell.restarts > self.spec.restart_budget:
                return "failed"
            self._event(
                "cell_restart", cell=cell.name, rc=rc,
                kind=exit_codes.describe(rc), restarts=cell.restarts,
            )
            return None
        cell.attempts += 1
        if cell.attempts > self.spec.max_restarts:
            return "failed"
        self._event("cell_retry", cell=cell.name, rc=rc, attempts=cell.attempts)
        return None

    # -- the loop ----------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        os.makedirs(self.exps_root, exist_ok=True)
        t0 = self._clock()
        self._event(
            "fleet_start", spec=self.spec.name, cells=len(self.cells),
            configs=len(self.spec.configs), seeds=list(self.spec.seeds),
        )
        pending: List[FleetCell] = list(self.cells)
        # cell -> (proc, out_path, attempt_started, cell_first_started)
        running: Dict[int, Any] = {}

        def launch(cell: FleetCell) -> None:
            self._gate_wait()
            proc, out_path = self._launcher(cell, cell.attempts)
            if out_path:
                # appending doesn't update mtime on spawn: reset the
                # liveness clock so every (re)launch gets the full window
                try:
                    os.utime(out_path, None)
                except OSError:
                    pass
            cell.status = "running"
            running[id(cell)] = (cell, proc, out_path, self._clock())
            fields = {"cell": cell.name, "attempt": cell.attempts,
                      "restart": cell.restarts}
            warm = self._warm_manifest(cell)
            if warm is not None:
                # expectation on record: this (re)launch should hit warm
                fields["prewarm_manifest"] = warm
            self._event("cell_launch", **fields)

        def kill(proc) -> None:
            try:
                proc.terminate()
            except Exception:
                pass
            deadline = self._clock() + 10.0
            while proc.poll() is None and self._clock() < deadline:
                self._sleep(0.2)
            if proc.poll() is None:
                try:
                    proc.kill()
                except Exception:
                    pass
                proc.wait()

        while pending or running:
            # start cells while slots are free (and the round deadline allows)
            while pending and len(running) < self.spec.max_parallel:
                if (
                    self.spec.deadline_epoch
                    and self._walltime() >= self.spec.deadline_epoch
                ):
                    for cell in pending:
                        self._finish(cell, "skipped", "deadline_epoch passed")
                    pending = []
                    break
                launch(pending.pop(0))
            if not running:
                break
            self._sleep(self.spec.poll_s)
            for key in list(running):
                cell, proc, out_path, started = running[key]
                rc = proc.poll()
                attempt_wall = self._clock() - started
                if rc is None:
                    stalled = (
                        self.spec.stall_deadline_s > 0
                        and self._liveness_age_s(out_path) > self.spec.stall_deadline_s
                    )
                    over_budget = (
                        self.spec.cell_timeout_s > 0
                        and cell.wall_s + attempt_wall > self.spec.cell_timeout_s
                    )
                    if not stalled and not over_budget:
                        continue
                    kill(proc)
                    cell.wall_s += self._clock() - started
                    del running[key]
                    if over_budget:
                        cell.rcs.append(proc.returncode)
                        self._finish(cell, "failed", "cell_timeout_s exhausted")
                        continue
                    cell.stall_kills += 1
                    cell.rcs.append(proc.returncode)
                    cell.attempts += 1
                    self._event(
                        "cell_stalled", cell=cell.name,
                        stall_s=round(self._liveness_age_s(out_path), 1),
                        attempts=cell.attempts,
                    )
                    if cell.attempts > self.spec.max_restarts:
                        self._finish(cell, "failed", "stalled past max_restarts")
                    else:
                        pending.insert(0, cell)  # resume immediately, in order
                    continue
                # attempt finished on its own
                cell.wall_s += self._clock() - started
                del running[key]
                verdict = self._classify(cell, int(rc))
                if verdict is None:
                    pending.insert(0, cell)
                elif verdict == "failed":
                    self._finish(
                        cell, "failed",
                        f"rc={rc} ({exit_codes.describe(int(rc))}) after "
                        f"{cell.attempts} attempts / {cell.restarts} restarts",
                    )
                else:
                    self._finish(cell, verdict)

        report = self.report(elapsed_s=self._clock() - t0)
        try:
            with open(os.path.join(self.exps_root, "fleet_report.json"), "w") as f:
                json.dump(report, f, indent=1)
        except OSError:
            pass
        self._event(
            "fleet_done", ok=report["ok"], done=report["done"],
            diverged=report["diverged"], failed=report["failed"],
            skipped=report["skipped"],
        )
        return report

    def report(self, elapsed_s: float = 0.0) -> Dict[str, Any]:
        by_status: Dict[str, int] = {}
        for cell in self.cells:
            by_status[cell.status] = by_status.get(cell.status, 0) + 1
        return {
            "report": "fleet",
            "spec": self.spec.name,
            "cells": [c.as_dict() for c in self.cells],
            "done": by_status.get("done", 0),
            "diverged": by_status.get("diverged", 0),
            "failed": by_status.get("failed", 0),
            "skipped": by_status.get("skipped", 0),
            # diverged is a model outcome the fleet handled per policy, not
            # a harness failure; failed/skipped cells mean the matrix is
            # incomplete
            "ok": all(c.status in ("done", "diverged") for c in self.cells),
            "restart_rcs": list(exit_codes.RESTARTABLE_RCS),
            "elapsed_s": round(elapsed_s, 1),
        }


def load_spec(path: str) -> FleetSpec:
    """Read a fleet spec YAML (PyYAML when importable, else a minimal
    subset parser is NOT attempted — fleet specs are only read where the
    training stack already runs)."""
    import yaml

    with open(path) as f:
        return FleetSpec.from_dict(yaml.safe_load(f) or {})
