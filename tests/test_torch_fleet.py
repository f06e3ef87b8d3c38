"""The port's training fleet (``resilience/fleet.py``,
``scripts/fleet_run.py``, ``scripts/wait_for_card.py``,
``scripts/obs_report.py``) against the JAX package's, on the CPU.

The scheduler's value is its rc policy, so the fast tests drive it with
scripted child processes that exit exactly the codes a real run would (75
preemption, 76 wedge, 3 divergence, stalls), through the port's scheduler
and the JAX package's alike: the same launches, rcs, statuses and events
(``tests/test_fleet.py``). Then the port's own defaults: the card gate
skipped on ``--device cpu`` and its rc contract with an injected probe
that is up, down or hung; the CLI's dry run over a spec file; a real
training matrix through the port's default launcher (its training CLI on
the CPU) with an injected preemption, rc 75 then a resume to rc 0; and the
port's ``obs_report`` equal to the repo's on the same port run directories.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest
import yaml

from howtotrainyourmamlpytorch_tpu import exit_codes
from howtotrainyourmamlpytorch_tpu.resilience import fleet as jax_fleet
from howtotrainyourmamlpytorch_tpu_torch import exit_codes as port_exit_codes
from howtotrainyourmamlpytorch_tpu_torch.resilience import fleet as port_fleet

from tests.test_torch_runner import toy_dataset  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEETS = pytest.mark.parametrize("fleet", [jax_fleet, port_fleet], ids=["jax", "torch"])
PORT_SCRIPTS = os.path.join(REPO, "howtotrainyourmamlpytorch_tpu_torch", "scripts")


def _spec(fleet, tmp_path, configs, seeds=(0,), **kw):
    defaults = dict(name="test_fleet", configs=configs, seeds=list(seeds), experiment_root=str(tmp_path / "exps"),
                    poll_s=0.02, stall_deadline_s=0.0, gate_retry_s=0.01)
    defaults.update(kw)
    return fleet.FleetSpec(**defaults)


def _exit_child(rc: int):
    return subprocess.Popen([sys.executable, "-c", f"raise SystemExit({rc})"])


def _scripted_launcher(script):
    launches = []

    def launcher(cell, attempt):
        rc = script[cell.name].pop(0)
        launches.append((cell.name, rc))
        return _exit_child(rc), None

    return launcher, launches


def _events(root):
    with open(os.path.join(root, "fleet_events.jsonl")) as f:
        return [json.loads(line)["event"] for line in f if line.strip()]


def test_port_rc_registry_equals_jax():
    for name in ("OK", "DIVERGED", "PREEMPTED", "WEDGED", "TPU_WAIT_DEADLINE", "TPU_WAIT_WEDGED", "USAGE",
                 "RESTARTABLE_RCS"):
        assert getattr(port_exit_codes, name) == getattr(exit_codes, name)
    assert port_fleet.exit_codes.RESTARTABLE_RCS == exit_codes.RESTARTABLE_RCS


@FLEETS
def test_spec_cells_cross_configs_and_seeds(fleet, tmp_path):
    spec = _spec(fleet, tmp_path, [{"name": "a", "overrides": ["x=1"]}, {"name": "b", "overrides": []}],
                 seeds=(0, 1), base_overrides=["net=vgg"])
    cells = spec.cells()
    assert [c.name for c in cells] == ["a.s0", "a.s1", "b.s0", "b.s1"]
    assert cells[1].overrides == ["net=vgg", "seed=1", "train_seed=1", "val_seed=1", "x=1"]
    pinned = fleet.FleetSpec(name="p", configs=[{"name": "j", "overrides": ["seed=2", "train_seed=2"]}]).cells()[0]
    assert pinned.overrides.index("seed=0") < pinned.overrides.index("seed=2")
    spec2 = fleet.FleetSpec.from_dict({"fleet": {"name": "y", "configs": ["j1 k=2", {"name": "j2"}], "seeds": [3]}})
    assert [c.name for c in spec2.cells()] == ["j1.s3", "j2.s3"]
    assert spec2.cells()[0].overrides[-1] == "k=2"
    with pytest.raises(ValueError):
        fleet.FleetSpec.from_dict({"fleet": {"configs": [], "name": "empty"}})
    with pytest.raises(ValueError):
        fleet.FleetSpec.from_dict({"fleet": {"configs": ["dup"], "bogus_knob": 1}})


def test_port_spec_names_its_device():
    spec = port_fleet.FleetSpec.from_dict({"fleet": {"configs": ["j"], "device": "cpu"}})
    assert spec.device == "cpu" and port_fleet.FleetSpec(configs=[{"name": "j"}]).device == "cuda"
    with pytest.raises(ValueError, match="device"):
        port_fleet.FleetSpec(configs=[{"name": "j"}], device="tpu")


def _rc_matrix(fleet, tmp_path):
    script = {"a.s0": [exit_codes.PREEMPTED, exit_codes.OK], "a.s1": [exit_codes.WEDGED, exit_codes.OK],
              "b.s0": [exit_codes.DIVERGED], "b.s1": [exit_codes.OK]}
    launcher, launches = _scripted_launcher(script)
    spec = _spec(fleet, tmp_path, [{"name": "a", "overrides": []}, {"name": "b", "overrides": []}], seeds=(0, 1))
    report = fleet.FleetScheduler(spec, launcher=launcher, gate=lambda: 0, obs=lambda d: None,
                                  log=lambda m: None).run()
    return spec, report, launches


@FLEETS
def test_rc_policy_matrix_restarts_diverged_and_report(fleet, tmp_path):
    """rc 75 and 76 restart (bounded, without burning an attempt), rc 3 is
    terminal-diverged, and ONE fleet-report JSON lands."""
    spec, report, launches = _rc_matrix(fleet, tmp_path)
    assert report["ok"] is True
    assert report["done"] == 3 and report["diverged"] == 1 and report["failed"] == 0
    by_name = {c["name"]: c for c in report["cells"]}
    assert by_name["a.s0"]["rcs"] == [75, 0] and by_name["a.s0"]["restarts"] == 1
    assert by_name["a.s1"]["rcs"] == [76, 0] and by_name["a.s1"]["restarts"] == 1
    assert by_name["a.s0"]["attempts"] == 0
    assert by_name["b.s0"]["status"] == "diverged" and by_name["b.s0"]["rcs"] == [3]
    assert [n for n, _ in launches].count("a.s0") == 2
    with open(os.path.join(spec.experiment_root, "fleet_report.json")) as f:
        assert json.load(f)["ok"] is True
    assert "cell_restart" in _events(spec.experiment_root) and "fleet_done" in _events(spec.experiment_root)


def test_rc_matrix_report_and_events_equal_jax(tmp_path):
    """The same scripted matrix through both schedulers: the same launches,
    the same report (its wall times aside) and the same event stream."""
    _, jreport, jlaunches = _rc_matrix(jax_fleet, tmp_path / "jax")
    pspec, preport, plaunches = _rc_matrix(port_fleet, tmp_path / "port")

    def strip(report):
        out = {k: v for k, v in report.items() if k not in ("elapsed_s", "cells")}
        out["cells"] = [{k: v for k, v in c.items() if k != "wall_s"} for c in report["cells"]]
        return out

    assert plaunches == jlaunches and strip(preport) == strip(jreport)
    assert _events(pspec.experiment_root) == _events(str(tmp_path / "jax" / "exps"))


@FLEETS
def test_restart_budget_bounds_a_wedge_loop(fleet, tmp_path):
    launcher, launches = _scripted_launcher({"w.s0": [exit_codes.WEDGED] * 10})
    spec = _spec(fleet, tmp_path, [{"name": "w", "overrides": []}], max_restarts=1, restart_budget=2)
    report = fleet.FleetScheduler(spec, launcher=launcher, gate=lambda: 0, obs=lambda d: None,
                                  log=lambda m: None).run()
    cell = report["cells"][0]
    assert cell["status"] == "failed" and cell["restarts"] == 3
    assert len(launches) == 3 and report["ok"] is False


@FLEETS
def test_unknown_rc_burns_attempts_until_failed(fleet, tmp_path):
    launcher, _ = _scripted_launcher({"u.s0": [17, 17, 17]})
    spec = _spec(fleet, tmp_path, [{"name": "u", "overrides": []}], max_restarts=2)
    report = fleet.FleetScheduler(spec, launcher=launcher, gate=lambda: 0, obs=lambda d: None,
                                  log=lambda m: None).run()
    cell = report["cells"][0]
    assert cell["status"] == "failed" and cell["attempts"] == 3 and cell["rcs"] == [17, 17, 17]


@FLEETS
def test_gate_64_65_pause_the_queue_until_clear(fleet, tmp_path):
    gates = [exit_codes.TPU_WAIT_WEDGED, exit_codes.TPU_WAIT_DEADLINE, 0]
    launcher, _ = _scripted_launcher({"g.s0": [exit_codes.OK]})
    spec = _spec(fleet, tmp_path, [{"name": "g", "overrides": []}])
    report = fleet.FleetScheduler(spec, launcher=launcher, gate=lambda: gates.pop(0), obs=lambda d: None,
                                  log=lambda m: None).run()
    assert report["cells"][0]["status"] == "done" and gates == []
    assert _events(spec.experiment_root).count("gate_paused") == 2


def test_default_gate_skips_on_the_cpu_device(tmp_path, monkeypatch):
    """A cpu fleet has no card to gate on: the default gate returns OK at
    once (no probe), the port's counterpart of JAX's ``JAX_PLATFORMS=cpu``;
    a gateless spec never probes at all."""
    monkeypatch.setattr(port_fleet.subprocess, "run", lambda *a, **k: pytest.fail("the cpu gate probed"))
    assert port_fleet._default_gate("cpu") == exit_codes.OK
    launcher, _ = _scripted_launcher({"a.s0": [exit_codes.OK], "b.s0": [exit_codes.OK]})
    for name, knobs in (("a", dict(device="cpu")), ("b", dict(tpu_gate=False))):
        spec = _spec(port_fleet, tmp_path / name, [{"name": name, "overrides": []}], **knobs)
        report = port_fleet.FleetScheduler(spec, launcher=launcher, obs=lambda d: None, log=lambda m: None).run()
        assert report["cells"][0]["status"] == "done"
    # the JAX package's gate skips the same way under its own switch
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert jax_fleet._default_gate() == exit_codes.OK


def test_default_gate_runs_the_card_gate_on_cuda(monkeypatch):
    calls = []

    def run(cmd, cwd=None):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, exit_codes.TPU_WAIT_WEDGED)

    monkeypatch.setattr(port_fleet.subprocess, "run", run)
    assert port_fleet._default_gate("cuda") == exit_codes.TPU_WAIT_WEDGED
    assert calls[0][-1] == os.path.join(PORT_SCRIPTS, "wait_for_card.py")


@FLEETS
def test_stalled_child_is_killed_and_relaunched(fleet, tmp_path):
    exps = tmp_path / "exps"
    exps.mkdir()
    out_path = str(exps / "s.s0.out")
    calls = []

    def launcher(cell, attempt):
        calls.append(attempt)
        if len(calls) == 1:
            open(out_path, "w").close()
            return subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"]), out_path
        return _exit_child(0), None

    spec = _spec(fleet, tmp_path, [{"name": "s", "overrides": []}], stall_deadline_s=0.3, poll_s=0.05)
    t0 = time.monotonic()
    report = fleet.FleetScheduler(spec, launcher=launcher, gate=lambda: 0, obs=lambda d: None,
                                  log=lambda m: None).run()
    cell = report["cells"][0]
    assert cell["status"] == "done" and cell["stall_kills"] == 1 and cell["attempts"] == 1
    assert time.monotonic() - t0 < 30


@FLEETS
def test_deadline_epoch_skips_remaining_cells(fleet, tmp_path):
    launcher, _ = _scripted_launcher({"a.s0": [exit_codes.OK], "b.s0": [exit_codes.OK]})
    now = {"t": 1000.0}
    spec = _spec(fleet, tmp_path, [{"name": "a", "overrides": []}, {"name": "b", "overrides": []}],
                 deadline_epoch=1500.0)

    def launcher_and_advance(cell, attempt):
        now["t"] = 2000.0
        return launcher(cell, attempt)

    report = fleet.FleetScheduler(spec, launcher=launcher_and_advance, gate=lambda: 0, obs=lambda d: None,
                                  walltime=lambda: now["t"], log=lambda m: None).run()
    by_name = {c["name"]: c for c in report["cells"]}
    assert by_name["a.s0"]["status"] == "done" and by_name["b.s0"]["status"] == "skipped"
    assert report["ok"] is False


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _fleet_run(*args, module=False):
    cmd = ([sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.scripts.fleet_run"] if module
           else [sys.executable, os.path.join(PORT_SCRIPTS, "fleet_run.py")])
    return subprocess.run(cmd + list(args), capture_output=True, text=True, cwd=REPO, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))


def test_fleet_run_cli_dry_run_and_spec_file(tmp_path):
    """The port's ``fleet_run``: a spec file (the repo's
    ``configs/fleet_accuracy_omniglot.yaml`` read as it is) and inline jobs,
    by path and as a module; the plan equals the JAX CLI's; a usage error
    is rc 2."""
    spec_path = str(tmp_path / "spec.yaml")
    with open(spec_path, "w") as f:
        yaml.safe_dump({"fleet": {"name": "cli", "configs": ["c1 x=1", "c2 y=2"], "seeds": [0, 1]}}, f)
    proc = _fleet_run(spec_path, "--dry-run", "--select", "c1")
    assert proc.returncode == 0, proc.stderr
    assert [c["name"] for c in json.loads(proc.stdout)["cells"]] == ["c1.s0", "c1.s1"]
    proc = _fleet_run("--job", "j Xk=1", "--base", "net=vgg", "--seeds", "5", "--dry-run", "--device", "cpu",
                      module=True)
    assert proc.returncode == 0, proc.stderr
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert len(lines) == 1
    cell = json.loads(lines[0])["cells"][0]
    assert cell["name"] == "j.s5" and cell["overrides"][0] == "net=vgg" and cell["overrides"][-1] == "Xk=1"
    assert "seed=5" in cell["overrides"]
    shipped = os.path.join(REPO, "configs", "fleet_accuracy_omniglot.yaml")
    proc = _fleet_run(shipped, "--dry-run", "--select", r"omniglot\.5\.1\.vgg")
    jax_proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "fleet_run.py"), shipped, "--dry-run",
                               "--select", r"omniglot\.5\.1\.vgg"], capture_output=True, text=True, cwd=REPO,
                              timeout=120)
    assert proc.returncode == jax_proc.returncode == 0, (proc.stderr, jax_proc.stderr)
    assert json.loads(proc.stdout) == json.loads(jax_proc.stdout)
    assert len(json.loads(proc.stdout)["cells"]) == 4 * 3  # 4 configs x 3 seeds
    proc = _fleet_run()
    assert proc.returncode == exit_codes.USAGE


def _wait(*args, probe=None):
    env = dict(os.environ)
    env.pop("WAIT_FOR_CARD_PROBE", None)
    if probe is not None:
        env["WAIT_FOR_CARD_PROBE"] = probe
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, os.path.join(PORT_SCRIPTS, "wait_for_card.py"), *args],
                          capture_output=True, text=True, timeout=120, env=env)
    return proc, time.monotonic() - t0


def test_wait_for_card_rc_contract():
    """Up: rc 0. Down (the probe answers badly) until the deadline: rc 64.
    Hung probes in a row: rc 65 at once, well before the deadline."""
    proc, _ = _wait("--deadline-s", "30", probe="print('CARD_OK', 1, 'fake')")
    assert proc.returncode == 0 and "card up" in proc.stdout
    proc, _ = _wait("--deadline-s", "1", "--probe-interval-s", "0.2", probe="raise SystemExit(1)")
    assert proc.returncode == exit_codes.TPU_WAIT_DEADLINE and "deadline exceeded" in proc.stdout
    proc, took = _wait("--deadline-s", "60", "--probe-timeout-s", "0.5", "--max-wedged-probes", "2",
                       "--probe-interval-s", "0", probe="import time; time.sleep(30)")
    assert proc.returncode == exit_codes.TPU_WAIT_WEDGED and "wedged" in proc.stdout and took < 30


def test_wait_for_card_never_counts_the_cpu_as_up():
    """The real probe on a box with no card: down, never a CPU fallback."""
    proc, _ = _wait("--deadline-s", "0.5", "--probe-timeout-s", "60", "--probe-interval-s", "0")
    assert proc.returncode == exit_codes.TPU_WAIT_DEADLINE, proc.stdout
    assert "no CUDA card visible" in proc.stdout or "rc=" in proc.stdout


# ---------------------------------------------------------------------------
# the real training matrix, and obs_report on its run directories
# ---------------------------------------------------------------------------

TOY = ["num_samples_per_class=2", "num_target_samples=2", "batch_size=2", "total_epochs=2",
       "total_iter_per_epoch=3", "num_evaluation_tasks=4", "number_of_training_steps_per_iter=2",
       "number_of_evaluation_steps_per_iter=2", "train_val_test_split=[0.6,0.2,0.2]"]


@pytest.fixture(scope="module")
def trained_fleet(toy_dataset, tmp_path_factory):  # noqa: F811
    """A real 2-config matrix through the port's DEFAULT launcher (its
    training CLI, ``--device cpu``): one cell's first attempt gets a real
    SIGTERM fault (rc 75, emergency checkpoint), another's an injected rc
    76; both resume in their own run directories and finish."""
    exps_root = str(tmp_path_factory.mktemp("fleet") / "exps")
    os.makedirs(exps_root)
    base = [f'dataset={{"name": "omniglot_toy", "path": "{toy_dataset}"}}',
            f"index_cache_dir={os.path.join(exps_root, 'idx')}"] + TOY
    spec = port_fleet.FleetSpec(name="e2e", configs=[{"name": "toy3", "overrides": ["num_classes_per_set=3"]},
                                                     {"name": "toy2", "overrides": ["num_classes_per_set=2"]}],
                                seeds=[0], base_overrides=base, experiment_root=exps_root, poll_s=0.2,
                                device="cpu")

    def launcher(cell, attempt):
        first = attempt == 0 and not cell.restarts
        if cell.name == "toy2.s0" and first:
            return _exit_child(exit_codes.WEDGED), None
        prior = os.environ.pop("HTYMP_FAULTS", None)
        if cell.name == "toy3.s0" and first:
            os.environ["HTYMP_FAULTS"] = "runner.step=sigterm:nth=3"
        try:
            return port_fleet._default_launcher(cell, attempt, exps_root, spec.device)
        finally:
            os.environ.pop("HTYMP_FAULTS", None)
            if prior is not None:
                os.environ["HTYMP_FAULTS"] = prior

    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        report = port_fleet.FleetScheduler(spec, launcher=launcher, log=lambda m: None).run()
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old
    return exps_root, report


def test_real_training_matrix_with_injected_preemption(trained_fleet):
    exps_root, report = trained_fleet
    assert report["ok"] is True, report
    assert report["done"] == 2 and report["failed"] == 0
    by_name = {c["name"]: c for c in report["cells"]}
    assert by_name["toy3.s0"]["rcs"] == [exit_codes.PREEMPTED, exit_codes.OK]
    assert by_name["toy2.s0"]["rcs"] == [exit_codes.WEDGED, exit_codes.OK]
    run_dir = os.path.join(exps_root, "toy3.s0")
    with open(os.path.join(run_dir, "logs", "events.jsonl")) as f:
        events = [json.loads(line).get("event") for line in f if line.strip()]
    assert "preempted" in events
    assert os.path.exists(os.path.join(run_dir, "logs", "test_summary.csv"))
    with open(os.path.join(exps_root, "toy3.s0.out")) as f:
        out = f.read()
    assert "PREEMPTED" in out and "resumed: epoch 0" in out  # the same run directory, resumed
    assert by_name["toy3.s0"]["obs"] and "error" not in by_name["toy3.s0"]["obs"]
    assert os.path.exists(os.path.join(run_dir, "fleet_cell.json"))
    proc = subprocess.run([sys.executable, os.path.join(PORT_SCRIPTS, "obs_report.py"), "--exps-root", exps_root,
                           "--json"], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    fleet_obs = json.loads(proc.stdout)
    assert fleet_obs["n_runs"] == 2 and fleet_obs["fleet"]["ok"] is True
    rows = {r["run"]: r for r in fleet_obs["runs"]}
    assert rows["toy3.s0"]["rcs"] == [75, 0] and rows["toy3.s0"]["restarts"] == 1


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_obs_report_equals_the_repo_report_on_port_run_dirs(trained_fleet):
    """The port's ``obs_report`` copy and the repo's ``scripts/obs_report.py``
    give the same per-run report, oneline, human table and fleet report on
    the port's run directories."""
    exps_root, _ = trained_fleet
    port = _load("t_fleet_obs_port", "howtotrainyourmamlpytorch_tpu_torch/scripts/obs_report.py")
    repo = _load("t_fleet_obs_repo", "scripts/obs_report.py")
    for run in ("toy3.s0", "toy2.s0"):
        run_dir = os.path.join(exps_root, run)
        mine, theirs = port.build_report(run_dir), repo.build_report(run_dir)
        assert mine == theirs and "device_breakdown" not in mine
        assert port.oneline(mine) == repo.oneline(theirs)
        assert port.render_human(mine) == repo.render_human(theirs)
    fleet_mine, fleet_theirs = port.build_fleet_report(exps_root), repo.build_fleet_report(exps_root)
    assert fleet_mine == fleet_theirs
    assert port.render_fleet_human(fleet_mine) == repo.render_fleet_human(fleet_theirs)
