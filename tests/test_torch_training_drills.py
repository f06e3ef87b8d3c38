"""The training-mode chaos episodes that need a fresh interpreter, on the
CPU: ``wedge-hung-step`` (rc 76 from the watchdog's ``os._exit``),
``device-shrink-resume`` and ``device-grow-resume`` (a child sees 1 CPU
entry, then 8), through ``campaign._run_train_episode`` with JAX's expected
rcs and required events; and the wedge drill of
``tests/test_wedge_watchdog.py``: rc 76 with the hung frame (the injector's
delay) in the ``wedged`` event's stacks, a stall at least the deadline,
the emergency checkpoint, and a resume that ends where an uninterrupted run
ends (rtol 1e-6, atol 1e-7)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch import config as tcfg
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.resilience import campaign
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

from .test_torch_runner import THREADS, _env, toy_dataset  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def child_threads(monkeypatch):
    """The children's CPU threads, as the other tests' subprocesses."""
    monkeypatch.setenv("OMP_NUM_THREADS", str(THREADS))
    monkeypatch.delenv("HTYMP_FAULTS", raising=False)


@pytest.mark.parametrize("kind", ["wedge-hung-step", "device-shrink-resume", "device-grow-resume"])
def test_subprocess_episode_passes_with_jax_rcs_and_events(kind, toy_dataset, tmp_path, child_threads):
    ep = {e.kind: e for e in campaign.episode_menu(np.random.RandomState(0))}[kind]
    assert ep.subprocess
    result = campaign._run_train_episode(ep, str(tmp_path), f"ep_{kind}", data_root=toy_dataset, device="cpu")
    assert result["violations"] == [], result
    want = {"wedge-hung-step": [76, 0], "device-shrink-resume": [0, 0], "device-grow-resume": [0, 0, 0]}[kind]
    assert result["rcs"] == want


def test_wedge_drill_rc76_stack_dump_exact_resume(toy_dataset, tmp_path, child_threads):
    """A hung step (a 120 s delay at the 4th ``runner.step``, epoch 1's
    first) exits rc 76 after the deadline with the injector's frame in the
    hung thread's stack and an emergency checkpoint; the resume matches an
    uninterrupted control run."""
    ctl_cfg = campaign.campaign_config(toy_dataset, str(tmp_path), "wedge_ctl")
    ctl = ExperimentRunner(ctl_cfg, system=campaign.tiny_system(ctl_cfg, "cpu"), devices=["cpu"] * 8)
    ctl.run_experiment()

    deadline = campaign.WEDGE_DEADLINE_S
    wedge_cfg = campaign.campaign_config(
        toy_dataset, str(tmp_path), "wedge_run",
        resilience=tcfg.ResilienceConfig(faults=["runner.step=delay:delay_s=120,nth=4"],
                                         watchdog=tcfg.WatchdogConfig(deadline_s=deadline, poll_s=0.5)),
    )
    cfg_yaml = str(tmp_path / "wedge_run.yaml")
    tcfg.save_config(wedge_cfg, cfg_yaml)
    code = ("import sys;from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import child_train_main;"
            "sys.exit(child_train_main(sys.argv[1], 'cpu', 8))")
    proc = subprocess.run([sys.executable, "-c", code, cfg_yaml], cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 76, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "WEDGED" in proc.stdout
    with open(os.path.join(str(tmp_path), "wedge_run", "logs", "events.jsonl")) as f:
        events = [json.loads(line) for line in f if line.strip()]
    wedged = [e for e in events if e.get("event") == "wedged"]
    assert wedged, [e.get("event") for e in events]
    stacks = wedged[0]["threads"]
    assert stacks and any("fire" in "".join(s) for s in stacks.values())
    assert wedged[0]["stall_s"] >= deadline
    assert any(e.get("event") == "wedge_checkpoint" for e in events)

    resume_cfg = campaign.campaign_config(toy_dataset, str(tmp_path), "wedge_run")
    resumed = ExperimentRunner(resume_cfg, system=campaign.tiny_system(resume_cfg, "cpu"), devices=["cpu"] * 8)
    assert resumed.start_epoch == 1
    resumed.run_experiment()
    for a, b in zip(tree_leaves(ctl.state.params), tree_leaves(resumed.state.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
