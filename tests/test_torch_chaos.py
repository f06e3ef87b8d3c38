"""The port's chaos campaign against the JAX package's, on the CPU
(``tests/test_chaos_smoke.py``): the seeded episode plan equal to JAX's,
the fixed-seed 4-episode in-process campaign green with its one-line
verdict in JAX's keys (no sanitizer block and no ``graftsan.jsonl`` with
the sanitizer off), the port's ``chaos_soak`` CLI, and ``run_campaign``'s
dispatch of each episode mode. The six serve episodes and the HTTP
strategy menu are ``test_torch_chaos_serve.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.resilience import campaign as jcampaign
from howtotrainyourmamlpytorch_tpu_torch.resilience import campaign
from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import (
    DOCUMENTED_RCS,
    Episode,
    _run_gateway_episode,
    episode_menu,
    run_campaign,
    sample_episodes,
)

from tests.test_torch_runner import toy_dataset  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(ep):
    """An episode as plain data (config objects by their repr)."""
    return {k: (v if isinstance(v, (str, int, float, bool, list, tuple, type(None))) else repr(v))
            for k, v in dataclasses.asdict(ep).items()}


@pytest.mark.parametrize("seed,n,sub", [(0, 21, True), (0, 8, False), (7, 21, True), (3, 17, False)])
def test_sampled_plan_equals_jax(seed, n, sub):
    """The same seed samples the same episodes, fault specs, knobs and rc
    sets as the JAX package's campaign."""
    port = [_plain(e) for e in sample_episodes(seed, n, sub)]
    ref = [_plain(e) for e in jcampaign.sample_episodes(seed, n, sub)]
    assert port == ref


def test_episode_sampling_is_seeded_and_covers_every_seam():
    menu = episode_menu(np.random.RandomState(0))
    seams = {f.split("=", 1)[0] for ep in menu for f in ep.faults}
    seams |= {"serving.dispatch", "serving.http", "serving.refine"}  # inside _run_serve_episode
    assert seams >= {"runner.step", "loader.episode", "checkpoint.read", "checkpoint.write", "serving.dispatch",
                     "serving.http", "serving.refine"}
    assert {"serve-refine-rollback", "serve-refine-across-drain", "fleet-surge", "fleet-crashloop"} <= {
        e.kind for e in menu}
    assert len(menu) == 21
    assert [e.kind for e in sample_episodes(7, 21)] == [e.kind for e in sample_episodes(7, 21)]
    assert not any(e.subprocess for e in sample_episodes(0, 21, include_subprocess=False))
    assert {e.kind for e in menu if e.mode == "serve"} == {
        "serve-dispatch-raise", "serve-dispatch-hang", "serve-replica-death", "serve-strategy-mix",
        "serve-refine-rollback", "serve-tenant-thrash"}


def test_chaos_smoke_campaign_all_invariants_green(toy_dataset, tmp_path):  # noqa: F811
    """A fixed-seed 4-episode in-process campaign on the CPU: documented rcs
    only, loadable checkpoints, well-formed events, honest serving; the
    verdict is one JSON line with the JAX verdict's keys; with the sanitizer
    off there is no sanitizer block and no graftsan.jsonl."""
    verdict = run_campaign(str(tmp_path), episodes=4, seed=0, data_root=toy_dataset, include_subprocess=False,
                           log=lambda m: None, device="cpu")
    assert verdict["ok"], verdict["violations"]
    assert verdict["episodes"] == 4
    assert [r["kind"] for r in verdict["episode_results"]] == [
        e.kind for e in jcampaign.sample_episodes(0, 4, include_subprocess=False)]
    for result in verdict["episode_results"]:
        assert set(result) == {"kind", "mode", "rcs", "violations"} and not result["violations"]
        assert all(rc in DOCUMENTED_RCS for rc in result["rcs"])
    assert set(verdict) == {"campaign", "seed", "episodes", "ok", "violations", "sanitizer", "invariants",
                            "episode_results", "elapsed_s"}
    line = json.dumps(verdict)
    assert "\n" not in line and json.loads(line)["ok"] is True
    assert verdict["sanitizer"] is None
    assert not os.path.exists(os.path.join(str(tmp_path), "graftsan.jsonl"))


def test_run_campaign_dispatches_every_mode(tmp_path, monkeypatch):
    """Serve episodes go to ``_run_serve_episode``, gateway drills to
    ``_run_gateway_episode``, the training modes to ``_run_train_episode``,
    each on the campaign's device; a violation lands in the verdict with
    its episode index and kind."""
    plan = [Episode("serve-x", "serve"), Episode("gateway-x", "gateway"), Episode("nan-x", "train")]
    calls = []
    monkeypatch.setattr(campaign, "sample_episodes", lambda seed, n, sub: plan[:n])
    monkeypatch.setattr(campaign, "_run_serve_episode", lambda ep, device: calls.append(("serve", device)) or [])
    monkeypatch.setattr(campaign, "_run_gateway_episode",
                        lambda ep, work_dir=None, device="cuda": calls.append(("gateway", device)) or ["broke"])
    monkeypatch.setattr(campaign, "_run_train_episode",
                        lambda ep, work_dir, name, data_root=None, device="cuda": calls.append(("train", device))
                        or {"kind": ep.kind, "mode": ep.mode, "rcs": [0], "violations": []})
    verdict = run_campaign(str(tmp_path), episodes=3, seed=5, data_root=str(tmp_path), log=lambda m: None,
                           device="cpu")
    assert calls == [("serve", "cpu"), ("gateway", "cpu"), ("train", "cpu")]
    assert not verdict["ok"] and verdict["violations"] == [{"episode": 1, "kind": "gateway-x", "violation": "broke"}]
    assert [r["rcs"] for r in verdict["episode_results"]] == [[], [], [0]]


def test_a_serve_episode_is_not_a_gateway_drill(tmp_path):
    """``_run_gateway_episode`` refuses the other modes with a pointer to
    their runners."""
    with pytest.raises(ValueError, match="_run_serve_episode"):
        _run_gateway_episode(Episode(kind="serve-dispatch-raise", mode="serve"), work_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="_run_train_episode"):
        _run_gateway_episode(Episode(kind="nan-step", mode="train"), work_dir=str(tmp_path), device="cpu")


def test_chaos_soak_cli(tmp_path):
    """``python -m howtotrainyourmamlpytorch_tpu_torch.scripts.chaos_soak
    --episodes 2 --no-subprocess --device cpu``: rc 0 and exactly one JSON
    line on stdout, progress on stderr."""
    proc = subprocess.run(
        [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.scripts.chaos_soak", "--episodes", "2",
         "--no-subprocess", "--device", "cpu", "--work-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, lines
    verdict = json.loads(lines[0])
    assert verdict["ok"] is True and verdict["episodes"] == 2 and verdict["sanitizer"] is None
    assert "chaos: episode 1/2" in proc.stderr
