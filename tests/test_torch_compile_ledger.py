"""The port's compile ledger (``observability/compile_ledger.py``), mirroring
``tests/test_perf_obs.py``'s ledger tests: cold, warm and new-shape entries
from eager first dispatches; a first dispatch that raises is recorded and
re-raised (the JAX ledger falls back to the plain jitted call instead); the
runner's observer sets ``flops_per_step`` (divided by K for
``train_multi``); the ``RecompileGuard`` seam; an ``nvcc/*`` entry per
source of a build report. Then the seams against JAX's: the system's and
the engine's ledger program names on the same traffic."""

import json
import os
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.observability.compile_ledger import CompileLedger as JaxLedger
from howtotrainyourmamlpytorch_tpu_torch.experiment.runner import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.observability.compile_ledger import CompileLedger, program_name
from howtotrainyourmamlpytorch_tpu_torch.observability.metrics import MetricsRegistry
from howtotrainyourmamlpytorch_tpu_torch.utils.strictmode import RecompileGuard

from .test_torch_strictmode import IMG, _jax_system, _support, _tiny_cfg, _tiny_system, engines  # noqa: F401
from .test_torch_train import _jnp, batch, pair

torch.set_num_threads(2)


def _entries(logs_dir):
    with open(os.path.join(logs_dir, "compile_ledger.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_compile_ledger_cold_warm_and_new_shape(tmp_path):
    ledger = CompileLedger(logs_dir=str(tmp_path))
    wrapped = ledger.wrap_build(("toy", 1), lambda x: x @ x.T * 2 + 1)
    a = torch.ones(4, 3)
    out1 = wrapped(a)
    out2 = wrapped(a + 1)  # same signature: no new entry
    assert torch.equal(out2, (a + 1) @ (a + 1).T * 2 + 1)
    assert ledger.summary()["entries"] == 1
    wrapped(torch.ones(8, 3))  # a new shape is a first dispatch again
    summary = ledger.summary()
    assert summary["entries"] == 2 and summary["by_program"]["toy/1"]["builds"] == 2
    ledger.close()
    entries = _entries(str(tmp_path))
    assert len(entries) == 2
    for e in entries:
        assert e["program"] == "toy/1" and e["cold"] is True and e["total_s"] >= 0
        assert e["lower_s"] is None and e["compile_s"] is None  # an eager dispatch has no build phases
        assert "persistent_cache" in e and e["error"] is None
    # the first dispatch was priced by the flop counter on the way
    assert [e["flops"] for e in entries] == [2 * 4 * 3 * 4, 2 * 8 * 3 * 8]
    assert set(entries[0]) >= set(JaxLedger().record("x"))  # the JAX line's keys
    assert torch.equal(out1, a @ a.T * 2 + 1)


def test_a_first_dispatch_that_raises_is_recorded_and_reraised(tmp_path):
    ledger = CompileLedger(logs_dir=str(tmp_path))

    def broken(x):
        raise RuntimeError("no such kernel")

    wrapped = ledger.wrap_build("broken", broken)
    for attempt in (1, 2):  # not pinned: each attempt is a first dispatch
        with pytest.raises(RuntimeError, match="no such kernel"):
            wrapped(torch.ones(2))
        assert ledger.summary()["by_program"]["broken"]["errors"] == attempt
    ledger.close()
    assert all("RuntimeError: no such kernel" in e["error"] for e in _entries(str(tmp_path)))


@pytest.mark.parametrize("program, flops, want", [
    ("train_multi/True/True", 400.0, 100.0),  # K = 4 steps per dispatch
    ("train/True/False", 50.0, 50.0),
    ("eval_multi", 70.0, None),
    ("train/True/True", None, None),
])
def test_observer_sets_flops_per_step(program, flops, want):
    fake = types.SimpleNamespace(cfg=types.SimpleNamespace(train_steps_per_dispatch=4),
                                 hub=types.SimpleNamespace(registry=MetricsRegistry()))
    ledger = CompileLedger()
    ledger.on_entry = lambda entry: ExperimentRunner._note_program_cost(fake, entry)
    ledger.record(program, total_s=0.1, flops=flops)
    assert fake.hub.registry.gauge("flops_per_step") == want


def test_observer_and_recompile_guard_seam():
    ledger = CompileLedger()  # collector-only (the serving frontend's)
    seen = []
    ledger.on_entry = seen.append
    guard = RecompileGuard(budget=4, name="probe")
    guard.ledger = ledger
    wrapped = guard.wrap(lambda x: (time.sleep(0.002), x * x)[1])
    wrapped(torch.ones(3))
    wrapped(torch.ones(3))  # warm: no new signature, no entry
    wrapped(torch.ones(5))
    summary = ledger.summary()
    assert summary["entries"] == 2
    prog = summary["by_program"]["probe/<lambda>"]
    assert prog["builds"] == 2 and prog["total_s"] > 0
    assert len(seen) == 2 and all(e["total_s"] > 0 for e in seen)
    # a broken observer never breaks recording
    ledger.on_entry = lambda e: 1 / 0
    wrapped(torch.ones(7))
    assert ledger.summary()["entries"] == 3


def test_nvcc_entries_from_a_build_report(tmp_path):
    ledger = CompileLedger(logs_dir=str(tmp_path))
    report = {
        "fused_sgd.cu": {"library": "/b/libfused_sgd-0.so", "built": True, "seconds": 3.25, "ptxas": ""},
        "fused_sgd_bwd.cu": {"library": "/b/libfused_sgd_bwd-0.so", "built": False, "seconds": 0.0, "ptxas": ""},
    }
    ledger.record_kernel_builds(report, "/b")
    ledger.close()
    by = {e["program"]: e for e in _entries(str(tmp_path))}
    assert set(by) == {"nvcc/fused_sgd.cu", "nvcc/fused_sgd_bwd.cu"}
    built, hit = by["nvcc/fused_sgd.cu"], by["nvcc/fused_sgd_bwd.cu"]
    assert (built["compile_s"], built["total_s"], built["cold"]) == (3.25, 3.25, True)
    assert built["persistent_cache"] == {"dir": "/b", "entries_added": 1, "hit": False}
    assert hit["persistent_cache"] == {"dir": "/b", "entries_added": 0, "hit": True} and hit["cold"] is False
    assert ledger.summary()["cache_hits"] == 1
    assert program_name(("train", True, False)) == "train/True/False"


def test_system_ledger_programs_match_jax():
    """The same calls on both systems give the same program names: the
    train variant and eval on their first dispatches, then the multi-step
    programs; the port prices each (FLOPs), a train_multi entry K steps."""
    jsys, jstate, tsys, tstate = pair("vgg", unroll_inner_steps=False)
    ledgers = {"jax": JaxLedger(), "port": CompileLedger()}
    jsys.attach_compile_ledger(ledgers["jax"])
    tsys.attach_compile_ledger(ledgers["port"])
    bs = [batch(seed=i) for i in range(3)]
    stacked = {k: np.stack([b[k] for b in bs]) for k in bs[0]}
    for b in bs[:2]:
        jstate, _ = jsys.train_step(jstate, _jnp(b), epoch=0)
        tstate, _ = tsys.train_step(tstate, b, epoch=0)
    jsys.eval_step(jstate, _jnp(bs[0]))
    tsys.eval_step(tstate, bs[0])
    jsys.train_step_multi(jstate, {k: jnp.asarray(v) for k, v in stacked.items()}, 0)
    tsys.train_step_multi(tstate, stacked, 0)
    jsys.eval_step_multi(jstate, {k: jnp.asarray(v) for k, v in stacked.items()})
    tsys.eval_step_multi(tstate, stacked)
    names = {k: sorted(led.summary()["by_program"]) for k, led in ledgers.items()}
    assert names["port"] == names["jax"]
    by = ledgers["port"].summary()["by_program"]
    assert all(p["flops"] and p["builds"] == 1 for p in by.values())
    train = next(k for k in by if k.startswith("train/"))
    multi = next(k for k in by if k.startswith("train_multi/"))
    assert by[multi]["flops"] == pytest.approx(3 * by[train]["flops"])


def test_engine_first_dispatches_match_jax_names(engines):  # noqa: F811
    """Each program's build (on the CPU its first flush) is one entry,
    priced by the flop counter as JAX's bucket programs are, named as the
    JAX engine names its programs."""
    port, jax_engine = engines
    ledgers = {"port": CompileLedger(), "jax": JaxLedger()}
    port.compile_ledger, jax_engine.compile_ledger = ledgers["port"], ledgers["jax"]
    try:
        for engine in (port, jax_engine):
            fw = engine.adapt(*_support(1, 40))
            engine.adapt(*_support(1, 41))  # the same shape: no entry
            engine.adapt_batch([_support(1, 42), _support(1, 43)])
            engine.predict(fw, np.zeros((10, *IMG), np.float32))
    finally:
        port.compile_ledger = jax_engine.compile_ledger = None
    names = {k: sorted(led.summary()["by_program"]) for k, led in ledgers.items()}
    assert set(names["port"]) <= set(names["jax"]) and len(names["port"]) == 3
    assert all(e["flops"] > 0 for e in ledgers["port"].summary()["by_program"].values())
    assert "compile_ledger" not in port.compile_counts()
