"""The port's static-analysis gate over the shipped tree, on the CPU:

- the self-gate: ``howtotrainyourmamlpytorch_tpu_torch`` (its ``scripts/``
  too) and ``chip_smoke.py`` have no unsuppressed finding, at most 20
  suppressed ones (the JAX gate's budget), each with a written reason;
- the paths the port's hot and captured code lives on, each gated on its
  own terms: ``core/programs.py``, ``core/maml.py``, ``serving/engine.py``,
  ``serving/pool.py``, ``experiment/runner.py``, ``bench.py``;
- the capture analysis reaches the steps the port's graphs record, and the
  hot paths it holds exist;
- the import-light contract: the markers are present and GL213 reports
  nothing.
"""

import functools
import os

import pytest

from howtotrainyourmamlpytorch_tpu_torch import lint
from howtotrainyourmamlpytorch_tpu_torch.lint import rules_torch
from tools.graftlint.engine import load_project
from tools.graftlint.rules_concurrency import _module_is_import_light

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "howtotrainyourmamlpytorch_tpu_torch"
SCOPE = [PACKAGE, "chip_smoke.py"]
SUPPRESSION_BUDGET = 20
IMPORT_LIGHT = [f"{PACKAGE}/{rel}" for rel in ("exit_codes.py", "serving/gateway.py", "serving/fleetctl.py",
                                               "serving/autoscaler.py", "scripts/gateway.py",
                                               "scripts/rolling_restart.py", "scripts/fleet_serve.py")]


def _in_repo(fn, *args):
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return fn(*args)
    finally:
        os.chdir(cwd)


@functools.lru_cache(maxsize=None)
def _gate():
    return _in_repo(lint.run_lint, SCOPE)


def test_self_gate_has_zero_unsuppressed_findings():
    active, suppressed = _gate()
    assert active == [], "unsuppressed findings:\n" + "\n".join(f.format() for f in active)
    assert len(suppressed) <= SUPPRESSION_BUDGET, [f.format() for f in suppressed]


def test_every_suppression_carries_its_reason():
    """A suppression names what supervises the finding: the comment that
    holds the directive, or the comment lines right above it (above a run
    of lines suppressed alike), say more than the directive."""
    _, suppressed = _gate()
    sources = {}
    for f in suppressed:
        lines = sources.setdefault(f.path, open(os.path.join(REPO, f.path)).read().splitlines())
        directive = f"graftlint: disable={f.rule}"
        text, i = [], f.line - 1
        if "#" in lines[i]:
            text.append(lines[i].split("#", 1)[1])
        while i > 0 and directive in lines[i - 1] and not lines[i - 1].strip().startswith("#"):
            i -= 1
        while i > 0 and lines[i - 1].strip().startswith("#"):
            i -= 1
            text.append(lines[i].strip().lstrip("#"))
        words = " ".join(text).replace(directive, "").split()
        assert len(words) >= 4, f"{f.format()} has no reason"


@pytest.mark.parametrize("rel", ["core/programs.py", "core/maml.py", "serving/engine.py", "serving/pool.py",
                                 "experiment/runner.py", "bench.py"])
def test_gate_holds_on_each_hot_or_captured_path(rel):
    active, _ = _in_repo(lint.run_lint, [os.path.join(PACKAGE, rel)])
    assert active == [], "\n".join(f.format() for f in active)


def _module(rel):
    project = _in_repo(load_project, [os.path.join(PACKAGE, rel)])
    return project.modules[0]


@pytest.mark.parametrize("rel,reached", [
    ("core/maml.py", {"_train_graph_step", "_eval_graph_step", "_train_step_impl", "_eval_step_impl",
                      "_meta_gradients", "_meta_objective", "_rollout", "_write_into", "_drop_batch"}),
    ("core/programs.py", {"_copy_into", "_keep"}),
    ("serving/engine.py", {"_program_fn"}),
])
def test_the_capture_analysis_reaches_the_graph_steps(rel, reached):
    """GL101/GL102 are not vacuous: from the port's capture roots the
    analysis reaches the steps its CUDA graphs record."""
    names = {getattr(fn, "name", "<lambda>") for fn in rules_torch.capture_reachable(_module(rel))}
    assert reached <= names, sorted(reached - names)


def test_the_hot_paths_exist():
    """Every GL110 hot path names a function of the package."""
    found = {}
    for suffix in rules_torch.HOT_PATHS:
        mod = _module(suffix)
        found[suffix] = {fn.name for fn in rules_torch.hot_functions(mod)}
    want = {suffix: {name.split(".")[-1] for name in names} for suffix, names in rules_torch.HOT_PATHS.items()}
    assert found == want


def test_import_light_contract_is_marked_and_clean():
    project = _in_repo(load_project, SCOPE)
    marked = {m.rel for m in project.modules if _module_is_import_light(m)}
    assert set(IMPORT_LIGHT) <= marked, sorted(set(IMPORT_LIGHT) - marked)
    active, suppressed = _in_repo(lint.run_lint, SCOPE, ["GL213"])
    assert active == [] and suppressed == [], "\n".join(f.format() for f in active + suppressed)
