"""The port stands alone: neither its package nor ``chip_smoke.py`` imports
jax or any module of the JAX package, and its entry points never fall back
to the CPU on their own."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.config import Config
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PACKAGE = os.path.join(_ROOT, "howtotrainyourmamlpytorch_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "howtotrainyourmamlpytorch_tpu")


def _sources():
    for dirpath, _, files in os.walk(_PACKAGE):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(_ROOT, "chip_smoke.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_no_source_imports_jax_or_the_jax_package():
    offenders = [
        (os.path.relpath(path, _ROOT), mod)
        for path in _sources()
        for mod in _imported_modules(path)
        if mod.split(".")[0] in _FORBIDDEN
    ]
    assert offenders == []


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import howtotrainyourmamlpytorch_tpu_torch\n"
        "from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine\n"
        "from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem\n"
        "from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint\n"
        "from howtotrainyourmamlpytorch_tpu_torch.ops import fused_update, _kernels, msl, outer_adam\n"
        "from howtotrainyourmamlpytorch_tpu_torch import data, native, observability, train\n"
        "from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentRunner, storage\n"
        "from howtotrainyourmamlpytorch_tpu_torch.resilience import faults, retry, watchdog\n"
        "from howtotrainyourmamlpytorch_tpu_torch.core import strategies\n"
        "from howtotrainyourmamlpytorch_tpu_torch.observability import context, memory\n"
        "from howtotrainyourmamlpytorch_tpu_torch import analysis\n"
        "from howtotrainyourmamlpytorch_tpu_torch.utils import results_archive\n"
        "from howtotrainyourmamlpytorch_tpu_torch import serve, serving\n"
        "from howtotrainyourmamlpytorch_tpu_torch.serving import (batcher, buckets, cache, errors, metrics,\n"
        "    pool, registry, router, server, sessions, tenancy)\n"
        "from howtotrainyourmamlpytorch_tpu_torch.serving.tenancy import TenantQuotas, WeightPager\n"
        "from howtotrainyourmamlpytorch_tpu_torch.resilience import breaker\n"
        "from howtotrainyourmamlpytorch_tpu_torch.resilience import campaign\n"
        "from howtotrainyourmamlpytorch_tpu_torch.serving import gateway\n"
        "from howtotrainyourmamlpytorch_tpu_torch.observability import slo\n"
        "from howtotrainyourmamlpytorch_tpu_torch import loadgen\n"
        "from howtotrainyourmamlpytorch_tpu_torch import parallel\n"
        "from howtotrainyourmamlpytorch_tpu_torch.parallel import mesh\n"
        "from howtotrainyourmamlpytorch_tpu_torch import lint\n"
        "lint.run_lint(['howtotrainyourmamlpytorch_tpu_torch/exit_codes.py'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'howtotrainyourmamlpytorch_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_device_means_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MAMLSystem(Config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdaptationEngine.from_run_dir(os.path.join(_ROOT, "no_such_run"), cfg=Config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExperimentRunner(Config())


# a JAX package path, or a root script that imports it (the port's own
# counterparts live in the package)
_JAX_PATHS = re.compile(
    r"howtotrainyourmamlpytorch_tpu(?!_torch)|train_maml_system|launch_all\.py|"
    r"scripts[/\\](?:grad_precision_probe|checkpoint_autopsy|stream_replay_probe|descent_probe|donation_probe|"
    r"imagenet_at_scale|summarize_run)\.py"
)


def test_no_source_names_a_jax_package_file():
    """No string in the port (docstrings aside) names a file of the JAX
    package or a root script that imports it, so nothing loads one by
    path."""
    offenders = []
    for path in _sources():
        if path.endswith("chip_smoke.py"):
            continue  # its kernels line names the TPU kernels it replaces
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        docstrings = {id(node.value) for node in ast.walk(tree)
                      if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)}
        offenders += [(os.path.relpath(path, _ROOT), node.lineno) for node in ast.walk(tree)
                      if isinstance(node, ast.Constant) and isinstance(node.value, str)
                      and id(node) not in docstrings and _JAX_PATHS.search(node.value)]
    assert offenders == []


def test_the_diagnostic_scripts_and_the_sweep_load_no_jax():
    code = (
        "import sys\n"
        "from howtotrainyourmamlpytorch_tpu_torch import bench, bench_serving, launch_all\n"
        "from howtotrainyourmamlpytorch_tpu_torch.scripts import (checkpoint_autopsy, descent_probe, donation_probe,\n"
        "    grad_precision_probe, imagenet_at_scale, stream_replay_probe, summarize_run)\n"
        "for module in (checkpoint_autopsy, descent_probe, donation_probe, grad_precision_probe, imagenet_at_scale,\n"
        "               stream_replay_probe, launch_all, bench, bench_serving):\n"
        "    try:\n"
        "        module.main(['--help'])\n"
        "    except SystemExit as exc:\n"
        "        assert exc.code == 0, module\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'howtotrainyourmamlpytorch_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "drops" in proc.stdout or "Dropped" in proc.stdout or "ignored" in proc.stdout
