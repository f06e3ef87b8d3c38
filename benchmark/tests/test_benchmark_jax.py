"""No module a run loads has the top-level name ``jax``, ``jaxlib``, ``flax``
or that of the JAX package (names compared whole: the port's begins with
the JAX package's). A fresh interpreter imports ``run.py``, every driver,
metric reader, the reference, the tools, and the port's modules the drivers
use."""

import glob
import json
import os
import subprocess
import sys

from harness import cells

SCRIPT = r"""
import glob, json, os, sys
bench = sys.argv[1]
sys.path[:0] = [bench, os.path.dirname(bench)]
import run, calibrate, count_flops, knee_sweep
from harness import cells, compare, faults, peaks, program, runtime, trace
from reference import costs, maml
for path in glob.glob(os.path.join(bench, "drivers", "*.py")):
    cells.driver(os.path.basename(path)[:-3], bench)
for path in glob.glob(os.path.join(bench, "metrics", "*.py")):
    cells.metric_reader(os.path.basename(path)[:-3], bench)
from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine
from howtotrainyourmamlpytorch_tpu_torch.serving.server import ServingFrontend
print(json.dumps({"forbidden": runtime.forbidden_modules(), "modules": len(sys.modules)}))
"""


def test_no_jax_module_is_loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT, cells.BENCH_DIR], capture_output=True, text=True,
                         timeout=300, cwd=cells.ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["forbidden"] == [] and line["modules"] > 100


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from harness import runtime

    monkeypatch.setitem(sys.modules, "howtotrainyourmamlpytorch_tpu_torch_lookalike", sys)
    assert "howtotrainyourmamlpytorch_tpu" not in runtime.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in runtime.forbidden_modules()
    assert len(glob.glob(os.path.join(cells.BENCH_DIR, "metrics", "*.py"))) >= 1
