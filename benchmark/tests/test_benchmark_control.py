"""The control of every cell, on the card: the program one precision below
the configuration's (TF32 where the configuration states IEEE float32:
its ``matmul_precision: high``) has to come out not correct, on three
seeds, where the program as configured comes out correct. The training
cell reads its set-up's comparison (no window needs measuring); the
serving cell a short window at its own load; both at their own sizes.

    python -m pytest benchmark/tests/test_benchmark_control.py -m cuda -q
"""

import pytest
import torch

import run as bench
from harness import cells, runtime

pytestmark = pytest.mark.cuda

SEEDS = (2147483861, 2147483862, 2147483863)
CONTROL = {"matmul_precision": "high"}
TRAIN_CELLS = ("train.omniglot20w5s-vgg64",)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32, the control's precision, exists only there")
    bench._paths()
    return torch.device("cuda")


def _run(cell_name, seed, device, overrides, seconds=0.0):
    spec = cells.benchmark_spec()
    cell = cells.workload(spec, cell_name)
    config = cells.part("configs", cell["config"])
    traffic = cells.part("traffic", cell["traffic"])
    limits = cells.part("limits", cell_name)["limits"]
    args = bench.parse(["--workload", cell_name, "--seed", str(seed), "--seconds", str(seconds)])
    return bench.Run(args, cell, config, traffic, limits, device, runtime.Spans(), bench.NoFaults(), overrides), traffic


@pytest.mark.parametrize("cell_name", TRAIN_CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_is_not_correct(card, cell_name, seed):
    from harness import compare

    for overrides, expect in ((None, True), (CONTROL, False)):
        run, traffic = _run(cell_name, seed, card, overrides)
        driver = cells.driver(traffic["driver"])
        checks = driver.check(run, driver.setup(run))
        assert compare.passed(checks) is expect, checks
        torch.cuda.empty_cache()


@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_is_not_correct(card, seed):
    for overrides, expect in ((None, True), (CONTROL, False)):
        run, traffic = _run("serve.omniglot20w5s-vgg64.over-knee", seed, card, overrides, seconds=6.0)
        result = cells.driver(traffic["driver"]).run(run)
        assert result["correct"] is expect, result["checks"]
        torch.cuda.empty_cache()
