"""The plain reference against the port at tiny sizes on the CPU: three
meta-steps (losses, the first gradient, the trainables after the steps)
and a served request (adapt, then the query probabilities). The test
imports both; the reference itself imports nothing of the port."""

import ast
import os

import numpy as np
import pytest
import torch

from harness import cells, program
from reference import maml as ref

TINY = {"dataset": "omniglot", "net": "vgg", "inner_optim": {"kind": "sgd", "lr": 0.1}, "num_classes_per_set": 5,
        "num_samples_per_class": 5, "num_target_samples": 1, "batch_size": 2, "number_of_training_steps_per_iter": 2,
        "number_of_evaluation_steps_per_iter": 2, "multi_step_loss_num_epochs": 10, "meta_learning_rate": 0.001,
        "min_learning_rate": 1e-05, "total_epochs": 150, "total_iter_per_epoch": 500, "use_pallas_inner_update": True}


def _double(d):
    return {k: v.double() if v.is_floating_point() else v for k, v in d.items()}


@pytest.mark.parametrize("net,dataset", [("vgg", "omniglot"), ("resnet-4", "imagenet")])
def test_three_meta_steps_agree(net, dataset):
    """The program's first three steps (``train_step``, one a dispatch)
    against the reference (float64) taken from the program's state before
    each: the loss, every leaf's gradient as the outer Adam takes it and its
    change, by the cell's own comparison. Float32 rounds the second step's
    gradients at about 1e-3 of their norm at this size, on both sides."""
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem

    drv = cells.driver("train_steps")
    cfg = {**TINY, "net": net, "dataset": dataset}
    system = MAMLSystem(program.program_config(cfg), device="cpu")
    params = ref.init_params(cfg, program.generator(3, 0, "cpu"), "cpu")
    lrs = {k: torch.tensor(0.1) for k in params}
    data = program.episodes(cfg, 3, program.generator(3, 1, "cpu"), "cpu", 0.3)
    stepper = drv._Stepper(system, data, 1)
    _, losses, snaps = drv._first_steps(stepper, program.train_state(system, params, lrs), 3)
    gaps = drv.compared(cfg, losses, snaps, data, torch.float64)
    assert gaps["loss_gap"] < 1e-4
    assert gaps["grad_gap"] < 2e-2 and gaps["change_gap"] < 0.1
    # the step is not the identity: a state left unchanged reads 1
    unchanged = drv.compared(cfg, losses, [snaps[0]] * 4, data, torch.float64)
    assert unchanged["grad_gap"] > 0.5 and unchanged["change_gap"] > 0.5


def test_a_served_request_agrees():
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine

    cfg = {**TINY, "serving.support_buckets": [25], "serving.query_buckets": [7]}
    system = MAMLSystem(program.program_config(cfg), device="cpu")
    params = ref.init_params(cfg, program.generator(4, 0, "cpu"), "cpu")
    lrs = {k: torch.tensor(0.05 + 0.01 * i) for i, k in enumerate(params)}
    engine = AdaptationEngine(system, program.train_state(system, params, lrs))
    drv = cells.driver("open_loop_adapt_predict")
    x_s, y_s, x_q = drv.request(cfg, 4, 0, 0, 7, 0.3)
    probs = engine.predict(engine.adapt(x_s, y_s), x_q)
    expect = ref.adapt_predict(cfg, _double(params), _double(lrs), torch.as_tensor(x_s).reshape(25, 28, 28, 1).double(),
                               torch.as_tensor(y_s.reshape(-1)).long(), torch.as_tensor(x_q).double(), 2)
    assert np.abs(probs - expect.numpy()).max() < 1e-4


def test_the_reference_imports_nothing_of_the_program():
    for name in os.listdir(os.path.join(cells.BENCH_DIR, "reference")):
        if name.endswith(".py"):
            with open(os.path.join(cells.BENCH_DIR, "reference", name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for mod in mods:
                    assert mod.split(".")[0] in ("math", "typing", "torch", "") or node.level > 0, (name, mod)
