"""A whole run of each toy cell on the CPU (the look for a card skipped),
sound, and with each fault the cell can have planted under its timed path
(``harness/faults.py``): the sound run is correct, every fault makes
``correct`` false, and the run still prints every number beside its
limit."""

import pytest

import run as bench
import toycells
from harness import faults

CASES = [(cell, name) for cell in toycells.TOY_CELLS for name in faults.for_cell(*toycells.parts(cell))]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("toy")
    toycells.build(str(path))
    return str(path)


@pytest.mark.parametrize("cell", list(toycells.TOY_CELLS))
def test_a_sound_run_is_correct(root, cell):
    code, line = bench.execute(toycells.args(cell), device="cpu", root=root)
    assert code == 0 and line["correct"], line
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks" and line["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_each_fault_makes_the_run_incorrect(root, cell, fault):
    kinds = {**faults.TRAIN_FAULTS, **faults.SERVE_FAULTS}
    code, line = bench.execute(toycells.args(cell), device="cpu", root=root, faults=kinds[fault]())
    assert code == 0 and not line["correct"], line["checks"]
