"""Settings of the benchmark's own tests, run as ``pytest benchmark/tests``
(on the CPU; the tests marked ``cuda`` need a card and skip without one).
The harness's directory and the repository's root go on the path, as
``benchmark/run.py`` puts them."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
