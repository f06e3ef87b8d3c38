"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files (and entries of ``BENCHMARK.json``), editing no file of the
benchmark: in a copy of ``benchmark/``, the toy cells' files and a new
metric reader are added, and a run in a fresh interpreter finds them by
name and reports the new metric."""

import hashlib
import json
import os
import subprocess
import sys

import toycells

READER = '''"""Steps in the untraced window (a toy metric of this test)."""

MOVES = "meta_steps_per_s"


def read(record, run):
    return float(record["steps"])
'''

LAUNCH = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import run
code, line = run.execute(sys.argv[2:], device="cpu")
print(json.dumps(line))
sys.exit(code)
"""


def _digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            if "__pycache__" not in base:
                with open(os.path.join(base, name), "rb") as f:
                    out[os.path.relpath(os.path.join(base, name), root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    spec = toycells.build(root, copy_code=True)
    bench = os.path.join(root, "benchmark")
    before = _digests(toycells.BENCH_DIR)
    with open(os.path.join(bench, "metrics", "toy_steps.train.py"), "w") as f:
        f.write(READER)
    spec["per_layer"].append({"name": "toy_steps.train", "unit": "steps", "better": "higher", "source": "host_clock",
                              "layer": "program layer", "moves": "meta_steps_per_s", "workloads": ["toy.train.vgg"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    env = {**os.environ, "PYTHONPATH": toycells.ROOT}
    out = subprocess.run([sys.executable, "-c", LAUNCH, bench] + toycells.args("toy.train.vgg", trace=1),
                         capture_output=True, text=True, timeout=600, cwd=root, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert line["metrics"]["toy_steps.train"]["value"] > 0
    assert "host_enqueue_ms.train" in line["metrics"]
    # the copied files are the benchmark's own, unedited
    after = _digests(bench)
    assert all(after[name] == digest for name, digest in before.items() if not name.startswith("tests"))
