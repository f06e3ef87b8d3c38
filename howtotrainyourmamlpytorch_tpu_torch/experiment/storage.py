"""Experiment artifacts: folder tree, CSV statistics, JSON experiment log.

Same artifact contract as the reference (``utils/storage.py``; SURVEY.md §2.6)
so notebook-style analysis keeps working unchanged:
``{exp}/saved_models``, ``{exp}/logs``, ``{exp}/visual_outputs``;
``logs/summary_statistics.csv`` (one row per epoch incl. ``epoch``,
``train_accuracy_mean``, ``val_accuracy_mean``); ``logs/test_summary.csv``
(``test_accuracy_mean``); ``lrs.csv`` / ``betas.csv`` (one row per epoch of
learned per-tensor inner-opt hyperparams, reference
``few_shot_learning_system.py:366-376``); plus a structured JSONL stream the
reference lacks (SURVEY.md §5.5).
"""

import csv
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


def build_experiment_folder(experiment_dir: str) -> Tuple[str, str, str]:
    """Create {exp}/saved_models, {exp}/logs, {exp}/visual_outputs (reference
    utils/storage.py:48-65)."""
    saved_models = os.path.join(experiment_dir, "saved_models")
    logs = os.path.join(experiment_dir, "logs")
    visual = os.path.join(experiment_dir, "visual_outputs")
    for d in (experiment_dir, saved_models, logs, visual):
        os.makedirs(d, exist_ok=True)
    return saved_models, logs, visual


def save_statistics(log_dir: str, statistics: Dict[str, Any], filename: str = "summary_statistics.csv") -> str:
    """Append one row; writes the header on first use (reference
    utils/storage.py:17-28). If the new row's columns differ from the existing
    header (e.g. a later run appends ensemble columns), the file is rewritten
    under the union of columns so rows never go positionally misaligned."""
    path = os.path.join(log_dir, filename)
    fieldnames = list(statistics.keys())
    if os.path.exists(path):
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            existing_fields = reader.fieldnames or []
            if existing_fields != fieldnames:
                rows = list(reader)
                merged = list(existing_fields) + [
                    k for k in fieldnames if k not in existing_fields
                ]
                with open(path, "w", newline="") as g:
                    writer = csv.DictWriter(g, fieldnames=merged, restval="")
                    writer.writeheader()
                    writer.writerows(rows)
                fieldnames = merged
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames, restval="")
        if f.tell() == 0:
            writer.writeheader()
        writer.writerow({k: _scalar(v) for k, v in statistics.items()})
    return path


def load_statistics(log_dir: str, filename: str = "summary_statistics.csv") -> List[Dict[str, str]]:
    path = os.path.join(log_dir, filename)
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def append_hparam_row(run_dir: str, values, filename: str) -> None:
    """lrs.csv / betas.csv rows in the run dir (reference
    few_shot_learning_system.py:366-376: bare comma-joined floats, no header)."""
    with open(os.path.join(run_dir, filename), "a") as f:
        f.write(",".join(str(float(v)) for v in values) + "\n")


# ---------------------------------------------------------------------------
# JSON experiment log (reference utils/storage.py:81-130)
# ---------------------------------------------------------------------------


def _log_path(log_dir: str, experiment_name: str) -> str:
    return os.path.join(log_dir, f"{experiment_name}.json")


def create_json_experiment_log(log_dir: str, experiment_name: str, args: Dict[str, Any]) -> str:
    path = _log_path(log_dir, experiment_name)
    if not os.path.exists(path):
        summary = {
            "args": args,
            "experiment_status": ["created at {}".format(time.strftime("%Y-%m-%d %H:%M:%S"))],
            "epoch_stats": {},
        }
        with open(path, "w") as f:
            json.dump(summary, f, indent=1)
    return path


def update_json_experiment_log_epoch_stats(
    log_dir: str, experiment_name: str, epoch: int, stats: Dict[str, Any]
) -> None:
    path = _log_path(log_dir, experiment_name)
    with open(path) as f:
        summary = json.load(f)
    for key, value in stats.items():
        summary["epoch_stats"].setdefault(key, []).append(_scalar(value))
    summary["latest_epoch"] = epoch
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)


def change_json_log_experiment_status(log_dir: str, experiment_name: str, status: str) -> None:
    path = _log_path(log_dir, experiment_name)
    with open(path) as f:
        summary = json.load(f)
    summary["experiment_status"].append(
        "{} at {}".format(status, time.strftime("%Y-%m-%d %H:%M:%S"))
    )
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)


class EventLog:
    """Persistent ``events.jsonl`` handle for one run.

    Post-mortems (wedge stack dumps, preemption events) are read precisely
    when the process died ugly, so durability beats buffering: every append
    is written whole and flushed under a lock (the wedge watchdog appends
    from its own thread while the main thread hangs), and the runner closes
    the handle on every exit path — normal completion, the rc=3 divergence
    abort, the rc=75 preemption exit, and the rc=76 wedge ``os._exit`` (which
    skips ``finally`` blocks, so the wedge path closes explicitly first).
    ``close`` is idempotent; appending after close falls back to an
    open-append-close so a late event is never silently dropped."""

    def __init__(self, log_dir: str, filename: str = "events.jsonl"):
        self.path = os.path.join(log_dir, filename)
        self._lock = threading.Lock()
        self._handle = None
        self._closed = False

    def append(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record) + "\n"
        with self._lock:
            if self._closed:
                with open(self.path, "a") as f:
                    f.write(line)
                return
            if self._handle is None:
                self._handle = open(self.path, "a")
            self._handle.write(line)
            self._handle.flush()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._handle is not None:
                try:
                    self._handle.flush()
                    self._handle.close()
                finally:
                    self._handle = None
