#!/usr/bin/env python
"""Unified run report: telemetry.jsonl + events.jsonl + access.jsonl.

The repo's ``scripts/obs_report.py`` cut to the sections this package's run
directories produce, loading this package's ``exit_codes.py``. Joins the
telemetry surfaces a run leaves behind into one report:

- ``logs/telemetry.jsonl`` (observability/telemetry.py) — step-phase
  histograms (data-wait / dispatch / settle / checkpoint / eval), throughput
  in episodes/s, provider snapshots (recompile guard, watchdog beat age);
- ``logs/events.jsonl`` (experiment/storage.py EventLog) — the resilience
  event stream (NaN skips/rollbacks, preemptions, wedges, degraded mesh);
- ``logs/access.jsonl`` — the serving tables (padding, strategies,
  tenants) and, with ``--fleet-events``, a supervisor's scaling decisions.

- ``logs/compile_ledger.jsonl`` (observability/compile_ledger.py) — the
  compile tax: per-program build seconds (CUDA-graph captures, first
  eager dispatches, ``nvcc`` builds), persistent-cache hits, priced FLOPs and
  graph-pool bytes;
- the ``torch.profiler`` Chrome trace of the run's ``profile_dir`` window,
  when one was written — a device-time breakdown via ``utils/profiling.py``
  (loaded by file path).

The repo script's donation section reads audits a port run does not write
(donation is ROADMAP.md A10.7), so it is not here; on a port run directory
without a profile window both scripts give the same report.

Host-phase coverage is the report's honesty check: the train-loop phase sums
(data-wait + dispatch + settle) over the summed epoch wall-clock. Near 1.0
the phase table explains the run; a low ratio means time is going somewhere
the phases don't span — say so rather than pretend.

Usage::

    python howtotrainyourmamlpytorch_tpu_torch/scripts/obs_report.py exps/<run> \
        [--json] [--oneline] [--chrome-trace out.json]
    python howtotrainyourmamlpytorch_tpu_torch/scripts/obs_report.py --exps-root exps [--json]

``--json`` emits the full machine-readable report, ``--oneline`` one compact
JSON line (what ``scripts/sweep.sh`` appends per finished run),
``--chrome-trace`` copies the run's exported span trace (``logs/trace.json``,
Chrome/Perfetto-loadable) to the given path.

``--exps-root`` is the FLEET mode: every run directory under the root gets
the same per-run ``build_report`` pass, slimmed to its oneline form and
joined with the fleet scheduler's per-cell record (``fleet_cell.json``: rc
history, restarts, status) when one exists — one table/JSON over the whole
matrix, sharing the per-run code path rather than re-implementing it.

Import-light by design (stdlib + the file-path-loaded rc registry; no
torch, no package import): a report over a finished run dir must never touch
(or wait on) the card.
"""

import argparse
import importlib.util
import json
import os
import shutil
import sys
from typing import Any, Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: train-loop phases whose sums are compared against epoch wall-clock; eval
#: and checkpoint run outside the timed train loop
TRAIN_LOOP_PHASES = ("data_wait", "dispatch", "settle")


def _load_by_path(name: str, path: str):
    """File-path module load: keeps this CLI free of the package import
    (which pulls torch)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


try:
    exit_codes = _load_by_path("htymp_torch_exit_codes", os.path.join(_PKG, "exit_codes.py"))
    _RC_OK, _RC_USAGE = exit_codes.OK, exit_codes.USAGE
except Exception:  # standalone copy of scripts/: the historical literals hold
    _RC_OK, _RC_USAGE = 0, 2


def _read_jsonl(path: str):
    """Parse a jsonl file, skipping (and counting) torn lines: a run killed
    hard mid-append leaves a partial final line, and this report must
    degrade on exactly those runs, never die on them."""
    records: List[Dict[str, Any]] = []
    torn = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                torn += 1
    return records, torn


def _hbm_from_session(session: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Peak-HBM watermark over one process session, from the memory
    provider rows the telemetry snapshots carry. None when the run had no
    available memory stats (CPU backends)."""
    peaks: List[float] = []
    headrooms: List[float] = []
    sampled = 0
    for record in session:
        mem = (record.get("providers") or {}).get("memory") or {}
        if not mem.get("available_devices"):
            continue
        sampled += 1
        if mem.get("peak_bytes_in_use_max") is not None:
            peaks.append(float(mem["peak_bytes_in_use_max"]))
        if mem.get("headroom_frac_min") is not None:
            headrooms.append(float(mem["headroom_frac_min"]))
    if not sampled:
        return None
    return {
        "snapshots_with_stats": sampled,
        "peak_bytes_in_use_max": max(peaks) if peaks else None,
        "peak_gib": round(max(peaks) / 2**30, 3) if peaks else None,
        "headroom_frac_min": min(headrooms) if headrooms else None,
    }


def _profiling_module():
    return _load_by_path("htymp_torch_profiling", os.path.join(_PKG, "utils", "profiling.py"))


def _device_breakdown(trace_dir: Optional[str]) -> Optional[Dict[str, Any]]:
    if not trace_dir or not os.path.isdir(trace_dir):
        return None
    try:
        return _profiling_module().device_time_breakdown(trace_dir)
    except Exception as exc:  # noqa: BLE001 — the join degrades, never dies
        return {"error": f"trace parse failed: {exc!r}"}


def _profile_dir_from_config(run_dir: str) -> Optional[str]:
    """``profile_dir`` out of the run's saved config.yaml without a yaml
    dependency surprise: the value is a plain scalar on its own line."""
    path = os.path.join(run_dir, "config.yaml")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        for line in f:
            if line.startswith("profile_dir:"):
                value = line.split(":", 1)[1].strip().strip("'\"")
                return value or None
    return None


def _aggregate_compile_ledger(entries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The compile-tax section: per-program build seconds, build counts,
    persistent-cache hits, priced FLOPs and memory, aggregated from
    ``logs/compile_ledger.jsonl``. Re-implements ``CompileLedger.summary()``'s
    aggregation: this script imports no package, so it cannot replay
    entries through the ledger class. Keep the two shapes in sync."""
    by: Dict[str, Dict[str, Any]] = {}
    for e in entries:
        agg = by.setdefault(
            str(e.get("program", "?")),
            {"builds": 0, "lower_s": 0.0, "compile_s": 0.0, "total_s": 0.0, "cache_hits": 0, "errors": 0,
             "flops": None},
        )
        agg["builds"] += 1
        agg["lower_s"] = round(agg["lower_s"] + (e.get("lower_s") or 0.0), 3)
        agg["compile_s"] = round(agg["compile_s"] + (e.get("compile_s") or 0.0), 3)
        agg["total_s"] = round(agg["total_s"] + (e.get("total_s") or 0.0), 3)
        if (e.get("persistent_cache") or {}).get("hit"):
            agg["cache_hits"] += 1
        if e.get("error"):
            agg["errors"] += 1
        if e.get("flops"):
            agg["flops"] = e["flops"]
        # the memory column: peak bytes (a graph's pool) and the rest where a
        # backend gives them; the latest build wins, like flops
        mem = e.get("memory") or {}
        for src, dst in (("argument_bytes", "argument_bytes"), ("output_bytes", "output_bytes"),
                         ("temp_bytes", "temp_bytes"), ("peak_bytes", "peak_bytes"),
                         ("alias_bytes", "donated_bytes")):
            if mem.get(src) is not None:
                agg[dst] = mem[src]
    peaks = [p["peak_bytes"] for p in by.values() if p.get("peak_bytes")]
    donated = [p["donated_bytes"] for p in by.values() if p.get("donated_bytes")]
    return {
        "entries": len(entries),
        "programs": len(by),
        "total_lower_s": round(sum(p["lower_s"] for p in by.values()), 3),
        "total_compile_s": round(sum(p["compile_s"] for p in by.values()), 3),
        "total_s": round(sum(p["total_s"] for p in by.values()), 3),
        "cache_hits": sum(p["cache_hits"] for p in by.values()),
        "errors": sum(p["errors"] for p in by.values()),
        "peak_program_bytes": max(peaks) if peaks else None,
        "donated_bytes": max(donated) if donated else None,
        "by_program": by,
    }


def build_report(run_dir: str, trace_dir: Optional[str] = None,
                 fleet_events: Optional[str] = None) -> Dict[str, Any]:
    logs_dir = os.path.join(run_dir, "logs")
    tel_path = os.path.join(logs_dir, "telemetry.jsonl")
    report: Dict[str, Any] = {
        "report": "obs",
        "run_dir": run_dir,
        "run": os.path.basename(os.path.normpath(run_dir)),
    }
    # fleet scaling decisions: an explicit --fleet-events path
    # (the supervisor's events.jsonl lives next to fleet_state.json, not in
    # a run dir) — replayed into a chronological decision table
    fleet_records: List[Dict[str, Any]] = []
    if fleet_events:
        if os.path.exists(fleet_events):
            fleet_records, torn_fleet = _read_jsonl(fleet_events)
            if torn_fleet:
                report["torn_fleet_event_lines"] = torn_fleet
        else:
            report["fleet_events_error"] = f"no such file: {fleet_events}"
    if not os.path.exists(tel_path):
        report["error"] = (
            "no logs/telemetry.jsonl — run predates the observability "
            "subsystem or had observability.enabled=false"
        )
        # a supervisor's decision log needs no telemetry — degrade to the
        # scaling table alone rather than dying on the missing file
        scaling = _scaling_from_events(fleet_records)
        if scaling is not None:
            report["scaling"] = scaling
        return report

    snapshots, torn = _read_jsonl(tel_path)
    if torn:
        report["torn_telemetry_lines"] = torn
    if not snapshots:
        report["error"] = (
            "logs/telemetry.jsonl holds no parseable snapshot "
            "(run died before its first snapshot, or every line is torn)"
        )
        return report
    # a resumed run APPENDS a fresh process session to the same
    # telemetry.jsonl, and each session's cumulative counters restart —
    # phase sums and wall-clock must be compared within ONE session, never
    # a suffix against the whole file. Snapshots carry a per-process
    # "session" id; split on it, falling back to a counter-reset heuristic
    # for id-less records.
    sessions: List[List[Dict[str, Any]]] = [[]]
    prev = None
    for record in snapshots:
        if prev is not None:
            if "session" in record or "session" in prev:
                new_session = record.get("session") != prev.get("session")
            else:
                new_session = (
                    float(record.get("elapsed_s") or 0.0)
                    < float(prev.get("elapsed_s") or 0.0)
                    or int(record.get("steps") or 0) < int(prev.get("steps") or 0)
                )
            if new_session:
                sessions.append([])
        sessions[-1].append(record)
        prev = record
    session = sessions[-1]  # report the latest process session
    epochs_all = [s for s in snapshots if s.get("kind") == "epoch"]
    epochs = [s for s in session if s.get("kind") == "epoch"]
    last = session[-1]
    phases = last.get("phases", {})
    report.update(
        {
            "snapshots": len(snapshots),
            "sessions": len(sessions),
            "epochs": len(epochs_all),
            "session_epochs": len(epochs),
            "steps": last.get("steps"),
            "episodes": last.get("episodes"),
            "episodes_per_s": last.get("episodes_per_s"),
            "elapsed_s": last.get("elapsed_s"),
            "phases": phases,
            "providers": last.get("providers", {}),
            "dropped_spans": last.get("dropped_spans", 0),
            "mfu": last.get("mfu"),
        }
    )

    # peak HBM per session (observability/memory.py provider rows)
    hbm = _hbm_from_session(session)
    if hbm is not None:
        report["hbm"] = hbm

    # cold start (runner gauge: init -> first settled step) — the number
    # the AOT prewarm exists to shrink
    gauges = last.get("gauges") or {}
    if gauges.get("cold_start_s") is not None:
        report["cold_start_s"] = gauges["cold_start_s"]

    # compile tax (logs/compile_ledger.jsonl), scoped to the reported
    # session when the entries carry session ids
    ledger_path = os.path.join(logs_dir, "compile_ledger.jsonl")
    if os.path.exists(ledger_path):
        entries, torn_ledger = _read_jsonl(ledger_path)
        if torn_ledger:
            report["torn_ledger_lines"] = torn_ledger
        session_id = last.get("session")
        scoped = [e for e in entries if e.get("session") == session_id]
        report["compile_tax"] = _aggregate_compile_ledger(scoped or entries)
        if not scoped and entries:
            report["compile_tax"]["all_sessions"] = True
        # the prewarm slice of the tax: entries a prewarm paid
        # (phase="prewarm") before the first step
        prewarmed = [e for e in (scoped or entries) if e.get("phase") == "prewarm"]
        if prewarmed:
            report["prewarm"] = {
                "programs": len({e.get("program") for e in prewarmed}),
                "seconds": round(sum(e.get("total_s") or 0.0 for e in prewarmed), 3),
                "cache_hits": sum(1 for e in prewarmed if (e.get("persistent_cache") or {}).get("hit")),
                "store_hits": sum(1 for e in prewarmed if (e.get("executable_store") or {}).get("hit")),
            }

    # host-phase coverage vs the SAME session's epoch wall-clock (the
    # honesty check)
    train_wall_s = sum(float(e.get("train_wall_s") or 0.0) for e in epochs)
    loop_sum_s = sum(
        float(phases.get(p, {}).get("sum_ms") or 0.0) / 1e3
        for p in TRAIN_LOOP_PHASES
    )
    report["train_wall_s"] = round(train_wall_s, 3)
    report["train_phase_sum_s"] = round(loop_sum_s, 3)
    report["phase_coverage"] = (
        round(loop_sum_s / train_wall_s, 3) if train_wall_s > 0 else None
    )

    # events.jsonl: counts by name + the resilience-notable subset
    events_path = os.path.join(logs_dir, "events.jsonl")
    event_records: List[Dict[str, Any]] = []
    if os.path.exists(events_path):
        event_records, torn_events = _read_jsonl(events_path)
        if torn_events:
            report["torn_event_lines"] = torn_events
        counts: Dict[str, int] = {}
        for record in event_records:
            name = record.get("event", "epoch_stats")
            counts[name] = counts.get(name, 0) + 1
        report["events"] = counts
        notable = {
            k: v
            for k, v in counts.items()
            if k in ("nan_step_skipped", "nan_rollback", "nan_abort",
                     "preempted", "wedged", "wedge_checkpoint",
                     "degraded_mesh", "early_abort", "donation_refused",
                     "replica_death", "backend_out", "backend_in",
                     "drain_begin", "drain_complete",
                     "sessions_spilled", "sessions_rehydrated",
                     "refine_rollback", "session_quarantined")
        }
        if notable:
            report["notable_events"] = notable
        # serving/fleet lifecycle timeline: replica deaths,
        # gateway membership flaps, drain milestones, session
        # spill/rehydrate — chronological, so "when did r1 die and who
        # absorbed it" is answerable from the run dir after the fact
        serving_events = [
            {
                k: rec.get(k)
                for k in ("ts", "event", "replica", "backend", "reason",
                          "status", "routable", "count", "deadline_exceeded",
                          "spilled_sessions", "loaded", "stale", "corrupt",
                          "in_count", "tenant", "bytes")
                if rec.get(k) is not None
            }
            for rec in event_records
            if rec.get("event")
            in ("replica_death", "backend_out", "backend_in", "drain_begin",
                "drain_complete", "sessions_spilled", "sessions_rehydrated",
                "tenant_evicted")
        ]
        if serving_events:
            report["serving_events"] = serving_events
        # per-session refinement lifecycle
        refinement = _refinement_from_events(event_records)
        if refinement is not None:
            report["refinement"] = refinement
    # padding-waste accounting (ROADMAP 4d): the access log records every
    # request's true vs bucketed sample count — aggregate the wasted-FLOPs
    # fraction per (verb, bucket) so bucket-edge tuning has a number
    access_path = os.path.join(logs_dir, "access.jsonl")
    if os.path.exists(access_path):
        access_records, torn_access = _read_jsonl(access_path)
        if torn_access:
            report["torn_access_lines"] = torn_access
        padding = _padding_from_access(access_records)
        if padding is not None:
            report["padding"] = padding
        strategies = _strategies_from_access(access_records)
        if strategies is not None:
            report["strategies"] = strategies
        tenants = _tenants_from_access(access_records, event_records)
        if tenants is not None:
            report["tenants"] = tenants

    # the scaling table also replays off the run's own events.jsonl when a
    # supervisor shared it (component == "supervisor" rows)
    scaling = _scaling_from_events(fleet_records or event_records)
    if scaling is not None:
        report["scaling"] = scaling

    breakdown = _device_breakdown(trace_dir or _profile_dir_from_config(run_dir))
    if breakdown is not None:
        report["device_breakdown"] = breakdown

    trace_path = os.path.join(logs_dir, "trace.json")
    report["trace_path"] = trace_path if os.path.exists(trace_path) else None
    return report


def _padding_from_access(records: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Per-(verb, bucket) padding waste off access-log lines. FLOPs scale
    with the PADDED sample count, so a bucket's wasted-FLOPs fraction is
    ``1 - true_samples / padded_samples`` over the requests it served;
    lines without both shape fields (cache hits, HTTP-layer failures, older
    logs) are skipped."""
    per_bucket: Dict[str, Dict[str, Any]] = {}
    total_true = total_padded = 0
    for r in records:
        bucket, true = r.get("bucket"), r.get("true_size")
        if not isinstance(bucket, int) or not isinstance(true, int) or bucket <= 0:
            continue
        key = f"{r.get('verb')}/{bucket}"
        row = per_bucket.setdefault(
            key, {"requests": 0, "true_samples": 0, "padded_samples": 0}
        )
        row["requests"] += 1
        row["true_samples"] += true
        row["padded_samples"] += bucket
        total_true += true
        total_padded += bucket
    if not per_bucket or not total_padded:
        return None
    for row in per_bucket.values():
        row["waste_frac"] = round(
            1.0 - row["true_samples"] / row["padded_samples"], 4
        )
    return {
        "by_bucket": dict(sorted(per_bucket.items())),
        "padding_waste_frac": round(1.0 - total_true / total_padded, 4),
    }


def _strategies_from_access(
    records: List[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """Per-strategy latency/outcome table off access-log lines — the
    post-hoc answer to "which adaptation tier ate the fleet, and at what
    latency". Lines without a strategy field (HTTP-layer failures, synthetic
    replica_death lines, pre-registry logs) are skipped; latency percentiles
    use each line's ``total_ms`` where present."""
    per: Dict[str, Dict[str, Any]] = {}
    latencies: Dict[str, List[float]] = {}
    for r in records:
        strategy = r.get("strategy")
        if not isinstance(strategy, str):
            continue
        row = per.setdefault(
            strategy, {"requests": 0, "by_verb": {}, "by_outcome": {}}
        )
        row["requests"] += 1
        verb, outcome = str(r.get("verb")), str(r.get("outcome"))
        row["by_verb"][verb] = row["by_verb"].get(verb, 0) + 1
        row["by_outcome"][outcome] = row["by_outcome"].get(outcome, 0) + 1
        total_ms = r.get("total_ms")
        if isinstance(total_ms, (int, float)):
            latencies.setdefault(strategy, []).append(float(total_ms))
    if not per:
        return None
    for strategy, vals in latencies.items():
        vals.sort()
        per[strategy]["p50_ms"] = round(vals[len(vals) // 2], 3)
        per[strategy]["p95_ms"] = round(vals[min(len(vals) - 1, int(len(vals) * 0.95))], 3)
    return dict(sorted(per.items()))


def _refinement_from_events(
    events: List[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """Per-session refinement table replayed off events.jsonl:
    commits, rollbacks, quarantines and re-adapts per session, plus the
    committed-score trend (first -> last -> best) so "is this long-lived
    session actually getting better, or riding its rollback guard" is
    answerable from the run dir. Sessions are keyed by their short id;
    returns None for runs with no refinement traffic at all."""
    per: Dict[str, Dict[str, Any]] = {}

    def _row(session: str, rec: Dict[str, Any]) -> Dict[str, Any]:
        row = per.setdefault(
            session,
            {"refines": 0, "rollbacks": 0, "quarantines": 0, "readapts": 0,
             "scores": [], "strategy": rec.get("strategy")},
        )
        if isinstance(rec.get("tenant"), str):
            row["tenant"] = rec["tenant"]
        return row

    saw_refinement = False
    for rec in events:
        session = rec.get("session")
        if not isinstance(session, str):
            continue
        event = rec.get("event")
        if event == "refine_commit":
            saw_refinement = True
            row = _row(session, rec)
            row["refines"] += 1
            if isinstance(rec.get("score"), (int, float)):
                row["scores"].append(float(rec["score"]))
        elif event == "refine_rollback":
            saw_refinement = True
            row = _row(session, rec)
            row["rollbacks"] += 1
            row["last_streak"] = rec.get("streak")
        elif event == "session_quarantined":
            saw_refinement = True
            _row(session, rec)["quarantines"] += 1
        elif event == "session_readapted":
            # only interesting for sessions that refined: a plain cache
            # miss on a refine-free session is not refinement traffic
            _row(session, rec)["readapts"] += 1
    if not saw_refinement:
        return None
    table: Dict[str, Dict[str, Any]] = {}
    for session, row in sorted(per.items()):
        if not (row["refines"] or row["rollbacks"] or row["quarantines"]):
            continue
        scores = row.pop("scores")
        if scores:
            row["first_score"] = round(scores[0], 4)
            row["last_score"] = round(scores[-1], 4)
            row["best_score"] = round(min(scores), 4)
        table[session[:12]] = row
    return table or None


#: supervisor event names that ARE scaling decisions (serving/autoscaler.py
#: _event); health-gate chatter (adopt, adopt_found_dead) stays out
_SCALING_EVENTS = (
    "supervisor_start", "scale_up", "scale_down", "backend_died",
    "spawn_crash", "quarantine", "retune", "adopt_rollforward",
    "supervisor_stop",
)


def _scaling_from_events(
    events: List[Dict[str, Any]],
) -> Optional[List[Dict[str, Any]]]:
    """Chronological scaling-decision table replayed off a fleet
    supervisor's events.jsonl: each decision with the signal values that
    triggered it, its outcome, and how long it took to settle — "why did
    the fleet grow at 14:02, and how fast" is answerable after the fact.
    Returns None when the stream holds no supervisor records at all."""
    rows: List[Dict[str, Any]] = []
    for rec in events:
        if rec.get("component") != "supervisor":
            continue
        if rec.get("event") not in _SCALING_EVENTS:
            continue
        row = {
            k: rec.get(k)
            for k in ("ts", "event", "slot", "reason", "outcome", "settle_s",
                      "drain", "drain_rc", "backoff_s", "crashes", "pid",
                      "mode", "target", "adopted", "rolled_forward",
                      "spilled_sessions", "overrides", "improvement",
                      "waste_frac_before", "waste_frac_after", "ticks")
            if rec.get(k) is not None
        }
        signals = rec.get("signals")
        if isinstance(signals, dict) and signals:
            row["signals"] = signals
        rows.append(row)
    return rows or None


def _tenants_from_access(
    records: List[Dict[str, Any]],
    events: List[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """Per-tenant latency/outcome/resident-bytes table. Request rows come
    off access-log lines (lines without a tenant field — single-tenant
    deployments, HTTP-layer failures — count under ``default``); paging
    rows replay the pager's ``tenant_paged_in``/``tenant_evicted`` events
    so end-of-run master resident bytes are answerable from the run dir.
    Returns None for runs with no tenant traffic and no paging at all."""
    per: Dict[str, Dict[str, Any]] = {}
    latencies: Dict[str, List[float]] = {}
    saw_tenant_field = False

    def _row(tenant: str) -> Dict[str, Any]:
        return per.setdefault(
            tenant,
            {"requests": 0, "by_verb": {}, "by_outcome": {},
             "page_ins": 0, "evictions": 0, "resident_bytes": 0},
        )

    for r in records:
        if not isinstance(r.get("verb"), str):
            continue
        tenant = r.get("tenant")
        if isinstance(tenant, str):
            saw_tenant_field = True
        else:
            tenant = "default"
        row = _row(tenant)
        row["requests"] += 1
        verb, outcome = str(r.get("verb")), str(r.get("outcome"))
        row["by_verb"][verb] = row["by_verb"].get(verb, 0) + 1
        row["by_outcome"][outcome] = row["by_outcome"].get(outcome, 0) + 1
        total_ms = r.get("total_ms")
        if isinstance(total_ms, (int, float)):
            latencies.setdefault(tenant, []).append(float(total_ms))
    saw_paging = False
    for e in events:
        tenant, nbytes = e.get("tenant"), e.get("bytes")
        if not isinstance(tenant, str) or not isinstance(nbytes, int):
            continue
        if e.get("event") == "tenant_paged_in":
            saw_paging = True
            row = _row(tenant)
            row["page_ins"] += 1
            row["resident_bytes"] += nbytes
        elif e.get("event") == "tenant_evicted":
            saw_paging = True
            row = _row(tenant)
            row["evictions"] += 1
            row["resident_bytes"] = max(0, row["resident_bytes"] - nbytes)
    if not saw_tenant_field and not saw_paging:
        return None
    for tenant, vals in latencies.items():
        vals.sort()
        per[tenant]["p50_ms"] = round(vals[len(vals) // 2], 3)
        per[tenant]["p95_ms"] = round(
            vals[min(len(vals) - 1, int(len(vals) * 0.95))], 3
        )
    return dict(sorted(per.items()))


def oneline(report: Dict[str, Any]) -> str:
    """One compact JSON line per run for sweep logs."""
    phases = report.get("phases", {})
    compile_tax = report.get("compile_tax") or {}
    hbm = report.get("hbm") or {}
    slim = {
        "report": "obs",
        "run": report.get("run"),
        "error": report.get("error"),
        "epochs": report.get("epochs"),
        "episodes_per_s": report.get("episodes_per_s"),
        "mfu": report.get("mfu"),
        "cold_start_s": report.get("cold_start_s"),
        "prewarm_s": (report.get("prewarm") or {}).get("seconds"),
        "compile_tax_s": compile_tax.get("total_s"),
        "peak_program_bytes": compile_tax.get("peak_program_bytes"),
        "peak_hbm_gib": hbm.get("peak_gib"),
        "padding_waste": (report.get("padding") or {}).get("padding_waste_frac"),
        "phase_coverage": report.get("phase_coverage"),
        "phase_p50_ms": {k: v.get("p50_ms") for k, v in phases.items()},
        "notable_events": report.get("notable_events"),
    }
    return json.dumps({k: v for k, v in slim.items() if v is not None})


def _slim_run_row(report: Dict[str, Any], run_dir: str) -> Dict[str, Any]:
    """One fleet-table row: the oneline fields + the fleet scheduler's
    per-cell record (rc/restarts) when the run was fleet-driven."""
    row = json.loads(oneline(report))
    cell_path = os.path.join(run_dir, "fleet_cell.json")
    if os.path.exists(cell_path):
        try:
            with open(cell_path) as f:
                cell = json.load(f)
            row.update(
                {
                    "status": cell.get("status"),
                    "rcs": cell.get("rcs"),
                    "restarts": cell.get("restarts"),
                    "attempts": cell.get("attempts"),
                    "seed": cell.get("seed"),
                }
            )
        except (OSError, json.JSONDecodeError) as exc:
            row["fleet_cell_error"] = repr(exc)
    return row


def build_fleet_report(exps_root: str) -> Dict[str, Any]:
    """Aggregate every run dir under ``exps_root`` through the per-run
    ``build_report`` path. A directory counts as a run when it has a
    ``logs/`` subdirectory; runs predating the observability subsystem
    degrade to their error row rather than being skipped silently."""
    rows: List[Dict[str, Any]] = []
    for name in sorted(os.listdir(exps_root)):
        run_dir = os.path.join(exps_root, name)
        if not os.path.isdir(os.path.join(run_dir, "logs")):
            continue
        rows.append(_slim_run_row(build_report(run_dir), run_dir))
    report: Dict[str, Any] = {
        "report": "fleet_obs",
        "exps_root": exps_root,
        "runs": rows,
        "n_runs": len(rows),
    }
    fleet_path = os.path.join(exps_root, "fleet_report.json")
    if os.path.exists(fleet_path):
        try:
            with open(fleet_path) as f:
                fleet = json.load(f)
            report["fleet"] = {
                k: fleet.get(k)
                for k in ("spec", "done", "diverged", "failed", "skipped", "ok")
            }
        except (OSError, json.JSONDecodeError) as exc:
            report["fleet_report_error"] = repr(exc)
    return report


def render_fleet_human(report: Dict[str, Any]) -> str:
    lines = [f"== fleet report: {report['exps_root']} ({report['n_runs']} runs) =="]
    if report.get("fleet"):
        f = report["fleet"]
        lines.append(
            f"scheduler: spec={f.get('spec')} done={f.get('done')} "
            f"diverged={f.get('diverged')} failed={f.get('failed')} "
            f"skipped={f.get('skipped')} ok={f.get('ok')}"
        )
    lines.append(
        f"{'run':<34} {'status':<9} {'rcs':<12} {'rst':>3} {'epochs':>6} "
        f"{'eps/s':>8} {'cov':>5}  notable"
    )
    for row in report["runs"]:
        notable = row.get("notable_events") or {}
        rcs = ",".join(str(r) for r in (row.get("rcs") or [])) or "-"
        lines.append(
            f"{str(row.get('run'))[:34]:<34} "
            f"{str(row.get('status') or ('err' if row.get('error') else '-')):<9} "
            f"{rcs:<12} {str(row.get('restarts', '-')):>3} "
            f"{str(row.get('epochs', '-')):>6} "
            f"{str(row.get('episodes_per_s', '-')):>8} "
            f"{str(row.get('phase_coverage', '-')):>5}  "
            + (" ".join(f"{k}={v}" for k, v in sorted(notable.items())) or "-")
        )
    return "\n".join(lines)


def _render_scaling(report: Dict[str, Any], lines: List[str]) -> None:
    scaling = report.get("scaling")
    if not scaling:
        return
    lines.append(
        "-- fleet scaling decisions (supervisor events.jsonl, "
        "chronological) --"
    )
    for rec in scaling:
        ts = rec.get("ts")
        stamp = f"{ts:.3f}" if isinstance(ts, (int, float)) else "-"
        signals = rec.get("signals") or {}
        sig = " ".join(f"{k}={v}" for k, v in sorted(signals.items()))
        detail = "  ".join(
            f"{k}={v}" for k, v in sorted(rec.items())
            if k not in ("ts", "event", "signals")
        )
        lines.append(
            f"  {stamp}  {rec.get('event'):<18} {detail}"
            + (f"  [{sig}]" if sig else "")
        )


def render_human(report: Dict[str, Any]) -> str:
    lines = [f"== run report: {report.get('run')} =="]
    if report.get("error"):
        lines.append(f"ERROR: {report['error']}")
        # the scaling table survives a telemetry-free dir (fleet mode has
        # no training run behind it)
        _render_scaling(report, lines)
        return "\n".join(lines)
    lines.append(
        f"epochs {report['epochs']}  steps {report['steps']}  "
        f"episodes {report['episodes']}  "
        f"throughput {report['episodes_per_s']} episodes/s  "
        f"elapsed {report['elapsed_s']}s"
    )
    if report.get("sessions", 1) > 1:
        lines.append(
            f"({report['sessions']} process sessions in telemetry.jsonl — "
            f"resumed run; steps/phases below are the last session's "
            f"{report['session_epochs']} epoch(s))"
        )
    phases = report.get("phases", {})
    if phases:
        lines.append("-- step phases (host) --")
        lines.append(
            f"{'phase':<12} {'count':>7} {'p50 ms':>9} {'p95 ms':>9} "
            f"{'max ms':>9} {'sum s':>9}"
        )
        for name in sorted(phases):
            s = phases[name]
            lines.append(
                f"{name:<12} {s['count']:>7} {s['p50_ms']:>9} {s['p95_ms']:>9} "
                f"{s['max_ms']:>9} {round(s['sum_ms'] / 1e3, 2):>9}"
            )
        cov = report.get("phase_coverage")
        lines.append(
            f"train-loop phase sum {report['train_phase_sum_s']}s over "
            f"{report['train_wall_s']}s epoch wall-clock"
            + (f" (coverage {cov})" if cov is not None else "")
        )
        if cov is not None and not 0.9 <= cov <= 1.1:
            lines.append(
                "  NOTE: coverage outside [0.9, 1.1] — phase spans do not "
                "account for the train loop; trust the trace, not this table"
            )
    if report.get("mfu") is not None:
        lines.append(f"live MFU (last snapshot): {report['mfu']}")
    if report.get("cold_start_s") is not None:
        prewarm = report.get("prewarm")
        lines.append(
            f"cold start {report['cold_start_s']}s (init -> first settled step)"
            + (
                f"; prewarm compiled {prewarm['programs']} programs in "
                f"{prewarm['seconds']}s ({prewarm.get('store_hits', 0)} store hits, "
                f"{prewarm['cache_hits']} cache hits)"
                if prewarm
                else ""
            )
        )
    tax = report.get("compile_tax")
    if tax:
        lines.append(
            f"-- compile tax ({tax['entries']} compiles, "
            f"{tax['total_s']}s total: {tax['total_lower_s']}s lower + "
            f"{tax['total_compile_s']}s compile; "
            f"{tax['cache_hits']} persistent-cache hits"
            + (", ALL sessions" if tax.get("all_sessions") else "")
            + ") --"
        )
        lines.append(f"{'program':<28} {'builds':>6} {'lower s':>8} {'compile s':>9} {'hits':>5}  flops")
        for name in sorted(tax["by_program"]):
            p = tax["by_program"][name]
            flops = f"{p['flops']:.3e}" if p.get("flops") else "-"
            lines.append(
                f"{name[:28]:<28} {p['builds']:>6} {p['lower_s']:>8} "
                f"{p['compile_s']:>9} {p['cache_hits']:>5}  {flops}"
            )
        mem_rows = {name: p for name, p in tax["by_program"].items() if p.get("peak_bytes") is not None}
        if mem_rows:
            lines.append(f"-- program memory (peak over programs: {_fmt_mib(tax.get('peak_program_bytes'))} MiB) --")
            lines.append(f"{'program':<28} {'args MiB':>9} {'out MiB':>8} {'temp MiB':>9} {'peak MiB':>9} {'donated':>8}")
            for name in sorted(mem_rows):
                p = mem_rows[name]
                lines.append(
                    f"{name[:28]:<28} {_fmt_mib(p.get('argument_bytes')):>9} "
                    f"{_fmt_mib(p.get('output_bytes')):>8} "
                    f"{_fmt_mib(p.get('temp_bytes')):>9} "
                    f"{_fmt_mib(p.get('peak_bytes')):>9} "
                    f"{_fmt_mib(p.get('donated_bytes')):>8}"
                )
    padding = report.get("padding")
    if padding:
        lines.append(
            f"-- serving padding waste (access.jsonl) -- overall "
            f"{padding['padding_waste_frac']} of padded FLOPs wasted --"
        )
        lines.append(
            f"{'verb/bucket':<20} {'requests':>8} {'true':>8} {'padded':>8} "
            f"{'waste':>7}"
        )
        for name, row in padding["by_bucket"].items():
            lines.append(
                f"{name[:20]:<20} {row['requests']:>8} {row['true_samples']:>8} "
                f"{row['padded_samples']:>8} {row['waste_frac']:>7}"
            )
    strategies = report.get("strategies")
    if strategies:
        lines.append("-- serving strategies (access.jsonl) --")
        lines.append(
            f"{'strategy':<12} {'requests':>8} {'p50_ms':>8} {'p95_ms':>8} "
            f"{'outcomes'}"
        )
        for name, row in strategies.items():
            outcomes = ",".join(
                f"{k}={v}" for k, v in sorted(row["by_outcome"].items())
            )
            lines.append(
                f"{name[:12]:<12} {row['requests']:>8} "
                f"{row.get('p50_ms', '-'):>8} {row.get('p95_ms', '-'):>8} "
                f"{outcomes}"
            )
    tenants = report.get("tenants")
    if tenants:
        lines.append("-- serving tenants (access.jsonl + events.jsonl) --")
        lines.append(
            f"{'tenant':<16} {'requests':>8} {'p50_ms':>8} {'p95_ms':>8} "
            f"{'page_ins':>8} {'evict':>6} {'res_bytes':>10}  {'outcomes'}"
        )
        for name, row in tenants.items():
            outcomes = ",".join(
                f"{k}={v}" for k, v in sorted(row["by_outcome"].items())
            )
            lines.append(
                f"{name[:16]:<16} {row['requests']:>8} "
                f"{row.get('p50_ms', '-'):>8} {row.get('p95_ms', '-'):>8} "
                f"{row['page_ins']:>8} {row['evictions']:>6} "
                f"{row['resident_bytes']:>10}  {outcomes}"
            )
    refinement = report.get("refinement")
    if refinement:
        lines.append("-- session refinement (events.jsonl) --")
        lines.append(
            f"{'session':<14} {'strategy':<10} {'refines':>7} {'rollbk':>6} "
            f"{'quar':>4} {'readapt':>7} {'first':>8} {'last':>8} {'best':>8}"
        )
        for name, row in refinement.items():
            lines.append(
                f"{name:<14} {str(row.get('strategy') or '-')[:10]:<10} "
                f"{row['refines']:>7} {row['rollbacks']:>6} "
                f"{row['quarantines']:>4} {row['readapts']:>7} "
                f"{row.get('first_score', '-'):>8} "
                f"{row.get('last_score', '-'):>8} "
                f"{row.get('best_score', '-'):>8}"
            )
    hbm = report.get("hbm")
    if hbm:
        lines.append(
            f"-- HBM watermark (session) -- peak "
            f"{hbm.get('peak_gib', '-')} GiB, min headroom "
            f"{hbm.get('headroom_frac_min', '-')} "
            f"({hbm['snapshots_with_stats']} sampled snapshots)"
        )
    if report.get("events"):
        lines.append("-- events.jsonl --")
        lines.append(
            "  " + "  ".join(f"{k}={v}" for k, v in sorted(report["events"].items()))
        )
        if report.get("notable_events"):
            lines.append(
                "  notable: "
                + "  ".join(f"{k}={v}" for k, v in sorted(report["notable_events"].items()))
            )
    if report.get("serving_events"):
        lines.append("-- serving/fleet lifecycle (chronological) --")
        for rec in report["serving_events"]:
            ts = rec.get("ts")
            stamp = f"{ts:.3f}" if isinstance(ts, (int, float)) else "-"
            detail = "  ".join(
                f"{k}={v}" for k, v in sorted(rec.items())
                if k not in ("ts", "event")
            )
            lines.append(f"  {stamp}  {rec.get('event'):<20} {detail}")
    _render_scaling(report, lines)
    dev = report.get("device_breakdown")
    if dev and "error" not in dev:
        lines.append("-- device time (torch.profiler trace) --")
        lines.append(
            f"  busy {dev.get('device_busy_ms')}ms: compute {dev.get('compute_frac')} "
            f"dma {dev.get('dma_frac')} other {dev.get('other_frac')}"
        )
    elif dev:
        lines.append(f"-- device time: {dev['error']}")
    providers = report.get("providers") or {}
    if providers:
        lines.append("-- providers (last snapshot) --")
        for name, value in sorted(providers.items()):
            lines.append(f"  {name}: {json.dumps(value)}")
    if report.get("trace_path"):
        lines.append(
            f"Chrome trace: {report['trace_path']} "
            "(open in chrome://tracing or https://ui.perfetto.dev; "
            "or --chrome-trace OUT to copy it)"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "run_dir", nargs="?", help="experiment run directory (exps/<name>)"
    )
    parser.add_argument(
        "--exps-root",
        help="fleet mode: aggregate every run dir under this root into one "
        "table/JSON (joined with fleet_cell.json / fleet_report.json)",
    )
    parser.add_argument("--json", action="store_true", help="full JSON report")
    parser.add_argument(
        "--oneline", action="store_true", help="one compact JSON line (sweep logs)"
    )
    parser.add_argument(
        "--chrome-trace",
        metavar="OUT",
        help="copy the run's exported span trace (logs/trace.json) here",
    )
    parser.add_argument(
        "--trace-dir",
        help="torch.profiler trace dir for the device-time join (default: the run config's profile_dir)",
    )
    parser.add_argument(
        "--fleet-events",
        metavar="PATH",
        help="a fleet supervisor's events.jsonl (scripts/fleet_serve.py "
        "--events): adds the chronological scaling-decision table — works "
        "against a telemetry-free dir too",
    )
    args = parser.parse_args(argv)
    if args.exps_root:
        if not os.path.isdir(args.exps_root):
            print(f"obs_report: no such exps root: {args.exps_root}", file=sys.stderr)
            return _RC_USAGE
        fleet_report = build_fleet_report(args.exps_root)
        if args.json or args.oneline:
            print(
                json.dumps(fleet_report)
                if args.oneline
                else json.dumps(fleet_report, indent=1)
            )
        else:
            print(render_fleet_human(fleet_report))
        return _RC_OK
    if not args.run_dir:
        print("obs_report: need a run dir or --exps-root", file=sys.stderr)
        return _RC_USAGE
    if not os.path.isdir(args.run_dir):
        print(f"obs_report: no such run dir: {args.run_dir}", file=sys.stderr)
        return _RC_USAGE
    report = build_report(args.run_dir, trace_dir=args.trace_dir, fleet_events=args.fleet_events)
    if args.chrome_trace:
        src = report.get("trace_path")
        if src:
            shutil.copyfile(src, args.chrome_trace)
            report["chrome_trace_written"] = args.chrome_trace
        else:
            print(
                "obs_report: no logs/trace.json to export "
                "(observability disabled, or the run died before export)",
                file=sys.stderr,
            )
            return _RC_USAGE
    if args.oneline:
        print(oneline(report))
    elif args.json:
        print(json.dumps(report, indent=1))
    else:
        print(render_human(report))
    return _RC_OK if "error" not in report else _RC_USAGE


if __name__ == "__main__":
    sys.exit(main())
