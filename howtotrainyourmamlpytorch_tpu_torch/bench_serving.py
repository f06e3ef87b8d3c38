#!/usr/bin/env python
"""Serving-path benchmark: adapt latency, cached-predict latency, predict
throughput through the full engine (bucketing + masking + the serving
programs), on the CUDA card (the root ``bench_serving.py`` of the JAX
package, on this one).

Prints ONE JSON line, the JAX script's keys: ``{"metric", "value",
"unit", "vs_baseline"}`` plus diagnostics. The headline is cached-predict
throughput — the steady-state serving number once a client's support set is
adapted and cached (the adapt-once / predict-many workload shape). The
reference has no serving path to baseline against, so ``vs_baseline`` is
null.

Usage::

    python -m howtotrainyourmamlpytorch_tpu_torch.bench_serving                # on the card
    python -m howtotrainyourmamlpytorch_tpu_torch.bench_serving --device cpu --tiny
    python -m howtotrainyourmamlpytorch_tpu_torch.bench_serving --n-way 20 --k-shot 5
    python -m howtotrainyourmamlpytorch_tpu_torch.bench_serving --url http://127.0.0.1:8200

Model/episode defaults are the Omniglot 5-way 1-shot ablation shape with the
full Conv-4 backbone; ``--tiny`` shrinks the model for smoke runs. On the
card ``engine.prewarm()`` captures the serving grid as CUDA graphs, so every
timed flush is a replay. The knobs are the JAX script's environment
variables (``BENCH_PRECISION``, ``BENCH_REMAT``, ``BENCH_STRATEGY``,
``BENCH_TENANTS``, ``BENCH_REFINE``, ``BENCH_AUTOSCALE``, ``BENCH_REPLICAS``,
``BENCH_SLO_DURATION_S``, ``BENCH_SLO_STAIRS``, ``BENCH_SLO_P99_MS``,
``BENCH_GATEWAY``); each bad value exits 2 with a stderr line naming it,
before any device work.
"""

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

# cold_start_s in the JSON line is "process start -> first served request",
# the serving replica's spawn tax
from .bench import _seconds_since_start


def _gateway_bench(args, url: str) -> int:
    """External-process target (``--url`` / ``BENCH_GATEWAY``): drive an
    ALREADY-RUNNING gateway with the open-loop SLO staircase and emit ONE
    JSON line with per-backend outcome counts."""
    from .data.synthetic import synthetic_batch
    from .observability import slo

    img = (28, 28, 1)
    stairs = [
        float(s)
        for s in os.environ.get("BENCH_SLO_STAIRS", "4,8").split(",")
        if s.strip()
    ]
    duration = float(os.environ.get("BENCH_SLO_DURATION_S", "10"))
    schedule = slo.generate_schedule(
        0, duration, stairs,
        adapt_frac=0.25, query_sizes=(args.n_query,), query_weights=(1.0,),
    )
    if not schedule:
        print("bench_serving: empty schedule for the gateway staircase",
              file=sys.stderr)
        return 2

    def episode(seed):
        b = synthetic_batch(
            1, args.n_way, args.k_shot,
            max(args.n_query // args.n_way, 1), img, seed & 0x7FFFFFFF,
        )
        return (
            b["x_support"][0],
            b["y_support"][0],
            b["x_target"][0].reshape((-1,) + img)[: args.n_query],
        )

    frontend = slo.HttpFrontend(url)
    run = slo.run_load(
        frontend,
        schedule,
        lambda seed: episode(seed)[:2],
        lambda seed, n_q: episode(seed)[2][:n_q],
        log=lambda m: print(m, file=sys.stderr, flush=True),
    )
    report = slo.slo_report(
        schedule, run, stairs_rps=stairs, duration_s=duration, seed=0,
        slo_p99_ms=float(os.environ.get("BENCH_SLO_P99_MS", "2000")),
        max_shed_rate=0.05,
        metric_suffix=f"_gateway_{args.n_way}w{args.k_shot}s",
        platform="external",
        target=url,
        per_backend=frontend.per_backend(),
    )
    print(json.dumps(report), flush=True)
    return 0


def _knobs():
    """The environment's knobs, each validated under the rc-2 contract ->
    ``(knobs, None)``, or ``(None, the stderr line)`` for the first bad one."""
    from .config import REMAT_POLICIES, SERVING_STRATEGIES

    autoscale = os.environ.get("BENCH_AUTOSCALE", "")
    if autoscale not in ("", "0", "1"):
        return None, f"bench_serving: bad BENCH_AUTOSCALE {autoscale!r} (want '' / '0' / '1')"
    # BENCH_PRECISION: "" = the recipe (f32 here), "bf16" = the principled
    # policy (ops/precision.py), "f32"/"legacy" explicit
    precision = os.environ.get("BENCH_PRECISION", "")
    if precision not in ("", "legacy", "f32", "bf16"):
        return None, f"bench_serving: bad BENCH_PRECISION {precision!r}"
    # BENCH_REMAT: "" keeps the recipe (the serving default
    # remat_inner_steps=True -> "full" on the adapt programs)
    remat = os.environ.get("BENCH_REMAT", "")
    if remat not in REMAT_POLICIES:
        return None, (f"bench_serving: bad BENCH_REMAT {remat!r} "
                      f"(valid: {sorted(p for p in REMAT_POLICIES if p)})")
    # BENCH_STRATEGY: the FULL menu incl. the forward-only protonet tier;
    # "" = maml++
    strategy = os.environ.get("BENCH_STRATEGY", "")
    if strategy not in ("",) + tuple(SERVING_STRATEGIES):
        return None, (f"bench_serving: bad BENCH_STRATEGY {strategy!r} "
                      f"(valid: {sorted(SERVING_STRATEGIES)})")
    # BENCH_TENANTS: N > 0 spreads the SLO staircase across N synthetic
    # tenants behind an in-process registry (the weight pager in the line)
    tenants_knob = os.environ.get("BENCH_TENANTS", "")
    try:
        n_tenants = int(tenants_knob) if tenants_knob else 0
    except ValueError:
        n_tenants = -1
    if n_tenants < 0:
        return None, f"bench_serving: bad BENCH_TENANTS {tenants_knob!r} (want a non-negative integer)"
    # BENCH_REFINE: N > 0 measures N guarded in-place session refinements
    # through the frontend; 0 keeps refine_enabled off (the planned program
    # set and the prewarm grid untouched)
    refine_knob = os.environ.get("BENCH_REFINE", "")
    try:
        refine_reps = int(refine_knob) if refine_knob else 0
    except ValueError:
        refine_reps = -1
    if refine_reps < 0:
        return None, (f"bench_serving: bad BENCH_REFINE {refine_knob!r} "
                      "(want a non-negative integer: refine reps, 0 = off)")
    return {"autoscale": autoscale == "1", "precision": precision, "remat": remat,
            "strategy": strategy or "maml++", "tenants": n_tenants, "refine_reps": refine_reps}, None


def _autoscale_cycle(device: str) -> dict:
    """BENCH_AUTOSCALE=1: the REAL fleet-surge drill (resilience/campaign.py
    — subprocess gateway + backends on ``device`` + supervisor), its
    control-plane numbers off the supervisor's decision log:
    scale_up_settle_s = spawn -> /healthz past warming -> gateway
    admission, surge_recovery_s = supervisor engaged -> surge capacity
    admitted. Nulls, with the violations on stderr, off a broken cycle."""
    from .resilience import campaign

    out = {"scale_up_settle_s": None, "surge_recovery_s": None}
    work = tempfile.mkdtemp(prefix="bench_autoscale_")
    try:
        template = campaign.make_serving_run_dir(work, "template")
        violations = campaign._run_gateway_episode(
            campaign.Episode(kind="fleet-surge", mode="gateway", subprocess=True),
            work_dir=work, template_run=template, device=device,
        )
        if violations:
            # honest line: no timings rather than timings off a broken cycle
            print(f"bench_serving: autoscale cycle violations: {violations}", file=sys.stderr)
            return out
        # the episode runs in its own chaos_fleet_surge_* subdir of work
        drill_dirs = sorted(d for d in os.listdir(work) if d.startswith("chaos_fleet_surge_"))
        events = []
        with open(os.path.join(work, drill_dirs[-1], "supervisor_events.jsonl")) as f:
            for line in f:
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        start = next(e for e in events if e.get("event") == "supervisor_start")
        up = next(e for e in events if e.get("event") == "scale_up")
        out["scale_up_settle_s"] = up.get("settle_s")
        out["surge_recovery_s"] = round(up["ts"] - start["ts"], 2)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n-way", type=int, default=5)
    parser.add_argument("--k-shot", type=int, default=1)
    parser.add_argument("--n-query", type=int, default=15, help="query count per request")
    parser.add_argument("--adapt-reps", type=int, default=8)
    parser.add_argument("--predict-reps", type=int, default=32)
    parser.add_argument("--batch", type=int, default=8, help="micro-batch size for throughput")
    parser.add_argument("--tiny", action="store_true",
                        help="2-stage 4-filter backbone (CI smoke)")
    parser.add_argument(
        "--url", default=None,
        help="drive an already-running gateway/frontend at this base URL "
        "(BENCH_GATEWAY env is the same knob): SLO staircase only, with "
        "per-backend outcome counts in the JSON line",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the engine runs (default: the CUDA card)")
    args = parser.parse_args(argv)

    # every knob validated BEFORE anything heavy spins up: a typo'd arm
    # exits the clean rc-2 usage contract, never a mid-main traceback
    knobs, bad = _knobs()
    if bad:
        print(bad, file=sys.stderr)
        return 2

    gateway_url = args.url or os.environ.get("BENCH_GATEWAY", "")
    if gateway_url:
        return _gateway_bench(args, gateway_url)

    import torch

    from .config import Config, ServingConfig
    from .core.maml import MAMLSystem, resolve_device
    from .data.synthetic import synthetic_batch
    from .models.vgg import build_vgg
    from .observability import costs as obs_costs
    from .observability.compile_ledger import CompileLedger
    from .serving.engine import AdaptationEngine

    try:
        device = resolve_device(None if args.device == "cuda" else args.device)
    except RuntimeError as exc:
        print(f"bench_serving: {exc}", file=sys.stderr)
        return 2
    on_card = device.type == "cuda"
    strategy, n_tenants, refine_reps = knobs["strategy"], knobs["tenants"], knobs["refine_reps"]

    img = (28, 28, 1)
    support = args.n_way * args.k_shot
    cfg = Config(
        num_classes_per_set=args.n_way,
        num_samples_per_class=args.k_shot,
        num_target_samples=max(args.n_query // args.n_way, 1),
        compute_dtype="bfloat16" if knobs["precision"] == "legacy" else "float32",
        precision={"enabled": knobs["precision"] == "bf16"},
        remat_policy=knobs["remat"],
        serving=ServingConfig(
            support_buckets=[support], query_buckets=[args.n_query],
            max_batch_size=args.batch,
            # the benched strategy is the deployment's (only) configured
            # one: the prewarm grid, planned set, and default all follow
            strategies=[strategy],
            refine_enabled=bool(refine_reps),
        ),
    )
    stages, filters = (2, 4) if args.tiny else (4, 64)
    system = MAMLSystem(
        cfg, model=build_vgg(img, args.n_way, num_stages=stages, cnn_num_filters=filters), device=device
    )
    # collector-only compile ledger (observability/compile_ledger.py): the
    # serving programs' build tax and per-program FLOPs ride the line
    ledger = CompileLedger()
    state = system.init_train_state()
    registry = None
    scratch = []
    if n_tenants:
        from .serving.registry import synthetic_registry

        scratch.append(tempfile.mkdtemp(prefix="bench_tenants_"))
        registry = synthetic_registry(
            [f"t{i}" for i in range(n_tenants)], state, scratch[-1],
            feature_shape=system.model.feature_shape,
        )
    engine = AdaptationEngine(system, state, compile_ledger=ledger, registry=registry)

    def settle():
        if on_card:
            torch.cuda.synchronize(device)

    def episode(seed):
        b = synthetic_batch(1, args.n_way, args.k_shot, cfg.num_target_samples, img, seed)
        return (
            b["x_support"][0],
            b["y_support"][0],
            b["x_target"][0].reshape((-1,) + img)[: args.n_query],
        )

    # --- warm up the programs (excluded from every measurement): the
    # prewarm builds the full planned (bucket x batch-bucket) grid through
    # the ledger — on the card a CUDA graph each — the same pre-clock path a
    # fresh replica runs; then one real adapt/predict round settles the
    # first request.
    prewarm_summary = engine.prewarm()
    x_s, y_s, x_q = episode(0)
    fw = engine.adapt(x_s, y_s)
    engine.predict(fw, x_q)
    cold_start_s = round(_seconds_since_start(), 3)
    engine.adapt_batch([episode(i)[:2] for i in range(args.batch)])
    engine.predict_batch([(fw, x_q)] * args.batch)

    # phase instrumentation (observability/metrics.py): data-wait = request
    # payload assembly, dispatch = the headline predict engine call (host
    # arrays back, settle inside), adapt_dispatch/settle = the adapt launch
    # and its drain — adapt and predict in SEPARATE histograms
    from .observability import MetricsRegistry

    reg = MetricsRegistry()

    # --- adapt latency (uncached: a fresh support set every rep) ---
    adapt_ms = []
    weights = []
    for i in range(args.adapt_reps):
        with reg.timer("phase.data_wait"):
            x_s, y_s, _ = episode(100 + i)
        t0 = time.perf_counter()
        with reg.timer("phase.adapt_dispatch"):
            w = engine.adapt(x_s, y_s)
        with reg.timer("phase.settle"):
            settle()
        adapt_ms.append((time.perf_counter() - t0) * 1e3)
        weights.append(w)

    # --- cached-predict latency (weights already adapted: predict only) ---
    predict_ms = []
    for i in range(args.predict_reps):
        with reg.timer("phase.data_wait"):
            _, _, x_q = episode(200 + i)
        t0 = time.perf_counter()
        with reg.timer("phase.dispatch"):
            engine.predict(weights[i % len(weights)], x_q)
        predict_ms.append((time.perf_counter() - t0) * 1e3)

    # --- predict throughput at the micro-batch size ---
    items = [(weights[i % len(weights)], episode(300 + i)[2]) for i in range(args.batch)]
    reps = max(args.predict_reps // args.batch, 1)
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict_batch(items)
    elapsed = time.perf_counter() - t0
    queries_per_sec = reps * args.batch * args.n_query / elapsed

    result = {
        "metric": f"serving_cached_predict_queries_per_sec_{args.n_way}w{args.k_shot}s_b{args.batch}",
        "value": round(queries_per_sec, 2),
        "unit": "queries/sec",
        "vs_baseline": None,  # reference has no serving path to compare against
        "platform": f"gpu:{torch.cuda.get_device_name(device)}" if on_card else "cpu",
        "adapt_p50_ms": round(float(np.percentile(adapt_ms, 50)), 3),
        "adapt_p95_ms": round(float(np.percentile(adapt_ms, 95)), 3),
        "cached_predict_p50_ms": round(float(np.percentile(predict_ms, 50)), 3),
        "cached_predict_p95_ms": round(float(np.percentile(predict_ms, 95)), 3),
        # the per-strategy latency-ladder fields (one recorded line per
        # BENCH_STRATEGY arm): predict_p50_ms aliases the cached-predict p50
        "strategy": strategy,
        "predict_p50_ms": round(float(np.percentile(predict_ms, 50)), 3),
        "n_way": args.n_way,
        "k_shot": args.k_shot,
        "n_query": args.n_query,
        "micro_batch": args.batch,
        "model": f"vgg{stages}x{filters}",
        # resolved policy name ("f32" | "legacy_bf16" | "bf16_inner")
        "precision": system.precision.name,
        "compiled": engine.compile_counts(),
        "phase_breakdown": {
            name: {"p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"]}
            for name, s in reg.summaries("phase.").items()
        },
    }
    # cost model + build tax: per-query FLOPs of the headline predict
    # program (its flop-counted warmup over its batch x query count) and the
    # ledger totals; mfu null-with-reason off the card
    summary = ledger.summary()
    result["compile_tax_s"] = summary["total_s"]
    # program-memory axes: resolved remat policy + the biggest program's
    # graph-pool bytes and donated bytes off the ledger
    result["remat_policy"] = cfg.resolved_remat_policy
    result["peak_program_bytes"] = summary.get("peak_program_bytes")
    result["donated_bytes"] = summary.get("donated_bytes")
    for key in ("peak_program_bytes", "donated_bytes"):
        if result[key] is None:
            print(f"bench_serving: {key} null: no program of this run has it (no graph off the card; "
                  "serving donates nothing)", file=sys.stderr)
    # process start -> first served request, plus the prewarm breakdown
    result["cold_start_s"] = cold_start_s
    result["prewarm"] = {
        "programs": prewarm_summary["programs"],
        "seconds": prewarm_summary["seconds"],
        "cache_hits": prewarm_summary["cache_hits"],
    }
    # program keys are serve_predict[@strategy]/<query-bucket>/<task-batch>;
    # take the widest-batch priced program (the headline's dispatch shape)
    flops_per_query = None
    best_batch = 0
    for name, p in summary["by_program"].items():
        if not (name.startswith("serve_predict") and p.get("flops")):
            continue
        _, bucket, b = name.split("/")
        if int(b) > best_batch:
            best_batch = int(b)
            flops_per_query = p["flops"] / (int(b) * int(bucket))
    result["predict_flops_per_query"] = flops_per_query

    # --- fleet staircase: sustained RPS within SLO through a replicated
    # frontend (BENCH_REPLICAS engine replicas behind the affinity router,
    # observability/slo.py open-loop schedule). BENCH_SLO_DURATION_S=0
    # skips it; the fields stay in the line either way so captures join.
    n_replicas = int(os.environ.get("BENCH_REPLICAS", "1"))
    slo_duration = float(os.environ.get("BENCH_SLO_DURATION_S", "6"))
    result["sustained_rps"] = None
    from .observability import slo
    from .serving.errors import SessionQuarantinedError
    from .serving.server import ServingFrontend

    # the frontend resolves BENCH_REPLICAS=0 to the actual per-device count
    # — the line carries the real denominator, not the raw env value. Its
    # progress lines go to stderr: stdout carries the one JSON line
    with contextlib.redirect_stdout(sys.stderr):
        frontend = ServingFrontend(engine, replicas=n_replicas)
        try:
            result["replicas"] = len(frontend.pool)
            if slo_duration > 0:
                stairs = [
                    float(s)
                    for s in os.environ.get("BENCH_SLO_STAIRS", "4,8").split(",")
                    if s.strip()
                ]
                schedule = slo.generate_schedule(
                    0, slo_duration, stairs,
                    adapt_frac=0.25, query_sizes=(args.n_query,), query_weights=(1.0,),
                    tenants=[f"t{i}" for i in range(n_tenants)] or None,
                )
                if schedule:
                    run = slo.run_load(
                        frontend,
                        schedule,
                        lambda seed: episode(seed & 0x7FFFFFFF)[:2],
                        lambda seed, n_q: episode(seed & 0x7FFFFFFF)[2][:n_q],
                        log=lambda m: print(m, file=sys.stderr, flush=True),
                    )
                    slo_rep = slo.slo_report(
                        schedule, run, stairs_rps=stairs, duration_s=slo_duration,
                        seed=0, slo_p99_ms=2000.0, max_shed_rate=0.05,
                    )
                    result["sustained_rps"] = slo_rep["value"]
                    result["slo_breaker_trips"] = slo_rep["breaker_trips"]
                    if "per_replica" in slo_rep:
                        result["per_replica"] = slo_rep["per_replica"]
            if result["sustained_rps"] is None:
                print("bench_serving: sustained_rps null: "
                      + ("no stair met the SLO" if slo_duration > 0 else "BENCH_SLO_DURATION_S=0 skips the staircase"),
                      file=sys.stderr)
            # multi-tenant paging story (BENCH_TENANTS arm); the fields stay
            # in the line either way so single- and multi-tenant captures join
            result["tenants"] = n_tenants
            pager_stats = frontend.pool.pager_stats()
            result["page_in_p50_ms"] = (
                pager_stats["page_in_p50_ms"] if pager_stats else None
            )
            result["tenant_evictions"] = (
                pager_stats["evictions"] if pager_stats else None
            )
            # guarded in-place refinement (BENCH_REFINE arm): adapt one
            # session, warm-refine it once (the probe carve + baseline probe
            # score settle outside the clock), then time steady-state
            # refinements of the same support set. Rollbacks ride the
            # frontend's counter; a quarantine exits via explicit re-adapt,
            # timed like any rep.
            if refine_reps:
                x_rs, y_rs, _ = episode(400)
                sid = frontend.adapt(x_rs, y_rs)["adaptation_id"]
                frontend.refine(sid, x_rs, y_rs)
                refine_ms = []
                for _ in range(refine_reps):
                    t0 = time.perf_counter()
                    try:
                        frontend.refine(sid, x_rs, y_rs)
                    except SessionQuarantinedError:
                        sid = frontend.adapt(x_rs, y_rs)["adaptation_id"]
                    refine_ms.append((time.perf_counter() - t0) * 1e3)
                result["refine_reps"] = refine_reps
                result["refine_p50_ms"] = round(float(np.percentile(refine_ms, 50)), 3)
                result["refine_p95_ms"] = round(float(np.percentile(refine_ms, 95)), 3)
                result["rollbacks"] = int(frontend.counters.get("refine_rollbacks"))
        finally:
            frontend.close()
            for path in scratch:
                shutil.rmtree(path, ignore_errors=True)
        # --- autoscale cycle (BENCH_AUTOSCALE=1); the fields stay in the
        # line either way so captures join
        result["scale_up_settle_s"] = None
        result["surge_recovery_s"] = None
        if knobs["autoscale"]:
            result.update(_autoscale_cycle(device.type))
    device_kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    mfu_value, mfu_reason = obs_costs.mfu(flops_per_query, queries_per_sec, device_kind)
    if mfu_reason:
        print(f"bench_serving: mfu unavailable: {mfu_reason}", file=sys.stderr)
    result["mfu"] = mfu_value
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
