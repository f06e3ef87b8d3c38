"""Open-loop SLO load test against a live ServingFrontend (the JAX
package's ``scripts/loadgen.py``).

Generates a seeded heavy-tailed request schedule over an offered-load
staircase (``observability/slo.py``), drives a ``ServingFrontend`` with it
— mixed adapt/refine/predict (``--refine-frac`` carves guarded session
refinements out of the predict share), bucket-skewed query sizes, launched
at schedule time whether or not earlier requests returned — and prints
exactly ONE JSON SLO-report line on stdout: per-stair p50/p99 vs offered
load, shed rate, 503/504 counts, breaker trips, headline = highest offered
load whose stair met the SLO. Progress goes to stderr.

Usage::

    python -m howtotrainyourmamlpytorch_tpu_torch.loadgen --seed 0 --duration-s 10
    python -m howtotrainyourmamlpytorch_tpu_torch.loadgen --device cpu --tiny
    python -m howtotrainyourmamlpytorch_tpu_torch.loadgen --run-dir exps/<run> --stairs 20,40,80
    python -m howtotrainyourmamlpytorch_tpu_torch.loadgen --url http://127.0.0.1:8200

With no ``--run-dir`` or ``--url`` a synthetic-weight engine is built
in-process (``--tiny``, the default: a 2-stage, 4-filter VGG; ``--full``:
the real Conv-4) on the CUDA card, or on the CPU with ``--device cpu``;
without a card and without ``--device cpu`` it raises, never falling back.
``--url`` drives an already-running gateway or serve process instead. Same
``--seed`` => the JAX package's schedule, bit for bit
(``--print-schedule`` emits it without touching a backend).
"""

import argparse
import dataclasses
import json
import os
import sys
import time


def _parse_stairs(text: str):
    try:
        stairs = [float(x) for x in text.split(",") if x.strip()]
    except ValueError:
        stairs = []
    if not stairs:
        raise SystemExit(f"loadgen: --stairs must be comma-separated req/s, got {text!r}")
    return stairs


def _apply_profile(stairs, text):
    """Shaped-load profiles as DETERMINISTIC staircase transforms (no RNG —
    the seeded schedule draw stays the only source of randomness, so the
    same --seed still means a bit-identical schedule):

      diurnal   trough->peak->trough day curve: the stairs followed by
                their mirror ([4,8,16] -> [4,8,16,8,4])
      surge:K   the stairs, then a K-fold spike of the peak, then recovery
                back at the first stair ([4,8,16] surge:3 -> [4,8,16,48,4])
                — the autoscaler drill shape (scale up, then back down)

    ``--profile`` absent returns the stairs untouched (byte-identical
    schedules; test-pinned)."""
    if text is None:
        return stairs
    if text == "diurnal":
        return stairs + stairs[-2::-1]
    if text.startswith("surge:"):
        try:
            k = float(text.split(":", 1)[1])
        except ValueError:
            k = -1.0
        if k > 0:
            return stairs + [k * stairs[-1], stairs[0]]
    raise SystemExit(
        f"loadgen: --profile must be 'diurnal' or 'surge:K' (K > 0), "
        f"got {text!r}"
    )


def _parse_tenant_skew(text: str, n_tenants: int):
    """'uniform' -> None (equal weights); 'zipf:a' -> 1/rank^a weights.
    Zipf is the realistic multi-tenant shape: a few hot tenants pin
    residency, a long cold tail exercises the pager."""
    if n_tenants <= 0 or text == "uniform":
        return None
    if text.startswith("zipf:"):
        try:
            a = float(text.split(":", 1)[1])
        except ValueError:
            a = -1.0
        if a >= 0:
            return [1.0 / (i + 1) ** a for i in range(n_tenants)]
    raise SystemExit(
        f"loadgen: --tenant-skew must be 'uniform' or 'zipf:a', got {text!r}"
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--duration-s", type=float, default=10.0)
    parser.add_argument(
        "--stairs", default="4,8,16",
        help="comma-separated offered loads (req/s), one staircase stage each",
    )
    parser.add_argument(
        "--profile", default=None,
        help="shaped-load schedule: 'diurnal' (stairs mirrored into a "
        "trough->peak->trough day curve) or 'surge:K' (a K-fold spike of "
        "the peak stair, then recovery) — a deterministic transform of "
        "--stairs, so the same --seed stays bit-identical; absent = the "
        "plain staircase, byte-identical to before",
    )
    parser.add_argument("--adapt-frac", type=float, default=0.25,
                        help="fraction of requests that are (uncached) adapts")
    parser.add_argument(
        "--refine-frac", type=float, default=0.0,
        help="fraction of requests that refine an existing session in place "
        "(POST /adapt with refine:true; carved out of the predict share by "
        "the SAME seeded draw, so 0.0 keeps the schedule bit-identical). "
        "Needs serving.refine_enabled on the target; synthetic-engine runs "
        "enable it automatically.",
    )
    parser.add_argument("--slo-p99-ms", type=float, default=2000.0)
    parser.add_argument("--max-shed-rate", type=float, default=0.05)
    parser.add_argument("--run-dir", default=None,
                        help="serve this experiment's checkpoint instead of synthetic weights")
    parser.add_argument(
        "--url", default=None,
        help="drive an ALREADY-RUNNING gateway or serving frontend at this "
        "base URL (external-process target; scripts/gateway.py of this "
        "package) instead of building an in-process engine — the report "
        "gains per-backend outcome counts from X-Gateway-Backend.",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where an in-process engine runs (default: the CUDA card)")
    parser.add_argument("--n-way", type=int, default=5)
    parser.add_argument("--k-shot", type=int, default=1)
    size = parser.add_mutually_exclusive_group()
    size.add_argument("--tiny", action="store_true",
                      help="tiny 2-stage, 4-filter backbone (the default)")
    size.add_argument("--full", action="store_true",
                      help="full Conv-4 backbone")
    parser.add_argument(
        "--replicas", type=int, default=1,
        help="engine replicas behind the router (0 = one per local device); "
        "the report gains per-replica outcome counts, breaker trips, and "
        "cache hit rates",
    )
    parser.add_argument("--max-workers", type=int, default=16)
    parser.add_argument(
        "--access-log-dir", default="logs",
        help="directory for the structured access log (access.jsonl; one "
        "line per request with trace id + per-hop timing). '' disables. "
        "With --run-dir the run's own logs/ is used instead.",
    )
    parser.add_argument(
        "--worst-k", type=int, default=5,
        help="how many worst request ids each failing stair names",
    )
    parser.add_argument(
        "--print-schedule", action="store_true",
        help="emit the request schedule as one JSON line and exit "
        "(no backend contact; the determinism-check surface)",
    )
    parser.add_argument(
        "--tenants", type=int, default=0,
        help="number of tenants (t0..tN-1) to spread traffic across; 0 = "
        "single-tenant. Without --run-dir/--url, N perturbed tenant "
        "checkpoints are synthesized behind an in-process registry.",
    )
    parser.add_argument(
        "--tenant-skew", default="uniform",
        help="tenant traffic skew: 'uniform' or 'zipf:a' (weight of the "
        "i-th tenant proportional to 1/(i+1)^a; same --seed => "
        "bit-identical tenant assignment)",
    )
    args = parser.parse_args(argv)
    stairs = _apply_profile(_parse_stairs(args.stairs), args.profile)
    if args.tenants < 0:
        raise SystemExit(f"loadgen: --tenants must be >= 0, got {args.tenants}")
    if args.refine_frac < 0 or args.adapt_frac + args.refine_frac > 1:
        raise SystemExit(
            "loadgen: --refine-frac must satisfy 0 <= refine-frac <= "
            f"1 - adapt-frac, got {args.refine_frac} "
            f"(adapt-frac {args.adapt_frac})"
        )
    tenants = [f"t{i}" for i in range(args.tenants)] or None
    tenant_weights = _parse_tenant_skew(args.tenant_skew, args.tenants)
    if args.url and args.run_dir:
        # an external-process target serves ITS OWN checkpoint; a local
        # run dir cannot also be the backend — refuse instead of guessing
        raise SystemExit("loadgen: --url and --run-dir are mutually exclusive")

    from .observability import slo

    # bucket-skewed query sizes: most traffic on the small bucket, a tail on
    # the big ones (matched to the engine's query_buckets below)
    query_sizes, query_weights = (5, 15, 40), (0.7, 0.2, 0.1)
    schedule = slo.generate_schedule(
        args.seed,
        args.duration_s,
        stairs,
        adapt_frac=args.adapt_frac,
        query_sizes=query_sizes,
        query_weights=query_weights,
        tenants=tenants,
        tenant_weights=tenant_weights,
        refine_frac=args.refine_frac,
    )
    if not schedule:
        # fail fast BEFORE the backend spins up: heavy-tailed gaps over a
        # short window can legitimately produce zero arrivals
        raise SystemExit(
            f"loadgen: schedule is empty for seed={args.seed} "
            f"duration={args.duration_s}s stairs={stairs} — lengthen "
            "--duration-s or raise --stairs"
        )
    if args.print_schedule:
        print(
            json.dumps(
                {
                    # drop the all-None tenant column from single-tenant
                    # schedules: pre-tenancy seeds keep byte-identical output
                    "schedule": [
                        {
                            k: v
                            for k, v in dataclasses.asdict(r).items()
                            if k != "tenant" or v is not None
                        }
                        for r in schedule
                    ],
                    "digest": slo.schedule_digest(schedule),
                }
            ),
            flush=True,
        )
        return 0

    from .config import Config, ServingConfig
    from .core.maml import MAMLSystem
    from .data.synthetic import synthetic_batch
    from .models.vgg import build_vgg
    from .serving.engine import AdaptationEngine
    from .serving.server import ServingFrontend

    device = None if args.device == "cuda" else args.device  # None: the card
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731

    if args.url:
        # external-process target: the gateway (or a lone frontend) is
        # already running — same open-loop schedule, driven over the wire
        frontend = slo.HttpFrontend(args.url)
        n_way, k_shot = args.n_way, args.k_shot
        cfg = None
        model_label = f"url:{args.url}"
    elif args.run_dir:
        from .serving.server import frontend_from_run_dir

        # from_run_dir already points access.jsonl at the run's own logs/
        frontend = frontend_from_run_dir(args.run_dir, replicas=args.replicas, device=device)
        cfg = frontend.engine.cfg
        if args.refine_frac and not getattr(
            frontend.engine.serving, "refine_enabled", False
        ):
            # a run dir serves ITS OWN serving config; refuse before the
            # staircase instead of logging a wall of per-request 400s
            raise SystemExit(
                "loadgen: --refine-frac needs serving.refine_enabled in "
                f"the run dir's config ({args.run_dir})"
            )
        n_way = cfg.num_classes_per_set
        k_shot = cfg.num_samples_per_class
        model_label = f"run:{os.path.basename(os.path.normpath(args.run_dir))}"
    else:
        n_way, k_shot = args.n_way, args.k_shot
        img = (28, 28, 1)
        cfg = Config(
            num_classes_per_set=n_way,
            num_samples_per_class=k_shot,
            num_target_samples=max(max(query_sizes) // n_way, 1),
            serving=ServingConfig(
                support_buckets=[n_way * k_shot],
                query_buckets=sorted(query_sizes),
                # refine traffic needs the stateful-session path; off keeps
                # the synthetic engine byte-identical to the legacy config
                refine_enabled=bool(args.refine_frac),
            ),
        )
        stages, filters = (4, 64) if args.full else (2, 4)
        system = MAMLSystem(
            cfg,
            model=build_vgg(img, n_way, num_stages=stages, cnn_num_filters=filters),
            device=device,
        )
        state = system.init_train_state()
        registry = None
        if tenants:
            import tempfile

            from .serving.registry import synthetic_registry

            registry = synthetic_registry(
                tenants, state,
                tempfile.mkdtemp(prefix="loadgen_tenants_"), args.seed,
                feature_shape=system.model.feature_shape,
            )
        frontend = ServingFrontend(
            AdaptationEngine(system, state, registry=registry),
            access_log_dir=args.access_log_dir or None,
            replicas=args.replicas,
        )
        model_label = f"vgg{stages}x{filters}"
    if tenants and (args.run_dir or args.url):
        # the target owns its registry; with --run-dir we can verify the
        # schedule's tenant ids are actually registered before offering load
        reg = getattr(getattr(frontend, "engine", None), "registry", None)
        missing = [t for t in tenants if reg is None or t not in reg]
        if args.run_dir and missing:
            raise SystemExit(
                f"loadgen: --tenants {args.tenants} needs tenants "
                f"{missing} in the run dir's tenant registry (tenants.yaml)"
            )
    img_shape = cfg.image_shape if args.run_dir else (28, 28, 1)
    n_replicas = len(frontend.pool) if getattr(frontend, "pool", None) else None

    max_query = max(max(query_sizes), max(r.n_query for r in schedule))
    targets_per_class = max(max_query // n_way + 1, 1)

    def episode(seed: int):
        b = synthetic_batch(1, n_way, k_shot, targets_per_class, img_shape, seed & 0x7FFFFFFF)
        return b

    def make_support(seed: int):
        b = episode(seed)
        return b["x_support"][0], b["y_support"][0]

    def make_query(seed: int, n_query: int):
        b = episode(seed)
        return b["x_target"][0].reshape((-1,) + tuple(img_shape))[:n_query]

    log(
        f"loadgen: seed={args.seed} duration={args.duration_s}s "
        f"stairs={stairs} req/s, {len(schedule)} requests, model "
        f"{model_label}"
        + (f", {n_replicas} replica(s)" if n_replicas is not None else "")
    )
    run = slo.run_load(
        frontend,
        schedule,
        make_support,
        make_query,
        max_workers=args.max_workers,
        log=log,
    )
    report = slo.slo_report(
        schedule,
        run,
        stairs_rps=stairs,
        duration_s=args.duration_s,
        seed=args.seed,
        slo_p99_ms=args.slo_p99_ms,
        max_shed_rate=args.max_shed_rate,
        metric_suffix=f"_{n_way}w{k_shot}s",
        # the engine's device type; an external target reports its own
        platform=None if args.url else frontend.engine.device.type,
        worst_k=args.worst_k,
        # join the access log back in: each failing stair's worst request
        # ids carry their queue-wait/dispatch/flush-batch breakdown
        access_log_path=(
            frontend.access_log.path if frontend.access_log is not None else None
        ),
        model=model_label,
        adapt_frac=args.adapt_frac,
        replicas=n_replicas,
        schedule_digest=slo.schedule_digest(schedule),
        # shaped-load runs say which shape produced the stairs
        **({"profile": args.profile} if args.profile else {}),
        # external-process target: the gateway's per-backend outcome story
        # (X-Gateway-Backend tallies) — the multi-host twin of per_replica
        **(
            {"target": args.url, "per_backend": frontend.per_backend()}
            if args.url
            else {}
        ),
        # multi-tenant runs carry the paging story next to the latency one
        **(
            {
                "tenants": args.tenants,
                "tenant_skew": args.tenant_skew,
                **(
                    {"pager": frontend.pool.pager_stats()}
                    if getattr(frontend, "pool", None) is not None
                    and frontend.pool.pager_stats() is not None
                    else {}
                ),
            }
            if args.tenants
            else {}
        ),
        # refinement runs carry the guard's story (refines / rollbacks /
        # quarantines off /metrics) next to the latency one; external
        # targets own their /metrics, so only the knob itself is echoed
        **(
            {
                "refine_frac": args.refine_frac,
                **(
                    {
                        "refine": frontend.metrics()
                        .get("sessions", {})
                        .get("refine")
                    }
                    if hasattr(frontend, "metrics")
                    else {}
                ),
            }
            if args.refine_frac
            else {}
        ),
    )
    if frontend.access_log is not None and frontend.hub.enabled:
        # the flow-linked span trace lands NEXT TO access.jsonl, so a worst
        # request id from the report is one grep away from its arc (and
        # trace_merge finds the pair together)
        trace_path = os.path.join(
            os.path.dirname(frontend.access_log.path), "trace.json"
        )
        try:
            frontend.hub.tracer.export(trace_path)
            report["trace_path"] = trace_path
        except OSError as exc:
            log(f"loadgen: trace export failed (continuing): {exc}")
    frontend.close()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.monotonic()
    rc = main()
    print(f"loadgen: done in {time.monotonic() - t0:.1f}s", file=sys.stderr)
    sys.exit(rc)
