"""Serving entry point of the port (``scripts/serve.py``'s contract): a
trained run directory as a few-shot adaptation HTTP service.

Usage::

    python -m howtotrainyourmamlpytorch_tpu_torch.serve RUN_DIR \\
        [--checkpoint best|latest|N] [--host H] [--port P] [--replicas N] \\
        [--device cuda|cpu] [key=value ...]

Loads ``RUN_DIR/config.yaml`` and ``saved_models/train_model_{checkpoint}``
(``best`` falls back to ``latest`` when no best-val model was written),
builds the :class:`serving.AdaptationEngine` on the CUDA card (``--device
cpu`` for the CPU; without a card the server raises rather than falling
back) and serves the JSON API:

    POST /adapt          {"x_support": [...], "y_support": [...]}
                         (+ "refine": true, "session_id": ... to refine)
    POST /predict        {"adaptation_id": "...", "x_query": [...]}
    POST /adapt_predict  support + query in one call
    GET  /healthz        liveness, platform, checkpoint fingerprint
    GET  /metrics        latency percentiles, cache, batchers, kernel launches
                         (?format=prom: OpenMetrics text)

Every POST may carry ``"tenant": "<id>"``: with a ``tenants.yaml`` in
``RUN_DIR`` (or ``serving.tenant_registry=PATH``) the server is multi-tenant
(``serving/registry.py``) and the request runs against that tenant's
checkpoint, paged onto the card under ``serving.tenant_budget_bytes``;
``serving.tenant_max_inflight``, ``tenant_rate_rps`` and
``tenant_max_resident_bytes`` are per-tenant quotas (429 + Retry-After),
and ``/metrics`` gains a ``tenants`` block.

``key=value`` overrides patch the run's config (dotted paths, e.g.
``serving.refine_enabled=true``), before or after the flags. SIGTERM or
SIGINT drains gracefully: in-flight requests finish, cached sessions spill
to ``saved_models/sessions/`` (rehydrated by the next start), and the
process exits with ``serving.server.drain_exit_code`` (0 when clean).

On the card the CLI turns on ``torch.use_deterministic_algorithms`` (warning
where an op has no deterministic implementation) and
``cudnn.deterministic`` before it builds the engine
(``utils/seeding.py::deterministic_algorithms``, not for training):
a session re-adapted in another backend process then gets bit-equal
probabilities, as the JAX package's fleet drills require.
"""

import argparse
import contextlib
import os
import sys


def build_frontend(run_dir: str, checkpoint="best", overrides=None, system=None, replicas=None, device=None):
    """-> a ``ServingFrontend`` over ``run_dir``. ``system`` overrides the
    ``MAMLSystem`` built from the run's config (a checkpoint of a model the
    config alone cannot rebuild); ``replicas`` overrides
    ``serving.replicas``; ``device`` (used only without ``system``)
    defaults to the card."""
    from .config import load_config
    from .serving import ServingFrontend
    from .serving.engine import AdaptationEngine

    cfg = load_config(os.path.join(run_dir, "config.yaml"), overrides or [])
    engine = AdaptationEngine.from_run_dir(run_dir, checkpoint, cfg=cfg, system=system, device=device)
    # access.jsonl lands in the run's logs/ next to telemetry.jsonl
    return ServingFrontend(engine, access_log_dir=os.path.join(run_dir, "logs"), replicas=replicas)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("run_dir", help="experiment directory (holds config.yaml)")
    parser.add_argument("--checkpoint", default="best", help="'best', 'latest', or an epoch number")
    parser.add_argument("--host", default=None, help="bind host (default: config serving.host)")
    parser.add_argument("--port", type=int, default=None, help="bind port (default: config serving.port)")
    parser.add_argument("--replicas", type=int, default=None,
                        help="engine replicas behind the router (default: config serving.replicas)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the engine runs (default: the CUDA card)")
    parser.add_argument("overrides", nargs="*", default=[], help="key=value config overrides")
    args = parser.parse_intermixed_args(argv)

    from .utils.seeding import deterministic_algorithms

    with deterministic_algorithms() if args.device == "cuda" else contextlib.nullcontext():
        return _serve(args)


def _serve(args) -> int:
    from .serving import run_server

    frontend = build_frontend(args.run_dir, args.checkpoint, args.overrides, replicas=args.replicas,
                              device=None if args.device == "cuda" else args.device)
    # the serving prewarm (Config.aot): the frontend is already dispatching
    # the full (bucket x batch-bucket) grid; /healthz answers 503 "warming"
    # until it finishes, and the frontend prints "serving prewarm: warm in
    # <s>s" when it lands
    aot_cfg = frontend.engine.cfg.aot
    if aot_cfg.enabled:
        mode = "background" if aot_cfg.serving_background else "blocking"
        print(f"prewarm: dispatching the planned serving grid ({mode}); /healthz reports 'warming' until warm",
              flush=True)
    serving = frontend.serving
    host = args.host if args.host is not None else serving.host
    port = args.port if args.port is not None else serving.port
    try:
        return run_server(frontend, host, port)
    finally:
        frontend.close()


if __name__ == "__main__":
    sys.exit(main())
