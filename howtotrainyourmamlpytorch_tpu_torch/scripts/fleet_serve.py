#!/usr/bin/env python
"""Self-healing fleet supervisor CLI: traffic-adaptive autoscaling over a
gateway-fronted serving fleet (serving/autoscaler.py).

Usage:
    python howtotrainyourmamlpytorch_tpu_torch/scripts/fleet_serve.py \
        --state fleet_state.json \
        --gateway-url http://127.0.0.1:8100 [--slots slots.json] \
        [--events events.jsonl] [--metrics-port 0] [--port-file PATH] \
        [--access-log logs/access.jsonl --support-buckets '[16]' \
         --query-buckets '[16]'] [--min-backends 1] [--max-backends 4] ...

``slots.json`` pre-provisions the fleet's port slots (the gateway's backend
list is static, so every POSSIBLE backend URL is registered up front and an
un-spawned slot simply stays OUT)::

    [{"url": "http://127.0.0.1:8101", "port": 8101,
      "respawn": ["python", "-m", "howtotrainyourmamlpytorch_tpu_torch.serve",
                  "exps/run", "--port", "8101", "--device", "cuda"],
      "log": "/path/backend0.log", "run_dir": "exps/run", "pid": 12345},
     ...]

``pid`` marks a backend that is already running (the supervisor adopts it);
omit it for an empty slot. On restart with an existing ``--state`` journal
the slots file is ignored — the journal is the source of truth and the
supervisor adopts the live fleet from it (pid/port liveness probe), rolling
any interrupted spawn/drain forward. SIGTERM stops the CONTROL LOOP only:
backends are never killed on supervisor exit (rc 0) — the fleet must not
care that its controller died.

Every decision is appended to ``--events`` (events.jsonl) and the live
controller state is served on ``--metrics-port`` (``/metrics`` +
``/healthz``; ``scripts/obs_top.py --url`` auto-detects the payload).

Import-light BY CONTRACT (no torch, no numpy, no package import, no yaml —
knobs are flags, not config files): run by path, it file-path-loads
``serving/autoscaler.py``, which in turn loads only its stdlib siblings.
Enforced by the same banned-import subprocess probe as the gateway.
"""

# graftlint: import-light — supervises backends from a host with no torch (GL213 gates the closure)
import argparse
import importlib.util
import json
import os
import signal
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_by_path(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_autoscaler = _load_by_path(
    "htymp_torch_autoscaler", os.path.join(_PKG, "serving", "autoscaler.py")
)
RC_OK, RC_USAGE = _autoscaler.RC_OK, _autoscaler.RC_USAGE


def _write_port(path: str, port: int) -> None:
    """Atomic port-file write (tmp + rename): a poller never reads torn."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, path)


def _parse_edges(label: str, blob):
    if blob is None:
        return None
    try:
        edges = json.loads(blob)
        if not isinstance(edges, list) or not all(
            isinstance(e, int) and e > 0 for e in edges
        ):
            raise ValueError("must be a JSON list of positive ints")
        return edges
    except ValueError as exc:
        raise SystemExit(f"fleet_serve: bad {label}: {exc}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--state", required=True,
                        help="fleet_state.json journal path (created on "
                        "first run, adopted on restart)")
    parser.add_argument("--gateway-url", default=None,
                        help="gateway base URL to poll for scale signals")
    parser.add_argument("--slots", default=None,
                        help="JSON file pre-provisioning the port slots "
                        "(required when --state does not exist yet)")
    parser.add_argument("--events", default=None,
                        help="decision log (events.jsonl); defaults to "
                        "<state dir>/events.jsonl")
    parser.add_argument("--metrics-host", default="127.0.0.1")
    parser.add_argument("--metrics-port", type=int, default=0,
                        help="supervisor /metrics + /healthz port (0 = OS-"
                        "assigned; -1 disables the endpoint)")
    parser.add_argument("--port-file", default=None,
                        help="write the bound metrics port here (atomic)")
    parser.add_argument("--access-log", default=None,
                        help="access.jsonl to forecast the traffic mix from "
                        "(enables the predictive retune loop)")
    parser.add_argument("--support-buckets", default=None,
                        help="current support bucket edges, JSON list "
                        "(the forecast baseline)")
    parser.add_argument("--query-buckets", default=None,
                        help="current query bucket edges, JSON list")
    parser.add_argument("--max-ticks", type=int, default=0,
                        help="stop after N control ticks (0 = run forever)")
    # every Policy knob is a flag — single source of truth for defaults
    for knob in sorted(_autoscaler.Policy.DEFAULTS):
        default = _autoscaler.Policy.DEFAULTS[knob]
        parser.add_argument(
            "--" + knob.replace("_", "-"), dest=knob,
            type=type(default), default=default,
            help=f"policy knob (default {default})",
        )
    args = parser.parse_args(argv)

    try:
        policy = _autoscaler.Policy(
            **{k: getattr(args, k) for k in _autoscaler.Policy.DEFAULTS}
        )
    except ValueError as exc:
        print(f"fleet_serve: {exc}", file=sys.stderr)
        return RC_USAGE

    slots = None
    if not os.path.exists(args.state):
        if not args.slots:
            print("fleet_serve: --state does not exist and no --slots "
                  "template given", file=sys.stderr)
            return RC_USAGE
        try:
            with open(args.slots) as f:
                slots = json.load(f)
            if not isinstance(slots, list) or not slots:
                raise ValueError("--slots must be a non-empty JSON list")
        except (OSError, ValueError) as exc:
            print(f"fleet_serve: bad --slots file: {exc}", file=sys.stderr)
            return RC_USAGE

    events_path = args.events or os.path.join(
        os.path.dirname(os.path.abspath(args.state)), "events.jsonl"
    )
    try:
        support = _parse_edges("--support-buckets", args.support_buckets)
        query = _parse_edges("--query-buckets", args.query_buckets)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return RC_USAGE

    supervisor = _autoscaler.Supervisor(
        args.state, policy, args.gateway_url,
        events_path=events_path,
        access_log=args.access_log,
        current_support=support,
        current_query=query,
    )
    # the endpoint comes up BEFORE load_or_init: adopt-on-restart can block
    # in a warm gate for minutes, and observers (port-file pollers, obs_top)
    # must be able to watch the adoption, not wait for it
    server = None
    if args.metrics_port >= 0:
        server, port = _autoscaler.run_supervisor_http(
            supervisor, args.metrics_host, args.metrics_port
        )
        if args.port_file:
            _write_port(args.port_file, port)
        print(f"fleet_serve: metrics on "
              f"http://{args.metrics_host}:{port}/metrics", file=sys.stderr,
              flush=True)
    try:
        mode = supervisor.load_or_init(slots)
    except (OSError, ValueError) as exc:
        print(f"fleet_serve: bad fleet state: {exc}", file=sys.stderr)
        if server is not None:
            server.shutdown()
        return RC_USAGE
    print(f"fleet_serve: {mode}", file=sys.stderr, flush=True)

    def _stop(signum, frame):
        # stop the CONTROL LOOP only — backends keep running; the journal
        # lets the next supervisor adopt them
        supervisor.stop()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        supervisor.run(max_ticks=args.max_ticks)
    finally:
        supervisor._save()
        supervisor._event("supervisor_stop",
                          ticks=supervisor.counters["ticks"])
        if server is not None:
            server.shutdown()
    return RC_OK


if __name__ == "__main__":
    sys.exit(main())
