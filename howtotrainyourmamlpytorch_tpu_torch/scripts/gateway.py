#!/usr/bin/env python
"""Multi-host serving gateway CLI: a load-balancer process over N serve
backends (serving/gateway.py — live membership by /healthz hysteresis,
rendezvous session affinity, retry-with-exclusion, admission control).

Usage:
    python howtotrainyourmamlpytorch_tpu_torch/scripts/gateway.py \
        --backends http://h1:8100,http://h2:8100 \
        [--host 127.0.0.1] [--port 8200] [--log-dir logs/gateway] \
        [--health-interval-s 1.0] [--fail-threshold 2] [--pass-threshold 1] \
        [--max-inflight 0] [--port-file PATH]

Import-light BY CONTRACT (no torch, no numpy, no package import): a
gateway host needs no accelerator stack, so this script is run by path, not
as ``python -m`` (the package's ``__init__`` imports torch), and
file-path-loads ``serving/gateway.py`` (itself pure stdlib) and
``exit_codes.py``. SIGTERM/SIGINT shut the gateway down cleanly (poller
stopped, access/events logs flushed), rc 0.
"""

# graftlint: import-light — a gateway host runs with no torch (GL213 gates the closure)
import argparse
import importlib.util
import os
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_by_path(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_gateway_mod = _load_by_path(
    "htymp_torch_serving_gateway", os.path.join(_PKG, "serving", "gateway.py")
)

try:
    _exit_codes = _load_by_path(
        "htymp_torch_exit_codes", os.path.join(_PKG, "exit_codes.py")
    )
    _RC_OK, _RC_USAGE = _exit_codes.OK, _exit_codes.USAGE
except Exception:  # standalone copy of this script: the historical literals hold
    _RC_OK, _RC_USAGE = 0, 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--backends", default="",
        help="comma-separated backend base URLs (http://host:port)",
    )
    parser.add_argument(
        "--backend", action="append", default=[],
        help="one backend base URL (repeatable; alternative to --backends)",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8200,
                        help="bind port (0 = ephemeral; see --port-file)")
    parser.add_argument(
        "--port-file", default=None,
        help="write the bound port here after bind (ephemeral-port "
        "discovery for drills/supervisors)",
    )
    parser.add_argument(
        "--log-dir", default=None,
        help="directory for the gateway's access.jsonl + events.jsonl "
        "(membership flaps); '' / absent disables",
    )
    parser.add_argument("--health-interval-s", type=float, default=1.0)
    parser.add_argument(
        "--fail-threshold", type=int, default=2,
        help="consecutive non-routable observations before a backend is OUT",
    )
    parser.add_argument(
        "--pass-threshold", type=int, default=1,
        help="consecutive routable probes before a backend is (back) IN",
    )
    parser.add_argument(
        "--max-inflight", type=int, default=0,
        help="gateway admission control: shed 429 beyond this many "
        "in-flight proxied requests (0 = disabled)",
    )
    parser.add_argument("--probe-timeout-s", type=float, default=3.0)
    parser.add_argument("--request-timeout-s", type=float, default=120.0)
    parser.add_argument("--retry-after-s", type=float, default=1.0)
    args = parser.parse_args(argv)

    urls = [u.strip() for u in args.backends.split(",") if u.strip()]
    urls += [u.strip() for u in args.backend if u.strip()]
    if not urls:
        print("gateway: no backends (--backends or --backend)", file=sys.stderr)
        return _RC_USAGE

    gateway = _gateway_mod.Gateway(
        urls,
        health_interval_s=args.health_interval_s,
        fail_threshold=args.fail_threshold,
        pass_threshold=args.pass_threshold,
        max_inflight=args.max_inflight,
        retry_after_s=args.retry_after_s,
        probe_timeout_s=args.probe_timeout_s,
        request_timeout_s=args.request_timeout_s,
        log_dir=args.log_dir or None,
    )

    def _write_port(host, port):
        if not args.port_file:
            return
        tmp = f"{args.port_file}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(port))
        os.replace(tmp, args.port_file)

    _gateway_mod.run_gateway(gateway, args.host, args.port, on_bound=_write_port)
    return _RC_OK


if __name__ == "__main__":
    sys.exit(main())
