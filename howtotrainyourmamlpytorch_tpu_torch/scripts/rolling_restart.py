#!/usr/bin/env python
"""Rolling restart of a serving fleet: drain one backend, respawn it warm,
gate on /healthz, proceed to the next — zero-downtime behind the gateway.

Usage:
    python howtotrainyourmamlpytorch_tpu_torch/scripts/rolling_restart.py \
        --fleet fleet.json [--gateway-url http://127.0.0.1:8100] \
        [--drain-timeout-s 60] [--warm-timeout-s 300] [--settle-s 0]

``fleet.json`` is either the legacy list form, in restart order::

    [{"url": "http://127.0.0.1:8101", "pid": 12345,
      "respawn": ["python", "-m", "howtotrainyourmamlpytorch_tpu_torch.serve",
                  "exps/run", "--port", "8101", "--device", "cuda"]},
     ...]

or the shared version-1 ``fleet_state.json`` schema the autoscaling
supervisor journals (see ``serving/fleetctl.py``) — the same file drives
both tools, so a roll can restart a supervisor-built fleet verbatim.

Per backend the script: (1) sends SIGTERM — the backend flips /healthz to
``draining`` (the gateway stops routing new work to it), completes in-flight
+ queued requests, spills hot sessions to its run dir, and exits (rc 0
clean; rc 77 = drain deadline exceeded — reported, the roll continues);
(2) waits for the pid to disappear; (3) respawns it with ``respawn`` —
the fresh process rehydrates the spilled sessions; (4) polls ``/healthz``
until it answers 200 and, with ``--gateway-url``, until that gateway's
``/metrics`` lists the backend IN again, then moves on. Without that last
wait the next drain can start before the gateway's next health probe has
seen this backend back, and for that moment no backend takes new work.
One JSON line per backend on stdout + a final summary line; rc 0 iff every
backend came back healthy.

Import-light BY CONTRACT (no torch, no numpy, no package import; run by
path) so it runs on a gateway-only host: the drain/spawn/liveness
primitives live in ``serving/fleetctl.py`` (stdlib-only, file-path-loaded
here).
"""

# graftlint: import-light — rolls a fleet from an ops host with no torch (GL213 gates the closure)
import argparse
import importlib.util
import json
import os
import sys
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_by_path(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_fleetctl = _load_by_path(
    "htymp_torch_fleetctl", os.path.join(_PKG, "serving", "fleetctl.py")
)
RC_OK, RC_USAGE = _fleetctl.RC_OK, _fleetctl.RC_USAGE
RC_DRAIN_DEADLINE = _fleetctl.RC_DRAIN_DEADLINE

# re-exported for callers/tests that reach through this module
_healthz = _fleetctl.healthz
_pid_alive = _fleetctl.pid_alive
_wait_pid_gone = _fleetctl.wait_pid_gone
_wait_healthy = _fleetctl.wait_healthy
restart_backend = _fleetctl.restart_backend


def rolling_restart(
    fleet: list,
    drain_timeout_s: float,
    warm_timeout_s: float,
    settle_s: float = 0.0,
    gateway_url=None,
    log=lambda m: print(m, file=sys.stderr, flush=True),
) -> dict:
    rows = []
    for i, entry in enumerate(fleet):
        row = restart_backend(
            entry, drain_timeout_s, warm_timeout_s, gateway_url=gateway_url, log=log
        )
        rows.append(row)
        print(json.dumps({"backend": i, **row}), flush=True)
        if not row["ok"]:
            # stop the roll: taking the NEXT backend down while this one is
            # sick would walk the fleet toward zero availability
            log(f"rolling_restart: {entry['url']} unhealthy — aborting the roll")
            break
        if settle_s > 0 and i + 1 < len(fleet):
            time.sleep(settle_s)
    return {
        "rolling_restart": True,
        "backends": len(fleet),
        "restarted": sum(1 for r in rows if r.get("ok")),
        "ok": len(rows) == len(fleet) and all(r.get("ok") for r in rows),
        "rows": rows,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fleet", required=True,
                        help="JSON file: legacy [{url, pid, respawn}, ...] "
                        "list or version-1 fleet_state.json")
    parser.add_argument("--drain-timeout-s", type=float, default=60.0,
                        help="max wait for a SIGTERM'd backend to exit "
                        "(should exceed serving.drain_deadline_s)")
    parser.add_argument("--warm-timeout-s", type=float, default=300.0,
                        help="max wait for a respawned backend's /healthz 200")
    parser.add_argument("--gateway-url", default=None,
                        help="the gateway in front of the fleet: before the "
                        "next drain, wait until it routes to the respawned "
                        "backend again")
    parser.add_argument("--settle-s", type=float, default=0.0,
                        help="pause between backends (let caches re-warm)")
    args = parser.parse_args(argv)
    try:
        state = _fleetctl.load_fleet_state(args.fleet)
    except (OSError, ValueError) as exc:
        print(f"rolling_restart: bad --fleet file: {exc}", file=sys.stderr)
        return RC_USAGE
    # quarantined slots are radioactive (crash-looped under the supervisor)
    # and empty slots have nothing to restart — roll only live backends
    fleet = [
        s for s in state["slots"]
        if s.get("pid") and s.get("state") not in ("quarantined", "down")
    ]
    if not fleet:
        print("rolling_restart: no restartable backends in --fleet",
              file=sys.stderr)
        return RC_USAGE
    verdict = rolling_restart(
        fleet, args.drain_timeout_s, args.warm_timeout_s, settle_s=args.settle_s,
        gateway_url=args.gateway_url,
    )
    print(json.dumps(verdict), flush=True)
    return RC_OK if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
