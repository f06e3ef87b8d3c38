#!/usr/bin/env python
"""Block until the CUDA card answers, probing with short-lived child
processes: the card gate of the fleet scheduler (``resilience/fleet.py``),
with the rc contract and flags of the JAX package's ``scripts/wait_for_tpu.py``.

Usage::

    python howtotrainyourmamlpytorch_tpu_torch/scripts/wait_for_card.py \\
        [--deadline-s 3600] [--probe-timeout-s 90] [--max-wedged-probes 5] \\
        [--probe-interval-s 30]

Each probe is a separate python child, killed on timeout: through the
CUDA driver API (``libcuda`` by ``ctypes``, no torch import, so a probe of
a card that is up takes well under a second where importing torch takes
seconds) it counts the cards, makes a context on card 0, fills 256 floats
with 2.0 there, synchronises and reads them back (their sum must be 512). A probe that finds no card counts as
down: the gate never falls back to the CPU. Exit codes:

- **0**: the card is up;
- **64** (``TPU_WAIT_DEADLINE``): ``--deadline-s`` elapsed without a
  successful probe (mixed failures);
- **65** (``TPU_WAIT_WEDGED``): ``--max-wedged-probes`` consecutive probes
  hung, the signature of a wedged card: stop at once instead of waiting out
  the deadline.

Import-light (no torch, no package import in this process): it runs exactly
when the card may be down. The probe command is overridable through the
``WAIT_FOR_CARD_PROBE`` variable, the drill seam that lets tests simulate a
card that is up, down or hung.
"""

import argparse
import importlib.util
import os
import subprocess
import sys
import time


def _load_exit_codes():
    """The port's rc registry, loaded by file path; a standalone copy of
    this script falls back to the historical literals."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "exit_codes.py")
    try:
        spec = importlib.util.spec_from_file_location("htymp_torch_exit_codes", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except Exception:
        import types

        return types.SimpleNamespace(OK=0, USAGE=2, TPU_WAIT_DEADLINE=64, TPU_WAIT_WEDGED=65)


exit_codes = _load_exit_codes()

#: the probe: a card must be visible AND run a synchronised op
PROBE_CARD = """
import ctypes, struct
try:
    cu = ctypes.CDLL("libcuda.so.1")
except OSError as exc:
    raise SystemExit(f"no CUDA card visible: {exc}")
def ok(rc, what):
    assert rc == 0, f"{what}: CUDA driver error {rc}"
n, dev, ctx, ptr = ctypes.c_int(), ctypes.c_int(), ctypes.c_void_p(), ctypes.c_uint64()
ok(cu.cuInit(0), "cuInit")
ok(cu.cuDeviceGetCount(ctypes.byref(n)), "cuDeviceGetCount")
assert n.value > 0, "no CUDA card visible"
ok(cu.cuDeviceGet(ctypes.byref(dev), 0), "cuDeviceGet")
name = ctypes.create_string_buffer(256)
ok(cu.cuDeviceGetName(name, 256, dev), "cuDeviceGetName")
ok(cu.cuCtxCreate_v2(ctypes.byref(ctx), 0, dev), "cuCtxCreate")
ok(cu.cuMemAlloc_v2(ctypes.byref(ptr), ctypes.c_size_t(1024)), "cuMemAlloc")
two = struct.unpack("<I", struct.pack("<f", 2.0))[0]
ok(cu.cuMemsetD32_v2(ptr, ctypes.c_uint(two), ctypes.c_size_t(256)), "cuMemsetD32")
ok(cu.cuCtxSynchronize(), "cuCtxSynchronize")
host = (ctypes.c_float * 256)()
ok(cu.cuMemcpyDtoH_v2(host, ptr, ctypes.c_size_t(1024)), "cuMemcpyDtoH")
s = sum(host)
assert s == 512.0, s
cu.cuMemFree_v2(ptr)
cu.cuCtxDestroy_v2(ctx)
print("CARD_OK", n.value, name.value.decode())
"""

RC_UP = exit_codes.OK
RC_DEADLINE = exit_codes.TPU_WAIT_DEADLINE
RC_WEDGED = exit_codes.TPU_WAIT_WEDGED


def wait_for_card(
    deadline_s: float = 3600.0,
    probe_timeout_s: float = 90.0,
    label: str = "wait_for_card",
    log=print,
    max_consecutive_wedged: int = 5,
    probe_interval_s: float = 30.0,
    sleep=time.sleep,
) -> str:
    """Probe until a child process runs an op on the card, the deadline
    passes, or ``max_consecutive_wedged`` probes in a row hang. Returns
    ``"up"`` / ``"deadline"`` / ``"wedged"``; compare against ``"up"``."""
    probe = os.environ.get("WAIT_FOR_CARD_PROBE") or PROBE_CARD
    start = time.time()
    attempt = 0
    wedged_streak = 0
    while time.time() - start < deadline_s:
        attempt += 1
        try:
            out = subprocess.run(
                [sys.executable, "-c", probe], timeout=probe_timeout_s, capture_output=True, text=True
            )
            if "CARD_OK" in out.stdout:
                log(
                    f"{label}: card up after {time.time() - start:.0f}s ({attempt} probes): "
                    f"{out.stdout.strip().splitlines()[-1]}"
                )
                return "up"
            wedged_streak = 0  # it answered (badly): not the hang signature
            diag = f"rc={out.returncode} stderr: ...{out.stderr.strip()[-200:]}"
        except subprocess.TimeoutExpired:
            wedged_streak += 1
            diag = (
                f"hung >{probe_timeout_s:.0f}s (wedged card, "
                f"{wedged_streak}/{max_consecutive_wedged} consecutive)"
            )
        elapsed = time.time() - start
        log(f"{label}: probe {attempt} failed ({elapsed:.0f}s elapsed): {diag}")
        if max_consecutive_wedged and wedged_streak >= max_consecutive_wedged:
            log(f"{label}: {wedged_streak} consecutive probes hung — the card is wedged, giving up early")
            return "wedged"
        sleep(min(probe_interval_s, max(0.0, deadline_s - elapsed)))
    log(f"{label}: deadline exceeded")
    return "deadline"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--deadline-s", type=float, default=3600.0, help="hard wall-clock budget")
    parser.add_argument("--probe-timeout-s", type=float, default=90.0, help="per-probe child timeout")
    parser.add_argument("--max-wedged-probes", type=int, default=5,
                        help="consecutive hung probes before rc=65 (0 disables)")
    parser.add_argument("--probe-interval-s", type=float, default=30.0, help="pause between probes")
    args = parser.parse_args(argv)
    status = wait_for_card(
        args.deadline_s, args.probe_timeout_s, log=lambda m: print(m, flush=True),
        max_consecutive_wedged=args.max_wedged_probes, probe_interval_s=args.probe_interval_s,
    )
    return {"up": RC_UP, "deadline": RC_DEADLINE, "wedged": RC_WEDGED}[status]


if __name__ == "__main__":
    sys.exit(main())
