#!/usr/bin/env python
"""Throughput benchmark: full MAML++ meta-steps/sec on the flagship config,
on the CUDA card (the root ``bench.py`` of the JAX package, on this one).

Usage::

    python -m howtotrainyourmamlpytorch_tpu_torch.bench                 # on the card
    python -m howtotrainyourmamlpytorch_tpu_torch.bench --device cpu    # CPU shake-out
    BENCH_ALLOW_CPU=1 python -m howtotrainyourmamlpytorch_tpu_torch.bench

Config benched: the reference's default training recipe (``config.yaml``):
Omniglot 20-way 5-shot, VGG Conv-4 backbone, meta-batch 8 tasks, 5 inner
steps, second-order meta-gradients, MSL active, learnable per-tensor lrs —
one full outer update per step (forward + inner rollout + second-order
backward + outer Adam + projection), under the JAX script's recipe: the
legacy bfloat16 per-forward cast (``compute_dtype="bfloat16"``), remat off,
the fused inner update (B1/B2) off.

Baseline: the reference records no throughput numbers. Its published runs
are 150 epochs x 500 iters = 75,000 meta-steps over ~8-40 h of single-GPU
wall-clock => 0.5-2.6 steps/s. The *fastest* plausible reference throughput,
2.6 steps/s, is the conservative baseline; ``vs_baseline`` = ours / 2.6.

Prints ONE JSON line on stdout, the JAX script's keys: ``{"metric",
"value", "unit", "vs_baseline"}`` plus diagnostics (``platform``, ``mfu``,
``breakdown``, ...). Progress goes to stderr, and a null field always has
its reason there. The knobs are the JAX script's environment variables
(``BENCH_PRECISION``, ``BENCH_REMAT``, ``BENCH_STRATEGY``,
``BENCH_MATMUL_PRECISION``, ``BENCH_CONV_VIA_PATCHES``, the iteration
counts ``BENCH_MEASURE_ITERS`` / ``BENCH_PHASE_ITERS`` /
``BENCH_STEPS_PER_DISPATCH`` / ``BENCH_TRACE_ITERS``, ``BENCH_B16``, the
start-up and watchdog limits). ``BENCH_MATMUL_PRECISION`` sets the port's
``matmul_precision`` (``high`` = TF32); ``BENCH_CONV_VIA_PATCHES`` is
reported and changes nothing here (it steers XLA's convolution layout).

Failure modes are bounded: the card is waited for with short-lived child
probes (``scripts/wait_for_card.py``) before this process touches it, a
stage watchdog salvages a measured headline if a device call hangs, and a
SIGTERM does the same. Without a card the CPU runs only when asked
(``--device cpu`` or ``BENCH_ALLOW_CPU=1``); otherwise the script prints
its structured failure line and exits 2.
"""

import argparse
import json
import os
import sys
import threading
import time


# cold-start anchor where /proc cannot be read (see _seconds_since_start)
_PROC_T0 = time.perf_counter()


def _seconds_since_start() -> float:
    """Seconds since this process started, from Linux ``/proc``:
    ``cold_start_s`` in the JSON line is "process start -> first settled
    step", and ``python -m`` imports the package, and torch with it, before
    this module runs. Where ``/proc`` cannot be read, the seconds since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _PROC_T0

try:
    from .exit_codes import USAGE as _RC_USAGE
except Exception:  # the failure path must not grow an import failure mode
    _RC_USAGE = 2

REFERENCE_STEPS_PER_SEC = 2.6  # fastest plausible single-GPU reference (see docstring)


def _precision_overrides(knob: str) -> dict:
    """Config kwargs for the BENCH_PRECISION A/B knob:

    - ``""``/``"legacy"`` (default): the flagship recipe, the legacy
      ``compute_dtype="bfloat16"`` per-forward casts;
    - ``"f32"``: full float32;
    - ``"bf16"``: the principled bf16 inner loop with f32
      meta-accumulation (``Config.precision``, ops/precision.py).
    """
    if knob in ("", "legacy"):
        return {"compute_dtype": "bfloat16"}
    if knob == "f32":
        return {"compute_dtype": "float32"}
    if knob == "bf16":
        return {"compute_dtype": "bfloat16", "precision": {"enabled": True}}
    raise ValueError(
        f"BENCH_PRECISION must be '', 'legacy', 'f32' or 'bf16', got {knob!r}"
    )


#: BENCH_STRATEGY arms (core/strategies.py): the train bench measures the
#: gradient strategies only — "protonet" has no train step (bench_serving
#: measures it). "" keeps the flagship recipe's default exactly.
_STRATEGY_KNOBS = ("", "maml++", "fomaml", "anil")


def _strategy_overrides(knob: str) -> dict:
    """Config kwargs for the BENCH_STRATEGY A/B knob: ``""`` keeps the
    flagship recipe's default strategy (maml++); an explicit name maps onto
    ``Config.strategy``. Validation happens in main() under the rc-2 usage
    contract."""
    if knob in ("", "maml++"):
        return {}
    return {"strategy": knob}


def _remat_overrides(knob: str) -> dict:
    """Config kwargs for the BENCH_REMAT A/B knob: ``""`` keeps the
    flagship recipe (``remat_inner_steps=False``, policy "none"); a policy
    name maps onto ``Config.remat_policy``. Valid names are
    ``config.REMAT_POLICIES``; validation happens at Config construction."""
    if knob == "":
        return {"remat_inner_steps": False}
    return {"remat_inner_steps": False, "remat_policy": knob}


STARTUP_TIMEOUT_S = float(os.environ.get("BENCH_STARTUP_TIMEOUT_S", 90.0))
# A first in-process contact with a wedged card cannot be retried from the
# same process, so the card is waited for with short-lived child probes, up
# to this deadline (overridable for CI).
STARTUP_DEADLINE_S = float(os.environ.get("BENCH_STARTUP_DEADLINE_S", 1800.0))
METRIC = "meta_steps_per_sec_omniglot20w5s_vgg_b8_5steps_2nd_order"

# the CPU is benched only where it is asked for: BENCH_ALLOW_CPU=1 lets a
# run without a card fall back to it, --device cpu selects it
_ALLOW_CPU = os.environ.get("BENCH_ALLOW_CPU") == "1"


def _fail(msg: str, rc: int = None) -> None:
    if rc is None:
        rc = _RC_USAGE
    print(
        json.dumps(
            {
                "metric": METRIC,
                "value": None,
                "unit": "meta-steps/sec/chip",
                "vs_baseline": None,
                "error": msg,
            }
        ),
        flush=True,
    )
    # os._exit: a hung device-contact thread must not keep the process alive
    os._exit(rc)


def _wait_for_backend(deadline_s: float) -> None:
    """Wait for the card to answer before any in-process contact, through
    ``scripts/wait_for_card.py`` (the fleet's card gate). K *consecutive
    hung probes* (the wedged-card signature) emit the structured-failure
    line at once; a mixed-failure deadline falls through and lets the
    in-process contact produce the structured failure."""
    from .scripts.wait_for_card import wait_for_card

    max_wedged = int(os.environ.get("BENCH_MAX_WEDGED_PROBES", "5"))
    status = wait_for_card(
        deadline_s,
        STARTUP_TIMEOUT_S,
        label="bench",
        log=lambda m: print(m, file=sys.stderr, flush=True),
        max_consecutive_wedged=max_wedged,
        probe_interval_s=float(os.environ.get("BENCH_PROBE_INTERVAL_S", "30")),
    )
    if status == "wedged":
        _fail(
            f"card wedged: {max_wedged} consecutive card probes hung "
            f">{STARTUP_TIMEOUT_S:.0f}s each — giving up without an "
            "in-process contact attempt (set BENCH_MAX_WEDGED_PROBES to tune)"
        )


def _contact_device(want_cpu: bool):
    """First device contact -> ``(platform, device_kind, n_devices)``:
    ``("gpu", torch.cuda.get_device_name(0), torch.cuda.device_count())``,
    or ``("cpu", "cpu", 1)`` where the CPU was asked for or no card is
    visible. Bounded by STARTUP_TIMEOUT_S. The child probes run first
    unless the CPU may serve (``--device cpu``, ``BENCH_ALLOW_CPU=1``)."""
    import concurrent.futures

    if want_cpu:
        return "cpu", "cpu", 1
    if not _ALLOW_CPU:
        _wait_for_backend(STARTUP_DEADLINE_S)

    def probe():
        import torch

        if not torch.cuda.is_available():
            return "cpu", "cpu", 1
        torch.cuda.set_device(0)
        torch.zeros(1, device="cuda").item()
        return "gpu", torch.cuda.get_device_name(0), torch.cuda.device_count()

    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(probe)
    try:
        return fut.result(timeout=STARTUP_TIMEOUT_S)
    except concurrent.futures.TimeoutError:
        _fail(
            "card contact did not complete within "
            f"{STARTUP_TIMEOUT_S:.0f}s (after waiting up to "
            f"{STARTUP_DEADLINE_S:.0f}s for a child probe to see the card)"
        )
    except Exception as e:
        _fail(f"card contact failed: {type(e).__name__}: {e}")


def _peak_flops(device_kind: str):
    """The card's peak from ``observability/costs.py``'s table; None for
    unknown kinds (the CPU), and on any import surprise: the peak is a
    diagnostic, never worth the headline."""
    try:
        from .observability.costs import peak_flops_per_sec

        return peak_flops_per_sec(device_kind)
    except Exception:
        return None


class _Watchdog:
    """Guarantee the ONE JSON line reaches stdout even if the card wedges
    mid-run. A wedged device call never returns and is not interruptible
    from Python (it hangs in C with the GIL released), so a timer thread
    watches a per-stage deadline and, when it fires, emits whatever has been
    measured so far via ``os._exit`` — which works from a secondary thread
    while the main thread is hung. If the headline loops already completed,
    the partial report (with ``wedged_at`` set) is a valid capture; before
    that, it degrades to the structured-failure line."""

    def __init__(self, report: dict, enabled: bool = True):
        self.report = report
        self.enabled = enabled
        self._lock = threading.Lock()
        self._done = False
        self._deadline = float("inf")
        self._stage = "init"
        # parse/validate on the main thread: a malformed env value must fail
        # loudly here, not kill the daemon thread and silently remove the
        # wedge protection — and "loudly" must still honor the one-JSON-line
        # contract (a bare raise here would precede the excepthook)
        raw_poll = os.environ.get("BENCH_WATCHDOG_POLL_S", "10")
        try:
            self._poll_s = float(raw_poll)
        except ValueError:
            self._poll_s = -1.0
        if self._poll_s <= 0:
            _fail(f"BENCH_WATCHDOG_POLL_S must be a positive number, got {raw_poll!r}")
        if enabled:
            t = threading.Thread(target=self._watch, daemon=True)
            t.start()

    def enter(self, stage: str, budget_s: float) -> None:
        """Stage deadlines assume card-speed execution; when disabled (the
        CPU: no card to wedge, and legitimately 100x slower) stages are
        tracked for reporting but never expire. The stage and deadline are
        set under the lock that the emitting paths hold."""
        with self._lock:
            self._stage = stage
            if self.enabled:
                self._deadline = time.monotonic() + budget_s
        if self.enabled:
            print(f"bench: stage {stage} (budget {budget_s:.0f}s)",
                  file=sys.stderr, flush=True)

    def update(self, **kw) -> None:
        # all report mutations hold the lock so an emitting thread can never
        # serialize a dict that is changing size under it
        with self._lock:
            self.report.update(kw)

    def _emit_and_exit(self, stage_note: str) -> None:
        """Single-shot partial emission from the watchdog or a signal
        handler. Safe while the main thread is hung in a device call."""
        with self._lock:
            if self._done:
                return
            self._done = True
            rc = 0 if self.report.get("value") is not None else 2
            if rc == 0:
                self.report["wedged_at"] = stage_note
            else:
                self.report["error"] = (
                    f"run interrupted during stage {stage_note!r} before the "
                    "headline measurement completed"
                )
            try:
                payload = json.dumps(self.report)
            except Exception as e:  # never die without the one JSON line
                payload = json.dumps(
                    {"metric": METRIC, "value": None,
                     "unit": "meta-steps/sec/chip", "vs_baseline": None,
                     "error": f"report serialization failed: {e!r}"}
                )
                rc = 2
            # print + exit INSIDE the lock: if this runs on the sigterm
            # emitter thread while the main thread is entering emit_final,
            # releasing the lock first would let emit_final see _done and
            # return printless, main() exit, and interpreter shutdown kill
            # this daemon thread before its print — zero JSON lines on
            # stdout. Nothing else prints under the lock, and os._exit never
            # returns, so holding it here is deadlock-free.
            print(payload, flush=True)
            os._exit(rc)

    def _watch(self) -> None:
        while True:
            time.sleep(self._poll_s)
            if time.monotonic() > self._deadline:
                self._emit_and_exit(self._stage)

    def on_sigterm(self, signum, frame) -> None:
        # An outer `timeout` SIGTERMs us; if the main thread is still alive
        # this salvages whatever was measured (a hung main thread never runs
        # this handler — the stage watchdog covers that). Signal handlers
        # run ON the main thread, which may currently hold self._lock
        # (inside update()/emit_final()) — taking it here would deadlock
        # until the outer SIGKILL. Emit from a fresh thread instead: it
        # blocks only until main releases the lock, then prints and exits.
        threading.Thread(
            target=self._emit_and_exit,
            args=(f"{self._stage} (sigterm)",),
            daemon=True,
        ).start()

    def emit_final(self) -> None:
        with self._lock:
            if self._done:
                return
            self._done = True
            self._deadline = float("inf")
            payload = json.dumps(self.report)
        print(payload, flush=True)


def build_system(cfg, device):
    """The benched system: ``MAMLSystem(cfg)`` on ``device``, its model the
    config's (the Conv-4 VGG)."""
    from .core.maml import MAMLSystem

    return MAMLSystem(cfg, device=device)


def _synthetic_batch(cfg, batch_size: int, device):
    """The JAX script's synthetic batch (seed 0) on ``device``, in the
    loader's dtypes (float32 images, int32 labels)."""
    import torch

    from .data.synthetic import synthetic_batch

    return {
        k: torch.as_tensor(v).to(device)
        for k, v in synthetic_batch(
            batch_size,
            cfg.num_classes_per_set,
            cfg.num_samples_per_class,
            cfg.num_target_samples,
            cfg.image_shape,
            seed=0,
        ).items()
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the benched system runs (default: the CUDA card)")
    args = parser.parse_args(argv)
    # validated BEFORE any device contact: a typo'd arm exits the clean
    # rc-2 usage contract (one structured JSON line), never a traceback
    # minutes into a card wait
    strategy_knob = os.environ.get("BENCH_STRATEGY", "")
    if strategy_knob not in _STRATEGY_KNOBS:
        _fail(
            f"BENCH_STRATEGY must be one of {list(_STRATEGY_KNOBS)} "
            f"('protonet' is forward-only — bench_serving measures it), "
            f"got {strategy_knob!r}"
        )
    platform, device_kind, n_devices = _contact_device(args.device == "cpu")
    print(
        f"bench: platform={platform} device_kind={device_kind!r} n_devices={n_devices}",
        file=sys.stderr,
        flush=True,
    )
    if platform == "cpu" and args.device != "cpu" and not _ALLOW_CPU:
        _fail(
            "no CUDA card is visible; a CPU number is not comparable to the "
            "per-chip baseline — pass --device cpu (or set BENCH_ALLOW_CPU=1) "
            "to bench on the CPU anyway"
        )

    report = {
        "metric": METRIC,
        "value": None,
        "unit": "meta-steps/sec/chip",
        "vs_baseline": None,
        "platform": f"{platform}:{device_kind}",
        # program-variant markers: a capture from an A/B arm must never read
        # as the flagship default-precision number without saying so
        "matmul_precision": os.environ.get("BENCH_MATMUL_PRECISION", "default"),
        "conv_via_patches": os.environ.get("BENCH_CONV_VIA_PATCHES", "0") == "1",
    }
    wd = _Watchdog(report, enabled=platform != "cpu")
    import signal

    signal.signal(signal.SIGTERM, wd.on_sigterm)

    def _excepthook(tp, val, tb):
        # a device call that *raises* instead of hanging must still produce
        # the one JSON line — with the headline if it was already measured,
        # as a structured failure otherwise
        import traceback

        traceback.print_exception(tp, val, tb)
        sys.stderr.flush()
        wd.update(stage_error=f"{tp.__name__}: {val}")
        wd._emit_and_exit(f"{wd._stage} (exception)")

    sys.excepthook = _excepthook
    wd.enter("imports+build", 600)

    import torch

    from .config import Config
    from .observability.compile_ledger import CompileLedger, program_name

    device = torch.device("cuda" if platform == "gpu" else "cpu")

    def settle():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # The JAX script's recipe: the legacy bfloat16 per-forward cast (float32
    # master params, outer updates and losses), remat off. The fused inner
    # update (use_pallas_inner_update, B1/B2) is deliberately NOT in it: the
    # JAX script keeps its kernel out of the flagship recipe, and the port
    # benches the same recipe. BENCH_CONV_VIA_PATCHES is reported and
    # changes nothing here (it steers XLA's convolution layout).
    cfg = Config(
        matmul_precision=os.environ.get("BENCH_MATMUL_PRECISION", "default"),
        conv_via_patches=os.environ.get("BENCH_CONV_VIA_PATCHES", "0") == "1",
        **_precision_overrides(os.environ.get("BENCH_PRECISION", "")),
        **_remat_overrides(os.environ.get("BENCH_REMAT", "")),
        **_strategy_overrides(strategy_knob),
    )
    system = build_system(cfg, device)
    cfg = system.cfg
    # program-variant markers: the resolved precision policy name
    # ("legacy_bf16" | "f32" | "bf16_inner"), the resolved remat policy, and
    # the adaptation strategy
    wd.update(
        precision=system.precision.name,
        remat_policy=cfg.resolved_remat_policy,
        strategy=cfg.strategy,
    )
    # collector-only compile ledger: every program this process builds (the
    # eager step's first dispatch, priced by the flop counter; the K-step
    # CUDA graph's capture) is timed and attributed, so the line's
    # `prewarm` breakdown is a tracked number exactly like the headline
    compile_ledger = CompileLedger()
    system.attach_compile_ledger(compile_ledger)
    state = system.init_train_state()
    batch = _synthetic_batch(cfg, cfg.batch_size, device)

    # warmup / first dispatch. epoch is passed host-side (as the training
    # loop does): reading it from state.step would force a device sync per
    # step
    wd.enter("compile+warmup", float(os.environ.get("BENCH_COMPILE_DEADLINE_S", 1200)))
    t0 = time.perf_counter()
    state, out = system.train_step(state, batch, epoch=0)
    settle()
    print(f"bench: compile+warmup {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    # process start -> first settled step: THE cold-start number
    wd.update(cold_start_s=round(_seconds_since_start(), 3))

    wd.enter("measure", 600)
    # BENCH_MEASURE_ITERS: CI/CPU shake-out knob; the card's headline keeps 30
    n_iters = int(os.environ.get("BENCH_MEASURE_ITERS", "30"))
    start = time.perf_counter()
    for _ in range(n_iters):
        state, out = system.train_step(state, batch, epoch=0)
    settle()
    elapsed = time.perf_counter() - start
    single_steps_per_sec = n_iters / elapsed
    wd.update(
        value=round(single_steps_per_sec, 3),
        vs_baseline=round(single_steps_per_sec / REFERENCE_STEPS_PER_SEC, 3),
        steps_per_dispatch=1,
        steps_per_sec_single_dispatch=round(single_steps_per_sec, 3),
    )
    print(f"bench: single-dispatch {single_steps_per_sec:.3f} steps/s",
          file=sys.stderr, flush=True)

    # --- step-phase breakdown (observability/metrics.py): where host time
    # goes per step, with the runner's one-dispatch lag — dispatch = host
    # launch of the step, settle = the LAGGED fetch of the previous step's
    # loss (the pipeline's real device wait), data-wait ~0 here (the
    # synthetic batch is resident) but reported so the line carries the
    # run telemetry's phase keys. A failure here degrades to
    # phase_breakdown=null, never costs the headline.
    wd.enter("phase-breakdown", 300)
    phase_breakdown = None
    # BENCH_PHASE_ITERS: CI/CPU shake-out knob; the card's capture keeps 12
    n_phase = int(os.environ.get("BENCH_PHASE_ITERS", "12"))
    try:
        from .observability import MetricsRegistry

        reg = MetricsRegistry()
        pending = None
        for _ in range(n_phase):
            with reg.timer("phase.data_wait"):
                step_batch = batch  # resident synthetic batch: no assembly
            with reg.timer("phase.dispatch"):
                state, out = system.train_step(state, step_batch, epoch=0)
            if pending is not None:
                with reg.timer("phase.settle"):
                    float(pending)
            pending = out.loss
        with reg.timer("phase.settle"):
            float(pending)
        phase_breakdown = {
            name: {"p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"]}
            for name, s in reg.summaries("phase.").items()
        }
    except Exception as e:
        print(f"bench: phase breakdown unavailable: {e}", file=sys.stderr)
    wd.update(phase_breakdown=phase_breakdown)

    # Multi-step dispatch (train_steps_per_dispatch=K in production): K outer
    # steps in ONE dispatch — on the card one CUDA graph of the train step
    # replayed K times (core/programs.py), on the CPU K eager steps. Same
    # math (tests/test_torch_multi_dispatch.py); measured on a resident
    # K-stacked batch exactly like the single-dispatch loop above.
    K = int(os.environ.get("BENCH_STEPS_PER_DISPATCH", "10"))
    multi_steps_per_sec = None
    multi_dispatch_error = None
    if K > 1:
        wd.enter("multi-dispatch", 900)
        try:
            stacked = {k: torch.stack([v] * K) for k, v in batch.items()}
            t0 = time.perf_counter()
            state, (chunk_losses, _, _) = system.train_step_multi(state, stacked, epoch=0)
            settle()
            print(
                f"bench: multi-dispatch K={K} compile+warmup {time.perf_counter() - t0:.1f}s",
                file=sys.stderr,
            )
            n_chunks = max(1, n_iters // K)
            start = time.perf_counter()
            for _ in range(n_chunks):
                state, (chunk_losses, _, _) = system.train_step_multi(
                    state, stacked, epoch=0
                )
            settle()
            multi_steps_per_sec = n_chunks * K / (time.perf_counter() - start)
        except Exception as e:
            # degrade to the single-dispatch headline rather than losing the
            # capture to a diagnostic arm — but leave a machine-readable
            # trace so a silent K-regression can't pass as a K=1 run
            multi_dispatch_error = f"{type(e).__name__}: {e}"
            print(
                f"bench: multi-dispatch arm unavailable: {multi_dispatch_error}",
                file=sys.stderr,
            )
    else:
        print(f"bench: steps_per_sec_multi_dispatch null: BENCH_STEPS_PER_DISPATCH={K} runs no "
              "multi-step arm", file=sys.stderr)

    # headline = what the shipped flagship recipe achieves (the runner runs
    # multi-dispatch when train_steps_per_dispatch>1); both modes reported
    if multi_steps_per_sec and multi_steps_per_sec > single_steps_per_sec:
        steps_per_sec, steps_per_dispatch = multi_steps_per_sec, K
    else:
        steps_per_sec, steps_per_dispatch = single_steps_per_sec, 1
    wd.update(
        value=round(steps_per_sec, 3),
        vs_baseline=round(steps_per_sec / REFERENCE_STEPS_PER_SEC, 3),
        steps_per_dispatch=steps_per_dispatch,
        steps_per_sec_multi_dispatch=(
            round(multi_steps_per_sec, 3) if multi_steps_per_sec else None
        ),
        multi_dispatch_error=multi_dispatch_error,
    )
    print(f"bench: headline {steps_per_sec:.3f} steps/s "
          f"(K={steps_per_dispatch})", file=sys.stderr, flush=True)

    # --- FLOPs per meta-step: the flop counter's count of the exact step
    # the timed loop ran (observability/costs.py), taken when the ledger
    # priced the step's first dispatch. Degrades to null-with-stderr-reason,
    # never a crash.
    wd.enter("cost-analysis", 600)
    from .observability import costs as obs_costs

    # same program variant the timed loop selected for epoch=0
    variant = (system.use_second_order(0), system.msl_active(0))
    train_program = program_name((system._kind("train"),) + variant)
    flops_counted = compile_ledger.summary()["by_program"].get(train_program, {}).get("flops")
    if not flops_counted:
        print(f"bench: cost analysis unavailable: the ledger's first dispatch of {train_program} "
              "has no flop count", file=sys.stderr)
    else:
        print(f"bench: bytes_accessed_per_step null: {obs_costs.NO_BYTES_REASON}", file=sys.stderr)
        wd.update(bytes_accessed_per_step=None)
    if flops_counted:
        # provisional MFU goes into the report NOW: a wedge in the trace/b16
        # arms below must not cost the capture its mfu
        mfu0, mfu0_reason = obs_costs.mfu(flops_counted, steps_per_sec, device_kind)
        if mfu0_reason:
            print(f"bench: mfu unavailable: {mfu0_reason}", file=sys.stderr)
        wd.update(
            flops_per_step=flops_counted,
            flops_source="flop_counter",
            peak_flops_per_sec=_peak_flops(device_kind),
            mfu=mfu0,
        )

    # --- device-time breakdown from a short torch.profiler trace
    # (utils/profiling.py reads its Chrome trace). The trace carries no
    # per-op FLOPs: the flop counter's count stays the FLOPs source.
    breakdown = None
    trace_peak = None
    wd.enter("profile-trace", 600)
    try:
        import shutil
        import tempfile

        from torch.profiler import ProfilerActivity, profile

        from .utils.profiling import device_time_breakdown, trace_path

        trace_dir = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            # BENCH_TRACE_ITERS: CI/CPU shake-out knob; the card's capture keeps 5
            n_prof = int(os.environ.get("BENCH_TRACE_ITERS", "5"))
            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                for _ in range(n_prof):
                    state, out = system.train_step(state, batch, epoch=0)
                settle()
                prof_wall = time.perf_counter() - t0
            prof.export_chrome_trace(trace_path(trace_dir, time.strftime("%Y_%m_%d_%H_%M_%S")))
            breakdown = device_time_breakdown(trace_dir)
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        if breakdown is None:
            print("bench: breakdown null: the trace holds no device event", file=sys.stderr)
        else:
            breakdown["wall_ms_per_step"] = round(1e3 * prof_wall / n_prof, 3)
            trace_peak = breakdown.pop("peak_flops_per_sec", None)
            # keep the JSON line short
            breakdown.pop("top_ops", None)
            breakdown.pop("flops_total", None)
            breakdown.pop("model_flops_total", None)
    except Exception as e:
        print(f"bench: profile breakdown unavailable: {e}", file=sys.stderr)
    if breakdown:
        # persist the trace refinement immediately: a wedge in the b16 arm
        # must not discard a completed trace
        _peak = trace_peak or _peak_flops(device_kind)
        wd.update(
            flops_per_step=flops_counted,
            flops_source="flop_counter" if flops_counted else None,
            peak_flops_per_sec=_peak,
            mfu=(round(flops_counted * steps_per_sec / _peak, 5) if flops_counted and _peak else None),
            breakdown=breakdown,
        )

    # Batch-scaling arm: does task throughput scale with a doubled
    # meta-batch? Diagnostic only; the flagship metric stays at the
    # reference's B. Runs AFTER the trace so the profiled flagship step sees
    # production memory conditions, and frees its state before the report.
    b16_steps_per_sec = None
    b16_ratio = None
    B16 = 2 * cfg.batch_size
    if os.environ.get("BENCH_B16", "1") == "1":
        wd.enter("b16-arm", 1800)
        try:
            import dataclasses

            cfg16 = dataclasses.replace(cfg, batch_size=B16)
            system16 = build_system(cfg16, device)
            state16 = system16.init_train_state()
            batch16 = _synthetic_batch(system16.cfg, B16, device)
            t0 = time.perf_counter()
            state16, out16 = system16.train_step(state16, batch16, epoch=0)
            settle()
            print(
                f"bench: B={B16} compile+warmup {time.perf_counter() - t0:.1f}s",
                file=sys.stderr,
            )
            start = time.perf_counter()
            for _ in range(15):
                state16, out16 = system16.train_step(state16, batch16, epoch=0)
            settle()
            b16_steps_per_sec = 15 / (time.perf_counter() - start)
            b16_ratio = (B16 * b16_steps_per_sec) / (
                cfg.batch_size * single_steps_per_sec
            )
            del system16, state16, batch16, out16
            if device.type == "cuda":
                torch.cuda.empty_cache()
        except Exception as e:
            print(f"bench: B={B16} arm unavailable: {e}", file=sys.stderr)
    else:
        print("bench: b16_steps_per_sec null: BENCH_B16 is off", file=sys.stderr)

    # --- MFU = FLOPs/step x steps/s / card peak, the peak from the trace's
    # device name, the table by device kind as fallback
    flops_per_step = flops_counted
    peak = trace_peak or _peak_flops(device_kind)
    mfu, mfu_reason = obs_costs.mfu(
        flops_per_step, steps_per_sec, device_kind, peak=peak
    )
    if mfu_reason:
        # the null-only-with-logged-reason contract: a null mfu in the JSON
        # line always has its reason on stderr
        print(f"bench: mfu unavailable: {mfu_reason}", file=sys.stderr)

    # build-tax breakdown off the ledger (every program the headline system
    # built: the first eager dispatch, the multi-dispatch graph): the
    # cold-start side of the capture, comparable run over run
    ledger_summary = compile_ledger.summary()
    for key in ("peak_program_bytes", "donated_bytes"):
        if ledger_summary.get(key) is None:
            print(f"bench: {key} null: no program of this run has it (an eager step holds no graph pool; "
                  "the recipe donates nothing)", file=sys.stderr)
    wd.update(
        prewarm={
            "programs": ledger_summary["programs"],
            "seconds": ledger_summary["total_s"],
            "cache_hits": ledger_summary["cache_hits"],
        },
        # program-memory axes: the biggest captured program's graph-pool
        # bytes and the donated bytes off the ledger — null where no
        # program has them, like every other cost field
        peak_program_bytes=ledger_summary.get("peak_program_bytes"),
        donated_bytes=ledger_summary.get("donated_bytes"),
    )

    wd.update(
        b16_steps_per_sec=(
            round(b16_steps_per_sec, 3) if b16_steps_per_sec else None
        ),
        b16_tasks_per_sec_ratio=(round(b16_ratio, 3) if b16_ratio else None),
        flops_per_step=flops_per_step,
        flops_source="flop_counter" if flops_per_step else None,
        peak_flops_per_sec=peak,
        mfu=mfu,
        breakdown=breakdown,
    )
    wd.emit_final()


if __name__ == "__main__":
    main()
