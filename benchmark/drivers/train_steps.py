"""Traffic driver ``train_steps``: meta-training as the port's runner does
it (``experiment/runner.py``), K outer steps per dispatch
(``train_steps_per_dispatch`` of the configuration: ``train_step_multi``
for K > 1, ``train_step`` for 1), each dispatch's losses fetched to the
host one dispatch later.

Set-up makes the weights (learning rates at the configuration's inner lr)
and a pool of distinct episodes on the card from the seed, builds the
system, and drives it through its first dispatches with the window's own
call on the pool's first rows: as many whole dispatches of K as cover the
configuration's ``reference_steps``. Those steps are what the reference
follows, and the window goes on from that same state over the rest of the
pool (cycled if the window outruns it) for ``--seconds``.

The reference takes each step from the program's state before it (Adam
turns round-off in a near-zero gradient into a full step of either sign,
so two trajectories part after one step). A dispatch of K > 1 steps shows
only its end, so the states inside it come from a pass over the same rows
from the same weights, one step a dispatch, before it: the same captured
step, replayed once a dispatch. Each step's loss, gradient and change are
read from the pass and judged against the reference's step from the
pass's state before it; the compared dispatches' own losses are judged
against the same reference steps (``dispatch_loss_gap``: the window's
call, its rows and the state carried from replay to replay). IEEE float32
convolutions are not bitwise repeatable on the card, and the objective
amplifies that to a few percent within ten steps, so a dispatch's end is
not compared leaf by leaf with the pass's.

The traffic file's parameters: ``pool_bytes`` (the episode pool),
``noise_share`` (of each image, ``harness/program.py::episodes``),
``trace_seconds`` (the traced sub-window's length, ``--trace 1``).
"""

import gc
import math
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from harness import compare, program
from harness import trace as tracing
from harness.runtime import seconds_since_start
from reference import costs as ref_costs
from reference import maml as ref

#: the outer Adam's first moment after one step is (1 - B1) times the
#: gradient it took
ADAM_B1 = 0.9


class _Stepper:
    """The window's call: ``advance(state, lo, hi)`` runs the pool's rows
    ``lo..hi-1`` as one dispatch -> (state, their losses on the card)."""

    def __init__(self, system, data, k: int):
        self.system, self.data, self.k = system, data, k

    def advance(self, state, lo: int, hi: int):
        if self.k > 1:
            state, (losses, _, _) = self.system.train_step_multi(state, program.rows(self.data, lo, hi), epoch=0)
            return state, losses
        losses = []
        for i in range(lo, hi):
            state, out = self.system.train_step(state, program.row(self.data, i), epoch=0)
            losses.append(out.loss)
        return state, torch.stack(losses)


class _Peaks:
    """The allocator's peak over the whole process, across the resets that
    measure a part of it."""

    def __init__(self, device):
        self.on_card, self.seen = device.type == "cuda", 0

    def reset(self) -> int:
        """-> the bytes allocated now; the peak is read from here on."""
        if not self.on_card:
            return 0
        torch.cuda.synchronize()
        self.seen = max(self.seen, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def read(self) -> Optional[int]:
        """-> the peak since the last reset."""
        if not self.on_card:
            return None
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        self.seen = max(self.seen, peak)
        return peak


def _snapshot(state) -> Dict:
    """A copy of the trainables and of the outer Adam state, in the
    reference's layout (the program may update its state in place)."""
    adam = state.opt_state[0]
    flat = lambda tree: {k: v.detach().clone() for k, v in ref.flat(tree).items()}  # noqa: E731
    return {"params": flat(state.params), "lrs": flat(state.inner_hparams["lr"]),
            "mu": {"p": flat(adam.mu["params"]), "a": flat(adam.mu["hparams"]["lr"])},
            "nu": {"p": flat(adam.nu["params"]), "a": flat(adam.nu["hparams"]["lr"])},
            "count": int(adam.count)}


def _first_steps(stepper, state, n: int):
    """The first ``n`` steps, one a dispatch -> (state, their losses, the
    state before and after each)."""
    snaps, losses = [_snapshot(state)], []
    for i in range(n):
        state, loss = stepper.advance(state, i, i + 1)
        losses += loss.tolist()
        snaps.append(_snapshot(state))
    return state, losses, snaps


def _compared_dispatches(stepper, state, n: int):
    """The first ``n`` steps as the window dispatches them, K a dispatch ->
    (state, their losses, ``{steps done: the state at a dispatch's end}``)."""
    losses, ends = [], {}
    for lo in range(0, n, stepper.k):
        state, loss = stepper.advance(state, lo, lo + stepper.k)
        losses += loss.tolist()
        ends[lo + stepper.k] = _snapshot(state)
    return state, losses, ends


def _window(run, stepper, state, first: int, n_rows: int, seconds: float = 0.0, dispatches: int = 0):
    """Dispatches over the pool after its ``first`` rows, until ``seconds``
    have passed (or ``dispatches`` are made), each dispatch's losses read one
    dispatch later -> (state, steps, non-finite losses, elapsed seconds)."""
    k = stepper.k
    chunks = max(1, (n_rows - first) // k)
    pending, steps, bad, c = None, 0, 0, 0
    t0 = time.perf_counter()
    while True:
        lo = first + (c % chunks) * k
        with run.spans.span("bench.dispatch"):
            state, losses = stepper.advance(state, lo, lo + k)
        if pending is not None:
            with run.spans.span("bench.loss_fetch"):
                bad += int((~torch.isfinite(pending)).sum())
        pending, steps, c = losses, steps + k, c + 1
        if (c >= dispatches) if dispatches else (time.perf_counter() - t0 >= seconds):
            break
    with run.spans.span("bench.loss_fetch"):
        bad += int((~torch.isfinite(pending)).sum())
    return state, steps, bad, time.perf_counter() - t0


def _leaves(part_p: Dict, part_a: Dict) -> Dict:
    out = {"params/" + k: v for k, v in part_p.items()}
    out.update({"lrs/" + k: v for k, v in part_a.items()})
    return out


def _program_steps(losses, snaps) -> List[Dict]:
    """Per step: the program's loss, its gradient by leaf (as its Adam took
    it, from the first moments before and after) and the change of every
    trainable, from the states before and after it."""
    out = []
    for i, loss in enumerate(losses):
        before, after = snaps[i], snaps[i + 1]
        mu_after, mu_before = (_leaves(s["mu"]["p"], s["mu"]["a"]) for s in (after, before))
        grad = program.norms({k: (mu_after[k].double() - ADAM_B1 * mu_before[k].double()) / (1.0 - ADAM_B1)
                              for k in mu_after})
        start = _leaves(before["params"], before["lrs"])
        change = program.norms({k: v.double() - start[k].double()
                                for k, v in _leaves(after["params"], after["lrs"]).items()})
        out.append({"loss": loss, "grad": grad, "change": change})
    return out


def _reference_steps(cfgd: Dict, snaps, first_rows, dtype) -> List[Dict]:
    """Per step: the reference's loss, gradient by leaf and change, each
    step taken in ``dtype`` from the program's state before it."""
    ref.strict_float32()
    cast = lambda d: {k: v.to(dtype) for k, v in d.items()}  # noqa: E731
    out = []
    for i in range(len(snaps) - 1):
        before = snaps[i]
        state = {"params": cast(before["params"]), "lrs": cast(before["lrs"]), "count": before["count"],
                 "mu": {p: cast(before["mu"][p]) for p in "pa"}, "nu": {p: cast(before["nu"][p]) for p in "pa"}}
        batch = {k: (v[i].to(dtype) if v.is_floating_point() else v[i]) for k, v in first_rows.items()}
        new, loss, grads = ref.train_step(cfgd, state, batch)
        start = _leaves(state["params"], state["lrs"])
        change = program.norms({k: v - start[k] for k, v in _leaves(new["params"], new["lrs"]).items()})
        out.append({"loss": loss, "grad": program.norms(_leaves(grads["p"], grads["a"])), "change": change})
    return out


def gaps(steps: List[Dict], reference: List[Dict]) -> Dict[str, float]:
    """The numbers that can be compared (the cell's limits name those that
    are): each step's loss gap; each leaf's gradient and change gap
    (``compare.leaf_gaps``; the change over the leaves the reference's
    gradient moves), read by the worst leaf and by the median leaf, each the
    largest over the steps; the median leaf's gaps and the loss gaps also
    as means over the steps, and the median over every step's every leaf."""
    rows = []
    for mine, theirs in zip(steps, reference):
        grad = compare.leaf_gaps(mine["grad"], theirs["grad"])
        change = compare.leaf_gaps(mine["change"], theirs["change"], compare.moved_leaves(theirs["grad"]))
        rows.append({"loss": compare.loss_gap([mine["loss"]], [theirs["loss"]]), "grad": grad, "change": change})
    worst = lambda f: max(f(r) for r in rows)  # noqa: E731
    mean = lambda f: statistics.fmean(f(r) for r in rows)  # noqa: E731
    med = lambda values: values[len(values) // 2]  # noqa: E731
    return {"loss_gap": worst(lambda r: r["loss"]), "loss_gap_mean": mean(lambda r: r["loss"]),
            "first_loss_gap": rows[0]["loss"],
            "grad_gap": worst(lambda r: r["grad"][-1]), "change_gap": worst(lambda r: r["change"][-1]),
            "grad_gap_median_leaf": worst(lambda r: med(r["grad"])),
            "change_gap_median_leaf": worst(lambda r: med(r["change"])),
            "grad_gap_median_leaf_mean": mean(lambda r: med(r["grad"])),
            "change_gap_median_leaf_mean": mean(lambda r: med(r["change"])),
            "grad_gap_pooled_median": statistics.median(g for r in rows for g in r["grad"]),
            "change_gap_pooled_median": statistics.median(c for r in rows for c in r["change"])}


def compared(cfgd: Dict, losses, snaps, first_rows, dtype) -> Dict[str, float]:
    """The program's first steps against the reference's (``gaps``)."""
    return gaps(_program_steps(losses, snaps), _reference_steps(cfgd, snaps, first_rows, dtype))


def dispatch_gaps(losses, reference: List[Dict]) -> Dict[str, float]:
    """The compared dispatches' losses against the reference's steps: the
    largest relative gap and the mean over the steps."""
    each = [compare.loss_gap([mine], [theirs["loss"]]) for mine, theirs in zip(losses, reference)]
    return {"dispatch_loss_gap": max(each), "dispatch_loss_gap_mean": statistics.fmean(each)}


def _state_gap(a: Dict, b: Dict) -> float:
    mine, theirs = (_leaves(s["params"], s["lrs"]) for s in (a, b))
    return max(float((mine[k] - theirs[k]).abs().max()) for k in mine)


def setup(run):
    """The system, its state after the compared dispatches, the pool, and
    what the comparison needs of the first steps."""
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem

    cfgd = run.config["maml"]
    device = run.device
    system = MAMLSystem(program.program_config(cfgd, run.program_overrides), device=device)
    params = ref.init_params(cfgd, program.generator(run.seed, 0, device), device)
    lr = float(cfgd["inner_optim"]["lr"])
    lrs = {k: torch.full((), lr, device=device) for k in params}
    k = int(cfgd.get("train_steps_per_dispatch", 1))
    first = k * math.ceil(int(run.config["reference_steps"]) / k)
    n_rows = first + k * max(1, int(run.traffic["pool_bytes"]) // (k * program.episode_bytes(cfgd)))
    data = program.episodes(cfgd, n_rows, program.generator(run.seed, 1, device), device,
                            float(run.traffic["noise_share"]))
    stepper = _Stepper(system, data, k)
    run.faults.apply(stepper)
    peaks = _Peaks(device)
    held = peaks.reset()
    # the first dispatch builds the step (warm-up and capture): its peak over what is held is the step's memory
    state, pass_losses, snaps = _first_steps(stepper, program.train_state(system, params, lrs), first)
    step_peak = peaks.read()
    # the first step starts from the harness's weights, not from the program's copy of them
    snaps[0]["params"], snaps[0]["lrs"] = params, lrs
    diagnostics = {}
    if getattr(run, "diagnose", False):
        # a second pass from the same weights: how far two passes over the same rows lie apart
        _, again, snaps_again = _first_steps(stepper, program.train_state(system, params, lrs), first)
        diagnostics = {"repeat_loss_gap": compare.loss_gap(again, pass_losses),
                       "repeat_state_gap": _state_gap(snaps_again[-1], snaps[-1])}
        del snaps_again
    if k > 1:
        state, losses, ends = _compared_dispatches(stepper, program.train_state(system, params, lrs), first)
        diagnostics.update({"pass_loss_gap": compare.loss_gap(losses, pass_losses),
                            "pass_state_gap": _state_gap(ends[first], snaps[first])})
    else:
        losses = pass_losses
    first_rows = {key: v[:first].clone() for key, v in data.items()}
    return {"system": system, "state": state, "stepper": stepper, "first": first, "n_rows": n_rows,
            "losses": losses, "pass_losses": pass_losses, "snaps": snaps, "first_rows": first_rows,
            "diagnostics": diagnostics, "peaks": peaks,
            "step_peak_bytes": None if step_peak is None else step_peak - held}


def check(run, built) -> Dict[str, Dict[str, float]]:
    """The numbers compared, beside their limits. Frees the program's state
    first. A calibration with ``run.f32ref`` also reads the reference itself
    in float32 against its own ``reference_dtype``."""
    losses, pass_losses, snaps, first_rows = built["losses"], built["pass_losses"], built["snaps"], built["first_rows"]
    diagnostics = built["diagnostics"]
    built.clear()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    cfgd = run.config["maml"]
    dtype = getattr(torch, run.config.get("reference_dtype", "float32"))
    t0 = time.perf_counter()
    reference = _reference_steps(cfgd, snaps, first_rows, dtype)
    values = gaps(_program_steps(pass_losses, snaps), reference)
    values.update(dispatch_gaps(losses, reference))
    seconds = time.perf_counter() - t0
    values.update(diagnostics)
    if getattr(run, "f32ref", False):
        plain = _reference_steps(cfgd, snaps, first_rows, torch.float32)
        values.update({"f32ref." + name: v for name, v in gaps(plain, reference).items()})
    print(f"benchmark: reference {seconds:.1f} s over {len(losses)} steps; program losses {losses}",
          file=sys.stderr, flush=True)
    run.readings = values
    return compare.judge(values, run.limits)


def run(run):
    cfgd = run.config["maml"]
    built = setup(run)
    peaks = built.pop("peaks")
    peaks.reset()
    setup_s = seconds_since_start()
    print(f"benchmark: set-up {setup_s:.1f} s", file=sys.stderr, flush=True)
    stepper, first, n_rows = built["stepper"], built["first"], built["n_rows"]
    state, steps, bad, elapsed = _window(run, stepper, built.pop("state"), first, n_rows, seconds=run.seconds)
    record = {"steps": steps, "elapsed_s": elapsed, "meta_steps_per_s": steps / elapsed, "k": stepper.k,
              "dispatch_s": run.spans.seconds("bench.dispatch"), "precision": run.config["precision"],
              "flops_per_meta_step": run.config.get("flops_per_meta_step"),
              "inner_update_bytes": ref_costs.inner_update_bytes(cfgd, int(cfgd["batch_size"])),
              "step_peak_bytes": built.pop("step_peak_bytes")}
    record["window_peak_bytes"] = peaks.read()
    if run.trace:
        dispatches = max(1, math.ceil(float(run.traffic["trace_seconds"]) * record["meta_steps_per_s"] / stepper.k))
        (state, traced_steps, traced_bad, _), record["trace"] = tracing.traced(
            lambda: _window(run, stepper, state, first, n_rows, dispatches=dispatches), run.spans, run.device)
        steps, bad = steps + traced_steps, bad + traced_bad
    if peaks.on_card:
        peaks.read()
        record["memory_peak_bytes"] = peaks.seen
    del state, stepper
    checks = check(run, built)
    return {"correct": compare.passed(checks) and bad == 0, "attempted": steps, "failed": bad,
            "metrics": {"meta_steps_per_s": record["meta_steps_per_s"], "setup_s": setup_s},
            "checks": checks, "record": record}
