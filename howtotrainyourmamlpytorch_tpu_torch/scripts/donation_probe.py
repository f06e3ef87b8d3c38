#!/usr/bin/env python
"""Buffer-donation probe (the JAX package's ``scripts/donation_probe.py``,
on this package): the same seed and batch sequence in two arms,
``donate_train_state=true`` and ``false``, stepped eagerly with a fresh
host-to-device copy of a different batch every step (the loader's churn:
a donated buffer reused by an incoming copy is the aliasing fault that only
streaming inputs show).

Donation must not change the result: both arms must give the same per-step
losses and final parameters up to float reordering. The arm runner, the
comparison and the verdict thresholds are ``observability/donation.py``'s,
the same code as the runner's startup gate (``donation_selfcheck``), so
this probe and the gate cannot drift apart; the arms step under the
deterministic algorithms, so on the card two clean arms do not differ by
cuDNN's choice of convolution.

Usage:
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.donation_probe \\
        [N_STEPS=40] [N_WAY=20] [K_SHOT=5] [BATCH_SIZE=8] [--override KEY=VALUE] \\
        [--device cuda|cpu] [--json PATH]
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.donation_probe selfcheck [N_STEPS ...]

``selfcheck`` runs the determinism control instead: each arm twice on the
same stream, compared with itself, then the two arms' first runs with each
other. Dropped from the JAX script: its unrolled program family (an XLA
choice with no counterpart: the arms run the port's one eager step).
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def probe_config(n_way: int = 20, k_shot: int = 5, batch_size: int = 8, overrides=()):
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config

    return load_config(None, [f"num_classes_per_set={n_way}", f"num_samples_per_class={k_shot}",
                              f"batch_size={batch_size}", "remat_inner_steps=false", *overrides])


def _arm(cfg, donate: bool, n_steps: int, device, system=None, model=None):
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.observability.donation import run_donation_arm

    cfg = dataclasses.replace(cfg, donate_train_state=donate)
    if system is None and model is not None:
        system = MAMLSystem(cfg, model=model, device=device)
    return run_donation_arm(cfg, n_steps, system=system, device=device)


def ab(cfg, n_steps: int, device=None, model=None, out=print) -> dict:
    """The A/B: the donated and the plain arm -> the comparison and the
    verdict (``"clean"`` or ``"corruption"``)."""
    from howtotrainyourmamlpytorch_tpu_torch.observability.donation import compare_arms, param_divergences, verdict_from

    out(f"donation probe: device={device or 'cuda'} n_steps={n_steps} "
        f"{cfg.num_classes_per_set}w{cfg.num_samples_per_class}s b{cfg.batch_size}")
    loss_d, params_d = _arm(cfg, True, n_steps, device, model=model)
    loss_n, params_n = _arm(cfg, False, n_steps, device, model=model)
    cmp = compare_arms(loss_d, params_d, loss_n, params_n)
    out(f"per-step loss: max |donate - nodonate| = {cmp['max_loss_dev']:.3e} "
        f"(first step deviating >1e-5: {cmp['first_step_deviating']})")
    for path, rel in param_divergences(params_d, params_n):
        if rel > 1e-4:
            out(f"  DIVERGED {path}: rel |d| = {rel:.3e}")
    out(f"final params: worst relative divergence = {cmp['worst_param_rel']:.3e}")
    verdict = verdict_from(cmp)
    out(f"verdict: {'DONATION-CORRUPTION' if verdict == 'corruption' else 'clean'}")
    return {"verdict": verdict, "losses": {"donate": loss_d, "plain": loss_n},
            **{k: v for k, v in cmp.items() if k != "diverged_leaves"}}


def selfcheck(cfg, n_steps: int, device=None, model=None, out=print) -> dict:
    """Each arm twice on the same stream (one system per arm), compared
    with itself; then the two arms' first runs."""
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.observability.donation import compare_arms

    out(f"donation selfcheck: device={device or 'cuda'} n_steps={n_steps} "
        f"{cfg.num_classes_per_set}w{cfg.num_samples_per_class}s b{cfg.batch_size}")
    runs, report = {}, {}
    for donate in (True, False):
        arm_cfg = dataclasses.replace(cfg, donate_train_state=donate)
        system = MAMLSystem(arm_cfg, model=model, device=device)
        runs[donate] = [_arm(cfg, donate, n_steps, device, system=system) for _ in range(2)]
        (loss_a, p_a), (loss_b, p_b) = runs[donate]
        cmp = compare_arms(loss_a, p_a, loss_b, p_b)
        nondet = cmp["worst_param_rel"] > 1e-4 or cmp["max_loss_dev"] > 1e-4
        out(f"  donate={donate} run-vs-rerun: max |loss dev| = {cmp['max_loss_dev']:.3e}, worst param rel |d| = "
            f"{cmp['worst_param_rel']:.3e} ({'NONDETERMINISTIC' if nondet else 'self-reproducible'})")
        report["donate" if donate else "plain"] = {"max_loss_dev": cmp["max_loss_dev"],
                                                   "worst_param_rel": cmp["worst_param_rel"],
                                                   "deterministic": not nondet}
    cross = compare_arms(runs[True][0][0], runs[True][0][1], runs[False][0][0], runs[False][0][1])["worst_param_rel"]
    out(f"  donate-vs-nodonate (run 0): worst param rel |d| = {cross:.3e}")
    report["cross_worst_param_rel"] = cross
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                     epilog=__doc__.split("\n\n", 2)[2],
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("numbers", nargs="*", help="[selfcheck] [N_STEPS] [N_WAY] [K_SHOT] [BATCH_SIZE]")
    parser.add_argument("--override", action="append", default=[], metavar="KEY=VALUE",
                        help="a config override applied last (e.g. use_pallas_inner_update=true); repeatable")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--json", default=None, help="write the result as one JSON object to this path")
    args = parser.parse_args(argv)
    words = list(args.numbers)
    mode = "selfcheck" if words[:1] == ["selfcheck"] else "ab"
    nums = [int(w) for w in words[mode == "selfcheck":]]
    n_steps, n_way, k_shot, batch_size = nums + [40, 20, 5, 8][len(nums):]
    cfg = probe_config(n_way, k_shot, batch_size, args.override)
    device = None if args.device == "cuda" else "cpu"
    result = (selfcheck if mode == "selfcheck" else ab)(cfg, n_steps, device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"mode": mode, **result}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
