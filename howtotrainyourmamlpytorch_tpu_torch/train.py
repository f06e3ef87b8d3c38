"""Training entry point of the port (``train_maml_system.py``'s contract).

Usage::

    python -m howtotrainyourmamlpytorch_tpu_torch.train \\
        [--config configs/default.yaml] [--device cuda|cpu] [key=value ...]

Overrides use dotted paths, as in the JAX package's entry script. The run
writes the same run directory (``{experiment_root}/{dataset}.{n_way}.{k_shot}``),
and a second call with a larger ``total_epochs`` resumes from ``latest``.
``--device`` defaults to the CUDA card; without one the run raises rather
than falling back to the CPU.

The runner's mesh draws from every visible card (``--device cpu``: the one
CPU), so ``parallel.dp=2`` on a machine with one card degrades to a single
device and logs the ``degraded_mesh`` event; a run resumed from a
checkpoint written under a bigger mesh shrinks onto this one, and a run on
more cards than its checkpoint's mesh grows (``mesh_grown``). A drill
named in ``HTYMP_FAULTS`` (``runner.step=sigterm:nth=3``,
``checkpoint.write=sigterm:nth=2``, ...) fires at the runner's seams.
"""

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=None, help="YAML config file")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the system runs (default: the CUDA card)")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = parser.parse_args(argv)

    from .config import load_config
    from .experiment import ExperimentRunner

    cfg = load_config(args.config, args.overrides)
    runner = ExperimentRunner(cfg, device=None if args.device == "cuda" else args.device)
    print(f"run dir: {runner.run_dir}", flush=True)
    print(f"n_params: {runner.system.num_params(runner.state)}", flush=True)
    if runner.start_epoch or runner.loader.train_episodes_produced:
        print(f"resumed: epoch {runner.start_epoch}, train episodes {runner.loader.train_episodes_produced}",
              flush=True)
    result = runner.run_experiment()
    print(result, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
