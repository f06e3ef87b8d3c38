"""The supervisor's cross-process drills against the port's backends on
the CPU (the last three of ``tests/test_gateway_fleet.py``'s six), each
with every spawn and respawn command on ``cpu`` and the JAX drills'
assertions unchanged:

- a refined session survives a SIGTERM drain + rehydrate (bit-identical
  predictions, the lineage continues at refine_count 2) and a kill -9 of
  the gateway in front of it (refine_count 3 through a fresh gateway);
- the port's ``scripts/fleet_serve.py`` closes the scaling loop: a
  slowed backend (``HTYMP_FAULTS`` ``serving.dispatch`` delay) under
  surging load makes the supervisor spawn the second slot, and when the
  load stops it drains it back (rc 0) with zero dropped connections and
  the refined lineage intact;
- crash-safe control: a die-on-spawn slot walks the backoff ladder into
  quarantine; a supervisor kill -9'd mid-spawn restarts and settles the
  journaled spawn with the same pid.
"""

from tests.test_torch_fleet_drills import _one_thread_per_backend, fleet_template, run_drill  # noqa: F401


def test_cross_process_refined_session_survives_drain_and_gateway_kill(tmp_path, fleet_template):  # noqa: F811
    run_drill("serve-refine-across-drain", tmp_path, fleet_template)


def test_cross_process_fleet_surge_autoscale_cycle(tmp_path, fleet_template):  # noqa: F811
    run_drill("fleet-surge", tmp_path, fleet_template)


def test_cross_process_fleet_crashloop_and_supervisor_kill9(tmp_path, fleet_template):  # noqa: F811
    run_drill("fleet-crashloop", tmp_path, fleet_template)
