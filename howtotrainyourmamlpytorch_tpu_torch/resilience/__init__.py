"""The resilience layer (copies of the JAX package's modules):

- :mod:`faults` — ``FaultInjector``: seeded injection points at the real
  seams (checkpoint read/write, episode assembly, step dispatch, serving
  dispatch and refine, HTTP handler), inert unless a drill is named;
- :mod:`retry` — ``retry_call``: exponential backoff with jitter;
- :mod:`breaker` — ``CircuitBreaker`` around the serving dispatch;
- :mod:`watchdog` — ``HeartbeatWatchdog``: zero progress past a deadline
  becomes thread stacks, an emergency checkpoint and exit code 76;
- :mod:`campaign` — the seeded chaos campaign (``run_campaign``,
  ``scripts/chaos_soak.py``): training episodes, the in-process serve
  episodes and the cross-process fleet drills, optionally under the
  lock-discipline sanitizer;
- :mod:`fleet` — the config x seed training scheduler
  (``scripts/fleet_run.py``): the rc policy of ``exit_codes.py``, the card
  gate, stall kills and the fleet report.
"""

from .breaker import CircuitBreaker, Permit  # noqa: F401
from .faults import (  # noqa: F401
    ENV_VAR,
    NULL_INJECTOR,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    injector_from,
)
from .fleet import FleetCell, FleetScheduler, FleetSpec  # noqa: F401
from .retry import DeadlineExceededError, backoff_schedule, retry_call  # noqa: F401
from .watchdog import (  # noqa: F401
    WEDGE_EXIT_CODE,
    HeartbeatWatchdog,
    dump_all_thread_stacks,
)
