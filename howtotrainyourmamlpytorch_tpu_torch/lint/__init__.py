"""The port's static-analysis gate: ``tools/graftlint``'s rules for
PyTorch and CUDA graphs.

    python -m howtotrainyourmamlpytorch_tpu_torch.lint [--json] [--rule GLxxx ...] [--list-rules] PATH...
    python -m howtotrainyourmamlpytorch_tpu_torch.lint howtotrainyourmamlpytorch_tpu_torch chip_smoke.py

Exit codes as the root CLI's (``scripts/lint.py``): 0 clean, 1 findings, 2
a usage error; ``--json`` prints its payload, ``rule_times_ms`` included.
The rule ids, their meanings and the ``# graftlint: disable=GLxxx``
suppressions are ``docs/STATIC_ANALYSIS.md``'s:

- carried over (``rules_carried.py``): GL120, GL122, GL201, GL202, GL210,
  GL211, GL212 as they are; GL213, GL301, GL302 and GL303 on the port's
  heavy roots and registries;
- the torch counterparts (``rules_torch.py``): GL101/GL102 in code a CUDA
  graph captures, GL110 on the port's hot paths, GL121 with torch's global
  generator, GL130 on the port's donations, GL140 on torch's casts.

The registry (:data:`RULES`) is this package's; the JAX linter's is left as
it is. Like the JAX linter it reads the code with ``ast`` and imports none
of what it lints, so it needs no card.
"""

from . import rules_carried, rules_torch
from .engine import LAST_RULE_TIMES_MS, RULES, register, report_human, report_json, run_lint  # noqa: F401
from tools.graftlint.rules_concurrency import (
    GuardedFieldBareWrite,
    LockHeldAcrossBlocking,
    LockOrderInversion,
    UnguardedSharedWrite,
    UntimedBlockingWait,
)
from tools.graftlint.rules_jax import SetIterationOrder, WallClockSeededRNG

for _rule in (
    rules_torch.HostSyncInCapture,
    rules_torch.ControlFlowOnTensor,
    rules_torch.HostSyncInHotPath,
    WallClockSeededRNG,
    rules_torch.UnseededGlobalRNG,
    SetIterationOrder,
    rules_torch.DonationAfterUse,
    rules_torch.FloatCastOutsidePolicy,
    UnguardedSharedWrite,
    UntimedBlockingWait,
    LockOrderInversion,
    GuardedFieldBareWrite,
    LockHeldAcrossBlocking,
    rules_carried.ImportLightClosure,
    rules_carried.PortExitCodeLiteral,
    rules_carried.PortOperationsRcTable,
    rules_carried.PortFaultSeams,
):
    register(_rule)
