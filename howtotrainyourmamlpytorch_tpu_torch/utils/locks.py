"""Lock-factory indirection for the graftsan lock-discipline sanitizer.

Every hand-rolled ``threading.Lock()`` in ``serving/`` + ``resilience/`` +
``observability/`` is constructed through these factories instead. With the
sanitizer off (the default) they return the plain stdlib primitive — zero
overhead, bit-identical objects. Armed (``HTYMP_GRAFTSAN=1`` or
``Config.resilience.sanitizer``), they return ``tools/graftsan`` wrappers
that record the site-keyed acquisition-order graph and report lock-order
cycles / held-across-blocking violations as ``graftsan_violation`` events.

The ``site`` string is the lock's identity in the order graph — keep it
``ClassName._attr`` so one report names the owning class, not an instance.

The guarded import keeps the package usable when the repo's ``tools/`` tree
is not on ``sys.path`` (a packaged install): the factories then degrade to
plain primitives permanently, which is exactly the off-path behavior.
"""

import threading
from typing import Optional

try:
    from tools.graftsan.runtime import (  # noqa: F401
        note_blocking,
        san_condition,
        san_lock,
        san_rlock,
    )

    GRAFTSAN_AVAILABLE = True
except ImportError:  # packaged without the repo tools/ tree
    GRAFTSAN_AVAILABLE = False

    def san_lock(site: Optional[str] = None) -> threading.Lock:
        return threading.Lock()

    def san_rlock(site: Optional[str] = None) -> threading.RLock:
        return threading.RLock()

    def san_condition(site: Optional[str] = None, lock=None) -> threading.Condition:
        return threading.Condition(lock)

    def note_blocking(what: str, timeout: Optional[float] = None) -> None:
        return None
