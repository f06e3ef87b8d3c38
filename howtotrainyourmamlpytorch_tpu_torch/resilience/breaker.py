"""Circuit breaker for the serving engine's device dispatch.

When the device path starts failing repeatedly (wedged tunnel, poisoned
compile cache, OOM loop), every queued request burns a full dispatch attempt
and a deadline before failing — the breaker converts that into an immediate,
cheap 503 the client can back off on, and probes the device again after a
cooldown. Two failure signatures feed it, each with its own consecutive
threshold:

- **raising failures** (``record_failure``): the dispatch returned an error;
  ``failure_threshold`` of them in a row trips the breaker.
- **deadline timeouts** (``record_timeout``): the dispatch never returned at
  all — the wedged-backend signature. Counted separately under
  ``timeout_threshold`` so the two signatures are tuned independently;
  the default is *lower* than ``failure_threshold`` because every timeout
  already burns a full request deadline before the client hears anything,
  so a hung device should convert slow 504s into fast 503s after fewer
  events than cheap, instant raising failures need.

Both consecutive counters reset only on ``record_success``.

States (classic three-state breaker):

- ``closed``: all calls pass; a consecutive-failure or consecutive-timeout
  streak reaching its threshold trips it open.
- ``open``: calls are rejected without dispatching; after ``cooldown_s``
  (measured on the injectable clock) the next ``allow()`` moves to half-open.
- ``half_open``: up to ``half_open_probes`` calls pass as probes. Any probe
  failure — raising or hung — re-opens (fresh cooldown); once
  ``half_open_probes`` probes succeed the breaker closes.

``allow()`` returns a :class:`Permit` (or ``None`` for a rejection) stamped
with whether THIS call consumed a half-open probe slot and the breaker
*generation* it was admitted under. The generation advances on every trip,
and every verdict path (``release_probe``, ``record_success``,
``record_failure``, ``record_timeout``) ignores permits from an earlier
generation: a call admitted before a trip that resolves late — while the
breaker is open, probing, or already re-closed — can never free a slot
owned by a different in-flight probe, close or re-open a half-open breaker,
or count toward (or clear) the post-recovery consecutive streaks. Stale
verdicts still land in the lifetime counters. (Calling a record method with
no permit is an authoritative manual verdict — operator/test use.)

Thread-safe; the clock is injectable so tests walk the whole state machine
with zero real waiting.
"""

import threading
import time
from typing import Any, Callable, Dict, Optional

from ..utils.locks import san_lock

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class Permit:
    """Admission token from ``allow()``. Truthy (a rejection is ``None``).
    ``probe`` says whether this call consumed a half-open probe slot;
    ``generation`` names the breaker era (advanced on every trip) the call
    was admitted under, so permits that straddle a trip are inert."""

    __slots__ = ("probe", "generation")

    def __init__(self, probe: bool, generation: int):
        self.probe = probe
        self.generation = generation


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 5,
        cooldown_s: float = 10.0,
        half_open_probes: int = 1,
        timeout_threshold: int = 3,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        if half_open_probes < 1:
            raise ValueError(f"half_open_probes must be >= 1, got {half_open_probes}")
        if timeout_threshold < 1:
            raise ValueError(f"timeout_threshold must be >= 1, got {timeout_threshold}")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = int(half_open_probes)
        self.timeout_threshold = int(timeout_threshold)
        self._clock = clock
        self._lock = san_lock("CircuitBreaker._lock")
        self._state = CLOSED
        self._consecutive_failures = 0
        self._consecutive_timeouts = 0
        self._opened_at = 0.0
        self._probes_allowed = 0
        self._probes_succeeded = 0
        self._generation = 0  # bumped on every open -> half_open transition
        # lifetime counters for /metrics
        self.opens = 0
        self.rejections = 0
        self.failures = 0
        self.timeouts = 0
        self.successes = 0

    # ------------------------------------------------------------------

    def _trip_locked(self) -> None:
        self._state = OPEN
        self._opened_at = self._clock()
        self._consecutive_failures = 0
        self._consecutive_timeouts = 0
        self._probes_allowed = 0
        self._probes_succeeded = 0
        # every permit minted before this trip is now stale: its verdict
        # describes the device era the trip already judged
        self._generation += 1
        self.opens += 1

    def allow(self) -> Optional[Permit]:
        """May a call proceed right now? Returns a :class:`Permit` if so,
        ``None`` if rejected (counted). A probe permit MUST be followed up
        with ``record_success``/``record_failure``/``record_timeout``, or
        returned via ``release_probe`` if the call never dispatched."""
        with self._lock:
            if self._state == CLOSED:
                return Permit(probe=False, generation=self._generation)
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._state = HALF_OPEN
                    self._probes_allowed = 0
                    self._probes_succeeded = 0
                else:
                    self.rejections += 1
                    return None
            # half-open: bounded probe slots
            if self._probes_allowed < self.half_open_probes:
                self._probes_allowed += 1
                return Permit(probe=True, generation=self._generation)
            self.rejections += 1
            return None

    def _owns_probe_locked(self, permit: Optional[Permit]) -> bool:
        return (
            permit is not None
            and permit.probe
            and permit.generation == self._generation
            and self._state == HALF_OPEN
        )

    def release_probe(self, permit: Optional[Permit]) -> None:
        """Give back a half-open probe slot whose call never produced a
        verdict (shed before dispatch). Without this, an unresolved probe
        would permanently consume the slot and wedge the breaker in
        half_open — rejecting all traffic forever even after the device
        recovers. Only the permit that consumed the slot can return it: a
        closed-era or prior-generation permit is a no-op, so a late-resolving
        older call can't mint extra concurrent probes."""
        with self._lock:
            if self._owns_probe_locked(permit) and self._probes_allowed > 0:
                self._probes_allowed -= 1

    def _is_current_locked(self, permit: Optional[Permit]) -> bool:
        """Does this verdict speak for the current breaker era? A missing
        permit is an authoritative manual verdict (operator/test); a permit
        from before the last trip is a stale call resolving late — its
        verdict already got judged in aggregate by the trip and must not
        move the state machine or the consecutive streaks again. In
        half-open, only probes can be current: any pre-trip permit is, by
        construction, a generation behind."""
        return permit is None or permit.generation == self._generation

    def record_success(self, permit: Optional[Permit] = None) -> None:
        with self._lock:
            self.successes += 1
            if not self._is_current_locked(permit):
                return  # stale: must not close the breaker or clear streaks
            self._consecutive_timeouts = 0
            if self._state == HALF_OPEN:
                self._probes_succeeded += 1
                if self._probes_succeeded >= self.half_open_probes:
                    self._state = CLOSED
                    self._consecutive_failures = 0
            else:
                self._consecutive_failures = 0

    def record_failure(self, permit: Optional[Permit] = None) -> None:
        with self._lock:
            self.failures += 1
            if not self._is_current_locked(permit):
                return  # stale: must not re-open or feed the fresh streak
            if self._state == HALF_OPEN:
                self._trip_locked()  # a failed probe re-opens with fresh cooldown
                return
            self._consecutive_failures += 1
            if self._state == CLOSED and self._consecutive_failures >= self.failure_threshold:
                self._trip_locked()

    def record_timeout(self, permit: Optional[Permit] = None) -> None:
        """The call hit its request deadline — the dispatch may still land,
        but a streak of these is how a wedged backend looks from the front
        end. A hung probe (current-generation permit) re-opens immediately:
        the device it was probing is evidently still stuck. Otherwise the
        consecutive-timeout counter trips the breaker from closed at
        ``timeout_threshold``."""
        with self._lock:
            self.timeouts += 1
            if not self._is_current_locked(permit):
                return  # stale: lifetime-counted only, no streak, no trip
            if self._state == HALF_OPEN:
                self._trip_locked()  # a hung probe: the device is still stuck
                return
            self._consecutive_timeouts += 1
            if self._state == CLOSED and self._consecutive_timeouts >= self.timeout_threshold:
                self._trip_locked()

    # ------------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            # surface the lazily-entered half-open so /healthz reads right
            # even before the first post-cooldown call arrives
            if (
                self._state == OPEN
                and self._clock() - self._opened_at >= self.cooldown_s
            ):
                return HALF_OPEN
            return self._state

    def snapshot(self) -> Dict[str, Any]:
        state = self.state
        with self._lock:
            return {
                "state": state,
                "opens": self.opens,
                "rejections": self.rejections,
                "failures": self.failures,
                "timeouts": self.timeouts,
                "successes": self.successes,
                "consecutive_failures": self._consecutive_failures,
                "consecutive_timeouts": self._consecutive_timeouts,
            }
