"""Bounded retry with exponential backoff + jitter, fake-clock injectable.

One retry policy for every transient-failure seam (loader episode I/O,
serving clients, scripts talking through the wedging tunnel) instead of
ad-hoc ``for attempt in range(...)`` loops. Everything time-shaped is
injectable (``sleep``, ``clock``, ``rng``) so tests drive the full backoff
schedule with a fake clock and zero real sleeping.
"""

import time
from typing import Callable, Optional, Sequence, Tuple, Type

import numpy as np


class DeadlineExceededError(TimeoutError):
    """A call (or retry budget) ran past its deadline. The serving layer maps
    this to HTTP 504."""


def backoff_schedule(
    retries: int,
    backoff_s: float,
    max_backoff_s: float = 2.0,
    jitter: float = 0.5,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[float, ...]:
    """The delays ``retry_call`` would sleep between attempts: exponential
    doubling from ``backoff_s`` capped at ``max_backoff_s``, each inflated by
    up to ``jitter`` fraction (pass a seeded rng for determinism in tests).
    Exposed separately so callers can budget deadlines against it. The
    default rng is OS-seeded: jitter exists to DEcorrelate the retries of
    many threads/processes hitting the same blip, so they must not all draw
    the identical inflation sequence."""
    rng = rng if rng is not None else np.random.RandomState()
    delays = []
    for attempt in range(retries):
        base = min(backoff_s * (2.0 ** attempt), max_backoff_s)
        delays.append(base * (1.0 + jitter * float(rng.random_sample())))
    return tuple(delays)


def retry_call(
    fn: Callable,
    *args,
    retries: int = 2,
    backoff_s: float = 0.05,
    max_backoff_s: float = 2.0,
    jitter: float = 0.5,
    retry_on: Sequence[Type[BaseException]] = (OSError,),
    deadline_s: Optional[float] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: Optional[np.random.RandomState] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Call ``fn(*args)``; on an exception in ``retry_on``, sleep the next
    backoff delay and try again, up to ``retries`` retries (so ``retries + 1``
    attempts total). The final failure re-raises the original exception.

    ``deadline_s`` bounds the whole affair against ``clock``: a retry that
    would start past the deadline raises :class:`DeadlineExceededError`
    chained to the last failure instead of sleeping toward it.
    ``on_retry(attempt, exc)`` observes each scheduled retry (logging,
    counters)."""
    delays = backoff_schedule(retries, backoff_s, max_backoff_s, jitter, rng)
    start = clock()
    for attempt in range(retries + 1):
        try:
            return fn(*args)
        except tuple(retry_on) as exc:
            if attempt >= retries:
                raise
            delay = delays[attempt]
            if deadline_s is not None and clock() - start + delay > deadline_s:
                raise DeadlineExceededError(
                    f"retry budget exhausted after {attempt + 1} attempts "
                    f"({clock() - start:.3f}s elapsed, deadline {deadline_s}s)"
                ) from exc
            if on_retry is not None:
                on_retry(attempt, exc)
            if delay > 0:
                sleep(delay)
