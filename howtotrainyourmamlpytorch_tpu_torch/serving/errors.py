"""Request-path error taxonomy shared by the frontend, pool, and router.

These used to live in ``serving/server.py``; the fleet layer (``pool.py`` /
``router.py``) raises them from below the frontend, so they moved to a leaf
module neither side has to import the HTTP stack for. ``server.py``
re-exports them — every existing ``from .server import
ServiceUnavailableError`` keeps working and keeps meaning the same class.
"""

from ..exit_codes import HTTP_UNAVAILABLE


class UnknownAdaptationError(KeyError):
    """predict() named an adaptation id that is not (or no longer) cached.

    In a fleet this is also the honest failover answer: a session whose
    affine replica died predicts against a replica that never saw its
    support set — the client re-sends /adapt (priming the new replica's
    cache) instead of being served a stale or wrong result."""


class SessionQuarantinedError(RuntimeError):
    """The session's refinement guard hit ``serving.refine_quarantine_after``
    consecutive held-out regressions: its cached fast weights are untrusted
    and the frontend refuses to refine OR predict through them (HTTP 409 +
    ``Retry-After``) until the client re-adapts from the masters — a plain
    (non-refine) ``/adapt`` with the same support set resets the session.
    The honest alternative to silently serving a poisoned session."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.status = 409


class ServiceUnavailableError(RuntimeError):
    """The serving path refused the request without dispatching it — queue
    full (load shed), circuit breaker open, router admission control, or no
    routable replica. The HTTP layer maps this to ``status`` (503 for
    replica-side refusals, 429 for router admission) with a ``Retry-After``
    header so clients back off instead of hammering."""

    def __init__(
        self, message: str, retry_after_s: float, status: int = HTTP_UNAVAILABLE
    ):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.status = int(status)
