"""Request tenancy: the part of the JAX package's ``serving/tenancy.py``
that a frontend serving one checkpoint needs — a request's tenant
normalized (absent, empty and ``"default"`` are the one default tenant)
and validated, and the quota error type. The tenant registry, the
``WeightPager`` and ``TenantQuotas`` are not ported yet (ROADMAP.md A8.4):
``serving.tenant_registry`` is refused by the engine, so any request that
names a non-default tenant is a client error (HTTP 400).
"""

from typing import Optional

from ..config import DEFAULT_TENANT


def normalize_tenant(tenant: Optional[str]) -> Optional[str]:
    """Request tenant -> internal identity. Absent, empty, and the explicit
    default all collapse to ``None``, so a client naming ``"default"`` gets
    byte-identical digests/ids to one omitting the field entirely."""
    if tenant is None:
        return None
    if not isinstance(tenant, str):
        raise ValueError(f"tenant must be a string, got {type(tenant).__name__}")
    tenant = tenant.strip()
    if tenant in ("", DEFAULT_TENANT):
        return None
    return tenant


def validate_request_tenant(tenant: Optional[str], registry) -> Optional[str]:
    """Normalize + admit a request's tenant. A non-default tenant needs a
    registry naming it; unknown tenants are a client error (HTTP 400), not
    a silent fall-through to someone else's weights."""
    tenant = normalize_tenant(tenant)
    if tenant is None:
        return None
    if registry is None:
        raise ValueError(
            f"request names tenant {tenant!r} but no tenant registry is "
            "configured (serving.tenant_registry)"
        )
    if tenant not in registry:
        raise ValueError(
            f"unknown tenant {tenant!r}; registered: {list(registry.tenants())}"
        )
    return tenant


class QuotaExceededError(Exception):
    """A per-tenant quota breach. ``retry_after_s`` is honest: for rate
    breaches it is the token-bucket refill time, for inflight/byte breaches
    a short constant (the resource frees on request completion /
    TTL-eviction, not on a schedule)."""

    def __init__(self, tenant: str, reason: str, retry_after_s: float):
        super().__init__(f"tenant {tenant!r} over {reason} quota")
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
