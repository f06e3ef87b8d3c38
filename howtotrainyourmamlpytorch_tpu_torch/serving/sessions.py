"""Session spill / rehydrate: adapted fast weights survive a graceful drain.

A SIGTERM'd serving process used to take every cached adapted session with
it — after a rolling restart each client's next predict was an honest 404
and a full re-adapt. The drain path (``serving/server.py::begin_drain``) now
spills hot sessions here, content-addressed under
``<run>/saved_models/sessions/``, and a freshly started replica of the same
run dir rehydrates them into its adapted-weight caches — a restart costs
cache warmth bookkeeping, never correctness:

- every file is **digest-wrapped** (format-2 checkpoint convention: the
  body's sha256 rides inside the file) and written via the checkpoint
  module's atomic temp+rename, so a kill mid-spill leaves an invisible temp
  or a verifiable file, never a loadable-but-torn session;
- a file that fails its digest is quarantined to ``*.corrupt`` (the
  checkpoint convention) and NEVER served;
- a session is only rehydrated for the SAME checkpoint fingerprint, and
  only while its original cache TTL has not lapsed (spill records the
  entry's age; wall-clock carries it across the restart) — stale or foreign
  entries are ignored, so the fallback is always the existing honest 404 +
  re-adapt, never a wrong answer.

Consumed files are removed on load (the session is live again; the next
drain re-spills it), so the directory holds exactly the sessions parked
between two process lifetimes.

The JAX package's module without flax: the files are flax msgpack written
by the checkpoint module's encoder (``experiment/checkpoint.py``), and
every tree in them is in the JAX layout (HWIO conv kernels, ``[in, out]``
head; ``utils/interop.py``), byte for byte what ``flax.serialization``
writes for the same weights. A session spilled by either package
rehydrates in the other. The trees are converted with the model's
``feature_shape``, which the store is built with.
"""

import hashlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..experiment.checkpoint import _packb, _restore, _write_atomic
from ..utils.interop import params_from_jax, params_to_jax
from ..utils.trees import tree_flatten, tree_unflatten


def tree_to_bytes(tree: Any, feature_shape) -> bytes:
    """A port tree -> ``flax.serialization.to_bytes`` of it in the JAX
    layout (keys sorted, as ``jax.tree`` rebuilds dicts)."""
    return _packb(params_to_jax(tree, feature_shape))


def tree_from_bytes(template: Any, blob: bytes, feature_shape) -> Any:
    """Inverse of :func:`tree_to_bytes` against ``template``: its keys and
    shapes are required (``ValueError`` otherwise), and each leaf takes the
    template leaf's dtype and device."""
    tree = params_from_jax(_restore(blob), feature_shape)
    leaves, paths = tree_flatten(tree)
    want, want_paths = tree_flatten(template)
    if paths != want_paths:
        raise ValueError(f"session tree has keys {paths}, the template {want_paths}")
    for path, got, ref in zip(paths, leaves, want):
        if tuple(got.shape) != tuple(ref.shape):
            raise ValueError(
                f"session leaf {'/'.join(path)} has shape {tuple(got.shape)}, "
                f"the template {tuple(ref.shape)}"
            )
    return tree_unflatten(paths, [g.to(device=r.device, dtype=r.dtype) for g, r in zip(leaves, want)])

#: session spill format version (bumped on any layout change; a reader
#: refuses versions it does not know rather than guessing)
SESSION_FORMAT = 1

_PREFIX = "session_"
_SUFFIX = ".msgpack"


def encode_lineage(lineage, feature_shape) -> Dict[str, Any]:
    """``SessionLineage`` (serving/cache.py) -> msgpack-friendly payload:
    counters/flags verbatim, the snapshot ring as per-tree ``to_bytes``
    blobs, the held-out probe as raw arrays. Rides the spill file under the
    OPTIONAL ``lineage`` key — SESSION_FORMAT stays 1, and pre-refinement
    readers/files interoperate (an absent key reads as no lineage)."""
    out: Dict[str, Any] = {
        "refine_count": int(lineage.refine_count),
        "rollbacks": int(lineage.rollbacks),
        "consecutive_regressions": int(lineage.consecutive_regressions),
        "quarantined": bool(lineage.quarantined),
        "snapshot_ring": int(lineage.snapshot_ring),
        "scores": [float(s) for s in lineage.scores],
        "snapshots": [tree_to_bytes(t, feature_shape) for t in lineage.snapshots],
    }
    if lineage.probe is not None:
        out["probe_x"] = np.asarray(lineage.probe[0])
        out["probe_y"] = np.asarray(lineage.probe[1])
    return out


def decode_lineage(payload: Dict[str, Any], template: Any, feature_shape):
    """Inverse of :func:`encode_lineage`; snapshot trees restore against
    ``template`` (the same parameter tree the session itself restored
    against). Returns None on ANY defect — a session whose lineage cannot
    be trusted rehydrates as a fresh, lineage-free session rather than
    with made-up history."""
    from .cache import SessionLineage

    try:
        lineage = SessionLineage(snapshot_ring=int(payload.get("snapshot_ring", 1)))
        lineage.refine_count = int(payload.get("refine_count", 0))
        lineage.rollbacks = int(payload.get("rollbacks", 0))
        lineage.consecutive_regressions = int(
            payload.get("consecutive_regressions", 0)
        )
        lineage.quarantined = bool(payload.get("quarantined", False))
        lineage.scores = [float(s) for s in payload.get("scores", [])]
        lineage.snapshots = [
            tree_from_bytes(template, blob, feature_shape)
            for blob in payload.get("snapshots", [])
        ]
        if "probe_x" in payload and "probe_y" in payload:
            lineage.probe = (
                np.asarray(payload["probe_x"]),
                np.asarray(payload["probe_y"]),
            )
        return lineage
    except Exception:  # noqa: BLE001 — untrusted lineage is no lineage
        return None


class SessionStore:
    """Content-addressed spill directory for adapted-weight cache entries.
    ``feature_shape`` is the model's (``Model.feature_shape``): the head's
    rows are reordered with it between the two layouts."""

    def __init__(self, root: str, feature_shape):
        self.root = root
        self.feature_shape = tuple(feature_shape)

    def _path(self, digest: str) -> str:
        return os.path.join(self.root, f"{_PREFIX}{digest}{_SUFFIX}")

    # -- spill ----------------------------------------------------------

    def spill(
        self,
        digest: str,
        tree: Any,
        fingerprint: str,
        age_s: float,
        ttl_s: float,
        wall_clock: Callable[[], float] = time.time,
        strategy: str = "maml++",
        tenant: Optional[str] = None,
        lineage: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Write one session (its adapted-parameter pytree) atomically,
        digest-wrapped. ``age_s`` is how long the entry had already lived in
        the cache; with ``ttl_s`` it lets the rehydrating process honor the
        ORIGINAL expiry across the restart. ``strategy`` is the adaptation
        strategy the tree belongs to (core/strategies.py) — the rehydrating
        cache keys on it, so a session can only ever be served back through
        the strategy that produced it. ``tenant`` (serving/tenancy.py) is
        recorded the same way for non-default tenants; the entry's
        ``fingerprint`` is already the TENANT's checkpoint fingerprint, so
        rehydration re-keys it under the right master by construction."""
        os.makedirs(self.root, exist_ok=True)
        payload = {
            "digest": str(digest),
            "fingerprint": str(fingerprint),
            "strategy": str(strategy),
            "saved_at": float(wall_clock()),
            "age_s": float(age_s),
            "ttl_s": float(ttl_s),
            "tree": tree_to_bytes(tree, self.feature_shape),
        }
        if tenant:
            # only non-default tenants stamp the field: a default-tenant
            # spill stays byte-compatible with pre-tenancy readers
            payload["tenant"] = str(tenant)
        if lineage:
            # refinement lineage (encode_lineage): optional key, so a
            # never-refined session's spill file is byte-identical to the
            # pre-refinement format and old files keep loading
            payload["lineage"] = lineage
        body = _packb(payload)
        blob = _packb(
            {
                "format": SESSION_FORMAT,
                "sha256": hashlib.sha256(body).hexdigest(),
                "body": body,
            }
        )
        path = self._path(digest)
        _write_atomic(path, blob)
        return path

    # -- rehydrate -------------------------------------------------------

    def load_all(
        self,
        fingerprint: str,
        template: Any,
        wall_clock: Callable[[], float] = time.time,
        tenant_fingerprints: Optional[Dict[str, str]] = None,
        lineage_sink: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> Tuple[List[Tuple[str, Any, float, str, Optional[str]]], Dict[str, int]]:
        """-> (``[(digest, tree, lived_s, strategy, tenant)]`` safe to
        serve, stats). Digest-verified; corrupt => quarantined ``*.corrupt``;
        TTL-lapsed => removed and counted ``stale``; other-checkpoint
        entries counted ``foreign`` and left for a replica of that
        checkpoint. ``lived_s`` is how much TTL budget the session has
        already consumed (cache age before spill + wall time parked on
        disk) — the rehydrating cache back-dates the entry with it, so a
        restart never extends a session's original expiry. ``strategy`` is
        the adaptation strategy recorded at spill (files from before the
        registry read as the default); ``tenant`` likewise (pre-tenancy
        files read as the default tenant, None). ``tenant_fingerprints``
        maps tenant id -> checkpoint fingerprint for the tenants this fleet
        serves (serving/registry.py): a spilled tenant session rehydrates
        only when BOTH its recorded tenant is registered AND its
        fingerprint matches that tenant's checkpoint — anything else stays
        ``foreign``, never a cross-tenant serve. ``lineage_sink`` (optional
        dict) collects each loaded entry's raw refinement-lineage payload
        under its digest — callers that track lineage (ServingFrontend)
        decode it via :func:`decode_lineage`; the 5-tuple return shape is
        unchanged for everyone else. Loaded files are consumed (removed) —
        they are live cache entries again."""
        stats = {"loaded": 0, "stale": 0, "corrupt": 0, "foreign": 0}
        entries: List[Tuple[str, Any, float, str, Optional[str]]] = []
        if not os.path.isdir(self.root):
            return entries, stats
        for name in sorted(os.listdir(self.root)):
            if not (name.startswith(_PREFIX) and name.endswith(_SUFFIX)):
                continue
            path = os.path.join(self.root, name)
            payload = self._read_verified(path)
            if payload is None:
                # torn/corrupt/unknown-format: quarantine like a corrupt
                # checkpoint — visible for forensics, invisible to serving
                os.replace(path, path + ".corrupt")
                stats["corrupt"] += 1
                continue
            tenant = payload.get("tenant") or None
            if tenant is None:
                expected = fingerprint
            else:
                expected = (tenant_fingerprints or {}).get(str(tenant))
            if expected is None or payload["fingerprint"] != expected:
                stats["foreign"] += 1
                continue
            ttl_s = float(payload["ttl_s"])
            lived_s = float(payload["age_s"]) + max(
                0.0, wall_clock() - float(payload["saved_at"])
            )
            if ttl_s > 0 and lived_s > ttl_s:
                os.remove(path)
                stats["stale"] += 1
                continue
            try:
                tree = tree_from_bytes(template, payload["tree"], self.feature_shape)
            except Exception:  # noqa: BLE001 — a structure mismatch is corrupt
                os.replace(path, path + ".corrupt")
                stats["corrupt"] += 1
                continue
            entries.append(
                (payload["digest"], tree, lived_s,
                 str(payload.get("strategy", "maml++")),
                 str(tenant) if tenant is not None else None)
            )
            if lineage_sink is not None and isinstance(
                payload.get("lineage"), dict
            ):
                lineage_sink[payload["digest"]] = payload["lineage"]
            stats["loaded"] += 1
            os.remove(path)
        return entries, stats

    @staticmethod
    def _read_verified(path: str) -> Optional[Dict[str, Any]]:
        """Digest-verify + decode one spill file; None on ANY defect."""
        try:
            with open(path, "rb") as f:
                blob = f.read()
            outer = _restore(blob)
            if (
                not isinstance(outer, dict)
                or outer.get("format") != SESSION_FORMAT
                or "body" not in outer
                or "sha256" not in outer
            ):
                return None
            body = outer["body"]
            if hashlib.sha256(body).hexdigest() != outer["sha256"]:
                return None
            payload = _restore(body)
            if not isinstance(payload, dict) or not all(
                k in payload
                for k in ("digest", "fingerprint", "saved_at", "age_s", "ttl_s", "tree")
            ):
                return None
            return payload
        except Exception:  # noqa: BLE001 — any decode failure is corruption
            return None

    def pending(self) -> int:
        """Spilled sessions currently parked on disk (drill assertions)."""
        if not os.path.isdir(self.root):
            return 0
        return sum(
            1
            for name in os.listdir(self.root)
            if name.startswith(_PREFIX) and name.endswith(_SUFFIX)
        )
