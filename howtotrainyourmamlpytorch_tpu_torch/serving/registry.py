"""Tenant model registry: many checkpoints behind one serving fleet (JAX
package ``serving/registry.py``).

The registry maps **tenant ids** to checkpoint run directories, so many
fine-tuned variants sit behind one engine. Master weights load **lazily
into host RAM** (a registry naming 1000 tenants costs nothing until traffic
arrives for one) and are keyed on the checkpoint's sha256 fingerprint — the
content address the adapted-weight cache and the session store already use,
so tenant isolation falls out of content addressing rather than a parallel
namespace.

The registry is host-side bookkeeping: paging masters onto the card under
a byte budget is ``serving/tenancy.py::WeightPager``'s job. A master is
read in the JAX layout (``experiment/checkpoint.py::load_for_inference``)
and converted to the port's on the CPU (``utils/interop.py``), which needs
the model's ``feature_shape``: the engine sets it with the ``template``.
With a CUDA card present every host leaf is pinned, so a page-in is an
asynchronous copy from page-locked memory.

Registry sources, in precedence order:

1. an explicit ``serving.tenant_registry`` YAML path;
2. ``<run_dir>/tenants.yaml`` next to the served run's ``config.yaml``.

YAML format (``checkpoint`` optional, ``best`` with a ``latest`` fallback,
matching ``AdaptationEngine.from_run_dir``)::

    tenants:
      acme:
        run_dir: exps/acme_finetune
        checkpoint: best
"""

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import yaml

from ..core.train_state import TrainState
from ..experiment import checkpoint as ckpt
from ..utils.interop import params_from_jax, params_to_jax, state_from_jax
from ..utils.locks import san_lock
from ..utils.trees import tree_flatten, tree_map

_SERVED_FIELDS = ("params", "bn_state", "inner_hparams")


def _tree_shapes(state: TrainState) -> List[Tuple[str, Tuple[int, ...]]]:
    """Sorted (path, shape) pairs of the served fields and the step — the
    structural identity two checkpoints must share to flow through one
    engine. Optimizer state is excluded: serving never touches it, and
    registry loads come back with ``opt_state=None`` while a directly
    constructed fleet master may still carry one."""
    out = [("step", tuple(np.shape(state.step)))]
    for field in _SERVED_FIELDS:
        leaves, paths = tree_flatten(getattr(state, field))
        out += [("/".join((field,) + path), tuple(leaf.shape)) for path, leaf in zip(paths, leaves)]
    return sorted(out)


class TenantRegistry:
    """Lazy host-RAM store of tenant master states, fingerprint-keyed.

    ``entries`` maps tenant id -> ``{"run_dir": ..., "checkpoint": ...}``.
    ``host_state(tenant)`` loads the checkpoint on first use (CPU tensors in
    the port's layout — no device memory until the pager asks) and validates
    its tree structure against ``template`` when one is set: a tenant whose
    backbone differs from the fleet master cannot share the engine, and
    failing at load beats failing on the serving hot path."""

    def __init__(self, entries: Dict[str, Dict[str, Any]], base_dir: str = "", feature_shape=None):
        self.base_dir = base_dir
        self._entries: Dict[str, Dict[str, Any]] = {}
        for tenant, spec in entries.items():
            if not isinstance(spec, dict) or "run_dir" not in spec:
                raise ValueError(f"tenant {tenant!r}: registry entry must be a mapping with a run_dir, got {spec!r}")
            self._entries[str(tenant)] = {
                "run_dir": str(spec["run_dir"]),
                "checkpoint": str(spec.get("checkpoint", "best")),
            }
        if not self._entries:
            raise ValueError("tenant registry names no tenants")
        self._lock = san_lock("TenantRegistry._lock")
        # tenant -> (host TrainState, fingerprint); populated lazily
        self._masters: Dict[str, Tuple[TrainState, str]] = {}
        self.template: Optional[TrainState] = None
        # the model's (C, H, W) before the head: the JAX -> port conversion
        self.feature_shape = feature_shape
        self.loads = 0

    # -- construction ----------------------------------------------------

    @classmethod
    def from_yaml(cls, path: str) -> "TenantRegistry":
        with open(path) as f:
            doc = yaml.safe_load(f)
        if not isinstance(doc, dict) or not isinstance(doc.get("tenants"), dict):
            raise ValueError(f"tenant registry {path}: expected a top-level 'tenants' mapping")
        # relative run_dirs resolve against the registry file's directory,
        # so a registry travels with the run tree it names
        return cls(doc["tenants"], base_dir=os.path.dirname(os.path.abspath(path)))

    @classmethod
    def discover(cls, serving_cfg, run_dir: Optional[str] = None) -> Optional["TenantRegistry"]:
        """The two registry sources, explicit path winning. None = the
        single-tenant mode."""
        explicit = getattr(serving_cfg, "tenant_registry", None)
        if explicit:
            return cls.from_yaml(explicit)
        if run_dir:
            auto = os.path.join(run_dir, "tenants.yaml")
            if os.path.exists(auto):
                return cls.from_yaml(auto)
        return None

    # -- lookup ----------------------------------------------------------

    def tenants(self) -> Tuple[str, ...]:
        return tuple(sorted(self._entries))

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._entries

    def _resolve_run_dir(self, tenant: str) -> str:
        run_dir = self._entries[tenant]["run_dir"]
        if not os.path.isabs(run_dir) and self.base_dir:
            run_dir = os.path.join(self.base_dir, run_dir)
        return run_dir

    def host_state(self, tenant: str) -> Tuple[TrainState, str]:
        """(host-RAM master ``TrainState``, checkpoint fingerprint) for one
        tenant, loaded on first use and cached (masters are immutable)."""
        if tenant not in self._entries:
            raise KeyError(f"unknown tenant {tenant!r}")
        with self._lock:
            cached = self._masters.get(tenant)
            if cached is not None:
                return cached
            if self.feature_shape is None:
                raise ValueError(
                    f"tenant {tenant!r}: the registry needs the model's feature_shape to convert a "
                    "checkpoint to the port's layout (the engine sets it)"
                )
            save_dir = os.path.join(self._resolve_run_dir(tenant), "saved_models")
            idx = self._entries[tenant]["checkpoint"]
            if idx == "best" and not ckpt.checkpoint_exists(save_dir, "best"):
                idx = "latest"
            inf, _ = ckpt.load_for_inference(save_dir, idx)
            served = state_from_jax(inf.params, inf.bn_state, inf.inner_hparams, self.feature_shape, device="cpu")
            if torch.cuda.is_available():
                # page-locked host leaves: a page-in is an asynchronous copy
                served = tuple(tree_map(lambda t: t.pin_memory(), tree) for tree in served)
            state = TrainState(*served, opt_state=None, step=torch.as_tensor(np.asarray(inf.step), dtype=torch.int64))
            if self.template is not None and _tree_shapes(state) != _tree_shapes(self.template):
                raise ValueError(
                    f"tenant {tenant!r}: checkpoint structure differs from the fleet master — it "
                    "cannot share the shape-keyed compiled programs (serve it from its own fleet)"
                )
            self._masters[tenant] = (state, inf.fingerprint)
            self.loads += 1
            return self._masters[tenant]

    def fingerprint(self, tenant: str) -> str:
        return self.host_state(tenant)[1]

    def hosted_fingerprints(self) -> Dict[str, str]:
        """tenant -> fingerprint for masters ALREADY in host RAM (no loads
        triggered) — the drain spill's reverse map: only a loaded tenant
        can have adapted sessions in any cache."""
        with self._lock:
            return {t: fp for t, (_, fp) in self._masters.items()}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"tenants": len(self._entries), "hosted": len(self._masters), "loads": self.loads}


def synthetic_registry(tenant_ids, state: TrainState, root: str, seed: int = 0, *, feature_shape) -> TenantRegistry:
    """N deterministically-perturbed copies of ``state`` saved as real
    format-2 checkpoints under ``root`` (one run dir per tenant), behind a
    TenantRegistry. The perturbation is drawn in the JAX layout and leaf
    order with the JAX package's seeds, so both packages'
    ``synthetic_registry`` over one master (carried across with
    ``utils/interop.py``) write the same tenant parameters."""
    master = params_to_jax(state.params, feature_shape)
    entries: Dict[str, Dict[str, Any]] = {}
    for i, tenant in enumerate(tenant_ids):
        rng = np.random.default_rng((int(seed) << 8) + i + 1)

        def _perturb(a):
            if not np.issubdtype(a.dtype, np.floating):
                return a
            return a + (0.01 * rng.standard_normal(a.shape)).astype(a.dtype)

        # tree_map walks sorted keys: jax.tree's leaf order, so the draws
        # land on the same leaves as the JAX package's
        params = params_from_jax(tree_map(_perturb, master), feature_shape, device="cpu")
        run_dir = os.path.join(root, str(tenant))
        save_dir = os.path.join(run_dir, "saved_models")
        ckpt.save_named(save_dir, state._replace(params=params), {"epoch": 0}, "latest", feature_shape=feature_shape)
        entries[str(tenant)] = {"run_dir": run_dir, "checkpoint": "latest"}
    return TenantRegistry(entries, feature_shape=feature_shape)
