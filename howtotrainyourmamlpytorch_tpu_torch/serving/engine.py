"""The adaptation engine: a model state as request entry points, adapt,
refine and predict (JAX package ``serving/engine.py``).

``adapt_batch`` runs the first-order inner loop for a group of support sets
and returns one adapted-weight tree per request; ``refine_batch`` runs it
again from each request's earlier adapted weights; ``predict_batch``
forwards each request's queries through its own adapted weights and returns
softmax probabilities. Requests are padded to the same shape buckets as in
the JAX engine: the support/query size up to the smallest configured bucket
(padded samples carry zero ``sample_weight``, which masks them out of the
support loss and of the transductive-BN statistics, so bucketing never
changes predictions), and the task batch up to a power of two (by repeating
the last request). One flush is one task-batched call of ``MAMLSystem``, so
with ``use_pallas_inner_update`` every inner step of a flush is one launch
of the fused-update kernel.

Strategies (``core/strategies.py``): a request names one of
``serving.strategies`` (``None``: the first). ``maml++`` and ``fomaml``
adapt every leaf, ``anil`` the head only (the fused update runs over the
head's leaves); ``protonet`` adapts to a prototype table
``{"prototypes": [n_way, n_way]}`` and predicts through the master params.
A flush never mixes strategies. Each dispatch is a span of ``tracer``
(``serve.adapt_dispatch``, ``serve.refine_dispatch``,
``serve.predict_dispatch``); the request contexts ``ctxs`` get the dispatch
seconds and their trace flows end there.

Multi-tenant mode (``serving/registry.py``, ``serving/tenancy.py``): with a
``registry`` every dispatch names a tenant (``None``: the engine's own
checkpoint) and runs against that tenant's master, which the engine's
``WeightPager`` pages onto the card. A flush never mixes tenants.
``clone_for_device`` makes a replica of the engine on another card
(``serving/pool.py``).

PyTorch runs eagerly and compiles nothing, so the buckets here only bound
the set of shapes the card sees. Left out: the fault drills (the injector
is inert, ROADMAP.md A9), the compile ledger and strict guard (A10).
Refine sessions (the guard, lineage and spill) live in the frontend
(``serving/server.py``).
"""

import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, ServingConfig, load_config
from ..core.maml import MAMLSystem
from ..core.strategies import validate_request_strategy
from ..core.train_state import TrainState
from ..experiment import checkpoint as ckpt
from ..observability.context import flow_end
from ..observability.trace import NULL_TRACER
from ..ops import fused_update
from ..resilience.faults import injector_from
from ..utils.interop import state_from_jax
from ..utils.trees import tree_map
from .registry import TenantRegistry
from .tenancy import WeightPager


def _bucket_for(size: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= size; an oversize request keeps its exact shape."""
    for b in buckets:
        if size >= 0 and b >= size:
            return b
    return size


def _batch_bucket(n: int, max_batch: int) -> int:
    """Round a task-batch size up to the next power of two (capped at
    ``max_batch``)."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def _pad_axis0(arr: np.ndarray, target: int) -> np.ndarray:
    if arr.shape[0] == target:
        return arr
    pad = np.zeros((target - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _weights(sizes: Sequence[int], bucket: int) -> List[np.ndarray]:
    return [
        np.concatenate([np.ones(s, np.float32), np.zeros(bucket - s, np.float32)])
        for s in sizes
    ]


class AdaptationEngine:
    """Wraps a ``MAMLSystem`` and a model state (a ``TrainState`` on the
    system's device, or a ``checkpoint.InferenceState`` in the JAX layout)
    as a request-serving engine."""

    def __init__(
        self,
        system: MAMLSystem,
        state,
        serving_cfg: Optional[ServingConfig] = None,
        fingerprint: Optional[str] = None,
        tracer=None,
        injector=None,
        ledger_tag: str = "",
        registry: Optional[TenantRegistry] = None,
    ):
        self.system = system
        self.cfg = system.cfg
        self.device = system.device
        self.serving = serving_cfg or self.cfg.serving
        # the strategy menu; the first entry is the default
        self.strategies = tuple(self.serving.strategies)
        # span tracer of the dispatches (observability/trace.py)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # the fault seams' injector: inert, and a named drill raises (A9)
        self.injector = injector if injector is not None else injector_from(self.cfg.resilience)
        # a fleet replica's tag ("@r1", serving/pool.py)
        self.ledger_tag = str(ledger_tag)
        if isinstance(state, ckpt.InferenceState):
            fingerprint = fingerprint or state.fingerprint
            params, bn_state, hparams = state_from_jax(
                state.params, state.bn_state, state.inner_hparams,
                system.model.feature_shape, device=self.device,
            )
            state = TrainState(
                params=params,
                bn_state=bn_state,
                inner_hparams=hparams,
                opt_state=None,
                step=torch.as_tensor(state.step, dtype=torch.int64, device=self.device),
            )
        self.state: TrainState = state
        self.fingerprint = fingerprint or "live"
        # multi-tenant mode: the pager is per engine, so each fleet replica
        # owns its card's tenant residency; the engine's own state is the
        # pager's template (never paged, never counted)
        self.registry = registry
        self.pager: Optional[WeightPager] = None
        if registry is not None:
            registry.template = self.state
            registry.feature_shape = system.model.feature_shape
            self.pager = WeightPager(
                registry,
                self.state,
                device=self.device,
                budget_bytes=self.serving.tenant_budget_bytes,
                min_headroom_frac=self.serving.tenant_min_headroom_frac,
            )
        self.num_steps = self.serving.adapt_steps or self.cfg.number_of_evaluation_steps_per_iter
        self.num_classes = self.cfg.num_classes_per_set
        # (strategy, padded size, task-batch bucket) shapes served so far
        self._adapt_shapes = set()
        self._predict_shapes = set()
        self._refine_shapes = set()

    @classmethod
    def from_run_dir(
        cls,
        run_dir: str,
        checkpoint_idx="best",
        cfg: Optional[Config] = None,
        system: Optional[MAMLSystem] = None,
        device=None,
    ) -> "AdaptationEngine":
        """An engine over a run directory the JAX package wrote:
        ``config.yaml`` + ``saved_models/train_model_{idx}``.
        ``checkpoint_idx='best'`` falls back to 'latest' when no best-val
        checkpoint exists. ``device`` is used only when ``system`` is None.
        A tenant registry (``serving.tenant_registry``, or ``tenants.yaml``
        in the run directory) puts the engine in multi-tenant mode."""
        if cfg is None:
            cfg = load_config(os.path.join(run_dir, "config.yaml"))
        # the device is settled before the checkpoint is read
        system = system or MAMLSystem(cfg, device=device)
        save_dir = os.path.join(run_dir, "saved_models")
        if checkpoint_idx == "best" and not ckpt.checkpoint_exists(save_dir, "best"):
            checkpoint_idx = "latest"
        state, _ = ckpt.load_for_inference(save_dir, checkpoint_idx)
        registry = TenantRegistry.discover(cfg.serving, run_dir=run_dir)
        engine = cls(system, state, serving_cfg=cfg.serving, registry=registry)
        # the frontend spills and rehydrates sessions under it
        engine.save_dir = save_dir
        return engine

    def clone_for_device(self, device, index: int) -> "AdaptationEngine":
        """A replica of this engine on ``device`` (``serving/pool.py``): a
        ``MAMLSystem`` over the same config and model functions bound to
        that card, the state copied there, and the same fingerprint,
        injector, tracer and registry. The clone's tag is ``@r<index>`` and
        it has a pager of its own (each card owns its tenant residency)."""
        system = MAMLSystem(self.cfg, model=self.system.model, device=device)
        move = lambda t: t.to(system.device)  # noqa: E731
        state = TrainState(
            params=tree_map(move, self.state.params),
            bn_state=tree_map(move, self.state.bn_state),
            inner_hparams=tree_map(move, self.state.inner_hparams),
            opt_state=None,
            step=self.state.step,
        )
        clone = AdaptationEngine(
            system, state, serving_cfg=self.serving, fingerprint=self.fingerprint, tracer=self.tracer,
            injector=self.injector, ledger_tag=f"@r{index}", registry=self.registry,
        )
        # replicas of a run-dir engine spill and rehydrate sessions alike
        if getattr(self, "save_dir", None):
            clone.save_dir = self.save_dir
        return clone

    def compile_counts(self) -> Dict[str, Any]:
        """The shape grid served so far, the precision policy, the strategy
        menu, and the fused-update kernel's launch count (process-wide, since
        the last ``ops.fused_update.reset_launch_counts()``). The refine
        shapes only under ``serving.refine_enabled``, as the JAX package
        reports its refine programs."""
        out = {
            "adapt_shapes": len(self._adapt_shapes),
            "predict_shapes": len(self._predict_shapes),
            "precision": self.system.precision.name,
            "strategies": list(self.strategies),
            "fused_sgd_launches": fused_update.launch_counts["fused_sgd"],
        }
        if self.serving.refine_enabled:
            out["refine_programs"] = len(self._refine_shapes)
        if self.registry is not None:
            # tenant mode: the same shapes serve every tenant's master
            out["tenants"] = list(self.registry.tenants())
        return out

    def support_bucket(self, size: int) -> int:
        return _bucket_for(size, self.serving.support_buckets)

    def query_bucket(self, size: int) -> int:
        return _bucket_for(size, self.serving.query_buckets)

    @staticmethod
    def _flatten_support(x_support, y_support) -> Tuple[np.ndarray, np.ndarray]:
        """Accept [n_way, k, H, W, C] or already-flat [S, H, W, C]. Labels
        are int32, as in the JAX package: ``support_digest`` hashes them."""
        x = np.asarray(x_support, np.float32)
        y = np.asarray(y_support, np.int32)
        if y.ndim == 2:
            x = x.reshape((-1,) + x.shape[2:])
            y = y.reshape(-1)
        return x, y

    def _tenant_state(self, tenant: Optional[str]) -> TrainState:
        """The master a dispatch runs against: the engine's own state, or
        the tenant's, paged onto the card by the pager."""
        if self.pager is None:
            if tenant is not None:
                raise ValueError(
                    f"request names tenant {tenant!r} but this engine has no "
                    "tenant registry (serving.tenant_registry)"
                )
            return self.state
        return self.pager.resident(tenant)

    @staticmethod
    def _dispatch_flows(ctxs):
        """Flow-finish pairs for the dispatch span: the request arcs this
        device call ends (observability/context.py)."""
        return flow_end(ctxs) if ctxs else None

    @staticmethod
    def _stamp_dispatch(ctxs, seconds: float) -> None:
        """Every request of a flush shares its one device call, so each
        carries the call's full duration."""
        for c in ctxs or ():
            if c is not None:
                c.dispatch_s = seconds

    def _dispatch(self, name: str, ctxs, strategy: str, n: int, bucket: int, call, tenant: Optional[str] = None):
        """``call()`` under the dispatch span ``name``; the span and the
        request contexts get its wall seconds (up to the first
        synchronisation: predict copies to the host inside ``call``)."""
        span_kw = dict(batch=n, bucket=bucket, strategy=strategy)
        if tenant is not None:
            span_kw["tenant"] = tenant
        t0 = time.monotonic()
        with self.tracer.span(name, flows=self._dispatch_flows(ctxs), **span_kw):
            out = call()
        self._stamp_dispatch(ctxs, time.monotonic() - t0)
        return out

    def _support_flush(self, supports):
        """Padded support sets of a flush -> (xs, ys, ws, bucket, task-batch
        bucket), the last request repeated up to the task-batch bucket."""
        flat = [self._flatten_support(x, y) for x, y in supports]
        sizes = [x.shape[0] for x, _ in flat]
        bucket = self.support_bucket(max(sizes))
        xs = [_pad_axis0(x, bucket) for x, _ in flat]
        ys = [_pad_axis0(y, bucket) for _, y in flat]
        ws = _weights(sizes, bucket)
        b = _batch_bucket(len(supports), self.serving.max_batch_size)
        while len(xs) < b:  # pad the task axis by replicating the last task
            xs.append(xs[-1]); ys.append(ys[-1]); ws.append(ws[-1])
        return np.stack(xs), np.stack(ys), np.stack(ws), bucket, b

    @staticmethod
    def _stack_trees(trees, b: int):
        """One request's tree per item, the last repeated up to ``b`` ->
        one tree with a leading task axis."""
        trees = list(trees) + [trees[-1]] * (b - len(trees))
        return tree_map(lambda *leaves: torch.stack(leaves), *trees)

    @staticmethod
    def _split(stacked, n: int):
        """A flush's stacked tree -> one tree per request, each leaf a copy
        that owns its memory (as JAX's ``a[i]`` does): a view would keep the
        whole flush alive in the adapted-weight cache, past its byte
        budget."""
        return [tree_map(lambda a, i=i: a[i].clone(), stacked) for i in range(n)]

    def adapt_batch(self, items: List[Tuple[Any, Any]], ctxs=None, strategy: Optional[str] = None,
                    tenant: Optional[str] = None):
        """Adapt a group of support sets ``(x_support, y_support)`` in one
        task-batched call; returns one adapted tree per item (tensors on
        the engine's device): fast weights, or under ``protonet`` a
        prototype table. ``tenant`` names the master the whole group adapts
        against (None: the engine's own)."""
        strategy = validate_request_strategy(strategy, self.strategies)
        state = self._tenant_state(tenant)
        xs, ys, ws, bucket, b = self._support_flush(items)
        n = len(items)
        self._adapt_shapes.add((strategy, bucket, b))
        if strategy == "protonet":
            call = lambda: self.system.protonet_adapt(state, xs, ys, support_weight=ws)  # noqa: E731
        else:
            call = lambda: self.system.adapt_fast_weights(  # noqa: E731
                state, xs, ys, num_steps=self.num_steps, support_weight=ws, strategy=strategy)
        stacked = self._dispatch("serve.adapt_dispatch", ctxs, strategy, n, bucket, call, tenant)
        return self._split(stacked, n)

    def adapt(self, x_support, y_support, strategy: Optional[str] = None,
              tenant: Optional[str] = None):
        """Single-task convenience wrapper over :meth:`adapt_batch`."""
        return self.adapt_batch([(x_support, y_support)], strategy=strategy, tenant=tenant)[0]

    def refine_batch(self, items: List[Tuple[Any, Any, Any]], ctxs=None, strategy: Optional[str] = None,
                     tenant: Optional[str] = None):
        """Refine a group in one task-batched call: each item's rollout
        starts from its own earlier fast weights. ``items`` is a list of
        ``(fast_weights, x_support, y_support)``; returns one refined tree
        per item. ``protonet`` raises: a prototype table is recomputed by
        :meth:`adapt_batch`."""
        strategy = validate_request_strategy(strategy, self.strategies)
        if strategy == "protonet":
            raise ValueError("protonet has no refine rollout: recompute the prototypes with adapt_batch")
        state = self._tenant_state(tenant)
        xs, ys, ws, bucket, b = self._support_flush([(x, y) for _, x, y in items])
        stacked_fw = self._stack_trees([fw for fw, _, _ in items], b)
        n = len(items)
        self._refine_shapes.add((strategy, bucket, b))
        call = lambda: self.system.refine_fast_weights(  # noqa: E731
            state, stacked_fw, xs, ys, num_steps=self.num_steps, support_weight=ws, strategy=strategy)
        stacked = self._dispatch("serve.refine_dispatch", ctxs, strategy, n, bucket, call, tenant)
        return self._split(stacked, n)

    def refine(self, fast_weights, x_support, y_support, strategy: Optional[str] = None,
               tenant: Optional[str] = None):
        """Single-request convenience wrapper over :meth:`refine_batch`."""
        return self.refine_batch([(fast_weights, x_support, y_support)], strategy=strategy, tenant=tenant)[0]

    def predict_batch(self, items: List[Tuple[Any, Any]], ctxs=None, strategy: Optional[str] = None,
                      tenant: Optional[str] = None) -> List[np.ndarray]:
        """Forward a group of query batches, each through its own adapted
        tree (from the same strategy's adapt), in one task-batched call.
        ``items`` is a list of ``(adapted, x_query)``; returns per-item
        softmax probabilities ``[Q_i, num_classes]`` as host arrays, padding
        sliced off. Under ``protonet`` the queries embed through the master
        params and are scored against each item's prototype table."""
        strategy = validate_request_strategy(strategy, self.strategies)
        state = self._tenant_state(tenant)
        queries = [np.asarray(x, np.float32) for _, x in items]
        sizes = [q.shape[0] for q in queries]
        bucket = self.query_bucket(max(sizes))
        xs = [_pad_axis0(q, bucket) for q in queries]
        ws = _weights(sizes, bucket)
        n = len(items)
        b = _batch_bucket(n, self.serving.max_batch_size)
        while len(xs) < b:
            xs.append(xs[-1]); ws.append(ws[-1])
        xs, ws = np.stack(xs), np.stack(ws)
        self._predict_shapes.add((strategy, bucket, b))
        stacked = self._stack_trees([fw for fw, _ in items], b)
        system = self.system

        def call():
            if strategy == "protonet":
                logits = system.protonet_predict_logits(state.params, state.bn_state, stacked, xs, ws)
            else:
                logits = system.predict_logits(stacked, state.bn_state, xs, ws)
            # the flush's one device-to-host copy: predictions go back to clients
            return torch.softmax(logits, dim=-1).cpu().numpy()

        probs = self._dispatch("serve.predict_dispatch", ctxs, strategy, n, bucket, call, tenant)
        return [probs[i, : sizes[i]] for i in range(n)]

    def predict(self, fast_weights, x_query, strategy: Optional[str] = None,
                tenant: Optional[str] = None) -> np.ndarray:
        """Single-request convenience wrapper over :meth:`predict_batch`."""
        return self.predict_batch([(fast_weights, x_query)], strategy=strategy, tenant=tenant)[0]
