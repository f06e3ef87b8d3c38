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

Fault seams (``resilience/faults.py``): ``serving.dispatch`` fires at the
top of every adapt and predict flush, ``serving.refine`` at every refine
flush (``nan-loss`` there hands the frontend's guard non-finite weights).

PyTorch runs eagerly and compiles nothing, so the buckets here bound the
set of shapes the card sees: the first dispatch of a shape pays cuDNN's
algorithm choice and the allocator's first blocks. Strict mode
(``Config.strict_recompile_guard`` or ``strict=True``;
``utils/strictmode.py``) notes every flush's ``(kind, bucket, batch)``
before it dispatches and raises on a key outside
``serving_planned_programs``. :meth:`AdaptationEngine.prewarm` dispatches
the whole planned grid once, on zero inputs, and seals the guard, after
which any first-seen key is a violation. With a compile ledger
(``compile_ledger=``, or the frontend's), the first dispatch of each planned
``(kind, bucket, batch)`` is a ledger entry of its seconds, total only, as
the JAX ledger's guard-fed entries are: ``serve_adapt``, ``serve_refine``,
``serve_predict`` under ``strategy_kind``'s spelling, with the replica's tag.
Refine sessions (the guard, lineage and spill) live in the frontend
(``serving/server.py``).
"""

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, ServingConfig, kind_base, kind_strategy, load_config, strategy_kind
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
        strict: Optional[bool] = None,
        compile_ledger=None,
    ):
        self.system = system
        self.cfg = system.cfg
        self.device = system.device
        self.serving = serving_cfg or self.cfg.serving
        # the strategy menu; the first entry is the default
        self.strategies = tuple(self.serving.strategies)
        # span tracer of the dispatches (observability/trace.py)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # the fault seams' injector: inert unless a drill is named
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
        # compile ledger (observability/compile_ledger.py): when set (ctor
        # parameter, or attribute assignment before the first request: the
        # frontend attaches a collector-only ledger when telemetry is on),
        # each planned shape's first dispatch is timed into it
        self.compile_ledger = compile_ledger
        # strict mode (Config.strict_recompile_guard / explicit ``strict=``):
        # the bucket tables declare the whole program family up front; a
        # request that would dispatch outside it (an oversize support/query
        # set slipping past the buckets) raises instead of silently paying
        # a first dispatch on the serving hot path
        self.recompile_guard = None
        strict = self.cfg.strict_recompile_guard if strict is None else strict
        if strict:
            from ..utils.strictmode import RecompileGuard, serving_planned_programs

            self.recompile_guard = RecompileGuard(planned=serving_planned_programs(self.serving), name="serving-engine")

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
            strict=self.recompile_guard is not None, compile_ledger=self.compile_ledger,
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
        if self.recompile_guard is not None:
            out["recompile_guard"] = self.recompile_guard.snapshot()
        if self.compile_ledger is not None:
            out["compile_ledger"] = self.compile_ledger.summary()
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

    def _note_program(self, base: str, strategy: str, bucket: int, b: int) -> None:
        """Strict mode: the flush's program key, noted before it dispatches."""
        if self.recompile_guard is not None:
            self.recompile_guard.note((strategy_kind(base, strategy), bucket, b))

    def _first_dispatch(self, shapes: set, base: str, strategy: str, bucket: int, b: int, call: Callable) -> Callable:
        """Count the flush's shape among ``shapes``; the first dispatch of a
        shape is timed into the compile ledger (total only)."""
        first = (strategy, bucket, b) not in shapes
        shapes.add((strategy, bucket, b))
        ledger = self.compile_ledger
        if ledger is None or not first:
            return call
        program = (f"{strategy_kind('serve_' + base, strategy)}{self.ledger_tag}", bucket, b)

        def timed():
            t0 = time.perf_counter()
            out = call()
            ledger.record(program, total_s=time.perf_counter() - t0)
            return out

        return timed

    def _adapt_call(self, state, xs, ys, ws, strategy: str, bucket: int, b: int) -> Callable:
        """One adapt flush as a call: noted, then counted among the shapes."""
        self._note_program("adapt", strategy, bucket, b)
        if strategy == "protonet":
            call = lambda: self.system.protonet_adapt(state, xs, ys, support_weight=ws)  # noqa: E731
        else:
            call = lambda: self.system.adapt_fast_weights(  # noqa: E731
                state, xs, ys, num_steps=self.num_steps, support_weight=ws, strategy=strategy)
        return self._first_dispatch(self._adapt_shapes, "adapt", strategy, bucket, b, call)

    def _refine_call(self, state, stacked_fw, xs, ys, ws, strategy: str, bucket: int, b: int) -> Callable:
        self._note_program("refine", strategy, bucket, b)
        call = lambda: self.system.refine_fast_weights(  # noqa: E731
            state, stacked_fw, xs, ys, num_steps=self.num_steps, support_weight=ws, strategy=strategy)
        return self._first_dispatch(self._refine_shapes, "refine", strategy, bucket, b, call)

    def _predict_call(self, state, stacked, xs, ws, strategy: str, bucket: int, b: int) -> Callable:
        """One predict flush as a call; the call returns host probabilities
        (the flush's one device-to-host copy)."""
        self._note_program("predict", strategy, bucket, b)
        system = self.system

        def call():
            if strategy == "protonet":
                logits = system.protonet_predict_logits(state.params, state.bn_state, stacked, xs, ws)
            else:
                logits = system.predict_logits(stacked, state.bn_state, xs, ws)
            return torch.softmax(logits, dim=-1).cpu().numpy()

        return self._first_dispatch(self._predict_shapes, "predict", strategy, bucket, b, call)

    def adapt_batch(self, items: List[Tuple[Any, Any]], ctxs=None, strategy: Optional[str] = None,
                    tenant: Optional[str] = None):
        """Adapt a group of support sets ``(x_support, y_support)`` in one
        task-batched call; returns one adapted tree per item (tensors on
        the engine's device): fast weights, or under ``protonet`` a
        prototype table. ``tenant`` names the master the whole group adapts
        against (None: the engine's own)."""
        strategy = validate_request_strategy(strategy, self.strategies)
        state = self._tenant_state(tenant)
        self.injector.fire("serving.dispatch")
        xs, ys, ws, bucket, b = self._support_flush(items)
        n = len(items)
        call = self._adapt_call(state, xs, ys, ws, strategy, bucket, b)
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
        :meth:`adapt_batch`. Fires the ``serving.refine`` seam: ``nan-loss``
        returns non-finite refined weights, the poisoned-refinement drill
        the frontend's rollback guard must catch."""
        strategy = validate_request_strategy(strategy, self.strategies)
        if strategy == "protonet":
            raise ValueError("protonet has no refine rollout: recompute the prototypes with adapt_batch")
        state = self._tenant_state(tenant)
        fault = self.injector.fire("serving.refine")
        xs, ys, ws, bucket, b = self._support_flush([(x, y) for _, x, y in items])
        stacked_fw = self._stack_trees([fw for fw, _, _ in items], b)
        n = len(items)
        call = self._refine_call(state, stacked_fw, xs, ys, ws, strategy, bucket, b)
        stacked = self._dispatch("serve.refine_dispatch", ctxs, strategy, n, bucket, call, tenant)
        out = self._split(stacked, n)
        if fault == "nan-loss":
            # poisoned-refinement drill: hand the guard non-finite weights
            out = [tree_map(lambda a: torch.full_like(a, float("nan")), t) for t in out]
        return out

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
        self.injector.fire("serving.dispatch")
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
        stacked = self._stack_trees([fw for fw, _ in items], b)
        call = self._predict_call(state, stacked, xs, ws, strategy, bucket, b)
        probs = self._dispatch("serve.predict_dispatch", ctxs, strategy, n, bucket, call, tenant)
        return [probs[i, : sizes[i]] for i in range(n)]

    def predict(self, fast_weights, x_query, strategy: Optional[str] = None,
                tenant: Optional[str] = None) -> np.ndarray:
        """Single-request convenience wrapper over :meth:`predict_batch`."""
        return self.predict_batch([(fast_weights, x_query)], strategy=strategy, tenant=tenant)[0]

    # ------------------------------------------------------------------
    # the serving prewarm
    # ------------------------------------------------------------------

    def _prewarm_jobs(self, image_shape) -> List[Tuple[str, Callable]]:
        """One job per planned ``(kind, bucket, batch)``: the flush it
        names, on zero inputs of its shapes, through the ``_adapt_call``,
        ``_refine_call`` and ``_predict_call`` the request path uses (they
        note the keys). Support
        labels cycle through the classes and every sample is real (weight
        1), so no flush sees an empty class; predict and refine start from
        the engine's own params with the task axis, a prototype table of
        zeros under protonet. Tenant mode warms against the template: the
        one shape-keyed grid serves every tenant."""
        from ..core.strategies import protonet_prototype_shape
        from ..utils.strictmode import serving_planned_programs

        h, w, c = image_shape or self.cfg.image_shape
        state = self.state
        jobs: List[Tuple[str, Callable]] = []
        for key in sorted(serving_planned_programs(self.serving), key=repr):
            kind, bucket, b = key
            base, strategy = kind_base(kind), kind_strategy(kind)
            xs = np.zeros((b, bucket, h, w, c), np.float32)
            ws = np.ones((b, bucket), np.float32)
            name = f"serve_{kind}{self.ledger_tag}/{bucket}/{b}"
            if base == "predict":
                if strategy == "protonet":
                    fw = {"prototypes": torch.zeros((b,) + tuple(protonet_prototype_shape(self.num_classes)),
                                                    device=self.device)}
                else:
                    fw = self._stack_trees([state.params], b)
                job = (lambda fw=fw, xs=xs, ws=ws, st=strategy, bk=bucket, bb=b:
                       self._predict_call(state, fw, xs, ws, st, bk, bb)())
            else:
                ys = np.tile(np.arange(bucket, dtype=np.int32) % self.num_classes, (b, 1))
                if base == "adapt":
                    job = (lambda xs=xs, ys=ys, ws=ws, st=strategy, bk=bucket, bb=b:
                           self._adapt_call(state, xs, ys, ws, st, bk, bb)())
                else:  # refine
                    fw = self._stack_trees([state.params], b)
                    job = (lambda fw=fw, xs=xs, ys=ys, ws=ws, st=strategy, bk=bucket, bb=b:
                           self._refine_call(state, fw, xs, ys, ws, st, bk, bb)())
            jobs.append((name, job))
        return jobs

    def _warm_one(self, job: Callable) -> None:
        job()
        if self.device.type == "cuda":
            # the program's time is its work on the card, not its launch
            torch.cuda.synchronize(self.device)

    def prewarm(
        self,
        max_workers: Optional[int] = None,
        compile_timeout_s: Optional[float] = None,
        image_shape: Optional[Tuple[int, int, int]] = None,
        on_program=None,
    ) -> Dict[str, Any]:
        """Dispatch the full serving grid once before the first request:
        the exact ``serving_planned_programs`` set the strict guard pins,
        (adapt | refine | predict) x shape bucket x task-batch bucket, each
        on zero inputs of its planned shapes through the engine's own flush
        functions. The eager counterpart of the JAX engine's AOT prewarm,
        which compiles the grid and runs nothing: here the first dispatch of
        each shape pays cuDNN's algorithm choice and the allocator's first
        blocks, so that no request pays it. Nothing is kept: no result, no
        cache or session entry, no change to the engine's state; the fault
        seams do not fire and no dispatch span is recorded. Then the strict
        guard is sealed (``mark_prewarmed``).

        The jobs run inline, one after another. ``max_workers`` and
        ``compile_timeout_s`` keep the JAX signature and are ignored: the
        JAX engine compiles programs in parallel under a per-program
        timeout, but an eager engine dispatches to one card, where dispatch
        from several threads serializes and gains nothing, and a timed-out
        dispatch would go on touching the engine after the guard is sealed.
        ``image_shape`` overrides the config's dataset shape for engines
        serving hand-built models. ``on_program(name)`` is called as each
        program settles. The JAX
        ``store`` (serialized executables) has no torch counterpart: an
        eager program has nothing to serialize, so there is no such
        parameter. Returns the JAX summary keys: ``programs``, ``seconds``,
        ``errors``, the per-program table ``by_program`` (with each
        program's dispatch seconds) and the cache counters, which stay 0."""
        del max_workers, compile_timeout_s
        jobs = self._prewarm_jobs(image_shape)
        t0 = time.perf_counter()
        seconds: Dict[str, float] = {}
        errors: Dict[str, str] = {}
        for name, job in jobs:
            t = time.perf_counter()
            try:
                self._warm_one(job)
            except Exception as exc:  # noqa: BLE001 — contained per program
                errors[name] = f"{type(exc).__name__}: {exc}"
            seconds[name] = time.perf_counter() - t
            if on_program is not None:
                on_program(name)
        by_program: Dict[str, Dict[str, Any]] = {}
        for name, _ in jobs:
            by_program[name] = {"total_s": round(seconds[name], 6), "cache_hit": False,
                                "loaded": False, "stored": False, "already_warm": False}
            if name in errors:
                by_program[name]["error"] = errors[name]
        summary = {
            "programs": len(jobs),
            "seconds": round(time.perf_counter() - t0, 3),
            "compile_s": None,
            "cache_hits": 0,
            "store_hits": 0,
            "already_warm": 0,
            "errors": len(errors),
            "by_program": by_program,
        }
        if self.recompile_guard is not None:
            # the contract flip: the planned family is now declared complete
            self.recompile_guard.mark_prewarmed()
        return summary
