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
of the fused-update kernel (inside the program's graph on a card).

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

Programs (the JAX engine's ``_compiled_adapt``, ``_compiled_refine`` and
``_compiled_predict``): each flush ``(kind, strategy, support/query bucket,
task-batch bucket)`` runs one program of the engine's three tables
(``_adapt_programs``, ``_refine_programs``, ``_predict_programs``, keyed
``(strategy, bucket, b)`` as JAX's jit caches are), a
``core/programs.py::ServingCall``. On a card a program is one CUDA graph,
captured at the key's first flush (whose result is its warmup's) and
replayed after, so a flush is one replay: the flush's host arrays are
staged through page-locked memory into the program's static inputs, the
flush's master is copied into the static master unless it is the one
loaded last (tenant mode: every tenant runs the same programs, as the
master is a JAX program argument), and the outputs are copied out before
another flush may run (the adapted trees each own their memory; predict's
probabilities go to the host). The programs of one engine share one graph
pool, one capture stream and their static buffers (one per shape), and
one lock covers their builds and runs. A failed capture raises; only a key
outside the plan, first seen beside live traffic, runs eagerly after its
capture failed, with the reason in the ledger and in ``compile_counts()``.
On the CPU nothing is captured: the same programs run their static-buffer
path eagerly.

Strict mode (``Config.strict_recompile_guard`` or ``strict=True``;
``utils/strictmode.py``) notes every flush's ``(kind, bucket, batch)``
before it runs and raises on a key outside ``serving_planned_programs``.
:meth:`AdaptationEngine.prewarm` builds (on a card: captures) the whole
planned grid on zero inputs and seals the guard, after which any
first-seen key is a violation. With a compile ledger (``compile_ledger=``,
or the frontend's), each program's build is an entry priced by the flop
counter: ``serve_adapt``, ``serve_refine``, ``serve_predict`` under
``strategy_kind``'s spelling, with the replica's tag, its warmup and
capture seconds and the pool's bytes on a card.
Refine sessions (the guard, lineage and spill) live in the frontend
(``serving/server.py``).
"""

import contextlib
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, ServingConfig, kind_base, kind_strategy, load_config, strategy_kind
from ..core.maml import MAMLSystem
from ..core.programs import SYNC_GATE, ServingCall, StaticBuffers, _copy_into, tree_leaves_any
from ..core.strategies import validate_request_strategy
from ..core.train_state import TrainState
from ..experiment import checkpoint as ckpt
from ..observability.compile_ledger import program_name
from ..observability.context import flow_end
from ..observability.costs import pool_bytes
from ..observability.trace import NULL_TRACER
from ..ops import fused_update
from ..resilience.faults import injector_from
from ..utils.interop import state_from_jax
from ..utils.locks import san_lock
from ..utils.strictmode import serving_planned_programs
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
        # the program tables (JAX's _adapt_jit, _refine_jit, _predict_jit):
        # (strategy, padded size, task-batch bucket) -> ServingCall. One lock
        # covers a program's build and every run: the programs share the
        # static buffers, the graph pool and the capture stream, and the
        # batcher workers flush from several threads
        self._adapt_programs: Dict[Tuple[str, int, int], ServingCall] = {}
        self._predict_programs: Dict[Tuple[str, int, int], ServingCall] = {}
        self._refine_programs: Dict[Tuple[str, int, int], ServingCall] = {}
        self._tables = {"adapt": self._adapt_programs, "predict": self._predict_programs,
                        "refine": self._refine_programs}
        self._program_lock = san_lock("AdaptationEngine._program_lock")
        self._buffers = StaticBuffers(self.device)
        self._graph_pool = self._graph_stream = None
        # the static master every program reads, and the identity of the
        # master loaded into it (AdaptationEngine._load_master)
        self._static_master = None
        self._loaded = self._loaded_own = None
        self._planned = serving_planned_programs(self.serving)
        # program name -> why it runs eagerly on the card
        self._eager: Dict[str, str] = {}
        # compile ledger (observability/compile_ledger.py): when set (ctor
        # parameter, or attribute assignment before the first request: the
        # frontend attaches a collector-only ledger when telemetry is on),
        # each program's build is an entry in it
        self.compile_ledger = compile_ledger
        # strict mode (Config.strict_recompile_guard / explicit ``strict=``):
        # the bucket tables declare the whole program family up front; a
        # request that would dispatch outside it (an oversize support/query
        # set slipping past the buckets) raises instead of silently paying
        # a first dispatch on the serving hot path
        self.recompile_guard = None
        strict = self.cfg.strict_recompile_guard if strict is None else strict
        if strict:
            from ..utils.strictmode import RecompileGuard

            self.recompile_guard = RecompileGuard(planned=self._planned, name="serving-engine")

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
        it has a pager of its own (each card owns its tenant residency), and
        program tables of its own: its graphs are captured on its card, in
        a pool and on a stream of that card, at its own first flushes or
        prewarm."""
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
        """The JAX engine's counts: the programs built so far, the precision
        policy and the strategy menu (the refine programs only under
        ``serving.refine_enabled``), and the fused-update kernel's launch
        count (process-wide, since the last
        ``ops.fused_update.reset_launch_counts()``). A program that runs
        eagerly on the card is named in ``eager_programs`` with its
        reason. The tables are read without the program lock, which a
        capture holds for its seconds."""
        out = {
            "adapt_programs": len(self._adapt_programs),
            "predict_programs": len(self._predict_programs),
            "precision": self.system.precision.name,
            "strategies": list(self.strategies),
            "fused_sgd_launches": fused_update.launch_counts["fused_sgd"],
        }
        if self.serving.refine_enabled:
            out["refine_programs"] = len(self._refine_programs)
        if self._eager:
            out["eager_programs"] = dict(self._eager)
        if self.registry is not None:
            # tenant mode: the same programs serve every tenant's master
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

    def _master(self, tenant: Optional[str]):
        """The master a flush runs against and its identity: the engine's
        own state (None), or the tenant's, which the pager pages onto the
        card, with the page-in's serial. The pager runs outside the
        program lock: a page-in waits on the card."""
        if tenant is None:
            return self.state, (None, id(self.state))
        if self.pager is None:
            raise ValueError(
                f"request names tenant {tenant!r} but this engine has no "
                "tenant registry (serving.tenant_registry)"
            )
        state, serial = self.pager.resident_entry(tenant)
        return state, (tenant, serial)

    @staticmethod
    def _dispatch_flows(ctxs):
        """Flow-finish pairs for the dispatch span: the request arcs this
        device call ends (observability/context.py)."""
        return flow_end(ctxs) if ctxs else None

    @staticmethod
    def _stamp_dispatch(ctxs, seconds: float, program: str) -> None:
        """Every request of a flush shares its one device call, so each
        carries the call's full duration and its program's name."""
        for c in ctxs or ():
            if c is not None:
                c.dispatch_s = seconds
                c.program = program

    def _program_name(self, base: str, strategy: str, bucket: int, b: int) -> Tuple[str, int, int]:
        """The JAX engine's ledger key of a program."""
        return (f"{strategy_kind('serve_' + base, strategy)}{self.ledger_tag}", bucket, b)

    def _dispatch(self, name: str, ctxs, base: str, strategy: str, n: int, bucket: int, b: int, call,
                  tenant: Optional[str] = None):
        """``call()`` under the dispatch span ``name``; the span and the
        request contexts get its wall seconds (up to the first
        synchronisation: predict copies to the host inside ``call``)."""
        span_kw = dict(batch=n, bucket=bucket, strategy=strategy)
        if tenant is not None:
            span_kw["tenant"] = tenant
        t0 = time.monotonic()
        with self.tracer.span(name, flows=self._dispatch_flows(ctxs), **span_kw):
            out = call()
        self._stamp_dispatch(ctxs, time.monotonic() - t0, program_name(self._program_name(base, strategy, bucket, b)))
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
    def _split(stacked, n: int):
        """A flush's stacked tree -> one tree per request, each leaf a copy
        that owns its memory (as JAX's ``a[i]`` does): a view would keep the
        whole flush alive in the adapted-weight cache, past its byte
        budget, and the program's static outputs are overwritten by its
        next run. Under anil the body's leaves are views of the static
        master, copied here as well."""
        return [tree_map(lambda a, i=i: a[i].clone(), stacked) for i in range(n)]

    def _note_program(self, base: str, strategy: str, bucket: int, b: int) -> None:
        """Strict mode: the flush's program key, noted before it dispatches."""
        if self.recompile_guard is not None:
            self.recompile_guard.note((strategy_kind(base, strategy), bucket, b))

    # ------------------------------------------------------------------
    # the programs (JAX's _compiled_adapt, _compiled_refine, _compiled_predict)
    # ------------------------------------------------------------------

    def _program_fn(self, base: str, strategy: str) -> Callable:
        """The call a program of ``base`` under ``strategy`` runs:
        ``fn(master, inputs) -> outputs`` over the static buffers."""
        system, steps = self.system, self.num_steps
        if base == "adapt" and strategy == "protonet":
            return lambda st, inp: system.protonet_adapt(st, inp["xs"], inp["ys"], support_weight=inp["ws"])
        if base == "adapt":
            return lambda st, inp: system.adapt_fast_weights(
                st, inp["xs"], inp["ys"], num_steps=steps, support_weight=inp["ws"], strategy=strategy)
        if base == "refine":
            return lambda st, inp: system.refine_fast_weights(
                st, inp["fw"], inp["xs"], inp["ys"], num_steps=steps, support_weight=inp["ws"], strategy=strategy)

        def predict(st, inp):
            if strategy == "protonet":
                logits = system.protonet_predict_logits(st.params, st.bn_state, inp["fw"], inp["xs"], inp["ws"])
            else:
                logits = system.predict_logits(inp["fw"], st.bn_state, inp["xs"], inp["ws"])
            return torch.softmax(logits, dim=-1)

        return predict

    def _device_scope(self):
        return torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()

    def _graph_parts(self):
        """The engine's one graph pool and capture stream, shared by all of
        its programs (they never run at once) and apart from its system's
        (``MAMLSystem._graph_pool_handle``): a runner's graphs and an
        engine's can live in one process. None, None off a card."""
        if self.device.type != "cuda":
            return None, None
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_stream = torch.cuda.Stream(self.device)
        return self._graph_pool, self._graph_stream

    def _load_master(self, state, ident) -> None:
        """Under the program lock: the flush's master into the programs'
        static master, unless it is the one loaded last: the same tenant's
        page-in (the pager's serial: not evicted, re-paged or reloaded
        since), or the engine's own state object, kept alive here so that
        its identity is never another's. An address is never the test: the
        pager reuses memory after an eviction."""
        served = TrainState(params=state.params, bn_state=state.bn_state, inner_hparams=state.inner_hparams,
                            opt_state=None, step=None)
        if self._static_master is None:
            self._static_master = self._buffers.like("master", served)
        elif ident == self._loaded:
            return
        _copy_into(tree_leaves_any(self._static_master), tree_leaves_any(served))
        self._loaded = ident
        self._loaded_own = state if ident[0] is None else None

    def _stage(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """A flush's host array into the static input of its shape: through
        page-locked memory, asynchronously, on the card (the pinned block
        is not reused before the copy has run)."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        buf = self._buffers.get(name, src.shape, src.dtype)
        if buf.is_cuda:
            buf.copy_(src.pin_memory(), non_blocking=True)
        else:
            buf.copy_(src)
        return buf

    def _stage_trees(self, trees, b: int):
        """One request's tree per item, the last repeated up to ``b``,
        stacked into the static fast weights (one kernel per leaf)."""
        trees = list(trees) + [trees[-1]] * (b - len(trees))
        static = self._buffers.like("fw", trees[0], lead=(b,))
        for buf, leaves in zip(tree_leaves_any(static), zip(*(tree_leaves_any(t) for t in trees))):
            torch.stack(leaves, out=buf)
        return static

    def _build(self, base: str, strategy: str, bucket: int, b: int, inputs, phase: Optional[str]) -> ServingCall:
        """A new program on the staged inputs, recorded in the compile
        ledger (priced; its capture seconds and the pool's bytes on the
        card). A failed capture raises, except for a key outside the plan
        first seen beside live traffic: that key runs eagerly from then on,
        on the warmup's outputs first, with its reason in the ledger and in
        ``compile_counts()["eager_programs"]``."""
        pool, stream = self._graph_parts()
        program = ServingCall(self._program_fn(base, strategy), self._static_master, inputs, self._buffers,
                              self.device, pool, stream)
        name = self._program_name(base, strategy, bucket, b)
        try:
            program.build()
        except Exception as exc:
            warmed = program.outputs is not None
            what = "capture" if warmed else "warmup"
            self._record(name, phase, error=f"{what} failed: {type(exc).__name__}: {exc}")
            planned = (strategy_kind(base, strategy), bucket, b) in self._planned
            if not warmed or planned or phase == "prewarm":
                raise
            reason = f"capture failed beside live traffic: {type(exc).__name__}: {exc}"
            self._eager[program_name(name)] = reason
            print(f"serving engine: {program_name(name)} runs eagerly: {reason}", file=sys.stderr, flush=True)
            self._record(name, phase, graph=False, reason=reason)
            return program
        cost = program.cost
        if program.graph is not None:
            self._record(name, phase, lower_s=program.lower_s, compile_s=program.compile_s, flops=cost.get("flops"),
                         memory=program.memory, graph=True, cost_error=cost.get("error"))
        else:
            self._record(name, phase, total_s=program.lower_s, flops=cost.get("flops"), graph=False,
                         reason="no CUDA graph off a card", cost_error=cost.get("error"))
        return program

    def _record(self, name, phase: Optional[str], **entry) -> None:
        if self.compile_ledger is not None:
            self.compile_ledger.record(name, cold=True, phase=phase, **entry)

    def _flush(self, base: str, strategy: str, bucket: int, b: int, master, stage: Callable, finish: Callable,
               phase: Optional[str] = None):
        """One run of the program ``(strategy, bucket, b)`` of ``base``:
        noted (strict mode raises here, before anything runs), then under
        the program lock the master loaded, the inputs staged (``stage()``
        -> the static inputs), the program replayed, or built where it is
        new (its warmup is this flush), and ``finish(static outputs)``
        before another run may overwrite them. -> (finish's result, whether
        the program was built)."""
        self._note_program(base, strategy, bucket, b)
        table = self._tables[base]
        with self._device_scope(), self._program_lock:
            self._load_master(*master)
            inputs = stage()
            program = table.get((strategy, bucket, b))
            if program is None:
                program = table[(strategy, bucket, b)] = self._build(base, strategy, bucket, b, inputs, phase)
                return finish(program.outputs), True
            return finish(program.run()), False

    def _to_host(self, probs: torch.Tensor):
        """Under the program lock: the static probabilities' copy to the
        host enqueued -> a wait that returns the host array (outside the
        lock: the copy is ordered before any later run)."""
        if not probs.is_cuda:
            out = probs.clone().numpy()
            return lambda: out
        host = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=True)
        host.copy_(probs, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def wait():
            with SYNC_GATE.host_sync():
                done.synchronize()
            return host.numpy()

        return wait

    def adapt_batch(self, items: List[Tuple[Any, Any]], ctxs=None, strategy: Optional[str] = None,
                    tenant: Optional[str] = None):
        """Adapt a group of support sets ``(x_support, y_support)`` in one
        task-batched call; returns one adapted tree per item (tensors on
        the engine's device): fast weights, or under ``protonet`` a
        prototype table. ``tenant`` names the master the whole group adapts
        against (None: the engine's own)."""
        strategy = validate_request_strategy(strategy, self.strategies)
        master = self._master(tenant)
        self.injector.fire("serving.dispatch")
        xs, ys, ws, bucket, b = self._support_flush(items)
        n = len(items)

        def stage():
            return {"xs": self._stage("xs", xs), "ys": self._stage("ys", ys), "ws": self._stage("ws", ws)}

        call = lambda: self._flush("adapt", strategy, bucket, b, master, stage,  # noqa: E731
                                   lambda out: self._split(out, n))[0]
        return self._dispatch("serve.adapt_dispatch", ctxs, "adapt", strategy, n, bucket, b, call, tenant)

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
        master = self._master(tenant)
        fault = self.injector.fire("serving.refine")
        xs, ys, ws, bucket, b = self._support_flush([(x, y) for _, x, y in items])
        n = len(items)

        def stage():
            return {"fw": self._stage_trees([fw for fw, _, _ in items], b), "xs": self._stage("xs", xs),
                    "ys": self._stage("ys", ys), "ws": self._stage("ws", ws)}

        call = lambda: self._flush("refine", strategy, bucket, b, master, stage,  # noqa: E731
                                   lambda out: self._split(out, n))[0]
        out = self._dispatch("serve.refine_dispatch", ctxs, "refine", strategy, n, bucket, b, call, tenant)
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
        master = self._master(tenant)
        self.injector.fire("serving.dispatch")
        # parses the requests' host payloads (JSON-decoded lists or numpy
        # arrays), not device values  # graftlint: disable=GL110
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

        def stage():
            return {"fw": self._stage_trees([fw for fw, _ in items], b), "xs": self._stage("xs", xs),
                    "ws": self._stage("ws", ws)}

        call = lambda: self._flush("predict", strategy, bucket, b, master, stage, self._to_host)[0]()  # noqa: E731
        probs = self._dispatch("serve.predict_dispatch", ctxs, "predict", strategy, n, bucket, b, call, tenant)
        return [probs[i, : sizes[i]] for i in range(n)]

    def predict(self, fast_weights, x_query, strategy: Optional[str] = None,
                tenant: Optional[str] = None) -> np.ndarray:
        """Single-request convenience wrapper over :meth:`predict_batch`."""
        return self.predict_batch([(fast_weights, x_query)], strategy=strategy, tenant=tenant)[0]

    # ------------------------------------------------------------------
    # the serving prewarm
    # ------------------------------------------------------------------

    def _prewarm_jobs(self, image_shape) -> List[Tuple[str, Callable]]:
        """One job per planned ``(kind, bucket, batch)``: its program built
        (on the card, captured) on zero inputs of its shapes, through
        :meth:`_flush`, as a request builds it (the keys are noted).
        Support labels cycle through the classes and every sample is real
        (weight 1), so no warmup sees an empty class; predict and refine
        start from the engine's own params with the task axis, a prototype
        table of zeros under protonet. Tenant mode warms against the
        engine's own master: one program serves every tenant. The largest
        flushes (support or query bucket x task batch) are built first:
        the programs share one graph pool, and a later capture reuses the
        blocks an earlier one freed only where they are large enough."""
        from ..core.strategies import protonet_prototype_shape
        from ..utils.strictmode import serving_planned_programs

        h, w, c = image_shape or self.cfg.image_shape
        jobs: List[Tuple[str, Callable]] = []
        for key in sorted(serving_planned_programs(self.serving), key=lambda k: (-k[1] * k[2], repr(k))):
            kind, bucket, b = key
            base, strategy = kind_base(kind), kind_strategy(kind)
            if base == "predict" and strategy == "protonet":
                fw = {"prototypes": torch.zeros(protonet_prototype_shape(self.num_classes), device=self.device)}
            else:
                fw = self.state.params
            inputs = {"xs": np.zeros((b, bucket, h, w, c), np.float32), "ws": np.ones((b, bucket), np.float32)}
            if base != "predict":
                inputs["ys"] = np.tile(np.arange(bucket, dtype=np.int32) % self.num_classes, (b, 1))
            jobs.append((program_name(self._program_name(base, strategy, bucket, b)),
                         lambda base=base, st=strategy, bk=bucket, bb=b, inp=inputs, fw=fw:
                         self._warm_program(base, st, bk, bb, inp, fw)))
        return jobs

    def _warm_program(self, base: str, strategy: str, bucket: int, b: int, inputs, fw) -> Dict[str, Any]:
        """Build one program on ``inputs`` (and ``fw`` stacked where the
        program takes fast weights), its outputs dropped -> JAX's warm
        result keys and ``graph``."""

        def stage():
            staged = {name: self._stage(name, arr) for name, arr in inputs.items()}
            if base != "adapt":
                staged["fw"] = self._stage_trees([fw], b)
            return staged

        table = self._tables[base]
        warm = (strategy, bucket, b) in table
        if not warm:
            self._flush(base, strategy, bucket, b, self._master(None), stage, lambda out: None, phase="prewarm")
            if self.device.type == "cuda":
                # the program's seconds are its work on the card
                with SYNC_GATE.host_sync():
                    torch.cuda.synchronize(self.device)
        else:
            self._note_program(base, strategy, bucket, b)
        return {"program": program_name(self._program_name(base, strategy, bucket, b)), "already_warm": warm,
                "graph": table[(strategy, bucket, b)].graph is not None}

    def program_memory(self) -> Dict[str, Any]:
        """The bytes the programs hold on the card: the graph pool's
        (``costs.pool_bytes``; None off a card or before a capture) and the
        static buffers' (master, inputs and outputs, shared by every
        program)."""
        return {"pool_bytes": pool_bytes(self.device, self._graph_pool), "static_bytes": self._buffers.nbytes()}

    def prewarm(
        self,
        max_workers: Optional[int] = None,
        compile_timeout_s: Optional[float] = None,
        image_shape: Optional[Tuple[int, int, int]] = None,
        on_program=None,
    ) -> Dict[str, Any]:
        """Build the full serving grid before the first request and seal
        the guard: ``compile/aot.py::prewarm_serving``, where the JAX
        package keeps it. On the card every planned program is captured,
        as the JAX prewarm compiles it; nothing of the warmups is kept.
        ``on_program(name)`` is called as each program settles. The JAX
        ``store`` (serialized executables) has no torch counterpart: a CUDA
        graph holds one process's device addresses, so there is no such
        parameter."""
        from ..compile.aot import prewarm_serving

        return prewarm_serving(self, max_workers=max_workers, compile_timeout_s=compile_timeout_s,
                               image_shape=image_shape, on_program=on_program)
