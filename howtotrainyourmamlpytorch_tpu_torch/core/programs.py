"""Captured programs: a step callable as one CUDA graph, replayed per step
(the port's counterpart of ``jax.jit`` and its executable for the
multi-step programs of ``core/maml.py``).

The JAX package scans K train steps, or every eval batch, in one XLA
program, so that one dispatch pays the host's cost once. Eager PyTorch pays
it per kernel, and a ResNet-12 train step launches tens of thousands. Its
counterpart is a CUDA graph of the step, captured once and replayed without
Python. :class:`CapturedStep` is one graph of one step callable
``step(state, batch) -> (new_state or None, outputs)``:

- static input buffers: a copy of the state and of one batch, made outside
  the capture, so they live in the allocator's default pool for as long as
  the graph does;
- one warmup run on a side stream, on a throwaway copy of the state (the
  real state does not advance), under ``torch.cuda.set_sync_debug_mode("error")``
  so that a hidden host sync raises there instead of breaking the capture.
  That mode is one setting for the whole process, so a warmup holds
  :data:`SYNC_GATE` alone and the host syncs that may run beside one (a
  server's other threads) hold it shared. The warmup is priced by the flop
  counter (``observability/costs.py``);
- the capture, with the garbage collector paused (a dead graph destroyed
  inside a capture would invalidate it), into a memory pool and on a
  stream the caller passes
  (``core/maml.py`` shares one pool, ``torch.cuda.graph_pool_handle()``,
  and one capture stream among all of a system's graphs: they never run
  at once, and a pool each would hold each step's peak. The caching
  allocator reuses a pool's free blocks only for allocations on the
  stream that made them, so captures on streams of their own would not
  reuse each other's working set); at its end an in-graph ``copy_``
  writes the new state into the static state buffers, so the state is
  updated in place;
- :meth:`CapturedStep.replay`: batch k copied into the static batch on the
  stream, then ``graph.replay()``;
- :meth:`CapturedStep.dispatch`: a state that is not the graph's own is
  copied into the buffers first (so a rollback or a resume needs no special
  case), then one replay per batch; the outputs of each replay are copied
  out before the next, and the returned state is a view of the buffers.

Everything a replay reads or writes lives either in the static buffers or in
the graph's pool: the fused update's kernels (B1, B2) take bare pointers in
their launch parameters (``ops/fused_update.py::_prepare``), and the copies
and scratch they allocate during the capture are blocks of the pool that
the graph keeps. A wrapper under capture launches nothing, so it adds its
launch to ``fused_update.captured_counts``, not to ``launch_counts``; the
graph keeps its capture's tally (``launches``) and every replay adds it to
the launch counts (``fused_update.count_replay``), so the counts measure
what each replay ran. Their launches go to ``torch.cuda.current_stream()``,
which is the capture stream during the capture. B2's last-block ticket is
one ``__device__`` counter per card (``csrc/fused_sgd_bwd.cu``) that wraps
to 0 by itself, so replays on one stream are sound; two B2 launches at once
on two streams were already unsafe before graphs (a replay beside a serving
flush on another stream is such a pair) and stay so.

:class:`ServingCall` is the serving engine's counterpart (the JAX
engine's jitted bucket programs): one graph of one flush ``fn(master,
inputs) -> outputs`` with no state to advance, whose master, inputs and
outputs are :class:`StaticBuffers` the engine shares among its programs
(``serving/engine.py``); it captures with ``capture_error_mode=
"thread_local"``, since a server's other threads use the card meanwhile,
and the flush that builds it returns its warmup's outputs.

A failed capture raises: nothing falls back to eager (but for the serving
engine's unplanned keys, ``serving/engine.py``). On the CPU no graph
is captured; ``core/maml.py`` runs the K eager steps instead. On a mesh of
``[cuda:0] * (dp * mp)`` (``parallel/mesh.py``) the graph holds the sharded
step (the dp x mp step where the state is split over ``mp``: B1 and B2
once per mesh entry per inner step), its static buffers the whole state,
which the step places on the mesh again, and every shard of the batch; a
mesh over several cards or processes runs eager, decided from the mesh
before any capture (:class:`GraphProgram`).
:class:`GraphProgram` keeps one :class:`CapturedStep` per batch signature
and records each capture in the compile ledger
(``observability/compile_ledger.py``).
"""

import contextlib
import gc
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from ..observability.costs import pool_bytes, priced_call, program_memory
from ..ops import fused_update
from ..parallel.mesh import Replicated, ShardedBatch, place_like, unreplicate


def tree_leaves_any(tree) -> List[Any]:
    """The leaves of a tree of dicts (sorted keys), tuples, lists,
    NamedTuples (a ``TrainState``), a mesh's sharded batches (their
    shards) and placed states (the whole state's: the first replica, or
    its split leaves gathered), in a fixed order."""
    if isinstance(tree, ShardedBatch):
        return tree_leaves_any(tree.shards)
    if isinstance(tree, Replicated):
        return tree_leaves_any(unreplicate(tree))
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves_any(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves_any(item)]
    return [tree]


def tree_map_any(fn: Callable, tree):
    """``fn`` over every leaf of a tree of dicts, tuples, lists,
    NamedTuples and sharded batches, keeping its structure; a placed state
    maps its whole state and places the result as it was placed."""
    if isinstance(tree, ShardedBatch):
        return ShardedBatch(tree.mesh, tree_map_any(fn, tree.shards))
    if isinstance(tree, Replicated):
        return place_like(tree_map_any(fn, unreplicate(tree)), tree)
    if isinstance(tree, dict):
        return {key: tree_map_any(fn, tree[key]) for key in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_any(fn, item) for item in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_any(fn, item) for item in tree)
    return fn(tree)


def clone_tree(tree):
    """A copy of every tensor leaf (other leaves as they are)."""
    return tree_map_any(lambda t: t.clone() if torch.is_tensor(t) else t, tree)


def _copy_into(dsts, srcs) -> None:
    """``dst.copy_(src)`` leaf by leaf, skipping a leaf that is its own
    source. A source that shares memory with another destination is copied
    first, so that no write lands before a read of the same memory."""
    pairs = [(d, s) for d, s in zip(dsts, srcs) if torch.is_tensor(d) and d is not s]
    targets = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in targets and s.data_ptr() != d.data_ptr() else s)
             for d, s in pairs]
    for d, s in pairs:
        if s.data_ptr() != d.data_ptr():
            d.copy_(s)


class SyncGate:
    """The process's sync-debug mode against its host syncs.
    ``torch.cuda.set_sync_debug_mode`` is one setting for the whole
    process: while a warmup runs under ``"error"``, a host sync in any other
    thread raises. So a warmup holds the gate alone (:meth:`checked`), and a
    host sync that may run beside one (a serving flush's copy to the host,
    the tenant pager's page-in, a capture's own synchronisation) holds it
    shared (:meth:`host_sync`), with any number of other syncs. A thread
    holding either side takes neither again."""

    def __init__(self):
        self._cond = threading.Condition()
        self._syncs = 0
        self._checking = False

    @contextlib.contextmanager
    def host_sync(self) -> Iterator[None]:
        with self._cond:
            self._cond.wait_for(lambda: not self._checking)
            self._syncs += 1
        try:
            yield
        finally:
            with self._cond:
                self._syncs -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def checked(self) -> Iterator[None]:
        """The block under ``set_sync_debug_mode("error")``, alone."""
        with self._cond:
            self._cond.wait_for(lambda: not self._checking and self._syncs == 0)
            self._checking = True
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(previous)
            with self._cond:
                self._checking = False
                self._cond.notify_all()


#: the gate of the process's one sync-debug mode
SYNC_GATE = SyncGate()


def warm_up(fn: Callable, device, stream, *args):
    """``fn(*args)`` once on ``stream`` under the sync gate's ``"error"``
    mode, priced by the flop counter -> ``(outputs, cost)``, the card
    synchronised after it."""
    stream.wait_stream(torch.cuda.current_stream(device))
    with SYNC_GATE.checked(), torch.cuda.stream(stream):
        outputs, cost = priced_call(fn, *args)
    with SYNC_GATE.host_sync():
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
    return outputs, cost


def capture_graph(fn: Callable, device, pool, stream, capture_error_mode: str = "global"):
    """``fn()`` captured into a new CUDA graph on ``stream``, its memory
    from ``pool`` -> ``(graph, fn's outputs, the fused update's launches
    per replay)``. The garbage collector is paused: a dead graph (a dropped
    system's) destroyed inside a capture is a CUDA call the capture does
    not permit, and it invalidates the capture. The capture's
    synchronisations hold the sync gate's shared side."""
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with SYNC_GATE.host_sync(), fused_update.capture_tally(stream) as tally, \
                torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode=capture_error_mode):
            outputs = fn()
    finally:
        if collecting:
            gc.enable()
    with SYNC_GATE.host_sync():
        torch.cuda.synchronize(device)
    return graph, outputs, dict(tally)


class CapturedStep:
    """One CUDA graph of ``step(state, batch) -> (new_state or None,
    outputs)`` at one batch shape. :meth:`build` warms up and captures;
    ``lower_s`` is the warmup's seconds, ``compile_s`` the capture's with
    the graph's instantiation, ``cost`` the warmup's FLOPs, ``memory`` the
    graph pool's bytes after the capture (``costs.program_memory``),
    ``launches`` the fused update's kernels the capture recorded (name ->
    launches per replay)."""

    def __init__(self, step: Callable, state, batch, device, pool, stream):
        self.step = step
        self.device = torch.device(device)
        self.pool = pool
        self.stream = stream
        self.state = clone_tree(state)
        self.batch = clone_tree(batch)
        self._state_leaves = tree_leaves_any(self.state)
        self._batch_leaves = tree_leaves_any(self.batch)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.cost: Dict[str, Any] = {}
        self.memory: Dict[str, Any] = {}
        self.lower_s = self.compile_s = None
        self.launches: Dict[str, int] = {}

    def build(self) -> "CapturedStep":
        device = self.device
        t0 = time.perf_counter()
        _, self.cost = warm_up(self.step, device, self.stream, clone_tree(self.state), self.batch)
        t1 = time.perf_counter()

        def capture():
            new_state, outputs = self.step(self.state, self.batch)
            if new_state is not None:
                _copy_into(self._state_leaves, tree_leaves_any(new_state))
            return outputs

        graph, outputs, self.launches = capture_graph(capture, device, self.pool, self.stream)
        self.compile_s = time.perf_counter() - t1
        self.lower_s = t1 - t0
        self.memory = program_memory(pool_bytes(device, self.pool))
        self.graph, self.outputs = graph, outputs
        return self

    def load_state(self, state) -> None:
        """Make ``state`` the graph's: copied into the static buffers unless
        it is already the graph's own."""
        if state is not self.state:
            _copy_into(self._state_leaves, tree_leaves_any(state))

    def replay(self, batch):
        """``batch`` into the static batch, one replay -> the graph's static
        outputs (overwritten by the next replay)."""
        _copy_into(self._batch_leaves, tree_leaves_any(batch))
        self.graph.replay()
        fused_update.count_replay(self.launches)
        return self.outputs

    def dispatch(self, state, batches):
        """One replay per batch of ``batches`` from ``state`` -> (the state,
        a view of the static buffers; each replay's outputs, copied)."""
        self.load_state(state)
        outs = [tree_map_any(lambda t: t.clone() if torch.is_tensor(t) else t, self.replay(batch))
                for batch in batches]
        return self.state, outs


class GraphProgram:
    """A program of a system on the card: ``step_for(**kwargs)`` gives the
    step callable to capture, and one :class:`CapturedStep` is kept per
    batch signature. A call ``program(state, batches, **kwargs)`` replays
    it once per batch. The ledger (``wrap_build`` hands it over) gets one
    priced entry per capture, whose FLOPs are the captured step's times the
    replays of the dispatch (the JAX program scans them all); a capture that
    fails is recorded with its error and raised.

    A mesh's sharded batches (``parallel/mesh.py``): the graph holds the
    sharded step where every mesh entry is one card and one process; its
    static state is the unreplicated state, which the step replicates
    again. On a mesh that spans cards or processes (``Mesh.graph_refusal``)
    the program runs ``eager``, the steps one by one, decided from the mesh
    before anything is captured; its first dispatch of each signature is a
    ledger entry with ``graph: false`` and the reason.

    :meth:`warm` builds the program for a signature without a real
    dispatch (``compile/aot.py::prewarm_train``): the capture, whose
    warmup runs on a copy of the state, or the first eager dispatch, on a
    copy the caller throws away. Its entries carry ``phase="prewarm"``;
    after a warm, a real dispatch of a signature the warm did not build
    is recorded under ``phase="prewarm_respec"``, as JAX records a rebuild
    of a prewarmed program."""

    prices_own_builds = True

    def __init__(self, step_for: Callable, device, pool_for: Callable, eager: Callable, stream_for: Callable):
        self._step_for = step_for
        self.device = torch.device(device)
        self._pool_for = pool_for
        self._stream_for = stream_for
        self._eager = eager
        self._captured: Dict[Any, CapturedStep] = {}
        self._eager_seen: set = set()
        self._warmed = False
        self.ledger = None
        self.name = "graph"

    def attach_ledger(self, ledger, name: str) -> None:
        self.ledger, self.name = ledger, name

    @property
    def captures(self) -> List[CapturedStep]:
        return list(self._captured.values())

    @staticmethod
    def _signature(batches):
        from ..utils.strictmode import abstract_signature

        return abstract_signature(batches[0])

    @staticmethod
    def _refusal(batches) -> Optional[str]:
        return batches[0].mesh.graph_refusal() if isinstance(batches[0], ShardedBatch) else None

    def _record(self, **entry) -> None:
        if self.ledger is not None:
            self.ledger.record(self.name, cold=True, **entry)

    def _capture(self, sig, state, batches, phase: Optional[str], **kwargs) -> CapturedStep:
        captured = CapturedStep(self._step_for(**kwargs), state, batches[0], self.device, self._pool_for(),
                                self._stream_for())
        try:
            captured.build()
        except Exception as exc:
            self._record(error=f"capture failed: {type(exc).__name__}: {exc}", phase=phase)
            raise
        self._captured[sig] = captured
        flops = captured.cost.get("flops")
        self._record(
            lower_s=captured.lower_s, compile_s=captured.compile_s,
            flops=flops * len(batches) if flops else None, bytes_accessed=None, memory=captured.memory,
            replays=len(batches), flops_per_replay=flops, cost_error=captured.cost.get("error"), graph=True,
            phase=phase,
        )
        return captured

    def _run_eager(self, sig, state, batches, reason: str, phase: Optional[str], **kwargs):
        if sig in self._eager_seen:
            return self._eager(state, batches, **kwargs)
        t0 = time.perf_counter()
        try:
            out, cost = priced_call(self._eager, state, batches, **kwargs)
        except Exception as exc:
            self._record(total_s=time.perf_counter() - t0, graph=False, reason=reason, phase=phase,
                         error=f"first dispatch failed: {type(exc).__name__}: {exc}")
            raise
        self._eager_seen.add(sig)
        self._record(total_s=time.perf_counter() - t0, flops=cost.get("flops"), replays=len(batches), graph=False,
                     reason=reason, phase=phase)
        return out

    def _respec(self) -> Optional[str]:
        return "prewarm_respec" if self._warmed else None

    def __call__(self, state, batches: List[Any], **kwargs):
        sig, refusal = self._signature(batches), self._refusal(batches)
        if refusal is not None:
            return self._run_eager(sig, state, batches, refusal, self._respec(), **kwargs)
        state = unreplicate(state)
        captured = self._captured.get(sig)
        if captured is None:
            captured = self._capture(sig, state, batches, self._respec(), **kwargs)
        return captured.dispatch(state, batches)

    def warm(self, state, batches: List[Any], **kwargs) -> Dict[str, Any]:
        """Build the program for ``batches``' signature without advancing
        ``state``: the capture (its warmup on a copy), or on a mesh a graph
        cannot hold the first eager dispatch on a copy. -> JAX's warm
        result keys, and ``graph``."""
        sig, refusal = self._signature(batches), self._refusal(batches)
        self._warmed = True
        if sig in self._captured or sig in self._eager_seen:
            return {"program": self.name, "already_warm": True, "signature": sig, "graph": refusal is None}
        if refusal is not None:
            # the step replicates the copy onto the batch's mesh
            self._run_eager(sig, clone_tree(unreplicate(state)), batches, refusal, "prewarm", **kwargs)
        else:
            self._capture(sig, unreplicate(state), batches, "prewarm", **kwargs)
        return {"program": self.name, "already_warm": False, "signature": sig, "graph": refusal is None}

    def release(self) -> None:
        """Drop every graph and its static buffers (their pool blocks go
        back to the shared pool for the next capture)."""
        self._captured.clear()
        self._eager_seen.clear()


class StaticBuffers:
    """Tensors made outside any capture, one per ``(role, shape, dtype)``,
    shared by every program of one owner (a serving engine): the programs
    of one shape read their inputs from, and write their outputs to, the
    same memory, which they never use at once. A tree gets one buffer per
    leaf, keyed by the leaf's position, so that no two leaves of one tree
    share."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._by_key: Dict[Any, torch.Tensor] = {}

    def get(self, role: str, shape, dtype) -> torch.Tensor:
        key = (role, tuple(shape), dtype)
        buf = self._by_key.get(key)
        if buf is None:
            buf = self._by_key[key] = torch.zeros(tuple(shape), dtype=dtype, device=self.device)
        return buf

    def like(self, role: str, tree, lead=()):
        """A tree of buffers shaped as ``tree``'s tensor leaves with
        ``lead`` in front (other leaves as they are)."""
        index = iter(range(len(tree_leaves_any(tree))))
        return tree_map_any(
            lambda t: self.get(f"{role}/{next(index)}", tuple(lead) + tuple(t.shape), t.dtype)
            if torch.is_tensor(t) else t, tree)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._by_key.values())


class ServingCall:
    """One serving flush ``fn(state, inputs) -> outputs`` as one CUDA graph
    (the port's counterpart of the JAX engine's jitted bucket programs):
    :class:`CapturedStep`'s parts, with no state to advance.

    ``state`` (the master) and ``inputs`` are static buffers that the
    caller fills before each run (``serving/engine.py`` shares them among
    its programs); the outputs are copied, in the graph, into static outputs
    from ``buffers`` shaped as the warmup's, so that the pool keeps no
    block of a program's own past its capture. :meth:`build` runs the
    warmup on the filled inputs, on ``stream`` under the sync gate's
    ``"error"`` mode and priced by the flop counter, then captures in
    ``capture_error_mode="thread_local"`` (a server's other threads touch
    the card meanwhile); the warmup's outputs are the flush's that built
    the program. :meth:`run` replays. ``lower_s`` is the warmup's seconds,
    ``compile_s`` the capture's, ``memory`` the pool's bytes after it,
    ``launches`` the fused update's kernels per replay.

    On the CPU nothing is captured: :meth:`build` is the first run, priced,
    and :meth:`run` calls ``fn`` on the static buffers and copies its
    outputs into the static ones, the same buffer path without a graph."""

    def __init__(self, fn: Callable, state, inputs, buffers: StaticBuffers, device, pool=None, stream=None):
        self.fn = fn
        self.state = state
        self.inputs = inputs
        self.buffers = buffers
        self.device = torch.device(device)
        self.pool = pool
        self.stream = stream
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.cost: Dict[str, Any] = {}
        self.memory: Dict[str, Any] = {}
        self.lower_s = self.compile_s = None
        self.launches: Dict[str, int] = {}

    def _keep(self, outputs) -> None:
        if self.outputs is None:
            self.outputs = self.buffers.like("out", outputs)
        _copy_into(tree_leaves_any(self.outputs), tree_leaves_any(outputs))

    def build(self) -> "ServingCall":
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            outputs, self.cost = priced_call(self.fn, self.state, self.inputs)
            self._keep(outputs)
            self.lower_s = time.perf_counter() - t0
            return self
        outputs, self.cost = warm_up(self.fn, self.device, self.stream, self.state, self.inputs)
        self._keep(outputs)
        del outputs
        t1 = time.perf_counter()
        self.graph, _, self.launches = capture_graph(
            lambda: self._keep(self.fn(self.state, self.inputs)), self.device, self.pool, self.stream,
            capture_error_mode="thread_local")
        self.compile_s = time.perf_counter() - t1
        self.lower_s = t1 - t0
        self.memory = program_memory(pool_bytes(self.device, self.pool))
        return self

    def run(self):
        """One run on the static inputs -> the static outputs (overwritten
        by the next run of any program that shares them)."""
        if self.graph is None:
            self._keep(self.fn(self.state, self.inputs))
        else:
            self.graph.replay()
            fused_update.count_replay(self.launches)
        return self.outputs
