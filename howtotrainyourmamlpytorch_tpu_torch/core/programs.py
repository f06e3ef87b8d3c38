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
  The warmup is priced by the flop counter (``observability/costs.py``);
- the capture, into a memory pool the caller passes (``core/maml.py``
  shares one, ``torch.cuda.graph_pool_handle()``, among all of a system's
  graphs: they never run at once, and a pool each would hold each step's
  peak); at its end an in-graph ``copy_`` writes the new state into the
  static state buffers, so the state is updated in place;
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

A failed capture raises: nothing falls back to eager. On the CPU no graph
is captured; ``core/maml.py`` runs the K eager steps instead.
:class:`GraphProgram` keeps one :class:`CapturedStep` per batch signature
and records each capture in the compile ledger
(``observability/compile_ledger.py``).
"""

import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..observability.costs import pool_bytes, priced_call, program_memory
from ..ops import fused_update


def tree_leaves_any(tree) -> List[Any]:
    """The leaves of a tree of dicts (sorted keys), tuples, lists and
    NamedTuples (a ``TrainState``), in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves_any(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves_any(item)]
    return [tree]


def tree_map_any(fn: Callable, tree):
    """``fn`` over every leaf of a tree of dicts, tuples, lists and
    NamedTuples, keeping its structure."""
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


class CapturedStep:
    """One CUDA graph of ``step(state, batch) -> (new_state or None,
    outputs)`` at one batch shape. :meth:`build` warms up and captures;
    ``lower_s`` is the warmup's seconds, ``compile_s`` the capture's with
    the graph's instantiation, ``cost`` the warmup's FLOPs, ``memory`` the
    graph pool's bytes after the capture (``costs.program_memory``),
    ``launches`` the fused update's kernels the capture recorded (name ->
    launches per replay)."""

    def __init__(self, step: Callable, state, batch, device, pool=None):
        self.step = step
        self.device = torch.device(device)
        self.pool = pool
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
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            previous = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                _, self.cost = priced_call(self.step, clone_tree(self.state), self.batch)
            finally:
                torch.cuda.set_sync_debug_mode(previous)
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = dict(fused_update.captured_counts)
        with torch.cuda.graph(graph, pool=self.pool, stream=stream):
            new_state, outputs = self.step(self.state, self.batch)
            if new_state is not None:
                _copy_into(self._state_leaves, tree_leaves_any(new_state))
        torch.cuda.synchronize(device)
        self.launches = {k: n - before[k] for k, n in fused_update.captured_counts.items()}
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
    fails is recorded with its error and raised."""

    prices_own_builds = True

    def __init__(self, step_for: Callable, device, pool_for: Callable):
        self._step_for = step_for
        self.device = torch.device(device)
        self._pool_for = pool_for
        self._captured: Dict[Any, CapturedStep] = {}
        self.ledger = None
        self.name = "graph"

    def attach_ledger(self, ledger, name: str) -> None:
        self.ledger, self.name = ledger, name

    @property
    def captures(self) -> List[CapturedStep]:
        return list(self._captured.values())

    def __call__(self, state, batches: List[Any], **kwargs):
        from ..utils.strictmode import abstract_signature

        sig = abstract_signature(batches[0])
        captured = self._captured.get(sig)
        if captured is None:
            captured = CapturedStep(self._step_for(**kwargs), state, batches[0], self.device, self._pool_for())
            try:
                captured.build()
            except Exception as exc:
                if self.ledger is not None:
                    self.ledger.record(self.name, cold=True, error=f"capture failed: {type(exc).__name__}: {exc}")
                raise
            self._captured[sig] = captured
            if self.ledger is not None:
                flops = captured.cost.get("flops")
                self.ledger.record(
                    self.name, lower_s=captured.lower_s, compile_s=captured.compile_s, cold=True,
                    flops=flops * len(batches) if flops else None, bytes_accessed=None, memory=captured.memory,
                    replays=len(batches), flops_per_replay=flops, cost_error=captured.cost.get("error"),
                )
        return captured.dispatch(state, batches)

    def release(self) -> None:
        """Drop every graph and its static buffers (their pool blocks go
        back to the shared pool for the next capture)."""
        self._captured.clear()
