"""Device mesh, data-parallel and tensor-parallel placement (JAX package
``parallel/mesh.py``).

The JAX package shards the meta-batch over the ``dp`` axis of a ``Mesh``,
places the parameters with ``train_state_shardings`` and lets XLA
partition the second-order program and insert the collectives. Here the
mesh is what one process drives: a ``dp x mp`` grid of ``torch.device``
entries, entry ``(i, j)`` at ``devices[i * mp + j]``. :func:`shard_batch`
splits the task axis into ``dp`` contiguous chunks, chunk ``i`` on row
``i``'s first entry (``Mesh.row_devices``); :func:`replicate` gives every
entry the whole state. ``MAMLSystem.train_step`` given such a pair runs
each chunk's rollout on its row and sums the rows' meta-gradients in mesh
order (``core/maml.py``). Shrinking onto fewer devices and growing back are
re-placements inside the process, as in the JAX runner; a DDP group could
not change its size without restarting every process.

Tensor parallelism (``mp > 1``): :func:`shard_train_state` places a
``TrainState`` as JAX's ``train_state_shardings`` does. :func:`param_spec`
is JAX's ``_param_spec`` read on the port's layout: a dense ``w`` (``[out,
in]`` here, ``[in, out]`` in JAX) and, under ``tp_convs``, a conv ``w``
(OIHW here, HWIO in JAX) split their output axis, the port's dim 0, over
``mp`` where it divides; the outer Adam moments of a parameter split as
the parameter does; every other leaf is whole on every entry. Entry ``(i,
j)`` holds block ``j`` of each split leaf, a contiguous block of rows. A
row's step reads its entries as one tree (:meth:`Replicated.row`) in which
a split leaf is a dict of its blocks, ``{"mp0": ..., "mp1": ...}``
(:func:`shard_key`), each on its entry's device: a conv or dense layer
given such a ``w`` computes each block's output channels on that block's
device and concatenates them in channel order (``models/layers.py``,
column-parallel as GSPMD lays it out); batch norm, activations and the next
layer see the whole activation on the row's first device. The meta-gradient
of a split leaf stays split, and the new state keeps the placement it came
in with. :func:`unreplicate` gathers the whole state (checkpoints, the NaN
guard, serving).

A mesh may name one device several times: on the CPU every entry is
``cpu`` (the counterpart of the JAX tests' 8 virtual CPU devices), and on
one card ``[cuda:0] * (dp * mp)`` runs the dp x mp code paths. Entries on
one device share their tensors (a block is a view of its whole leaf where
the leaf lies on the entry's device already); a step that writes into the
state it is given (``donate_train_state``) writes after every read of the
old values. It is how the tests and the one-card smoke run exercise the
mesh, not a way to go faster. :func:`shard_chunk` splits a chunk of K
batches (the multi-step programs' input) the same way, batch by batch; a
mesh whose entries are all one card and one process runs those programs as
one CUDA graph of the sharded step (``Mesh.graph_refusal``).

Across hosts: one process per host, joined by ``torch.distributed``
(:func:`initialize_distributed`: NCCL between cards, gloo on the CPU). The
mesh's ``dp`` then counts every host's rows, as JAX's global mesh does;
each process holds ``dp / process_count`` of them, each with its ``mp``
entries (the ``mp`` axis always lies within a process), builds its own
slice of the meta-batch (``host_shard_bounds``, the loader's
``host_shard``) and the meta-gradient is all-reduced over the processes.
The plan functions are the JAX package's arithmetic, copied.
"""

import os
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ParallelConfig

DATA_AXIS = "dp"
MODEL_AXIS = "mp"
#: a split leaf in a row's tree is ``{SHARD_PREFIX + str(j): block j}``
SHARD_PREFIX = MODEL_AXIS


def shard_key(j: int) -> str:
    """The key of block ``j`` of a split leaf in a row's tree."""
    return f"{SHARD_PREFIX}{j}"


def shard_index(key) -> Optional[int]:
    """``j`` for :func:`shard_key` ``(j)``, else None."""
    if isinstance(key, str) and key.startswith(SHARD_PREFIX) and key[len(SHARD_PREFIX):].isdigit():
        return int(key[len(SHARD_PREFIX):])
    return None


def shard_blocks(node: Dict[str, Any]) -> List[Any]:
    """The blocks of a split leaf, in channel order."""
    return [node[shard_key(j)] for j in range(len(node))]


def process_count() -> int:
    """Processes in the ``torch.distributed`` group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def visible_devices(device=None) -> List[torch.device]:
    """Every visible card, or the one CPU when ``device`` is the CPU.
    Raises without a card unless the CPU is asked for."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the port on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _canonical(device) -> torch.device:
    """A device with its index: ``cuda`` names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A ``dp x mp`` grid of this process's devices. ``shape`` and ``size``
    count every process's devices (JAX's global mesh); ``devices`` are this
    process's, ``local_dp`` of them along ``dp``."""

    def __init__(self, devices: Sequence, dp: int, mp: int = 1, processes: int = 1, tp_convs: bool = False):
        if dp % processes:
            raise ValueError(f"mesh dp={dp} does not divide over {processes} processes")
        self.devices = [_canonical(d) for d in devices]
        self.local_dp = dp // processes
        if len(self.devices) != self.local_dp * mp:
            raise ValueError(f"mesh {dp}x{mp} over {processes} process(es) needs {self.local_dp * mp} "
                             f"local devices, got {len(self.devices)}")
        self.shape = {DATA_AXIS: dp, MODEL_AXIS: mp}
        self.processes = processes
        # the placement shard_train_state gives a whole state on this mesh
        # where the caller names none (the graph path re-places its own)
        self.tp_convs = bool(tp_convs)

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    @property
    def row_devices(self) -> List[torch.device]:
        """Each local dp row's first entry: where the row's batch shard,
        its whole activations and its replicated leaves' work lie."""
        return self.devices[:: self.shape[MODEL_AXIS]]

    def graph_refusal(self) -> Optional[str]:
        """Why one CUDA graph cannot hold a step on this mesh, or None when
        it can: every entry is one card and one process drives it (the
        ``[cuda:0] * (dp * mp)`` mesh). A graph is recorded on one card's streams,
        and a collective over gloo cannot be captured."""
        if self.processes > 1:
            return f"the mesh spans {self.processes} processes (a collective cannot be captured)"
        cards = sorted({str(d) for d in self.devices})
        if len(cards) > 1:
            return f"the mesh spans {len(cards)} devices {cards} (a graph is recorded on one card)"
        if self.devices[0].type != "cuda":
            return f"the mesh lies on {cards[0]}, not a card"
        return None

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, devices={[str(d) for d in self.devices]}, processes={self.processes}"
                + (", tp_convs=True)" if self.tp_convs else ")"))


def make_mesh(parallel: Optional[ParallelConfig] = None, devices=None) -> Mesh:
    """The ``dp x mp`` mesh of ``parallel`` over ``devices`` (default:
    every visible card), entry ``(i, j)`` at ``devices[i * mp + j]``;
    ``dp=-1`` takes them all. The mesh keeps ``parallel.tp_convs``."""
    parallel = parallel or ParallelConfig()
    devices = list(devices if devices is not None else visible_devices())
    hosts = process_count()
    n_devices = len(devices) * hosts
    mp = max(parallel.mp, 1)
    dp = parallel.dp if parallel.dp and parallel.dp > 0 else n_devices // mp
    if dp * mp > n_devices:
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} devices, have {n_devices}")
    return Mesh(devices[: (dp // hosts) * mp], dp, mp, hosts, tp_convs=parallel.tp_convs)


def requested_mesh_shape(parallel: Optional[ParallelConfig], n_devices: int):
    """The ``(dp, mp)`` the config demands given ``n_devices`` visible
    (``dp=-1`` auto-sizes to the visible devices, so it can never be
    infeasible by itself; an explicit dp can)."""
    parallel = parallel or ParallelConfig()
    mp = max(parallel.mp, 1)
    dp = parallel.dp if parallel.dp and parallel.dp > 0 else max(n_devices // mp, 1)
    return dp, mp


def degraded_mesh_plan(parallel: Optional[ParallelConfig], n_devices: int, global_batch_size: int):
    """Shrink plan for resuming on fewer devices than ``ParallelConfig``
    demands. ``None`` when the demanded shape fits, else ``(dp, mp)`` of the
    largest feasible degraded mesh: ``mp`` kept if it still fits, else 1;
    ``dp`` the largest value that fits beside ``mp`` and divides the global
    meta-batch. ``(1, 1)`` means one device (the caller skips the mesh)."""
    dp_req, mp_req = requested_mesh_shape(parallel, n_devices)
    if dp_req * mp_req <= n_devices:
        return None
    mp = mp_req if mp_req <= n_devices else 1
    budget = max(n_devices // mp, 1)
    dp = 1
    for cand in range(min(budget, dp_req), 0, -1):
        if global_batch_size % cand == 0:
            dp = cand
            break
    return dp, mp


def grow_mesh_plan(parallel: Optional[ParallelConfig], n_devices: int, global_batch_size: int, current):
    """Grow plan, the inverse of :func:`degraded_mesh_plan`: the largest
    feasible ``(dp, mp)`` for ``n_devices``, or ``None`` when it uses no more
    devices than ``current`` (so shrink and grow never oscillate between
    equal-sized shapes)."""
    cur_dp, cur_mp = current
    plan = degraded_mesh_plan(parallel, n_devices, global_batch_size)
    best = requested_mesh_shape(parallel, n_devices) if plan is None else plan
    if best[0] * best[1] <= cur_dp * cur_mp:
        return None
    return best


def host_shard_bounds(batch_size: int, process_index: int, process_count: int):
    """[start, stop) of the global meta-batch this host materializes."""
    if batch_size % process_count != 0:
        raise ValueError(f"global batch_size {batch_size} not divisible by process_count {process_count}")
    per_host = batch_size // process_count
    return process_index * per_host, (process_index + 1) * per_host


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


class ShardedBatch:
    """A meta-batch split over the mesh's ``dp`` axis: ``shards[i]`` is a
    dict of the i-th contiguous chunk of tasks, on ``mesh.row_devices[i]``.
    ``num_tasks`` counts this process's tasks, ``global_tasks`` every
    process's."""

    spec = (DATA_AXIS,)

    def __init__(self, mesh: Mesh, shards: List[Dict[str, torch.Tensor]]):
        self.mesh = mesh
        self.shards = shards
        self.num_tasks = sum(len(next(iter(s.values()))) for s in shards)
        self.global_tasks = self.num_tasks * mesh.processes

    def abstract_signature(self):
        """The shapes and dtypes of every shard, with its device and the
        mesh's processes (``utils/strictmode.py::abstract_signature``): a
        sharded batch never shares a program's signature with a plain
        one, nor with one sharded otherwise."""
        from ..utils.strictmode import abstract_signature

        return ("sharded", self.mesh.processes,
                self.mesh.shape[MODEL_AXIS],
                tuple((str(d), abstract_signature(s)) for d, s in zip(self.mesh.row_devices, self.shards)))


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> ShardedBatch:
    """Split the task axis (axis 0) of every array of ``batch`` (numpy or
    tensors) into ``local_dp`` contiguous chunks, chunk ``i`` on
    ``mesh.row_devices[i]``."""
    n = len(next(iter(batch.values())))
    if n % mesh.local_dp:
        raise ValueError(f"meta-batch of {n} tasks not divisible by the mesh's local dp={mesh.local_dp}")
    per = n // mesh.local_dp
    shards = []
    for i, device in enumerate(mesh.row_devices):
        shards.append({k: torch.as_tensor(v[i * per:(i + 1) * per]).to(device) for k, v in batch.items()})
    return ShardedBatch(mesh, shards)


def shard_chunk(chunk: Dict[str, Any], mesh: Mesh) -> List[ShardedBatch]:
    """A chunk of batches (every array with a leading ``[K]`` axis, task
    axis second) -> K :class:`ShardedBatch`es, the tasks of each split over
    the mesh exactly as :func:`shard_batch` splits one batch (the JAX
    package's ``chunk_sharding``, ``P(None, dp)``). Each shard's ``[K]``
    slice goes to its device once; batch k's shard is a view of it."""
    first = next(iter(chunk.values()))
    k, n = len(first), len(first[0])
    if n % mesh.local_dp:
        raise ValueError(f"meta-batch of {n} tasks not divisible by the mesh's local dp={mesh.local_dp}")
    per = n // mesh.local_dp
    placed = [{key: torch.as_tensor(v[:, i * per:(i + 1) * per]).to(device) for key, v in chunk.items()}
              for i, device in enumerate(mesh.row_devices)]
    return [ShardedBatch(mesh, [{key: v[j] for key, v in shard.items()} for shard in placed]) for j in range(k)]


def global_batch_from_local(local_batch: Dict[str, Any], mesh: Mesh) -> ShardedBatch:
    """This host's slice of the global meta-batch, sharded over its devices.
    The global batch is never assembled in one place: each host keeps its
    slice, and the meta-gradient is all-reduced over the hosts."""
    return shard_batch(local_batch, mesh)


def move_tree(tree, device):
    """A state (NamedTuples, tuples and dicts over tensors; ``None`` kept)
    with every tensor on ``device``; a tensor already there is itself."""
    if isinstance(tree, tuple):
        items = [move_tree(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, dict):
        return {k: move_tree(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return tree.to(device)


def param_spec(shape, mp: int, tp_convs: bool = False, leaf_name=None) -> Tuple:
    """JAX's ``_param_spec`` on the port's layout: ``(MODEL_AXIS, None)``
    for a dense kernel (a 2-D leaf named ``w``, ``[out, in]``) whose output
    axis divides over ``mp``; under ``tp_convs`` ``(MODEL_AXIS, None, None,
    None)`` for a conv kernel (a 4-D ``w``, OIHW) whose output channels do;
    else ``()`` (replicated, JAX's ``P()``). JAX's split axis (``[in, out]``
    axis 1, HWIO axis 3) is the port's dim 0. Both branches key off the
    name, as JAX's do: a 2-D or 4-D leaf of another name is replicated."""
    if leaf_name == "w" and len(shape) == 2 and shape[0] >= mp and shape[0] % mp == 0:
        return (MODEL_AXIS, None)
    if tp_convs and leaf_name == "w" and len(shape) == 4 and shape[0] >= mp and shape[0] % mp == 0:
        return (MODEL_AXIS, None, None, None)
    return ()


def param_specs(params, mp: int, tp_convs: bool = False):
    """:func:`param_spec` of every leaf of a parameter tree."""
    return {k: param_specs(v, mp, tp_convs) if isinstance(v, dict) else param_spec(tuple(v.shape), mp, tp_convs, k)
            for k, v in params.items()}


def _split(spec) -> bool:
    return bool(spec) and MODEL_AXIS in spec


def _walk(nodes: List[Any], spec, fn, specs):
    """``fn(leaves, spec)`` over matching leaves of the trees ``nodes``
    (NamedTuples, tuples, lists, dicts), keeping the first one's structure.
    ``spec`` is a leaf's :func:`param_spec` inside the parameters and
    inside the optimizer's mirrors of them (a subtree under a key or field
    ``params``, as JAX's ``opt_spec`` finds them), else None. A split leaf
    reaches ``fn`` whatever its node is (a row's split leaf is a dict of
    blocks)."""
    node = nodes[0]
    if isinstance(spec, tuple):
        return fn(nodes, spec)
    if isinstance(node, dict):
        return {k: _walk([n[k] for n in nodes], spec[k] if spec is not None else (specs if k == "params" else None),
                         fn, specs) for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_walk([getattr(n, f) for n in nodes],
                                  spec if spec is not None else (specs if f == "params" else None), fn, specs)
                            for f in node._fields))
    if isinstance(node, (tuple, list)):
        return type(node)(_walk([n[i] for n in nodes], spec, fn, specs) for i in range(len(node)))
    return fn(nodes, None)


class _Mover:
    """``.to(device)`` with one copy per (leaf, device) while the leaves it
    is given live: entries on one device share a whole leaf."""

    def __init__(self):
        self._moved: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def __call__(self, x, device):
        if not torch.is_tensor(x) or x.device == device:
            return x
        key = (id(x), device)
        if key not in self._moved:
            self._moved[key] = x.to(device)
        return self._moved[key]


class Replicated:
    """A state (or any tree of tensors) placed on a mesh: ``replicas[i]``
    is entry ``i``'s (on ``mesh.devices[i]``), and entries that name the
    same device share their tensors. ``specs`` (None: every entry holds the
    whole tree) is the :func:`param_specs` tree of a tensor-parallel
    ``TrainState``: entry ``(i, j)`` then holds block ``j`` of each split
    leaf. Reading an attribute reads the whole state's (``state.params``,
    ``state.step``: the first replica's, or the gathered tree)."""

    def __init__(self, mesh: Mesh, replicas: List[Any], specs=None):
        self.mesh = mesh
        self.replicas = replicas
        self.specs = specs

    def on(self, device) -> Any:
        """The replica on ``device`` (a state without split leaves)."""
        return self.replicas[self.mesh.devices.index(_canonical(device))]

    def row(self, i: int) -> Any:
        """The tree dp row ``i`` computes with: its first entry's, each
        split leaf as ``{shard_key(j): entry (i, j)'s block}``."""
        mp = self.mesh.shape[MODEL_AXIS]
        entries = self.replicas[i * mp:(i + 1) * mp]
        if self.specs is None:
            return entries[0]
        return _walk(entries, None, lambda leaves, spec: (
            {shard_key(j): x for j, x in enumerate(leaves)} if _split(spec) else leaves[0]), self.specs)

    def __getattr__(self, name):
        if name in ("mesh", "replicas", "specs"):
            raise AttributeError(name)
        return getattr(unreplicate(self), name)


def replicate(tree, mesh: Mesh) -> Replicated:
    """``tree`` copied whole once to each distinct device of the mesh."""
    tree = unreplicate(tree)
    placed: Dict[torch.device, Any] = {}
    for device in mesh.devices:
        if device not in placed:
            placed[device] = move_tree(tree, device)
    return Replicated(mesh, [placed[d] for d in mesh.devices])


def _place(state, mesh: Mesh, specs, pick) -> Replicated:
    """Entry ``(i, j)`` of ``mesh`` gets ``pick(leaf, j)`` of every split
    leaf of ``state`` and the others whole, each on the entry's device;
    entries on one device share."""
    mp = mesh.shape[MODEL_AXIS]
    move, placed, replicas = _Mover(), {}, []
    for k, device in enumerate(mesh.devices):
        j = k % mp
        if (device, j) not in placed:
            placed[(device, j)] = _walk([state], None, lambda leaves, spec, j=j, device=device: (
                pick(leaves[0], j).to(device) if _split(spec) else move(leaves[0], device)), specs)
        replicas.append(placed[(device, j)])
    return Replicated(mesh, replicas, specs)


def _block(x: torch.Tensor, j: int, mp: int) -> torch.Tensor:
    """Rows ``[j n, (j + 1) n)`` of ``x``, ``n = len(x) / mp``: a view."""
    n = x.shape[0] // mp
    return x[j * n:(j + 1) * n]


def shard_train_state(state, mesh: Mesh, tp_convs: Optional[bool] = None) -> Replicated:
    """The train state on the mesh, as JAX's ``shard_train_state`` places
    it: with ``mp == 1`` a whole replica per entry; else each parameter and
    its outer-Adam moments split over ``mp`` where :func:`param_spec` says
    so, every other leaf whole on every entry. ``tp_convs`` None: the
    mesh's. A placed state is gathered first."""
    mp = mesh.shape[MODEL_AXIS]
    if mp == 1:
        return replicate(state, mesh)
    state = unreplicate(state)
    specs = param_specs(state.params, mp, mesh.tp_convs if tp_convs is None else tp_convs)
    return _place(state, mesh, specs, lambda x, j: _block(x, j, mp))


def place_like(tree, like: Replicated) -> Replicated:
    """A whole ``tree`` placed as ``like`` is."""
    if like.specs is None:
        return replicate(tree, like.mesh)
    mp = like.mesh.shape[MODEL_AXIS]
    return _place(tree, like.mesh, like.specs, lambda x, j: _block(x, j, mp))


def place_row(row, like: Replicated) -> Replicated:
    """A row's tree (:meth:`Replicated.row`: split leaves as dicts of
    blocks, on their entries' devices) placed on every row as ``like`` is:
    what a step writes back after it updated row 0's tree."""
    if like.specs is None:
        return replicate(row, like.mesh)
    return _place(row, like.mesh, like.specs, lambda blocks, j: blocks[shard_key(j)])


def row_view(tree, i: int = 0):
    """Row ``i``'s tree of a placed state; anything else as it is."""
    return tree.row(i) if isinstance(tree, Replicated) else tree


def unreplicate(tree):
    """The whole tree of a :class:`Replicated` (the first replica, or its
    split leaves gathered on the mesh's first device), anything else as it
    is."""
    if not isinstance(tree, Replicated):
        return tree
    if tree.specs is None:
        return tree.replicas[0]
    first = tree.mesh.devices[0]
    mp = tree.mesh.shape[MODEL_AXIS]
    return _walk(tree.replicas[:mp], None, lambda leaves, spec: (
        torch.cat([x.to(first) for x in leaves]) if _split(spec) else leaves[0]), tree.specs)


def placement(state) -> Any:
    """The :func:`param_spec` of every leaf of a state as it is placed
    (``()``: whole on every entry), in the state's structure: the
    counterpart of the specs of JAX's ``train_state_shardings``."""
    specs = state.specs if isinstance(state, Replicated) else None
    return _walk([unreplicate(state)], None, lambda leaves, spec: spec if spec is not None else (), specs)


def spread_over_blocks(tree, like):
    """``tree`` (a hyperparameter tree with one leaf per whole parameter,
    ``{"lr": params-like, ...}``) with each leaf that stands for a split
    parameter of ``like`` (a row's parameters) given once per block, moved
    to the block's device: the per-tensor hyperparameters a row's inner
    update takes. ``tree`` itself where ``like`` has no split leaf."""

    def spread(h, p):
        if isinstance(p, dict) and not isinstance(h, dict):
            return {k: h.to(b.device) for k, b in p.items()}
        if isinstance(p, dict):
            return {k: spread(h[k], p[k]) for k in h}
        return h

    if not _has_blocks(like):
        return tree
    return {name: spread(sub, like) for name, sub in tree.items()}


def _has_blocks(params) -> bool:
    if isinstance(params, dict):
        return any(shard_index(k) is not None or _has_blocks(v) for k, v in params.items())
    return False


# ---------------------------------------------------------------------------
# multi-host
# ---------------------------------------------------------------------------


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_s: float = 300.0,
) -> None:
    """Join the hosts' process group: a no-op for one process, else
    ``torch.distributed.init_process_group`` over
    ``tcp://coordinator_address`` with gloo where ``device`` is the CPU and
    NCCL otherwise: ``None`` means the card, as everywhere in the port, and
    raises where none is visible. Unset arguments fall back to torch's own
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``), where the JAX package reads ``JAX_NUM_PROCESSES``."""
    from ..core.maml import resolve_device  # core.maml imports this module

    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    on_cpu = resolve_device(device).type == "cpu"
    dist.init_process_group(
        "gloo" if on_cpu else "nccl",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=timedelta(seconds=timeout_s),
    )


def all_reduce_sum(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the processes (in place; returned)."""
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return tensors


def all_gather_tasks(x: torch.Tensor) -> torch.Tensor:
    """This process's ``[n, ...]`` rows -> every process's, concatenated in
    process order along axis 0 (host p holds rows [p*n, (p+1)*n)), on
    ``x``'s device. gloo gathers host tensors, NCCL card tensors."""
    src = (x.cpu() if dist.get_backend() == "gloo" else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(x.device)


def all_gather_host(x: np.ndarray) -> np.ndarray:
    """:func:`all_gather_tasks` of a host array."""
    return all_gather_tasks(torch.from_numpy(np.ascontiguousarray(x))).numpy()
