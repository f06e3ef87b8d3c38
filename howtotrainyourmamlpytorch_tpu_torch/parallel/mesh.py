"""Device mesh and data-parallel placement (JAX package ``parallel/mesh.py``).

The JAX package shards the meta-batch over the ``dp`` axis of a ``Mesh``
and lets XLA partition the second-order program and insert the
meta-gradient ``psum``. Here the mesh is what one process drives: a
``dp x mp`` grid of ``torch.device`` entries. :func:`shard_batch` splits the
task axis into ``dp`` contiguous chunks, one on each entry;
:func:`replicate` gives every entry the state. ``MAMLSystem.train_step``
given such a pair runs each chunk's rollout on its device and sums the
chunks' meta-gradients in mesh order (``core/maml.py``). Shrinking onto
fewer devices and growing back are re-placements inside the process, as in
the JAX runner; a DDP group could not change its size without restarting
every process.

A mesh may name one device several times: on the CPU every entry is
``cpu`` (the counterpart of the JAX tests' 8 virtual CPU devices), and on
one card ``[cuda:0, cuda:0]`` runs the dp=2 code path. Replicas on one
device share their tensors, which is safe because no step writes into the
state it is given; it is how the tests and the one-card smoke run exercise
sharding, not a way to go faster. :func:`shard_chunk` splits a chunk of K
batches (the multi-step programs' input) the same way, batch by batch; a
mesh whose entries are all one card and one process runs those programs as
one CUDA graph of the sharded step (``Mesh.graph_refusal``).

Across hosts: one process per host, joined by ``torch.distributed``
(:func:`initialize_distributed`: NCCL between cards, gloo on the CPU). The
mesh's ``dp`` then counts every host's devices, as JAX's global mesh does;
each process holds ``dp / process_count`` of them, builds its own slice of
the meta-batch (``host_shard_bounds``, the loader's ``host_shard``) and the
meta-gradient is all-reduced over the processes.

Tensor parallelism (``mp > 1``, ``tp_convs``) is not ported: it raises
``NotImplementedError`` naming ROADMAP.md A12. The plan functions are the
JAX package's arithmetic, copied.
"""

import os
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import ParallelConfig

DATA_AXIS = "dp"
MODEL_AXIS = "mp"
#: the ROADMAP.md item that ports tensor parallelism
TENSOR_PARALLEL_ITEM = "A12"


def refuse_tensor_parallel(parallel: Optional[ParallelConfig]) -> None:
    """``NotImplementedError`` for ``mp > 1`` or ``tp_convs``."""
    parallel = parallel or ParallelConfig()
    if parallel.mp > 1 or parallel.tp_convs:
        raise NotImplementedError(
            f"tensor parallelism (parallel mp={parallel.mp}, tp_convs={parallel.tp_convs}) is not "
            f"ported to PyTorch yet (ROADMAP.md {TENSOR_PARALLEL_ITEM}); the port's mesh is data-parallel"
        )


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

    def __init__(self, devices: Sequence, dp: int, mp: int = 1, processes: int = 1):
        if dp % processes:
            raise ValueError(f"mesh dp={dp} does not divide over {processes} processes")
        self.devices = [_canonical(d) for d in devices]
        self.local_dp = dp // processes
        if len(self.devices) != self.local_dp * mp:
            raise ValueError(f"mesh {dp}x{mp} over {processes} process(es) needs {self.local_dp * mp} "
                             f"local devices, got {len(self.devices)}")
        self.shape = {DATA_AXIS: dp, MODEL_AXIS: mp}
        self.processes = processes

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def graph_refusal(self) -> Optional[str]:
        """Why one CUDA graph cannot hold a step on this mesh, or None when
        it can: every entry is one card and one process drives it (the
        ``[cuda:0] * dp`` mesh). A graph is recorded on one card's streams,
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
        return f"Mesh(shape={self.shape}, devices={[str(d) for d in self.devices]}, processes={self.processes})"


def make_mesh(parallel: Optional[ParallelConfig] = None, devices=None) -> Mesh:
    """The mesh of ``parallel`` over ``devices`` (default: every visible
    card); ``dp=-1`` takes them all. Refuses tensor parallelism."""
    parallel = parallel or ParallelConfig()
    refuse_tensor_parallel(parallel)
    devices = list(devices if devices is not None else visible_devices())
    hosts = process_count()
    n_devices = len(devices) * hosts
    mp = max(parallel.mp, 1)
    dp = parallel.dp if parallel.dp and parallel.dp > 0 else n_devices // mp
    if dp * mp > n_devices:
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} devices, have {n_devices}")
    return Mesh(devices[: (dp // hosts) * mp], dp, mp, hosts)


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
    dict of the i-th contiguous chunk of tasks, on ``mesh.devices[i]``.
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
                tuple((str(d), abstract_signature(s)) for d, s in zip(self.mesh.devices, self.shards)))


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> ShardedBatch:
    """Split the task axis (axis 0) of every array of ``batch`` (numpy or
    tensors) into ``local_dp`` contiguous chunks, chunk ``i`` on
    ``mesh.devices[i]``."""
    n = len(next(iter(batch.values())))
    if n % mesh.local_dp:
        raise ValueError(f"meta-batch of {n} tasks not divisible by the mesh's local dp={mesh.local_dp}")
    per = n // mesh.local_dp
    shards = []
    for i, device in enumerate(mesh.devices[: mesh.local_dp]):
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
              for i, device in enumerate(mesh.devices[: mesh.local_dp])]
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


class Replicated:
    """A state (or any tree of tensors) with one replica per mesh device:
    ``replicas[i]`` lies on ``mesh.devices[i]``, and entries that name the
    same device share one replica. Reading an attribute reads the first
    replica's (``state.params``, ``state.step``)."""

    def __init__(self, mesh: Mesh, replicas: List[Any]):
        self.mesh = mesh
        self.replicas = replicas

    def on(self, device) -> Any:
        """The replica on ``device``."""
        return self.replicas[self.mesh.devices.index(_canonical(device))]

    def __getattr__(self, name):
        if name in ("mesh", "replicas"):
            raise AttributeError(name)
        return getattr(self.replicas[0], name)


def replicate(tree, mesh: Mesh) -> Replicated:
    """``tree`` copied once to each distinct device of the mesh."""
    tree = unreplicate(tree)
    placed: Dict[torch.device, Any] = {}
    for device in mesh.devices:
        if device not in placed:
            placed[device] = move_tree(tree, device)
    return Replicated(mesh, [placed[d] for d in mesh.devices])


def shard_train_state(state, mesh: Mesh, tp_convs: bool = False) -> Replicated:
    """The train state on the mesh: a replica per device while ``mp == 1``
    (the only mesh the port builds)."""
    if tp_convs or mesh.shape[MODEL_AXIS] > 1:
        refuse_tensor_parallel(ParallelConfig(mp=mesh.shape[MODEL_AXIS], tp_convs=tp_convs))
    return replicate(state, mesh)


def unreplicate(tree):
    """The first replica of a :class:`Replicated`, anything else as it is."""
    return tree.replicas[0] if isinstance(tree, Replicated) else tree


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
    ``tcp://coordinator_address`` with NCCL between cards or gloo where
    ``device`` is the CPU (or no card is visible). Unset arguments fall back
    to torch's own environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``
    and ``MASTER_PORT``), where the JAX package reads ``JAX_NUM_PROCESSES``."""
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    on_cpu = (device is not None and torch.device(device).type == "cpu") or not torch.cuda.is_available()
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
