"""Prewarm: build the planned program families before the first step or
request (the JAX package's ``compile/aot.py``).

Strict mode enumerates the planned sets (``utils/strictmode.py``:
``train_planned_programs``, the ``(train | train_multi, second_order,
msl_active)`` variants plus ``eval`` and ``eval_multi``;
``serving_planned_programs``, the engine's ``(kind, shape bucket, batch
bucket)`` grid). :func:`prewarm_train` and :func:`prewarm_serving` walk
them through the system's and the engine's own program caches, so that the
strict guard notes every key (plan and guard cannot drift apart), then seal
the guard (``mark_prewarmed``): from there on a program built outside the
prewarm is a finding.

What a build is differs from JAX's, which lowers and compiles each program
and runs nothing:

- a multi-step program on the card (``train_multi``, ``eval_multi``) is a
  CUDA graph (``core/programs.py``): the prewarm captures it, its warmup on
  a copy of the state, on a zero batch of the config's episode shape placed
  as the run places its chunks. The capture executes nothing, so the real
  state does not move;
- a K = 1 train variant and ``eval`` are eager: the prewarm makes their
  first dispatch on a copy of the state, which pays cuDNN's algorithm choice
  and the allocator's first blocks, and drops the result. On the CPU every
  program is such a first dispatch.

Every build is a ledger entry with ``phase="prewarm"``
(``observability/compile_ledger.py``). The zero batches go through the
step's own placement (``MAMLSystem._step_batches``, ``shard_batch``,
``shard_chunk``) in the loader's dtypes, so the signature a real dispatch
computes is the one prewarmed; a real dispatch of another signature builds
its program under ``phase="prewarm_respec"``.

The jobs run inline, one after another. ``max_workers`` and
``compile_timeout_s`` keep the JAX signature and are ignored: JAX overlaps
XLA compiles in threads under a per-program timeout, but captures and
dispatches to one card serialize on it, and a timed-out job would go on
touching the system after the guard is sealed (the serving engine's
prewarm argues the same).

There is no executable store: a CUDA graph holds raw device addresses of
one process and cannot be serialized, and an eager program has nothing to
keep. What persists across processes is the kernels' build directory
(``ops/_kernels.py::BUILD_DIR``; a library's name hashes its sources and
flags), the counterpart of the JAX persistent compilation cache. The
manifest (:func:`build_manifest`, written beside the checkpoints by
``experiment/checkpoint.py::save_prewarm_manifest`` where
``aot.executable_store`` is on) records the programs, the environment's
fingerprint and the build directory's state; :func:`verify_manifest` tells
a restarted process whether the kernels it needs are there for its
environment. A restart still captures every graph again.
"""

import hashlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_VERSION = 1

#: the fingerprint fields a manifest must match to promise a warm start: the
#: torch and CUDA builds and the card (the code nvcc emitted and the
#: libraries' ABI), the device count and the mesh (the placement every
#: program was built for)
_FINGERPRINT_FIELDS = ("torch", "cuda", "backend", "device_kind", "n_devices", "mesh")

#: the environment-only subset, for a single-device consumer (a serving
#: replica: its programs never take a mesh)
ENVIRONMENT_FIELDS = ("torch", "cuda", "backend", "device_kind")


# ---------------------------------------------------------------------------
# the zero batches
# ---------------------------------------------------------------------------


def zero_train_batch(cfg, leading: Tuple[int, ...] = (), processes: int = 1) -> Dict[str, np.ndarray]:
    """The loader's episode batch as zeros (JAX ``train_batch_spec``, which
    gives shapes only: an eager program needs arrays): leaves shaped
    ``leading + [B, n_way, k, ...]`` in the loader's dtypes (x float32, y
    int32), ``B`` this process's share of ``batch_size * samples_per_iter``."""
    b = cfg.batch_size * cfg.samples_per_iter // processes
    n_way, k, t = cfg.num_classes_per_set, cfg.num_samples_per_class, cfg.num_target_samples
    h, w, c = cfg.image_shape
    lead = tuple(leading)
    return {
        "x_support": np.zeros(lead + (b, n_way, k, h, w, c), np.float32),
        "y_support": np.zeros(lead + (b, n_way, k), np.int32),
        "x_target": np.zeros(lead + (b, n_way, t, h, w, c), np.float32),
        "y_target": np.zeros(lead + (b, n_way, t), np.int32),
    }


def signature_digest(sig: Any) -> Optional[str]:
    """Short stable digest of a program's abstract signature: the
    manifest's program identity."""
    if sig is None:
        return None
    return hashlib.sha256(repr(sig).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------


def _run_jobs(jobs: List[Tuple[str, Callable[[], Any]]], ledger, guard, device,
              on_program: Optional[Callable[[str], None]]) -> Dict[str, Any]:
    """Run every job inline and fold the results and the ledger's delta
    into JAX's summary keys. A job that raises is contained: counted in
    ``errors``, its error in its ``by_program`` row. Each program's
    ``seconds`` is its wall time to the card's idle (the ledger's
    ``total_s`` of an eager dispatch is the host's). Then the guard is
    sealed."""
    before = ledger.summary() if ledger is not None else None
    t0 = time.perf_counter()
    results: Dict[str, Dict[str, Any]] = {}
    errors: Dict[str, str] = {}
    seconds: Dict[str, float] = {}
    for name, job in jobs:
        t = time.perf_counter()
        try:
            results[name] = job() or {}
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except Exception as exc:  # noqa: BLE001 — contained per program
            errors[name] = f"{type(exc).__name__}: {exc}"
        seconds[name] = time.perf_counter() - t
        if on_program is not None:
            on_program(name)
    after = ledger.summary() if ledger is not None else None
    by_program: Dict[str, Dict[str, Any]] = {}
    for name, _ in jobs:
        res = results.get(name, {})
        agg = (after or {}).get("by_program", {}).get(name, {})
        by_program[name] = {
            "signature": signature_digest(res.get("signature")),
            "total_s": agg.get("total_s"),
            "seconds": round(seconds[name], 6),
            "cache_hit": bool(agg.get("cache_hits")),
            "loaded": False,
            "stored": False,
            "already_warm": bool(res.get("already_warm")),
        }
        if "graph" in res:
            by_program[name]["graph"] = res["graph"]
        if name in errors:
            by_program[name]["error"] = errors[name]
    summary = {
        "programs": len(jobs),
        "seconds": round(time.perf_counter() - t0, 3),
        "compile_s": round(after["total_s"] - before["total_s"], 3) if before is not None else None,
        "cache_hits": after["cache_hits"] - before["cache_hits"] if before is not None else 0,
        "store_hits": 0,
        "already_warm": sum(1 for r in results.values() if r.get("already_warm")),
        "errors": len(errors),
        "by_program": by_program,
    }
    if guard is not None:
        # the contract flip: the planned family is now declared complete
        guard.mark_prewarmed()
    return summary


def _place(batch, mesh, chunk: bool):
    """A zero batch (or chunk) placed as the runner places its own."""
    if mesh is None:
        return batch
    from ..parallel.mesh import shard_batch, shard_chunk

    return shard_chunk(batch, mesh) if chunk else shard_batch(batch, mesh)


# ---------------------------------------------------------------------------
# train-side prewarm (MAMLSystem)
# ---------------------------------------------------------------------------


def prewarm_train(
    system,
    state,
    batch_sharding=None,
    chunk_sharding=None,
    max_workers: Optional[int] = None,
    compile_timeout_s: Optional[float] = None,
    on_program: Optional[Callable[[str], None]] = None,
) -> Dict[str, Any]:
    """Build the whole planned train family: exactly
    ``train_planned_programs(cfg)``, in JAX's order (sorted by ``repr``),
    each through its program cache: a ``train_multi`` variant captured at K
    = ``train_steps_per_dispatch``, ``eval_multi`` captured at the split's
    batch count, a ``train`` variant and ``eval`` dispatched once, all on a
    copy of ``state`` and zero batches. ``batch_sharding`` and
    ``chunk_sharding`` are the mesh the run shards its batches and chunks
    over (``None``: no mesh). Attaches a collect-only compile ledger where
    the system has none. ``state`` is not advanced. Returns JAX's summary
    keys (``programs``, ``seconds``, ``compile_s``, ``cache_hits``,
    ``store_hits``, ``already_warm``, ``errors``, ``by_program``) and seals
    the strict guard. ``max_workers`` and ``compile_timeout_s`` are
    ignored (module docstring)."""
    from ..config import kind_base
    from ..core.programs import clone_tree
    from ..observability.compile_ledger import CompileLedger, program_name
    from ..utils.strictmode import train_planned_programs

    del max_workers, compile_timeout_s
    cfg = system.cfg
    if system.compile_ledger is None:
        system.attach_compile_ledger(CompileLedger())
    mesh = chunk_sharding if chunk_sharding is not None else batch_sharding
    processes = mesh.processes if mesh is not None else 1
    batch = _place(zero_train_batch(cfg, processes=processes), batch_sharding, chunk=False)
    k = max(1, cfg.train_steps_per_dispatch)
    chunk = system._step_batches(_place(zero_train_batch(cfg, (k,), processes), chunk_sharding, chunk=True))
    n_eval = max(cfg.num_evaluation_tasks // (cfg.batch_size * cfg.samples_per_iter), 1)
    evals = system._step_batches(_place(zero_train_batch(cfg, (n_eval,), processes), chunk_sharding, chunk=True))
    jobs: List[Tuple[str, Callable[[], Any]]] = []
    for key in sorted(train_planned_programs(cfg), key=repr):
        kind = kind_base(key[0])
        if kind == "train":
            program, args, kwargs = system._compiled_train_step(key[1], key[2]), batch, {"variant": key[1:]}
        elif kind == "train_multi":
            program, args, kwargs = system._compiled_train_multi(key[1], key[2]), chunk, {}
        elif kind == "eval":
            program, args, kwargs = system._compiled_eval_step(), batch, {}
        elif kind == "eval_multi":
            program, args, kwargs = system._compiled_eval_multi(), evals, {}
        else:  # a future planned kind: not built
            continue
        jobs.append((program_name(key),
                     lambda p=program, a=args, kw=kwargs: p.warm(clone_tree(state), a, **kw)))
    return _run_jobs(jobs, system.compile_ledger, system.recompile_guard, system.device, on_program)


# ---------------------------------------------------------------------------
# serving-side prewarm (AdaptationEngine, EnginePool)
# ---------------------------------------------------------------------------


def prewarm_serving(
    engine,
    max_workers: Optional[int] = None,
    compile_timeout_s: Optional[float] = None,
    image_shape: Optional[Tuple[int, int, int]] = None,
    on_program: Optional[Callable[[str], None]] = None,
) -> Dict[str, Any]:
    """Build the full serving grid before the first request: the exact
    ``serving_planned_programs`` set the strict guard pins, (adapt |
    refine | predict) x shape bucket x task-batch bucket, each on zero
    inputs of its planned shapes through the engine's own program tables
    (``AdaptationEngine._prewarm_jobs``). On the card each program is
    captured as a CUDA graph (its warmup runs once); on the CPU each runs
    once. Nothing is kept: no result, no cache or session entry, no change
    to the engine's state; the fault seams do not fire and no dispatch span
    is recorded. Attaches a collect-only compile ledger where the engine
    has none, as JAX's does: each program is an entry with
    ``phase="prewarm"``, priced by the flop counter. Then the guard is
    sealed. ``image_shape`` overrides the config's dataset shape for
    engines serving hand-built models. Returns the JAX summary keys (each
    program's wall seconds and the ledger's ``total_s`` in
    ``by_program``; the cache counters stay 0) and the engine's program
    memory (``pool_bytes``, ``static_bytes``). ``max_workers`` and
    ``compile_timeout_s`` are ignored (module docstring)."""
    from ..observability.compile_ledger import CompileLedger

    del max_workers, compile_timeout_s
    if engine.compile_ledger is None:
        engine.compile_ledger = CompileLedger()
    summary = _run_jobs(engine._prewarm_jobs(image_shape), engine.compile_ledger, engine.recompile_guard,
                        torch.device("cpu"), on_program)
    for row in summary["by_program"].values():
        del row["signature"]
    summary.update(engine.program_memory())
    return summary


def prewarm_pool(pool, **kwargs) -> Dict[str, Any]:
    """Warm every replica of a serving pool (``serving/pool.py``): each
    DISTINCT engine behind it runs its ``AdaptationEngine.prewarm`` exactly
    once; same-device replicas sharing an engine share its warm set.
    Returns the single-engine summary keys (totals summed; seconds are the
    wall cost paid) plus a per-replica table of the engine each replica
    serves through."""
    engines = pool.engines()
    summaries = [engine.prewarm(**kwargs) for engine in engines]
    merged: Dict[str, Any] = {
        "programs": sum(s.get("programs", 0) for s in summaries),
        "seconds": round(sum(s.get("seconds", 0.0) for s in summaries), 3),
        "cache_hits": sum(s.get("cache_hits", 0) for s in summaries),
        "store_hits": sum(s.get("store_hits", 0) for s in summaries),
        "errors": sum(s.get("errors", 0) for s in summaries),
        "by_program": {k: v for s in summaries for k, v in s.get("by_program", {}).items()},
        "pool_bytes": sum(s.get("pool_bytes") or 0 for s in summaries),
    }
    per_replica = []
    for replica in pool.replicas:
        engine_idx = next(i for i, e in enumerate(engines) if e is replica.engine)
        s = summaries[engine_idx]
        per_replica.append({
            "replica": replica.index,
            "engine": engine_idx,
            "shared": sum(1 for r in pool.replicas if r.engine is replica.engine) > 1,
            "programs": s.get("programs", 0),
            "seconds": s.get("seconds", 0.0),
            "errors": s.get("errors", 0),
            "pool_bytes": s.get("pool_bytes"),
        })
    merged["replicas"] = per_replica
    return merged


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------


def environment_fingerprint(mesh_shape=None, device=None) -> Dict[str, Any]:
    """What the built programs and kernels are valid for: the torch and
    CUDA builds, the backend and the card (its name and compute capability:
    the kernels are built for ``sm_90a``), the device count and the mesh
    (``[dp, mp]``).
    ``device``: the run's (default the card where one is visible)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        device_kind = f"{torch.cuda.get_device_name(device)} (sm_{major}{minor})"
        n_devices = torch.cuda.device_count()
    else:
        device_kind, n_devices = device.type, 1
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": device.type,
        "device_kind": device_kind,
        "n_devices": n_devices,
        "mesh": list(mesh_shape) if mesh_shape is not None else None,
    }


def _libraries(build_dir: Optional[str]) -> Optional[List[str]]:
    """The built libraries in ``build_dir``, None where it is gone."""
    try:
        return sorted(name for name in os.listdir(build_dir) if name.endswith(".so"))
    except (OSError, TypeError):
        return None


def cache_state(build_dir: Optional[str] = None) -> Dict[str, Any]:
    """The kernels' build directory (default ``ops/_kernels.py::BUILD_DIR``):
    its library count and a digest of their names (each name hashes its
    sources and flags), the manifest's proof that the libraries it
    promises exist."""
    if build_dir is None:
        from ..ops._kernels import BUILD_DIR as build_dir
    names = _libraries(build_dir) or []
    return {
        "dir": build_dir,
        "entries": len(names),
        "digest": hashlib.sha256("\n".join(names).encode()).hexdigest() if names else None,
    }


def build_manifest(train_summary: Optional[Dict[str, Any]] = None,
                   serving_summary: Optional[Dict[str, Any]] = None, mesh_shape=None,
                   device=None) -> Dict[str, Any]:
    """The prewarm manifest: program name -> signature digest, seconds and
    verdicts, under the environment's fingerprint and the build
    directory's state (JAX's keys; no ``store``: module docstring)."""
    programs: Dict[str, Any] = {}
    for summary in (train_summary, serving_summary):
        if summary:
            programs.update(summary.get("by_program", {}))
    return {
        "version": MANIFEST_VERSION,
        "ts": time.time(),
        "fingerprint": environment_fingerprint(mesh_shape, device),
        "cache": cache_state(),
        "programs": programs,
    }


def verify_manifest(manifest: Optional[Dict[str, Any]], mesh_shape=None,
                    fields: Tuple[str, ...] = _FINGERPRINT_FIELDS, device=None) -> Tuple[bool, Optional[str]]:
    """Will a prewarm in THIS process find its kernels built for its
    environment? ``(True, None)`` where the manifest's fingerprint matches
    the live one (``fields`` of it; ``mesh`` skipped where ``mesh_shape``
    is None) and its build directory still holds every library it
    recorded; ``(False, reason)`` otherwise. Never raises."""
    if not manifest:
        return False, "no prewarm manifest"
    if manifest.get("version") != MANIFEST_VERSION:
        return False, f"unknown manifest version {manifest.get('version')!r}"
    then = manifest.get("fingerprint") or {}
    now = environment_fingerprint(mesh_shape, device)
    for name in fields:
        if name == "mesh" and mesh_shape is None:
            continue  # the caller does not know its mesh yet
        if then.get(name) != now.get(name):
            return False, f"fingerprint mismatch: {name} manifest={then.get(name)!r} != current={now.get(name)!r}"
    cache = manifest.get("cache") or {}
    if not cache.get("entries"):
        return False, "manifest records no built kernel libraries"
    names = _libraries(cache.get("dir"))
    if names is None:
        return False, f"kernel build directory {cache.get('dir')!r} is gone"
    if len(names) < int(cache["entries"]):
        return False, f"kernel build directory {cache.get('dir')} shrank ({len(names)} < {cache['entries']} libraries)"
    return True, None
