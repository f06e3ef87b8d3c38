"""Experiment runner: the JAX package's ``experiment/runner.py`` on one card.

It builds the experiment folder tree, resumes from 'latest' (the loader's
cursor with it), loops ``total_epochs x total_iter_per_epoch`` train steps,
runs ``num_evaluation_tasks/batch_size`` val batches per epoch, appends
``logs/summary_statistics.csv`` rows, writes per-epoch ``lrs.csv`` (and
``betas.csv``), rotates checkpoints, keeps the best-by-validation
checkpoint, and finally evaluates it on the test split into
``logs/test_summary.csv``. Around the steps: the
one-step-lag NaN sentinel with its skip and rollback ladder, SIGTERM/SIGINT
to an emergency checkpoint and exit 75, the wedge watchdog, the
early-divergence abort (exit 3), the async checkpoint writer and run
telemetry. The method names are the JAX runner's, so a reader finds each
counterpart.

The state lives on the system's device (the card unless ``device="cpu"``).
Host copies of it (the rollback anchor, checkpoint snapshots) are taken on
the main thread: the writer and watchdog threads make no CUDA call.

Data and tensor parallelism (``parallel/mesh.py``): the runner builds a
``parallel.dp x parallel.mp`` mesh of ``devices`` (default: every visible
card, or the CPU on request), places the state on it as the JAX runner
does (``shard_train_state(..., tp_convs=parallel.tp_convs)``: the dense
head, and under ``tp_convs`` the conv kernels, split over ``mp``) and
shards every batch over ``dp``. A
config that demands more devices than ``device_probe()`` sees shrinks onto
the largest feasible mesh (the ``degraded_mesh`` event; ``[1, 1]`` means
one device and no mesh), and while degraded each epoch boundary probes
again and grows the mesh back (``mesh_grown``). A resume onto a bigger mesh
than the checkpoint's ``mesh`` bookkeeping is a grow too. Checkpoints are
format 3 with ``checkpoint_shards`` files (0: one per mesh device), format 2
for one; a save gathers the whole state, so its files are the JAX
package's bytes for that state whatever the placement. Across hosts (a
``torch.distributed`` group of more than one process) each process loads
its slice of every batch (the loader's
``host_shard``), the meta-gradient is all-reduced, and evaluation gathers
the per-task values in process order. The fault injector fires at the
``runner.step``, ``checkpoint.read``/``checkpoint.write`` and
``loader.episode`` seams.

The lock-discipline sanitizer (``resilience.sanitizer`` or
``HTYMP_GRAFTSAN=1``, ``tools/graftsan``) is armed before the loader and the
watchdog build their locks, and its findings are ``graftsan_violation``
events. Under ``strict_recompile_guard`` the system's guard snapshot is a
telemetry provider.

The program layer (JAX's runner, ROADMAP.md A10.3-A10.6):
``train_steps_per_dispatch = K`` trains K outer steps per dispatch
(``MAMLSystem.train_step_multi``: a CUDA graph replayed K times on the
card, K eager steps on the CPU) over ``loader.train_batch_chunks``, with the
NaN sentinel's one-dispatch lag over chunks; ``eval_fused_dispatch``
evaluates the whole split in one dispatch (``eval_step_multi``). The
compile ledger (``logs/compile_ledger.jsonl``) records every capture, the
first eager dispatch of each program and each ``nvcc`` build; its observer
sets the ``flops_per_step`` gauge that, with ``peak_flops_per_sec``, gives
the telemetry's ``mfu``. ``profile_dir`` traces iterations [10, 20) of the
first trained epoch ([0, 1) in a shorter one) with ``torch.profiler``, at
K = 1, into ``profile_dir/plugins/profile/<ts>/*.pt.trace.json``
(``utils/profiling.py`` reads it).

On a mesh the chunks and the fused eval's stack are sharded batch by batch
(``parallel/mesh.py::shard_chunk``): one CUDA graph of the sharded step on
a mesh of one card, the sharded eager steps on a mesh over several (the
multi-host path keeps the eval per batch, as JAX's does). Under
``aot.enabled`` the whole planned train family is built before the first
step, inside the watchdog's scope (``_prewarm_programs``,
``compile/aot.py``), and the prewarm manifest is verified before it and
written after it beside the checkpoints.

Buffer donation (``donate_train_state``, ``donate_batch``,
``observability/donation.py``): under ``donate_train_state`` the runner
first runs the A/B self-check (``donation_selfcheck``; a verdict other than
``clean`` is a ``donation_refused`` event and the run trains without
donation), writes the ``donation_audit`` event and gauge (on every run, as
JAX does), keeps the checkpoint writer synchronous, and where the NaN
sentinel discards a step it restores the last good state (the last
checkpoint's host copy): a donated step has already written over the
state it was given.
"""

import contextlib
import dataclasses
import os
import signal
import socket
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import exit_codes
from ..config import Config, save_config
from ..core.maml import MAMLSystem
from ..core.programs import clone_tree
from ..core.train_state import TrainState
from ..data import MetaLearningDataLoader
from ..data.loader import _stack
from ..observability import TelemetryHub
from ..observability import costs as obs_costs
from ..observability.compile_ledger import CompileLedger
from ..observability.memory import MemoryWatermarks
from ..parallel.mesh import (
    all_gather_host,
    all_gather_tasks,
    degraded_mesh_plan,
    grow_mesh_plan,
    make_mesh,
    move_tree,
    process_count,
    process_index,
    requested_mesh_shape,
    shard_batch,
    shard_chunk,
    shard_train_state,
    unreplicate,
    visible_devices,
)
from ..resilience.faults import injector_from
from ..resilience.watchdog import HeartbeatWatchdog
from ..utils.profiling import trace_path
from ..utils.trees import tree_leaves
from . import checkpoint as ckpt
from . import storage


def _mean_std(values):
    arr = np.asarray(values, np.float64)
    return float(arr.mean()), float(arr.std())


def _episode_stats(split: str, ep_losses, ep_accs) -> Dict[str, Any]:
    """Eval statistics over *episodes* (one value per task), the unit the
    published tables use. ``*_std`` is the per-episode standard deviation
    (spread across tasks, not across seeds); ``*_ci95`` is the
    1.96*std/sqrt(n) half-width for the mean."""
    loss_mean, loss_std = _mean_std(ep_losses)
    acc_mean, acc_std = _mean_std(ep_accs)
    n = int(np.size(ep_accs))
    return {
        f"{split}_loss_mean": loss_mean,
        f"{split}_loss_std": loss_std,
        f"{split}_accuracy_mean": acc_mean,
        f"{split}_accuracy_std": acc_std,
        f"{split}_accuracy_ci95": float(1.96 * acc_std / np.sqrt(max(n, 1))),
        f"{split}_num_episodes": n,
    }


def _host(x) -> np.ndarray:
    """A tensor as a host array of at least one dimension."""
    return np.atleast_1d(x.detach().cpu().numpy())


class ExperimentRunner:
    def __init__(
        self,
        cfg: Config,
        system: Optional[MAMLSystem] = None,
        loader: Optional[MetaLearningDataLoader] = None,
        data_root: Optional[str] = None,
        device=None,
        devices=None,
        device_probe=None,
    ):
        """``device``: where the system runs when none is given (default the
        card; ``"cpu"`` on request). ``devices``: the list the mesh draws
        from (default every visible card, or the CPU where the system runs
        there; an entry may repeat). ``device_probe``: the visible-device
        count, read at init and at each epoch boundary while degraded
        (default ``len(devices)`` times the processes), injectable so a
        drill can walk it up and down."""
        self.cfg = cfg
        self._t_init = time.perf_counter()
        self._cold_start_s: Optional[float] = None
        self.system = system or MAMLSystem(cfg, device=device)
        device = self.system.device
        self._devices = list(devices) if devices is not None else visible_devices(device)
        self._device_probe = device_probe or (lambda: len(self._devices) * process_count())
        self._feature_shape = self.system.model.feature_shape
        self.run_dir = cfg.run_dir()
        self.saved_models_dir, self.logs_dir, self.visual_dir = storage.build_experiment_folder(self.run_dir)
        save_config(cfg, os.path.join(self.run_dir, "config.yaml"))
        self.experiment_name = cfg.run_name()
        storage.create_json_experiment_log(self.logs_dir, self.experiment_name, cfg.to_dict())
        # events.jsonl: appends flushed immediately, closed on every exit
        # path (run_experiment's finally; the wedge path closes it itself)
        self.events = storage.EventLog(self.logs_dir)
        # span tracer + metrics registry + logs/telemetry.jsonl snapshots;
        # inert when observability.enabled is false
        self.hub = TelemetryHub.from_config(cfg.observability, logs_dir=self.logs_dir)
        # the device memory watermarks: a provider of every telemetry
        # snapshot, and one hbm_headroom_low event per card before an OOM
        self._memory: Optional[MemoryWatermarks] = None
        # the compile ledger prices every program build into
        # logs/compile_ledger.jsonl and feeds the flops_per_step gauge the
        # live MFU reads; inert with the hub disabled
        self._compile_ledger: Optional[CompileLedger] = None
        if self.hub.enabled:
            kind = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
            self.hub.registry.set_gauge("device_kind", kind)
            peak = obs_costs.peak_flops_per_sec(kind)
            if peak:
                self.hub.registry.set_gauge("peak_flops_per_sec", peak)
            else:
                self.hub.registry.set_gauge("mfu_unavailable_reason",
                                            f"no peak-FLOPs table entry for device_kind {kind!r}")
            if cfg.observability.memory_watermarks:
                self._memory = MemoryWatermarks(cfg.observability.hbm_headroom_warn_frac)
            if cfg.observability.compile_ledger:
                self._compile_ledger = CompileLedger(logs_dir=self.logs_dir, session=self.hub.session_id)
                self._compile_ledger.on_entry = self._note_program_cost
                self.system.attach_compile_ledger(self._compile_ledger)
                self._record_kernel_builds()
        # program variants already run once (second order x MSL): the first
        # step of each is tagged cold in the trace
        self._variants_seen: set = set()
        # the profiler window: open between its first and last step
        self._profiled = False
        self._profiler = None

        # graftsan lock-discipline sanitizer: armed here, before the loader
        # pool and the watchdog build their locks, so that every lock built
        # through the utils/locks.py factories is instrumented; violations
        # land in this run's events.jsonl as graftsan_violation records
        if cfg.resilience.sanitizer or os.environ.get("HTYMP_GRAFTSAN") == "1":
            try:
                from tools.graftsan import runtime as _graftsan_runtime

                _graftsan_runtime.arm()
                _graftsan_runtime.add_sink(self.events.append)
            except ImportError:  # packaged without tools/: sanitizer off
                pass

        # fault injector (inert unless cfg.resilience.faults / HTYMP_FAULTS
        # name a drill), NaN-ladder counters, preemption flag
        self._injector = injector_from(cfg.resilience)
        self._bad_steps = 0  # consecutive non-finite steps discarded
        self._rollbacks = 0  # rollbacks spent (rc=3 after max_rollbacks more)
        self._last_good = None  # host-side TrainState copy for rollback
        self._preempt_signum: Optional[int] = None
        self._resume_mid_iter = 0  # >0: start_epoch was preempted mid-epoch

        # --- resume (reference continue_from_epoch: latest) ---
        self.state: TrainState = self.system.init_train_state()
        self.start_epoch = 0
        self.best_val_accuracy = -1.0
        self.best_val_epoch = -1
        # epoch -> val accuracy, for best_val checkpoint rotation and top-K
        # test ensembling (persisted in checkpoint bookkeeping)
        self.val_acc_by_epoch: Dict[int, float] = {}
        # the (dp, mp) the resumed checkpoint was written under (bookkeeping
        # "mesh"): growing past it on resume is a mesh_grown event
        self._resume_prev_mesh = None
        idx = cfg.continue_from_epoch
        resumable = idx not in ("", "scratch", None)
        if resumable and not ckpt.checkpoint_exists(self.saved_models_dir, idx):
            # 'latest' missing = a fresh run; a *named* epoch missing is a
            # user error: fail fast instead of silently training anew
            if idx != "latest":
                raise FileNotFoundError(
                    f"continue_from_epoch={idx!r} but no such checkpoint in "
                    f"{self.saved_models_dir} (have epochs "
                    f"{ckpt.available_epochs(self.saved_models_dir)})"
                )
            resumable = False
        if resumable:
            if idx == "latest":
                # a corrupt 'latest' is quarantined and the newest valid
                # epoch file resumes instead
                self.state, bookkeeping, used_idx = ckpt.load_latest_with_fallback(
                    self.saved_models_dir, self.state, self._injector, feature_shape=self._feature_shape
                )
            else:
                self.state, bookkeeping = ckpt.load_checkpoint(
                    self.saved_models_dir, idx, self.state, self._injector, feature_shape=self._feature_shape
                )
                used_idx = idx
            self.start_epoch = int(bookkeeping.get("epoch", -1)) + 1
            # a preemption checkpoint carries the mid-epoch iteration cursor:
            # start_epoch is then the interrupted epoch, resumed at exactly
            # the next iteration (the loader cursor below matches)
            self._resume_mid_iter = int(bookkeeping.get("mid_epoch_iter", 0) or 0)
            self.best_val_accuracy = float(bookkeeping.get("best_val_accuracy", -1.0))
            self.best_val_epoch = int(bookkeeping.get("best_val_epoch", -1))
            self.val_acc_by_epoch = {
                int(k): float(v) for k, v in (bookkeeping.get("val_acc_by_epoch") or {}).items()
            }
            prev_mesh = bookkeeping.get("mesh")
            if prev_mesh is not None:
                self._resume_prev_mesh = [int(x) for x in prev_mesh]
            storage.change_json_log_experiment_status(
                self.logs_dir, self.experiment_name,
                f"resumed at epoch {self.start_epoch}"
                + (f" iter {self._resume_mid_iter}" if self._resume_mid_iter else "")
                + (f" (from {used_idx})" if used_idx != idx else ""),
            )

        # --- mesh (none on one device) ---
        print(f"device={device} devices={len(self._devices)} processes={process_count()}", flush=True)
        global_batch_size = cfg.batch_size * cfg.samples_per_iter
        self._global_batch_size = global_batch_size
        self.mesh = None
        # elastic degraded resume: fewer visible devices than the config
        # demands shrink the mesh to the largest feasible one instead of
        # failing; a lost device costs throughput, not the run
        self.degraded_mesh: Optional[Dict[str, Any]] = None
        parallel = cfg.parallel
        n_visible = int(self._device_probe())
        if parallel.shard_meta_batch:
            plan = degraded_mesh_plan(parallel, n_visible, global_batch_size)
            if plan is not None:
                dp_req, mp_req = requested_mesh_shape(parallel, n_visible)
                dp, mp = plan
                parallel = dataclasses.replace(parallel, dp=dp, mp=mp)
                self.degraded_mesh = {"requested": [dp_req, mp_req], "granted": [dp, mp],
                                      "visible_devices": n_visible}
                msg = (
                    f"DEGRADED MESH: config demands dp={dp_req} x mp={mp_req} "
                    f"but only {n_visible} device(s) are visible — continuing "
                    + (f"on a shrunken dp={dp} x mp={mp} mesh" if dp * mp > 1 else "on a single device")
                    + " at reduced throughput"
                )
                print(msg, flush=True)
                self.events.append({"ts": time.time(), "event": "degraded_mesh", **self.degraded_mesh})
                storage.change_json_log_experiment_status(self.logs_dir, self.experiment_name, msg)
        if parallel.shard_meta_batch and n_visible > 1 and (
            self.degraded_mesh is None or self.degraded_mesh["granted"] != [1, 1]
        ):
            mesh = make_mesh(parallel, self._devices)
            if global_batch_size % mesh.shape["dp"] != 0:
                # a silent fall-back to one device would hide a misconfigured
                # mesh; a degraded plan always picks a dp dividing the batch
                raise ValueError(
                    f"meta-batch ({global_batch_size}) not divisible by dp="
                    f"{mesh.shape['dp']}: adjust batch_size/samples_per_iter "
                    "or parallel.dp, or set parallel.shard_meta_batch=false "
                    "to deliberately train on a single device"
                )
            self.mesh = mesh
            # the state placed on the mesh (a degraded resume re-places the
            # restored state onto the shrunken mesh here): whole replicas on
            # a dp mesh, the JAX runner's tensor-parallel split on dp x mp
            self.state = shard_train_state(self.state, self.mesh, tp_convs=cfg.parallel.tp_convs)

        # resume-side grow-back: the checkpoint was written under a smaller
        # mesh than this process just built
        granted_now = self._mesh_shape()
        if (
            self._resume_prev_mesh is not None
            and granted_now[0] * granted_now[1] > self._resume_prev_mesh[0] * self._resume_prev_mesh[1]
        ):
            self._note_mesh_grown(previous=self._resume_prev_mesh, granted=granted_now, n_visible=n_visible)

        # one-save-lag checkpoint writer: serialization off the step path.
        # Synchronous under donation, as in the JAX runner: a donated step
        # writes into the state a lagged save would still be reading
        self._ckpt_writer: Optional[ckpt.AsyncCheckpointWriter] = (
            ckpt.AsyncCheckpointWriter() if cfg.checkpoint_async and not cfg.donate_train_state else None
        )
        # multi-host: each process loads only its slice of the global
        # meta-batch. Host slicing without a mesh would leave every process
        # training alone on a fraction of the batch: refuse instead
        self._multihost = process_count() > 1
        if self._multihost and self.mesh is None:
            raise RuntimeError(
                "multi-host run but no usable device mesh: enable "
                "parallel.shard_meta_batch and make batch_size divisible by dp"
            )
        host_shard = (process_index(), process_count()) if self._multihost else None
        # the runner shuts an owned loader down when run_experiment exits; a
        # caller-supplied loader is the caller's to close
        self._owns_loader = loader is None
        self.loader = loader or MetaLearningDataLoader(
            cfg,
            # mid-epoch resume: the stream restarts on the exact next iteration
            current_iter=self.start_epoch * cfg.total_iter_per_epoch + self._resume_mid_iter,
            data_root=data_root,
            host_shard=host_shard,
            injector=self._injector,
        )
        # rollback anchor: the state as it is now (resumed or init),
        # refreshed on every epoch save
        self._capture_last_good()
        # the wedge watchdog's emergency-checkpoint anchor: ONE tuple
        # (host state, bookkeeping) rebound atomically, so the watchdog
        # thread never pairs a fresh state with stale bookkeeping
        self._wedge_anchor = (
            self._last_good,
            {
                "epoch": self.start_epoch - 1,
                "mid_epoch_iter": self._resume_mid_iter,
                "mesh": self._mesh_shape(),
                "train_episodes_produced": self.loader.train_episodes_produced,
                "best_val_accuracy": self.best_val_accuracy,
                "best_val_epoch": self.best_val_epoch,
                "val_acc_by_epoch": {str(k): v for k, v in self.val_acc_by_epoch.items()},
            },
        )

        # --- wedge watchdog: armed for run_experiment, fed by per-step
        # progress marks; no progress past the deadline => thread stacks
        # into events.jsonl, emergency checkpoint from _wedge_anchor, exit 76
        wd_cfg = cfg.resilience.watchdog
        self._watchdog: Optional[HeartbeatWatchdog] = None
        if wd_cfg.enabled:
            self._watchdog = HeartbeatWatchdog(
                deadline_s=wd_cfg.deadline_s,
                poll_s=wd_cfg.poll_s,
                on_wedge=self._on_wedge,
                exit_code=wd_cfg.wedge_exit_code,
                name="runner",
            )
        if self.hub.enabled:
            if self.system.recompile_guard is not None:
                self.hub.add_provider("recompile_guard", self.system.recompile_guard.snapshot)
            if self._watchdog is not None:
                self.hub.add_provider("watchdog_beat_age_s", lambda: round(self._watchdog.beat_age_s(), 3))
            self.hub.add_provider("loader", self.loader.stats)
            if self._memory is not None:
                self.hub.add_provider("memory", self._memory.snapshot)
            if self.degraded_mesh is not None:
                self.hub.registry.set_gauge("degraded_mesh", self.degraded_mesh)
            if self._compile_ledger is not None:
                self.hub.add_provider("compile_ledger", self._compile_ledger.summary)

    # ------------------------------------------------------------------

    def _traced_batches(self, iterable, epoch: int):
        """Wrap a loader stream so time blocked on episode assembly is the
        ``data_wait`` phase. The span closes before the batch is yielded, so
        an abandoned iterator (preemption break) never leaves a span open."""
        it = iter(iterable)
        while True:
            with self.hub.phase("data_wait", epoch=epoch):
                try:
                    batch = next(it)
                except StopIteration:
                    return
            yield batch

    def _note_variant(self, key) -> bool:
        """True exactly once per program variant."""
        if key in self._variants_seen:
            return False
        self._variants_seen.add(key)
        return True

    def _note_program_cost(self, entry: Dict[str, Any]) -> None:
        """Compile-ledger observer: when a train program is priced, publish
        its FLOPs per meta-step as the gauge the live MFU reads (a
        ``train_multi`` entry prices K steps, so its FLOPs divide by K)."""
        flops = entry.get("flops")
        program = entry.get("program") or ""
        if not flops:
            return
        if program.startswith("train_multi/"):
            flops = flops / max(1, self.cfg.train_steps_per_dispatch)
        elif not program.startswith("train/"):
            return
        self.hub.registry.set_gauge("flops_per_step", flops)
        if entry.get("bytes_accessed"):
            self.hub.registry.set_gauge("train_step_bytes_accessed", entry["bytes_accessed"])

    def _record_kernel_builds(self) -> None:
        """On the card with the fused update: build the kernels now (one
        ``nvcc`` per missing source, all at once) and record each source in
        the ledger, instead of inside the first step."""
        if not (self.cfg.use_pallas_inner_update and self.system.device.type == "cuda"):
            return
        from ..ops import _kernels

        self._compile_ledger.record_kernel_builds(_kernels.build(), _kernels.BUILD_DIR)

    def _close_compile_ledger(self) -> None:
        if self._compile_ledger is not None:
            try:
                self._compile_ledger.close()
            except Exception:
                # a failing close (full disk) must not skip the closes after
                # it or mask the run's exception
                pass

    def _train_epoch(self, epoch: int) -> Dict[str, Any]:
        cfg = self.cfg
        losses, accs, lr = [], [], 0.0
        start = time.time()
        # mid-epoch resume: only the remaining iterations of the interrupted
        # epoch (the loader cursor already points at the next one)
        skipped = self._resume_mid_iter if epoch == self.start_epoch else 0
        total_iters = cfg.total_iter_per_epoch - skipped
        # the profiling window: iterations [10, 20) of the first trained
        # epoch, past the first dispatches; the profiled epoch keeps K = 1,
        # so that the window stays per step
        profile_this_epoch = bool(cfg.profile_dir) and not self._profiled
        prof_start, prof_stop = (10, 20) if total_iters >= 20 else (0, 1)
        K = 1 if profile_this_epoch else max(1, cfg.train_steps_per_dispatch)
        n_chunks, single_iters = divmod(total_iters, K)

        # --- NaN sentinel (resilience.nan_guard) -----------------------
        # Each dispatch's loss is judged on the host with a ONE-dispatch
        # lag: dispatch i-1's losses are fetched only after dispatch i has
        # been issued, so the host keeps enqueueing while the card works. A
        # non-finite loss discards the poisoned dispatch (and the one issued
        # on top of it) by restoring the state captured before it; the
        # episode stream moves on past the bad batches. An eager step never
        # writes into the tensors of the state it was given; a multi-step
        # graph does (MAMLSystem.state_in_place), so there the captured
        # state is a copy.
        guard = cfg.resilience.nan_guard
        # (state_before, loss, accuracy, forced_nan, cold, episodes, steps)
        pending = None

        def settle() -> bool:
            """Judge the pending dispatch; True = good (stats recorded)."""
            nonlocal pending
            state_before, loss_dev, acc_dev, forced, cold, episodes, steps = pending
            pending = None
            # the lagged fetch of dispatch i-1 while dispatch i is queued:
            # the pipeline's real device wait
            with self.hub.phase("settle", epoch=epoch, cold=cold):
                loss_host = _host(loss_dev)
            self._beat(f"settle epoch {epoch}")
            if forced or not np.all(np.isfinite(loss_host)):
                # a donated step wrote over the state it was given: the
                # last good state is the last checkpoint's host copy
                self.state = self._place_state(self._last_good) if cfg.donate_train_state else state_before
                return False
            losses.append(loss_host)
            accs.append(_host(acc_dev))
            # a good step breaks the streak: the K threshold counts
            # CONSECUTIVE discards
            self._bad_steps = 0
            self.hub.step_completed(episodes, steps=steps)
            self._note_cold_start()
            return True

        preempted = False
        undispatched = 0  # drawn from the loader, never trained on
        if K > 1:
            chunk_episodes = K * self.loader.batch_size
            in_place = guard and self.system.state_in_place
            for chunk in self._traced_batches(self.loader.train_batch_chunks(n_chunks, K, augment_images=True),
                                              epoch):
                if self._preempt_signum is not None:
                    preempted, undispatched = True, K
                    break
                forced = self._injector.fire("runner.step") == "nan-loss"
                cold = self._note_variant(("multi", self.system.use_second_order(epoch),
                                           self.system.msl_active(epoch)))
                before = clone_tree(self.state) if in_place else self.state
                with self.hub.phase("dispatch", epoch=epoch, cold=cold):
                    self.state, (chunk_losses, chunk_accs, chunk_lrs) = self.system.train_step_multi(
                        self.state, self._put_chunk(chunk), epoch)
                self._beat(f"dispatch epoch {epoch}")
                lr = chunk_lrs[-1]
                if not guard:
                    losses.append(chunk_losses)
                    accs.append(chunk_accs)
                    self.hub.step_completed(chunk_episodes, steps=K)
                    self._note_cold_start()
                    continue
                if pending is not None and not settle():
                    # settle() restored the pre-poison state, which also
                    # discards the dispatch just issued on top of it
                    self._note_bad_step(epoch)
                    continue
                pending = (before, chunk_losses, chunk_accs, forced, cold, chunk_episodes, K)
        else:
            single_iters = total_iters
        if not preempted:
            for it, batch in enumerate(self._traced_batches(
                    self.loader.train_batches(single_iters, augment_images=True), epoch)):
                if self._preempt_signum is not None:
                    preempted, undispatched = True, 1
                    break
                if profile_this_epoch and it == prof_start:
                    self._start_profile()
                # the runner.step seam: nan-loss marks this step poisoned for
                # the sentinel, sigterm reaches the preemption handler, delay
                # hangs the step for the wedge watchdog
                forced = self._injector.fire("runner.step") == "nan-loss"
                cold = self._note_variant(("single", self.system.use_second_order(epoch),
                                           self.system.msl_active(epoch)))
                before = self.state
                # the dispatch phase is host work: the batch's copy to the
                # device(s) and the step's kernel launches
                with self.hub.phase("dispatch", epoch=epoch, cold=cold):
                    self.state, out = self.system.train_step(self.state, self._put(batch), epoch=epoch)
                self._beat(f"dispatch epoch {epoch}")
                if profile_this_epoch and it == prof_stop - 1:
                    self._stop_profile()
                lr = out.learning_rate
                if not guard:
                    losses.append(out.loss)
                    accs.append(out.accuracy)
                    self.hub.step_completed(self.loader.batch_size)
                    self._note_cold_start()
                    continue
                if pending is not None and not settle():
                    self._note_bad_step(epoch)
                    continue
                pending = (before, out.loss, out.accuracy, forced, cold, self.loader.batch_size, 1)
        # drain the lagged check (also before an emergency save: the saved
        # state must be a settled-good one)
        if pending is not None and not settle():
            self._note_bad_step(epoch)
        if preempted or self._preempt_signum is not None:
            self._emergency_exit(epoch, undispatched=undispatched)
        # with the guard off the entries are device tensors: one fetch each
        # here, after the loop
        losses = np.concatenate([_host(x) if torch.is_tensor(x) else x for x in losses] or [np.zeros(0)])
        accs = np.concatenate([_host(x) if torch.is_tensor(x) else x for x in accs] or [np.zeros(0)])
        if losses.size == 0:
            # every step of the epoch was discarded as non-finite
            losses = accs = np.asarray([np.nan])
        loss_mean, loss_std = _mean_std(losses)
        acc_mean, acc_std = _mean_std(accs)
        return {
            "train_loss_mean": loss_mean,
            "train_loss_std": loss_std,
            "train_accuracy_mean": acc_mean,
            "train_accuracy_std": acc_std,
            # once per epoch, after the loop and the losses' fetch above,
            # which already waited for the card  # graftlint: disable=GL110
            "learning_rate": float(lr),
            "epoch_run_time": time.time() - start,
        }

    def _start_profile(self) -> None:
        """Open the ``torch.profiler`` window (the card's timeline too where
        the system runs on one)."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.system.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()

    def _stop_profile(self) -> None:
        """Close the window after the device has finished its steps, and
        write the Chrome trace where ``jax.profiler`` writes its xplanes."""
        if self.system.device.type == "cuda":
            torch.cuda.synchronize(self.system.device)
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
        prof.export_chrome_trace(trace_path(self.cfg.profile_dir, stamp, socket.gethostname()))
        self._profiled = True

    # ------------------------------------------------------------------
    # resilience: NaN skip/rollback ladder, preemption, wedge
    # ------------------------------------------------------------------

    def _beat(self, stage: str) -> None:
        """Progress mark feeding the wedge watchdog (no-op when disabled)."""
        if self._watchdog is not None:
            self._watchdog.beat(stage)

    def _note_cold_start(self) -> None:
        """First settled train step: runner init -> first useful step,
        as a gauge and an event."""
        if self._cold_start_s is not None:
            return
        self._cold_start_s = round(time.perf_counter() - self._t_init, 3)
        if self.hub.enabled:
            self.hub.registry.set_gauge("cold_start_s", self._cold_start_s)
        self.events.append(
            {"ts": time.time(), "event": "cold_start", "cold_start_s": self._cold_start_s,
             "prewarmed": bool(self.cfg.aot.enabled)}
        )

    # ------------------------------------------------------------------
    # the prewarm (compile/aot.py; Config.aot)
    # ------------------------------------------------------------------

    def _prewarm_programs(self) -> None:
        """Build the whole planned train family before the first step (the
        set the strict guard enforces), each build a ledger entry with
        ``phase="prewarm"``, placed on the run's mesh; then write the
        manifest beside the checkpoints. An existing manifest is verified
        first (event ``prewarm_manifest``): a torch, CUDA, card or mesh
        change, or a missing kernel library, is logged and the prewarm
        builds cold. A prewarm that fails is contained (event
        ``prewarm_failed``; a failed program counts in ``errors``): the run
        goes on and builds it at its first dispatch."""
        from ..compile import aot

        cfg = self.cfg
        device = self.system.device
        mesh_shape = self._mesh_shape()
        expected_warm, reason = aot.verify_manifest(ckpt.load_prewarm_manifest(self.saved_models_dir), mesh_shape,
                                                    device=device)
        self.events.append({"ts": time.time(), "event": "prewarm_manifest", "expected_warm": expected_warm,
                            "reason": reason})
        if not expected_warm:
            print(f"prewarm: no warm-start promise ({reason})", flush=True)
        try:
            summary = self.system.prewarm(
                self.state, batch_sharding=self.mesh, chunk_sharding=self.mesh,
                # each program is watchdog progress: a long planned set must
                # never read as a wedge
                on_program=lambda name: self._beat(f"prewarm {name}"),
            )
        except Exception as exc:  # noqa: BLE001 — a prewarm must not kill the run
            print(f"warning: prewarm failed (continuing cold): {exc!r}", flush=True)
            self.events.append({"ts": time.time(), "event": "prewarm_failed", "error": repr(exc)})
            return
        slim = {k: v for k, v in summary.items() if k != "by_program"}
        print(f"prewarm: {summary['programs']} programs in {summary['seconds']}s ({summary['errors']} errors)",
              flush=True)
        self.events.append({"ts": time.time(), "event": "prewarm", **slim})
        if self.hub.enabled:
            self.hub.registry.set_gauge("prewarm", slim)
        if cfg.aot.executable_store:
            try:
                ckpt.save_prewarm_manifest(
                    self.saved_models_dir, aot.build_manifest(train_summary=summary, mesh_shape=mesh_shape,
                                                              device=device))
            except OSError as exc:
                print(f"warning: prewarm manifest not written: {exc!r}", flush=True)

    # ------------------------------------------------------------------
    # buffer donation (observability/donation.py; Config.donate_*)
    # ------------------------------------------------------------------

    def _donation_gate(self) -> None:
        """The donation A/B on this run's device; state donation is refused
        on any verdict but ``clean``, a self-check that fails included.
        Runs before the first step."""
        from ..observability import donation

        self._beat("donation_selfcheck")
        try:
            result = donation.donation_selfcheck(self.cfg, device=self.system.device)
        except Exception as exc:  # noqa: BLE001 — an uncertified device trains without donation
            result = {"verdict": "selfcheck_failed", "error": f"{type(exc).__name__}: {exc}"}
        self._beat("donation_selfcheck done")
        if result["verdict"] == "clean":
            self.events.append({"ts": time.time(), "event": "donation_selfcheck", **result})
            return
        self.cfg.donate_train_state = False
        msg = (f"DONATION REFUSED: the self-check's verdict is {result['verdict']!r} on "
               f"{result.get('backend', self.system.device.type)}; training without donation")
        print(msg, flush=True)
        self.events.append({"ts": time.time(), "event": "donation_refused", **result})
        storage.change_json_log_experiment_status(self.logs_dir, self.experiment_name, msg)

    def _note_donation_audit(self) -> None:
        """One ``donation_audit`` event (and gauge), and the audit's bytes
        in the compile ledger. An audit that fails costs the event, never
        the run."""
        from ..observability import donation

        try:
            audit = donation.donation_audit(self.cfg, self.state)
        except Exception as exc:  # noqa: BLE001 — bookkeeping only
            print(f"warning: donation audit unavailable: {exc!r}", flush=True)
            return
        self.events.append({"ts": time.time(), "event": "donation_audit", **audit})
        if self._compile_ledger is not None:
            self._compile_ledger.note_donation(audit)
        if self.hub.enabled:
            self.hub.registry.set_gauge("donation", {"flags": audit["flags"], "donated_bytes": audit["donated_bytes"],
                                                     "left_on_table_bytes": audit["left_on_table_bytes"]})

    def _drain_ckpt_writer(self) -> None:
        """Block until any in-flight async save lands; a failed save is
        reported (events + stderr) but never masks the caller's own exit
        path."""
        if self._ckpt_writer is None:
            return
        try:
            self._ckpt_writer.wait()
        except Exception as exc:  # noqa: BLE001 — surfaced, not fatal here
            print(f"warning: async checkpoint save failed: {exc!r}", flush=True)
            try:
                self.events.append({"ts": time.time(), "event": "checkpoint_save_failed", "error": repr(exc)})
            except Exception:
                pass

    def _on_wedge(self, info: Dict[str, Any]) -> None:
        """Watchdog verdict: no progress past the deadline. Runs ON THE
        WATCHDOG THREAD and stays on the host: the event with every thread's
        stack, an emergency 'latest' checkpoint from the last settled host
        state, then the watchdog exits with the wedge code. Each salvage
        step is independent."""
        code = self.cfg.resilience.watchdog.wedge_exit_code
        msg = (
            f"WEDGED: no progress for {info['stall_s']:.0f}s "
            f"(deadline {info['deadline_s']:.0f}s) at stage {info['stage']!r} "
            f"— emergency checkpoint from the last settled state, exiting "
            f"{code} (restart to resume)"
        )
        print(msg, flush=True)
        try:
            self.events.append(
                {"ts": time.time(), "event": "wedged", "stage": info["stage"], "stall_s": info["stall_s"],
                 "beats": info["beats"], "threads": info["threads"]}
            )
        except Exception:
            pass
        # not draining the async writer: per-thread temp files and atomic
        # renames keep both writes whole, and the last rename wins
        try:
            anchor_state, anchor_book = self._wedge_anchor  # one atomic read
            ckpt.save_named(self.saved_models_dir, anchor_state, dict(anchor_book), "latest", self._injector,
                            feature_shape=self._feature_shape)
            self.events.append(
                {"ts": time.time(), "event": "wedge_checkpoint", "epoch": anchor_book.get("epoch"),
                 "mid_epoch_iter": anchor_book.get("mid_epoch_iter")}
            )
        except Exception:
            import traceback

            traceback.print_exc()
        try:
            storage.change_json_log_experiment_status(self.logs_dir, self.experiment_name, msg)
        except Exception:
            pass
        # os._exit skips finally blocks: flush telemetry and close the
        # ledger and the event log here
        try:
            self.hub.close()
        except Exception:
            pass
        self._close_compile_ledger()
        self.events.close()

    def _put(self, batch):
        """A loader batch as the step takes it: sharded over the mesh, or
        as it is (the system copies it to its device)."""
        return shard_batch(batch, self.mesh) if self.mesh is not None else batch

    def _put_chunk(self, chunk):
        """A chunk (or the fused eval's stack) as the multi-step programs
        take it: sharded batch by batch over the mesh, or as it is."""
        return shard_chunk(chunk, self.mesh) if self.mesh is not None else chunk

    def _host_state(self) -> TrainState:
        """The whole state (gathered on a mesh) copied to the host, on the
        main thread. On the CPU under donation a copy: the next step writes
        into the live state's tensors."""
        host = move_tree(unreplicate(self.state), "cpu")
        return clone_tree(host) if self.cfg.donate_train_state and self.system.device.type == "cpu" else host

    def _place_state(self, host_state: TrainState) -> TrainState:
        """A host state placed as the run places its state (a fresh copy
        under donation, so that the host state stays as it is)."""
        if self.mesh is not None:
            state = shard_train_state(host_state, self.mesh, tp_convs=self.cfg.parallel.tp_convs)
        else:
            state = move_tree(host_state, self.system.device)
        return clone_tree(state) if self.cfg.donate_train_state and self.system.device.type == "cpu" else state

    # ------------------------------------------------------------------
    # elastic mesh grow-back (parallel/mesh.py::grow_mesh_plan)
    # ------------------------------------------------------------------

    def _mesh_shape(self):
        """The (dp, mp) in use, [1, 1] without a mesh."""
        if self.mesh is None:
            return [1, 1]
        return [int(self.mesh.shape["dp"]), int(self.mesh.shape["mp"])]

    def _checkpoint_shards(self) -> int:
        """Format-3 shard count: the config's, or (0) one per mesh device."""
        n = self.cfg.checkpoint_shards
        if n == 0:
            n = int(self.mesh.size) if self.mesh is not None else 1
        return max(n, 1)

    def _note_mesh_grown(self, previous, granted, n_visible: int) -> None:
        dp_req, mp_req = requested_mesh_shape(self.cfg.parallel, n_visible)
        full = granted == [dp_req, mp_req]
        info = {"previous": list(previous), "granted": list(granted), "requested": [dp_req, mp_req],
                "visible_devices": n_visible}
        msg = (
            f"MESH GROWN: dp={previous[0]} x mp={previous[1]} -> dp={granted[0]} x mp={granted[1]} "
            f"({n_visible} device(s) visible" + ("" if full else f"; config demands dp={dp_req} x mp={mp_req}")
            + ") — recovered capacity, training continues"
        )
        print(msg, flush=True)
        self.events.append({"ts": time.time(), "event": "mesh_grown", **info})
        storage.change_json_log_experiment_status(self.logs_dir, self.experiment_name, msg)
        self.degraded_mesh = None if full else {"requested": [dp_req, mp_req], "granted": list(granted),
                                                "visible_devices": n_visible}
        if self.hub.enabled:
            self.hub.registry.set_gauge("degraded_mesh", self.degraded_mesh)
            self.hub.registry.set_gauge("mesh_grown", info)

    def _maybe_grow_mesh(self) -> bool:
        """Epoch-boundary grow-back: while degraded, one device-count probe
        decides whether more devices are visible than the mesh uses; if the
        grow plan improves on it, the settled state is re-placed onto the
        bigger mesh. Nothing runs when the mesh is healthy. True on a grow."""
        if (
            self.degraded_mesh is None
            or not self.cfg.elastic_grow
            or self._multihost
            or not self.cfg.parallel.shard_meta_batch
        ):
            return False
        n_visible = int(self._device_probe())
        current = tuple(self.degraded_mesh["granted"])
        plan = grow_mesh_plan(self.cfg.parallel, n_visible, self._global_batch_size, current)
        if plan is None:
            return False
        dp, mp = plan
        # one host round trip per grow (rare), the path a degraded resume
        # takes without the process restart
        host_state = self._host_state()
        self.mesh = make_mesh(dataclasses.replace(self.cfg.parallel, dp=dp, mp=mp), self._devices)
        self.state = shard_train_state(host_state, self.mesh, tp_convs=self.cfg.parallel.tp_convs)
        # the JAX runner drops the programs built for the degraded mesh here;
        # strict mode re-plans the same family
        self.system.drop_compiled_programs()
        self._variants_seen.clear()
        self._note_mesh_grown(previous=list(current), granted=[dp, mp], n_visible=n_visible)
        return True

    def _capture_last_good(self) -> None:
        self._last_good = self._host_state()

    def _note_bad_step(self, epoch: int) -> None:
        """One discarded non-finite step. After ``max_consecutive_bad_steps``
        (K) discards, roll the state back to the last checkpointed state
        with an outer-LR backoff; after ``max_rollbacks`` (M) rollbacks,
        give up with exit code 3. The episode cursor is NOT rewound:
        replaying the same stream into the same state would reproduce the
        same NaN."""
        res = self.cfg.resilience
        self._bad_steps += 1
        self.events.append(
            {"ts": time.time(), "event": "nan_step_skipped", "epoch": epoch, "consecutive": self._bad_steps}
        )
        print(
            f"warning: non-finite step loss at epoch {epoch} — step discarded "
            f"({self._bad_steps}/{res.max_consecutive_bad_steps} consecutive)",
            flush=True,
        )
        if self._bad_steps < res.max_consecutive_bad_steps:
            return
        if self._rollbacks >= res.max_rollbacks:
            msg = (
                f"NAN ABORT: {self._bad_steps} consecutive non-finite steps "
                f"after {self._rollbacks} rollbacks — unrecoverable"
            )
            print(msg, flush=True)
            self.events.append({"ts": time.time(), "event": "nan_abort", "epoch": epoch})
            storage.change_json_log_experiment_status(self.logs_dir, self.experiment_name, msg)
            raise SystemExit(exit_codes.DIVERGED)
        self._rollbacks += 1
        self._bad_steps = 0
        self.state = self._place_state(self._last_good)
        self.system.scale_meta_lr(res.rollback_lr_backoff)
        self.events.append(
            {"ts": time.time(), "event": "nan_rollback", "epoch": epoch, "rollback": self._rollbacks,
             "meta_lr_scale": self.system.meta_lr_scale}
        )
        print(
            f"warning: rolled back to last good state (rollback "
            f"{self._rollbacks}/{res.max_rollbacks}, outer LR x{self.system.meta_lr_scale:g})",
            flush=True,
        )

    def _handle_preempt_signal(self, signum, frame) -> None:
        # signal-safe: just flag; the train loop saves at the next step
        # boundary and exits
        self._preempt_signum = signum

    @contextlib.contextmanager
    def _preemption_guard(self):
        """SIGTERM/SIGINT -> emergency-checkpoint handlers for the duration
        of run_experiment (main thread only: ``signal.signal`` is a
        main-thread API)."""
        if not self.cfg.resilience.preemption_save or threading.current_thread() is not threading.main_thread():
            yield
            return
        prev = {s: signal.signal(s, self._handle_preempt_signal) for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            yield
        finally:
            for s, handler in prev.items():
                signal.signal(s, handler)

    def _emergency_exit(self, epoch: int, undispatched: int) -> None:
        """Preemption mid-epoch: an emergency 'latest' checkpoint whose
        bookkeeping carries the mid-epoch iteration cursor, then the
        restart-not-fail exit code. ``undispatched``: batches drawn from the
        loader but never trained on (drawn again on resume)."""
        cfg = self.cfg
        # the emergency 'latest' must be the final one, not raced by a
        # lagged epoch save
        self._drain_ckpt_writer()
        consumed = self.loader.train_episodes_produced // self.loader.batch_size - epoch * cfg.total_iter_per_epoch
        mid = consumed - undispatched
        bookkeeping = {
            "epoch": epoch - 1,  # last fully completed epoch
            "mid_epoch_iter": mid,
            "train_episodes_produced": (epoch * cfg.total_iter_per_epoch + mid) * self.loader.batch_size,
            "best_val_accuracy": self.best_val_accuracy,
            "best_val_epoch": self.best_val_epoch,
            "val_acc_by_epoch": {str(k): v for k, v in self.val_acc_by_epoch.items()},
            "mesh": self._mesh_shape(),
        }
        ckpt.save_named(self.saved_models_dir, self._host_state(), bookkeeping, "latest", self._injector,
                        feature_shape=self._feature_shape)
        signame = signal.Signals(self._preempt_signum).name
        msg = (
            f"PREEMPTED ({signame}) at epoch {epoch} iter {mid}: emergency "
            f"checkpoint written, exiting {cfg.resilience.preemption_exit_code} (restart to resume)"
        )
        print(msg, flush=True)
        self.events.append({"ts": time.time(), "event": "preempted", "epoch": epoch, "iter": mid})
        storage.change_json_log_experiment_status(self.logs_dir, self.experiment_name, msg)
        raise SystemExit(cfg.resilience.preemption_exit_code)

    # ------------------------------------------------------------------
    # evaluation and checkpoints
    # ------------------------------------------------------------------

    def _eval_batches(self, split: str):
        n_batches = max(self.cfg.num_evaluation_tasks // self.loader.batch_size, 1)
        if split == "val":
            return self.loader.val_batches(n_batches)
        return self.loader.test_batches(n_batches)

    def _eval_split(self, split: str) -> Dict[str, Any]:
        if self.cfg.eval_fused_dispatch and not self._multihost:
            # one dispatch over the whole fixed eval set (the multi-host
            # path stays per batch: it gathers each batch's tasks across
            # processes)
            stacked = _stack(list(self._eval_batches(split)))
            with self.hub.phase("eval", split=split, cold=self._note_variant(("eval_fused",))):
                losses, accs = self.system.eval_step_multi(self.state, self._put_chunk(stacked))
            self._beat(f"eval {split}")
            return _episode_stats(split, _host(losses.reshape(-1)), _host(accs.reshape(-1)))
        ep_losses, ep_accs = [], []
        for batch in self._eval_batches(split):
            with self.hub.phase("eval", split=split, cold=self._note_variant(("eval",))):
                out = self.system.eval_step(self.state, self._put(batch))
            self._beat(f"eval {split}")
            ep_losses.append(self._gather_array(out.per_task_losses))
            ep_accs.append(self._gather_array(out.per_task_accuracies))
        # one fetch per list, after the last batch is queued
        return _episode_stats(split, _host(torch.cat(ep_losses)), _host(torch.cat(ep_accs)))

    def write_inner_opt_stats(self) -> None:
        """One row per epoch of the learned per-tensor lrs (``[K]`` each
        under ``lslr_per_step``), and for inner Adam of its betas,
        interleaved b1, b2 per tensor, in the JAX package's column order
        (sorted key paths)."""
        if not self.cfg.learnable_inner_opt_params:
            return
        hp = self.state.inner_hparams
        lrs = [float(x) for leaf in tree_leaves(hp["lr"]) for x in _host(leaf).ravel()]
        storage.append_hparam_row(self.run_dir, lrs, "lrs.csv")
        if self.cfg.inner_optim.kind == "adam":
            betas = [
                float(x)
                for b1, b2 in zip(tree_leaves(hp["beta1"]), tree_leaves(hp["beta2"]))
                for pair in zip(_host(b1).ravel(), _host(b2).ravel())
                for x in pair
            ]
            storage.append_hparam_row(self.run_dir, betas, "betas.csv")

    def _save(self, epoch: int) -> None:
        bookkeeping = {
            "epoch": epoch,
            "best_val_accuracy": self.best_val_accuracy,
            "best_val_epoch": self.best_val_epoch,
            "train_episodes_produced": self.loader.train_episodes_produced,
            "val_acc_by_epoch": {str(k): v for k, v in self.val_acc_by_epoch.items()},
            "mesh": self._mesh_shape(),
        }
        num_shards = self._checkpoint_shards()
        # val_acc_by_epoch mutates across epochs; the writer needs this
        # epoch's snapshot
        rotation_accs = dict(self.val_acc_by_epoch) if self.cfg.checkpoint_rotation == "best_val" else None

        with self.hub.phase("checkpoint", epoch=epoch):
            # the host copy on this thread: the writer makes no CUDA call
            host_state = self._host_state()

            def write() -> None:
                ckpt.save_checkpoint(
                    self.saved_models_dir, host_state, bookkeeping, epoch,
                    feature_shape=self._feature_shape,
                    max_models_to_save=self.cfg.max_models_to_save,
                    val_acc_by_epoch=rotation_accs,
                    injector=self._injector,
                    num_shards=num_shards,
                )
                # this durable state is the new NaN-rollback anchor and the
                # wedge watchdog's anchor: single-reference rebinds
                self._last_good = host_state
                self._wedge_anchor = (host_state, {**bookkeeping, "mid_epoch_iter": 0})
                self._beat(f"checkpoint epoch {epoch}")

            if self._ckpt_writer is not None:
                # one-save lag: block on the previous epoch's save, then
                # serialize off the step path
                self._ckpt_writer.submit(write)
            else:
                write()

    def _save_best(self) -> None:
        ckpt.save_named(
            self.saved_models_dir, self._host_state(),
            {"epoch": self.best_val_epoch, "best_val_accuracy": self.best_val_accuracy}, "best",
            feature_shape=self._feature_shape,
        )

    def load_best(self) -> None:
        if ckpt.checkpoint_exists(self.saved_models_dir, "best"):
            state, _ = ckpt.load_checkpoint(self.saved_models_dir, "best", unreplicate(self.state),
                                            feature_shape=self._feature_shape)
            self.state = self._place_state(state)

    def _gather_array(self, x: torch.Tensor) -> torch.Tensor:
        """Per-task values of this process -> every process's, in process
        order (the order of the host slices of the global batch). As it is
        on one process."""
        if self._multihost:
            return all_gather_tasks(x)
        return x

    def _gather_host_local(self, x: np.ndarray) -> np.ndarray:
        """A host-local numpy slice -> the global array, concatenated in
        process order along axis 0."""
        if self._multihost:
            return all_gather_host(x)
        return np.asarray(x)

    def _collect_test_probs(self, state: TrainState, batches):
        """Per-batch softmax target probabilities for pre-assembled test
        batches (every ensemble member sees the same episodes)."""
        probs = []
        for batch in batches:
            with self.hub.phase("eval", split="test-ensemble", cold=self._note_variant(("eval",))):
                out = self.system.eval_step(state, self._put(batch))
            self._beat("eval test-ensemble")
            probs.append(self._gather_array(torch.softmax(out.per_task_target_logits, dim=-1)).cpu().numpy())
        return probs

    def evaluate_test(self) -> Dict[str, Any]:
        """Test evaluation -> logs/test_summary.csv. With
        ``test_ensemble_top_k > 1`` the softmax probabilities of the top-K
        saved checkpoints by validation accuracy are averaged per episode."""
        k = max(self.cfg.test_ensemble_top_k, 1)
        ranked = sorted(
            (e for e in ckpt.available_epochs(self.saved_models_dir) if e in self.val_acc_by_epoch),
            key=lambda e: self.val_acc_by_epoch[e],
            reverse=True,
        )[:k] if k > 1 else []
        if k > 1 and len(ranked) < k:
            print(
                f"warning: test ensemble requested top_k={k} but only "
                f"{len(ranked)} ranked checkpoints survive rotation "
                f"(max_models_to_save={self.cfg.max_models_to_save}); "
                f"{'ensembling ' + str(len(ranked)) if len(ranked) > 1 else 'falling back to single-model evaluation'}",
                flush=True,
            )
        if len(ranked) > 1:
            batches = list(self._eval_batches("test"))  # assembled once
            # on a multi-host run each loader yields only this host's slice
            # of the global batch: tile the label slices into global order
            labels = [self._gather_host_local(b["y_target"].reshape(b["y_target"].shape[0], -1)) for b in batches]
            member_probs = []
            for epoch in ranked:
                state, _ = ckpt.load_checkpoint(self.saved_models_dir, epoch, unreplicate(self.state),
                                                feature_shape=self._feature_shape)
                member_probs.append(self._collect_test_probs(state, batches))
            ep_accs, ep_losses = [], []
            for b, y in enumerate(labels):
                mean_probs = np.mean([m[b] for m in member_probs], axis=0)
                ep_accs.append((mean_probs.argmax(-1) == y).mean(axis=-1))
                true_p = np.take_along_axis(mean_probs, y[..., None], axis=-1)
                ep_losses.append(-np.log(np.maximum(true_p, 1e-12)).mean(axis=(-2, -1)))
            stats = {
                **_episode_stats("test", np.concatenate(ep_losses), np.concatenate(ep_accs)),
                "test_ensemble_size": len(ranked),
                "test_ensemble_epochs": " ".join(str(e) for e in ranked),
            }
        else:
            stats = self._eval_split("test")
        storage.save_statistics(self.logs_dir, stats, filename="test_summary.csv")
        storage.change_json_log_experiment_status(
            self.logs_dir, self.experiment_name, f"tested: acc={stats['test_accuracy_mean']:.4f}"
        )
        return stats

    # ------------------------------------------------------------------

    def run_experiment(self) -> Dict[str, Any]:
        """Train/eval to completion. An owned loader is shut down on every
        exit path (completion, the exit-3 abort, preemption, errors);
        SIGTERM/SIGINT during the run take the emergency-save path; the
        wedge watchdog is armed for exactly this scope."""
        try:
            with self._preemption_guard():
                if self._watchdog is not None:
                    with self._watchdog.watching("run_experiment"):
                        return self._run_experiment()
                return self._run_experiment()
        finally:
            # any in-flight async epoch save lands before the run dir is
            # read as final
            self._drain_ckpt_writer()
            if self._watchdog is not None:
                self._watchdog.stop()
            # final telemetry snapshot + Chrome-trace export
            self.hub.close()
            self._close_compile_ledger()
            self.events.close()
            if self._owns_loader:
                self.loader.close()

    def _run_experiment(self) -> Dict[str, Any]:
        cfg = self.cfg
        if cfg.evaluate_on_test_set_only:
            self.load_best()
            return self.evaluate_test()

        # the donation gate: the A/B self-check before any donated step (a
        # verdict other than clean trains without donation), then the audit
        if cfg.donate_train_state and cfg.donation_selfcheck:
            self._donation_gate()
        self._note_donation_audit()

        # the prewarm (Config.aot): the planned program set is built HERE,
        # inside the watchdog's scope, before the first step
        if cfg.aot.enabled:
            self._prewarm_programs()

        end_epoch = min(cfg.total_epochs, self.start_epoch + cfg.total_epochs_before_pause)
        for epoch in range(self.start_epoch, end_epoch):
            # elastic grow-back: one device-count probe per epoch boundary
            # while degraded (nothing when healthy)
            self._maybe_grow_mesh()
            stats: Dict[str, Any] = {"epoch": epoch}
            stats.update(self._train_epoch(epoch))
            stats.update(self._eval_split("val"))
            storage.save_statistics(self.logs_dir, stats)
            storage.update_json_experiment_log_epoch_stats(self.logs_dir, self.experiment_name, epoch, stats)
            self.events.append({"ts": time.time(), **stats})
            self.write_inner_opt_stats()
            self.val_acc_by_epoch[epoch] = float(stats["val_accuracy_mean"])
            if stats["val_accuracy_mean"] > self.best_val_accuracy:
                self.best_val_accuracy = stats["val_accuracy_mean"]
                self.best_val_epoch = epoch
                self._save_best()
            self._save(epoch)
            # after eval + checkpoint so the epoch snapshot's cumulative
            # phase sums include every phase of this epoch
            self.hub.snapshot("epoch", epoch=epoch, train_wall_s=round(float(stats["epoch_run_time"]), 3))
            # the headroom check rides the epoch cadence (latched per card)
            if self._memory is not None:
                self._memory.maybe_warn(self.events)
            # a preemption signal that landed during eval/save: the epoch
            # checkpoint just written is complete, so exit restartable
            if self._preempt_signum is not None:
                signame = signal.Signals(self._preempt_signum).name
                code = cfg.resilience.preemption_exit_code
                print(
                    f"PREEMPTED ({signame}) after epoch {epoch}: checkpoint "
                    f"already written, exiting {code} (restart to resume)",
                    flush=True,
                )
                self.events.append({"ts": time.time(), "event": "preempted", "epoch": epoch})
                raise SystemExit(code)
            print(
                f"epoch {epoch}: train_acc={stats['train_accuracy_mean']:.4f} "
                f"val_acc={stats['val_accuracy_mean']:.4f} "
                f"({stats['epoch_run_time']:.1f}s)",
                flush=True,
            )
            # early divergence abort: train accuracy still below the
            # threshold after the grace window exits with the permanent
            # code 3; the checkpoints up to this epoch stay on disk
            if (
                cfg.early_abort_train_acc > 0.0
                and epoch + 1 >= cfg.early_abort_epoch
                and stats["train_accuracy_mean"] < cfg.early_abort_train_acc
            ):
                msg = (
                    f"EARLY ABORT: train_acc {stats['train_accuracy_mean']:.4f} < "
                    f"{cfg.early_abort_train_acc} after {epoch + 1} epochs "
                    f"(early_abort_epoch {cfg.early_abort_epoch}) — diverged"
                )
                print(msg, flush=True)
                self.events.append({"ts": time.time(), "event": "early_abort", **stats})
                storage.change_json_log_experiment_status(self.logs_dir, self.experiment_name, msg)
                raise SystemExit(exit_codes.DIVERGED)
        # settle the last epoch's async save (and its rotation) before the
        # test phase loads the per-epoch checkpoint files
        self._drain_ckpt_writer()
        self.load_best()
        test_stats = self.evaluate_test()
        return {"best_val_accuracy": self.best_val_accuracy, "best_val_epoch": self.best_val_epoch, **test_stats}
