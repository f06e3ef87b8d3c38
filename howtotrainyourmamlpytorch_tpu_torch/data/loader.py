"""Batched episode streams with background prefetch.

Replaces the reference's fork-based ``torch.utils.data.DataLoader`` wrapper
(``MetaLearningSystemDataLoader``, reference ``data.py:564-646``) with a
thread-pool episode assembler: with the RAM cache on, episode construction is
numpy gather + rot90 (GIL-friendly), and batches are assembled ahead of the
consumer through a bounded in-flight window, then handed to the device
asynchronously by the runner.

Resume: the train stream position is a single integer (episodes produced);
``continue_from_iter`` restores it exactly (reference ``data.py:592-597``).
Batch ``b`` draws episode seeds ``init_train_seed + produced + j``. Val/test
streams are fixed-seed, so evaluation episodes are identical every epoch
(reference ``data.py:148-149``).

Deviation (documented): the reference advances its train cursor by one
batch-worth per *epoch* because the missing ExperimentBuilder drives a
DataLoader over a length-capped dataset (SURVEY.md §2.4), which would replay
nearly-identical episode streams across epochs. We advance the cursor per
*batch*, giving a non-repeating deterministic stream and exact resume.

A copy of the JAX package's loader, multi-host slicing included
(``host_shard``). ``stats()`` also counts which path assembled each batch:
``native_batches`` (the C++ engine) and ``numpy_batches`` (the per-episode
fallback).
"""

import concurrent.futures
import threading
import weakref
from typing import Dict, Iterator, Optional

import numpy as np

from ..config import Config
from ..resilience.faults import NULL_INJECTOR
from ..resilience.retry import retry_call
from .dataset import FewShotDataset


def _stack(episodes) -> Dict[str, np.ndarray]:
    return {k: np.stack([e[k] for e in episodes]) for k in episodes[0]}


def _shutdown_pools(*pools) -> None:
    """weakref.finalize target — must not capture the loader itself."""
    for pool in pools:
        pool.shutdown(wait=False)


class MetaLearningDataLoader:
    def __init__(
        self,
        cfg: Config,
        dataset: Optional[FewShotDataset] = None,
        current_iter: int = 0,
        data_root: Optional[str] = None,
        host_shard: Optional[tuple] = None,
        injector=NULL_INJECTOR,
    ):
        """``host_shard=(process_index, process_count)`` makes this loader
        materialize only its host's contiguous slice of each *global*
        meta-batch (``parallel.host_shard_bounds``). Episode seeds stay a
        pure function of the global stream position, so every host agrees
        on the episode assignment and resume cursors remain global."""
        self.cfg = cfg
        self.dataset = dataset or FewShotDataset(cfg, data_root=data_root)
        self.batch_size = cfg.batch_size * cfg.samples_per_iter
        if host_shard is not None:
            from ..parallel.mesh import host_shard_bounds

            self._local_lo, self._local_hi = host_shard_bounds(self.batch_size, host_shard[0], host_shard[1])
        else:
            self._local_lo, self._local_hi = 0, self.batch_size
        self.num_workers = max(cfg.num_dataprovider_workers, 1)
        self._injector = injector
        # transient episode-I/O retries (observability). Retry callbacks run
        # on the prefetch-window pool threads — two in-flight batch builds
        # can retry concurrently, so the counter increments under a lock
        # (graftlint GL201: the lost-update shape)
        self._stats_lock = threading.Lock()
        self.io_retries_used = 0
        self.native_batches = 0
        self.numpy_batches = 0
        self.train_episodes_produced = 0
        self.continue_from_iter(current_iter)
        # persistent episode-assembly pool: one per loader, not per batch —
        # episode work is a cheap numpy gather, pool churn would dominate it.
        # Sized for both in-flight prefetch builds (window=2) so overlapping
        # builds don't halve per-build parallelism.
        self._episode_pool = None
        self._window_pool = None
        self._finalizer = None
        self._ensure_pools()

    _PREFETCH_WINDOW = 2  # batches in flight ahead of the consumer

    def _ensure_pools(self) -> None:
        """(Re)create the worker pools. The episode pool assembles episodes
        within a batch; the prefetch-window pool drives whole-batch builds
        ahead of the consumer — persistent per loader, NOT per iterator
        (previously ``_prefetched`` spun up and tore down a fresh executor
        per iterator, once per epoch per split — thousands of churned
        threads over a run for a pool whose lifetime should be the
        loader's). A closed loader reopens on next use, so runners can
        release threads at run end while callers may still evaluate later."""
        if self._episode_pool is not None:
            return
        self._episode_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.num_workers * self._PREFETCH_WINDOW
        )
        self._window_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self._PREFETCH_WINDOW
        )
        self._finalizer = weakref.finalize(
            self, _shutdown_pools, self._episode_pool, self._window_pool
        )

    def close(self) -> None:
        """Shut down the worker pools (also runs via GC finalizer). Not
        terminal: the next batch request transparently reopens them."""
        if self._finalizer is not None:
            self._finalizer()
        self._episode_pool = None
        self._window_pool = None

    def continue_from_iter(self, current_iter: int) -> None:
        self.train_episodes_produced = current_iter * self.batch_size

    def stats(self) -> Dict[str, int]:
        """Telemetry-provider snapshot (observability/telemetry.py): stream
        position, transient-I/O retry count and the batches each assembly
        path served. The counters are mutated under ``_stats_lock`` by the
        window-pool threads, so read them there; ``train_episodes_produced``
        only moves on the consumer thread."""
        with self._stats_lock:
            counts = {
                "io_retries_used": self.io_retries_used,
                "native_batches": self.native_batches,
                "numpy_batches": self.numpy_batches,
            }
        return {"train_episodes_produced": self.train_episodes_produced, **counts}

    # ------------------------------------------------------------------

    def _build_batch(self, split: str, base: int, augment: bool) -> Dict[str, np.ndarray]:
        """Assemble the batch whose first global episode index is ``base``.
        Episode assembly is wrapped in a bounded transient-I/O retry
        (resilience.loader_io_*): a flaky read (cold NFS, an injected
        ``loader.episode`` fault) is retried with backoff instead of killing
        the prefetch pipeline; a persistent failure still propagates."""
        res = self.cfg.resilience

        def attempt() -> Dict[str, np.ndarray]:
            self._injector.fire("loader.episode")
            ds = self.dataset
            # this host's slice of the global batch (the whole batch by default)
            seeds = [ds.episode_seed(split, base + j) for j in range(self._local_lo, self._local_hi)]
            # fast path: whole batch assembled by one native C++ call
            # (gather+rot90+normalize+pack in native threads; ctypes releases
            # the GIL, so prefetch still overlaps the device step)
            batch = ds.sample_episode_batch(split, seeds, augment)
            if batch is not None:
                with self._stats_lock:
                    self.native_batches += 1
                return batch
            episodes = list(
                self._episode_pool.map(
                    lambda s: ds.sample_episode(split, s, augment), seeds
                )
            )
            with self._stats_lock:
                self.numpy_batches += 1
            return _stack(episodes)

        def note_retry(attempt_idx, exc):
            with self._stats_lock:
                self.io_retries_used += 1
            print(
                f"warning: episode I/O failed ({exc}); retry "
                f"{attempt_idx + 1}/{res.loader_io_retries}",
                flush=True,
            )

        return retry_call(
            attempt,
            retries=res.loader_io_retries,
            backoff_s=res.loader_io_backoff_s,
            retry_on=(OSError,),
            on_retry=note_retry,
        )

    def _prefetched(self, build, total: int, advance_per_yield: int) -> Iterator:
        """Drive ``build(i)`` for i in [0, total) through the bounded
        prefetch window, advancing the train cursor by ``advance_per_yield``
        episodes as each item is handed to the consumer. Uses the loader's
        persistent window pool; an abandoned iterator leaves at most
        ``_PREFETCH_WINDOW`` in-flight builds to finish idle."""
        window = self._PREFETCH_WINDOW
        self._ensure_pools()
        ahead = self._window_pool
        futures = {i: ahead.submit(build, i) for i in range(min(window, total))}
        for i in range(total):
            # untimed on purpose: a batch build has no sane fixed budget (cold
            # NFS, huge ways) and a truly hung build is the runner wedge
            # watchdog's job — it rc=76s the process with stacks rather than
            # guessing a timeout here  # graftlint: disable=GL202
            item = futures.pop(i).result()
            nxt = i + window
            if nxt < total:
                futures[nxt] = ahead.submit(build, nxt)
            # consumer-thread only: the generator body runs on the single
            # iterating thread; pool threads never touch this cursor
            # graftlint: disable=GL201
            self.train_episodes_produced += advance_per_yield
            yield item

    def _batches(
        self,
        split: str,
        start_index: int,
        total_batches: int,
        augment: bool,
        advance_train_cursor: bool,
    ) -> Iterator[Dict[str, np.ndarray]]:
        bs = self.batch_size
        build = lambda i: self._build_batch(split, start_index + i * bs, augment)
        return self._prefetched(build, total_batches, bs if advance_train_cursor else 0)

    def train_batches(self, total_batches: int, augment_images: bool = True):
        """Deterministic resumable train stream (cursor advances per batch)."""
        return self._batches(
            "train", self.train_episodes_produced, total_batches, augment_images, True
        )

    def train_batch_chunks(
        self, total_chunks: int, chunk_size: int, augment_images: bool = True
    ) -> Iterator[Dict[str, np.ndarray]]:
        """The SAME deterministic train stream as ``train_batches``, grouped:
        each yield stacks the next ``chunk_size`` batches under an extra
        leading ``[chunk_size]`` axis for one multi-step device dispatch
        (``MAMLSystem.train_step_multi``). Episode seeds, augmentation and
        the resume cursor are batch-for-batch identical to the ungrouped
        stream; stacking happens in the prefetch threads, off the dispatch
        thread."""
        bs = self.batch_size
        start = self.train_episodes_produced

        def build(chunk_idx: int) -> Dict[str, np.ndarray]:
            return _stack([
                self._build_batch(
                    "train", start + (chunk_idx * chunk_size + k) * bs, augment_images
                )
                for k in range(chunk_size)
            ])

        return self._prefetched(build, total_chunks, bs * chunk_size)

    def val_batches(self, total_batches: int, augment_images: bool = False):
        return self._batches("val", 0, total_batches, augment_images, False)

    def test_batches(self, total_batches: int, augment_images: bool = False):
        return self._batches("test", 0, total_batches, augment_images, False)
