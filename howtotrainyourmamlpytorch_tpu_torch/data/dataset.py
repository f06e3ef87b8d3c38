"""Deterministic few-shot episode sampler (reference ``data.py:109-561``).

Every episode is a pure function of ``(split, seed)``: with
``rng = np.random.RandomState(seed)`` the sampler draws ``n_way`` classes
without replacement, shuffles them, draws one rotation ``k in {0..3}`` per
class, then ``k_shot + num_target`` images per class without replacement —
call-for-call the same RandomState sequence as the reference ``get_set``
(``data.py:486-532``), so seed discipline and resume semantics carry over.

Episode tensors are NHWC float32, as in the JAX package, so both packages'
loaders give the same arrays (the reference emits NCHW via torchvision
``ToTensor``; the port's model permutes at its entry): ``x: [n_way, k, H, W,
C]``, ``y: [n_way, k]`` int32 episode-local labels 0..n_way-1.
"""

import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from ..config import Config
from ..utils.seeding import derive_split_seed
from .index import check_dataset_integrity, load_or_build_index
from .registry import DatasetSpec, get_dataset_spec

SPLITS = ("train", "val", "test")


class FewShotDataset:
    """Class-split episodic dataset with optional in-RAM image cache."""

    def __init__(self, cfg: Config, data_root: Optional[str] = None):
        self.cfg = cfg
        self.spec: DatasetSpec = get_dataset_spec(cfg.dataset.name)
        self.data_path = os.path.join(data_root, cfg.dataset.path) if data_root else cfg.dataset.path
        self.num_classes_per_set = cfg.num_classes_per_set
        self.num_samples_per_class = cfg.num_samples_per_class
        self.num_target_samples = cfg.num_target_samples

        # per-split stream seeds (reference data.py:139-149; test stream is
        # seeded from val_seed — preserved behind cfg.test_stream_uses_val_seed)
        train_seed = derive_split_seed(cfg.train_seed)
        val_seed = derive_split_seed(cfg.val_seed)
        test_seed = (
            val_seed
            if cfg.test_stream_uses_val_seed
            else derive_split_seed(cfg.test_seed)
        )
        self.init_seed = {"train": train_seed, "val": val_seed, "test": test_seed}

        self.datasets = self._load_splits()
        self.class_counts = {
            split: {key: len(v) for key, v in classes.items()}
            for split, classes in self.datasets.items()
        }
        self.in_memory = False
        if cfg.load_into_memory:
            self._load_into_memory()

    # ------------------------------------------------------------------
    # split construction (reference load_dataset, data.py:176-239)
    # ------------------------------------------------------------------

    def _load_splits(self) -> Dict[str, Dict[str, List]]:
        cfg = self.cfg
        paths, idx_to_label, _ = load_or_build_index(
            self.data_path,
            cfg.dataset.name,
            self.spec.indexes_of_folders_indicating_class,
            cfg.labels_as_int,
            cfg.reset_stored_filepaths,
            cache_dir=cfg.index_cache_dir or None,
        )
        if cfg.effective_sets_are_pre_split:
            # labels look like "train/n01532829": group by the embedded split
            # name (reference data.py:185-196; needed for mini-imagenet)
            splits: Dict[str, Dict[str, List]] = {}
            for key, value in paths.items():
                label = idx_to_label[str(key)] if str(key) in idx_to_label else idx_to_label[key]
                set_name, class_label = label.split("/", 1)
                splits.setdefault(set_name, {})[class_label] = value
            for name in SPLITS:
                splits.setdefault(name, {})
            return {name: splits[name] for name in SPLITS}
        # ratio split over *classes*, shuffled with the val-seeded RNG
        # (reference data.py:197-218)
        rng = np.random.RandomState(seed=self.init_seed["val"])
        keys = list(paths.keys())
        order = np.arange(len(keys), dtype=np.int32)
        rng.shuffle(order)
        shuffled = [keys[i] for i in order]
        n = len(shuffled)
        r = tuple(cfg.train_val_test_split) or self.spec.train_val_test_split
        n_train, n_val = int(r[0] * n), int((r[0] + r[1]) * n)
        return {
            "train": {k: paths[k] for k in shuffled[:n_train]},
            "val": {k: paths[k] for k in shuffled[n_train:n_val]},
            "test": {k: paths[k] for k in shuffled[n_val:]},
        }

    def _load_into_memory(self) -> None:
        """Pre-decode every image to float32 NHWC arrays (reference RAM cache,
        data.py:220-237) so the episode hot path is pure gather.

        The cache is one contiguous packed buffer per split; the per-class
        entries in ``self.datasets`` become views into it, and
        ``self.packed[split] = (buffer, {class_key: offset})`` feeds the
        native C++ episode-assembly engine (native/episode_engine.cpp)."""
        import concurrent.futures

        self.packed = {}
        H, W, C = self.spec.image_shape
        for split, classes in self.datasets.items():
            if not classes:
                continue
            # preallocate the packed buffer (sizes known up front) and decode
            # directly into per-class slices: peak RAM = 1x the cache
            total = sum(len(v) for v in classes.values())
            buffer = np.empty((total, H, W, C), np.float32)
            offsets, views, pos = {}, {}, 0
            for key, file_list in classes.items():
                offsets[key] = pos
                views[key] = buffer[pos : pos + len(file_list)]
                pos += len(file_list)

            def load_class(item):
                key, file_list = item
                dst = views[key]
                for i, f in enumerate(file_list):
                    dst[i] = self._load_image(f)

            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
                list(pool.map(load_class, classes.items()))
            # one-shot init on the calling thread: pool.map has already
            # joined the decode workers when these cache writes run
            self.datasets[split] = views  # graftlint: disable=GL201
            self.packed[split] = (buffer, offsets)  # graftlint: disable=GL201
        self.in_memory = True

    # ------------------------------------------------------------------
    # image IO (reference load_image, data.py:382-403)
    # ------------------------------------------------------------------

    def _load_image(self, image_path) -> np.ndarray:
        spec = self.spec
        with Image.open(image_path) as image:
            if "omniglot" in self.cfg.dataset.name:
                image = image.resize(
                    (spec.image_height, spec.image_width), resample=Image.LANCZOS
                )
                arr = np.array(image, np.float32)
                if spec.image_channels == 1 and arr.ndim == 2:
                    arr = arr[:, :, None]
                return arr  # binary 0/1 values, deliberately no /255
            image = image.resize((spec.image_height, spec.image_width)).convert("RGB")
            arr = np.array(image, np.float32) / 255.0
            if self.cfg.reverse_channels:
                # RGB -> BGR flip BEFORE normalization, the reference order
                # (load_batch: load_image -> preprocess_data flip on raw /255
                # data, data.py:422,458-463; Normalize runs later inside
                # augment_image, data.py:514-517). Applied at decode time so
                # the RAM cache — and therefore the native batched path —
                # inherit it; NB the reference skips the flip entirely on its
                # RAM-cache path (data.py:412-417), an upstream inconsistency
                # we resolve in favor of the flag meaning what it says.
                # Returned as a view: every consumer copies into its own
                # buffer anyway.
                arr = arr[..., ::-1]
            return arr

    def _postprocess(self, arr: np.ndarray, k: int, augment: bool) -> np.ndarray:
        """Per-image transform: rotation-k for omniglot train episodes
        (reference rotate_image + transforms, data.py:15-31,90-104), ImageNet
        mean/std normalization for imagenet."""
        if self.spec.rotation_augmentation:
            if augment and k:
                arr = np.rot90(arr, k=k, axes=(0, 1)).copy()
            return arr
        if self.spec.normalize_mean:
            mean = np.asarray(self.spec.normalize_mean, np.float32)
            std = np.asarray(self.spec.normalize_std, np.float32)
            return (arr - mean) / std
        return arr

    # ------------------------------------------------------------------
    # episode sampling (reference get_set, data.py:486-532)
    # ------------------------------------------------------------------

    def _draw_episode(self, rng: np.random.RandomState, split: str):
        """The reference's exact RandomState call sequence for one episode
        (data.py:493-508): n_way classes w/o replacement, shuffle, one rot-k
        per class, then k+t sample indices per class w/o replacement."""
        counts = self.class_counts[split]
        n_samples = self.num_samples_per_class + self.num_target_samples
        selected = rng.choice(list(counts.keys()), size=self.num_classes_per_set, replace=False)
        rng.shuffle(selected)
        k_list = rng.randint(0, 4, size=self.num_classes_per_set)
        sample_idx = [
            rng.choice(counts[key], size=n_samples, replace=False) for key in selected
        ]
        return selected, k_list, sample_idx

    def _split_episode(self, x: np.ndarray, y: np.ndarray) -> Dict[str, np.ndarray]:
        # x slices stay views — _stack's np.stack is the one copy on the
        # per-episode path (the native batched path builds support/target
        # contiguously up front and doesn't come through here)
        k_shot = self.num_samples_per_class
        return {
            "x_support": x[..., :k_shot, :, :, :],
            "x_target": x[..., k_shot:, :, :, :],
            "y_support": np.ascontiguousarray(y[..., :k_shot]),
            "y_target": np.ascontiguousarray(y[..., k_shot:]),
        }

    def _labels(self, *lead_shape) -> np.ndarray:
        n_way = self.num_classes_per_set
        n_samples = self.num_samples_per_class + self.num_target_samples
        y = np.arange(n_way, dtype=np.int32)[:, None]
        return np.broadcast_to(y, lead_shape + (n_way, n_samples))

    def sample_episode(self, split: str, seed: int, augment: bool = False) -> Dict[str, np.ndarray]:
        spec = self.spec
        n_way = self.num_classes_per_set
        n_samples = self.num_samples_per_class + self.num_target_samples
        rng = np.random.RandomState(seed)
        selected, k_list, sample_idx = self._draw_episode(rng, split)
        x = np.empty(
            (n_way, n_samples, spec.image_height, spec.image_width, spec.image_channels),
            np.float32,
        )
        for ci, class_key in enumerate(selected):
            store = self.datasets[split][class_key]
            for si, s in enumerate(sample_idx[ci]):
                arr = store[s] if self.in_memory else self._load_image(store[s])
                x[ci, si] = self._postprocess(arr, int(k_list[ci]), augment)
        return self._split_episode(x, self._labels())

    def sample_episode_batch(
        self, split: str, seeds, augment: bool = False
    ) -> Optional[Dict[str, np.ndarray]]:
        """Whole meta-batch in ONE native call (C++ engine, native/): the
        RandomState draws happen here (bit-exact with sample_episode via
        _draw_episode), then gather + rot90 + normalize + pack run in native
        threads over the packed cache. Returns None when the native engine or
        the packed RAM cache is unavailable — callers fall back to the
        per-episode numpy path."""
        if not self.in_memory or split not in getattr(self, "packed", {}):
            return None
        from .. import native

        if native.load_engine() is None:
            return None
        buffer, offsets = self.packed[split]
        n_way = self.num_classes_per_set
        n_samples = self.num_samples_per_class + self.num_target_samples
        B = len(seeds)
        image_idx = np.empty((B, n_way, n_samples), np.int64)
        rot_k = np.zeros((B, n_way), np.int32)
        for b, seed in enumerate(seeds):
            rng = np.random.RandomState(seed)
            selected, k_list, sample_idx = self._draw_episode(rng, split)
            for ci, class_key in enumerate(selected):
                image_idx[b, ci] = offsets[class_key] + sample_idx[ci]
            if self.spec.rotation_augmentation and augment:
                rot_k[b] = k_list
        mean = std = None
        if not self.spec.rotation_augmentation and self.spec.normalize_mean:
            mean = np.asarray(self.spec.normalize_mean, np.float32)
            std = np.asarray(self.spec.normalize_std, np.float32)
        # assemble support and target directly into separate contiguous
        # buffers (two native calls over the pre-split index array): no
        # post-hoc slicing copy of the just-built batch
        k_shot = self.num_samples_per_class
        threads = max(self.cfg.num_dataprovider_workers, 1)
        x_support = native.assemble_episodes(
            buffer, np.ascontiguousarray(image_idx[:, :, :k_shot]), rot_k,
            mean=mean, std=std, num_threads=threads,
        )
        x_target = native.assemble_episodes(
            buffer, np.ascontiguousarray(image_idx[:, :, k_shot:]), rot_k,
            mean=mean, std=std, num_threads=threads,
        )
        if x_support is None or x_target is None:
            return None
        y = self._labels(B)
        return {
            "x_support": x_support,
            "x_target": x_target,
            "y_support": np.ascontiguousarray(y[..., :k_shot]),
            "y_target": np.ascontiguousarray(y[..., k_shot:]),
        }

    def episode_seed(self, split: str, index: int) -> int:
        """seed = f(split, index): the whole task stream is a pure function of
        (seed, iteration) — exact-resume property (reference data.py:545-558)."""
        return self.init_seed[split] + index

    def validate(self) -> int:
        return check_dataset_integrity(self.data_path, self.cfg.dataset.name)
