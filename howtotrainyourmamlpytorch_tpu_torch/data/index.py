"""Filesystem index bootstrap with the reference's on-disk JSON cache format.

On first run, walk the dataset directory, label each image by
"<grandparent>/<parent>" path components, verify each image opens, and cache
three JSONs *next to* the dataset dir (reference ``data.py:241-342``):
``{dataset}.json`` (class-idx -> filepath list), ``map_to_label_name_*.json``,
``label_name_to_map_*.json``. The formats match the reference's verified
on-disk artifacts so existing caches interoperate.

Deviations from the reference, on purpose:
- verification uses a thread pool (PIL decoding releases the GIL) instead of a
  4-process fork pool;
- a corrupt image is dropped with a warning instead of shelling out to
  ImageMagick ``convert`` (reference ``data.py:299``);
- the dataset-integrity count check fails fast instead of deleting the dataset
  dir and recursing forever (reference ``utils/dataset_tools.py:42-44`` — the
  re-download logic it relied on is commented out upstream).
"""

import concurrent.futures
import json
import os
import warnings
from typing import Dict, List, Optional, Tuple

from PIL import Image

from . import registry

_IMAGE_EXTS = (".jpeg", ".png", ".jpg")

# reference utils/dataset_tools.py:29-40 expected image counts
EXPECTED_COUNTS = {"omniglot_dataset": 1623 * 20, "mini_imagenet_full_size": 100 * 600}


def label_from_path(filepath: str, class_indexes=(-3, -2), labels_as_int=False):
    bits = filepath.split("/")
    label = "/".join(bits[idx] for idx in class_indexes)
    return int(label) if labels_as_int else label


def _verify_image(filepath: str):
    try:
        with Image.open(filepath) as im:
            im.verify()
        return filepath
    except Exception:
        warnings.warn(f"dropping unreadable image {filepath}")
        return None


def index_paths(data_path: str, dataset_name: str, cache_dir: Optional[str] = None) -> Tuple[str, str, str]:
    dataset_dir = cache_dir or os.path.split(os.path.normpath(data_path))[0]
    return (
        os.path.join(dataset_dir, f"{dataset_name}.json"),
        os.path.join(dataset_dir, f"map_to_label_name_{dataset_name}.json"),
        os.path.join(dataset_dir, f"label_name_to_map_{dataset_name}.json"),
    )


def _resolve_paths(paths: Dict, data_path: str) -> Dict:
    """Cached indexes may hold paths relative to the original repo root (the
    reference's shipped ``omniglot_dataset.json`` does). Resolve them against
    the dataset's enclosing repo dir when they don't exist as given."""
    root = os.path.dirname(os.path.split(os.path.normpath(data_path))[0])
    probe = next((p for v in paths.values() for p in v[:1]), None)
    if probe is None or os.path.exists(probe):
        return paths
    if os.path.exists(os.path.join(root, probe)):
        return {k: [os.path.join(root, p) for p in v] for k, v in paths.items()}
    return paths


def build_index(
    data_path: str,
    class_indexes=(-3, -2),
    labels_as_int: bool = False,
    verify: bool = True,
    max_workers: int = 8,
) -> Tuple[Dict[int, List[str]], Dict[int, str], Dict[str, int]]:
    files = []
    for subdir, _, names in os.walk(data_path):
        for name in names:
            if name.lower().endswith(_IMAGE_EXTS):
                files.append(os.path.abspath(os.path.join(subdir, name)))
    if verify:
        with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as pool:
            files = [f for f in pool.map(_verify_image, files) if f is not None]
    labels = sorted({label_from_path(f, class_indexes, labels_as_int) for f in files})
    idx_to_label = {i: label for i, label in enumerate(labels)}
    label_to_idx = {label: i for i, label in enumerate(labels)}
    paths: Dict[int, List[str]] = {i: [] for i in idx_to_label}
    for f in sorted(files):
        paths[label_to_idx[label_from_path(f, class_indexes, labels_as_int)]].append(f)
    return paths, idx_to_label, label_to_idx


def load_or_build_index(
    data_path: str,
    dataset_name: str,
    class_indexes=(-3, -2),
    labels_as_int: bool = False,
    reset_stored_filepaths: bool = False,
    cache_dir: Optional[str] = None,
):
    """Load the JSON caches, building them on first run (reference
    ``load_datapaths``, ``data.py:241-276``). Returns
    (class_idx->paths with *string* keys as JSON round-trips them,
    idx->label, label->idx). ``cache_dir`` overrides where the JSONs live —
    needed when the dataset dir is on a read-only mount."""
    paths_file, idx_to_label_file, label_to_idx_file = index_paths(
        data_path, dataset_name, cache_dir
    )
    if reset_stored_filepaths and os.path.exists(paths_file):
        os.remove(paths_file)
    try:
        with open(paths_file) as f:
            paths = json.load(f)
        with open(idx_to_label_file) as f:
            idx_to_label = json.load(f)
        with open(label_to_idx_file) as f:
            label_to_idx = json.load(f)
        return _resolve_paths(paths, data_path), idx_to_label, label_to_idx
    except (FileNotFoundError, json.JSONDecodeError):
        pass
    paths, idx_to_label, label_to_idx = build_index(data_path, class_indexes, labels_as_int)
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
    for obj, fname in [
        (paths, paths_file),
        (idx_to_label, idx_to_label_file),
        (label_to_idx, label_to_idx_file),
    ]:
        with open(fname, "w") as f:
            json.dump(obj, f)
    # re-load so key types match the cached-file case (JSON stringifies ints)
    return load_or_build_index(
        data_path, dataset_name, class_indexes, labels_as_int, cache_dir=cache_dir
    )


def check_dataset_integrity(data_path: str, dataset_name: str) -> int:
    """Count images and validate against the expected totals (reference
    ``utils/dataset_tools.py:29-40``) — fail fast on mismatch rather than the
    reference's delete-and-recurse loop. The pkl-packed mini-imagenet variant
    (reference accepts exactly 3 ``.pkl`` files, dataset_tools.py:37-40) is
    validated by its pickle count."""
    if not os.path.exists(data_path):
        raise FileNotFoundError(f"dataset dir missing: {data_path}")
    if registry.is_pkl_variant(dataset_name):
        total = sum(
            1
            for _, _, names in os.walk(data_path)
            for n in names
            if n.lower().endswith(".pkl")
        )
        if total != 3:
            raise RuntimeError(
                f"{dataset_name}: found {total} .pkl files, expected 3 "
                "(train/val/test pickles); dataset appears incomplete"
            )
        return total
    total = 0
    for _, _, names in os.walk(data_path):
        total += sum(1 for n in names if n.lower().endswith(_IMAGE_EXTS))
    expected = EXPECTED_COUNTS.get(dataset_name)
    if expected is not None and total != expected:
        raise RuntimeError(
            f"{dataset_name}: found {total} images, expected {expected}; "
            "dataset appears corrupt or incomplete"
        )
    return total
