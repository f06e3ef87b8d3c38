"""Full-train-state checkpoints in the JAX package's file formats (JAX package
``experiment/checkpoint.py``), so that either package resumes the other's.

A checkpoint file is flax msgpack, encoded here with ``msgpack`` directly
(flax's serializer imports jax): an ndarray is
``ExtType(1, packb((shape, dtype_name, bytes)))``, a numpy scalar
``ExtType(3, ...)`` with the same body, and a NamedTuple or tuple is a dict
keyed by field name or by index (``"0"``, ``"1"``, ...), as
``flax.serialization.to_state_dict`` lays it out. The ``network`` entry is
itself msgpack: the ``TrainState`` by field name, in the JAX layout
(``utils/interop.py``: HWIO conv kernels, ``[in, out]`` head with NHWC rows,
int32 step), with the outer Adam state as optax's
``{"0": {"count", "mu", "nu"}, "1": {"count"}}``.

- Format 2 (written and read): the body wrapped with its sha256 digest
  (``{"format", "sha256", "body"}``); every load verifies it. Writes are
  atomic (a unique temp file, then ``os.replace``), and
  ``max_models_to_save`` rotates the per-epoch files.
- Pre-format-2 files (the bare payload) load unverified.
- Format 3 (written and read): a digest-wrapped manifest naming per-shard
  files and their sha256; the shards hold flat ``"params/fc/w"``-keyed
  leaves, split byte-balanced (largest leaf first into the lightest
  shard), and an empty subtree is one ``__empty_dict__`` key.
  ``save_checkpoint(..., num_shards>=2)`` writes the shards first, each
  atomically, and renames the manifest in last: the manifest is the commit
  point, so a kill between shard files leaves stray shards and the
  previous checkpoint, never a torn one that loads. ``latest`` hard-links
  the epoch's shards under its own names.

A file that fails a digest or does not decode raises
:class:`CheckpointCorruptError`; :func:`quarantine` moves it aside and
:func:`load_latest_with_fallback` resumes from the newest valid file.
:class:`AsyncCheckpointWriter` runs a save on a writer thread with a
one-save lag. The fault injector fires ``checkpoint.read`` on every file
read (the blob, each shard) and ``checkpoint.write`` on every blob before
its atomic write, as the JAX package's does.

The prewarm manifest (``compile/aot.py``) lies beside the checkpoints as
``prewarm_manifest.json``, in the JAX package's keys and atomic write.
"""

import hashlib
import json
import os
import re
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import msgpack
import numpy as np
import torch

from ..core.train_state import TrainState
from ..resilience.faults import NULL_INJECTOR
from ..utils.interop import opt_state_from_jax, opt_state_to_jax, params_from_jax, params_to_jax
from ..utils.trees import tree_flatten

MODEL_NAME = "train_model"
CHECKPOINT_FORMAT = 2  # 1 (implicit): bare payload; 2: sha256-wrapped body
SHARDED_FORMAT = 3  # per-shard leaf files + digest-wrapped manifest

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
#: the flat-key leaf that stands for an empty subtree in a format-3 shard
_EMPTY_MARK = "__empty_dict__"


class CheckpointCorruptError(RuntimeError):
    """The file failed its embedded-digest check or cannot be decoded."""


class InferenceState(NamedTuple):
    """What a server needs: meta-parameters, BN state, learned inner-opt
    hyperparams and the step counter (no outer optimizer state), plus the
    checkpoint file's content hash."""

    params: Any
    bn_state: Any
    inner_hparams: Any
    step: Any
    fingerprint: str


def _path(save_dir: str, idx) -> str:
    return os.path.join(save_dir, f"{MODEL_NAME}_{idx}")


def checkpoint_exists(save_dir: str, idx) -> bool:
    return os.path.exists(_path(save_dir, idx))


def available_epochs(save_dir: str) -> List[int]:
    pattern = re.compile(rf"^{MODEL_NAME}_(\d+)$")
    if not os.path.isdir(save_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(save_dir) if (m := pattern.match(name)))


# ---------------------------------------------------------------------------
# flax msgpack encoding
# ---------------------------------------------------------------------------


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def _ext_pack(obj):
    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_bytes(obj))
    if isinstance(obj, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    return obj


def _sorted_keys(tree):
    """Every dict with its keys in sorted order, as flax's
    ``msgpack_serialize`` lays a tree out (it rebuilds it through
    ``jax.tree_util``)."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [_sorted_keys(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree


def _packb(tree, sort_keys: bool = True) -> bytes:
    """Flax's ``msgpack_serialize`` of ``tree`` byte for byte: sorted keys,
    or (``sort_keys=False``) the tree's own order, as its ``to_bytes`` packs
    a state dict."""
    return msgpack.packb(_sorted_keys(tree) if sort_keys else tree, default=_ext_pack, strict_types=True)


def _ndarray(data: bytes):
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    # a writable copy: torch refuses to share numpy's read-only buffers
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    return msgpack.ExtType(code, data)


def _restore(blob: bytes):
    return msgpack.unpackb(blob, ext_hook=_ext_hook, raw=False, strict_map_key=False)


# ---------------------------------------------------------------------------
# the state in the JAX layout
# ---------------------------------------------------------------------------


def _to_state_dict(state: TrainState, feature_shape) -> Dict[str, Any]:
    """A port ``TrainState`` -> flax's state dict of the JAX package's
    ``TrainState`` (numpy leaves, JAX layout)."""
    if state.opt_state is None:
        raise ValueError("a training checkpoint needs the outer optimizer state (opt_state is None)")
    adam, sched = opt_state_to_jax(state.opt_state, feature_shape)
    # flax's key order: the TrainState's fields in order, the optax states'
    # fields in order, every dict of the trees sorted (as jax.tree rebuilds
    # it), so the blobs are the JAX package's bytes for the same state
    return {
        "params": _sorted_keys(params_to_jax(state.params, feature_shape)),
        "bn_state": _sorted_keys(params_to_jax(state.bn_state, feature_shape)),
        "inner_hparams": _sorted_keys(params_to_jax(state.inner_hparams, feature_shape)),
        "opt_state": {"0": {"count": adam.count, "mu": _sorted_keys(adam.mu), "nu": _sorted_keys(adam.nu)},
                      "1": {"count": sched.count}},
        "step": np.asarray(int(state.step), dtype=np.int32),
    }


def _from_state_dict(net: Dict[str, Any], feature_shape, template: TrainState) -> TrainState:
    """flax's state dict of a JAX ``TrainState`` -> a port ``TrainState``
    with ``template``'s structure, dtypes and device. Raises ``ValueError``
    when the trees differ in keys or shapes."""
    device = tree_flatten(template.params)[0][0].device
    loaded = TrainState(
        params=params_from_jax(net["params"], feature_shape),
        bn_state=params_from_jax(net["bn_state"], feature_shape),
        inner_hparams=params_from_jax(net["inner_hparams"], feature_shape),
        opt_state=opt_state_from_jax(net["opt_state"], feature_shape),
        step=torch.as_tensor(np.asarray(net["step"])),
    )
    out = []
    for field, got, want in zip(TrainState._fields, loaded, template):
        got_leaves, got_paths = tree_flatten(_as_tree(got))
        want_leaves, want_paths = tree_flatten(_as_tree(want))
        if got_paths != want_paths:
            raise ValueError(f"checkpoint {field} has keys {got_paths}, the template {want_paths}")
        for path, g, w in zip(got_paths, got_leaves, want_leaves):
            if tuple(g.shape) != tuple(w.shape):
                raise ValueError(
                    f"checkpoint {field}/{'/'.join(path)} has shape {tuple(g.shape)}, "
                    f"the template {tuple(w.shape)}"
                )
        out.append(_like(got, want, device))
    return TrainState(*out)


def _as_tree(value):
    """A NamedTuple/tuple state as a dict tree (flax's key layout), so that
    it flattens by path like the dicts."""
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return {k: _as_tree(v) for k, v in zip(value._fields, value)}
    if isinstance(value, tuple):
        return {str(i): _as_tree(v) for i, v in enumerate(value)}
    if isinstance(value, dict):
        return {k: _as_tree(v) for k, v in value.items()}
    return value


def _like(value, template, device):
    """``value`` with each leaf in ``template``'s dtype, on ``device``,
    keeping ``value``'s structure (tuples, NamedTuples, dicts)."""
    if isinstance(value, tuple):
        items = [_like(v, t, device) for v, t in zip(value, template)]
        return type(value)(*items) if hasattr(value, "_fields") else tuple(items)
    if isinstance(value, dict):
        return {k: _like(value[k], template[k], device) for k in value}
    return value.to(device=device, dtype=template.dtype)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _read_payload(path: str, injector=NULL_INJECTOR) -> Tuple[Dict[str, Any], bytes]:
    """Read and digest-verify one checkpoint file -> (payload, raw blob)."""
    with open(path, "rb") as f:
        blob = f.read()
    blob = injector.fire_bytes("checkpoint.read", blob)
    try:
        outer = _restore(blob)
    except Exception as exc:  # any decode failure of untrusted bytes is corruption
        raise CheckpointCorruptError(f"{path}: undecodable checkpoint ({exc!r})") from exc
    if isinstance(outer, dict) and "body" in outer and "sha256" in outer:
        body = outer["body"]
        digest = hashlib.sha256(body).hexdigest()
        if digest != outer["sha256"]:
            raise CheckpointCorruptError(
                f"{path}: sha256 mismatch (stored {outer['sha256'][:12]}…, "
                f"computed {digest[:12]}…) — corrupt checkpoint"
            )
        try:
            payload = _restore(body)
        except Exception as exc:
            raise CheckpointCorruptError(f"{path}: undecodable body ({exc!r})") from exc
    else:
        payload = outer  # pre-format-2 file: no digest to verify
    if not isinstance(payload, dict) or ("network" not in payload and "shards" not in payload):
        raise CheckpointCorruptError(f"{path}: payload missing 'network' (blob) or 'shards' (manifest)")
    return payload, blob


def _read_shards(path: str, payload: Dict[str, Any], injector=NULL_INJECTOR) -> Dict[str, Any]:
    """Read and digest-verify every shard a format-3 manifest names -> the
    merged flat leaf dict. A missing or corrupt shard fails the whole
    checkpoint."""
    save_dir = os.path.dirname(path)
    flat: Dict[str, Any] = {}
    for entry in payload["shards"]:
        shard_path = os.path.join(save_dir, entry["file"])
        try:
            with open(shard_path, "rb") as f:
                blob = f.read()
        except OSError as exc:
            raise CheckpointCorruptError(f"{path}: missing shard {entry['file']} ({exc!r})") from exc
        blob = injector.fire_bytes("checkpoint.read", blob)
        digest = hashlib.sha256(blob).hexdigest()
        if digest != entry["sha256"]:
            raise CheckpointCorruptError(
                f"{path}: shard {entry['file']} sha256 mismatch (stored "
                f"{entry['sha256'][:12]}…, computed {digest[:12]}…)"
            )
        try:
            flat.update(_restore(blob))
        except Exception as exc:
            raise CheckpointCorruptError(f"{path}: undecodable shard {entry['file']} ({exc!r})") from exc
    if len(flat) != payload.get("num_leaves", len(flat)):
        raise CheckpointCorruptError(
            f"{path}: manifest promises {payload.get('num_leaves')} leaves, shards hold {len(flat)}"
        )
    return flat


def _unflatten_state_dict(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Flat ``{"params/fc/w": leaf}`` keys -> the nested state dict; an
    ``__empty_dict__`` key keeps its (empty) subtree."""
    nested: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = nested
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if parts[-1] != _EMPTY_MARK:
            node[parts[-1]] = value
    return nested


def _network(path: str, payload: Dict[str, Any], injector=NULL_INJECTOR) -> Dict[str, Any]:
    """The JAX ``TrainState`` state dict of a payload, any format."""
    if "shards" in payload:
        return _unflatten_state_dict(_read_shards(path, payload, injector))
    try:
        return _restore(payload["network"])
    except Exception as exc:
        raise CheckpointCorruptError(f"{path}: undecodable network ({exc!r})") from exc


def load_checkpoint(
    save_dir: str, idx, template: TrainState, injector=NULL_INJECTOR, *, feature_shape
) -> Tuple[TrainState, Dict[str, Any]]:
    """Resume checkpoint ``idx`` (an epoch, ``'latest'`` or ``'best'``),
    written by either package in format 1, 2 or 3, as a port ``TrainState``
    with ``template``'s structure and device (an ``init_train_state()``
    result), the outer Adam state included. ``feature_shape`` is the
    model's ``(C, H, W)`` before the head (``Model.feature_shape``).
    Returns ``(state, bookkeeping)``."""
    path = _path(save_dir, idx)
    payload, _ = _read_payload(path, injector)
    return _from_state_dict(_network(path, payload, injector), feature_shape, template), payload["bookkeeping"]


def load_latest_with_fallback(
    save_dir: str, template: TrainState, injector=NULL_INJECTOR, *, feature_shape
) -> Tuple[TrainState, Dict[str, Any], Any]:
    """Resume chain: ``latest`` first, then per-epoch files newest-first.
    Every corrupt candidate is quarantined (``*.corrupt``) and the chain
    moves on, so one torn write costs one epoch of progress, not the run.
    Returns ``(state, bookkeeping, idx_used)``; raises
    :class:`CheckpointCorruptError` only when no candidate survives."""
    errors = []
    for idx in ["latest"] + list(reversed(available_epochs(save_dir))):
        if not checkpoint_exists(save_dir, idx):
            continue
        try:
            state, bookkeeping = load_checkpoint(save_dir, idx, template, injector, feature_shape=feature_shape)
            return state, bookkeeping, idx
        except CheckpointCorruptError as exc:
            quarantined = quarantine(save_dir, idx)
            errors.append(str(exc))
            print(
                f"warning: checkpoint {MODEL_NAME}_{idx} is corrupt — "
                f"quarantined to {quarantined}; falling back",
                flush=True,
            )
    raise CheckpointCorruptError(f"no valid checkpoint under {save_dir}: " + "; ".join(errors))


def load_for_inference(save_dir: str, idx, injector=NULL_INJECTOR) -> Tuple[InferenceState, Dict[str, Any]]:
    """Params / BN state / inner hyperparams / step of checkpoint ``idx`` in
    the JAX layout, any format. A format-3 fingerprint hashes the manifest,
    which names every shard's digest."""
    path = _path(save_dir, idx)
    payload, blob = _read_payload(path, injector)
    net = _network(path, payload, injector)
    try:
        state = InferenceState(
            params=net["params"],
            bn_state=net["bn_state"],
            inner_hparams=net["inner_hparams"],
            step=np.asarray(net["step"]),
            fingerprint=hashlib.sha256(blob).hexdigest(),
        )
    except Exception as exc:
        raise CheckpointCorruptError(f"{path}: undecodable network ({exc!r})") from exc
    return state, payload["bookkeeping"]


# ---------------------------------------------------------------------------
# writing (formats 2 and 3)
# ---------------------------------------------------------------------------


def _serialize(state: TrainState, bookkeeping: Dict[str, Any], feature_shape) -> bytes:
    network = _packb(_to_state_dict(state, feature_shape), sort_keys=False)
    body = _packb({"network": network, "bookkeeping": bookkeeping})
    # format 2: the body's digest rides inside the file
    return _packb({"format": CHECKPOINT_FORMAT, "sha256": hashlib.sha256(body).hexdigest(), "body": body})


def _write_atomic(target: str, blob: bytes, injector=NULL_INJECTOR) -> None:
    blob = injector.fire_bytes("checkpoint.write", blob)
    # a unique temp per (process, thread): two writers of one target each
    # rename a COMPLETE file into place
    tmp = f"{target}.tmp-{os.getpid()}-{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, target)


def _shard_files(path: str) -> List[str]:
    """The live ``<path>.shard<N>`` files of a format-3 checkpoint."""
    pattern = re.compile(re.escape(os.path.basename(path)) + r"\.shard\d+$")
    parent = os.path.dirname(path) or "."
    if not os.path.isdir(parent):
        return []
    return sorted(os.path.join(parent, name) for name in os.listdir(parent) if pattern.fullmatch(name))


def quarantine(save_dir: str, idx) -> Optional[str]:
    """Rename a corrupt checkpoint to ``*.corrupt`` (kept for forensics,
    invisible to ``available_epochs``/``checkpoint_exists``), a format-3
    checkpoint's shard files with it. Returns the new path, or None if the
    file was already gone."""
    path = _path(save_dir, idx)
    if not os.path.exists(path):
        return None
    for shard in _shard_files(path):
        os.replace(shard, shard + ".corrupt")
    target = path + ".corrupt"
    os.replace(path, target)
    return target


def save_named(
    save_dir: str, state: TrainState, bookkeeping: Dict[str, Any], idx, injector=NULL_INJECTOR, *, feature_shape
) -> str:
    """Write a single format-2 checkpoint file under any idx (``'best'``,
    an emergency ``'latest'``)."""
    os.makedirs(save_dir, exist_ok=True)
    path = _path(save_dir, idx)
    _write_atomic(path, _serialize(state, bookkeeping, feature_shape), injector)
    return path


def _flatten_state_dict(nested, prefix: str = "") -> Dict[str, Any]:
    """A nested state dict -> flat ``{"params/fc/w": leaf}``; an empty
    subtree becomes one ``__empty_dict__`` leaf (a zero-length uint8 array),
    so the restore keeps it."""
    flat: Dict[str, Any] = {}
    for key, value in nested.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            if value:
                flat.update(_flatten_state_dict(value, name))
            else:
                flat[f"{name}/{_EMPTY_MARK}"] = np.zeros(0, np.uint8)
        else:
            flat[name] = value
    return flat


def _partition_keys(flat: Dict[str, Any], num_shards: int) -> List[List[str]]:
    """Greedy byte-balanced partition of the leaf keys into ``num_shards``
    groups (largest leaf first into the lightest bin; ties on key order),
    as the JAX package partitions them."""
    sized = sorted(flat.items(), key=lambda kv: (-int(getattr(kv[1], "nbytes", 0) or 0), kv[0]))
    bins: List[List[str]] = [[] for _ in range(num_shards)]
    weights = [0] * num_shards
    for key, value in sized:
        i = weights.index(min(weights))
        bins[i].append(key)
        weights[i] += int(getattr(value, "nbytes", 0) or 0) + 1
    return bins


def _shard_path(path: str, k: int) -> str:
    return f"{path}.shard{k}"


def _sharded_serialize(state: TrainState, num_shards: int, feature_shape) -> Tuple[List[bytes], int]:
    """-> (shard blobs, leaf count): each shard a msgpack map of flat key ->
    ndarray, in the JAX layout. The partition orders the keys itself, so the
    shards hold the JAX package's bytes for the same state."""
    flat = _flatten_state_dict(_to_state_dict(state, feature_shape))
    blobs = [_packb({key: flat[key] for key in keys}) for keys in _partition_keys(flat, num_shards)]
    return blobs, len(flat)


def _manifest_blob(shard_entries: List[Dict[str, Any]], bookkeeping: Dict[str, Any], num_leaves: int) -> bytes:
    body = _packb({"shards": shard_entries, "num_leaves": num_leaves, "bookkeeping": bookkeeping})
    return _packb({"format": SHARDED_FORMAT, "sha256": hashlib.sha256(body).hexdigest(), "body": body})


def _save_sharded(
    save_dir: str, state: TrainState, bookkeeping: Dict[str, Any], epoch: int, num_shards: int,
    feature_shape, injector=NULL_INJECTOR,
) -> str:
    """Format-3 save (JAX package ``_save_sharded``): every shard written
    atomically, then the manifests, the epoch's and ``latest``'s: a rename
    of a manifest is the commit point. ``latest``'s shards are hard links
    of the epoch's (a copy where the filesystem has none), under its own
    names, so rotating the epoch away never strands it. The injector's
    ``checkpoint.write`` fires on each file, between the shards."""
    path = _path(save_dir, epoch)
    latest = _path(save_dir, "latest")
    blobs, num_leaves = _sharded_serialize(state, num_shards, feature_shape)
    entries, latest_entries = [], []
    for k, blob in enumerate(blobs):
        shard = _shard_path(path, k)
        _write_atomic(shard, blob, injector)
        # the digest of the bytes as written (the injector's included): an
        # injected torn write is detected at load, like rot
        with open(shard, "rb") as f:
            written = f.read()
        digest = hashlib.sha256(written).hexdigest()
        entries.append({"file": os.path.basename(shard), "sha256": digest})
        link = _shard_path(latest, k)
        tmp = f"{link}.tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            os.link(shard, tmp)
        except OSError:  # no hard links on this filesystem: a plain copy
            with open(tmp, "wb") as f:
                f.write(written)
        os.replace(tmp, link)
        latest_entries.append({"file": os.path.basename(link), "sha256": digest})
    _write_atomic(path, _manifest_blob(entries, bookkeeping, num_leaves), injector)
    _write_atomic(latest, _manifest_blob(latest_entries, bookkeeping, num_leaves), injector)
    # a previous save under the same name with more shards leaves files the
    # new manifests do not name: sweep them once both manifests committed
    named = {os.path.basename(_shard_path(p, k)) for p in (path, latest) for k in range(len(blobs))}
    for target in (path, latest):
        for stale in _shard_files(target):
            if os.path.basename(stale) not in named:
                os.remove(stale)
    return path


def _rotate(save_dir: str, keep: int, val_acc_by_epoch: Optional[Dict[int, float]] = None) -> None:
    """Keep ``keep`` per-epoch files: the most recent, or the best by
    validation accuracy when ``val_acc_by_epoch`` is given (unrecorded
    epochs rank lowest, ties oldest-first). A format-3 epoch's shards go
    with its manifest."""
    if keep <= 0:
        return
    epochs = available_epochs(save_dir)
    if val_acc_by_epoch is not None:
        epochs = sorted(epochs, key=lambda e: (val_acc_by_epoch.get(e, -1.0), e))
    for epoch in epochs[:-keep]:
        path = _path(save_dir, epoch)
        for shard in _shard_files(path):
            os.remove(shard)
        os.remove(path)


def save_checkpoint(
    save_dir: str,
    state: TrainState,
    bookkeeping: Dict[str, Any],
    epoch: int,
    *,
    feature_shape,
    max_models_to_save: int = 5,
    val_acc_by_epoch: Optional[Dict[int, float]] = None,
    injector=NULL_INJECTOR,
    num_shards: int = 1,
) -> str:
    """Write ``train_model_{epoch}`` and ``train_model_latest`` (JAX
    layout) and rotate: format 2, or with ``num_shards >= 2`` format 3
    (:func:`_save_sharded`). Rotation keeps ``max_models_to_save``
    per-epoch files, the most recent, or the best by validation accuracy
    when ``val_acc_by_epoch`` is given."""
    os.makedirs(save_dir, exist_ok=True)
    if num_shards >= 2:
        path = _save_sharded(save_dir, state, bookkeeping, epoch, num_shards, feature_shape, injector)
    else:
        blob = _serialize(state, bookkeeping, feature_shape)
        path = _path(save_dir, epoch)
        for target in (path, _path(save_dir, "latest")):
            _write_atomic(target, blob, injector)
    _rotate(save_dir, max_models_to_save, val_acc_by_epoch)
    return path


class AsyncCheckpointWriter:
    """One-save-lag background checkpoint writer.

    The save (serialization and the atomic writes) runs on a writer thread,
    and the caller blocks only on the *previous* save at the next save
    point. The writer thread makes no CUDA call: the caller hands it a
    state already copied to the host.

    A failed save re-raises on the next :meth:`wait`/:meth:`submit`/
    :meth:`close`, so a dead disk surfaces one save late, never silently.
    At most one save is in flight; the writes themselves stay atomic
    (tmp+rename), so killing the process mid-save never leaves a torn
    checkpoint that loads."""

    def __init__(self, name: str = "ckpt-writer"):
        self._name = name
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, fn: Callable[[], None]) -> None:
        """Block on the previous save (the one-save lag), then start ``fn``
        on the writer thread."""
        self.wait()

        def run():
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001 — carried to wait()
                self._error = exc

        self._thread = threading.Thread(target=run, name=self._name, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight save, if any; re-raise its failure."""
        thread = self._thread
        if thread is not None:
            thread.join()
            self._thread = None
        if self._error is not None:
            error = self._error
            self._error = None
            raise error

    @property
    def busy(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    def close(self) -> None:
        self.wait()


# ---------------------------------------------------------------------------
# the prewarm manifest (compile/aot.py), beside the checkpoints: a restarted
# process reads it to learn whether its prewarm will find the kernels built
# for this environment
# ---------------------------------------------------------------------------

PREWARM_MANIFEST = "prewarm_manifest.json"


def prewarm_manifest_path(save_dir: str) -> str:
    return os.path.join(save_dir, PREWARM_MANIFEST)


def save_prewarm_manifest(save_dir: str, manifest: Dict[str, Any]) -> str:
    """Atomic write (the checkpoints' temp file and rename: a kill mid-write
    leaves the previous manifest, never a torn one)."""
    os.makedirs(save_dir, exist_ok=True)
    path = prewarm_manifest_path(save_dir)
    _write_atomic(path, json.dumps(manifest, indent=1).encode())
    return path


def load_prewarm_manifest(save_dir: str) -> Optional[Dict[str, Any]]:
    """None when absent or unreadable: a bad manifest reads as no
    manifest (a cold start)."""
    try:
        with open(prewarm_manifest_path(save_dir)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
