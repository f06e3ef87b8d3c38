"""Build + ctypes bindings for the native episode-assembly engine (host
C++, a copy of the JAX package's ``native/``).

The shared library is compiled from ``episode_engine.cpp`` on first use with
the system ``g++`` (plain C ABI + ctypes) into the package's ``build/``
directory, never next to the source; it is rebuilt whenever the source is
newer. ``load_engine()`` returns None when no compiler/toolchain is
available, and callers fall back to the pure-numpy path — the native engine
is a fast path, never a requirement (the loader counts which path served
each batch, ``MetaLearningDataLoader.stats()``).
"""

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "episode_engine.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
_LIB = os.path.join(BUILD_DIR, "episode_engine.so")
_lock = threading.Lock()
_engine = None
_engine_failed = False


def _build() -> bool:
    # compile to a process-unique temp path, then atomically os.replace into
    # place: concurrent builders race harmlessly, and an interrupted g++ can
    # never leave a partial .so at the canonical path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def load_engine() -> Optional[ctypes.CDLL]:
    """The compiled engine with argtypes set, or None if unavailable."""
    global _engine, _engine_failed
    with _lock:
        if _engine is not None:
            return _engine
        if _engine_failed:
            return None
        stale = not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        if stale and not _build():
            _engine_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            # e.g. a corrupt .so from an older interrupted writer: remove and
            # rebuild once before giving up on the native path
            try:
                os.remove(_LIB)
            except OSError:
                pass
            if not _build():
                _engine_failed = True
                return None
            try:
                lib = ctypes.CDLL(_LIB)
            except OSError:
                _engine_failed = True
                return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.assemble_episodes.restype = ctypes.c_int
        lib.assemble_episodes.argtypes = [
            f32p,  # cache
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),  # image_idx
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),  # rot_k
            f32p,  # out
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # B, n_way, n_samples
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # H, W, C
            f32p, f32p,  # mean, std
            ctypes.c_int,  # has_norm
            ctypes.c_int,  # num_threads
        ]
        _engine = lib
        return _engine


_NO_NORM = np.zeros(1, np.float32), np.ones(1, np.float32)


def assemble_episodes(
    cache: np.ndarray,       # [total_images, H, W, C] float32
    image_idx: np.ndarray,   # [B, n_way, n_samples] int64
    rot_k: np.ndarray,       # [B, n_way] int32
    mean: Optional[np.ndarray] = None,
    std: Optional[np.ndarray] = None,
    num_threads: int = 4,
) -> Optional[np.ndarray]:
    """One native call: gather + rot90 + normalize + pack a whole meta-batch.

    Returns ``[B, n_way, n_samples, H, W, C]`` float32, or None when the
    native engine is unavailable (caller falls back to numpy).
    """
    lib = load_engine()
    if lib is None:
        return None
    B, n_way, n_samples = image_idx.shape
    _, H, W, C = cache.shape
    out = np.empty((B, n_way, n_samples, H, W, C), np.float32)
    has_norm = int(mean is not None)
    m, s = (mean, std) if has_norm else _NO_NORM
    rc = lib.assemble_episodes(
        np.ascontiguousarray(cache),
        np.ascontiguousarray(image_idx, np.int64),
        np.ascontiguousarray(rot_k, np.int32),
        out, B, n_way, n_samples, H, W, C,
        np.ascontiguousarray(m, np.float32),
        np.ascontiguousarray(s, np.float32),
        has_norm, num_threads,
    )
    if rc != 0:
        raise ValueError("assemble_episodes: odd rotation of non-square images")
    return out
