"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file (with the headers ``csrc/*.cuh`` it includes) is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface and loaded with ``ctypes``. Nothing is built
when this module is imported: :func:`library` builds a source at its first
use, from the repository's sources only, into ``build/`` beside this package
(listed in ``.gitignore``). A library's file name carries a hash of its
sources and flags, so an edited kernel is rebuilt and a built one is reused.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for all.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(_PACKAGE, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# the C functions each source exports: name -> (argtypes, restype). The
# leaf records are kRecordWords uint64 words per leaf (csrc/tree_chunks.cuh).
_RECORDS = ctypes.POINTER(ctypes.c_uint64)
_SIGNATURES = {
    "fused_sgd.cu": {
        "fused_sgd_forward": (
            [
                _RECORDS,  # records: p, g, out, lr, numel per leaf
                ctypes.c_int,  # n_leaves
                ctypes.c_int,  # dtype code
                ctypes.c_void_p,  # stream
            ],
            ctypes.c_int,
        ),
    },
    "fused_sgd_bwd.cu": {
        "fused_sgd_backward": (
            [
                _RECORDS,  # records: ct, g, dg, lr, numel per leaf
                ctypes.c_int,  # n_leaves
                ctypes.c_void_p,  # partial: float32 scratch, one per chunk
                ctypes.c_int,  # its length
                ctypes.c_void_p,  # dlr: [n_leaves] float32
                ctypes.c_int,  # dtype code
                ctypes.c_void_p,  # stream
            ],
            ctypes.c_int,
        ),
        "fused_sgd_chunks": (
            [
                _RECORDS,  # records, as fused_sgd_backward's
                ctypes.c_int,  # n_leaves
                ctypes.c_int,  # dtype code
                ctypes.POINTER(ctypes.c_int32),  # first_chunk: [n_leaves + 1] out, or None
            ],
            ctypes.c_int,  # the chunk count, -1 if the records are out of range
        ),
    },
}

SOURCES = tuple(_SIGNATURES)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from csrc/ at first use"
        )
    return found


def library_path(source: str) -> str:
    """The library's path; its name hashes the source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest[:16]}.so")


def build(sources: Sequence[str] = SOURCES) -> Dict[str, Dict[str, object]]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns per source its library path,
    whether this call built it, the build seconds (0 when it was already
    built) and the compiler's resource report (``-Xptxas=-v``). Raises with
    the compiler's output if any fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    report: Dict[str, Dict[str, object]] = {}
    for source in sources:
        target = library_path(source)
        if os.path.exists(target):
            report[source] = {"library": target, "built": False, "seconds": 0.0, "ptxas": ""}
            continue
        tmp = f"{target}.tmp-{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[source] = (proc, tmp, target, time.perf_counter())
    failures = []
    for source, (proc, tmp, target, t0) in started.items():
        output, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{source}: nvcc exited {proc.returncode}\n{output}")
            continue
        os.replace(tmp, target)
        report[source] = {"library": target, "built": True, "seconds": seconds, "ptxas": output}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed, with every
    exported function's ``argtypes``/``restype`` declared."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(library_path(source))
            for name, (argtypes, restype) in _SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[source] = lib
        return lib
