"""Per-program build ledger: every program the port builds, priced and
attributed (JAX package ``observability/compile_ledger.py``).

One JSON line per build goes to ``logs/compile_ledger.jsonl``, in the JAX
ledger's keys::

    {"ts": ..., "program": "train_multi/True/True", "lower_s": 0.41,
     "compile_s": 0.62, "total_s": 1.03, "cold": true,
     "persistent_cache": null, "flops": 1.2e12, "bytes_accessed": null,
     "memory": {...}, "error": null, "session": "..."}

and the in-process aggregate (:meth:`CompileLedger.summary`) is a telemetry
hub provider and the ``/metrics`` block of a serving frontend.

Eager PyTorch compiles nothing, so what the port builds, and what each
entry's numbers are:

- **a CUDA graph capture** (``core/programs.py``, a multi-step train or a
  fused eval program on the card): ``lower_s`` is the warmup run's seconds,
  ``compile_s`` the capture plus the graph's instantiation, ``flops`` the
  warmup's count (``observability/costs.py::step_cost``), ``memory`` the
  graph pool's growth. The program prices itself: :meth:`wrap_build` hands
  it the ledger;
- **the first eager dispatch of a planned program** (the K=1 train step of
  each variant, eval, the multi-step programs on the CPU): ``total_s`` and
  the call's FLOPs (:class:`LedgerWrapped`), or ``total_s`` only where the
  caller records it (the serving engine's first flush of each planned
  shape, as the JAX ledger's guard-fed entries are);
- **an ``nvcc`` build** of a kernel source (:meth:`record_kernel_builds`):
  ``program: "nvcc/<source>"``, ``compile_s`` the compiler's seconds, and
  ``persistent_cache = {"dir": BUILD_DIR, "entries_added": 0|1, "hit":
  <library existed>}``. The build directory, whose file names hash the
  sources and flags (``ops/_kernels.py``), is the port's counterpart of
  ``utils/compcache.py``'s persistent XLA cache, so no separate module
  reads it.

One difference from the JAX ledger: where JAX falls back to the plain
jitted call after an AOT failure, a build that fails here is recorded with
its error **and re-raised**. The only fallback would be the eager path, and
a graph that silently became eager would hide the path it exists for.

With no ``logs_dir`` the ledger collects only (a serving frontend owns no
run directory; its summary rides ``/metrics`` and the hub provider).
"""

import time
from typing import Any, Callable, Dict, Optional

from ..utils.locks import san_lock
from .costs import priced_call


def program_name(key: Any) -> str:
    """Canonical ledger name for a program key: tuples join with ``/``
    (``("train", True, False)`` -> ``"train/True/False"``)."""
    if isinstance(key, (list, tuple)):
        return "/".join(str(k) for k in key)
    return str(key)


class CompileLedger:
    def __init__(
        self,
        logs_dir: Optional[str] = None,
        session: Optional[str] = None,
        clock: Callable[[], float] = time.perf_counter,
        wall_clock: Callable[[], float] = time.time,
    ):
        self._clock = clock
        self._wall_clock = wall_clock
        self.session = session
        self._lock = san_lock("CompileLedger._lock")
        # program name -> aggregate {builds, lower_s, compile_s, total_s,
        # cache_hits, errors, flops, bytes_accessed, peak_bytes, donated_bytes}
        self._programs: Dict[str, Dict[str, Any]] = {}
        self._entries = 0
        self._log = None
        if logs_dir is not None:
            from ..experiment.storage import EventLog

            self._log = EventLog(logs_dir, filename="compile_ledger.jsonl")
        #: optional observer called with each entry dict AFTER it is
        #: recorded (the runner sets the flops_per_step gauge from it).
        #: Observer errors are contained.
        self.on_entry: Optional[Callable[[Dict[str, Any]], None]] = None

    # ------------------------------------------------------------------

    def record(
        self,
        program: Any,
        lower_s: Optional[float] = None,
        compile_s: Optional[float] = None,
        total_s: Optional[float] = None,
        cold: bool = True,
        persistent_cache: Optional[Dict[str, Any]] = None,
        flops: Optional[float] = None,
        bytes_accessed: Optional[float] = None,
        error: Optional[str] = None,
        memory: Optional[Dict[str, Any]] = None,
        **extra: Any,
    ) -> Dict[str, Any]:
        """Append one ledger entry (and fold it into the in-process
        aggregate). Never raises."""
        name = program_name(program)
        if total_s is None and (lower_s is not None or compile_s is not None):
            total_s = (lower_s or 0.0) + (compile_s or 0.0)
        entry: Dict[str, Any] = {
            "ts": self._wall_clock(),
            "program": name,
            "lower_s": round(lower_s, 4) if lower_s is not None else None,
            "compile_s": round(compile_s, 4) if compile_s is not None else None,
            "total_s": round(total_s, 4) if total_s is not None else None,
            "cold": bool(cold),
            "persistent_cache": persistent_cache,
            "flops": flops,
            "bytes_accessed": bytes_accessed,
            "memory": memory,
            "error": error,
        }
        if self.session is not None:
            entry["session"] = self.session
        entry.update(extra)
        with self._lock:
            self._entries += 1
            agg = self._programs.setdefault(
                name,
                {"builds": 0, "lower_s": 0.0, "compile_s": 0.0, "total_s": 0.0, "cache_hits": 0, "errors": 0,
                 "flops": None, "bytes_accessed": None, "peak_bytes": None, "donated_bytes": None},
            )
            agg["builds"] += 1
            agg["lower_s"] = round(agg["lower_s"] + (lower_s or 0.0), 4)
            agg["compile_s"] = round(agg["compile_s"] + (compile_s or 0.0), 4)
            agg["total_s"] = round(agg["total_s"] + (total_s or 0.0), 4)
            if persistent_cache and persistent_cache.get("hit"):
                agg["cache_hits"] += 1
            if error is not None:
                agg["errors"] += 1
            if flops is not None:
                agg["flops"] = flops
            if bytes_accessed is not None:
                agg["bytes_accessed"] = bytes_accessed
            if memory is not None:
                if memory.get("peak_bytes") is not None:
                    agg["peak_bytes"] = memory["peak_bytes"]
                if memory.get("alias_bytes") is not None:
                    agg["donated_bytes"] = memory["alias_bytes"]
        if self._log is not None:
            try:
                self._log.append(entry)
            except Exception:
                pass  # a full disk must not turn a build into a crash
        observer = self.on_entry
        if observer is not None:
            try:
                observer(entry)
            except Exception:
                pass
        return entry

    def summary(self) -> Dict[str, Any]:
        """The build-tax aggregate (hub provider / ``/metrics`` payload):
        totals plus the per-program table."""
        with self._lock:
            programs = {k: dict(v) for k, v in self._programs.items()}
            entries = self._entries
        peaks = [p["peak_bytes"] for p in programs.values() if p.get("peak_bytes")]
        donated = [p["donated_bytes"] for p in programs.values() if p.get("donated_bytes")]
        return {
            "entries": entries,
            "programs": len(programs),
            "total_lower_s": round(sum(p["lower_s"] for p in programs.values()), 3),
            "total_compile_s": round(sum(p["compile_s"] for p in programs.values()), 3),
            "total_s": round(sum(p["total_s"] for p in programs.values()), 3),
            "cache_hits": sum(p["cache_hits"] for p in programs.values()),
            "errors": sum(p["errors"] for p in programs.values()),
            "peak_program_bytes": max(peaks) if peaks else None,
            "donated_bytes": max(donated) if donated else None,
            "by_program": programs,
        }

    def close(self) -> None:
        if self._log is not None:
            self._log.close()

    # ------------------------------------------------------------------
    # the build seams
    # ------------------------------------------------------------------

    def wrap_build(self, program: Any, fn: Callable) -> Callable:
        """Wrap a freshly built program callable so that what it builds is a
        ledger entry. A program that prices its own builds (a captured CUDA
        graph: its warmup and capture ARE the build) is handed the ledger and
        returned as it is; an eager callable is wrapped in
        :class:`LedgerWrapped`."""
        if getattr(fn, "prices_own_builds", False):
            fn.attach_ledger(self, program_name(program))
            return fn
        return LedgerWrapped(self, program_name(program), fn)

    def record_kernel_builds(self, report: Dict[str, Dict[str, Any]], build_dir: str) -> None:
        """One ``nvcc/<source>`` entry per source of an
        ``ops/_kernels.build()`` report: the compiler's seconds for a build,
        a persistent-cache hit for a library that already existed."""
        for source, info in report.items():
            built = bool(info.get("built"))
            self.record(
                f"nvcc/{source}",
                compile_s=float(info.get("seconds") or 0.0),
                cold=built,
                persistent_cache={"dir": build_dir, "entries_added": int(built), "hit": not built},
                library=info.get("library"),
            )


class LedgerWrapped:
    """An eager program callable whose first dispatch per argument signature
    is a ledger entry: timed, and priced by the flop counter on the way
    (``costs.priced_call``, so the first step is not run twice). Later calls
    of a seen signature (of the positional arguments) go straight to the
    callable. A first call that
    raises is recorded with its error and the exception re-raised; its
    signature stays unseen."""

    def __init__(self, ledger: CompileLedger, program: str, fn: Callable):
        self._ledger = ledger
        self.program = program
        self._fn = fn
        self._lock = san_lock("LedgerWrapped._lock")
        self._seen: set = set()
        self._clock = ledger._clock

    @staticmethod
    def _signature(args) -> Any:
        """The positional arguments' abstract signature. Keyword arguments
        are the host switches a call passes through (the train step's
        ``epoch``), not part of the program."""
        from ..utils.strictmode import abstract_signature

        try:
            return abstract_signature(args)
        except Exception:
            return ("unsigned",)

    def __call__(self, *args, **kwargs):
        sig = self._signature(args)
        with self._lock:
            first = sig not in self._seen
            self._seen.add(sig)
        if not first:
            return self._fn(*args, **kwargs)
        t0 = self._clock()
        try:
            out, cost = priced_call(self._fn, *args, **kwargs)
        except Exception as exc:
            with self._lock:
                self._seen.discard(sig)
            self._ledger.record(self.program, total_s=self._clock() - t0, cold=True,
                                error=f"first dispatch failed: {type(exc).__name__}: {exc}")
            raise
        self._ledger.record(self.program, total_s=self._clock() - t0, cold=True, flops=cost.get("flops"),
                            bytes_accessed=cost.get("bytes_accessed"), signature_index=len(self._seen))
        return out
