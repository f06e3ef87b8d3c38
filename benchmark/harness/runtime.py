"""What a run shares: the set-up clock, the host spans, the run's deadline,
the card's description and the check that no JAX module was loaded."""

import contextlib
import os
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

_T0 = time.perf_counter()

#: top-level module names a run may not load (the port's name begins with
#: the JAX package's, so names are compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "howtotrainyourmamlpytorch_tpu")


def seconds_since_start() -> float:
    """Seconds since this process started, from ``/proc`` (the interpreter's
    start and every import count); where ``/proc`` cannot be read, since
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> List[str]:
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN_MODULES))


class Deadline:
    """Ends the process, with no result line, where a run outlives
    ``seconds`` (a wedged card never returns from its call; the timer thread
    still runs and exits)."""

    def __init__(self, seconds: float):
        self._timer = threading.Timer(seconds, self._expire, args=(seconds,))
        self._timer.daemon = True
        self._timer.start()

    @staticmethod
    def _expire(seconds: float) -> None:
        print(f"benchmark: the run passed its deadline of {seconds:.0f} s; no result", file=sys.stderr, flush=True)
        os._exit(3)

    def cancel(self) -> None:
        self._timer.cancel()


class Spans:
    """The harness's host spans around its calls into the program: each
    ``(name, start, end, thread)`` on ``time.perf_counter`` and the thread's
    native id, from any thread, and, while a profiler records, a
    ``record_function`` range of the same name (the profiler sees those of
    the thread that started it, which places the others on its timeline,
    ``harness/trace.py``)."""

    def __init__(self):
        self.records: List[Tuple[str, float, float, int]] = []
        self.annotate = False
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.annotate:
            import torch

            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with ctx:
            yield
        t1 = time.perf_counter()
        with self._lock:
            self.records.append((name, t0, t1, threading.get_native_id()))

    def seconds(self, name: str) -> List[float]:
        with self._lock:
            return [t1 - t0 for n, t0, t1, _ in self.records if n == name]

    def since(self, t: float) -> List[Tuple[str, float, float, int]]:
        with self._lock:
            return [r for r in self.records if r[2] >= t]


def power_limit() -> Optional[str]:
    """``name, power.limit`` of the card as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None
