"""Deterministic, seeded fault injection at the port's seams (the JAX
package's ``resilience/faults.py``).

A config/env-driven list of injection specs names a site (a seam the
production code already passes through), a fault kind, and a deterministic
trigger, and the seam fires the injector on every call. With no specs the
injector is inert — one attribute check per seam, no RNG draws.

Sites wired in the port (grep for ``fire(``):

==================  ========================================================
``loader.episode``    ``data/loader.py`` — episode-batch assembly (raise =
                      transient I/O; retried by the loader's retry wrapper)
``serving.dispatch``  ``serving/engine.py`` — device dispatch of a batched
                      adapt/predict flush (raise trips the circuit breaker,
                      delay = a slow card)
``serving.http``      ``serving/server.py`` — request handler, after the
                      body is drained (raise = handler bug -> 500, delay =
                      slow client path)
``serving.refine``    ``serving/engine.py`` — refine dispatch (nan-loss =
                      poisoned refinement observed by the rollback guard,
                      raise = dispatch failure, delay = slow refine)
==================  ========================================================

The training seams ``runner.step``, ``checkpoint.read`` and
``checkpoint.write`` are not wired yet (ROADMAP.md A9): :func:`injector_from`
raises ``NotImplementedError`` for a spec naming one, so a drill is never
silently skipped.

Spec grammar (one string per fault; ``;``-separated when packed into the
``HTYMP_FAULTS`` environment variable)::

    <site>=<kind>[:opt=val[,opt=val...]]

    kinds:    raise | corrupt-bytes | nan-loss | delay | sigterm
    options:  nth=N      fire only on the Nth call at the site (1-based)
              times=N    fire on the first N calls (after ``after``, if set)
              after=N    skip the first N calls (combine with times for a
                         burst: after=39,times=3 fires on calls 40-42)
              p=F        fire with probability F per call (seeded, so a
                         given (seed, call-index) always decides the same)
              delay_s=F  sleep duration for kind=delay
"""

import os
import signal
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.locks import san_lock

KINDS = ("raise", "corrupt-bytes", "nan-loss", "delay", "sigterm")

#: The seams the port does not fire yet (ROADMAP.md A9).
UNWIRED_SEAMS = ("runner.step", "checkpoint.read", "checkpoint.write")

# env var merged into every config-built injector: drills on a live run
# without editing its config
ENV_VAR = "HTYMP_FAULTS"


class InjectedFault(OSError):
    """Raised by ``kind=raise`` sites. An OSError subclass so transient-I/O
    retry wrappers (``resilience.retry.retry_call`` with the default
    ``retry_on=(OSError,)``) treat it exactly like the real thing."""


@dataclass
class FaultSpec:
    site: str
    kind: str
    p: float = 1.0
    nth: int = 0  # 0 = no nth trigger
    times: int = 0  # 0 = no first-N trigger
    after: int = 0  # skip the first N calls (shifts the times window)
    delay_s: float = 0.01

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        head, _, opts = text.strip().partition(":")
        site, eq, kind = head.partition("=")
        if not eq or not site or kind not in KINDS:
            raise ValueError(
                f"bad fault spec {text!r}: want '<site>=<kind>[:opt=val,...]' "
                f"with kind in {KINDS}"
            )
        spec = cls(site=site.strip(), kind=kind.strip())
        for item in filter(None, (o.strip() for o in opts.split(","))):
            key, eq, val = item.partition("=")
            if not eq or key not in ("p", "nth", "times", "after", "delay_s"):
                raise ValueError(f"bad fault option {item!r} in spec {text!r}")
            setattr(spec, key, float(val) if key in ("p", "delay_s") else int(val))
        if not 0.0 <= spec.p <= 1.0:
            raise ValueError(f"fault p must be in [0, 1], got {spec.p} in {text!r}")
        return spec


class FaultInjector:
    """Holds parsed specs and decides, per call at a site, whether (and which)
    fault fires. Deterministic: probability triggers hash (seed, site,
    call-index), so the same configuration replays the same fault sequence
    — the JAX package's decisions, call for call.

    Side effects by kind:

    - ``raise``: raises :class:`InjectedFault`
    - ``delay``: calls the injected ``sleep`` (real by default, fake in tests)
    - ``sigterm``: sends SIGTERM to this process
    - ``corrupt-bytes``: only meaningful through :meth:`fire_bytes`, which
      returns a deterministically bit-flipped copy of the payload
    - ``nan-loss``: no side effect here — :meth:`fire` returns the kind and
      the seam poisons its own result
    """

    def __init__(
        self,
        specs: Sequence[FaultSpec] = (),
        seed: int = 0,
        sleep=time.sleep,
        kill=os.kill,
    ):
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for spec in specs:
            self._by_site.setdefault(spec.site, []).append(spec)
        self.seed = seed
        self._sleep = sleep
        self._kill = kill
        # the serving seams fire from concurrent threads (batcher workers,
        # HTTP handlers) sharing one injector: the call counters must be
        # atomic or nth/times/p triggers lose their deterministic replay
        self._lock = san_lock("FaultInjector._lock")
        self._calls: Dict[str, int] = {}
        # (site, kind) -> times fired; the observability surface for drills
        self.fired: Dict[str, int] = {}

    @classmethod
    def from_specs(
        cls,
        specs: Sequence[str],
        seed: int = 0,
        include_env: bool = True,
        **kwargs,
    ) -> "FaultInjector":
        """Build from spec strings (e.g. ``Config.resilience.faults``), merging
        in the ``HTYMP_FAULTS`` env var (``;``-separated) unless told not to."""
        texts = list(specs)
        if include_env and os.environ.get(ENV_VAR):
            texts += [s for s in os.environ[ENV_VAR].split(";") if s.strip()]
        return cls([FaultSpec.parse(t) for t in texts], seed=seed, **kwargs)

    @property
    def enabled(self) -> bool:
        return bool(self._by_site)

    def _decide(self, site: str) -> Optional[FaultSpec]:
        specs = self._by_site.get(site)
        if not specs:
            return None
        with self._lock:
            call = self._calls.get(site, 0) + 1
            self._calls[site] = call
            for spec in specs:
                if spec.nth and call != spec.nth:
                    continue
                if spec.after and call <= spec.after:
                    continue
                if spec.times and call > spec.after + spec.times:
                    continue
                if spec.p < 1.0:
                    # a pure function of (seed, site, call): replayable
                    mix = zlib.crc32(f"{self.seed}:{site}:{call}".encode())
                    if np.random.RandomState(mix).random_sample() >= spec.p:
                        continue
                self.fired[f"{site}:{spec.kind}"] = self.fired.get(f"{site}:{spec.kind}", 0) + 1
                return spec
            return None

    def fire(self, site: str) -> Optional[str]:
        """The seam entry point. Returns the fault kind that fired (None for
        no fault), after applying its side effect. Inert and allocation-free
        when no specs are configured."""
        if not self._by_site:
            return None
        spec = self._decide(site)
        if spec is None:
            return None
        if spec.kind == "raise":
            raise InjectedFault(f"injected fault at {site} (call {self._calls[site]})")
        if spec.kind == "delay":
            self._sleep(spec.delay_s)
        elif spec.kind == "sigterm":
            self._kill(os.getpid(), signal.SIGTERM)
        return spec.kind

    def fire_bytes(self, site: str, blob: bytes) -> bytes:
        """Seam entry point for byte-payload sites: ``corrupt-bytes``
        returns a deterministically corrupted copy (a run of flipped bytes
        mid-payload); other kinds behave as in :meth:`fire`."""
        if not self._by_site:
            return blob
        spec = self._decide(site)
        if spec is None:
            return blob
        if spec.kind == "raise":
            raise InjectedFault(f"injected fault at {site} (call {self._calls[site]})")
        if spec.kind == "delay":
            self._sleep(spec.delay_s)
        elif spec.kind == "sigterm":
            self._kill(os.getpid(), signal.SIGTERM)
        elif spec.kind == "corrupt-bytes":
            corrupted = bytearray(blob)
            mid = len(corrupted) // 2
            for i in range(mid, min(mid + 16, len(corrupted))):
                corrupted[i] ^= 0xFF
            return bytes(corrupted)
        return blob

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.fired)


#: Shared inert instance for default arguments — ``fire()`` on it is a single
#: falsy-dict check.
NULL_INJECTOR = FaultInjector()


def injector_from(resilience_cfg, **kwargs) -> FaultInjector:
    """Build an injector from a ``ResilienceConfig``-shaped object (duck-typed
    ``faults`` list + ``fault_seed``), merging ``HTYMP_FAULTS``. A spec that
    names a training seam the port does not fire yet raises
    ``NotImplementedError`` (ROADMAP.md A9) instead of never firing."""
    injector = FaultInjector.from_specs(
        getattr(resilience_cfg, "faults", ()) or (),
        seed=getattr(resilience_cfg, "fault_seed", 0),
        **kwargs,
    )
    unwired = sorted(site for site in injector._by_site if site in UNWIRED_SEAMS)
    if unwired:
        raise NotImplementedError(
            f"fault drills at {unwired} are not ported to PyTorch yet (ROADMAP.md A9: "
            "the training seams); the port fires faults at loader.episode and the "
            "serving seams only"
        )
    return injector
