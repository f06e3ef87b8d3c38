"""Fault-spec grammar and the inert injector: the part of the JAX package's
``resilience/faults.py`` that ``config.py``, the loader and the runner need.
``config.py`` parses every ``resilience.faults`` entry at config load, so a
config that loads into the JAX package loads here with the same values and
the same errors.

The drills themselves (an injector that fires faults at the seams) are not
ported yet (ROADMAP.md A9): :func:`injector_from` returns the inert
:data:`NULL_INJECTOR` when no drill is named and raises
``NotImplementedError`` when one is, so a drill is never silently skipped.

Spec grammar (one string per fault)::

    <site>=<kind>[:opt=val[,opt=val...]]

    kinds:    raise | corrupt-bytes | nan-loss | delay | sigterm
    options:  nth=N, times=N, after=N, p=F, delay_s=F
"""

import os
from dataclasses import dataclass
from typing import Dict, Optional

KINDS = ("raise", "corrupt-bytes", "nan-loss", "delay", "sigterm")

# env var merged into every config-built injector in the JAX package
ENV_VAR = "HTYMP_FAULTS"


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


class NullInjector:
    """The seams' injector with no drill armed: every call is a no-op."""

    def fire(self, site: str) -> Optional[str]:
        return None

    def stats(self) -> Dict[str, int]:
        """Faults fired per site: none (``/metrics`` ``injected_faults``)."""
        return {}


#: Shared inert instance for default arguments.
NULL_INJECTOR = NullInjector()


def injector_from(resilience_cfg) -> NullInjector:
    """The injector for a ``ResilienceConfig``-shaped object: inert when
    neither ``faults`` nor the ``HTYMP_FAULTS`` environment variable names a
    drill; a named drill raises, since the drills are not ported."""
    texts = list(getattr(resilience_cfg, "faults", ()) or ())
    texts += [t for t in os.environ.get(ENV_VAR, "").split(";") if t.strip()]
    for text in texts:
        FaultSpec.parse(text)  # a malformed spec fails as in the JAX package
    if texts:
        raise NotImplementedError(
            f"fault drills {texts} are not ported to PyTorch yet (ROADMAP.md A9: "
            "the resilience layer); run without resilience.faults and HTYMP_FAULTS"
        )
    return NULL_INJECTOR
