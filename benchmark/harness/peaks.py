"""The card's published peaks (``benchmark/peaks.json``), keyed by the name
``torch.cuda.get_device_name`` gives and by precision."""

import os
from typing import Optional

from .cells import BENCH_DIR, load_json


def _card(kind: str) -> Optional[dict]:
    return load_json(os.path.join(BENCH_DIR, "peaks.json"))["cards"].get(kind)


def flops_per_s(kind: str, precision: str) -> Optional[float]:
    card = _card(kind)
    return None if card is None else card["flops_per_s"].get(precision)


def hbm_bytes_per_s(kind: str) -> Optional[float]:
    card = _card(kind)
    return None if card is None else card["hbm_bytes_per_s"]
