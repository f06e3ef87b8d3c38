"""The whole meta-step's share of the card's peak for the configuration's
precision, in percent: the benchmark's own FLOPs per meta-step (the
reference counted at the cell's shapes, ``count_flops.py``) times the
untraced window's meta-steps per second, over ``peaks.json``'s rate.
Layer: meta-step and model (``core/maml.py``, ``models/``)."""

from harness import peaks

MOVES = "meta_steps_per_s"


def read(record, run):
    flops = record.get("flops_per_meta_step")
    peak = peaks.flops_per_s(record.get("card", ""), record.get("precision", ""))
    if not flops or not peak:
        return None
    return 100.0 * flops * record["meta_steps_per_s"] / peak
