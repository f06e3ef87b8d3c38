"""The served tasks' share of the card's peak for the configuration's
precision, in percent: the benchmark's own FLOPs of every answered request
(``flops_per_task`` of the configuration by its query size, the reference
counted by ``count_flops.py``: the adaptation on the support set and the
queries' forward pass), over the seconds from the window's start to its
last answer, over ``peaks.json``'s rate. Layer: engine and serving
programs (``serving/engine.py``, ``core/programs.py::ServingCall``)."""

from harness import peaks

MOVES = "serve_tasks_per_s"


def read(record, run):
    flops, seconds = record.get("flops_answered"), record.get("answer_s")
    peak = peaks.flops_per_s(record.get("card", ""), record.get("precision", ""))
    if not flops or not seconds or not peak:
        return None
    return 100.0 * flops / seconds / peak
