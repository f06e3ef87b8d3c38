"""Device time of one adapt flush in the traced sub-window: CUDA events
recorded on the flush's stream before and after the engine's
``adapt_batch`` (the staging of the support sets, the replayed adapt
program, the split of its outputs), averaged over the window's adapt
flushes. Layer: engine and serving programs (``serving/engine.py``,
``core/programs.py::ServingCall``)."""

MOVES = "serve_tasks_per_s"


def read(record, run):
    seconds = record.get("adapt_flush_s")
    if not seconds:
        return None
    return 1e3 * sum(seconds) / len(seconds)
