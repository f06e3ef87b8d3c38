"""Requests per adapt flush over the untraced window: the change of
``EnginePool.batcher_stats("adapt")``'s requests over the change of its
flushes. Layer: batcher and pool (``serving/batcher.py``,
``serving/pool.py``)."""

MOVES = "serve_tasks_per_s"


def read(record, run):
    flushes = record.get("adapt_flushes")
    if not flushes:
        return None
    return record["adapt_requests"] / flushes
