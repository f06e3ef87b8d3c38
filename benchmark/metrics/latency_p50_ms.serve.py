"""The 50th percentile of every request of the untraced window, from its
scheduled send time to the return of ``ServingFrontend.adapt_predict``
(a failed request counts as missing it), in ms: what a client feels.
Above the knee the backlog grows all through the window, so it swings
with the smallest change of the rate the deployment sustains
(``serve_tasks_per_s``), which it moves the other way. Layer: the serving
frontend (``serving/server.py``) and everything under it."""

MOVES = "serve_tasks_per_s"


def read(record, run):
    return record.get("p50_ms")
