"""Host enqueue time per meta-step: the harness's span around each
dispatch call of the untraced window (``train_step_multi`` or
``train_step``) until it returns, summed and divided by the steps. Layer:
the program layer (``core/programs.py``, ``MAMLSystem.train_step_multi`` /
``train_step``)."""

MOVES = "meta_steps_per_s"


def read(record, run):
    spans = record.get("dispatch_s")
    if not spans or not record.get("steps"):
        return None
    return 1e3 * sum(spans) / record["steps"]
