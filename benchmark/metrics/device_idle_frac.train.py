"""The card's idle share of the traced sub-window: 1 minus the union of its
kernels', copies' and sets' intervals over the window. Layer: the device."""

MOVES = "meta_steps_per_s"


def read(record, run):
    trace = record.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 1.0 - trace.busy_s / trace.window_s
