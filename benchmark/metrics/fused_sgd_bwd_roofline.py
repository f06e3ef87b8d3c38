"""B2's share of its roofline, in percent: the launches of the fused inner
update's backward (``csrc/fused_sgd_bwd.cu``, kernel
``fused_sgd_bwd_kernel``) in the traced
sub-window times the bytes one launch has to move (each input read once,
each output written once, ``reference/costs.py``) over the card's HBM
bandwidth, divided by the launches' device time. Layer: kernels B1/B2."""

from harness import peaks

MOVES = "meta_steps_per_s"
KERNEL = "fused_sgd_bwd_kernel"


def read(record, run):
    trace, bandwidth = record.get("trace"), peaks.hbm_bytes_per_s(record.get("card", ""))
    if trace is None or not bandwidth:
        return None
    durations = trace.kernels(KERNEL)
    if not durations:
        return None
    bound = len(durations) * record["inner_update_bytes"]["fused_sgd_bwd"] / bandwidth
    return 100.0 * bound / sum(durations)
