"""The train step's own memory, in GiB: the allocator's peak over the
first dispatch, which warms the step up and builds it (its capture as a
CUDA graph, where the graph then holds that memory in its pool; an eager
step allocates it again each step), above what was held before it (the
episode pool, the weights, the optimizer state). The activations the
inner loop keeps for the outer backward are most of it: the memory the
remat policy trades against speed. The window's own peak cannot show it,
since a graph's replays allocate nothing. Layer: meta-step and model
(``core/remat.py``)."""

MOVES = "meta_steps_per_s"


def read(record, run):
    peak = record.get("step_peak_bytes")
    return None if peak is None else peak / 2 ** 30
