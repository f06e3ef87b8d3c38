"""Faults planted under the timed path, for the tests and the calibration
that show the comparison deciding ``correct`` catches each: the harness
drives a whole run with one of these applied (``faults=`` of
``run.execute``) and ``correct`` has to come out false.

Training (``drivers/train_steps.py``'s stepper):

- :class:`StateUnchanged`: every dispatch returns the state it was given;
- :class:`HalfBatch`: every dispatch sees the first half of its tasks only,
  the loss the mean over those;
- :class:`FirstRowOnly`: every step of a dispatch of several reads the
  dispatch's first row (a loop over a dispatch's rows that never moves on).

Serving (the engine under the frontend):

- :class:`AlteredAnswer`: the first request of every predict flush gets
  its classes' probabilities rolled by one;
- :class:`HalfSupport`: every adapt flush adapts on the first half of each
  support set's images, the loss the mean over those.

A run on one card has no exchange between cards to leave out.
"""


class StateUnchanged:
    def apply(self, stepper) -> None:
        advance = stepper.advance

        def unchanged(state, lo, hi):
            _, losses = advance(state, lo, hi)
            return state, losses

        stepper.advance = unchanged


class HalfBatch:
    def apply(self, stepper) -> None:
        system = stepper.system
        for name, axis in (("train_step_multi", 1), ("train_step", 0)):
            inner = getattr(system, name)

            def halved(state, batch, *args, _inner=inner, _axis=axis, **kwargs):
                half = {k: v.narrow(_axis, 0, v.shape[_axis] // 2) for k, v in batch.items()}
                return _inner(state, half, *args, **kwargs)

            setattr(system, name, halved)


class FirstRowOnly:
    def apply(self, stepper) -> None:
        system = stepper.system
        inner = system.train_step_multi

        def first_row(state, batches, *args, **kwargs):
            same = {k: v[:1].expand(v.shape).contiguous() for k, v in batches.items()}
            return inner(state, same, *args, **kwargs)

        system.train_step_multi = first_row


class AlteredAnswer:
    def apply(self, engine) -> None:
        import numpy as np

        inner = engine.predict_batch

        def altered(*args, **kwargs):
            out = list(inner(*args, **kwargs))
            out[0] = np.roll(out[0], 1, axis=-1)
            return out

        engine.predict_batch = altered


class HalfSupport:
    def apply(self, engine) -> None:
        inner = engine.adapt_batch

        def halved(items, *args, **kwargs):
            items = [(x[: max(1, len(x) // 2)], y[: max(1, len(y) // 2)]) for x, y in items]
            return inner(items, *args, **kwargs)

        engine.adapt_batch = halved


TRAIN_FAULTS = {"state_unchanged": StateUnchanged, "half_batch": HalfBatch, "first_row_only": FirstRowOnly}
SERVE_FAULTS = {"altered_answer": AlteredAnswer, "half_support": HalfSupport}


def for_cell(traffic, config):
    """The faults a cell can have: a serving traffic's, or a training
    one's (a dispatch's rows only where a dispatch holds several)."""
    if "query_sizes" in traffic:
        return dict(SERVE_FAULTS)
    kinds = dict(TRAIN_FAULTS)
    if int(config["maml"].get("train_steps_per_dispatch", 1)) <= 1:
        kinds.pop("first_row_only")
    return kinds
