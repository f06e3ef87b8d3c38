"""The training-state tuple (JAX package ``core/train_state.py``).

``opt_state`` is the outer Adam state in optax's layout
(``ops/outer_adam.py``): ``(ScaleByAdamState(count, mu, nu),
ScaleByScheduleState(count))`` over ``{"params", "hparams"}``. A state built
from a serving checkpoint (``checkpoint.InferenceState``) carries ``None``
there: a server never takes an outer step.
"""

from typing import Any, NamedTuple


class TrainState(NamedTuple):
    params: Any  # classifier meta-parameters (dict tree of tensors)
    bn_state: Any  # batch-norm running stats (inert under transductive BN)
    inner_hparams: Any  # learnable per-tensor inner-opt hyperparams ({} if not learnable)
    opt_state: Any  # outer Adam state (None in a serving-only state)
    step: Any  # global meta-step counter (int64 0-d tensor)
