"""Multi-step-loss (MSL) importance annealing (JAX package ``ops/msl.py``).

Exact re-derivation of the reference schedule
(``few_shot_learning_system.py:131-151``): weights start uniform ``1/N`` over
the ``N`` inner steps; each epoch every non-final weight decays by
``1/(N * multi_step_loss_num_epochs)`` down to a floor of ``0.03/N`` while the
final-step weight grows symmetrically up to ``1 - (N-1) * 0.03/N``. All
non-final weights are equal at every epoch, so the loop in the reference
collapses to the closed form below, computed in float32 as the JAX package
computes it.
"""

import torch


def per_step_loss_importance(epoch, num_steps: int, multi_step_loss_num_epochs: int, device=None):
    """Weight vector ``[num_steps]`` (float32) for the epoch index."""
    epoch = torch.as_tensor(epoch, dtype=torch.float32, device=device)
    n = float(num_steps)
    decay_rate = 1.0 / n / multi_step_loss_num_epochs
    min_non_final = 0.03 / n
    non_final = torch.clamp(1.0 / n - epoch * decay_rate, min=min_non_final)
    final = torch.clamp(
        1.0 / n + epoch * (n - 1.0) * decay_rate, max=1.0 - (n - 1.0) * min_non_final
    )
    weights = torch.ones(num_steps, dtype=torch.float32, device=device) * non_final
    weights[-1] = final
    return weights


def final_step_only(num_steps: int, device=None):
    """The no-MSL weighting: only the last inner step's target loss counts
    (reference ``few_shot_learning_system.py:246-251``)."""
    weights = torch.zeros(num_steps, dtype=torch.float32, device=device)
    # fill_, not an item assignment: a Python scalar assigned to a CUDA
    # element is copied from the host, which a captured graph cannot do
    weights[-1:].fill_(1.0)
    return weights
