"""Seed derivation matching the reference's discipline.

``derive_model_seed`` and ``derive_split_seed`` (the per-split episode-stream
seeds) are the JAX package's numpy-RNG derivations, so "the seed 0
experiment" names the same derived seeds in both packages. The model seed
then seeds a ``torch.Generator`` for parameter init. Torch's generator
does not reproduce ``jax.random`` draws: a port model initialised from a seed
differs from the JAX model from the same seed, and parity checks carry the
JAX weights over instead (``utils/interop.py``).

:func:`deterministic_algorithms` switches the card to its deterministic
kernels for a block, so that the same inputs give the same bits in every
process (the serve CLI, the fleet drills' backends, the card checks).
"""

import contextlib
import os

import numpy as np
import torch


def derive_model_seed(seed: int) -> int:
    """Reference ``set_torch_seed``: np.RandomState(seed).randint(0, 999999)."""
    rng = np.random.RandomState(seed=seed)
    return int(rng.randint(0, 999999))


def model_init_generator(seed: int) -> torch.Generator:
    """A CPU generator seeded with the derived model seed (the port's
    counterpart of ``model_init_key``). Init draws on the CPU and the caller
    moves the result to its device, so a seed gives the same weights on every
    device."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(derive_model_seed(seed))
    return gen


def derive_split_seed(seed: int) -> int:
    """Reference ``data.py:139-144``: np.RandomState(seed).randint(1, 999999)."""
    rng = np.random.RandomState(seed=seed)
    return int(rng.randint(1, 999999))


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True):
    """``torch.use_deterministic_algorithms(on, warn_only=True)`` and
    ``cudnn.deterministic = on`` inside the block, with cuBLAS's workspace
    setting (``CUBLAS_WORKSPACE_CONFIG``, its condition for deterministic
    results) while on; the prior settings are restored after it. An op
    without a deterministic implementation warns instead of raising: not
    for the training entry points, where it would still be a different
    kernel than the run asked for."""
    prior = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    if on:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prior[0], warn_only=prior[1])
        torch.backends.cudnn.deterministic = prior[2]
        if prior[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prior[3]
