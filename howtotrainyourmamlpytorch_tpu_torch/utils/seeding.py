"""Seed derivation matching the reference's discipline.

``derive_model_seed`` and ``derive_split_seed`` (the per-split episode-stream
seeds) are the JAX package's numpy-RNG derivations, so "the seed 0
experiment" names the same derived seeds in both packages. The model seed
then seeds a ``torch.Generator`` for parameter init. Torch's generator
does not reproduce ``jax.random`` draws: a port model initialised from a seed
differs from the JAX model from the same seed, and parity checks carry the
JAX weights over instead (``utils/interop.py``).
"""

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
