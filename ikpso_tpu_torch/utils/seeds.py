"""Generator seeds: the port's counterpart of JAX's PRNG keys.

Where the JAX package splits a key (``jax.random.split``) or folds a
counter into it (``jax.random.fold_in``), the port splits or folds a seed,
a non-negative 63-bit int, through ``numpy.random.SeedSequence``; a solve
then draws from ``torch.Generator(device).manual_seed(seed)``. The same
seed gives the same stream on every run, so a saved seed resumes a sweep
exactly (``utils/checkpoint.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _seeds(entropy, n: int):
    return [int(w >> np.uint64(1)) for w in
            np.random.SeedSequence(entropy).generate_state(n, np.uint64)]


def split(seed: int) -> Tuple[int, int]:
    """Two new seeds from one: ``(carry, sub)``, as ``key, sub =
    jax.random.split(key)``."""
    carry, sub = _seeds(int(seed), 2)
    return carry, sub


def fold_in(seed: int, counter: int) -> int:
    """The seed of step ``counter`` of one stream, as
    ``jax.random.fold_in(key, counter)``."""
    return _seeds([int(seed), int(counter)], 1)[0]


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))
