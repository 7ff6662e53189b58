"""Seeds of a run's inputs, derived from ``--seed``.

Every stream a run draws from (the targets of batch i, the solve of batch
i, frame f of trial batch b) has a seed of its own, a pure function of
``--seed`` and the stream's indices, so the same seed gives the same
inputs and no two streams share one. ``--seed`` may be any non-negative
integer (numpy's ``SeedSequence`` takes integers of any size).
"""

from __future__ import annotations

import numpy as np
import torch

# Stream ids: what a derived seed is for.
TARGETS, SOLVE, FRAME = range(3)


def derive(seed: int, *indices: int) -> int:
    """A 63-bit seed for the stream ``indices`` of run seed ``seed``."""
    words = [int(seed)] + [int(i) for i in indices]
    if any(w < 0 for w in words):
        raise ValueError(f"seeds and stream indices are non-negative: {words}")
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))
