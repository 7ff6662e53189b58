"""Checkpoint / resume for trajectory sweeps.

Port of ``ikpso_tpu/utils/checkpoint.py``: the sweep's waypoint cursor,
solved angles and errors, and its seed (the JAX key becomes a generator
seed, ``utils/seeds.py``), in an npz written to a temporary name and
renamed into place. Solves are stateless, so a batch cut off before its
checkpoint is simply recomputed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SweepState:
    """Resumable state of a waypoint sweep."""

    cursor: int  # first unsolved waypoint index
    angles: np.ndarray  # (W, D) solved joint angles (zeros if unsolved)
    errors: np.ndarray  # (W,) final effector errors (inf if unsolved)
    seed: int  # the seed the next batch splits


def fresh_state(num_waypoints: int, dof: int, seed: int) -> SweepState:
    return SweepState(
        cursor=0,
        angles=np.zeros((num_waypoints, dof), np.float32),
        errors=np.full((num_waypoints,), np.inf, np.float32),
        seed=int(seed),
    )


def save(path: str, state: SweepState) -> None:
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, cursor=np.int64(state.cursor), angles=state.angles,
             errors=state.errors, seed=np.int64(state.seed))
    os.replace(tmp, path)


def load(path: str) -> Optional[SweepState]:
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return SweepState(
            cursor=int(data["cursor"]),
            angles=data["angles"],
            errors=data["errors"],
            seed=int(data["seed"]),
        )
