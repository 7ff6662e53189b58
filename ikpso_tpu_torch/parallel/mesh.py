"""A mesh of ranks with named axes over ``torch.distributed``.

Port of ``ikpso_tpu/parallel/mesh.py``. JAX lays its devices out on a
``jax.sharding.Mesh``; here each rank is one process (one device), and a
``Mesh`` lays the ranks of the process group out on named axes:

  * ``swarm``: independent IK problems (targets, waypoints) split across
    ranks, no communication during a solve;
  * ``particle``: the particles of each swarm split across ranks; the
    global best is an all-reduce every iteration
    (``parallel.sharded.distributed_argmin``).

Ranks are laid out row-major over the mesh shape, the last axis
innermost, as ``make_mesh`` reshapes its device list. For each axis a
rank belongs to one process group: the ranks that differ from it only in
that axis, in axis order (so a rank's place in the group is its index on
the axis). Without an initialized process group the mesh has one rank
and every collective is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

SWARM_AXIS = "swarm"
PARTICLE_AXIS = "particle"


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of this process; ``(0, 1)`` without an
    initialized process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh: the axis names and sizes, its index on
    each axis and, per axis, its process group (None where the axis has
    one rank)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[Optional[object], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def group(self, name: str):
        return self.groups[self.axis_names.index(name)]


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (SWARM_AXIS,)) -> Mesh:
    """A mesh over every rank of the process group: by default the 1-D
    ``("swarm",)`` mesh; ``shape=(n_swarm, n_particle)`` with
    ``axis_names=("swarm", "particle")`` gives the 2-D hybrid. The shape
    must cover the ranks exactly, since every process takes part.

    Every rank must call this with the same arguments: the axis groups
    are created collectively, in the same order on every rank.
    """
    rank, size = world()
    if shape is None:
        shape = (size,)
    shape = tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    if int(np.prod(shape)) != size:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} ranks; the "
                         f"process group has {size}")
    ranks = np.arange(size).reshape(shape)
    coords = tuple(int(c) for c in np.argwhere(ranks == rank)[0])
    groups = []
    for axis in range(len(shape)):
        mine = None
        if shape[axis] > 1:
            # One group per line along the axis; every rank creates all of
            # them, in the same order.
            lines = np.moveaxis(ranks, axis, -1).reshape(-1, shape[axis])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    mine = g
        groups.append(mine)
    return Mesh(axis_names, shape, coords, tuple(groups))


def swarm_mesh() -> Mesh:
    """The 1-D swarm mesh over every rank."""
    return make_mesh()


def hybrid_mesh(num_particle_shards: int) -> Mesh:
    """The 2-D mesh: particle shards innermost (adjacent ranks), swarms over
    the rest."""
    _, size = world()
    if size % num_particle_shards:
        raise ValueError(f"{size} ranks not divisible by {num_particle_shards} "
                         "particle shards")
    return make_mesh((size // num_particle_shards, num_particle_shards),
                     (SWARM_AXIS, PARTICLE_AXIS))
