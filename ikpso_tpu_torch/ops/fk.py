"""Forward kinematics for parent-indexed kinematic trees.

Port of ``ikpso_tpu/ops/fk.py`` (``fk``, ``fk_points``,
``effector_positions``, ``angles_to_pose``, ``pose_to_angles``):

  * root:   ``M_0 = T(origin) @ Rxyz(pose_0)``
  * node k: ``M_k = M_parent @ Rxyz(pose_k) @ T_x(length_k)``

carried as rotation ``R`` plus translation ``p`` with
``p_k = p_parent + L_k * R_k[:, 0]``. The 3x3 composes are
``torch.matmul`` in full float32: the package turns TF32 off at import
(see ``ikpso_tpu_torch/__init__.py``), the counterpart of the JAX
``precision="highest"``. ``fk_serial_scan`` waits (ROADMAP queue A
item 9).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ikpso_tpu_torch.models.chain import ChainSpec
from ikpso_tpu_torch.ops.rotations import euler_xyz_to_matrix


def fk(
    spec: ChainSpec, pose: torch.Tensor, origin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World placements of every node: ``(..., N, 3)`` positions and
    ``(..., N, 3, 3)`` rotations for a ``(..., N, 3)`` pose."""
    local = euler_xyz_to_matrix(pose)
    rots = [local[..., 0, :, :]]
    poss = [origin.expand(local.shape[:-3] + (3,))]
    for k in range(1, spec.num_nodes):
        p = spec.parent[k]
        rk = torch.matmul(rots[p], local[..., k, :, :])
        poss.append(poss[p] + spec.length[k] * rk[..., :, 0])
        rots.append(rk)
    return torch.stack(poss, dim=-2), torch.stack(rots, dim=-3)


def fk_points(spec: ChainSpec, pose: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """World positions only, ``(..., N, 3)``."""
    return fk(spec, pose, origin)[0]


def effector_positions(
    spec: ChainSpec, pose: torch.Tensor, origin: torch.Tensor
) -> torch.Tensor:
    """World positions of the effector nodes, ``(..., E, 3)``."""
    return fk_points(spec, pose, origin)[..., list(spec.effector_idx), :]


def angles_to_pose(
    spec: ChainSpec, root_rotation: torch.Tensor, angles: torch.Tensor
) -> torch.Tensor:
    """Assemble a ``(..., N, 3)`` pose from a node-major ``(..., D)``
    DOF vector and the ``(..., 3)`` origin rotation."""
    joints = angles.reshape(angles.shape[:-1] + (spec.num_nodes - 1, 3))
    root = root_rotation[..., None, :].expand(joints.shape[:-2] + (1, 3))
    return torch.cat([root, joints], dim=-2)


def pose_to_angles(spec: ChainSpec, pose: torch.Tensor) -> torch.Tensor:
    """Flatten a ``(..., N, 3)`` pose to the ``(..., D)`` DOF vector."""
    del spec
    joints = pose[..., 1:, :]
    return joints.reshape(joints.shape[:-2] + (-1,))
