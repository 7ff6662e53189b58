"""Forward kinematics for parent-indexed kinematic trees.

Port of ``ikpso_tpu/ops/fk.py`` (``fk``, ``fk_points``,
``effector_positions``, ``angles_to_pose``, ``pose_to_angles``):

  * root:   ``M_0 = T(origin) @ Rxyz(pose_0)``
  * node k: ``M_k = M_parent @ Rxyz(pose_k) @ T_x(length_k)``

carried as rotation ``R`` plus translation ``p`` with
``p_k = p_parent + L_k * R_k[:, 0]``. The 3x3 composes are elementwise
products summed in float32, in a fixed order, so no TF32 setting of a
caller can reach them: the counterpart of the JAX ``precision="highest"``.
``fk_serial_scan`` computes the same placements of a serial chain as a
log-depth prefix product of affine transforms.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ikpso_tpu_torch.models.chain import ChainSpec
from ikpso_tpu_torch.ops.rotations import euler_xyz_to_matrix


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for ``(..., 3, 3)`` rotations: ``(a0 b0 + a1 b1) + a2 b2``
    over the inner index, each term an elementwise product."""
    return ((a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :])
            + a[..., :, 2:3] * b[..., 2:3, :])


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
        rk = _compose(rots[p], local[..., k, :, :])
        poss.append(poss[p] + spec.length[k] * rk[..., :, 0])
        rots.append(rk)
    return torch.stack(poss, dim=-2), torch.stack(rots, dim=-3)


def _affine_compose(a, b):
    """``(Ra, ta) . (Rb, tb) = (Ra Rb, ta + Ra tb)``, associative."""
    ra, ta = a
    rb, tb = b
    ra_tb = ((ra[..., :, 0] * tb[..., 0:1] + ra[..., :, 1] * tb[..., 1:2])
             + ra[..., :, 2] * tb[..., 2:3])
    return _compose(ra, rb), ta + ra_tb


def fk_serial_scan(
    spec: ChainSpec, pose: torch.Tensor, origin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fk` of a serial chain (``parent[k] == k - 1``) as an
    inclusive prefix scan of the nodes' local affines ``(R_k, L_k R_k e_x)``
    (the root's offset zero): ceil(log2 N) rounds, round r composing each
    node with the partial product ``2^r`` nodes before it (Hillis-Steele).
    The counterpart of JAX's ``lax.associative_scan``; it groups the
    products differently, so the two agree to rounding, not bit for bit."""
    if any(spec.parent[k] != k - 1 for k in range(1, spec.num_nodes)):
        raise ValueError("fk_serial_scan requires a serial chain")
    rot = euler_xyz_to_matrix(pose)
    trans = spec.length.to(rot.device)[:, None] * rot[..., :, :, 0]
    trans = torch.cat([torch.zeros_like(trans[..., :1, :]), trans[..., 1:, :]], dim=-2)
    n = spec.num_nodes
    step = 1
    while step < n:
        r, t = _affine_compose((rot[..., :n - step, :, :], trans[..., :n - step, :]),
                               (rot[..., step:, :, :], trans[..., step:, :]))
        rot = torch.cat([rot[..., :step, :, :], r], dim=-3)
        trans = torch.cat([trans[..., :step, :], t], dim=-2)
        step *= 2
    return trans + origin[..., None, :], rot


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
