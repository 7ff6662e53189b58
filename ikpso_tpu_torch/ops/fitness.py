"""PSO fitness: weighted effector error plus locality regularizers.

Port of ``ikpso_tpu/ops/fitness.py`` (``COLLISION_PENALTY``,
``FitnessConfig``, ``fitness``, ``true_effector_error``):

  cost = sum_e  w_e * |p_e - target_e|^2
       + (distance_weight / J) * sum_k |p_k - anchor_p_k|^2
       + (angle_weight / J)    * sum_k |theta_k - anchor_theta_k|^2
       (+ orientation_weight * sum_e w_e |R_e - R_target_e|_F^2)

with J = DOF / 3. With scene ``obstacles``, a pose whose chain colliders
(``ops/collision.py``, by ``collision_backend`` / ``collision_shape``)
hit a box costs ``COLLISION_PENALTY`` instead.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.rotations import euler_xyz_to_matrix

# float32 max, returned for colliding poses (reference kernel.cu:129,134).
COLLISION_PENALTY = np.float32(3.4028235e38)


@dataclasses.dataclass(frozen=True)
class FitnessConfig:
    """Cost weights; same fields and defaults as the JAX ``FitnessConfig``.

    ``trig_impl`` selects the kernel trig ("poly" minimax polynomials or
    "exact"); the plain ``fitness`` always uses stock trig and is the
    accuracy oracle. ``fk_impl`` is ``"unrolled"`` (``ops.fk.fk``) or
    ``"scan"`` (``ops.fk.fk_serial_scan``, serial chains only).
    """

    angle_weight: float = 3.0
    distance_weight: float = 0.0
    orientation_weight: float = 0.0
    error_threshold: float = 0.1
    gizmo_size: float = 0.2
    collision_backend: str = "sat"
    collision_shape: str = "box"
    trig_impl: str = "poly"
    fk_impl: str = "unrolled"


def fitness(
    spec: ChainSpec,
    angles: torch.Tensor,
    problem: IKProblem,
    config: FitnessConfig = FitnessConfig(),
    obstacles=None,
    anchor_angles: Optional[torch.Tensor] = None,
    anchor_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """PSO cost of ``(..., D)`` candidate angles (``(S, P, D)`` for an
    ``(S,)``-batched problem); smaller is better."""
    num_joints = spec.num_nodes - 1
    batched_particles = angles.dim() > problem.pose.dim() - 1

    if anchor_angles is None:
        anchor_angles = fk_ops.pose_to_angles(spec, problem.pose)
    if anchor_positions is None:
        anchor_positions = fk_ops.fk_points(spec, problem.pose, problem.origin)
    root_rot = problem.pose[..., 0, :]
    origin = problem.origin
    targets = problem.targets
    target_rot = problem.target_rot
    if batched_particles:
        anchor_angles = anchor_angles[..., None, :]
        anchor_positions = anchor_positions[..., None, :, :]
        root_rot = root_rot[..., None, :]
        origin = origin[..., None, :]
        targets = targets[..., None, :, :]
        if target_rot is not None:
            target_rot = target_rot[..., None, :, :]

    pose = fk_ops.angles_to_pose(spec, root_rot, angles)
    if config.fk_impl == "scan":
        positions, rotations = fk_ops.fk_serial_scan(spec, pose, origin)
    elif config.fk_impl == "unrolled":
        positions, rotations = fk_ops.fk(spec, pose, origin)
    else:
        raise ValueError(f"unknown fk_impl {config.fk_impl!r}; expected 'unrolled' or 'scan'")

    d_angles = angles - anchor_angles
    rotation_difference = torch.sum(d_angles * d_angles, dim=-1)
    d_pos = positions[..., 1:, :] - anchor_positions[..., 1:, :]
    position_difference = torch.sum(d_pos * d_pos, dim=(-2, -1))

    eff = list(spec.effector_idx)
    d_eff = positions[..., eff, :] - targets
    eff_w = spec.effector_weight[eff]
    cost = torch.sum(eff_w * torch.sum(d_eff * d_eff, dim=-1), dim=-1)

    if target_rot is not None:
        d_rot = rotations[..., eff, :, :] - euler_xyz_to_matrix(target_rot)
        orient = torch.sum(eff_w * torch.sum(d_rot * d_rot, dim=(-2, -1)), dim=-1)
        cost = cost + config.orientation_weight * orient

    cost = (
        cost
        + (config.distance_weight / num_joints) * position_difference
        + (config.angle_weight / num_joints) * rotation_difference
    )

    if obstacles is not None and obstacles.count > 0:
        from ikpso_tpu_torch.ops.collision import get_chain_collider

        collides = get_chain_collider(config.collision_backend, config.collision_shape)
        hit = collides(
            positions[..., 1:, :], rotations[..., 1:, :, :],
            positions[..., list(spec.parent[1:]), :], spec.length[1:],
            obstacles.center, obstacles.half_extent, obstacles.rot,
            gizmo_size=config.gizmo_size,
        )
        cost = torch.where(hit, torch.full_like(cost, COLLISION_PENALTY), cost)
    return cost


@functools.lru_cache(maxsize=64)
def effector_index(effector_idx: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``ChainSpec.effector_idx`` as an int64 index tensor on ``device``,
    made once per index tuple and device. It gathers the rows a Python
    list gathers; the list's index is a pageable host copy on every call,
    which waits for the device's queue (and a CUDA graph cannot hold it)."""
    return torch.tensor(effector_idx, dtype=torch.int64, device=device)


def true_effector_error(
    spec: ChainSpec, pose: torch.Tensor, problem: IKProblem
) -> torch.Tensor:
    """Sum of Euclidean effector distances (the reference's host oracle
    ``checkDistance``), a different space than the squared fitness."""
    positions = fk_ops.fk_points(spec, pose, problem.origin)
    d = positions[..., effector_index(spec.effector_idx, positions.device), :] - problem.targets
    return torch.sum(torch.sqrt(torch.sum(d * d, dim=-1)), dim=-1)
