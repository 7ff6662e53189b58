"""Prebuilt kinematic models.

Port of ``ikpso_tpu/models/library.py``: ``reference_arm`` and its
``reference_reset_targets``, ``planar_3dof``, ``arm_6dof``, ``snake`` and
``snake_30dof`` (via ``serial_chain``), ``arm_7dof``, the trees
``dual_arm_14dof`` and ``humanoid_45dof``, and ``batched_problem``.
Every model function takes the device its tensors live on.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem, make_chain_spec

TWO_PI = 2.0 * math.pi
PI = math.pi

_REF_BEND = 1.57


def _problem(pose, targets, origin=(0.0, 0.0, 0.0), *, device) -> IKProblem:
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return IKProblem(pose=f32(pose), origin=f32(origin), targets=f32(targets))


def reference_arm(device="cpu") -> Tuple[ChainSpec, IKProblem]:
    """The reference's 21-DOF experiment tree: 4 serial elbows then 3
    effector children of the last elbow, limits [0, 2*pi]."""
    spec = make_chain_spec(
        parent=[-1, 0, 1, 2, 3, 4, 4, 4],
        length=[0.0] + [1.0] * 7,
        min_rotation=np.zeros((8, 3), np.float32),
        max_rotation=np.full((8, 3), TWO_PI, np.float32),
        effector_idx=[5, 6, 7],
        effector_weight=[1.0, 1.0, 1.0],
        device=device,
    )
    pose = np.zeros((8, 3), np.float32)
    for k in range(1, 6):
        pose[k] = (0.0, _REF_BEND, 0.0)
    pose[6] = (0.0, 0.0, _REF_BEND)
    pose[7] = (0.0, 0.0, _REF_BEND)
    targets = [(0.5, 1.0, -2.0), (-0.5, 1.0, -2.0), (0.0, 0.0, -2.0)]
    return spec, _problem(pose, targets, device=device)


def reference_reset_targets(device="cpu") -> torch.Tensor:
    """``reference_arm``'s targets after the experiment harness's reset
    (the reference's Main.cpp:330-337)."""
    return torch.as_tensor(np.asarray(
        [(0.75, 1.0, -2.5), (-0.75, 1.0, -2.5), (0.0, 0.0, -2.5)], np.float32),
        device=device)


def serial_chain(
    num_links: int,
    link_length: float = 1.0,
    free_axes: Sequence[int] = (0, 1, 2),
    limit: float = PI,
    effector_weight: float = 1.0,
    target=None,
    initial_bend: float = 0.0,
    *,
    device="cpu",
) -> Tuple[ChainSpec, IKProblem]:
    """A serial chain whose last node is the single effector; axes not
    in ``free_axes`` are locked by degenerate limits."""
    n = num_links + 1
    min_rot = np.zeros((n, 3), np.float32)
    max_rot = np.zeros((n, 3), np.float32)
    for ax in free_axes:
        min_rot[1:, ax] = -limit
        max_rot[1:, ax] = limit
    spec = make_chain_spec(
        parent=[-1] + list(range(num_links)),
        length=[0.0] + [link_length] * num_links,
        min_rotation=min_rot,
        max_rotation=max_rot,
        effector_idx=[n - 1],
        effector_weight=[effector_weight],
        device=device,
    )
    pose = np.zeros((n, 3), np.float32)
    if initial_bend:
        pose[1:, free_axes[0]] = initial_bend
    if target is None:
        target = (num_links * link_length * 0.6, num_links * link_length * 0.3, 0.0)
    return spec, _problem(pose, [target], device=device)


def planar_3dof(target=(1.5, 1.5, 0.0), device="cpu") -> Tuple[ChainSpec, IKProblem]:
    """3-DOF planar arm (rotation about Z only)."""
    return serial_chain(3, link_length=1.0, free_axes=(2,), target=target,
                        device=device)


def snake(num_links: int, device="cpu") -> Tuple[ChainSpec, IKProblem]:
    """Long-chain family (``snake:<links>``): ``num_links`` spherical
    links of length 1, +-pi/2 on every axis, a 0.1 rad initial bend off
    the straight singular start, the target at (0.4, 0.3, 0.2) x reach."""
    reach = float(num_links)
    return serial_chain(num_links, link_length=1.0, free_axes=(0, 1, 2), limit=PI / 2,
                        target=(0.4 * reach, 0.3 * reach, 0.2 * reach),
                        initial_bend=0.1, device=device)


def snake_30dof(device="cpu") -> Tuple[ChainSpec, IKProblem]:
    """The 10-link :func:`snake` (11 nodes, D=30)."""
    return snake(10, device=device)


def arm_6dof(target=(1.2, 0.8, 0.5), target_rot=(0.0, 0.3, 0.2),
             device="cpu") -> Tuple[ChainSpec, IKProblem]:
    """6-DOF arm with a position+orientation target: two spherical joints
    (N=3 nodes, D=6, one effector) and an Euler-XYZ target rotation."""
    spec, problem = serial_chain(2, link_length=1.0, free_axes=(0, 1, 2),
                                 target=target, device=device)
    return spec, problem.replace(target_rot=torch.as_tensor(
        np.asarray([target_rot], np.float32), device=device))


def arm_7dof(target=(1.0, 1.2, -0.8), device="cpu") -> Tuple[ChainSpec, IKProblem]:
    """7-DOF redundant arm: two spherical joints plus a Z-only wrist
    (N=4 nodes, D=9 with the wrist's X/Y axes locked at lo=hi=0)."""
    n = 4
    min_rot = np.zeros((n, 3), np.float32)
    max_rot = np.zeros((n, 3), np.float32)
    min_rot[1:3, :] = -PI
    max_rot[1:3, :] = PI
    min_rot[3, 2] = -PI
    max_rot[3, 2] = PI
    spec = make_chain_spec(
        parent=[-1, 0, 1, 2],
        length=[0.0, 1.0, 1.0, 0.5],
        min_rotation=min_rot,
        max_rotation=max_rot,
        effector_idx=[3],
        device=device,
    )
    return spec, _problem(np.zeros((n, 3), np.float32), [target], device=device)


def dual_arm_14dof(target_a=(1.0, 1.0, 0.5), target_b=(-1.0, 1.0, 0.5),
                   device="cpu") -> Tuple[ChainSpec, IKProblem]:
    """Two 7-DOF arms branching from one origin (N=7 nodes, D=18, effectors
    3 and 6): nodes 1-3 arm A, 4-6 arm B, each a 7-DOF arm's limits."""
    n = 7
    min_rot = np.zeros((n, 3), np.float32)
    max_rot = np.zeros((n, 3), np.float32)
    for base in (1, 4):
        min_rot[base:base + 2, :] = -PI
        max_rot[base:base + 2, :] = PI
        min_rot[base + 2, 2] = -PI
        max_rot[base + 2, 2] = PI
    spec = make_chain_spec(
        parent=[-1, 0, 1, 2, 0, 4, 5],
        length=[0.0, 1.0, 1.0, 0.5, 1.0, 1.0, 0.5],
        min_rotation=min_rot,
        max_rotation=max_rot,
        effector_idx=[3, 6],
        effector_weight=[1.0, 1.0],
        device=device,
    )
    return spec, _problem(np.zeros((n, 3), np.float32), [target_a, target_b],
                          device=device)


def humanoid_45dof(device="cpu") -> Tuple[ChainSpec, IKProblem]:
    """The 5-effector humanoid tree (N=16 nodes, D=45): spine and chest
    from the pelvis, head and both arms branching at the chest, both legs
    at the pelvis; limits +-2 on every joint axis. The targets are the
    effector positions of a fixed bent pose, computed by this package's
    ``fk_points``; the solve starts from the straight pose."""
    from ikpso_tpu_torch.ops.fk import fk_points

    # pelvis, spine, chest, head, L shoulder, L elbow, L hand, R shoulder,
    # R elbow, R hand, L hip, L knee, L foot, R hip, R knee, R foot
    parent = [-1, 0, 1, 2, 2, 4, 5, 2, 7, 8, 0, 10, 11, 0, 13, 14]
    length = [0.0, 0.5, 0.5, 0.3,
              0.4, 0.5, 0.5,
              0.4, 0.5, 0.5,
              0.3, 0.6, 0.6,
              0.3, 0.6, 0.6]
    n = len(parent)
    min_rot = np.full((n, 3), -2.0, np.float32)
    max_rot = np.full((n, 3), 2.0, np.float32)
    min_rot[0] = max_rot[0] = 0.0
    effectors = [3, 6, 9, 12, 15]
    spec = make_chain_spec(
        parent=parent,
        length=length,
        min_rotation=min_rot,
        max_rotation=max_rot,
        effector_idx=effectors,
        effector_weight=[1.0] * len(effectors),
        device=device,
    )
    target_pose = np.zeros((n, 3), np.float32)
    target_pose[1] = (0.0, 0.15, 0.10)
    target_pose[2] = (0.0, 0.10, 0.10)
    target_pose[3] = (0.10, 0.0, 0.20)
    target_pose[4] = (0.0, 0.80, 0.50)
    target_pose[5] = (0.0, 0.0, 0.70)
    target_pose[7] = (0.0, -0.80, -0.50)
    target_pose[8] = (0.0, 0.0, -0.70)
    target_pose[10] = (0.0, -0.60, 0.40)
    target_pose[11] = (0.0, 0.0, -0.80)
    target_pose[13] = (0.0, 0.60, -0.40)
    target_pose[14] = (0.0, 0.0, 0.80)
    points = fk_points(spec, torch.as_tensor(target_pose, device=device),
                       torch.zeros(3, device=device))
    return spec, _problem(np.zeros((n, 3), np.float32),
                          points[effectors].cpu().numpy(), device=device)


def batched_problem(
    problem: IKProblem,
    targets: torch.Tensor,
    target_rot: Optional[torch.Tensor] = None,
) -> IKProblem:
    """Broadcast one problem into S swarms with per-swarm ``(S, E, 3)``
    targets; pose and origin are tiled (materialized, so rows can be
    gathered and written independently)."""
    s = targets.shape[0]
    return IKProblem(
        pose=problem.pose.expand((s,) + tuple(problem.pose.shape)).contiguous(),
        origin=problem.origin.expand((s,) + tuple(problem.origin.shape)).contiguous(),
        targets=targets.to(torch.float32),
        target_rot=None if target_rot is None else target_rot.to(torch.float32),
    )
