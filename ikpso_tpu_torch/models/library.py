"""Prebuilt kinematic models.

Port of ``ikpso_tpu/models/library.py``: ``reference_arm``,
``planar_3dof`` (via ``serial_chain``), ``arm_7dof`` and
``batched_problem``. The rest of the zoo (``arm_6dof``, ``snake``,
``dual_arm_14dof``, ``humanoid_45dof``) waits for ROADMAP queue A
item 8. Every model function takes the device its tensors live on.
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
