"""Kinematic-tree specification and per-solve problem state.

Port of ``ikpso_tpu/models/chain.py`` (``ChainSpec``, ``make_chain_spec``,
``Obstacles``, ``IKProblem``, ``stack_problems``). Topology (``parent``,
``effector_idx``) stays a static Python tuple; joint data are float32
tensors on an explicit device. Nodes are topologically ordered
(``parent[k] < k``) and node 0 is the origin, which carries no degrees
of freedom: ``dof = 3 * (num_nodes - 1)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static description of an articulated kinematic tree.

    Attributes:
      length: ``(N,)`` link length along the parent-local +X axis.
      min_rotation / max_rotation: ``(N, 3)`` per-axis joint limits.
      effector_weight: ``(N,)`` fitness weight; zero for non-effectors.
      parent: parent node index per node, ``parent[0] == -1``.
      effector_idx: effector node indices, in target order.
    """

    length: torch.Tensor
    min_rotation: torch.Tensor
    max_rotation: torch.Tensor
    effector_weight: torch.Tensor
    parent: Tuple[int, ...]
    effector_idx: Tuple[int, ...]

    @property
    def num_nodes(self) -> int:
        return len(self.parent)

    @property
    def num_effectors(self) -> int:
        return len(self.effector_idx)

    @property
    def dof(self) -> int:
        return (self.num_nodes - 1) * 3

    @property
    def device(self) -> torch.device:
        return self.length.device

    def validate(self) -> "ChainSpec":
        if self.parent[0] != -1:
            raise ValueError("node 0 must be the origin (parent == -1)")
        for k, p in enumerate(self.parent[1:], start=1):
            if not 0 <= p < k:
                raise ValueError(
                    f"nodes must be topologically ordered: parent[{k}]={p}"
                )
        for e in self.effector_idx:
            if not 0 < e < self.num_nodes:
                raise ValueError(f"effector index {e} out of range")
        n = self.num_nodes
        for name in ("length", "effector_weight"):
            if tuple(getattr(self, name).shape) != (n,):
                raise ValueError(f"{name} must have shape ({n},)")
        for name in ("min_rotation", "max_rotation"):
            if tuple(getattr(self, name).shape) != (n, 3):
                raise ValueError(f"{name} must have shape ({n}, 3)")
        return self

    def limits(self) -> torch.Tensor:
        """``(2, D)`` flat [lower; upper] joint limits of the DOF vector."""
        return torch.stack(
            [self.min_rotation[1:].reshape(-1), self.max_rotation[1:].reshape(-1)]
        )


def make_chain_spec(
    parent,
    length,
    min_rotation,
    max_rotation,
    effector_idx,
    effector_weight=None,
    *,
    device="cpu",
) -> ChainSpec:
    """Build and validate a :class:`ChainSpec` from array-likes.

    ``effector_weight`` may be per-effector or per-node; the default is
    1.0 per effector.
    """
    parent = tuple(int(p) for p in np.asarray(parent))
    effector_idx = tuple(int(e) for e in np.asarray(effector_idx))
    n = len(parent)
    weights = np.zeros((n,), np.float32)
    if effector_weight is None:
        weights[list(effector_idx)] = 1.0
    else:
        ew = np.asarray(effector_weight, np.float32)
        if ew.shape == (len(effector_idx),):
            weights[list(effector_idx)] = ew
        elif ew.shape == (n,):
            weights = ew
        else:
            raise ValueError("effector_weight must be per-effector or per-node")
    return ChainSpec(
        length=_f32(np.broadcast_to(np.asarray(length, np.float32), (n,)), device),
        min_rotation=_f32(
            np.broadcast_to(np.asarray(min_rotation, np.float32), (n, 3)), device
        ),
        max_rotation=_f32(
            np.broadcast_to(np.asarray(max_rotation, np.float32), (n, 3)), device
        ),
        effector_weight=_f32(weights, device),
        parent=parent,
        effector_idx=effector_idx,
    ).validate()


@dataclasses.dataclass(frozen=True)
class Obstacles:
    """Oriented-box scene colliders (``half_extent`` holds HALF sizes,
    ``rot`` the box world rotation as a matrix, columns = box axes)."""

    center: torch.Tensor  # (C, 3)
    half_extent: torch.Tensor  # (C, 3)
    rot: torch.Tensor  # (C, 3, 3)

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @staticmethod
    def empty(device="cpu") -> "Obstacles":
        return Obstacles(
            center=torch.zeros((0, 3), device=device),
            half_extent=torch.zeros((0, 3), device=device),
            rot=torch.zeros((0, 3, 3), device=device),
        )

    @staticmethod
    def from_boxes(centers, full_dims, quats=None, *, device="cpu") -> "Obstacles":
        """Build from full box dimensions and optional (x,y,z,w) quats."""
        from ikpso_tpu_torch.ops.rotations import quaternion_to_matrix

        centers = _f32(np.atleast_2d(np.asarray(centers, np.float32)), device)
        dims = _f32(np.atleast_2d(np.asarray(full_dims, np.float32)), device)
        if quats is None:
            rot = torch.eye(3, device=device).expand(centers.shape[0], 3, 3)
        else:
            rot = quaternion_to_matrix(
                _f32(np.atleast_2d(np.asarray(quats, np.float32)), device))
        return Obstacles(center=centers, half_extent=dims * 0.5,
                         rot=rot.contiguous())


@dataclasses.dataclass(frozen=True)
class IKProblem:
    """Per-solve state; every field may carry leading batch (swarm) axes.

    Attributes:
      pose: ``(..., N, 3)`` Euler-XYZ joint rotations; row 0 is the
        fixed origin rotation, rows 1.. the warm start and locality anchor.
      origin: ``(..., 3)`` origin world translation.
      targets: ``(..., E, 3)`` effector targets, ordered like
        ``ChainSpec.effector_idx``.
      target_rot: optional ``(..., E, 3)`` Euler target orientations.
    """

    pose: torch.Tensor
    origin: torch.Tensor
    targets: torch.Tensor
    target_rot: Optional[torch.Tensor] = None

    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.pose.shape[:-2])

    def replace(self, **kw) -> "IKProblem":
        return dataclasses.replace(self, **kw)

    def take(self, idx: torch.Tensor) -> "IKProblem":
        """Rows ``idx`` of a batched problem (the retry gather)."""
        return IKProblem(
            pose=self.pose[idx],
            origin=self.origin[idx],
            targets=self.targets[idx],
            target_rot=None if self.target_rot is None else self.target_rot[idx],
        )


def stack_problems(problems) -> IKProblem:
    """Stack a list of unbatched problems into one batched IKProblem."""
    problems = list(problems)
    rots = [p.target_rot for p in problems]
    if any(r is None for r in rots) and not all(r is None for r in rots):
        raise ValueError("either every problem or none carries target_rot")
    return IKProblem(
        pose=torch.stack([p.pose for p in problems]),
        origin=torch.stack([p.origin for p in problems]),
        targets=torch.stack([p.targets for p in problems]),
        target_rot=None if rots[0] is None else torch.stack(rots),
    )
