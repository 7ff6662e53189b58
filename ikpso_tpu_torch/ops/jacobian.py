"""Analytic geometric Jacobian of the effector pose w.r.t. joint angles.

Port of ``ikpso_tpu/ops/jacobian.py`` (``ancestry_mask``,
``fk_with_jacobian``). Node k's three Euler rotations pivot at the
parent's world position and rotate everything downstream; their world
axes are column 0 of ``R_parent`` (x), ``cx * col1(R_parent) + sx *
col2(R_parent)`` (y) and column 2 of ``R_k`` (z). Position rows are
``axis x (p_effector - p_parent)``, orientation rows the axis itself,
both masked to the nodes on the root-to-effector path. One FK pass plus
cross products, elementwise over the batch: each product and difference
its own op, so no device fuses them and every device rounds alike.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ikpso_tpu_torch.models.chain import ChainSpec
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.rotations import cos_sin


def ancestry_mask(spec: ChainSpec) -> np.ndarray:
    """``(E, N-1)`` float mask: 1 where node k is on the path to effector e."""
    mask = np.zeros((spec.num_effectors, spec.num_nodes - 1), np.float32)
    for ei, node in enumerate(spec.effector_idx):
        k = node
        while k > 0:
            mask[ei, k - 1] = 1.0
            k = spec.parent[k]
    return mask


def fk_with_jacobian(
    spec: ChainSpec, pose: torch.Tensor, origin: torch.Tensor, *,
    orientation: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FK plus the effector Jacobian in one pass.

    ``pose`` is ``(..., N, 3)`` (row 0 the origin rotation), ``origin``
    ``(..., 3)``. Returns ``(eff_pos (..., E, 3), eff_rot (..., E, 3, 3),
    jac)``, ``jac`` ``(..., 3E, D)`` -- rows (effector, xyz), columns
    (node, axis) -- or ``(..., 6E, D)`` with ``orientation`` (the position
    rows, then three rotation rows per effector, the residual layout of
    ``pso.polish``).
    """
    eff = list(spec.effector_idx)
    parents = list(spec.parent[1:])
    pos, rot = fk_ops.fk(spec, pose, origin)

    rp = rot[..., parents, :, :]  # (..., K, 3, 3) parent world rotations
    cx, sx = cos_sin(pose[..., 1:, 0])
    ax = rp[..., :, :, 0]
    ay = cx[..., None] * rp[..., :, :, 1] + sx[..., None] * rp[..., :, :, 2]
    az = rot[..., 1:, :, 2]
    axes = torch.stack([ax, ay, az], dim=-2)  # (..., K, 3 axes, 3)

    pivot = pos[..., parents, :]  # (..., K, 3)
    pe = pos[..., eff, :]  # (..., E, 3)
    mask = torch.as_tensor(ancestry_mask(spec), device=pose.device)  # (E, K)

    # J_pos[e, k, a, :] = axis_(k, a) x (p_e - pivot_k), masked by path.
    diff = pe[..., :, None, None, :] - pivot[..., None, :, None, :]
    a, diff = torch.broadcast_tensors(axes[..., None, :, :, :], diff)
    (a0, a1, a2), (d0, d1, d2) = a.unbind(-1), diff.unbind(-1)
    jpos = torch.stack([a1 * d2 - a2 * d1, a2 * d0 - a0 * d2, a0 * d1 - a1 * d0], dim=-1)
    jpos = jpos * mask[:, :, None, None]  # (..., E, K, A, 3)

    def rows(j):  # (..., E, K, A, 3) -> (..., E*3, D)
        j = torch.movedim(j, -1, -3)  # (..., E, 3, K, A)
        return j.reshape(j.shape[:-4] + (j.shape[-4] * 3, spec.dof))

    jac = rows(jpos)
    if orientation:
        jrot = a * mask[:, :, None, None]
        jac = torch.cat([jac, rows(jrot)], dim=-2)
    return pe, rot[..., eff, :, :], jac
