"""Rotation math: Euler-XYZ matrices.

Port of ``ikpso_tpu/ops/rotations.py::euler_xyz_to_matrix``:
``R = Rx(a_x) @ Ry(a_y) @ Rz(a_z)`` in closed form. The quaternion
helpers wait for the orientation branch (ROADMAP queue A item 8).
"""

from __future__ import annotations

import torch


def euler_xyz_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Euler XYZ angles ``(..., 3)`` -> rotation matrices ``(..., 3, 3)``."""
    x, y, z = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    r00 = cy * cz
    r01 = -cy * sz
    r02 = sy
    r10 = cx * sz + sx * sy * cz
    r11 = cx * cz - sx * sy * sz
    r12 = -sx * cy
    r20 = sx * sz - cx * sy * cz
    r21 = sx * cz + cx * sy * sz
    r22 = cx * cy
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )
