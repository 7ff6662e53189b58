"""Rotation math: Euler-XYZ matrices and quaternion conversions.

Port of ``ikpso_tpu/ops/rotations.py``: ``euler_xyz_to_matrix``
(``R = Rx(a_x) @ Ry(a_y) @ Rz(a_z)`` in closed form),
``quaternion_to_matrix`` (scene boxes), ``matrix_to_quaternion`` /
``quaternion_to_euler_xyz``, through which the orientation harness
builds its Euler target rotations as ``bench.py:112-120`` does, and the
quaternion algebra ``euler_xyz_to_quaternion``, ``quaternion_multiply``,
``quaternion_invert`` and ``quaternion_rotate_vector``. Quaternions are
``(x, y, z, w)``.

The sines and cosines are taken in float64 and rounded to the input's
dtype: a float32 ``sin`` differs by an ulp between the CPU and the GPU,
a float64 one rounded to float32 does not (but for inputs within a few
float64 ulps of a rounding midpoint), so the FK built on them rounds
alike on every device.
"""

from __future__ import annotations

import torch


def cos_sin(x: torch.Tensor):
    """``(cos x, sin x)`` taken in float64, rounded to ``x``'s dtype."""
    xd = x.double()
    return torch.cos(xd).to(x.dtype), torch.sin(xd).to(x.dtype)


def euler_xyz_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Euler XYZ angles ``(..., 3)`` -> rotation matrices ``(..., 3, 3)``."""
    x, y, z = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = cos_sin(x)
    cy, sy = cos_sin(y)
    cz, sz = cos_sin(z)
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


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion ``(..., 4)`` (x, y, z, w) -> rotation matrix ``(..., 3, 3)``."""
    qx, qy, qz, qw = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    r00 = 1 - 2 * qy * qy - 2 * qz * qz
    r01 = 2 * qx * qy - 2 * qz * qw
    r02 = 2 * qx * qz + 2 * qy * qw
    r10 = 2 * qx * qy + 2 * qz * qw
    r11 = 1 - 2 * qx * qx - 2 * qz * qz
    r12 = 2 * qy * qz - 2 * qx * qw
    r20 = 2 * qx * qz - 2 * qy * qw
    r21 = 2 * qy * qz + 2 * qx * qw
    r22 = 1 - 2 * qx * qx - 2 * qy * qy
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quaternion(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``(..., 3, 3)`` -> quaternion ``(..., 4)`` (x, y, z, w).

    Branch-free four-candidate selection: every candidate is computed and
    the numerically stable one picked with ``torch.where``; each sqrt
    argument is floored at 1e-12 so the unselected candidates stay finite.
    """
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22

    def _safe_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12))

    s0 = _safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0],
                     dim=-1)
    s1 = _safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1],
                     dim=-1)
    s2 = _safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2],
                     dim=-1)
    s3 = _safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3],
                     dim=-1)
    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 > m11) & (m00 > m22))[..., None]
    use2 = (m11 > m22)[..., None]
    return torch.where(use0, q0, torch.where(use1, q1, torch.where(use2, q2, q3)))


def quaternion_to_euler_xyz(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion ``(..., 4)`` -> Euler XYZ ``(..., 3)``, read off the
    equivalent matrix: ``r02 = sin y`` (clamped ``asin``),
    ``x = atan2(-r12, r22)``, ``z = atan2(-r01, r00)``."""
    rot = quaternion_to_matrix(quat)
    y = torch.asin(torch.clamp(rot[..., 0, 2], -1.0, 1.0))
    x = torch.atan2(-rot[..., 1, 2], rot[..., 2, 2])
    z = torch.atan2(-rot[..., 0, 1], rot[..., 0, 0])
    return torch.stack([x, y, z], dim=-1)


def euler_xyz_to_quaternion(angles: torch.Tensor) -> torch.Tensor:
    """Euler XYZ ``(..., 3)`` -> quaternion ``(..., 4)`` (x, y, z, w),
    ``q = qx * qy * qz``, the rotation of :func:`euler_xyz_to_matrix`."""
    half = angles * 0.5
    cx, sx = cos_sin(half[..., 0])
    cy, sy = cos_sin(half[..., 1])
    cz, sz = cos_sin(half[..., 2])
    qx = sx * cy * cz + cx * sy * sz
    qy = cx * sy * cz - sx * cy * sz
    qz = cx * cy * sz + sx * sy * cz
    qw = cx * cy * cz - sx * sy * sz
    return torch.stack([qx, qy, qz, qw], dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of ``(x, y, z, w)`` quaternions."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quaternion_invert(quat: torch.Tensor) -> torch.Tensor:
    """Inverse of a (not necessarily unit) quaternion: the conjugate over
    ``|q|^2`` (floored at 1e-30), the reference's ``quatInvert2``."""
    norm_sq = (quat[..., 0:1] * quat[..., 0:1] + quat[..., 1:2] * quat[..., 1:2]
               + quat[..., 2:3] * quat[..., 2:3] + quat[..., 3:4] * quat[..., 3:4])
    sign = torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=quat.dtype, device=quat.device)
    return quat * sign / torch.clamp_min(norm_sq, 1e-30)


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def quaternion_rotate_vector(quat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Rotate ``vec`` ``(..., 3)`` by the unit quaternion ``quat`` ``(..., 4)``:
    ``v + w t + q_v x t`` with ``t = 2 q_v x v``."""
    qv = quat[..., :3]
    qw = quat[..., 3:4]
    t = 2.0 * _cross(qv, vec)
    return vec + qw * t + _cross(qv, t)
