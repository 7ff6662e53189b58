"""Oriented-box collision tests, plain torch.

Port of ``ikpso_tpu/ops/collision.py``: the 15-axis separating-axis test
(``obb_obb_intersect``) behind the reference's cube-gizmo + link-box
chain colliders (``chain_collides``), and the closed-form point/segment
OBB distances (``point_obb_dist2``, ``segment_obb_dist2``) behind the
rounded sphere + capsule colliders (``chain_collides_capsule``).
``get_chain_collider`` picks one by (backend, shape): these closed-form
colliders for ``"sat"``, their GJK twins (``ops/gjk.py``) for ``"gjk"``.

Every function broadcasts over leading batch dimensions, so one call
tests (swarms x nodes x obstacles) pairs. These tensor versions serve
the scoring and the polish gate; the fitness tile inlines its own
per-particle copies (``ops/fitness_kernel.py``, kernel B).
"""

from __future__ import annotations

import numpy as np
import torch

# Fattening epsilon on |C|: the standard SAT guard against near-parallel
# edge pairs.
SAT_EPS = 1e-6
# Bisection rounds for the segment-OBB distance (t pinned to ~6e-8).
SEGMENT_OBB_ITERATIONS = 24


def obb_obb_intersect(center_a, half_a, rot_a, center_b, half_b, rot_b):
    """``(...,)`` bool: do oriented boxes A and B overlap?

    ``center_*`` / ``half_*`` are ``(..., 3)``, ``rot_*`` ``(..., 3, 3)``
    with the box axes as columns.
    """
    rot_a, rot_b = torch.broadcast_tensors(rot_a, rot_b)
    c = torch.einsum("...ji,...jk->...ik", rot_a, rot_b)
    t = torch.einsum("...ji,...j->...i", rot_a,
                     (center_b - center_a).expand(rot_a.shape[:-1]))
    abs_c = torch.abs(c) + SAT_EPS
    a = [half_a[..., i] for i in range(3)]
    b = [half_b[..., i] for i in range(3)]

    separated = torch.zeros(t.shape[:-1], dtype=torch.bool, device=t.device)
    for i in range(3):
        rb = b[0] * abs_c[..., i, 0] + b[1] * abs_c[..., i, 1] + b[2] * abs_c[..., i, 2]
        separated |= torch.abs(t[..., i]) > a[i] + rb
    for j in range(3):
        ra = a[0] * abs_c[..., 0, j] + a[1] * abs_c[..., 1, j] + a[2] * abs_c[..., 2, j]
        proj = t[..., 0] * c[..., 0, j] + t[..., 1] * c[..., 1, j] + t[..., 2] * c[..., 2, j]
        separated |= torch.abs(proj) > ra + b[j]
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            ra = a[i1] * abs_c[..., i2, j] + a[i2] * abs_c[..., i1, j]
            rb = b[j1] * abs_c[..., i, j2] + b[j2] * abs_c[..., i, j1]
            lhs = torch.abs(t[..., i2] * c[..., i1, j] - t[..., i1] * c[..., i2, j])
            separated |= lhs > ra + rb
    return ~separated


def chain_collides(positions, rotations, parent_positions, lengths,
                   obstacle_center, obstacle_half, obstacle_rot, gizmo_size=0.2):
    """``(...,)`` bool: does any joint gizmo or link box hit any obstacle?

    Per non-root node a cube of side ``gizmo_size`` at the node and a
    ``length x (gizmo_size/4)^2`` box at the link midpoint, both
    oriented by the node's world rotation (reference kernel.cu:104-136).
    ``positions`` / ``parent_positions`` are ``(..., K, 3)``,
    ``rotations`` ``(..., K, 3, 3)``, ``lengths`` ``(K,)``, the
    obstacle tensors ``(C, 3)`` / ``(C, 3)`` / ``(C, 3, 3)``.
    """
    if obstacle_center.shape[0] == 0:
        return torch.zeros(positions.shape[:-2], dtype=torch.bool,
                           device=positions.device)
    node_rot = rotations[..., :, None, :, :]
    node_half = torch.full((3,), gizmo_size * 0.5, device=positions.device)
    link_center = ((positions + parent_positions) * 0.5)[..., :, None, :]
    link_half = torch.stack(
        [lengths * 0.5,
         torch.full_like(lengths, gizmo_size * 0.25 * 0.5),
         torch.full_like(lengths, gizmo_size * 0.25 * 0.5)],
        dim=-1,
    )[..., :, None, :]
    node_hit = obb_obb_intersect(positions[..., :, None, :], node_half, node_rot,
                                 obstacle_center, obstacle_half, obstacle_rot)
    link_hit = obb_obb_intersect(link_center, link_half, node_rot,
                                 obstacle_center, obstacle_half, obstacle_rot)
    return torch.any(torch.any(node_hit | link_hit, dim=-1), dim=-1)


def _box_frame(rot, v):
    """``rot^T v`` for ``(..., 3)`` offsets ``v``: each coordinate a 3-term
    dot product summed in axis order, as XLA's CPU dot sums it."""
    return torch.stack([rot[..., 0, i] * v[..., 0] + rot[..., 1, i] * v[..., 1]
                        + rot[..., 2, i] * v[..., 2] for i in range(3)], dim=-1)


def _excess2(q, half):
    """``sum_i max(|q_i| - h_i, 0)^2`` of box-frame points, in axis order."""
    d = torch.clamp_min(torch.abs(q) - half, 0.0)
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def point_obb_dist2(p, center, half, rot):
    """Squared distance from points ``(..., 3)`` to an OBB: clamp the
    point, in the box frame, to the box."""
    return _excess2(_box_frame(rot, p - center), half)


def segment_obb_dist2(p0, p1, center, half, rot, *,
                      iterations: int = SEGMENT_OBB_ITERATIONS):
    """Squared distance from segments ``p0 -> p1`` to an OBB.

    ``d^2(t)`` is convex in the segment parameter with the monotone
    derivative ``g(t) = 2 sum_i sign(q_i) max(|q_i| - h_i, 0) b_i``;
    ``iterations`` branch-free bisection rounds on ``g`` find the
    minimizing t (the endpoint cases collapse onto the right end).
    """
    q0 = _box_frame(rot, p0 - center)
    q1 = _box_frame(rot, p1 - center)
    b = q1 - q0

    def g(t):
        q = q0 + t[..., None] * b
        s = torch.sign(q) * torch.clamp_min(torch.abs(q) - half, 0.0)
        return torch.sum(s * b, dim=-1)

    lo = torch.zeros(q0.shape[:-1], dtype=q0.dtype, device=q0.device)
    hi = torch.ones_like(lo)
    for _ in range(iterations):
        tm = 0.5 * (lo + hi)
        pred = g(tm) > 0
        hi = torch.where(pred, tm, hi)
        lo = torch.where(pred, lo, tm)
    t = 0.5 * (lo + hi)
    return _excess2(q0 + t[..., None] * b, half)


def chain_collides_capsule(positions, rotations, parent_positions, lengths,
                           obstacle_center, obstacle_half, obstacle_rot,
                           gizmo_size=0.2):
    """Rounded chain colliders vs scene boxes: a sphere of radius
    ``gizmo_size/2`` at each non-root node and a capsule of radius
    ``gizmo_size/8`` over each parent->node segment. ``rotations`` and
    ``lengths`` are accepted for signature parity and ignored."""
    del rotations, lengths
    if obstacle_center.shape[0] == 0:
        return torch.zeros(positions.shape[:-2], dtype=torch.bool,
                           device=positions.device)
    # Radii squared in double, then rounded (the JAX side's np.float32).
    node_r2 = float(np.float32((gizmo_size * 0.5) ** 2))
    link_r2 = float(np.float32((gizmo_size * 0.125) ** 2))
    p = positions[..., :, None, :]
    pp = parent_positions[..., :, None, :]
    node_hit = point_obb_dist2(p, obstacle_center, obstacle_half, obstacle_rot) <= node_r2
    link_hit = segment_obb_dist2(pp, p, obstacle_center, obstacle_half,
                                 obstacle_rot) <= link_r2
    return torch.any(torch.any(node_hit | link_hit, dim=-1), dim=-1)


def get_chain_collider(backend: str, shape: str):
    """The chain collider for ``(collision_backend, collision_shape)``:
    ``("sat", "box")`` -> :func:`chain_collides`, ``("sat", "capsule")``
    -> :func:`chain_collides_capsule`, ``("gjk", shape)`` -> the GJK twins
    ``ops.gjk.chain_collides_gjk`` / ``chain_collides_capsule_gjk``."""
    if backend not in ("sat", "gjk"):
        raise ValueError(f"unknown collision_backend {backend!r}; expected 'sat' or 'gjk'")
    if shape not in ("box", "capsule"):
        raise ValueError(f"unknown collision_shape {shape!r}; expected 'box' or 'capsule'")
    if backend == "gjk":
        from ikpso_tpu_torch.ops.gjk import chain_collides_capsule_gjk, chain_collides_gjk

        return chain_collides_gjk if shape == "box" else chain_collides_capsule_gjk
    return chain_collides if shape == "box" else chain_collides_capsule
