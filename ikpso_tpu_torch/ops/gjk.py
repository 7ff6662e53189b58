"""Branch-free, fixed-round GJK boolean intersection, plain torch.

Port of ``ikpso_tpu/ops/gjk.py``: the reference's iterative support-point
GJK (``GJK_ITERATIONS = 50`` rounds) with every simplex case (segment,
triangle, tetrahedron) evaluated as masked selects over a fixed
``(..., 4, 3)`` simplex buffer, so all lanes run the same straight-line
code each round. Lanes that reach a verdict freeze their state under the
``done`` mask; lanes that exhaust the budget without one report a hit
(the conservative pose rejector of the reference).

Stopping early: JAX runs all rounds inside a ``lax.fori_loop``. Here the
loop leaves once every lane is done, checked every
``GJK_CHECK_EVERY`` rounds (one host sync per check, not one per round).
A done lane's state never changes again, so the result is bit-identical
to running every round (``early_stop=False`` forces them all).

The arithmetic follows JAX's op for op in float32: dot products and the
box support's 3x3 products summed term by term in axis order, cross
products as ``jnp.cross`` forms them. ``gjk_intersect`` takes any pair of
support functions; ``chain_collides_gjk`` and
``chain_collides_capsule_gjk`` are the GJK twins of
``ops.collision.chain_collides`` and ``chain_collides_capsule``. Every
function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

from typing import Callable

import torch

# The reference's fixed round budget (ik_constants.h:8).
GJK_ITERATIONS = 50
# Squared-magnitude epsilon: FLT_EPSILON, as the reference's IsZERO.
_EPS = 1.19209290e-07
# Rounds between the early-stop checks (one host sync each).
GJK_CHECK_EVERY = 4

SupportFn = Callable[[torch.Tensor], torch.Tensor]  # (..., 3) dir -> (..., 3) point


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _triple(a, b, c):
    """``(a x b) x c``."""
    return _cross(_cross(a, b), c)


def _where(mask, a, b):
    return torch.where(mask[..., None], a, b)


def _pick(mask, a, b):
    """``where`` of ``(..., 4, 3)`` simplex buffers on an ``(...,)`` mask."""
    return torch.where(mask[..., None, None], a, b)


def _simplex2(a, b):
    """Segment case: ``(pts (..., 4, 3), n, dir, contact)``; index 0 of
    the buffer is always the newest point A. ``contact`` where the origin
    lies on the segment."""
    ab = b - a
    ao = -a
    t = _dot(ab, ao)
    toward = t > 0
    d_line = _triple(ab, ao, ab)
    ab2 = _dot(ab, ab)
    ao2 = _dot(ao, ao)
    collinear = _dot(d_line, d_line) <= _EPS * ab2 * ab2 * ao2
    between = toward & (t <= ab2 * (1.0 + _EPS))
    contact = collinear & between
    new_dir = _where(toward, d_line, ao)
    pts = torch.stack([a, b, b, b], dim=-2)
    n = torch.where(toward, 2, 1)
    return pts, n, new_dir, contact


def _simplex3(a, b, c):
    """Triangle case: ``(pts, n, dir, contact)``."""
    ab = b - a
    ac = c - a
    ao = -a
    abc = _cross(ab, ac)

    outside_ac = _dot(_cross(abc, ac), ao) > 0
    ac_toward = _dot(ac, ao) > 0
    outside_ab = _dot(_cross(ab, abc), ao) > 0
    above = _dot(abc, ao) > 0

    pts_ac, n_ac, dir_ac, contact_ac = _simplex2(a, c)
    pts_ab, n_ab, dir_ab, contact_ab = _simplex2(a, b)
    plane_d = _dot(abc, ao)
    abc2 = _dot(abc, abc)
    in_plane = plane_d * plane_d <= _EPS * abc2 * torch.clamp_min(_dot(ao, ao), _EPS)
    pts_up = torch.stack([a, b, c, c], dim=-2)
    pts_dn = torch.stack([a, c, b, b], dim=-2)
    pts_tri = _pick(above, pts_up, pts_dn)
    dir_tri = _where(above, abc, -abc)

    use_ac = outside_ac & ac_toward
    use_ab = (outside_ac & ~ac_toward) | (~outside_ac & outside_ab)
    use_tri = ~use_ac & ~use_ab

    pts = _pick(use_ac, pts_ac, _pick(use_ab, pts_ab, pts_tri))
    n = torch.where(use_ac, n_ac, torch.where(use_ab, n_ab, 3))
    new_dir = _where(use_ac, dir_ac, _where(use_ab, dir_ab, dir_tri))
    contact = torch.where(use_ac, contact_ac,
                          torch.where(use_ab, contact_ab, use_tri & in_plane))
    return pts, n, new_dir, contact


def _simplex4(a, b, c, d):
    """Tetrahedron case: ``(pts, n, dir, contains)``, ``contains`` where
    the origin is inside the tetrahedron (or on a face's triangle)."""
    ab = b - a
    ac = c - a
    ad = d - a
    ao = -a
    abc = _cross(ab, ac)
    acd = _cross(ac, ad)
    adb = _cross(ad, ab)

    out_abc = _dot(abc, ao) > 0
    out_acd = _dot(acd, ao) > 0
    out_adb = _dot(adb, ao) > 0
    contains = ~(out_abc | out_acd | out_adb)

    pts_abc, n_abc, dir_abc, c_abc = _simplex3(a, b, c)
    pts_acd, n_acd, dir_acd, c_acd = _simplex3(a, c, d)
    pts_adb, n_adb, dir_adb, c_adb = _simplex3(a, d, b)

    pts = _pick(out_abc, pts_abc, _pick(out_acd, pts_acd, pts_adb))
    n = torch.where(out_abc, n_abc, torch.where(out_acd, n_acd, n_adb))
    new_dir = _where(out_abc, dir_abc, _where(out_acd, dir_acd, dir_adb))
    sub_contact = torch.where(out_abc, c_abc, torch.where(out_acd, c_acd, c_adb))
    return pts, n, new_dir, contains | sub_contact


def gjk_intersect(support_a: SupportFn, support_b: SupportFn, init_dir: torch.Tensor, *,
                  iterations: int = GJK_ITERATIONS, early_stop: bool = True) -> torch.Tensor:
    """``(...,)`` bool: do convex shapes A and B overlap?

    ``support_a`` / ``support_b`` map ``(..., 3)`` directions to the
    shape's farthest point; ``init_dir`` ``(..., 3)`` is the first search
    direction (conventionally ``center_b - center_a``). Lanes without a
    verdict after ``iterations`` rounds report True. ``early_stop`` leaves
    the loop once every lane is done (:data:`GJK_CHECK_EVERY`); the result
    is the same bits either way.
    """

    def minkowski_support(d):
        return support_a(d) - support_b(-d)

    batch = init_dir.shape[:-1]
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=init_dir.dtype, device=init_dir.device)
    d0 = _where(_dot(init_dir, init_dir) < _EPS, x_axis, init_dir)
    s0 = minkowski_support(d0)
    pts = s0[..., None, :].expand(batch + (4, 3)).to(init_dir.dtype)
    n = torch.ones(batch, dtype=torch.int32, device=init_dir.device)
    direction = -s0
    # The origin is the first support point itself: contact.
    done = _dot(direction, direction) < _EPS
    hit = done.clone()

    for rnd in range(iterations):
        if early_stop and rnd % GJK_CHECK_EVERY == 0 and bool(done.all()):
            break
        a = minkowski_support(direction)
        # The new point did not pass the origin: separated.
        separated = _dot(a, direction) < 0
        # Stall: the support point is already in the simplex (the padding
        # rows copy valid rows), so no progress is possible.
        diff = a[..., None, :] - pts
        scale = 1.0 + _dot(a, a)
        stalled = torch.any(_dot(diff, diff) < _EPS * scale[..., None], dim=-1)

        b, c, d = pts[..., 0, :], pts[..., 1, :], pts[..., 2, :]
        pts2, n2, dir2, hit2 = _simplex2(a, b)
        pts3, n3, dir3, hit3 = _simplex3(a, b, c)
        pts4, n4, dir4, hit4 = _simplex4(a, b, c, d)

        is2 = n == 1
        is3 = n == 2
        new_pts = _pick(is2, pts2, _pick(is3, pts3, pts4))
        new_n = torch.where(is2, n2, torch.where(is3, n3, n4))
        new_dir = _where(is2, dir2, _where(is3, dir3, dir4))
        new_hit = torch.where(is2, hit2, torch.where(is3, hit3, hit4))
        # A degenerate next direction that is not a contact: keep moving
        # toward the origin; a support point at the origin is a contact.
        zero_dir = _dot(new_dir, new_dir) < _EPS
        new_dir = _where(zero_dir, -a, new_dir)
        at_origin = zero_dir & (_dot(a, a) < _EPS)

        # The separation verdict wins over the simplex contact flags.
        step_hit = ~separated & (new_hit | at_origin)
        step_done = separated | stalled | step_hit

        pts = _pick(done, pts, new_pts)
        n = torch.where(done, n, new_n.to(n.dtype))
        direction = _where(done, direction, new_dir)
        hit = torch.where(done, hit, step_hit)
        done = done | step_done
    # Budget exhausted without a verdict: a conservative hit.
    return torch.where(done, hit, True)


def _rotate_t(rot, d):
    """``R^T d`` for ``(..., 3, 3)`` rotations, summed in axis order."""
    return torch.stack([rot[..., 0, i] * d[..., 0] + rot[..., 1, i] * d[..., 1]
                        + rot[..., 2, i] * d[..., 2] for i in range(3)], dim=-1)


def _rotate(rot, v):
    """``R v`` for ``(..., 3, 3)`` rotations, summed in axis order."""
    return torch.stack([rot[..., i, 0] * v[..., 0] + rot[..., i, 1] * v[..., 1]
                        + rot[..., i, 2] * v[..., 2] for i in range(3)], dim=-1)


def box_support(center: torch.Tensor, half: torch.Tensor, rot: torch.Tensor) -> SupportFn:
    """Support function of an oriented box: ``center`` ``(..., 3)``, half
    extents ``half`` ``(..., 3)``, ``rot`` ``(..., 3, 3)`` with the box
    axes as columns."""

    def support(d):
        local = _rotate_t(rot, d)
        corner = torch.where(local >= 0, half, -half)
        return center + _rotate(rot, corner)

    return support


def sphere_support(center: torch.Tensor, radius) -> SupportFn:
    """Support function of a sphere."""

    def support(d):
        norm = torch.sqrt(torch.clamp_min(_dot(d, d), 1e-30))[..., None]
        return center + radius * d / norm

    return support


def segment_support(p0: torch.Tensor, p1: torch.Tensor) -> SupportFn:
    """Support function of the segment ``p0 -> p1``."""

    def support(d):
        return _where(_dot(p1 - p0, d) > 0, p1, p0)

    return support


def capsule_support(p0: torch.Tensor, p1: torch.Tensor, radius) -> SupportFn:
    """Support function of a capsule: the segment swept by a sphere."""
    seg = segment_support(p0, p1)

    def support(d):
        norm = torch.sqrt(torch.clamp_min(_dot(d, d), 1e-30))[..., None]
        return seg(d) + radius * d / norm

    return support


def gjk_box_box(center_a, half_a, rot_a, center_b, half_b, rot_b, *,
                iterations: int = GJK_ITERATIONS, early_stop: bool = True) -> torch.Tensor:
    """GJK twin of ``ops.collision.obb_obb_intersect``."""
    return gjk_intersect(box_support(center_a, half_a, rot_a),
                         box_support(center_b, half_b, rot_b), center_b - center_a,
                         iterations=iterations, early_stop=early_stop)


def chain_collides_gjk(positions, rotations, parent_positions, lengths, obstacle_center,
                       obstacle_half, obstacle_rot, gizmo_size=0.2, *,
                       iterations: int = GJK_ITERATIONS,
                       early_stop: bool = True) -> torch.Tensor:
    """GJK twin of ``ops.collision.chain_collides``: a ``gizmo_size`` cube
    at each non-root node and a ``length x (gizmo_size/4)^2`` box at each
    link midpoint, both oriented by the node's world rotation, against
    every scene box."""
    if obstacle_center.shape[0] == 0:
        return torch.zeros(positions.shape[:-2], dtype=torch.bool, device=positions.device)
    node_center = positions[..., :, None, :]
    node_rot = rotations[..., :, None, :, :]
    node_half = torch.full((3,), gizmo_size * 0.5, dtype=positions.dtype,
                           device=positions.device)
    link_center = ((positions + parent_positions) * 0.5)[..., :, None, :]
    link_half = torch.stack(
        [lengths * 0.5,
         torch.full_like(lengths, gizmo_size * 0.25 * 0.5),
         torch.full_like(lengths, gizmo_size * 0.25 * 0.5)],
        dim=-1,
    )[..., :, None, :]
    kw = dict(iterations=iterations, early_stop=early_stop)
    node_hit = gjk_box_box(node_center, node_half, node_rot, obstacle_center,
                           obstacle_half, obstacle_rot, **kw)
    link_hit = gjk_box_box(link_center, link_half, node_rot, obstacle_center,
                           obstacle_half, obstacle_rot, **kw)
    return torch.any(torch.any(node_hit | link_hit, dim=-1), dim=-1)


def chain_collides_capsule_gjk(positions, rotations, parent_positions, lengths,
                               obstacle_center, obstacle_half, obstacle_rot, gizmo_size=0.2,
                               *, iterations: int = GJK_ITERATIONS,
                               early_stop: bool = True) -> torch.Tensor:
    """GJK twin of ``ops.collision.chain_collides_capsule``: node spheres
    of radius ``gizmo_size/2`` and parent->node capsules of radius
    ``gizmo_size/8`` against every scene box. ``rotations`` and
    ``lengths`` are accepted for signature parity and ignored."""
    del rotations, lengths
    if obstacle_center.shape[0] == 0:
        return torch.zeros(positions.shape[:-2], dtype=torch.bool, device=positions.device)
    p = positions[..., :, None, :]
    pp = parent_positions[..., :, None, :]
    obox = box_support(obstacle_center, obstacle_half, obstacle_rot)
    kw = dict(iterations=iterations, early_stop=early_stop)
    node_hit = gjk_intersect(sphere_support(p, gizmo_size * 0.5), obox,
                             obstacle_center - p, **kw)
    mid = (p + pp) * 0.5
    link_hit = gjk_intersect(capsule_support(pp, p, gizmo_size * 0.125), obox,
                             obstacle_center - mid, **kw)
    return torch.any(torch.any(node_hit | link_hit, dim=-1), dim=-1)
