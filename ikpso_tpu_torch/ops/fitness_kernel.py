"""Fused FK + fitness: the plain torch tile and the wrappers of kernels B and C.

Port of ``ikpso_tpu/ops/pallas_fitness.py`` (renamed: the kernels here
are CUDA, not Pallas). It holds the tile arithmetic the fused solver
inlines — ``sincos_poly`` (``_sincos``), ``rot_xyz`` (``_rot_xyz``),
``mat_mul`` (``_mat_mul``), the collider bodies ``sat_obb``
(``_sat_obb``), ``point_obb_dist2_tile`` and ``seg_obb_dist2_tile`` —
the packed-constant layout (``MetaLayout``, ``pack_meta``,
``pack_swarm``), and two kernels with their plain versions:

  * ``fk_fitness_tile`` over an ``(S, P, D)`` angle tensor:
    ``fk_fitness_plain`` (plain torch, op for op the Pallas tile body)
    and ``fk_fitness`` — kernel B (``csrc/fk_fitness.cuh`` device
    function + ``csrc/fk_fitness.cu`` launcher);
  * ``fused_fitness`` over the lane-major ``(S, D, P)`` layout:
    ``fused_fitness_plain`` and ``fused_fitness`` — kernel C
    (``csrc/fused_fitness.cu``, inlining kernel B's device function),
    with ``make_kernel_fitness``, the scan solver's ``fitness_fn``
    (``make_pallas_fitness``): a :class:`KernelFitness`, which also
    launches the scan solver's step (``csrc/scan_step.cu(h)``, one PSO
    iteration with kernel C's evaluation inlined; ``pso.solver.scan_step``).

Each kernel wrapper runs its plain version on CPU tensors and launches
the kernel (or raises) on CUDA tensors.

Supported in this port: everything the Pallas tile computes -- the FK
tree walk, polynomial or stock (``trig_impl="exact"``) trig, the weighted
effector cost, the orientation term (squared Frobenius distance of each
effector's world rotation to its target, times the orientation and
effector weights), the angular- and node-position-locality terms and
obstacle rejection (box SAT or capsule colliders against the scene boxes
packed into ``meta``; a hit costs ``COLLISION_PENALTY``); on the card,
any tree (``utils.kernels`` builds a combination the prebuilt library
lacks on demand). The GJK collider is the plain fitness's only, as in
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import COLLISION_PENALTY, FitnessConfig, effector_index
from ikpso_tpu_torch.ops.collision import SAT_EPS, SEGMENT_OBB_ITERATIONS
from ikpso_tpu_torch.ops.rotations import euler_xyz_to_matrix
from ikpso_tpu_torch.utils import kernels


def _f32(v) -> float:
    """A Python float holding exactly the float32 value of ``v`` (so a
    tensor op with it rounds like the JAX/Pallas np.float32 constant)."""
    return float(np.float32(v))


# Minimax sincos on [-pi, pi] after one-step range reduction; the same
# coefficients as ikpso_tpu/ops/pallas_fitness.py:63-73. End-to-end f32
# error over [-4pi, 4pi]: 1.2e-6 (sin) / 5.3e-7 (cos).
INV_2PI = _f32(1.0 / (2.0 * np.pi))
TWO_PI = _f32(2.0 * np.pi)
SIN_C = tuple(_f32(v) for v in (
    9.9999970703e-01, -1.6666577215e-01, 8.3325581177e-03,
    -1.9812575520e-04, 2.7040512127e-06, -2.0534244526e-08,
))
COS_C = tuple(_f32(v) for v in (
    9.9999999228e-01, -4.9999991772e-01, 4.1666524360e-02,
    -1.3887970390e-03, 2.4773423752e-05, -2.7113368761e-07,
    1.7369116668e-09,
))


def sincos_poly(x: torch.Tensor):
    """(sin x, cos x) by range reduction to [-pi, pi] (round half to
    even, as ``jnp.round``) and Horner polynomials in r**2."""
    r = x - torch.round(x * INV_2PI) * TWO_PI
    r2 = r * r
    s = SIN_C[-1]
    for coef in SIN_C[-2::-1]:
        s = s * r2 + coef
    c = COS_C[-1]
    for coef in COS_C[-2::-1]:
        c = c * r2 + coef
    return s * r, c


def sincos_exact(x: torch.Tensor):
    """(sin x, cos x) by stock float32 trig (``trig_impl="exact"``):
    ``torch.sin`` / ``torch.cos``, which on the card call the libdevice
    routines kernel B's exact branch calls (``sinf`` / ``cosf``)."""
    return torch.sin(x), torch.cos(x)


def rot_xyz(ax, ay, az, trig_impl: str = "poly"):
    """Rx@Ry@Rz from elementwise angle tensors -> 9 row-major entries."""
    sincos = sincos_exact if trig_impl == "exact" else sincos_poly
    sx, cx = sincos(ax)
    sy, cy = sincos(ay)
    sz, cz = sincos(az)
    return (
        cy * cz, -cy * sz, sy,
        cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy,
        sx * sz - cx * sy * cz, sx * cz + cx * sy * sz, cx * cy,
    )


def mat_mul(a, b):
    """3x3 compose of two row-major 9-tuples of tensors."""
    return (
        a[0] * b[0] + a[1] * b[3] + a[2] * b[6],
        a[0] * b[1] + a[1] * b[4] + a[2] * b[7],
        a[0] * b[2] + a[1] * b[5] + a[2] * b[8],
        a[3] * b[0] + a[4] * b[3] + a[5] * b[6],
        a[3] * b[1] + a[4] * b[4] + a[5] * b[7],
        a[3] * b[2] + a[4] * b[5] + a[5] * b[8],
        a[6] * b[0] + a[7] * b[3] + a[8] * b[6],
        a[6] * b[1] + a[7] * b[4] + a[8] * b[7],
        a[6] * b[2] + a[7] * b[5] + a[8] * b[8],
    )


def sat_frame(rot, orot):
    """The SAT's setup from the particle box's rotation ``rot`` (9-tuple)
    and the scene box's rows ``orot``: ``C = Ra^T Rb`` and ``|C| + eps``
    (``_sat_obb``'s ``c`` and ``ac``). The kernels compute it once per
    (node, obstacle) pair for both of the node's boxes, which share
    ``rot``."""
    c = [rot[i] * orot[0][j] + rot[3 + i] * orot[1][j] + rot[6 + i] * orot[2][j]
         for i in range(3) for j in range(3)]
    return c, [torch.abs(v) + SAT_EPS for v in c]


def sat_separations(px, py, pz, rot, half, oc, oh, orot, frame=None):
    """The 15 separating-axis tests of a particle box (center p,
    rotation ``rot`` 9-tuple, half extents ``half``) against one scene
    box (center ``oc``, half ``oh``, rotation rows ``orot``), yielded one
    by one in the Pallas tile's op order (``_sat_obb``): the setup
    (:func:`sat_frame`, unless ``frame`` hands it in) and ``T`` run before
    the first. The kernels stop at the first true one (``utils/flops.py``
    counts the work that way)."""
    c, ac = sat_frame(rot, orot) if frame is None else frame
    dx, dy, dz = oc[0] - px, oc[1] - py, oc[2] - pz
    t = (rot[0] * dx + rot[3] * dy + rot[6] * dz,
         rot[1] * dx + rot[4] * dy + rot[7] * dz,
         rot[2] * dx + rot[5] * dy + rot[8] * dz)
    a, b = half, oh
    for i in range(3):
        rb = b[0] * ac[i * 3] + b[1] * ac[i * 3 + 1] + b[2] * ac[i * 3 + 2]
        yield torch.abs(t[i]) > a[i] + rb
    for j in range(3):
        ra = a[0] * ac[j] + a[1] * ac[3 + j] + a[2] * ac[6 + j]
        proj = t[0] * c[j] + t[1] * c[3 + j] + t[2] * c[6 + j]
        yield torch.abs(proj) > ra + b[j]
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            ra = a[i1] * ac[i2 * 3 + j] + a[i2] * ac[i1 * 3 + j]
            rb = b[j1] * ac[i * 3 + j2] + b[j2] * ac[i * 3 + j1]
            lhs = torch.abs(t[i2] * c[i1 * 3 + j] - t[i1] * c[i2 * 3 + j])
            yield lhs > ra + rb


def sat_obb(px, py, pz, rot, half, oc, oh, orot):
    """Do the particle boxes overlap one scene box? The OR of
    :func:`sat_separations`, negated; returns a bool tensor."""
    sep = None
    for hit in sat_separations(px, py, pz, rot, half, oc, oh, orot):
        sep = hit if sep is None else sep | hit
    return ~sep


def _box_frame(p, oc, orot):
    """Coordinates of points ``p`` (3-tuple) in a scene box's frame."""
    return [orot[0][i] * (p[0] - oc[0]) + orot[1][i] * (p[1] - oc[1])
            + orot[2][i] * (p[2] - oc[2]) for i in range(3)]


def _excess2(q, oh):
    """Sum over axes of max(|q_i| - h_i, 0)^2."""
    d2 = None
    for i in range(3):
        di = torch.clamp_min(torch.abs(q[i]) - oh[i], 0.0)
        d2 = di * di if d2 is None else d2 + di * di
    return d2


def point_obb_dist2_tile(p, oc, oh, orot):
    """Squared point -> scene-box distance (``_point_obb_dist2``)."""
    return _excess2(_box_frame(p, oc, orot), oh)


def seg_obb_dist2_frame(q0, q1, oh, iterations=SEGMENT_OBB_ITERATIONS):
    """Squared distance to the scene box of the segment whose end points
    have box-frame coordinates ``q0``, ``q1``: bisection on the monotone
    derivative (``_seg_obb_dist2`` after its two frame transforms).
    ``torch.sign(0) == 0``, as ``jnp.sign``: a box-frame coordinate of
    exactly 0 adds nothing."""
    b = [q1[i] - q0[i] for i in range(3)]

    def g(t):
        acc = None
        for i in range(3):
            qi = q0[i] + t * b[i]
            si = torch.sign(qi) * torch.clamp_min(torch.abs(qi) - oh[i], 0.0)
            acc = si * b[i] if acc is None else acc + si * b[i]
        return acc

    lo = torch.zeros_like(q0[0])
    hi = torch.ones_like(q0[0])
    for _ in range(iterations):
        tm = 0.5 * (lo + hi)
        pred = g(tm) > 0
        hi = torch.where(pred, tm, hi)
        lo = torch.where(pred, lo, tm)
    t = 0.5 * (lo + hi)
    return _excess2([q0[i] + t * b[i] for i in range(3)], oh)


def seg_obb_dist2_tile(p0, p1, oc, oh, orot, iterations=SEGMENT_OBB_ITERATIONS):
    """Squared segment -> scene-box distance (``_seg_obb_dist2``)."""
    return seg_obb_dist2_frame(_box_frame(p0, oc, orot), _box_frame(p1, oc, orot), oh,
                               iterations)


# The exact slab reject of the kernels' collider branches (csrc/fk_fitness.cuh,
# node_hits; the proof is there), mirrored op for op: it decides "no hit" for
# a (node, obstacle) pair ahead of the narrow phase, and only where the
# narrow phase says so. The plain twins (fk_fitness_plain and those built on
# it) evaluate the narrow phase alone; ``utils/flops.py::collider_work``
# follows the kernels' exits with these functions.
REJECT_TAU = _f32(2e-3)
REJECT_MAX_ANGLE = 12.5
REJECT_ABS = _f32(1e-15)
CAPSULE_SLACK = _f32(1e-4)
SQRT2 = _f32(1.41421356)
SQRT3 = _f32(1.73205081)


def box_reject_eps(num_nodes: int) -> float:
    """The box reject's relative slack for a chain of ``num_nodes``
    nodes, ``4e-3 + 5e-5 N`` rounded from double to float32."""
    return _f32(4e-3 + 5e-5 * num_nodes)


def box_frame_offset(p, oc, orot):
    """Box-frame coordinates of ``p`` as the kernels compute them
    (``box_frame``: ``d = p - c`` once, then ``q_i = column i of R . d``;
    the values of :func:`_box_frame`); returns ``(q, d)``."""
    d = [p[i] - oc[i] for i in range(3)]
    return [orot[0][i] * d[0] + orot[1][i] * d[1] + orot[2][i] * d[2] for i in range(3)], d


def l1_norm(v):
    """``(|v_0| + |v_1|) + |v_2|``: the scale of the rounding in ``v``."""
    return (torch.abs(v[0]) + torch.abs(v[1])) + torch.abs(v[2])


def slab_reject(q0, q1, oh, thr):
    """For some axis j, do the box-frame points ``q0_j`` and ``q1_j`` both
    lie beyond ``oh_j + thr`` on one side? (A point: ``q0 = q1``.)"""
    out = None
    for j in range(3):
        lo, hi = torch.minimum(q0[j], q1[j]), torch.maximum(q0[j], q1[j])
        sep = torch.maximum(lo, -hi) - oh[j] > thr
        out = sep if out is None else out | sep
    return out


def box_reject_slack(num_nodes: int, root, obs_rots):
    """The box reject's slack (:func:`box_reject_eps`), or +inf where the
    root rotation (9-tuple, row-major) is not orthonormal to
    ``REJECT_TAU`` or an axis of a scene box (``obs_rots``: each box's
    rotation rows) is not of unit length to it."""
    ok = None
    for i in range(3):
        row = 0.0
        for j in range(3):
            g = root[i] * root[j] + root[3 + i] * root[3 + j] + root[6 + i] * root[6 + j]
            row = row + torch.abs(g - 1.0 if i == j else g)
        ok = row <= REJECT_TAU if ok is None else ok & (row <= REJECT_TAU)
    for orot in obs_rots:
        for j in range(3):
            n2 = orot[0][j] * orot[0][j] + orot[1][j] * orot[1][j] + orot[2][j] * orot[2][j]
            ok = ok & (torch.abs(n2 - 1.0) <= REJECT_TAU)
    return torch.where(ok, box_reject_eps(num_nodes), float("inf"))


def reject_angles_in_range(ax, ay, az):
    """Are a node's three angles where the polynomial trig keeps the
    walk's rotations orthonormal enough for the box reject?"""
    return ((torch.abs(ax) <= REJECT_MAX_ANGLE) & (torch.abs(ay) <= REJECT_MAX_ANGLE)
            & (torch.abs(az) <= REJECT_MAX_ANGLE))


def box_reject_radii(pk, pp, slack, node_half, link_half):
    """A node's share of the box reject: ``|pk|_1 + |pp|_1`` and the cube's
    and the link box's radii, ``sqrt(3) |a| (1 + eps)``, ``sqrt(2) |w| (1 + eps)``."""
    pmag = l1_norm(pk) + l1_norm(pp)
    grow = 1.0 + slack
    return pmag, _f32(SQRT3 * abs(node_half)) * grow, _f32(SQRT2 * abs(link_half)) * grow


def box_pair_reject(pk, pp, oc, oh, orot, pmag, r_cube, r_link, slack):
    """Is the gizmo cube, and is the link box, separated from one scene
    box on one of its axes? ``(cube_sep, link_sep)``."""
    q1, d1 = box_frame_offset(pk, oc, orot)
    q0, d0 = box_frame_offset(pp, oc, orot)
    margin = slack * ((pmag + l1_norm(d1)) + l1_norm(d0)) + REJECT_ABS
    t_cube = r_cube + margin
    cube = None
    for j in range(3):
        sep = torch.abs(q1[j]) - oh[j] > t_cube
        cube = sep if cube is None else cube | sep
    return cube, slab_reject(q0, q1, oh, r_link + margin)


def capsule_reject_radius(link_r2: float) -> float:
    """The capsule reject's radius, ``sqrt(link_r2) (1 + 1e-4)``, in float32."""
    return _f32(np.sqrt(np.float32(link_r2)) * _f32(1.0 + CAPSULE_SLACK))


def capsule_pair_reject(q0, q1, oh, r_cap):
    """Is the link capsule separated from one scene box on one of its
    axes (box-frame end points ``q0``, ``q1``)?"""
    return slab_reject(q0, q1, oh,
                       r_cap + (CAPSULE_SLACK * (l1_norm(q0) + l1_norm(q1)) + REJECT_ABS))


def scene_constants(gizmo_size: float):
    """Collider sizes from ``gizmo_size``, each computed in double and
    rounded to float32 as the Pallas tile's constants are: box gizmo
    half extent, link box half width, node-sphere and link-capsule
    radius squared."""
    return (_f32(gizmo_size * 0.5), _f32(gizmo_size * 0.25 * 0.5),
            _f32((gizmo_size * 0.5) ** 2), _f32((gizmo_size * 0.125) ** 2))


class MetaLayout:
    """Offsets into the packed per-chain (meta) and per-swarm vectors.

    meta:  [aw, dw, len_1..len_{N-1}, w_e.., (center3 half3 rot9) x C]
    swarm: [root R (9), origin (3), anchor angles (D), targets (3E),
            anchor positions (3(N-1))]
    """

    def __init__(self, spec: ChainSpec, num_obstacles: int = 0,
                 use_orientation: bool = False):
        d = spec.dof
        e_count = spec.num_effectors
        num_joints = spec.num_nodes - 1
        self.OFF_LEN = 2
        self.OFF_EW = 2 + num_joints
        self.OFF_OBS = self.OFF_EW + e_count
        self.OFF_OW = self.OFF_OBS + 15 * num_obstacles
        self.meta_size = self.OFF_OW + (1 if use_orientation else 0)
        self.OFF_ROOT = 0
        self.OFF_ORIGIN = 9
        self.OFF_ANCHOR = 12
        self.OFF_TGT = 12 + d
        self.OFF_APOS = 12 + d + 3 * e_count
        self.OFF_TROT = self.OFF_APOS + 3 * num_joints
        self.swarm_size = self.OFF_TROT + (9 * e_count if use_orientation else 0)


def _check_branches(*, trig_impl="poly", collision_shape="box") -> None:
    if trig_impl not in ("poly", "exact"):
        raise ValueError(f"unknown trig_impl {trig_impl!r}; expected 'poly' or 'exact'")
    if collision_shape not in ("box", "capsule"):
        raise ValueError(
            f"unknown collision_shape {collision_shape!r}; expected 'box' or 'capsule'"
        )


def pack_meta(spec: ChainSpec, fit: FitnessConfig, obstacles: Obstacles = None,
              use_orientation: bool = False) -> torch.Tensor:
    """``(1, M)`` per-chain constants (``MetaLayout``): the weights, link
    lengths, effector weights, ``(center3, half3, rot9)`` per scene box
    and, with ``use_orientation``, the orientation weight last."""
    dev = spec.device
    weights = torch.tensor(
        [fit.angle_weight, fit.distance_weight], dtype=torch.float32, device=dev
    )
    parts = [weights, spec.length[1:],
             spec.effector_weight[effector_index(spec.effector_idx, dev)]]
    if obstacles is not None and obstacles.count > 0:
        parts.append(torch.cat(
            [obstacles.center, obstacles.half_extent,
             obstacles.rot.reshape(-1, 9)], dim=-1).to(dev).reshape(-1))
    if use_orientation:
        parts.append(torch.tensor([fit.orientation_weight], dtype=torch.float32,
                                  device=dev))
    return torch.cat(parts).to(torch.float32)[None, :]


def pack_swarm(spec: ChainSpec, problem: IKProblem, anchor_angles: torch.Tensor,
               anchor_positions: torch.Tensor,
               use_orientation: bool = False) -> torch.Tensor:
    """``(S, K)`` per-swarm constants (``MetaLayout``).

    ``anchor_positions`` may be the ``(S, N, 3)`` FK or the flat
    ``(S, 3*(N-1))`` non-root block (``pso.polish_soa.anchor_positions_flat``).
    ``use_orientation`` appends the ``9E`` row-major target rotation
    matrices of ``problem.target_rot``.
    """
    root_r = euler_xyz_to_matrix(problem.pose[..., 0, :])
    s = root_r.shape[0]
    ap = (
        anchor_positions[:, 1:].reshape(s, -1)
        if anchor_positions.dim() == 3
        else anchor_positions
    )
    parts = [
        root_r.reshape(s, 9),
        problem.origin.expand(s, 3),
        anchor_angles,
        problem.targets.reshape(s, -1),
        ap,
    ]
    if use_orientation:
        if problem.target_rot is None:
            raise ValueError("use_orientation requires problem.target_rot")
        parts.append(euler_xyz_to_matrix(problem.target_rot).reshape(s, -1))
    return torch.cat(parts, dim=-1).to(torch.float32).contiguous()


def _tile_hits(pk, pp, rk, length, obs, collision_shape, gizmo_size):
    """Does any node (positions pk, world rotations rk, parent positions
    pp, link lengths ``length`` -- the nodes on a trailing axis) hit any
    of the ``(C, 15)`` scene boxes ``obs``?

    Same arithmetic per (node, obstacle) pair as the Pallas tile's loop,
    vectorized: nodes, then for the box colliders the gizmo cube and the
    link box, then the obstacles ride trailing axes.
    """
    node_half, link_half, node_r2, link_r2 = scene_constants(gizmo_size)
    oc = tuple(obs[:, i] for i in range(3))
    oh = tuple(obs[:, 3 + i] for i in range(3))
    orot = tuple(tuple(obs[:, 6 + 3 * r + c] for c in range(3)) for r in range(3))
    if collision_shape == "capsule":
        p = tuple(v[..., None] for v in pk)
        q = tuple(v[..., None] for v in pp)
        return ((point_obb_dist2_tile(p, oc, oh, orot) <= node_r2)
                | (seg_obb_dist2_tile(q, p, oc, oh, orot) <= link_r2)).any(-1).any(-1)
    centers = [torch.stack([pk[i], (pk[i] + pp[i]) * 0.5], dim=-1)[..., None]
               for i in range(3)]
    rot = tuple(r[..., None, None] for r in rk)
    half = (torch.stack([torch.full_like(length, node_half), length * 0.5], -1)[..., None],
            torch.tensor([[node_half], [link_half]], device=length.device),
            torch.tensor([[node_half], [link_half]], device=length.device))
    return sat_obb(*centers, rot, half, oc, oh, orot).any(-1).any(-1).any(-1)


def _stack_nodes(per_node):
    """A list over nodes of equal-length tuples of broadcastable tensors
    -> one tuple of tensors with the nodes on a trailing axis."""
    return tuple(torch.stack(torch.broadcast_tensors(*vals), dim=-1)
                 for vals in zip(*per_node))


def fk_walk_tile(spec: ChainSpec, get_x, meta, sw, *, num_obstacles: int = 0,
                 use_orientation: bool = False, use_distance_term: bool = False,
                 trig_impl: str = "poly"):
    """The FK walk and the collision-free cost of a tile (plain torch):
    returns ``(rots, poss, total)``, the per-node world rotations
    (9-tuples) and positions (3-tuples) keyed by node, and the cost.
    Arguments as :func:`fk_fitness_tile`; ``num_obstacles`` places the
    orientation weight in ``meta``."""
    n = spec.num_nodes
    num_joints = n - 1
    eff_slot = {e: i for i, e in enumerate(spec.effector_idx)}
    lay = MetaLayout(spec, num_obstacles, use_orientation)

    aw = meta(0)
    rots = {0: tuple(sw(lay.OFF_ROOT + i) for i in range(9))}
    poss = {0: tuple(sw(lay.OFF_ORIGIN + i) for i in range(3))}
    rot_diff = 0.0
    pos_diff = 0.0
    cost = 0.0
    for k in range(1, n):
        d0 = 3 * (k - 1)
        ax, ay, az = get_x(d0), get_x(d0 + 1), get_x(d0 + 2)
        parent = spec.parent[k]
        rk = mat_mul(rots[parent], rot_xyz(ax, ay, az, trig_impl))
        length = meta(lay.OFF_LEN + (k - 1))
        pp = poss[parent]
        pk = (pp[0] + length * rk[0], pp[1] + length * rk[3],
              pp[2] + length * rk[6])
        rots[k] = rk
        poss[k] = pk

        da = ax - sw(lay.OFF_ANCHOR + d0)
        db = ay - sw(lay.OFF_ANCHOR + d0 + 1)
        dc = az - sw(lay.OFF_ANCHOR + d0 + 2)
        rot_diff = rot_diff + (da * da + db * db + dc * dc)

        if use_distance_term:
            # Node-position locality (pallas_fitness.py:335-339).
            ox = pk[0] - sw(lay.OFF_APOS + d0)
            oy = pk[1] - sw(lay.OFF_APOS + d0 + 1)
            oz = pk[2] - sw(lay.OFF_APOS + d0 + 2)
            pos_diff = pos_diff + (ox * ox + oy * oy + oz * oz)

        if k in eff_slot:
            e = eff_slot[k]
            w = meta(lay.OFF_EW + e)
            ex = pk[0] - sw(lay.OFF_TGT + 3 * e)
            ey = pk[1] - sw(lay.OFF_TGT + 3 * e + 1)
            ez = pk[2] - sw(lay.OFF_TGT + 3 * e + 2)
            cost = cost + w * (ex * ex + ey * ey + ez * ez)
            if use_orientation:
                ow = meta(lay.OFF_OW)
                fro = 0.0
                for i in range(9):
                    dr = rk[i] - sw(lay.OFF_TROT + 9 * e + i)
                    fro = fro + dr * dr
                cost = cost + ow * w * fro
    # Divide by a tensor: on the card torch divides by a Python number as a
    # multiply by its reciprocal, which can round one ulp off the kernels'
    # quotient (0.3 / 3 does) and fork a solve's trajectory.
    joints = aw.new_tensor(float(num_joints))
    total = cost + (aw / joints) * rot_diff
    if use_distance_term:
        total = total + (meta(1) / joints) * pos_diff
    return rots, poss, total


def fk_fitness_tile(spec: ChainSpec, get_x, meta, sw, *, obstacles=None,
                    collision_shape: str = "box", gizmo_size: float = 0.2,
                    use_orientation: bool = False, use_distance_term: bool = False,
                    trig_impl: str = "poly"):
    """FK rollout + cost for a tile of particles (plain torch).

    ``get_x(d)`` returns the angle tile of DOF ``d``; ``meta(i)`` /
    ``sw(i)`` read the packed per-chain / per-swarm constants, shaped
    to broadcast against the tile; ``obstacles`` is the ``(C, 15)``
    scene block of meta, or None; ``use_orientation`` adds the
    orientation term (meta and swarm in its ``MetaLayout``),
    ``use_distance_term`` the node-position locality term, and
    ``trig_impl`` picks the trig. Same arithmetic, in the same order, as
    ``ikpso_tpu/ops/pallas_fitness.py::fk_fitness_tile`` and the CUDA
    device function ``fk_fitness_eval`` (``csrc/fk_fitness.cuh``).
    """
    num_obstacles = 0 if obstacles is None else obstacles.shape[0]
    rots, poss, total = fk_walk_tile(spec, get_x, meta, sw, num_obstacles=num_obstacles,
                                     use_orientation=use_orientation,
                                     use_distance_term=use_distance_term,
                                     trig_impl=trig_impl)
    if obstacles is not None:
        # The hit test reads only FK outputs, so all nodes are tested in
        # one pass after the walk (the OR of the per-node hits).
        lay = MetaLayout(spec)
        nodes = range(1, spec.num_nodes)
        hit = _tile_hits(
            _stack_nodes([poss[k] for k in nodes]),
            _stack_nodes([poss[spec.parent[k]] for k in nodes]),
            _stack_nodes([rots[k] for k in nodes]),
            torch.stack([meta(lay.OFF_LEN + (k - 1)) for k in nodes]),
            obstacles, collision_shape, gizmo_size,
        )
        total = torch.where(hit, torch.full_like(total, COLLISION_PENALTY), total)
    return total


def check_meta(spec, meta, num_obstacles, use_orientation=False):
    """Raise unless ``meta`` has the layout of ``num_obstacles`` scene boxes
    (and the orientation weight, with ``use_orientation``)."""
    want = MetaLayout(spec, num_obstacles, use_orientation).meta_size
    if meta.numel() != want:
        raise ValueError(f"meta holds {meta.numel()} values; {num_obstacles} "
                         f"obstacles{' and orientation' if use_orientation else ''} "
                         f"need {want}")


def check_swarm(spec, swarm, num_obstacles, use_orientation):
    """Raise unless each ``swarm`` row holds every constant the tile reads."""
    want = MetaLayout(spec, num_obstacles, use_orientation).swarm_size
    if swarm.dim() != 2 or swarm.shape[1] < want:
        raise ValueError(f"swarm rows must hold {want} constants, got "
                         f"{tuple(swarm.shape)}")


def fk_fitness_plain(spec: ChainSpec, x: torch.Tensor, meta: torch.Tensor,
                     swarm: torch.Tensor, *, num_obstacles: int = 0,
                     collision_shape: str = "box", gizmo_size: float = 0.2,
                     use_distance_term: bool = False,
                     use_orientation: bool = False,
                     trig_impl: str = "poly") -> torch.Tensor:
    """``(S, P, D)`` angles -> ``(S, P)`` fitness, plain torch."""
    _check_branches(trig_impl=trig_impl, collision_shape=collision_shape)
    check_meta(spec, meta, num_obstacles, use_orientation)
    check_swarm(spec, swarm, num_obstacles, use_orientation)
    m = meta.reshape(-1)
    off = MetaLayout(spec).OFF_OBS
    obstacles = m[off:off + 15 * num_obstacles].reshape(-1, 15) if num_obstacles else None
    return fk_fitness_tile(
        spec, lambda d: x[..., d], lambda i: m[i], lambda i: swarm[:, i:i + 1],
        obstacles=obstacles, collision_shape=collision_shape, gizmo_size=gizmo_size,
        use_orientation=use_orientation, use_distance_term=use_distance_term,
        trig_impl=trig_impl,
    )


def _launch(name, spec, x, meta, swarm, num_obstacles, collision_shape, gizmo_size,
            use_orientation, use_distance_term, trig_impl, prebuilt, serial, on_demand):
    """Check what a kernel launch is handed (device, dtype, contiguity),
    pick its instantiation and launch it through the caller's
    ``prebuilt(lib, topo, collider, orient, scene)``, ``serial(lib)`` or
    ``on_demand(lib, scene)``."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for arg, t in (("x", x), ("meta", meta), ("swarm", swarm)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32")
    kernels.require_cuda_contiguous(name, x, meta, swarm)
    topo, collider, orient = kernels.kernel_variant(
        spec, num_obstacles, collision_shape, use_orientation, use_distance_term, trig_impl)
    scene = (num_obstacles, *scene_constants(gizmo_size))
    if topo == kernels.ON_DEMAND:
        key = kernels.on_demand_key(spec, collider, orient, use_distance_term,
                                    trig_impl == "exact")
        rc = on_demand(kernels.on_demand_library(key), scene)
    elif topo == kernels.SERIAL:
        rc = serial(kernels.library())
    else:
        rc = prebuilt(kernels.library(), topo, collider, orient, scene)
    kernels.check(rc, name)


def fk_fitness(spec: ChainSpec, x: torch.Tensor, meta: torch.Tensor,
               swarm: torch.Tensor, *, num_obstacles: int = 0,
               collision_shape: str = "box", gizmo_size: float = 0.2,
               use_distance_term: bool = False,
               use_orientation: bool = False,
               trig_impl: str = "poly") -> torch.Tensor:
    """Kernel B: ``(S, P, D)`` angles -> ``(S, P)`` fitness.

    A CPU tensor runs :func:`fk_fitness_plain`; a CUDA tensor launches
    the kernel (one thread per particle) or raises.
    """
    _check_branches(trig_impl=trig_impl, collision_shape=collision_shape)
    check_meta(spec, meta, num_obstacles, use_orientation)
    check_swarm(spec, swarm, num_obstacles, use_orientation)
    branches = dict(num_obstacles=num_obstacles, collision_shape=collision_shape,
                    gizmo_size=gizmo_size, use_orientation=use_orientation,
                    use_distance_term=use_distance_term, trig_impl=trig_impl)
    if x.device.type == "cpu":
        return fk_fitness_plain(spec, x, meta, swarm, **branches)
    s, p, d = x.shape
    if d != spec.dof or swarm.shape[0] != s:
        raise ValueError(f"fk_fitness: shapes x {tuple(x.shape)}, swarm "
                         f"{tuple(swarm.shape)} do not match dof {spec.dof}")
    meta = meta.reshape(-1)
    out = torch.empty((s, p), dtype=torch.float32, device=x.device)
    tail = (x.data_ptr(), meta.data_ptr(), swarm.data_ptr(), swarm.shape[1],
            out.data_ptr(), s * p, p, kernels.stream_ptr(x.device))
    _launch("fk_fitness", spec, x, meta, swarm, **branches,
            prebuilt=lambda lib, topo, collider, orient, scene: lib.ikpso_fk_fitness(
                topo, collider, orient, *scene, *tail),
            serial=lambda lib: lib.ikpso_fk_fitness_serial(spec.num_nodes, *tail),
            on_demand=lambda lib, scene: lib.ikpso_od_fk_fitness(*scene, *tail))
    fk_fitness.launches += 1
    return out


fk_fitness.launches = 0


def _check_lane_major(spec, x_dp, swarm):
    if x_dp.dim() != 3 or x_dp.shape[1] != spec.dof or swarm.shape[0] != x_dp.shape[0]:
        raise ValueError(f"fused_fitness: shapes x_dp {tuple(x_dp.shape)}, swarm "
                         f"{tuple(swarm.shape)} do not match (S, {spec.dof}, P)")


def fused_fitness_plain(spec: ChainSpec, x_dp: torch.Tensor, meta: torch.Tensor,
                        swarm: torch.Tensor, *, num_obstacles: int = 0,
                        collision_shape: str = "box", gizmo_size: float = 0.2,
                        use_distance_term: bool = False,
                        use_orientation: bool = False,
                        trig_impl: str = "poly") -> torch.Tensor:
    """``(S, D, P)`` lane-major angles -> ``(S, P)`` fitness, plain torch:
    :func:`fk_fitness_plain` on the ``(S, P, D)`` view of the same
    elements, so the arithmetic is the tile's."""
    _check_lane_major(spec, x_dp, swarm)
    return fk_fitness_plain(spec, x_dp.transpose(1, 2), meta, swarm,
                            num_obstacles=num_obstacles, collision_shape=collision_shape,
                            gizmo_size=gizmo_size, use_distance_term=use_distance_term,
                            use_orientation=use_orientation, trig_impl=trig_impl)


def fused_fitness(spec: ChainSpec, x_dp: torch.Tensor, meta: torch.Tensor,
                  swarm: torch.Tensor, *, num_obstacles: int = 0,
                  collision_shape: str = "box", gizmo_size: float = 0.2,
                  use_distance_term: bool = False,
                  use_orientation: bool = False,
                  trig_impl: str = "poly") -> torch.Tensor:
    """Kernel C: ``(S, D, P)`` angles -> ``(S, P)`` fitness, any P.

    A CPU tensor runs :func:`fused_fitness_plain`; a CUDA tensor launches
    the kernel (one thread per particle) or raises.
    """
    _check_branches(trig_impl=trig_impl, collision_shape=collision_shape)
    check_meta(spec, meta, num_obstacles, use_orientation)
    _check_lane_major(spec, x_dp, swarm)
    check_swarm(spec, swarm, num_obstacles, use_orientation)
    branches = dict(num_obstacles=num_obstacles, collision_shape=collision_shape,
                    gizmo_size=gizmo_size, use_orientation=use_orientation,
                    use_distance_term=use_distance_term, trig_impl=trig_impl)
    if x_dp.device.type == "cpu":
        return fused_fitness_plain(spec, x_dp, meta, swarm, **branches)
    s, _, p = x_dp.shape
    meta = meta.reshape(-1)
    out = torch.empty((s, p), dtype=torch.float32, device=x_dp.device)
    tail = (x_dp.data_ptr(), meta.data_ptr(), swarm.data_ptr(), swarm.shape[1],
            out.data_ptr(), s, p, kernels.stream_ptr(x_dp.device))
    _launch("fused_fitness", spec, x_dp, meta, swarm, **branches,
            prebuilt=lambda lib, topo, collider, orient, scene: lib.ikpso_fused_fitness(
                topo, collider, orient, *scene, *tail),
            serial=lambda lib: lib.ikpso_fused_fitness_serial(spec.num_nodes, *tail),
            on_demand=lambda lib, scene: lib.ikpso_od_fused_fitness(*scene, *tail))
    fused_fitness.launches += 1
    return out


fused_fitness.launches = 0


class KernelFitness:
    """Kernel C as the scan solver's ``fitness_fn``, with its packing.

    Called on ``(S, P, D)`` angles it transposes them to the lane-major
    ``(S, D, P)`` and calls :func:`fused_fitness`, as ``make_pallas_fitness``'s
    closure does. It carries what it packed -- ``spec``, ``meta``,
    ``swarm`` and the branch flags (``branches``: the keyword arguments of
    :func:`fused_fitness`) -- so that ``pso.solver.solve`` can run a whole
    iteration through the scan step (:meth:`launch_step`) on the card.
    """

    def __init__(self, spec: ChainSpec, meta: torch.Tensor, swarm: torch.Tensor,
                 branches: dict):
        self.spec, self.meta, self.swarm = spec, meta, swarm
        self.branches = dict(branches)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return fused_fitness(self.spec, x.transpose(-1, -2).contiguous(), self.meta,
                             self.swarm, **self.branches)

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """Kernel C's plain twin on the same packing (``(S, P, D)`` angles)."""
        return fused_fitness_plain(self.spec, x.transpose(-1, -2).contiguous(), self.meta,
                                   self.swarm, **self.branches)

    def configuration(self) -> str:
        """The topology and branches, as a refusal names them."""
        b = self.branches
        terms = [f"{b['num_obstacles']} {b['collision_shape']} obstacles"
                 if b["num_obstacles"] else "no scene"]
        terms += [t for t, on in (("orientation", b["use_orientation"]),
                                  ("distance term", b["use_distance_term"]),
                                  (f"{b['trig_impl']} trig", True)) if on]
        return f"{kernels.topology_name(self.spec)} ({', '.join(terms)})"

    def launch_step(self, x, v, lbest, lbest_val, draws, limits, gbest, gbest_val,
                    reduced, update, work) -> None:
        """Launch the scan step over the CUDA state (``pso.solver.scan_step``,
        which owns the launch count): ``draws`` is ``(u, seeds, n_draws,
        iteration)``, u the iteration's ``(n_draws, S, P, D)`` block for the
        replay step or None, seeds the ``(S, 2)`` int32 key words the drawing
        step draws from or None; ``update`` is ``(w, c1, c2, randomized,
        kick, kick_scale, kick_threshold)``, ``reduced`` the hook's
        ``(value, coordinates)`` outputs or None, ``work`` the
        ``(candidate values, candidate ids, arrivals)`` scratch."""
        u, seeds, n_draws, iteration = draws
        replay = u is not None
        name = f"scan_step ({'replay' if replay else 'drawing'}) for {self.configuration()}"
        s, p, _ = x.shape
        cand_val, cand_id, arrivals = work
        source = u if replay else seeds
        kernels.require_cuda_contiguous(name, x, v, lbest, lbest_val, source, limits, gbest,
                                        gbest_val, *work, *(reduced or ()))
        if not replay and (seeds.dtype != torch.int32 or tuple(seeds.shape) != (s, 2)):
            raise ValueError(f"{name}: seeds must be ({s}, 2) int32, got "
                             f"{tuple(seeds.shape)} {seeds.dtype}")
        red = (None, None) if reduced is None else tuple(t.data_ptr() for t in reduced)
        meta = self.meta.reshape(-1)
        tail = (meta.data_ptr(), self.swarm.data_ptr(), self.swarm.shape[1],
                limits.data_ptr(), x.data_ptr(), v.data_ptr(), lbest.data_ptr(),
                lbest_val.data_ptr(), int(replay), u.data_ptr() if replay else None,
                None if replay else seeds.data_ptr(), n_draws, iteration, gbest.data_ptr(),
                gbest_val.data_ptr(), *red, *update, cand_val.data_ptr(),
                cand_id.data_ptr(), cand_val.shape[1], arrivals.data_ptr(), s, p,
                kernels.stream_ptr(x.device))
        _launch(name, self.spec, x, meta, self.swarm, **self.branches,
                prebuilt=lambda lib, topo, collider, orient, scene: lib.ikpso_scan_step(
                    topo, collider, orient, *scene, *tail),
                serial=lambda lib: lib.ikpso_scan_step_serial(self.spec.num_nodes, *tail),
                on_demand=lambda lib, scene: lib.ikpso_od_scan_step(*scene, *tail))


def kernel_fitness_packer(spec: ChainSpec, fit: FitnessConfig = FitnessConfig(),
                          obstacles: Obstacles = None):
    """``problem -> KernelFitness``: :func:`make_kernel_fitness` for each
    problem, with the per-chain constants (:func:`pack_meta`) packed once
    for each value of the orientation flag they depend on, at the first
    call that needs it, and only the per-swarm ones packed each call.
    ``pack_meta`` ends in host copies that wait for the device's queue;
    the per-swarm packing queues device work alone."""
    num_obstacles = 0 if obstacles is None else obstacles.count
    if num_obstacles and fit.collision_backend == "gjk":
        raise NotImplementedError(
            "collision_backend='gjk': kernel C fuses only the closed-form 'sat' "
            "colliders, as JAX's kernel does; the scan solver runs GJK scenes on the "
            "plain fitness (--impl jnp, harness.trajectory.build_solver)"
        )
    use_distance = float(fit.distance_weight) != 0.0
    _check_branches(trig_impl=fit.trig_impl, collision_shape=fit.collision_shape)
    metas = {}

    def pack(problem: IKProblem) -> KernelFitness:
        use_orientation = (problem.target_rot is not None
                           and float(fit.orientation_weight) != 0.0)
        if use_orientation not in metas:
            metas[use_orientation] = pack_meta(spec, fit, obstacles, use_orientation)
        meta = metas[use_orientation].to(problem.pose.device)
        swarm = pack_swarm(spec, problem, fk_ops.pose_to_angles(spec, problem.pose),
                           fk_ops.fk_points(spec, problem.pose, problem.origin),
                           use_orientation)
        return KernelFitness(spec, meta, swarm, dict(
            num_obstacles=num_obstacles, collision_shape=fit.collision_shape,
            gizmo_size=fit.gizmo_size, use_orientation=use_orientation,
            use_distance_term=use_distance, trig_impl=fit.trig_impl))

    return pack


def make_kernel_fitness(spec: ChainSpec, problem: IKProblem,
                        fit: FitnessConfig = FitnessConfig(),
                        obstacles: Obstacles = None) -> KernelFitness:
    """A scan-solver ``fitness_fn`` backed by kernel C
    (``make_pallas_fitness``): a :class:`KernelFitness`, whose per-chain
    and per-swarm constants are packed once, here."""
    return kernel_fitness_packer(spec, fit, obstacles)(problem)
