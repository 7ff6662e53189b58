"""Fused FK + fitness: the plain torch tile and kernel B's wrapper.

Port of ``ikpso_tpu/ops/pallas_fitness.py`` (renamed: the kernel here
is CUDA, not Pallas). It holds the tile arithmetic the fused solver
inlines — ``sincos_poly`` (``_sincos``), ``rot_xyz`` (``_rot_xyz``),
``mat_mul`` (``_mat_mul``) — the packed-constant layout
(``MetaLayout``, ``pack_meta``, ``pack_swarm``), and the two versions
of ``fk_fitness_tile`` over an ``(S, P, D)`` angle tensor:

  * ``fk_fitness_plain`` — plain torch, op for op the Pallas tile body;
  * ``fk_fitness`` — kernel B (``csrc/fk_fitness.cuh`` device function
    + ``csrc/fk_fitness.cu`` launcher) on CUDA tensors, the plain
    version on CPU tensors.

Supported in this port: the FK tree walk, polynomial trig, the weighted
effector cost and the angular-locality term. The node-position
(distance) term, the orientation term, obstacles and
``trig_impl="exact"`` raise (ROADMAP queue B item 2, kernel B's
remaining branches). The standalone fitness kernel C
(``fused_fitness`` / ``make_pallas_fitness``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem
from ikpso_tpu_torch.ops.fitness import FitnessConfig
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


def rot_xyz(ax, ay, az):
    """Rx@Ry@Rz from elementwise angle tensors -> 9 row-major entries."""
    sx, cx = sincos_poly(ax)
    sy, cy = sincos_poly(ay)
    sz, cz = sincos_poly(az)
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


def _refuse_unported(*, num_obstacles=0, use_distance_term=False,
                     use_orientation=False, trig_impl="poly") -> None:
    if num_obstacles:
        raise NotImplementedError(
            "obstacle rejection in the fitness tile is not ported yet "
            "(ROADMAP queue B item 2: SAT / capsule branches)"
        )
    if use_distance_term:
        raise NotImplementedError(
            "the node-position locality (distance) term is not ported yet "
            "(ROADMAP queue B item 2)"
        )
    if use_orientation:
        raise NotImplementedError(
            "the orientation term is not ported yet (ROADMAP queue B item 2)"
        )
    if trig_impl != "poly":
        raise NotImplementedError(
            f"trig_impl={trig_impl!r}: the port's tile implements the "
            "polynomial sincos only (ROADMAP queue B item 2)"
        )


def pack_meta(spec: ChainSpec, fit: FitnessConfig, obstacles=None,
              use_orientation: bool = False) -> torch.Tensor:
    """``(1, M)`` per-chain constants (``MetaLayout``)."""
    _refuse_unported(num_obstacles=0 if obstacles is None else 1,
                     use_orientation=use_orientation)
    dev = spec.device
    weights = torch.tensor(
        [fit.angle_weight, fit.distance_weight], dtype=torch.float32, device=dev
    )
    return torch.cat(
        [weights, spec.length[1:], spec.effector_weight[list(spec.effector_idx)]]
    ).to(torch.float32)[None, :]


def pack_swarm(spec: ChainSpec, problem: IKProblem, anchor_angles: torch.Tensor,
               anchor_positions: torch.Tensor,
               use_orientation: bool = False) -> torch.Tensor:
    """``(S, K)`` per-swarm constants (``MetaLayout``).

    ``anchor_positions`` may be the ``(S, N, 3)`` FK or the flat
    ``(S, 3*(N-1))`` non-root block (``pso.polish_soa.anchor_positions_flat``).
    """
    _refuse_unported(use_orientation=use_orientation)
    root_r = euler_xyz_to_matrix(problem.pose[..., 0, :])
    s = root_r.shape[0]
    ap = (
        anchor_positions[:, 1:].reshape(s, -1)
        if anchor_positions.dim() == 3
        else anchor_positions
    )
    return torch.cat(
        [
            root_r.reshape(s, 9),
            problem.origin.expand(s, 3),
            anchor_angles,
            problem.targets.reshape(s, -1),
            ap,
        ],
        dim=-1,
    ).to(torch.float32).contiguous()


def fk_fitness_tile(spec: ChainSpec, get_x, meta, sw):
    """FK rollout + cost for a tile of particles (plain torch).

    ``get_x(d)`` returns the angle tile of DOF ``d``; ``meta(i)`` /
    ``sw(i)`` read the packed per-chain / per-swarm constants, shaped
    to broadcast against the tile. Same arithmetic, in the same order,
    as ``ikpso_tpu/ops/pallas_fitness.py::fk_fitness_tile`` and the
    CUDA device function ``fk_fitness_eval`` (``csrc/fk_fitness.cuh``).
    """
    n = spec.num_nodes
    num_joints = n - 1
    eff_slot = {e: i for i, e in enumerate(spec.effector_idx)}
    lay = MetaLayout(spec)

    aw = meta(0)
    rots = {0: tuple(sw(lay.OFF_ROOT + i) for i in range(9))}
    poss = {0: tuple(sw(lay.OFF_ORIGIN + i) for i in range(3))}
    rot_diff = 0.0
    cost = 0.0
    for k in range(1, n):
        d0 = 3 * (k - 1)
        ax, ay, az = get_x(d0), get_x(d0 + 1), get_x(d0 + 2)
        parent = spec.parent[k]
        rk = mat_mul(rots[parent], rot_xyz(ax, ay, az))
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

        if k in eff_slot:
            e = eff_slot[k]
            w = meta(lay.OFF_EW + e)
            ex = pk[0] - sw(lay.OFF_TGT + 3 * e)
            ey = pk[1] - sw(lay.OFF_TGT + 3 * e + 1)
            ez = pk[2] - sw(lay.OFF_TGT + 3 * e + 2)
            cost = cost + w * (ex * ex + ey * ey + ez * ez)
    return cost + (aw / num_joints) * rot_diff


def fk_fitness_plain(spec: ChainSpec, x: torch.Tensor, meta: torch.Tensor,
                     swarm: torch.Tensor, *, num_obstacles: int = 0,
                     use_distance_term: bool = False,
                     use_orientation: bool = False,
                     trig_impl: str = "poly") -> torch.Tensor:
    """``(S, P, D)`` angles -> ``(S, P)`` fitness, plain torch."""
    _refuse_unported(num_obstacles=num_obstacles,
                     use_distance_term=use_distance_term,
                     use_orientation=use_orientation, trig_impl=trig_impl)
    m = meta.reshape(-1)
    return fk_fitness_tile(
        spec, lambda d: x[..., d], lambda i: m[i], lambda i: swarm[:, i:i + 1]
    )


def fk_fitness(spec: ChainSpec, x: torch.Tensor, meta: torch.Tensor,
               swarm: torch.Tensor, *, num_obstacles: int = 0,
               use_distance_term: bool = False,
               use_orientation: bool = False,
               trig_impl: str = "poly") -> torch.Tensor:
    """Kernel B: ``(S, P, D)`` angles -> ``(S, P)`` fitness.

    A CPU tensor runs :func:`fk_fitness_plain`; a CUDA tensor launches
    the kernel (one thread per particle) or raises.
    """
    _refuse_unported(num_obstacles=num_obstacles,
                     use_distance_term=use_distance_term,
                     use_orientation=use_orientation, trig_impl=trig_impl)
    if x.device.type == "cpu":
        return fk_fitness_plain(spec, x, meta, swarm)
    if x.device.type != "cuda":
        raise ValueError(f"fk_fitness: unsupported device {x.device}")
    s, p, d = x.shape
    if d != spec.dof or swarm.shape[0] != s:
        raise ValueError(f"fk_fitness: shapes x {tuple(x.shape)}, swarm "
                         f"{tuple(swarm.shape)} do not match dof {spec.dof}")
    for name, t in (("x", x), ("meta", meta), ("swarm", swarm)):
        if t.dtype != torch.float32:
            raise ValueError(f"fk_fitness: {name} must be float32")
    topo = kernels.topology_id(spec)
    meta = meta.reshape(-1)
    kernels.require_cuda_contiguous("fk_fitness", x, meta, swarm)
    out = torch.empty((s, p), dtype=torch.float32, device=x.device)
    rc = kernels.library().ikpso_fk_fitness(
        topo, x.data_ptr(), meta.data_ptr(), swarm.data_ptr(), swarm.shape[1],
        out.data_ptr(), s * p, p, kernels.stream_ptr(x.device),
    )
    kernels.check(rc, "fk_fitness")
    fk_fitness.launches += 1
    return out


fk_fitness.launches = 0
