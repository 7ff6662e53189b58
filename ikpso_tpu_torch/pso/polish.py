"""Levenberg-Marquardt polish of PSO solutions.

Port of ``ikpso_tpu/pso/polish.py``: ``soa_traceable``, ``polish_angles``
(the SoA core of ``pso/polish_soa.py`` where ``soa_traceable`` holds, the
tensor-shaped path otherwise: the 45-DOF humanoid), ``residual_cost`` and
``wrap_with_polish`` (accept-if-better per swarm, gated on the true
effector error, or with ``locality_weight`` on the residual cost the
polish minimizes, and, with a scene, on the polished pose being
collision-free).

The tensor path keeps JAX's arithmetic: the analytic Jacobian
(``ops.jacobian.fk_with_jacobian``), the gradient-projection active set,
the dual ``(M, M)`` normal equations when ``M <= D`` (primal ``(D, D)``
otherwise), the unrolled Cholesky of ``_chol_solve`` in the same op
order, and the 0.1 / 1 / 10x damping race. JAX's einsums run at
``precision="highest"``; here they, and the FK's 3x3 composes
(``ops.fk``), are elementwise products summed in float32, so no TF32
setting of a caller reaches them. The sums run term by term in index
order (``_ordered_sum``) and the FK's trig in float64 (``ops.rotations``),
so the CPU and the GPU round as nearly alike as they can: near
convergence an LM step is accepted or refused on differences of a few
ulps, and a redundant chain (the humanoid) then moves along its null
space by up to ~2.4e-4 rad on one ulp of difference in its FK.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.collision import get_chain_collider
from ikpso_tpu_torch.ops.jacobian import fk_with_jacobian
from ikpso_tpu_torch.ops.rotations import euler_xyz_to_matrix
from ikpso_tpu_torch.pso.polish_soa import (
    _chol_solve_rows,
    polish_angles_soa,
    true_effector_error_rows,
)

DAMPING_RACE = (0.1, 1.0, 10.0)


def soa_traceable(spec: ChainSpec, d: int, use_orientation: bool) -> bool:
    """Whether the SoA LM core covers this model (same gate as JAX:
    few-effector chains up to 512 DOF, else m^2 * D <= 4000)."""
    e_rows = 3 * spec.num_effectors * (2 if use_orientation else 1)
    if e_rows <= 9 and d <= 512:
        return True
    return e_rows * e_rows * d <= 4000


def _ordered_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t.sum(dim)`` as one add per term in index order: a reduction
    kernel's order differs between devices."""
    parts = t.unbind(dim)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _vee_residual(re, rt_mat, weight):
    """``sqrt(weight) * 0.5 * vee(R Rt^T - Rt R^T)`` per effector: the
    world-frame rotation-vector residual, ``(..., E, 3)``."""
    m = _ordered_sum(re[..., :, :, None, :] * rt_mat[..., :, None, :, :], -1)
    vee = 0.5 * torch.stack([m[..., 2, 1] - m[..., 1, 2],
                             m[..., 0, 2] - m[..., 2, 0],
                             m[..., 1, 0] - m[..., 0, 1]], dim=-1)
    return math.sqrt(weight) * vee


def _chol_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve of ``(..., M, M)`` by ``(..., M)``: the unrolled
    Cholesky of JAX's ``_chol_solve``, every op elementwise over the
    batch."""
    m = a.shape[-1]
    x = _chol_solve_rows([[a[..., i, j] for j in range(m)] for i in range(m)],
                         [b[..., i] for i in range(m)])
    return torch.stack(x, dim=-1)


def _batched_residual(spec, problem, use_orientation, orientation_weight,
                      locality_weight):
    """``(..., S, D) -> (..., S, M)`` residual of a batched problem:
    weighted effector positions, optional rotation-vector rows, optional
    Tikhonov locality rows."""
    eff = list(spec.effector_idx)
    w_pos = torch.sqrt(spec.effector_weight[eff])
    root_rot = problem.pose[..., 0, :]
    rt_mat = euler_xyz_to_matrix(problem.target_rot) if use_orientation else None
    anchor = fk_ops.pose_to_angles(spec, problem.pose)

    def res_only(x):
        pos, rot = fk_ops.fk(spec, fk_ops.angles_to_pose(spec, root_rot, x),
                             problem.origin)
        r = ((pos[..., eff, :] - problem.targets) * w_pos[:, None]).flatten(-2)
        if use_orientation:
            ro = _vee_residual(rot[..., eff, :, :], rt_mat, orientation_weight)
            r = torch.cat([r, ro.flatten(-2)], dim=-1)
        if locality_weight:
            r = torch.cat([r, math.sqrt(locality_weight) * (x - anchor)], dim=-1)
        return r

    return res_only


def residual_cost(spec: ChainSpec, problem: IKProblem, angles: torch.Tensor, *,
                  use_orientation: bool = False, orientation_weight: float = 1.0,
                  locality_weight: float = 0.0) -> torch.Tensor:
    """``(S,)`` squared residual norm, the objective the polish minimizes."""
    r = _batched_residual(spec, problem, use_orientation, orientation_weight,
                          locality_weight)(angles)
    return _ordered_sum(r * r, -1)


def _polish_tensor(spec, problem, angles, *, steps, init_damping, use_orientation,
                   orientation_weight, locality_weight):
    """The tensor-shaped LM path (``ikpso_tpu/pso/polish.py:270-384``).
    The three damping candidates run as one ``(3, S, ...)`` batch: each of
    their ops is elementwise, so each candidate rounds as it would alone."""
    lo = spec.min_rotation[1:].reshape(-1)
    hi = spec.max_rotation[1:].reshape(-1)
    eff = list(spec.effector_idx)
    w_pos = torch.sqrt(spec.effector_weight[eff])
    root_rot = problem.pose[..., 0, :]
    d = angles.shape[-1]
    res_only = _batched_residual(spec, problem, use_orientation, orientation_weight,
                                 locality_weight)
    anchor = fk_ops.pose_to_angles(spec, problem.pose)
    sqrt_lw = math.sqrt(locality_weight) if locality_weight else None
    rt_mat = euler_xyz_to_matrix(problem.target_rot) if use_orientation else None
    row_w = w_pos.repeat_interleave(3)
    if use_orientation:
        row_w = torch.cat([row_w, torch.full((3 * len(eff),), math.sqrt(
            orientation_weight), dtype=row_w.dtype, device=row_w.device)])
    # Locked coordinates (min == max) and coordinates pinned at a bound and
    # pushed outward take none of the step (gradient-projection active set).
    free_static = hi > lo
    mults = torch.tensor(DAMPING_RACE, dtype=angles.dtype, device=angles.device)

    def res_from_fk(pe, re, x):
        r = ((pe - problem.targets) * w_pos[:, None]).flatten(-2)
        if use_orientation:
            r = torch.cat([r, _vee_residual(re, rt_mat, orientation_weight).flatten(-2)],
                          dim=-1)
        if locality_weight:
            r = torch.cat([r, sqrt_lw * (x - anchor)], dim=-1)
        return r

    x = angles
    lam = torch.full(angles.shape[:-1], init_damping, dtype=angles.dtype,
                     device=angles.device)
    for _ in range(steps):
        pe, re, j = fk_with_jacobian(spec, fk_ops.angles_to_pose(spec, root_rot, x),
                                     problem.origin, orientation=use_orientation)
        j = j * row_w[:, None]
        r = res_from_fk(pe, re, x)
        if locality_weight:
            eye = torch.eye(d, dtype=j.dtype, device=j.device)
            j = torch.cat([j, (sqrt_lw * eye).expand(x.shape[:-1] + (d, d))], dim=-2)
        g0 = _ordered_sum(j * r[..., :, None], -2)
        at_lo = (x <= lo + 1e-7) & (g0 > 0)
        at_hi = (x >= hi - 1e-7) & (g0 < 0)
        free = free_static & ~at_lo & ~at_hi
        j = j * free[..., None, :].to(j.dtype)
        m = j.shape[-2]
        lam_k = lam * mults[:, None]  # (3, S)
        if m <= d:
            # Dual (damped-least-squares) form: the minimum-norm step.
            jjt = _ordered_sum(j[..., :, None, :] * j[..., None, :, :], -1)
            a = jjt + lam_k[..., None, None] * torch.eye(m, dtype=x.dtype, device=x.device)
            y = _chol_solve(a, r.expand((3,) + r.shape))
            dx = -_ordered_sum(j * y[..., None], -2)
        else:
            h = _ordered_sum(j[..., :, :, None] * j[..., :, None, :], -3)
            a = h + lam_k[..., None, None] * torch.eye(d, dtype=x.dtype, device=x.device)
            dx = -_chol_solve(a, g0.expand((3,) + g0.shape))
        cands = torch.clamp(x + dx, lo, hi)  # (3, S, D)
        r_c = res_only(cands)
        errs = _ordered_sum(r_c * r_c, -1)  # (3, S)
        kbest = torch.argmin(errs, dim=0)
        ebest = errs.gather(0, kbest[None])[0]
        xbest = cands.gather(0, kbest[None, :, None].expand((1,) + x.shape))[0]
        lam_best = lam * mults[kbest]
        better = ebest < _ordered_sum(r * r, -1)
        x = torch.where(better[:, None], xbest, x)
        lam = torch.clamp(torch.where(better, lam_best * 0.5, lam * 10.0), 1e-8, 1e6)
    return x


def polish_angles(
    spec: ChainSpec,
    problem: IKProblem,
    angles: torch.Tensor,
    *,
    steps: int = 4,
    init_damping: float = 1e-3,
    use_orientation: bool = False,
    orientation_weight: float = 1.0,
    locality_weight: float = 0.0,
    soa: bool = True,
) -> torch.Tensor:
    """LM refinement of ``(S, D)`` per-swarm angles; each swarm's
    residual norm is non-increasing. ``soa`` and :func:`soa_traceable`
    route to the SoA core; otherwise the tensor path runs."""
    kw = dict(steps=steps, init_damping=init_damping, use_orientation=use_orientation,
              orientation_weight=orientation_weight, locality_weight=locality_weight)
    if soa and soa_traceable(spec, angles.shape[-1], use_orientation):
        return polish_angles_soa(spec, problem, angles, **kw)
    return _polish_tensor(spec, problem, angles, **kw)


def wrap_with_polish(
    solver,
    spec: ChainSpec,
    *,
    steps: int = 4,
    use_orientation: bool = False,
    orientation_weight: float = 1.0,
    init_damping: float = 1e-3,
    locality_weight: float = 0.0,
    obstacles=None,
    collision_backend: str = "sat",
    collision_shape: str = "box",
    gizmo_size: float = 0.2,
):
    """Wrap a ``(problem, generator) -> SolveResult`` solver with LM polish.

    The polished angles replace the PSO answer per swarm only where the
    gate metric does not get worse and, with ``obstacles``, where the
    polished pose is collision-free under the plain chain collider (the LM
    objective knows nothing of the scene); ``fitness`` and ``trace`` keep
    the PSO values. The gate metric is the true effector error, or with
    ``locality_weight`` the residual cost the polish minimizes
    (``ikpso_tpu/pso/polish.py:442-449``): position error may then trade
    against motion locality, as in the fitness.
    """
    collides = None
    if obstacles is not None:
        collides = get_chain_collider(collision_backend, collision_shape)
    cost_kw = dict(use_orientation=use_orientation, orientation_weight=orientation_weight,
                   locality_weight=locality_weight)

    def _solve(problem: IKProblem, generator: torch.Generator):
        base = solver(problem, generator)
        x = polish_angles(spec, problem, base.angles, steps=steps,
                          init_damping=init_damping, **cost_kw)
        pose = fk_ops.angles_to_pose(spec, problem.pose[..., 0, :], x)
        err = true_effector_error_rows(spec, problem, x)
        if locality_weight:
            take = (residual_cost(spec, problem, x, **cost_kw)
                    <= residual_cost(spec, problem, base.angles, **cost_kw))
        else:
            take = err <= base.effector_error
        if collides is not None:
            pos, rot = fk_ops.fk(spec, pose, problem.origin)
            take = take & ~collides(
                pos[..., 1:, :], rot[..., 1:, :, :], pos[..., list(spec.parent[1:]), :],
                spec.length[1:], obstacles.center, obstacles.half_extent,
                obstacles.rot, gizmo_size=gizmo_size)
        return dataclasses.replace(
            base,
            angles=torch.where(take[..., None], x, base.angles),
            pose=torch.where(take[..., None, None], pose, base.pose),
            effector_error=torch.where(take, err, base.effector_error),
        )

    return _solve
