"""Structure-of-arrays LM polish core over ``(S,)`` rows.

Port of ``ikpso_tpu/pso/polish_soa.py``: ``polish_angles_soa``,
``true_effector_error_rows``, ``anchor_positions_flat`` and their row
helpers. The math is unrolled over the static topology so every
intermediate is one ``(S,)`` tensor; the FK composes rotation
components elementwise in float32. In JAX this is jnp outside any
Pallas kernel; here it is plain torch. The TPU padding chunker
(``_chunked_rows``) has no counterpart: GPU memory holds the unchunked
rows at the headline batch.

Residual rows: effector positions and optional Tikhonov locality rows.
The orientation rows wait (ROADMAP queue A item 8, orientation).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem
from ikpso_tpu_torch.ops.jacobian import ancestry_mask


def _euler_rows(ax, ay, az):
    """Rx@Ry@Rz components from (S,) angle rows: (9-list, (cos x, sin x))."""
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    return [
        cy * cz, -cy * sz, sy,
        cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy,
        sx * sz - cx * sy * cz, sx * cz + cx * sy * sz, cx * cy,
    ], (cx, sx)


def _matmul3_rows(a: Sequence, b: Sequence) -> List:
    """Row-major 9-component product of two row-list rotations."""
    out = []
    for i in range(3):
        for j in range(3):
            out.append(
                a[3 * i + 0] * b[0 + j]
                + a[3 * i + 1] * b[3 + j]
                + a[3 * i + 2] * b[6 + j]
            )
    return out


def _fk_rows(spec: ChainSpec, ang_rows, root_rows, origin_rows):
    """Unrolled FK over (S,) rows -> (pos, rot, cxsx) per node."""
    rot0, cs0 = _euler_rows(*root_rows)
    pos = [list(origin_rows)]
    rot = [rot0]
    cxsx = [cs0]
    for k in range(1, spec.num_nodes):
        p = spec.parent[k]
        local, cs = _euler_rows(
            ang_rows[3 * (k - 1)], ang_rows[3 * (k - 1) + 1],
            ang_rows[3 * (k - 1) + 2],
        )
        rk = _matmul3_rows(rot[p], local)
        lk = spec.length[k]
        pos.append([
            pos[p][0] + lk * rk[0],
            pos[p][1] + lk * rk[3],
            pos[p][2] + lk * rk[6],
        ])
        rot.append(rk)
        cxsx.append(cs)
    return pos, rot, cxsx


def _residual_rows(spec: ChainSpec, pos, targets_rows, w_sqrt):
    """M = 3E weighted position-residual rows."""
    rows = []
    for ei, node in enumerate(spec.effector_idx):
        for c in range(3):
            rows.append((pos[node][c] - targets_rows[ei][c]) * w_sqrt[ei])
    return rows


def _err2_rows(rows) -> torch.Tensor:
    s = rows[0] * rows[0]
    for r in rows[1:]:
        s = s + r * r
    return s


def _chol_solve_rows(a, b):
    """SPD solve on an MxM matrix of (S,) rows (unrolled Cholesky)."""
    m = len(b)
    low = [[None] * m for _ in range(m)]
    for i in range(m):
        for jc in range(i + 1):
            s = a[i][jc]
            for k in range(jc):
                s = s - low[i][k] * low[jc][k]
            if i == jc:
                low[i][jc] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                low[i][jc] = s / low[jc][jc]
    y = [None] * m
    for i in range(m):
        s = b[i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y[i] = s / low[i][i]
    x = [None] * m
    for i in reversed(range(m)):
        s = y[i]
        for k in range(i + 1, m):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return x


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def polish_angles_soa(
    spec: ChainSpec,
    problem: IKProblem,
    angles: torch.Tensor,
    *,
    steps: int,
    init_damping: float,
    locality_weight: float = 0.0,
    use_orientation: bool = False,
    orientation_weight: float = 1.0,
) -> torch.Tensor:
    """SoA-unrolled LM polish of ``(S, D)`` angles (position / locality rows).

    Same step as the JAX core: analytic Jacobian rows, a
    gradient-projection active set (locked dims and coordinates pinned
    at a bound being pushed outward), the dual ``(M, M)`` normal
    equations (primal ``(D, D)`` with locality or M > D), a damping
    race over 0.1/1/10x lambda, and per-swarm accept-if-better.
    """
    if use_orientation:
        raise NotImplementedError(
            "orientation rows of the LM polish are not ported yet "
            "(ROADMAP queue A item 8, orientation)"
        )
    del orientation_weight
    d = spec.dof
    eff = list(spec.effector_idx)
    e_count = len(eff)
    m = 3 * e_count
    lo_flat = spec.min_rotation[1:].reshape(-1)
    hi_flat = spec.max_rotation[1:].reshape(-1)
    lo = [lo_flat[k] for k in range(d)]
    hi = [hi_flat[k] for k in range(d)]
    free_dim = [hi[k] > lo[k] for k in range(d)]
    mask = ancestry_mask(spec)
    w_sqrt = [torch.sqrt(spec.effector_weight[node]) for node in eff]

    x = [angles[..., k] for k in range(d)]
    root_rows = [problem.pose[..., 0, c] for c in range(3)]
    origin_rows = [problem.origin[..., c] for c in range(3)]
    targets_rows = [
        [problem.targets[..., ei, c] for c in range(3)] for ei in range(e_count)
    ]
    lam = torch.full(x[0].shape, init_damping, dtype=angles.dtype,
                     device=angles.device)
    lw = float(locality_weight)
    anchor = [problem.pose[..., 1 + k // 3, k % 3] for k in range(d)] if lw else None

    def residual_at(x_rows):
        pos, _, _ = _fk_rows(spec, x_rows, root_rows, origin_rows)
        return _residual_rows(spec, pos, targets_rows, w_sqrt)

    def total_err2(x_rows, r_rows):
        s = _err2_rows(r_rows)
        if lw:
            for k in range(d):
                dk = x_rows[k] - anchor[k]
                s = s + lw * dk * dk
        return s

    zero = torch.zeros_like(x[0])
    for _ in range(steps):
        pos, rot, cxsx = _fk_rows(spec, x, root_rows, origin_rows)
        r = _residual_rows(spec, pos, targets_rows, w_sqrt)

        jac = [[None] * d for _ in range(m)]
        for k in range(1, spec.num_nodes):
            p = spec.parent[k]
            rp = rot[p]
            cx, sx = cxsx[k]
            axes = [
                (rp[0], rp[3], rp[6]),
                (
                    cx * rp[1] + sx * rp[2],
                    cx * rp[4] + sx * rp[5],
                    cx * rp[7] + sx * rp[8],
                ),
                (rot[k][2], rot[k][5], rot[k][8]),
            ]
            for ei, node in enumerate(eff):
                if mask[ei, k - 1] == 0.0:
                    continue
                dx0 = pos[node][0] - pos[p][0]
                dy0 = pos[node][1] - pos[p][1]
                dz0 = pos[node][2] - pos[p][2]
                for a in range(3):
                    wx, wy, wz = axes[a]
                    col = 3 * (k - 1) + a
                    we = w_sqrt[ei]
                    jac[3 * ei + 0][col] = we * (wy * dz0 - wz * dy0)
                    jac[3 * ei + 1][col] = we * (wz * dx0 - wx * dz0)
                    jac[3 * ei + 2][col] = we * (wx * dy0 - wy * dx0)
        for i in range(m):
            for kcol in range(d):
                if jac[i][kcol] is None:
                    jac[i][kcol] = zero

        g0 = [None] * d
        keep_row = [None] * d
        for kcol in range(d):
            g = jac[0][kcol] * r[0]
            for i in range(1, m):
                g = g + jac[i][kcol] * r[i]
            if lw:
                g = g + lw * (x[kcol] - anchor[kcol])
            g0[kcol] = g
            pinned = ((x[kcol] <= lo[kcol] + 1e-7) & (g > 0)) | (
                (x[kcol] >= hi[kcol] - 1e-7) & (g < 0)
            )
            keep = (~pinned & free_dim[kcol]).to(angles.dtype)
            keep_row[kcol] = keep
            for i in range(m):
                jac[i][kcol] = jac[i][kcol] * keep

        primal = bool(lw) or m > d
        if primal:
            h = [[None] * d for _ in range(d)]
            for kcol in range(d):
                for lcol in range(kcol + 1):
                    s = jac[0][kcol] * jac[0][lcol]
                    for i in range(1, m):
                        s = s + jac[i][kcol] * jac[i][lcol]
                    if kcol == lcol and lw:
                        s = s + lw * keep_row[kcol]
                    h[kcol][lcol] = s
                    h[lcol][kcol] = s
        else:
            jjt = [[None] * m for _ in range(m)]
            for i in range(m):
                for jr in range(i + 1):
                    s = jac[i][0] * jac[jr][0]
                    for kcol in range(1, d):
                        s = s + jac[i][kcol] * jac[jr][kcol]
                    jjt[i][jr] = s
                    jjt[jr][i] = s

        err_cur = total_err2(x, r)
        cand_x = []
        cand_e = []
        for mult in (0.1, 1.0, 10.0):
            lam_k = lam * mult
            xn = []
            if primal:
                a = [
                    [h[kc][lc] + lam_k if kc == lc else h[kc][lc] for lc in range(d)]
                    for kc in range(d)
                ]
                dx = _chol_solve_rows(a, g0)
                for kcol in range(d):
                    xn.append(_clip(x[kcol] - dx[kcol], lo[kcol], hi[kcol]))
            else:
                a = [
                    [jjt[i][jr] + lam_k if i == jr else jjt[i][jr] for jr in range(m)]
                    for i in range(m)
                ]
                y = _chol_solve_rows(a, r)
                for kcol in range(d):
                    dxk = jac[0][kcol] * y[0]
                    for i in range(1, m):
                        dxk = dxk + jac[i][kcol] * y[i]
                    xn.append(_clip(x[kcol] - dxk, lo[kcol], hi[kcol]))
            cand_x.append(xn)
            cand_e.append(total_err2(xn, residual_at(xn)))

        ebest = torch.minimum(torch.minimum(cand_e[0], cand_e[1]), cand_e[2])
        better = ebest < err_cur
        pick0 = cand_e[0] <= ebest
        pick1 = (~pick0) & (cand_e[1] <= ebest)
        lam_best = torch.where(pick0, lam * 0.1, torch.where(pick1, lam, lam * 10.0))
        for kcol in range(d):
            xk = torch.where(
                pick0, cand_x[0][kcol],
                torch.where(pick1, cand_x[1][kcol], cand_x[2][kcol]),
            )
            x[kcol] = torch.where(better, xk, x[kcol])
        lam = torch.clamp(
            torch.where(better, lam_best * 0.5, lam * 10.0), 1e-8, 1e6
        )
    return torch.stack(x, dim=-1)


def true_effector_error_rows(spec: ChainSpec, problem: IKProblem,
                             angles: torch.Tensor) -> torch.Tensor:
    """``(S,)`` sum of Euclidean effector distances through the row FK
    (same metric as ``ops.fitness.true_effector_error``)."""
    d = angles.shape[-1]
    origin = problem.origin.expand(angles.shape[:-1] + (3,))
    pos, _, _ = _fk_rows(
        spec,
        [angles[..., k] for k in range(d)],
        [problem.pose[..., 0, c] for c in range(3)],
        [origin[..., c] for c in range(3)],
    )
    err = None
    for ei, node in enumerate(spec.effector_idx):
        s2 = None
        for c in range(3):
            dc = pos[node][c] - problem.targets[..., ei, c]
            s2 = dc * dc if s2 is None else s2 + dc * dc
        e = torch.sqrt(s2)
        err = e if err is None else err + e
    return err


def anchor_positions_flat(spec: ChainSpec, problem: IKProblem) -> torch.Tensor:
    """``(S, 3*(N-1))`` non-root node positions of the problem's pose."""
    n = spec.num_nodes
    pose = problem.pose
    origin = problem.origin.expand(pose.shape[:-2] + (3,))
    pos, _, _ = _fk_rows(
        spec,
        [pose[..., k, c] for k in range(1, n) for c in range(3)],
        [pose[..., 0, c] for c in range(3)],
        [origin[..., c] for c in range(3)],
    )
    return torch.stack([pos[k][c] for k in range(1, n) for c in range(3)], dim=-1)
