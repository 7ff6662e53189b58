"""Fully-fused PSO solve: kernel A and its plain torch version.

Port of ``ikpso_tpu/pso/fused.py`` (``fused_solve_raw``,
``make_fused_solver``), main-path branch only:

  * ``fused_solve`` — kernel A (``csrc/fused_solve.cu``): one thread
    block per swarm, one thread per particle, the whole solve in
    registers; CPU tensors run ``fused_solve_plain`` instead;
  * ``fused_solve_plain`` — the same solve on ``(S, P, D)`` tensors,
    with ``torch.argmin`` (first occurrence) for gbest;
  * ``make_fused_solver`` — ``(problem, generator) -> SolveResult``.

Supported: ``inertia_mode="canonical"`` with or without
``inertia_end``, ``init_mode="warm"``, ``gbest_interval=1``,
``rekick_interval=0``, no obstacles / orientation / distance term.
Everything else raises (ROADMAP queue B item 1, branches (b) and (c)).
The TPU-only knobs (``swarms_per_tile``, ``gbest_mode``,
``const_mode``, VMEM gates, multi-row output) have no counterpart.

Random stream: per-swarm seed words ``(S, 2)`` int32 drawn from the
caller's ``torch.Generator``; the kernel's in-register Philox and
``ops.philox.philox_uniform`` produce the same bits from them. The
``uniforms`` replay input, ``(S, n_draws, D, P)``, replaces the
generator in both versions (the test hook).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.fitness_kernel import (
    MetaLayout,
    fk_fitness_plain,
    pack_meta,
    pack_swarm,
)
from ikpso_tpu_torch.ops.philox import philox_uniform
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.solver import SolveResult
from ikpso_tpu_torch.utils import kernels


def check_supported(pso: PSOConfig, fit: FitnessConfig, obstacles=None) -> None:
    """Refuse the branches kernel A does not implement yet."""
    reasons = []
    if pso.inertia_mode != "canonical":
        reasons.append(f"inertia_mode={pso.inertia_mode!r}")
    if pso.init_mode != "warm":
        reasons.append(f"init_mode={pso.init_mode!r}")
    if pso.gbest_interval != 1:
        reasons.append(f"gbest_interval={pso.gbest_interval}")
    if pso.rekick_interval:
        reasons.append(f"rekick_interval={pso.rekick_interval}")
    if reasons:
        raise NotImplementedError(
            "fused solver branch not ported yet: " + ", ".join(reasons)
            + " (ROADMAP queue B item 1, branch (b))"
        )
    if obstacles is not None or float(fit.distance_weight) != 0.0 or float(
        fit.orientation_weight
    ) != 0.0 or fit.trig_impl != "poly":
        raise NotImplementedError(
            "fused solver with obstacles, orientation, distance term or exact "
            "trig is not ported yet (ROADMAP queue B item 1, branch (c))"
        )


def num_draws(pso: PSOConfig) -> int:
    """Draw slots of one solve: the init velocity, then (u_c, u_s) per
    iteration."""
    return 1 + 2 * pso.iterations


def inertia_schedule(pso: PSOConfig) -> np.ndarray:
    """Per-iteration inertia, computed in double on the host and cast to
    float32 — what the interpreted JAX kernel's static unroll feeds in."""
    return np.asarray(
        [pso.inertia_at(it) for it in range(pso.iterations)], np.float64
    ).astype(np.float32)


def _check_args(spec, pso, swarm, limits, seeds, num_particles, uniforms):
    s = swarm.shape[0]
    d = spec.dof
    if num_particles % 32 or not 32 <= num_particles <= 1024:
        raise ValueError(
            f"num_particles={num_particles} must be a multiple of 32 in [32, 1024]"
        )
    if tuple(limits.shape) != (2, d):
        raise ValueError(f"limits must be (2, {d}), got {tuple(limits.shape)}")
    if tuple(seeds.shape) != (s, 2) or seeds.dtype != torch.int32:
        raise ValueError("seeds must be an (S, 2) int32 tensor")
    if uniforms is not None:
        want = (s, num_draws(pso), d, num_particles)
        if tuple(uniforms.shape) != want:
            raise ValueError(f"uniforms must be {want}, got {tuple(uniforms.shape)}")


def fused_solve_plain(
    spec: ChainSpec,
    pso: PSOConfig,
    fit: FitnessConfig,
    meta: torch.Tensor,
    swarm: torch.Tensor,
    limits: torch.Tensor,
    seeds: torch.Tensor,
    num_particles: int,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused solve on ``(S, P, D)`` tensors; returns ``(gbest (S, D),
    gval (S,))``. Same update order and rounding as kernel A."""
    check_supported(pso, fit)
    _check_args(spec, pso, swarm, limits, seeds, num_particles, uniforms)
    s, d, p = swarm.shape[0], spec.dof, num_particles

    def draw(slot):
        if uniforms is not None:
            return uniforms[:, slot].transpose(1, 2)
        return philox_uniform(seeds, slot, p, d)

    def fitness_of(x):
        return fk_fitness_plain(spec, x, meta, swarm)

    lay = MetaLayout(spec)
    lo, hi = limits[0], limits[1]
    rows = torch.arange(s, device=swarm.device)
    x = swarm[:, None, lay.OFF_ANCHOR:lay.OFF_ANCHOR + d].expand(s, p, d)
    v = (draw(0) * 2.0 - 1.0) * float(np.float32(pso.init_velocity_scale))
    lbest = x
    lval = fitness_of(x)
    c1, c2 = float(np.float32(pso.cognitive)), float(np.float32(pso.social))
    for it, w in enumerate(inertia_schedule(pso)):
        gb = lbest[rows, torch.argmin(lval, dim=1)][:, None, :]
        u_c = draw(1 + 2 * it)
        u_s = draw(2 + 2 * it)
        v = float(w) * v + c1 * u_c * (lbest - x) + c2 * u_s * (gb - x)
        x = torch.minimum(torch.maximum(x + v, lo), hi)
        f = fitness_of(x)
        better = f < lval
        lval = torch.where(better, f, lval)
        lbest = torch.where(better[..., None], x, lbest)
    win = torch.argmin(lval, dim=1)
    return lbest[rows, win], lval[rows, win]


def fused_solve(
    spec: ChainSpec,
    pso: PSOConfig,
    fit: FitnessConfig,
    meta: torch.Tensor,
    swarm: torch.Tensor,
    limits: torch.Tensor,
    seeds: torch.Tensor,
    num_particles: int,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A: one PSO solve per swarm; returns ``(gbest (S, D), gval (S,))``.

    CPU tensors run :func:`fused_solve_plain`; CUDA tensors launch the
    kernel or raise.
    """
    check_supported(pso, fit)
    _check_args(spec, pso, swarm, limits, seeds, num_particles, uniforms)
    if swarm.device.type == "cpu":
        return fused_solve_plain(spec, pso, fit, meta, swarm, limits, seeds,
                                 num_particles, uniforms)
    if swarm.device.type != "cuda":
        raise ValueError(f"fused_solve: unsupported device {swarm.device}")
    topo = kernels.topology_id(spec)
    dev = swarm.device
    s, d = swarm.shape[0], spec.dof
    meta = meta.reshape(-1).to(torch.float32).contiguous()
    swarm = swarm.to(torch.float32).contiguous()
    limits = limits.to(torch.float32).contiguous()
    seeds = seeds.contiguous()
    inertia = torch.as_tensor(inertia_schedule(pso), device=dev)
    tensors = [meta, swarm, limits, seeds, inertia]
    if uniforms is not None:
        uniforms = uniforms.to(torch.float32).contiguous()
        tensors.append(uniforms)
    kernels.require_cuda_contiguous("fused_solve", *tensors)
    gbest = torch.empty((s, d), dtype=torch.float32, device=dev)
    gval = torch.empty((s,), dtype=torch.float32, device=dev)
    rc = kernels.library().ikpso_fused_solve(
        topo, int(uniforms is not None),
        meta.data_ptr(), meta.numel(),
        swarm.data_ptr(), swarm.shape[1],
        limits.data_ptr(), seeds.data_ptr(), inertia.data_ptr(), pso.iterations,
        float(np.float32(pso.cognitive)), float(np.float32(pso.social)),
        float(np.float32(pso.init_velocity_scale)),
        None if uniforms is None else uniforms.data_ptr(), num_draws(pso),
        gbest.data_ptr(), gval.data_ptr(), s, num_particles,
        kernels.stream_ptr(dev),
    )
    kernels.check(rc, "fused_solve")
    fused_solve.launches += 1
    return gbest, gval


fused_solve.launches = 0


def make_fused_solver(
    spec: ChainSpec,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    num_particles: int = 1024,
    device="cpu",
    obstacles=None,
):
    """A ``(problem, generator) -> SolveResult`` running kernel A.

    Packs the constants as ``ikpso_tpu/pso/fused.py:759-764`` does,
    draws ``(S, 2)`` seed words from the generator, and computes the
    solved pose and the row-FK effector error.
    """
    check_supported(pso, fit, obstacles)
    from ikpso_tpu_torch.pso.polish_soa import (
        anchor_positions_flat,
        true_effector_error_rows,
    )

    device = torch.device(device)
    limits = spec.limits().to(device)
    meta = pack_meta(spec, fit).to(device)

    def _solve(problem: IKProblem, generator: torch.Generator) -> SolveResult:
        anchor_angles = fk_ops.pose_to_angles(spec, problem.pose)
        swarm = pack_swarm(spec, problem, anchor_angles,
                           anchor_positions_flat(spec, problem))
        s = swarm.shape[0]
        seeds = torch.randint(
            -2**31, 2**31, (s, 2), generator=generator,
            device=generator.device, dtype=torch.int32,
        ).to(device)
        gbest, gval = fused_solve(spec, pso, fit, meta, swarm, limits, seeds,
                                  num_particles)
        return SolveResult(
            angles=gbest,
            fitness=gval,
            pose=fk_ops.angles_to_pose(spec, problem.pose[..., 0, :], gbest),
            effector_error=true_effector_error_rows(spec, problem, gbest),
            trace=gval[None],
        )

    return _solve
