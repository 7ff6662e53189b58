"""Levenberg-Marquardt polish of PSO solutions.

Port of ``ikpso_tpu/pso/polish.py``: ``soa_traceable``,
``polish_angles`` (dispatching to the SoA core only) and
``wrap_with_polish`` (accept-if-better per swarm, gated on the true
effector error). Not ported yet: the tensor-shaped LM path (models
where ``soa_traceable`` is false), the Tikhonov-locality gate and the
obstacle gate (ROADMAP queue A item 8).
"""

from __future__ import annotations

import dataclasses

import torch

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.pso.polish_soa import polish_angles_soa, true_effector_error_rows


def soa_traceable(spec: ChainSpec, d: int, use_orientation: bool) -> bool:
    """Whether the SoA LM core covers this model (same gate as JAX:
    few-effector chains up to 512 DOF, else m^2 * D <= 4000)."""
    e_rows = 3 * spec.num_effectors * (2 if use_orientation else 1)
    if e_rows <= 9 and d <= 512:
        return True
    return e_rows * e_rows * d <= 4000


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
) -> torch.Tensor:
    """LM refinement of ``(S, D)`` per-swarm angles; each swarm's
    residual norm is non-increasing."""
    if not soa_traceable(spec, angles.shape[-1], use_orientation):
        raise NotImplementedError(
            "the tensor-shaped LM polish (models too wide for the SoA core) is "
            "not ported yet (ROADMAP queue A item 8, the rest of the zoo)"
        )
    return polish_angles_soa(
        spec, problem, angles, steps=steps, init_damping=init_damping,
        locality_weight=locality_weight, use_orientation=use_orientation,
        orientation_weight=orientation_weight,
    )


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
):
    """Wrap a ``(problem, generator) -> SolveResult`` solver with LM polish.

    The polished angles replace the PSO answer per swarm only where the
    true effector error does not get worse; ``fitness`` and ``trace``
    keep the PSO values.
    """
    if obstacles is not None:
        raise NotImplementedError(
            "the polish collision gate is not ported yet "
            "(ROADMAP queue A item 8, obstacles)"
        )
    if locality_weight:
        raise NotImplementedError(
            "the locality-cost accept gate is not ported yet "
            "(ROADMAP queue A item 8, distance and locality terms)"
        )

    def _solve(problem: IKProblem, generator: torch.Generator):
        base = solver(problem, generator)
        x = polish_angles(
            spec, problem, base.angles, steps=steps, init_damping=init_damping,
            use_orientation=use_orientation, orientation_weight=orientation_weight,
        )
        pose = fk_ops.angles_to_pose(spec, problem.pose[..., 0, :], x)
        err = true_effector_error_rows(spec, problem, x)
        take = err <= base.effector_error
        return dataclasses.replace(
            base,
            angles=torch.where(take[..., None], x, base.angles),
            pose=torch.where(take[..., None, None], pose, base.pose),
            effector_error=torch.where(take, err, base.effector_error),
        )

    return _solve
