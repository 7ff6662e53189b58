"""Solve results.

Port of ``ikpso_tpu/pso/solver.py::SolveResult`` only. The scan solver
(``init_swarm``, ``pso_iteration``, ``make_solver``) waits for ROADMAP
queue A item 4.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Output of one batched solve.

    Attributes:
      angles: ``(S, D)`` global-best joint angles per swarm.
      fitness: ``(S,)`` global-best fitness values.
      pose: ``(S, N, 3)`` the problem pose with the solution's joint rows.
      effector_error: ``(S,)`` summed Euclidean effector error.
      trace: ``(T, S)`` global-best fitness history (one row for the
        fused solver: the final value).
    """

    angles: torch.Tensor
    fitness: torch.Tensor
    pose: torch.Tensor
    effector_error: torch.Tensor
    trace: torch.Tensor
