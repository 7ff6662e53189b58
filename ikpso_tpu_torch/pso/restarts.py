"""Top-k retries of the worst swarms.

Port of ``ikpso_tpu/pso/restarts.py``: ``wrap_with_topk_retries`` and
``make_topk_retry_solver``. Each round re-solves the ``bucket`` swarms
with the largest effector error from the ORIGINAL problem pose
(``retry_start="problem"``) and keeps a retry row only where it is
better and the previous row had not converged, so converged swarms stay
bit-stable: ``better = (retry < prev) & (prev > threshold)``.

The port has no tiles, so the bucket alignment is the identity; bucket
decay is kept. Retry streams continue the caller's generator (the base
solve draws first). Walk retries (``wrap_solver_with_target_walk``) and
the host-gather ``solve_with_retries`` are not ported yet (ROADMAP
queue A item 8).
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Callable, List, Optional, Sequence, Union

import torch

from ikpso_tpu_torch.models.chain import IKProblem
from ikpso_tpu_torch.pso.solver import SolveResult

Solver = Callable[[IKProblem, torch.Generator], SolveResult]


def bucket_schedule(bucket: int, rounds: int, bucket_decay: int = 1) -> List[int]:
    """Per-round bucket sizes: ``bucket // decay**r`` floored at
    ``min(bucket, 1024)`` (constant when ``bucket_decay`` is 1)."""
    if bucket_decay > 1:
        return [
            max(1, max(min(bucket, 1024), bucket // bucket_decay**r))
            for r in range(rounds)
        ]
    return [max(1, bucket)] * rounds


def worst_indices(err: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest errors, ties in ascending index order
    (the order ``jax.lax.top_k`` returns; ``torch.topk`` promises none)."""
    return torch.sort(err, descending=True, stable=True).indices[:k]


def wrap_with_topk_retries(
    build: Callable,
    pso,
    *,
    rounds: int,
    bucket: int,
    err_threshold: float = 1e-3,
    retry_init_mode: Optional[str] = None,
    retry_iterations: Optional[int] = None,
    retry_walk_steps: int = 0,
    bucket_decay: int = 1,
) -> Solver:
    """Build a solver with ``build(pso_config)`` and wrap it in top-k
    retries; ``retry_init_mode`` / ``retry_iterations`` give the retry
    rounds their own solver."""
    if retry_walk_steps:
        raise NotImplementedError(
            "walk retries are not ported yet (ROADMAP queue A item 8)"
        )
    solver = build(pso)
    if not rounds:
        return solver
    retry_cfg = {}
    if retry_init_mode and retry_init_mode != pso.init_mode:
        retry_cfg["init_mode"] = retry_init_mode
    if retry_iterations and retry_iterations != pso.iterations:
        retry_cfg["iterations"] = retry_iterations
        if pso.rekick_interval and retry_iterations % pso.rekick_interval:
            retry_cfg["rekick_interval"] = 0
    retry_solver = build(dataclasses.replace(pso, **retry_cfg)) if retry_cfg else None
    return make_topk_retry_solver(
        solver, err_threshold=err_threshold, rounds=rounds,
        bucket=bucket_schedule(bucket, rounds, bucket_decay),
        retry_solver=retry_solver,
    )


def make_topk_retry_solver(
    solver: Solver,
    *,
    bucket: Union[int, Sequence[int]] = 1024,
    err_threshold: float = 1e-3,
    rounds: int = 1,
    retry_solver: Optional[Solver] = None,
    retry_start: str = "problem",
) -> Solver:
    """Base solve plus ``rounds`` re-solves of the worst ``bucket`` swarms,
    merged on device."""
    if retry_start != "problem":
        raise NotImplementedError(
            f"retry_start={retry_start!r}: only 'problem' is ported (retries "
            "from the current best lose rescues: ikpso_tpu/pso/restarts.py:343-356)"
        )
    retry_solver_ = retry_solver or solver
    buckets = (
        [int(bucket)] * rounds
        if isinstance(bucket, numbers.Integral)
        else [int(b) for b in bucket]
    )
    if len(buckets) < rounds:
        buckets += [buckets[-1]] * (rounds - len(buckets))

    def _solve(problem: IKProblem, generator: torch.Generator) -> SolveResult:
        res = solver(problem, generator)
        s = res.effector_error.shape[0]
        # One copy up front; later rounds then write rows in place.
        out = {f: getattr(res, f).clone() for f in
               ("angles", "fitness", "pose", "effector_error")}
        for rnd in range(rounds):
            worst = worst_indices(out["effector_error"], min(buckets[rnd], s))
            retry = retry_solver_(problem.take(worst), generator)
            prev_err = out["effector_error"][worst]
            better = (retry.effector_error < prev_err) & (prev_err > err_threshold)
            rows = worst[better]
            for f in out:
                out[f][rows] = getattr(retry, f)[better]
        return SolveResult(trace=res.trace, **out)

    return _solve
