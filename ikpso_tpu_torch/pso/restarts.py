"""Retries of failed swarms: host-gather buckets and top-k rounds.

Port of ``ikpso_tpu/pso/restarts.py``:

  * ``solve_with_retries`` / ``make_retry_solver``: the exact failure set
    (effector error above the threshold) is read on the host after each
    round and re-solved in fixed-size buckets, the last one padded by
    repeating its first failed index; a retry row replaces the base row
    where it is better, under a first-occurrence mask so the padding
    cannot write twice;
  * ``wrap_with_topk_retries`` / ``make_topk_retry_solver``: each round
    re-solves the ``bucket`` swarms with the largest effector error, from
    the problem's pose (``retry_start="problem"``) or from the current
    best (``"best"``, which loses rescues: ``ikpso_tpu/pso/restarts.py:343-356``),
    and keeps a retry row only where it is better and the previous row
    had not converged, so converged swarms stay bit-stable:
    ``better = (retry < prev) & (prev > threshold)``.

The port has no tiles, so the bucket alignment is the identity; bucket
decay is kept. Retry streams continue the caller's generator (the base
solve draws first, then each retry call in turn) where JAX splits its key.
``wrap_solver_with_target_walk`` makes a retry round a W-step warm target
walk (``retry_walk_steps``).
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ikpso_tpu_torch.models.chain import IKProblem
from ikpso_tpu_torch.ops.fk import fk_points
from ikpso_tpu_torch.pso.solver import SolveResult

Solver = Callable[[IKProblem, torch.Generator], SolveResult]


def _gather_problem(problem: IKProblem, idx: np.ndarray) -> IKProblem:
    return problem.take(torch.as_tensor(idx, device=problem.pose.device))


def _scatter_better(base: SolveResult, retry: SolveResult, idx: np.ndarray,
                    take: np.ndarray) -> SolveResult:
    """``base`` with row ``idx[i]`` replaced by retry row ``i`` wherever
    ``take[i]``; the caller makes ``idx[take]`` duplicate-free."""
    if not take.any():
        return base
    dev = base.angles.device
    rows = torch.as_tensor(idx[take], device=dev)
    src = torch.as_tensor(np.flatnonzero(take), device=dev)

    def merge(b, r):
        b = b.clone()
        b[rows] = r[src]
        return b

    return SolveResult(
        angles=merge(base.angles, retry.angles),
        fitness=merge(base.fitness, retry.fitness),
        pose=merge(base.pose, retry.pose),
        effector_error=merge(base.effector_error, retry.effector_error),
        trace=base.trace,
    )


def solve_with_retries(
    solver: Solver,
    problem: IKProblem,
    generator: torch.Generator,
    *,
    err_threshold: float = 1e-3,
    max_rounds: int = 1,
    bucket: int = 1024,
    retry_solver: Optional[Solver] = None,
) -> SolveResult:
    """Base solve plus up to ``max_rounds`` rounds over the failed swarms.

    Each round reads the effector errors on the host, gathers the swarms
    above ``err_threshold`` into ``ceil(n / bucket)`` buckets of exactly
    ``bucket`` rows (the last padded with its first failed index) and
    re-solves each with ``retry_solver`` (default ``solver``); every call
    continues ``generator``. A retry row is kept where its error is below
    the current one, at the first occurrence of its index in the bucket.
    """
    res = solver(problem, generator)
    retry_solver = retry_solver or solver
    bucket = max(1, min(bucket, int(problem.batch_shape()[0])))
    for _ in range(max_rounds):
        err = res.effector_error.cpu().numpy()
        failed = np.flatnonzero(err > err_threshold)
        if failed.size == 0:
            break
        for start in range(0, failed.size, bucket):
            chunk = failed[start:start + bucket]
            idx = np.full((bucket,), chunk[0], dtype=np.int64)
            idx[:chunk.size] = chunk
            retry = retry_solver(_gather_problem(problem, idx), generator)
            take = retry.effector_error.cpu().numpy() < err[idx]
            first = np.zeros((bucket,), bool)
            first[np.unique(idx, return_index=True)[1]] = True
            take &= first
            res = _scatter_better(res, retry, idx, take)
            err = res.effector_error.cpu().numpy()
    return res


def make_retry_solver(solver: Solver, **retry_kwargs) -> Solver:
    """``solver`` wrapped with :func:`solve_with_retries`."""

    def _solve(problem: IKProblem, generator: torch.Generator) -> SolveResult:
        return solve_with_retries(solver, problem, generator, **retry_kwargs)

    return _solve


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


def wrap_solver_with_target_walk(solver: Solver, spec, steps: int,
                                 jitter: float = 0.0) -> Solver:
    """Re-solve by a ``steps``-step warm target walk instead of one jump.

    The targets move from the problem pose's effector positions to the
    true targets in ``steps`` equal fractions; each step re-solves warm
    from the previous step's pose, and the last step, at the true
    targets, returns the result (``ikpso_tpu/pso/restarts.py:124-199``).
    Orientation targets stay fixed. ``jitter`` > 0 offsets each
    intermediate waypoint by a standard normal draw (from the caller's
    generator) times ``jitter * 4 f (1 - f)`` times the effector's
    start-to-target distance, so each call walks another curved path
    that still starts at the pose and ends at the targets.
    """
    if steps < 1:
        raise ValueError(f"target walk needs steps >= 1, got {steps}")
    eff = list(spec.effector_idx)

    def _solve(problem: IKProblem, generator: torch.Generator) -> SolveResult:
        if steps > 1:
            start = fk_points(spec, problem.pose, problem.origin)[:, eff, :]
            span = torch.linalg.norm(problem.targets - start, dim=-1, keepdim=True)
            pose = problem.pose
            for i in range(1, steps):
                f = float(np.float32(i) / np.float32(steps))
                tgt = start + f * (problem.targets - start)
                if jitter:
                    off = torch.randn(start.shape, generator=generator,
                                      device=generator.device).to(start.device)
                    tgt = tgt + (jitter * 4.0 * f * (1.0 - f)) * span * off
                pose = solver(problem.replace(pose=pose, targets=tgt), generator).pose
            problem = problem.replace(pose=pose)
        return solver(problem, generator)

    return _solve


def wrap_with_topk_retries(
    build: Callable,
    pso,
    *,
    rounds: int,
    bucket: int,
    err_threshold: float = 1e-3,
    retry_init_mode: Optional[str] = None,
    retry_iterations: Optional[int] = None,
    spec=None,
    retry_walk_steps: int = 0,
    retry_walk_jitter: float = 0.0,
    bucket_decay: int = 1,
) -> Solver:
    """Build a solver with ``build(pso_config)`` and wrap it in top-k
    retries; ``retry_init_mode`` / ``retry_iterations`` give the retry
    rounds their own solver. ``retry_walk_steps=W`` (needs ``spec``)
    makes each retry round a W-step warm target walk
    (:func:`wrap_solver_with_target_walk`) from the problem's pose; a walk
    needs its warm start, so it ignores ``retry_init_mode``."""
    if retry_walk_steps and spec is None:
        raise ValueError("retry_walk_steps requires spec")
    solver = build(pso)
    if not rounds:
        return solver
    retry_cfg = {}
    if retry_init_mode and retry_init_mode != pso.init_mode and not retry_walk_steps:
        retry_cfg["init_mode"] = retry_init_mode
    if retry_iterations and retry_iterations != pso.iterations:
        retry_cfg["iterations"] = retry_iterations
        if pso.rekick_interval and retry_iterations % pso.rekick_interval:
            retry_cfg["rekick_interval"] = 0
    retry_solver = build(dataclasses.replace(pso, **retry_cfg)) if retry_cfg else None
    if retry_walk_steps:
        retry_solver = wrap_solver_with_target_walk(
            retry_solver or solver, spec, retry_walk_steps, jitter=retry_walk_jitter)
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
    merged on device. ``retry_start="best"`` starts each re-solve from the
    swarm's current best pose instead of the problem's."""
    if retry_start not in ("problem", "best"):
        raise ValueError(f"unknown retry_start {retry_start!r}; expected 'problem' or 'best'")
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
            sub_problem = problem.take(worst)
            if retry_start == "best":
                sub_problem = sub_problem.replace(pose=out["pose"][worst])
            retry = retry_solver_(sub_problem, generator)
            prev_err = out["effector_error"][worst]
            better = (retry.effector_error < prev_err) & (prev_err > err_threshold)
            rows = worst[better]
            for f in out:
                out[f][rows] = getattr(retry, f)[better]
        return SolveResult(trace=res.trace, **out)

    return _solve
