"""Trajectory tracking and waypoint sweeps: many targets as batched swarms.

Port of ``ikpso_tpu/harness/trajectory.py`` (``SweepResult``,
``TrackResult``, ``track_trajectories``, ``follow_targets``,
``circle_paths``, ``solve_waypoints``) on one device:

  * ``track_trajectories``: S targets moving over T steps, each step one
    batched solve warm-started from the previous step's pose. JAX runs
    the T steps as one ``lax.scan`` program; here they are a host loop
    over one fixed-shape frame with the same chaining (the solved pose
    is the next step's warm start and locality anchor);
  * ``follow_targets``: the same re-solve loop over target (or base)
    updates that arrive one at a time;
  * ``solve_waypoints``: W independent waypoints in fixed-size batches,
    with top-k retries, optional polish, and an npz checkpoint after
    every batch so a cut-off sweep resumes at the last finished one
    (``utils/checkpoint.py``).

Solves run where the problem's tensors are (``build_solver``): kernel A
for ``impl="fused"``; for ``impl="jnp"`` the scan solver, its fitness
kernel C on the card and the plain fitness on the CPU or with a GJK scene
(no kernel fuses GJK, in JAX or here: :func:`fitness_impl` names the
fitness that runs). With ``mesh=`` the trajectory (S) axis of each step,
or each waypoint batch, is solved by ``parallel.sharded.solve_sharded``
across the mesh's ranks. The multi-process sweep is
``parallel.distributed.sweep_waypoints_multihost``. Random streams are
generator seeds (``utils/seeds.py``) in place of JAX's keys.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso_tpu_torch.models.library import batched_problem
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.polish import wrap_with_polish
from ikpso_tpu_torch.pso.restarts import wrap_with_topk_retries
from ikpso_tpu_torch.utils import checkpoint as ckpt
from ikpso_tpu_torch.utils import seeds
from ikpso_tpu_torch.utils.guards import check_solve_result
from ikpso_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class SweepResult:
    angles: np.ndarray  # (W, D)
    errors: np.ndarray  # (W,)
    solves_per_second: float


@dataclasses.dataclass
class TrackResult:
    """Output of :func:`track_trajectories`."""

    angles: np.ndarray  # (T, S, D)
    errors: np.ndarray  # (T, S) true effector error per step
    final_pose: np.ndarray  # (S, N, 3)
    solves_per_second: float
    wall_time_s: float


def fitness_impl(fit: FitnessConfig, obstacles: Optional[Obstacles], impl: str,
                 device) -> str:
    """The fitness a :func:`build_solver` solve runs: ``"kernel-A"``
    (``impl="fused"``), ``"kernel-C"`` (the scan solver on the card),
    ``"plain-gjk"`` (the scan solver with a GJK scene: the plain fitness,
    on the card too, as JAX's ``jnp`` path) or ``"plain"`` (the CPU)."""
    if impl == "fused":
        return "kernel-A"
    if obstacles is not None and obstacles.count and fit.collision_backend == "gjk":
        return "plain-gjk"
    return "kernel-C" if torch.device(device).type == "cuda" else "plain"


def build_solver(spec: ChainSpec, *, pso: PSOConfig = PSOConfig(),
                 fit: FitnessConfig = FitnessConfig(), obstacles: Optional[Obstacles] = None,
                 num_particles: int = 1024, impl: str = "jnp", device="cuda",
                 gbest_reduce=None):
    """``(problem, generator) -> SolveResult`` on ``device``: kernel A
    (``impl="fused"``) or the scan solver (``"jnp"``), whose fitness is
    kernel C on the card, packed for each problem it is given, and the
    plain fitness on the CPU or with a GJK scene (:func:`fitness_impl`).
    ``gbest_reduce`` (the scan solver only) reduces each swarm's gbest
    across the ranks of a particle-sharded solve."""
    from ikpso_tpu_torch.ops.fitness_kernel import make_kernel_fitness
    from ikpso_tpu_torch.pso.fused import make_fused_solver
    from ikpso_tpu_torch.pso.solver import make_solver, solve

    device = torch.device(device)
    if impl == "fused":
        if gbest_reduce is not None:
            raise ValueError("impl='fused' has a swarm-local gbest; a particle-sharded "
                             "solve needs impl='jnp'")
        return make_fused_solver(spec, pso=pso, fit=fit, num_particles=num_particles,
                                 device=device, obstacles=obstacles)
    if impl != "jnp":
        raise ValueError(f"unknown impl {impl!r}: 'jnp' or 'fused'")
    if fitness_impl(fit, obstacles, impl, device) != "kernel-C":
        return make_solver(spec, pso=pso, fit=fit, obstacles=obstacles,
                           num_particles=num_particles, gbest_reduce=gbest_reduce)

    def _solve(problem: IKProblem, generator: torch.Generator):
        with span("ikpso.solve"):
            with span("ikpso.solve.pack"):
                fitness_fn = make_kernel_fitness(spec, problem, fit, obstacles)
            return solve(spec, problem, generator, pso=pso, fit=fit, obstacles=obstacles,
                         num_particles=num_particles, fitness_fn=fitness_fn,
                         gbest_reduce=gbest_reduce)

    return _solve


def _base_solver(spec, pso, fit, obstacles, num_particles, impl, device, mesh):
    """:func:`build_solver`, or across ``mesh`` the sharded solver."""
    if mesh is None:
        return build_solver(spec, pso=pso, fit=fit, obstacles=obstacles,
                            num_particles=num_particles, impl=impl, device=device)
    from ikpso_tpu_torch.parallel.sharded import make_sharded_solver

    return make_sharded_solver(spec, mesh, pso=pso, fit=fit, obstacles=obstacles,
                               num_particles=num_particles, impl=impl)


def frame_solver(spec: ChainSpec, *, pso: PSOConfig = PSOConfig(),
                 fit: FitnessConfig = FitnessConfig(), obstacles: Optional[Obstacles] = None,
                 num_particles: int = 1024, impl: str = "jnp", polish: int = 0,
                 device="cuda", mesh=None):
    """A per-frame re-solve: :func:`build_solver` (across ``mesh``, the
    sharded solver), then with ``polish`` steps the LM polish gated on the
    locality-aware cost, its weight the fitness's angular-locality weight
    at the reference's normalization (kernel.cu:150), so per-frame motion
    stays animation-smooth."""
    solver = _base_solver(spec, pso, fit, obstacles, num_particles, impl, device, mesh)
    if polish:
        solver = wrap_with_polish(
            solver, spec, steps=polish,
            locality_weight=float(fit.angle_weight) / max(1, spec.dof // 3),
            obstacles=obstacles, collision_backend=fit.collision_backend,
            collision_shape=fit.collision_shape, gizmo_size=fit.gizmo_size)
    return solver


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def track_trajectories(
    spec: ChainSpec,
    problem: IKProblem,
    path,
    seed: int,
    *,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 1024,
    impl: str = "jnp",
    polish: int = 0,
    timeit: bool = False,
    mesh=None,
) -> TrackResult:
    """Track S moving targets over T steps on the problem's device.

    The reference's animation loop re-solves every rendered frame as the
    targets move, warm-starting each solve from the pose the previous
    frame produced (reference Main.cpp:222-227). Here each step is one
    batched solve of the S trajectories; the solved pose is the next
    step's warm start and locality anchor, and nothing leaves the device
    between steps. Step ``i`` draws from ``seeds.fold_in(seed, i)``.

    Args:
      path: ``(T, S, E, 3)`` target positions per step and trajectory.
      polish: K LM steps a frame on each gbest, gated on the
        locality-aware cost (``pso/polish.py``).
      timeit: run the T steps twice and report the second run's wall
        time (the first includes first-use builds and launches).
      mesh: a ``parallel.mesh.Mesh``; each step's S trajectories are solved
        across its ranks (``solve_sharded``: each rank its block, on its
        own derived stream), and every rank chains the gathered poses.
    """
    device = problem.pose.device
    path = torch.as_tensor(np.asarray(path, np.float32), device=device)
    t, s = path.shape[0], path.shape[1]
    base = batched_problem(problem, path[0])
    solver = frame_solver(spec, pso=pso, fit=fit, obstacles=obstacles,
                          num_particles=num_particles, impl=impl, polish=polish,
                          device=device, mesh=mesh)

    def run():
        pose = base.pose
        angles = torch.empty((t, s, spec.dof), dtype=torch.float32, device=device)
        errors = torch.empty((t, s), dtype=torch.float32, device=device)
        for i in range(t):
            res = solver(base.replace(pose=pose, targets=path[i]),
                         seeds.generator(seeds.fold_in(seed, i), device))
            pose = res.pose
            angles[i] = res.angles
            errors[i] = res.effector_error
        return pose, angles, errors

    start = time.perf_counter()
    out = run()
    _sync(device)
    wall = time.perf_counter() - start
    if timeit:
        start = time.perf_counter()
        out = run()
        _sync(device)
        wall = time.perf_counter() - start
    final_pose, angles, errors = (o.cpu().numpy() for o in out)
    if not np.isfinite(errors).all():
        bad = int((~np.isfinite(errors)).sum())
        warnings.warn(f"track_trajectories: {bad} non-finite step errors", stacklevel=2)
    return TrackResult(
        angles=angles,
        errors=errors,
        final_pose=final_pose,
        solves_per_second=t * s / wall if wall > 0 else float("inf"),
        wall_time_s=wall,
    )


def follow_targets(
    spec: ChainSpec,
    problem: IKProblem,
    updates,
    seed: int,
    *,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 1024,
    impl: str = "jnp",
    polish: int = 0,
):
    """Streaming re-solve loop over target updates fed from outside.

    The online form of :func:`track_trajectories` (the reference's
    interactive loop, Main.cpp:401-453: the user drags a target gizmo, or
    the arm's base with the arrow keys). ``updates`` is any iterator; each
    item is an ``(E, 3)`` or ``(S, E, 3)`` target array, or a dict with any
    of ``"targets"`` (same shapes) and ``"origin"`` (``(3,)`` or ``(S, 3)``
    base translation). Omitted fields keep their previous value; an
    origin-only first update solves for ``problem.targets``. Every step
    re-solves warm from the previous step's pose.

    Yields one dict per update: ``{step, effector_error, angles, wall_ms}``
    (numpy; ``wall_ms`` the step's solve, synchronized), and from the
    second step ``angle_delta_max``.
    """
    device = problem.pose.device
    solver = frame_solver(spec, pso=pso, fit=fit, obstacles=obstacles,
                          num_particles=num_particles, impl=impl, polish=polish,
                          device=device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    base = None
    pose = None
    prev_angles = None
    for step, upd in enumerate(updates):
        if isinstance(upd, dict):
            tgt, origin = upd.get("targets"), upd.get("origin")
        else:
            tgt, origin = upd, None
        if tgt is not None:
            tgt = f32(tgt)
            if tgt.dim() == 2:
                tgt = tgt[None]
        if base is None:
            base = batched_problem(problem, tgt if tgt is not None
                                   else problem.targets.to(torch.float32)[None])
            pose = base.pose
        if tgt is not None:
            base = base.replace(targets=tgt)
        if origin is not None:
            base = base.replace(origin=f32(origin).expand(base.origin.shape).contiguous())
        seed, sub = seeds.split(seed)
        t0 = time.perf_counter()
        res = solver(base.replace(pose=pose), seeds.generator(sub, device))
        err = res.effector_error.cpu().numpy()
        wall = time.perf_counter() - t0
        pose = res.pose
        angles = res.angles.cpu().numpy()
        out = dict(step=step, effector_error=err, angles=angles, wall_ms=wall * 1e3)
        if prev_angles is not None:
            out["angle_delta_max"] = float(np.abs(angles - prev_angles).max())
        prev_angles = angles
        yield out


def circle_paths(
    targets,
    steps: int,
    num_paths: int,
    *,
    radius: float = 0.25,
    revolutions: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """(T, S, E, 3) circular target paths starting AT the base targets.

    Each trajectory orbits every effector target around its base position
    in the XY plane with a per-trajectory random phase, so the S
    trajectories are decorrelated. Step 0 equals the base targets.
    """
    if isinstance(targets, torch.Tensor):
        targets = targets.cpu().numpy()
    targets = np.asarray(targets, np.float32)  # (E, 3)
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, size=(1, num_paths, 1))
    theta = np.linspace(0, 2 * np.pi * revolutions, steps, dtype=np.float64)[:, None, None]
    dx = radius * (np.cos(theta + phase) - np.cos(phase))
    dy = radius * (np.sin(theta + phase) - np.sin(phase))
    out = np.broadcast_to(targets[None, None], (steps, num_paths) + targets.shape).copy()
    out[..., 0] += dx
    out[..., 1] += dy
    return out.astype(np.float32)


def solve_waypoints(
    spec: ChainSpec,
    problem: IKProblem,
    waypoints,
    seed: int,
    *,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 1024,
    batch_size: int = 256,
    checkpoint_path: Optional[str] = None,
    impl: str = "jnp",
    retries: int = 0,
    retry_init_mode: Optional[str] = None,
    retry_iterations: Optional[int] = None,
    retry_err_threshold: float = 1e-3,
    polish: int = 0,
    mesh=None,
) -> SweepResult:
    """Solve every waypoint ``(W, E, 3)`` as an independent swarm.

    Each waypoint warm-starts from ``problem.pose``. ``retries`` wraps the
    solver in top-k retries (re-solve the worst eighth of each batch up to
    N rounds, ``pso/restarts.py``); ``retry_init_mode`` /
    ``retry_iterations`` give the retry rounds their own swarm init and
    depth. ``polish`` adds K LM steps on each waypoint's gbest
    (accept-if-better). Batch ``k`` draws from the second seed of a split
    of the seed batch ``k - 1`` carried; the checkpoint keeps the carried
    seed, so a resumed sweep returns what an uninterrupted one returns.
    With ``mesh``, each batch is solved across its ranks
    (``parallel.sharded.solve_sharded``), the batch size a multiple of
    the mesh's swarm axis.
    """
    device = problem.pose.device
    waypoints = np.asarray(waypoints, np.float32)
    w = waypoints.shape[0]

    state = ckpt.load(checkpoint_path) if checkpoint_path else None
    if state is None or state.angles.shape != (w, spec.dof):
        state = ckpt.fresh_state(w, spec.dof, seed)

    def build(pso_cfg):
        sv = _base_solver(spec, pso_cfg, fit, obstacles, num_particles, impl, device, mesh)
        if polish:
            sv = wrap_with_polish(sv, spec, steps=polish, obstacles=obstacles,
                                  collision_backend=fit.collision_backend,
                                  collision_shape=fit.collision_shape,
                                  gizmo_size=fit.gizmo_size)
        return sv

    solver = wrap_with_topk_retries(
        build, pso, rounds=retries, bucket=max(1, batch_size // 8),
        err_threshold=retry_err_threshold, retry_init_mode=retry_init_mode,
        retry_iterations=retry_iterations)

    run_seed = state.seed
    start = time.perf_counter()
    solved = 0
    cursor = state.cursor
    while cursor < w:
        end = min(cursor + batch_size, w)
        chunk = waypoints[cursor:end]
        # Pad the tail chunk to the fixed batch size.
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        batch = batched_problem(problem, torch.as_tensor(chunk, device=device))
        run_seed, sub = seeds.split(run_seed)
        res = solver(batch, seeds.generator(sub, device))
        check_solve_result(res, context=f"waypoints {cursor}:{end}")
        n = end - cursor
        state.angles[cursor:end] = res.angles[:n].cpu().numpy()
        state.errors[cursor:end] = res.effector_error[:n].cpu().numpy()
        solved += n
        cursor = end
        state = dataclasses.replace(state, cursor=cursor, seed=run_seed)
        if checkpoint_path:
            ckpt.save(checkpoint_path, state)
    wall = time.perf_counter() - start

    return SweepResult(
        angles=state.angles,
        errors=state.errors,
        solves_per_second=solved / wall if wall > 0 and solved else 0.0,
    )
