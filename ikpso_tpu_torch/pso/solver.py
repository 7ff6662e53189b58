"""The PSO scan solver over the full ``(S, P, D)`` state.

Port of ``ikpso_tpu/pso/solver.py`` (``SolveResult``, ``_swarm_argmin``,
``pso_iteration``, ``init_swarm``, ``solve``, ``solve_single``,
``make_solver``). The JAX ``lax.scan`` over iterations is a Python loop
of plain torch ops; the fitness is the plain ``ops.fitness.fitness``
unless the caller passes a ``fitness_fn`` -- kernel C's
``ops.fitness_kernel.make_kernel_fitness`` is the ``impl="pallas"``
path of ``bench.py``. ``gbest_reduce`` reduces each swarm's gbest
candidate across the ranks that hold its other particles
(``parallel.sharded.distributed_argmin``), after init and after every
iteration, as JAX's hook does.

Random draws: U[0, 1) float32 on the caller's ``torch.Generator``, in
the JAX package's order -- the init position block (uniform / hybrid
init only) and the init velocity block from ``torch.rand``, one block a
solve each, then one ``(n, S, P, D)`` block per iteration: ``(u_w, u_c,
u_s)`` with randomized inertia, ``(u_c, u_s)`` with canonical inertia,
plus one re-kick block when ``rekick_interval > 0``. Off the card each
iteration's block is ``torch.rand``'s. On the card (kernel C's fitness,
:func:`step_route`) the solve draws ``(S, 2)`` int32 seed words from the
generator after the init blocks (:func:`step_seeds`, as
``pso/fused.py``'s solver seeds kernel A) and the scan step draws each
iteration's uniforms in registers from them (Philox4x32-10, the counter
mapping of ``ops.philox.step_uniforms``, which is the same block in
plain torch); no iteration's block is written to device memory.
``ScanDraws`` injects every block instead (the test hook, as kernel A's
``uniforms`` replay input; on the card the step then reads them:
the replay step). Every draw maps to its range exactly as
``jax.random.uniform`` maps its U[0, 1) floats (``u * (max - min) +
min``, floored at ``min``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import FitnessConfig, fitness, true_effector_error
from ikpso_tpu_torch.ops.fitness_kernel import TWO_PI, KernelFitness
from ikpso_tpu_torch.ops.philox import step_uniforms
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.utils.profiling import span

FitnessFn = Callable[[torch.Tensor], torch.Tensor]  # (S, P, D) -> (S, P)
# Cross-rank reduction of the per-rank gbest candidate:
# ((S,), (S, D)) -> ((S,), (S, D)).
GbestReduce = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Output of one batched solve.

    Attributes:
      angles: ``(S, D)`` global-best joint angles per swarm.
      fitness: ``(S,)`` global-best fitness values.
      pose: ``(S, N, 3)`` the problem pose with the solution's joint rows.
      effector_error: ``(S,)`` summed Euclidean effector error.
      trace: ``(T, S)`` global-best fitness history: after init and
        after each iteration for the scan solver, the final value alone
        for the fused solver.
    """

    angles: torch.Tensor
    fitness: torch.Tensor
    pose: torch.Tensor
    effector_error: torch.Tensor
    trace: torch.Tensor


class ScanDraws(NamedTuple):
    """Injected U[0, 1) draws of one solve: ``position`` ``(S, P, D)``
    (None for warm init), ``velocity`` ``(S, P, D)`` and ``steps``
    ``(iterations, n, S, P, D)`` (n from :func:`draws_per_iteration`)."""

    position: Optional[torch.Tensor]
    velocity: torch.Tensor
    steps: torch.Tensor


def draws_per_iteration(pso: PSOConfig) -> int:
    """Uniform blocks one iteration draws."""
    return (3 if pso.inertia_mode == "randomized" else 2) + (pso.rekick_interval > 0)


def _uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device,
                      dtype=torch.float32).to(device)


def step_seeds(generator: torch.Generator, num_swarms: int, device) -> torch.Tensor:
    """The drawing step's ``(S, 2)`` int32 Philox key words, drawn from
    ``generator`` on its device as ``pso.fused.make_fused_solver`` draws
    kernel A's."""
    return torch.randint(-2**31, 2**31, (num_swarms, 2), generator=generator,
                         device=generator.device, dtype=torch.int32).to(device)


class StepDraws:
    """The drawing step's iteration blocks as ``ScanDraws.steps``: item
    ``it`` is ``ops.philox.step_uniforms(seeds, it, n, P, D)``, computed
    when it is read (a whole solve's blocks need not fit in memory)."""

    def __init__(self, seeds: torch.Tensor, n: int, num_particles: int, dof: int):
        self.seeds, self.n, self.num_particles, self.dof = seeds, n, num_particles, dof

    def __getitem__(self, iteration: int) -> torch.Tensor:
        return step_uniforms(self.seeds, iteration, self.n, self.num_particles, self.dof)


def drawing_route_draws(generator: torch.Generator, pso: PSOConfig, num_swarms: int,
                        num_particles: int, dof: int, device) -> ScanDraws:
    """What :func:`solve` draws from ``generator`` on the drawing step's
    route, as :class:`ScanDraws`: the init blocks from ``torch.rand`` in
    :func:`init_swarm`'s order, then the seed words, the iterations'
    blocks as :class:`StepDraws` of them. ``pso_iteration`` fed these is
    the drawing route's plain twin, bit for bit (tests and
    ``chip_smoke.py``)."""
    shape = (num_swarms, num_particles, dof)
    position = (_uniform(generator, shape, device)
                if pso.init_mode in ("uniform", "hybrid") else None)
    velocity = _uniform(generator, shape, device)
    seeds = step_seeds(generator, num_swarms, device)
    return ScanDraws(position, velocity,
                     StepDraws(seeds, draws_per_iteration(pso), num_particles, dof))


def _scale(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jax.random.uniform``'s map of U[0, 1) floats onto ``[lo, hi)``."""
    return torch.clamp_min(u * (hi - lo) + lo, lo)


def inertia_at(pso: PSOConfig, iteration: int) -> float:
    """``PSOConfig.inertia_at`` in float32 arithmetic, as the JAX scan
    body evaluates it on a traced iteration counter."""
    if pso.inertia_end < 0.0:
        return pso.inertia
    frac = np.float32(iteration) / np.float32(max(pso.iterations - 1, 1))
    return float(np.float32(pso.inertia)
                 + np.float32(pso.inertia_end - pso.inertia) * frac)


def _swarm_argmin(values: torch.Tensor, coords: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-swarm best: values (S, P), coords (S, P, D) -> (S,), (S, D).
    ``torch.argmin`` returns the first minimum, as ``jnp.argmin``."""
    idx = torch.argmin(values, dim=-1)
    best_val = torch.take_along_dim(values, idx[:, None], dim=-1)[:, 0]
    best_coords = torch.take_along_dim(coords, idx[:, None, None], dim=-2)[:, 0, :]
    return best_val, best_coords


def pso_iteration(x, v, lbest, lbest_val, gbest, gbest_val, u: torch.Tensor,
                  fitness_fn: FitnessFn, lo, hi, pso: PSOConfig, iteration: int = 0,
                  gbest_reduce: Optional[GbestReduce] = None):
    """One PSO step over the full (S, P, D) state; ``u`` is the
    iteration's ``(n, S, P, D)`` block of U[0, 1) draws."""
    randomized = pso.inertia_mode == "randomized"
    u_c, u_s = (u[1], u[2]) if randomized else (u[0], u[1])
    if pso.rekick_interval > 0 and iteration > 0 and iteration % pso.rekick_interval == 0:
        # Overwrite the inertia memory with a fresh init-style draw; with
        # a threshold, only swarms whose gbest is above it are kicked.
        kicked = (u[-1] * 2.0 - 1.0) * pso.rekick_scale
        if pso.rekick_threshold >= 0.0:
            kicked = torch.where((gbest_val > pso.rekick_threshold)[:, None, None],
                                 kicked, v)
        v = kicked
    # Randomized: v = w*U()*v + c1*U()*(lbest-x) + c2*U()*(gbest-x).
    inertia = pso.inertia * u[0] * v if randomized else inertia_at(pso, iteration) * v
    v = (inertia + pso.cognitive * u_c * (lbest - x)
         + pso.social * u_s * (gbest[:, None, :] - x))
    # Integrate, then clamp per axis to the joint limits; the velocity
    # stays unclamped, as in the reference.
    x = torch.clamp(x + v, lo, hi)

    f = fitness_fn(x)
    improved = f < lbest_val
    lbest_val = torch.where(improved, f, lbest_val)
    lbest = torch.where(improved[..., None], x, lbest)

    cand_val, cand = _swarm_argmin(lbest_val, lbest)
    if gbest_reduce is not None:
        cand_val, cand = gbest_reduce(cand_val, cand)
    better = cand_val < gbest_val
    gbest_val = torch.where(better, cand_val, gbest_val)
    gbest = torch.where(better[:, None], cand, gbest)
    return x, v, lbest, lbest_val, gbest, gbest_val


def _kick(pso: PSOConfig, iteration: int) -> int:
    """Which swarms iteration ``iteration`` re-kicks, as :func:`pso_iteration`
    decides it: 0 none, 1 every swarm, 2 those whose gbest is above the
    threshold (``StepKick`` in ``csrc/scan_step.cuh``)."""
    if pso.rekick_interval > 0 and iteration > 0 and iteration % pso.rekick_interval == 0:
        return 2 if pso.rekick_threshold >= 0.0 else 1
    return 0


class StepWork(NamedTuple):
    """The scan step's scratch for S swarms: each block's first-minimum
    candidate ``(S, blocks)`` (value, particle id; room for the most blocks
    a swarm can take, of 32 threads, as the step takes for the widest
    chains) and each swarm's arrival counter ``(S,)``, zero between launches
    (the last block resets it)."""

    cand_val: torch.Tensor
    cand_id: torch.Tensor
    arrivals: torch.Tensor


def step_work(num_swarms: int, num_particles: int, device) -> StepWork:
    """:class:`StepWork` for S swarms of P particles."""
    blocks = -(-num_particles // 32)
    return StepWork(torch.empty((num_swarms, blocks), dtype=torch.float32, device=device),
                    torch.empty((num_swarms, blocks), dtype=torch.int32, device=device),
                    torch.zeros(num_swarms, dtype=torch.int32, device=device))


def block_first_min(values: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's block candidates, plain: per block of ``block``
    particles of ``values`` ``(S, P)``, the first minimum and its particle
    id, ``(S, blocks)`` each (a NaN counts as the minimum, as
    ``torch.argmin`` takes it; the ragged last block is padded with +inf,
    which loses every tie to a real particle)."""
    s, p = values.shape
    blocks = -(-p // block)
    pad = values.new_full((s, blocks * block - p), float("inf"))
    tiles = torch.cat([values, pad], dim=1).reshape(s, blocks, block)
    idx = torch.argmin(tiles, dim=-1)
    first = torch.arange(blocks, device=values.device) * block
    return torch.take_along_dim(tiles, idx[..., None], dim=-1)[..., 0], idx + first


def first_min_of_blocks(cand_val: torch.Tensor, cand_id: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's second pass, plain: the first minimum over the block
    candidates in block order -> ``(S,)`` value and particle id."""
    k = torch.argmin(cand_val, dim=-1, keepdim=True)
    return (torch.take_along_dim(cand_val, k, dim=-1)[:, 0],
            torch.take_along_dim(cand_id, k, dim=-1)[:, 0])


def scan_step(fitness: KernelFitness, x, v, lbest, lbest_val, gbest, gbest_val,
              u: Optional[torch.Tensor], limits: torch.Tensor, pso: PSOConfig,
              iteration: int = 0, gbest_reduce: Optional[GbestReduce] = None,
              work: Optional[StepWork] = None, seeds: Optional[torch.Tensor] = None):
    """One PSO step through the scan-step kernel: :func:`pso_iteration`
    with kernel C's evaluation, in one launch. The iteration's uniforms
    are either ``u``, its ``(n, S, P, D)`` block (the replay step reads
    it), or drawn in the kernel from ``seeds``, the swarms' ``(S, 2)``
    int32 Philox key words (the drawing step: the block
    ``ops.philox.step_uniforms(seeds, iteration, n, P, D)``); exactly one
    of the two is given. ``limits`` is the ``(2, D)`` stack of the joint
    limits, ``work`` the step's scratch (:func:`step_work`).

    CPU tensors run :func:`pso_iteration` (with ``fitness``, whose CPU
    call is kernel C's plain twin; with ``seeds``, on ``step_uniforms``'s
    block). CUDA tensors launch the kernel or raise: x, v, lbest and
    lbest_val are updated in place, and gbest and gbest_val too without
    ``gbest_reduce``; with it the kernel returns each swarm's candidate and
    the hook and the two ``torch.where`` run as in :func:`pso_iteration`.
    x, v and lbest must be separate buffers."""
    if (u is None) == (seeds is None):
        raise ValueError("scan_step takes either the iteration's uniforms u or the "
                         "seed words it draws them from, not both or neither")
    n = draws_per_iteration(pso)
    if x.device.type == "cpu":
        if u is None:
            u = step_uniforms(seeds, iteration, n, x.shape[1], x.shape[2])
        return pso_iteration(x, v, lbest, lbest_val, gbest, gbest_val, u, fitness,
                             limits[0], limits[1], pso, iteration=iteration,
                             gbest_reduce=gbest_reduce)
    if u is not None and u.shape[0] != n:
        raise ValueError(f"scan_step: u holds {u.shape[0]} blocks, the iteration draws {n}")
    randomized = pso.inertia_mode == "randomized"
    w = pso.inertia if randomized else inertia_at(pso, iteration)
    update = (w, pso.cognitive, pso.social, int(randomized), _kick(pso, iteration),
              pso.rekick_scale, pso.rekick_threshold)
    if work is None:
        work = step_work(x.shape[0], x.shape[1], x.device)
    reduced = None
    if gbest_reduce is not None:
        reduced = (torch.empty_like(gbest_val), torch.empty_like(gbest))
    fitness.launch_step(x, v, lbest, lbest_val, (u, seeds, n, iteration), limits, gbest,
                        gbest_val, reduced, update, work)
    scan_step.launches += 1
    scan_step.replay_launches += u is not None
    if reduced is not None:
        cand_val, cand = gbest_reduce(*reduced)
        better = cand_val < gbest_val
        gbest_val = torch.where(better, cand_val, gbest_val)
        gbest = torch.where(better[:, None], cand, gbest)
    return x, v, lbest, lbest_val, gbest, gbest_val


scan_step.launches = 0  # every launch
scan_step.replay_launches = 0  # of which the replay step's


def step_route(fitness_fn, device) -> bool:
    """Whether :func:`solve` runs its iterations through :func:`scan_step`:
    kernel C's fitness on the card."""
    return isinstance(fitness_fn, KernelFitness) and torch.device(device).type == "cuda"


def step_buffers(state):
    """The init state as the scan step updates it in place: x, v and lbest
    separate contiguous buffers (warm init's x is an ``expand`` view and
    lbest is x), gbest and gbest_val copies (the trace keeps init's)."""
    x, v, lbest, lbest_val, gbest, gbest_val = state

    def own(t):
        return t.clone(memory_format=torch.contiguous_format)

    return (x.contiguous(), v.contiguous(), own(lbest), lbest_val.contiguous(), own(gbest),
            own(gbest_val))


def init_swarm(generator: Optional[torch.Generator], anchor_angles: torch.Tensor,
               num_particles: int, fitness_fn: FitnessFn, pso: PSOConfig,
               limits: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               uniforms: Optional[Tuple[Optional[torch.Tensor], torch.Tensor]] = None,
               gbest_reduce: Optional[GbestReduce] = None):
    """Swarm init: ``"warm"`` starts every particle at the anchor pose,
    ``"uniform"`` over the joint range (``limits``, cut to +-2 pi),
    ``"hybrid"`` uniform with particle 0 warm; velocities are uniform in
    ``[-init_velocity_scale, init_velocity_scale)``. ``uniforms`` is the
    ``(position, velocity)`` pair of injected U[0, 1) blocks."""
    s, d = anchor_angles.shape
    shape = (s, num_particles, d)
    dev = anchor_angles.device
    u_x, u_v = uniforms if uniforms is not None else (None, None)
    if pso.init_mode in ("uniform", "hybrid"):
        if limits is None:
            raise ValueError(f"init_mode={pso.init_mode!r} requires joint limits")
        lo = torch.clamp_min(limits[0], -TWO_PI)
        hi = torch.clamp_max(limits[1], TWO_PI)
        if u_x is None:
            u_x = _uniform(generator, shape, dev)
        x = _scale(u_x, lo, hi)
        if pso.init_mode == "hybrid":
            x[:, 0, :] = anchor_angles
    else:
        x = anchor_angles[:, None, :].expand(shape)
    if u_v is None:
        u_v = _uniform(generator, shape, dev)
    scale = float(np.float32(pso.init_velocity_scale))
    v = _scale(u_v, -scale, scale)
    lbest = x
    lbest_val = fitness_fn(x)
    gbest_val, gbest = _swarm_argmin(lbest_val, lbest)
    if gbest_reduce is not None:
        gbest_val, gbest = gbest_reduce(gbest_val, gbest)
    return x, v, lbest, lbest_val, gbest, gbest_val


def solve(spec: ChainSpec, problem: IKProblem, generator: Optional[torch.Generator],
          pso: PSOConfig = PSOConfig(), fit: FitnessConfig = FitnessConfig(),
          obstacles: Optional[Obstacles] = None, num_particles: int = 1024,
          fitness_fn: Optional[FitnessFn] = None,
          uniforms: Optional[ScanDraws] = None,
          gbest_reduce: Optional[GbestReduce] = None,
          vary_axes: Tuple[str, ...] = ()) -> SolveResult:
    """Solve a batch of IK problems (one leading swarm axis) with PSO.

    ``fitness_fn`` overrides the plain fitness (e.g. kernel C's
    ``make_kernel_fitness``, whose iterations on the card are launches of
    the drawing scan step, or of the replay step under ``uniforms``);
    ``uniforms`` replaces the generator; ``gbest_reduce``
    reduces the gbest candidates across ranks.
    ``vary_axes`` is accepted for JAX's signature: it marks the carry as
    rank-varying for ``shard_map``'s types, and a rank's torch tensors
    need no such mark. Everything before the iterations is the span
    ``ikpso.solve.init`` (``utils.profiling.span``).
    """
    del vary_axes
    with span("ikpso.solve.init"):
        anchor_angles = fk_ops.pose_to_angles(spec, problem.pose)
        if anchor_angles.dim() != 2:
            raise ValueError(
                "solve() expects a single leading swarm axis; got pose shape "
                f"{tuple(problem.pose.shape)}. Use solve_single() for unbatched problems."
            )
        if uniforms is None and generator is None:
            raise ValueError("solve() needs a generator or injected uniforms")
        if fitness_fn is None:
            anchor_positions = fk_ops.fk_points(spec, problem.pose, problem.origin)

            def fitness_fn(x):
                return fitness(spec, x, problem, fit, obstacles=obstacles,
                               anchor_angles=anchor_angles,
                               anchor_positions=anchor_positions)

        lo, hi = spec.limits().to(anchor_angles.device)
        state = init_swarm(generator, anchor_angles, num_particles, fitness_fn, pso,
                           limits=(lo, hi),
                           uniforms=None if uniforms is None
                           else (uniforms.position, uniforms.velocity),
                           gbest_reduce=gbest_reduce)
        trace = [state[5]]
        on_card = step_route(fitness_fn, anchor_angles.device)
        if on_card:
            state = step_buffers(state)
            limits = torch.stack((lo, hi)).contiguous()
            work = step_work(state[0].shape[0], num_particles, anchor_angles.device)
            # The drawing step: the iterations' uniforms from these seed words,
            # in the kernel.
            seeds = (None if uniforms is not None
                     else step_seeds(generator, state[0].shape[0], anchor_angles.device))
    n = draws_per_iteration(pso)
    for it in range(pso.iterations):
        if on_card:
            u = None if seeds is not None else uniforms.steps[it].contiguous()
            state = scan_step(fitness_fn, *state, u, limits, pso, iteration=it,
                              gbest_reduce=gbest_reduce, work=work, seeds=seeds)
            trace.append(state[5].clone())
        else:
            u = (uniforms.steps[it] if uniforms is not None
                 else _uniform(generator, (n,) + tuple(state[0].shape), anchor_angles.device))
            state = pso_iteration(*state, u, fitness_fn, lo, hi, pso, iteration=it,
                                  gbest_reduce=gbest_reduce)
            trace.append(state[5])
    gbest, gbest_val = state[4], state[5]
    solved_pose = fk_ops.angles_to_pose(spec, problem.pose[..., 0, :], gbest)
    return SolveResult(
        angles=gbest,
        fitness=gbest_val,
        pose=solved_pose,
        effector_error=true_effector_error(spec, solved_pose, problem),
        trace=torch.stack(trace),
    )


def solve_single(spec: ChainSpec, problem: IKProblem,
                 generator: Optional[torch.Generator], **kwargs) -> SolveResult:
    """Solve one unbatched IK problem (adds and strips the swarm axis)."""
    batched = IKProblem(
        pose=problem.pose[None], origin=problem.origin[None],
        targets=problem.targets[None],
        target_rot=None if problem.target_rot is None else problem.target_rot[None],
    )
    res = solve(spec, batched, generator, **kwargs)
    fields = (getattr(res, f.name) for f in dataclasses.fields(res))
    return SolveResult(*(t[0] if t.shape[0] == 1 else t[:, 0] for t in fields))


def make_solver(spec: ChainSpec, pso: PSOConfig = PSOConfig(),
                fit: FitnessConfig = FitnessConfig(),
                obstacles: Optional[Obstacles] = None, num_particles: int = 1024,
                fitness_fn: Optional[FitnessFn] = None,
                gbest_reduce: Optional[GbestReduce] = None):
    """A ``(problem, generator) -> SolveResult`` closure over :func:`solve`."""

    def _solve(problem: IKProblem, generator: torch.Generator) -> SolveResult:
        return solve(spec, problem, generator, pso=pso, fit=fit, obstacles=obstacles,
                     num_particles=num_particles, fitness_fn=fitness_fn,
                     gbest_reduce=gbest_reduce)

    return _solve
