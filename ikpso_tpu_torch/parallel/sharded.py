"""Sharded PSO solves over a mesh of ranks: swarm-, particle-parallel or both.

Port of ``ikpso_tpu/parallel/sharded.py``. Every rank runs
:func:`solve_sharded` on the same global problem:

  * on a ``swarm`` axis it solves its contiguous block of S / n_swarm
    swarms, with no communication until the results are all-gathered;
  * on a ``particle`` axis it holds P / n_particle particles of every
    swarm of its block, and each swarm's global best is reduced across
    the axis after init and after every iteration
    (:func:`distributed_argmin`, the reference's ``thrust::min_element``
    as three all-reduces).

Every rank returns the global result, as JAX returns globally shaped
arrays. Random streams: the caller's generator gives one 63-bit seed (one
draw, the same on every rank when the callers' generators agree), and a
rank draws from ``utils.seeds.fold_in`` of it by its swarm index, then by
its particle index, for the axes the mesh has (:func:`shard_seed`), as
JAX folds the axis indices into its key. A rank's solve is thus the
single-process solve of its shard under its derived seed, bit for bit.

Collectives run on the process group's backend. Under gloo a CUDA tensor
is reduced through a host copy (gloo's own CUDA path stages through host
memory as well); under nccl each rank's tensors stay on its card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.parallel.mesh import PARTICLE_AXIS, SWARM_AXIS, Mesh
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.solver import SolveResult
from ikpso_tpu_torch.utils import seeds

_INT_MAX = 2**31 - 1


def _host_staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``t`` all-reduced with ``op`` over ``group`` (a new tensor on
    ``t``'s device)."""
    buf = t.cpu().clone() if _host_staged(group) else t.clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (same shape on every rank) concatenated along
    ``dim`` in group-rank order."""
    src = t.contiguous().cpu() if _host_staged(group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def distributed_argmin(val: torch.Tensor, coords: torch.Tensor, group
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global ``(min value, its coordinates)`` across the ranks of ``group``.

    ``val`` ``(S,)`` and ``coords`` ``(S, D)`` are each rank's candidates.
    Three all-reduces: MIN on the value; MIN on the owner rank among the
    ranks whose value equals the minimum (ties go to the lowest rank, and
    within a rank the local argmin already took the lowest particle id:
    ``thrust::min_element``'s first minimum); SUM of the coordinates, which
    only the owner contributes. ``group=None`` is one rank: the identity.
    """
    if group is None:
        return val, coords
    gval = all_reduce(val, dist.ReduceOp.MIN, group)
    me = dist.get_rank(group)
    owner = torch.where(val <= gval, me, _INT_MAX).to(torch.int32)
    min_owner = all_reduce(owner, dist.ReduceOp.MIN, group)
    contrib = torch.where((min_owner == me)[..., None], coords, torch.zeros_like(coords))
    return gval, all_reduce(contrib, dist.ReduceOp.SUM, group)


def shard_seed(seed: int, mesh: Mesh) -> int:
    """This rank's seed: ``seed`` folded with the rank's swarm index, then
    its particle index, for the axes ``mesh`` has."""
    for axis in (SWARM_AXIS, PARTICLE_AXIS):
        if axis in mesh.axis_names:
            seed = seeds.fold_in(seed, mesh.axis_index(axis))
    return seed


def draw_seed(generator: torch.Generator) -> int:
    """One non-negative 63-bit seed drawn from ``generator``."""
    return int(torch.randint(0, 2**63 - 1, (1,), generator=generator,
                             device=generator.device).item())


def _rows(problem: IKProblem, start: int, stop: int) -> IKProblem:
    return IKProblem(
        pose=problem.pose[start:stop], origin=problem.origin[start:stop],
        targets=problem.targets[start:stop],
        target_rot=None if problem.target_rot is None else problem.target_rot[start:stop])


def solve_sharded(
    chain: ChainSpec,
    problem: IKProblem,
    generator: torch.Generator,
    mesh: Mesh,
    *,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 1024,
    impl: str = "jnp",
) -> SolveResult:
    """Solve the global ``(S, ...)`` problem across the mesh's ranks.

    Every rank passes the same global problem (on its own device) and a
    generator in the same state. ``num_particles`` is the global count per
    swarm. ``impl="jnp"`` runs the scan solver (kernel C on the card, the
    plain fitness on the CPU or with a GJK scene:
    ``harness.trajectory.build_solver``); ``impl="fused"`` runs kernel A
    and shards swarms only. Returns the global result on every rank.
    """
    from ikpso_tpu_torch.harness.trajectory import build_solver

    has_swarm = SWARM_AXIS in mesh.axis_names
    has_particle = PARTICLE_AXIS in mesh.axis_names
    n_part = mesh.shape[PARTICLE_AXIS] if has_particle else 1
    n_swarm = mesh.shape[SWARM_AXIS] if has_swarm else 1
    if num_particles % n_part:
        raise ValueError(f"num_particles={num_particles} not divisible by {n_part} "
                         "particle shards")
    s = problem.pose.shape[0]
    if s % n_swarm:
        raise ValueError(f"swarm count {s} not divisible by mesh swarm axis {n_swarm}")
    if impl == "fused" and has_particle:
        raise ValueError("impl='fused' shards swarms only; the megakernel's gbest is "
                         "swarm-local (use impl='jnp' for particle-axis sharding)")
    device = problem.pose.device
    gbest_reduce = None
    if has_particle and mesh.group(PARTICLE_AXIS) is not None:
        group = mesh.group(PARTICLE_AXIS)

        def gbest_reduce(val, coords):
            return distributed_argmin(val, coords, group)

    solver = build_solver(chain, pso=pso, fit=fit, obstacles=obstacles,
                          num_particles=num_particles // n_part, impl=impl, device=device,
                          gbest_reduce=gbest_reduce)
    block = s // n_swarm
    start = (mesh.axis_index(SWARM_AXIS) if has_swarm else 0) * block
    local = solver(_rows(problem, start, start + block),
                   seeds.generator(shard_seed(draw_seed(generator), mesh), device))
    group = mesh.group(SWARM_AXIS) if has_swarm else None
    if group is None:
        return local
    return SolveResult(
        angles=all_gather_cat(local.angles, group),
        fitness=all_gather_cat(local.fitness, group),
        pose=all_gather_cat(local.pose, group),
        effector_error=all_gather_cat(local.effector_error, group),
        trace=all_gather_cat(local.trace, group, dim=1),
    )


def make_sharded_solver(chain: ChainSpec, mesh: Mesh, **kwargs):
    """A ``(problem, generator) -> SolveResult`` closure over
    :func:`solve_sharded`."""

    def _solve(problem: IKProblem, generator: torch.Generator) -> SolveResult:
        return solve_sharded(chain, problem, generator, mesh, **kwargs)

    return _solve
