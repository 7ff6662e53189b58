"""Fully-fused PSO solve: kernel A and its plain torch version.

Port of ``ikpso_tpu/pso/fused.py`` (``fused_solve_raw``,
``make_fused_solver``):

  * ``fused_solve`` — kernel A (``csrc/fused_solve.cu``): one thread
    block per swarm, one thread per particle, the whole solve on chip: x
    in registers, v and lbest in registers or shared memory (branching
    trees of 46-60 DOFs: a swarm over a cluster of blocks, v and lbest in
    their shared memory, ``csrc/fused_solve_cluster.cuh``; serial chains
    without a compile-time topology and the other trees past 45 DOFs: x
    and v in a global scratch, lbest in shared memory where it fits;
    :func:`kernel_a_layout`); CPU tensors run ``fused_solve_plain``
    instead;
  * ``fused_solve_plain`` — the same solve on ``(S, P, D)`` tensors,
    with ``torch.argmin`` (first occurrence) for gbest;
  * ``make_fused_solver`` — ``(problem, generator) -> SolveResult``.

Supported: canonical inertia (with or without ``inertia_end``) or
randomized inertia, ``init_mode`` ``"warm"``, ``"uniform"`` or
``"hybrid"``, any ``gbest_interval``, the velocity re-kick with or
without its threshold, the orientation and distance terms, polynomial or
exact trig, obstacles with the closed-form (``"sat"``) colliders of
either shape, on any tree: on the card, the prebuilt instantiations of
``utils.kernels`` or one built on demand for the request, with at most
``utils.kernels.max_particles`` particles a swarm. Only the GJK collider
raises, as it does in JAX. The TPU-only knobs (``swarms_per_tile``,
``gbest_mode``, ``const_mode``, VMEM gates, multi-row output) have no
counterpart.

Random stream: per-swarm seed words ``(S, 2)`` int32 drawn from the
caller's ``torch.Generator``; the kernel's in-register Philox and
``ops.philox.philox_uniform`` produce the same bits from them. The
``uniforms`` replay input, ``(S, n_draws, D, P)``, replaces the
generator in both versions (the test hook). Draw slots, the JAX kernel's
replay numbering (``ikpso_tpu/pso/fused.py:245-250, 390-394``): the init
draws first (position at slot 0 unless warm; velocity at
``n_init - 1``), then :func:`draws_per_iter` slots per iteration --
``u_c``, ``u_s``, ``u_w`` (randomized inertia), and the re-kick draw of
a block starting at that iteration in the last slot.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.fitness_kernel import (
    TWO_PI,
    MetaLayout,
    check_meta,
    check_swarm,
    fk_fitness_plain,
    pack_meta,
    pack_swarm,
    scene_constants,
)
from ikpso_tpu_torch.ops.philox import philox_uniform
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.solver import SolveResult
from ikpso_tpu_torch.utils import kernels


# Init-mode ids (enum InitMode in csrc/fused_solve.cu).
INIT_MODES = {"warm": 0, "uniform": 1, "hybrid": 2}


def check_supported(pso: PSOConfig, fit: FitnessConfig, num_obstacles: int = 0) -> None:
    """Refuse what JAX's kernel refuses: the GJK collider
    (``ikpso_tpu/pso/fused.py:733-741``)."""
    if num_obstacles and fit.collision_backend != "sat":
        raise NotImplementedError(
            f"collision_backend={fit.collision_backend!r}: kernel A fuses only the "
            "closed-form 'sat' colliders, as JAX's kernel does; solve GJK scenes on "
            "the scan solver (--impl jnp, impl='jnp'), whose fitness is the plain one"
        )


def uses_distance(fit: FitnessConfig) -> bool:
    """Whether the fitness has the distance term (a non-zero weight), as
    JAX's kernel decides it at trace time."""
    return float(fit.distance_weight) != 0.0


def num_draws(pso: PSOConfig) -> int:
    """Draw slots of one solve: the init draws (velocity; position too
    unless warm), then :func:`draws_per_iter` per iteration."""
    return n_init_draws(pso) + draws_per_iter(pso) * pso.iterations


def n_init_draws(pso: PSOConfig) -> int:
    return 1 if pso.init_mode == "warm" else 2


def draws_per_iter(pso: PSOConfig) -> int:
    """Slots per iteration: u_c, u_s, u_w with randomized inertia, and one
    for the re-kick when it is on."""
    return (3 if pso.inertia_mode == "randomized" else 2) + (1 if pso.rekick_interval else 0)


def gbest_interval(pso: PSOConfig) -> int:
    """The gbest refresh interval, after the JAX kernel's checks: it
    divides the iterations and, with the re-kick on, the kick interval,
    which divides the iterations too (``ikpso_tpu/pso/fused.py:361-378``)."""
    interval = max(1, pso.gbest_interval)
    if pso.iterations % interval:
        raise ValueError(f"iterations={pso.iterations} must be a multiple of "
                         f"gbest_interval={interval}")
    rk = pso.rekick_interval
    if rk and (rk % interval or pso.iterations % rk):
        raise ValueError(f"rekick_interval={rk} must be a multiple of "
                         f"gbest_interval={interval} and divide "
                         f"iterations={pso.iterations}")
    return interval


def inertia_schedule(pso: PSOConfig) -> np.ndarray:
    """Per-iteration inertia, computed in double on the host and cast to
    float32 — what the interpreted JAX kernel's static unroll feeds in."""
    return np.asarray(
        [pso.inertia_at(it) for it in range(pso.iterations)], np.float64
    ).astype(np.float32)


def kernel_a_layout(spec, fit, swarm, num_particles, num_obstacles=0,
                    use_orientation=False) -> kernels.KernelALayout:
    """Where kernel A keeps its state for this solve, and the shared memory
    a block takes (``utils.kernels.kernel_a_layout``)."""
    return kernels.kernel_a_layout(spec, num_particles, num_obstacles, fit.collision_shape,
                                   use_orientation, uses_distance(fit), fit.trig_impl,
                                   swarm_width=swarm.shape[1])


def _check_args(spec, pso, fit, swarm, limits, seeds, num_particles, uniforms,
                num_obstacles=0, use_orientation=False):
    s = swarm.shape[0]
    d = spec.dof
    most = kernels.max_particles(spec, num_obstacles, fit.collision_shape, use_orientation,
                                 uses_distance(fit), fit.trig_impl)
    if num_particles % 32 or not 32 <= num_particles <= most:
        raise ValueError(
            f"num_particles={num_particles} must be a multiple of 32 in [32, {most}]"
            + ("" if most == 1024 else " (kernel A's thread-block bound for this "
               "topology)")
        )
    layout = kernel_a_layout(spec, fit, swarm, num_particles, num_obstacles, use_orientation)
    if layout.smem_bytes + layout.static_bytes > kernels.SMEM_OPTIN:
        raise ValueError(
            f"kernel A needs {layout.smem_bytes} bytes of shared memory a block"
            + (f" (and {layout.static_bytes} static)" if layout.static_bytes else "")
            + f" for {spec.num_nodes} nodes, P={num_particles} and {num_obstacles} obstacles "
            f"(v and lbest: {layout.placement}); a block has at most "
            f"{kernels.SMEM_OPTIN}"
        )
    if tuple(limits.shape) != (2, d):
        raise ValueError(f"limits must be (2, {d}), got {tuple(limits.shape)}")
    if tuple(seeds.shape) != (s, 2) or seeds.dtype != torch.int32:
        raise ValueError("seeds must be an (S, 2) int32 tensor")
    if uniforms is not None:
        want = (s, num_draws(pso), d, num_particles)
        if tuple(uniforms.shape) != want:
            raise ValueError(f"uniforms must be {want}, got {tuple(uniforms.shape)}")
    return layout


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
    num_obstacles: int = 0,
    observe: Optional[Callable[[torch.Tensor], None]] = None,
    use_orientation: bool = False,
    on_kick: Optional[Callable[[torch.Tensor], None]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused solve on ``(S, P, D)`` tensors; returns ``(gbest (S, D),
    gval (S,))``. Same update order and rounding as kernel A, in the JAX
    body's order (``ikpso_tpu/pso/fused.py:383-458``): at each re-kick
    block start but the first, v is redrawn for the swarms whose min lval
    is above the threshold (all swarms without one); gbest is refreshed
    where ``it % gbest_interval == 0``, by ``torch.argmin``, whose
    first-occurrence rule sends ties (at ``COLLISION_PENALTY`` too) to the
    lowest particle id. ``observe``, if given, sees every ``(S, P, D)``
    position tensor the solve evaluates (``utils/flops.py`` counts the
    collider work on them); ``on_kick``, the ``(S,)`` mask of the swarms
    kicked at each block start (it counts the kicks)."""
    check_supported(pso, fit, num_obstacles)
    _check_args(spec, pso, fit, swarm, limits, seeds, num_particles, uniforms,
                num_obstacles, use_orientation)
    interval = gbest_interval(pso)
    s, d, p = swarm.shape[0], spec.dof, num_particles

    def draw(slot):
        if uniforms is not None:
            return uniforms[:, slot].transpose(1, 2)
        return philox_uniform(seeds, slot, p, d)

    def fitness_of(x):
        if observe is not None:
            observe(x)
        return fk_fitness_plain(spec, x, meta, swarm, num_obstacles=num_obstacles,
                                collision_shape=fit.collision_shape,
                                gizmo_size=fit.gizmo_size,
                                use_distance_term=uses_distance(fit),
                                use_orientation=use_orientation, trig_impl=fit.trig_impl)

    lay = MetaLayout(spec, num_obstacles)
    lo, hi = limits[0], limits[1]
    rows = torch.arange(s, device=swarm.device)
    n_init = n_init_draws(pso)
    x = swarm[:, None, lay.OFF_ANCHOR:lay.OFF_ANCHOR + d].expand(s, p, d)
    if pso.init_mode != "warm":
        lo_c = torch.clamp_min(lo, -TWO_PI)
        hi_c = torch.clamp_max(hi, TWO_PI)
        x0 = lo_c + draw(0) * (hi_c - lo_c)
        if pso.init_mode == "hybrid":
            x0[:, 0] = x[:, 0]
        x = x0
    v = (draw(n_init - 1) * 2.0 - 1.0) * float(np.float32(pso.init_velocity_scale))
    lbest = x
    lval = fitness_of(x)
    c1, c2 = float(np.float32(pso.cognitive)), float(np.float32(pso.social))
    dpi = draws_per_iter(pso)
    randomized = pso.inertia_mode == "randomized"
    rk = pso.rekick_interval
    kick_scale = float(np.float32(pso.rekick_scale))
    kick_threshold = float(np.float32(pso.rekick_threshold))
    for it, w in enumerate(inertia_schedule(pso)):
        if rk and it and it % rk == 0:
            kick = (draw(n_init + it * dpi + dpi - 1) * 2.0 - 1.0) * kick_scale
            kicked = torch.ones(s, dtype=torch.bool, device=swarm.device)
            if pso.rekick_threshold >= 0.0:
                kicked = lval.min(dim=1).values > kick_threshold
                kick = torch.where(kicked[:, None, None], kick, v)
            if on_kick is not None:
                on_kick(kicked)
            v = kick
        if it % interval == 0:
            gb = lbest[rows, torch.argmin(lval, dim=1)][:, None, :]
        base = n_init + dpi * it
        u_c = draw(base)
        u_s = draw(base + 1)
        inert = float(w) * draw(base + 2) * v if randomized else float(w) * v
        v = inert + c1 * u_c * (lbest - x) + c2 * u_s * (gb - x)
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
    num_obstacles: int = 0,
    use_orientation: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A: one PSO solve per swarm; returns ``(gbest (S, D), gval (S,))``.

    CPU tensors run :func:`fused_solve_plain`; CUDA tensors launch the
    kernel or raise. ``meta`` carries ``num_obstacles`` scene boxes
    (``pack_meta``); ``fit.collision_shape`` picks the collider;
    ``use_orientation`` adds the orientation term (meta and swarm packed
    with it).
    """
    check_supported(pso, fit, num_obstacles)
    layout = _check_args(spec, pso, fit, swarm, limits, seeds, num_particles, uniforms,
                         num_obstacles, use_orientation)
    check_meta(spec, meta, num_obstacles, use_orientation)
    check_swarm(spec, swarm, num_obstacles, use_orientation)
    interval = gbest_interval(pso)
    if swarm.device.type == "cpu":
        return fused_solve_plain(spec, pso, fit, meta, swarm, limits, seeds,
                                 num_particles, uniforms, num_obstacles,
                                 use_orientation=use_orientation)
    if swarm.device.type != "cuda":
        raise ValueError(f"fused_solve: unsupported device {swarm.device}")
    return _launch(spec, pso, fit, meta, swarm, limits, seeds, num_particles, uniforms,
                   num_obstacles, use_orientation, layout, interval)


def _launch(spec, pso, fit, meta, swarm, limits, seeds, num_particles, uniforms,
            num_obstacles, use_orientation, layout, interval):
    """Kernel A's launch on ``swarm``'s device, after :func:`fused_solve`'s
    checks (``layout`` from ``_check_args``); counts it."""
    distance = uses_distance(fit)
    topo, collider, orient = kernels.kernel_variant(spec, num_obstacles,
                                                    fit.collision_shape, use_orientation,
                                                    distance, fit.trig_impl)
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
    replay = int(uniforms is not None)
    update = (
        limits.data_ptr(), seeds.data_ptr(), inertia.data_ptr(), pso.iterations,
        float(np.float32(pso.cognitive)), float(np.float32(pso.social)),
        float(np.float32(pso.init_velocity_scale)),
        int(pso.inertia_mode == "randomized"), interval, pso.rekick_interval,
        float(np.float32(pso.rekick_scale)), float(np.float32(pso.rekick_threshold)),
        None if uniforms is None else uniforms.data_ptr(), num_draws(pso),
    )
    if topo == kernels.ON_DEMAND:
        _launch_on_demand(kernels.on_demand_key(spec, collider, orient, distance,
                                                fit.trig_impl == "exact"),
                          INIT_MODES[pso.init_mode], replay, num_obstacles,
                          scene_constants(fit.gizmo_size), meta, swarm, update, gbest,
                          gval, num_particles, layout)
    elif topo == kernels.SERIAL:
        _launch_serial(spec, INIT_MODES[pso.init_mode], replay, meta, swarm, update,
                       gbest, gval, num_particles, layout)
    else:
        rc = kernels.library().ikpso_fused_solve(
            topo, collider, orient, replay, INIT_MODES[pso.init_mode],
            num_obstacles, *scene_constants(fit.gizmo_size),
            meta.data_ptr(), meta.numel(), swarm.data_ptr(), swarm.shape[1], *update,
            gbest.data_ptr(), gval.data_ptr(), s, num_particles, layout.threads,
            kernels.stream_ptr(dev),
        )
        kernels.check(rc, "fused_solve")
    fused_solve.launches += 1
    variant = (f"{kernels.topology_name(spec)}/{pso.init_mode}/"
               f"{fit.collision_shape if num_obstacles else 'none'}")
    for flag, on in (("orientation", use_orientation), ("distance", distance),
                     ("exact", fit.trig_impl == "exact")):
        if on:
            variant += f"/{flag}"
    fused_solve.variant_launches[variant] = fused_solve.variant_launches.get(variant, 0) + 1
    return gbest, gval


def _scratch(layout, grid, d, p, device):
    """The scratch layout's global scratch: ``(grid, planes, D, P)``, x and
    v and, where lbest is not in shared memory, lbest (``layout``)."""
    return torch.empty((grid, layout.scratch_planes, d, p), dtype=torch.float32,
                       device=device)


def _launch_serial(spec, init_mode, replay, meta, swarm, update, gbest, gval,
                   num_particles, layout):
    """Launch kernel A's serial-chain variant: a grid of the blocks that fit
    the card at once strides over the swarms, each block keeping its
    swarm's state in a slice of a scratch allocated here on the caller's
    device (:func:`_scratch`)."""
    lib = kernels.library()
    s, d, p = swarm.shape[0], spec.dof, num_particles
    shared = int(layout.placement == "shared")
    blocks = lib.ikpso_fused_solve_serial_blocks(replay, shared, p, meta.numel(),
                                                 swarm.shape[1], spec.num_nodes)
    if blocks <= 0:
        raise RuntimeError(f"fused_solve: no block of the serial-chain variant fits "
                           f"the card at D={d}, P={p}")
    grid = min(s, blocks)
    scratch = _scratch(layout, grid, d, p, swarm.device)
    rc = lib.ikpso_fused_solve_serial(
        replay, shared, init_mode, spec.num_nodes, meta.data_ptr(), meta.numel(),
        swarm.data_ptr(), swarm.shape[1], *update, scratch.data_ptr(), grid,
        gbest.data_ptr(), gval.data_ptr(), s, p, kernels.stream_ptr(swarm.device),
    )
    kernels.check(rc, "fused_solve")


def _launch_on_demand(key, init_mode, replay, num_obstacles, scene, meta, swarm, update,
                      gbest, gval, num_particles, layout):
    """Launch kernel A from the on-demand library of ``key``: in the cluster
    layout where ``layout.cluster`` is set (that many blocks a swarm, a grid
    of the clusters that fit the card at once striding over the swarms, no
    scratch), else in the key's own layout, whose scratch layout takes a
    scratch sized as :func:`_launch_serial`'s."""
    lib = kernels.on_demand_library(key)
    s, p = swarm.shape[0], num_particles
    stream = kernels.stream_ptr(swarm.device)
    if layout.cluster:
        c = layout.cluster
        clusters = lib.ikpso_od_fused_solve_cluster_blocks(replay, c, p, meta.numel(),
                                                           swarm.shape[1])
        if clusters <= 0:
            raise RuntimeError(f"fused_solve: no cluster of the cluster layout fits the "
                               f"card for {key.name()} at P={p}, c={c}")
        rc = lib.ikpso_od_fused_solve_cluster(
            replay, c, init_mode, num_obstacles, *scene, meta.data_ptr(), meta.numel(),
            swarm.data_ptr(), swarm.shape[1], *update, min(s, clusters),
            gbest.data_ptr(), gval.data_ptr(), s, p, stream)
        kernels.check(rc, "fused_solve")
        return
    scratch, grid = None, 0
    if key.scratch:
        blocks = lib.ikpso_od_fused_solve_blocks(replay, p, meta.numel(), swarm.shape[1])
        if blocks <= 0:
            raise RuntimeError(f"fused_solve: no block of the scratch layout fits the "
                               f"card for {key.name()} at P={p}")
        grid = min(s, blocks)
        scratch = _scratch(layout, grid, 3 * (len(key.parents) - 1), p, swarm.device)
    rc = lib.ikpso_od_fused_solve(
        replay, init_mode, num_obstacles, *scene, meta.data_ptr(), meta.numel(),
        swarm.data_ptr(), swarm.shape[1], *update,
        None if scratch is None else scratch.data_ptr(), grid,
        gbest.data_ptr(), gval.data_ptr(), s, p, stream)
    kernels.check(rc, "fused_solve")


# Launch counts: in all, and per (topology / init mode / collider
# [/ orientation][/ distance][/ exact]) variant.
fused_solve.launches = 0
fused_solve.variant_launches = {}


def make_fused_solver(
    spec: ChainSpec,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 1024,
    *,
    device="cuda",
):
    """A ``(problem, generator) -> SolveResult`` running kernel A.

    The positional order is JAX's (``spec, pso, fit, obstacles,
    num_particles``); ``device`` is keyword-only. Runs on the card unless
    ``device`` says otherwise (``"cpu"`` runs the plain solve); raises
    when the card is asked for and none is visible.
    Packs the constants (scene boxes included) as
    ``ikpso_tpu/pso/fused.py:742-764`` does -- with the orientation term
    when the weight is non-zero and the problem carries target rotations
    -- draws ``(S, 2)`` seed words from the generator, and computes the
    solved pose and the row-FK effector error.
    """
    num_obstacles = 0 if obstacles is None else obstacles.count
    check_supported(pso, fit, num_obstacles)
    gbest_interval(pso)
    from ikpso_tpu_torch.pso.polish_soa import (
        anchor_positions_flat,
        true_effector_error_rows,
    )

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_fused_solver: device cuda requested but no CUDA "
                           "device is visible; pass device='cpu' for the plain solve")
    limits = spec.limits().to(device)
    use_orientation_w = float(fit.orientation_weight) != 0.0
    metas = {o: pack_meta(spec, fit, obstacles, o).to(device)
             for o in {False, use_orientation_w}}

    def _solve(problem: IKProblem, generator: torch.Generator) -> SolveResult:
        use_orientation = use_orientation_w and problem.target_rot is not None
        anchor_angles = fk_ops.pose_to_angles(spec, problem.pose)
        swarm = pack_swarm(spec, problem, anchor_angles,
                           anchor_positions_flat(spec, problem), use_orientation)
        s = swarm.shape[0]
        seeds = torch.randint(
            -2**31, 2**31, (s, 2), generator=generator,
            device=generator.device, dtype=torch.int32,
        ).to(device)
        gbest, gval = fused_solve(spec, pso, fit, metas[use_orientation], swarm, limits,
                                  seeds, num_particles, num_obstacles=num_obstacles,
                                  use_orientation=use_orientation)
        return SolveResult(
            angles=gbest,
            fitness=gval,
            pose=fk_ops.angles_to_pose(spec, problem.pose[..., 0, :], gbest),
            effector_error=true_effector_error_rows(spec, problem, gbest),
            trace=gval[None],
        )

    return _solve
