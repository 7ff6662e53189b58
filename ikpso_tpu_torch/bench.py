"""The port's benchmark entry: batched IK solves/s on one card to < 1 mm.

Port of the root ``bench.py`` (all of it but ``--selftest``): the same
flags, the same per-model recipes (``pso/presets.py``) and the same JSON
record, with ``failures_ge_1mm`` beside ``frac_under_1mm`` and without
the TPU's ``swarms_per_tile``.

Protocol: S reachable targets, each the effector positions of random
in-limit joint angles (with ``--orientation`` also their effector
rotations; with ``--obstacles N`` an N-box scene, scored on the targets
whose generating pose is collision-free), one batched solve of the
model's recipe, timed as the median of 5 calls after 2 warm-ups, each
call on its own generator (``utils.seeds.fold_in(seed, call)``);
solves/s = S / wall.

  * ``--impl fused`` (``auto`` on the card): kernel A with kernel B inlined;
    where kernel A refuses the configuration (its thread-block bound or
    its shared memory), the entry exits with kernel A's error and names
    ``--impl pallas`` and ``--impl jnp`` as the explicit choices;
  * ``--impl pallas``: the scan solver with kernel C as its fitness;
  * ``--impl jnp`` (``auto`` with ``--cpu``): the scan solver on the plain
    fitness.

Extras: ``--sol`` (on by default for ``arm_7dof`` on the card, without
``--latency`` or ``--obstacles``) prints kernel A's speed-of-light
fraction to stderr after the record; ``--latency`` times an S=1,280
batch, the host's dispatch of a trivial op, the 64x-batch slope and a
chain of 64 runs with no synchronization of the bench's own between
them. The chain still holds the solve's own host synchronizations (the
retry rounds and the polish read results on the host; a stderr line
counts them), so ``chained_ms`` includes the host's dispatch, unlike
JAX's single-program chain.

Run: ``python -m ikpso_tpu_torch.bench [--cpu] [--model M] ...`` prints
ONE JSON line on stdout (progress, the kernels' launch counts and the
peak device memory go to stderr). It runs on the card unless ``--cpu``
is given, and exits non-zero when no card is visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import sys
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ikpso_tpu_torch.harness.cli import device_of
from ikpso_tpu_torch.harness.headline import headline_bucket, reachable_pose
from ikpso_tpu_torch.harness.obstacles import obstacle_scene, pose_collides
from ikpso_tpu_torch.harness.orientation import orientation_error_deg, orientation_targets
from ikpso_tpu_torch.harness.trees import model_spec, tree_configs
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.fitness_kernel import fused_fitness, make_kernel_fitness
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.fused import fused_solve, make_fused_solver
from ikpso_tpu_torch.pso.polish import wrap_with_polish
from ikpso_tpu_torch.pso.presets import FUSED_PRESETS
from ikpso_tpu_torch.pso.restarts import wrap_solver_with_target_walk, wrap_with_topk_retries
from ikpso_tpu_torch.pso.solver import SolveResult, make_solver, scan_step
from ikpso_tpu_torch.utils import roofline, seeds
from ikpso_tpu_torch.utils.flops import fused_solve_count
from ikpso_tpu_torch.utils.profiling import measure, trace

# >= 10k 7-DOF solves under 1 mm in < 10 ms on 8 chips (BASELINE.json), per chip.
BASELINE_SOLVES_PER_S_PER_CHIP = 125_000.0
# --latency: the per-chip share of the 10k-solve target, rounded up to 256.
LATENCY_SWARMS = 1280
CHAINED_RUNS = 64
LATENCY_SLOPE = 64  # the device-time slope's large batch, in units of S
# Poses per call of the plain collider when the feasibility mask is built.
FEASIBILITY_CHUNK = 65_536
# Seed of the targets and of the solves' generators (JAX's `random.key(0)`).
SEED = 0
# Seed offset of the latency chain's calls (JAX folds 500 + i).
CHAIN_SEED_OFFSET = 500

_T0 = time.time()


def progress(msg: str) -> None:
    """A stderr line with the seconds since start."""
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--swarms", type=int, default=None,
                    help="batch size (default: the preset's with --impl fused, else "
                    "16,384; 1,280 with --latency)")
    ap.add_argument("--particles", type=int, default=None,
                    help="particles per swarm (default: the preset's with --impl "
                    "fused, else 1,024)")
    ap.add_argument("--iterations", type=int, default=None,
                    help="PSO iterations (default: the preset's with --impl fused, "
                    "else 20 canonical / 60 randomized)")
    ap.add_argument("--inertia-mode", choices=("canonical", "randomized"), default=None,
                    help="default: canonical with --impl fused, else randomized")
    ap.add_argument("--init-mode", choices=("warm", "uniform", "hybrid"), default="warm")
    ap.add_argument("--retry-init-mode", choices=("warm", "uniform", "hybrid"),
                    default=None, help="swarm init of the retry rounds (default: the "
                    "preset's)")
    ap.add_argument("--impl", choices=("auto", "jnp", "pallas", "fused"), default="auto",
                    help="fused: kernel A; pallas: the scan solver on kernel C; jnp: "
                    "the scan solver on the plain fitness; auto: fused on the card, jnp "
                    "with --cpu")
    ap.add_argument("--model", default="arm_7dof", metavar="MODEL",
                    help=f"one of {sorted(FUSED_PRESETS)} or snake:<links>")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--orientation", action="store_true",
                    help="position + orientation targets; adds the p50/p90 "
                    "geodesic orientation error")
    ap.add_argument("--retries", type=int, default=None,
                    help="top-k retry rounds (default: the preset's)")
    ap.add_argument("--retry-iterations", type=int, default=None, metavar="N",
                    help="PSO iterations of the retry rounds (default: the preset's)")
    ap.add_argument("--retry-bucket", type=int, default=None, metavar="N",
                    help="swarms re-solved per retry round (default: the preset's, "
                    "else S/16 or S/32, at least 1,024, at most S/8)")
    ap.add_argument("--walk", type=int, default=0, metavar="W",
                    help="run the base solve as a W-step warm target walk")
    ap.add_argument("--retry-bucket-decay", type=int, default=None, metavar="K",
                    help="shrink the retry bucket K-fold each round (default: the "
                    "preset's; 1 with a scene)")
    ap.add_argument("--retry-walk", type=int, default=None, metavar="W",
                    help="retry rounds re-solve by a W-step warm target walk "
                    "(default: the preset's)")
    ap.add_argument("--retry-walk-jitter", type=float, default=None, metavar="J",
                    help="random waypoint offsets of the retry walks, J x the span "
                    "(default: the preset's)")
    ap.add_argument("--rekick-interval", type=int, default=None,
                    help="velocity re-kick every N iterations (default: the "
                    "preset's when it divides the iterations)")
    ap.add_argument("--rekick-scale", type=float, default=0.5)
    ap.add_argument("--rekick-threshold", type=float, default=1e-6)
    ap.add_argument("--polish", type=int, default=None, metavar="K",
                    help="LM polish steps (default: the preset's)")
    ap.add_argument("--obstacles", type=int, default=0, metavar="N",
                    help="an N-box scene; scored on the collision-free targets")
    ap.add_argument("--fk-impl", choices=("unrolled", "scan"), default="unrolled",
                    help="the plain fitness's FK (the scan solver's)")
    ap.add_argument("--collision-shape", choices=("box", "capsule"), default="box")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace of the measured solves")
    ap.add_argument("--record", default=None, metavar="FILE",
                    help="append the record (with model and session) to FILE")
    ap.add_argument("--session", default=None, help="session tag of --record lines")
    ap.add_argument("--sol", action="store_true",
                    help="measure kernel A's speed-of-light fraction after the record")
    ap.add_argument("--no-sol", action="store_true",
                    help="turn off --sol's default for arm_7dof on the card")
    ap.add_argument("--latency", action="store_true",
                    help="time one S=1,280 batch, the dispatch, the 64x slope and "
                    "a chain of 64 runs")
    return ap


def resolve_recipe(args, platform: str) -> dict:
    """The keyword arguments of :func:`target_p50_under_1mm` for parsed
    ``args`` on ``platform`` (``"gpu"`` or ``"cpu"``): ``bench.py``'s
    resolution (``bench.py:960-1093``) line for line, less the TPU's
    tile packing and VMEM gate. ``auto`` is ``fused`` on the card and
    ``jnp`` on the CPU."""
    try:
        pre, _, _ = tree_configs(args.model)
    except ValueError as err:
        raise SystemExit(f"error: {err}") from None
    impl = args.impl
    if impl == "auto":
        impl = "fused" if platform == "gpu" else "jnp"
    fused = impl == "fused"
    inertia_mode = args.inertia_mode or ("canonical" if fused else "randomized")
    if args.swarms is not None:
        swarms = args.swarms
    elif args.latency:
        swarms = LATENCY_SWARMS
    else:
        swarms = pre.swarms if fused else 16384
    particles = args.particles or (pre.particles if fused else 1024)
    default_iters = pre.iterations if fused else (20 if inertia_mode == "canonical" else 60)
    iterations = args.iterations or default_iters
    if args.rekick_interval is not None:
        rekick_interval = args.rekick_interval
    elif fused and pre.rekick_interval and iterations % pre.rekick_interval == 0:
        rekick_interval = pre.rekick_interval
    else:
        rekick_interval = 0
    on_preset = fused and iterations == pre.iterations
    polish = args.polish if args.polish is not None else (pre.polish if on_preset else 0)
    retries = args.retries if args.retries is not None else (
        pre.retries if on_preset else 0)
    # The preset's retry settings apply wherever fused retries run and the
    # flag is not given.
    preset_retry = bool(retries) and fused

    def retry_default(flag, value):
        return flag if flag is not None else (value if preset_retry else None)

    # Scenes keep constant buckets: their failures are wrong-basin and do
    # not shrink geometrically (bench.py:1078-1093).
    if args.retry_bucket_decay is not None:
        decay = args.retry_bucket_decay
    else:
        decay = pre.retry_bucket_decay if fused and not args.obstacles else 1
    sol_default = (not args.no_sol and args.model == "arm_7dof" and not args.latency
                   and not args.obstacles)
    kernel_sol = fused and platform == "gpu" and (args.sol or sol_default)
    if kernel_sol and not args.sol:
        progress("--sol is on by default for arm_7dof on the card (the record prints "
                 "first)")
    return dict(
        model=args.model, seed=SEED, swarms=swarms, num_particles=particles,
        iterations=iterations, impl=impl, inertia_mode=inertia_mode,
        init_mode=args.init_mode,
        retry_init_mode=retry_default(args.retry_init_mode, pre.retry_init_mode),
        retries=retries, orientation=args.orientation, rekick_interval=rekick_interval,
        rekick_scale=args.rekick_scale, rekick_threshold=args.rekick_threshold,
        obstacles=args.obstacles, polish=polish, collision_shape=args.collision_shape,
        fk_impl=args.fk_impl, kernel_sol=kernel_sol,
        retry_iterations=retry_default(args.retry_iterations, pre.retry_iterations),
        retry_bucket=retry_default(args.retry_bucket, pre.retry_bucket),
        chained_runs=CHAINED_RUNS if args.latency else 0,
        retry_walk=retry_default(args.retry_walk, pre.retry_walk) or 0,
        retry_walk_jitter=retry_default(args.retry_walk_jitter, pre.retry_walk_jitter) or 0.0,
        walk=args.walk, retry_bucket_decay=decay,
    )


@dataclasses.dataclass
class BenchRun:
    """What one measured recipe gives: the stats the record reads, the
    last timed call's result, and kernel A's speed-of-light measurement,
    deferred until the record has printed (None where it is off)."""

    stats: dict
    result: SolveResult
    sol: Optional[Callable[[], dict]] = None


def call_generator(seed: int, call: int, device) -> torch.Generator:
    """The generator of timed call ``call`` of a solve stream seeded
    ``seed`` (``jax.random.fold_in(key, call)``)."""
    return seeds.generator(seeds.fold_in(seed, call), device)


def target_p50_under_1mm(model: str, *, seed: int, swarms: int, num_particles: int,
                         iterations: int, impl: str, inertia_mode: str, init_mode: str,
                         retry_init_mode, retries: int, orientation: bool,
                         rekick_interval: int, rekick_scale: float,
                         rekick_threshold: float, obstacles: int, polish: int,
                         collision_shape: str, fk_impl: str, kernel_sol: bool,
                         retry_iterations, retry_bucket, chained_runs: int,
                         retry_walk: int, retry_walk_jitter: float, walk: int,
                         retry_bucket_decay: int, device, warmup: int = 2,
                         iters: int = 5) -> BenchRun:
    """Build the targets, the scene and the recipe's solver on ``device``
    and time the whole solve (``bench.py:74-353``): the median of
    ``iters`` calls after ``warmup``, call i on
    ``call_generator(solve seed, i)``; then score the last call's result
    (on the feasible targets with a scene)."""
    device = torch.device(device)
    spec, problem = model_spec(model, device)
    scene = obstacle_scene(spec, obstacles, device) if obstacles else None
    target_seed, solve_seed = seeds.split(seed)
    pose = reachable_pose(spec, problem, swarms, seeds.generator(target_seed, device))
    if orientation:
        targets, target_rot = orientation_targets(spec, problem, pose)
    else:
        targets = fk_ops.fk_points(spec, pose, problem.origin)[:, list(spec.effector_idx)]
        target_rot = None
    batched = library.batched_problem(problem, targets, target_rot=target_rot)
    # With a scene, only targets whose generating pose is collision-free
    # are scored: a blocked target says nothing about the solver.
    feasible = None
    if scene is not None:
        feasible = torch.cat([
            ~pose_collides(spec, pose[i:i + FEASIBILITY_CHUNK], problem.origin, scene,
                           collision_shape)
            for i in range(0, swarms, FEASIBILITY_CHUNK)]).cpu().numpy()
    del pose

    pso_kw = dict(iterations=iterations, rekick_interval=rekick_interval,
                  rekick_scale=rekick_scale, rekick_threshold=rekick_threshold,
                  init_mode=init_mode)
    if inertia_mode == "canonical":
        pso = PSOConfig(inertia_mode="canonical", inertia=0.5, inertia_end=0.2, **pso_kw)
    else:
        pso = PSOConfig(inertia_mode=inertia_mode, **pso_kw)
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0,
                        orientation_weight=1.0 if orientation else 0.0,
                        collision_shape=collision_shape, fk_impl=fk_impl)

    def build(pso_cfg):
        if impl == "fused":
            solver = make_fused_solver(spec, pso_cfg, fit, scene, num_particles,
                                       device=device)
        else:
            fitness_fn = (make_kernel_fitness(spec, batched, fit, scene)
                          if impl == "pallas" else None)
            solver = make_solver(spec, pso_cfg, fit, scene, num_particles,
                                 fitness_fn=fitness_fn)
        if polish:
            solver = wrap_with_polish(solver, spec, steps=polish,
                                      use_orientation=orientation, obstacles=scene,
                                      collision_backend=fit.collision_backend,
                                      collision_shape=fit.collision_shape,
                                      gizmo_size=fit.gizmo_size)
        if walk:
            solver = wrap_solver_with_target_walk(solver, spec, walk)
        return solver

    solver = wrap_with_topk_retries(
        build, pso, rounds=retries,
        bucket=retry_bucket or headline_bucket(swarms, retry_bucket_decay),
        retry_init_mode=retry_init_mode, retry_iterations=retry_iterations, spec=spec,
        retry_walk_steps=retry_walk, retry_walk_jitter=retry_walk_jitter,
        bucket_decay=retry_bucket_decay,
    )
    progress(f"measuring the solve (S={swarms}, P={num_particles}, I={iterations}, "
             f"impl={impl}, {warmup} warm-ups and {iters} timed calls)")
    res, wall = measure(solver, batched, solve_seed, device=device, warmup=warmup,
                        iters=iters,
                        vary=lambda i, a: (a[0], call_generator(a[1], i, device)))
    progress(f"measured wall {wall * 1e3:.1f} ms per batch")
    err_mm = res.effector_error.double().cpu().numpy() * 1000.0
    scored = err_mm if feasible is None else err_mm[feasible]
    # The counted work of the base PSO stage: polish and retries add
    # uncounted work, so this is a floor on the delivered operations.
    count = fused_solve_count(spec, pso, fit, num_particles=num_particles,
                              num_swarms=swarms, num_obstacles=obstacles,
                              use_orientation=orientation)
    stats = dict(
        wall_s=wall,
        solves_per_s=swarms / wall,
        p50_err_mm=float(np.percentile(scored, 50)),
        p90_err_mm=float(np.percentile(scored, 90)),
        frac_under_1mm=float((scored < 1.0).mean()),
        failures_ge_1mm=int((scored >= 1.0).sum()),
        gflops=count.flops / wall / 1e9,
        gtranscendentals=count.transcendentals / wall / 1e9,
    )
    if chained_runs:
        stats.update(chained(solver, batched, solve_seed, chained_runs, device))
    if feasible is not None:
        stats["frac_targets_feasible"] = float(feasible.mean())
    if orientation:
        ang = orientation_error_deg(spec, res.pose, batched).double().cpu().numpy()
        stats["p50_orient_err_deg"] = float(np.percentile(ang, 50))
        stats["p90_orient_err_deg"] = float(np.percentile(ang, 90))
    sol = None
    if impl == "fused" and kernel_sol:
        sol = functools.partial(kernel_sol_frac, spec, batched, pso, fit, scene,
                                particles=num_particles, device=device, seed=solve_seed)
    return BenchRun(stats, res, sol)


def host_syncs(solver, batched, generator) -> int:
    """Host synchronizations one call of ``solver`` makes on the card,
    counted by ``torch.cuda.set_sync_debug_mode("warn")``'s warnings."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solver(batched, generator)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def chained(solver, batched, seed: int, runs: int, device) -> dict:
    """Milliseconds a run of ``runs`` full solves enqueued back to back,
    each on its own generator, with no synchronization of the bench's own
    between them, CUDA events around the chain on the card
    (``bench.py:285-330``). One chain, after the solve's own warm-up: the
    solve's host reads (retry rounds, polish gates) stay inside it, so a
    chain takes ``runs`` host-dispatched solves, where JAX's is one
    program timed 5 times."""
    device = torch.device(device)
    if device.type == "cuda":
        n = host_syncs(solver, batched, call_generator(seed, CHAIN_SEED_OFFSET, device))
        progress(f"one run makes {n} host synchronizations (torch.cuda."
                 "set_sync_debug_mode); chained_ms includes the host's dispatch")

    def chain(problem, chain_seed):
        total = torch.zeros((), device=device)
        for j in range(runs):
            total = total + solver(problem, call_generator(chain_seed, j, device)
                                   ).effector_error.sum()
        return total

    progress(f"measuring a chain of {runs} runs")
    _, wall = measure(chain, batched, seeds.fold_in(seed, CHAIN_SEED_OFFSET), device=device,
                      warmup=0, iters=1)
    return dict(chained_runs=runs, chained_ms_per_run=wall / runs * 1e3)


def dispatch_seconds(device, warmup: int = 2, iters: int = 9) -> float:
    """Host clock around an 8-element ``x + 1`` and a synchronize: the
    median of ``iters`` after ``warmup``."""
    device = torch.device(device)
    x = torch.zeros(8, device=device)
    samples = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        x.add(float(i + 1))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples[warmup:])


def kernel_sol_frac(spec, batched, pso, fit, scene, *, particles: int, device,
                    seed: int) -> dict:
    """Kernel A's speed-of-light fraction (``bench.py:659-715``): kernel A
    alone at I and 3I iterations, half the difference the wall of I loop
    iterations, over the bound of their counted work
    (``utils.roofline.megakernel_slope``; published peaks, so at most 1)."""
    wall, count = roofline.megakernel_slope(spec, batched, pso, fit, particles=particles,
                                            device=device, seed=seed, obstacles=scene)
    bound, _ = roofline.speed_of_light_seconds(count)
    return dict(kernel_wall_s=wall, kernel_gflops=count.flops / wall / 1e9,
                kernel_gtranscendentals=count.transcendentals / wall / 1e9,
                sol_frac=bound / wall)


def build_record(args, recipe: dict, stats: dict, platform: str) -> dict:
    """``bench.py``'s record (``bench.py:1181-1262``): the same keys under
    the same conditions, less ``swarms_per_tile``, with
    ``failures_ge_1mm``."""
    model_tag = args.model.replace(":", "")
    if args.latency:
        wall_ms = stats["wall_s"] * 1e3
        record = {
            "metric": f"{model_tag}_latency_ms_per_{recipe['swarms']}solve_run",
            "value": round(wall_ms, 3),
            "unit": "ms",
            "vs_baseline": round(10.0 / wall_ms, 4),
            "dispatch_ms": round(stats["dispatch_ms"], 3),
            "device_ms": round(stats["device_ms"], 3),
        }
        if "chained_ms_per_run" in stats:
            record["chained_ms"] = round(stats["chained_ms_per_run"], 4)
            record["chained_runs"] = stats["chained_runs"]
    else:
        value = stats["solves_per_s"]
        record = {
            "metric": ("7dof_ik_solves_per_s_per_chip" if args.model == "arm_7dof"
                       else f"{model_tag}_ik_solves_per_s_per_chip"),
            "value": round(value, 1),
            "unit": "solves/s/chip",
            "vs_baseline": round(value / BASELINE_SOLVES_PER_S_PER_CHIP, 4),
        }
    record.update({
        "platform": platform,
        "impl": recipe["impl"],
        "swarms": recipe["swarms"],
        "particles": recipe["num_particles"],
        "iterations": recipe["iterations"],
        "inertia_mode": recipe["inertia_mode"],
        "init_mode": recipe["init_mode"],
        "retry_init_mode": recipe["retry_init_mode"],
        "p50_err_mm": round(stats["p50_err_mm"], 4),
        "p90_err_mm": round(stats["p90_err_mm"], 4),
        "frac_under_1mm": round(stats["frac_under_1mm"], 4),
        "failures_ge_1mm": stats["failures_ge_1mm"],
        "obstacles": recipe["obstacles"],
        "wall_ms_per_solve_batch": round(stats["wall_s"] * 1e3, 3),
        "gflops": round(stats["gflops"], 1),
        "gtranscendentals": round(stats["gtranscendentals"], 1),
    })
    if recipe["walk"]:
        record["walk_steps"] = recipe["walk"]
    if "frac_targets_feasible" in stats:
        record["frac_targets_feasible"] = round(stats["frac_targets_feasible"], 4)
    if recipe["obstacles"]:
        record["collision_shape"] = recipe["collision_shape"]
    if recipe["fk_impl"] != "unrolled":
        record["fk_impl"] = recipe["fk_impl"]
    if recipe["retries"]:
        record["retries"] = recipe["retries"]
        if recipe["retry_iterations"]:
            record["retry_iterations"] = recipe["retry_iterations"]
        if recipe["retry_bucket"]:
            record["retry_bucket"] = recipe["retry_bucket"]
        if recipe["retry_walk"]:
            record["retry_walk"] = recipe["retry_walk"]
            if recipe["retry_walk_jitter"]:
                record["retry_walk_jitter"] = recipe["retry_walk_jitter"]
        if recipe["retry_bucket_decay"] != 1:
            record["retry_bucket_decay"] = recipe["retry_bucket_decay"]
    if recipe["polish"]:
        record["polish_steps"] = recipe["polish"]
    if recipe["rekick_interval"]:
        record["rekick_interval"] = recipe["rekick_interval"]
        record["rekick_scale"] = recipe["rekick_scale"]
        record["rekick_threshold"] = recipe["rekick_threshold"]
    if recipe["orientation"]:
        record["orientation"] = True
        record["p50_orient_err_deg"] = round(stats["p50_orient_err_deg"], 3)
        record["p90_orient_err_deg"] = round(stats["p90_orient_err_deg"], 3)
    return record


def _launch_counts(since: Optional[dict] = None) -> dict:
    """Kernel A's and C's and the scan step's launches (of which the replay
    step's; and kernel A's per variant) since the counts ``since``."""
    now = {"fused_solve": fused_solve.launches, "fused_fitness": fused_fitness.launches,
           "scan_step": scan_step.launches, "scan_step_replay": scan_step.replay_launches,
           "fused_solve_variants": dict(fused_solve.variant_launches)}
    if since is None:
        return now
    variants = {k: n - since["fused_solve_variants"].get(k, 0)
                for k, n in now["fused_solve_variants"].items()}
    return {**{k: now[k] - since[k] for k in ("fused_solve", "fused_fitness", "scan_step",
                                              "scan_step_replay")},
            "fused_solve_variants": {k: n for k, n in variants.items() if n}}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_of(args)
    platform = "gpu" if device.type == "cuda" else "cpu"
    if platform == "gpu":
        torch.cuda.reset_peak_memory_stats(device)
    progress(f"platform={platform}, device="
             f"{torch.cuda.get_device_name(device) if platform == 'gpu' else 'cpu'}")
    recipe = resolve_recipe(args, platform)
    launches0 = _launch_counts()
    try:
        with trace(args.profile):
            run = target_p50_under_1mm(**recipe, device=device)
    except ValueError as err:
        if recipe["impl"] != "fused":
            raise
        raise SystemExit(f"error: kernel A refuses this configuration: {err}; run "
                         "the scan solver with --impl pallas (kernel C) or --impl jnp "
                         "(the plain fitness)") from None
    stats = run.stats
    if args.latency:
        progress("measuring the dispatch of a trivial op")
        stats["dispatch_ms"] = dispatch_seconds(device) * 1e3
        progress(f"measuring the {LATENCY_SLOPE}x batch for the device-time slope")
        big = target_p50_under_1mm(**{**recipe, "swarms": recipe["swarms"] * LATENCY_SLOPE,
                                      "chained_runs": 0}, device=device)
        stats["device_ms"] = max(0.0, (big.stats["wall_s"] - stats["wall_s"])
                                 / (LATENCY_SLOPE - 1) * 1e3)
    record = build_record(args, recipe, stats, platform)
    # The record prints (and flushes) before any extra.
    print(json.dumps(record), flush=True)
    if run.sol is not None:
        progress("record printed; measuring kernel A's speed-of-light fraction")
        sol = run.sol()
        record["sol_frac"] = round(sol["sol_frac"], 4)
        record["kernel_wall_ms"] = round(sol["kernel_wall_s"] * 1e3, 3)
        record["kernel_gflops"] = round(sol["kernel_gflops"], 1)
        record["kernel_gtranscendentals"] = round(sol["kernel_gtranscendentals"], 1)
        print(json.dumps({k: record[k] for k in (
            "metric", "sol_frac", "kernel_wall_ms", "kernel_gflops",
            "kernel_gtranscendentals")}), file=sys.stderr, flush=True)
    print(json.dumps({
        "kernel_launches": _launch_counts(since=launches0),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if platform == "gpu" else None),
    }), file=sys.stderr, flush=True)
    if args.record:
        logged = {"model": args.model, **record}
        if args.session:
            logged = {"session": args.session, **logged}
        with open(args.record, "a") as fh:
            fh.write(json.dumps(logged) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
