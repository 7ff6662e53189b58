"""The scan solver on kernel C and the scan step, end to end.

Torch twin of ``python bench.py --impl pallas`` on ``arm_7dof``: with
``impl != "fused"`` bench's defaults resolve (``bench.py:1004,
1028-1029, 1042-1063``) to

  1. S = 16,384 targets, each the FK effector position of random
     in-limit angles (built as ``harness/headline.py`` builds them);
  2. one swarm per target, P = 1,024 particles, 60 iterations of the
     scan solver (``pso/solver.py``): randomized inertia (0.5, 0.5,
     1.25), warm init, position-only cost (``bench.py:168-173``);
  3. no re-kick, no polish, no retries;

and kernel C (``make_kernel_fitness``, ``bench.py:184-196``) evaluates
the fitness: on the card once at init, then each iteration is one launch
of the scan step (``csrc/scan_step.cu(h)``), which inlines the same
evaluation -- 1 kernel C and ``iterations`` step launches per solve.

Run: ``python -m ikpso_tpu_torch.harness.scan [--swarms S]
[--iterations I] [--device cuda] [--seed N]`` prints the result dict as
one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ikpso_tpu_torch.harness.headline import reachable_targets
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.fitness_kernel import fused_fitness, make_kernel_fitness
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.solver import make_solver, scan_step
from ikpso_tpu_torch.utils.profiling import measure

MODEL = "arm_7dof"
SWARMS = 16_384
PARTICLES = 1_024
ITERATIONS = 60


def scan_configs(iterations: int = ITERATIONS):
    """bench.py's scan-solver settings: randomized inertia, warm init,
    position-only cost."""
    pso = PSOConfig(iterations=iterations, inertia_mode="randomized", init_mode="warm")
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0, orientation_weight=0.0)
    return pso, fit


def build_scan_solver(spec, batched, particles: int, iterations: int):
    """The scan solver with kernel C as its ``fitness_fn``."""
    pso, fit = scan_configs(iterations)
    return make_solver(spec, pso=pso, fit=fit, num_particles=particles,
                       fitness_fn=make_kernel_fitness(spec, batched, fit))


def run_scan(swarms: int = SWARMS, particles: int = PARTICLES,
             iterations: int = ITERATIONS, device="cuda", seed: int = 0,
             warmup: int = 1, iters: int = 3) -> dict:
    """Build targets and the solver as bench.py does; time the whole
    solve (median of ``iters`` after ``warmup``) and score the last
    result."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_scan: device cuda requested but no GPU is visible")
    spec, problem = library.arm_7dof(device=device)
    gen_targets = torch.Generator(device=device).manual_seed(seed)
    gen_solve = torch.Generator(device=device).manual_seed(seed + 1)
    batched = library.batched_problem(
        problem, reachable_targets(spec, problem, swarms, gen_targets))
    solver = build_scan_solver(spec, batched, particles, iterations)
    before = fused_fitness.launches, scan_step.launches
    res, wall = measure(solver, batched, gen_solve, device=device,
                        warmup=warmup, iters=iters)
    launches = fused_fitness.launches - before[0]
    steps = scan_step.launches - before[1]
    calls = max(warmup, 0) + max(iters, 1)
    err_mm = res.effector_error.double().cpu().numpy() * 1000.0
    return dict(
        model=MODEL,
        impl="kernel",  # bench.py --impl pallas
        swarms=swarms,
        particles=particles,
        iterations=iterations,
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
        wall_s=wall,
        solves_per_s=swarms / wall,
        p50_err_mm=float(np.percentile(err_mm, 50)),
        p90_err_mm=float(np.percentile(err_mm, 90)),
        frac_under_1mm=float((err_mm < 1.0).mean()),
        failures_ge_1mm=int((err_mm >= 1.0).sum()),
        finite=bool(np.isfinite(err_mm).all()),
        fused_fitness_launches=launches,
        fused_fitness_launches_per_solve=launches / calls,
        scan_step_launches=steps,
        scan_step_launches_per_solve=steps / calls,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--swarms", type=int, default=SWARMS)
    ap.add_argument("--particles", type=int, default=PARTICLES)
    ap.add_argument("--iterations", type=int, default=ITERATIONS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run_scan(args.swarms, args.particles, args.iterations,
                              args.device, args.seed)), flush=True)


if __name__ == "__main__":
    main()
