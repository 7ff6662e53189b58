"""The 7-DOF headline solve, end to end.

Port of the main-path part of ``bench.py::_target_p50_under_1mm``
(``bench.py:74-284``) and of ``main()``'s preset resolution
(``bench.py:1000-1093``) for ``arm_7dof``: no obstacles, no
orientation, no walk, no speed-of-light extras.

  1. S targets, each the FK effector position of random in-limit angles;
  2. one swarm per target, P=128 particles, 8 PSO iterations of kernel A
     (warm init, canonical inertia 0.5 -> 0.2, position-only cost);
  3. 4 SoA LM polish steps, each kept only where it helps;
  4. 4 top-k retry rounds, buckets S/32 decaying 8x per round.

Run: ``python -m ikpso_tpu_torch.harness.headline [--swarms S]
[--device cuda] [--seed N]`` prints the result dict as one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.fused import make_fused_solver
from ikpso_tpu_torch.pso.polish import wrap_with_polish
from ikpso_tpu_torch.pso.presets import fused_preset
from ikpso_tpu_torch.pso.restarts import wrap_with_topk_retries
from ikpso_tpu_torch.utils.profiling import measure

MODEL = "arm_7dof"


def headline_bucket(swarms: int, bucket_decay: int) -> int:
    """First retry bucket, as bench.py:238-241 sizes it: S/32 for big
    decaying batches, else S/16; at least 1024, at most S/8."""
    div = 32 if bucket_decay > 1 and swarms >= 262144 else 16
    return min(max(1024, swarms // div), max(swarms // 8, 1))


def reachable_pose(spec, problem, swarms: int, generator: torch.Generator):
    """``(S, N, 3)`` poses of uniform in-limit joint angles."""
    limits = spec.limits()
    u = torch.rand((swarms, spec.dof), generator=generator,
                   device=generator.device, dtype=torch.float32)
    angles = limits[0] + u.to(limits.device) * (limits[1] - limits[0])
    return fk_ops.angles_to_pose(spec, problem.pose[0].expand(swarms, 3), angles)


def reachable_targets(spec, problem, swarms: int, generator: torch.Generator):
    """``(S, E, 3)`` effector positions of uniform in-limit joint angles."""
    pose = reachable_pose(spec, problem, swarms, generator)
    return fk_ops.fk_points(spec, pose, problem.origin)[
        :, list(spec.effector_idx), :
    ]


def headline_configs():
    """The preset and its base solve's PSO and fitness settings."""
    pre = fused_preset(MODEL)
    pso = PSOConfig(
        iterations=pre.iterations, inertia_mode="canonical",
        inertia=pre.inertia, inertia_end=pre.inertia_end,
        rekick_interval=pre.rekick_interval, init_mode="warm",
    )
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0,
                        orientation_weight=0.0)
    return pre, pso, fit


def build_headline_solver(spec, swarms: int, device):
    """The preset's solver: fused PSO + polish + top-k retries."""
    pre, pso, fit = headline_configs()

    def build(pso_cfg):
        solver = make_fused_solver(spec, pso=pso_cfg, fit=fit,
                                   num_particles=pre.particles, device=device)
        return wrap_with_polish(solver, spec, steps=pre.polish)

    return wrap_with_topk_retries(
        build, pso, rounds=pre.retries,
        bucket=pre.retry_bucket or headline_bucket(swarms, pre.retry_bucket_decay),
        retry_init_mode=pre.retry_init_mode,
        retry_iterations=pre.retry_iterations,
        bucket_decay=pre.retry_bucket_decay,
    )


def run_headline(swarms: int = None, device="cuda", seed: int = 0,
                 warmup: int = 1, iters: int = 3) -> dict:
    """Build targets, solver, polish and retries as bench.py does; time
    the whole solve (median of ``iters`` after ``warmup``) and score the
    last result."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_headline: device cuda requested but no GPU is visible")
    swarms = swarms or fused_preset(MODEL).swarms
    spec, problem = library.arm_7dof(device=device)
    gen_targets = torch.Generator(device=device).manual_seed(seed)
    gen_solve = torch.Generator(device=device).manual_seed(seed + 1)
    targets = reachable_targets(spec, problem, swarms, gen_targets)
    batched = library.batched_problem(problem, targets)
    solver = build_headline_solver(spec, swarms, device)
    res, wall = measure(solver, batched, gen_solve, device=device,
                        warmup=warmup, iters=iters)
    err_mm = res.effector_error.double().cpu().numpy() * 1000.0
    return dict(
        model=MODEL,
        swarms=swarms,
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
        wall_s=wall,
        solves_per_s=swarms / wall,
        p50_err_mm=float(np.percentile(err_mm, 50)),
        p90_err_mm=float(np.percentile(err_mm, 90)),
        frac_under_1mm=float((err_mm < 1.0).mean()),
        failures_ge_1mm=int((err_mm >= 1.0).sum()),
        finite=bool(np.isfinite(err_mm).all()),
    )


def headline_sol(swarms: int = None, device="cuda", seed: int = 0) -> dict:
    """Speed-of-light fraction of kernel A's loop on the headline batch,
    the twin of ``bench.py:659-715``: kernel A alone (no polish, no
    retries) at the preset's I and at 3I iterations; half the
    difference is the wall of I loop iterations, and
    ``sol_frac = bound / wall`` with the bound of their counted work
    (``utils.roofline.speed_of_light_seconds``: published peaks, never a
    measured rate, so the fraction cannot pass 1)."""
    from ikpso_tpu_torch.utils import roofline

    device = torch.device(device)
    pre, pso, fit = headline_configs()
    swarms = swarms or pre.swarms
    spec, problem = library.arm_7dof(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    batched = library.batched_problem(
        problem, reachable_targets(spec, problem, swarms, gen))
    wall, count = roofline.megakernel_slope(spec, batched, pso, fit,
                                            particles=pre.particles, device=device,
                                            seed=seed)
    t_sol, bound_by = roofline.speed_of_light_seconds(count)
    return dict(swarms=swarms, particles=pre.particles, iterations=pso.iterations,
                kernel_wall_s=wall, counted_ops=count.ops, ops_per_s=count.ops / wall,
                bound_s=t_sol, bound_by=bound_by, sol_frac=t_sol / wall)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--swarms", type=int, default=None,
                    help="batch size (default: the preset's 1,048,576)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run_headline(args.swarms, args.device, args.seed)), flush=True)


if __name__ == "__main__":
    main()
