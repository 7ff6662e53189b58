"""The 7-DOF obstacle-scene solve, end to end.

Port of ``python bench.py --model arm_7dof --obstacles 4 --swarms 524288
--retries 12 --retry-iterations 24 --retry-init-mode uniform``: the scene
(``bench.py:46-71``), the feasibility scoring (``bench.py:127-154``) and
the constant retry buckets scenes get (``bench.py:1078-1093``).

  1. S targets, each the FK effector position of random in-limit angles;
     a target is feasible when its generating pose is collision-free, and
     accuracy is scored on feasible targets only;
  2. one swarm per target, P=128 particles, 8 PSO iterations of kernel A
     (warm init, canonical inertia 0.5 -> 0.2, position-only cost) with
     the scene's colliders in the fitness (box SAT or capsule);
  3. 4 SoA LM polish steps, each kept only where it helps and the
     polished pose is collision-free;
  4. 12 top-k retry rounds of 24 iterations from uniform init, over a
     constant bucket of S/16.

Run: ``python -m ikpso_tpu_torch.harness.obstacles [--swarms S]
[--obstacles N] [--collision-shape box|capsule] [--device cuda]
[--seed N]`` prints the result dict as one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ikpso_tpu_torch.harness.headline import headline_bucket, reachable_pose
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.models.chain import Obstacles
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.collision import get_chain_collider
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.fused import make_fused_solver
from ikpso_tpu_torch.pso.polish import wrap_with_polish
from ikpso_tpu_torch.pso.presets import fused_preset
from ikpso_tpu_torch.pso.restarts import wrap_with_topk_retries
from ikpso_tpu_torch.utils.profiling import measure

MODEL = "arm_7dof"
SWARMS = 524_288
RETRIES = 12
RETRY_ITERATIONS = 24
RETRY_INIT_MODE = "uniform"


def obstacle_scene(spec, n: int, device="cpu") -> Obstacles:
    """A deterministic n-box scene scaled to the chain's reach: boxes
    ring the workspace at 0.55x reach, alternating +-0.3x reach in z,
    each 0.15x reach on a side, axis-aligned."""
    reach = float(np.abs(spec.length.cpu().numpy()).sum())
    ang = np.arange(n) * (2.0 * np.pi / max(n, 1)) + 0.4
    r = 0.55 * reach
    centers = np.stack(
        [r * np.cos(ang), r * np.sin(ang),
         0.3 * reach * np.where(np.arange(n) % 2 == 0, 1.0, -1.0)],
        axis=-1,
    ).astype(np.float32)
    dims = np.full((n, 3), 0.15 * reach, np.float32)
    return Obstacles.from_boxes(centers, dims, device=device)


def pose_collides(spec, pose, origin, obstacles: Obstacles,
                  collision_shape: str = "box", gizmo_size: float = 0.2,
                  collision_backend: str = "sat"):
    """``(S,)`` bool: does each pose's chain hit the scene (plain collider
    of ``collision_backend``, the closed form by default)?"""
    pos, rot = fk_ops.fk(spec, pose, origin)
    collides = get_chain_collider(collision_backend, collision_shape)
    return collides(pos[..., 1:, :], rot[..., 1:, :, :],
                    pos[..., list(spec.parent[1:]), :], spec.length[1:],
                    obstacles.center, obstacles.half_extent, obstacles.rot,
                    gizmo_size=gizmo_size)


def build_obstacle_solver(spec, obstacles: Obstacles, swarms: int, device,
                          collision_shape: str = "box"):
    """Fused PSO with the scene + gated polish + uniform-init top-k retries."""
    pre = fused_preset(MODEL)
    pso = PSOConfig(iterations=pre.iterations, inertia_mode="canonical",
                    inertia=pre.inertia, inertia_end=pre.inertia_end,
                    init_mode="warm")
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0,
                        orientation_weight=0.0, collision_shape=collision_shape)

    def build(pso_cfg):
        solver = make_fused_solver(spec, pso=pso_cfg, fit=fit,
                                   num_particles=pre.particles, device=device,
                                   obstacles=obstacles)
        return wrap_with_polish(solver, spec, steps=pre.polish, obstacles=obstacles,
                                collision_backend=fit.collision_backend,
                                collision_shape=fit.collision_shape,
                                gizmo_size=fit.gizmo_size)

    # Scenes keep constant buckets: their failures are wrong-basin and
    # do not shrink geometrically (bench.py:1078-1093).
    return wrap_with_topk_retries(
        build, pso, rounds=RETRIES, bucket=headline_bucket(swarms, 1),
        retry_init_mode=RETRY_INIT_MODE, retry_iterations=RETRY_ITERATIONS,
        bucket_decay=1,
    )


def run_obstacles(swarms: int = SWARMS, device="cuda", seed: int = 0,
                  collision_shape: str = "box", num_obstacles: int = 4,
                  warmup: int = 1, iters: int = 3) -> dict:
    """Build targets, scene and solver as bench.py does; time the whole
    solve (median of ``iters`` after ``warmup``) and score the last
    result on the feasible targets."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_obstacles: device cuda requested but no GPU is visible")
    spec, problem = library.arm_7dof(device=device)
    obstacles = obstacle_scene(spec, num_obstacles, device)
    gen_targets = torch.Generator(device=device).manual_seed(seed)
    gen_solve = torch.Generator(device=device).manual_seed(seed + 1)
    pose = reachable_pose(spec, problem, swarms, gen_targets)
    targets = fk_ops.fk_points(spec, pose, problem.origin)[:, list(spec.effector_idx)]
    feasible = ~pose_collides(spec, pose, problem.origin, obstacles, collision_shape)
    batched = library.batched_problem(problem, targets)
    solver = build_obstacle_solver(spec, obstacles, swarms, device, collision_shape)
    res, wall = measure(solver, batched, gen_solve, device=device,
                        warmup=warmup, iters=iters)
    colliding = pose_collides(spec, res.pose, problem.origin, obstacles,
                              collision_shape) & feasible
    err_mm = res.effector_error.double().cpu().numpy() * 1000.0
    scored = err_mm[feasible.cpu().numpy()]
    return dict(
        model=MODEL,
        obstacles=num_obstacles,
        collision_shape=collision_shape,
        swarms=swarms,
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
        wall_s=wall,
        solves_per_s=swarms / wall,
        p50_err_mm=float(np.percentile(scored, 50)),
        p90_err_mm=float(np.percentile(scored, 90)),
        frac_under_1mm=float((scored < 1.0).mean()),
        failures_ge_1mm=int((scored >= 1.0).sum()),
        frac_targets_feasible=float(scored.size / swarms),
        colliding_solutions=int(colliding.sum()),
        finite=bool(np.isfinite(err_mm).all()),
        retries=RETRIES,
        retry_iterations=RETRY_ITERATIONS,
        retry_bucket=headline_bucket(swarms, 1),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--swarms", type=int, default=SWARMS)
    ap.add_argument("--obstacles", type=int, default=4)
    ap.add_argument("--collision-shape", choices=("box", "capsule"), default="box")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run_obstacles(args.swarms, args.device, args.seed,
                                   args.collision_shape, args.obstacles)), flush=True)


if __name__ == "__main__":
    main()
