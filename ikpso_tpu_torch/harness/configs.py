"""A JSON config solved at batch size: ``solve``'s solver over S targets.

The ``solve`` subcommand (``harness/cli.py``) solves the one problem of
a config. This runs the same solver, built by the same
``cli.build_solver``, over S targets and scores it as ``bench.py``
scores a model:

  1. S targets, each the effector positions of random in-limit angles
     (``headline.reachable_pose``); with the config's scene, a target is
     feasible when its generating pose is collision-free, and accuracy
     is scored on the feasible targets only;
  2. one swarm per target through ``cli.build_solver``: kernel A where
     the config's particle count fits its bound (``--impl auto``), else
     the scan solver on kernel C (the plain fitness with a GJK scene);
     then ``polish`` LM steps, as ``solve --polish`` runs them. No
     retries: ``solve`` has none.

The configurations (``ikpso_tpu_torch/configs``): ``arm7_locality`` (the
distance term), ``arm7_exact`` (stock trig), ``dual_arm_box`` (a tree
with a box scene), ``hand21`` (a 21-node tree, MediaPipe Hands' landmark
layout) and ``arm7_box_gjk`` (the 7-DOF arm in the 4-box scene of
``harness/obstacles.py`` with the GJK collider, solved with ``--impl
jnp``). With a scene, the solutions' collisions are counted with the
closed-form collider and, for a GJK document, with GJK as well.

Run: ``python -m ikpso_tpu_torch.harness.configs --config FILE [--swarms
S] [--polish K] [--impl auto|jnp|fused] [--device cuda] [--seed N]``
prints the result dict as one JSON line.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ikpso_tpu_torch.harness.cli import build_solver, pick_impl
from ikpso_tpu_torch.harness.headline import reachable_pose
from ikpso_tpu_torch.harness.obstacles import pose_collides
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.utils.configio import load_config
from ikpso_tpu_torch.utils.profiling import measure

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


def config_problem(cfg, swarms: int, generator: torch.Generator):
    """``(batched problem, feasible mask)`` of ``swarms`` reachable targets
    for a RunConfig: feasible where the generating pose misses the scene
    under the config's collider (all feasible without a scene)."""
    spec, problem = cfg.spec, cfg.problem
    pose = reachable_pose(spec, problem, swarms, generator)
    targets = fk_ops.fk_points(spec, pose, problem.origin)[:, list(spec.effector_idx)]
    feasible = torch.ones(swarms, dtype=torch.bool, device=pose.device)
    if cfg.obstacles is not None:
        feasible = ~pose_collides(spec, pose, problem.origin, cfg.obstacles,
                                  cfg.fitness.collision_shape, cfg.fitness.gizmo_size,
                                  cfg.fitness.collision_backend)
    return library.batched_problem(problem, targets), feasible


def run_config(config, swarms: int, polish: int, device="cuda", seed: int = 0,
               warmup: int = 1, iters: int = 3, impl: str = "auto") -> dict:
    """Build targets and ``solve``'s solver for ``config`` (a path, JSON
    string or dict) with ``--impl impl``; time the whole solve (median of
    ``iters`` after ``warmup``) and score the last result on the feasible
    targets. ``fitness_impl`` names the fitness that ran."""
    from ikpso_tpu_torch.harness.trajectory import fitness_impl

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_config: device cuda requested but no GPU is visible")
    cfg = load_config(str(config) if isinstance(config, Path) else config, device)
    gen_targets = torch.Generator(device=device).manual_seed(seed)
    gen_solve = torch.Generator(device=device).manual_seed(seed + 1)
    batched, feasible = config_problem(cfg, swarms, gen_targets)
    impl = pick_impl(impl, cfg, device)
    solver = build_solver(cfg, impl, polish, device)
    res, wall = measure(solver, batched, gen_solve, device=device, warmup=warmup,
                        iters=iters)
    err_mm = res.effector_error.double().cpu().numpy() * 1000.0
    scored = err_mm[feasible.cpu().numpy()]
    out = dict(
        swarms=swarms,
        impl=impl,
        fitness_impl=fitness_impl(cfg.fitness, cfg.obstacles, impl, device),
        particles=cfg.num_particles,
        iterations=cfg.pso.iterations,
        polish=polish,
        device=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        wall_s=wall,
        solves_per_s=swarms / wall,
        p50_err_mm=float(np.percentile(scored, 50)),
        p90_err_mm=float(np.percentile(scored, 90)),
        frac_under_1mm=float((scored < 1.0).mean()),
        failures_ge_1mm=int((scored >= 1.0).sum()),
        finite=bool(np.isfinite(err_mm).all()),
    )
    if cfg.obstacles is not None:
        def colliding(backend):
            return int((pose_collides(cfg.spec, res.pose, cfg.problem.origin, cfg.obstacles,
                                      cfg.fitness.collision_shape, cfg.fitness.gizmo_size,
                                      backend) & feasible).sum())

        out.update(frac_targets_feasible=float(scored.size / swarms),
                   colliding_solutions=colliding("sat"))
        if cfg.fitness.collision_backend == "gjk":
            out["colliding_solutions_gjk"] = colliding("gjk")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="JSON config path")
    ap.add_argument("--swarms", type=int, default=16_384)
    ap.add_argument("--polish", type=int, default=0)
    ap.add_argument("--impl", choices=("auto", "jnp", "fused"), default="auto")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run_config(args.config, args.swarms, args.polish, args.device,
                                args.seed, impl=args.impl)), flush=True)


if __name__ == "__main__":
    main()
