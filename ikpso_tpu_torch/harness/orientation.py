"""The 6-DOF position + orientation solve, end to end.

Port of ``python bench.py --model arm_6dof --orientation`` (BASELINE
config 2): the targets (``bench.py:94-121``), the preset's recipe
(``bench.py:1000-1093``, ``ikpso_tpu/pso/presets.py:129-130``) and the
orientation scores (``bench.py:339-352``).

  1. S targets, each the FK effector position of random in-limit angles;
     its target rotation is that pose's effector world rotation, passed
     through ``quaternion_to_euler_xyz(matrix_to_quaternion(.))``;
  2. one swarm per target, P=128 particles, 40 iterations of kernel A
     (warm init, canonical inertia 0.5 -> 0.2, position + orientation
     cost with weight 1) with a velocity re-kick every 20 iterations
     (scale 0.5, only swarms whose best fitness is above 1e-6);
  3. 4 SoA LM polish steps with orientation rows, each kept only where it
     does not worsen the position error;
  4. 20 top-k retry rounds of 80 iterations from uniform init, the
     re-kick still on, over a constant bucket of S/16.

Run: ``python -m ikpso_tpu_torch.harness.orientation [--swarms S]
[--device cuda] [--seed N]`` prints the result dict as one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ikpso_tpu_torch.harness.headline import headline_bucket, reachable_pose
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.rotations import (
    euler_xyz_to_matrix,
    matrix_to_quaternion,
    quaternion_to_euler_xyz,
)
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.fused import make_fused_solver
from ikpso_tpu_torch.pso.polish import wrap_with_polish
from ikpso_tpu_torch.pso.presets import fused_preset
from ikpso_tpu_torch.pso.restarts import wrap_with_topk_retries
from ikpso_tpu_torch.utils.profiling import measure

MODEL = "arm_6dof"


def orientation_targets(spec, problem, pose):
    """``(S, E, 3)`` effector positions and ``(S, E, 3)`` Euler target
    rotations of the poses ``pose``, as ``bench.py:103-120`` builds them."""
    pos, rot = fk_ops.fk(spec, pose, problem.origin)
    eff = list(spec.effector_idx)
    return pos[:, eff], quaternion_to_euler_xyz(matrix_to_quaternion(rot[:, eff]))


def orientation_configs():
    """The preset and its base solve's PSO and fitness settings."""
    pre = fused_preset(MODEL)
    pso = PSOConfig(
        iterations=pre.iterations, inertia_mode="canonical",
        inertia=pre.inertia, inertia_end=pre.inertia_end, init_mode="warm",
        rekick_interval=pre.rekick_interval, rekick_scale=pre.rekick_scale,
        rekick_threshold=pre.rekick_threshold,
    )
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0, orientation_weight=1.0)
    return pre, pso, fit


def build_orientation_solver(spec, swarms: int, device):
    """The preset's solver: fused PSO + orientation polish + top-k retries."""
    pre, pso, fit = orientation_configs()

    def build(pso_cfg):
        solver = make_fused_solver(spec, pso=pso_cfg, fit=fit,
                                   num_particles=pre.particles, device=device)
        return wrap_with_polish(solver, spec, steps=pre.polish, use_orientation=True,
                                orientation_weight=fit.orientation_weight)

    return wrap_with_topk_retries(
        build, pso, rounds=pre.retries,
        bucket=headline_bucket(swarms, pre.retry_bucket_decay),
        retry_init_mode=pre.retry_init_mode, retry_iterations=pre.retry_iterations,
        bucket_decay=pre.retry_bucket_decay,
    )


def orientation_error_deg(spec, pose, problem):
    """``(S,)`` geodesic angle between each solved effector rotation and
    its target, ``acos(clip((tr(Ra^T Rb) - 1) / 2))``, worst effector, in
    degrees (``bench.py:339-352``)."""
    rot = fk_ops.fk(spec, pose, problem.origin)[1][:, list(spec.effector_idx)]
    tr = (rot * euler_xyz_to_matrix(problem.target_rot)).sum(dim=(-2, -1))
    ang = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    return torch.rad2deg(ang).amax(dim=-1)


def run_orientation(swarms: int = None, device="cuda", seed: int = 0,
                    warmup: int = 1, iters: int = 3) -> dict:
    """Build targets and solver as bench.py does; time the whole solve
    (median of ``iters`` after ``warmup``) and score the last result."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_orientation: device cuda requested but no GPU is visible")
    pre = fused_preset(MODEL)
    swarms = swarms or pre.swarms
    spec, problem = library.arm_6dof(device=device)
    gen_targets = torch.Generator(device=device).manual_seed(seed)
    gen_solve = torch.Generator(device=device).manual_seed(seed + 1)
    targets, target_rot = orientation_targets(
        spec, problem, reachable_pose(spec, problem, swarms, gen_targets))
    batched = library.batched_problem(problem, targets, target_rot=target_rot)
    solver = build_orientation_solver(spec, swarms, device)
    res, wall = measure(solver, batched, gen_solve, device=device,
                        warmup=warmup, iters=iters)
    err_mm = res.effector_error.double().cpu().numpy() * 1000.0
    ang = orientation_error_deg(spec, res.pose, batched).double().cpu().numpy()
    return dict(
        model=MODEL,
        orientation=True,
        swarms=swarms,
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
        wall_s=wall,
        solves_per_s=swarms / wall,
        p50_err_mm=float(np.percentile(err_mm, 50)),
        p90_err_mm=float(np.percentile(err_mm, 90)),
        frac_under_1mm=float((err_mm < 1.0).mean()),
        failures_ge_1mm=int((err_mm >= 1.0).sum()),
        p50_orient_err_deg=float(np.percentile(ang, 50)),
        p90_orient_err_deg=float(np.percentile(ang, 90)),
        finite=bool(np.isfinite(err_mm).all() and np.isfinite(ang).all()),
        retries=pre.retries,
        retry_iterations=pre.retry_iterations,
        retry_bucket=headline_bucket(swarms, pre.retry_bucket_decay),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--swarms", type=int, default=None,
                    help="batch size (default: the preset's 262,144)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run_orientation(args.swarms, args.device, args.seed)), flush=True)


if __name__ == "__main__":
    main()
