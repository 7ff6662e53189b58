"""The model zoo end to end: any preset model and ``snake:<links>``.

Port of ``python bench.py --model <m>`` for the fused solver: the targets
(``bench.py:94-105``), each preset's recipe (``bench.py:1000-1093``,
``ikpso_tpu/pso/presets.py``) and the scores.

  1. S targets, each the effector positions of random in-limit angles;
  2. one swarm per target through kernel A (warm init, canonical inertia
     0.5 -> 0.2, position-only cost) at the preset's P, iterations and
     re-kick;
  3. the preset's LM polish steps, each kept only where it helps (none
     for ``reference_arm``);
  4. the preset's top-k retry rounds: buckets S/32 (S >= 262,144 and a
     decaying schedule) or S/16, at least 1,024 and at most S/8, unless
     the preset fixes one; diverse inits, or warm target walks.

The rows this module was written for:

  * ``dual_arm_14dof`` (7 nodes, D=18, 2 effectors): S=262,144, P=1,024,
    8 iterations, re-kick every 4, 4 SoA steps, 4 hybrid-init rounds over
    S/16;
  * ``humanoid_45dof`` (16 nodes, D=45, 5 effectors): S=16,384, P=512, 60
    iterations, 6 tensor-path steps, 6 rounds over 8,192 of 8-step warm
    target walks;
  * ``planar_3dof`` (arm_7dof's topology, frozen X and Y axes): S=1,048,576,
    P=128, 8 iterations, 4 steps, 2 uniform-init rounds over 32,768 then
    8,192;
  * ``reference_arm`` (8 nodes, D=21, 3 effectors): S=262,144, P=256, 100
    iterations, no polish, no retries;
  * ``snake_30dof`` and ``snake:<links>`` (serial chains, D = 3 x links):
    S=65,536, P=256, 4 iterations, re-kick every 2, 4 SoA steps, 2 warm
    rounds over 4,096 then 1,024; chains past 10 links run kernel A's
    serial-chain variant.

Run: ``python -m ikpso_tpu_torch.harness.trees --model snake:50
[--swarms S] [--device cuda] [--seed N]`` prints the result dict as one
JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ikpso_tpu_torch.harness.headline import headline_bucket, reachable_targets
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.fused import make_fused_solver
from ikpso_tpu_torch.pso.polish import wrap_with_polish
from ikpso_tpu_torch.pso.presets import FUSED_PRESETS, fused_preset
from ikpso_tpu_torch.pso.restarts import wrap_with_topk_retries
from ikpso_tpu_torch.utils.profiling import measure


def model_spec(model: str, device="cpu"):
    """``(spec, problem)`` of a zoo model or of ``snake:<links>``."""
    if model.startswith("snake:"):
        return library.snake(int(model.split(":", 1)[1]), device=device)
    return getattr(library, model)(device=device)


def tree_configs(model: str):
    """The preset and its base solve's PSO and fitness settings."""
    pre = fused_preset(model)
    links = model.split(":", 1)[1] if model.startswith("snake:") else "1"
    if pre is None or not links.isdigit() or int(links) < 1:
        raise ValueError(f"unknown model {model!r}; expected one of "
                         f"{sorted(FUSED_PRESETS)} or 'snake:<links>'")
    pso = PSOConfig(
        iterations=pre.iterations, inertia_mode="canonical",
        inertia=pre.inertia, inertia_end=pre.inertia_end, init_mode="warm",
        rekick_interval=pre.rekick_interval, rekick_scale=pre.rekick_scale,
        rekick_threshold=pre.rekick_threshold,
    )
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0, orientation_weight=0.0)
    return pre, pso, fit


def tree_bucket(model: str, swarms: int) -> int:
    """The retry bucket: the preset's, else bench.py's S/16 rule."""
    pre = fused_preset(model)
    return pre.retry_bucket or headline_bucket(swarms, pre.retry_bucket_decay)


def build_tree_solver(model: str, spec, swarms: int, device):
    """The preset's solver: fused PSO + polish + top-k retries (walks for
    the humanoid); bench.py leaves out a stage whose count is 0."""
    pre, pso, fit = tree_configs(model)

    def build(pso_cfg):
        solver = make_fused_solver(spec, pso=pso_cfg, fit=fit,
                                   num_particles=pre.particles, device=device)
        return wrap_with_polish(solver, spec, steps=pre.polish) if pre.polish else solver

    return wrap_with_topk_retries(
        build, pso, rounds=pre.retries, bucket=tree_bucket(model, swarms),
        retry_init_mode=pre.retry_init_mode, retry_iterations=pre.retry_iterations,
        spec=spec, retry_walk_steps=pre.retry_walk or 0,
        retry_walk_jitter=pre.retry_walk_jitter, bucket_decay=pre.retry_bucket_decay,
    )


def tree_problem(model: str, swarms: int, device, seed: int = 0):
    """``(spec, batched problem)`` with ``swarms`` reachable targets."""
    spec, problem = model_spec(model, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return spec, library.batched_problem(
        problem, reachable_targets(spec, problem, swarms, gen))


def run_tree(model: str, swarms: int = None, device="cuda", seed: int = 0,
             warmup: int = 1, iters: int = 3) -> dict:
    """Build targets and solver as bench.py does; time the whole solve
    (median of ``iters`` after ``warmup``) and score the last result."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_tree: device cuda requested but no GPU is visible")
    pre, pso, _ = tree_configs(model)
    swarms = swarms or pre.swarms
    spec, batched = tree_problem(model, swarms, device, seed)
    gen_solve = torch.Generator(device=device).manual_seed(seed + 1)
    solver = build_tree_solver(model, spec, swarms, device)
    res, wall = measure(solver, batched, gen_solve, device=device,
                        warmup=warmup, iters=iters)
    err_mm = res.effector_error.double().cpu().numpy() * 1000.0
    return dict(
        model=model,
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
        recipe=dict(particles=pre.particles, iterations=pso.iterations,
                    rekick_interval=pso.rekick_interval, polish=pre.polish,
                    retries=pre.retries, retry_bucket=tree_bucket(model, swarms),
                    retry_init_mode=None if pre.retry_walk else pre.retry_init_mode,
                    retry_walk=pre.retry_walk or 0),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True,
                    help=f"one of {sorted(FUSED_PRESETS)} or snake:<links>")
    ap.add_argument("--swarms", type=int, default=None,
                    help="batch size (default: the preset's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tree_configs(args.model)
    print(json.dumps(run_tree(args.model, args.swarms, args.device, args.seed)),
          flush=True)


if __name__ == "__main__":
    main()
