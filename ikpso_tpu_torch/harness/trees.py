"""The zoo's kinematic trees, end to end: the dual arm and the humanoid.

Port of ``python bench.py --model dual_arm_14dof`` and ``python bench.py
--model humanoid_45dof``: the targets (``bench.py:94-105``), each
preset's recipe (``bench.py:1000-1093``, ``ikpso_tpu/pso/presets.py``)
and the scores.

  1. S targets, each the effector positions of random in-limit angles;
  2. one swarm per target through kernel A (warm init, canonical inertia
     0.5 -> 0.2, position-only cost):
       * ``dual_arm_14dof`` (7 nodes, D=18, 2 effectors): S=262,144,
         P=1,024, 8 iterations with a re-kick every 4 (scale 0.5, above
         1e-6);
       * ``humanoid_45dof`` (16 nodes, D=45, 5 effectors): S=16,384,
         P=512, 60 iterations;
  3. LM polish, each step kept only where it helps: 4 SoA steps (dual
     arm), 6 tensor-path steps (humanoid, m = 15 rows);
  4. top-k retries over a constant bucket: 4 hybrid-init rounds of 8
     iterations over S/16 (dual arm); 6 rounds over 8,192, each an
     8-step warm target walk of the base solver from the problem's pose
     (humanoid).

Run: ``python -m ikpso_tpu_torch.harness.trees --model dual_arm_14dof
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
from ikpso_tpu_torch.pso.presets import fused_preset
from ikpso_tpu_torch.pso.restarts import wrap_with_topk_retries
from ikpso_tpu_torch.utils.profiling import measure

MODELS = ("dual_arm_14dof", "humanoid_45dof")


def tree_configs(model: str):
    """The preset and its base solve's PSO and fitness settings."""
    if model not in MODELS:
        raise ValueError(f"unknown tree model {model!r}; expected one of {MODELS}")
    pre = fused_preset(model)
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
    the humanoid)."""
    pre, pso, fit = tree_configs(model)

    def build(pso_cfg):
        solver = make_fused_solver(spec, pso=pso_cfg, fit=fit,
                                   num_particles=pre.particles, device=device)
        return wrap_with_polish(solver, spec, steps=pre.polish)

    return wrap_with_topk_retries(
        build, pso, rounds=pre.retries, bucket=tree_bucket(model, swarms),
        retry_init_mode=pre.retry_init_mode, retry_iterations=pre.retry_iterations,
        spec=spec, retry_walk_steps=pre.retry_walk or 0,
        retry_walk_jitter=pre.retry_walk_jitter, bucket_decay=pre.retry_bucket_decay,
    )


def tree_problem(model: str, swarms: int, device, seed: int = 0):
    """``(spec, batched problem)`` with ``swarms`` reachable targets."""
    spec, problem = getattr(library, model)(device=device)
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
    ap.add_argument("--model", choices=MODELS, required=True)
    ap.add_argument("--swarms", type=int, default=None,
                    help="batch size (default: the preset's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run_tree(args.model, args.swarms, args.device, args.seed)),
          flush=True)


if __name__ == "__main__":
    main()
