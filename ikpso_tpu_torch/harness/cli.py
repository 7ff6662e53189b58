"""Command-line driver: one batched solve from a JSON config.

Port of ``ikpso_tpu/harness/cli.py``'s ``solve`` (``_add_common``,
``_load`` with ``--preset``, ``cmd_solve``): the same flags, the same
overrides and the same one JSON line (``angles``, ``fitness``,
``effector_error``, ``trace``). It runs on the card unless ``--cpu`` is
given, with no fallback:

  * ``--impl fused``: kernel A (``pso/fused.py``); it needs the card;
  * ``--impl jnp``: the scan solver (``pso/solver.py``), its fitness
    kernel C on the card and the plain fitness on the CPU;
  * ``--impl auto`` (the default): kernel A on the card where the
    particle count fits its thread-block bound
    (``utils.kernels.max_particles``), else the scan solver.

``--swarms-per-tile`` packs swarms into a TPU tile and has no counterpart
here. The other subcommands of the JAX CLI exist and raise, naming the
ROADMAP item that ports them.

Run: ``python -m ikpso_tpu_torch.harness.cli solve [--config FILE |
--preset] [--model NAME] [--particles P] [--iterations N] [--cpu] ...``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

# The JAX CLI's subcommands this port does not have yet, with the ROADMAP
# item that ports each.
UNPORTED = {
    "experiment": "A5 (the reference experiment)",
    "parity": "A5 (the reference experiment)",
    "sweep": "A6 (trajectories)",
    "track": "A6 (trajectories)",
    "viz": "A7 (viz/render.py)",
}


def _add_common(p):
    p.add_argument("--config", default=None, help="JSON config path or literal")
    p.add_argument("--model", default="reference_arm")
    p.add_argument("--particles", type=int, default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain versions of the kernels)")
    p.add_argument(
        "--preset", action="store_true",
        help="apply the model's recipe (particles, iterations, inertia "
        "schedule, re-kick, polish; ikpso_tpu_torch/pso/presets.py). "
        "Explicit flags still win",
    )
    p.add_argument("--inertia-mode", choices=("randomized", "canonical"), default=None,
                   help="PSO inertia policy (default: the config's)")
    p.add_argument("--init-mode", choices=("warm", "uniform", "hybrid"), default=None,
                   help="swarm init (default: the config's)")
    p.add_argument("--rekick-interval", type=int, default=None,
                   help="re-randomize particle velocities every N iterations (0 = off)")
    p.add_argument("--rekick-scale", type=float, default=None,
                   help="half-width of the re-kick velocity draw")
    p.add_argument("--rekick-threshold", type=float, default=None,
                   help="only kick swarms with gbest fitness above this")
    p.add_argument("--angle-weight", type=float, default=None,
                   help="override the angular-locality weight")
    p.add_argument("--polish", type=int, default=None, metavar="K",
                   help="K Levenberg-Marquardt polish steps (accept-if-better; 0 = off)")
    p.add_argument("--impl", choices=("auto", "jnp", "fused"), default="auto",
                   help="solver: the scan solver (jnp) or kernel A (fused, the card "
                   "only); auto picks fused on the card when the particle count fits")


def device_of(args) -> torch.device:
    """The card unless ``--cpu``; raises when the card is asked for and
    none is visible."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device is visible; pass --cpu to run on the CPU")
    return torch.device("cuda")


def _load(args, device):
    from ikpso_tpu_torch.utils.configio import load_config

    pre = None
    if getattr(args, "preset", False):
        if args.config:
            raise SystemExit(
                "--preset and --config are mutually exclusive (a JSON "
                "config is already an explicit full configuration)"
            )
        from ikpso_tpu_torch.pso.presets import fused_preset

        pre = fused_preset(args.model)
        if pre is None:
            raise SystemExit(f"no preset for model {args.model!r}")
        defaults = dict(particles=pre.particles, iterations=pre.iterations,
                        inertia_mode="canonical", rekick_interval=pre.rekick_interval,
                        rekick_scale=pre.rekick_scale,
                        rekick_threshold=pre.rekick_threshold, polish=pre.polish)
        for name, value in defaults.items():
            if getattr(args, name) is None:
                setattr(args, name, value)

    cfg = load_config(args.config if args.config else {"model": args.model}, device)
    pso_fields = dict(iterations=args.iterations, init_mode=args.init_mode,
                      inertia_mode=args.inertia_mode, rekick_interval=args.rekick_interval,
                      rekick_scale=args.rekick_scale, rekick_threshold=args.rekick_threshold)
    if args.particles is not None:
        cfg = dataclasses.replace(cfg, num_particles=args.particles)
    pso_fields = {k: v for k, v in pso_fields.items() if v is not None}
    if pso_fields:
        cfg = dataclasses.replace(cfg, pso=dataclasses.replace(cfg.pso, **pso_fields))
    if args.angle_weight is not None:
        cfg = dataclasses.replace(cfg, fitness=dataclasses.replace(
            cfg.fitness, angle_weight=args.angle_weight))
    if pre is not None and cfg.pso.inertia_mode == "canonical":
        # The recipes decay inertia pre.inertia -> pre.inertia_end.
        cfg = dataclasses.replace(cfg, pso=dataclasses.replace(
            cfg.pso, inertia=pre.inertia, inertia_end=pre.inertia_end))
    args.polish = args.polish or 0
    return cfg


def _orientation(cfg, problem) -> bool:
    return problem.target_rot is not None and float(cfg.fitness.orientation_weight) != 0.0


def pick_impl(impl: str, cfg, device: torch.device) -> str:
    """``fused`` or ``jnp`` for ``--impl`` on ``device``."""
    from ikpso_tpu_torch.pso.fused import uses_distance
    from ikpso_tpu_torch.utils import kernels

    p = cfg.num_particles
    most = kernels.max_particles(
        cfg.spec, 0 if cfg.obstacles is None else cfg.obstacles.count,
        cfg.fitness.collision_shape, _orientation(cfg, cfg.problem),
        uses_distance(cfg.fitness), cfg.fitness.trig_impl)
    fits = p % 32 == 0 and 32 <= p <= most
    if impl == "fused":
        if device.type != "cuda":
            raise SystemExit("error: --impl fused runs kernel A, which needs the card; "
                             "use --impl jnp with --cpu")
        if not fits:
            raise SystemExit(f"error: kernel A takes a multiple of 32 particles in "
                             f"[32, {most}] for this model; got {p}")
        return "fused"
    if impl == "jnp":
        return "jnp"
    return "fused" if device.type == "cuda" and fits else "jnp"


def build_solver(cfg, impl: str, polish: int, device):
    """``(problem, generator) -> SolveResult`` for a RunConfig, as ``solve``
    builds it: kernel A (``impl="fused"``) or the scan solver, its fitness
    kernel C on the card; then, with ``polish`` steps, the LM polish with
    the config's orientation, scene and collider."""
    from ikpso_tpu_torch.ops.fitness_kernel import make_kernel_fitness
    from ikpso_tpu_torch.pso.fused import make_fused_solver
    from ikpso_tpu_torch.pso.polish import wrap_with_polish
    from ikpso_tpu_torch.pso.solver import solve

    device = torch.device(device)
    if impl == "fused":
        solver = make_fused_solver(cfg.spec, pso=cfg.pso, fit=cfg.fitness,
                                   num_particles=cfg.num_particles, device=device,
                                   obstacles=cfg.obstacles)
    else:
        def solver(problem, generator):
            fitness_fn = None
            if device.type == "cuda":
                fitness_fn = make_kernel_fitness(cfg.spec, problem, cfg.fitness,
                                                 cfg.obstacles)
            return solve(cfg.spec, problem, generator, pso=cfg.pso, fit=cfg.fitness,
                         obstacles=cfg.obstacles, num_particles=cfg.num_particles,
                         fitness_fn=fitness_fn)
    if polish:
        orient = _orientation(cfg, cfg.problem)
        solver = wrap_with_polish(
            solver, cfg.spec, steps=polish, use_orientation=orient,
            orientation_weight=float(cfg.fitness.orientation_weight) if orient else 1.0,
            obstacles=cfg.obstacles, collision_backend=cfg.fitness.collision_backend,
            collision_shape=cfg.fitness.collision_shape, gizmo_size=cfg.fitness.gizmo_size)
    return solver


def cmd_solve(args) -> int:
    device = device_of(args)
    cfg = _load(args, device)
    solver = build_solver(cfg, pick_impl(args.impl, cfg, device), args.polish, device)
    prob = cfg.problem
    batched = dataclasses.replace(
        prob, pose=prob.pose[None], origin=prob.origin[None], targets=prob.targets[None],
        target_rot=None if prob.target_rot is None else prob.target_rot[None])
    res = solver(batched, torch.Generator(device=device).manual_seed(args.seed))

    def strip(t):
        # The swarm axis: leading, or second in the (T, S) trace.
        t = t.detach().cpu()
        return t[0] if t.dim() > 0 and t.shape[0] == 1 else t[:, 0]

    print(json.dumps(dict(
        angles=strip(res.angles).tolist(),
        fitness=float(strip(res.fitness)),
        effector_error=float(strip(res.effector_error)),
        trace=strip(res.trace).tolist(),
    )), flush=True)
    return 0


def _unported(name):
    def cmd(args) -> int:
        raise NotImplementedError(f"the {name} subcommand is not ported yet: ROADMAP "
                                  f"{UNPORTED[name]}")
    return cmd


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ikpso_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("solve", help="one solve from config")
    _add_common(p)
    p.set_defaults(fn=cmd_solve)
    for name in UNPORTED:
        p = sub.add_parser(name, help=f"not ported yet (ROADMAP {UNPORTED[name]})")
        p.set_defaults(fn=_unported(name))
    # An unported subcommand takes (and ignores) the JAX CLI's arguments.
    args, extra = parser.parse_known_args(argv)
    if extra and args.cmd not in UNPORTED:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
