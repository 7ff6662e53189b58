"""Command-line interface: solve / experiment / parity / sweep / track / viz.

Port of ``ikpso_tpu/harness/cli.py`` with the same flags, defaults and
JSON lines (``_add_common``, ``_load`` with ``--preset``, ``cmd_solve``,
``cmd_experiment``, ``cmd_parity``, ``cmd_sweep`` with ``--multihost``,
``cmd_track`` with ``_follow_updates``, ``cmd_viz``). Every subcommand
runs on the card unless ``--cpu`` is given, with no fallback:

  * ``--impl fused``: kernel A (``pso/fused.py``); it needs the card;
  * ``--impl jnp``: the scan solver (``pso/solver.py``), its fitness
    kernel C on the card and the plain fitness on the CPU, or with a GJK
    scene (``collision_backend: "gjk"``: no kernel fuses GJK, in JAX or
    here); ``solve``'s JSON line names the fitness that ran
    (``fitness_impl``);
  * ``--impl auto`` (the default): kernel A on the card where the
    particle count fits its thread-block bound
    (``utils.kernels.max_particles``), else the scan solver. As in JAX it
    does not look at the collider: kernel A refuses a GJK scene, naming
    ``--impl jnp``.

``parity`` runs the scan solver, as JAX's does. ``--swarms-per-tile``
packs swarms into a TPU tile and has no counterpart here. ``sweep
--multihost --coordinator HOST:PORT --num-processes N --process-id I``
is one of N processes of a ``torch.distributed`` group
(``parallel/distributed.py``): each solves its block of the waypoints on
its device (checkpointing it to ``CHECKPOINT.p<process>`` with
``--checkpoint``) and prints the merged sweep.

Run: ``python -m ikpso_tpu_torch.harness.cli <cmd> [--cpu] ...``, e.g.
``solve [--config FILE | --preset] [--model NAME] [--particles P]
[--iterations N]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch


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
    none is visible. A process of a multi-process group drives the card
    of its rank (``parallel.distributed.rank_device``)."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device is visible; pass --cpu to run on the CPU")
    if getattr(args, "multihost", False):
        from ikpso_tpu_torch.parallel.distributed import rank_device

        return rank_device("cuda", args.process_id or 0)
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
        if hasattr(args, "retries"):
            defaults.update(retries=pre.retries, retry_init_mode=pre.retry_init_mode)
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
    if hasattr(args, "retries"):
        args.retries = args.retries or 0
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
    kernel C on the card (``harness.trajectory.build_solver``); then, with
    ``polish`` steps, the LM polish with the config's orientation, scene
    and collider."""
    from ikpso_tpu_torch.harness.trajectory import build_solver as base_solver
    from ikpso_tpu_torch.pso.polish import wrap_with_polish

    solver = base_solver(cfg.spec, pso=cfg.pso, fit=cfg.fitness, obstacles=cfg.obstacles,
                         num_particles=cfg.num_particles, impl=impl, device=device)
    if polish:
        orient = _orientation(cfg, cfg.problem)
        solver = wrap_with_polish(
            solver, cfg.spec, steps=polish, use_orientation=orient,
            orientation_weight=float(cfg.fitness.orientation_weight) if orient else 1.0,
            obstacles=cfg.obstacles, collision_backend=cfg.fitness.collision_backend,
            collision_shape=cfg.fitness.collision_shape, gizmo_size=cfg.fitness.gizmo_size)
    return solver


def cmd_solve(args) -> int:
    from ikpso_tpu_torch.harness.trajectory import fitness_impl

    device = device_of(args)
    cfg = _load(args, device)
    impl = pick_impl(args.impl, cfg, device)
    solver = build_solver(cfg, impl, args.polish, device)
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
        fitness_impl=fitness_impl(cfg.fitness, cfg.obstacles, impl, device),
    )), flush=True)
    return 0


def cmd_experiment(args) -> int:
    from ikpso_tpu_torch.harness.experiment import frames_to_converge
    from ikpso_tpu_torch.models.library import reference_reset_targets
    from ikpso_tpu_torch.native import make_diagnostics_writer

    device = device_of(args)
    cfg = _load(args, device)
    diag = make_diagnostics_writer(args.outdir) if args.outdir else None
    reset = (reference_reset_targets(device=device)
             if args.model == "reference_arm" and not args.config else cfg.problem.targets)
    try:
        result = frames_to_converge(
            cfg.spec, cfg.problem, reset, args.seed, pso=cfg.pso, fit=cfg.fitness,
            obstacles=cfg.obstacles, num_particles=cfg.num_particles, eps_dist=args.eps,
            max_frames=args.max_frames, trials=args.trials, diagnostics=diag,
            impl=pick_impl(args.impl, cfg, device), trial_batch=args.trial_batch,
            progress=args.progress, polish=args.polish)
    finally:
        if diag:
            diag.close()
    print(json.dumps(result.summary()), flush=True)
    return 0


# The reference's three published protocols (Documentation/Iteration_{1,2,3}:
# one PSO config, differing init and fitness), and the two documented PSO
# configs: the shipped Main.cpp:130 hardcode and the Particle.h:70-78
# struct defaults (the historical-config hypothesis for iterations 1-2).
PROTOCOLS = {
    "iter1": dict(init_mode="uniform", angle_weight=0.0),
    "iter2": dict(init_mode="warm", angle_weight=0.0),
    "iter3": dict(init_mode="warm", angle_weight=3.0),
}
PSO_VARIANTS = {
    "shipped": dict(inertia=0.5, cognitive=0.5, social=1.25, iterations=15),
    "struct": dict(inertia=0.2, cognitive=0.5, social=0.7, iterations=10),
}


def protocol_configs(name: str, variant: str = "shipped"):
    """``(PSOConfig, FitnessConfig)`` of one published protocol."""
    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.pso.config import PSOConfig

    p = PROTOCOLS[name]
    return (PSOConfig(inertia_mode="randomized", init_mode=p["init_mode"],
                      **PSO_VARIANTS[variant]),
            FitnessConfig(angle_weight=p["angle_weight"]))


def cmd_parity(args) -> int:
    """Frames-to-converge distributions of the three protocols against the
    reference's raw per-trial sheets (``Documentation/results.xlsx``, read
    from ``--xlsx``): a KS test and a bootstrap CI of the mean difference per
    protocol."""
    from ikpso_tpu_torch.harness.experiment import frames_to_converge
    from ikpso_tpu_torch.harness.parity import compare_distributions, load_reference_frames
    from ikpso_tpu_torch.models.library import reference_arm, reference_reset_targets

    device = device_of(args)
    ref = load_reference_frames(args.xlsx)
    spec, problem = reference_arm(device=device)
    reset = reference_reset_targets(device=device)
    wanted = args.protocols.split(",") if args.protocols else list(PROTOCOLS)
    out = {}
    for name in wanted:
        pso, fit = protocol_configs(name, args.pso_variant)
        res = frames_to_converge(
            spec, problem, reset, args.seed, pso=pso, fit=fit,
            num_particles=args.particles, eps_dist=0.025, max_frames=args.max_frames,
            trials=args.trials, trial_batch=args.trial_batch, impl="jnp",
            rng_mode=args.rng_stream)
        frames = np.asarray(res.frames, float)
        converged = frames[frames >= 0]
        if converged.size == 0:
            rec = {"error": "no trials converged", "unconverged": int(frames.size)}
        else:
            rec = compare_distributions(ref[name], converged)
            rec["unconverged"] = int((frames < 0).sum())
        out[name] = rec
        print(json.dumps({name: rec}), flush=True)
    record = dict(trials=args.trials, pso_variant=args.pso_variant,
                  rng_stream=args.rng_stream, results=out)
    print(json.dumps(dict(metric="parity", **record)), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(record) + "\n")
    return 0


def cmd_sweep(args) -> int:
    from ikpso_tpu_torch.harness.trajectory import solve_waypoints
    from ikpso_tpu_torch.parallel import distributed

    device = device_of(args)
    if args.multihost:
        distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                               device=device)
    try:
        cfg = _load(args, device)
        # Reachable waypoints around the configured targets; every process
        # draws the same global set and the multi-process sweep slices it.
        rng = np.random.default_rng(args.seed)
        base = cfg.problem.targets.cpu().numpy()
        waypoints = base[None] + rng.normal(
            scale=args.jitter, size=(args.waypoints,) + base.shape).astype(np.float32)
        kw = dict(pso=cfg.pso, fit=cfg.fitness, obstacles=cfg.obstacles,
                  num_particles=cfg.num_particles, impl=pick_impl(args.impl, cfg, device),
                  retries=args.retries, retry_init_mode=args.retry_init_mode,
                  retry_iterations=args.retry_iterations, polish=args.polish)
        extra = {}
        if args.multihost:
            from ikpso_tpu_torch.parallel.mesh import world

            rank, size = world()
            # Each process checkpoints its own block.
            ck = f"{args.checkpoint}.p{rank}" if args.checkpoint else None
            result, sl = distributed.sweep_waypoints_multihost(
                cfg.spec, cfg.problem, waypoints, args.seed, batch_size=args.batch,
                checkpoint_path=ck, **kw)
            extra = dict(process=rank, num_processes=size,
                         local_slice=[int(sl.start), int(sl.stop)])
        else:
            result = solve_waypoints(cfg.spec, cfg.problem, waypoints, args.seed,
                                     batch_size=args.batch, checkpoint_path=args.checkpoint,
                                     **kw)
    finally:
        if args.multihost:
            distributed.shutdown()
    print(json.dumps(dict(
        waypoints=int(result.errors.size),
        err_mean=float(result.errors.mean()),
        err_p50=float(np.percentile(result.errors, 50)),
        err_p95=float(np.percentile(result.errors, 95)),
        solves_per_second=result.solves_per_second,
        **extra,
    )), flush=True)
    return 0


def _follow_updates(stream):
    """Parse a target/origin-update stream: one update per line.

    Accepted line forms (blank lines and ``#`` comments skipped):

    * a JSON array ``[[x,y,z], ...]`` of E effector targets;
    * 3*E whitespace-separated floats (same meaning);
    * ``origin x y z``: move the arm base only (the reference's arrow-key
      base drag, Main.cpp:401-453);
    * a JSON object ``{"targets": [[x,y,z],...], "origin": [x,y,z]}`` with
      either or both keys: one atomic mixed update.

    Malformed lines raise ValueError naming the line number; the effector
    count is pinned by the first line that carries targets.
    """
    expected = [None]  # effector count, fixed by the first targets line

    def _targets(arr, lineno):
        arr = np.asarray(arr, np.float32)
        if arr.size == 0 or arr.size % 3:
            raise ValueError(f"follow stream line {lineno}: targets need 3*E floats, "
                             f"got {arr.size}")
        arr = arr.reshape(-1, 3)
        if expected[0] is None:
            expected[0] = arr.shape[0]
        elif arr.shape[0] != expected[0]:
            raise ValueError(f"follow stream line {lineno}: {arr.shape[0]} effector "
                             f"targets, but the first update had {expected[0]}")
        return arr

    def _origin(arr, lineno):
        arr = np.asarray(arr, np.float32)
        if arr.shape != (3,):
            raise ValueError(f"follow stream line {lineno}: origin needs exactly 3 "
                             f"floats, got shape {arr.shape}")
        return arr

    for lineno, line in enumerate(stream, start=1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("{"):
            obj = json.loads(line)
            unknown = sorted(set(obj) - {"targets", "origin"})
            if unknown or not obj:
                raise ValueError(f"follow stream line {lineno}: expected keys "
                                 f"'targets'/'origin', got {sorted(obj) or 'none'}")
            upd = {}
            if "targets" in obj:
                upd["targets"] = _targets(obj["targets"], lineno)
            if "origin" in obj:
                upd["origin"] = _origin(obj["origin"], lineno)
            yield upd
        elif line.startswith("["):
            yield _targets(json.loads(line), lineno)
        else:
            toks = line.split()
            if toks[0] == "origin":
                yield {"origin": _origin([float(v) for v in toks[1:]], lineno)}
            else:
                try:
                    vals = [float(v) for v in toks]
                except ValueError:
                    raise ValueError(f"follow stream line {lineno}: not a number: "
                                     f"{line!r}") from None
                yield _targets(vals, lineno)


def _cmd_follow(args, cfg, device) -> int:
    from ikpso_tpu_torch.harness.trajectory import follow_targets

    stream = sys.stdin if args.follow == "-" else open(args.follow)
    records = []
    try:
        for rec in follow_targets(
                cfg.spec, cfg.problem, _follow_updates(stream), args.seed, pso=cfg.pso,
                fit=cfg.fitness, obstacles=cfg.obstacles,
                num_particles=cfg.num_particles, impl=pick_impl(args.impl, cfg, device),
                polish=args.polish):
            err = float(rec["effector_error"].max())
            line = dict(step=rec["step"], err=err, wall_ms=round(rec["wall_ms"], 3))
            if "angle_delta_max" in rec:
                line["angle_delta_max"] = round(rec["angle_delta_max"], 6)
            print(json.dumps(line), flush=True)
            records.append(err)
    finally:
        if stream is not sys.stdin:
            stream.close()
    if not records:
        print(json.dumps(dict(steps=0)), flush=True)
        return 0
    settle = args.settle if args.settle is not None else min(3, len(records) - 1)
    ss = np.asarray(records[settle:])
    print(json.dumps(dict(steps=len(records), settle=settle,
                          err_p50_settled=float(np.percentile(ss, 50)),
                          err_max_settled=float(ss.max()))), flush=True)
    return 0


def cmd_track(args) -> int:
    from ikpso_tpu_torch.harness.trajectory import circle_paths, track_trajectories

    device = device_of(args)
    cfg = _load(args, device)
    if args.follow is not None:
        return _cmd_follow(args, cfg, device)
    path = circle_paths(cfg.problem.targets, steps=args.steps, num_paths=args.paths,
                        radius=args.radius, revolutions=args.revolutions, seed=args.seed)
    result = track_trajectories(
        cfg.spec, cfg.problem, path, args.seed, pso=cfg.pso, fit=cfg.fitness,
        obstacles=cfg.obstacles, num_particles=cfg.num_particles,
        impl=pick_impl(args.impl, cfg, device), polish=args.polish, timeit=args.timeit)
    print(json.dumps(track_summary(result, args.steps, args.settle)), flush=True)
    return 0


def track_summary(result, steps: int, settle=None) -> dict:
    """``track``'s JSON line: error percentiles over all steps and over the
    steps after a settle prefix (default steps // 4: the run starts from
    the model's canonical pose, so the first steps are the convergence
    transient), and the per-step joint motion."""
    step_delta = np.abs(np.diff(result.angles, axis=0))
    settle = steps // 4 if settle is None else settle
    settle = max(0, min(settle, steps - 1))
    ss = result.errors[settle:]
    return dict(
        steps=int(result.errors.shape[0]),
        paths=int(result.errors.shape[1]),
        err_p50=float(np.percentile(result.errors, 50)),
        err_p95=float(np.percentile(result.errors, 95)),
        settle=settle,
        err_p50_settled=float(np.percentile(ss, 50)),
        err_p95_settled=float(np.percentile(ss, 95)),
        err_max_settled=float(ss.max()),
        angle_delta_avg=float(step_delta.mean()),
        angle_delta_max=float(step_delta.max()),
        solves_per_second=result.solves_per_second,
        wall_time_s=result.wall_time_s,
    )


def cmd_viz(args) -> int:
    """Render the configured scene: standalone HTML for ``--out *.html``
    (the default ``out/scene.html``), else a matplotlib image."""
    from ikpso_tpu_torch.viz.render import export_html, plot_scene

    cfg = _load(args, device_of(args))
    out = args.out or "out/scene.html"
    if out.endswith(".html"):
        export_html(cfg.spec, cfg.problem, out, obstacles=cfg.obstacles)
    elif plot_scene(cfg.spec, cfg.problem, obstacles=cfg.obstacles, path=out) is None:
        raise SystemExit(f"error: {out} needs matplotlib, which is not installed; "
                         "write .html instead")
    print(json.dumps(dict(written=out)), flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: every subcommand with JAX's flags and defaults."""
    from ikpso_tpu_torch.harness.parity import REFERENCE_XLSX

    parser = argparse.ArgumentParser(prog="ikpso_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("solve", help="one solve from config")
    _add_common(p)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("experiment", help="frames-to-converge protocol")
    _add_common(p)
    p.add_argument("--trials", type=int, default=32)
    p.add_argument("--trial-batch", type=int, default=32,
                   help="max trials solved as one parallel batch (memory cap)")
    p.add_argument("--eps", type=float, default=0.025)
    p.add_argument("--max-frames", type=int, default=300)
    p.add_argument("--outdir", default=None, help="diagnostics directory")
    p.add_argument("--progress", action="store_true",
                   help="per-frame convergence progress on stderr")
    p.set_defaults(fn=cmd_experiment)

    p = sub.add_parser("parity", help="frames-to-converge distribution vs the "
                       "reference's raw results.xlsx (KS test + bootstrap CI per protocol)")
    p.add_argument("--xlsx", default=REFERENCE_XLSX, metavar="PATH",
                   help="the reference's results.xlsx (default: "
                   "reference/Documentation/results.xlsx inside this checkout)")
    p.add_argument("--trials", type=int, default=512)
    p.add_argument("--trial-batch", type=int, default=128)
    p.add_argument("--particles", type=int, default=16384)
    p.add_argument("--max-frames", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain versions of the kernels)")
    p.add_argument("--protocols", default=None,
                   help="comma list of iter1,iter2,iter3 (default: all)")
    p.add_argument("--pso-variant", choices=tuple(PSO_VARIANTS), default="shipped",
                   help="PSO coefficients: the shipped Main.cpp hardcode (0.5/0.5/1.25, "
                   "15 it) or the Particle.h struct defaults (0.2/0.5/0.7, 10 it)")
    p.add_argument("--rng-stream", choices=("independent", "session"),
                   default="independent",
                   help="fresh per-frame seeds (independent trials) or one stream "
                   "across all frames and trials (the reference's curand_init-once)")
    p.add_argument("--out", default=None, help="append JSON record to FILE")
    p.set_defaults(fn=cmd_parity)

    p = sub.add_parser("sweep", help="trajectory waypoint sweep")
    _add_common(p)
    p.add_argument("--waypoints", type=int, default=1024)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--jitter", type=float, default=0.25)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--retries", type=int, default=None,
                   help="top-k retry rounds per batch (re-solve the worst eighth; "
                   "default 0, or the model preset's with --preset)")
    p.add_argument("--retry-init-mode", choices=("warm", "uniform", "hybrid"),
                   default=None, help="swarm init for the retry rounds only")
    p.add_argument("--retry-iterations", type=int, default=None,
                   help="PSO iterations for the retry rounds only")
    p.add_argument("--multihost", action="store_true",
                   help="shard the sweep across torch.distributed processes: each "
                   "solves its contiguous waypoint block on its device, and the "
                   "results are all-gathered")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's rendezvous address (without it, one process)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("track", help="track moving targets: chained per-frame re-solves")
    _add_common(p)
    p.add_argument("--steps", type=int, default=120, help="path length T")
    p.add_argument("--paths", type=int, default=256,
                   help="S independent trajectories tracked in parallel")
    p.add_argument("--radius", type=float, default=0.25)
    p.add_argument("--revolutions", type=float, default=1.0)
    p.add_argument("--settle", type=int, default=None,
                   help="steps to exclude from steady-state error stats (default "
                   "steps//4; the initial convergence transient)")
    p.add_argument("--timeit", action="store_true",
                   help="run twice and report steady-state wall time")
    p.add_argument("--follow", default=None, metavar="FILE|-",
                   help="streaming mode: consume target updates line by line from FILE "
                   "(or stdin with '-') and re-solve warm per update, one JSON record "
                   "per step. Line format: JSON [[x,y,z],...] or 3*E floats")
    p.set_defaults(fn=cmd_track)

    p = sub.add_parser("viz", help="render scene to html/png")
    _add_common(p)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_viz)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
