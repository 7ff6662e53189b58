"""The reference's validation experiment, reproduced as a harness.

Port of ``ikpso_tpu/harness/experiment.py`` (``ExperimentResult``,
``frames_to_converge``, ``run_reference_experiment``). Protocol
(reference Main.cpp:171-216, 330-337): reset the arm to its canonical
pose, move the targets to a fixed second set (a ~0.5-unit target jump),
then re-solve every frame -- each solve warm-started from the previous
frame's result -- until the summed true Euclidean effector error drops
to ``eps_dist`` (0.025 in the reference, Main.cpp:134). The
frames-to-converge count is the metric of the reference's three
experiment reports (Documentation/Iteration_{1,2,3}; BASELINE.md).

T independent trials run as T swarms of one batched solve per frame;
the frame loop is the host loop, since each frame's warm start is the
previous frame's result. The solve runs where the problem's tensors
are: on the card, ``impl="jnp"`` is the scan solver with kernel C as
its fitness and ``impl="fused"`` kernel A; on the CPU, their plain
versions. Random streams are generator seeds (``utils/seeds.py``) in
place of JAX's keys.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from ikpso_tpu_torch.harness.trajectory import frame_solver
from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso_tpu_torch.models.library import batched_problem
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.fk import fk_points, pose_to_angles
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.utils import seeds
from ikpso_tpu_torch.utils.guards import check_solve_result, to_host as _host


@dataclasses.dataclass
class ExperimentResult:
    """Frames-to-converge statistics over all trials.

    ``frames`` is -1 for trials that hit ``max_frames`` unconverged.
    The avg/min/max fields mirror the reference reports' tables
    (Documentation/Iteration_3/Raport_3.tex:86-91).
    """

    frames: np.ndarray  # (trials,)
    final_error: np.ndarray  # (trials,)
    solves_per_second: float
    wall_time_s: float
    # Per-frame motion statistics over all pre-convergence frames of all
    # trials: the reference reports' "angle delta per DOF" / "node
    # position delta" tables. Keys avg/min/max/n.
    angle_delta: Optional[dict] = None
    pos_delta: Optional[dict] = None

    @property
    def converged(self) -> np.ndarray:
        return self.frames >= 0

    def summary(self) -> dict:
        ok = self.frames[self.converged]
        out = dict(
            trials=int(self.frames.size),
            converged=int(ok.size),
            frames_avg=float(ok.mean()) if ok.size else float("nan"),
            frames_min=int(ok.min()) if ok.size else -1,
            frames_max=int(ok.max()) if ok.size else -1,
            frames_std=float(ok.std()) if ok.size else float("nan"),
            solves_per_second=self.solves_per_second,
            wall_time_s=self.wall_time_s,
        )
        if self.angle_delta is not None:
            out["angle_delta"] = self.angle_delta
        if self.pos_delta is not None:
            out["pos_delta"] = self.pos_delta
        return out


def _merge(ds):
    ds = [d for d in ds if d]
    if not ds:
        return None
    n = sum(d["n"] for d in ds)
    return dict(avg=sum(d["avg"] * d["n"] for d in ds) / n, min=min(d["min"] for d in ds),
                max=max(d["max"] for d in ds), n=n)


def frames_to_converge(
    spec: ChainSpec,
    problem: IKProblem,
    reset_targets: torch.Tensor,
    seed: int,
    *,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    obstacles: Optional[Obstacles] = None,
    num_particles: int = 16384,
    eps_dist: float = 0.025,
    max_frames: int = 300,
    trials: int = 32,
    diagnostics=None,
    impl: str = "jnp",
    validate: bool = True,
    trial_batch: Optional[int] = None,
    progress: bool = False,
    polish: int = 0,
    rng_mode: str = "independent",
    _session=None,
) -> ExperimentResult:
    """Run the reset->solve->converge experiment.

    Args:
      spec / problem: the arm and its canonical (default) pose, the state
        the reference's ``resetArm`` restores (Main.cpp:330-337), on the
        device the solves run on.
      reset_targets: ``(E, 3)`` the post-reset target set the trials
        must reach.
      seed: the generator seed the trials' streams come from.
      trials: independent trials, run as parallel swarms.
      diagnostics: optional 4-stream writer; logs trial 0's frames, as
        the reference logs its single run.
      trial_batch: cap on trials run as parallel swarms at once; more run
        as sequential batches of independent streams and merge (trials
        never interact).
      rng_mode: ``"independent"`` gives every batch a split of ``seed``
        and every frame a split of its batch's seed. ``"session"`` runs
        ONE stream across every frame and every batch: frame ``c`` of the
        whole call draws from ``fold_in(seed, c)``, so batch k's streams
        depend on how many frames batch k-1 took, like the reference's
        trial t starting where trial t-1's stream ended
        (utility_kernels.cuh:28, seeded once from Main.cpp:145).
      impl: ``"jnp"`` (the scan solver) or ``"fused"`` (kernel A).
      polish: K LM steps a frame, gated on the locality-aware cost.

    Returns:
      ExperimentResult with per-trial frame counts (the number of solves
      until the trial's error first reaches ``eps_dist``).
    """
    if rng_mode not in ("independent", "session"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    if rng_mode == "session" and _session is None:
        _session = {"seed": int(seed), "counter": 0}
    if trial_batch is not None and trials > trial_batch:
        chunks = []
        remaining = trials
        while remaining > 0:
            n = min(remaining, trial_batch)
            seed, sub = seeds.split(seed)
            chunks.append(frames_to_converge(
                spec, problem, reset_targets, sub, pso=pso, fit=fit, obstacles=obstacles,
                num_particles=num_particles, eps_dist=eps_dist, max_frames=max_frames,
                trials=n,
                # Reference-style single-run logging: first batch only.
                diagnostics=diagnostics if not chunks else None,
                impl=impl, validate=validate, progress=progress, polish=polish,
                rng_mode=rng_mode, _session=_session))
            remaining -= n
            if progress:
                print(f"[experiment] batch done: {trials - remaining}/{trials} trials",
                      file=sys.stderr, flush=True)
        wall = sum(c.wall_time_s for c in chunks)
        total = sum(c.solves_per_second * c.wall_time_s for c in chunks)
        return ExperimentResult(
            frames=np.concatenate([c.frames for c in chunks]),
            final_error=np.concatenate([c.final_error for c in chunks]),
            solves_per_second=total / wall if wall > 0 else float("inf"),
            wall_time_s=wall,
            angle_delta=_merge([c.angle_delta for c in chunks]),
            pos_delta=_merge([c.pos_delta for c in chunks]),
        )

    device = problem.pose.device
    reset = torch.as_tensor(reset_targets, dtype=torch.float32, device=device)
    batched = batched_problem(problem, reset[None].expand((trials,) + tuple(reset.shape)))
    # The polish is opt-in: the reference has no local refinement, so the
    # parity protocol keeps polish=0.
    solver = frame_solver(spec, pso=pso, fit=fit, obstacles=obstacles,
                          num_particles=num_particles, impl=impl, polish=polish,
                          device=device)

    frames = np.full((trials,), -1, np.int64)
    final_error = np.full((trials,), np.inf, np.float64)
    done = np.zeros((trials,), bool)
    current = batched

    # Per-frame motion accumulators (the reference's degStream / posStream
    # analysis). Baselines: the canonical pose the trials reset from.
    prev_angles = _host(pose_to_angles(spec, batched.pose))
    prev_pos = _host(fk_points(spec, batched.pose, batched.origin))[:, 1:]
    d_stats = {"sum": 0.0, "n": 0, "min": np.inf, "max": -np.inf}
    p_stats = {"sum": 0.0, "n": 0, "min": np.inf, "max": -np.inf}

    def _acc(stats, vals):
        if vals.size:
            stats["sum"] += float(vals.sum())
            stats["n"] += int(vals.size)
            stats["min"] = min(stats["min"], float(vals.min()))
            stats["max"] = max(stats["max"], float(vals.max()))

    start = time.perf_counter()
    n_solves = 0
    for frame in range(1, max_frames + 1):
        if _session is not None:
            sub = seeds.fold_in(_session["seed"], _session["counter"])
            _session["counter"] += 1
        else:
            seed, sub = seeds.split(seed)
        res = solver(current, seeds.generator(sub, device))
        n_solves += 1
        if validate:
            check_solve_result(res, context=f"frame {frame}")
        err = _host(res.effector_error)
        final_error = np.where(done, final_error, err)

        # Motion deltas of the trials still running (the reference logs
        # every frame up to and including the converging one).
        angles_np = _host(res.angles)
        pos_np = _host(fk_points(spec, res.pose, batched.origin))[:, 1:]
        active = ~done
        _acc(d_stats, np.abs(angles_np - prev_angles)[active])
        _acc(p_stats, np.linalg.norm(pos_np - prev_pos, axis=-1)[active])
        prev_angles, prev_pos = angles_np, pos_np

        if diagnostics is not None and not done[0]:
            diagnostics.log_frame(angles_np[0], pos_np[0], float(err[0]))

        newly = (~done) & (err <= eps_dist)
        frames[newly] = frame
        if progress and (frame % 25 == 0 or newly.any()):
            print(f"[experiment] frame {frame}: {int((done | newly).sum())}/{trials} "
                  "converged", file=sys.stderr, flush=True)
        if diagnostics is not None and newly[0]:
            diagnostics.log_convergence(frame)
        done |= newly
        if done.all():
            break
        # Warm start the next frame from this frame's solution (the
        # reference's FromCoords step, Main.cpp:227); converged trials keep
        # solving harmlessly.
        current = dataclasses.replace(current, pose=res.pose)
    wall = time.perf_counter() - start

    def _final(stats):
        if not stats["n"]:
            return None
        return dict(avg=stats["sum"] / stats["n"], min=stats["min"], max=stats["max"],
                    n=stats["n"])

    return ExperimentResult(
        frames=frames,
        final_error=final_error,
        solves_per_second=(n_solves * trials) / wall if wall > 0 else float("inf"),
        wall_time_s=wall,
        angle_delta=_final(d_stats),
        pos_delta=_final(p_stats),
    )


def run_reference_experiment(
    seed: int = 0,
    *,
    trials: int = 32,
    num_particles: int = 16384,
    pso: PSOConfig = PSOConfig(),
    fit: FitnessConfig = FitnessConfig(),
    eps_dist: float = 0.025,
    max_frames: int = 300,
    diagnostics=None,
    trial_batch: int = 32,
    device="cuda",
) -> ExperimentResult:
    """The shipped code's experiment: the 21-DOF arm, 16,384 particles, 15
    randomized-inertia iterations, angle_weight 3.0, eps 0.025, on the
    card unless ``device`` says otherwise."""
    from ikpso_tpu_torch.models.library import reference_arm, reference_reset_targets

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_reference_experiment: device cuda requested but no CUDA "
                           "device is visible; pass device='cpu'")
    spec, problem = reference_arm(device=device)
    return frames_to_converge(
        spec, problem, reference_reset_targets(device=device), seed, pso=pso, fit=fit,
        num_particles=num_particles, eps_dist=eps_dist, max_frames=max_frames,
        trials=trials, diagnostics=diagnostics, trial_batch=trial_batch)
