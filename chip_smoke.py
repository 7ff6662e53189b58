#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``ikpso_tpu_torch``).

Builds the port's CUDA kernels from ``ikpso_tpu_torch/csrc``, checks each
against its plain torch version on the card, drives the 7-DOF headline
solve (``harness.headline.run_headline``) at S=1,048,576 through kernel
A, and times kernel/plain pairs. Every phase prints one JSON line; any
failure raises and the script exits non-zero. The last line is
``{"ok": true, "device": {...}}``.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX and fails without a visible CUDA device.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

JAX_REFERENCE_FAILURES = "18/1048576"  # JAX reference on the same batch size
REPLAY_ATOL, REPLAY_RTOL, REPLAY_VAL_ATOL = 5e-4, 1e-3, 1e-5  # tests/test_fused.py:257-258
FK_RTOL, FK_ATOL = 1e-5, 1e-6
HEADLINE_SWARMS = 1_048_576  # the arm_7dof preset's batch
# Kernel/plain timing batch: the plain solver's (S, P, D) temporaries
# would not fit in device memory at the headline batch.
TIMING_SWARMS = 65_536


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs a GPU")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0].strip()
    from ikpso_tpu_torch.utils import kernels

    nvcc = run([kernels._nvcc(), "--version"]).splitlines()[-1]
    emit("environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc, python=sys.version.split()[0],
         device_count=torch.cuda.device_count())
    return card


def phase_build():
    from ikpso_tpu_torch.utils import kernels

    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    seconds = time.perf_counter() - t0
    log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = re.findall(r"(\d+) bytes spill stores", log)
    emit("build", seconds=seconds, library=lib.name, registers=regs,
         spill_store_bytes=[int(s) for s in spills])


def _problem(name, swarms, rng, device):
    """A batched problem with reachable targets (FK of random in-limit
    angles) made from a seeded numpy generator."""
    import torch

    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.ops import fk as fk_ops

    spec, problem = getattr(library, name)(device=device)
    lim = spec.limits().cpu().numpy()
    ang = lim[0] + rng.random((swarms, spec.dof)) * (lim[1] - lim[0])
    ang = torch.as_tensor(ang.astype("float32"), device=device)
    pose = fk_ops.angles_to_pose(spec, problem.pose[0].expand(swarms, 3), ang)
    targets = fk_ops.fk_points(spec, pose, problem.origin)[:, list(spec.effector_idx)]
    return spec, library.batched_problem(problem, targets)


def _packed(spec, batched, fit):
    from ikpso_tpu_torch.ops import fk as fk_ops
    from ikpso_tpu_torch.ops.fitness_kernel import pack_meta, pack_swarm
    from ikpso_tpu_torch.pso.polish_soa import anchor_positions_flat

    meta = pack_meta(spec, fit)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched))
    return meta, swarm


def phase_fk_fitness(device, swarms=4096, particles=128):
    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness, fk_fitness_plain

    worst = 0.0
    for name in ("arm_7dof", "reference_arm"):
        rng = np.random.default_rng(1)
        spec, batched = _problem(name, swarms, rng, device)
        meta, swarm = _packed(spec, batched, FitnessConfig(angle_weight=3.0))
        lim = spec.limits().cpu().numpy()
        x = lim[0] + rng.random((swarms, particles, spec.dof)) * (lim[1] - lim[0])
        x = torch.as_tensor(x.astype("float32"), device=device)
        got = fk_fitness(spec, x, meta, swarm)
        want = fk_fitness_plain(spec, x, meta, swarm)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        ok = torch.allclose(got, want, rtol=FK_RTOL, atol=FK_ATOL)
        emit("fk_fitness_vs_plain", model=name, swarms=swarms, particles=particles,
             max_abs_err=err, rtol=FK_RTOL, atol=FK_ATOL, ok=bool(ok))
        if not ok:
            raise AssertionError(f"kernel B disagrees with fk_fitness_plain on {name}")
    return worst


def _compare_solve(tag, spec, pso, fit, meta, swarm, seeds, particles, uniforms):
    import torch

    from ikpso_tpu_torch.pso.fused import fused_solve, fused_solve_plain

    limits = spec.limits()
    gk, vk = fused_solve(spec, pso, fit, meta, swarm, limits, seeds, particles,
                         uniforms=uniforms)
    gp, vp = fused_solve_plain(spec, pso, fit, meta, swarm, limits, seeds, particles,
                               uniforms=uniforms)
    torch.cuda.synchronize()
    g_err = float((gk - gp).abs().max())
    v_err = float((vk - vp).abs().max())
    ok = bool(torch.isfinite(gk).all() and torch.isfinite(vk).all()
              and g_err <= REPLAY_ATOL
              and bool(((vk - vp).abs() <= REPLAY_VAL_ATOL + REPLAY_RTOL * vp.abs()).all()))
    emit(tag, model=spec_name(spec), swarms=swarm.shape[0], particles=particles,
         iterations=pso.iterations, gbest_max_abs_err=g_err, gval_max_abs_err=v_err,
         gbest_bitwise_equal=bool(torch.equal(gk, gp)), atol=REPLAY_ATOL,
         rtol=REPLAY_RTOL, ok=ok)
    if not ok:
        raise AssertionError(f"{tag}: kernel A disagrees with fused_solve_plain")
    return g_err


def spec_name(spec):
    return {4: "arm_7dof", 8: "reference_arm"}.get(spec.num_nodes, str(spec.parent))


def _headline_configs():
    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.pso.config import PSOConfig

    pso = PSOConfig(iterations=8, inertia_mode="canonical", inertia=0.5,
                    inertia_end=0.2)
    return pso, FitnessConfig(angle_weight=0.0, distance_weight=0.0)


def phase_fused_replay(device, swarms=1024, particles=128):
    import numpy as np
    import torch

    from ikpso_tpu_torch.pso.fused import num_draws

    pso, fit = _headline_configs()
    worst = 0.0
    for name, s in (("arm_7dof", swarms), ("reference_arm", 256)):
        rng = np.random.default_rng(2)
        spec, batched = _problem(name, s, rng, device)
        meta, swarm = _packed(spec, batched, fit)
        u = rng.random((s, num_draws(pso), spec.dof, particles), dtype=np.float32)
        seeds = torch.zeros((s, 2), dtype=torch.int32, device=device)
        worst = max(worst, _compare_solve(
            "fused_replay_vs_plain", spec, pso, fit, meta, swarm, seeds, particles,
            torch.as_tensor(u, device=device)))
    return worst


def phase_fused_tie(device, particles=128):
    """Kernel A's argmin on exact ties: the last link has length 0, so the
    wrist angles (dims 6-8) leave the fitness unchanged bit for bit. All
    particles move alike in dims 0-5 and differently in dims 6-8; after one
    iteration every lval ties and the lbests differ only in the wrist, so
    gbest must carry particle 0's wrist angles."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.models.chain import IKProblem, make_chain_spec
    from ikpso_tpu_torch.models.library import batched_problem
    from ikpso_tpu_torch.ops import fk as fk_ops
    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.pso.config import PSOConfig
    from ikpso_tpu_torch.pso.fused import fused_solve, num_draws

    spec = make_chain_spec([-1, 0, 1, 2], [0.0, 1.0, 1.0, 0.0],
                           np.full((4, 3), -np.pi), np.full((4, 3), np.pi), [3],
                           device=device)
    problem = IKProblem(pose=torch.zeros(4, 3, device=device),
                        origin=torch.zeros(3, device=device),
                        targets=torch.zeros(1, 3, device=device))
    goal = torch.tensor([0.1] * 6 + [0.0] * 3, device=device)
    tgt = fk_ops.effector_positions(
        spec, fk_ops.angles_to_pose(spec, problem.pose[0], goal), problem.origin)
    swarms = 4
    batched = batched_problem(problem, tgt[None].expand(swarms, 1, 3))
    pso = PSOConfig(iterations=1, inertia_mode="canonical")
    fit = FitnessConfig(angle_weight=0.0)
    meta, swarm = _packed(spec, batched, fit)
    u = torch.full((swarms, num_draws(pso), spec.dof, particles), 0.6, device=device)
    wrist = torch.linspace(0.05, 0.95, particles, device=device).flip(0)
    u[:, 0, 6:, :] = wrist
    want = np.float32(0.5) * (np.float32(wrist[0].item()) * np.float32(2) - np.float32(1))
    gb, gv = fused_solve(spec, pso, fit, meta, swarm, spec.limits(),
                         torch.zeros((swarms, 2), dtype=torch.int32, device=device),
                         particles, uniforms=u)
    torch.cuda.synchronize()
    got = gb[:, 6:].cpu().numpy()
    ok = bool((got == want).all())
    emit("fused_tie_lowest_id", swarms=swarms, particles=particles,
         want=float(want), got=got[:, 0].tolist(), ok=ok)
    if not ok:
        raise AssertionError("kernel A broke an exact tie away from particle 0")


def phase_fused_philox(device, swarms=1024, particles=128):
    import numpy as np
    import torch

    pso, fit = _headline_configs()
    rng = np.random.default_rng(3)
    spec, batched = _problem("arm_7dof", swarms, rng, device)
    meta, swarm = _packed(spec, batched, fit)
    seeds = torch.as_tensor(
        rng.integers(-2**31, 2**31, (swarms, 2), dtype=np.int64).astype(np.int32),
        device=device)
    return _compare_solve("fused_philox_vs_plain", spec, pso, fit, meta, swarm,
                          seeds, particles, None)


def phase_headline(device, swarms, card):
    from ikpso_tpu_torch.harness.headline import run_headline
    from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness
    from ikpso_tpu_torch.pso.fused import fused_solve

    fused_solve.launches = 0
    fk_fitness.launches = 0
    out = run_headline(swarms=swarms, device=device, seed=0, warmup=1, iters=3)
    launches = {"fused_solve": fused_solve.launches, "fk_fitness": fk_fitness.launches}
    ok = (launches["fused_solve"] > 0 and out["finite"]
          and out["p50_err_mm"] < 1.0 and out["frac_under_1mm"] >= 0.999)
    emit("headline", **out, wall_ms=out["wall_s"] * 1e3, launches=launches,
         jax_reference_failures=JAX_REFERENCE_FAILURES, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("headline solve missed its bar or bypassed kernel A")
    return launches


def phase_timing(device, swarms, big_swarms, particles=128):
    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness, fk_fitness_plain
    from ikpso_tpu_torch.pso.fused import fused_solve, fused_solve_plain

    pso, fit = _headline_configs()
    rng = np.random.default_rng(4)
    spec, batched = _problem("arm_7dof", swarms, rng, device)
    meta, swarm = _packed(spec, batched, fit)
    limits = spec.limits()
    seeds = torch.as_tensor(
        rng.integers(-2**31, 2**31, (swarms, 2), dtype=np.int64).astype(np.int32),
        device=device)
    x = torch.as_tensor(
        (limits[0].cpu().numpy() + rng.random((swarms, particles, spec.dof))
         * (limits[1] - limits[0]).cpu().numpy()).astype("float32"), device=device)
    saved = (fused_solve.launches, fk_fitness.launches)
    times = {
        "fused_solve_ms": cuda_time_ms(lambda: fused_solve(
            spec, pso, fit, meta, swarm, limits, seeds, particles), reps=10),
        "fused_solve_plain_ms": cuda_time_ms(lambda: fused_solve_plain(
            spec, pso, fit, meta, swarm, limits, seeds, particles), reps=3),
        "fk_fitness_ms": cuda_time_ms(lambda: fk_fitness(spec, x, meta, swarm), reps=20),
        "fk_fitness_plain_ms": cuda_time_ms(
            lambda: fk_fitness_plain(spec, x, meta, swarm), reps=5),
    }
    del x
    spec, batched = _problem("arm_7dof", big_swarms, rng, device)
    meta, swarm = _packed(spec, batched, fit)
    seeds = torch.zeros((big_swarms, 2), dtype=torch.int32, device=device)
    times["fused_solve_big_ms"] = cuda_time_ms(lambda: fused_solve(
        spec, pso, fit, meta, swarm, limits, seeds, particles), reps=5)
    fused_solve.launches, fk_fitness.launches = saved
    emit("timing", swarms=swarms, big_swarms=big_swarms, particles=particles, **times)
    return times


def main() -> None:
    card = phase_environment()
    import torch

    device = torch.device("cuda", 0)
    phase_build()
    b_err = phase_fk_fitness(device)
    a_err = phase_fused_replay(device)
    phase_fused_tie(device)
    phase_fused_philox(device)
    launches = phase_headline(device, HEADLINE_SWARMS, card)
    t = phase_timing(device, TIMING_SWARMS, HEADLINE_SWARMS)

    kernels = [
        {"name": "fused_solve", "route": "cuda",
         "source": "ikpso_tpu_torch/csrc/fused_solve.cu",
         "replaces": "ikpso_tpu/pso/fused.py:539",
         "launches": launches["fused_solve"], "max_abs_err": a_err,
         "ms": t["fused_solve_ms"], "plain_ms": t["fused_solve_plain_ms"],
         "timed_swarms": TIMING_SWARMS,
         "ms_at_headline_swarms": t["fused_solve_big_ms"]},
        # Kernel B's device function runs inside every fused_solve launch;
        # its standalone launcher is for checking and timing only.
        {"name": "fk_fitness", "route": "cuda",
         "source": "ikpso_tpu_torch/csrc/fk_fitness.cuh",
         "replaces": "ikpso_tpu/ops/pallas_fitness.py:256",
         "launches": launches["fused_solve"],
         "standalone_launches": launches["fk_fitness"],
         "inlined_into": "fused_solve", "max_abs_err": b_err,
         "ms": t["fk_fitness_ms"], "plain_ms": t["fk_fitness_plain_ms"],
         "timed_swarms": TIMING_SWARMS},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
