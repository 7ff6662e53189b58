"""Roofline of the card: measured ceilings (kernels D and E) and the bound.

Port of ``ikpso_tpu/utils/roofline.py``. Kernel D (``csrc/roofline.cu``,
``roofline_body``) runs one of three bodies on a grid-stride loop --
the FMA, 3x3-compose and ``sin`` recurrences of ``measure_fma_peak``,
``measure_compose_peak`` and ``measure_transcendental_peak``
(``ikpso_tpu/utils/roofline.py:151-205``) -- with every element's result
written out. Kernel E (``philox_xor``) XOR-accumulates Philox4x32-10
draws (``csrc/philox.cuh``), the counterpart of ``measure_rng_peak``.
Each ceiling is a slope between two step counts, so the launch and the
bytes cancel. ``measure_fitness_kernel_rate`` is the chained-evaluation
slope over kernel C, ``measure_megakernel_rate`` the I-vs-3I slope over
kernel A.

The bound differs from the JAX model's on purpose. There the flops were
rated at the best *observed* megakernel rate, so a kernel could read
``sol_frac`` above 1 (ROADMAP A12). Here
:func:`speed_of_light_seconds` is the roofline of published peaks: the
larger of operations over 67 TFLOP/s (float32 outside the tensor cores;
an FMA is two operations) and bytes over 3.35 TB/s (NVIDIA's H100 SXM
data sheet, 700 W). Every operation class -- float, transcendental
(one operation per evaluation) and Philox integer operations -- is
charged at that one rate, which is optimistic, as a bound must be. The
measured rates below stand beside it and are never the ceiling.

Two traps of the measurement:
  * the library compiles with ``-fmad=false``, so the FMA body calls
    ``fmaf`` (which that flag does not split); the compose body stays
    plain mul/add, the instruction mix the solver kernels compile to,
    so its ceiling is about half of 67 T;
  * the ``sin`` body is the precise ``sinf``; the solver kernels use a
    polynomial and evaluate no transcendental at all.

``python -m ikpso_tpu_torch.utils.roofline`` measures everything on the
card and prints one JSON line; it fails without a GPU.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
from typing import Dict, Tuple

import numpy as np
import torch

from ikpso_tpu_torch.ops.philox import MASK32, philox4x32_10
from ikpso_tpu_torch.utils import kernels
from ikpso_tpu_torch.utils.flops import (
    CALL,
    PHILOX_KEY_SCHEDULE_OPS,
    THREAD,
    ZERO,
    FlopCount,
    philox_call_ops,
)
from ikpso_tpu_torch.utils.profiling import measure

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PUBLISHED_PEAKS: Dict[str, float] = {
    "fp32_ops_per_s": 67e12,  # float32 outside the tensor cores, FMA = 2
    "hbm_bytes_per_s": 3.35e12,
}

# Measured by `python3 chip_smoke.py` (phase "roofline", this module's
# functions) on one NVIDIA H100 80GB HBM3, power limit 700.00 W.
# Re-measure on other hardware. Units: operations (or draws, or
# evaluations) per second; an FMA counts 2. Context only: the bound
# never reads them.
MEASURED_PEAKS: Dict[str, float] = {
    "fma_flops_per_s": 5.254e13,  # kernel D, fmaf chain: 0.78 of 67 T
    "compose_flops_per_s": 2.960e13,  # kernel D, unfused mul/add composes
    "transcendental_per_s": 9.781e11,  # kernel D, precise sinf
    "rng_words_per_s": 1.808e12,  # kernel E, Philox4x32-10 32-bit words
    "fitness_kernel_ops_per_s": 2.363e13,  # kernel C, scan path's fitness
    "fitness_kernel_evals_per_s": 4.634e10,
    "fitness_kernel_bytes_per_s": 1.860e12,
    "kernel_ops_per_s": 2.911e13,  # kernel A's loop, headline settings
}

# Kernel D's bodies: ids of enum RooflineBody in csrc/roofline.cu, the
# counted operations per element and step, and per element outside the
# steps (the setup and the final sum).
BODIES = {"fma": 0, "compose": 1, "sin": 2}
OPS_PER_STEP = {"fma": 6.0, "compose": 90.0, "sin": 1.0}
OPS_SETUP = {"fma": 6.0, "compose": 44.0, "sin": 0.0}
# Kernel E, counter (t, k, 0, 0): per thread and step, the Philox work
# that depends on k and the XOR of the four words into the accumulator
# (4 integer operations); per thread, the key schedule and the work on
# t alone.
_E_CALL, _E_THREAD = philox_call_ops((THREAD, CALL, ZERO, ZERO))
E_OPS_PER_STEP = _E_CALL + 4.0
E_OPS_PER_THREAD = _E_THREAD + PHILOX_KEY_SCHEDULE_OPS


def speed_of_light_seconds(count: FlopCount) -> Tuple[float, str]:
    """``(seconds, "operations" | "bytes")``: the least time the card
    could take for a counted workload -- the larger of its operations
    over the float32 peak and its bytes over the memory rate
    (``PUBLISHED_PEAKS``) -- and which of the two terms sets it."""
    t_ops = count.ops / PUBLISHED_PEAKS["fp32_ops_per_s"]
    t_bytes = count.bytes / PUBLISHED_PEAKS["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# Kernel D: the three bodies.


def _fma(a, b, c):
    """float32 fused multiply-add: the float32 product is exact in
    float64, so one float64 add and the cast round like ``fmaf`` (bar a
    double-rounding tie)."""
    return (a.double() * b.double() + c).float()


def roofline_body_plain(body: str, x: torch.Tensor, steps: int) -> torch.Tensor:
    """Kernel D's recurrence ``body`` over ``steps`` steps on each
    element of the float32 tensor ``x`` (plain torch)."""
    if body == "fma":
        h = 0.5
        a, b, c = x, x * 0.5 + 0.1, x * 0.25 + 0.2
        for _ in range(steps):
            a = _fma(a, b, h)
            b = _fma(b, c, h)
            c = _fma(c, a, h)
        return a + b + c
    if body == "compose":
        from ikpso_tpu_torch.ops.fitness_kernel import mat_mul

        a = tuple(x * float(np.float32(0.1 * (i + 1))) for i in range(9))
        b = tuple(x * float(np.float32(0.05 * (i + 1))) + 0.1 for i in range(9))
        for _ in range(steps):
            a = mat_mul(a, b)
            b = mat_mul(b, a)
        acc = a[0]
        for t in a[1:] + b:
            acc = acc + t
        return acc
    if body == "sin":
        for _ in range(steps):
            x = torch.sin(x)
        return x
    raise ValueError(f"unknown body {body!r}; expected one of {sorted(BODIES)}")


def roofline_body(body: str, x: torch.Tensor, steps: int) -> torch.Tensor:
    """Kernel D: ``body`` over ``steps`` steps on each element of ``x``.

    A CPU tensor runs :func:`roofline_body_plain`; a CUDA tensor
    launches the kernel (8 blocks of 256 threads per SM, 2,048 threads:
    a full SM, on a grid-stride loop) or raises.
    """
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}; expected one of {sorted(BODIES)}")
    if x.dtype != torch.float32:
        raise ValueError("roofline_body: x must be float32")
    if x.device.type == "cpu":
        return roofline_body_plain(body, x, steps)
    kernels.require_cuda_contiguous("roofline_body", x)
    blocks = 8 * torch.cuda.get_device_properties(x.device).multi_processor_count
    out = torch.empty_like(x)
    rc = kernels.library().ikpso_roofline_body(
        BODIES[body], x.data_ptr(), out.data_ptr(), x.numel(), steps, blocks, 256,
        kernels.stream_ptr(x.device))
    kernels.check(rc, "roofline_body")
    roofline_body.launches += 1
    return out


roofline_body.launches = 0


def roofline_body_count(body: str, elems: int, steps: int) -> FlopCount:
    """Counted work of one kernel D launch: operations, and one float
    read and one written per element."""
    return FlopCount(flops=elems * (OPS_PER_STEP[body] * steps + OPS_SETUP[body]),
                     bytes=8.0 * elems)


# ---------------------------------------------------------------------------
# Kernel E: Philox draws.


def philox_xor_plain(key: Tuple[int, int], n: int, steps: int, device="cpu") -> torch.Tensor:
    """Kernel E in plain torch: element t is the XOR, over k < steps, of
    the four words of Philox4x32-10(counter (t, k, 0, 0), key); int32
    storage of the unsigned words."""
    dev = torch.device(device)
    t = torch.arange(n, device=dev, dtype=torch.int64)
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    k0, k1 = (torch.tensor(k & MASK32, device=dev, dtype=torch.int64) for k in key)
    acc = torch.zeros(n, device=dev, dtype=torch.int64)
    for k in range(steps):
        w = philox4x32_10((t, torch.full((), k, device=dev, dtype=torch.int64), zero,
                           zero), (k0, k1))
        acc = acc ^ w[0] ^ w[1] ^ w[2] ^ w[3]
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


def philox_xor(key: Tuple[int, int], n: int, steps: int, device="cuda") -> torch.Tensor:
    """Kernel E: ``(n,)`` int32 words, each the XOR of ``steps`` Philox
    calls (:func:`philox_xor_plain`). On the CPU it runs the plain
    version; on a CUDA device it launches the kernel or raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return philox_xor_plain(key, n, steps, dev)
    if dev.type != "cuda":
        raise ValueError(f"philox_xor: unsupported device {dev}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    rc = kernels.library().ikpso_philox_xor(
        key[0] & MASK32, key[1] & MASK32, out.data_ptr(), n, steps,
        kernels.stream_ptr(dev))
    kernels.check(rc, "philox_xor")
    philox_xor.launches += 1
    return out


philox_xor.launches = 0


def philox_xor_count(n: int, steps: int) -> FlopCount:
    """Counted work of one kernel E launch: Philox integer operations,
    and one word written per thread."""
    return FlopCount(int_ops=n * (steps * E_OPS_PER_STEP + E_OPS_PER_THREAD),
                     rng_elems=4.0 * n * steps, bytes=4.0 * n)


# ---------------------------------------------------------------------------
# Measured ceilings (slopes between two work sizes).


def _require_cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("roofline measurements need a CUDA device")
    return dev


def _body_walls(body: str, n_steps: int, elems: int, device) -> Tuple[float, float]:
    """Kernel D's median seconds at ``n_steps`` and ``3 * n_steps``."""
    dev = _require_cuda(device)
    x = torch.linspace(0.1, 0.9, elems, device=dev, dtype=torch.float32)
    walls = []
    for steps in (n_steps, 3 * n_steps):
        _, w = measure(lambda xi, s=steps: roofline_body(body, xi, s), x, device=dev,
                       warmup=2, iters=5, vary=lambda i, a: (a[0] + 1e-7 * (i + 1),))
        walls.append(w)
    return walls[0], walls[1]


def _body_rate(body: str, n_steps: int, elems: int, device) -> float:
    w1, w3 = _body_walls(body, n_steps, elems, device)
    return OPS_PER_STEP[body] * 2 * n_steps * elems / max(w3 - w1, 1e-9)


def measure_fma_peak(n_steps: int = 512, elems: int = 1 << 22, device="cuda") -> float:
    """float32 operations/s of the FMA recurrence (3 rotating
    accumulators, ``a = fma(a, b, h)``: 6 operations per element and
    step). The optimistic float ceiling: real kernels mix unfused adds,
    compares and selects."""
    return _body_rate("fma", n_steps, elems, device)


def measure_compose_peak(n_steps: int = 64, elems: int = 1 << 22, device="cuda") -> float:
    """Counted operations/s of chained 3x3 composes (``A <- A.B``,
    ``B <- B.A``: 90 per element and step) as plain mul/add, the
    solver kernels' dominant op pattern under ``-fmad=false``."""
    return _body_rate("compose", n_steps, elems, device)


def measure_transcendental_peak(n_steps: int = 128, elems: int = 1 << 22,
                                device="cuda") -> float:
    """Chained precise ``sinf`` evaluations/s."""
    return _body_rate("sin", n_steps, elems, device)


def _rng_walls(n_steps: int, n: int, device) -> Tuple[float, float]:
    dev = _require_cuda(device)
    walls = []
    for steps in (n_steps, 3 * n_steps):
        _, w = measure(lambda key, s=steps: philox_xor(key, n, s, dev), (7, 11),
                       device=dev, warmup=2, iters=5,
                       vary=lambda i, a: ((a[0][0] + i + 1, a[0][1]),))
        walls.append(w)
    return walls[0], walls[1]


def measure_rng_peak(n_steps: int = 256, n: int = 1 << 20, device="cuda") -> float:
    """32-bit Philox words/s of kernel E (4 words per call)."""
    w1, w3 = _rng_walls(n_steps, n, device)
    return 4.0 * 2 * n_steps * n / max(w3 - w1, 1e-9)


def measure_fitness_kernel_rate(swarms: int = 16_384, particles: int = 1024,
                                k1: int = 4, k2: int = 12, device="cuda", seed: int = 0):
    """Kernel C's rate on the scan path's fitness (``arm_7dof``,
    position-only cost): chains of ``k1`` and ``k2`` launches, each
    reading a swarm row that the previous launch's output perturbs (a
    tiny ``(S, K)`` add), so the slope holds ``k2 - k1`` evaluations and
    nothing else of size. Returns ``(counted ops/s, particle evaluations/s,
    bytes/s)``, the bytes as :func:`utils.flops.fitness_kernel_count`
    counts them."""
    from ikpso_tpu_torch.harness.headline import reachable_targets
    from ikpso_tpu_torch.harness.scan import scan_configs
    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.ops import fk as fk_ops
    from ikpso_tpu_torch.ops.fitness_kernel import fused_fitness, pack_meta, pack_swarm
    from ikpso_tpu_torch.utils.flops import fitness_kernel_count

    dev = _require_cuda(device)
    spec, problem = library.arm_7dof(device=dev)
    _, fit = scan_configs()
    gen = torch.Generator(device=dev).manual_seed(seed)
    batched = library.batched_problem(
        problem, reachable_targets(spec, problem, swarms, gen))
    meta = pack_meta(spec, fit)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       fk_ops.fk_points(spec, batched.pose, batched.origin))
    lim = spec.limits()
    u = torch.rand((swarms, spec.dof, particles), generator=gen, device=dev)
    x = lim[0][None, :, None] + u * (lim[1] - lim[0])[None, :, None]

    def chain(x_dp, sw, length):
        out = None
        for _ in range(length):
            out = fused_fitness(spec, x_dp, meta, sw)
            sw = sw + out[:, :1] * 1e-20
        return out

    walls = []
    for length in (k1, k2):
        _, w = measure(lambda x_dp, sw, n=length: chain(x_dp, sw, n), x, swarm,
                       device=dev, warmup=2, iters=5,
                       vary=lambda i, a: (a[0] + 1e-3 * (i + 1), a[1]))
        walls.append(w)
    one = fitness_kernel_count(spec, fit, num_swarms=swarms, num_particles=particles)
    dt = max(walls[1] - walls[0], 1e-9)
    k = k2 - k1
    return one.ops * k / dt, k * swarms * particles / dt, one.bytes * k / dt


def megakernel_slope(spec, batched, pso, fit, *, particles: int, device, seed: int = 0,
                     obstacles=None):
    """Kernel A at ``pso.iterations`` and 3x as many iterations (no
    polish, no retries), with the scene ``obstacles`` and, where ``fit``
    weighs it and ``batched`` has target rotations, the orientation term:
    returns ``(seconds, FlopCount)`` of exactly ``pso.iterations`` loop
    iterations -- half the difference of the two walls, and half the
    difference of the two counts (init, the constants' bytes and the
    launch cancel). The counts are ``fused_solve_count``'s with the
    scene's boxes and no collider work, so the bound stays below the
    kernel's."""
    from ikpso_tpu_torch.ops import fk as fk_ops
    from ikpso_tpu_torch.ops.fitness_kernel import pack_meta, pack_swarm
    from ikpso_tpu_torch.pso.fused import fused_solve
    from ikpso_tpu_torch.pso.polish_soa import anchor_positions_flat
    from ikpso_tpu_torch.utils.flops import fused_solve_count

    dev = _require_cuda(device)
    s = batched.pose.shape[0]
    num_obstacles = 0 if obstacles is None else obstacles.count
    orient = float(fit.orientation_weight) != 0.0 and batched.target_rot is not None
    meta = pack_meta(spec, fit, obstacles, orient).to(dev)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched), orient)
    limits = spec.limits().to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    seeds = torch.randint(-2**31, 2**31, (s, 2), generator=gen, device=dev,
                          dtype=torch.int32)
    walls, counts = [], []
    for mult in (1, 3):
        cfg = dataclasses.replace(pso, iterations=pso.iterations * mult)
        _, w = measure(
            lambda sd, c=cfg: fused_solve(spec, c, fit, meta, swarm, limits, sd, particles,
                                          num_obstacles=num_obstacles,
                                          use_orientation=orient),
            seeds, device=dev, warmup=1, iters=5,
            vary=lambda i, a: (a[0] + (i + 1),))
        walls.append(w)
        counts.append(fused_solve_count(spec, cfg, fit, num_particles=particles,
                                        num_swarms=s, num_obstacles=num_obstacles,
                                        use_orientation=orient))
    d = counts[1] + counts[0] * -1.0
    return max((walls[1] - walls[0]) / 2.0, 1e-9), d * 0.5


def measure_megakernel_rate(iterations: int = 8, swarms: int = 262_144,
                            particles: int = 128, device="cuda", seed: int = 0) -> float:
    """Counted ops/s of kernel A's PSO loop on the headline's settings
    (canonical inertia 0.5 -> 0.2, warm init, position-only cost)."""
    from ikpso_tpu_torch.harness.headline import headline_configs, reachable_targets
    from ikpso_tpu_torch.models import library

    dev = _require_cuda(device)
    spec, problem = library.arm_7dof(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batched = library.batched_problem(
        problem, reachable_targets(spec, problem, swarms, gen))
    _, pso, fit = headline_configs()
    pso = dataclasses.replace(pso, iterations=iterations)
    dt, count = megakernel_slope(spec, batched, pso, fit, particles=particles,
                                 device=dev, seed=seed)
    return count.ops / dt


def card_name() -> str:
    """``name, power.limit`` of GPU 0, as ``nvidia-smi`` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def main() -> None:
    dev = _require_cuda("cuda")
    out = {"card": card_name(), "published_peaks": PUBLISHED_PEAKS}
    for name, fn in (("fma_flops_per_s", measure_fma_peak),
                     ("compose_flops_per_s", measure_compose_peak),
                     ("transcendental_per_s", measure_transcendental_peak),
                     ("rng_words_per_s", measure_rng_peak)):
        out[name] = fn(device=dev)
    kf, ke, kb = measure_fitness_kernel_rate(device=dev)
    out.update(fitness_kernel_ops_per_s=kf, fitness_kernel_evals_per_s=ke,
               fitness_kernel_bytes_per_s=kb)
    out["kernel_ops_per_s"] = measure_megakernel_rate(device=dev)
    peak = PUBLISHED_PEAKS["fp32_ops_per_s"]
    out["share_of_published"] = {
        k: out[k] / peak for k in ("fma_flops_per_s", "compose_flops_per_s",
                                   "fitness_kernel_ops_per_s", "kernel_ops_per_s")}
    out["share_of_published"]["fitness_kernel_bytes_per_s"] = (
        kb / PUBLISHED_PEAKS["hbm_bytes_per_s"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
