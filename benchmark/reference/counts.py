"""Frozen operation and byte counts of the port's kernels, and the card's
published peaks: the yardstick of the roofline metrics.

Copies of ``ikpso_tpu_torch/utils/flops.py`` as it counts today
(``scan_step_count``, ``philox_call_ops``, ``pso_update_count``) for the
configurations the benchmark runs: no scene, no orientation, no distance
term, no re-kick. The fitness tile's operations a particle, which the
port counts by dispatching its plain tile, are frozen as numbers in each
configuration's ``counts`` block. The counts follow from shapes alone,
so the same work reads the same whatever implements it; a test holds
them equal to the port's at every cell's shapes.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores (an FMA
# counts 2) and HBM3, at the full 700 W power limit.
PEAK_FP32_OPS_PER_S = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

PHILOX_KEY_SCHEDULE_OPS = 9 * 2
ZERO, CONST, THREAD, CALL = range(4)


def philox_call_ops(counter) -> Tuple[float, float]:
    """``(per call, per thread)`` integer ops of one Philox4x32-10 call
    whose counter words are of the kinds ``counter``."""
    ops = [0, 0]

    def mul(w):
        if w >= THREAD:
            ops[w == THREAD] += 2
        return w, w

    def xor(*ws):
        ws = [w for w in ws if w != ZERO]
        if not ws:
            return ZERO
        fixed = sum(w == THREAD for w in ws) + any(w == CONST for w in ws)
        changing = sum(w == CALL for w in ws)
        if any(w == THREAD for w in ws):
            ops[1] += fixed - 1
        if changing:
            ops[0] += changing - (0 if fixed else 1)
        return max(ws)

    c = list(counter)
    for _ in range(10):
        hi0, lo0 = mul(c[0])
        hi1, lo1 = mul(c[2])
        c = [xor(hi1, c[1], THREAD), lo1, xor(hi0, c[3], THREAD), lo0]
    return float(ops[0]), float(ops[1])


def update_flops(dof: int, randomized: bool) -> Tuple[float, float]:
    """``(flops, draws)`` of one velocity and position update, a particle."""
    n_draws = 3 if randomized else 2
    return float(dof * (n_draws * 3 + (8 if randomized else 7) + 1 + 2)), float(dof * n_draws)


def scan_step(counts: dict, dof: int, r: dict, num_swarms: int,
              improved: float = 0.0) -> Tuple[float, float]:
    """``(operations, bytes)`` of one launch of the drawing scan step of
    recipe ``r`` over S swarms (``scan_step_count(drawing=True)``, no
    kick). ``improved`` particles write a new lbest row back; the
    benchmark counts 0, the least the step has to move."""
    if r.get("rekick_interval"):
        raise ValueError("the frozen count covers the step without re-kicks")
    d, p, s = dof, r["particles"], num_swarms
    randomized = r["inertia_mode"] == "randomized"
    planes = 3 if randomized else 2
    upd_flops, upd_draws = update_flops(d, randomized)
    per_particle = counts["tile_flops"] + counts["tile_transcendentals"] + (
        upd_flops - 3.0 * upd_draws + 2.0)
    particles = float(s * p)
    bytes_ = 4.0 * (particles * (3 * d + 1 + 2 * d) + improved * (d + 1)
                    + 2.0 * s * (d + 1) + counts["meta_size"] + s * counts["swarm_size"] + 2 * d)
    b = counts["step_threads"]
    blocks = -(-p // b)
    drawing_threads = sum(min(b, -(-min(b, p - k * b) * d // 4)) for k in range(blocks))
    per_call, per_thread = philox_call_ops((CALL, THREAD, ZERO, ZERO))
    calls = planes * -(-p * d // 4)
    draw_flops = 3.0 * planes * d * p
    draw_ints = calls * per_call + drawing_threads * (PHILOX_KEY_SCHEDULE_OPS
                                                      + planes * per_thread)
    ops = per_particle * particles + (draw_flops + draw_ints) * s
    return ops, bytes_ + 4.0 * 2 * blocks * s


def bound_seconds(ops: float, bytes_: float) -> float:
    """The least time the card could take: the larger of the operation
    and the byte bound at the published peaks."""
    return max(ops / PEAK_FP32_OPS_PER_S, bytes_ / PEAK_HBM_BYTES_PER_S)
