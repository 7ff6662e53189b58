"""The port's op model (ikpso_tpu_torch.utils.flops) against the JAX
package's (ikpso_tpu/utils/flops.py), and the roofline's plain kernels
(ikpso_tpu_torch.utils.roofline) against numpy statements of their
recurrences (ikpso_tpu/utils/roofline.py:151-205; the JAX versions run
only as timed Pallas calls).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ikpso_tpu.models import library as jlib
from ikpso_tpu.models.chain import Obstacles as JObstacles
from ikpso_tpu.ops.fitness import FitnessConfig as JFit
from ikpso_tpu.pso.config import PSOConfig as JPSO
from ikpso_tpu.utils import flops as jflops
from ikpso_tpu_torch.models import convert
from ikpso_tpu_torch.ops.fitness_kernel import (
    MetaLayout,
    pack_meta,
    pack_swarm,
    sat_separations,
)
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.philox import MASK32
from ikpso_tpu_torch.utils import flops, kernels, roofline

SPEC_J = jlib.arm_7dof()[0]
SPEC = convert.chain_spec_from(SPEC_J)


@pytest.mark.parametrize("shape,n_obs,tol", [
    ("box", 0, 0.0),
    # JAX shares the link box's center across a node's obstacles and
    # seeds each SAT's OR with zeros (+1 op); the port charges the
    # center per pair, as the kernels compute it: +0.6%.
    ("box", 4, 0.02),
    # JAX charges node 1's box-frame transform of its parent (the root,
    # a per-swarm scalar) once per tile; the port per particle, as the
    # kernels do, and its point test recomputes p - c per axis: +1.7%.
    ("capsule", 4, 0.02),
])
def test_fitness_tile_count_matches_jax(shape, n_obs, tol):
    fit_j = JFit(angle_weight=0.0, distance_weight=0.0, collision_shape=shape)
    want = jflops.fitness_tile_count(SPEC_J, fit_j, num_obstacles=n_obs)
    got = flops.fitness_tile_count(SPEC, convert.fitness_config_from(fit_j),
                                   num_obstacles=n_obs)
    assert got.flops == pytest.approx(want.flops, rel=tol, abs=0.0 if tol else 1e-9)
    assert got.transcendentals == want.transcendentals == 0.0


@pytest.mark.parametrize("orientation", [False, True])
def test_arm_6dof_tile_count_matches_jax(orientation):
    # The orientation branch of the plain tile counts what the Pallas tile
    # body counts (9 differences, squares and sums, the weight product).
    spec_j = jlib.arm_6dof()[0]
    fit_j = JFit(angle_weight=0.0, distance_weight=0.0, orientation_weight=1.0)
    want = jflops.fitness_tile_count(spec_j, fit_j, use_orientation=orientation)
    got = flops.fitness_tile_count(convert.chain_spec_from(spec_j),
                                   convert.fitness_config_from(fit_j),
                                   use_orientation=orientation)
    assert got.flops == want.flops
    if orientation:
        assert got.flops - flops.fitness_tile_count(
            convert.chain_spec_from(spec_j)).flops == pytest.approx(27.0 + 2.0 + 1 / 1024)


@pytest.mark.parametrize("mode", ["randomized", "canonical"])
def test_pso_update_count_matches_jax(mode):
    pso_j = JPSO(inertia_mode=mode)
    want = jflops.pso_update_count(SPEC_J, pso_j)
    got = flops.pso_update_count(SPEC, convert.pso_config_from(pso_j))
    assert (got.flops, got.rng_elems) == (want.flops, want.rng_elems)


def test_fused_solve_count_shares_jax_fitness_and_update():
    # Fitness evaluations and updates are the shared design; the TPU's
    # roll-tree gbest gives way to kernel A's warp-butterfly argmin, and
    # the port adds the init and the Philox integer operations.
    s, p = 4096, 1024
    pso_j = JPSO(iterations=8, inertia_mode="canonical", inertia_end=0.2)
    fit_j = JFit(angle_weight=0.0, distance_weight=0.0)
    pso = convert.pso_config_from(pso_j)
    want = jflops.fused_solve_count(SPEC_J, pso_j, fit_j, num_particles=p, num_swarms=s)
    got = flops.fused_solve_count(SPEC, pso, convert.fitness_config_from(fit_j),
                                  num_particles=p, num_swarms=s)
    it, d = pso.iterations, SPEC.dof
    gbest_j = jflops.gbest_broadcast_count(d, p // 128, 1).flops * (it + 2)
    port_only = (it + 1) * flops.argmin_count(p).flops + 6.0 * d
    assert got.flops / (s * p) - port_only == pytest.approx(
        want.flops / (s * p) - gbest_j, rel=1e-12)
    assert got.rng_elems / (s * p) - d == want.rng_elems / (s * p)
    # Philox: 63 ops per call of each of the 3 groups of every draw slot;
    # once per thread, the group's fixed work (12 for g = 0, 14 for
    # g = 1, 2) and the key schedule.
    assert got.int_ops == s * p * ((1 + 2 * it) * 3 * 63 + 12 + 2 * 14 + 18)


@pytest.mark.parametrize("kw,kicks", [
    (dict(inertia_mode="randomized", rekick_interval=4, gbest_interval=2), None),
    (dict(inertia_mode="canonical", inertia_end=0.2, rekick_interval=2,
          rekick_threshold=1e-6, init_mode="uniform"), 5.0),
    (dict(inertia_mode="canonical", gbest_interval=4), None),
])
def test_fused_solve_count_one_iteration_at_a_time(kw, kicks):
    # fused_solve_count against a statement of kernel A's loop, one
    # iteration at a time (csrc/fused_solve.cu): a refresh argmin where
    # it % gbest_interval == 0, a threshold compare at each kick block
    # start but the first, the kicked swarms' draws and writes, the
    # iteration's draw slots, update and evaluation.
    s, p, it = 3, 64, 8
    pso = convert.pso_config_from(JPSO(iterations=it, **kw))
    fit = convert.fitness_config_from(JFit(angle_weight=0.0))
    d = SPEC.dof
    n_init = 1 if pso.init_mode == "warm" else 2
    tile = flops.fitness_tile_count(SPEC, fit)
    per_call = 63.0 * 3  # 3 Philox groups of D=9, 63 changing ops each
    slots, threads, per = n_init, 0.0, tile + flops.FlopCount(
        flops=6.0 * d * n_init, rng_elems=float(d * n_init))
    rk = pso.rekick_interval
    for i in range(it):
        if i % max(1, pso.gbest_interval) == 0:
            per = per + flops.argmin_count(p)
        if rk and i and i % rk == 0:
            per = per + flops.FlopCount(flops=1.0)
        slots += 3 if pso.inertia_mode == "randomized" else 2
        per = per + flops.pso_update_count(SPEC, pso) + tile
    per = per + flops.argmin_count(p)
    n_kicks = (it // rk - 1) * s if rk and kicks is None else (kicks or 0.0)
    threads = 12 + 2 * 14 + 18  # per-thread Philox work and key schedule
    want_int = s * p * (slots * per_call + threads) + n_kicks * p * per_call
    got = flops.fused_solve_count(SPEC, pso, fit, num_particles=p, num_swarms=s,
                                  kicks=kicks)
    assert got.int_ops == want_int
    assert got.flops == pytest.approx(per.flops * s * p + n_kicks * p * 6.0 * d,
                                      rel=1e-12)
    assert got.rng_elems == per.rng_elems * s * p + n_kicks * p * d


@pytest.mark.parametrize("counter,want", [
    # Every word changes: the full 10 rounds of 2 products and 2 XORs
    # (4 + 4 ops), nothing fixed.
    ((flops.CALL,) * 4, (80.0, 0.0)),
    # Kernel E's (t, k, 0, 0). Per call: round 1 the XOR with k (1);
    # round 2 the product of the changing word and one XOR (3); round 3
    # a product and two XORs with a fixed operand (4); round 4 two
    # products, a two-changing XOR and one more (7); rounds 5-10 all 8
    # (48). Per thread: the products of t and the words it fixes (12).
    ((flops.THREAD, flops.CALL, flops.ZERO, flops.ZERO), (63.0, 12.0)),
    # Kernel A's (particle, slot, g, 0) for g > 0: the product of g folds
    # at compile time; XORing its result into the fixed words costs 2
    # more per thread.
    ((flops.THREAD, flops.CALL, flops.CONST, flops.ZERO), (63.0, 14.0)),
    # Nothing changes: all work once per thread; rounds 1 and 2 skip the
    # zero words (3 + 7), rounds 3-10 do all 8 (64).
    ((flops.THREAD, flops.ZERO, flops.ZERO, flops.ZERO), (0.0, 74.0)),
])
def test_philox_call_ops_charges_fixed_work_once_per_thread(counter, want):
    assert flops.philox_call_ops(counter) == want


def test_bytes_count_each_input_once_and_each_output_once():
    s, p, n_obs = 64, 128, 4
    lay = MetaLayout(SPEC, n_obs)
    fit = convert.fitness_config_from(JFit())
    c = flops.fitness_kernel_count(SPEC, fit, num_swarms=s, num_particles=p,
                                   num_obstacles=n_obs, collider_ops=123.0)
    d = SPEC.dof
    assert c.bytes == 4 * (s * p * d + s * lay.swarm_size + lay.meta_size + s * p)
    base = flops.fitness_kernel_count(SPEC, fit, num_swarms=s, num_particles=p)
    assert c.flops - 123.0 == pytest.approx(base.flops)
    pso = convert.pso_config_from(JPSO(iterations=5, inertia_mode="canonical"))
    a = flops.fused_solve_count(SPEC, pso, fit, num_particles=p, num_swarms=s)
    lay0 = MetaLayout(SPEC)
    # In: meta, swarm rows, limits, seeds, the inertia schedule; out: gbest, gval.
    assert a.bytes == 4 * (lay0.meta_size + s * lay0.swarm_size + 2 * d + 2 * s + 5
                           + s * (d + 1))


@pytest.mark.parametrize("mode,kick,planes", [("randomized", False, 3),
                                               ("randomized", True, 4),
                                               ("canonical", False, 2),
                                               ("canonical", True, 3)])
def test_scan_step_count_moves_each_byte_once(mode, kick, planes):
    s, p, d = 16, 300, SPEC.dof
    fit = convert.fitness_config_from(JFit())
    pso = convert.pso_config_from(JPSO(iterations=5, inertia_mode=mode))
    lay = MetaLayout(SPEC)
    c = flops.scan_step_count(SPEC, pso, fit, num_swarms=s, num_particles=p, improved=70,
                              kick=kick)
    # In: x, v, lbest, the lbest value and the uniform planes; out: x, v, and
    # the lbest row and value of each improved particle; gbest in and out.
    assert c.bytes == 4 * (s * p * (3 * d + 1 + planes * d + 2 * d) + 70 * (d + 1)
                           + 2 * s * (d + 1) + lay.meta_size + s * lay.swarm_size + 2 * d)
    # The scan shape, every particle improved: 83 floats a particle (332 B).
    if mode == "randomized" and not kick:
        full = flops.scan_step_count(SPEC, pso, fit, num_swarms=1, num_particles=1,
                                     improved=1)
        assert full.bytes - 4 * (2 * (d + 1) + lay.meta_size + lay.swarm_size + 2 * d) \
            == 4 * 83
    tile = flops.fitness_tile_count(SPEC, fit)
    update = flops.pso_update_count(SPEC, pso)
    per = (tile.flops + update.flops - 3 * update.rng_elems + (3 * d if kick else 0) + 2)
    assert c.flops == pytest.approx(per * s * p)
    assert c.rng_elems == 0.0


@pytest.mark.parametrize("mode,kick,planes", [("randomized", False, 3),
                                               ("randomized", True, 4),
                                               ("canonical", False, 2),
                                               ("canonical", True, 3)])
@pytest.mark.parametrize("p", [300, 1024])
def test_scan_step_count_drawing_step_reads_no_planes(mode, kick, planes, p):
    s, d = 16, SPEC.dof
    fit = convert.fitness_config_from(JFit())
    pso = convert.pso_config_from(JPSO(iterations=5, inertia_mode=mode))
    lay = MetaLayout(SPEC)
    replay = flops.scan_step_count(SPEC, pso, fit, num_swarms=s, num_particles=p,
                                   improved=70, kick=kick)
    c = flops.scan_step_count(SPEC, pso, fit, num_swarms=s, num_particles=p, improved=70,
                              kick=kick, drawing=True)
    b = kernels.step_threads(d)
    assert b == 128  # arm_7dof's step block
    blocks = -(-p // b)
    # No uniform plane; the seed words once a block.
    assert c.bytes == 4 * (s * p * (3 * d + 1 + 2 * d) + 70 * (d + 1) + 2 * s * (d + 1)
                           + lay.meta_size + s * lay.swarm_size + 2 * d + 2 * s * blocks)
    assert replay.bytes - c.bytes == 4 * s * (p * planes * d - 2 * blocks)
    # The draws' conversion, 3 ops each, over the replay step's arithmetic.
    assert c.flops - replay.flops == pytest.approx(3.0 * planes * d * s * p)
    assert c.rng_elems == planes * d * s * p
    # Philox: ceil(P * D / 4) calls a swarm and slot of counter (call, slot, 0, 0);
    # each thread that draws runs the key schedule and each slot's fixed words once.
    per_call, per_thread = flops.philox_call_ops((flops.CALL, flops.THREAD, flops.ZERO,
                                                  flops.ZERO))
    assert (per_call, per_thread) == (70.0, 5.0)
    threads = sum(min(b, -(-min(b, p - k * b) * d // 4)) for k in range(blocks))
    assert c.int_ops == s * (planes * -(-p * d // 4) * per_call
                             + threads * (flops.PHILOX_KEY_SCHEDULE_OPS + planes * per_thread))
    # The scan shape with randomized inertia and every particle improved: 56
    # floats a particle (224 B) against the replay step's 83.
    if mode == "randomized" and not kick and p == 1024:
        full = flops.scan_step_count(SPEC, pso, fit, num_swarms=1, num_particles=1024,
                                     improved=1024, drawing=True)
        fixed = 4 * (2 * (d + 1) + lay.meta_size + lay.swarm_size + 2 * d + 2 * 8)
        assert full.bytes - fixed == 4 * 56 * 1024


def test_bound_takes_the_larger_term():
    peaks = roofline.PUBLISHED_PEAKS
    ops = flops.FlopCount(flops=67e12, int_ops=67e12, bytes=3.35e12)
    assert roofline.speed_of_light_seconds(ops) == (pytest.approx(2.0), "operations")
    byt = flops.FlopCount(flops=67e9, bytes=3 * 3.35e12)
    assert roofline.speed_of_light_seconds(byt) == (pytest.approx(3.0), "bytes")
    assert peaks == {"fp32_ops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def _kernel_order_work(x, meta, swarm, shape, n_obs):
    """Collider ops of each particle, one at a time, in the device
    function's order (csrc/fk_fitness.cuh: fk_fitness_eval_at, node_hits,
    the slab reject, sat_frame, sat_obb, seg_obb_dist2)."""
    from ikpso_tpu_torch.ops.fitness_kernel import (
        _excess2,
        box_frame_offset,
        box_pair_reject,
        box_reject_radii,
        box_reject_slack,
        capsule_pair_reject,
        capsule_reject_radius,
        fk_walk_tile,
        reject_angles_in_range,
        sat_frame,
        scene_constants,
        seg_obb_dist2_frame,
    )

    node_half, link_half, node_r2, link_r2 = scene_constants(0.2)
    prefix = flops._sat_prefix_costs()
    cost = flops.reject_costs(shape)
    lay = MetaLayout(SPEC)
    m = meta.reshape(-1)
    scene = []
    for o in range(n_obs):
        ob = m[lay.OFF_OBS + 15 * o:lay.OFF_OBS + 15 * (o + 1)]
        scene.append((tuple(ob[:3]), tuple(ob[3:6]),
                      tuple(tuple(ob[6 + 3 * r + c] for c in range(3)) for r in range(3))))

    def sat(center, half, rk, oc, oh, orot, frame):
        """(ops, hit) of one SAT stopping at its first separating axis."""
        for axis, sep in enumerate(sat_separations(*center, rk, half, oc, oh, orot, frame)):
            if bool(sep):
                return prefix[axis], False
        return prefix[-1], True

    total = 0.0
    for i in range(x.shape[1]):
        xi = x[:, i:i + 1]
        rots, poss, _ = fk_walk_tile(SPEC, lambda d: xi[..., d], lambda j: m[j],
                                     lambda j: swarm[:, j:j + 1])
        hit = False
        if shape == "box":
            total += cost["eval"] + n_obs * cost["obstacle"]
            slack = box_reject_slack(SPEC.num_nodes, tuple(swarm[:, j:j + 1] for j in range(9)),
                                     [orot for _, _, orot in scene])
        for k in range(1, SPEC.num_nodes):
            pk, rk, pp = poss[k], rots[k], poss[SPEC.parent[k]]
            length = m[lay.OFF_LEN + k - 1]
            if shape == "box":
                d0 = 3 * (k - 1)
                if not bool(reject_angles_in_range(xi[..., d0], xi[..., d0 + 1],
                                                   xi[..., d0 + 2])):
                    slack = torch.full_like(slack, float("inf"))
                total += cost["angles"]
            if hit:
                continue
            total += cost["node"]
            for oc, oh, orot in scene:
                if shape == "capsule":
                    total += cost["point"]
                    q1 = box_frame_offset(pk, oc, orot)[0]
                    if bool(_excess2(q1, oh) <= node_r2):
                        hit = True
                        break
                    total += cost["pair"]
                    q0 = box_frame_offset(pp, oc, orot)[0]
                    if bool(capsule_pair_reject(q0, q1, oh, capsule_reject_radius(link_r2))):
                        continue
                    total += cost["bisection"]
                    if bool(seg_obb_dist2_frame(q0, q1, oh) <= link_r2):
                        hit = True
                        break
                    continue
                total += cost["pair"]
                pmag, r_cube, r_link = box_reject_radii(pk, pp, slack, node_half, link_half)
                cube, link = (bool(v) for v in box_pair_reject(pk, pp, oc, oh, orot, pmag,
                                                               r_cube, r_link, slack))
                if cube and link:
                    continue
                total += cost["frame"]
                frame = sat_frame(rk, orot)
                if not cube:
                    ops, hit = sat(pk, (node_half,) * 3, rk, oc, oh, orot, frame)
                    total += ops
                if not hit and not link:
                    mid = tuple((pk[j] + pp[j]) * 0.5 for j in range(3))
                    ops, hit = sat(mid, (length * 0.5, link_half, link_half), rk, oc, oh,
                                   orot, frame)
                    total += flops.LINK_BOX_SETUP + ops
                if hit:
                    break
    return total


def _collider_case(shape, centers, dims, quats, particles=48, seed=40, scale_axis=None):
    rng = np.random.default_rng(seed)
    spec_j, problem_j = jlib.arm_7dof()
    obs = convert.obstacles_from(JObstacles.from_boxes(centers, dims, quats))
    if scale_axis is not None:  # a scene axis 1% long: the box reject's precondition fails
        obs = dataclasses.replace(obs, rot=obs.rot * torch.tensor([1.0, 1.0, 1.01]))
    problem = convert.problem_from(jlib.batched_problem(problem_j, problem_j.targets[None]))
    fit = dataclasses.replace(convert.fitness_config_from(JFit()), collision_shape=shape)
    meta = pack_meta(SPEC, fit, obs)
    swarm = pack_swarm(SPEC, problem, fk_ops.pose_to_angles(SPEC, problem.pose),
                       fk_ops.fk_points(SPEC, problem.pose, problem.origin))
    lim = SPEC.limits().numpy()
    x = torch.as_tensor((lim[0] + rng.random((1, particles, SPEC.dof)) * (lim[1] - lim[0]))
                        .astype(np.float32))
    return fit, obs, meta, swarm, x


@pytest.mark.parametrize("shape", ["box", "capsule"])
def test_collider_work_counts_what_the_kernel_evaluates(shape):
    fit, obs, meta, swarm, x = _collider_case(
        shape, [(1.0, 0.5, 0.0), (-0.6, -0.6, 0.3)], [(1.2, 1.2, 1.2), (0.8, 0.8, 0.8)],
        [(0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.383, 0.924)])
    got = flops.collider_work(SPEC, x, meta, swarm, num_obstacles=obs.count,
                              collision_shape=shape, chunk=16)
    assert got == _kernel_order_work(x, meta, swarm, shape, obs.count)
    full = (flops.fitness_tile_count(SPEC, fit, num_obstacles=obs.count).flops
            - flops.fitness_tile_count(SPEC, fit).flops) * x.shape[1]
    assert 0 < got < full


@pytest.mark.parametrize("shape", ["box", "capsule"])
def test_collider_work_where_the_reject_decides_every_pair(shape):
    # Two small boxes far from the arm: every pair is rejected, so the work
    # is the reject's alone, in closed form.
    fit, obs, meta, swarm, x = _collider_case(
        shape, [(30.0, 0.0, 0.0), (0.0, -30.0, 5.0)], [(1.0, 1.0, 1.0), (0.5, 0.5, 0.5)],
        [(0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.383, 0.924)])
    got = flops.collider_work(SPEC, x, meta, swarm, num_obstacles=2, collision_shape=shape)
    assert got == _kernel_order_work(x, meta, swarm, shape, 2)
    cost = flops.reject_costs(shape)
    nodes, p = SPEC.num_nodes - 1, x.shape[1]
    if shape == "box":
        per = (cost["eval"] + 2 * cost["obstacle"]
               + nodes * (cost["angles"] + cost["node"] + 2 * cost["pair"]))
    else:
        per = nodes * (cost["node"] + 2 * (cost["point"] + cost["pair"]))
    assert got == p * per


@pytest.mark.parametrize("shape", ["box", "capsule"])
def test_collider_work_where_the_reject_decides_no_pair(shape):
    # Box: a scene axis 1% long disarms the reject, so every pair pays the
    # reject and the narrow phase. Capsule: a box around the root, which
    # every first link leaves from: the reject cannot decide node 1's
    # pair, and the bisection finds the hit.
    if shape == "box":
        fit, obs, meta, swarm, x = _collider_case(
            shape, [(1.0, 0.5, 0.0), (-0.6, -0.6, 0.3)], [(1.2, 1.2, 1.2), (0.8, 0.8, 0.8)],
            [(0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.383, 0.924)], scale_axis=2)
    else:
        fit, obs, meta, swarm, x = _collider_case(
            shape, [(0.0, 0.0, 0.0)], [(0.2, 0.2, 0.2)], None)
    got = flops.collider_work(SPEC, x, meta, swarm, num_obstacles=obs.count,
                              collision_shape=shape)
    assert got == _kernel_order_work(x, meta, swarm, shape, obs.count)
    cost = flops.reject_costs(shape)
    p = x.shape[1]
    if shape == "box":
        # More than the reject alone on every pair: the narrow phase ran.
        nodes = SPEC.num_nodes - 1
        floor = p * (cost["eval"] + obs.count * cost["obstacle"] + nodes * (
            cost["angles"] + cost["node"] + obs.count * (cost["pair"] + cost["frame"])))
        assert got > floor
        assert flops.collider_work(SPEC, x, meta, swarm, num_obstacles=obs.count,
                                   collision_shape=shape) == got
    else:
        assert got == p * (cost["node"] + cost["point"] + cost["pair"] + cost["bisection"])


def test_fused_solve_collider_work_follows_the_plain_trajectory():
    rng = np.random.default_rng(41)
    spec_j, problem_j = jlib.arm_7dof()
    obs = convert.obstacles_from(JObstacles.from_boxes([(1.0, 0.5, 0.0)], [(1.2, 1.2, 1.2)]))
    problem = convert.problem_from(jlib.batched_problem(
        problem_j, np.repeat(np.asarray(problem_j.targets)[None], 2, 0)))
    fit = dataclasses.replace(convert.fitness_config_from(JFit(angle_weight=0.0)),
                              collision_shape="box")
    pso = convert.pso_config_from(JPSO(iterations=2, inertia_mode="canonical",
                                       init_mode="uniform"))
    meta = pack_meta(SPEC, fit, obs)
    swarm = pack_swarm(SPEC, problem, fk_ops.pose_to_angles(SPEC, problem.pose),
                       fk_ops.fk_points(SPEC, problem.pose, problem.origin))
    seeds = torch.as_tensor(rng.integers(-2**31, 2**31, (2, 2)).astype(np.int32))
    seen = []
    work = flops.fused_solve_collider_work(SPEC, pso, fit, meta, swarm, SPEC.limits(),
                                           seeds, 32, num_obstacles=1)
    from ikpso_tpu_torch.pso.fused import fused_solve_plain

    fused_solve_plain(SPEC, pso, fit, meta, swarm, SPEC.limits(), seeds, 32,
                      num_obstacles=1, observe=lambda x: seen.append(x.clone()))
    # 3 evaluations of 2 x 32 particles, each charged as the kernel runs it,
    # the reject's slack once a swarm row (the first evaluation's).
    assert len(seen) == 3
    assert work == sum(flops.collider_work(SPEC, x, meta, swarm, num_obstacles=1,
                                           collision_shape="box", row_ops=i == 0)
                       for i, x in enumerate(seen))
    cost = flops.reject_costs("box")
    assert (sum(flops.collider_work(SPEC, x, meta, swarm, num_obstacles=1,
                                    collision_shape="box") for x in seen) - work
            == 2 * 2 * 32 * (cost["eval"] + cost["obstacle"]))
    per_eval = (flops.fitness_tile_count(SPEC, fit, num_obstacles=1).flops
                - flops.fitness_tile_count(SPEC, fit).flops)
    assert 0 < work < 3 * 2 * 32 * per_eval


def _np_fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)


def _np_body(body, x, steps):
    """The recurrences of ikpso_tpu/utils/roofline.py:151-205 in numpy
    float32, the FMA body as one rounding per step (fmaf)."""
    f = np.float32
    if body == "fma":
        a, b, c = x, x * f(0.5) + f(0.1), x * f(0.25) + f(0.2)
        for _ in range(steps):
            a = _np_fma(a, b, 0.5)
            b = _np_fma(b, c, 0.5)
            c = _np_fma(c, a, 0.5)
        return a + b + c
    if body == "compose":
        def mm(a, b):
            return [a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j]
                    for i in range(3) for j in range(3)]

        a = [x * f(0.1 * (i + 1)) for i in range(9)]
        b = [x * f(0.05 * (i + 1)) + f(0.1) for i in range(9)]
        for _ in range(steps):
            a = mm(a, b)
            b = mm(b, a)
        acc = a[0]
        for t in a[1:] + b:
            acc = acc + t
        return acc
    for _ in range(steps):
        x = np.sin(x)
    return x


@pytest.mark.parametrize("body", sorted(roofline.BODIES))
def test_roofline_bodies_match_numpy(body):
    x = np.linspace(0.1, 0.9, 4096, dtype=np.float32)
    before = roofline.roofline_body.launches
    got = roofline.roofline_body(body, torch.as_tensor(x), 4).numpy()
    want = _np_body(body, x, 4)
    assert roofline.roofline_body.launches == before  # CPU: the plain twin ran
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6 if body == "sin" else 0, atol=0)


def _philox_py(c, k):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
    c, k = list(c), list(k)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & MASK32, (k[1] + 0xBB67AE85) & MASK32]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & MASK32, (p0 >> 32) ^ c[3] ^ k[1], p0 & MASK32]
    return c


def test_philox_xor_matches_python_statement():
    key, n, steps = (0x12345678, 0xFFFFFFF0), 8, 3
    before = roofline.philox_xor.launches
    got = roofline.philox_xor(key, n, steps, "cpu").numpy().astype(np.int64) & MASK32
    assert roofline.philox_xor.launches == before
    for t in range(n):
        acc = 0
        for k in range(steps):
            w = _philox_py((t, k, 0, 0), key)
            acc ^= w[0] ^ w[1] ^ w[2] ^ w[3]
        assert got[t] == acc


def test_roofline_counts():
    c = roofline.roofline_body_count("compose", 1000, 10)
    assert (c.flops, c.bytes) == (1000 * (90 * 10 + 44), 8000)
    e = roofline.philox_xor_count(1000, 10)
    # Per step 63 Philox ops and 4 XORs; per thread 12 + the key schedule.
    assert (e.int_ops, e.rng_elems, e.bytes) == (1000 * (10 * 67 + 30), 40000, 4000)
    with pytest.raises(ValueError, match="body"):
        roofline.roofline_body("tan", torch.zeros(4), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.measure_fma_peak(device="cpu")


def test_measure_hands_each_call_its_own_inputs():
    from ikpso_tpu_torch.utils.profiling import measure

    seen = []
    result, seconds = measure(lambda a: seen.append(a) or a, 0, device="cpu", warmup=2,
                              iters=3, vary=lambda i, args: (args[0] + i,))
    assert seen == [3, 4, 0, 1, 2]  # warm-ups take the indices above the timed range
    assert result == 2 and seconds >= 0.0


def test_profiling_solve_flops_matches_jax():
    # utils/profiling.py's solve_flops goes through the op model: JAX's
    # value less its gbest broadcasts equals the port's less kernel A's
    # argmins and init (test_fused_solve_count_shares_jax_fitness_and_update).
    from ikpso_tpu.utils.profiling import solve_flops as j_solve_flops
    from ikpso_tpu_torch.utils.profiling import solve_flops

    s, p = 2048, 1024
    pso_j = JPSO(iterations=8)
    pso = convert.pso_config_from(pso_j)
    want = j_solve_flops(SPEC_J, p, s, pso_j)
    got = solve_flops(SPEC, p, s, pso)
    it, d = pso.iterations, SPEC.dof
    gbest_j = jflops.gbest_broadcast_count(d, p // 128, 1).flops * (it + 2)
    port_only = (it + 1) * flops.argmin_count(p).flops + 6.0 * d
    assert got / (s * p) - port_only == pytest.approx(want / (s * p) - gbest_j, rel=1e-9)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, for the timer's walk."""

    @staticmethod
    def __new__(cls, index):
        t = torch.Tensor._make_subclass(cls, torch.zeros(1))
        t.card = index
        return t

    @property
    def device(self):
        return torch.device("cuda", self.card)


def test_timer_waits_on_every_card_a_result_holds(monkeypatch):
    # JAX's Timer blocks on any pytree (jax.block_until_ready); the port's
    # walks a SolveResult, tuples (NamedTuples too), lists and dicts and
    # synchronizes each card found once before the clock stops.
    from typing import NamedTuple

    from ikpso_tpu_torch.pso.solver import SolveResult
    from ikpso_tpu_torch.utils.profiling import Timer, cuda_devices

    class Pair(NamedTuple):
        a: torch.Tensor
        b: torch.Tensor

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    c0, c1, cpu = _OnCard(0), _OnCard(1), torch.zeros(2)
    result = SolveResult(angles=c0, fitness=c0, pose=c1, effector_error=cpu, trace=c0)
    for value in (result, (c0, [c1, c0], Pair(cpu, c1)), {"x": c0, "y": {"z": c1}}):
        calls.clear()
        with Timer() as t:
            assert t.sync_on(value) is value
        assert sorted(map(str, calls)) == ["cuda:0", "cuda:1"]
        assert t.elapsed_s > 0
    calls.clear()
    with Timer(sync={"only": c1}):
        pass
    assert calls == [torch.device("cuda", 1)]
    calls.clear()
    with Timer(sync=(cpu, None, "text", 3)):
        pass
    assert calls == [] and cuda_devices(None) == set()


def test_profiling_timer_and_trace_on_the_cpu(tmp_path):
    import json

    from ikpso_tpu_torch.utils.profiling import Timer, trace

    with trace(str(tmp_path / "prof")):
        with Timer() as t:
            x = t.sync_on(torch.ones(64, 64) @ torch.ones(64, 64))
    assert t.elapsed_s > 0 and float(x[0, 0]) == 64.0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with trace(None):  # a no-op
        pass
    assert not (tmp_path / "None").exists()
