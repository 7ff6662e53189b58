"""The 6-DOF position + orientation slice of the port against the JAX package.

(a) Kernel A's plain version (``fused_solve_plain``) against the
    interpreted JAX megakernel with the same injected uniforms, S=8 (one
    JAX tile), P=128, 4 iterations in blocks of 2, for the branches this
    slice ports: the re-kick with and without its threshold, randomized
    inertia with and without the re-kick, ``gbest_interval`` 2, and
    ``arm_6dof`` with orientation, re-kick and uniform init. Bar: the
    replay tolerances of tests/test_fused.py:257-258 (angles atol 5e-4,
    value rtol 1e-3).
(b) Kernels B and C's plain versions with the orientation term on
    ``arm_6dof`` against the interpreted Pallas kernel (rtol 1e-6: the
    same polynomial trig, the same association) and against JAX's jnp
    fitness (rtol 1e-4: polynomial against library trig); the packing
    against ``_pack_meta`` / ``_pack_swarm``.
(c) The LM polish with orientation rows against JAX at S=64 (atol 1e-4,
    the position-only polish test's bar); the quaternion round trip of the
    target rotations against JAX on 1,000 rotations (as matrices, atol
    1e-6); the harness's targets against bench.py's on the same poses.
(d) The slice as a composition at S=8: A's plain replay, the polish with
    orientation, the row error, against the same JAX composition (atol
    1e-4).
(e) The whole orientation path (``harness/orientation.py``) on the CPU at
    S=512, where the bucket rule gives S/8 = 64. Observed on an 8-core CPU
    (seed 0): p50 0.00012 mm, p90 0.0036 mm, 100% under 1 mm, 0 failures,
    p90 orientation error 0.028 deg (JAX's TPU record on its own S=262,144
    batch: 100.00%, 0.028 deg), ~18 s a solve (Philox on the CPU takes two
    thirds of it). Bar: p50 < 1 mm, >= 0.98 under 1 mm, p90 orientation
    error < 0.1 deg.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ikpso_tpu.models import library as jlib
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.ops import rotations as jrot
from ikpso_tpu.ops.fitness import FitnessConfig as JFit
from ikpso_tpu.ops.fitness import fitness as j_fitness
from ikpso_tpu.ops.pallas_fitness import _pack_meta, _pack_swarm, fused_fitness
from ikpso_tpu.pso.config import PSOConfig as JPSO
from ikpso_tpu.pso.fused import fused_solve_raw
from ikpso_tpu.pso.polish import polish_angles as j_polish
from ikpso_tpu.pso.polish_soa import anchor_positions_flat as j_anchor_flat
from ikpso_tpu.pso.polish_soa import true_effector_error_rows as j_err_rows
from ikpso_tpu_torch.harness.headline import reachable_pose
from ikpso_tpu_torch.harness.orientation import (
    orientation_error_deg,
    orientation_targets,
    run_orientation,
)
from ikpso_tpu_torch.models import convert, library
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops import rotations
from ikpso_tpu_torch.ops.fitness_kernel import (
    MetaLayout,
    fk_fitness,
    fk_fitness_plain,
    fused_fitness_plain,
    pack_meta,
    pack_swarm,
)
from ikpso_tpu_torch.pso.fused import fused_solve_plain, num_draws
from ikpso_tpu_torch.pso.polish import polish_angles
from ikpso_tpu_torch.pso.polish_soa import anchor_positions_flat, true_effector_error_rows

from test_torch_fused import (  # noqa: F401 (torch_single_thread: a fixture)
    ATOL_ANGLES, ATOL_VALUE, RTOL_VALUE, SW, torch_single_thread, tpu_layout)

CANONICAL = dict(inertia_mode="canonical", inertia=0.5, inertia_end=0.2)
# The six replay configurations: (model, orientation, PSOConfig fields).
REPLAY_CASES = {
    "rekick": ("arm_7dof", False, dict(CANONICAL, rekick_interval=2, rekick_scale=0.5)),
    "rekick_threshold": ("arm_7dof", False, dict(CANONICAL, rekick_interval=2,
                                                 rekick_scale=0.5, rekick_threshold=1e-6)),
    "randomized": ("arm_7dof", False, dict(inertia_mode="randomized")),
    "randomized_rekick": ("arm_7dof", False, dict(inertia_mode="randomized",
                                                  rekick_interval=2, rekick_scale=0.5)),
    "gbest_interval": ("arm_7dof", False, dict(CANONICAL, gbest_interval=2)),
    "arm_6dof_orientation": ("arm_6dof", True, dict(
        CANONICAL, init_mode="uniform", rekick_interval=2, rekick_scale=0.5,
        rekick_threshold=1e-6)),
}


def _jax_case(name, s, rng, orientation):
    """A batched JAX problem with reachable targets and, with
    ``orientation``, the generating poses' effector rotations as targets
    (bench.py:94-121)."""
    spec_j, problem_j = getattr(jlib, name)()
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    ang = (lo + rng.random((s, spec_j.dof)) * (hi - lo)).astype(np.float32)
    pose = jfk.angles_to_pose(spec_j, jnp.broadcast_to(problem_j.pose[0], (s, 3)),
                              jnp.asarray(ang))
    eff = list(spec_j.effector_idx)
    targets = jfk.fk_points(spec_j, pose, problem_j.origin)[:, eff, :]
    target_rot = None
    if orientation:
        world = jfk.fk(spec_j, pose, problem_j.origin)[1][:, eff]
        target_rot = jrot.quaternion_to_euler_xyz(jrot.matrix_to_quaternion(world))
    return spec_j, jlib.batched_problem(problem_j, targets, target_rot=target_rot)


def _jax_packs(spec_j, batched_j, fit_j, orientation):
    anchor = jfk.pose_to_angles(spec_j, batched_j.pose)
    return (_pack_meta(spec_j, fit_j, None, orientation),
            _pack_swarm(spec_j, batched_j, anchor, j_anchor_flat(spec_j, batched_j),
                        orientation))


def _limits_j(spec_j):
    return jnp.stack([spec_j.min_rotation[1:].reshape(-1),
                      spec_j.max_rotation[1:].reshape(-1)])


def _replay_both(case, rng, s=SW, p=128, iterations=4):
    """The JAX megakernel (interpreted) and the port's plain solve on the
    same injected uniforms; returns both results and the kicks the plain
    solve made."""
    name, orientation, fields = REPLAY_CASES[case]
    spec_j, batched_j = _jax_case(name, s, rng, orientation)
    pso_j = JPSO(iterations=iterations, **fields)
    fit_j = JFit(angle_weight=0.0, distance_weight=0.0,
                 orientation_weight=1.0 if orientation else 0.0)
    meta_j, swarm_j = _jax_packs(spec_j, batched_j, fit_j, orientation)
    pso = convert.pso_config_from(pso_j)
    u = rng.random((s, num_draws(pso), spec_j.dof, p), dtype=np.float32)
    want = fused_solve_raw(
        spec_j, pso_j, fit_j, meta_j, swarm_j, _limits_j(spec_j),
        jnp.zeros((s, 2), jnp.int32), p, 0, interpret=pltpu.InterpretParams(),
        uniforms=jnp.asarray(tpu_layout(u)), use_orientation=orientation,
        swarms_per_tile=SW)
    spec = convert.chain_spec_from(spec_j)
    kicks = []
    got = fused_solve_plain(
        spec, pso, convert.fitness_config_from(fit_j), torch.tensor(np.asarray(meta_j)),
        torch.tensor(np.asarray(swarm_j)), spec.limits(),
        torch.zeros((s, 2), dtype=torch.int32), p, uniforms=torch.as_tensor(u),
        use_orientation=orientation, on_kick=lambda k: kicks.append(k.clone()))
    return spec_j, batched_j, pso, want, got, kicks


@pytest.mark.parametrize("case", sorted(REPLAY_CASES))
def test_replay_branches_match_jax_interpreted_kernel(case):
    rng = np.random.default_rng(60)
    _, _, pso, (gb_j, gv_j), (gb, gv), kicks = _replay_both(case, rng)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), atol=ATOL_ANGLES)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_j), rtol=RTOL_VALUE,
                               atol=ATOL_VALUE)
    # One kick block (iteration 2); a threshold of 1e-6 keeps none of
    # these 4-iteration swarms from being kicked.
    assert len(kicks) == (1 if pso.rekick_interval else 0)
    assert all(bool(k.all()) for k in kicks)


def test_draw_slots_follow_the_jax_replay_numbering():
    # dpi = (3 if randomized else 2) + (1 if re-kick): the kick of the block
    # starting at iteration 2 reads slot n_init + 2 dpi + dpi - 1, and the
    # canonical no-kick layout keeps 2 slots per iteration.
    pso = convert.pso_config_from(JPSO(iterations=4, inertia_mode="randomized",
                                       rekick_interval=2, init_mode="uniform"))
    assert num_draws(pso) == 2 + 4 * 4
    assert num_draws(dataclasses.replace(pso, inertia_mode="canonical",
                                         rekick_interval=0)) == 2 + 2 * 4
    # Changing only the kick slot of block 1 changes the result; changing
    # the kick slot of block 0 (never read: no kick at iteration 0) does not.
    rng = np.random.default_rng(61)
    spec, problem = library.arm_7dof()
    batched = library.batched_problem(
        problem, torch.as_tensor(rng.normal(0, 1, (2, 1, 3)), dtype=torch.float32))
    fit = convert.fitness_config_from(JFit(angle_weight=0.0))
    meta = pack_meta(spec, fit)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched))
    u = torch.as_tensor(rng.random((2, num_draws(pso), spec.dof, 32), dtype=np.float32))

    def solve(uu):
        return fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(),
                                 torch.zeros((2, 2), dtype=torch.int32), 32, uniforms=uu)

    base = solve(u)
    u0 = u.clone()
    u0[:, 2 + 3] = 0.5  # block 0's kick slot
    assert torch.equal(solve(u0)[0], base[0])
    u1 = u.clone()
    u1[:, 2 + 2 * 4 + 3] = 0.5  # block 1's kick slot
    assert not torch.equal(solve(u1)[0], base[0])


def test_kick_threshold_gates_per_swarm_on_the_block_start_min():
    # A threshold between the swarms' block-start minima kicks exactly the
    # swarms above it, and a tie at the threshold is not above it.
    rng = np.random.default_rng(62)
    spec_j, batched_j = _jax_case("arm_7dof", 8, rng, False)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    fit = convert.fitness_config_from(JFit(angle_weight=0.0))
    meta = pack_meta(spec, fit)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched))
    # Blocks of one iteration: iteration 1 kicks on the lvals after
    # iteration 0, i.e. the better of each particle's first two positions.
    pso = convert.pso_config_from(JPSO(iterations=2, rekick_interval=1,
                                       rekick_threshold=1e9, **CANONICAL))
    u = torch.as_tensor(rng.random((8, num_draws(pso), spec.dof, 32), dtype=np.float32))
    seen, evals = [], []

    def run(threshold):
        return fused_solve_plain(
            spec, dataclasses.replace(pso, rekick_threshold=threshold), fit, meta, swarm,
            spec.limits(), torch.zeros((8, 2), dtype=torch.int32), 32, uniforms=u,
            observe=lambda x: evals.append(fk_fitness_plain(spec, x, meta, swarm)),
            on_kick=seen.append)

    run(1e9)
    assert not seen[0].any()
    best = torch.minimum(evals[0], evals[1]).min(dim=1).values
    thr = float(best.sort().values[3])  # the 4th-best swarm sits exactly at it
    seen.clear()
    kicked = run(thr)
    assert torch.equal(seen[0], best > thr) and int(seen[0].sum()) == 4
    assert not torch.equal(kicked[0], run(1e9)[0])


def test_pack_with_orientation_matches_jax():
    rng = np.random.default_rng(63)
    spec_j, batched_j = _jax_case("arm_6dof", 8, rng, True)
    fit_j = JFit(angle_weight=0.0, orientation_weight=0.7)
    meta_j, swarm_j = _jax_packs(spec_j, batched_j, fit_j, True)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    meta = pack_meta(spec, convert.fitness_config_from(fit_j), use_orientation=True)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched), use_orientation=True)
    lay = MetaLayout(spec, 0, True)
    assert (meta.shape[1], swarm.shape[1]) == (lay.meta_size, lay.swarm_size) == (
        meta_j.shape[1], swarm_j.shape[1])
    np.testing.assert_array_equal(meta.numpy(), np.asarray(meta_j))
    assert meta[0, lay.OFF_OW] == np.float32(0.7)
    np.testing.assert_array_equal(swarm[:, :lay.OFF_APOS].numpy(),
                                  np.asarray(swarm_j)[:, :lay.OFF_APOS])
    # The target rotations are the same stock-trig closed form on both
    # sides; the anchor positions come from two FKs (last-bit rounding).
    np.testing.assert_allclose(swarm.numpy(), np.asarray(swarm_j), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="target_rot"):
        pack_swarm(spec, batched.replace(target_rot=None),
                   fk_ops.pose_to_angles(spec, batched.pose),
                   anchor_positions_flat(spec, batched), use_orientation=True)


@pytest.mark.parametrize("aw", [0.0, 2.0])
def test_orientation_tile_matches_interpreted_pallas_kernel(aw):
    # Kernels B and C's plain versions on arm_6dof, (S, P) = (2, 1024).
    rng = np.random.default_rng(64)
    s, p = 2, 1024
    spec_j, batched_j = _jax_case("arm_6dof", s, rng, True)
    # Start the anchors away from the targets so the locality term counts.
    batched_j = batched_j.replace(pose=batched_j.pose.at[:, 1:].set(0.3))
    fit_j = JFit(angle_weight=aw, distance_weight=0.0, orientation_weight=0.8)
    meta_j, swarm_j = _jax_packs(spec_j, batched_j, fit_j, True)
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    x = (lo + rng.random((s, p, spec_j.dof)) * (hi - lo)).astype(np.float32)
    x_dp = np.ascontiguousarray(np.swapaxes(x, -1, -2))
    want = np.asarray(fused_fitness(spec_j, jnp.asarray(x_dp), meta_j, swarm_j,
                                    use_orientation=True,
                                    interpret=pltpu.InterpretParams()))
    spec = convert.chain_spec_from(spec_j)
    meta, swarm = torch.tensor(np.asarray(meta_j)), torch.tensor(np.asarray(swarm_j))
    before = fk_fitness.launches
    got_b = fk_fitness(spec, torch.as_tensor(x), meta, swarm, use_orientation=True)
    assert fk_fitness.launches == before  # a CPU tensor runs the plain twin
    got_c = fused_fitness_plain(spec, torch.as_tensor(x_dp), meta, swarm,
                                use_orientation=True)
    np.testing.assert_allclose(got_b.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got_c.numpy(), got_b.numpy())
    # Against the jnp fitness (library trig): the polynomial's error.
    oracle = np.asarray(j_fitness(spec_j, jnp.asarray(x), batched_j, config=fit_j))
    np.testing.assert_allclose(got_b.numpy(), oracle, rtol=1e-4, atol=1e-5)
    # The term is really in: without it the values drop.
    plain = fk_fitness_plain(spec, torch.as_tensor(x), meta[:, :-1],
                             swarm[:, :MetaLayout(spec).swarm_size])
    assert bool((plain < got_b).all())


def test_polish_with_orientation_matches_jax():
    rng = np.random.default_rng(65)
    s = 64
    spec_j, batched_j = _jax_case("arm_6dof", s, rng, True)
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    # Targets from random in-limit poses; starts perturb those poses.
    ang = (lo + rng.random((s, spec_j.dof)) * (hi - lo)).astype(np.float32)
    pose = jfk.angles_to_pose(spec_j, jnp.broadcast_to(batched_j.pose[0, 0], (s, 3)),
                              jnp.asarray(ang))
    eff = list(spec_j.effector_idx)
    batched_j = batched_j.replace(
        targets=jfk.fk_points(spec_j, pose, batched_j.origin)[:, eff],
        target_rot=jrot.quaternion_to_euler_xyz(jrot.matrix_to_quaternion(
            jfk.fk(spec_j, pose, batched_j.origin)[1][:, eff])))
    start = np.clip(ang + rng.normal(0, 0.1, ang.shape), lo, hi).astype(np.float32)
    want = j_polish(spec_j, batched_j, jnp.asarray(start), steps=4, use_orientation=True)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    got = polish_angles(spec, batched, torch.as_tensor(start), steps=4,
                        use_orientation=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # The orientation rows pull the rotation in: the geodesic error falls.
    before = orientation_error_deg(
        spec, fk_ops.angles_to_pose(spec, batched.pose[:, 0], torch.as_tensor(start)),
        batched)
    after = orientation_error_deg(
        spec, fk_ops.angles_to_pose(spec, batched.pose[:, 0], got), batched)
    assert float(after.mean()) < 0.5 * float(before.mean())


def test_rotation_round_trip_matches_jax():
    rng = np.random.default_rng(66)
    ang = rng.uniform(-np.pi, np.pi, (1000, 3)).astype(np.float32)
    mats_j = jrot.euler_xyz_to_matrix(jnp.asarray(ang))
    want = jrot.euler_xyz_to_matrix(
        jrot.quaternion_to_euler_xyz(jrot.matrix_to_quaternion(mats_j)))
    mats = torch.tensor(np.asarray(mats_j))
    quat = rotations.matrix_to_quaternion(mats)
    np.testing.assert_allclose(quat.numpy(), np.asarray(jrot.matrix_to_quaternion(mats_j)),
                               atol=1e-6)
    got = rotations.euler_xyz_to_matrix(rotations.quaternion_to_euler_xyz(quat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # And the round trip gives back the rotation (quaternion sign aside).
    np.testing.assert_allclose(got.numpy(), mats.numpy(), atol=1e-4)


def test_orientation_targets_match_bench():
    # bench.py:94-121 on the same poses: targets from fk_points, rotations
    # through quaternion_to_euler_xyz(matrix_to_quaternion(world rot)).
    spec_j, problem_j = jlib.arm_6dof()
    spec, problem = library.arm_6dof()
    pose = reachable_pose(spec, problem, 256, torch.Generator().manual_seed(67))
    pose_j = jnp.asarray(pose.numpy())
    eff = list(spec_j.effector_idx)
    want_t = jfk.fk_points(spec_j, pose_j, problem_j.origin)[:, eff, :]
    world = jfk.fk(spec_j, pose_j, problem_j.origin)[1][:, eff]
    want_r = jrot.quaternion_to_euler_xyz(jrot.matrix_to_quaternion(world))
    targets, target_rot = orientation_targets(spec, problem, pose)
    np.testing.assert_allclose(targets.numpy(), np.asarray(want_t), atol=1e-6)
    np.testing.assert_allclose(rotations.euler_xyz_to_matrix(target_rot).numpy(),
                               np.asarray(jrot.euler_xyz_to_matrix(want_r)), atol=1e-5)
    np.testing.assert_array_equal(library.arm_6dof()[1].target_rot.numpy(),
                                  np.asarray(problem_j.target_rot))


def test_orientation_slice_matches_jax_composition():
    rng = np.random.default_rng(68)
    case = "arm_6dof_orientation"
    spec_j, batched_j, _, (gb_j, _), (gb, _), _ = _replay_both(case, rng)
    x_j = j_polish(spec_j, batched_j, gb_j, steps=4, use_orientation=True)
    err_j = np.asarray(j_err_rows(spec_j, batched_j, x_j))
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    x = polish_angles(spec, batched, gb, steps=4, use_orientation=True)
    err = true_effector_error_rows(spec, batched, x)
    np.testing.assert_allclose(err.numpy(), err_j, atol=1e-4)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), atol=1e-4)


@pytest.mark.usefixtures("torch_single_thread")
def test_orientation_path_on_cpu_reaches_accuracy_class():
    out = run_orientation(swarms=512, device="cpu", seed=0, warmup=0, iters=1)
    assert out["finite"] and out["device"] == "cpu" and out["orientation"]
    assert (out["retries"], out["retry_iterations"], out["retry_bucket"]) == (20, 80, 64)
    assert out["p50_err_mm"] < 1.0
    assert out["frac_under_1mm"] >= 0.98
    assert out["failures_ge_1mm"] == round((1 - out["frac_under_1mm"]) * 512)
    assert out["p90_orient_err_deg"] < 0.1


def test_orientation_path_refuses_absent_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        run_orientation(swarms=8, device="cuda")
