"""Fitness of the port (ikpso_tpu_torch.ops.fitness, .ops.fitness_kernel)
against the JAX package.

``fitness`` / ``true_effector_error`` use stock trig on both sides: atol
1e-5 absolute on costs of order 1-10 (float32 rounding of FK plus a sum).
``fk_fitness_plain`` is held against the Pallas kernel run in interpret
mode (the tests/test_fused.py:22-26 pattern); both evaluate the same
polynomial trig with the same association, so they agree to rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ikpso_tpu.models import library as jlib
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.ops.fitness import FitnessConfig as JFit
from ikpso_tpu.ops.fitness import fitness as j_fitness
from ikpso_tpu.ops.fitness import true_effector_error as j_true_err
from ikpso_tpu.models.chain import Obstacles as JObstacles
from ikpso_tpu.ops.pallas_fitness import (
    _pack_meta,
    _pack_swarm,
    fused_fitness,
    make_pallas_fitness,
)
from ikpso_tpu_torch.models import convert
from ikpso_tpu_torch.ops import collision
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import COLLISION_PENALTY, FitnessConfig, fitness
from ikpso_tpu_torch.ops.fitness import true_effector_error
from ikpso_tpu_torch.ops.fitness_kernel import (
    fk_fitness,
    fk_fitness_plain,
    pack_meta,
    pack_swarm,
    sincos_poly,
)

MODELS = ["arm_7dof", "reference_arm"]
SHAPES = ["box", "capsule"]
# JAX's own bar for the Pallas tile against the jnp fitness with a scene
# (tests/test_pallas.py:116-138): identical masks, values to 2e-4.
SCENE_TOL = 2e-4
# tests/test_pallas.py:52-72: one axis-aligned and one z-rotated box.
PALLAS_SCENE = dict(
    centers=[(1.5, 0.5, 0.0), (-1.0, -1.0, 0.0)],
    full_dims=[(1.0, 1.0, 1.0), (0.8, 0.8, 0.8)],
    quats=[(0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.383, 0.924)],
)


def _batched_case(name, s, rng):
    spec_j, problem_j = getattr(jlib, name)()
    lo = np.asarray(spec_j.min_rotation)
    hi = np.asarray(spec_j.max_rotation)
    pose = (lo + rng.random((s,) + lo.shape) * (hi - lo) * 0.3).astype(np.float32)
    pose[:, 0] = 0.0
    targets = np.asarray(problem_j.targets)[None] + rng.normal(
        0, 0.4, (s,) + problem_j.targets.shape)
    batched_j = jlib.batched_problem(problem_j, jnp.asarray(targets, jnp.float32))
    batched_j = batched_j.replace(pose=jnp.asarray(pose))
    return spec_j, batched_j


def _angles(spec_j, shape, rng):
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    return (lo + rng.random(shape + (spec_j.dof,)) * (hi - lo)).astype(np.float32)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("aw", [3.0, 0.0])
def test_fitness_matches_jax(name, aw):
    rng = np.random.default_rng(10)
    spec_j, batched_j = _batched_case(name, 4, rng)
    x = _angles(spec_j, (4, 16), rng)
    fit_j = JFit(angle_weight=aw, distance_weight=0.5)
    want = j_fitness(spec_j, jnp.asarray(x), batched_j, config=fit_j)
    got = fitness(convert.chain_spec_from(spec_j), torch.as_tensor(x),
                  convert.problem_from(batched_j), convert.fitness_config_from(fit_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("name", MODELS)
def test_true_effector_error_matches_jax(name):
    rng = np.random.default_rng(11)
    spec_j, batched_j = _batched_case(name, 8, rng)
    x = _angles(spec_j, (8,), rng)
    pose_j = jfk.angles_to_pose(spec_j, batched_j.pose[:, 0], jnp.asarray(x))
    want = j_true_err(spec_j, pose_j, batched_j)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    pose = fk_ops.angles_to_pose(spec, batched.pose[:, 0], torch.as_tensor(x))
    got = true_effector_error(spec, pose, batched)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("aw", [3.0, 0.0])
def test_fk_fitness_plain_matches_interpreted_pallas_kernel(name, aw):
    # S=2, P=1024 (the Pallas kernel's 8x128 tile), angle-locality on/off.
    rng = np.random.default_rng(12)
    s, p = 2, 1024
    spec_j, batched_j = _batched_case(name, s, rng)
    fit_j = JFit(angle_weight=aw, distance_weight=0.0)
    meta_j = _pack_meta(spec_j, fit_j, None)
    anchor = jfk.pose_to_angles(spec_j, batched_j.pose)
    swarm_j = _pack_swarm(spec_j, batched_j, anchor,
                          jfk.fk_points(spec_j, batched_j.pose, batched_j.origin))
    x = _angles(spec_j, (s, p), rng)
    want = fused_fitness(spec_j, jnp.swapaxes(jnp.asarray(x), -1, -2), meta_j, swarm_j,
                         interpret=pltpu.InterpretParams())
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    meta = pack_meta(spec, convert.fitness_config_from(fit_j))
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       fk_ops.fk_points(spec, batched.pose, batched.origin))
    np.testing.assert_array_equal(meta.numpy(), np.asarray(meta_j))
    got = fk_fitness_plain(spec, torch.as_tensor(x), meta, swarm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # And the plain tile agrees with the stock-trig oracle to the poly
    # trig's error (~1e-6 per angle, scaled by reach).
    oracle = j_fitness(spec_j, jnp.asarray(x), batched_j, config=fit_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-4, atol=1e-4)


def test_fk_fitness_cpu_wrapper_runs_plain_and_counts_nothing():
    rng = np.random.default_rng(13)
    spec_j, batched_j = _batched_case("arm_7dof", 3, rng)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    meta = pack_meta(spec, FitnessConfig(angle_weight=3.0))
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       fk_ops.fk_points(spec, batched.pose, batched.origin))
    x = torch.as_tensor(_angles(spec_j, (3, 64), rng))
    before = fk_fitness.launches
    assert torch.equal(fk_fitness(spec, x, meta, swarm),
                       fk_fitness_plain(spec, x, meta, swarm))
    assert fk_fitness.launches == before


@pytest.mark.parametrize("kw", [
    # Once refused, now computed: the distance term alone, beside the
    # orientation term and beside a scene, and exact trig.
    dict(use_distance_term=True), dict(use_orientation=True, use_distance_term=True),
    dict(num_obstacles=1, use_distance_term=True), dict(trig_impl="exact"),
])
def test_unported_tile_branches_raise(kw):
    # The name is kept from when these branches raised; each now runs the
    # plain twin on the CPU and agrees with JAX's jnp fitness (stock trig,
    # the accuracy oracle) at the poly tile's bar of
    # test_fk_fitness_plain_matches_interpreted_pallas_kernel.
    rng = np.random.default_rng(14)
    spec_j, batched_j = _batched_case("arm_7dof", 2, rng)
    orient = kw.get("use_orientation", False)
    if orient:
        batched_j = batched_j.replace(target_rot=jnp.asarray(
            rng.normal(0, 0.5, (2, 1, 3)), jnp.float32))
    n_obs = kw.get("num_obstacles", 0)
    obs_j = (JObstacles.from_boxes(PALLAS_SCENE["centers"][:1], PALLAS_SCENE["full_dims"][:1])
             if n_obs else None)
    fit_j = JFit(angle_weight=3.0, distance_weight=0.7 if kw.get("use_distance_term") else 0.0,
                 orientation_weight=0.5 if orient else 0.0,
                 trig_impl=kw.get("trig_impl", "poly"))
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    obs = None if obs_j is None else convert.obstacles_from(obs_j)
    meta = pack_meta(spec, convert.fitness_config_from(fit_j), obs, orient)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       fk_ops.fk_points(spec, batched.pose, batched.origin), orient)
    x = torch.as_tensor(_angles(spec_j, (2, 64), rng))
    before = fk_fitness.launches
    got = fk_fitness(spec, x, meta, swarm, **kw)
    assert fk_fitness.launches == before
    assert torch.equal(got, fk_fitness_plain(spec, x, meta, swarm, **kw))
    oracle = np.asarray(j_fitness(spec_j, jnp.asarray(x.numpy()), batched_j, config=fit_j,
                                  obstacles=obs_j))
    hit = oracle >= COLLISION_PENALTY
    np.testing.assert_array_equal(got.numpy() >= COLLISION_PENALTY, hit)
    np.testing.assert_allclose(got.numpy()[~hit], oracle[~hit], rtol=1e-4, atol=1e-4)


def test_fitness_refuses_obstacles():
    # Scenes run with every collider, the GJK backend included: the plain
    # fitness with collision_backend="gjk" returns JAX's values on the
    # tests/test_pallas.py scene (tests/test_torch_gjk.py holds it on a
    # denser scene and counts tangencies).
    rng = np.random.default_rng(41)
    spec_j, batched_j = _batched_case("arm_7dof", 2, rng)
    spec = convert.chain_spec_from(spec_j)
    obs_j = JObstacles.from_boxes(**PALLAS_SCENE)
    fit_j = JFit(angle_weight=0.5, collision_backend="gjk")
    x = _angles(spec_j, (2, 64), rng)
    want = np.asarray(j_fitness(spec_j, jnp.asarray(x), batched_j, config=fit_j,
                                obstacles=obs_j))
    got = fitness(spec, torch.as_tensor(x), convert.problem_from(batched_j),
                  convert.fitness_config_from(fit_j),
                  obstacles=convert.obstacles_from(obs_j)).numpy()
    hit = want >= COLLISION_PENALTY
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(got >= COLLISION_PENALTY, hit)
    np.testing.assert_allclose(got[~hit], want[~hit], rtol=1e-5)


def _scene_case(name, rng, p):
    """A problem, random in-limit angles (S=1, p particles) and the
    tests/test_pallas.py scene, for both packages."""
    spec_j, batched_j = _batched_case(name, 1, rng)
    obs_j = JObstacles.from_boxes(**PALLAS_SCENE)
    return spec_j, batched_j, obs_j, _angles(spec_j, (1, p), rng)


def _assert_scene_match(got, want, rtol, atol):
    hit_want = want >= float(COLLISION_PENALTY)
    np.testing.assert_array_equal(got >= float(COLLISION_PENALTY), hit_want)
    assert hit_want.any() and (~hit_want).any(), "the scene must both hit and miss"
    np.testing.assert_allclose(got[~hit_want], want[~hit_want], rtol=rtol, atol=atol)
    assert np.all(got[hit_want] == COLLISION_PENALTY)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["planar_3dof", "arm_7dof"])
def test_fitness_with_obstacles_matches_jax(name, shape):
    rng = np.random.default_rng(14)
    spec_j, batched_j, obs_j, x = _scene_case(name, rng, 256)
    fit_j = JFit(angle_weight=1.0, collision_shape=shape)
    want = j_fitness(spec_j, jnp.asarray(x), batched_j, config=fit_j, obstacles=obs_j)
    got = fitness(convert.chain_spec_from(spec_j), torch.as_tensor(x),
                  convert.problem_from(batched_j), convert.fitness_config_from(fit_j),
                  obstacles=convert.obstacles_from(obs_j))
    _assert_scene_match(got.numpy(), np.asarray(want), SCENE_TOL, SCENE_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_fk_fitness_plain_obstacles_matches_interpreted_pallas_kernel(shape):
    # The plain tile's collider branch against the Pallas tile in
    # interpret mode (make_pallas_fitness, S=1, P=1024), on planar_3dof
    # (links in the z = 0 plane, the sign(0) case of the capsule).
    rng = np.random.default_rng(15)
    spec_j, batched_j, obs_j, x = _scene_case("planar_3dof", rng, 1024)
    fit_j = JFit(angle_weight=1.0, collision_shape=shape)
    want = np.asarray(make_pallas_fitness(spec_j, batched_j, fit=fit_j, obstacles=obs_j,
                                          interpret=True)(jnp.asarray(x)))
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    fit = convert.fitness_config_from(fit_j)
    obs = convert.obstacles_from(obs_j)
    meta = pack_meta(spec, fit, obs)
    np.testing.assert_array_equal(meta.numpy(), np.asarray(_pack_meta(spec_j, fit_j, obs_j)))
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       fk_ops.fk_points(spec, batched.pose, batched.origin))
    got = fk_fitness(spec, torch.as_tensor(x), meta, swarm, num_obstacles=obs.count,
                     collision_shape=shape, gizmo_size=fit.gizmo_size)
    _assert_scene_match(got.numpy(), want, SCENE_TOL, SCENE_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_fk_fitness_plain_mask_equals_chain_collider(shape):
    # The tile's inlined collider and the tensor collider of
    # ops/collision.py flag the same poses (rotated boxes, arm_7dof).
    rng = np.random.default_rng(16)
    q = rng.normal(size=(4, 4))
    obs = convert.obstacles_from(JObstacles.from_boxes(
        rng.uniform(-1.5, 1.5, (4, 3)), rng.uniform(0.4, 1.0, (4, 3)),
        q / np.linalg.norm(q, axis=-1, keepdims=True)))
    spec_j, batched_j = _batched_case("arm_7dof", 2, rng)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    fit = FitnessConfig(angle_weight=0.0, collision_shape=shape)
    x = torch.as_tensor(_angles(spec_j, (2, 512), rng))
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       fk_ops.fk_points(spec, batched.pose, batched.origin))
    got = fk_fitness_plain(spec, x, pack_meta(spec, fit, obs), swarm,
                           num_obstacles=obs.count, collision_shape=shape)
    pose = fk_ops.angles_to_pose(spec, batched.pose[:, None, 0].expand(2, 512, 3), x)
    pos, rot = fk_ops.fk(spec, pose, batched.origin[:, None])
    want = collision.get_chain_collider("sat", shape)(
        pos[..., 1:, :], rot[..., 1:, :, :], pos[..., list(spec.parent[1:]), :],
        spec.length[1:], obs.center, obs.half_extent, obs.rot)
    hit = got == COLLISION_PENALTY
    assert 0.02 < float(want.float().mean()) < 0.98
    # The tile's polynomial trig moves a pose by ~1e-6: allow a pose
    # sitting within that of a box face to flip, and no more.
    assert int((hit != want).sum()) <= 2


def test_collision_penalty_comparisons_stay_finite():
    # ROADMAP queue C recheck: the penalty is float32 max, never inf, so
    # comparisons against it and the argmin over it give no inf or NaN.
    pen = torch.tensor([COLLISION_PENALTY, COLLISION_PENALTY, 1.0], dtype=torch.float32)
    assert torch.isfinite(pen).all()
    assert not bool(pen[0] < pen[1])  # a colliding f never beats a colliding lval
    assert bool(pen[2] < pen[0])
    assert int(torch.argmin(pen[:2])) == 0  # ties at the penalty: lowest index
    rng = np.random.default_rng(17)
    spec_j, batched_j, obs_j, x = _scene_case("planar_3dof", rng, 256)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    obs = convert.obstacles_from(obs_j)
    for shape in SHAPES:
        fit = FitnessConfig(angle_weight=1.0, collision_shape=shape)
        f = fitness(spec, torch.as_tensor(x), batched, fit, obstacles=obs)
        tile = fk_fitness_plain(
            spec, torch.as_tensor(x), pack_meta(spec, fit, obs),
            pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       fk_ops.fk_points(spec, batched.pose, batched.origin)),
            num_obstacles=obs.count, collision_shape=shape)
        for v in (f, tile):
            assert torch.isfinite(v).all() and (v == COLLISION_PENALTY).any()


def test_sincos_poly_error_bound():
    # The repository's bound (ikpso_tpu/ops/pallas_fitness.py:53-62): f32
    # end-to-end max error over [-4pi, 4pi] of 1.2e-6 (sin) / 5.3e-7 (cos)
    # against float64 libm.
    x = np.linspace(-4 * np.pi, 4 * np.pi, 400_001).astype(np.float32)
    s, c = sincos_poly(torch.as_tensor(x))
    x64 = x.astype(np.float64)
    assert np.abs(s.numpy() - np.sin(x64)).max() <= 1.2e-6
    assert np.abs(c.numpy() - np.cos(x64)).max() <= 5.3e-7


def test_sincos_poly_rounds_half_to_even():
    # x = k*pi with k odd puts x/(2pi) at a half: round-half-even picks the
    # even neighbour (jnp.round / rintf), not away-from-zero.
    assert torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5])).tolist() == [0.0, 2.0, 2.0, -0.0]


def test_collision_penalty_is_float32_max():
    assert COLLISION_PENALTY == np.finfo(np.float32).max


def _kernel_c_case(shape, rng, s=2, p=1024):
    """arm_7dof, (S, P) random in-limit angles and, unless ``shape`` is
    "none", the tests/test_pallas.py scene, for both packages."""
    spec_j, batched_j = _batched_case("arm_7dof", s, rng)
    obs_j = None if shape == "none" else JObstacles.from_boxes(**PALLAS_SCENE)
    fit_j = JFit(angle_weight=1.0, collision_shape="box" if shape == "none" else shape)
    return spec_j, batched_j, obs_j, fit_j, _angles(spec_j, (s, p), rng)


def _assert_kernel_c_match(got, want, shape):
    if shape == "none":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        _assert_scene_match(got, want, 1e-5, 1e-6)


@pytest.mark.parametrize("shape", ["none", *SHAPES])
def test_fused_fitness_plain_matches_interpreted_pallas_kernel(shape):
    # Kernel C's plain twin against JAX fused_fitness in interpret mode on
    # the lane-major (S, D, P) = (2, 9, 1024) layout.
    from ikpso_tpu_torch.ops.fitness_kernel import fused_fitness_plain

    rng = np.random.default_rng(18)
    spec_j, batched_j, obs_j, fit_j, x = _kernel_c_case(shape, rng)
    n_obs = 0 if obs_j is None else obs_j.count
    anchor = jfk.pose_to_angles(spec_j, batched_j.pose)
    swarm_j = _pack_swarm(spec_j, batched_j, anchor,
                          jfk.fk_points(spec_j, batched_j.pose, batched_j.origin))
    x_dp = np.ascontiguousarray(np.swapaxes(x, -1, -2))
    want = fused_fitness(spec_j, jnp.asarray(x_dp), _pack_meta(spec_j, fit_j, obs_j), swarm_j,
                         num_obstacles=n_obs, collision_shape=fit_j.collision_shape,
                         interpret=pltpu.InterpretParams())
    spec = convert.chain_spec_from(spec_j)
    obs = None if obs_j is None else convert.obstacles_from(obs_j)
    meta = pack_meta(spec, convert.fitness_config_from(fit_j), obs)
    np.testing.assert_array_equal(meta.numpy(), np.asarray(_pack_meta(spec_j, fit_j, obs_j)))
    # The same packed swarm row on both sides (the two FKs that pack it
    # differ in the last bit): the tile arithmetic alone is compared.
    got = fused_fitness_plain(spec, torch.as_tensor(x_dp), meta,
                              torch.as_tensor(np.asarray(swarm_j)), num_obstacles=n_obs,
                              collision_shape=fit_j.collision_shape)
    _assert_kernel_c_match(got.numpy(), np.asarray(want), shape)


@pytest.mark.parametrize("shape", ["none", *SHAPES])
def test_make_kernel_fitness_matches_make_pallas_fitness(shape):
    # The scan solver's fitness_fn on its (S, P, D) layout, both sides
    # packing their constants once at closure build.
    from ikpso_tpu_torch.ops.fitness_kernel import fused_fitness as kernel_c
    from ikpso_tpu_torch.ops.fitness_kernel import make_kernel_fitness

    rng = np.random.default_rng(19)
    spec_j, batched_j, obs_j, fit_j, x = _kernel_c_case(shape, rng)
    want = make_pallas_fitness(spec_j, batched_j, fit=fit_j, obstacles=obs_j,
                               interpret=True)(jnp.asarray(x))
    spec = convert.chain_spec_from(spec_j)
    fn = make_kernel_fitness(spec, convert.problem_from(batched_j),
                             convert.fitness_config_from(fit_j),
                             None if obs_j is None else convert.obstacles_from(obs_j))
    before = kernel_c.launches
    got = fn(torch.as_tensor(x))
    assert kernel_c.launches == before  # a CPU tensor runs the plain twin
    _assert_kernel_c_match(got.numpy(), np.asarray(want), shape)


def test_make_kernel_fitness_refuses_gjk():
    from ikpso_tpu_torch.ops.fitness_kernel import make_kernel_fitness

    spec_j, problem_j = jlib.arm_7dof()
    spec = convert.chain_spec_from(spec_j)
    obs = convert.obstacles_from(JObstacles.from_boxes(**PALLAS_SCENE))
    problem = convert.problem_from(jlib.batched_problem(problem_j, problem_j.targets[None]))
    with pytest.raises(NotImplementedError, match="gjk"):
        make_kernel_fitness(spec, problem, FitnessConfig(collision_backend="gjk"), obs)
    # Without a scene the backend is never used, as in make_pallas_fitness.
    make_kernel_fitness(spec, problem, FitnessConfig(collision_backend="gjk"))


def test_fused_fitness_checks_its_layout():
    from ikpso_tpu_torch.ops.fitness_kernel import fused_fitness as kernel_c

    spec = convert.chain_spec_from(jlib.arm_7dof()[0])
    meta = torch.zeros(1, 6)
    with pytest.raises(ValueError, match=r"\(S, 9, P\)"):
        kernel_c(spec, torch.zeros(2, 1000, 9), meta, torch.zeros(2, 30))
    # The orientation term needs its weight in meta and the target
    # rotations in each swarm row.
    with pytest.raises(ValueError, match="orientation"):
        kernel_c(spec, torch.zeros(2, 9, 8), meta, torch.zeros(2, 33), use_orientation=True)
    with pytest.raises(ValueError, match="swarm rows must hold 42"):
        kernel_c(spec, torch.zeros(2, 9, 8), torch.zeros(1, 7), torch.zeros(2, 33),
                 use_orientation=True)


def test_fitness_with_serial_scan_fk_matches_jax():
    # FitnessConfig(fk_impl="scan"): the serial-scan FK in the fitness.
    rng = np.random.default_rng(43)
    spec_j, batched_j = _batched_case("arm_7dof", 3, rng)
    x = _angles(spec_j, (3, 32), rng)
    fit_j = JFit(angle_weight=1.0, distance_weight=0.5, fk_impl="scan")
    want = np.asarray(j_fitness(spec_j, jnp.asarray(x), batched_j, config=fit_j))
    got = fitness(convert.chain_spec_from(spec_j), torch.as_tensor(x),
                  convert.problem_from(batched_j), convert.fitness_config_from(fit_j)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="fk_impl"):
        fitness(convert.chain_spec_from(spec_j), torch.as_tensor(x),
                convert.problem_from(batched_j), FitnessConfig(fk_impl="tree"))
