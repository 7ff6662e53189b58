"""The port's GJK (ikpso_tpu_torch.ops.gjk) against the JAX package's.

Mirrors every case of tests/test_gjk.py (box-box against SAT on random
boxes, the analytic cases, sphere-sphere, capsule-box, batching) with the
same inputs through both packages: the hit masks must be equal. Then the
chain colliders of both shapes, the fitness with
``collision_backend="gjk"`` (hit masks equal, or a disagreement only at a
tangency, counted; other values at rtol 1e-5), the early stop against the
forced 50-round loop (bit for bit), and a scan solve on a GJK scene with
JAX's draws injected (the replay bar of tests/test_fused.py:257-258).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikpso_tpu.models import library as jlib
from ikpso_tpu.models.chain import Obstacles as JObstacles
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.ops import gjk as jgjk
from ikpso_tpu.ops.collision import obb_obb_intersect as j_sat
from ikpso_tpu.ops.fitness import FitnessConfig as JFit
from ikpso_tpu.ops.fitness import fitness as j_fitness
from ikpso_tpu.ops.rotations import euler_xyz_to_matrix as j_euler
from ikpso_tpu.pso import solver as jsolver
from ikpso_tpu.pso.config import PSOConfig as JPSO
from ikpso_tpu_torch.models import convert
from ikpso_tpu_torch.ops import collision, gjk
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import COLLISION_PENALTY, fitness
from ikpso_tpu_torch.pso import solver

from test_torch_fused import torch_single_thread  # noqa: F401 (a fixture)
from test_torch_solver import _assert_replay, _jax_draws

EYE = np.eye(3, dtype=np.float32)
FIT_RTOL = 1e-5
TANGENCY = 1e-6


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _random_boxes(rng, n):
    ca = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    cb = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    ha = rng.uniform(0.2, 1.2, size=(n, 3)).astype(np.float32)
    hb = rng.uniform(0.2, 1.2, size=(n, 3)).astype(np.float32)
    ra = np.asarray(j_euler(rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)))
    rb = np.asarray(j_euler(rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)))
    return ca, ha, ra, cb, hb, rb


def test_box_box_matches_jax_and_sat_random(rng, torch_single_thread):
    boxes = _random_boxes(rng, 256)
    got = gjk.gjk_box_box(*map(_t, boxes)).numpy()
    want = np.asarray(jgjk.gjk_box_box(*boxes))
    np.testing.assert_array_equal(got, want)
    # As tests/test_gjk.py: GJK and SAT disagree only near contact.
    sat = np.asarray(j_sat(*boxes))
    idx = np.flatnonzero(sat != got)
    ca, ha, ra, cb, hb, rb = boxes
    grown = np.asarray(j_sat(ca[idx], ha[idx] * 1.02, ra[idx], cb[idx], hb[idx] * 1.02, rb[idx]))
    shrunk = np.asarray(j_sat(ca[idx], ha[idx] * 0.98, ra[idx], cb[idx], hb[idx] * 0.98,
                              rb[idx]))
    assert (grown & ~shrunk).all()
    assert idx.size / 256 < 0.02


@pytest.mark.parametrize("center_b,half_a,half_b,hit", [
    ((1.5, 0.0, 0.0), (1.0, 1.0, 1.0), (1.0, 1.0, 1.0), True),
    ((5.0, 0.0, 0.0), (1.0, 1.0, 1.0), (1.0, 1.0, 1.0), False),
    ((0.3, 0.2, -0.1), (2.0, 2.0, 2.0), (0.1, 0.1, 0.1), True),  # containment
])
def test_box_box_analytic_cases(center_b, half_a, half_b, hit):
    args = (np.zeros(3, np.float32), np.asarray(half_a, np.float32), EYE,
            np.asarray(center_b, np.float32), np.asarray(half_b, np.float32), EYE)
    assert bool(gjk.gjk_box_box(*map(_t, args))) is hit
    assert bool(jgjk.gjk_box_box(*args)) is hit


@pytest.mark.parametrize("center,hit", [((1.5, 0.0, 0.0), True), ((2.5, 0.0, 0.0), False)])
def test_sphere_sphere(center, hit):
    d0 = np.asarray([1.0, 0.0, 0.0], np.float32)
    got = gjk.gjk_intersect(gjk.sphere_support(_t(np.zeros(3)), 1.0),
                            gjk.sphere_support(_t(center), 1.0), _t(d0))
    want = jgjk.gjk_intersect(jgjk.sphere_support(jnp.zeros(3), 1.0),
                              jgjk.sphere_support(jnp.asarray(center), 1.0), jnp.asarray(d0))
    assert bool(got) is bool(want) is hit


@pytest.mark.parametrize("y,hit", [(0.7, True), (0.8, False)])
def test_capsule_box(y, hit):
    # Capsule along X from (0,0,0) to (2,0,0), radius 0.25, against a unit
    # box at (1, y, 0): a hit while |y| < 0.75.
    d0 = np.asarray([0.0, 1.0, 0.0], np.float32)
    got = gjk.gjk_intersect(
        gjk.capsule_support(_t(np.zeros(3)), _t([2.0, 0.0, 0.0]), 0.25),
        gjk.box_support(_t([1.0, y, 0.0]), _t(np.full(3, 0.5)), _t(EYE)), _t(d0))
    want = jgjk.gjk_intersect(
        jgjk.capsule_support(jnp.zeros(3), jnp.asarray([2.0, 0.0, 0.0]), 0.25),
        jgjk.box_support(jnp.asarray([1.0, y, 0.0]), jnp.full(3, 0.5), EYE), jnp.asarray(d0))
    assert bool(got) is bool(want) is hit


def test_gjk_batches_like_jax(rng, torch_single_thread):
    # One unbatched box against 64 centers: the batch broadcasts.
    ca = rng.uniform(-2, 2, size=(64, 3)).astype(np.float32)
    half = np.full(3, 0.5, np.float32)
    got = gjk.gjk_box_box(_t(ca), _t(half), _t(EYE), _t(np.zeros(3)), _t(np.ones(3)), _t(EYE))
    want = np.asarray(jgjk.gjk_box_box(ca, half, EYE, np.zeros(3, np.float32),
                                       np.ones(3, np.float32), EYE))
    assert got.shape == (64,)
    np.testing.assert_array_equal(got.numpy(), want)
    sat = np.asarray(j_sat(ca, half, np.broadcast_to(EYE, (64, 3, 3)), np.zeros(3, np.float32),
                           np.ones(3, np.float32), EYE))
    assert (got.numpy() == sat).mean() > 0.95


def _near_scene(n=4):
    """Four 0.6-unit boxes on a ring at 1.2 around arm_7dof's base, where
    random poses of its 2.5-unit chain hit them often."""
    ang = np.arange(n) * (2 * np.pi / n) + 0.3
    centers = np.stack([1.2 * np.cos(ang), 1.2 * np.sin(ang), 0.3 * (-1) ** np.arange(n)],
                       axis=-1).astype(np.float32)
    quats = np.tile(np.asarray([0.0, 0.0, 0.383, 0.924], np.float32), (n, 1))
    return dict(centers=centers, full_dims=np.full((n, 3), 0.6, np.float32), quats=quats)


def _chain_case(s, p, seed):
    """arm_7dof: (S, P) random in-limit angles, a batched problem with
    reachable targets, and both packages' objects."""
    spec_j, problem_j = jlib.arm_7dof()
    rng = np.random.default_rng(seed)
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    x = (lo + rng.random((s, p, spec_j.dof)) * (hi - lo)).astype(np.float32)
    targets = np.asarray(problem_j.targets)[None] + rng.normal(
        scale=0.3, size=(s,) + tuple(problem_j.targets.shape)).astype(np.float32)
    return spec_j, jlib.batched_problem(problem_j, jnp.asarray(targets)), x


@pytest.mark.parametrize("shape", ["box", "capsule"])
def test_chain_colliders_match_jax(shape, torch_single_thread):
    spec_j, batched_j, x = _chain_case(4, 64, 1)
    spec = convert.chain_spec_from(spec_j)
    obs_j = JObstacles.from_boxes(**_near_scene())
    obs = convert.obstacles_from(obs_j)
    pose_j = jfk.angles_to_pose(spec_j, batched_j.pose[:, None, 0, :], jnp.asarray(x))
    pos_j, rot_j = jfk.fk(spec_j, pose_j, batched_j.origin[:, None])
    par = list(spec_j.parent[1:])
    j_fn = jgjk.chain_collides_gjk if shape == "box" else jgjk.chain_collides_capsule_gjk
    want = np.asarray(j_fn(pos_j[..., 1:, :], rot_j[..., 1:, :, :], pos_j[..., par, :],
                           spec_j.length[1:], obs_j.center, obs_j.half_extent, obs_j.rot))
    pos, rot = torch.as_tensor(np.asarray(pos_j)), torch.as_tensor(np.asarray(rot_j))
    fn = collision.get_chain_collider("gjk", shape)
    got = fn(pos[..., 1:, :], rot[..., 1:, :, :], pos[..., par, :], spec.length[1:],
             obs.center, obs.half_extent, obs.rot).numpy()
    assert 0.1 < want.mean() < 0.9  # the scene is hit, and missed
    np.testing.assert_array_equal(got, want)


def _tangent(spec, x, batched, obs, shape, idx):
    """Whether each pose in ``idx`` is at a tangency: the SAT verdict
    flips between the scene's boxes grown and shrunk by ``TANGENCY``."""
    pose = fk_ops.angles_to_pose(spec, batched.pose[:, None, 0, :], x)
    pos, rot = fk_ops.fk(spec, pose, batched.origin[:, None])
    sat = collision.get_chain_collider("sat", shape)
    par = list(spec.parent[1:])

    def hits(delta):
        return sat(pos[..., 1:, :], rot[..., 1:, :, :], pos[..., par, :], spec.length[1:],
                   obs.center, obs.half_extent + delta, obs.rot).reshape(-1)[idx]

    return hits(TANGENCY) & ~hits(-TANGENCY)


@pytest.mark.parametrize("shape", ["box", "capsule"])
def test_fitness_gjk_matches_jax(shape, torch_single_thread):
    spec_j, batched_j, x = _chain_case(4, 128, 2)
    obs_j = JObstacles.from_boxes(**_near_scene())
    fit_j = JFit(angle_weight=0.5, collision_backend="gjk", collision_shape=shape)
    want = np.asarray(j_fitness(spec_j, jnp.asarray(x), batched_j, config=fit_j,
                                obstacles=obs_j))
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    obs = convert.obstacles_from(obs_j)
    got = fitness(spec, torch.as_tensor(x), batched, convert.fitness_config_from(fit_j),
                  obstacles=obs).numpy()
    hit_g, hit_w = got >= COLLISION_PENALTY, want >= COLLISION_PENALTY
    assert 0.1 < hit_w.mean() < 0.9
    off = np.flatnonzero((hit_g != hit_w).reshape(-1))
    # The two FKs round alike to an ulp or so; a pose whose verdict then
    # differs sits on a box face. Count them: none at this seed.
    assert _tangent(spec, torch.as_tensor(x), batched, obs, shape, off).all()
    assert off.size == 0, f"{off.size} mask disagreements at tangencies"
    free = ~hit_w
    np.testing.assert_allclose(got[free], want[free], rtol=FIT_RTOL)


def test_early_stop_is_bit_identical_to_fifty_rounds(torch_single_thread):
    spec_j, batched_j, x = _chain_case(8, 128, 3)
    spec = convert.chain_spec_from(spec_j)
    obs = convert.obstacles_from(JObstacles.from_boxes(**_near_scene()))
    pose = fk_ops.angles_to_pose(spec, convert.problem_from(batched_j).pose[:, None, 0, :],
                                 torch.as_tensor(x))
    pos, rot = fk_ops.fk(spec, pose, torch.zeros(3))
    par = list(spec.parent[1:])
    args = (pos[..., 1:, :], rot[..., 1:, :, :], pos[..., par, :], spec.length[1:],
            obs.center, obs.half_extent, obs.rot)
    for fn in (gjk.chain_collides_gjk, gjk.chain_collides_capsule_gjk):
        assert torch.equal(fn(*args), fn(*args, early_stop=False))
    # The loop does stop early: count the support calls of one batch.
    calls = []
    box = gjk.box_support(obs.center, obs.half_extent, obs.rot)

    def counted(d):
        calls.append(1)
        return box(d)

    sphere = gjk.sphere_support(pos[..., 1:, None, :], 0.1)
    fast = gjk.gjk_intersect(sphere, counted, obs.center - pos[..., 1:, None, :])
    rounds = len(calls) - 1
    full = gjk.gjk_intersect(sphere, box, obs.center - pos[..., 1:, None, :],
                             early_stop=False)
    assert torch.equal(fast, full)
    assert rounds < gjk.GJK_ITERATIONS


def test_scan_solve_on_a_gjk_scene_matches_jax_replay(torch_single_thread):
    # S=4, P=32, 4 iterations, 2 boxes; JAX's draws injected.
    s, p = 4, 32
    spec_j, batched_j, _ = _chain_case(s, 1, 4)
    scene = {k: v[:2] for k, v in _near_scene().items()}
    obs_j = JObstacles.from_boxes(**scene)
    pso_j = JPSO(iterations=4, inertia_mode="canonical", inertia_end=0.2, init_mode="hybrid")
    fit_j = JFit(angle_weight=0.0, collision_backend="gjk")
    key = jax.random.key(9)
    want = jsolver.solve(spec_j, batched_j, key, pso=pso_j, fit=fit_j, obstacles=obs_j,
                         num_particles=p)
    spec = convert.chain_spec_from(spec_j)
    got = solver.solve(spec, convert.problem_from(batched_j), None,
                       convert.pso_config_from(pso_j), convert.fitness_config_from(fit_j),
                       obstacles=convert.obstacles_from(obs_j), num_particles=p,
                       uniforms=_jax_draws(key, pso_j, s, p, spec.dof))
    _assert_replay(got, want)
