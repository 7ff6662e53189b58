"""The port's scan solver (ikpso_tpu_torch.pso.solver) against the JAX
package's (ikpso_tpu/pso/solver.py).

Both sides take the same U[0, 1) draws: the JAX solver's key splits
(``ikpso_tpu/pso/solver.py:163-187, 240-273``) made in JAX and handed to
the port as injected draws. One update step agrees to float tolerance
(atol 1e-5 on angles of order 1: the two fitnesses round differently);
whole solves are held to the replay bar of tests/test_fused.py:257-258
(atol 5e-4 on the angles, rtol 1e-3 on the value). A 60-iteration run on
each side's own random stream is compared as a distribution (KS test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from ikpso_tpu.models import library as jlib
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.ops.fitness import FitnessConfig as JFit
from ikpso_tpu.ops.fitness import fitness as j_fitness
from ikpso_tpu.ops.pallas_fitness import make_pallas_fitness
from ikpso_tpu.pso import solver as jsolver
from ikpso_tpu.pso.config import PSOConfig as JPSO
from ikpso_tpu_torch.models import convert
from ikpso_tpu_torch.ops.fitness import COLLISION_PENALTY, fitness
from ikpso_tpu_torch.ops.fitness_kernel import fused_fitness, make_kernel_fitness
from ikpso_tpu_torch.pso import solver
from ikpso_tpu_torch.pso.config import PSOConfig

STEP_ATOL = 1e-5
REPLAY_ATOL, REPLAY_RTOL, REPLAY_VAL_ATOL = 5e-4, 1e-3, 1e-5


def _case(s, rng, warm=True):
    """arm_7dof with s reachable targets and (``warm``) a random warm pose
    near the middle, else the model's own pose."""
    spec_j, problem_j = jlib.arm_7dof()
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    ang = (lo + rng.random((s, spec_j.dof)) * (hi - lo)).astype(np.float32)
    pose = jfk.angles_to_pose(spec_j, jnp.broadcast_to(problem_j.pose[0], (s, 3)),
                              jnp.asarray(ang))
    targets = jfk.fk_points(spec_j, pose, problem_j.origin)[:, list(spec_j.effector_idx)]
    batched_j = jlib.batched_problem(problem_j, targets)
    if not warm:
        return spec_j, batched_j, lo.astype(np.float32), hi.astype(np.float32)
    warm = (0.3 * (lo + rng.random((s, spec_j.dof)) * (hi - lo))).astype(np.float32)
    batched_j = batched_j.replace(pose=batched_j.pose.at[:, 1:].set(
        jnp.asarray(warm).reshape(s, -1, 3)))
    return spec_j, batched_j, lo.astype(np.float32), hi.astype(np.float32)


def _fitness_pair(spec_j, batched_j, fit_j):
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    fit = convert.fitness_config_from(fit_j)

    def jf(x):
        return j_fitness(spec_j, x, batched_j, config=fit_j)

    def tf(x):
        return fitness(spec, x, batched, fit)

    return spec, batched, jf, tf


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _state(spec_j, batched_j, jf, s, p, rng, lo, hi):
    """A mid-solve state: random positions, velocities and lbests."""
    d = spec_j.dof
    x = (lo + rng.random((s, p, d)) * (hi - lo)).astype(np.float32)
    v = rng.normal(0, 0.3, (s, p, d)).astype(np.float32)
    lbest = (lo + rng.random((s, p, d)) * (hi - lo)).astype(np.float32)
    lval = np.asarray(jf(jnp.asarray(lbest)))
    gval, gbest = jsolver._swarm_argmin(jnp.asarray(lval), jnp.asarray(lbest))
    return x, v, lbest, lval, np.asarray(gbest), np.asarray(gval)


ITERATION_CASES = {
    "canonical": JPSO(inertia_mode="canonical"),
    "randomized": JPSO(inertia_mode="randomized"),
    "schedule": JPSO(iterations=9, inertia_mode="canonical", inertia=0.5, inertia_end=0.2),
    "rekick_threshold": JPSO(inertia_mode="randomized", rekick_interval=2,
                             rekick_scale=0.7, rekick_threshold=0.5),
}


@pytest.mark.parametrize("case", sorted(ITERATION_CASES))
def test_pso_iteration_matches_jax(case):
    pso_j = ITERATION_CASES[case]
    rng = np.random.default_rng(30)
    s, p, it = 4, 64, 4
    spec_j, batched_j, lo, hi = _case(s, rng)
    fit_j = JFit(angle_weight=0.0, distance_weight=0.0)
    spec, _, jf, tf = _fitness_pair(spec_j, batched_j, fit_j)
    state = _state(spec_j, batched_j, jf, s, p, rng, lo, hi)
    if case == "rekick_threshold":
        # Half the swarms above the threshold (kicked), half below.
        state = state[:5] + (np.array([0.1, 2.0, 0.2, 3.0], np.float32),)
    key = jax.random.key(31)
    want = jsolver.pso_iteration(*map(jnp.asarray, state), key, jf, jnp.asarray(lo),
                                 jnp.asarray(hi), pso_j, iteration=it)
    pso = convert.pso_config_from(pso_j)
    u = jax.random.uniform(key, (solver.draws_per_iteration(pso), s, p, spec.dof))
    got = solver.pso_iteration(*map(torch.as_tensor, state), torch.as_tensor(np.asarray(u)),
                               tf, torch.as_tensor(lo), torch.as_tensor(hi), pso,
                               iteration=it)
    if case == "rekick_threshold":
        # Swarms 1 and 3 (gbest above the threshold) move as if every swarm
        # were kicked, swarms 0 and 2 as if none were.
        args = (torch.as_tensor(lo), torch.as_tensor(hi))
        kick_all = solver.pso_iteration(
            *map(torch.as_tensor, state), torch.as_tensor(np.asarray(u)), tf, *args,
            dataclasses.replace(pso, rekick_threshold=-1.0), iteration=it)
        kick_none = solver.pso_iteration(
            *map(torch.as_tensor, state), torch.as_tensor(np.asarray(u))[:3], tf, *args,
            dataclasses.replace(pso, rekick_interval=0), iteration=it)
        assert torch.equal(got[1][[1, 3]], kick_all[1][[1, 3]])
        assert torch.equal(got[1][[0, 2]], kick_none[1][[0, 2]])
        assert not torch.equal(kick_all[1], kick_none[1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=STEP_ATOL, rtol=1e-5)


@pytest.mark.parametrize("init_mode", ["warm", "uniform", "hybrid"])
def test_init_swarm_matches_jax(init_mode):
    rng = np.random.default_rng(32)
    s, p = 3, 128
    spec_j, batched_j, lo, hi = _case(s, rng)
    fit_j = JFit(angle_weight=1.0)
    spec, batched, jf, tf = _fitness_pair(spec_j, batched_j, fit_j)
    pso_j = JPSO(init_mode=init_mode, init_velocity_scale=0.75)
    anchor_j = jfk.pose_to_angles(spec_j, batched_j.pose)
    key = jax.random.key(33)
    want = jsolver.init_swarm(key, anchor_j, p, jf, pso_j,
                              limits=(jnp.asarray(lo), jnp.asarray(hi)))
    # The JAX init's key splits (ikpso_tpu/pso/solver.py:163-187).
    shape = (s, p, spec.dof)
    u_x = None
    if init_mode != "warm":
        key, key_x = jax.random.split(key)
        u_x = torch.as_tensor(np.asarray(jax.random.uniform(key_x, shape)))
    u_v = torch.as_tensor(np.asarray(jax.random.uniform(key, shape)))
    got = solver.init_swarm(None, torch.as_tensor(np.asarray(anchor_j)), p, tf,
                            convert.pso_config_from(pso_j),
                            limits=(torch.as_tensor(lo), torch.as_tensor(hi)),
                            uniforms=(u_x, u_v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=STEP_ATOL, rtol=1e-5)


def _jax_draws(key, pso_j, s, p, d):
    """The U[0, 1) blocks JAX solve() draws (solver.py:163-187, 240-273)."""
    shape = (s, p, d)
    key_init, key_loop = jax.random.split(key)
    position = None
    if pso_j.init_mode != "warm":
        key_init, key_x = jax.random.split(key_init)
        position = torch.as_tensor(np.asarray(jax.random.uniform(key_x, shape)))
    velocity = torch.as_tensor(np.asarray(jax.random.uniform(key_init, shape)))
    n = solver.draws_per_iteration(convert.pso_config_from(pso_j))
    steps = [np.asarray(jax.random.uniform(k, (n,) + shape))
             for k in jax.random.split(key_loop, pso_j.iterations)]
    return solver.ScanDraws(position, velocity, torch.as_tensor(np.stack(steps)))


def _assert_replay(got, want):
    np.testing.assert_allclose(got.angles.numpy(), np.asarray(want.angles), atol=REPLAY_ATOL)
    np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness),
                               rtol=REPLAY_RTOL, atol=REPLAY_VAL_ATOL)
    np.testing.assert_allclose(got.effector_error.numpy(), np.asarray(want.effector_error),
                               atol=REPLAY_ATOL)
    assert got.trace.shape == want.trace.shape


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_solve_matches_jax(impl):
    # S=2, P=1024 (one Pallas tile per swarm), 3 randomized iterations.
    rng = np.random.default_rng(34)
    s, p = 2, 1024
    spec_j, batched_j, _, _ = _case(s, rng)
    pso_j = JPSO(iterations=3, init_mode="hybrid")
    fit_j = JFit(angle_weight=0.0, distance_weight=0.0)
    key = jax.random.key(35)
    fitness_j = (make_pallas_fitness(spec_j, batched_j, fit=fit_j, interpret=True)
                 if impl == "kernel" else None)
    want = jsolver.solve(spec_j, batched_j, key, pso=pso_j, fit=fit_j, num_particles=p,
                         fitness_fn=fitness_j)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    fit = convert.fitness_config_from(fit_j)
    before = fused_fitness.launches
    got = solver.solve(
        spec, batched, None, convert.pso_config_from(pso_j), fit, num_particles=p,
        fitness_fn=make_kernel_fitness(spec, batched, fit) if impl == "kernel" else None,
        uniforms=_jax_draws(key, pso_j, s, p, spec.dof))
    assert fused_fitness.launches == before  # CPU tensors: the plain twin ran
    _assert_replay(got, want)


def test_solve_single_and_make_solver():
    rng = np.random.default_rng(36)
    spec_j, batched_j, _, _ = _case(1, rng)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    pso = PSOConfig(iterations=2)
    single = jax.tree.map(lambda t: t[0], batched_j)
    problem = convert.problem_from(single)
    gen = torch.Generator().manual_seed(0)
    one = solver.solve_single(spec, problem, gen, pso=pso, num_particles=64)
    gen = torch.Generator().manual_seed(0)
    many = solver.make_solver(spec, pso=pso, num_particles=64)(batched, gen)
    assert one.angles.shape == (spec.dof,) and one.trace.shape == (3,)
    assert torch.equal(one.angles, many.angles[0])
    assert torch.equal(one.trace, many.trace[:, 0])


def test_swarm_argmin_ties_go_to_first_particle():
    # Duplicated minima, and a swarm whose particles all sit at the
    # collision penalty: the first minimum wins, as jnp.argmin.
    pen = float(COLLISION_PENALTY)
    values = np.array([[3.0, 1.0, 2.0, 1.0, 1.0],
                       [pen, pen, pen, pen, pen],
                       [pen, 5.0, pen, 5.0, 0.5]], np.float32)
    coords = np.arange(values.size * 2, dtype=np.float32).reshape(3, 5, 2)
    got_v, got_c = solver._swarm_argmin(torch.as_tensor(values), torch.as_tensor(coords))
    want_v, want_c = jsolver._swarm_argmin(jnp.asarray(values), jnp.asarray(coords))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_c.numpy(), coords[[0, 1, 2], [1, 0, 4]])
    assert np.isfinite(got_v.numpy()).all()


@pytest.mark.parametrize("scale", [1.0, 0.3])
def test_draws_stay_in_range(scale):
    # U[0, 1) from the generator, velocity init in [-scale, scale), also
    # at the extreme draws 0 and the largest float32 below 1.
    gen = torch.Generator().manual_seed(37)
    pso = PSOConfig(init_velocity_scale=scale, iterations=1)
    u = solver._uniform(gen, (4, 256, 9), "cpu")
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    top = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
    u_v = u.clone()
    u_v[0, 0], u_v[0, 1] = 0.0, top
    s32 = float(np.float32(scale))
    v = solver.init_swarm(None, torch.zeros(4, 9), 256, lambda x: x.sum(-1), pso,
                          uniforms=(None, u_v))[1]
    assert float(v.min()) >= -s32 and float(v.max()) < s32
    assert float(solver._scale(torch.tensor([top]), -s32, s32)) < s32


def test_scan_error_distribution_matches_jax():
    # 60 randomized iterations, S=128, P=1024, each side on its own random
    # stream (fixed seeds): the per-swarm error distributions agree (KS).
    rng = np.random.default_rng(38)
    s, p = 128, 1024
    spec_j, batched_j, _, _ = _case(s, rng, warm=False)
    pso_j = JPSO(iterations=60)
    fit_j = JFit(angle_weight=0.0, distance_weight=0.0)
    want = jsolver.make_solver(spec_j, pso=pso_j, fit=fit_j, num_particles=p)(
        batched_j, jax.random.key(39))
    spec = convert.chain_spec_from(spec_j)
    got = solver.make_solver(spec, convert.pso_config_from(pso_j),
                             convert.fitness_config_from(fit_j), num_particles=p)(
        convert.problem_from(batched_j), torch.Generator().manual_seed(39))
    e_got = got.effector_error.numpy()
    e_want = np.asarray(want.effector_error)
    assert np.isfinite(e_got).all()
    assert scipy.stats.ks_2samp(e_got, e_want).pvalue > 0.01
    assert abs((e_got < 1e-3).mean() - (e_want < 1e-3).mean()) < 0.15


def test_solve_refuses_missing_randomness():
    spec = convert.chain_spec_from(jlib.arm_7dof()[0])
    problem = convert.problem_from(jax.tree.map(lambda t: t[None], jlib.arm_7dof()[1]))
    with pytest.raises(ValueError, match="generator"):
        solver.solve(spec, problem, None, PSOConfig(iterations=1), num_particles=32)
    pso = dataclasses.replace(PSOConfig(), init_mode="uniform")
    with pytest.raises(ValueError, match="limits"):
        solver.init_swarm(torch.Generator(), torch.zeros(1, 9), 8, lambda x: x.sum(-1), pso)
