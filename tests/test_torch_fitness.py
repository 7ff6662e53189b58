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
from ikpso_tpu.ops.pallas_fitness import _pack_meta, _pack_swarm, fused_fitness
from ikpso_tpu_torch.models import convert
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
    dict(use_distance_term=True), dict(use_orientation=True),
    dict(num_obstacles=1), dict(trig_impl="exact"),
])
def test_unported_tile_branches_raise(kw):
    spec = convert.chain_spec_from(jlib.arm_7dof()[0])
    x = torch.zeros(1, 8, spec.dof)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fk_fitness(spec, x, torch.zeros(1, 6), torch.zeros(1, 30), **kw)


def test_fitness_refuses_obstacles():
    spec_j, problem_j = jlib.arm_7dof()
    spec = convert.chain_spec_from(spec_j)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fitness(spec, torch.zeros(spec.dof), convert.problem_from(problem_j),
                obstacles=object())


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
