"""Models and FK of the port (ikpso_tpu_torch.models, .ops.rotations,
.ops.fk) against the JAX package on identical inputs.

Inputs come from a seeded numpy generator and reach both packages through
ikpso_tpu_torch.models.convert. Tolerance: atol 1e-5 — both sides use
stock float32 sin/cos and float32 composes (JAX at precision="highest"),
so they differ only by libm and summation-order rounding, a few ulp of
values of order 1-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikpso_tpu.models import library as jlib
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.ops.rotations import euler_xyz_to_matrix as j_euler
from ikpso_tpu_torch.models import convert, library
from ikpso_tpu_torch.models.chain import IKProblem, stack_problems
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.rotations import euler_xyz_to_matrix

ATOL = 1e-5
MODELS = ["arm_7dof", "reference_arm"]


def _case(name, seed=0, batch=16):
    spec_j, problem_j = getattr(jlib, name)()
    rng = np.random.default_rng(seed)
    lo = np.asarray(spec_j.min_rotation)
    hi = np.asarray(spec_j.max_rotation)
    pose = (lo + rng.random((batch,) + lo.shape) * (hi - lo)).astype(np.float32)
    pose[:, 0] = rng.normal(0, 0.3, (batch, 3))  # a rotated origin frame too
    origin = rng.normal(0, 1, (batch, 3)).astype(np.float32)
    return spec_j, convert.chain_spec_from(spec_j), pose, origin


@pytest.mark.parametrize("name", MODELS)
def test_library_model_matches_jax(name):
    # Converted JAX model == the port's own library function, exactly.
    spec_j, problem_j = getattr(jlib, name)()
    spec, problem = getattr(library, name)()
    assert spec.parent == tuple(spec_j.parent)
    assert spec.effector_idx == tuple(spec_j.effector_idx)
    for field in ("length", "min_rotation", "max_rotation", "effector_weight"):
        np.testing.assert_array_equal(getattr(spec, field).numpy(),
                                      np.asarray(getattr(spec_j, field)))
    for field in ("pose", "origin", "targets"):
        np.testing.assert_array_equal(getattr(problem, field).numpy(),
                                      np.asarray(getattr(problem_j, field)))


def test_planar_3dof_matches_jax():
    spec_j, problem_j = jlib.planar_3dof()
    spec, problem = library.planar_3dof()
    np.testing.assert_array_equal(spec.max_rotation.numpy(),
                                  np.asarray(spec_j.max_rotation))
    np.testing.assert_array_equal(problem.targets.numpy(), np.asarray(problem_j.targets))


def test_euler_xyz_to_matrix_matches_jax():
    a = np.random.default_rng(3).uniform(-7, 7, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(euler_xyz_to_matrix(torch.as_tensor(a)).numpy(),
                               np.asarray(j_euler(jnp.asarray(a))), atol=ATOL)


@pytest.mark.parametrize("name", MODELS)
def test_fk_matches_jax(name):
    spec_j, spec, pose, origin = _case(name)
    pos_j, rot_j = jfk.fk(spec_j, jnp.asarray(pose), jnp.asarray(origin))
    pos, rot = fk_ops.fk(spec, torch.as_tensor(pose), torch.as_tensor(origin))
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_j), atol=ATOL)
    np.testing.assert_allclose(rot.numpy(), np.asarray(rot_j), atol=ATOL)


@pytest.mark.parametrize("name", MODELS)
def test_fk_points_and_effectors_match_jax(name):
    spec_j, spec, pose, origin = _case(name, seed=1)
    pts_j = jfk.fk_points(spec_j, jnp.asarray(pose), jnp.asarray(origin))
    eff_j = jfk.effector_positions(spec_j, jnp.asarray(pose), jnp.asarray(origin))
    pts = fk_ops.fk_points(spec, torch.as_tensor(pose), torch.as_tensor(origin))
    eff = fk_ops.effector_positions(spec, torch.as_tensor(pose), torch.as_tensor(origin))
    np.testing.assert_allclose(pts.numpy(), np.asarray(pts_j), atol=ATOL)
    np.testing.assert_allclose(eff.numpy(), np.asarray(eff_j), atol=ATOL)


@pytest.mark.parametrize("name", MODELS)
def test_pose_angle_round_trip_matches_jax(name):
    # Pure reshapes: exact.
    spec_j, spec, pose, _ = _case(name, seed=2)
    ang_j = jfk.pose_to_angles(spec_j, jnp.asarray(pose))
    ang = fk_ops.pose_to_angles(spec, torch.as_tensor(pose))
    np.testing.assert_array_equal(ang.numpy(), np.asarray(ang_j))
    root = pose[:, 0]
    back_j = jfk.angles_to_pose(spec_j, jnp.asarray(root), ang_j)
    back = fk_ops.angles_to_pose(spec, torch.as_tensor(root), ang)
    np.testing.assert_array_equal(back.numpy(), np.asarray(back_j))
    np.testing.assert_array_equal(back.numpy(), pose)


def test_fk_broadcasts_unbatched_origin_over_particles():
    # (S, P, N, 3) poses with a per-swarm (S, 1, 3) origin, as the fitness
    # inserts the particle axis.
    spec_j, spec, pose, origin = _case("arm_7dof", seed=4, batch=6)
    pose = pose.reshape(2, 3, *pose.shape[1:])
    org = origin[:2, None, :]
    pos_j, _ = jfk.fk(spec_j, jnp.asarray(pose), jnp.asarray(org))
    pos, _ = fk_ops.fk(spec, torch.as_tensor(pose), torch.as_tensor(org))
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_j), atol=ATOL)


def test_stack_problems_and_take():
    _, p1 = library.arm_7dof(target=(1.0, 0.0, 0.0))
    _, p2 = library.arm_7dof(target=(0.0, 1.0, 0.0))
    batched = stack_problems([p1, p2])
    assert batched.batch_shape() == (2,)
    assert isinstance(batched, IKProblem)
    np.testing.assert_array_equal(batched.take(torch.tensor([1])).targets.numpy(),
                                  [[[0.0, 1.0, 0.0]]])


def test_tf32_is_off():
    # FK composes in full float32: TF32 would put mm-scale error into FK.
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
