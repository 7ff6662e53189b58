"""SoA LM polish of the port (ikpso_tpu_torch.pso.polish_soa, .pso.polish)
against the JAX package on identical inputs.

Tolerance atol 1e-4 on angles: both sides run the same unrolled float32
LM step with stock trig; libm and op-order rounding (~1e-7) can shift a
damped step by a few ulp, and four steps compound that well under 1e-4.
The row FK metrics have no solve in them: atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikpso_tpu.models import library as jlib
from ikpso_tpu.models.chain import Obstacles as JObstacles
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.pso.polish import polish_angles as j_polish
from ikpso_tpu.pso.polish import wrap_with_polish as j_wrap
from ikpso_tpu.pso.polish_soa import anchor_positions_flat as j_anchor_flat
from ikpso_tpu.pso.polish_soa import true_effector_error_rows as j_err_rows
from ikpso_tpu.pso.solver import SolveResult as JResult
from ikpso_tpu_torch.models import convert
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.models.chain import Obstacles
from ikpso_tpu_torch.ops.fitness import true_effector_error
from ikpso_tpu_torch.pso.polish import polish_angles, soa_traceable, wrap_with_polish
from ikpso_tpu_torch.pso.polish_soa import anchor_positions_flat, true_effector_error_rows
from ikpso_tpu_torch.pso.solver import SolveResult

ATOL = 1e-4


def _case(name, s, seed, noise=0.1):
    """Reachable targets (FK of random in-limit angles) and starts that
    perturb the generating angles by ``noise`` (clipped to the limits)."""
    spec_j, problem_j = getattr(jlib, name)()
    rng = np.random.default_rng(seed)
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    truth = (lo + rng.random((s, spec_j.dof)) * (hi - lo)).astype(np.float32)
    pose = jfk.angles_to_pose(spec_j, jnp.broadcast_to(problem_j.pose[0], (s, 3)),
                              jnp.asarray(truth))
    targets = jfk.fk_points(spec_j, pose, problem_j.origin)[
        :, list(spec_j.effector_idx), :]
    batched_j = jlib.batched_problem(problem_j, targets)
    start = np.clip(truth + rng.normal(0, noise, truth.shape), lo, hi).astype(np.float32)
    return spec_j, batched_j, start


@pytest.mark.parametrize("locality", [0.0, 0.5])
def test_polish_angles_soa_matches_jax(locality):
    # Dual (M, M) form without locality; primal (D, D) form with it.
    spec_j, batched_j, start = _case("arm_7dof", 64, seed=20)
    want = j_polish(spec_j, batched_j, jnp.asarray(start), steps=4,
                    locality_weight=locality)
    spec = convert.chain_spec_from(spec_j)
    got = polish_angles(spec, convert.problem_from(batched_j), torch.as_tensor(start),
                        steps=4, locality_weight=locality)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # The polish did something: it moved the starts, and without the
    # locality pull towards the (zero) anchor pose it halved the error.
    assert np.all(np.any(got.numpy() != start, axis=-1))
    if not locality:
        e0 = j_err_rows(spec_j, batched_j, jnp.asarray(start))
        e1 = true_effector_error_rows(spec, convert.problem_from(batched_j), got)
        assert float(e1.mean()) < 0.5 * float(np.asarray(e0).mean())


@pytest.mark.parametrize("name", ["arm_7dof", "reference_arm"])
def test_row_metrics_match_jax(name):
    spec_j, batched_j, start = _case(name, 32, seed=21, noise=0.3)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    np.testing.assert_allclose(
        true_effector_error_rows(spec, batched, torch.as_tensor(start)).numpy(),
        np.asarray(j_err_rows(spec_j, batched_j, jnp.asarray(start))), atol=1e-5)
    posed_j = batched_j.replace(
        pose=jfk.angles_to_pose(spec_j, batched_j.pose[:, 0], jnp.asarray(start)))
    posed = convert.problem_from(posed_j)
    np.testing.assert_allclose(anchor_positions_flat(spec, posed).numpy(),
                               np.asarray(j_anchor_flat(spec_j, posed_j)), atol=1e-5)
    # The row FK is the tensor FK in another layout.
    pts = fk_ops.fk_points(spec, posed.pose, posed.origin)[:, 1:].reshape(32, -1)
    np.testing.assert_allclose(anchor_positions_flat(spec, posed).numpy(), pts.numpy(),
                               atol=1e-5)


def test_wrap_with_polish_accept_gate_matches_jax():
    # A deterministic stub base solver: starts near the truth, and for the
    # even swarms it reports an error of 0 — better than any polish can
    # claim, so the gate must keep those swarms' base answers untouched.
    s = 16
    spec_j, batched_j, start = _case("arm_7dof", s, seed=22)
    even = (np.arange(s) % 2 == 0)

    def j_stub(problem, key):
        del key
        ang = jnp.asarray(start)
        err = jnp.where(jnp.asarray(even), 0.0, j_err_rows(spec_j, problem, ang))
        return JResult(angles=ang, fitness=err, effector_error=err,
                       pose=jfk.angles_to_pose(spec_j, problem.pose[:, 0], ang),
                       trace=err[None])

    spec = convert.chain_spec_from(spec_j)

    def stub(problem, generator):
        del generator
        ang = torch.as_tensor(start)
        err = torch.where(torch.as_tensor(even), torch.zeros(()),
                          true_effector_error_rows(spec, problem, ang))
        return SolveResult(angles=ang, fitness=err, effector_error=err,
                           pose=fk_ops.angles_to_pose(spec, problem.pose[:, 0], ang),
                           trace=err[None])

    want = j_wrap(j_stub, spec_j, steps=4)(batched_j, jax.random.key(0))
    got = wrap_with_polish(stub, spec, steps=4)(
        convert.problem_from(batched_j), torch.Generator())
    np.testing.assert_array_equal(got.angles.numpy()[even], start[even])
    assert np.all(got.effector_error.numpy()[even] == 0.0)
    assert np.all(np.any(got.angles.numpy()[~even] != start[~even], axis=-1))
    np.testing.assert_allclose(got.angles.numpy(), np.asarray(want.angles), atol=ATOL)
    np.testing.assert_allclose(got.effector_error.numpy(),
                               np.asarray(want.effector_error), atol=1e-5)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=ATOL)
    np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness), atol=1e-5)


@pytest.mark.parametrize("shape", ["box", "capsule"])
def test_polish_gate_rejects_colliding_refinement_like_jax(shape):
    # tests/test_polish.py:235-280: a box sits on the planar arm's
    # target. Ungated polish chases the target into it; the gate keeps the
    # feasible PSO answer, in both packages.
    _gate_case(shape, "sat")


def _gate_case(shape, backend):
    """The polish gate of ``test_polish_gate_rejects_colliding_refinement_like_jax``
    with the ``backend`` collider, in both packages."""
    spec_j, problem_j = jlib.planar_3dof(target=(2.5, 0.0, 0.0))
    boxes = dict(centers=np.array([[2.5, 0.0, 0.0]], np.float32),
                 full_dims=np.array([[0.8, 0.8, 0.8]], np.float32))
    obs_j = JObstacles.from_boxes(**boxes)
    s = 4
    one = np.zeros((spec_j.dof,), np.float32)
    one[[2, 5, 8]] = (0.9, 0.6, 0.3)
    start = np.broadcast_to(one, (s, spec_j.dof)).copy()
    batched_j = jax.tree.map(lambda a: jnp.broadcast_to(a, (s,) + a.shape), problem_j)
    batched_j = batched_j.replace(
        pose=jfk.angles_to_pose(spec_j, batched_j.pose[..., 0, :], jnp.asarray(start)))

    def j_stub(prob, key):
        del key
        from ikpso_tpu.ops.fitness import true_effector_error as j_true_err

        err = j_true_err(spec_j, prob.pose, prob)
        return JResult(angles=jfk.pose_to_angles(spec_j, prob.pose), fitness=err,
                       pose=prob.pose, effector_error=err, trace=err[None])

    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)

    def stub(prob, generator):
        del generator
        err = true_effector_error(spec, prob.pose, prob)
        return SolveResult(angles=fk_ops.pose_to_angles(spec, prob.pose), fitness=err,
                           pose=prob.pose, effector_error=err, trace=err[None])

    want = j_wrap(j_stub, spec_j, steps=5, obstacles=obs_j, collision_shape=shape,
                  collision_backend=backend)(batched_j, jax.random.key(0))
    free = wrap_with_polish(stub, spec, steps=5)(batched, torch.Generator())
    gated = wrap_with_polish(stub, spec, steps=5, obstacles=Obstacles.from_boxes(**boxes),
                             collision_shape=shape,
                             collision_backend=backend)(batched, torch.Generator())
    base_err = true_effector_error(spec, batched.pose, batched).numpy()
    assert (free.effector_error.numpy() < base_err - 0.05).all()
    np.testing.assert_array_equal(gated.angles.numpy(), start)
    np.testing.assert_array_equal(np.asarray(want.angles), start)
    np.testing.assert_allclose(gated.effector_error.numpy(),
                               np.asarray(want.effector_error), rtol=1e-6)


def test_soa_gate_and_refusals():
    spec = convert.chain_spec_from(jlib.arm_7dof()[0])
    assert soa_traceable(spec, spec.dof, False)
    # The GJK collider gates the polish too, as in JAX (no longer refused).
    for shape in ("box", "capsule"):
        _gate_case(shape, "gjk")
    # The orientation rows (tests/test_torch_orientation.py) and the
    # locality-cost accept gate (tests/test_torch_experiment.py) are ported:
    # wrapping with a locality weight no longer refuses.
    assert callable(wrap_with_polish(lambda p, g: None, spec, locality_weight=0.5))


def _oriented_case(name, s, seed, noise):
    """``_case`` with target rotations: the generating poses' effector
    world rotations (bench.py:117-120)."""
    from ikpso_tpu.ops import rotations as jrot

    spec_j, problem_j = getattr(jlib, name)()
    rng = np.random.default_rng(seed)
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    truth = (lo + rng.random((s, spec_j.dof)) * (hi - lo)).astype(np.float32)
    pose = jfk.angles_to_pose(spec_j, jnp.broadcast_to(problem_j.pose[0], (s, 3)),
                              jnp.asarray(truth))
    eff = list(spec_j.effector_idx)
    pos, rot = jfk.fk(spec_j, pose, problem_j.origin)
    batched_j = jlib.batched_problem(
        problem_j, pos[:, eff],
        target_rot=jrot.quaternion_to_euler_xyz(jrot.matrix_to_quaternion(rot[:, eff])))
    start = np.clip(truth + rng.normal(0, noise, truth.shape), lo, hi).astype(np.float32)
    return spec_j, batched_j, start


@pytest.mark.parametrize("name,orientation,steps", [
    # The humanoid's m = 15 rows take the dual (M, M) form of the tensor
    # path; arm_6dof with orientation (m = 6 = D) too, with the
    # rotation-vector rows; the dual arm runs it here through soa=False.
    ("humanoid_45dof", False, 6), ("arm_6dof", True, 4), ("dual_arm_14dof", False, 4),
])
def test_tensor_polish_matches_jax(name, orientation, steps):
    # JAX polish_angles(..., soa=False), S=64, starts 0.1 rad off the truth.
    spec_j, batched_j, start = _oriented_case(name, 64, seed=24, noise=0.1)
    if not orientation:
        batched_j = batched_j.replace(target_rot=None)
    want = j_polish(spec_j, batched_j, jnp.asarray(start), steps=steps,
                    use_orientation=orientation, soa=False)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    got = polish_angles(spec, batched, torch.as_tensor(start), steps=steps,
                        use_orientation=orientation, soa=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    e0 = true_effector_error_rows(spec, batched, torch.as_tensor(start))
    e1 = true_effector_error_rows(spec, batched, got)
    assert float(e1.mean()) < 0.1 * float(e0.mean())


def test_tensor_polish_cost_and_primal_form_match_jax():
    # With locality rows m = 3E + D > D: the primal (D, D) form; and the
    # residual cost it minimizes, against JAX.
    from ikpso_tpu.pso.polish import residual_cost as j_cost
    from ikpso_tpu_torch.pso.polish import residual_cost

    spec_j, batched_j, start = _case("dual_arm_14dof", 16, seed=25)
    want = j_polish(spec_j, batched_j, jnp.asarray(start), steps=3, locality_weight=0.01,
                    soa=False)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    got = polish_angles(spec, batched, torch.as_tensor(start), steps=3,
                        locality_weight=0.01, soa=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(
        residual_cost(spec, batched, got, locality_weight=0.01).numpy(),
        np.asarray(j_cost(spec_j, batched_j, want, locality_weight=0.01)), rtol=1e-4,
        atol=1e-7)


def test_soa_routing_gate_matches_jax():
    # tests/test_polish.py:388-409: every zoo model lands on the LM path JAX
    # routes it to; the humanoid (m = 15, m^2 D = 10,125) on the tensor
    # path, snakes of any depth on the SoA core.
    from ikpso_tpu.pso.polish import soa_traceable as j_soa_traceable
    from ikpso_tpu_torch.models import library

    for name, orient, want_soa in [
        ("arm_7dof", False, True), ("planar_3dof", False, True), ("arm_6dof", True, True),
        ("dual_arm_14dof", False, True), ("reference_arm", False, True),
        ("humanoid_45dof", False, False),
    ]:
        spec, _ = getattr(library, name)()
        assert soa_traceable(spec, spec.dof, orient) == want_soa, name
        spec_j, _ = getattr(jlib, name)()
        assert j_soa_traceable(spec_j, spec_j.dof, orient) == want_soa, name
    for links in (30, 50, 100, 150, 170):
        spec, _ = library.serial_chain(links)
        assert soa_traceable(spec, spec.dof, False), f"snake:{links}"
