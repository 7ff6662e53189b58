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
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.pso.polish import polish_angles as j_polish
from ikpso_tpu.pso.polish import wrap_with_polish as j_wrap
from ikpso_tpu.pso.polish_soa import anchor_positions_flat as j_anchor_flat
from ikpso_tpu.pso.polish_soa import true_effector_error_rows as j_err_rows
from ikpso_tpu.pso.solver import SolveResult as JResult
from ikpso_tpu_torch.models import convert
from ikpso_tpu_torch.ops import fk as fk_ops
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


def test_soa_gate_and_refusals():
    spec = convert.chain_spec_from(jlib.arm_7dof()[0])
    assert soa_traceable(spec, spec.dof, False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wrap_with_polish(lambda p, g: None, spec, obstacles=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        polish_angles(spec, None, torch.zeros(1, spec.dof), use_orientation=True)
