"""Top-k retries and target walks of the port (ikpso_tpu_torch.pso.restarts)
against the JAX package.

The base and retry solvers are deterministic stubs that are functions of
the problem alone, written once in jnp and once in torch with the same
float32 arithmetic, so the merged results must be identical, bit for bit
— including the rows of already-converged swarms, which the merge
``better = (retry < prev) & (prev > thr)`` must leave untouched.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikpso_tpu.models import library as jlib
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.pso.restarts import make_topk_retry_solver as j_topk
from ikpso_tpu.pso.solver import SolveResult as JResult
from ikpso_tpu_torch.harness.headline import headline_bucket
from ikpso_tpu_torch.models import convert
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.restarts import (
    bucket_schedule,
    make_topk_retry_solver,
    worst_indices,
    wrap_solver_with_target_walk,
    wrap_with_topk_retries,
)
from ikpso_tpu_torch.pso.solver import SolveResult

THRESHOLD = 1e-3


def _tied_problem(s=64, seed=30):
    # Target coordinates from a 4-value set: errors tie in large groups,
    # so top-k order among equal errors decides which swarms are retried.
    spec_j, problem_j = jlib.arm_7dof()
    rng = np.random.default_rng(seed)
    vals = np.array([0.05, 0.1, 0.2, 0.02], np.float32)
    targets = vals[rng.integers(0, 4, (s, 1, 3))]
    return spec_j, jlib.batched_problem(problem_j, jnp.asarray(targets))


def _j_stub(spec_j, col, scale):
    def solve(problem, key):
        del key
        err = jnp.abs(problem.targets[:, 0, col]) * scale
        ang = jnp.concatenate([problem.targets[:, 0, :]] * 3, axis=-1) * scale
        return JResult(angles=ang, fitness=err * 2.0, effector_error=err,
                       pose=jfk.angles_to_pose(spec_j, problem.pose[:, 0], ang),
                       trace=err[None])
    return solve


def _stub(spec, col, scale):
    def solve(problem, generator):
        del generator
        err = torch.abs(problem.targets[:, 0, col]) * scale
        ang = torch.cat([problem.targets[:, 0, :]] * 3, dim=-1) * scale
        return SolveResult(angles=ang, fitness=err * 2.0, effector_error=err,
                           pose=fk_ops.angles_to_pose(spec, problem.pose[:, 0], ang),
                           trace=err[None])
    return solve


@pytest.mark.parametrize("buckets,rounds", [([8, 4, 2], 3), (16, 2), ([64], 1)])
def test_topk_retry_merge_matches_jax(buckets, rounds):
    spec_j, batched_j = _tied_problem()
    want = j_topk(_j_stub(spec_j, 0, 0.02), bucket=buckets, rounds=rounds,
                  err_threshold=THRESHOLD,
                  retry_solver=_j_stub(spec_j, 1, 0.03))(batched_j, jax.random.key(0))
    spec = convert.chain_spec_from(spec_j)
    got = make_topk_retry_solver(
        _stub(spec, 0, 0.02), bucket=buckets, rounds=rounds, err_threshold=THRESHOLD,
        retry_solver=_stub(spec, 1, 0.03))(convert.problem_from(batched_j),
                                           torch.Generator())
    for field in ("angles", "fitness", "pose", "effector_error", "trace"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    base = _stub(spec, 0, 0.02)(convert.problem_from(batched_j), None)
    changed = (got.effector_error != base.effector_error).numpy()
    assert changed.any(), "some retries must win, or the merge is untested"
    # Converged swarms (base error <= threshold) are bit-stable.
    converged = (base.effector_error <= THRESHOLD).numpy()
    assert converged.any()
    np.testing.assert_array_equal(got.angles.numpy()[converged],
                                  base.angles.numpy()[converged])


def test_topk_retry_merge_with_two_effectors_matches_jax():
    # The dual arm's two effectors: the stubs' errors tie in groups and the
    # angles (18 DOF) concatenate both targets; the merge stays bit for bit
    # JAX's and leaves converged swarms untouched.
    spec_j, problem_j = jlib.dual_arm_14dof()
    rng = np.random.default_rng(32)
    vals = np.array([0.05, 0.1, 0.2, 0.02], np.float32)
    batched_j = jlib.batched_problem(problem_j, jnp.asarray(vals[rng.integers(0, 4, (64, 2, 3))]))

    def j_stub(col, scale):
        def solve(problem, key):
            del key
            err = jnp.abs(problem.targets[:, 1, col]) * scale
            ang = jnp.concatenate([problem.targets.reshape(-1, 6)] * 3, axis=-1) * scale
            return JResult(angles=ang, fitness=err * 2.0, effector_error=err,
                           pose=jfk.angles_to_pose(spec_j, problem.pose[:, 0], ang),
                           trace=err[None])
        return solve

    spec = convert.chain_spec_from(spec_j)

    def stub(col, scale):
        def solve(problem, generator):
            del generator
            err = torch.abs(problem.targets[:, 1, col]) * scale
            ang = torch.cat([problem.targets.reshape(-1, 6)] * 3, dim=-1) * scale
            return SolveResult(angles=ang, fitness=err * 2.0, effector_error=err,
                               pose=fk_ops.angles_to_pose(spec, problem.pose[:, 0], ang),
                               trace=err[None])
        return solve

    want = j_topk(j_stub(0, 0.02), bucket=[16, 8], rounds=2, err_threshold=THRESHOLD,
                  retry_solver=j_stub(2, 0.03))(batched_j, jax.random.key(0))
    got = make_topk_retry_solver(stub(0, 0.02), bucket=[16, 8], rounds=2,
                                 err_threshold=THRESHOLD, retry_solver=stub(2, 0.03))(
        convert.problem_from(batched_j), torch.Generator())
    for field in ("angles", "fitness", "pose", "effector_error", "trace"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    base = stub(0, 0.02)(convert.problem_from(batched_j), None)
    assert bool((got.effector_error != base.effector_error).any())
    converged = (base.effector_error <= THRESHOLD).numpy()
    assert converged.any()
    np.testing.assert_array_equal(got.angles.numpy()[converged],
                                  base.angles.numpy()[converged])


def test_worst_indices_order_ties_like_lax_top_k():
    err = np.array([0.5, 0.2, 0.5, 0.9, 0.2, 0.5, 0.9, 0.1, 0.2], np.float32)
    for k in range(1, err.size + 1):
        want = np.asarray(jax.lax.top_k(jnp.asarray(err), k)[1])
        np.testing.assert_array_equal(worst_indices(torch.as_tensor(err), k).numpy(), want)


def test_headline_bucket_schedule():
    s = 1_048_576
    assert headline_bucket(s, 8) == 32768
    assert bucket_schedule(headline_bucket(s, 8), 4, 8) == [32768, 4096, 1024, 1024]
    # Small batches: S/8 cap, constant buckets without decay.
    assert headline_bucket(1024, 8) == 128
    assert bucket_schedule(128, 3, 8) == [128, 128, 128]
    assert bucket_schedule(2048, 2) == [2048, 2048]


def test_wrap_builds_a_retry_solver_only_for_changed_configs():
    built = []

    def build(cfg):
        built.append(cfg)
        return lambda problem, gen: None

    pso = PSOConfig(iterations=8, inertia_mode="canonical", inertia_end=0.2)
    wrap_with_topk_retries(build, pso, rounds=2, bucket=64)
    assert built == [pso]
    built.clear()
    wrap_with_topk_retries(build, pso, rounds=2, bucket=64, retry_iterations=16)
    assert built == [pso, dataclasses.replace(pso, iterations=16)]
    # A walk needs the spec to find its start (as in JAX), and it ignores
    # retry_init_mode: no retry solver of its own is built.
    with pytest.raises(ValueError, match="requires spec"):
        wrap_with_topk_retries(build, pso, rounds=1, bucket=8, retry_walk_steps=4)
    built.clear()
    spec = convert.chain_spec_from(jlib.dual_arm_14dof()[0])
    wrap_with_topk_retries(build, pso, rounds=2, bucket=8, retry_init_mode="hybrid",
                           retry_walk_steps=4, spec=spec)
    assert built == [pso]
    with pytest.raises(ValueError, match="steps >= 1"):
        wrap_solver_with_target_walk(lambda p, g: None, spec, 0)


def _polish_only(spec, make_result, err_rows, angles_to_pose):
    """A deterministic solver: the problem pose's angles, then 2 LM steps."""
    def solve(problem, key):
        del key
        ang = problem.pose[:, 1:].reshape(problem.pose.shape[0], -1)
        err = err_rows(spec, problem, ang)
        return make_result(angles=ang, fitness=err, effector_error=err,
                           pose=angles_to_pose(spec, problem.pose[:, 0], ang),
                           trace=err[None])
    return solve


def test_target_walk_matches_jax_with_a_deterministic_solver():
    # A 3-step walk of a polish-only solver on the dual arm: the same
    # waypoints, the same warm chaining, the same final solve at the true
    # targets (atol 1e-4, the polish tests' bar).
    from ikpso_tpu.pso.polish import wrap_with_polish as j_wrap_polish
    from ikpso_tpu.pso.polish_soa import true_effector_error_rows as j_err_rows
    from ikpso_tpu.pso.restarts import wrap_solver_with_target_walk as j_walk
    from ikpso_tpu_torch.pso.polish import wrap_with_polish
    from ikpso_tpu_torch.pso.polish_soa import true_effector_error_rows

    spec_j, problem_j = jlib.dual_arm_14dof()
    rng = np.random.default_rng(31)
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    # Targets within reach of a few LM steps per waypoint, where the walk is
    # well conditioned (a far jump leaves a rounding-sensitive LM path).
    ang = np.clip(rng.normal(0, 0.4, (16, spec_j.dof)), lo, hi).astype(np.float32)
    pose = jfk.angles_to_pose(spec_j, jnp.broadcast_to(problem_j.pose[0], (16, 3)),
                              jnp.asarray(ang))
    batched_j = jlib.batched_problem(problem_j, jfk.fk_points(
        spec_j, pose, problem_j.origin)[:, list(spec_j.effector_idx)])
    inner_j = j_wrap_polish(_polish_only(spec_j, JResult, j_err_rows, jfk.angles_to_pose),
                            spec_j, steps=2)
    want = j_walk(inner_j, spec_j, 3)(batched_j, jax.random.key(0))
    spec = convert.chain_spec_from(spec_j)
    inner = wrap_with_polish(_polish_only(spec, SolveResult, true_effector_error_rows,
                                          fk_ops.angles_to_pose), spec, steps=2)
    got = wrap_solver_with_target_walk(inner, spec, 3)(convert.problem_from(batched_j),
                                                       torch.Generator())
    np.testing.assert_allclose(got.angles.numpy(), np.asarray(want.angles), atol=1e-4)
    np.testing.assert_allclose(got.effector_error.numpy(), np.asarray(want.effector_error),
                               atol=1e-4)
    # The walk did the work: the error fell from the straight start's.
    e0 = true_effector_error_rows(spec, convert.problem_from(batched_j),
                                  torch.zeros((16, spec.dof)))
    assert float(got.effector_error.mean()) < 0.5 * float(e0.mean())


@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_target_walk_waypoints_and_jitter_endpoints(jitter):
    # The walk starts at the problem's pose, chains each step's pose into
    # the next, and ends exactly at the true targets; jitter bends only the
    # intermediate waypoints, a new curve at every call.
    spec_j, batched_j = _tied_problem(s=8)
    spec = convert.chain_spec_from(spec_j)
    problem = convert.problem_from(batched_j)
    calls = []

    def recording(prob, generator):
        calls.append((prob.pose.clone(), prob.targets.clone()))
        ang = prob.pose[:, 1:].reshape(8, -1) + 0.01
        err = torch.zeros(8)
        return SolveResult(angles=ang, fitness=err, effector_error=err,
                           pose=fk_ops.angles_to_pose(spec, prob.pose[:, 0], ang),
                           trace=err[None])

    walk = wrap_solver_with_target_walk(recording, spec, 4, jitter=jitter)
    gen = torch.Generator().manual_seed(0)
    walk(problem, gen)
    assert len(calls) == 4
    assert torch.equal(calls[0][0], problem.pose)
    assert torch.equal(calls[-1][1], problem.targets)
    for i in range(1, 4):
        np.testing.assert_allclose(calls[i][0][:, 1:].numpy(),
                                   problem.pose[:, 1:].numpy() + 0.01 * i, atol=1e-6)
    start = fk_ops.fk_points(spec, problem.pose, problem.origin)[:, list(spec.effector_idx)]
    straight = [start + (i / 4) * (problem.targets - start) for i in (1, 2, 3)]
    bent = [not torch.allclose(calls[i][1], straight[i], atol=1e-6) for i in range(3)]
    assert all(bent) if jitter else not any(bent)
    first = [c[1] for c in calls[:3]]
    calls.clear()
    walk(problem, gen)
    assert torch.equal(calls[-1][1], problem.targets)
    again = [torch.equal(a, c[1]) for a, c in zip(first, calls[:3])]
    assert not any(again) if jitter else all(again)
