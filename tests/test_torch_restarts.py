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
    make_retry_solver,
    make_topk_retry_solver,
    solve_with_retries,
    worst_indices,
    wrap_solver_with_target_walk,
    wrap_with_topk_retries,
)
from ikpso_tpu_torch.pso.solver import SolveResult

from test_torch_fused import torch_single_thread  # noqa: F401,E402 (a fixture)

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


# Host-gather retries (solve_with_retries / make_retry_solver), the cases of
# tests/test_restarts.py:25-123 with the deterministic stubs: the gathered
# failure set, the bucket padding (bucket > failures), the chunking
# (bucket < failures) and the first-occurrence merge equal JAX's bit for bit.


def _assert_same(got, want):
    for field in ("angles", "fitness", "pose", "effector_error", "trace"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)


@pytest.mark.parametrize("bucket,rounds", [(3, 1), (8, 2), (64, 1), (1024, 1)])
def test_host_gather_retries_match_jax(bucket, rounds):
    from ikpso_tpu.pso.restarts import solve_with_retries as j_retries

    spec_j, batched_j = _tied_problem(s=48, seed=31)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    want = j_retries(_j_stub(spec_j, 0, 0.02), batched_j, jax.random.key(0),
                     err_threshold=THRESHOLD, max_rounds=rounds, bucket=bucket,
                     retry_solver=_j_stub(spec_j, 1, 0.03))
    got = solve_with_retries(_stub(spec, 0, 0.02), batched, torch.Generator(),
                             err_threshold=THRESHOLD, max_rounds=rounds, bucket=bucket,
                             retry_solver=_stub(spec, 1, 0.03))
    _assert_same(got, want)
    base = _stub(spec, 0, 0.02)(batched, None)
    failed = int((base.effector_error > THRESHOLD).sum())
    assert failed > bucket or bucket >= 64  # chunked, or one padded bucket
    assert bool((got.effector_error < base.effector_error).any())
    assert bool((got.effector_error <= base.effector_error).all())
    converged = (base.effector_error <= THRESHOLD).numpy()
    np.testing.assert_array_equal(got.angles.numpy()[converged],
                                  base.angles.numpy()[converged])


def test_retry_solver_is_a_noop_when_all_converged_like_jax():
    from ikpso_tpu.pso.restarts import make_retry_solver as j_make

    spec_j, batched_j = _tied_problem(s=16, seed=33)
    spec = convert.chain_spec_from(spec_j)
    want = j_make(_j_stub(spec_j, 0, 0.02), err_threshold=1e9)(batched_j, jax.random.key(1))
    calls = []

    def counted(problem, generator):
        calls.append(problem.pose.shape[0])
        return _stub(spec, 0, 0.02)(problem, generator)

    got = make_retry_solver(counted, err_threshold=1e9)(convert.problem_from(batched_j),
                                                        torch.Generator())
    _assert_same(got, want)
    assert calls == [16]  # the base solve only


def test_host_gather_padding_repeats_the_first_failed_index():
    # Two failures in a bucket of 5: the retry solver sees rows
    # [f0, f1, f0, f0, f0]; each is written once.
    spec_j, problem_j = jlib.arm_7dof()
    targets = np.full((6, 1, 3), 0.01, np.float32)
    targets[[1, 4], 0, 0] = 0.2  # err 0.004 > THRESHOLD
    batched = convert.problem_from(jlib.batched_problem(problem_j, jnp.asarray(targets)))
    spec = convert.chain_spec_from(spec_j)
    seen = []

    def retry(problem, generator):
        seen.append(problem.targets[:, 0, 0].tolist())
        return _stub(spec, 1, 0.03)(problem, generator)

    got = solve_with_retries(_stub(spec, 0, 0.02), batched, torch.Generator(),
                             err_threshold=THRESHOLD, bucket=5, retry_solver=retry)
    assert seen == [[np.float32(0.2)] * 5]
    np.testing.assert_allclose(got.effector_error.numpy()[[1, 4]], 0.01 * 0.03)


def test_topk_retry_from_best_matches_jax_replay(torch_single_thread):
    # retry_start="best": the re-solve starts at the swarm's current best
    # pose. Real scan solves on both sides with JAX's draws injected (the
    # base solve's key and the retry round's split of fold_in(key, 0x7e7)),
    # held to the replay bar of tests/test_fused.py:257-258.
    from ikpso_tpu.pso import solver as jsolver
    from ikpso_tpu.pso.config import PSOConfig as JPSO
    from ikpso_tpu_torch.pso import solver

    from test_torch_solver import _assert_replay, _case, _jax_draws

    s, p, bucket = 8, 32, 4
    spec_j, batched_j, _, _ = _case(s, np.random.default_rng(44))
    base_j, strong_j = JPSO(iterations=2), JPSO(iterations=6)
    key = jax.random.key(45)

    def j_solver(pso):
        return lambda problem, k: jsolver.solve(spec_j, problem, k, pso=pso,
                                                num_particles=p)

    want = {start: j_topk(j_solver(base_j), bucket=bucket, rounds=1,
                          err_threshold=THRESHOLD, retry_solver=j_solver(strong_j),
                          retry_start=start)(batched_j, key)
            for start in ("best", "problem")}
    _, ks = jax.random.split(jax.random.fold_in(key, 0x7e7))
    spec = convert.chain_spec_from(spec_j)

    def replayed(pso_j, k, n):
        draws = _jax_draws(k, pso_j, n, p, spec.dof)
        return lambda problem, gen: solver.solve(
            spec, problem, None, convert.pso_config_from(pso_j), num_particles=p,
            uniforms=draws)

    for start in ("best", "problem"):
        got = make_topk_retry_solver(replayed(base_j, key, s), bucket=bucket, rounds=1,
                                     err_threshold=THRESHOLD,
                                     retry_solver=replayed(strong_j, ks, bucket),
                                     retry_start=start)(convert.problem_from(batched_j),
                                                        torch.Generator())
        _assert_replay(got, want[start])
    assert not np.array_equal(np.asarray(want["best"].angles),
                              np.asarray(want["problem"].angles))
    with pytest.raises(ValueError, match="retry_start"):
        make_topk_retry_solver(replayed(base_j, key, s), retry_start="worst")
