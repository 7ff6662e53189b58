"""Top-k retries of the port (ikpso_tpu_torch.pso.restarts) against the
JAX package.

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wrap_with_topk_retries(build, pso, rounds=1, bucket=8, retry_walk_steps=4)
