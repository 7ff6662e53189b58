"""The zoo's kinematic trees in the port (dual_arm_14dof, humanoid_45dof)
against the JAX package.

(a) The models: specs, limits, weights and the humanoid's FK-built targets
    (atol 1e-6); the presets field by field.
(b) Kernels B and C's plain tile on both trees against the interpreted
    Pallas kernel (rtol 1e-6: the same polynomial trig and association,
    effector terms in node order) and against JAX's jnp fitness (rtol
    1e-5, atol 1e-6: polynomial against library trig); the tile's op
    count against the JAX model's.
(c) Kernel A's plain version against the interpreted JAX megakernel on the
    same injected uniforms, S=8 (one JAX tile), P=128, 2 iterations: the
    dual arm with hybrid init and a re-kick, the humanoid warm. Bar: the
    replay tolerances of tests/test_fused.py:257-258.
(d) ``fk_with_jacobian`` against JAX (atol 1e-5), with and without the
    orientation rows.
(e) The whole tree paths (``harness/trees.py``) on the CPU at tiny S: the
    dual arm with its preset's recipe (S=64), the humanoid (S=8) with a
    cut recipe (the full one runs 49 solves of 60 iterations at P=512).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ikpso_tpu.models import library as jlib
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.ops.fitness import FitnessConfig as JFit
from ikpso_tpu.ops.fitness import fitness as j_fitness
from ikpso_tpu.ops.jacobian import fk_with_jacobian as j_fk_jac
from ikpso_tpu.ops.pallas_fitness import _pack_meta, _pack_swarm, fused_fitness
from ikpso_tpu.pso.config import PSOConfig as JPSO
from ikpso_tpu.pso.fused import fused_solve_raw
from ikpso_tpu.pso.polish_soa import anchor_positions_flat as j_anchor_flat
from ikpso_tpu.pso.presets import FUSED_PRESETS as J_PRESETS
from ikpso_tpu.utils import flops as jflops
from ikpso_tpu_torch.harness import trees
from ikpso_tpu_torch.models import convert, library
from ikpso_tpu_torch.models.chain import make_chain_spec
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness_kernel import (
    fk_fitness,
    fused_fitness_plain,
    pack_meta,
    pack_swarm,
)
from ikpso_tpu_torch.ops.jacobian import fk_with_jacobian
from ikpso_tpu_torch.pso.fused import fused_solve_plain, make_fused_solver, num_draws
from ikpso_tpu_torch.pso.polish_soa import anchor_positions_flat
from ikpso_tpu_torch.pso.presets import FUSED_PRESETS
from ikpso_tpu_torch.utils import flops, kernels

from test_torch_fused import (  # noqa: F401 (torch_single_thread: a fixture)
    ATOL_ANGLES, ATOL_VALUE, RTOL_VALUE, SW, torch_single_thread, tpu_layout)

TREES = ("dual_arm_14dof", "humanoid_45dof")
CANONICAL = dict(inertia_mode="canonical", inertia=0.5, inertia_end=0.2)


def _jax_case(name, s, rng):
    """A batched JAX problem with reachable targets (FK of random in-limit
    angles, bench.py:94-105)."""
    spec_j, problem_j = getattr(jlib, name)()
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    ang = (lo + rng.random((s, spec_j.dof)) * (hi - lo)).astype(np.float32)
    pose = jfk.angles_to_pose(spec_j, jnp.broadcast_to(problem_j.pose[0], (s, 3)),
                              jnp.asarray(ang))
    targets = jfk.fk_points(spec_j, pose, problem_j.origin)[:, list(spec_j.effector_idx)]
    return spec_j, jlib.batched_problem(problem_j, targets)


def _jax_packs(spec_j, batched_j, fit_j):
    anchor = jfk.pose_to_angles(spec_j, batched_j.pose)
    return (_pack_meta(spec_j, fit_j, None),
            _pack_swarm(spec_j, batched_j, anchor, j_anchor_flat(spec_j, batched_j)))


@pytest.mark.parametrize("name", TREES)
def test_tree_models_match_jax(name):
    spec_j, problem_j = getattr(jlib, name)()
    spec, problem = getattr(library, name)()
    assert list(spec.parent) == list(spec_j.parent)
    assert list(spec.effector_idx) == list(spec_j.effector_idx)
    for field in ("length", "min_rotation", "max_rotation", "effector_weight"):
        np.testing.assert_array_equal(getattr(spec, field).numpy(),
                                      np.asarray(getattr(spec_j, field)), err_msg=field)
    np.testing.assert_array_equal(problem.pose.numpy(), np.asarray(problem_j.pose))
    np.testing.assert_array_equal(problem.origin.numpy(), np.asarray(problem_j.origin))
    # The humanoid's targets are the port's own FK of the bent pose.
    np.testing.assert_allclose(problem.targets.numpy(), np.asarray(problem_j.targets),
                               atol=1e-6)
    assert spec.dof == {"dual_arm_14dof": 18, "humanoid_45dof": 45}[name]


def test_tree_presets_match_jax_field_by_field():
    for name, pre in FUSED_PRESETS.items():
        want = dataclasses.asdict(J_PRESETS[name])
        want.pop("swarms_per_tile")  # a TPU tiling knob, not ported
        assert dataclasses.asdict(pre) == want, name
    assert set(TREES) <= set(FUSED_PRESETS)


@pytest.mark.parametrize("name", TREES)
def test_tree_tile_matches_pallas_kernel_and_jnp_fitness(name):
    rng = np.random.default_rng(70)
    s, p = 2, 1024
    spec_j, batched_j = _jax_case(name, s, rng)
    # Anchors away from zero so the locality term counts.
    batched_j = batched_j.replace(pose=batched_j.pose.at[:, 1:].set(0.2))
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    x = (lo + rng.random((s, p, spec_j.dof)) * (hi - lo)).astype(np.float32)
    fit_j = JFit(angle_weight=2.0, distance_weight=0.0)
    meta_j, swarm_j = _jax_packs(spec_j, batched_j, fit_j)
    x_dp = np.ascontiguousarray(np.swapaxes(x, -1, -2))
    want = np.asarray(fused_fitness(spec_j, jnp.asarray(x_dp), meta_j, swarm_j,
                                    interpret=pltpu.InterpretParams()))
    spec = convert.chain_spec_from(spec_j)
    meta, swarm = torch.tensor(np.asarray(meta_j)), torch.tensor(np.asarray(swarm_j))
    before = fk_fitness.launches
    got = fk_fitness(spec, torch.as_tensor(x), meta, swarm)
    assert fk_fitness.launches == before  # a CPU tensor runs the plain twin
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        fused_fitness_plain(spec, torch.as_tensor(x_dp), meta, swarm).numpy(), got.numpy())
    oracle = np.asarray(j_fitness(spec_j, jnp.asarray(x), batched_j, config=fit_j))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-6)
    # The op model counts this tile as the JAX model counts the Pallas one.
    want_ops = jflops.fitness_tile_count(spec_j, JFit(angle_weight=0.0,
                                                      distance_weight=0.0))
    got_ops = flops.fitness_tile_count(spec, convert.fitness_config_from(fit_j))
    assert got_ops.flops == pytest.approx(want_ops.flops, abs=1e-6)


# Kernel A replay configurations per tree: the dual arm's preset shape
# (hybrid retry init, re-kick; here every iteration) and the humanoid's.
REPLAY = {
    "dual_arm_14dof": dict(CANONICAL, init_mode="hybrid", rekick_interval=1,
                           rekick_scale=0.5, rekick_threshold=1e-6),
    "humanoid_45dof": dict(CANONICAL, init_mode="warm"),
}


@pytest.mark.parametrize("name", TREES)
def test_tree_replay_matches_jax_interpreted_kernel(name):
    rng = np.random.default_rng(71)
    s, p = SW, 128
    spec_j, batched_j = _jax_case(name, s, rng)
    pso_j = JPSO(iterations=2, **REPLAY[name])
    fit_j = JFit(angle_weight=0.0, distance_weight=0.0)
    meta_j, swarm_j = _jax_packs(spec_j, batched_j, fit_j)
    pso = convert.pso_config_from(pso_j)
    u = rng.random((s, num_draws(pso), spec_j.dof, p), dtype=np.float32)
    limits_j = jnp.stack([spec_j.min_rotation[1:].reshape(-1),
                          spec_j.max_rotation[1:].reshape(-1)])
    gb_j, gv_j = fused_solve_raw(
        spec_j, pso_j, fit_j, meta_j, swarm_j, limits_j, jnp.zeros((s, 2), jnp.int32),
        p, 0, interpret=pltpu.InterpretParams(), uniforms=jnp.asarray(tpu_layout(u)),
        swarms_per_tile=SW)
    spec = convert.chain_spec_from(spec_j)
    kicks = []
    gb, gv = fused_solve_plain(
        spec, pso, convert.fitness_config_from(fit_j), torch.tensor(np.asarray(meta_j)),
        torch.tensor(np.asarray(swarm_j)), spec.limits(), torch.zeros((s, 2), dtype=torch.int32),
        p, uniforms=torch.as_tensor(u), on_kick=lambda k: kicks.append(int(k.sum())))
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), atol=ATOL_ANGLES)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_j), rtol=RTOL_VALUE,
                               atol=ATOL_VALUE)
    assert kicks == ([s] if pso.rekick_interval else [])
    assert np.all(np.abs(gb.numpy()).sum(-1) > 0.0)


@pytest.mark.parametrize("name,orientation", [
    ("dual_arm_14dof", False), ("humanoid_45dof", False), ("humanoid_45dof", True),
    ("arm_6dof", True),
])
def test_fk_with_jacobian_matches_jax(name, orientation):
    rng = np.random.default_rng(72)
    spec_j, batched_j = _jax_case(name, 16, rng)
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    ang = (lo + rng.random((16, spec_j.dof)) * (hi - lo)).astype(np.float32)
    pose_j = jfk.angles_to_pose(spec_j, batched_j.pose[:, 0], jnp.asarray(ang))
    want = j_fk_jac(spec_j, pose_j, batched_j.origin, orientation=orientation)
    spec = convert.chain_spec_from(spec_j)
    got = fk_with_jacobian(spec, torch.tensor(np.asarray(pose_j)),
                           torch.tensor(np.asarray(batched_j.origin)),
                           orientation=orientation)
    m = 3 * spec.num_effectors * (2 if orientation else 1)
    assert tuple(got[2].shape) == (16, m, spec.dof)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_kernel_particle_bound_follows_the_topology():
    # Kernel A's humanoid instantiation is bounded at 512 threads a block,
    # reference_arm's and snake_30dof's at 256; a 21-node serial chain runs
    # the serial-chain variant (1024), and a tree with no prebuilt kernel is
    # built on demand, bounded as its DOFs choose (1024 up to 18).
    spec, problem = library.humanoid_45dof()
    assert kernels.max_particles(spec) == 512
    assert kernels.max_particles(library.dual_arm_14dof()[0]) == 1024
    assert kernels.max_particles(library.reference_arm()[0]) == 256
    assert kernels.max_particles(library.snake_30dof()[0]) == 256
    spec20 = library.serial_chain(20)[0]
    assert kernels.topology_id(spec20) == kernels.SERIAL
    assert kernels.max_particles(spec20) == 1024
    tree = make_chain_spec([-1, 0, 1, 1], [0.0, 1.0, 1.0, 1.0], np.zeros((4, 3)),
                           np.zeros((4, 3)), [2, 3])
    assert kernels.topology_id(tree) == kernels.ON_DEMAND
    assert kernels.max_particles(tree) == 1024
    pre, pso, fit = trees.tree_configs("humanoid_45dof")
    batched = library.batched_problem(problem, problem.targets[None])
    with pytest.raises(ValueError, match="512"):
        make_fused_solver(spec, pso=dataclasses.replace(pso, iterations=1),
                          fit=fit, num_particles=1024, device="cpu")(
            batched, torch.Generator().manual_seed(0))


@pytest.mark.usefixtures("torch_single_thread")
def test_dual_arm_path_on_cpu():
    out = trees.run_tree("dual_arm_14dof", swarms=64, device="cpu", warmup=0, iters=1)
    assert out["finite"] and out["device"] == "cpu"
    assert out["recipe"] == dict(particles=1024, iterations=8, rekick_interval=4,
                                 polish=4, retries=4, retry_bucket=8,
                                 retry_init_mode="hybrid", retry_walk=0)
    assert out["p50_err_mm"] < 1.0 and out["frac_under_1mm"] >= 0.95
    assert out["failures_ge_1mm"] == round((1 - out["frac_under_1mm"]) * 64)


@pytest.mark.usefixtures("torch_single_thread")
def test_humanoid_path_on_cpu_with_a_cut_recipe(monkeypatch):
    # The walk retries and the tensor polish on a cut recipe: 128 particles,
    # 20 iterations, the preset's 6 LM steps, 2 rounds of 4-step walks.
    # Observed on an 8-core CPU: 3.5 s, p50 0.00046 mm, all 8 under 1 mm.
    full = FUSED_PRESETS["humanoid_45dof"]
    cut = dataclasses.replace(full, particles=128, iterations=20, retry_iterations=20,
                              retries=2, retry_walk=4)
    monkeypatch.setattr(trees, "fused_preset", lambda model: cut)
    calls = []
    real = trees.wrap_with_topk_retries
    monkeypatch.setattr(trees, "wrap_with_topk_retries",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    out = trees.run_tree("humanoid_45dof", swarms=8, device="cpu", warmup=0, iters=1)
    assert calls[0]["retry_walk_steps"] == 4 and calls[0]["spec"] is not None
    assert out["finite"] and out["recipe"]["retry_walk"] == 4
    assert out["recipe"]["retry_init_mode"] is None
    assert out["p50_err_mm"] < 1.0 and out["frac_under_1mm"] >= 0.875


def test_tree_path_refuses_absent_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        trees.run_tree("dual_arm_14dof", swarms=8, device="cuda")
    # Any preset model and snake:<links> run; other names do not.
    for name in ("no_such_model", "snake:0", "snake:ten"):
        with pytest.raises(ValueError, match="unknown model"):
            trees.tree_configs(name)


def test_kick_count_from_final_values_matches_the_full_replay(monkeypatch):
    # flops.fused_solve_kicks with the launch's final values replays only
    # the swarms that end at or under the threshold; the count must equal
    # the full replay's, here with swarms on both sides of a threshold of 1.0.
    rng = np.random.default_rng(73)
    spec, problem = library.dual_arm_14dof()
    pre, pso, fit = trees.tree_configs("dual_arm_14dof")
    pso = dataclasses.replace(pso, rekick_interval=2, rekick_threshold=1.0)
    s, p = 24, 64
    lo, hi = spec.limits().numpy()
    ang = torch.as_tensor((lo + rng.random((s, spec.dof)) * (hi - lo)).astype(np.float32))
    pose = fk_ops.angles_to_pose(spec, problem.pose[0].expand(s, 3), ang)
    batched = library.batched_problem(problem, fk_ops.fk_points(
        spec, pose, problem.origin)[:, list(spec.effector_idx)])
    meta = pack_meta(spec, fit)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched))
    seeds = torch.as_tensor(rng.integers(-2**31, 2**31, (s, 2)), dtype=torch.int32)
    args = (spec, pso, fit, meta, swarm, spec.limits(), seeds, p)
    _, gval = fused_solve_plain(*args)
    above = int((gval > 1.0).sum())
    assert 0 < above < s
    full = flops.fused_solve_kicks(*args)
    monkeypatch.setattr(flops, "KICK_CHUNK", 5)  # several replay chunks
    assert flops.fused_solve_kicks(*args, gval=gval) == full
    assert 0 < full < 3 * s
