"""The rest of the model zoo in the port (planar_3dof, reference_arm,
snake_30dof, snake:<links>) against the JAX package.

(a) The models and presets field by field (atol 1e-6), ``snake:<links>``
    included.
(b) The plain tile on ``snake_30dof``, ``snake:20`` and ``snake:50``
    against the interpreted Pallas ``fused_fitness`` (rtol 1e-6 at 11
    nodes, growing with the nodes: see the test) and JAX's jnp fitness
    (rtol 1e-5, atol 1e-6).
(c) Kernel A's plain version against the interpreted JAX megakernel on
    the same injected uniforms, S=8, P=128, 2 iterations: ``snake_30dof``
    with the re-kick, ``snake:20`` with hybrid init, and ``snake:43``
    (D=129, past JAX's one-row output). Bar: the replay tolerances of
    tests/test_fused.py:257-258.
(d) The kernels' routing: compile-time topologies where one exists, the
    serial-chain variant for any other serial chain, a refusal for the
    rest; kernel A's particle bound per topology.
(e) The four paths through ``harness/trees.py`` on the CPU at tiny S.
(f) planar_3dof's frozen axes stay at 0 under uniform-init retries.

The reference_arm path's accuracy bar comes from JAX's scan solver with
the same recipe; :func:`reference_arm_bar` computes it (run this file as
a script, see :func:`main`).
"""

import dataclasses
import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ikpso_tpu.models import library as jlib
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.ops.fitness import FitnessConfig as JFit
from ikpso_tpu.ops.fitness import fitness as j_fitness
from ikpso_tpu.ops.pallas_fitness import _pack_meta, _pack_swarm, fused_fitness
from ikpso_tpu.pso.config import PSOConfig as JPSO
from ikpso_tpu.pso.fused import fused_solve_raw
from ikpso_tpu.pso.polish_soa import anchor_positions_flat as j_anchor_flat
from ikpso_tpu.pso.presets import FUSED_PRESETS as J_PRESETS
from ikpso_tpu.pso.presets import fused_preset as j_fused_preset
from ikpso_tpu.utils import flops as jflops
from ikpso_tpu_torch.harness import trees
from ikpso_tpu_torch.models import convert, library
from ikpso_tpu_torch.models.chain import make_chain_spec
from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness, fused_fitness_plain
from ikpso_tpu_torch.pso.fused import fused_solve_plain, make_fused_solver, num_draws
from ikpso_tpu_torch.pso.presets import fused_preset
from ikpso_tpu_torch.utils import flops, kernels

from test_torch_fused import (  # noqa: F401 (torch_single_thread: a fixture)
    ATOL_ANGLES, ATOL_VALUE, RTOL_VALUE, SW, torch_single_thread, tpu_layout)

ZOO = ("planar_3dof", "reference_arm", "snake_30dof", "snake:16", "snake:50")
CANONICAL = dict(inertia_mode="canonical", inertia=0.5, inertia_end=0.2)


def _jax_model(name):
    if name.startswith("snake:"):
        return jlib.snake(int(name.split(":")[1]))
    return getattr(jlib, name)()


def _jax_case(name, s, rng):
    """A batched JAX problem with reachable targets (FK of random in-limit
    angles, bench.py:94-105)."""
    spec_j, problem_j = _jax_model(name)
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


# (a) The models and presets.


@pytest.mark.parametrize("name", ZOO)
def test_zoo_models_match_jax(name):
    spec_j, problem_j = _jax_model(name)
    spec, problem = trees.model_spec(name)
    assert list(spec.parent) == list(spec_j.parent)
    assert list(spec.effector_idx) == list(spec_j.effector_idx)
    for field in ("length", "min_rotation", "max_rotation", "effector_weight"):
        np.testing.assert_allclose(getattr(spec, field).numpy(),
                                   np.asarray(getattr(spec_j, field)), atol=1e-6,
                                   err_msg=field)
    for field in ("pose", "origin", "targets"):
        np.testing.assert_allclose(getattr(problem, field).numpy(),
                                   np.asarray(getattr(problem_j, field)), atol=1e-6,
                                   err_msg=field)
    assert problem.target_rot is None and problem_j.target_rot is None


def test_reference_reset_targets_match_jax():
    np.testing.assert_allclose(library.reference_reset_targets().numpy(),
                               np.asarray(jlib.reference_reset_targets()), atol=1e-6)


@pytest.mark.parametrize("name", ["planar_3dof", "reference_arm", "snake_30dof",
                                  "snake:43", "snake:50"])
def test_zoo_presets_match_jax_field_by_field(name):
    want = dataclasses.asdict(j_fused_preset(name))
    want.pop("swarms_per_tile")  # a TPU tiling knob, not ported
    assert dataclasses.asdict(fused_preset(name)) == want
    assert fused_preset(name) is not None and j_fused_preset(name) == J_PRESETS[
        "snake_30dof" if name.startswith("snake:") else name]


# (b) The plain tile against the interpreted Pallas kernel and JAX's fitness.


@pytest.mark.parametrize("name", ["snake_30dof", "snake:20", "snake:50"])
def test_zoo_tile_matches_pallas_kernel_and_jnp_fitness(name):
    rng = np.random.default_rng(80)
    s, p = 2, 1024
    spec_j, batched_j = _jax_case(name, s, rng)
    # Anchors away from the pose so the locality term counts.
    batched_j = batched_j.replace(pose=batched_j.pose.at[:, 1:].set(0.2))
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    x = (lo + rng.random((s, p, spec_j.dof)) * (hi - lo)).astype(np.float32)
    fit_j = JFit(angle_weight=2.0, distance_weight=0.0)
    meta_j, swarm_j = _jax_packs(spec_j, batched_j, fit_j)
    x_dp = np.ascontiguousarray(np.swapaxes(x, -1, -2))
    want = np.asarray(fused_fitness(spec_j, jnp.asarray(x_dp), meta_j, swarm_j,
                                    interpret=True))
    spec = convert.chain_spec_from(spec_j)
    meta, swarm = torch.tensor(np.asarray(meta_j)), torch.tensor(np.asarray(swarm_j))
    before = fk_fitness.launches
    got = fk_fitness(spec, torch.as_tensor(x), meta, swarm)
    assert fk_fitness.launches == before  # a CPU tensor runs the plain twin
    # XLA's CPU code for the interpreted kernel does not round op by op
    # (only 10-25% of these values agree to the bit, against 100% between
    # the port's CUDA kernel and this tile on the card), and float32
    # rounding compounds along the chain's composes: both it and this tile
    # sit 0.5-2.3e-6 from the same tile in float64 at 11-51 nodes. So the
    # bar is rtol 1e-6 at snake_30dof's 11 nodes, growing with the nodes;
    # the same bar holds this tile to its float64 evaluation.
    rtol = 1e-6 * spec.num_nodes / 11
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    exact = fk_fitness(spec, torch.as_tensor(x).double(), meta.double(), swarm.double())
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=rtol, atol=0)
    np.testing.assert_array_equal(
        fused_fitness_plain(spec, torch.as_tensor(x_dp), meta, swarm).numpy(), got.numpy())
    oracle = np.asarray(j_fitness(spec_j, jnp.asarray(x), batched_j, config=fit_j))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-6)
    # The op model counts this tile as the JAX model counts the Pallas one.
    want_ops = jflops.fitness_tile_count(spec_j, JFit(angle_weight=0.0,
                                                      distance_weight=0.0))
    got_ops = flops.fitness_tile_count(spec, convert.fitness_config_from(fit_j))
    assert got_ops.flops == pytest.approx(want_ops.flops, abs=1e-6)


# (c) Kernel A's plain version against the interpreted JAX megakernel.
# snake_30dof with a re-kick every iteration above a threshold, snake:20
# with hybrid init, snake:43 (D=129: two 128-lane output rows in JAX), and
# reference_arm at its preset's update and fitness (warm init, canonical
# inertia, no re-kick; position only, no distance term): the instantiation
# its path runs, which tests/test_torch_fused_host.py holds bit for bit to
# this plain version.
REPLAY = {
    "reference_arm": dict(CANONICAL, init_mode="warm", rekick_scale=0.5,
                          rekick_threshold=1e-6),
    "snake_30dof": dict(CANONICAL, init_mode="warm", rekick_interval=1, rekick_scale=0.5,
                        rekick_threshold=1e-6),
    "snake:20": dict(CANONICAL, init_mode="hybrid"),
    "snake:43": dict(CANONICAL, init_mode="uniform"),
}


@pytest.mark.parametrize("name", list(REPLAY))
def test_zoo_replay_matches_jax_interpreted_kernel(name):
    rng = np.random.default_rng(81)
    s, p = SW, 128
    spec_j, batched_j = _jax_case(name, s, rng)
    pso_j = JPSO(iterations=2, **REPLAY[name])
    fit_j = JFit(angle_weight=0.0, distance_weight=0.0)
    meta_j, swarm_j = _jax_packs(spec_j, batched_j, fit_j)
    pso = convert.pso_config_from(pso_j)
    if name == "reference_arm":  # the preset's base solve, cut to 2 iterations
        _, pso_pre, fit_pre = trees.tree_configs(name)
        assert pso == dataclasses.replace(pso_pre, iterations=2)
        assert convert.fitness_config_from(fit_j) == fit_pre
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
        torch.tensor(np.asarray(swarm_j)), spec.limits(),
        torch.zeros((s, 2), dtype=torch.int32), p, uniforms=torch.as_tensor(u),
        on_kick=lambda k: kicks.append(int(k.sum())))
    assert gb.shape == (s, spec.dof) and gb_j.shape == (s, spec.dof)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), atol=ATOL_ANGLES)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_j), rtol=RTOL_VALUE,
                               atol=ATOL_VALUE)
    assert kicks == ([s] if pso.rekick_interval else [])


# (d) The kernels' routing.


def test_zoo_routing_and_particle_bounds():
    planar, ref = library.planar_3dof()[0], library.reference_arm()[0]
    snake30 = library.snake_30dof()[0]
    # planar_3dof runs on arm_7dof's topology with its own limits.
    assert kernels.topology_code(planar) == (4, 0x2100, 0x8)
    assert kernels.topology_id(planar) == 0 and kernels.max_particles(planar) == 1024
    assert kernels.topology_id(ref) == 1 and kernels.max_particles(ref) == 256
    assert kernels.topology_code(snake30) == (11, 0x98765432100, 0x400)
    assert kernels.topology_id(snake30) == 5 and kernels.max_particles(snake30) == 256
    # Every other serial chain runs the serial-chain variant, past 16 nodes too.
    for links in (1, 5, 15, 16, 20, 50):
        spec = library.snake(links)[0]
        assert kernels.topology_id(spec) == kernels.SERIAL, links
        assert kernels.kernel_variant(spec, 0, "box", False) == (kernels.SERIAL, 0, 0)
        assert kernels.max_particles(spec) == 1024
    assert kernels.topology_code(library.snake(16)[0]) == (17, None, 1 << 16)
    # Not serial: the effector is not the last node, or a node hangs off
    # another than its predecessor; past 16 nodes that is any tree. Each is
    # built on demand, its 48 DOFs in kernel A's scratch layout at a
    # 512-particle bound; the tree that branches has the cluster layout
    # beside it, the chain does not.
    n = 17
    lim = np.zeros((n, 3), np.float32)
    chain = list(range(-1, n - 1))
    for parents, effectors, branched in ((chain, [n - 2], False),
                                         (chain[:-1] + [0], [n - 1], True)):
        tree = make_chain_spec(parents, [0.0] + [1.0] * (n - 1), lim, lim, effectors)
        assert not kernels.is_serial(tree)
        assert kernels.topology_id(tree) == kernels.ON_DEMAND
        assert kernels.max_particles(tree) == 512
        assert kernels.on_demand_key(tree, 0, False).scratch
        assert kernels.on_demand_key(tree, 0, False).cluster == branched
    # A serial chain with a scene or an orientation term is built on demand,
    # at its prebuilt topology's bound.
    for n_obs, orient in ((2, False), (0, True)):
        assert kernels.kernel_variant(snake30, n_obs, "box", orient) == (
            kernels.ON_DEMAND, 1 if n_obs else 0, int(orient))
        assert kernels.max_particles(snake30, n_obs, "box", orient) == 256


def test_zoo_particle_bound_is_refused_in_python():
    # reference_arm's kernel A is bounded at 256 threads a block.
    spec, problem = library.reference_arm()
    pre, pso, fit = trees.tree_configs("reference_arm")
    batched = library.batched_problem(problem, problem.targets[None])
    with pytest.raises(ValueError, match="256"):
        make_fused_solver(spec, pso=dataclasses.replace(pso, iterations=1), fit=fit,
                          num_particles=512, device="cpu")(
            batched, torch.Generator().manual_seed(0))


def test_zoo_solve_counts_follow_the_chain():
    # snake:50's kernel A work per particle-evaluation (tile, update, Philox
    # and argmin) against the same count of snake:10 and of snake:20: the
    # tile grows with the nodes, the update and the Philox calls with D.
    pre, pso, fit = trees.tree_configs("snake:50")
    per_eval = {}
    for links in (10, 20, 50):
        spec = library.snake(links)[0]
        c = flops.fused_solve_count(spec, pso, fit, num_particles=256, num_swarms=64)
        per_eval[links] = c.ops / (64 * 256 * (pso.iterations + 1))
        assert c.bytes == pytest.approx(4.0 * (
            (2 + links + 1) + 64 * (12 + 3 * links + 3 + 3 * links) + 2 * 3 * links
            + pso.iterations + 2 * 64 + 64 * (3 * links + 1)))
    assert 15_000 < per_eval[50] < 16_500
    assert per_eval[10] < per_eval[20] < per_eval[50]
    assert per_eval[50] / per_eval[10] == pytest.approx(5.0, rel=0.1)


# (e) The four paths on the CPU at tiny S.


@pytest.mark.usefixtures("torch_single_thread")
@pytest.mark.parametrize("name,swarms", [("planar_3dof", 64), ("snake_30dof", 32),
                                         ("snake:50", 16)])
def test_zoo_path_on_cpu(name, swarms):
    pre = fused_preset(name)
    out = trees.run_tree(name, swarms=swarms, device="cpu", warmup=0, iters=1)
    assert out["finite"] and out["device"] == "cpu" and out["model"] == name
    bucket = max(1, swarms // 8)  # bench.py's S/8 cap at small S
    assert out["recipe"] == dict(particles=pre.particles, iterations=pre.iterations,
                                 rekick_interval=pre.rekick_interval, polish=4, retries=2,
                                 retry_bucket=bucket, retry_init_mode=pre.retry_init_mode,
                                 retry_walk=0)
    assert out["p50_err_mm"] < 1.0 and out["frac_under_1mm"] >= 0.9
    assert out["failures_ge_1mm"] == round((1 - out["frac_under_1mm"]) * swarms)


@pytest.mark.usefixtures("torch_single_thread")
def test_reference_arm_path_on_cpu_with_a_cut_recipe(monkeypatch):
    # The preset's 100 iterations cut to 25 (256 particles, no polish, no
    # retries, as the preset): single-shot far targets, so the error stays
    # at hundreds of mm, as JAX's (p50 460 mm at 100 iterations).
    cut = dataclasses.replace(fused_preset("reference_arm"), iterations=25)
    monkeypatch.setattr(trees, "fused_preset", lambda model: cut)
    calls = []
    real = trees.wrap_with_polish
    monkeypatch.setattr(trees, "wrap_with_polish",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    out = trees.run_tree("reference_arm", swarms=16, device="cpu", warmup=0, iters=1)
    assert not calls  # polish 0: no polish stage, as bench.py
    assert out["finite"] and out["recipe"]["iterations"] == 25
    assert out["recipe"]["retries"] == 0 and out["recipe"]["particles"] == 256
    assert 10.0 < out["p50_err_mm"] < 5000.0


# (f) planar_3dof's frozen axes.


@pytest.mark.usefixtures("torch_single_thread")
def test_planar_frozen_axes_stay_zero_under_uniform_retries():
    # Only Z turns (lo = hi = 0 on X and Y): the uniform init draws
    # lo + u (hi - lo) = 0 there, the clamp keeps 0, and the polish pins
    # the locked dims; so every returned angle on X and Y is exactly 0.
    spec, batched = trees.tree_problem("planar_3dof", 64, "cpu", seed=3)
    pre, pso, fit = trees.tree_configs("planar_3dof")
    frozen = [d for d in range(spec.dof) if d % 3 != 2]
    gen = torch.Generator().manual_seed(4)
    uniform = make_fused_solver(spec, pso=dataclasses.replace(pso, init_mode="uniform"),
                                fit=fit, num_particles=pre.particles, device="cpu")
    res = uniform(batched, gen)
    assert torch.all(res.angles[:, frozen] == 0.0)
    assert torch.all(res.angles[:, 2::3] != 0.0)
    full = trees.build_tree_solver("planar_3dof", spec, 64, "cpu")(batched, gen)
    assert torch.all(full.angles[:, frozen] == 0.0)
    assert torch.all(full.pose[:, 1:, :2] == 0.0)


# The reference_arm path's accuracy bar (chip_smoke.py's constants).


def test_order_statistic_interval():
    # n = 1024: the 99% interval of the median spans ranks 471-554, of the
    # 90th percentile 896-947; each tail holds at most 0.5%.
    assert order_statistic_interval(1024, 0.5, 0.99) == (471, 554)
    assert order_statistic_interval(1024, 0.9, 0.99) == (896, 947)
    lo, hi = order_statistic_interval(100, 0.5, 0.95)
    assert (lo, hi) == (40, 61)


def order_statistic_interval(n: int, q: float, conf: float):
    """1-based ranks ``(lo, hi)`` of the order statistics that bound the
    ``q`` quantile of a continuous distribution with probability at least
    ``conf`` in a sample of ``n``: the distribution-free interval, equal
    tails, from the binomial(n, q) law of the count below the quantile."""
    tail = (1.0 - conf) / 2.0
    cdf, acc = [], 0.0
    for k in range(n + 1):
        acc += math.comb(n, k) * q ** k * (1.0 - q) ** (n - k)
        cdf.append(acc)  # P(count <= k)
    # X_(lo) <= quantile unless the count below it is < lo: P = cdf[lo - 1].
    lo = max(k for k in range(1, n + 1) if cdf[k - 1] <= tail)
    # X_(hi) >= quantile unless the count below it is >= hi: P = 1 - cdf[hi - 1].
    hi = min(k for k in range(1, n + 1) if 1.0 - cdf[k - 1] <= tail)
    return lo, hi


# The reference_arm bar: JAX's bench.py with the port's recipe on the scan
# solver (the fused kernel's in-kernel PRNG has no CPU lowering).
REFERENCE_ARM_BENCH_ARGS = (
    "--cpu", "--impl", "jnp", "--model", "reference_arm", "--inertia-mode",
    "canonical", "--particles", "256", "--iterations", "100", "--polish", "0",
    "--retries", "0", "--swarms", "1024", "--no-sol",
)


def reference_arm_bar(conf: float = 0.99) -> dict:
    """Run ``python bench.py`` with :data:`REFERENCE_ARM_BENCH_ARGS` and
    return its p50 and p90 effector errors (mm) with their ``conf``
    distribution-free intervals from the order statistics of its errors.
    The errors are bench.py's own last timed solve, taken from its call
    of ``ikpso_tpu.utils.profiling.measure``."""
    import bench
    from ikpso_tpu.utils import profiling

    seen = []
    real = profiling.measure

    def recording(*args, **kw):
        res, wall = real(*args, **kw)
        seen.append(res)
        return res, wall

    argv = sys.argv
    profiling.measure = recording
    sys.argv = ["bench.py", *REFERENCE_ARM_BENCH_ARGS]
    try:
        bench.main()
    finally:
        profiling.measure, sys.argv = real, argv
    err = np.sort(np.asarray(seen[-1].effector_error) * 1000.0).astype(np.float64)
    out = {"swarms": int(err.size), "conf": conf}
    for q in (0.5, 0.9):
        lo, hi = order_statistic_interval(err.size, q, conf)
        out[f"p{round(q * 100)}_err_mm"] = float(np.percentile(err, q * 100))
        out[f"p{round(q * 100)}_interval_mm"] = (float(err[lo - 1]), float(err[hi - 1]))
        out[f"p{round(q * 100)}_ranks"] = (lo, hi)
    return out


def main() -> None:
    """``JAX_PLATFORMS=cpu python tests/test_torch_zoo.py``: print the
    reference_arm bar as one JSON line (~100 s on an 8-core CPU)."""
    import json
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    print(json.dumps(reference_arm_bar()), flush=True)


if __name__ == "__main__":
    main()
