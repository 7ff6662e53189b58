"""Kernel A's plain version and its random stream (ikpso_tpu_torch.pso.fused,
ikpso_tpu_torch.ops.philox) against the JAX megakernel.

The JAX kernel runs under the Pallas interpreter with an injected uniform
stream (the tests/test_fused.py replay pattern); the port's plain solver
replays the same numbers through its own layout. The CUDA kernel itself
runs only on the card and is checked there by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ikpso_tpu.models import library as jlib
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.ops.fitness import FitnessConfig as JFit
from ikpso_tpu.ops.pallas_fitness import _pack_meta, _pack_swarm
from ikpso_tpu.pso.config import PSOConfig as JPSO
from ikpso_tpu.pso.fused import fused_solve_raw
from ikpso_tpu.pso.polish_soa import anchor_positions_flat as j_anchor_flat
from ikpso_tpu_torch.models import convert, library
from ikpso_tpu_torch.models.chain import IKProblem, make_chain_spec
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness_plain, pack_meta, pack_swarm
from ikpso_tpu_torch.ops.philox import bits_to_uniform, philox4x32_10, philox_uniform
from ikpso_tpu_torch.pso.fused import (
    fused_solve,
    fused_solve_plain,
    make_fused_solver,
    num_draws,
)
from ikpso_tpu_torch.pso.polish_soa import anchor_positions_flat
from ikpso_tpu_torch.utils import kernels

# Replay bar of tests/test_fused.py:257-258: angles atol 5e-4, value
# rtol 1e-3 (+ atol 1e-5 for values near zero). Both sides replay the same
# draws, so only float op-order differences separate them.
ATOL_ANGLES, RTOL_VALUE, ATOL_VALUE = 5e-4, 1e-3, 1e-5
SW = 8  # JAX swarms per tile: P=128 is one 128-lane row, 8 rows fill a tile


def tpu_layout(u_port):
    """Port uniforms (S, T, D, P) -> JAX replay layout (S/8, T, D*8, 128):
    U_tpu[g, t, d*8 + j, lane] = U_port[g*8 + j, t, d, lane]."""
    s, t, d, p = u_port.shape
    return (u_port.reshape(s // SW, SW, t, d, p)
            .transpose(0, 2, 3, 1, 4).reshape(s // SW, t, d * SW, p))


def _jax_case(s, rng):
    spec_j, problem_j = jlib.arm_7dof()
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    ang = (lo + rng.random((s, spec_j.dof)) * (hi - lo)).astype(np.float32)
    pose = jfk.angles_to_pose(spec_j, jnp.broadcast_to(problem_j.pose[0], (s, 3)),
                              jnp.asarray(ang))
    targets = jfk.fk_points(spec_j, pose, problem_j.origin)[:, [3], :]
    return spec_j, jlib.batched_problem(problem_j, targets)


def _configs(iterations=8):
    pso_j = JPSO(iterations=iterations, inertia_mode="canonical", inertia=0.5,
                 inertia_end=0.2)
    fit_j = JFit(angle_weight=0.0, distance_weight=0.0)
    return pso_j, fit_j


def _packs(spec_j, batched_j, fit_j):
    anchor = jfk.pose_to_angles(spec_j, batched_j.pose)
    meta_j = _pack_meta(spec_j, fit_j, None)
    swarm_j = _pack_swarm(spec_j, batched_j, anchor, j_anchor_flat(spec_j, batched_j))
    return meta_j, swarm_j


def test_tpu_layout_adapter_maps_swarm_band_and_lane():
    # Each entry of the port layout encodes its own (s, t, d, p); the
    # adapter must land it at the JAX kernel's (tile, slot, d*8+band, lane).
    s, t, d, p = 16, 3, 9, 128
    idx = np.arange(s * t * d * p).reshape(s, t, d, p)
    tpu = tpu_layout(idx)
    assert tpu.shape == (2, t, d * SW, p)
    for (sw, tt, dd, pp) in [(0, 0, 0, 0), (9, 2, 8, 127), (7, 1, 3, 5), (12, 0, 6, 64)]:
        g, j = divmod(sw, SW)
        assert tpu[g, tt, dd * SW + j, pp] == idx[sw, tt, dd, pp]


def test_pack_matches_jax():
    # Packing is pure data movement plus one stock-trig root rotation: exact.
    rng = np.random.default_rng(0)
    spec_j, batched_j = _jax_case(8, rng)
    pso_j, fit_j = _configs()
    meta_j, swarm_j = _packs(spec_j, batched_j, fit_j)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    fit = convert.fitness_config_from(fit_j)
    meta = pack_meta(spec, fit)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched))
    np.testing.assert_array_equal(meta.numpy(), np.asarray(meta_j))
    np.testing.assert_allclose(swarm.numpy(), np.asarray(swarm_j), atol=1e-6)


def test_replay_matches_jax_interpreted_kernel():
    # The main-path configuration: P=128, I=8, canonical 0.5 -> 0.2, warm
    # init, position-only cost, S=8 swarms (one JAX tile).
    rng = np.random.default_rng(1)
    s, p = 8, 128
    spec_j, batched_j = _jax_case(s, rng)
    pso_j, fit_j = _configs()
    meta_j, swarm_j = _packs(spec_j, batched_j, fit_j)
    limits_j = jnp.stack([spec_j.min_rotation[1:].reshape(-1),
                          spec_j.max_rotation[1:].reshape(-1)])
    pso = convert.pso_config_from(pso_j)
    u = rng.random((s, num_draws(pso), spec_j.dof, p), dtype=np.float32)
    gb_j, gv_j = fused_solve_raw(
        spec_j, pso_j, fit_j, meta_j, swarm_j, limits_j,
        jnp.zeros((s, 2), jnp.int32), p, 0,
        interpret=pltpu.InterpretParams(), uniforms=jnp.asarray(tpu_layout(u)),
        swarms_per_tile=SW,
    )
    spec = convert.chain_spec_from(spec_j)
    gb, gv = fused_solve_plain(
        spec, pso, convert.fitness_config_from(fit_j),
        torch.tensor(np.asarray(meta_j)), torch.tensor(np.asarray(swarm_j)),
        spec.limits(), torch.zeros((s, 2), dtype=torch.int32), p,
        uniforms=torch.as_tensor(u),
    )
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), atol=ATOL_ANGLES)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_j), rtol=RTOL_VALUE,
                               atol=ATOL_VALUE)
    # The solve did real work: it moved every swarm off the anchor.
    assert np.all(np.abs(gb.numpy()).sum(-1) > 0.0)


def tie_case(p=32, swarms=2):
    """A solve whose final lvals tie exactly while the lbests differ.

    The last link has length 0, so the effector ignores the wrist angles
    (dims 6-8) bit for bit. Every particle moves identically in dims 0-5
    (v0 = +0.2 towards the target) and differently in dims 6-8 (distinct
    draws), so after one iteration all lvals are equal and improved, and
    the lbests differ only in dims 6-8. gbest must be particle 0's.
    """
    spec = make_chain_spec([-1, 0, 1, 2], [0.0, 1.0, 1.0, 0.0],
                           np.full((4, 3), -np.pi), np.full((4, 3), np.pi), [3])
    problem = IKProblem(pose=torch.zeros(4, 3), origin=torch.zeros(3),
                        targets=torch.zeros(1, 3))
    goal = torch.tensor([0.1] * 6 + [0.0] * 3)
    tgt = fk_ops.effector_positions(
        spec, fk_ops.angles_to_pose(spec, torch.zeros(3), goal), problem.origin)
    batched = library.batched_problem(problem, tgt[None].expand(swarms, 1, 3))
    pso = convert.pso_config_from(JPSO(iterations=1, inertia_mode="canonical"))
    fit = convert.fitness_config_from(_configs()[1])
    u = torch.full((swarms, num_draws(pso), spec.dof, p), 0.6)
    wrist = torch.linspace(0.05, 0.95, p).flip(0)  # distinct, particle 0 largest
    u[:, 0, 6:, :] = wrist
    meta = pack_meta(spec, fit)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched))
    # Particle 0's wrist angles after one step: x = 0 + w * v0, v0 = 2u - 1.
    want = np.float32(0.5) * (wrist[0].numpy() * np.float32(2) - np.float32(1))
    return spec, pso, fit, meta, swarm, u, want


def test_gbest_ties_go_to_lowest_particle_id():
    spec, pso, fit, meta, swarm, u, want = tie_case()
    s, p = swarm.shape[0], u.shape[-1]
    seeds = torch.zeros((s, 2), dtype=torch.int32)
    x = swarm[:, None, 12:21].expand(s, p, 9)  # anchor angles (MetaLayout)
    v0 = u[:, 0].transpose(1, 2) * 2.0 - 1.0
    lval = fk_fitness_plain(spec, x + 0.5 * v0, meta, swarm)
    assert torch.all(lval == lval[:, :1]), "construction must tie exactly"
    assert torch.all(lval < fk_fitness_plain(spec, x, meta, swarm))
    gb, gv = fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p,
                               uniforms=u)
    np.testing.assert_array_equal(gb[:, 6:].numpy(), np.broadcast_to(want, (s, 3)))
    np.testing.assert_array_equal(gv.numpy(), lval[:, 0].numpy())


def test_argmin_first_occurrence_on_constructed_ties():
    # The plain solver's gbest is torch.argmin, which documents the first
    # minimal index; pin that on a constructed tie row.
    vals = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0], [0.5, 0.5, 0.5, 0.5, 0.5]])
    assert torch.argmin(vals, dim=1).tolist() == [1, 0]


def test_philox_known_answer_vectors():
    # Random123 kat_vectors for philox4x32_10.
    def run(ctr, key):
        t = [torch.tensor(v, dtype=torch.int64) for v in ctr + key]
        return [int(w) for w in philox4x32_10(t[:4], t[4:])]

    assert run([0, 0, 0, 0], [0, 0]) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
               [0xA4093822, 0x299F31D0]) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_signed_shift_trap():
    # Bits with the top bit set are large unsigned values: U >= 0.5. An
    # arithmetic shift would map them below zero.
    bits = torch.tensor([-1, -2**31, -2**30, 2**31 - 1, 0, 255, 256],
                        dtype=torch.int32)
    u = bits_to_uniform(bits)
    assert torch.all(u[:3] >= 0.5) and torch.all(u < 1.0) and torch.all(u >= 0.0)
    assert u[4] == 0.0 and u[5] == 0.0 and u[6] == 2.0 ** -24
    assert u[0] == 1.0 - 2.0 ** -24


def test_philox_uniform_counter_mapping():
    # Draw of dof d, particle p, slot t = word d % 4 of
    # philox(counter=(p, t, d // 4, 0), key=(s0, s1)), seeds unsigned.
    seeds = torch.tensor([[7, -5], [0, 2**31 - 1]], dtype=torch.int32)
    u = philox_uniform(seeds, slot=3, num_particles=16, dof=9)
    assert u.shape == (2, 16, 9)
    for s, p, d in [(0, 0, 0), (0, 15, 8), (1, 4, 5), (1, 9, 3)]:
        key = [torch.tensor(int(k) & 0xFFFFFFFF) for k in seeds[s]]
        ctr = [torch.tensor(v) for v in (p, 3, d // 4, 0)]
        word = philox4x32_10(ctr, key)[d % 4]
        assert u[s, p, d] == bits_to_uniform(word)


def test_philox_uniform_is_uniform():
    # 147k draws: mean within 6 sigma of 1/2, and no sign-trap mass below 0.
    u = philox_uniform(torch.tensor([[1, 2]], dtype=torch.int32), 0, 1024, 144)
    assert abs(float(u.mean()) - 0.5) < 6 * (1 / 12 / u.numel()) ** 0.5
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_cpu_wrapper_dispatches_to_plain():
    rng = np.random.default_rng(2)
    spec, batched = library.arm_7dof()
    batched = library.batched_problem(
        batched, torch.as_tensor(rng.normal(0, 1, (4, 1, 3)), dtype=torch.float32))
    pso = convert.pso_config_from(_configs(iterations=2)[0])
    fit = convert.fitness_config_from(_configs()[1])
    meta = pack_meta(spec, fit)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched))
    seeds = torch.tensor(rng.integers(-2**31, 2**31, (4, 2)), dtype=torch.int32)
    before = fused_solve.launches
    a = fused_solve(spec, pso, fit, meta, swarm, spec.limits(), seeds, 64)
    b = fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, 64)
    assert fused_solve.launches == before  # no kernel launched on the CPU
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("kw", [
    dict(inertia_mode="randomized"),
    dict(inertia_mode="canonical", init_mode="uniform"),
    dict(inertia_mode="canonical", gbest_interval=2),
    dict(inertia_mode="canonical", rekick_interval=2),
])
def test_unported_branches_raise(kw):
    spec, _ = library.arm_7dof()
    pso = convert.pso_config_from(JPSO(iterations=4, **kw))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_fused_solver(spec, pso=pso, fit=convert.fitness_config_from(_configs()[1]),
                          num_particles=128)


def test_fused_solver_end_to_end_shapes_and_error():
    # make_fused_solver: pose carries the gbest angles, the error is the
    # row-FK true error of those angles, and the generator drives the seeds.
    spec, problem = library.arm_7dof()
    targets = torch.tensor([[[1.0, 1.2, -0.8]], [[0.5, -1.0, 1.0]], [[-1.2, 0.3, 0.9]]])
    batched = library.batched_problem(problem, targets)
    pso = convert.pso_config_from(_configs()[0])
    solver = make_fused_solver(spec, pso=pso, fit=convert.fitness_config_from(_configs()[1]),
                               num_particles=128)
    res = solver(batched, torch.Generator().manual_seed(0))
    assert res.angles.shape == (3, 9) and res.pose.shape == (3, 4, 3)
    np.testing.assert_array_equal(res.pose[:, 1:].reshape(3, 9).numpy(), res.angles.numpy())
    pos = fk_ops.effector_positions(spec, res.pose, batched.origin)
    want = torch.linalg.norm(pos - targets, dim=-1).sum(-1)
    np.testing.assert_allclose(res.effector_error.numpy(), want.numpy(), atol=1e-5)
    lim = spec.limits()
    assert torch.all(res.angles >= lim[0]) and torch.all(res.angles <= lim[1])
    again = solver(batched, torch.Generator().manual_seed(0))
    assert torch.equal(again.angles, res.angles)


def test_topology_codes_and_refusal():
    spec7, _ = library.arm_7dof()
    spec_ref, _ = library.reference_arm()
    assert kernels.topology_code(spec7) == (4, 0x2100, 0x8)
    assert kernels.topology_code(spec_ref) == (8, 0x44432100, 0xE0)
    assert kernels.topology_id(spec7) == 0 and kernels.topology_id(spec_ref) == 1
    # planar_3dof shares arm_7dof's serial 4-node topology; a 6-node
    # chain has no instantiation.
    assert kernels.topology_id(library.planar_3dof()[0]) == 0
    spec5, _ = library.serial_chain(5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.topology_id(spec5)
