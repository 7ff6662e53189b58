"""The branches kernels A, B and C take since this slice, against the JAX
package: the distance term, exact trig, and any tree or combination built
on demand.

(a) Kernel B's plain twin (``fk_fitness_plain``, what the CUDA tile is held
    to bit for bit on the card) against the interpreted Pallas tile
    (``fused_fitness(..., interpret=...)``): the distance term on
    ``arm_7dof`` and ``hand21`` and exact trig on ``arm_7dof``,
    ``dual_arm_14dof`` with a box scene (equal masks) and with orientation,
    each at four seeds, at a bar derived from float32 rounding
    (``tile_rtol``: k * 2^-24 or the zoo's 1e-6 x nodes / 11, the larger;
    atol 0; the same bar holds the tile to its own float64 evaluation);
    poly against exact at rtol 1e-5, atol 1e-5 (tests/test_pallas.py:167-182);
    and each against JAX's jnp ``fitness`` at rtol 1e-5.
(b) Kernel A's plain twin against ``fused_solve_raw(..., interpret=...,
    uniforms=U)`` at the replay bars (atol 5e-4 on angles, rtol 1e-3 on
    values): the distance term on ``reference_arm`` (weights 3.0 / 0.7, as
    tests/test_fused.py:55-76), exact trig, ``dual_arm_box`` and ``hand21``
    (S=8, P=128, 2 iterations).
(c) The routing: ids, variants and particle bounds of trees that used to
    raise, on-demand keys and their library names, and the generated source
    compiled with g++ against a stand-in CUDA runtime (skipped where g++ is
    absent).
(d) The op model's counts of the two new branches.
"""

import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ikpso_tpu.models import library as jlib
from ikpso_tpu.models.chain import Obstacles as JObstacles
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.ops.fitness import FitnessConfig as JFit
from ikpso_tpu.ops.fitness import fitness as j_fitness
from ikpso_tpu.ops.pallas_fitness import _pack_meta, _pack_swarm, fused_fitness
from ikpso_tpu.pso.config import PSOConfig as JPSO
from ikpso_tpu.pso.fused import fused_solve_raw
from ikpso_tpu.pso.polish_soa import anchor_positions_flat as j_anchor_flat
from ikpso_tpu.utils import configio as jconfigio
from ikpso_tpu_torch.models import convert, library
from ikpso_tpu_torch.models.chain import make_chain_spec
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.fitness_kernel import (
    fk_fitness,
    fk_fitness_plain,
    fused_fitness_plain,
    pack_meta,
    pack_swarm,
)
from ikpso_tpu_torch.pso.fused import fused_solve_plain, make_fused_solver, num_draws
from ikpso_tpu_torch.utils import flops, kernels

from test_torch_fused import (  # noqa: F401 (torch_single_thread: a fixture)
    ATOL_ANGLES, ATOL_VALUE, RTOL_VALUE, SW, torch_single_thread, tpu_layout)

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = ROOT / "ikpso_tpu_torch" / "configs"
HAND_PARENTS = [-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19]
# A scene in the dual arm's reach (tests/test_pallas.py:52-72 style): one
# axis-aligned box and one turned about z, both hit by some random poses.
NEAR_SCENE = dict(centers=[(1.2, 0.8, 0.0), (-1.0, 1.0, 0.3)],
                  full_dims=[(0.8, 0.8, 0.8), (0.9, 0.9, 0.9)],
                  quats=[(0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.383, 0.924)])


def _jax_model(name):
    if name == "hand21":
        cfg = jconfigio.load_config(str(CONFIG_DIR / "hand21.json"))
        return cfg.spec, cfg.problem
    return getattr(jlib, name)()


def _jax_case(name, s, rng, orientation=False):
    """A batched JAX problem: targets the effectors of random in-limit
    poses (with their rotations as orientation targets), the anchors a
    nearby pose so the locality terms count."""
    spec_j, problem_j = _jax_model(name)
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    ang = (lo + rng.random((s, spec_j.dof)) * (hi - lo)).astype(np.float32)
    root = jnp.broadcast_to(problem_j.pose[0], (s, 3))
    pose = jfk.angles_to_pose(spec_j, root, jnp.asarray(ang))
    pos, rot = jfk.fk(spec_j, pose, problem_j.origin)
    eff = list(spec_j.effector_idx)
    target_rot = None
    if orientation:
        from ikpso_tpu.ops.rotations import matrix_to_quaternion, quaternion_to_euler_xyz

        target_rot = quaternion_to_euler_xyz(matrix_to_quaternion(rot[:, eff]))
    batched = jlib.batched_problem(problem_j, pos[:, eff], target_rot=target_rot)
    anchor = (ang + rng.normal(0, 0.3, ang.shape)).clip(lo, hi).astype(np.float32)
    return spec_j, batched.replace(pose=jfk.angles_to_pose(spec_j, root, jnp.asarray(anchor)))


def _x(spec_j, shape, rng):
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    return (lo + rng.random(shape + (spec_j.dof,)) * (hi - lo)).astype(np.float32)


# (a) Kernel B's plain twin.

TILE_CASES = {
    "distance_arm_7dof": ("arm_7dof", dict(angle_weight=3.0, distance_weight=0.7), None, False),
    "distance_hand21": ("hand21", dict(angle_weight=3.0, distance_weight=0.7), None, False),
    "exact_arm_7dof": ("arm_7dof", dict(angle_weight=3.0, trig_impl="exact"), None, False),
    "dual_arm_box": ("dual_arm_14dof", dict(angle_weight=1.0, distance_weight=0.5),
                     NEAR_SCENE, False),
    "dual_arm_orientation": ("dual_arm_14dof", dict(angle_weight=1.0,
                                                    orientation_weight=0.5), None, True),
}


# float32's unit roundoff: one rounded operation's relative error.
U32 = 2.0 ** -24


def rounding_steps(spec, fit, orientation):
    """k of the tile's float32 floor k * 2^-24: the most rounded operations
    that any summand of the cost passes through from the last cancelling
    subtraction to the returned total (``ops/fitness_kernel.py``,
    ``fk_walk_tile``). Every summand is non-negative, so the total's
    relative error is at most the largest of its summands' chains:

      * the subtraction, counted twice (its square doubles its relative
        error), the square, and the two adds of a 3-vector's squares (eight
        of the orientation term's nine);
      * the sum over nodes past its first term (exact: 0 + t), n - 2 adds
        for the joint and distance terms; over the cost's terms, T - 1 (T
        = E, or 2 E with orientation);
      * the weight: w * (.) for an effector; (aw / nj) * (.) for the joint
        term and (dw / nj) * (.) for the distance term, the quotient
        rounded too; (ow * w) * (.) for orientation;
      * the adds that join the terms: cost + joint term, then + distance
        term.

    The FK walk's own rounding before the subtraction grows with the nodes
    and is the zoo's per-node term (1e-6 x nodes / 11); the bar is the larger
    of the two. The Pallas tile runs the same operations in the same order,
    so it differs from the port only where XLA rounds one of them
    otherwise, not by two independent errors: one floor holds both
    comparisons."""
    n, e = spec.num_nodes, spec.num_effectors
    dist = fit.distance_weight != 0.0
    terms = e * (2 if orientation else 1)
    tail = 1 + int(dist)  # + joint term, + distance term
    chains = [2 + 1 + 2 + (n - 2) + 2 + tail,  # joint angles
              2 + 1 + 2 + 1 + (terms - 1) + tail]  # effector positions
    if dist:
        chains.append(2 + 1 + 2 + (n - 2) + 2 + 1)
    if orientation:
        chains.append(2 + 1 + 8 + 2 + (terms - 1) + tail)
    return max(chains)


def tile_rtol(spec, fit, orientation):
    """The tile's bar: the float32 floor of :func:`rounding_steps` or the zoo's
    per-node term, the larger. At 4 nodes the per-node term alone
    (3.6e-7) sat below the port's distance from its own float64
    evaluation (4.5e-7) and from the Pallas tile (5.8e-7)."""
    return max(1e-6 * spec.num_nodes / 11, rounding_steps(spec, fit, orientation) * U32)


# Each case at its first seed (the case's own id) and three more.
TILE_SEEDS = (90, 91, 92, 93)


@pytest.mark.parametrize("case,seed", [
    pytest.param(case, seed, id=case if seed == TILE_SEEDS[0] else f"{case}-seed{seed}")
    for case in TILE_CASES for seed in TILE_SEEDS])
def test_tile_branch_matches_pallas_kernel_and_jnp_fitness(case, seed):
    name, fields, scene, orient = TILE_CASES[case]
    rng = np.random.default_rng(seed)
    s, p = 2, 1024
    spec_j, batched_j = _jax_case(name, s, rng, orient)
    fit_j = JFit(**fields)
    obs_j = None if scene is None else JObstacles.from_boxes(**scene)
    n_obs = 0 if obs_j is None else obs_j.count
    meta_j = _pack_meta(spec_j, fit_j, obs_j, orient)
    swarm_j = _pack_swarm(spec_j, batched_j, jfk.pose_to_angles(spec_j, batched_j.pose),
                          j_anchor_flat(spec_j, batched_j), orient)
    x = _x(spec_j, (s, p), rng)
    dist = fit_j.distance_weight != 0.0
    want = np.asarray(fused_fitness(
        spec_j, jnp.swapaxes(jnp.asarray(x), -1, -2), meta_j, swarm_j, num_obstacles=n_obs,
        use_distance_term=dist, use_orientation=orient, trig_impl=fit_j.trig_impl,
        interpret=pltpu.InterpretParams()))
    spec = convert.chain_spec_from(spec_j)
    fit = convert.fitness_config_from(fit_j)
    obs = None if obs_j is None else convert.obstacles_from(obs_j)
    meta = pack_meta(spec, fit, obs, orient)
    np.testing.assert_array_equal(meta.numpy(), np.asarray(meta_j).reshape(meta.shape))
    swarm = torch.tensor(np.asarray(swarm_j))
    kw = dict(num_obstacles=n_obs, use_distance_term=dist, use_orientation=orient,
              trig_impl=fit.trig_impl)
    before = fk_fitness.launches
    got = fk_fitness(spec, torch.as_tensor(x), meta, swarm, **kw)
    assert fk_fitness.launches == before  # a CPU tensor runs the plain twin
    np.testing.assert_array_equal(
        fused_fitness_plain(spec, torch.as_tensor(x).transpose(1, 2), meta, swarm,
                            **kw).numpy(), got.numpy())
    hit, hit_j = got.numpy() >= 3e38, want >= 3e38
    np.testing.assert_array_equal(hit, hit_j)
    if scene is not None:
        assert 0.01 < hit.mean() < 0.99
    free = ~hit
    rtol = tile_rtol(spec, fit, orient)
    np.testing.assert_allclose(got.numpy()[free], want[free], rtol=rtol, atol=0)
    exact = fk_fitness(spec, torch.as_tensor(x).double(), meta.double(), swarm.double(),
                       **kw)
    np.testing.assert_allclose(got.numpy()[free], exact.numpy()[free], rtol=rtol, atol=0)
    oracle = np.asarray(j_fitness(spec_j, jnp.asarray(x), batched_j, config=fit_j,
                                  obstacles=obs_j))
    np.testing.assert_array_equal(oracle >= 3e38, hit)
    np.testing.assert_allclose(got.numpy()[free], oracle[free], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["arm_7dof", "hand21"])
def test_exact_trig_tile_matches_poly_tile(name):
    # tests/test_pallas.py:167-182: the two trigs agree to 1e-5.
    rng = np.random.default_rng(91)
    spec_j, batched_j = _jax_case(name, 2, rng)
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    fit = FitnessConfig(angle_weight=3.0, distance_weight=0.7)
    meta = pack_meta(spec, fit)
    swarm = pack_swarm(spec, batched, torch.as_tensor(np.asarray(
        jfk.pose_to_angles(spec_j, batched_j.pose))), torch.as_tensor(np.asarray(
            j_anchor_flat(spec_j, batched_j))))
    x = torch.as_tensor(_x(spec_j, (2, 512), rng))
    poly = fk_fitness_plain(spec, x, meta, swarm, use_distance_term=True)
    exact = fk_fitness_plain(spec, x, meta, swarm, use_distance_term=True,
                             trig_impl="exact")
    assert not torch.equal(poly, exact)
    np.testing.assert_allclose(exact.numpy(), poly.numpy(), rtol=1e-5, atol=1e-5)


# (b) Kernel A's plain twin against the interpreted JAX megakernel.

REPLAY_CASES = {
    # tests/test_fused.py:55-76's weights.
    "distance_reference_arm": ("reference_arm", dict(angle_weight=3.0, distance_weight=0.7),
                               dict(init_mode="warm"), None, 128),
    "exact_arm_7dof": ("arm_7dof", dict(angle_weight=0.0, trig_impl="exact"),
                       dict(init_mode="uniform", rekick_interval=1, rekick_scale=0.5),
                       None, 128),
    "dual_arm_box": ("dual_arm_14dof", dict(angle_weight=0.0, collision_shape="box"),
                     dict(init_mode="hybrid", rekick_interval=1, rekick_scale=0.5,
                          rekick_threshold=1e-6), NEAR_SCENE, 128),
    "hand21": ("hand21", dict(angle_weight=0.0), dict(init_mode="warm"), None, 128),
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_branch_replay_matches_jax_interpreted_kernel(case, torch_single_thread):
    name, fit_fields, pso_fields, scene, p = REPLAY_CASES[case]
    rng = np.random.default_rng(92)
    s = SW
    spec_j, batched_j = _jax_case(name, s, rng)
    pso_j = JPSO(iterations=2, inertia_mode="canonical", inertia=0.5, inertia_end=0.2,
                 **pso_fields)
    fit_j = JFit(**fit_fields)
    obs_j = None if scene is None else JObstacles.from_boxes(**scene)
    n_obs = 0 if obs_j is None else obs_j.count
    meta_j = _pack_meta(spec_j, fit_j, obs_j)
    swarm_j = _pack_swarm(spec_j, batched_j, jfk.pose_to_angles(spec_j, batched_j.pose),
                          j_anchor_flat(spec_j, batched_j))
    pso = convert.pso_config_from(pso_j)
    u = rng.random((s, num_draws(pso), spec_j.dof, p), dtype=np.float32)
    limits_j = jnp.stack([spec_j.min_rotation[1:].reshape(-1),
                          spec_j.max_rotation[1:].reshape(-1)])
    gb_j, gv_j = fused_solve_raw(
        spec_j, pso_j, fit_j, meta_j, swarm_j, limits_j, jnp.zeros((s, 2), jnp.int32), p,
        n_obs, interpret=pltpu.InterpretParams(), uniforms=jnp.asarray(tpu_layout(u)),
        swarms_per_tile=SW)
    spec = convert.chain_spec_from(spec_j)
    gb, gv = fused_solve_plain(
        spec, pso, convert.fitness_config_from(fit_j), torch.tensor(np.asarray(meta_j)),
        torch.tensor(np.asarray(swarm_j)), spec.limits(),
        torch.zeros((s, 2), dtype=torch.int32), p, uniforms=torch.as_tensor(u),
        num_obstacles=n_obs)
    assert gb.shape == (s, spec.dof)
    np.testing.assert_array_equal(gv.numpy() >= 3e38, np.asarray(gv_j) >= 3e38)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), atol=ATOL_ANGLES)
    free = gv.numpy() < 3e38
    np.testing.assert_allclose(gv.numpy()[free], np.asarray(gv_j)[free], rtol=RTOL_VALUE,
                               atol=ATOL_VALUE)


def test_config_branches_solve_on_the_cpu(torch_single_thread):
    # make_fused_solver takes every branch a config can name: the distance
    # term with exact trig on a tree with a scene and an orientation target.
    from ikpso_tpu_torch.utils.configio import load_config

    doc = {"model": "dual_arm_14dof", "num_particles": 64,
           "pso": {"iterations": 2, "inertia_mode": "canonical"},
           "fitness": {"distance_weight": 0.5, "orientation_weight": 0.5,
                       "trig_impl": "exact"},
           "obstacles": {"centers": NEAR_SCENE["centers"],
                         "full_dims": NEAR_SCENE["full_dims"]}}
    cfg = load_config(doc)
    solver = make_fused_solver(cfg.spec, pso=cfg.pso, fit=cfg.fitness, num_particles=64,
                               device="cpu", obstacles=cfg.obstacles)
    problem = library.batched_problem(cfg.problem, cfg.problem.targets[None].expand(4, 2, 3),
                                      target_rot=torch.zeros(4, 2, 3))
    res = solver(problem, torch.Generator().manual_seed(0))
    assert torch.isfinite(res.angles).all() and bool((res.fitness < 3e38).all())


# (c) The routing.


def _tree(parents, effectors):
    n = len(parents)
    lim = np.zeros((n, 3), np.float32)
    return make_chain_spec(parents, [0.0] + [1.0] * (n - 1), lim, lim, effectors)


def test_on_demand_routing_for_trees_that_used_to_raise():
    hand = _tree(HAND_PARENTS, [4, 8, 12, 16, 20])
    branched17 = _tree([-1] + list(range(15)) + [0], [16])
    short = _tree([-1, 0, 1, 2, 1], [3, 4])
    for spec in (hand, branched17, short):
        assert kernels.topology_id(spec) == kernels.ON_DEMAND
        assert kernels.kernel_variant(spec, 0, "box", False) == (kernels.ON_DEMAND, 0, 0)
        assert kernels.topology_name(spec) == f"tree{spec.num_nodes}"
    assert kernels.topology_code(hand) == (21, None, sum(1 << e for e in (4, 8, 12, 16, 20)))
    # The hand's 60 DOFs take the scratch layout and, beside it, the
    # cluster layout at a 512-particle bound; the 17-node tree's 48 too;
    # the 5-node tree stays in registers.
    assert kernels.max_particles(hand) == kernels.max_particles(branched17) == 512
    assert kernels.on_demand_key(hand, 0, False).scratch
    assert kernels.on_demand_key(hand, 0, False).cluster
    assert kernels.on_demand_key(branched17, 0, False).cluster
    assert not kernels.on_demand_key(short, 0, False).cluster
    assert not kernels.on_demand_key(short, 0, False).scratch
    assert kernels.max_particles(short) == 1024
    assert kernels.max_particles(_tree([-1, 0, 1, 2, 3, 4, 5, 6, 1, 8], [7, 9])) == 512
    # Trees with a scene or an orientation target, and any tree with the
    # distance term or exact trig, are built on demand; a prebuilt
    # topology keeps its bound there.
    dual, human = library.dual_arm_14dof()[0], library.humanoid_45dof()[0]
    ref, arm6 = library.reference_arm()[0], library.arm_6dof()[0]
    assert kernels.kernel_variant(dual, 4, "box", False) == (kernels.ON_DEMAND, 1, 0)
    assert kernels.kernel_variant(dual, 0, "box", True) == (kernels.ON_DEMAND, 0, 1)
    assert kernels.kernel_variant(human, 2, "capsule", True) == (kernels.ON_DEMAND, 2, 1)
    assert kernels.kernel_variant(arm6, 0, "box", True) == (2, 0, 1)  # prebuilt
    assert kernels.kernel_variant(arm6, 0, "box", True, True) == (kernels.ON_DEMAND, 0, 1)
    assert kernels.kernel_variant(ref, 0, "box", False, trig_impl="exact") == (
        kernels.ON_DEMAND, 0, 0)
    assert kernels.max_particles(ref, use_distance=True) == 256
    assert kernels.max_particles(human, 2, "box", True) == 512
    key = kernels.on_demand_key(human, 1, True, True, True)
    assert (key.threads, key.stream, key.scratch) == (512, True, False)
    # Only an unknown collider shape or trig raises.
    with pytest.raises(ValueError, match="collision_shape"):
        kernels.kernel_variant(dual, 2, "sphere", False)
    with pytest.raises(ValueError, match="trig_impl"):
        kernels.kernel_variant(dual, 0, "box", False, trig_impl="fast")


def test_on_demand_key_names_and_hashes():
    hand = _tree(HAND_PARENTS, [4, 8, 12, 16, 20])
    dual = library.dual_arm_14dof()[0]
    keys = [kernels.on_demand_key(hand, 0, False), kernels.on_demand_key(hand, 1, False),
            kernels.on_demand_key(dual, 1, False), kernels.on_demand_key(dual, 1, True),
            kernels.on_demand_key(dual, 1, False, True),
            kernels.on_demand_key(dual, 1, False, False, True),
            kernels.on_demand_key(_tree(HAND_PARENTS, [20, 16, 12, 8, 4]), 0, False)]
    paths = [kernels.on_demand_path(k) for k in keys]
    # Two keys never share a library; the same key always maps to one.
    assert len(set(paths)) == len(keys)
    assert kernels.on_demand_path(kernels.on_demand_key(hand, 0, False)) == paths[0]
    assert keys[0].name() == "n21-c0-p-scratch-cluster" and keys[4].name() == "n7-c1-d"
    assert all(p.parent == kernels.BUILD_DIR and p.name.startswith("libikpso_od-")
               for p in paths)
    assert re.fullmatch(r"libikpso_od-n7-c1-ox-[0-9a-f]{16}\.so",
                        kernels.on_demand_path(kernels.on_demand_key(
                            dual, 1, True, False, True)).name)
    src = kernels.on_demand_source(keys[6])
    assert "#define IKPSO_OD_EFFECTORS 20, 16, 12, 8, 4" in src
    assert '#include "on_demand.cuh"' in src and "__global__" not in src


# A stand-in CUDA runtime for a host compiler: enough of the language and
# the runtime API for g++ to check the kernel sources (launches are
# rewritten into calls).
STANDIN = """
#pragma once
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 1; return 0; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline void __syncthreads() {}
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline unsigned __reduce_min_sync(unsigned, unsigned v) { return v; }
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline unsigned __float_as_uint(float v) {
  unsigned b;
  __builtin_memcpy(&b, &v, sizeof b);
  return b;
}
#define __align__(n) __attribute__((aligned(n)))
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
inline void __threadfence() {}
inline int atomicAdd(int* p, int v) { const int old = *p; *p += v; return old; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __uint_as_float(unsigned b) {
  float v;
  __builtin_memcpy(&v, &b, sizeof v);
  return v;
}
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t*, void (*)(P...), A&&...) {
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, F, const cudaLaunchConfig_t*) {
  *n = 1;
  return cudaSuccess;
}
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return 0; }
  void sync() const { __syncthreads(); }
  template <class T> T* map_shared_rank(T* p, int) const { return p; }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
#include <algorithm>
#include <climits>
using std::isnan;
using std::min;
"""
# The header the cluster layout includes; the stand-in above declares it.
COOPERATIVE_GROUPS = '#pragma once\n#include "cuda_runtime.h"\n'


def test_on_demand_source_compiles_with_a_host_compiler(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    (tmp_path / "cuda_runtime.h").write_text(STANDIN)
    (tmp_path / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS)
    for src in kernels.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_text(
            re.sub(r"<<<.*?>>>", "", src.read_text(), flags=re.S))
    hand = _tree(HAND_PARENTS, [4, 8, 12, 16, 20])
    # Past CLUSTER_MAX_DOF DOFs (22 nodes: 63) a tree keeps the scratch layout.
    wide = _tree([-1] + [0] * 21, [21])
    keys = [kernels.on_demand_key(hand, 0, False),  # the scratch and cluster layouts
            kernels.on_demand_key(wide, 0, False),  # the scratch layout alone
            kernels.on_demand_key(library.dual_arm_14dof()[0], 1, True, True, True)]
    assert keys[0].cluster and keys[0].scratch and keys[1].scratch
    assert not keys[1].cluster
    for i, key in enumerate(keys):
        cu = tmp_path / f"od{i}.cu"
        cu.write_text(kernels.on_demand_source(key))
        proc = subprocess.run(["g++", "-std=c++17", "-fsyntax-only", "-I", str(tmp_path),
                               "-x", "c++", str(cu)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]


# (d) The op model.


@pytest.mark.parametrize("name", ["arm_7dof", "dual_arm_14dof", "hand21"])
def test_op_model_counts_the_new_branches(name):
    spec = (convert.chain_spec_from(_jax_model(name)[0]) if name == "hand21"
            else getattr(library, name)()[0])
    base = flops.fitness_tile_count(spec, FitnessConfig(angle_weight=3.0))
    dist = flops.fitness_tile_count(spec, FitnessConfig(angle_weight=3.0,
                                                        distance_weight=0.7))
    exact = flops.fitness_tile_count(spec, FitnessConfig(angle_weight=3.0,
                                                         trig_impl="exact"))
    joints = spec.num_nodes - 1
    # Distance: 3 subs, 3 muls, 2 adds and the accumulate a joint, then the
    # weight over J once a tile and the final multiply-add.
    assert dist.flops - base.flops == 9 * joints + 2 + 1 / flops.TILE_PARTICLES
    assert dist.transcendentals == base.transcendentals == 0.0
    # Exact trig: each angle's sinf / cosf pair costs the 43 instructions of
    # its fast path (10 shared, 16 and 17) in place of the polynomial
    # pair's 28 counted ops (range reduction 4, r^2 1, sin 10 + 1, cos 12).
    assert flops.EXACT_SINCOS_OPS == 43.0
    assert exact.transcendentals == 0.0
    assert exact.flops - base.flops == spec.dof * (43.0 - 28.0)


def test_fused_solve_count_carries_the_branches():
    spec = library.arm_7dof()[0]
    pso = dataclasses.replace(convert.pso_config_from(JPSO(iterations=8)),
                              inertia_mode="canonical")
    kw = dict(num_particles=128, num_swarms=4)
    base = flops.fused_solve_count(spec, pso, FitnessConfig(), **kw)
    dist = flops.fused_solve_count(spec, pso, FitnessConfig(distance_weight=0.7), **kw)
    tile = flops.fitness_tile_count(spec, FitnessConfig(distance_weight=0.7)).flops - \
        flops.fitness_tile_count(spec, FitnessConfig()).flops
    assert dist.flops - base.flops == pytest.approx(9 * 128 * 4 * tile)


# (e) The fault this slice repaired: the row FK (``pso/polish_soa.py``: the
# SoA polish, ``true_effector_error_rows``, the anchor positions packed for
# the distance term) took float32 ``torch.sin`` / ``torch.cos`` while the
# tensor FK (``ops/fk.py``) takes them in float64 and rounds. The card's
# float32 sin is not the CPU's, so on the same angles the card reported a
# larger effector error than the CPU at the float32 noise floor (PERF.md,
# PR 7); the two FKs now round alike, and alike on every device.


@pytest.mark.parametrize("name", ["arm_7dof", "dual_arm_14dof", "hand21"])
def test_row_fk_rounds_like_the_tensor_fk(name):
    from ikpso_tpu_torch.ops import fk as fk_ops
    from ikpso_tpu_torch.pso.polish_soa import _fk_rows, anchor_positions_flat

    spec_j, batched_j = _jax_case(name, 64, np.random.default_rng(93))
    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)
    x = torch.as_tensor(_x(spec_j, (64,), np.random.default_rng(94)))
    pose = fk_ops.angles_to_pose(spec, batched.pose[:, 0], x)
    want = fk_ops.fk_points(spec, pose, batched.origin)
    pos, _, _ = _fk_rows(spec, list(x.unbind(-1)), list(batched.pose[:, 0].unbind(-1)),
                         list(batched.origin.unbind(-1)))
    got = torch.stack([torch.stack(p, dim=-1) for p in pos], dim=-2)
    assert torch.equal(got, want)
    assert torch.equal(anchor_positions_flat(spec, batched),
                       fk_ops.fk_points(spec, batched.pose, batched.origin)[:, 1:].flatten(1))
