"""Kernel A's short-chain source (``csrc/fused_solve_short.cu`` through
``csrc/fused_solve.cu``'s entry point) compiled by g++ for this CPU and
held bit for bit against ``pso/fused.py::fused_solve_plain``.

The stand-in CUDA runtime is the scan step test's (each CUDA thread a
``std::thread``, ``__syncthreads`` a ``std::barrier``, dynamic shared
memory a block buffer filled with garbage, blocks in turn), with the warp
primitives the kernels use (``__shfl_xor_sync``, ``__reduce_min_sync``)
exchanged through a block buffer between two barriers, and a kernel's
static ``__shared__`` variables as statics. The cases run every short-chain
instantiation the prebuilt library has -- arm_7dof without a scene (the
headline) and with the box scene, arm_6dof with the orientation term and
the re-kick -- at both thread bounds (256 and 1,024), in the drawing and
the replay form, at P = 64 and P = 32; the canonical update (the headline
at the 256 bound, drawing) and the run-time branches (randomized inertia,
uniform init, a gbest interval of 2) both; and the first-minimum rule on
exact ties (``tests/test_torch_fused.py``'s tie and all-colliding cases);
NaN first on a block whose fitness values mix NaN with numbers (the plain
twin's ``torch.argmin``), at both short bounds and in the tree loop
(``fused_solve_tree_kernel``: the dual arm, the humanoid, reference_arm and
snake_30dof at their thread bounds, drawing and replay, gbest every other
iteration, their ties across warps, and the on-demand keys of the tree
loop's rule built by g++ as well: the orientation twins, the dual arm's
capsule, distance and exact-trig twins, hand12 with and without boxes,
their ties and NaN first, and hand12 among boxes against JAX's
``fused_solve_raw`` under the Pallas interpreter). A pose
with a NaN angle in a capsule scene is no hit, in JAX's collider and
solver, the plain twin and kernel A alike; in a box scene, the penalty.
Besides, ``kernel_a_layout``'s choice of the bound: 256 threads up to 256
particles, 1,024 above, and a P no instantiation takes raises before any
launch.
"""

import ctypes
import dataclasses
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.models.chain import Obstacles
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness_plain, pack_meta, pack_swarm
from ikpso_tpu_torch.pso import fused
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.polish_soa import anchor_positions_flat
from ikpso_tpu_torch.utils import kernels

from test_torch_branches import COOPERATIVE_GROUPS, STANDIN as BRANCHES_STANDIN
from test_torch_cluster_host import _problem, same
from test_torch_fused import penalty_tie_case, tie_case

STANDIN = (BRANCHES_STANDIN
           .replace("#define __shared__\n", "#define __shared__ static\n")
           .replace("inline void __syncthreads() {}", """#include <barrier>
#include <cstring>
#include <thread>
#include <vector>
extern std::barrier<>* standin_barrier;
extern float* standin_shared;
extern unsigned long long* standin_words;
inline void __syncthreads() { standin_barrier->arrive_and_wait(); }""")
           .replace("inline unsigned __reduce_min_sync(unsigned, unsigned v) { return v; }\n",
                    "")
           .replace("template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }",
                    """template <class T> T __shfl_xor_sync(unsigned, T v, int off) {
  static_assert(sizeof(T) <= sizeof(unsigned long long), "one word");
  std::memcpy(&standin_words[threadIdx.x], &v, sizeof(T));
  standin_barrier->arrive_and_wait();
  T out;
  std::memcpy(&out, &standin_words[threadIdx.x ^ off], sizeof(T));
  standin_barrier->arrive_and_wait();
  return out;
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  standin_words[threadIdx.x] = v;
  standin_barrier->arrive_and_wait();
  unsigned m = 0xffffffffu;
  for (unsigned i = threadIdx.x & ~31u; i < (threadIdx.x | 31u) + 1 && i < blockDim.x; ++i) {
    m = std::min<unsigned>(m, static_cast<unsigned>(standin_words[i]));
  }
  standin_barrier->arrive_and_wait();
  return m;
}""")
           .replace("inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) "
                    "{ *v = 1; return 0; }",
                    "inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {\n"
                    "  *v = a == cudaDevAttrMaxSharedMemoryPerBlockOptin ? 232448 : 1;\n"
                    "  return 0;\n}")
           .replace("struct float4 { float x, y, z, w; };",
                    "struct alignas(16) float4 { float x, y, z, w; };")
           + r"""
template <class K, class... A>
inline void standin_launch(unsigned g, unsigned b, size_t smem, cudaStream_t, K k, A... a) {
  std::vector<float> buf(smem / sizeof(float) + 1);
  std::vector<unsigned long long> words(b);
  for (unsigned x = 0; x < g; ++x) {
    std::fill(buf.begin(), buf.end(), -12345.0f);
    std::barrier<> barrier(b);
    standin_barrier = &barrier;
    standin_shared = buf.data();
    standin_words = words.data();
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < b; ++t) {
      threads.emplace_back([=] {
        blockIdx.x = x; threadIdx.x = t; blockDim.x = b; gridDim.x = g;
        k(a...);
      });
    }
    for (auto& th : threads) th.join();
  }
}
""")
RUNNER = r"""
#include "cuda_runtime.h"
thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
std::barrier<>* standin_barrier;
float* standin_shared;
unsigned long long* standin_words;
"""
SOURCES = ("fused_solve.cu", "fused_solve_short.cu")


def _host_source(text):
    text = text.replace("extern __shared__ float smem[];", "float* smem = standin_shared;")
    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\(", r"standin_launch(\2, \1, ",
                  text, flags=re.S)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """fused_solve.cu and fused_solve_short.cu, compiled by g++ for this CPU
    into one library."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    tmp = tmp_path_factory.mktemp("host_kernel_a")
    (tmp / "cuda_runtime.h").write_text("#pragma once\n" + STANDIN)
    for src in kernels.CSRC.glob("*.cu*"):
        (tmp / src.name).write_text(_host_source(src.read_text()))
    (tmp / "runner.cu").write_text(RUNNER)
    objs, procs = [], []
    for name in ("runner.cu", *SOURCES):
        obj = tmp / f"{name}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-fPIC",
             "-pthread", "-c", "-I", str(tmp), "-x", "c++", str(tmp / name), "-o", str(obj)],
            stderr=subprocess.PIPE, text=True))
    for proc in procs:
        err = proc.communicate()[1]
        assert proc.returncode == 0, err[-4000:]
    so = tmp / "libkernel_a.so"
    link = subprocess.run(["g++", "-shared", "-pthread", "-o", str(so), *map(str, objs)],
                          capture_output=True, text=True)
    assert link.returncode == 0, link.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    for fn, sig in kernels.SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _chip_smoke():
    mod_spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


# The zoo models whose twins with the orientation term the host tests build
# on demand (chip_smoke.py's ON_DEMAND_CASES has the dual arm's).
ORIENTATION_TWINS = {"humanoid_orientation": "humanoid_45dof",
                     "reference_arm_orientation": "reference_arm"}


def _od_case(tag, s, rng):
    """``(spec, pso, fit, meta, swarm, num_obstacles, orientation)``: a
    ``chip_smoke.py`` on-demand case (its cut recipe), or a zoo model of
    ``ORIENTATION_TWINS`` with the orientation term (its preset cut to 4
    iterations)."""
    smoke = _chip_smoke()
    if tag in ORIENTATION_TWINS:
        from ikpso_tpu_torch.harness.trees import tree_configs

        model = ORIENTATION_TWINS[tag]
        _, pso, fit = tree_configs(model)
        pso = dataclasses.replace(pso, iterations=4)
        fit = dataclasses.replace(fit, orientation_weight=1.0)
        spec, batched = smoke._problem(model, s, rng, "cpu", orientation=True)
        meta, swarm = smoke._packed(spec, batched, fit, use_orientation=True)
        return spec, pso, fit, meta, swarm, 0, True
    spec, pso, fit, _, meta, swarm, obs, orient = smoke.od_case(tag, "cpu", s, rng)
    return spec, pso, fit, meta, swarm, 0 if obs is None else obs.count, orient


# The on-demand keys the host tests build, in the tree loop at their thread
# bound: the twins with the orientation term of the trees and
# reference_arm, the dual arm's with the capsule collider and the distance
# term, and hand12 (36 DOFs, on demand) without and with the box scene;
# and in the general loop, which the box scene keeps at 64 registers, the
# dual arm's with the box scene (dual_arm_box).
OD_TREE_CASES = ("dual_arm_box", "dual_arm_orientation", "humanoid_orientation",
                 "reference_arm_orientation", "dual_arm_capsule", "dual_arm_distance",
                 "hand12", "hand12_box")
# The dual arm with exact trig, in the tree loop and in the general loop:
# this CPU's sinf / cosf are not torch's, so the host build is held to the
# general loop's host build, not to the plain twin (the card holds both to
# it: chip_smoke.py).
OD_EXACT_CASE = "dual_arm_exact"


def _od_key(spec, fit, n_obs, orient):
    distance = fused.uses_distance(fit)
    topo, collider, o = kernels.kernel_variant(spec, n_obs, fit.collision_shape, orient,
                                               distance, fit.trig_impl)
    assert topo == kernels.ON_DEMAND
    return kernels.on_demand_key(spec, collider, o, distance, fit.trig_impl == "exact")


@pytest.fixture(scope="module")
def od_host_libs(tmp_path_factory):
    """``{key: lib}``: the on-demand library of each ``OD_TREE_CASES`` case,
    compiled by g++ for this CPU against the threaded stand-in."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    tmp = tmp_path_factory.mktemp("host_kernel_a_od")
    (tmp / "cuda_runtime.h").write_text("#pragma once\n" + STANDIN)
    (tmp / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS)
    for src in kernels.CSRC.glob("*.cu*"):
        (tmp / src.name).write_text(_host_source(src.read_text()))
    procs, builds = {}, []
    for tag in (*OD_TREE_CASES, OD_EXACT_CASE):
        spec, _, fit, _, _, n_obs, orient = _od_case(tag, 1, np.random.default_rng(0))
        key = _od_key(spec, fit, n_obs, orient)
        assert key.tree == (tag != "dual_arm_box") and not key.scratch
        builds.append((tag, key))
    spec, _, fit, _, _, n_obs, orient = _od_case(OD_EXACT_CASE, 1, np.random.default_rng(0))
    builds.append((f"{OD_EXACT_CASE}_general",
                   _od_key(spec, fit, n_obs, orient)._replace(tree=False)))
    for tag, key in builds:
        cu = tmp / f"{tag}_host.cu"
        cu.write_text(RUNNER + kernels.on_demand_source(key))
        so = cu.with_suffix(".so")
        procs[key] = (so, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-shared",
             "-fPIC", "-pthread", "-I", str(tmp), "-x", "c++", str(cu), "-o", str(so)],
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        err = proc.communicate()[1]
        assert proc.returncode == 0, err[-4000:]
        lib = ctypes.CDLL(str(so))
        for fn, sig in kernels.OD_SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = sig
                getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


def _run_host(lib, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, uniforms=None,
              num_obstacles=0, use_orientation=False, threads=None):
    """Kernel A's launch (``fused._launch``) on CPU tensors through the g++
    build, at the layout's thread bound or ``threads``."""
    layout = fused._check_args(spec, pso, fit, swarm, spec.limits(), seeds, p, uniforms,
                               num_obstacles, use_orientation)
    if threads is not None:
        layout = layout._replace(threads=threads)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: None)
    monkeypatch.setattr(kernels, "require_cuda_contiguous", lambda *a: None)
    return fused._launch(spec, pso, fit, meta, swarm, spec.limits(), seeds, p, uniforms,
                         num_obstacles, use_orientation, layout, fused.gbest_interval(pso))


def _arm7(s, rng, fit, obstacles=None):
    spec, problem = library.arm_7dof()
    lim = spec.limits().numpy()
    ang = (lim[0] + rng.random((s, spec.dof)) * (lim[1] - lim[0])).astype(np.float32)
    pose = fk_ops.angles_to_pose(spec, problem.pose[0].expand(s, 3), torch.as_tensor(ang))
    targets = fk_ops.fk_points(spec, pose, problem.origin)[:, list(spec.effector_idx)]
    batched = library.batched_problem(problem, targets)
    meta = pack_meta(spec, fit, obstacles)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched))
    return spec, meta, swarm


def _arm6_orientation(s, rng, fit):
    from ikpso_tpu_torch.harness.orientation import orientation_targets

    spec, problem = library.arm_6dof()
    lim = spec.limits().numpy()
    ang = (lim[0] + rng.random((s, spec.dof)) * (lim[1] - lim[0])).astype(np.float32)
    pose = fk_ops.angles_to_pose(spec, problem.pose[0].expand(s, 3), torch.as_tensor(ang))
    targets, target_rot = orientation_targets(spec, problem, pose)
    batched = library.batched_problem(problem, targets, target_rot=target_rot)
    meta = pack_meta(spec, fit, None, True)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched), True)
    return spec, meta, swarm


HEADLINE = PSOConfig(iterations=8, inertia_mode="canonical", inertia=0.5, inertia_end=0.2)


def _case(name, s, rng):
    """``(spec, pso, fit, meta, swarm, num_obstacles, orientation)``."""
    obs, orient = None, False
    if name == "headline":
        pso, fit = HEADLINE, FitnessConfig(angle_weight=0.0, distance_weight=0.0)
    elif name == "branches":
        # The run-time branches of the update at the short bound: uniform
        # init, randomized inertia, gbest every 2 iterations.
        pso = PSOConfig(iterations=4, inertia_mode="randomized", init_mode="uniform",
                        gbest_interval=2)
        fit = FitnessConfig(angle_weight=3.0)
    elif name == "box":
        obs = Obstacles.from_boxes([(0.9, 0.9, 0.0), (-0.8, 0.4, 0.7)],
                                   [(0.25, 0.25, 0.25), (0.3, 0.3, 0.3)])
        pso = dataclasses.replace(HEADLINE, init_mode="hybrid")
        fit = FitnessConfig(angle_weight=0.0, collision_shape="box")
    else:
        from ikpso_tpu_torch.harness.orientation import orientation_configs

        _, pso, fit = orientation_configs()
        # The preset's re-kick every 20 of 40 iterations, cut to every 2 of 4.
        pso = dataclasses.replace(pso, iterations=4, rekick_interval=2)
        spec, meta, swarm = _arm6_orientation(s, rng, fit)
        return spec, pso, fit, meta, swarm, 0, True
    spec, meta, swarm = _arm7(s, rng, fit, obs)
    return spec, pso, fit, meta, swarm, 0 if obs is None else obs.count, orient


@pytest.mark.parametrize("threads", [256, 1024])
@pytest.mark.parametrize("particles", [64, 32])
@pytest.mark.parametrize("name", ["headline", "branches", "box", "orientation"])
def test_short_chain_source_matches_the_plain_solve(host_lib, monkeypatch, name,
                                                    particles, threads):
    rng = np.random.default_rng(15)
    spec, pso, fit, meta, swarm, n_obs, orient = _case(name, 3, rng)
    seeds = torch.as_tensor(rng.integers(-2**31, 2**31, (3, 2)).astype(np.int32))
    u = torch.as_tensor(rng.random((3, fused.num_draws(pso), spec.dof, particles),
                                   dtype=np.float32))
    before = fused.fused_solve.launches
    for uniforms in (None, u):  # the drawing form, then the replay form
        want = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds,
                                       particles, uniforms, n_obs, use_orientation=orient)
        got = _run_host(host_lib, monkeypatch, spec, pso, fit, meta, swarm, seeds,
                        particles, uniforms, n_obs, orient, threads)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fused.fused_solve.launches == before + 2


@pytest.mark.parametrize("threads", [256, 1024])
def test_short_chain_source_keeps_the_first_minimum(host_lib, monkeypatch, threads):
    # Exact ties in lval with different lbests: particle 0's, and at the
    # collision penalty (every pose collides) particle 0's initial pose.
    spec, pso, fit, meta, swarm, u, want = tie_case(p=64)
    seeds = torch.zeros((swarm.shape[0], 2), dtype=torch.int32)
    gb, _ = _run_host(host_lib, monkeypatch, spec, pso, fit, meta, swarm, seeds, 64, u,
                      threads=threads)
    np.testing.assert_array_equal(gb[:, 6:].numpy(), np.broadcast_to(want, (2, 3)))
    spec, pso, fit, meta, swarm, u, n_obs, want = penalty_tie_case(p=64)
    got = _run_host(host_lib, monkeypatch, spec, pso, fit, meta, swarm, seeds, 64, u, n_obs,
                    threads=threads)
    plain = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, 64, u,
                                    n_obs)
    assert torch.equal(got[0], want) and torch.equal(got[0], plain[0])
    assert torch.equal(got[1], plain[1])


@pytest.mark.parametrize("threshold", [-1.0, 2.0])  # every swarm; some of them
@pytest.mark.parametrize("model", ["dual_arm_14dof", "humanoid_45dof", "snake_30dof",
                                   "reference_arm"])
def test_general_kernel_source_matches_the_plain_solve(host_lib, monkeypatch, model,
                                                       threshold):
    # The register layout with v and lbest in shared memory: the tree loop
    # (fused_solve_tree_kernel) of the trees, snake_30dof and reference_arm,
    # each at its own thread bound. Uniform init, randomized inertia and the re-kick
    # every 2 iterations, of every swarm or above a threshold that the
    # block argmin's winning value decides, drawing and replay.
    rng = np.random.default_rng(30)
    s, p = 3, 64
    spec, fit, meta, swarm = _problem(model, s, rng)
    pso = PSOConfig(iterations=4, inertia_mode="randomized", init_mode="uniform",
                    rekick_interval=2, rekick_threshold=threshold)
    seeds = torch.as_tensor(rng.integers(-2**31, 2**31, (s, 2)).astype(np.int32))
    u = torch.as_tensor(rng.random((s, fused.num_draws(pso), spec.dof, p), dtype=np.float32))
    for uniforms in (None, u):
        want = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p,
                                       uniforms)
        got = _run_host(host_lib, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, uniforms)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("model", ["dual_arm_14dof", "humanoid_45dof", "reference_arm",
                                   "snake_30dof"])
def test_tree_loop_source_refreshes_every_other_iteration(host_lib, monkeypatch, model):
    # The tree loop's refresh and kick schedules (countdowns where a thread
    # has fewer than 128 registers, the dual arm's 1,024-thread bound; it %
    # interval at 128, the humanoid's 512 and the 256 of reference_arm and
    # snake_30dof at two blocks an SM): gbest
    # every 2 iterations and the re-kick every 4, canonical inertia,
    # hybrid init, drawing and replay, bit for bit against the plain twin.
    rng = np.random.default_rng(41)
    s, p = 2, 64
    spec, fit, meta, swarm = _problem(model, s, rng)
    pso = PSOConfig(iterations=8, inertia_mode="canonical", init_mode="hybrid",
                    gbest_interval=2, rekick_interval=4, rekick_threshold=-1.0)
    seeds = torch.as_tensor(rng.integers(-2**31, 2**31, (s, 2)).astype(np.int32))
    u = torch.as_tensor(rng.random((s, fused.num_draws(pso), spec.dof, p), dtype=np.float32))
    for uniforms in (None, u):
        want = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p,
                                       uniforms)
        got = _run_host(host_lib, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, uniforms)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("tag", OD_TREE_CASES)
def test_tree_loop_on_demand_source_matches_the_plain_solve(od_host_libs, monkeypatch, tag):
    # The keys built on demand: the dual arm, the humanoid and reference_arm
    # with the orientation term, the dual arm in the near capsule ring and
    # with the distance term, hand12 without and with the near box ring
    # (many lanes of a warp reach the SAT) take the tree loop; dual_arm_box
    # (the near box ring at 64 registers) the general loop; drawing and
    # replay at P = 64, bit for bit against the plain twin.
    rng = np.random.default_rng(24)
    s, p = 3, 64
    spec, pso, fit, meta, swarm, n_obs, orient = _od_case(tag, s, rng)
    key = _od_key(spec, fit, n_obs, orient)
    layout = fused._check_args(spec, pso, fit, swarm, spec.limits(),
                               torch.zeros((s, 2), dtype=torch.int32), p, None, n_obs, orient)
    assert layout.tree == (tag != "dual_arm_box") and layout.placement == "shared"
    assert (layout.static_bytes > 0) == bool(layout.tree)
    seeds = torch.as_tensor(rng.integers(-2**31, 2**31, (s, 2)).astype(np.int32))
    u = torch.as_tensor(rng.random((s, fused.num_draws(pso), spec.dof, p), dtype=np.float32))
    monkeypatch.setattr(kernels, "on_demand_library", lambda k: od_host_libs[k])
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: None)
    monkeypatch.setattr(kernels, "require_cuda_contiguous", lambda *a: None)
    for uniforms in (None, u):
        want = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p,
                                       uniforms, n_obs, use_orientation=orient)
        got = fused._launch(spec, pso, fit, meta, swarm, spec.limits(), seeds, p, uniforms,
                            n_obs, orient, layout, fused.gbest_interval(pso))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _od_launch(libs, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, uniforms, n_obs,
               orient=False, key=None):
    """Kernel A's launch on CPU tensors through the g++ build of an
    on-demand key (``key``, or the one the wrappers route to)."""
    layout = fused._check_args(spec, pso, fit, swarm, spec.limits(), seeds, p, uniforms, n_obs,
                               orient)
    if key is not None:
        monkeypatch.setattr(kernels, "on_demand_key", lambda *a, **kw: key)
    monkeypatch.setattr(kernels, "on_demand_library", lambda k: libs[k])
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: None)
    monkeypatch.setattr(kernels, "require_cuda_contiguous", lambda *a: None)
    return fused._launch(spec, pso, fit, meta, swarm, spec.limits(), seeds, p, uniforms, n_obs,
                         orient, layout, fused.gbest_interval(pso))


def test_tree_loop_on_demand_exact_trig_matches_the_general_loop(od_host_libs, monkeypatch):
    # Exact trig in the tree loop: the same bits as the general loop's
    # build (this CPU's sinf and cosf in both), drawing and replay, with the
    # run-time branches (uniform init, randomized inertia, the re-kick).
    rng = np.random.default_rng(27)
    s, p = 3, 64
    spec, _, fit, meta, swarm, n_obs, orient = _od_case(OD_EXACT_CASE, s, rng)
    pso = PSOConfig(iterations=4, inertia_mode="randomized", init_mode="uniform",
                    rekick_interval=2, rekick_threshold=-1.0)
    key = _od_key(spec, fit, n_obs, orient)
    seeds = torch.as_tensor(rng.integers(-2**31, 2**31, (s, 2)).astype(np.int32))
    u = torch.as_tensor(rng.random((s, fused.num_draws(pso), spec.dof, p), dtype=np.float32))
    for uniforms in (None, u):
        tree = _od_launch(od_host_libs, monkeypatch, spec, pso, fit, meta, swarm, seeds, p,
                          uniforms, n_obs, key=key)
        general = _od_launch(od_host_libs, monkeypatch, spec, pso, fit, meta, swarm, seeds, p,
                             uniforms, n_obs, key=key._replace(tree=False))
        assert torch.equal(tree[0], general[0]) and torch.equal(tree[1], general[1])
        assert torch.isfinite(tree[1]).all()


# The on-demand tree-loop keys the tie and NaN cases run: (OD_TREE_CASES
# tag, scene of the tie case: far boxes or capsules that no pose reaches).
OD_TIE_CASES = {"dual_arm_capsule": "capsule", "hand12": None, "hand12_box": "box"}


def _tie_case(zoo, s, p, shape=None):
    """The tree ``zoo`` with zero-length effector links (the effectors then
    ignore their own node's angles, so those DOFs are free) and limits of
    +-pi, a scene of ``shape`` far out of reach, replayed draws: particles
    20 (warp 0) and 40 (warp 1) step onto the goal in every DOF the
    effectors see and tie exactly, every other particle steps half as far,
    and the free DOFs differ by particle. ``(spec, pso, fit, meta, swarm, u,
    n_obs, free DOFs, particle 20's free value)``."""
    from ikpso_tpu_torch.models.chain import IKProblem, make_chain_spec

    n = zoo.num_nodes
    eff = list(zoo.effector_idx)
    length = zoo.length.clone()
    length[eff] = 0.0
    spec = make_chain_spec(list(zoo.parent), length, np.full((n, 3), -np.pi),
                           np.full((n, 3), np.pi), eff)
    free = [d for k in eff for d in range(3 * (k - 1), 3 * k)]
    problem = IKProblem(pose=torch.zeros(n, 3), origin=torch.zeros(3),
                        targets=torch.zeros(len(eff), 3))
    goal = torch.full((spec.dof,), 0.1)
    goal[free] = 0.0
    tgt = fk_ops.effector_positions(spec, fk_ops.angles_to_pose(spec, problem.pose[0], goal),
                                    problem.origin)
    batched = library.batched_problem(problem, tgt[None].expand(s, len(eff), 3))
    obs = None
    fit = FitnessConfig(angle_weight=0.0)
    if shape is not None:
        obs = Obstacles.from_boxes([(60.0, 60.0, 60.0), (-60.0, 60.0, -60.0)],
                                   [(0.5, 0.5, 0.5), (0.5, 0.5, 0.5)])
        fit = FitnessConfig(angle_weight=0.0, collision_shape=shape)
    meta = pack_meta(spec, fit, obs)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched))
    pso = PSOConfig(iterations=1, inertia_mode="canonical")
    u = torch.full((s, fused.num_draws(pso), spec.dof, p), 0.55)
    u[:, 0, :, [20, 40]] = 0.6  # v0 = 2u - 1: x after one step = 0.5 v0 = 0.1, the goal
    ignored = torch.linspace(0.05, 0.95, p).flip(0)
    u[:, 0, free, :] = ignored
    w20 = np.float32(0.5) * (np.float32(ignored[20].item()) * np.float32(2) - np.float32(1))
    return spec, pso, fit, meta, swarm, u, 0 if obs is None else obs.count, free, w20


@pytest.mark.parametrize("tag", sorted(OD_TIE_CASES))
def test_tree_loop_on_demand_tie_goes_to_the_least_particle_id(od_host_libs, monkeypatch,
                                                              tag):
    # The tie across warps (particles 20 and 40) on the on-demand keys of
    # the tree loop, with their scene far away: gbest carries particle 20's
    # free DOFs, as the plain twin's torch.argmin has it.
    s, p = 2, 64
    zoo = _od_case(tag, 1, np.random.default_rng(0))[0]
    spec, pso, fit, meta, swarm, u, n_obs, free, w20 = _tie_case(zoo, s, p, OD_TIE_CASES[tag])
    assert kernels.kernel_a_layout(spec, p, n_obs, fit.collision_shape).tree
    seeds = torch.zeros((s, 2), dtype=torch.int32)
    gb, gv = _od_launch(od_host_libs, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, u,
                        n_obs)
    want = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p, u,
                                   n_obs)
    assert torch.equal(gb, want[0]) and torch.equal(gv, want[1])
    assert (gv < 3e38).all()
    np.testing.assert_array_equal(gb[:, free].numpy(), np.full((s, len(free)), w20))


@pytest.mark.parametrize("nan_ids,first", [((40, 50), 40), ((50, 5), 5)])
@pytest.mark.parametrize("tag", sorted(OD_TIE_CASES))
def test_tree_loop_on_demand_source_puts_nan_first(od_host_libs, monkeypatch, tag, nan_ids,
                                                   first):
    # NaN in the first position draw of two particles at P = 64 (uniform
    # init, the case's scene): NaN goes first, the first NaN by id, as the
    # plain twin's torch.argmin has it; in the box ring a NaN pose scores
    # the penalty instead (no axis separates it), as in the plain twin.
    rng = np.random.default_rng(6)
    s, p = 2, 64
    spec, _, fit, meta, swarm, n_obs, orient = _od_case(tag, s, rng)
    pso = PSOConfig(iterations=2, inertia_mode="canonical", init_mode="uniform")
    u = torch.as_tensor(rng.random((s, fused.num_draws(pso), spec.dof, p), dtype=np.float32))
    u[:, 0, 0, list(nan_ids)] = float("nan")
    seeds = torch.zeros((s, 2), dtype=torch.int32)
    gb, gv = _od_launch(od_host_libs, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, u,
                        n_obs, orient)
    want = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p, u,
                                   n_obs, use_orientation=orient)
    assert same(gb, want[0]) and same(gv, want[1])
    if fit.collision_shape == "box" and n_obs:
        assert not torch.isnan(gv).any()
        return
    lim = spec.limits()
    lo_c, hi_c = torch.clamp_min(lim[0], -fused.TWO_PI), torch.clamp_max(lim[1], fused.TWO_PI)
    assert torch.isnan(gv).all() and same(gb, lo_c + u[:, 0, :, first] * (hi_c - lo_c))


def test_hand12_box_tree_loop_matches_jax_interpreted_kernel(od_host_libs, monkeypatch):
    # hand12 (an on-demand tree of 36 DOFs) in the near box ring, one JAX
    # tile (S=8, P=128), uniform init, 2 iterations, on one injected uniform
    # stream: JAX's fused_solve_raw under the Pallas interpreter, the plain
    # twin and kernel A's tree loop.
    # Kernel A is the plain twin bit for bit, and both meet JAX's kernel at
    # the replay bar of tests/test_fused.py:257-258 (angles atol 5e-4, value
    # rtol 1e-3).
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ikpso_tpu.models import library as jlib
    from ikpso_tpu.models.chain import IKProblem as JProblem
    from ikpso_tpu.models.chain import Obstacles as JObstacles
    from ikpso_tpu.models.chain import make_chain_spec as j_chain_spec
    from ikpso_tpu.ops import fk as jfk
    from ikpso_tpu.pso.fused import fused_solve_raw
    from ikpso_tpu.utils.configio import load_config as j_load_config
    from ikpso_tpu_torch.models import convert
    from test_torch_fused import (ATOL_ANGLES, ATOL_VALUE, RTOL_VALUE, SW, _configs, _packs,
                                  tpu_layout)

    smoke = _chip_smoke()
    doc, n, effectors = smoke.CUT_TREES["hand12"]
    full = j_load_config(str(smoke.CONFIG_DIR / f"{doc}.json")).spec
    spec_j = j_chain_spec(np.asarray(full.parent)[:n], np.asarray(full.length)[:n],
                          np.asarray(full.min_rotation)[:n], np.asarray(full.max_rotation)[:n],
                          effectors, np.asarray(full.effector_weight)[:n])
    rng = np.random.default_rng(19)
    s, p = 8, 128
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    ang = (lo + rng.random((s, spec_j.dof)) * (hi - lo)).astype(np.float32)
    problem_j = JProblem(pose=jnp.zeros((n, 3)), origin=jnp.zeros(3),
                         targets=jnp.zeros((len(effectors), 3)))
    pose = jfk.angles_to_pose(spec_j, jnp.zeros((s, 3)), jnp.asarray(ang))
    targets = jfk.fk_points(spec_j, pose, problem_j.origin)[:, list(effectors), :]
    batched_j = jlib.batched_problem(problem_j, targets)
    spec = convert.chain_spec_from(spec_j)
    near = smoke._near_scene(spec, "cpu")
    obs_j = JObstacles.from_boxes(near.center.numpy(), 2.0 * near.half_extent.numpy())
    pso_j, fit_j = _configs(iterations=2, init_mode="uniform", collision_shape="box")
    meta_j, swarm_j = _packs(spec_j, batched_j, fit_j, obs_j)
    limits_j = jnp.stack([spec_j.min_rotation[1:].reshape(-1),
                          spec_j.max_rotation[1:].reshape(-1)])
    pso, fit = convert.pso_config_from(pso_j), convert.fitness_config_from(fit_j)
    u = rng.random((s, fused.num_draws(pso), spec.dof, p), dtype=np.float32)
    gb_j, gv_j = fused_solve_raw(
        spec_j, pso_j, fit_j, meta_j, swarm_j, limits_j, jnp.zeros((s, 2), jnp.int32), p,
        obs_j.count, interpret=pltpu.InterpretParams(), uniforms=jnp.asarray(tpu_layout(u)),
        swarms_per_tile=SW)
    meta = pack_meta(spec, fit, convert.obstacles_from(obs_j))
    np.testing.assert_array_equal(meta.numpy(), np.asarray(meta_j))
    swarm, seeds, u = (torch.tensor(np.asarray(swarm_j)), torch.zeros((s, 2), dtype=torch.int32),
                       torch.as_tensor(u))
    hits = []

    def recording(*args, **kw):
        f = fk_fitness_plain(*args, **kw)
        hits.append(int((f >= 3e38).sum()))
        return f

    monkeypatch.setattr(fused, "fk_fitness_plain", recording)
    gb, gv = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p, u,
                                     obs_j.count)
    assert sum(hits) > 0, "the ring must reject some particle"
    assert kernels.kernel_a_layout(spec, p, obs_j.count, "box").tree
    got = _od_launch(od_host_libs, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, u,
                     obs_j.count)
    assert torch.equal(got[0], gb) and torch.equal(got[1], gv)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), atol=ATOL_ANGLES)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_j), rtol=RTOL_VALUE, atol=ATOL_VALUE)
    assert (gv < 3e38).all()


@pytest.mark.parametrize("model", ["dual_arm_14dof", "humanoid_45dof", "reference_arm",
                                   "snake_30dof"])
def test_tree_loop_tie_goes_to_the_least_particle_id(host_lib, monkeypatch, model):
    # The tree loop: the zoo tree with zero-length effector links (the
    # effectors then ignore their own node's angles, so those DOFs are free;
    # reference_arm's three effector children have no length already) and
    # limits of +-pi. Particles 20 (warp 0) and 40 (warp 1) step onto the goal
    # in every DOF the effectors see and tie exactly; every other particle
    # steps half as far. The free DOFs differ by particle, so gbest must
    # carry particle 20's: the first minimum by id across the warp slots.
    s, p = 2, 64
    spec, pso, fit, meta, swarm, u, _, free, w20 = _tie_case(getattr(library, model)()[0], s, p)
    assert kernels.kernel_a_layout(spec, p).tree
    seeds = torch.zeros((s, 2), dtype=torch.int32)
    gb, gv = _run_host(host_lib, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, u)
    want = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p, u)
    assert torch.equal(gb, want[0]) and torch.equal(gv, want[1])
    np.testing.assert_array_equal(gb[:, free].numpy(), np.full((s, len(free)), w20))


@pytest.mark.parametrize("nan_ids,first", [((40, 50), 40), ((50, 5), 5)])
@pytest.mark.parametrize("model,threads", [("arm_7dof", 256), ("arm_7dof", 1024),
                                           ("dual_arm_14dof", 1024),
                                           ("humanoid_45dof", 512),
                                           ("reference_arm", 256), ("snake_30dof", 256)])
def test_kernel_a_source_puts_nan_first(host_lib, monkeypatch, model, threads, nan_ids,
                                        first):
    # A block whose lvals mix NaN with numbers: uniform init with NaN in
    # the first position draw of the particles in nan_ids. The plain twin's
    # torch.argmin returns the first NaN; so must both argmins of kernel A.
    rng = np.random.default_rng(5)
    s, p = 2, 64
    spec, fit, meta, swarm = _problem(model, s, rng)
    pso = PSOConfig(iterations=2, inertia_mode="canonical", init_mode="uniform")
    u = torch.as_tensor(rng.random((s, fused.num_draws(pso), spec.dof, p), dtype=np.float32))
    u[:, 0, 0, list(nan_ids)] = float("nan")
    seeds = torch.zeros((s, 2), dtype=torch.int32)
    gb, gv = _run_host(host_lib, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, u,
                       threads=threads)
    want = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p, u)
    assert torch.isnan(gv).all() and same(gb, want[0]) and same(gv, want[1])
    lim = spec.limits()
    lo_c, hi_c = torch.clamp_min(lim[0], -fused.TWO_PI), torch.clamp_max(lim[1], fused.TWO_PI)
    assert same(gb, lo_c + u[:, 0, :, first] * (hi_c - lo_c))


@pytest.mark.parametrize("threads", [256, 1024])
def test_kernel_a_source_scores_nan_poses_at_the_penalty(host_lib, monkeypatch, threads):
    # Every pose collides (penalty_tie_case's box): the box collider scores
    # a pose with a NaN angle at the collision penalty too (a NaN fails
    # every separating-axis test, so no axis separates it), as the plain
    # twin and JAX do, and the tie at the penalty still goes to particle 0.
    # The capsule collider's rule is the other one: a NaN pose is no hit
    # (test_kernel_a_source_scores_nan_capsule_poses_as_misses).
    spec, pso, fit, meta, swarm, u, n_obs, want = penalty_tie_case(p=64)
    u = u.clone()
    u[:, 0, 0, [41, 57]] = float("nan")
    seeds = torch.zeros((swarm.shape[0], 2), dtype=torch.int32)
    got = _run_host(host_lib, monkeypatch, spec, pso, fit, meta, swarm, seeds, 64, u, n_obs,
                    threads=threads)
    plain = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, 64, u,
                                    n_obs)
    assert same(got[0], plain[0]) and same(got[1], plain[1])
    assert torch.equal(got[0], want)


@pytest.mark.parametrize("threads", [256, 1024])
def test_kernel_a_source_scores_nan_capsule_poses_as_misses(host_lib, monkeypatch, threads):
    # penalty_tie_case's box as a capsule scene: every finite pose collides,
    # but the capsule collider's distances of a pose with a NaN angle are
    # NaN (jnp.maximum's rule), so it is no hit and scores NaN, and NaN goes
    # first: gbest is particle 41's initial position and gval NaN, as the
    # plain twin gives them.
    spec, pso, _, _, swarm, u, n_obs, _ = penalty_tie_case(p=64)
    fit = FitnessConfig(angle_weight=0.0, collision_shape="capsule")
    meta = pack_meta(spec, fit, Obstacles.from_boxes([(0.0, 0.0, 0.0)],
                                                     [(100.0, 100.0, 100.0)]))
    u = u.clone()
    u[:, 0, 0, [41, 57]] = float("nan")
    seeds = torch.zeros((swarm.shape[0], 2), dtype=torch.int32)
    got = _run_host(host_lib, monkeypatch, spec, pso, fit, meta, swarm, seeds, 64, u, n_obs,
                    threads=threads)
    plain = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, 64, u,
                                    n_obs)
    assert same(got[0], plain[0]) and same(got[1], plain[1])
    lim = spec.limits()
    lo_c, hi_c = torch.clamp_min(lim[0], -fused.TWO_PI), torch.clamp_max(lim[1], fused.TWO_PI)
    assert torch.isnan(got[1]).all() and same(got[0], lo_c + u[:, 0, :, 41] * (hi_c - lo_c))


def test_capsule_nan_pose_is_a_miss_in_jax_the_plain_twin_and_kernel_a(host_lib,
                                                                       monkeypatch):
    # A pose with a NaN angle in a capsule scene. JAX's capsule
    # collider (ops/collision.py::chain_collides_capsule) and the port's
    # plain one call it no hit, so its fitness is NaN in JAX and in the
    # port, not the penalty. Then whole solves of one JAX tile (S=8,
    # P=128, uniform init, 2 iterations, the replay scene as capsules):
    # JAX's fused_solve_raw under the Pallas interpreter, fused_solve_plain
    # and kernel A's source on the same injected uniforms, NaN in particle
    # 37's first position draw of swarms 1 and 5. The swarms without a NaN
    # agree to the replay bar (JAX) and bit for bit (kernel A); each NaN
    # swarm's gval is NaN in all three (a hit would leave it finite: every
    # other particle is finite), and kernel A's gbest is the plain twin's.
    # (JAX's gbest there is its argmin's: a NaN minimum matches no id.)
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ikpso_tpu.models.chain import Obstacles as JObstacles
    from ikpso_tpu.ops import fitness as jfitness
    from ikpso_tpu.ops import fk as jfk
    from ikpso_tpu.ops.collision import chain_collides_capsule as j_capsule
    from ikpso_tpu.pso.fused import fused_solve_raw
    from ikpso_tpu_torch.models import convert
    from ikpso_tpu_torch.ops import fitness as port_fitness
    from ikpso_tpu_torch.ops.collision import chain_collides_capsule
    from test_torch_fused import (ATOL_ANGLES, ATOL_VALUE, REPLAY_SCENE, RTOL_VALUE, SW,
                                  _configs, _jax_case, _packs, tpu_layout)

    rng = np.random.default_rng(17)
    s, p, nan_rows = 8, 128, [1, 5]
    spec_j, batched_j = _jax_case(s, rng)
    pso_j, fit_j = _configs(iterations=2, init_mode="uniform", collision_shape="capsule")
    obs_j = JObstacles.from_boxes(**REPLAY_SCENE)
    spec, obs = convert.chain_spec_from(spec_j), convert.obstacles_from(obs_j)
    fit, pso = convert.fitness_config_from(fit_j), convert.pso_config_from(pso_j)

    # The colliders and the fitness on poses with a NaN angle.
    ang = np.tile(np.float32([0.3, -0.2, 0.5, 0.1, 0.4, -0.3, 0.2, 0.6, -0.1]), (4, 1))
    ang[np.arange(4), [0, 3, 5, 8]] = np.nan  # one NaN angle a pose, a node each
    ang_j = jnp.asarray(ang)
    pose_j = jfk.angles_to_pose(spec_j, jnp.broadcast_to(batched_j.pose[0, 0], (4, 3)), ang_j)
    pos_j, rot_j = jfk.fk(spec_j, pose_j, batched_j.origin[0])
    par = list(spec.parent[1:])
    hit_j = j_capsule(pos_j[:, 1:], rot_j[:, 1:], pos_j[:, par], spec_j.length[1:],
                      obs_j.center, obs_j.half_extent, obs_j.rot)
    pose = fk_ops.angles_to_pose(spec, torch.tensor(np.array(batched_j.pose[0, 0]))
                                 .expand(4, 3), torch.as_tensor(ang))
    pos, rot = fk_ops.fk(spec, pose, torch.tensor(np.array(batched_j.origin[0])))
    hit = chain_collides_capsule(pos[:, 1:], rot[:, 1:], pos[:, par], spec.length[1:],
                                 obs.center, obs.half_extent, obs.rot)
    assert not np.asarray(hit_j).any() and not hit.any()
    problem_j = batched_j.replace(pose=batched_j.pose[0], origin=batched_j.origin[0],
                                  targets=batched_j.targets[0])
    f_j = jfitness.fitness(spec_j, ang_j, problem_j, fit_j, obs_j)
    f = port_fitness.fitness(spec, torch.as_tensor(ang), convert.problem_from(problem_j),
                             fit, obs)
    assert np.isnan(np.asarray(f_j)).all() and torch.isnan(f).all()

    # Whole solves.
    meta_j, swarm_j = _packs(spec_j, batched_j, fit_j, obs_j)
    limits_j = jnp.stack([spec_j.min_rotation[1:].reshape(-1),
                          spec_j.max_rotation[1:].reshape(-1)])
    u = rng.random((s, fused.num_draws(pso), spec.dof, p), dtype=np.float32)
    u[nan_rows, 0, 0, 37] = np.nan
    gb_j, gv_j = fused_solve_raw(
        spec_j, pso_j, fit_j, meta_j, swarm_j, limits_j, jnp.zeros((s, 2), jnp.int32), p,
        obs_j.count, interpret=pltpu.InterpretParams(), uniforms=jnp.asarray(tpu_layout(u)),
        swarms_per_tile=SW)
    meta, swarm = pack_meta(spec, fit, obs), torch.tensor(np.array(swarm_j))
    seeds = torch.zeros((s, 2), dtype=torch.int32)
    u = torch.as_tensor(u)
    gb, gv = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p, u,
                                     obs.count)
    got = _run_host(host_lib, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, u, obs.count)
    assert same(got[0], gb) and same(got[1], gv)
    gb_j, gv_j = np.asarray(gb_j), np.asarray(gv_j)
    ok = [r for r in range(s) if r not in nan_rows]
    assert np.isnan(gv_j[nan_rows]).all() and torch.isnan(gv[nan_rows]).all()
    assert np.isfinite(gv_j[ok]).all() and torch.isfinite(gv[ok]).all()
    np.testing.assert_allclose(gb[ok].numpy(), gb_j[ok], atol=ATOL_ANGLES)
    np.testing.assert_allclose(gv[ok].numpy(), gv_j[ok], rtol=RTOL_VALUE, atol=ATOL_VALUE)


def test_layout_picks_the_short_bound_up_to_256_particles(monkeypatch):
    arm7, arm6 = library.arm_7dof()[0], library.arm_6dof()[0]
    for spec, orient in ((arm7, False), (arm6, False), (arm6, True)):
        for p, threads in ((32, 256), (128, 256), (256, 256), (288, 1024), (1024, 1024)):
            layout = kernels.kernel_a_layout(spec, p, use_orientation=orient)
            assert (layout.threads, layout.placement) == (threads, "registers")
            assert layout.static_bytes == kernels.short_static_bytes(spec, 0, orient, threads)
        assert kernels.max_particles(spec, use_orientation=orient) == 1024
    # The box scene too; the trees, the serial variant and an on-demand
    # short chain keep their one bound.
    assert kernels.kernel_a_layout(arm7, 128, 4, "box").threads == 256
    dual = library.dual_arm_14dof()[0]
    assert kernels.kernel_a_layout(dual, 128).threads == 1024
    # The trees' tree loop takes static shared memory of its own.
    assert (kernels.kernel_a_layout(dual, 128).static_bytes
            == kernels.tree_static_bytes(dual, 0, False, 1024))
    assert kernels.kernel_a_layout(arm7, 128, use_distance=True).threads == 1024

    # A P no instantiation takes raises before any library is loaded.
    def no_launch(*_):
        raise AssertionError("a kernel library was asked for")

    monkeypatch.setattr(kernels, "library", no_launch)
    fit = FitnessConfig(angle_weight=0.0)
    _, meta, swarm = _arm7(2, np.random.default_rng(1), fit)
    seeds = torch.zeros((2, 2), dtype=torch.int32)
    for p in (1056, 48, 0):
        with pytest.raises(ValueError, match="must be a multiple of 32"):
            fused.fused_solve(arm7, HEADLINE, fit, meta, swarm, arm7.limits(), seeds, p)


def test_short_static_bytes_match_the_kernels(tmp_path):
    # ShortShared's size, compiled by g++, against the Python reckoning.
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    (tmp_path / "cuda_runtime.h").write_text("#pragma once\n" + STANDIN + RUNNER.replace(
        '#include "cuda_runtime.h"', ""))
    for src in kernels.CSRC.glob("*.cuh"):
        (tmp_path / src.name).write_text(_host_source(src.read_text()))
    cases = [("Arm7Dof", c, False, t) for c in (0, 1, 2) for t in (256, 1024)]
    cases += [("Arm6Dof", 0, o, t) for o in (False, True) for t in (256, 1024)]
    # The trees' tree loop (TreeShared) at their thread bounds, with a scene
    # and the orientation term.
    tree = [("DualArm14", c, o, 1024) for c, o in ((0, False), (1, False), (0, True))]
    tree += [("Humanoid45", 0, o, 512) for o in (False, True)]
    tree += [("ReferenceArm", 0, False, 256), ("Snake30", 0, False, 256)]
    main = tmp_path / "static.cpp"
    main.write_text('#include <cstdio>\n#include "fused_solve.cuh"\nint main() {\n' + "".join(
        f'  std::printf("%zu\\n", sizeof(ikpso::{kind}<ikpso::{t}, {c}, '
        f'{str(o).lower()}, {th}>));\n' for kind, rows in (("ShortShared", cases),
                                                          ("TreeShared", tree))
        for t, c, o, th in rows) + "}\n")
    exe = tmp_path / "static"
    proc = subprocess.run(["g++", "-std=c++20", "-pthread", "-I", str(tmp_path), "-o",
                           str(exe), str(main)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = [int(v) for v in subprocess.run([str(exe)], capture_output=True,
                                          text=True).stdout.split()]
    specs = {"Arm7Dof": library.arm_7dof()[0], "Arm6Dof": library.arm_6dof()[0],
             "DualArm14": library.dual_arm_14dof()[0],
             "Humanoid45": library.humanoid_45dof()[0],
             "ReferenceArm": library.reference_arm()[0], "Snake30": library.snake_30dof()[0]}
    assert got == ([kernels.short_static_bytes(specs[t], c, o, th) for t, c, o, th in cases]
                   + [kernels.tree_static_bytes(specs[t], c, o, th) for t, c, o, th in tree])
    # Whole 16-byte units: the card rounds a kernel's static shared memory
    # so, and the launchers subtract these sizes from the opt-in maximum.
    assert all(v % 16 == 0 for v in got)
