"""Kernel A's cluster layout (``csrc/fused_solve_cluster.cuh``) compiled by
g++ for this CPU and held bit for bit against
``pso/fused.py::fused_solve_plain``.

The stand-in CUDA runtime runs every block of a launch at once, each CUDA
thread a ``std::thread``: a block's ``__syncthreads`` is a ``std::barrier``
over its threads, a cluster's ``cluster.sync()`` one over the threads of
all its blocks, ``map_shared_rank`` the same offset in another block's
dynamic shared memory (each block's filled with garbage before the
launch), ``__reduce_min_sync`` and ``__shfl_xor_sync`` an exchange through
a block buffer between two barriers. Three on-demand libraries of cluster
keys: ``hand21``'s tree, ``hand16`` (hand21 less its last finger: 17
nodes, 48 DOFs) and ``hand21`` with the box collider, each launched
through ``pso/fused.py``'s wrapper in the cluster layout. Cases: the
three over clusters of 2 blocks (P = 64, a few iterations), ``hand21`` in
one block and over 4 (P = 128), the canonical update and the run-time
branches (uniform init, randomized inertia, a gbest interval of 2, the
re-kick with its threshold), drawing and replay; a tie between blocks
that the first-minimum rule must decide by particle id, not by the column
in the block; NaN first across blocks (the plain twin's
``torch.argmin``).
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ikpso_tpu_torch.harness.trees import model_spec
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.models.chain import IKProblem, Obstacles, make_chain_spec
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.fitness_kernel import pack_meta, pack_swarm
from ikpso_tpu_torch.pso import fused
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.polish_soa import anchor_positions_flat
from ikpso_tpu_torch.utils import kernels
from ikpso_tpu_torch.utils.configio import load_config

from test_torch_branches import STANDIN as BRANCHES_STANDIN
from test_torch_kernel_a_layout import CONFIG_DIR

THREADED = r"""#include <barrier>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
struct StandinCluster {
  std::barrier<>* barrier;
  float** shared;
  int rank;
};
extern thread_local std::barrier<>* standin_barrier;
extern thread_local float* standin_shared;
extern thread_local unsigned long long* standin_words;
extern thread_local StandinCluster standin_cluster;
inline void __syncthreads() { standin_barrier->arrive_and_wait(); }"""

STANDIN = (BRANCHES_STANDIN
           .replace("#define __shared__\n", "#define __shared__ static\n")
           .replace("inline void __syncthreads() {}", THREADED)
           .replace("inline unsigned __reduce_min_sync(unsigned, unsigned v) { return v; }\n",
                    "")
           .replace("template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }",
                    """template <class T> T __shfl_xor_sync(unsigned, T v, int off) {
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
           .replace("""template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t*, void (*)(P...), A&&...) {
  return cudaSuccess;
}
""", "")
           .replace("  *n = 1;\n  return cudaSuccess;\n}\nnamespace cooperative_groups",
                    "  *n = 2;  // two clusters at once: the grid strides over the swarms\n"
                    "  return cudaSuccess;\n}\nnamespace cooperative_groups")
           .replace("""  unsigned block_rank() const { return 0; }
  void sync() const { __syncthreads(); }
  template <class T> T* map_shared_rank(T* p, int) const { return p; }""",
                    """  unsigned block_rank() const { return standin_cluster.rank; }
  void sync() const { standin_cluster.barrier->arrive_and_wait(); }
  template <class T> T* map_shared_rank(T* p, int r) const {
    const char* base = reinterpret_cast<const char*>(standin_shared);
    return reinterpret_cast<T*>(reinterpret_cast<char*>(standin_cluster.shared[r]) +
                                (reinterpret_cast<const char*>(p) - base));
  }""")
           + r"""
// A launch's blocks, all at once: one std::thread a CUDA thread, a barrier
// a block and one a cluster of `cl` blocks.
template <class K, class... A>
inline cudaError_t standin_run(unsigned g, unsigned b, unsigned cl, size_t smem, K k,
                               A&&... a) {
  if (cl == 0 || g % cl) return cudaErrorInvalidValue;
  std::vector<std::vector<float>> bufs(g, std::vector<float>(smem / sizeof(float) + 4,
                                                             -12345.0f));
  std::vector<float*> shared(g);
  std::vector<std::vector<unsigned long long>> words(g, std::vector<unsigned long long>(b));
  std::vector<std::unique_ptr<std::barrier<>>> blocks, clusters;
  for (unsigned x = 0; x < g; ++x) {
    shared[x] = bufs[x].data();
    blocks.emplace_back(new std::barrier<>(b));
  }
  for (unsigned c = 0; c < g / cl; ++c) clusters.emplace_back(new std::barrier<>(b * cl));
  std::vector<std::thread> threads;
  for (unsigned x = 0; x < g; ++x) {
    for (unsigned t = 0; t < b; ++t) {
      threads.emplace_back([&, x, t] {
        blockIdx.x = x; threadIdx.x = t; blockDim.x = b; gridDim.x = g;
        standin_barrier = blocks[x].get();
        standin_shared = shared[x];
        standin_words = words[x].data();
        standin_cluster = {clusters[x / cl].get(), shared.data() + (x / cl) * cl,
                           static_cast<int>(x % cl)};
        k(a...);
      });
    }
  }
  for (auto& th : threads) th.join();
  return cudaSuccess;
}
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*k)(P...), A&&... a) {
  unsigned cl = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i) {
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      cl = cfg->attrs[i].val.clusterDim.x;
    }
  }
  return standin_run(cfg->gridDim.x, cfg->blockDim.x, cl, cfg->dynamicSmemBytes, k, a...);
}
template <class K, class... A>
inline void standin_launch(unsigned g, unsigned b, size_t smem, cudaStream_t, K k, A... a) {
  standin_run(g, b, 1, smem, k, a...);
}
""")
RUNNER = r"""
#include "cuda_runtime.h"
thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
thread_local std::barrier<>* standin_barrier;
thread_local float* standin_shared;
thread_local unsigned long long* standin_words;
thread_local StandinCluster standin_cluster;
"""


def _host_source(text):
    text = text.replace("extern __shared__ float smem[];", "float* smem = standin_shared;")
    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\(", r"standin_launch(\2, \1, ",
                  text, flags=re.S)


def _hand21():
    return load_config(str(CONFIG_DIR / "hand21.json")).spec


def _hand16():
    """hand21 less its last finger: 17 nodes, 48 DOFs, 4 effectors."""
    full, n = _hand21(), 17
    return make_chain_spec(full.parent[:n], full.length[:n], full.min_rotation[:n],
                           full.max_rotation[:n], [4, 8, 12, 16], full.effector_weight[:n])


BOXES = Obstacles.from_boxes([(0.5, 0.3, 0.0), (-0.3, 0.5, 0.4)],
                             [(0.2, 0.2, 0.2), (0.25, 0.25, 0.25)])
# The host libraries: a spec, its collider and obstacles.
HOST_MODELS = {"hand21": ("hand21", None), "hand16": ("hand16", None),
               "hand21_box": ("hand21", BOXES)}


@pytest.fixture(scope="module")
def cluster_libs(tmp_path_factory):
    """``{key: lib}``: the on-demand library of each ``HOST_MODELS`` model
    (a cluster key), compiled by g++ for this CPU."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    tmp = tmp_path_factory.mktemp("host_cluster")
    (tmp / "cuda_runtime.h").write_text("#pragma once\n" + STANDIN)
    (tmp / "cooperative_groups.h").write_text('#pragma once\n#include "cuda_runtime.h"\n')
    for src in kernels.CSRC.glob("*.cu*"):
        (tmp / src.name).write_text(_host_source(src.read_text()))
    keys = {}
    for name, (model, obs) in HOST_MODELS.items():
        spec = _spec(model)
        collider = 0 if obs is None else kernels.kernel_variant(spec, obs.count, "box",
                                                                False)[1]
        keys[name] = kernels.on_demand_key(spec, collider, False)
        assert keys[name].cluster and keys[name].scratch
    libs, procs = {}, {}
    for name, key in keys.items():
        cu = tmp / f"{name}_host.cu"
        cu.write_text(RUNNER + kernels.on_demand_source(key))
        so = cu.with_suffix(".so")
        procs[keys[name]] = (so, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-shared",
             "-fPIC", "-pthread", "-I", str(tmp), "-x", "c++", str(cu), "-o", str(so)],
            stderr=subprocess.PIPE, text=True))
    for key, (so, proc) in procs.items():
        err = proc.communicate()[1]
        assert proc.returncode == 0, err[-4000:]
        lib = ctypes.CDLL(str(so))
        for fn, sig in kernels.OD_SIGNATURES.items():
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


def _run_host(libs, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, uniforms, cluster,
              num_obstacles=0):
    """Kernel A's launch (``fused._launch``) on CPU tensors through the g++
    build, in the cluster layout over ``cluster`` blocks a swarm."""
    layout = fused._check_args(spec, pso, fit, swarm, spec.limits(), seeds, p, uniforms,
                               num_obstacles)._replace(scratch=False, placement="shared",
                                                       scratch_planes=0, cluster=cluster)
    monkeypatch.setattr(kernels, "on_demand_library", lambda key: libs[key])
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: None)
    monkeypatch.setattr(kernels, "require_cuda_contiguous", lambda *a: None)
    return fused._launch(spec, pso, fit, meta, swarm, spec.limits(), seeds, p, uniforms,
                         num_obstacles, False, layout, fused.gbest_interval(pso))


def _spec(model):
    return {"hand21": _hand21, "hand16": _hand16}.get(model, lambda: model_spec(model)[0])()


def _problem(model, s, rng, obstacles=None):
    """``(spec, fit, meta, swarm)``: ``s`` reachable targets for ``model``
    (hand21, hand16 or a zoo model), with ``obstacles`` the box collider."""
    spec = _spec(model)
    lim = spec.limits().numpy()
    ang = (lim[0] + rng.random((s, spec.dof)) * (lim[1] - lim[0])).astype(np.float32)
    origin = torch.zeros(3)
    pose0 = torch.zeros(spec.num_nodes, 3)
    pose = fk_ops.angles_to_pose(spec, pose0[0].expand(s, 3), torch.as_tensor(ang))
    targets = fk_ops.fk_points(spec, pose, origin)[:, list(spec.effector_idx)]
    problem = IKProblem(pose=pose0, origin=origin, targets=targets[0])
    batched = library.batched_problem(problem, targets)
    fit = FitnessConfig(angle_weight=0.5,
                        **({} if obstacles is None else {"collision_shape": "box"}))
    meta = pack_meta(spec, fit, obstacles)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched))
    return spec, fit, meta, swarm


PSO_CASES = {
    "canonical": PSOConfig(iterations=4, inertia_mode="canonical", inertia=0.5,
                           inertia_end=0.2),
    # The run-time branches: uniform init, randomized inertia, gbest every 2
    # iterations and the re-kick every 2 above a threshold.
    "branches": PSOConfig(iterations=4, inertia_mode="randomized", init_mode="uniform",
                          gbest_interval=2, rekick_interval=2, rekick_threshold=1e-6),
}


@pytest.mark.parametrize("update", sorted(PSO_CASES))
@pytest.mark.parametrize("model,cluster,p", [("hand21", 2, 64), ("hand16", 2, 64),
                                             ("hand21_box", 2, 64), ("hand21", 1, 64),
                                             ("hand21", 4, 128)])
def test_cluster_source_matches_the_plain_solve(cluster_libs, monkeypatch, model, cluster, p,
                                                update):
    rng = np.random.default_rng(16)
    s = 3
    name, obs = HOST_MODELS[model]
    spec, fit, meta, swarm = _problem(name, s, rng, obs)
    n_obs = 0 if obs is None else obs.count
    pso = PSO_CASES[update]
    seeds = torch.as_tensor(rng.integers(-2**31, 2**31, (s, 2)).astype(np.int32))
    u = torch.as_tensor(rng.random((s, fused.num_draws(pso), spec.dof, p), dtype=np.float32))
    before = fused.fused_solve.launches
    for uniforms in (None, u):  # the drawing form, then the replay form
        want = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p,
                                       uniforms, n_obs)
        got = _run_host(cluster_libs, monkeypatch, spec, pso, fit, meta, swarm, seeds, p,
                        uniforms, cluster, n_obs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fused.fused_solve.launches == before + 2


# hand21's and hand16's trees with zero-length fingertip links (the
# effectors ignore the fingertips' angles): (parents, lengths, effectors,
# the ignored DOFs).
HAND_PARENTS = [-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19]
TIE_CHAINS = {
    name: (HAND_PARENTS[:n], [0.0] + [0.3, 0.3, 0.3, 0.0] * (n // 4), list(range(4, n, 4)),
           [d for k in range(4, n, 4) for d in range(3 * (k - 1), 3 * k)])
    for name, n in (("hand16", 17), ("hand21", 21))
}


def _tie_chain(model, swarms):
    parents, lengths, effectors, free = TIE_CHAINS[model]
    n = len(parents)
    spec = make_chain_spec(parents, lengths, np.full((n, 3), -np.pi), np.full((n, 3), np.pi),
                           effectors)
    problem = IKProblem(pose=torch.zeros(n, 3), origin=torch.zeros(3),
                        targets=torch.zeros(len(effectors), 3))
    goal = torch.full((spec.dof,), 0.1)
    goal[free] = 0.0
    tgt = fk_ops.effector_positions(spec, fk_ops.angles_to_pose(spec, problem.pose[0], goal),
                                    problem.origin)
    batched = library.batched_problem(problem, tgt[None].expand(swarms, len(effectors), 3))
    fit = FitnessConfig(angle_weight=0.0)
    meta = pack_meta(spec, fit)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched))
    return spec, fit, meta, swarm, free


@pytest.mark.parametrize("model", sorted(TIE_CHAINS))
def test_cluster_tie_goes_to_the_least_particle_id(cluster_libs, monkeypatch, model):
    # Particles 20 (block 0's column 20) and 40 (block 1's column 8) step
    # onto the goal in every DOF the effectors see and tie exactly; every
    # other particle steps half as far. The ignored DOFs differ by
    # particle, so gbest must carry particle 20's: the first minimum by id
    # in the swarm, not by column in a block.
    s, p = 2, 64
    spec, fit, meta, swarm, free = _tie_chain(model, s)
    pso = PSOConfig(iterations=1, inertia_mode="canonical")
    u = torch.full((s, fused.num_draws(pso), spec.dof, p), 0.55)
    u[:, 0, :, [20, 40]] = 0.6  # v0 = 2u - 1: x after one step = 0.5 v0 = 0.1, the goal
    ignored = torch.linspace(0.05, 0.95, p).flip(0)
    u[:, 0, free, :] = ignored
    seeds = torch.zeros((s, 2), dtype=torch.int32)
    gb, gv = _run_host(cluster_libs, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, u, 2)
    want = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p, u)
    assert torch.equal(gb, want[0]) and torch.equal(gv, want[1])
    w20 = np.float32(0.5) * (np.float32(ignored[20].item()) * np.float32(2) - np.float32(1))
    np.testing.assert_array_equal(gb[:, free].numpy(), np.full((s, len(free)), w20))


def same(a, b):
    """Equal, NaN where the other is NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("nan_ids,first", [((40, 50), 40), ((50, 5), 5)])
@pytest.mark.parametrize("model", ["hand16", "hand21"])
def test_cluster_puts_nan_first(cluster_libs, monkeypatch, model, nan_ids, first):
    # A block with some NaN fitness values: uniform init with NaN in the
    # first position draw of the particles in nan_ids; the first of them by
    # particle id wins, as torch.argmin returns the first NaN.
    rng = np.random.default_rng(5)
    s, p = 2, 64
    spec, fit, meta, swarm = _problem(model, s, rng)
    pso = PSOConfig(iterations=2, inertia_mode="canonical", init_mode="uniform")
    u = torch.as_tensor(rng.random((s, fused.num_draws(pso), spec.dof, p), dtype=np.float32))
    u[:, 0, 0, list(nan_ids)] = float("nan")
    seeds = torch.zeros((s, 2), dtype=torch.int32)
    gb, gv = _run_host(cluster_libs, monkeypatch, spec, pso, fit, meta, swarm, seeds, p, u, 2)
    want = fused.fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, p, u)
    assert torch.isnan(gv).all() and same(gb, want[0]) and same(gv, want[1])
    # gbest is that particle's initial position, its first DOF NaN.
    lim = spec.limits()
    lo_c, hi_c = torch.clamp_min(lim[0], -fused.TWO_PI), torch.clamp_max(lim[1], fused.TWO_PI)
    assert same(gb, lo_c + u[:, 0, :, first] * (hi_c - lo_c))

