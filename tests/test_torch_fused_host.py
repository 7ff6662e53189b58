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
twin's ``torch.argmin``), at both short bounds and in the general kernel
(the dual arm's ``fused_solve_kernel``). Besides, ``kernel_a_layout``'s choice of the bound: 256 threads up to 256
particles, 1,024 above, and a P no instantiation takes raises before any
launch.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.models.chain import Obstacles
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.fitness_kernel import pack_meta, pack_swarm
from ikpso_tpu_torch.pso import fused
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.polish_soa import anchor_positions_flat
from ikpso_tpu_torch.utils import kernels

from test_torch_branches import STANDIN as BRANCHES_STANDIN
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
@pytest.mark.parametrize("model", ["dual_arm_14dof", "snake_30dof"])
def test_general_kernel_source_matches_the_plain_solve(host_lib, monkeypatch, model,
                                                       threshold):
    # fused_solve_kernel (the trees' and snake_30dof's register layout, v
    # and lbest in shared memory): uniform init, randomized inertia and the
    # re-kick every 2 iterations, of every swarm or above a threshold that
    # the block argmin's winning value decides, drawing and replay.
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


@pytest.mark.parametrize("nan_ids,first", [((40, 50), 40), ((50, 5), 5)])
@pytest.mark.parametrize("model,threads", [("arm_7dof", 256), ("arm_7dof", 1024),
                                           ("dual_arm_14dof", 1024)])
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
    # Every pose collides (penalty_tie_case's box): poses with a NaN angle
    # score the collision penalty too, as in the plain twin, and the tie at
    # the penalty still goes to particle 0. (The capsule collider calls a
    # NaN pose a hit where the plain one does not: ROADMAP queue C.)
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
    assert kernels.kernel_a_layout(library.dual_arm_14dof()[0], 128).threads == 1024
    assert kernels.kernel_a_layout(library.dual_arm_14dof()[0], 128).static_bytes == 0
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
    main = tmp_path / "static.cpp"
    main.write_text('#include <cstdio>\n#include "fused_solve.cuh"\nint main() {\n' + "".join(
        f'  std::printf("%zu\\n", sizeof(ikpso::ShortShared<ikpso::{t}, {c}, '
        f'{str(o).lower()}, {th}>));\n' for t, c, o, th in cases) + "}\n")
    exe = tmp_path / "static"
    proc = subprocess.run(["g++", "-std=c++20", "-pthread", "-I", str(tmp_path), "-o",
                           str(exe), str(main)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = [int(v) for v in subprocess.run([str(exe)], capture_output=True,
                                          text=True).stdout.split()]
    specs = {"Arm7Dof": library.arm_7dof()[0], "Arm6Dof": library.arm_6dof()[0]}
    assert got == [kernels.short_static_bytes(specs[t], c, o, th) for t, c, o, th in cases]
