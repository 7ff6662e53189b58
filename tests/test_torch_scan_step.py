"""The scan solver's step (csrc/scan_step.cu(h), pso/solver.py::scan_step).

On the card every iteration of a kernel-C scan solve is one launch of the
step: the re-kick, the velocity, the clamp, kernel B's evaluation, lbest
and the first-minimum gbest. Held here, on the CPU:

  * routing: ``solve`` runs ``pso_iteration`` on the CPU (the step's
    launch count stays 0), for the plain GJK fitness and for any other
    callable;
  * the step's second pass, as its plain model (``block_first_min`` then
    ``first_min_of_blocks``), against ``torch.argmin`` and JAX's
    ``_swarm_argmin``: ties straddling a block boundary, NaN, a P that is
    no multiple of the block;
  * ``make_kernel_fitness``'s object: the packing of JAX's
    ``make_pallas_fitness`` (read from its closure), and the values;
  * the kernel's own source, compiled by g++ against a stand-in CUDA
    runtime that runs each CUDA thread of a block as a thread with
    ``__syncthreads`` a barrier (blocks in turn), with
    ``-ffp-contract=off`` as the card builds with ``-fmad=false``: bit for
    bit ``pso_iteration`` with kernel C's plain twin, step after step, in
    every inertia mode, with the re-kick, a box and a capsule scene, the
    orientation term, the serial-chain and on-demand entries, forced ties
    across blocks, NaN, a ragged P and the ``gbest_reduce`` hook.

On the card ``chip_smoke.py``'s ``scan_replay`` holds the built kernel to
the same twin with ``torch.equal``.
"""

from __future__ import annotations

import ctypes
import inspect
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikpso_tpu.models import library as jlib
from ikpso_tpu.ops.pallas_fitness import make_pallas_fitness
from ikpso_tpu.pso import solver as jsolver
from ikpso_tpu_torch.harness.obstacles import obstacle_scene
from ikpso_tpu_torch.harness.trees import model_spec
from ikpso_tpu_torch.models import convert, library
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops import fitness_kernel as fkm
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.philox import step_uniforms
from ikpso_tpu_torch.pso import solver
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.utils import kernels
from test_torch_branches import STANDIN as BRANCHES_STANDIN
from test_torch_fitness import _kernel_c_case
from test_torch_fused import torch_single_thread  # noqa: F401 (a fixture)

# --- routing -----------------------------------------------------------------


def _scan_problem(s, rng, model="arm_7dof"):
    spec, problem = model_spec(model, "cpu")
    noise = rng.normal(scale=0.1, size=(s,) + tuple(problem.targets.shape))
    targets = problem.targets[None] + torch.as_tensor(noise.astype(np.float32))
    return spec, library.batched_problem(problem, targets)


@pytest.mark.parametrize("fitness_kind", ["kernel", "plain", "callable", "gjk"])
def test_solve_on_the_cpu_runs_pso_iteration(fitness_kind, monkeypatch):
    rng = np.random.default_rng(1)
    spec, batched = _scan_problem(3, rng)
    pso = PSOConfig(iterations=3, inertia_mode="randomized", init_mode="warm")
    fit = FitnessConfig(angle_weight=0.3)
    obstacles = None
    if fitness_kind == "gjk":
        fit = FitnessConfig(angle_weight=0.3, collision_backend="gjk")
        obstacles = obstacle_scene(spec, 2)
    kernel_fn = fkm.make_kernel_fitness(spec, batched, FitnessConfig(angle_weight=0.3))
    fitness_fn = {"kernel": kernel_fn, "callable": kernel_fn.plain}.get(fitness_kind)
    calls = []
    real = solver.pso_iteration

    def counted(*args, **kw):
        calls.append(kw["iteration"])
        return real(*args, **kw)

    monkeypatch.setattr(solver, "pso_iteration", counted)
    before = solver.scan_step.launches
    res = solver.solve(spec, batched, torch.Generator().manual_seed(0), pso, fit,
                       obstacles=obstacles, num_particles=40, fitness_fn=fitness_fn)
    assert calls == [0, 1, 2]
    assert solver.scan_step.launches == before
    assert res.trace.shape == (4, 3) and bool(torch.isfinite(res.fitness).all())


def test_scan_step_on_cpu_tensors_is_pso_iteration():
    rng = np.random.default_rng(2)
    spec, batched = _scan_problem(2, rng)
    fitness = fkm.make_kernel_fitness(spec, batched, FitnessConfig(angle_weight=0.3))
    pso = PSOConfig(iterations=2, inertia_mode="canonical", inertia_end=0.2, rekick_interval=1)
    state, u, lo, hi = _init(spec, batched, fitness, pso, 64, rng)
    before = solver.scan_step.launches
    got = solver.scan_step(fitness, *state, u, torch.stack((lo, hi)), pso, iteration=1)
    want = solver.pso_iteration(*state, u, fitness, lo, hi, pso, iteration=1)
    assert solver.scan_step.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --- the second pass, plain ------------------------------------------------


def _lbest_values(s, p, rng, kind):
    vals = rng.integers(0, 4, size=(s, p)).astype(np.float32)  # many exact ties
    if kind == "nan":
        vals[0, p - 3] = np.nan
        vals[1, [5, p // 2]] = np.nan
    elif kind == "straddle":
        # Equal minima either side of the first block edge (one block: inside it).
        vals += 10.0
        vals[:, STRADDLE[p > 256]] = 1.0
    return vals


STRADDLE = {True: [255, 256], False: [100, 200]}


@pytest.mark.parametrize("p", [256, 300, 1000, 1024])
@pytest.mark.parametrize("kind", ["ties", "straddle", "nan"])
def test_second_pass_model_is_the_first_minimum(p, kind):
    rng = np.random.default_rng(p)
    vals = _lbest_values(3, p, rng, kind)
    coords = rng.normal(size=(3, p, 9)).astype(np.float32)
    cand_val, cand_id = solver.block_first_min(torch.as_tensor(vals), 256)
    assert cand_val.shape == (3, -(-p // 256))
    val, idx = solver.first_min_of_blocks(cand_val, cand_id)
    want_idx = torch.argmin(torch.as_tensor(vals), dim=-1)
    assert torch.equal(idx, want_idx)
    if kind == "straddle":
        assert bool((idx == STRADDLE[p > 256][0]).all())
    j_val, j_coords = jsolver._swarm_argmin(jnp.asarray(vals), jnp.asarray(coords))
    np.testing.assert_array_equal(val.numpy(), np.asarray(j_val))
    np.testing.assert_array_equal(coords[np.arange(3), idx.numpy()], np.asarray(j_coords))


# --- the packing object ----------------------------------------------------


@pytest.mark.parametrize("shape", ["none", "box", "capsule"])
def test_kernel_fitness_carries_make_pallas_fitness_packing(shape):
    rng = np.random.default_rng(19)
    spec_j, batched_j, obs_j, fit_j, x = _kernel_c_case(shape, rng)
    want_fn = make_pallas_fitness(spec_j, batched_j, fit=fit_j, obstacles=obs_j,
                                  interpret=True)
    jax_packed = inspect.getclosurevars(want_fn).nonlocals
    fn = fkm.make_kernel_fitness(convert.chain_spec_from(spec_j),
                                 convert.problem_from(batched_j),
                                 convert.fitness_config_from(fit_j),
                                 None if obs_j is None else convert.obstacles_from(obs_j))
    assert isinstance(fn, fkm.KernelFitness) and callable(fn)
    np.testing.assert_array_equal(fn.meta.numpy(), np.asarray(jax_packed["meta"]))
    # The two FKs that pack the anchor positions differ in the last bit.
    np.testing.assert_allclose(fn.swarm.numpy(), np.asarray(jax_packed["swarm"]),
                               rtol=1e-6, atol=1e-6)
    assert fn.branches == dict(
        num_obstacles=jax_packed["num_obstacles"], collision_shape=fit_j.collision_shape,
        gizmo_size=fit_j.gizmo_size, use_orientation=jax_packed["use_orientation"],
        use_distance_term=jax_packed["use_distance"], trig_impl=fit_j.trig_impl)
    assert torch.equal(fn(torch.as_tensor(x)), fn.plain(torch.as_tensor(x)))
    assert fn.configuration().startswith("arm_7dof (")


def test_kernel_fitness_packs_orientation_and_distance():
    rng = np.random.default_rng(4)
    spec, problem = library.arm_6dof()
    rot = torch.as_tensor(rng.normal(scale=0.2, size=(3, 1, 3)).astype(np.float32))
    batched = library.batched_problem(problem, problem.targets[None].expand(3, -1, -1))
    batched = batched.replace(target_rot=rot)
    fit = FitnessConfig(angle_weight=0.3, distance_weight=0.2, orientation_weight=1.0,
                        trig_impl="exact")
    fn = fkm.make_kernel_fitness(spec, batched, fit)
    assert fn.branches["use_orientation"] and fn.branches["use_distance_term"]
    assert fn.meta.shape[-1] == fkm.MetaLayout(spec, 0, True).meta_size
    assert fn.swarm.shape == (3, fkm.MetaLayout(spec, 0, True).swarm_size)
    assert kernels.kernel_variant(spec, 0, "box", True, True, "exact")[0] == kernels.ON_DEMAND
    assert "orientation" in fn.configuration() and "exact trig" in fn.configuration()


# --- the kernel's source through g++ -----------------------------------------

# The stand-in CUDA runtime of tests/test_torch_branches.py, whose launch
# here runs a block's threads as threads: __syncthreads is a barrier,
# dynamic shared memory a block buffer filled with garbage, a block's
# __shared__ scalar a static; blocks run in turn, so the arrival counter
# needs no atomicity.
STANDIN = BRANCHES_STANDIN.replace("inline void __syncthreads() {}", """#include <barrier>
extern std::barrier<>* standin_barrier;
extern float* standin_shared;
inline void __syncthreads() { standin_barrier->arrive_and_wait(); }""")
RUNNER = r"""
#include <thread>
#include <vector>
thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
std::barrier<>* standin_barrier;
float* standin_shared;
template <class K, class... A>
inline void standin_launch(unsigned g, unsigned b, size_t smem, cudaStream_t, K k, A... a) {
  std::vector<float> buf(smem / sizeof(float) + 1);
  for (unsigned x = 0; x < g; ++x) {
    std::fill(buf.begin(), buf.end(), -12345.0f);
    std::barrier<> barrier(b);
    standin_barrier = &barrier;
    standin_shared = buf.data();
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
extern "C" int probe_step_threads(int d) { return ikpso::step_threads(d); }
"""
STEP_ON_DEMAND = ("dual_arm_14dof", 1)  # a tree with the box collider: on demand


def _host_source(text):
    text = text.replace("extern __shared__ float smem[];", "float* smem = standin_shared;")
    text = text.replace("__shared__ int s_last;", "static int s_last;")
    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\(", r"standin_launch(\2, \1, ",
                  text, flags=re.S)


@pytest.fixture(scope="module")
def host_step(tmp_path_factory):
    """scan_step.cu and the on-demand step of ``STEP_ON_DEMAND``, compiled
    by g++ for this CPU; returns ``{"prebuilt": lib, "on_demand": lib}``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    tmp = tmp_path_factory.mktemp("host_step")
    (tmp / "cuda_runtime.h").write_text(STANDIN)
    for src in kernels.CSRC.glob("*.cu*"):
        (tmp / src.name).write_text(_host_source(src.read_text()))
    spec = model_spec(STEP_ON_DEMAND[0], "cpu")[0]
    od = ('#include "scan_step.cuh"\n'
          + kernels.on_demand_source(kernels.on_demand_key(spec, STEP_ON_DEMAND[1], False))
          .replace('#include "on_demand.cuh"', ""))
    # The on-demand step without kernel A's part of on_demand.cuh: its entry
    # point, as on_demand.cuh writes it, on the generated topology.
    entry = (tmp / "on_demand.cuh").read_text()
    entry = entry[entry.index('extern "C" int ikpso_od_scan_step'):]
    od += ("namespace ikpso { using OdTopology = OnDemandTopology<IntList<IKPSO_OD_PARENTS>, "
           "IntList<IKPSO_OD_EFFECTORS>, IKPSO_OD_THREADS, IKPSO_OD_STREAM != 0, "
           "IKPSO_OD_DISTANCE != 0, IKPSO_OD_EXACT != 0>; constexpr int kOdCollider = "
           "IKPSO_OD_COLLIDER; constexpr bool kOdOrientation = IKPSO_OD_ORIENTATION != 0; }\n"
           + entry)
    libs, procs = {}, {}
    for name, text in (("prebuilt", (tmp / "scan_step.cu").read_text()), ("on_demand", od)):
        cu = tmp / f"{name}.cu"
        cu.write_text('#include "cuda_runtime.h"\n#include "scan_step.cuh"\n' + RUNNER + text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-shared",
             "-fPIC", "-pthread", "-I", str(tmp), "-x", "c++", str(cu), "-o", str(so)],
            stderr=subprocess.PIPE, text=True))
    for name, (so, proc) in procs.items():
        err = proc.communicate()[1]
        assert proc.returncode == 0, err[-4000:]
        lib = ctypes.CDLL(str(so))
        for fn, sig in {**kernels.SIGNATURES, **kernels.OD_SIGNATURES}.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = sig
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _run_host_step(libs, fitness, state, u, limits, pso, iteration, gbest_reduce, work,
                   seeds=None):
    """``solver.scan_step`` on CPU tensors through the g++-built source: the
    replay step on ``u``, or with ``seeds`` (and ``u`` None) the drawing
    step."""
    x, v, lbest, lbest_val, gbest, gbest_val = state
    randomized = pso.inertia_mode == "randomized"
    w = pso.inertia if randomized else solver.inertia_at(pso, iteration)
    update = (w, pso.cognitive, pso.social, int(randomized), solver._kick(pso, iteration),
              pso.rekick_scale, pso.rekick_threshold)
    reduced = None
    if gbest_reduce is not None:
        reduced = (torch.empty_like(gbest_val), torch.empty_like(gbest))
    red = (None, None) if reduced is None else tuple(t.data_ptr() for t in reduced)
    s, p, _ = x.shape
    meta = fitness.meta.reshape(-1)
    tail = (meta.data_ptr(), fitness.swarm.data_ptr(), fitness.swarm.shape[1],
            limits.data_ptr(), x.data_ptr(), v.data_ptr(), lbest.data_ptr(),
            lbest_val.data_ptr(), int(seeds is None), None if u is None else u.data_ptr(),
            None if seeds is None else seeds.data_ptr(), solver.draws_per_iteration(pso),
            iteration, gbest.data_ptr(), gbest_val.data_ptr(), *red, *update,
            work.cand_val.data_ptr(),
            work.cand_id.data_ptr(), work.cand_val.shape[1], work.arrivals.data_ptr(), s, p,
            None)
    b = fitness.branches
    topo, collider, orient = kernels.kernel_variant(
        fitness.spec, b["num_obstacles"], b["collision_shape"], b["use_orientation"],
        b["use_distance_term"], b["trig_impl"])
    scene = (b["num_obstacles"], *fkm.scene_constants(b["gizmo_size"]))
    if topo == kernels.SERIAL:
        rc = libs["prebuilt"].ikpso_scan_step_serial(fitness.spec.num_nodes, *tail)
    elif topo == kernels.ON_DEMAND:
        rc = libs["on_demand"].ikpso_od_scan_step(*scene, *tail)
    else:
        rc = libs["prebuilt"].ikpso_scan_step(topo, collider, orient, *scene, *tail)
    assert rc == 0
    if reduced is not None:
        cand_val, cand = gbest_reduce(*reduced)
        better = cand_val < gbest_val
        gbest_val = torch.where(better, cand_val, gbest_val)
        gbest = torch.where(better[:, None], cand, gbest)
    return x, v, lbest, lbest_val, gbest, gbest_val


def _init(spec, batched, fitness, pso, p, rng):
    lo, hi = spec.limits()
    anchor = fk_ops.pose_to_angles(spec, batched.pose)
    shape = (anchor.shape[0], p, spec.dof)
    draws = (torch.as_tensor(rng.random(shape, dtype=np.float32)),
             torch.as_tensor(rng.random(shape, dtype=np.float32)))
    state = solver.init_swarm(None, anchor, p, fitness, pso, limits=(lo, hi), uniforms=draws)
    n = solver.draws_per_iteration(pso)
    return state, torch.as_tensor(rng.random((n,) + shape, dtype=np.float32)), lo, hi


def _negate_hook(val, coords):
    """A stand-in cross-rank reduction that moves the candidate (so the
    host's two ``torch.where`` lines are exercised on values the kernel did
    not pick)."""
    return val - 1.0, coords * 0.5


STEP_CASES = {
    # name: (model, S, P, pso, fit, scene, what to force)
    "scan_shape": ("arm_7dof", 3, 300, PSOConfig(iterations=5, inertia_mode="randomized",
                                                init_mode="warm"),
                   FitnessConfig(angle_weight=0.0), None, None),
    "canonical_rekick": ("arm_7dof", 2, 257, PSOConfig(
        iterations=5, inertia_mode="canonical", inertia_end=0.2, init_mode="uniform",
        rekick_interval=2, rekick_threshold=1e-3), FitnessConfig(angle_weight=0.3), None, None),
    "rekick_all": ("arm_7dof", 2, 512, PSOConfig(
        iterations=4, inertia_mode="randomized", init_mode="hybrid", rekick_interval=2,
        rekick_threshold=-1.0), FitnessConfig(angle_weight=0.3), None, None),
    "tie_across_blocks": ("arm_7dof", 2, 512, PSOConfig(iterations=3,
                                                        inertia_mode="randomized"),
                          FitnessConfig(angle_weight=0.3), None, "tie"),
    "nan": ("arm_7dof", 2, 300, PSOConfig(iterations=3, inertia_mode="randomized"),
            FitnessConfig(angle_weight=0.3), None, "nan"),
    "reference_arm": ("reference_arm", 2, 600, PSOConfig(iterations=3,
                                                         inertia_mode="randomized"),
                      FitnessConfig(angle_weight=3.0), None, None),
    "serial": ("snake:20", 2, 130, PSOConfig(iterations=3, inertia_mode="randomized",
                                             init_mode="uniform"),
               FitnessConfig(angle_weight=0.3), None, None),
    "box": ("arm_7dof", 2, 300, PSOConfig(iterations=3, inertia_mode="randomized",
                                          init_mode="uniform"),
            FitnessConfig(angle_weight=0.3), "box", None),
    "capsule": ("arm_7dof", 2, 300, PSOConfig(iterations=3, inertia_mode="randomized",
                                              init_mode="uniform"),
                FitnessConfig(angle_weight=0.3, collision_shape="capsule"), "capsule", None),
    "on_demand_box": ("dual_arm_14dof", 2, 200, PSOConfig(iterations=3,
                                                          inertia_mode="randomized"),
                      FitnessConfig(angle_weight=0.3), "box", None),
    "hook": ("arm_7dof", 2, 300, PSOConfig(iterations=3, inertia_mode="canonical"),
             FitnessConfig(angle_weight=0.3), None, "hook"),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_source_equals_pso_iteration_bit_for_bit(host_step, case, torch_single_thread):
    _hold_step_to_pso_iteration(host_step, case, STEP_CASES[case], drawing=False)


# The drawing step (REPLAY off), held to pso_iteration fed step_uniforms:
# both inertia modes, the re-kick with and without a threshold, a box scene,
# a ragged P (1,000: the last block partial), P=257 at D=9 (P * D odd, so
# every swarm after the first starts off a 16-byte boundary: the 4-byte
# path, vec == 0), the gbest_reduce hook, the serial-chain and on-demand
# entries.
DRAW_CASES = {
    "scan_shape": STEP_CASES["scan_shape"],
    "canonical_rekick_vec0": STEP_CASES["canonical_rekick"],
    "rekick_all": STEP_CASES["rekick_all"],
    "ragged_1000": ("arm_7dof", 2, 1000, PSOConfig(iterations=3, inertia_mode="randomized",
                                                   init_mode="uniform"),
                    FitnessConfig(angle_weight=0.3), None, None),
    "reference_arm": STEP_CASES["reference_arm"],
    "box": STEP_CASES["box"],
    "serial": STEP_CASES["serial"],
    "on_demand_box": STEP_CASES["on_demand_box"],
    "hook": STEP_CASES["hook"],
    "nan": STEP_CASES["nan"],
}


@pytest.mark.parametrize("case", list(DRAW_CASES))
def test_drawing_step_source_equals_pso_iteration_on_step_uniforms(host_step, case,
                                                                    torch_single_thread):
    _hold_step_to_pso_iteration(host_step, "draw_" + case, DRAW_CASES[case], drawing=True)


def _hold_step_to_pso_iteration(host_step, case, spec_case, drawing):
    """Steps of the g++-built step against ``pso_iteration`` on kernel C's
    plain twin, state for state: the replay step on numpy uniforms, or the
    drawing step on seed words with ``step_uniforms``'s block on the plain
    side."""
    model, s, p, pso, fit, scene, force = spec_case
    rng = np.random.default_rng(sum(map(ord, case)))
    spec, batched = _scan_problem(s, rng, model)
    obstacles = None if scene is None else obstacle_scene(spec, 4)
    fitness = fkm.make_kernel_fitness(spec, batched, fit, obstacles)
    state, _, lo, hi = _init(spec, batched, fitness, pso, p, rng)
    mine = solver.step_buffers(state)
    plain = tuple(t.clone() for t in mine)
    limits = torch.stack((lo, hi)).contiguous()
    work = solver.step_work(s, p, "cpu")
    recorded = {True: [], False: []}

    def recording(plain_side):
        def hook(val, coords):
            recorded[plain_side].append((val.clone(), coords.clone()))
            return val, coords
        return hook

    hooks = {False: _negate_hook, True: _negate_hook} if force == "hook" else (
        {False: recording(False), True: recording(True)} if force == "nan"
        else {False: None, True: None})
    n = solver.draws_per_iteration(pso)
    seeds = (torch.as_tensor(rng.integers(-2**31, 2**31, size=(s, 2), dtype=np.int32))
             if drawing else None)
    hits = 0
    for it in range(pso.iterations):
        if it == 1 and force == "tie":
            for st in (mine, plain):  # every lbest value equal: the first particle wins
                st[3].fill_(0.0)
        if it == 1 and force == "nan":
            for st in (mine, plain):  # the first NaN lbest value wins; a NaN velocity
                st[3][0, 280] = st[3][0, 20] = st[3][1, 7] = float("nan")  # clamps to NaN
                st[1][1, 3, 2] = float("nan")
        if drawing:
            u = step_uniforms(seeds, it, n, p, spec.dof)
            mine = _run_host_step(host_step, fitness, mine, None, limits, pso, it,
                                  hooks[False], work, seeds=seeds)
        else:
            u = torch.as_tensor(rng.random((n, s, p, spec.dof), dtype=np.float32))
            mine = _run_host_step(host_step, fitness, mine, u, limits, pso, it, hooks[False],
                                  work)
        plain = solver.pso_iteration(*plain, u, fitness.plain, lo, hi, pso, iteration=it,
                                     gbest_reduce=hooks[True])
        for name, a, b in zip(("x", "v", "lbest", "lbest_val", "gbest", "gbest_val"),
                              mine, plain):
            assert torch.equal(a, b) or (a.isnan() == b.isnan()).all() and torch.equal(
                a.nan_to_num(7.0), b.nan_to_num(7.0)), (case, it, name)
        assert int(work.arrivals.abs().sum()) == 0  # the last block reset the counters
        if scene is not None:
            hits += int((fitness.plain(mine[0]) >= fkm.COLLISION_PENALTY).sum())
    if force == "tie":
        assert bool((plain[4] == plain[2][:, 0]).all())
    if force == "nan":  # the recorded candidates: swarm 0's first NaN, particle 20
        assert len(recorded[False]) == len(recorded[True]) == pso.iterations
        for (va, ca), (vb, cb) in zip(recorded[False], recorded[True]):
            assert torch.equal(va.isnan(), vb.isnan()) and torch.equal(ca, cb)
        assert bool(recorded[False][-1][0][0].isnan())
        assert torch.equal(recorded[False][-1][1][0], plain[2][0, 20])
    if scene is not None:
        assert hits > 0  # some particles collide


def test_step_block_takes_the_widest_chains_and_refuses_the_rest(host_step):
    lib = host_step["prebuilt"]
    lib.probe_step_threads.argtypes = [ctypes.c_int]
    # arm_7dof, reference_arm, humanoid_45dof, hand21, snake:50: at most 128
    # threads a block, a block's shared memory fits 48 KB, and the candidate
    # scratch (32-thread blocks) holds any of them.
    assert [lib.probe_step_threads(d) for d in (9, 21, 45, 60, 150)] == [128, 128, 128, 128, 64]
    assert lib.probe_step_threads(400) == 0
    # A chain no block holds: the launcher refuses it (on the card the
    # wrapper raises, naming the configuration).
    spec, batched = _scan_problem(1, np.random.default_rng(3), "snake:134")
    fitness = fkm.make_kernel_fitness(spec, batched, FitnessConfig())
    pso = PSOConfig(iterations=1, inertia_mode="randomized")
    state, u, lo, hi = _init(spec, batched, fitness, pso, 32, np.random.default_rng(3))
    with pytest.raises(AssertionError):
        _run_host_step(host_step, fitness, solver.step_buffers(state), u,
                       torch.stack((lo, hi)), pso, 0, None, solver.step_work(1, 32, "cpu"))


def test_step_threads_mirror_matches_the_source(host_step):
    lib = host_step["prebuilt"]
    lib.probe_step_threads.argtypes = [ctypes.c_int]
    for d in range(1, 401):
        assert kernels.step_threads(d) == lib.probe_step_threads(d), d


# --- the drawing route ---------------------------------------------------------


def _route_case(rng, pso):
    spec, batched = _scan_problem(3, rng)
    fit = FitnessConfig(angle_weight=0.3)
    return spec, batched, fit, fkm.make_kernel_fitness(spec, batched, fit)


def test_solve_on_the_cpu_draws_the_torch_rand_blocks(torch_single_thread):
    # Off the card every block is torch.rand's, in the JAX package's order:
    # position (uniform init), velocity, then one (n, S, P, D) block an
    # iteration. No seed words are drawn.
    pso = PSOConfig(iterations=3, inertia_mode="randomized", init_mode="uniform",
                    rekick_interval=2)
    spec, batched, fit, fitness = _route_case(np.random.default_rng(5), pso)
    p = 40
    got = solver.solve(spec, batched, torch.Generator().manual_seed(3), pso, fit,
                       num_particles=p, fitness_fn=fitness)
    gen = torch.Generator().manual_seed(3)
    shape = (3, p, spec.dof)
    n = solver.draws_per_iteration(pso)
    draws = solver.ScanDraws(torch.rand(shape, generator=gen), torch.rand(shape, generator=gen),
                             torch.rand((pso.iterations, n) + shape, generator=gen))
    want = solver.solve(spec, batched, None, pso, fit, num_particles=p, fitness_fn=fitness,
                        uniforms=draws)
    for a, b in zip((got.angles, got.fitness, got.trace), (want.angles, want.fitness,
                                                           want.trace)):
        assert torch.equal(a, b)


def _host_route(monkeypatch, host_step, calls):
    """``solve``'s card route on CPU tensors: ``step_route`` true for kernel
    C's fitness, ``scan_step`` the g++-built step (recording, per call,
    whether it was handed u and seeds)."""
    monkeypatch.setattr(solver, "step_route",
                        lambda fn, device: isinstance(fn, fkm.KernelFitness))

    def step(fitness, *args, iteration=0, gbest_reduce=None, work=None, seeds=None):
        state, u, limits, pso = args[:6], args[6], args[7], args[8]
        calls.append((u is not None, seeds is not None))
        return _run_host_step(host_step, fitness, state, u, limits, pso, iteration,
                              gbest_reduce, work, seeds=seeds)

    monkeypatch.setattr(solver, "scan_step", step)


@pytest.mark.parametrize("init_mode", ["warm", "uniform"])
def test_drawing_route_draws_no_iteration_block(host_step, init_mode, monkeypatch,
                                                torch_single_thread):
    # The card's route without injected uniforms: the init blocks from
    # torch.rand, then seed words, every iteration the drawing step; the
    # whole solve equals pso_iteration fed drawing_route_draws' blocks.
    pso = PSOConfig(iterations=4, inertia_mode="randomized", init_mode=init_mode,
                    rekick_interval=2, rekick_threshold=1e-3)
    spec, batched, fit, fitness = _route_case(np.random.default_rng(6), pso)
    p = 300
    uniform_calls, steps = [], []
    real_uniform = solver._uniform

    def counted_uniform(generator, shape, device):
        uniform_calls.append(tuple(shape))
        return real_uniform(generator, shape, device)

    monkeypatch.setattr(solver, "_uniform", counted_uniform)
    want = solver.solve(spec, batched, None, pso, fit, num_particles=p,
                        fitness_fn=fitness.plain, uniforms=solver.drawing_route_draws(
                            torch.Generator().manual_seed(4), pso, 3, p, spec.dof, "cpu"))
    uniform_calls.clear()
    _host_route(monkeypatch, host_step, steps)
    got = solver.solve(spec, batched, torch.Generator().manual_seed(4), pso, fit,
                       num_particles=p, fitness_fn=fitness)
    n_init = 1 if init_mode == "warm" else 2
    assert uniform_calls == [(3, p, spec.dof)] * n_init  # the init blocks only
    assert steps == [(False, True)] * pso.iterations  # seeds, never u
    for a, b in zip((got.angles, got.fitness, got.trace), (want.angles, want.fitness,
                                                           want.trace)):
        assert torch.equal(a, b)


def test_scan_draws_select_the_replay_step(host_step, monkeypatch, torch_single_thread):
    pso = PSOConfig(iterations=3, inertia_mode="canonical", init_mode="warm")
    spec, batched, fit, fitness = _route_case(np.random.default_rng(7), pso)
    p = 256
    rng = np.random.default_rng(8)
    shape = (3, p, spec.dof)
    draws = solver.ScanDraws(None, torch.as_tensor(rng.random(shape, dtype=np.float32)),
                             torch.as_tensor(rng.random(
                                 (pso.iterations, solver.draws_per_iteration(pso)) + shape,
                                 dtype=np.float32)))
    want = solver.solve(spec, batched, None, pso, fit, num_particles=p,
                        fitness_fn=fitness.plain, uniforms=draws)
    steps = []
    _host_route(monkeypatch, host_step, steps)
    got = solver.solve(spec, batched, None, pso, fit, num_particles=p, fitness_fn=fitness,
                       uniforms=draws)
    assert steps == [(True, False)] * pso.iterations  # u, never seeds
    assert torch.equal(got.angles, want.angles) and torch.equal(got.trace, want.trace)


def test_scan_step_takes_either_u_or_seeds():
    rng = np.random.default_rng(9)
    spec, batched = _scan_problem(2, rng)
    fitness = fkm.make_kernel_fitness(spec, batched, FitnessConfig(angle_weight=0.3))
    pso = PSOConfig(iterations=2, inertia_mode="randomized", rekick_interval=1)
    state, u, lo, hi = _init(spec, batched, fitness, pso, 64, rng)
    limits = torch.stack((lo, hi))
    seeds = torch.as_tensor(rng.integers(-2**31, 2**31, size=(2, 2), dtype=np.int32))
    for bad in ((u, seeds), (None, None)):
        with pytest.raises(ValueError, match="either"):
            solver.scan_step(fitness, *state, bad[0], limits, pso, iteration=1,
                             seeds=bad[1])
    # On CPU tensors the drawing step is pso_iteration on step_uniforms' block.
    got = solver.scan_step(fitness, *state, None, limits, pso, iteration=1, seeds=seeds)
    want = solver.pso_iteration(*state, step_uniforms(seeds, 1, 4, 64, spec.dof), fitness,
                                lo, hi, pso, iteration=1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
