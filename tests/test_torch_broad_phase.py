"""The exact slab reject ahead of kernel B's narrow phase (csrc/fk_fitness.cuh).

Kernels A, B and C decide most (node, obstacle) pairs "no hit" by a slab
test on the scene box's own axes before the box SAT or the capsule
bisection (the proof is in ``node_hits``'s comment); the function they
compute does not change. Held here:

  * soundness of the plain mirror (``ops/fitness_kernel.py``:
    ``box_pair_reject``, ``capsule_pair_reject``, ``box_reject_slack``):
    wherever it says "separated" the plain narrow phase (``sat_obb``,
    ``seg_obb_dist2_tile``) says "no hit", on hypothesis draws of rotated
    boxes, signed link lengths and deep chains, and at the reject's own
    margin +- a few ulps;
  * the precondition: the polynomial trig's sin^2 + cos^2 stays within
    4e-6 of 1 where the reject trusts it;
  * the kernel's own source: ``fk_fitness.cu`` (and an on-demand source
    for the trees) compiled by g++ against a stand-in CUDA runtime that
    runs a launch's threads in turn, with ``-ffp-contract=off`` as the card
    builds with ``-fmad=false``, equals ``fk_fitness_plain`` bit for bit
    on the slice's 4-box scene, the near scene and rotated boxes, and
    JAX's interpreted Pallas tile at ``tests/test_torch_fitness.py``'s
    scene bar.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from ikpso_tpu.models import library as jlib
from ikpso_tpu.models.chain import Obstacles as JObstacles
from ikpso_tpu.ops.fitness import FitnessConfig as JFit
from ikpso_tpu.ops.pallas_fitness import make_pallas_fitness
from ikpso_tpu_torch.harness.obstacles import obstacle_scene
from ikpso_tpu_torch.harness.trees import model_spec
from ikpso_tpu_torch.models import convert, library
from ikpso_tpu_torch.models.chain import Obstacles
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops import fitness_kernel as fkm
from ikpso_tpu_torch.ops.fitness import COLLISION_PENALTY, FitnessConfig
from ikpso_tpu_torch.pso.polish_soa import anchor_positions_flat
from ikpso_tpu_torch.utils import kernels
from test_torch_branches import COOPERATIVE_GROUPS, STANDIN

ROOT = Path(__file__).resolve().parents[1]
SCENE_TOL = 2e-4  # tests/test_torch_fitness.py: JAX's bar for the tile with a scene
GIZMO = 0.2


def _near_scene(spec):
    """chip_smoke.py's near scene (a 4-box ring at 0.35 of the reach)."""
    mod_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod._near_scene(spec, "cpu")


def _quat(v):
    q = np.asarray(v, np.float64)
    return (q / np.linalg.norm(q)).astype(np.float32)


def _rotated_scene(spec, rng, n=4, scale=0.15):
    """n boxes of random orientation and size around the chain's workspace."""
    reach = float(np.abs(spec.length.numpy()).sum())
    centers = rng.normal(0.0, 0.45 * reach, (n, 3)).astype(np.float32)
    dims = (rng.uniform(0.2, 1.5, (n, 3)) * scale * reach).astype(np.float32)
    quats = np.stack([_quat(rng.normal(size=4)) for _ in range(n)])
    return Obstacles.from_boxes(centers, dims, quats)


def _case(spec, problem, obs, shape, s, p, rng, spread=1.0):
    """Random in-limit angles (the limits' middle ``spread`` of them) and
    the packed constants of a batched problem at its warm pose."""
    fit = FitnessConfig(angle_weight=3.0, collision_shape=shape, gizmo_size=GIZMO)
    batched = library.batched_problem(problem, problem.targets[None].expand(s, -1, -1))
    meta = fkm.pack_meta(spec, fit, obs)
    swarm = fkm.pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                           anchor_positions_flat(spec, batched))
    lo, hi = spec.limits().numpy()
    mid, half = (lo + hi) / 2, (hi - lo) / 2 * spread
    x = (mid - half + rng.random((s, p, spec.dof)) * 2 * half).astype(np.float32)
    return fit, meta, swarm, torch.as_tensor(x)


# --- the poly trig's precondition -------------------------------------------


def test_poly_sincos_stays_orthonormal_where_the_reject_trusts_it():
    # csrc/fk_fitness.cuh: within |angle| <= kRejectMaxAngle a local
    # rotation's sigma moves by < 1e-5 only if sin^2 + cos^2 is within
    # 4e-6 of 1 (measured max over every float32 in [2^-12, 12.5]: 9.8e-7).
    x = torch.linspace(-fkm.REJECT_MAX_ANGLE, fkm.REJECT_MAX_ANGLE, 1 << 22)
    x = torch.cat([x, torch.tensor([np.pi, -np.pi, 2 * np.pi, 4 * np.pi, 12.5, -12.5],
                                   dtype=torch.float32)])
    s, c = fkm.sincos_poly(x)
    assert float((s.double() ** 2 + c.double() ** 2 - 1.0).abs().max()) < 4e-6


# --- soundness of the mirror --------------------------------------------------


def _walk(spec, x, m, swarm):
    rots, poss, _ = fkm.fk_walk_tile(spec, lambda d: x[..., d], lambda i: m[i],
                                     lambda i: swarm[:, i:i + 1])
    return rots, poss


def _scene_rows(meta, spec, n_obs):
    m = meta.reshape(-1)
    off = fkm.MetaLayout(spec).OFF_OBS
    out = []
    for o in range(n_obs):
        ob = m[off + 15 * o:off + 15 * (o + 1)]
        out.append(((ob[0], ob[1], ob[2]), (ob[3], ob[4], ob[5]),
                    tuple(tuple(ob[6 + 3 * r + c] for c in range(3)) for r in range(3))))
    return out


def check_mirror_sound(spec, x, meta, swarm, n_obs, shape):
    """Every pair the mirror rejects is a pair the narrow phase misses;
    returns (pairs rejected, pairs)."""
    node_half, link_half, _, link_r2 = fkm.scene_constants(GIZMO)
    m = meta.reshape(-1)
    rots, poss = _walk(spec, x, m, swarm)
    scene = _scene_rows(meta, spec, n_obs)
    lay = fkm.MetaLayout(spec)
    slack = fkm.box_reject_slack(spec.num_nodes, tuple(swarm[:, i:i + 1] for i in range(9)),
                                 [orot for _, _, orot in scene]).expand(x.shape[:2])
    r_cap = fkm.capsule_reject_radius(link_r2)
    rejected = total = 0
    for k in range(1, spec.num_nodes):
        pk, rk, pp = poss[k], rots[k], poss[spec.parent[k]]
        length = m[lay.OFF_LEN + k - 1]
        d0 = 3 * (k - 1)
        slack = torch.where(fkm.reject_angles_in_range(
            x[..., d0], x[..., d0 + 1], x[..., d0 + 2]), slack, float("inf"))
        pmag, r_cube, r_link = fkm.box_reject_radii(pk, pp, slack, node_half, link_half)
        for oc, oh, orot in scene:
            if shape == "capsule":
                q0 = fkm.box_frame_offset(pp, oc, orot)[0]
                q1 = fkm.box_frame_offset(pk, oc, orot)[0]
                sep = fkm.capsule_pair_reject(q0, q1, oh, r_cap)
                assert not bool((sep & (fkm.seg_obb_dist2_tile(pp, pk, oc, oh, orot)
                                        <= link_r2)).any())
                rejected += int(sep.sum())
            else:
                cube, link = fkm.box_pair_reject(pk, pp, oc, oh, orot, pmag, r_cube, r_link,
                                                 slack)
                g_hit = fkm.sat_obb(*pk, rk, (node_half,) * 3, oc, oh, orot)
                mid = tuple((pk[i] + pp[i]) * 0.5 for i in range(3))
                l_hit = fkm.sat_obb(*mid, rk, (length * 0.5, link_half, link_half), oc, oh,
                                    orot)
                assert not bool((cube & g_hit).any()) and not bool((link & l_hit).any())
                rejected += int((cube & link).sum())
            total += x.shape[0] * x.shape[1]
    return rejected, total


CHAINS = ["arm_7dof", "dual_arm_14dof", "humanoid_45dof", "snake:50"]


@pytest.mark.parametrize("shape", ["box", "capsule"])
@settings(max_examples=12, deadline=None, database=None,
          suppress_health_check=list(HealthCheck))
@given(seed=st.integers(0, 2**32 - 1), chain=st.sampled_from(CHAINS),
       size=st.floats(1e-3 / GIZMO, 10.0), flip=st.booleans())
def test_reject_decides_no_hit_only_where_the_narrow_phase_misses(shape, seed, chain,
                                                                 size, flip):
    # Rotated boxes from quaternions, half extents from 1e-3 to 10 x the
    # gizmo, the chains' own rotations (the humanoid's, snake:50's depth),
    # and link lengths of either sign.
    rng = np.random.default_rng(seed)
    spec, problem = model_spec(chain, "cpu")
    if flip:
        spec = dataclasses.replace(spec, length=spec.length * torch.where(
            torch.as_tensor(rng.random(spec.num_nodes) < 0.5), -1.0, 1.0))
    n = 3
    reach = float(np.abs(spec.length.numpy()).sum())
    centers = rng.normal(0.0, 0.4 * reach, (n, 3)).astype(np.float32)
    dims = (rng.uniform(0.5, 1.0, (n, 3)) * 2 * size * GIZMO).astype(np.float32)
    quats = np.stack([_quat(rng.normal(size=4)) for _ in range(n)])
    obs = Obstacles.from_boxes(centers, dims, quats)
    fit, meta, swarm, x = _case(spec, problem, obs, shape, 2, 64, rng)
    rejected, total = check_mirror_sound(spec, x, meta, swarm, n, shape)
    assert 0 <= rejected <= total


def _at_margin(spec, problem, shape, ulps):
    """A one-box scene placed so that node 1's cube (box) or node 1's link
    (capsule) sits at the reject's threshold on the box's x axis, moved out
    by ``ulps`` ulps of the box-frame coordinate (negative: in)."""
    node_half, link_half, _, link_r2 = fkm.scene_constants(GIZMO)
    fit, meta, swarm, x = _case(spec, problem, None, shape, 1, 1, np.random.default_rng(0))
    rots, poss = _walk(spec, x, fkm.pack_meta(spec, fit).reshape(-1), swarm)
    pk = np.array([float(v) for v in poss[1]], np.float64)
    pp = np.array([float(v) for v in poss[0]], np.float64)
    half = np.float32(0.3)
    slack = fkm.box_reject_eps(spec.num_nodes)
    center = pk.copy()
    for _ in range(50):  # fixed point: the threshold depends on |p - c|
        if shape == "capsule":
            # both end points beyond the slab's + x side: the nearer one sets it
            lead = min(pk[0], pp[0])
            thr = fkm.capsule_reject_radius(link_r2) + fkm.CAPSULE_SLACK * (
                np.abs(pk - center).sum() + np.abs(pp - center).sum())
            center[0] = lead - (half + thr)
            center[1:] = pk[1:]
        else:
            mag = np.abs(pk).sum() + np.abs(pp).sum() + np.abs(pk - center).sum() + \
                np.abs(pp - center).sum()
            thr = np.sqrt(3.0) * node_half * (1 + slack) + slack * mag
            center[0] = pk[0] - (half + thr)
            center[1:] = pk[1:]
    c = np.float32(center[0])
    for _ in range(abs(ulps)):
        c = np.nextafter(c, np.float32(-np.inf if ulps > 0 else np.inf))
    center = np.array([c, center[1], center[2]], np.float32)
    obs = Obstacles.from_boxes(center[None], np.full((1, 3), 2 * half, np.float32))
    fit, meta, swarm, x = _case(spec, problem, obs, shape, 1, 1, np.random.default_rng(0))
    return fit, meta, swarm, x


@pytest.mark.parametrize("shape", ["box", "capsule"])
def test_reject_at_its_margin_plus_and_minus_a_few_ulps(shape):
    spec, problem = library.arm_7dof()
    decided = {}
    for ulps in (-64, -4, -1, 0, 1, 4, 64):
        fit, meta, swarm, x = _at_margin(spec, problem, shape, ulps)
        rejected, _ = check_mirror_sound(spec, x, meta, swarm, 1, shape)
        decided[ulps] = rejected
    # The placement straddles the threshold: far inside it decides node 1's
    # pair nothing, far outside it decides it.
    assert decided[-64] < decided[64], decided


def test_reject_disarms_where_its_precondition_fails():
    spec, problem = library.arm_7dof()
    rng = np.random.default_rng(3)
    obs = _rotated_scene(spec, rng)
    fit, meta, swarm, x = _case(spec, problem, obs, "box", 2, 8, rng)
    scene = _scene_rows(meta, spec, obs.count)
    root = tuple(swarm[:, i:i + 1] for i in range(9))
    eps = fkm.box_reject_eps(spec.num_nodes)
    assert torch.equal(fkm.box_reject_slack(spec.num_nodes, root, [o for _, _, o in scene]),
                       torch.full((2, 1), eps))
    bent = (root[0] * 1.01,) + root[1:]
    assert bool(torch.isinf(fkm.box_reject_slack(spec.num_nodes, bent, [])).all())
    scaled = [tuple(tuple(v * 1.01 for v in row) for row in o) for _, _, o in scene]
    assert bool(torch.isinf(fkm.box_reject_slack(spec.num_nodes, root, scaled)).all())
    far = torch.tensor([0.0, 13.0, -13.0, float("nan")])
    assert fkm.reject_angles_in_range(far, far * 0, far * 0).tolist() == [True, False,
                                                                         False, False]


# --- the kernel's source through g++ ------------------------------------------

RUNNER = """
thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
template <class G, class B, class S, class St, class K, class... A>
inline void standin_launch(G g, B b, S, St, K k, A... a) {
  for (unsigned x = 0; x < static_cast<unsigned>(g); ++x) {
    for (unsigned t = 0; t < static_cast<unsigned>(b); ++t) {
      blockIdx.x = x; threadIdx.x = t;
      blockDim.x = static_cast<unsigned>(b); gridDim.x = static_cast<unsigned>(g);
      k(a...);
    }
  }
}
"""


def _host_source(text):
    """A CUDA source with each ``kernel<<<g, b, s, st>>>(args)`` launch as
    a call of the stand-in's ``standin_launch(g, b, s, st, kernel, args)``
    (kernel A's dynamic shared memory, never run here, a placeholder)."""
    text = text.replace("extern __shared__ float smem[];", "static float smem[1];")
    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\(", r"standin_launch(\2, \1, ",
                  text, flags=re.S)


# The capsule bisection alone: n segments (box-frame end points q0, q1) against
# n scene boxes (15 floats each).
PROBE = """
#include "fk_fitness.cuh"
extern "C" void probe_seg_obb_dist2(const float* q, const float* obs, float* out, int n) {
  for (int i = 0; i < n; ++i) {
    const float q0[3] = {q[6 * i], q[6 * i + 1], q[6 * i + 2]};
    const float q1[3] = {q[6 * i + 3], q[6 * i + 4], q[6 * i + 5]};
    out[i] = ikpso::seg_obb_dist2(q0, q1, obs + 15 * i);
  }
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """Kernel B's prebuilt library and an on-demand library (the dual arm
    and snake:20 with a box scene), compiled by g++ for this CPU; returns
    ``{name: ctypes library}``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    tmp = tmp_path_factory.mktemp("host_kernels")
    (tmp / "cuda_runtime.h").write_text(STANDIN.replace(
        "extern thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;",
        "extern thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;\n"
        "template <class T> T __shfl_sync(unsigned, T v, int) { return v; }"))
    (tmp / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS)
    for src in kernels.CSRC.glob("*.cu*"):
        (tmp / src.name).write_text(_host_source(src.read_text()))
    sources = {"prebuilt": (tmp / "fk_fitness.cu").read_text(), "probe": PROBE}
    for name in ("dual_arm_14dof", "snake:20"):
        spec = model_spec(name, "cpu")[0]
        key = kernels.on_demand_key(spec, 1, False)
        sources[name] = kernels.on_demand_source(key)
    libs = {}
    procs = {}
    for name, text in sources.items():
        cu = tmp / f"{name.replace(':', '_')}_host.cu"
        cu.write_text('#include "cuda_runtime.h"\n' + RUNNER + text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math", "-shared",
             "-fPIC", "-I", str(tmp), "-x", "c++", str(cu), "-o", str(so)],
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


def host_fk_fitness(libs, spec, x, meta, swarm, n_obs, shape, name=None):
    """Kernel B's CUDA source, compiled for this CPU, on CPU tensors (an
    on-demand tree from the library of its model ``name``)."""
    x, meta, swarm = x.contiguous(), meta.reshape(-1).contiguous(), swarm.contiguous()
    s, p, _ = x.shape
    out = torch.empty((s, p), dtype=torch.float32)
    scene = (n_obs, *fkm.scene_constants(GIZMO))
    tail = (x.data_ptr(), meta.data_ptr(), swarm.data_ptr(), swarm.shape[1], out.data_ptr(),
            s * p, p, None)
    topo, collider, _ = kernels.kernel_variant(spec, n_obs, shape, False, False, "poly")
    if topo == kernels.ON_DEMAND:
        rc = libs[name].ikpso_od_fk_fitness(*scene, *tail)
    else:
        rc = libs["prebuilt"].ikpso_fk_fitness(topo, collider, 0, *scene, *tail)
    assert rc == 0
    return out


def _scenes(spec, rng):
    return {"ring": obstacle_scene(spec, 4), "near": _near_scene(spec),
            "rotated": _rotated_scene(spec, rng)}


@pytest.mark.parametrize("shape", ["box", "capsule"])
def test_kernel_b_source_equals_the_plain_tile_bit_for_bit(host_kernels, shape):
    rng = np.random.default_rng(31)
    spec, problem = library.arm_7dof()
    for tag, obs in _scenes(spec, rng).items():
        fit, meta, swarm, x = _case(spec, problem, obs, shape, 8, 256, rng)
        got = host_fk_fitness(host_kernels, spec, x, meta, swarm, obs.count, shape)
        want = fkm.fk_fitness_plain(spec, x, meta, swarm, num_obstacles=obs.count,
                                    collision_shape=shape, gizmo_size=GIZMO)
        hit = want >= COLLISION_PENALTY
        assert bool(hit.any()) and bool((~hit).any()), tag
        assert torch.equal(got, want), (tag, int((got != want).sum()))
        rejected, total = check_mirror_sound(spec, x, meta, swarm, obs.count, shape)
        assert 0 < rejected < total, (tag, rejected, total)


@pytest.mark.parametrize("shape", ["box", "capsule"])
def test_kernel_b_source_scores_nan_poses_as_the_plain_tile(host_kernels, shape):
    # Poses with a NaN angle among the ring, near and rotated scenes,
    # through the reject and the narrow phase. The box collider calls them a hit (a NaN
    # fails every separating-axis test), the capsule collider no hit (its
    # distances are NaN, as jnp.maximum gives them, so `<= r^2` fails):
    # the penalty or NaN, as fk_fitness_plain scores them.
    rng = np.random.default_rng(35)
    spec, problem = library.arm_7dof()
    for tag, obs in _scenes(spec, rng).items():
        fit, meta, swarm, x = _case(spec, problem, obs, shape, 4, 64, rng)
        x[:, ::5, rng.integers(0, spec.dof)] = float("nan")
        got = host_fk_fitness(host_kernels, spec, x, meta, swarm, obs.count, shape)
        want = fkm.fk_fitness_plain(spec, x, meta, swarm, num_obstacles=obs.count,
                                    collision_shape=shape, gizmo_size=GIZMO)
        nan = torch.isnan(x).any(-1)
        assert bool(torch.equal(torch.isnan(got), torch.isnan(want))), tag
        assert torch.equal(got[~torch.isnan(want)], want[~torch.isnan(want)]), tag
        if shape == "box":
            assert bool((got[nan] == COLLISION_PENALTY).all()), tag
        else:
            # NaN, but the penalty where a node before the NaN angle's hits.
            assert bool(torch.isnan(got[nan]).any()), tag
            assert bool((torch.isnan(got[nan]) | (got[nan] == COLLISION_PENALTY)).all()), tag


def test_kernel_b_capsule_source_at_box_frame_zeros(host_kernels):
    # planar_3dof (kernel id 0, arm_7dof's code) keeps every link in the
    # z = 0 plane, so an axis-aligned box centered at z = 0 sees box-frame
    # coordinates of exactly 0, where jnp.sign is 0 (tests/test_pallas.py's
    # scene, and boxes of negative half extents).
    rng = np.random.default_rng(34)
    spec, problem = library.planar_3dof()
    scenes = {"pallas": Obstacles.from_boxes([(1.5, 0.5, 0.0), (-1.0, -1.0, 0.0)],
                                             [(1.0, 1.0, 1.0), (0.8, 0.8, 0.8)]),
              "negative": Obstacles.from_boxes([(1.0, 0.2, 0.0), (0.5, -0.5, 0.0)],
                                               [(0.4, -0.6, -0.3), (-0.2, 0.4, 0.5)])}
    for tag, obs in scenes.items():
        fit, meta, swarm, x = _case(spec, problem, obs, "capsule", 4, 256, rng)
        got = host_fk_fitness(host_kernels, spec, x, meta, swarm, obs.count, "capsule")
        want = fkm.fk_fitness_plain(spec, x, meta, swarm, num_obstacles=obs.count,
                                    collision_shape="capsule", gizmo_size=GIZMO)
        assert torch.equal(got, want), (tag, int((got != want).sum()))


@pytest.mark.parametrize("shape", ["box", "capsule"])
def test_kernel_b_source_at_the_contact(host_kernels, shape):
    # planar_3dof at zero angles lies on the x axis (nodes at x = 0, 1, 2, 3).
    # A box beside link 2, its face at the link box's half width (box) or the
    # capsule radius (capsule) from the link, +- 1 to 4,096 ulps, and a box ahead
    # of node 3 at the cube's half extent or the sphere's radius: the narrow
    # phase flips there, and the reject must leave it to the narrow phase.
    spec, problem = library.planar_3dof()
    node_half, link_half, node_r2, link_r2 = fkm.scene_constants(GIZMO)
    link = link_half if shape == "box" else float(np.sqrt(np.float32(link_r2)))
    node = node_half if shape == "box" else float(np.sqrt(np.float32(node_r2)))
    hits = {}
    for at, (center, half) in {
            "link": (lambda g: (1.5, -(0.3 + g), 0.0), (0.05, 0.3, 0.3)),
            "node": (lambda g: (3.0 + g + 0.3, 0.0, 0.0), (0.3, 0.3, 0.3))}.items():
        contact = np.float32(link if at == "link" else node)
        for ulps in (-4096, -64, -4, -1, 0, 1, 4, 64, 4096):
            gap = contact
            for _ in range(abs(ulps)):
                gap = np.nextafter(gap, np.float32(np.inf if ulps > 0 else -np.inf))
            obs = Obstacles.from_boxes([center(float(gap))], [[2 * v for v in half]])
            fit, meta, swarm, _ = _case(spec, problem, obs, shape, 1, 1,
                                        np.random.default_rng(0))
            x = torch.zeros((1, 1, spec.dof))
            got = host_fk_fitness(host_kernels, spec, x, meta, swarm, 1, shape)
            want = fkm.fk_fitness_plain(spec, x, meta, swarm, num_obstacles=1,
                                        collision_shape=shape, gizmo_size=GIZMO)
            assert torch.equal(got, want), (at, ulps, got, want)
            hits[(at, ulps)] = bool(want >= COLLISION_PENALTY)
    # Inside the contact the scene hits, outside it (past the SAT's 1e-6 pad)
    # it misses.
    assert all(hits[(at, -4096)] and not hits[(at, 4096)] for at in ("link", "node")), hits


def test_bisection_source_equals_the_plain_bisection_bit_for_bit(host_kernels):
    # seg_obb_dist2 (its per-axis term a select and a sign copy) against the
    # plain bisection (jnp.sign times the clamp): random segments and half
    # extents of either sign, and segments whose x coordinate crosses 0 at
    # one of the bisection's midpoints (q0_x = -k a, q1_x = (2^m - k) a), where
    # jnp.sign's 0 decides the step; y varies along the segment, so a step
    # taken the other way shows in the returned bits.
    rng = np.random.default_rng(35)
    n = 4096
    q = rng.normal(0.0, 1.0, (n, 6)).astype(np.float32)
    half = rng.uniform(-0.5, 1.0, (n, 3)).astype(np.float32)
    crafted = n // 2
    a = np.float32(0.25)
    k = rng.integers(1, 4, crafted)
    m = rng.integers(2, 4, crafted)
    q[:crafted, 0] = -k * a
    q[:crafted, 3] = (2.0 ** m - k) * a
    q[:crafted, 2] = q[:crafted, 5] = 0.0
    obs = np.zeros((n, 15), np.float32)
    obs[:, 3:6] = half
    obs[:, 6:15] = np.eye(3, dtype=np.float32).reshape(-1)
    out = np.empty(n, np.float32)
    ptr = ctypes.POINTER(ctypes.c_float)
    fn = host_kernels["probe"].probe_seg_obb_dist2
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_int]
    fn(q.ctypes.data_as(ptr), obs.ctypes.data_as(ptr), out.ctypes.data_as(ptr), n)
    qt, ht = torch.as_tensor(q), torch.as_tensor(half)
    want = fkm.seg_obb_dist2_frame([qt[:, i] for i in range(3)],
                                   [qt[:, 3 + i] for i in range(3)],
                                   [ht[:, i] for i in range(3)]).numpy()
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", ["dual_arm_14dof", "snake:20"])
def test_on_demand_box_source_equals_the_plain_tile_bit_for_bit(host_kernels, name):
    rng = np.random.default_rng(32)
    spec, problem = model_spec(name, "cpu")
    for tag, obs in _scenes(spec, rng).items():
        fit, meta, swarm, x = _case(spec, problem, obs, "box", 4, 64, rng)
        got = host_fk_fitness(host_kernels, spec, x, meta, swarm, obs.count, "box", name)
        want = fkm.fk_fitness_plain(spec, x, meta, swarm, num_obstacles=obs.count,
                                    collision_shape="box", gizmo_size=GIZMO)
        assert torch.equal(got, want), (tag, int((got != want).sum()))


@pytest.mark.parametrize("shape", ["box", "capsule"])
def test_kernel_b_source_matches_the_interpreted_pallas_tile(host_kernels, shape):
    # The 4-box scene of the obstacle slice, S=1, P=1024, held as
    # tests/test_torch_fitness.py holds the plain tile: identical masks,
    # values to JAX's scene bar.
    rng = np.random.default_rng(33)
    spec_j, problem_j = jlib.arm_7dof()
    spec = convert.chain_spec_from(spec_j)
    obs = obstacle_scene(spec, 4)
    obs_j = JObstacles.from_boxes(obs.center.numpy(), obs.half_extent.numpy() * 2)
    fit_j = JFit(angle_weight=1.0, collision_shape=shape, gizmo_size=GIZMO)
    batched_j = jlib.batched_problem(problem_j, problem_j.targets[None])
    lo, hi = spec.limits().numpy()
    x = (lo + rng.random((1, 1024, spec.dof)) * (hi - lo)).astype(np.float32)
    want = np.asarray(make_pallas_fitness(spec_j, batched_j, fit=fit_j, obstacles=obs_j,
                                          interpret=True)(jnp.asarray(x)))
    batched = convert.problem_from(batched_j)
    meta = fkm.pack_meta(spec, convert.fitness_config_from(fit_j), obs)
    swarm = fkm.pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                           fk_ops.fk_points(spec, batched.pose, batched.origin))
    got = host_fk_fitness(host_kernels, spec, torch.as_tensor(x), meta, swarm, obs.count,
                          shape).numpy()
    hit_want = want >= float(COLLISION_PENALTY)
    np.testing.assert_array_equal(got >= float(COLLISION_PENALTY), hit_want)
    assert hit_want.any() and (~hit_want).any()
    np.testing.assert_allclose(got[~hit_want], want[~hit_want], rtol=SCENE_TOL,
                               atol=SCENE_TOL)
