"""Build and load the hand-written CUDA kernels (``ikpso_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into plain-C
shared libraries and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds. The libraries are built at first use into
``build/ikpso_tpu_torch/`` under the repository root and rebuilt when
the hash of the sources (or of the flags) changes. Nothing is
downloaded and nothing outside ``csrc/`` is compiled.

Every C entry point returns ``cudaGetLastError()``; :func:`check`
raises when it is non-zero. Kernels launch on PyTorch's current stream.

Topology, scene collider, the orientation and distance terms and the
trig are compile-time constants of the kernels (the TPU kernels unroll
them at trace time), except in the serial-chain variant, which takes a
serial chain's node count at run time. Two kinds of library hold them:

  * the prebuilt library (:func:`library`): the topologies of
    :data:`KERNEL_TOPOLOGIES` in the combinations of
    :data:`INSTANTIATED`, and the serial-chain variant;
  * an on-demand library per :class:`OnDemandKey`
    (:func:`on_demand_library`): any other tree or combination, compiled
    from a generated ``.cu`` that instantiates ``csrc/on_demand.cuh`` for
    that key (:func:`on_demand_source`); :func:`prebuild` compiles many
    keys in parallel.

:func:`kernel_variant` routes a (chain, scene, orientation, distance,
trig) request to one of them; nothing is refused but an unknown collider
shape or trig.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ikpso_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # No mul+add contraction: the kernels then round op by op exactly
    # like the plain torch versions, so kernel and plain agree to the
    # last bit on the same inputs and a PSO trajectory cannot fork on a
    # 1-ulp argmin difference (see PERF.md, kernel A).
    "-fmad=false",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
SOURCES = ("fused_solve.cu", "fused_solve_short.cu", "fk_fitness.cu", "fused_fitness.cu",
           "scan_step.cu", "roofline.cu")

# (num_nodes, packed parents, effector bit mask) -> id; must match the
# instantiations in csrc/fk_fitness.cuh (Arm7Dof, ReferenceArm, Arm6Dof,
# DualArm14, Humanoid45, Snake30), which the launchers of kernels A, B and
# C all instantiate. planar_3dof has arm_7dof's code and runs on id 0.
KERNEL_TOPOLOGIES = {
    (4, 0x2100, 0x8): 0,  # arm_7dof: serial 3 links, effector node 3
    (8, 0x44432100, 0xE0): 1,  # reference_arm: 4 elbows + 3 effector children
    (3, 0x100, 0x4): 2,  # arm_6dof: serial 2 links, effector node 2
    (7, 0x5402100, 0x48): 3,  # dual_arm_14dof: two 3-link arms, effectors 3, 6
    (16, 0xED0BA08725422100, 0x9248): 4,  # humanoid_45dof: 5 effectors
    (11, 0x98765432100, 0x400): 5,  # snake_30dof: serial 10 links, effector node 10
}
# The serial-chain variant of kernels A, B and C (csrc/fk_fitness.cuh,
# fk_fitness_eval_serial): any chain whose node k hangs off node k - 1 and
# whose one effector is the last node, the node count a run-time value.
# It runs every serial chain without a compile-time instantiation, with
# neither a scene, the orientation or distance term nor exact trig.
SERIAL = 6
# Any other tree, or a combination the prebuilt library lacks: built on
# demand (OnDemandKey).
ON_DEMAND = 7
TOPOLOGY_NAMES = ("arm_7dof", "reference_arm", "arm_6dof", "dual_arm_14dof",
                  "humanoid_45dof", "snake_30dof", "serial", "on_demand")
TRIG_IMPLS = ("poly", "exact")

# Kernel A's thread-block bound per topology id (its __launch_bounds__,
# KernelAThreads in csrc/fused_solve.cu): one thread per particle, so the
# most particles a swarm may have; 1024 where not listed. 256 (the
# reference_arm and snake presets' P) lets a thread hold 80 registers with
# three blocks an SM (KernelAMinBlocks), 512 (the humanoid's) 128 with one,
# 1024 only 64.
MAX_PARTICLES = {1: 256, 4: 512, 5: 256}
# The prebuilt short chains (ShortChain in csrc/fused_solve.cuh: v and
# lbest in registers, whole draw arrays; an on-demand chain placed so runs
# the same kernel at its key's bound): arm_7dof and arm_6dof. Each has a
# second instantiation at SHORT_THREADS threads (kShortThreads), which a
# swarm of at most that many particles takes: a thread may hold 80
# registers there (128 with the box scene) instead of 64.
SHORT_IDS = (0, 2)
SHORT_THREADS = 256
# The prebuilt topologies whose kernel A streams its draws (StreamDraws in
# csrc/fused_solve.cuh: every tree-loop topology); an on-demand topology
# streams from STREAM_DOF DOFs.
STREAM_IDS = (1, 3, 4, 5)
STREAM_DOF = 18
# Past this many DOFs an on-demand topology's kernel A keeps x and v in
# global scratch (the serial-chain variant's layout), at a 512-thread
# bound: the humanoid's 45 already took 128 registers and spilled at 512
# with all three in registers, and at a 1,024-thread bound the scratch
# layout spilled 300 bytes on the 21-keypoint hand (PERF.md).
SCRATCH_DOF = 45

# Kernel A's cluster layout (csrc/fused_solve_cluster.cuh): x in registers,
# v and lbest in shared memory, a swarm over a cluster of c blocks of at
# most CLUSTER_THREADS threads (kClusterThreads, kClusterMax). An on-demand
# tree of SCRATCH_DOF + 1 to CLUSTER_MAX_DOF DOFs that branches builds it
# beside the scratch layout, and takes it at any swarm whose blocks hold
# v and lbest (tree_cluster). The evidence, on an H100 (PERF.md): hand21
# (60 DOFs, the widest measured: 255 registers, 0 spill bytes) ran 1.9x
# faster than its scratch layout at P = 512 and 2.0x at P = 256, hand16
# (48 DOFs) 1.6x at P = 512; every chain lost: snake20_box (a 21-node
# chain among boxes, built on demand, P = 256) 1.18x slower, and the
# serial chains' cluster source (tools/kernel_a_cluster_serial.cu) 1.2-2.6x
# slower on snake:16 to snake:50. So chains keep the scratch layout.
CLUSTER_THREADS = 256
CLUSTER_SIZES = (1, 2, 4)
CLUSTER_MAX_DOF = 60

# The prebuilt topologies whose kernel A runs the register layout's tree
# loop (TreeLoop in csrc/fused_solve.cuh: fused_solve_tree_kernel, v and
# lbest a row a particle in shared memory, the constants at compile-time
# offsets, one barrier a gbest refresh): the dual arm, the humanoid,
# reference_arm and snake_30dof. Kept where it won at least 8 of 10 pairs
# against the parent's kernel and no instantiation spills (an H100,
# PERF.md, tools/kernel_a_tree_variants.py).
# An on-demand key (OnDemandKey.tree) takes it wherever it streams its
# draws and keeps v and lbest in shared memory and a block fits at its
# thread bound (tree_fits): the twins of these with the orientation term,
# the capsule collider, the distance term or exact trig, and the trees of
# STREAM_DOF to SCRATCH_DOF DOFs of a user's config, with or without a
# scene. Held to it on an H100: the dual arm's twins with the capsule
# collider, the distance term and exact trig, and hand12 (36 DOFs) with
# and without the box scene; the humanoid's, reference_arm's and
# snake_30dof's twins with a scene follow the same rule, untimed.
# The box scene at 64 registers a thread (a 1,024-thread bound:
# dual_arm_box) keeps the general loop: the tree loop's forms that spilled
# nothing there lost to it (the box narrow phase's state in shared memory,
# or deferred to a queue a warp), and the one that won spilled.
TREE_LOOP_IDS = (1, 3, 4, 5)

# The prebuilt topologies whose v and lbest are in shared memory: the trees,
# reference_arm and snake_30dof. An on-demand topology in the register
# layout follows its prebuilt twin's placement, else takes shared memory
# where it streams its draws (from STREAM_DOF DOFs: the register budget
# decides both); in the scratch layout lbest takes shared memory where it
# fits at the topology's thread bound with SMEM_RESERVE to spare. The
# serial-chain variant decides per launch (serial_lbest_shared).
SHARED_IDS = (1, 3, 4, 5)
# Dynamic shared memory a block may have on an H100 (the opt-in maximum,
# cudaDevAttrMaxSharedMemoryPerBlockOptin; the kernels check the card's),
# and what an SM holds for its blocks, 1 KB of it reserved a block.
SMEM_OPTIN = 232_448
SMEM_PER_SM = 233_472
# Shared memory kept free for the constants when an on-demand key's
# placement is chosen, before its scene is known: meta with ~250 scene
# boxes beside the swarm row.
SMEM_RESERVE = 16 * 1024

# Collider variants (enum Collider in csrc/fk_fitness.cuh; 0 = none).
COLLIDERS = {"box": 1, "capsule": 2}

# The (topology id, collider id, orientation) combinations that the
# prebuilt launchers of kernels A, B and C and the scan step instantiate
# (without the distance term, with polynomial trig): the ones the earlier
# paths run.
# Any other combination is built on demand.
INSTANTIATED = {
    (0, 0, False), (0, 1, False), (0, 2, False),  # arm_7dof, planar_3dof; scenes
    (1, 0, False),  # reference_arm
    (2, 0, False), (2, 0, True),  # arm_6dof, position only and with orientation
    (3, 0, False), (4, 0, False),  # dual_arm_14dof, humanoid_45dof
    (5, 0, False), (SERIAL, 0, False),  # snake_30dof; any other serial chain
}


class OnDemandKey(NamedTuple):
    """What an on-demand library instantiates (``csrc/on_demand.cuh``): the
    tree, the collider id, the three term flags, and kernel A's traits
    chosen for the topology (:func:`on_demand_key`): its thread bound,
    streamed draws, the scratch layout and its state placement (``shared``:
    v and lbest, in the scratch layout lbest, in shared memory), the
    cluster layout beside the scratch one (``cluster``; :func:`tree_cluster`
    picks one a launch), and the register layout's tree loop (``tree``,
    :data:`TREE_LOOP_IDS`). Kernel A's replay and Philox instantiations
    share a library."""

    parents: Tuple[int, ...]
    effectors: Tuple[int, ...]
    collider: int
    orientation: bool
    distance: bool
    exact: bool
    threads: int
    stream: bool
    scratch: bool
    shared: bool
    cluster: bool = False
    tree: bool = False

    def name(self) -> str:
        """A short readable tag: nodes, collider and terms."""
        flags = "".join(c for c, on in (("o", self.orientation), ("d", self.distance),
                                        ("x", self.exact)) if on)
        return (f"n{len(self.parents)}-c{self.collider}-{flags or 'p'}"
                f"{'-scratch' if self.scratch else ''}{'-cluster' if self.cluster else ''}")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def branches(spec) -> bool:
    """Whether some node of ``spec`` has two or more children (a chain
    has none)."""
    kids = list(spec.parent[1:])
    return len(set(kids)) < len(kids)


def is_serial(spec) -> bool:
    """Whether node k's parent is k - 1 for every k and the last node is
    the one effector: the chains the serial-chain variant runs."""
    n = spec.num_nodes
    return (n >= 2 and list(spec.parent[1:]) == list(range(n - 1))
            and list(spec.effector_idx) == [n - 1])


def topology_code(spec):
    """``(num_nodes, packed parents, effector mask)`` of a ChainSpec:
    parent of node k in bits ``[4k, 4k+4)``, effector k at bit k. Past 16
    nodes there is no parent word (``None``): the prebuilt topologies all
    fit one."""
    n = spec.num_nodes
    mask = 0
    for e in spec.effector_idx:
        mask |= 1 << e
    if n > 16:
        return n, None, mask
    parents = 0
    for k in range(1, n):
        parents |= spec.parent[k] << (4 * k)
    return n, parents, mask


def _prebuilt_id(spec):
    """The prebuilt compile-time topology of ``spec``, or None."""
    code = topology_code(spec)
    if code in KERNEL_TOPOLOGIES and list(spec.effector_idx) == sorted(spec.effector_idx):
        return KERNEL_TOPOLOGIES[code]
    return None


def topology_id(spec) -> int:
    """Id of ``spec``'s topology: the prebuilt compile-time one where it
    exists, else :data:`SERIAL` for a serial chain, else :data:`ON_DEMAND`."""
    topo = _prebuilt_id(spec)
    if topo is not None:
        return topo
    return SERIAL if is_serial(spec) else ON_DEMAND


def topology_name(spec) -> str:
    """A prebuilt topology's name, ``serial``, or ``tree<N>`` for a tree
    that is compiled on demand."""
    topo = topology_id(spec)
    return f"tree{spec.num_nodes}" if topo == ON_DEMAND else TOPOLOGY_NAMES[topo]


def kernel_variant(spec, num_obstacles: int, collision_shape: str,
                   use_orientation: bool, use_distance: bool = False,
                   trig_impl: str = "poly"):
    """``(topology id, collider id, orientation flag)`` of the kernels that
    run a chain with an obstacle scene (collider 0 without one), the
    orientation and distance terms and ``trig_impl``: a prebuilt
    instantiation where :data:`INSTANTIATED` holds it (no distance term,
    polynomial trig), else :data:`ON_DEMAND` (:func:`on_demand_key`)."""
    collider = 0
    if num_obstacles:
        if collision_shape not in COLLIDERS:
            raise ValueError(f"unknown collision_shape {collision_shape!r}")
        collider = COLLIDERS[collision_shape]
    if trig_impl not in TRIG_IMPLS:
        raise ValueError(f"unknown trig_impl {trig_impl!r}; expected one of {TRIG_IMPLS}")
    topo = topology_id(spec)
    key = (topo, collider, bool(use_orientation))
    if key in INSTANTIATED and not use_distance and trig_impl == "poly":
        return topo, collider, int(use_orientation)
    return ON_DEMAND, collider, int(use_orientation)


def on_demand_threads(spec) -> int:
    """Kernel A's thread-block bound for ``spec`` built on demand: a
    prebuilt topology's own bound, 1024 up to :data:`STREAM_DOF` DOFs,
    else 512 (128 registers a thread), the scratch layout too."""
    topo = _prebuilt_id(spec)
    if topo is not None:
        return MAX_PARTICLES.get(topo, 1024)
    return 1024 if spec.dof <= STREAM_DOF else 512


def kernel_a_smem_bytes(m: int, k: int, d: int, p: int, planes: int) -> int:
    """Kernel A's dynamic shared memory (``kernel_a_smem_bytes`` in
    ``csrc/fused_solve.cuh``): meta (``m`` floats), the swarm row (``k``),
    the limits and gbest (``3 d``) and the argmin scratch (64 words),
    rounded up to 16 bytes, then ``planes`` ``[d][p]`` float planes."""
    return 4 * ((m + k + 3 * d + 64 + 3) // 4 * 4 + planes * d * p)


def _shared_fits(d: int, p: int, planes: int) -> bool:
    return kernel_a_smem_bytes(0, 0, d, p, planes) + SMEM_RESERVE <= SMEM_OPTIN


def on_demand_shared(spec, threads: int, scratch: bool) -> bool:
    """Whether an on-demand kernel A of ``spec`` keeps v and lbest (the
    scratch layout: lbest) in shared memory (see :data:`SHARED_IDS`)."""
    if scratch:
        return _shared_fits(spec.dof, threads, 1)
    topo = _prebuilt_id(spec)
    if topo is not None:
        return topo in SHARED_IDS
    return spec.dof >= STREAM_DOF and _shared_fits(spec.dof, threads, 2)


def serial_lbest_shared(d: int, p: int, m: int, k: int) -> bool:
    """Whether the serial-chain variant keeps lbest in shared memory at
    ``d`` DOFs and ``p`` particles with ``m`` + ``k`` constants: where an
    SM then still holds two of its blocks, or as many as their registers
    let it where that is fewer (64 a thread at the variant's 1,024-thread
    bound). At P = 256 (the snakes' presets), four blocks fit an SM without
    lbest in shared memory; with it, ``snake:20`` kept three and ran 34%
    faster, ``snake:50`` kept one and ran 16% slower (PERF.md)."""
    by_registers = min(32, 65_536 // (64 * p))
    fit = SMEM_PER_SM // (kernel_a_smem_bytes(m, k, d, p, 1) + 1024)
    return fit >= min(2, by_registers)


def cluster_smem_bytes(m: int, k: int, d: int, pb: int) -> int:
    """A block's dynamic shared memory in kernel A's cluster layout
    (``cluster_smem_bytes`` in ``csrc/fused_solve.cuh``), ``pb``
    threads a block: the limits and two winner rows (``4 d4``, ``d4`` =
    ``d`` rounded up to 4), two slots of 4 words, 3 x 32 warp words, meta
    and the swarm row rounded up to 4, then two planes (v and lbest) of
    ``pb`` rows, each ``d4`` rounded up to an odd number of float4
    (``cluster_row``)."""
    d4 = (d + 3) // 4 * 4
    row = d4 if d4 // 4 % 2 else d4 + 4
    return 4 * (4 * d4 + 8 + 96 + (m + k + 3) // 4 * 4 + 2 * row * pb)


def cluster_size(d: int, p: int, m: int, k: int) -> int:
    """The cluster size of kernel A's cluster layout for ``p`` particles:
    the least of :data:`CLUSTER_SIZES` whose blocks (``p / c`` threads, a
    multiple of 32, at most :data:`CLUSTER_THREADS`) hold v and lbest in
    their shared memory (:func:`cluster_smem_bytes`), 0 where none does."""
    for c in CLUSTER_SIZES:
        if (p % (32 * c) == 0 and p // c <= CLUSTER_THREADS
                and cluster_smem_bytes(m, k, d, p // c) <= SMEM_OPTIN):
            return c
    return 0


def on_demand_key(spec, collider: int, orientation: bool, distance: bool = False,
                  exact: bool = False) -> OnDemandKey:
    """The on-demand library of ``spec`` with a collider id and term flags.
    A tree past :data:`SCRATCH_DOF` DOFs takes the scratch layout and, if
    it branches (:func:`branches`), has at most :data:`CLUSTER_MAX_DOF`
    DOFs and a cluster of blocks holds its state at the topology's thread
    bound with :data:`SMEM_RESERVE` to spare, the cluster layout beside it
    (:func:`tree_cluster` picks one a launch). One in the register layout
    that streams its draws and keeps v and lbest in shared memory takes the
    tree loop where its block fits (:func:`tree_fits`), but for the box
    scene at 64 registers a thread (:data:`TREE_LOOP_IDS`)."""
    topo = _prebuilt_id(spec)
    threads = on_demand_threads(spec)
    scratch = topo is None and spec.dof > SCRATCH_DOF
    cluster = (scratch and spec.dof <= CLUSTER_MAX_DOF and branches(spec)
               and cluster_size(spec.dof, threads, SMEM_RESERVE // 4, 0) > 0)
    stream = scratch or (topo in STREAM_IDS if topo is not None else spec.dof >= STREAM_DOF)
    shared = on_demand_shared(spec, threads, scratch)
    box_at_64 = collider == COLLIDERS["box"] and 65_536 // threads <= 64
    tree = (stream and shared and not scratch and not box_at_64
            and tree_fits(spec, collider, orientation, threads))
    return OnDemandKey(tuple(int(p) for p in spec.parent),
                       tuple(int(e) for e in spec.effector_idx), int(collider),
                       bool(orientation), bool(distance), bool(exact),
                       threads, bool(stream), bool(scratch), bool(shared), bool(cluster),
                       bool(tree))


def tree_fits(spec, collider: int, orientation: bool, threads: int) -> bool:
    """Whether a block of the tree loop holds ``threads`` particles of
    ``spec`` (:func:`tree_smem_bytes`, :func:`tree_static_bytes`) with
    :data:`SMEM_RESERVE` to spare for meta."""
    return (tree_smem_bytes(SMEM_RESERVE // 4, spec.dof, threads)
            + tree_static_bytes(spec, collider, orientation, threads) <= SMEM_OPTIN)


def tree_cluster(key: OnDemandKey, d: int, p: int, m: int, k: int) -> int:
    """The cluster size kernel A of an on-demand ``key`` takes at ``p``
    particles with ``m`` + ``k`` constants (:func:`cluster_size`), 0 for
    its scratch layout: a key without the cluster layout, or a swarm that
    no cluster's blocks hold."""
    return cluster_size(d, p, m, k) if key.cluster else 0


class KernelALayout(NamedTuple):
    """Where one launch of kernel A keeps its state (StatePlacement in
    ``csrc/fused_solve.cuh``), the dynamic shared memory a block takes and
    the thread bound of the instantiation it runs. In the register layout
    (``scratch`` false, ``cluster`` 0) x is in registers and v and lbest are
    in registers too (``placement`` "registers") or in shared memory,
    ``[D][P]`` each ("shared"); in the scratch layout x and v are in global
    scratch (``scratch_planes`` ``[D][P]`` planes a block) and lbest is in
    shared memory ("shared") or in the scratch too ("global"); in the
    cluster layout (``cluster``: c > 0 blocks a swarm,
    ``csrc/fused_solve_cluster.cuh``) x is in registers and v and lbest are
    in each block's shared memory ("shared"), no scratch. In the register
    layout's tree loop (``tree``) v and lbest are a row a particle in
    shared memory (:func:`tree_smem_bytes`). A short chain's kernel and the
    tree loop take ``static_bytes`` of static shared memory besides
    (:func:`short_static_bytes`, :func:`tree_static_bytes`)."""

    scratch: bool
    placement: str
    smem_bytes: int
    scratch_planes: int
    threads: int
    static_bytes: int
    cluster: int = 0
    tree: bool = False


def kernel_a_layout(spec, num_particles: int, num_obstacles: int = 0,
                    collision_shape: str = "box", use_orientation: bool = False,
                    use_distance: bool = False, trig_impl: str = "poly",
                    swarm_width=None) -> KernelALayout:
    """Kernel A's layout for ``spec`` at ``num_particles`` particles with
    the given scene and terms (routed as :func:`kernel_variant` routes
    them); ``swarm_width`` is the swarm rows' length (default: the packed
    layout's)."""
    from ikpso_tpu_torch.ops.fitness_kernel import MetaLayout

    topo, collider, orient = kernel_variant(spec, num_obstacles, collision_shape,
                                            use_orientation, use_distance, trig_impl)
    lay = MetaLayout(spec, num_obstacles, use_orientation)
    m, k = lay.meta_size, lay.swarm_size if swarm_width is None else int(swarm_width)
    d, p = spec.dof, num_particles
    c = 0
    if topo == ON_DEMAND:
        key = on_demand_key(spec, collider, orient, use_distance, trig_impl == "exact")
        c = tree_cluster(key, d, p, m, k)
    if c:
        return KernelALayout(False, "shared", cluster_smem_bytes(m, k, d, p // c), 0,
                             CLUSTER_THREADS, 0, c)
    if topo == SERIAL:
        scratch, shared, threads = True, serial_lbest_shared(d, p, m, k), 1024
        short = tree = False
    elif topo == ON_DEMAND:
        scratch, shared, threads = key.scratch, key.shared, key.threads
        short, tree = not (key.scratch or key.stream or key.shared), key.tree
    else:
        scratch, shared = False, topo in SHARED_IDS
        short, tree = topo in SHORT_IDS, topo in TREE_LOOP_IDS
        threads = (SHORT_THREADS if short and p <= SHORT_THREADS
                   else MAX_PARTICLES.get(topo, 1024))
    if tree:
        return KernelALayout(False, "shared", tree_smem_bytes(m, d, p), 0, threads,
                             tree_static_bytes(spec, collider, bool(orient), threads),
                             tree=True)
    planes = (1 if scratch else 2) if shared else 0
    placement = "shared" if shared else ("global" if scratch else "registers")
    return KernelALayout(scratch, placement, kernel_a_smem_bytes(m, k, d, p, planes),
                         (2 if shared else 3) if scratch else 0, threads,
                         short_static_bytes(spec, collider, bool(orient), threads)
                         if short else 0)


def tree_row(d: int) -> int:
    """A particle's row of v and lbest in the tree loop (``tree_row`` in
    ``csrc/fused_solve.cuh``): twice ``d`` rounded up to 4, rounded up to
    an odd number of float4."""
    d4 = (d + 3) // 4 * 4
    return 2 * d4 if d4 // 2 % 2 else 2 * d4 + 4


def tree_smem_bytes(m: int, d: int, p: int) -> int:
    """The tree loop's dynamic shared memory (``tree_smem_bytes`` in
    ``csrc/fused_solve.cuh``): meta (``m`` floats, rounded up to 4), then
    ``p`` rows (:func:`tree_row`)."""
    return 4 * ((m + 3) // 4 * 4 + p * tree_row(d))


def tree_static_bytes(spec, collider: int, orientation: bool, threads: int) -> int:
    """The tree loop's static shared memory (``TreeShared`` in
    ``csrc/fused_solve.cuh``) at ``threads`` threads a block: the short
    chains' (:func:`short_static_bytes`), then the Philox key, the replay's
    base and the two locality weights, 24 bytes padded to 32 (16-byte
    alignment)."""
    return short_static_bytes(spec, collider, orientation, threads) + 32


def short_static_bytes(spec, collider: int, orientation: bool, threads: int) -> int:
    """A short chain's static shared memory (``ShortShared`` in
    ``csrc/fused_solve.cuh``): the swarm row through the target rotations
    and meta through the effector weights (and, without a scene, the
    orientation weight), the two limit rows, each rounded up to whole
    float4, then for two refreshes each warp's lbest row, key, id and
    value."""
    def pad(n):
        return (n + 3) // 4 * 4

    n, d, e = spec.num_nodes, spec.dof, len(spec.effector_idx)
    sw = pad(12 + d + 3 * e + 3 * (n - 1) + (9 * e if orientation else 0))
    meta = pad(2 + (n - 1) + e + (1 if orientation and not collider else 0))
    warps = threads // 32
    return 4 * (sw + meta + 2 * pad(d) + 2 * warps * pad(d) + 6 * warps)


def max_particles(spec, num_obstacles: int = 0, collision_shape: str = "box",
                  use_orientation: bool = False, use_distance: bool = False,
                  trig_impl: str = "poly") -> int:
    """The most particles kernel A takes per swarm for ``spec`` with the
    given scene and terms (its thread-block bound)."""
    topo, _, _ = kernel_variant(spec, num_obstacles, collision_shape, use_orientation,
                                use_distance, trig_impl)
    if topo == ON_DEMAND:
        return on_demand_threads(spec)
    return MAX_PARTICLES.get(topo, 1024)


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return found


def library_path() -> Path:
    return BUILD_DIR / f"libikpso_kernels-{_source_hash()}.so"


def build() -> Path:
    """Compile the kernels if the current sources have no library yet.

    One ``nvcc -c`` per source, all started together, then one link.
    Writes the compiler's register/spill report beside the library
    (``<lib>.log``). Returns the library path.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{Path(src).stem}.o" for src in SOURCES]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(f"$ {' '.join(c)}\n{o}" for c, o in zip(cmds, outs))
        rc = next((p.returncode for p in procs if p.returncode), 0)
        if not rc:
            link = [_nvcc(), *LINK_FLAGS, "-o", str(Path(tmp) / "lib.so"),
                    *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            log += f"$ {' '.join(link)}\n{proc.stdout}{proc.stderr}"
            rc = proc.returncode
        lib.with_suffix(".log").write_text(
            log + f"\nbuild_seconds={time.perf_counter() - t0:.3f}\n"
        )
        if rc:
            raise RuntimeError(f"nvcc failed (rc {rc}):\n{log}")
        os.replace(Path(tmp) / "lib.so", lib)
    return lib


_SCENE = [_I, _F, _F, _F, _F]  # obstacle count, collider sizes
# The scan step's arguments after the topology's (IKPSO_STEP_PARAMS in
# csrc/scan_step.cuh).
_STEP = [
    _VP, _VP, _I, _VP,  # meta, swarm, K, limits (2, D)
    _VP, _VP, _VP, _VP,  # x, v, lbest, lbest values
    _I, _VP, _VP,  # replay flag, the iteration's uniforms (replay), seed words (drawing)
    _I, _I,  # n_draws, iteration
    _VP, _VP,  # gbest, gbest values
    _VP, _VP,  # the hook's candidate value and coordinates (null: none)
    _F, _F, _F, _I,  # w, c1, c2, randomized inertia flag
    _I, _F, _F,  # kick (0 none, 1 every swarm, 2 above the threshold), scale, threshold
    _VP, _VP, _I, _VP,  # candidate values, ids, their row stride, arrival counters
    _I, _I, _VP,  # S, P, stream
]
_UPDATE = [
    _VP, _VP, _VP, _I,  # limits, seeds, inertia, iterations
    _F, _F, _F,  # c1, c2, init velocity scale
    _I, _I,  # randomized inertia flag, gbest interval
    _I, _F, _F,  # re-kick interval (0: off), scale, threshold (< 0: kick all)
    _VP, _I,  # uniforms, n_draws
]
# Every C entry point's arguments; each returns a CUDA error code (the
# occupancy query: a block count, <= 0 on error).
SIGNATURES = {
    "ikpso_fk_fitness": [
        _I, _I, _I, *_SCENE,  # topology id, collider id, orientation flag, scene
        _VP, _VP, _VP, _I, _VP, ctypes.c_longlong, _I, _VP,
    ],
    "ikpso_fk_fitness_serial": [
        _I,  # nodes, then ikpso_fk_fitness's arguments after the scene
        _VP, _VP, _VP, _I, _VP, ctypes.c_longlong, _I, _VP,
    ],
    "ikpso_fused_solve": [
        _I, _I, _I, _I, _I,  # topology id, collider id, orientation, replay, init mode
        *_SCENE,
        _VP, _I,  # meta, M
        _VP, _I,  # swarm, K
        *_UPDATE,
        _VP, _VP,  # out gbest, out gval
        _I, _I, _I, _VP,  # S, P, the instantiation's thread bound, stream
    ],
    "ikpso_fused_solve_serial": [
        _I, _I, _I, _I,  # replay, lbest in shared memory, init mode, nodes
        _VP, _I, _VP, _I,  # meta, M, swarm, K
        *_UPDATE,
        _VP, _I,  # scratch, grid
        _VP, _VP,  # out gbest, out gval
        _I, _I, _VP,  # S, P, stream
    ],
    # replay, lbest in shared memory, P, M, K, nodes
    "ikpso_fused_solve_serial_blocks": [_I, _I, _I, _I, _I, _I],
    "ikpso_kernel_a_cluster_smem_bytes": [_I, _I, _I, _I],  # M, K, D, Pb
    "ikpso_kernel_a_smem_bytes": [_I, _I, _I, _I, _I],  # M, K, D, P, planes
    "ikpso_kernel_a_tree_smem_bytes": [_I, _I, _I],  # M, D, P
    "ikpso_kernel_a_short_threads": [],
    "ikpso_fused_fitness": [
        _I, _I, _I, *_SCENE,  # topology id, collider id, orientation flag, scene
        _VP, _VP, _VP, _I, _VP, _I, _I, _VP,  # x, meta, swarm, K, out, S, P, stream
    ],
    "ikpso_fused_fitness_serial": [
        _I,  # nodes, then ikpso_fused_fitness's arguments after the scene
        _VP, _VP, _VP, _I, _VP, _I, _I, _VP,
    ],
    "ikpso_scan_step": [
        _I, _I, _I, *_SCENE,  # topology id, collider id, orientation flag, scene
        *_STEP,
    ],
    "ikpso_scan_step_serial": [_I, *_STEP],  # nodes
    "ikpso_roofline_body": [
        _I, _VP, _VP, ctypes.c_longlong, _I, _I, _I, _VP,  # body, x, out, n, steps, grid
    ],
    "ikpso_philox_xor": [
        ctypes.c_uint, ctypes.c_uint, _VP, ctypes.c_longlong, _I, _VP,  # key, out, n, steps
    ],
}


# The entry points of an on-demand library (csrc/on_demand.cuh).
OD_SIGNATURES = {
    "ikpso_od_fused_solve": [
        _I, _I, *_SCENE,  # replay, init mode, scene
        _VP, _I, _VP, _I,  # meta, M, swarm, K
        *_UPDATE,
        _VP, _I,  # scratch, grid (the scratch layout)
        _VP, _VP,  # out gbest, out gval
        _I, _I, _VP,  # S, P, stream
    ],
    "ikpso_od_fused_solve_blocks": [_I, _I, _I, _I],  # replay, P, M, K
    # The cluster layout's (a library of a cluster key has them).
    "ikpso_od_fused_solve_cluster": [
        _I, _I, _I, *_SCENE,  # replay, cluster size, init mode, scene
        _VP, _I, _VP, _I,  # meta, M, swarm, K
        *_UPDATE,
        _I,  # clusters
        _VP, _VP,  # out gbest, out gval
        _I, _I, _VP,  # S, P, stream
    ],
    "ikpso_od_fused_solve_cluster_blocks": [_I, _I, _I, _I, _I],  # replay, c, P, M, K
    "ikpso_od_fk_fitness": [*_SCENE, _VP, _VP, _VP, _I, _VP, ctypes.c_longlong, _I, _VP],
    "ikpso_od_fused_fitness": [*_SCENE, _VP, _VP, _VP, _I, _VP, _I, _I, _VP],
    "ikpso_od_scan_step": [*_SCENE, *_STEP],
}


def on_demand_source(key: OnDemandKey) -> str:
    """The ``.cu`` that instantiates ``csrc/on_demand.cuh`` for ``key``:
    the key's macros and the include, no kernel code."""
    macros = {
        "PARENTS": ", ".join(map(str, key.parents)),
        "EFFECTORS": ", ".join(map(str, key.effectors)),
        "THREADS": key.threads, "STREAM": int(key.stream), "SCRATCH": int(key.scratch),
        "CLUSTER": int(key.cluster), "SHARED": int(key.shared), "TREE": int(key.tree),
        "COLLIDER": key.collider, "ORIENTATION": int(key.orientation),
        "DISTANCE": int(key.distance), "EXACT": int(key.exact),
    }
    lines = [f"// Kernels A, B and C and the scan step on demand for {key.name()}:",
             "// generated by ikpso_tpu_torch/utils/kernels.py (on_demand_source); see",
             "// ikpso_tpu_torch/csrc/on_demand.cuh."]
    lines += [f"#define IKPSO_OD_{k} {v}" for k, v in macros.items()]
    lines.append('#include "on_demand.cuh"')
    return "\n".join(lines) + "\n"


def on_demand_path(key: OnDemandKey) -> Path:
    """The library of ``key``, named by the hash of the kernel sources and
    flags (:func:`library_path`'s) and of the key itself."""
    h = hashlib.sha256(f"{_source_hash()} {key!r}".encode()).hexdigest()[:16]
    return BUILD_DIR / f"libikpso_od-{key.name()}-{h}.so"


def prebuild(keys: Iterable[OnDemandKey]) -> Dict[OnDemandKey, float]:
    """Compile the on-demand libraries of ``keys`` that are not built yet,
    one ``nvcc`` per key, all started together; returns the seconds each
    key's compile took (0.0 where it was built already). Each library's
    ptxas report is written beside it (``<lib>.log``). A failed compile
    raises with nvcc's log."""
    keys = list(dict.fromkeys(keys))
    seconds = {k: 0.0 for k in keys}
    todo = [k for k in keys if not on_demand_path(k).exists()]
    if not todo:
        return seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {}
        for i, key in enumerate(todo):
            src = Path(tmp) / f"od{i}.cu"
            src.write_text(on_demand_source(key))
            cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o",
                   str(Path(tmp) / f"od{i}.so"), str(src)]
            procs[key] = (cmd, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for i, (key, (cmd, t0, proc)) in enumerate(procs.items()):
            out = proc.communicate()[0]
            seconds[key] = time.perf_counter() - t0
            log = (f"$ {' '.join(cmd)}\n{out}\nkey={key!r}\n"
                   f"build_seconds={seconds[key]:.3f}\n")
            lib = on_demand_path(key)
            lib.with_suffix(".log").write_text(log)
            if proc.returncode:
                failed.append(f"{key.name()} (rc {proc.returncode}):\n{log}")
            else:
                os.replace(Path(tmp) / f"od{i}.so", lib)
        if failed:
            raise RuntimeError("nvcc failed for an on-demand key:\n" + "\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def on_demand_library(key: OnDemandKey) -> ctypes.CDLL:
    """The loaded on-demand library of ``key`` (built on first use)."""
    prebuild([key])
    lib = ctypes.CDLL(str(on_demand_path(key)))
    for name, argtypes in OD_SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use). Entry points a
    library lacks (one built from an older checkout's sources) are left
    undeclared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = _I
    for name in ("ikpso_kernel_a_smem_bytes", "ikpso_kernel_a_cluster_smem_bytes",
                 "ikpso_kernel_a_tree_smem_bytes"):
        if hasattr(lib, name):
            getattr(lib, name).restype = ctypes.c_longlong
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# The scan step's block (csrc/scan_step.cuh: kStepMaxThreads, kStepSmemBudget,
# step_smem_bytes, step_threads), mirrored for the op model.
STEP_MAX_THREADS = 128
STEP_SMEM_BUDGET = 48 * 1024


def step_threads(dof: int) -> int:
    """Threads a block of the scan step takes for ``dof`` angles: the most
    of 128, 64, 32 whose shared memory (the x slab at an odd row
    stride, gbest and the limits, the candidates) fits 48 KB; 0 where none
    does."""
    t = STEP_MAX_THREADS
    while t >= 32 and 4 * (t * (dof | 1) + 3 * dof) + 12 * t > STEP_SMEM_BUDGET:
        t //= 2
    return t if t >= 32 else 0


def require_cuda_contiguous(name: str, *tensors: torch.Tensor) -> None:
    """Validate pointers handed to a kernel: CUDA, contiguous, one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every tensor must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
