"""Build and load the hand-written CUDA kernels (``ikpso_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one
plain-C shared library and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds. The library is built at first use into
``build/ikpso_tpu_torch/`` under the repository root and rebuilt when
the hash of the sources (or of the flags) changes. Nothing is
downloaded and nothing outside ``csrc/`` is compiled.

Every C entry point returns ``cudaGetLastError()``; :func:`check`
raises when it is non-zero. Kernels launch on PyTorch's current stream.

Topology, scene collider and the orientation term are compile-time
constants of the kernels (the TPU kernels unroll them at trace time),
except in the serial-chain variant, which takes a serial chain's node
count at run time. :func:`topology_id` maps a ``ChainSpec`` to one of the
instantiated topologies or to that variant and :func:`kernel_variant` a
(topology, scene, orientation) combination to its instantiation; both
raise for anything not instantiated.
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
SOURCES = ("fused_solve.cu", "fk_fitness.cu", "fused_fitness.cu", "roofline.cu")

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
# It runs every serial chain without a compile-time instantiation.
SERIAL = 6
TOPOLOGY_NAMES = ("arm_7dof", "reference_arm", "arm_6dof", "dual_arm_14dof",
                  "humanoid_45dof", "snake_30dof", "serial")

# Kernel A's thread-block bound per topology id (its __launch_bounds__,
# KernelAThreads in csrc/fused_solve.cu): one thread per particle, so the
# most particles a swarm may have; 1024 where not listed. 256 (the
# reference_arm and snake presets' P) lets a thread hold 255 registers,
# 512 (the humanoid's) 128, 1024 only 64.
MAX_PARTICLES = {1: 256, 4: 512, 5: 256}

# Collider variants (enum Collider in csrc/fk_fitness.cuh; 0 = none).
COLLIDERS = {"box": 1, "capsule": 2}

# The (topology id, collider id, orientation) combinations that the
# launchers of kernels A, B and C instantiate: the ones a path runs.
INSTANTIATED = {
    (0, 0, False), (0, 1, False), (0, 2, False),  # arm_7dof, planar_3dof; scenes
    (1, 0, False),  # reference_arm
    (2, 0, False), (2, 0, True),  # arm_6dof, position only and with orientation
    (3, 0, False), (4, 0, False),  # dual_arm_14dof, humanoid_45dof
    (5, 0, False), (SERIAL, 0, False),  # snake_30dof; any other serial chain
}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def is_serial(spec) -> bool:
    """Whether node k's parent is k - 1 for every k and the last node is
    the one effector: the chains the serial-chain variant runs."""
    n = spec.num_nodes
    return (n >= 2 and list(spec.parent[1:]) == list(range(n - 1))
            and list(spec.effector_idx) == [n - 1])


def topology_code(spec):
    """``(num_nodes, packed parents, effector mask)`` of a ChainSpec:
    parent of node k in bits ``[4k, 4k+4)``, effector k at bit k. A serial
    chain of more than 16 nodes has no parent word (``None``): the
    serial-chain variant walks it without one."""
    n = spec.num_nodes
    mask = 0
    for e in spec.effector_idx:
        mask |= 1 << e
    if n > 16:
        if is_serial(spec):
            return n, None, mask
        raise NotImplementedError(
            f"a {n}-node tree: the CUDA kernels pack parents in 4-bit fields of "
            "one 64-bit word, and only serial chains run past 16 nodes "
            "(ROADMAP B1(d), any tree)"
        )
    parents = 0
    for k in range(1, n):
        parents |= spec.parent[k] << (4 * k)
    return n, parents, mask


def topology_id(spec) -> int:
    """Id of the kernel instantiation for ``spec``'s topology: the
    compile-time one where it exists, else :data:`SERIAL` for a serial
    chain; raises for any other tree."""
    code = topology_code(spec)
    if code in KERNEL_TOPOLOGIES and list(spec.effector_idx) == sorted(spec.effector_idx):
        return KERNEL_TOPOLOGIES[code]
    if is_serial(spec):
        return SERIAL
    raise NotImplementedError(
        f"no CUDA kernel instantiated for topology parent={spec.parent}, "
        f"effector_idx={spec.effector_idx} (instantiated: "
        f"{', '.join(TOPOLOGY_NAMES[:SERIAL])} and any serial chain with its "
        "one effector at the last node); any other tree is ROADMAP B1(d)"
    )


def max_particles(spec) -> int:
    """The most particles kernel A takes per swarm for ``spec``'s topology
    (1024 for a topology without a kernel: its plain solve's bound)."""
    try:
        topo = topology_id(spec)
    except NotImplementedError:
        return 1024
    return MAX_PARTICLES.get(topo, 1024)


def kernel_variant(spec, num_obstacles: int, collision_shape: str,
                   use_orientation: bool):
    """``(topology id, collider id, orientation flag)`` of the kernel
    instantiation for a chain, an obstacle scene (collider 0 without one)
    and the orientation term; raises for a combination no path uses."""
    collider = 0
    if num_obstacles:
        if collision_shape not in COLLIDERS:
            raise ValueError(f"unknown collision_shape {collision_shape!r}")
        collider = COLLIDERS[collision_shape]
    key = (topology_id(spec), collider, bool(use_orientation))
    if key not in INSTANTIATED:
        raise NotImplementedError(
            f"no CUDA kernel instantiated for parent={spec.parent} with "
            f"{collision_shape if collider else 'no'} colliders and orientation "
            f"{'on' if use_orientation else 'off'} (instantiated: arm_7dof's "
            "topology with or without a scene, arm_6dof with or without "
            "orientation, and reference_arm, the trees and the serial chains "
            "without either); any other combination is ROADMAP B1(d)"
        )
    return key[0], key[1], int(key[2])


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
        _I, _I, _VP,  # S, P, stream
    ],
    "ikpso_fused_solve_serial": [
        _I, _I, _I,  # replay, init mode, nodes
        _VP, _I, _VP, _I,  # meta, M, swarm, K
        *_UPDATE,
        _VP, _I,  # scratch, grid
        _VP, _VP,  # out gbest, out gval
        _I, _I, _VP,  # S, P, stream
    ],
    "ikpso_fused_solve_serial_blocks": [_I, _I, _I, _I, _I],  # replay, P, M, K, nodes
    "ikpso_fused_fitness": [
        _I, _I, _I, *_SCENE,  # topology id, collider id, orientation flag, scene
        _VP, _VP, _VP, _I, _VP, _I, _I, _VP,  # x, meta, swarm, K, out, S, P, stream
    ],
    "ikpso_fused_fitness_serial": [
        _I,  # nodes, then ikpso_fused_fitness's arguments after the scene
        _VP, _VP, _VP, _I, _VP, _I, _I, _VP,
    ],
    "ikpso_roofline_body": [
        _I, _VP, _VP, ctypes.c_longlong, _I, _I, _I, _VP,  # body, x, out, n, steps, grid
    ],
    "ikpso_philox_xor": [
        ctypes.c_uint, ctypes.c_uint, _VP, ctypes.c_longlong, _I, _VP,  # key, out, n, steps
    ],
}


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
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_contiguous(name: str, *tensors: torch.Tensor) -> None:
    """Validate pointers handed to a kernel: CUDA, contiguous, one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every tensor must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
