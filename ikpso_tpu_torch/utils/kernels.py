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
constants of the kernels (the TPU kernels unroll them at trace time).
:func:`topology_id` maps a ``ChainSpec`` to one of the instantiated
topologies and :func:`kernel_variant` a (topology, scene, orientation)
combination to its instantiation; both raise for anything not
instantiated.
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
# DualArm14, Humanoid45), which the launchers of kernels A, B and C all
# instantiate.
KERNEL_TOPOLOGIES = {
    (4, 0x2100, 0x8): 0,  # arm_7dof: serial 3 links, effector node 3
    (8, 0x44432100, 0xE0): 1,  # reference_arm: 4 elbows + 3 effector children
    (3, 0x100, 0x4): 2,  # arm_6dof: serial 2 links, effector node 2
    (7, 0x5402100, 0x48): 3,  # dual_arm_14dof: two 3-link arms, effectors 3, 6
    (16, 0xED0BA08725422100, 0x9248): 4,  # humanoid_45dof: 5 effectors
}
TOPOLOGY_NAMES = ("arm_7dof", "reference_arm", "arm_6dof", "dual_arm_14dof",
                  "humanoid_45dof")

# Kernel A's thread-block bound per topology id (its __launch_bounds__,
# KernelAThreads in csrc/fused_solve.cu): one thread per particle, so the
# most particles a swarm may have. The humanoid's 512 lets a thread hold
# 128 registers instead of 64.
MAX_PARTICLES = {4: 512}

# Collider variants (enum Collider in csrc/fk_fitness.cuh; 0 = none).
COLLIDERS = {"box": 1, "capsule": 2}

# The (topology id, collider id, orientation) combinations that the
# launchers of kernels A, B and C instantiate: the ones a path runs.
INSTANTIATED = {
    (0, 0, False), (0, 1, False), (0, 2, False),  # arm_7dof: headline, scenes
    (1, 0, False),  # reference_arm
    (2, 0, False), (2, 0, True),  # arm_6dof, position only and with orientation
    (3, 0, False), (4, 0, False),  # dual_arm_14dof, humanoid_45dof
}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def topology_code(spec):
    """``(num_nodes, packed parents, effector mask)`` of a ChainSpec:
    parent of node k in bits ``[4k, 4k+4)``, effector k at bit k."""
    n = spec.num_nodes
    if n > 16:
        raise NotImplementedError(
            f"{n}-node chains: the CUDA kernels pack parents in 4-bit fields "
            "(ROADMAP queue A item 8, the rest of the zoo)"
        )
    parents = 0
    for k in range(1, n):
        parents |= spec.parent[k] << (4 * k)
    mask = 0
    for e in spec.effector_idx:
        mask |= 1 << e
    return n, parents, mask


def topology_id(spec) -> int:
    """Id of the kernel instantiation for ``spec``'s topology."""
    code = topology_code(spec)
    if code not in KERNEL_TOPOLOGIES or list(spec.effector_idx) != sorted(
        spec.effector_idx
    ):
        raise NotImplementedError(
            f"no CUDA kernel instantiated for topology parent={spec.parent}, "
            f"effector_idx={spec.effector_idx} (instantiated: "
            f"{', '.join(TOPOLOGY_NAMES)}); more topologies are ROADMAP queue A "
            "item 8 (the rest of the zoo)"
        )
    return KERNEL_TOPOLOGIES[code]


def max_particles(spec) -> int:
    """The most particles kernel A takes per swarm for ``spec``'s topology
    (1024 for a topology without a kernel: its plain solve's bound)."""
    code = topology_code(spec) if spec.num_nodes <= 16 else None
    return MAX_PARTICLES.get(KERNEL_TOPOLOGIES.get(code), 1024)


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
            f"{'on' if use_orientation else 'off'} (instantiated: arm_7dof with "
            "or without a scene, arm_6dof with or without orientation, and "
            "reference_arm, dual_arm_14dof and humanoid_45dof without either); "
            "more combinations are ROADMAP queue A item 8 (the rest of the zoo)"
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


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    scene = [_I, _F, _F, _F, _F]  # obstacle count, collider sizes
    lib.ikpso_fk_fitness.argtypes = [
        _I, _I, _I, *scene,  # topology id, collider id, orientation flag, scene
        _VP, _VP, _VP, _I, _VP, ctypes.c_longlong, _I, _VP,
    ]
    lib.ikpso_fk_fitness.restype = _I
    lib.ikpso_fused_solve.argtypes = [
        _I, _I, _I, _I, _I,  # topology id, collider id, orientation, replay, init mode
        *scene,
        _VP, _I,  # meta, M
        _VP, _I,  # swarm, K
        _VP, _VP, _VP, _I,  # limits, seeds, inertia, iterations
        _F, _F, _F,  # c1, c2, init velocity scale
        _I, _I,  # randomized inertia flag, gbest interval
        _I, _F, _F,  # re-kick interval (0: off), scale, threshold (< 0: kick all)
        _VP, _I,  # uniforms, n_draws
        _VP, _VP,  # out gbest, out gval
        _I, _I, _VP,  # S, P, stream
    ]
    lib.ikpso_fused_solve.restype = _I
    lib.ikpso_fused_fitness.argtypes = [
        _I, _I, _I, *scene,  # topology id, collider id, orientation flag, scene
        _VP, _VP, _VP, _I, _VP, _I, _I, _VP,  # x, meta, swarm, K, out, S, P, stream
    ]
    lib.ikpso_fused_fitness.restype = _I
    lib.ikpso_roofline_body.argtypes = [
        _I, _VP, _VP, ctypes.c_longlong, _I, _I, _I, _VP,  # body, x, out, n, steps, grid
    ]
    lib.ikpso_roofline_body.restype = _I
    lib.ikpso_philox_xor.argtypes = [
        ctypes.c_uint, ctypes.c_uint, _VP, ctypes.c_longlong, _I, _VP,  # key, out, n, steps
    ]
    lib.ikpso_philox_xor.restype = _I
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
