"""Build and load the hand-written CUDA kernels (``ikpso_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one
plain-C shared library and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds. The library is built at first use into
``build/ikpso_tpu_torch/`` under the repository root and rebuilt when
the hash of the sources (or of the flags) changes. Nothing is
downloaded and nothing outside ``csrc/`` is compiled.

Every C entry point returns ``cudaGetLastError()``; :func:`check`
raises when it is non-zero. Kernels launch on PyTorch's current stream.

Topology is a compile-time constant of the kernels (the TPU kernels
unroll it at trace time). :func:`topology_id` maps a ``ChainSpec`` to
one of the instantiated topologies and raises for any other.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # No mul+add contraction: the kernels then round op by op exactly
    # like the plain torch versions, so kernel and plain agree to the
    # last bit on the same inputs and a PSO trajectory cannot fork on a
    # 1-ulp argmin difference (see PERF.md, kernel A).
    "-fmad=false",
    "-Xptxas", "-v",
)
SOURCES = ("fused_solve.cu", "fk_fitness.cu")

# (num_nodes, packed parents, effector bit mask) -> id; must match the
# instantiations in csrc/fk_fitness.cuh (Arm7Dof, ReferenceArm).
KERNEL_TOPOLOGIES = {
    (4, 0x2100, 0x8): 0,  # arm_7dof: serial 3 links, effector node 3
    (8, 0x44432100, 0xE0): 1,  # reference_arm: 4 elbows + 3 effector children
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
            f"effector_idx={spec.effector_idx} (instantiated: arm_7dof, "
            "reference_arm); more topologies are ROADMAP queue A item 8 "
            "(the rest of the zoo)"
        )
    return KERNEL_TOPOLOGIES[code]


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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

    Writes the compiler's register/spill report beside the library
    (``<lib>.log``). Returns the library path.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    lib.with_suffix(".log").write_text(
        log + f"\nbuild_seconds={time.perf_counter() - t0:.3f}\n"
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    lib.ikpso_fk_fitness.argtypes = [
        _I, _VP, _VP, _VP, _I, _VP, ctypes.c_longlong, _I, _VP,
    ]
    lib.ikpso_fk_fitness.restype = _I
    lib.ikpso_fused_solve.argtypes = [
        _I, _I,  # topology id, replay flag
        _VP, _I,  # meta, M
        _VP, _I,  # swarm, K
        _VP, _VP, _VP, _I,  # limits, seeds, inertia, iterations
        _F, _F, _F,  # c1, c2, init velocity scale
        _VP, _I,  # uniforms, n_draws
        _VP, _VP,  # out gbest, out gval
        _I, _I, _VP,  # S, P, stream
    ]
    lib.ikpso_fused_solve.restype = _I
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
