"""ctypes bindings for the native host runtime (``native/ikpso_native.cpp``).

Port of ``ikpso_tpu/native/__init__.py``: :class:`NodeTree` (the
reference's scene-graph idiom and a float64 host FK oracle),
:func:`tree_from_chain_spec` (from the port's ``ChainSpec``),
:class:`NativeDiagnostics` (the four-stream writer of
``utils.diagnostics.DiagnosticsWriter``, in C++),
:func:`make_diagnostics_writer`, :func:`available` and :func:`load_error`.

The library is this package's own build of the unchanged
``native/ikpso_native.cpp``: g++ with ``native/Makefile``'s flags, into
``build/ikpso_tpu_torch/libikpso_native-<hash>.so`` (the hash of the
source and the flags, as ``utils/kernels.py`` names its libraries). It is
built at first use, never at import. Each build writes a temporary file
beside the target and renames it into place, so a concurrent loader (a
thread, or another process building the same hash) never opens a partial
file. The JAX package's ``native/libikpso_native.so`` is neither read nor
written.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "ikpso_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ikpso_tpu_torch"
# native/Makefile's CXXFLAGS, and its link step's -shared.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None
_lock = threading.Lock()


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return Path(build_dir) / f"libikpso_native-{digest.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """The library's path, compiling it first when it is missing. The
    compile writes a temporary file in ``build_dir`` and renames it onto
    the target, so the target is either absent or whole."""
    path = library_path(build_dir)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=path.stem + ".", suffix=".tmp", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_dbl_p = ctypes.POINTER(ctypes.c_double)
    c_i32_p = ctypes.POINTER(ctypes.c_int32)

    lib.ik_tree_create.restype = ctypes.c_void_p
    lib.ik_tree_create.argtypes = []
    lib.ik_tree_destroy.restype = None
    lib.ik_tree_destroy.argtypes = [ctypes.c_void_p]
    lib.ik_tree_add_node.restype = ctypes.c_int
    lib.ik_tree_add_node.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
        c_dbl_p, c_dbl_p, ctypes.c_double, ctypes.c_int,
    ]
    lib.ik_tree_num_nodes.restype = ctypes.c_int
    lib.ik_tree_num_nodes.argtypes = [ctypes.c_void_p]
    lib.ik_tree_num_effectors.restype = ctypes.c_int
    lib.ik_tree_num_effectors.argtypes = [ctypes.c_void_p]
    lib.ik_tree_flatten.restype = None
    lib.ik_tree_flatten.argtypes = [
        ctypes.c_void_p, c_i32_p, c_dbl_p, c_dbl_p, c_dbl_p, c_dbl_p, c_i32_p,
    ]
    lib.ik_tree_fk.restype = None
    lib.ik_tree_fk.argtypes = [ctypes.c_void_p, c_dbl_p, c_dbl_p, c_dbl_p, c_dbl_p]
    lib.ik_tree_fk_batch.restype = None
    lib.ik_tree_fk_batch.argtypes = [
        ctypes.c_void_p, c_dbl_p, c_dbl_p, ctypes.c_int64, c_dbl_p,
    ]
    lib.ik_tree_effector_error.restype = ctypes.c_double
    lib.ik_tree_effector_error.argtypes = [ctypes.c_void_p, c_dbl_p, c_dbl_p, c_dbl_p]

    lib.ik_diag_open.restype = ctypes.c_void_p
    lib.ik_diag_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ik_diag_log_frame.restype = None
    lib.ik_diag_log_frame.argtypes = [
        ctypes.c_void_p, c_dbl_p, ctypes.c_int64, c_dbl_p, ctypes.c_int64,
        ctypes.c_double,
    ]
    lib.ik_diag_log_convergence.restype = None
    lib.ik_diag_log_convergence.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ik_diag_flush.restype = None
    lib.ik_diag_flush.argtypes = [ctypes.c_void_p]
    lib.ik_diag_close.restype = None
    lib.ik_diag_close.argtypes = [ctypes.c_void_p]
    return lib


def load(build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build (if needed) and load the library from ``build_dir``."""
    return _configure(ctypes.CDLL(str(build(build_dir))))


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_error
    with _lock:
        if _lib is None and _lib_error is None:
            try:
                _lib = load()
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", b"") or b""
                _lib_error = f"native build or load failed: {e} {detail.decode()[-2000:]}"
        return _lib


def available() -> bool:
    """True if the native runtime is (or can be) loaded."""
    return _load() is not None


def load_error() -> Optional[str]:
    _load()
    return _lib_error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_lib_error}")
    return lib


def _dbl(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64(x, shape) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, np.float64).reshape(shape))


class NodeTree:
    """Native kinematic-tree builder + float64 host FK oracle.

    Create the origin, attach joints and effectors, then hand the flat
    form to the port's solver (the reference's ``new Node`` /
    ``AttachChild`` idiom, Main.cpp:76-117)::

        tree = NodeTree()
        j1 = tree.add_joint(parent=0, length=1.0, limits=(-3.14, 3.14))
        tree.add_effector(parent=j1, length=1.0, weight=1.0)
        spec = tree.to_chain_spec()
    """

    def __init__(self):
        self._lib = _require()
        self._ptr = ctypes.c_void_p(self._lib.ik_tree_create())
        # Node 0: the origin (no DOF, no length).
        zero = np.zeros(3, np.float64)
        if self._lib.ik_tree_add_node(self._ptr, -1, 0.0, _dbl(zero), _dbl(zero), 0.0, 0):
            raise RuntimeError("native runtime refused the origin node")

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.ik_tree_destroy(ptr)
            self._ptr = None

    def _add(self, parent, length, min_rot, max_rot, weight, is_eff) -> int:
        lo = np.ascontiguousarray(np.broadcast_to(min_rot, (3,)), np.float64)
        hi = np.ascontiguousarray(np.broadcast_to(max_rot, (3,)), np.float64)
        idx = self._lib.ik_tree_add_node(
            self._ptr, int(parent), float(length), _dbl(lo), _dbl(hi),
            float(weight), int(is_eff),
        )
        if idx < 0:
            raise ValueError(f"invalid parent {parent}: must reference an existing node")
        return idx

    def add_joint(self, parent: int, length: float, limits=(-2 * np.pi, 2 * np.pi)) -> int:
        lo, hi = limits
        return self._add(parent, length, lo, hi, 0.0, False)

    def add_effector(self, parent: int, length: float, weight: float = 1.0,
                     limits=(-2 * np.pi, 2 * np.pi)) -> int:
        lo, hi = limits
        return self._add(parent, length, lo, hi, weight, True)

    @property
    def num_nodes(self) -> int:
        return self._lib.ik_tree_num_nodes(self._ptr)

    @property
    def num_effectors(self) -> int:
        return self._lib.ik_tree_num_effectors(self._ptr)

    def flatten(self):
        """Flat arrays (parent, length, min_rot, max_rot, eff_weight, eff_idx)."""
        n = self.num_nodes
        e = self.num_effectors
        parent = np.empty(n, np.int32)
        length = np.empty(n, np.float64)
        min_rot = np.empty((n, 3), np.float64)
        max_rot = np.empty((n, 3), np.float64)
        eff_w = np.empty(n, np.float64)
        eff_idx = np.empty(max(e, 1), np.int32)
        self._lib.ik_tree_flatten(self._ptr, _i32(parent), _dbl(length), _dbl(min_rot),
                                  _dbl(max_rot), _dbl(eff_w), _i32(eff_idx))
        return parent, length, min_rot, max_rot, eff_w, eff_idx[:e]

    def to_chain_spec(self, device="cpu"):
        """The port's ``ChainSpec`` of this tree."""
        from ikpso_tpu_torch.models.chain import make_chain_spec

        parent, length, min_rot, max_rot, eff_w, eff_idx = self.flatten()
        return make_chain_spec(parent=tuple(int(p) for p in parent), length=length,
                               min_rotation=min_rot, max_rotation=max_rot,
                               effector_idx=tuple(int(i) for i in eff_idx),
                               effector_weight=eff_w, device=device)

    def fk(self, pose, origin=(0.0, 0.0, 0.0), return_rotations: bool = False):
        """Double-precision host FK: ``(N, 3)`` node positions (and
        ``(N, 3, 3)`` rotations)."""
        n = self.num_nodes
        pose = _f64(pose, (n, 3))
        origin = _f64(origin, (3,))
        out_pos = np.empty((n, 3), np.float64)
        out_rot = np.empty((n, 3, 3), np.float64) if return_rotations else None
        self._lib.ik_tree_fk(self._ptr, _dbl(pose), _dbl(origin), _dbl(out_pos),
                             _dbl(out_rot) if return_rotations else None)
        return (out_pos, out_rot) if return_rotations else out_pos

    def fk_batch(self, poses, origins) -> np.ndarray:
        n = self.num_nodes
        poses = _f64(poses, (-1, n, 3))
        b = poses.shape[0]
        origins = np.ascontiguousarray(np.broadcast_to(_f64(origins, (-1, 3)), (b, 3)))
        out = np.empty((b, n, 3), np.float64)
        self._lib.ik_tree_fk_batch(self._ptr, _dbl(poses), _dbl(origins), b, _dbl(out))
        return out

    def effector_error(self, pose, origin, targets) -> float:
        """True Euclidean summed effector error (reference checkDistance)."""
        n = self.num_nodes
        pose = _f64(pose, (n, 3))
        origin = _f64(origin, (3,))
        targets = _f64(targets, (-1, 3))
        if targets.shape[0] != self.num_effectors:
            raise ValueError(f"expected {self.num_effectors} targets, got {targets.shape[0]}")
        return float(self._lib.ik_tree_effector_error(self._ptr, _dbl(pose), _dbl(origin),
                                                      _dbl(targets)))


def tree_from_chain_spec(spec) -> NodeTree:
    """Rebuild a native ``NodeTree`` from the port's ``ChainSpec`` (for
    oracle checks)."""
    tree = NodeTree.__new__(NodeTree)
    lib = _require()
    tree._lib = lib
    tree._ptr = ctypes.c_void_p(lib.ik_tree_create())
    length = _f64(spec.length, (-1,))
    min_rot = _f64(spec.min_rotation, (-1, 3))
    max_rot = _f64(spec.max_rotation, (-1, 3))
    eff_w = _f64(spec.effector_weight, (-1,))
    eff = set(spec.effector_idx)
    for k, parent in enumerate(spec.parent):
        r = lib.ik_tree_add_node(
            tree._ptr, int(parent), float(length[k]),
            _dbl(np.ascontiguousarray(min_rot[k])), _dbl(np.ascontiguousarray(max_rot[k])),
            float(eff_w[k]), int(k in eff),
        )
        if r != k:
            raise ValueError(f"bad topology at node {k} (parent {parent})")
    return tree


class NativeDiagnostics:
    """Native 4-stream diagnostics writer (the schema of
    ``utils.diagnostics.DiagnosticsWriter``; reference Main.cpp:147-216)."""

    def __init__(self, directory: str, prefix: str = "IK-diagnostics"):
        lib = _require()
        os.makedirs(directory, exist_ok=True)
        self._lib = lib
        self._ptr = ctypes.c_void_p(lib.ik_diag_open(directory.encode(), prefix.encode()))
        if not self._ptr:
            raise OSError(f"could not open diagnostics streams in {directory}")

    def log_frame(self, degrees, positions, distance: float) -> None:
        deg = _f64(degrees, (-1,))
        pos = _f64(positions, (-1,))
        self._lib.ik_diag_log_frame(self._ptr, _dbl(deg), deg.size, _dbl(pos), pos.size,
                                    float(distance))

    def log_convergence(self, frames: int) -> None:
        self._lib.ik_diag_log_convergence(self._ptr, int(frames))

    def flush(self) -> None:
        self._lib.ik_diag_flush(self._ptr)

    def close(self) -> None:
        if self._ptr:
            self._lib.ik_diag_close(self._ptr)
            self._ptr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_ptr", None):
            self.close()


def make_diagnostics_writer(directory: str, prefix: str = "IK-diagnostics"):
    """Native writer when available, the Python one otherwise."""
    if available():
        return NativeDiagnostics(directory, prefix)
    from ikpso_tpu_torch.utils.diagnostics import DiagnosticsWriter

    return DiagnosticsWriter(directory, prefix)
