"""PyTorch + CUDA port of ``ikpso_tpu`` (particle-swarm inverse kinematics).

The JAX package ``ikpso_tpu`` is the reference; this package holds the
same package (batched Euler-XYZ tree FK, the fitness with its box and
GJK colliders, the scan solver and the fused PSO megakernel, the
Levenberg-Marquardt polish, retries, sharded and multi-process solves on
``torch.distributed``, the harness, the benchmark entry ``bench`` and the
offline viewer) in plain
PyTorch plus hand-written CUDA kernels for Hopper (``csrc/``). It imports
neither ``jax`` nor ``ikpso_tpu``. The public names of ``ikpso_tpu`` are
exported here too, imported on first use.

Device setup: float32 matrix products must run in full float32. TF32
keeps ~10 mantissa bits, which puts millimetre-scale error into the FK
compose — the GPU twin of the TPU MXU-precision trap the reference
guards with ``precision="highest"`` (``ikpso_tpu/ops/fk.py``). Both
flags are PyTorch's defaults for matmul but not for cuDNN; they are set
here explicitly so no caller's global setting can change the FK.
"""

import importlib

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

_EXPORTS = {
    "ChainSpec": ("ikpso_tpu_torch.models.chain", 'ChainSpec'),
    "IKProblem": ("ikpso_tpu_torch.models.chain", 'IKProblem'),
    "Obstacles": ("ikpso_tpu_torch.models.chain", 'Obstacles'),
    "make_chain_spec": ("ikpso_tpu_torch.models.chain", 'make_chain_spec'),
    "planar_3dof": ("ikpso_tpu_torch.models.library", 'planar_3dof'),
    "arm_6dof": ("ikpso_tpu_torch.models.library", 'arm_6dof'),
    "arm_7dof": ("ikpso_tpu_torch.models.library", 'arm_7dof'),
    "batched_problem": ("ikpso_tpu_torch.models.library", 'batched_problem'),
    "dual_arm_14dof": ("ikpso_tpu_torch.models.library", 'dual_arm_14dof'),
    "reference_arm": ("ikpso_tpu_torch.models.library", 'reference_arm'),
    "serial_chain": ("ikpso_tpu_torch.models.library", 'serial_chain'),
    "fk": ("ikpso_tpu_torch.ops.fk", 'fk'),
    "fk_points": ("ikpso_tpu_torch.ops.fk", 'fk_points'),
    "FitnessConfig": ("ikpso_tpu_torch.ops.fitness", 'FitnessConfig'),
    "fitness": ("ikpso_tpu_torch.ops.fitness", 'fitness'),
    "true_effector_error": ("ikpso_tpu_torch.ops.fitness", 'true_effector_error'),
    "PSOConfig": ("ikpso_tpu_torch.pso.config", 'PSOConfig'),
    "SolveResult": ("ikpso_tpu_torch.pso.solver", 'SolveResult'),
    "make_solver": ("ikpso_tpu_torch.pso.solver", 'make_solver'),
    "solve": ("ikpso_tpu_torch.pso.solver", 'solve'),
    "solve_single": ("ikpso_tpu_torch.pso.solver", 'solve_single'),
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    # Imported on first use: importing the package loads none of its
    # submodules (the kernel loader, torch.distributed).
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = importlib.import_module(module)
    return value if attr is None else getattr(value, attr)
