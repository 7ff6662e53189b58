"""Compute ops: rotations, FK, fitness, colliders (SAT and GJK), kernels B and C.

The names of ``ikpso_tpu.ops``. The submodules ``fk`` and ``fitness``
keep their module names here (``from ikpso_tpu_torch.ops import fk as
fk_ops``); import the functions from the submodules. JAX's Pallas names
map onto kernel C's module: ``pallas_fitness`` is
``ikpso_tpu_torch.ops.fitness_kernel`` and ``make_pallas_fitness`` its
``make_kernel_fitness``.
"""

import importlib

_EXPORTS = {
    "collision": ("ikpso_tpu_torch.ops.collision", None),
    "fitness": ("ikpso_tpu_torch.ops.fitness", None),
    "fk": ("ikpso_tpu_torch.ops.fk", None),
    "gjk": ("ikpso_tpu_torch.ops.gjk", None),
    "rotations": ("ikpso_tpu_torch.ops.rotations", None),
    "pallas_fitness": ("ikpso_tpu_torch.ops.fitness_kernel", None),
    "chain_collides_gjk": ("ikpso_tpu_torch.ops.gjk", 'chain_collides_gjk'),
    "gjk_box_box": ("ikpso_tpu_torch.ops.gjk", 'gjk_box_box'),
    "gjk_intersect": ("ikpso_tpu_torch.ops.gjk", 'gjk_intersect'),
    "chain_collides": ("ikpso_tpu_torch.ops.collision", 'chain_collides'),
    "obb_obb_intersect": ("ikpso_tpu_torch.ops.collision", 'obb_obb_intersect'),
    "COLLISION_PENALTY": ("ikpso_tpu_torch.ops.fitness", 'COLLISION_PENALTY'),
    "FitnessConfig": ("ikpso_tpu_torch.ops.fitness", 'FitnessConfig'),
    "true_effector_error": ("ikpso_tpu_torch.ops.fitness", 'true_effector_error'),
    "angles_to_pose": ("ikpso_tpu_torch.ops.fk", 'angles_to_pose'),
    "effector_positions": ("ikpso_tpu_torch.ops.fk", 'effector_positions'),
    "fk_points": ("ikpso_tpu_torch.ops.fk", 'fk_points'),
    "fk_serial_scan": ("ikpso_tpu_torch.ops.fk", 'fk_serial_scan'),
    "pose_to_angles": ("ikpso_tpu_torch.ops.fk", 'pose_to_angles'),
    "fused_fitness": ("ikpso_tpu_torch.ops.fitness_kernel", 'fused_fitness'),
    "make_pallas_fitness": ("ikpso_tpu_torch.ops.fitness_kernel", 'make_kernel_fitness'),
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
