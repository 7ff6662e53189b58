"""Kinematic models: ChainSpec/IKProblem and the prebuilt library."""

import importlib

_EXPORTS = {
    "ChainSpec": ("ikpso_tpu_torch.models.chain", 'ChainSpec'),
    "IKProblem": ("ikpso_tpu_torch.models.chain", 'IKProblem'),
    "Obstacles": ("ikpso_tpu_torch.models.chain", 'Obstacles'),
    "make_chain_spec": ("ikpso_tpu_torch.models.chain", 'make_chain_spec'),
    "stack_problems": ("ikpso_tpu_torch.models.chain", 'stack_problems'),
    "arm_6dof": ("ikpso_tpu_torch.models.library", 'arm_6dof'),
    "arm_7dof": ("ikpso_tpu_torch.models.library", 'arm_7dof'),
    "batched_problem": ("ikpso_tpu_torch.models.library", 'batched_problem'),
    "dual_arm_14dof": ("ikpso_tpu_torch.models.library", 'dual_arm_14dof'),
    "planar_3dof": ("ikpso_tpu_torch.models.library", 'planar_3dof'),
    "reference_arm": ("ikpso_tpu_torch.models.library", 'reference_arm'),
    "reference_reset_targets": ("ikpso_tpu_torch.models.library", 'reference_reset_targets'),
    "serial_chain": ("ikpso_tpu_torch.models.library", 'serial_chain'),
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
