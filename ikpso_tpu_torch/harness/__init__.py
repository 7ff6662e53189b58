"""Experiment harness: reference protocol, trajectory sweeps, CLI."""

import importlib

_EXPORTS = {
    "ExperimentResult": ("ikpso_tpu_torch.harness.experiment", 'ExperimentResult'),
    "frames_to_converge": ("ikpso_tpu_torch.harness.experiment", 'frames_to_converge'),
    "run_reference_experiment": ("ikpso_tpu_torch.harness.experiment", 'run_reference_experiment'),
    "SweepResult": ("ikpso_tpu_torch.harness.trajectory", 'SweepResult'),
    "solve_waypoints": ("ikpso_tpu_torch.harness.trajectory", 'solve_waypoints'),
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
