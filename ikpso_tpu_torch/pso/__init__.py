"""The PSO solver core."""

import importlib

_EXPORTS = {
    "PSOConfig": ("ikpso_tpu_torch.pso.config", 'PSOConfig'),
    "make_retry_solver": ("ikpso_tpu_torch.pso.restarts", 'make_retry_solver'),
    "solve_with_retries": ("ikpso_tpu_torch.pso.restarts", 'solve_with_retries'),
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
