"""Multi-rank solves on torch.distributed: meshes, sharded solves, collectives."""

import importlib

_EXPORTS = {
    "initialize": ("ikpso_tpu_torch.parallel.distributed", 'initialize'),
    "process_waypoint_slice": ("ikpso_tpu_torch.parallel.distributed", 'process_waypoint_slice'),
    "sweep_waypoints_multihost": ("ikpso_tpu_torch.parallel.distributed", 'sweep_waypoints_multihost'),
    "PARTICLE_AXIS": ("ikpso_tpu_torch.parallel.mesh", 'PARTICLE_AXIS'),
    "SWARM_AXIS": ("ikpso_tpu_torch.parallel.mesh", 'SWARM_AXIS'),
    "hybrid_mesh": ("ikpso_tpu_torch.parallel.mesh", 'hybrid_mesh'),
    "make_mesh": ("ikpso_tpu_torch.parallel.mesh", 'make_mesh'),
    "swarm_mesh": ("ikpso_tpu_torch.parallel.mesh", 'swarm_mesh'),
    "distributed_argmin": ("ikpso_tpu_torch.parallel.sharded", 'distributed_argmin'),
    "make_sharded_solver": ("ikpso_tpu_torch.parallel.sharded", 'make_sharded_solver'),
    "solve_sharded": ("ikpso_tpu_torch.parallel.sharded", 'solve_sharded'),
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
