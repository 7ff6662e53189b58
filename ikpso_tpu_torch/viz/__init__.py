"""Offline visualization of chains, targets, colliders, swarms."""

import importlib

_EXPORTS = {
    "chain_segments": ("ikpso_tpu_torch.viz.render", 'chain_segments'),
    "export_html": ("ikpso_tpu_torch.viz.render", 'export_html'),
    "plot_scene": ("ikpso_tpu_torch.viz.render", 'plot_scene'),
    "scene_dict": ("ikpso_tpu_torch.viz.render", 'scene_dict'),
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
