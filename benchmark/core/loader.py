"""Find a cell's files by name.

A cell ``<config>.<traffic>`` is ``workloads/<cell>.json``; it names its
configuration (``configs/<config>.json``), its generator
(``traffic/<generator>.py``) and its parameters. A metric ``<name>`` is
read by ``metrics/<name>.py``. ``BENCHMARK.json`` at the checkout's root
says which metrics a cell reports. Nothing here knows a cell, a
configuration or a metric by name: a new one is a new file.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


def _checked(name: str, what: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{what} name {name!r}: at most 64 letters, digits, '_', '.' "
                         "and '-', starting with a letter, a digit or '_'")
    return name


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as fh:
        return json.load(fh)


def manifest() -> dict:
    """``BENCHMARK.json``."""
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    """``workloads/<name>.json`` with its name."""
    return {"name": name, **_json(HERE / "workloads" / f"{_checked(name, 'cell')}.json")}


def config(name: str) -> dict:
    """``configs/<name>.json``."""
    return _json(HERE / "configs" / f"{_checked(name, 'configuration')}.json")


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` as a module (its file name may hold dots)."""
    path = HERE / kind / f"{_checked(name, kind)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, params: dict = None, recipe: dict = None):
    """``(workload, config, generator module)`` of cell ``name``; ``params``
    and ``recipe`` override its parameters and its recipe's (the CPU
    rehearsal's tiny sizes)."""
    wl = workload(name)
    if params:
        wl["params"] = {**wl["params"], **params}
    cfg = config(wl["config"])
    if recipe:
        cfg["recipes"][wl["recipe"]] = {**cfg["recipes"][wl["recipe"]], **recipe}
    return wl, cfg, module("traffic", wl["generator"])


def cell_metrics(cell: str, trace: bool) -> list:
    """The manifest's entries of the metrics ``cell`` reports: its
    end-to-end metrics untraced, its per-layer metrics traced. A metric
    without ``workloads`` is every cell's."""
    entries = manifest()["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
