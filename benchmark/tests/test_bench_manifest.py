"""BENCHMARK.json against the rules its fields keep (names, units, keys, limits), and every cell's
files found by name."""

import json
import re

import pytest

from benchmark.core import loader

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
M = loader.manifest()


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert (loader.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = ([c["name"] for c in M["configs"]] + [w["name"] for w in M["workloads"]]
             + [m["name"] for m in M["end_to_end"] + M["per_layer"]])
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in M[group]}) == len(M[group])
    metrics = M["end_to_end"] + M["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert loader.config(c["name"])["name"] == c["name"]
        assert loader.config(c["name"])["reduced"] == c["reduced"] == []
        assert loader.config(c["name"])["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in M["workloads"])


def test_cells_found_by_name():
    configs = {c["name"] for c in M["configs"]}
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line_ok(w["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        wl = loader.workload(w["name"])
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        cfg = loader.config(wl["config"])
        assert wl["recipe"] in cfg["recipes"]
        gen = loader.module("traffic", wl["generator"])
        assert hasattr(gen, "Cell")
        assert set(wl["check"]["limits"]) >= {"err_gap_m", "failed", "missing"}
    assert [w["name"] for w in M["workloads"]] == ["arm7.scan", "reference_arm.frames"]


def test_metrics():
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert hasattr(loader.module("metrics", m["name"]), "read")
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert line_ok(m["layer"]) and m["moves"] in e2e
        assert hasattr(loader.module("metrics", m["name"]), "read")
    cells = [w["name"] for w in M["workloads"]]
    for cell in cells:
        reported = {m["name"] for m in loader.cell_metrics(cell, False)}
        assert "setup_s" in reported and len(reported) >= 2
        layers = loader.cell_metrics(cell, True)
        assert layers
        for m in layers:
            assert m["moves"] in reported
    for m in M["end_to_end"] + M["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)


def test_files_under_paths_are_named_from_name_characters():
    for path in (loader.HERE).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(loader.ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
        for part in rel.split("/"):
            assert NAME.match(part), rel


def test_every_cell_file_names_a_config_recipe_and_generator():
    for path in sorted((loader.HERE / "workloads").glob("*.json")):
        wl = loader.workload(path.stem)
        cfg = loader.config(wl["config"])
        assert path.stem == f"{wl['config']}.{wl['traffic']}"
        assert wl["recipe"] in cfg["recipes"]
        assert hasattr(loader.module("traffic", wl["generator"]), "Cell")


@pytest.mark.parametrize("name", ["../x", "a/b", "", "a b"])
def test_loader_refuses_names(name):
    with pytest.raises(ValueError):
        loader.workload(name)


def test_json_files_parse():
    for path in (loader.HERE).rglob("*.json"):
        json.loads(path.read_text())
