"""A CPU rehearsal of each traffic loop at a tiny size, on the kernels'
plain twins: paths, shapes, the window's accounting and the result line.
The entry itself refuses to run without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.core import loader

TINY = {
    "arm7.scan": ({"swarms": 16, "pool_batches_per_s": 2}, {"particles": 64, "iterations": 6}),
    "reference_arm.frames": ({"trials": 4}, {"particles": 128, "max_frames": 3}),
}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("cell", list(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run(cell, trace, one_thread):
    params, recipe = TINY[cell]
    out = run.run(cell, 2**33 + 5, 0.5, trace, "cpu", params=params, recipe=recipe)
    keys = list(out)
    assert keys == (KEYS[:5] + ["breakdown"] + KEYS[5:] if trace else KEYS)
    json.loads(json.dumps(out, allow_nan=False))
    wl = loader.workload(cell)
    assert list(out["check"]) == list(wl["check"]["limits"])
    assert out["device"]["platform"] == "cpu" and out["device"]["count"] == 1
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["device"]["window_s"] > 0
        # A CPU trace holds no device work: every device metric stays out.
        assert out["metrics"] == {}
    else:
        e2e = {m["name"] for m in loader.cell_metrics(cell, False)}
        assert set(out["metrics"]) == e2e
        for m in out["metrics"].values():
            assert m["value"] > 0
    swarms = params.get("swarms", params.get("trials"))
    assert out["attempted"] > 0 and out["attempted"] % swarms == 0
    assert out["failed"] == 0
    assert out["check"]["err_gap_m"]["value"] < 1e-5
    assert out["check"]["missing"]["value"] == 0


def test_window_accounting(one_thread):
    from benchmark.core.trace import Tracer

    params, recipe = TINY["arm7.scan"]
    wl = loader.workload("arm7.scan")
    wl["params"].update(params)
    cfg = loader.config("arm7")
    cfg["recipes"]["scan"].update(recipe)
    cell = loader.module("traffic", "closed_batch").Cell(cfg, wl, 7, 0.3, "cpu", Tracer(False))
    cell.setup()
    w = cell.run_window()
    assert w.window_s >= 0.3 and w.calls == len(cell.outputs) >= 1
    assert w.solves == 16 * w.calls == cell.attempted()
    assert sum(w.call_s) <= w.window_s
    # The pool covers ceil(0.3 * 2) batches; later ones are made on demand, alike.
    assert len(cell.pool) == 1
    again = cell.targets(5)
    assert (again == cell.targets(5)).all() and not (again == cell.pool[0]).all()


def test_frames_batches_and_convergence(one_thread):
    from benchmark.core.trace import Tracer

    wl = loader.workload("reference_arm.frames")
    wl["params"].update(trials=4)
    cfg = loader.config("reference_arm")
    cfg["recipes"]["iter3"].update(particles=128, max_frames=2)
    cell = loader.module("traffic", "frame_loop").Cell(cfg, wl, 7, 0.0, "cpu", Tracer(False))
    cell.setup()
    for i in range(5):
        cell.step(i)
    assert cell.finished == 2 and cell.batch == 2 and cell.frame == 2
    n = cell.check()
    assert n["batches_finished"] == 2
    assert 1.0 <= n["frames_mean"] <= 3.0
    assert n["missing"] == 0 and n["failed"] == 0


def test_entry_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(loader.HERE / "run.py"), "--workload",
                           "arm7.scan", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=loader.ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_entry_refuses_a_cell_outside_the_manifest():
    proc = subprocess.run([sys.executable, str(loader.HERE / "run.py"), "--workload",
                           "arm7.headline", "--seed", "1", "--seconds", "1"],
                          cwd=loader.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "not a cell of BENCHMARK.json" in proc.stderr


def test_frames_judged_in_blocks_read_as_one_at_a_time(one_thread):
    from benchmark.core.trace import Tracer

    wl = loader.workload("reference_arm.frames")
    wl["params"].update(trials=4)
    cfg = loader.config("reference_arm")
    cfg["recipes"]["iter3"].update(particles=128, max_frames=3)
    mod = loader.module("traffic", "frame_loop")
    cell = mod.Cell(cfg, wl, 11, 0.0, "cpu", Tracer(False))
    cell.setup()
    for i in range(8):
        cell.step(i)
    # A frame with half its answers sits between whole ones.
    b, angles, err = cell.outputs[3]
    cell.outputs[3] = (b, angles[:2], err[:2])
    read = {}
    for k in (1, 3, 256):
        mod.JUDGE_FRAMES = k
        read[k] = cell.check()
    assert read[1] == read[3] == read[256]
    assert read[1]["missing"] == 2
