"""Each fault a cell can have makes ``correct`` false: the run skips the
look for a card and drives the rest, with the timed path broken
underneath. Faults: a solve that returns its state unchanged (the warm
start), half of the batch left out, and an answer altered where it is
produced. The control (the plain reference in bfloat16 in the
program's place) fails too, and the same reference in float32 passes
the exact numbers."""

import dataclasses

import pytest
import torch

from benchmark import control, run
from benchmark.core import recipe

SCAN = ({"swarms": 16, "pool_batches_per_s": 2}, None)
FRAMES = ({"trials": 4}, {"particles": 256})


def unchanged(solve):
    """Returns the warm start, its error honestly reported."""
    from ikpso_tpu_torch.ops.fitness import true_effector_error
    from ikpso_tpu_torch.ops.fk import pose_to_angles

    def broken(problem, generator):
        res = solve(problem, generator)
        return dataclasses.replace(res, angles=pose_to_angles(None, problem.pose).clone(),
                                   pose=problem.pose.clone(),
                                   effector_error=true_effector_error(spec_of[0], problem.pose,
                                                                      problem))
    return broken


def half(solve):
    def broken(problem, generator):
        res = solve(problem, generator)
        n = res.angles.shape[0] // 2
        return dataclasses.replace(res, angles=res.angles[:n], pose=res.pose[:n],
                                   effector_error=res.effector_error[:n],
                                   fitness=res.fitness[:n])
    return broken


def altered(solve):
    def broken(problem, generator):
        res = solve(problem, generator)
        angles = res.angles.clone()
        angles[-1, 0] += 0.05
        return dataclasses.replace(res, angles=angles)
    return broken


spec_of = [None]
FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
FAILS = {"unchanged": {"miss_share", "frames_mean"}, "half": {"missing"},
         "altered": {"err_gap_m"}}


def failing(out):
    return {k for k, r in out["check"].items()
            if r["value"] is None or r["value"] > r["limit"]}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_batch_cell_faults(fault, monkeypatch, one_thread):
    real = recipe.solver

    def broken_solver(spec, r, device, **kw):
        spec_of[0] = spec
        return FAULTS[fault](real(spec, r, device, **kw))

    monkeypatch.setattr(recipe, "solver", broken_solver)
    params, rec = SCAN
    out = run.run("arm7.scan", 99, 0.2, False, "cpu", params=params, recipe=rec)
    assert out["correct"] is False
    assert failing(out) & FAILS[fault], out["check"]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_frame_cell_faults(fault, monkeypatch, one_thread):
    from ikpso_tpu_torch.harness import trajectory

    real = trajectory.frame_solver

    def broken_solver(spec, **kw):
        spec_of[0] = spec
        return FAULTS[fault](real(spec, **kw))

    monkeypatch.setattr(trajectory, "frame_solver", broken_solver)
    # At 128 particles a frame takes some ms here: a batch of 300 frames
    # finishes inside the window.
    out = run.run("reference_arm.frames", 99, 4.0, False, "cpu", params={"trials": 4},
                  recipe={"particles": 128})
    assert out["correct"] is False
    assert failing(out) & FAILS[fault], out["check"]


@pytest.mark.parametrize("cell, calls", [("arm7.scan", 2), ("reference_arm.frames", 4)])
def test_control_fails_and_float32_reference_holds_the_exact_numbers(cell, calls, one_thread):
    params, rec = {"arm7.scan": SCAN, "reference_arm.frames": FRAMES}[cell]
    low = control.run_control(cell, 5, calls, "cpu", torch.bfloat16, seconds=1.0,
                              params=params, recipe=rec)
    assert low["correct"] is False
    assert low["check"]["err_gap_m"]["value"] > low["check"]["err_gap_m"]["limit"]
    same = control.run_control(cell, 5, calls, "cpu", torch.float32, seconds=1.0,
                               params=params, recipe=rec)
    assert same["check"]["err_gap_m"]["value"] <= same["check"]["err_gap_m"]["limit"]
    assert same["numbers"]["failed"] == 0 and same["numbers"]["missing"] == 0
