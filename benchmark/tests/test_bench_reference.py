"""The plain reference: FK against known poses and the port's FK, the
judge's numbers on made-up answers, the comparison."""

import math

import numpy as np
import pytest
import torch

from benchmark.core import loader
from benchmark.reference import check, fk


def arm7(dtype=torch.float64):
    return fk.Model(loader.config("arm7")["model"], "cpu", dtype)


def test_fk_known_poses():
    m = arm7()
    zero = torch.zeros(1, 9, dtype=torch.float64)
    np.testing.assert_allclose(fk.positions(m, zero)[0].numpy(),
                               [[0, 0, 0], [1, 0, 0], [2, 0, 0], [2.5, 0, 0]], atol=1e-15)
    quarter = zero.clone()
    quarter[0, 2] = math.pi / 2  # node 1 about z: the whole arm along +y
    np.testing.assert_allclose(fk.positions(m, quarter)[0, 3].numpy(), [0, 2.5, 0],
                               atol=1e-15)
    bent = zero.clone()
    bent[0, 4] = math.pi / 2  # node 2 about y: links 2-3 along -z
    np.testing.assert_allclose(fk.positions(m, bent)[0, 3].numpy(), [1, 0, -1.5],
                               atol=1e-15)
    t = torch.tensor([[[2.5, 0.0, 1.0]]], dtype=torch.float64)
    assert float(fk.effector_error(m, zero, t)) == pytest.approx(1.0)


def test_reference_arm_canonical_pose():
    cfg = loader.config("reference_arm")
    m = fk.Model(cfg["model"], "cpu")
    p = fk.positions(m, m.anchor()[None])[0]
    # Node k's positions follow from the bends alone: 1.57 rad about y per elbow.
    assert p.shape == (8, 3)
    np.testing.assert_allclose(p[1].numpy(), [math.cos(1.57), 0, -math.sin(1.57)],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["arm7", "reference_arm"])
def test_fk_against_the_port(name):
    from benchmark.core import recipe
    from ikpso_tpu_torch.ops import fk as port_fk

    cfg = loader.config(name)
    spec, problem = recipe.model(cfg, "cpu")
    m = fk.Model(cfg["model"], "cpu")
    gen = torch.Generator().manual_seed(3)
    a = fk.uniform_angles(m, gen, 256)
    pose = port_fk.angles_to_pose(spec, problem.pose[0].expand(256, 3), a)
    want = port_fk.fk_points(spec, pose, problem.origin).double()
    np.testing.assert_allclose(fk.positions(m, a.double()).numpy(), want.numpy(), atol=2e-5)
    t = fk.reachable_targets(fk.Model(cfg["model"], "cpu", torch.float32), gen, 64)
    assert t.shape == (64, len(cfg["model"]["effector_idx"]), 3) and t.dtype == torch.float32


def test_judge_reads_gap_misses_failed_missing():
    m = arm7()
    judge = check.Judge(m, "cpu")
    a = torch.zeros(4, 9)
    targets = torch.tensor([[[2.5, 0, 0]], [[2.5, 0, 0.01]], [[2.5, 0, 0]], [[2.5, 0, 0]]])
    reported = torch.tensor([0.0, 0.01, 0.0, 0.0])
    a[2, 0] = float("nan")
    a[3, 1] = 3.5  # past pi
    judged = judge.block(a, reported, targets, due=5)
    n = judge.numbers()
    assert n["failed"] == 2 and n["missing"] == 1
    assert n["err_gap_m"] < 1e-8
    assert n["miss_share"] == pytest.approx(1 / 5)
    assert math.isnan(float(judged[2])) and float(judged[1]) == pytest.approx(0.01)
    judge.block(None, None, targets, due=3)
    assert judge.numbers()["missing"] == 4
    judge.block(torch.zeros(2, 9), torch.tensor([0.5, 0.0]), targets, due=2)
    assert judge.numbers()["err_gap_m"] == pytest.approx(0.5)


def test_locked_axes_at_their_bound_pass():
    m = arm7()
    judge = check.Judge(m, "cpu")
    a = torch.zeros(1, 9)
    a[0, 0] = float(np.float32(math.pi))  # hi of a free axis, as float32
    judge.block(a, torch.tensor([0.0]), torch.zeros(1, 1, 3), due=1)
    assert judge.numbers()["failed"] == 0


def test_compare():
    ok, rows = check.compare({"a": 1.0, "b": 0}, {"a": 2.0, "b": 0})
    assert ok and rows == {"a": {"value": 1.0, "limit": 2.0}, "b": {"value": 0, "limit": 0}}
    assert not check.compare({"a": 3.0}, {"a": 2.0})[0]
    assert not check.compare({"a": None}, {"a": 2.0})[0]
    assert not check.compare({"a": float("nan")}, {"a": 2.0})[0]
    assert not check.compare({}, {"a": 2.0})[0]
    assert list(check.lines(rows)) == ["check a 1.0 limit 2.0", "check b 0 limit 0"]


def test_plain_pso_in_float32_solves():
    from benchmark.reference import pso

    cfg = loader.config("arm7")
    m = fk.Model(cfg["model"], "cpu", torch.float32)
    gen = torch.Generator().manual_seed(11)
    t = fk.reachable_targets(m, gen, 16)
    angles, err = pso.solve(m, cfg["recipes"]["scan"], t, m.anchor()[None].expand(16, 9),
                            gen, dtype=torch.float32, chunk=8)
    judged = fk.effector_error(arm7(), angles.double(), t)
    assert float((err.double() - judged).abs().max()) < 1e-5
    # The scan recipe misses 1 mm on ~10% of targets (the port's scan row: 0.8994).
    assert float((judged >= check.MISS_M).double().mean()) <= 0.25
