"""The port's span recorder (``ikpso_tpu_torch/utils/profiling.py``:
``span``, ``spans``, ``clear_spans``) on the CPU: it records only while a
``torch.profiler`` profile is active, nests spans under their parent and
root call, keeps a bounded buffer, closes a span an exception leaves, and
the scan solver's route through ``harness/trajectory.py::build_solver``
records ``ikpso.solve`` > ``ikpso.solve.pack``, ``ikpso.solve.init``."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ikpso_tpu_torch.utils import profiling
from ikpso_tpu_torch.utils.profiling import clear_spans, span, spans


@pytest.fixture(autouse=True)
def empty_buffer():
    clear_spans()
    yield
    clear_spans()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_nothing_is_recorded_without_a_profiler():
    with span("a"):
        with span("b"):
            pass
    assert spans() == []
    # Off, a span is one shared no-op.
    assert span("a") is span("b")


def test_spans_nest_under_their_parent_and_share_the_root_call():
    with cpu_profile():
        with span("root"):
            with span("child"):
                with span("grandchild"):
                    pass
            with span("sibling"):
                pass
        with span("next"):
            pass
    with span("after"):
        pass
    got = {s.name: s for s in spans()}
    assert set(got) == {"root", "child", "grandchild", "sibling", "next"}
    root = got["root"]
    assert root.parent is None and root.call == root.id
    assert got["child"].parent == root.id and got["sibling"].parent == root.id
    assert got["grandchild"].parent == got["child"].id
    assert {got[n].call for n in ("child", "grandchild", "sibling")} == {root.id}
    assert got["next"].parent is None and got["next"].call == got["next"].id != root.id
    for s in got.values():
        assert s.start <= s.end
    assert root.start <= got["child"].start <= got["grandchild"].end <= got["child"].end
    assert got["child"].end <= got["sibling"].start <= got["sibling"].end <= root.end
    # Oldest first: the innermost closes first.
    assert [s.name for s in spans()] == ["grandchild", "child", "sibling", "root", "next"]
    clear_spans()
    assert spans() == []


def test_the_buffer_keeps_the_newest_records():
    extra = 10
    with cpu_profile():
        for i in range(profiling.SPAN_RECORDS + extra):
            with span(str(i)):
                pass
    got = spans()
    assert len(got) == profiling.SPAN_RECORDS
    assert got[0].name == str(extra) and got[-1].name == str(profiling.SPAN_RECORDS + extra - 1)


def test_an_exception_closes_the_span():
    with cpu_profile():
        with pytest.raises(ValueError):
            with span("outer"):
                with span("inner"):
                    raise ValueError("inside")
        with span("later"):
            pass
    got = {s.name: s for s in spans()}
    assert set(got) == {"outer", "inner", "later"}
    assert got["inner"].parent == got["outer"].id
    # Nothing was left open: the next span is a root.
    assert got["later"].parent is None


def test_the_scan_solve_records_its_three_spans(monkeypatch):
    from ikpso_tpu_torch.harness import trajectory
    from ikpso_tpu_torch.models.library import arm_7dof, batched_problem
    from ikpso_tpu_torch.pso.config import PSOConfig

    # The CPU route of build_solver is the plain one; kernel C's object
    # runs its plain twin on CPU tensors.
    monkeypatch.setattr(trajectory, "fitness_impl", lambda *a: "kernel-C")
    spec, problem = arm_7dof()
    targets = torch.tensor([[[1.0, 1.2, -0.8]], [[0.5, 0.5, 1.0]]])
    solver = trajectory.build_solver(spec, pso=PSOConfig(iterations=2), num_particles=16,
                                     impl="jnp", device="cpu")
    batch = batched_problem(problem, targets)
    solver(batch, torch.Generator().manual_seed(1))
    assert spans() == []
    with cpu_profile():
        for seed in (2, 3):
            res = solver(batch, torch.Generator().manual_seed(seed))
    assert res.angles.shape == (2, spec.dof)
    got = spans()
    assert [s.name for s in got] == ["ikpso.solve.pack", "ikpso.solve.init", "ikpso.solve"] * 2
    for pack, init, root in (got[:3], got[3:]):
        assert root.parent is None and root.call == root.id
        assert pack.parent == init.parent == root.id and pack.call == init.call == root.id
        assert root.start <= pack.start <= pack.end <= init.start <= init.end <= root.end
    assert got[2].call != got[5].call
