"""``solver_graph_share`` (and its ``.frames`` alias) on made-up port
spans over the made-up trace of ``test_bench_program_spans``: the share of
the window's ``ikpso.solve`` calls that hold an ``ikpso.solve.replay``
child (0 on a port without the graph route), and nothing read without a
root in the window."""

import pytest

from benchmark.core import loader
from ikpso_tpu_torch.utils import profiling
from ikpso_tpu_torch.utils.profiling import Span
from test_bench_program_spans import ctx, us

NAMES = ("solver_graph_share", "solver_graph_share.frames")


def call(root_id, t0, replayed):
    """One scan-solver call at ``t0`` us: its root, pack, init and, on the
    graph route, its replay child."""
    kids = [Span("ikpso.solve.pack", us(t0 + 5), us(t0 + 10), root_id + 1, root_id, root_id),
            Span("ikpso.solve.init", us(t0 + 10), us(t0 + 20), root_id + 2, root_id, root_id)]
    if replayed:
        kids.append(Span("ikpso.solve.replay", us(t0 + 20), us(t0 + 80), root_id + 3,
                         root_id, root_id))
    return kids + [Span("ikpso.solve", us(t0), us(t0 + 90), root_id, None, root_id)]


def record(monkeypatch, records):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))


def read(name, c):
    return loader.module("metrics", name).read(c)


@pytest.mark.parametrize("replays, want", [((True, True, True, True), 1.0),
                                           ((True, False, True, False), 0.5),
                                           ((False,) * 4, 0.0)])
def test_the_share_of_calls_that_replayed(monkeypatch, replays, want):
    records = [s for i, r in enumerate(replays) for s in call(10 * (i + 1), 200 * i, r)]
    # A replay child of a call before the window is not the window's.
    records += call(100, -5e5, True)
    record(monkeypatch, records)
    for name in NAMES:
        assert read(name, ctx()) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_roots", "roots_before_the_window"])
def test_nothing_read_without_roots_or_a_graph_route(monkeypatch, case):
    if case == "no_roots":
        record(monkeypatch, [Span("ikpso.solve.replay", us(5), us(10), 2, 1, 1)])
    else:  # the calls, replayed, all end before the window starts
        record(monkeypatch, call(10, -5e5, True) + call(20, -4e5, True))
    for name in NAMES:
        assert read(name, ctx()) is None
