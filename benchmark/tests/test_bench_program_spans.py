"""The scan solver's per-layer metrics (``solver_idle_ms``,
``solver_prologue_ms``, ``solver_launches`` and their ``.frames``
aliases) on a made-up Chrome trace and made-up port spans: the window's
clock (anchored at its closing mark), the idle gaps inside the
``ikpso.solve`` spans, the division by the traced calls, the runtime
calls counted, and nothing read where the port recorded no span."""

from types import SimpleNamespace

import pytest

from benchmark.core import loader, spans
from benchmark.core.trace import Trace
from ikpso_tpu_torch.utils import profiling
from ikpso_tpu_torch.utils.profiling import Span

HOST_T0 = 50.0  # the host clock at the window's start


def X(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


# The window runs from 1000 us to 2000 us of the trace's clock. The device
# is busy at 100-300, 500-600 and 800-850 us of it: idle 0-100, 300-500,
# 600-800 and 850-1000.
EVENTS = [
    X("cudaDeviceSynchronize", "cuda_runtime", 990, 10),
    X("cudaDeviceSynchronize", "cuda_runtime", 2000, 5),
    X("void ikpso::fused_fitness_kernel<A>(B)", "kernel", 1100, 200, 7),
    X("void ikpso::scan_step_kernel<A, false>(B)", "kernel", 1500, 100, 7),
    X("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1800, 50, 8),
    # Runtime calls of the window's thread: inside call 1, three that queue
    # work and a sync; between the calls one; inside call 2 one; after it one.
    X("cudaLaunchKernel", "cuda_runtime", 1005, 4),
    X("cudaMemcpyAsync", "cuda_runtime", 1100, 6),
    X("cudaMemsetAsync", "cuda_runtime", 1200, 3),
    X("cudaStreamSynchronize", "cuda_runtime", 1350, 40),
    X("cudaLaunchKernel", "cuda_runtime", 1420, 4),
    X("cudaLaunchKernelExC", "cuda_runtime", 1460, 4),
    X("cudaMemcpyAsync", "cuda_runtime", 1950, 4),
    # Another thread's launch, inside call 2: not the window's thread.
    X("cudaLaunchKernel", "cuda_runtime", 1470, 4, tid=2),
]


def us(t):
    return HOST_T0 + t * 1e-6


# Two calls: roots 0-400 and 450-900 us of the window, each with its pack
# and init; one root before the window, left out.
RECORDS = [
    Span("ikpso.solve.pack", us(10), us(60), 2, 1, 1),
    Span("ikpso.solve.init", us(60), us(250), 3, 1, 1),
    Span("ikpso.solve", us(0), us(400), 1, None, 1),
    Span("ikpso.solve.pack", us(460), us(480), 5, 4, 4),
    Span("ikpso.solve.init", us(480), us(700), 6, 4, 4),
    Span("ikpso.solve", us(450), us(900), 4, None, 4),
    Span("ikpso.solve", 49.0, 49.0001, 0, None, 0),
]
METRICS = ("solver_idle_ms", "solver_prologue_ms", "solver_launches")


def ctx(trace=True, events=EVENTS, host_t1=us(1000)):
    """A reader's context: the trace, and the tracer's host clock at the
    window's first and last marks."""
    t = Trace.from_chrome(events, [], HOST_T0, 2) if trace else None
    tracer = SimpleNamespace(_t0=HOST_T0, _t1=host_t1)
    return SimpleNamespace(trace=t, cell=SimpleNamespace(tracer=tracer))


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(RECORDS))


def in_us(got):
    return [(n, round(a * 1e6), round(b * 1e6), call) for n, a, b, call in got]


def read(name, c):
    return loader.module("metrics", name).read(c)


def test_window_spans_on_the_trace_clock(recorded):
    assert in_us(spans.window_spans(ctx(), profiling.spans())) == [
        ("ikpso.solve.pack", 10, 60, 1), ("ikpso.solve.init", 60, 250, 1),
        ("ikpso.solve", 0, 400, 1), ("ikpso.solve.pack", 460, 480, 4),
        ("ikpso.solve.init", 480, 700, 4), ("ikpso.solve", 450, 900, 4)]


def test_the_closing_mark_anchors_the_clocks(recorded):
    # The tracer's closing mark ends at 996 us of the trace, when the host
    # clock read us(996); the profiler's own sync at 2000 ends the window.
    # The first mark's host reading (_t0) plays no part.
    events = EVENTS[:1] + [X("cudaDeviceSynchronize", "cuda_runtime", 1990, 6)] + EVENTS[1:]
    c = ctx(events=events, host_t1=us(996))
    c.cell.tracer._t0 = HOST_T0 + 1.8e-3
    assert spans.last_mark_end(c.trace) == pytest.approx(996e-6)
    assert in_us(spans.window_spans(c, RECORDS)) == in_us(spans.window_spans(ctx(), RECORDS))
    # A host clock 300 us ahead at the closing mark moves every span 300 us
    # earlier, clipped at the window's start.
    early = spans.window_spans(ctx(events=events, host_t1=us(1296)), RECORDS)
    assert in_us(early) == [
        ("ikpso.solve", 0, 100, 1), ("ikpso.solve.pack", 160, 180, 4),
        ("ikpso.solve.init", 180, 400, 4), ("ikpso.solve", 150, 600, 4)]


def test_interval_arithmetic():
    assert spans.union([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    assert spans.overlap_s([(0, 1), (2, 5)], [(0.5, 3), (4, 6)]) == pytest.approx(2.5)
    assert spans.overlap_s([], [(0, 1)]) == 0.0


def test_solver_idle_is_the_gaps_inside_the_roots_a_call(recorded):
    c = ctx()
    # Gaps 0-100, 300-500, 600-800, 850-1000 against roots 0-400, 450-900:
    # 100 + (100 + 50) + 200 + 50 = 500 us over 2 calls.
    assert spans.solver_idle_s(c.trace, spans.window_spans(c, RECORDS)) == pytest.approx(500e-6)
    assert read("solver_idle_ms", c) == pytest.approx(0.25)
    # No larger than the window's idle a call: 550 us over 2.
    assert read("solver_idle_ms", c) <= 1e3 * (c.trace.window_s - c.trace.busy_s()) / 2


def test_solver_prologue_sums_pack_and_init_a_call(recorded):
    # 50 + 190 + 20 + 220 = 480 us over 2 calls.
    assert read("solver_prologue_ms", ctx()) == pytest.approx(0.24)


def test_solver_launches_counts_the_window_threads_enqueues_in_the_roots(recorded):
    c = ctx()
    assert spans.enqueues_by_call(c.trace, spans.window_spans(c, RECORDS)) == {1: 3, 4: 1}
    assert read("solver_launches", c) == pytest.approx(2.0)


def test_frames_aliases_read_alike(recorded):
    for name in METRICS:
        assert read(f"{name}.frames", ctx()) == read(name, ctx())


@pytest.mark.parametrize("case", ["no_records", "before_the_window", "no_trace", "no_recorder"])
def test_nothing_read_without_port_spans(case, monkeypatch):
    if case == "no_recorder":  # a port without the recorder
        monkeypatch.delattr(profiling, "spans")
    else:
        kept = {"no_records": [], "before_the_window": RECORDS[-1:], "no_trace": RECORDS}[case]
        monkeypatch.setattr(profiling, "spans", lambda: list(kept))
    c = ctx(trace=case != "no_trace")
    for name in METRICS:
        assert read(name, c) is None
        assert read(f"{name}.frames", c) is None
