"""The traced run's reading, on a made-up Chrome trace: the window, the
device's busy time and gaps, the host op in each gap, the kernels'
symbols, and the metric readers on it."""

import pytest

from benchmark.core import loader
from benchmark.core.trace import Trace, matching, symbol


def X(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


# The window runs from 1000 us (the first mark's end) to 2000 us (the last
# mark's start); the host clock's window started at 50.0 s.
EVENTS = [
    X("cudaDeviceSynchronize", "cuda_runtime", 990, 10),
    X("cudaDeviceSynchronize", "cuda_runtime", 2000, 5),
    X("cudaLaunchKernel", "cuda_runtime", 1010, 5),
    X("cudaStreamSynchronize", "cuda_runtime", 1350, 150),
    X("void ikpso::scan_step_kernel<ikpso::StepTreeWalk<ikpso::Topology<4, 8448ull, 8u>, 0, "
      "false>, false>(ikpso::StepState)", "kernel", 1100, 200, 7),
    X("void ikpso::scan_step_kernel<Arm7, true>(Walk, float const*)", "kernel", 1250, 100, 7),
    X("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1600, 100, 8),
    X("void at::native::elementwise_kernel<128, 2>(int)", "kernel", 1900, 200, 7),
    X("fused_fitness_kernel", "kernel", 500, 100, 7),  # before the window
    X("cudaLaunchKernel", "cuda_runtime", 1040, 50, 2),  # another thread
]
SPANS = [("bench.call", 50.0, 50.0005), ("bench.call", 50.0005, 50.00075),
         ("bench.solve", 50.0, 50.0001)]


def trace():
    return Trace.from_chrome(EVENTS, SPANS, 50.0, 2)


def test_window_busy_gaps_and_host_labels():
    t = trace()
    assert t.window_s == pytest.approx(1e-3)
    assert t.calls == 2
    assert [round(a * 1e6) for a, b in t.busy()] == [100, 600, 900]
    assert t.busy_s() == pytest.approx(250e-6 + 100e-6 + 100e-6)
    gaps = [(round(a * 1e6), round(b * 1e6)) for a, b in t.gaps()]
    assert gaps == [(0, 100), (350, 600), (700, 900)]
    assert t.host_at([12e-6, 50e-6, 475e-6, 800e-6]) == [
        "cudaLaunchKernel", "bench.solve", "cudaStreamSynchronize", "host (no span)"]
    br = t.breakdown()
    assert br["device_ops"][0][0].startswith("void ikpso::scan_step_kernel")
    assert br["device_ops"][0][1] == pytest.approx(200e-6)
    assert dict((k, round(v * 1e6)) for k, v in br["idle_gaps"]) == {
        "cudaStreamSynchronize": 250, "bench.solve": 100, "host (no span)": 200}
    assert len(t.kernels()) == 3


def test_symbols():
    k = trace().kernels()
    assert symbol(k[0][0]) == "scan_step_kernel"
    assert symbol("fused_fitness_kernel") == "fused_fitness_kernel"
    assert symbol("void at::native::elementwise_kernel<128, 2>(int)") == "elementwise_kernel"
    assert symbol("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH "
    assert len(matching(k, ("scan_step_kernel",))) == 2
    assert matching(k, ("fused_solve_",)) == []


def test_trace_without_window_is_refused():
    with pytest.raises(ValueError):
        Trace.from_chrome(EVENTS[1:], SPANS, 50.0, 2)


class Cell:
    swarms = 16384


def ctx(trace):
    from types import SimpleNamespace

    from benchmark.core.window import Window

    cfg = loader.config("arm7")
    return SimpleNamespace(window=Window([0.1, 0.1], 32768, 0.2), setup_s=9.0, trace=trace,
                   cell=Cell(), config=cfg, workload=loader.workload("arm7.scan"),
                   recipe=cfg["recipes"]["scan"], device=None, dof=9)


def test_readers_on_the_made_up_trace():
    from benchmark.reference import counts

    c = ctx(trace())
    idle = loader.module("metrics", "device_idle_pct").read(c)
    assert idle == pytest.approx(55.0)
    share = loader.module("metrics", "scan_step_roofline_pct").read(c)
    bound = counts.bound_seconds(*counts.scan_step(c.config["counts"], 9, c.recipe, 16384))
    assert share == pytest.approx(100.0 * 2 * bound / 300e-6)
    assert loader.module("metrics", "solves_per_s").read(c) == pytest.approx(32768 / 0.2)
    assert loader.module("metrics", "batch_ms_p95").read(c) == pytest.approx(100.0)
    assert loader.module("metrics", "setup_s").read(c) == 9.0


def test_readers_without_a_trace_read_nothing():
    c = ctx(None)
    for name in ("device_idle_pct", "scan_step_roofline_pct"):
        assert loader.module("metrics", name).read(c) is None
