"""The port's own spans on the traced window's clock, and what the scan
solver's per-layer metrics read of them.

``ikpso_tpu_torch.utils.profiling.spans()`` holds the port's spans
(``name``, ``start``, ``end``, ``id``, ``parent``, ``call``) on the host
clock, recorded while a ``torch.profiler`` profile is active: in a traced
run, the ``Tracer``'s window. They go on the trace's clock at the
window's last mark: the host clock when the ``Tracer``'s closing
``torch.cuda.synchronize()`` returned (``Tracer._t1``) is the end of that
``cudaDeviceSynchronize`` on the trace, the last one of the window's
thread, or the window's end where the profiler added no sync of its own
after it. The first mark, which the ``Tracer`` maps its ``bench.*`` spans
by (``Tracer._t0``), is no anchor: on the H100 the first synchronize after
the profiler starts returns 0.5-2.4 ms after its runtime call ends on the
trace, and every later one within a few us (``PERF.md``). The spans are
then clipped to the window. The readers hand the records in; this module
imports nothing of the port. Where the window holds no ``ikpso.solve``
span (a run without a card, or a port that records none) every reading is
None.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.core.trace import MARK

SOLVE = "ikpso.solve"  # the root: one call of the scan solver
PROLOGUE = ("ikpso.solve.pack", "ikpso.solve.init")  # its work before the first step
ENQUEUES = ("cudaLaunchKernel", "cudaMemcpy", "cudaMemset")  # runtime calls that queue work

WindowSpan = Tuple[str, float, float, int]  # name, start, end (s into the window), call


def on_window(records, host_at: float, trace_at: float, window_s: float) -> List[WindowSpan]:
    """The records that overlap the window, on its clock and clipped to it:
    host time ``host_at`` is ``trace_at`` s into the window."""
    out = []
    for r in records:
        a = max(r.start - host_at + trace_at, 0.0)
        b = min(r.end - host_at + trace_at, window_s)
        if b > a:
            out.append((r.name, a, b, r.call))
    return out


def last_mark_end(trace) -> float:
    """Where the window's closing mark ends on the trace: the end of the
    window thread's last ``cudaDeviceSynchronize``, or the window's end."""
    ends = [b for _, b, name in trace.host if name == MARK]
    return max(ends) if ends else trace.window_s


def window_spans(ctx, records) -> Optional[List[WindowSpan]]:
    """The port's spans of the traced window (``ctx`` as a metric's reader
    gets it), or None where the window holds no traced call or no
    ``ikpso.solve`` span."""
    t = ctx.trace
    t1 = getattr(getattr(ctx.cell, "tracer", None), "_t1", None)
    if t is None or t1 is None or not t.calls:
        return None
    got = on_window(records, t1, last_mark_end(t), t.window_s)
    return got if any(s[0] == SOLVE for s in got) else None


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Intervals merged into sorted disjoint ones."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_s(xs: Sequence[Tuple[float, float]], ys: Sequence[Tuple[float, float]]) -> float:
    """The time two lists of sorted disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def roots(spans: Sequence[WindowSpan]) -> List[WindowSpan]:
    return [s for s in spans if s[0] == SOLVE]


def solver_idle_s(trace, spans: Sequence[WindowSpan]) -> float:
    """The device's idle time inside the union of the ``ikpso.solve`` spans."""
    return overlap_s(trace.gaps(), union([(a, b) for _, a, b, _ in roots(spans)]))


def prologue_s(spans: Sequence[WindowSpan]) -> float:
    """The summed time of the ``ikpso.solve.pack`` and ``.init`` spans."""
    return sum(b - a for n, a, b, _ in spans if n in PROLOGUE)


def enqueues_by_call(trace, spans: Sequence[WindowSpan]) -> Dict[int, int]:
    """For each ``ikpso.solve`` span (by its call id), the window thread's
    CUDA runtime calls that queue work (``ENQUEUES``) and start inside it."""
    starts = sorted(a for a, _, name in trace.host if name.startswith(ENQUEUES))
    return {call: bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
            for _, a, b, call in roots(spans)}
