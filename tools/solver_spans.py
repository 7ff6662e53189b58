"""The scan solver's host time in a traced run of a benchmark cell, split by
the port's spans (``ikpso.solve`` > ``ikpso.solve.pack``,
``ikpso.solve.init``): each traced call's device idle in ``pack``, in
``init``, in the root's self time and outside ``ikpso.solve`` (the
latter by the innermost ``bench.*`` span or runtime call, the spans
placed as the port's are), the CUDA
runtime calls that start in each part, the enqueues of each call, and
whether the port's clock and the profiler's agree, on the spans as
``benchmark/core/spans.py`` places them: kernel C's launch
(``cudaLaunchKernel`` of ``fused_fitness_kernel``, matched by its
correlation id) inside each call's ``init`` span, how far any runtime call
straddles a span's edge, and how late the host read its clock after the
window's first mark (``first_mark_late_us``).

Run from the repository root on a machine with a card:

    python3 tools/solver_spans.py --workload reference_arm.frames --seeds 11 12 13 --seconds 8

Each seed is one traced run of ``benchmark/run.py``'s ``run`` in this
process, one after another; each prints one JSON line: ``correct``, the
per-layer metrics of the result line, the traced calls' rate
(``traced_solves_per_s``: answers of the traced calls over the traced
window) and the split, in ms a call.
"""

import argparse
import bisect
import collections
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.core import loader, spans  # noqa: E402
from benchmark.core.trace import HOST_CATS, MARK, Trace, Tracer, symbol  # noqa: E402
from ikpso_tpu_torch.utils import profiling  # noqa: E402

KERNEL_C = "fused_fitness_kernel"
STRADDLE_US = 5.0


def capture_traces(captured: dict):
    """Keep the Chrome events, the trace and the tracer of each traced run."""
    from_chrome, read = Trace.from_chrome.__func__, Tracer.read

    def keep_events(cls, events, bench_spans, host_t0, calls):
        captured.update(events=events)
        return from_chrome(cls, events, bench_spans, host_t0, calls)

    def keep_tracer(self):
        read(self)
        captured.update(tracer=self, trace=self.trace)

    Trace.from_chrome = classmethod(keep_events)
    Tracer.read = keep_tracer


def subtract(xs, ys):
    """Sorted disjoint ``xs`` less sorted disjoint ``ys``."""
    out = []
    for a, b in xs:
        for c, d in ys:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append((a, c))
            a = max(a, d)
        if b > a:
            out.append((a, b))
    return out


def phase_of(t, parts):
    for name, intervals in parts:
        i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
        if i >= 0 and intervals[i][0] <= t < intervals[i][1]:
            return name
    return "outside"


def clock_check(events, trace, recs):
    """Kernel C's launch in each call's init, and the widest straddle of a
    span edge by a runtime call of the window's thread, in us."""
    marks = sorted((e for e in events if e.get("ph") == "X" and e.get("name") == MARK
                    and e.get("cat") in HOST_CATS), key=lambda e: float(e["ts"]))
    t0, tid = float(marks[0]["ts"]) + float(marks[0]["dur"]), marks[0].get("tid")
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("tid") == tid
               and "correlation" in e.get("args", {})}
    launches = []
    for e in events:
        if e.get("cat") == "kernel" and symbol(e["name"]).startswith(KERNEL_C):
            r = runtime.get(e.get("args", {}).get("correlation"))
            if r is not None:
                launches.append(((float(r["ts"]) - t0) * 1e-6, r["name"]))
    inits = {call: (a, b) for n, a, b, call in recs if n == "ikpso.solve.init"}
    inside = collections.Counter()
    for t, _ in launches:
        for call, (a, b) in inits.items():
            if a <= t < b:
                inside[call] += 1
    calls = [call for n, _, _, call in recs if n == spans.SOLVE]
    host = sorted((a, b) for a, b, name in trace.host if not name.startswith("bench."))
    starts = [a for a, _ in host]
    widest, over = 0.0, 0
    for _, a, b, _ in recs:
        for edge in (a, b):
            i = bisect.bisect_left(starts, edge) - 1
            if i >= 0 and host[i][1] > edge:
                offset = 1e6 * min(edge - host[i][0], host[i][1] - edge)
                widest = max(widest, offset)
                over += offset > STRADDLE_US
    return {"calls": len(calls), "kernel_c_launches": len(launches),
            "calls_with_one_kernel_c_launch_in_init": sum(inside[c] == 1 for c in calls),
            "launch_runtime_names": sorted({n for _, n in launches}),
            "widest_straddle_us": widest, f"straddles_over_{STRADDLE_US:g}_us": over}


def split(trace, recs, bench):
    """Each traced call's idle and span time by part, and the runtime calls
    that start in each part, in ms (and counts) a call; the idle outside
    ``ikpso.solve`` by the innermost of ``bench`` (the ``bench.*`` spans on
    the window's clock) and the runtime calls."""
    calls = trace.calls
    gaps = trace.gaps()
    by = {n: spans.union([(a, b) for m, a, b, _ in recs if m == n])
          for n in (spans.SOLVE, *spans.PROLOGUE)}
    idle = {p: spans.overlap_s(gaps, by[n]) for p, n in
            (("root", spans.SOLVE), ("pack", spans.PROLOGUE[0]), ("init", spans.PROLOGUE[1]))}
    idle["self"] = idle["root"] - idle["pack"] - idle["init"]
    outside = subtract(gaps, by[spans.SOLVE])
    idle["outside"] = sum(b - a for a, b in outside)
    labels = collections.defaultdict(float)
    relabeled = Trace(trace.device, [h for h in trace.host if not h[2].startswith("bench.")]
                      + bench, trace.window_s, calls)
    for (a, b), label in zip(outside, relabeled.host_at([(a + b) / 2 for a, b in outside])):
        labels[label] += b - a
    span_s = {p: sum(b - a for a, b in by[n]) for p, n in
              (("root", spans.SOLVE), ("pack", spans.PROLOGUE[0]), ("init", spans.PROLOGUE[1]))}
    span_s["self"] = span_s["root"] - span_s["pack"] - span_s["init"]
    parts = [("pack", by[spans.PROLOGUE[0]]), ("init", by[spans.PROLOGUE[1]]),
             ("self", by[spans.SOLVE])]
    runtime = collections.defaultdict(lambda: collections.defaultdict(lambda: [0, 0.0]))
    for a, b, name in trace.host:
        if not name.startswith("bench."):
            cell = runtime[phase_of(a, parts)][name]
            cell[0] += 1
            cell[1] += b - a
    per_call = collections.Counter(spans.enqueues_by_call(trace, recs).values())

    def ms(d):
        return {k: 1e3 * v / calls for k, v in d.items()}

    return {"idle_ms": ms(idle), "idle_outside_by_host_ms": ms(labels),
            "span_ms": ms(span_s),
            "runtime_per_call": {p: {n: [c / calls, 1e3 * s / calls] for n, (c, s) in d.items()}
                                 for p, d in runtime.items()},
            "enqueues_per_call": {str(k): v for k, v in sorted(per_call.items())}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 3
    wl = loader.workload(args.workload)
    swarms = int(wl["params"].get("swarms", wl["params"].get("trials")))
    captured = {}
    capture_traces(captured)
    for seed in args.seeds:
        profiling.clear_spans()
        out = run.run(args.workload, seed, args.seconds, True, torch.device("cuda", 0))
        trace, tracer = captured["trace"], captured["tracer"]
        line = {"workload": args.workload, "seed": seed, "correct": out["correct"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "calls": trace.calls, "window_s": trace.window_s, "busy_s": trace.busy_s(),
                "idle_ms_per_call": 1e3 * (trace.window_s - trace.busy_s()) / trace.calls,
                "traced_solves_per_s": swarms * trace.calls / trace.window_s}
        recs = spans.window_spans(SimpleNamespace(trace=trace, cell=SimpleNamespace(
            tracer=tracer)), profiling.spans())
        if recs is not None:
            # The bench.* spans, placed at the closing mark as the port's are.
            bench = [(a, b, n) for n, a, b, _ in spans.on_window(
                [SimpleNamespace(name=n, start=a, end=b, call=None) for n, a, b in tracer._spans],
                tracer._t1, spans.last_mark_end(trace), trace.window_s)]
            line.update(split(trace, recs, bench))
            line["clock"] = clock_check(captured["events"], trace, recs)
            # How late the host read its clock after the window's first mark,
            # against the closing mark: the Tracer's bench.* spans sit that early.
            line["clock"]["first_mark_late_us"] = 1e6 * (
                spans.last_mark_end(trace) - (tracer._t1 - tracer._t0))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    run.fixed_hash_seed(sys.argv)
    sys.exit(main())
