"""The traced run's profiler and its reading.

``Tracer`` runs ``torch.profiler`` with CUDA activity alone over the
window's first calls: every kernel, copy and memset on the card, and the
CUDA runtime calls of the host (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
``cudaStreamSynchronize`` ...). Recording every PyTorch operator on the
host as well (CPU activity) costs the host ~10 us an operator, which
slowed a host-paced solve by 1.4-1.5x (``PERF.md``); the benchmark's own
spans (``bench.call``, ``bench.solve``, ``bench.to_host``) are timed on
the host clock instead, at the cost of a clock read each. The window is marked by a
``torch.cuda.synchronize()`` at each end (``cudaDeviceSynchronize`` in
the trace), which also ties the host clock to the trace's. Without a card
the tracer keeps only the spans.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

MARK = "cudaDeviceSynchronize"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    """Device work and host activity of the traced window, in seconds from
    its start: ``device`` ``(name, start, end, category)``, ``host``
    ``(start, end, name)`` (spans and runtime calls of the window's
    thread, nested), ``window_s`` and the window's ``calls``."""

    def __init__(self, device, host, window_s: float, calls: int):
        self.device = sorted(device, key=lambda d: d[1])
        self.host = sorted(host, key=lambda h: (h[0], -h[1]))
        self.window_s, self.calls = window_s, calls

    @classmethod
    def from_chrome(cls, events: List[dict], spans, host_t0: float, calls: int) -> "Trace":
        """A Chrome trace whose first and last ``cudaDeviceSynchronize``
        mark the window's ends; ``spans`` ``(name, start, end)`` on the host
        clock, whose window started at ``host_t0`` (the first mark's end)."""
        marks = sorted((e for e in events if e.get("ph") == "X" and e.get("name") == MARK
                        and e.get("cat") in HOST_CATS), key=lambda e: float(e["ts"]))
        if len(marks) < 2:
            raise ValueError(f"the trace holds no two {MARK} marks of the window")
        t0 = float(marks[0]["ts"]) + float(marks[0]["dur"])
        t1 = float(marks[-1]["ts"])
        window_s, tid = (t1 - t0) * 1e-6, marks[0].get("tid")

        def clip(a, b):
            return max(a, 0.0), min(b, window_s)

        device, host = [], []
        for e in events:
            if e.get("ph") != "X" or e is marks[0] or e is marks[-1]:
                continue
            a = (float(e["ts"]) - t0) * 1e-6
            a, b = clip(a, a + float(e.get("dur", 0.0)) * 1e-6)
            if b <= a:
                continue
            if e.get("cat") in DEVICE_CATS:
                device.append((e["name"], a, b, e["cat"]))
            elif e.get("cat") in HOST_CATS and e.get("tid") == tid:
                host.append((a, b, e["name"]))
        for name, a, b in spans:
            a, b = clip(a - host_t0, b - host_t0)
            if b > a:
                host.append((a, b, name))
        return cls(device, host, window_s, calls)

    def kernels(self) -> List[Tuple[str, float, float]]:
        """``(name, start, end)`` of every kernel in the window."""
        return [(n, a, b) for n, a, b, c in self.device if c == "kernel"]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's work as disjoint intervals."""
        out: List[List[float]] = []
        for _, a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> List[Tuple[float, float]]:
        """The window's intervals in which the device did nothing."""
        out, t = [], 0.0
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < self.window_s:
            out.append((t, self.window_s))
        return out

    def host_at(self, times: List[float]) -> List[str]:
        """The innermost span or runtime call of the window's thread at each
        of ``times`` (sorted), or ``"host (no span)"``."""
        labels, stack, i = [], [], 0
        for t in times:
            while i < len(self.host) and self.host[i][0] <= t:
                a, b, name = self.host[i]
                while stack and stack[-1][1] <= a:
                    stack.pop()
                stack.append((a, b, name))
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            labels.append(stack[-1][2] if stack else "host (no span)")
        return labels

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle time by
        what the host was doing, ``top`` of each, in seconds."""
        ops: Dict[str, float] = defaultdict(float)
        for name, a, b, _ in self.device:
            ops[name] += b - a
        gaps = self.gaps()
        idle: Dict[str, float] = defaultdict(float)
        for (a, b), label in zip(gaps, self.host_at([(a + b) / 2 for a, b in gaps])):
            idle[label] += b - a

        def ranked(d):
            return [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}


def symbol(name: str) -> str:
    """A kernel's unqualified name: its demangled name without the return
    type, the namespaces and the template arguments
    (``void ikpso::scan_step_kernel<...>(...)`` -> ``scan_step_kernel``)."""
    if name.startswith("void "):
        name = name[5:]
    cut = min((i for i in (name.find("<"), name.find("(")) if i >= 0), default=len(name))
    return name[:cut].rsplit("::", 1)[-1]


def matching(kernels, prefixes) -> List[Tuple[str, float, float]]:
    """The kernels whose unqualified name starts with one of ``prefixes``."""
    return [k for k in kernels if symbol(k[0]).startswith(tuple(prefixes))]


class Tracer:
    """The profiler over the window's first ``calls`` calls (all of them
    where ``calls`` is None) in a traced run; a no-op otherwise."""

    def __init__(self, on: bool, calls: Optional[int] = None):
        self.on, self.limit = on, calls
        self.trace: Optional[Trace] = None
        self._prof = None
        self._spans: List[Tuple[str, float, float]] = []
        self._calls = 0
        self._t0 = self._t1 = None

    @staticmethod
    def _mark():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return time.perf_counter()

    def start(self):
        """Start the profiler and mark the window's start."""
        if not self.on:
            return
        if torch.cuda.is_available():
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = self._mark()

    def calls(self, fn):
        """``fn``, the window's call, as a ``bench.call`` span; the profiler
        stops after the ``calls``-th."""
        if not self.on:
            return fn
        spanned = self.span("call", fn)

        def call(*args, **kwargs):
            out = spanned(*args, **kwargs)
            if self._t1 is None:
                self._calls += 1
                if self.limit is not None and self._calls >= self.limit:
                    self.finish()
            return out

        return call

    def span(self, name: str, fn):
        """``fn`` timed as a span ``bench.<name>`` while the window is traced."""
        if not self.on:
            return fn
        label = f"bench.{name}"

        def spanned(*args, **kwargs):
            if self._t0 is None or self._t1 is not None:
                return fn(*args, **kwargs)
            a = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._spans.append((label, a, time.perf_counter()))

        return spanned

    def finish(self):
        """Mark the window's end and stop the profiler (once)."""
        if self._t0 is None or self._t1 is not None:
            return
        self._t1 = self._mark()
        if self._prof is not None:
            self._prof.__exit__(None, None, None)

    def read(self):
        """Read the stopped profiler's trace into :attr:`trace`."""
        if self._t0 is None:
            return
        self.finish()
        if self._prof is None:
            spans = [(a - self._t0, b - self._t0, n) for n, a, b in self._spans]
            self.trace = Trace([], spans, self._t1 - self._t0, self._calls)
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)
        finally:
            os.unlink(path)
        self._prof = None
        events = events["traceEvents"] if isinstance(events, dict) else events
        self.trace = Trace.from_chrome(events, self._spans, self._t0, self._calls)
