"""Kernel-C scan solves replayed as CUDA graphs, one a shape.

On the card a kernel-C scan solve (``harness.trajectory.build_solver``,
``impl="jnp"``) is, for a given shape, a fixed chain of ~300 launches:
kernel C's per-swarm packing, the swarm's init, one scan-step launch an
iteration, the answer. Nothing in it reads the device from the host, and
its host dispatch is what the card waits on when the solve is short. So
a solver captures each shape's call once (:class:`CapturedSolve`) and
replays it:

  1. the problem's pose, origin, targets (and target rotations) are
     copied into the graph's inputs (span ``ikpso.solve.pack``);
  2. the call's uniforms are drawn from the caller's generator into the
     graph's draw buffers, outside the graph, as the eager route draws
     them (``pso.solver.draw_into``; span ``ikpso.solve.init``);
  3. the graph replays on the current stream and the answer is cloned out
     of its outputs (span ``ikpso.solve.replay``), so no tensor a caller
     keeps is overwritten by the next replay.

The graph holds the eager route's launches on the same inputs and draws,
so its answer is the eager one bit for bit. :func:`route` decides from
what a call carries: a shape's first call runs eagerly (a caller that
sees a shape once pays nothing for the graph), its second captures and
replays, and every later one replays. The first call is also the
warm-up torch asks for before a capture: the kernels' builds and the
allocator have run. A solver keeps ``GRAPH_KEYS`` captured shapes and as
many shapes seen once (:class:`GraphCache`), and drops the oldest
first; its graphs share one memory pool, as their replays run one after
another. A shape's graph has one set of inputs and draw buffers, so one
solver serves one thread at a time. The kernel wrappers count a
captured launch once, at its capture; :attr:`CapturedSolve.replays`
counts the replays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Hashable, Optional

import torch

from ikpso_tpu_torch.models.chain import IKProblem
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.solver import (ScanDraws, SolveResult, StepDraws, draw_into,
                                        draws_per_iteration)
from ikpso_tpu_torch.utils.profiling import span

GRAPH_KEYS = 4  # captured shapes a solver keeps; a fifth drops the oldest

# (problem, uniforms) -> SolveResult: the solve on injected draws.
DrawnSolve = Callable[[IKProblem, ScanDraws], SolveResult]


def _tensors(result) -> tuple:
    return tuple(getattr(result, f.name) for f in dataclasses.fields(result))


def graph_key(problem: IKProblem, num_particles: int) -> tuple:
    """What a captured solve is fixed to: the device, P, the pose's shape
    (S, N; D = 3 (N - 1)), the targets' (E), the origin's, whether
    ``target_rot`` is given (and its shape), and the dtypes."""
    fields = [t for t in _tensors(problem) if t is not None]
    return ((problem.pose.device, num_particles, problem.target_rot is not None)
            + tuple((tuple(t.shape), t.dtype) for t in fields))


def route(device, seen: bool, captured: bool) -> str:
    """How a call of ``build_solver``'s graph-routed scan solver runs:
    ``"replay"`` (its shape's graph), ``"capture"`` (the shape's second
    call: captured, then replayed) or ``"eager"`` (off the card; the
    shape's first call). Solvers whose fitness is not kernel C's, or that
    reduce gbest across ranks, are eager throughout (``build_solver``)."""
    if torch.device(device).type != "cuda":
        return "eager"
    if captured:
        return "replay"
    return "capture" if seen else "eager"


class GraphCache:
    """At most ``GRAPH_KEYS`` captured solves by :func:`graph_key`, and as
    many keys seen once; adding one more of either drops its oldest. The
    first graph's memory pool (``pool``) is every later one's."""

    def __init__(self):
        self._by_key: dict = {}
        self._seen: dict = {}
        self.pool = None

    def __contains__(self, key: Hashable) -> bool:
        return key in self._by_key

    def __getitem__(self, key: Hashable):
        return self._by_key[key]

    def seen(self, key: Hashable) -> bool:
        return key in self._seen

    def see(self, key: Hashable) -> None:
        self._seen[key] = None
        _keep_newest(self._seen)

    def add(self, key: Hashable, captured) -> None:
        self._seen.pop(key, None)
        self._by_key[key] = captured
        if self.pool is None:
            self.pool = captured.pool
        _keep_newest(self._by_key)


def _keep_newest(d: dict) -> None:
    while len(d) > GRAPH_KEYS:
        del d[next(iter(d))]


class CapturedSolve:
    """One shape's scan solve as a CUDA graph: ``run(inputs, draws)``
    captured on static inputs (copies of ``problem``'s tensors) and draw
    buffers of the shape, in ``pool`` (another graph's, or None: a pool of
    its own); called as ``(problem, generator) -> SolveResult``."""

    captures = 0  # graphs captured in this process
    replays = 0  # and replayed

    def __init__(self, run: DrawnSolve, problem: IKProblem, pso: PSOConfig,
                 num_particles: int, dof: int, pool=None):
        dev = problem.pose.device
        self.inputs = IKProblem(*(None if t is None else t.clone() for t in _tensors(problem)))
        s = problem.pose.shape[0]
        shape = (s, num_particles, dof)

        def block():
            return torch.empty(shape, dtype=torch.float32, device=dev)

        self.draws = ScanDraws(
            block() if pso.init_mode in ("uniform", "hybrid") else None, block(),
            StepDraws(torch.empty((s, 2), dtype=torch.int32, device=dev),
                      draws_per_iteration(pso), num_particles, dof))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            self.out: SolveResult = run(self.inputs, self.draws)
        self.pool = self.graph.pool()
        CapturedSolve.captures += 1

    def __call__(self, problem: IKProblem, generator: Optional[torch.Generator]
                 ) -> SolveResult:
        if generator is None:
            raise ValueError("solve() needs a generator or injected uniforms")
        with span("ikpso.solve.pack"):
            for dst, src in zip(_tensors(self.inputs), _tensors(problem)):
                if dst is not None:
                    dst.copy_(src)
        with span("ikpso.solve.init"):
            draw_into(self.draws, generator)
        with span("ikpso.solve.replay"):
            self.graph.replay()
            CapturedSolve.replays += 1
            return SolveResult(*(t.clone() for t in _tensors(self.out)))
