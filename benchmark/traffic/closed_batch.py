"""Closed batches of fresh targets: the caller hands the solver a batch of
S targets, waits for every answer in its host buffers (pinned, reused from
call to call), and hands it the next.

Parameters (the cell's ``params``): ``swarms`` (S, one swarm a target),
``pool_batches_per_s`` (the batches made in set-up, per second of the
window; a window that runs past them makes the next batches on demand,
the same function of the seed), ``trace_calls`` (the calls a traced run
profiles).
Targets are the effectors of uniform in-limit poses: the pool's batches
drawn in turn from ``derive(seed, TARGETS)``, a batch past the pool from
``derive(seed, TARGETS, i)``; batch i's solve draws from ``derive(seed,
SOLVE, i)``. No two batches share targets. Every answer of the window is judged.
"""

from __future__ import annotations

import math

import torch

from benchmark.core import recipe, seeds
from benchmark.core.window import closed_loop
from benchmark.reference import check, fk

WARMUP = 2**40  # the batch index of the set-up call's own targets
POOL_CHUNK = 1 << 22  # rows of targets made by one call in set-up


class Cell:
    def __init__(self, cfg: dict, wl: dict, seed: int, seconds: float, device, tracer):
        self.cfg, self.wl, self.seed, self.seconds = cfg, wl, seed, seconds
        self.device, self.tracer = torch.device(device), tracer
        self.r = cfg["recipes"][wl["recipe"]]
        self.params = wl["params"]
        self.swarms = int(self.params["swarms"])
        self.outputs = []

    # -- inputs -------------------------------------------------------
    def targets(self, i: int) -> torch.Tensor:
        """Batch i's ``(S, E, 3)`` targets on the device: the pool's, or
        past it made on demand from the batch's own seed."""
        if i < len(self.pool):
            return self.pool[i]
        gen = seeds.generator(seeds.derive(self.seed, seeds.TARGETS, i), self.device)
        return fk.reachable_targets(self.model32, gen, self.swarms)

    def make_pool(self):
        """The first ``ceil(seconds * pool_batches_per_s)`` batches, drawn in
        order from one stream, in chunks of at least ``POOL_CHUNK`` rows."""
        n = math.ceil(self.seconds * float(self.params["pool_batches_per_s"]))
        gen = seeds.generator(seeds.derive(self.seed, seeds.TARGETS), self.device)
        per_chunk = max(1, POOL_CHUNK // self.swarms)
        self.pool = []
        for i in range(0, n, per_chunk):
            k = min(per_chunk, n - i)
            rows = fk.reachable_targets(self.model32, gen, k * self.swarms)
            self.pool.extend(rows.split(self.swarms))

    def setup(self, solver=None, warmup: bool = True):
        """The targets' pool, the recipe's solver (or ``solver`` in its
        place) and, with ``warmup``, one call on targets of its own."""
        self.model32 = fk.Model(self.cfg["model"], self.device, torch.float32)
        self.make_pool()
        self.spec, self.problem = recipe.model(self.cfg, self.device)
        if solver is None:
            solver = recipe.solver(self.spec, self.r, self.device, wrap=self.tracer.span)
        self.solver = solver
        pin = self.device.type == "cuda"
        self.host = (torch.empty((self.swarms, self.model32.dof), pin_memory=pin),
                     torch.empty(self.swarms, pin_memory=pin))
        self.to_host = self.tracer.span("to_host", self._to_host)
        if warmup:
            self.solve_call(WARMUP, keep=False)

    # -- the timed call -----------------------------------------------
    def _to_host(self, res):
        """The answers into the call's host buffers (pinned, reused: a
        caller that keeps a buffer for its results)."""
        n = min(int(res.angles.shape[0]), self.swarms)
        self.host[0][:n].copy_(res.angles[:n])
        self.host[1][:n].copy_(res.effector_error[:n])
        return n

    def solve_call(self, i: int, keep: bool = True) -> int:
        problem = recipe.batched(self.problem, self.targets(i))
        gen = seeds.generator(seeds.derive(self.seed, seeds.SOLVE, i), self.device)
        res = self.solver(problem, gen)
        n = self.to_host(res)
        if keep:
            # The judge reads the same answers after the window, from the card.
            self.outputs.append((res.angles, res.effector_error))
        return n

    def run_window(self):
        return closed_loop(self.seconds, self.tracer.calls(self.solve_call))

    # -- after the window ---------------------------------------------
    def release(self):
        self.solver = self.spec = self.problem = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def attempted(self) -> int:
        return self.swarms * len(self.outputs)

    def check(self) -> dict:
        judge = check.Judge(fk.Model(self.cfg["model"], self.device, torch.float64),
                            self.device)
        for i, (angles, err) in enumerate(self.outputs):
            judge.block(angles, err, self.targets(i), due=self.swarms)
        return judge.numbers()
