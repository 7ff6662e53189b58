"""The upstream's frame protocol, played as a user would play it.

A batch of T trials (one swarm each) starts from the canonical pose with
the targets jumped to the configuration's ``reset_targets``; every frame
re-solves each trial warm from its previous frame's answer, through the
port's per-frame solver (``harness.trajectory.frame_solver``), and reads
the summed effector errors on the host. A trial has converged at the
first frame whose error is at most ``eps_dist``. The batch runs until
every trial has converged or ``max_frames`` have passed; the next batch
starts from the canonical pose. Frame f of batch b draws from
``derive(seed, FRAME, b, f)``.

Parameters: ``trials`` (T), ``trace_calls`` (the frames a traced run
profiles). A frame is one timed call. Every trial's answer of every
frame is judged, and ``frames_mean`` counts, for each trial of the
window's finished batches, the first frame whose judged error is at most
``eps_dist`` (``max_frames + 1`` for a trial that never got there).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.core import recipe, seeds
from benchmark.core.window import closed_loop
from benchmark.reference import check, fk

WARMUP = 2**40  # the batch index of the set-up frame's draws
JUDGE_FRAMES = 256  # whole frames judged in one block after the window


class Cell:
    def __init__(self, cfg: dict, wl: dict, seed: int, seconds: float, device, tracer):
        self.cfg, self.wl, self.seed, self.seconds = cfg, wl, seed, seconds
        self.device, self.tracer = torch.device(device), tracer
        self.r = cfg["recipes"][wl["recipe"]]
        self.params = wl["params"]
        self.swarms = int(self.params["trials"])
        self.eps, self.max_frames = float(self.r["eps_dist"]), int(self.r["max_frames"])
        self.outputs = []  # (batch, angles on the device, errors on the host) a frame
        self.finished = 0  # batches run to their end

    def setup(self, solver=None, warmup: bool = True):
        """The port's per-frame solver (or ``solver`` in its place), the
        first batch's start and, with ``warmup``, one frame."""
        self.spec, self.problem = recipe.model(self.cfg, self.device)
        reset = self.problem.targets
        self.start = recipe.batched(self.problem, reset[None].expand(
            (self.swarms,) + tuple(reset.shape)))
        if solver is None:
            from ikpso_tpu_torch.harness.trajectory import frame_solver

            solver = frame_solver(self.spec, pso=recipe.pso_config(self.r),
                                  fit=recipe.fitness_config(self.r),
                                  num_particles=self.r["particles"], impl="jnp",
                                  polish=self.r["polish"], device=self.device)
        self.solver = self.tracer.span("solve", solver)
        self.to_host = self.tracer.span("to_host", lambda res: res.effector_error.cpu())
        self._new_batch(0)
        if warmup:
            self.frame_call(WARMUP, 1, self.start, keep=False)

    def _new_batch(self, b: int):
        self.batch, self.frame = b, 1
        self.current = self.start
        self.done = np.zeros(self.swarms, bool)

    def frame_call(self, b: int, f: int, problem, keep: bool = True):
        gen = seeds.generator(seeds.derive(self.seed, seeds.FRAME, b, f), self.device)
        res = self.solver(problem, gen)
        err = self.to_host(res)
        if keep:
            self.outputs.append((b, res.angles, err))
        return res, err

    # -- the timed call -----------------------------------------------
    def step(self, i: int) -> int:
        res, err = self.frame_call(self.batch, self.frame, self.current)
        e = err.numpy()
        whole = e.shape == (self.swarms,) and tuple(res.pose.shape) == tuple(
            self.current.pose.shape)
        # Trials left without an answer have not converged and keep their pose.
        if whole:
            self.done |= e <= self.eps
        if self.done.all() or self.frame >= self.max_frames:
            self.finished += 1
            self._new_batch(self.batch + 1)
        else:
            if whole:
                self.current = self.current.replace(pose=res.pose)
            self.frame += 1
        return self.swarms if whole else 0

    def run_window(self):
        return closed_loop(self.seconds, self.tracer.calls(self.step))

    # -- after the window ---------------------------------------------
    def release(self):
        self.solver = self.spec = self.problem = self.start = self.current = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def attempted(self) -> int:
        return self.swarms * len(self.outputs)

    def _judged(self, judge, targets):
        """``(batch, judged errors on the host)`` of every frame, in order;
        whole frames judged ``JUDGE_FRAMES`` at a time."""
        whole = []

        def flush():
            k = len(whole)
            judged = judge.block(torch.cat([a for _, a, _ in whole]),
                                 torch.cat([e for _, _, e in whole]),
                                 targets.repeat(k, 1, 1), due=k * self.swarms)
            out = list(zip([b for b, _, _ in whole], judged.view(k, -1).cpu().numpy()))
            whole.clear()
            return out

        for b, angles, err in self.outputs:
            if tuple(angles.shape[:1]) + tuple(err.shape) == (self.swarms, self.swarms):
                whole.append((b, angles, err))
                if len(whole) == JUDGE_FRAMES:
                    yield from flush()
                continue
            if whole:
                yield from flush()
            yield b, judge.block(angles, err, targets, due=self.swarms).cpu().numpy()
        if whole:
            yield from flush()

    def check(self, include_open: bool = False) -> dict:
        """The judged numbers. With ``include_open`` the batch still running
        counts too, its trials not converged yet at its frames so far + 1:
        a lower bound of what it would read (the control's short runs)."""
        model = fk.Model(self.cfg["model"], self.device, torch.float64)
        judge = check.Judge(model, self.device)
        reset = torch.tensor(self.cfg["model"]["reset_targets"], dtype=torch.float32,
                             device=self.device)
        targets = reset[None].expand((self.swarms,) + tuple(reset.shape))
        never = {b: self.max_frames + 1 for b in range(self.finished)}
        if include_open and any(b == self.batch for b, _, _ in self.outputs):
            never[self.batch] = sum(b == self.batch for b, _, _ in self.outputs) + 1
        frames = {b: np.full(self.swarms, n) for b, n in never.items()}
        frame = {}
        for b, judged in self._judged(judge, targets):
            frame[b] = frame.get(b, 0) + 1
            if b in frames and judged.shape == (self.swarms,):
                first = (frames[b] == never[b]) & (judged <= self.eps)
                frames[b][first] = frame[b]
        numbers = judge.numbers()
        numbers.pop("miss_share")
        numbers["frames_mean"] = (float(np.concatenate(list(frames.values())).mean())
                                  if frames else None)
        numbers["batches_finished"] = self.finished
        return numbers
