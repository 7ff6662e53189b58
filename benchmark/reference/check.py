"""The comparison that decides ``correct``.

The judge recomputes, in float64 and from the configuration's numbers,
the summed effector error of every answer the program returned (its
angles, for the targets the benchmark made), and reads:

  * ``err_gap_m``: the widest gap between the error the program reported
    for an answer and the judge's error of that answer, in metres;
  * ``miss_share`` (the batch cells): the share of answers whose judged
    error is 1 mm or more;
  * ``frames_mean`` (the frame cell): the mean frames to converge of the
    trials of the window's finished trial batches, a trial that never
    converged counting ``max_frames + 1``;
  * ``failed``: answers with a non-finite angle or error, or an angle
    outside its joint's limits;
  * ``missing``: answers due in the window that never came.

Each number has its limit in the cell's file (``check.limits``); the run
is correct when every number is at most its limit.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

import torch

from benchmark.reference import fk

MISS_M = 1e-3  # the accuracy bar of the batch cells: 1 mm


class Judge:
    """Accumulates the judged numbers over blocks of answers."""

    def __init__(self, model: fk.Model, device):
        self.model, self.device = model, device
        self.answers = 0
        self.missing = 0
        self.failed = 0
        self.misses = 0
        self.gap = 0.0

    def block(self, angles: torch.Tensor, reported: torch.Tensor, targets: torch.Tensor,
              due: int) -> torch.Tensor:
        """Judge one call's answers: ``angles (n, D)`` and ``reported (n,)``
        as the program returned them, ``targets (due, E, 3)``. Returns the
        judged errors ``(n,)`` (float64, NaN where the answer failed)."""
        n = 0 if angles is None else int(angles.shape[0])
        ok_shape = (angles is not None and reported is not None and angles.dim() == 2
                    and angles.shape[1] == self.model.dof and reported.shape == (n,)
                    and n <= due)
        if not ok_shape:
            self.answers += due
            self.missing += due
            return torch.full((0,), math.nan, dtype=torch.float64)
        self.answers += due
        self.missing += due - n
        a = angles.to(self.device, torch.float32)
        rep = reported.to(self.device, torch.float64)
        lo, hi = self.model.lo.to(self.device), self.model.hi.to(self.device)
        bad = (~torch.isfinite(a).all(-1) | ~torch.isfinite(rep)
               | (a < lo).any(-1) | (a > hi).any(-1))
        judged = fk.effector_error(self.model, a.double(), targets[:n].to(self.device))
        good = ~bad
        self.failed += int(bad.sum())
        if bool(good.any()):
            self.gap = max(self.gap, float((rep[good] - judged[good]).abs().max()))
        self.misses += int(((judged >= MISS_M) & good).sum())
        return torch.where(good, judged, torch.full_like(judged, math.nan))

    def numbers(self) -> dict:
        return dict(err_gap_m=self.gap,
                    miss_share=self.misses / self.answers if self.answers else None,
                    failed=self.failed, missing=self.missing)


def compare(numbers: dict, limits: dict) -> Tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` for every limited number;
    a number that is missing (None) or NaN is not correct."""
    rows, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and not math.isnan(float(value)) and float(value) <= limit
        correct &= ok
        rows[name] = {"value": value, "limit": limit}
    return correct, rows


def lines(rows: dict) -> Iterable[str]:
    """The compared numbers, one line each, for standard error."""
    for name, r in rows.items():
        yield f"check {name} {r['value']!r} limit {r['limit']!r}"
