"""A plain particle-swarm solver: the reference put in the program's
place, in any float dtype (the control runs it in bfloat16).

The algorithm of the configuration's recipe, as the upstream states it:
warm init (every particle at its swarm's anchor pose, velocities uniform
in ``[-scale, scale)``), then each iteration ``v = w(*U) v + c1 U
(lbest - x) + c2 U (gbest - x)``, ``x = clamp(x + v, lo, hi)``, the
lbest and the first-minimum gbest. The cost is ``fk.fitness``. Draws are
float32 ``torch.rand`` rounded to the dtype. No polish and no retries:
those only refine what the PSO finds. Swarms run in chunks, which does
not change any swarm's answer's arithmetic.
"""

from __future__ import annotations

import torch

from benchmark.reference import fk


def _inertia(r: dict, it: int) -> float:
    if "inertia_end" in r:
        return r["inertia"] + (r["inertia_end"] - r["inertia"]) * it / max(r["iterations"] - 1, 1)
    return r["inertia"]


def solve(model: fk.Model, r: dict, targets: torch.Tensor, anchor: torch.Tensor,
          generator: torch.Generator, dtype=torch.bfloat16, chunk: int = 4096):
    """``(angles (S, D), reported error (S,))`` of recipe ``r``'s PSO for
    ``(S, E, 3)`` targets from ``(S, D)`` anchor angles, every operation
    in ``dtype``; the reported error is the dtype's own FK error."""
    if r["init_mode"] != "warm" or r.get("rekick_interval"):
        raise ValueError("the plain solver runs warm init without re-kicks")
    angles, errors = [], []
    for i in range(0, targets.shape[0], chunk):
        a, e = _solve_chunk(model, r, targets[i:i + chunk], anchor[i:i + chunk],
                            generator, dtype)
        angles.append(a)
        errors.append(e)
    return torch.cat(angles), torch.cat(errors)


def _solve_chunk(model, r, targets, anchor, generator, dtype):
    s, d = anchor.shape
    p = r["particles"]
    dev = targets.device

    def rand():
        return torch.rand((s, p, d), generator=generator, device=dev,
                          dtype=torch.float32).to(dtype)

    lo, hi = model.lo.to(dev, dtype), model.hi.to(dev, dtype)
    anchor = anchor.to(dtype)
    x = anchor[:, None, :].expand(s, p, d).clone()
    scale = r["init_velocity_scale"]
    v = rand() * (2 * scale) - scale
    lbest = x.clone()
    lval = fk.fitness(model, x, targets, anchor, r["angle_weight"])
    gval, gidx = lval.min(dim=1)
    gbest = lbest[torch.arange(s, device=dev), gidx]
    randomized = r["inertia_mode"] == "randomized"
    for it in range(r["iterations"]):
        w = _inertia(r, it)
        inertia = w * rand() * v if randomized else w * v
        v = (inertia + r["cognitive"] * rand() * (lbest - x)
             + r["social"] * rand() * (gbest[:, None, :] - x))
        x = torch.minimum(torch.maximum(x + v, lo), hi)
        f = fk.fitness(model, x, targets, anchor, r["angle_weight"])
        better = f < lval
        lval = torch.where(better, f, lval)
        lbest = torch.where(better[..., None], x, lbest)
        cval, cidx = lval.min(dim=1)
        take = cval < gval
        gval = torch.where(take, cval, gval)
        gbest = torch.where(take[:, None], lbest[torch.arange(s, device=dev), cidx], gbest)
    return gbest, fk.effector_error(model, gbest, targets)
