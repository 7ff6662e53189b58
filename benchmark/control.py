"""The control of ``correct``: the plain reference put in the program's
place, computed in bfloat16, the precision below the float32 every
configuration states. It must come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --calls N [--dtype bfloat16]

For each seed, the cell's generator makes the cell's inputs as a run
does (the same pool of targets, the same frames), the plain PSO of
``reference/pso.py`` in ``--dtype`` answers ``--calls`` calls in the
program's place, and the cell's own comparison judges them. Prints one
JSON line a seed with the compared numbers and ``correct``. It runs on
a card when one is visible, else on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class Answer:
    """A control's answer in the shape of the port's ``SolveResult``."""

    def __init__(self, angles, effector_error, pose):
        self.angles, self.effector_error, self.pose = angles, effector_error, pose


def control_solver(model, r: dict, dtype, chunk: int):
    """``(problem, generator) -> Answer``: recipe ``r``'s plain PSO in
    ``dtype``, warm from each swarm's pose, reported as float32."""
    import torch

    from benchmark.reference import pso

    def solve(problem, generator):
        anchor = problem.pose[:, 1:].reshape(problem.pose.shape[0], -1)
        angles, err = pso.solve(model, r, problem.targets, anchor, generator, dtype=dtype,
                                chunk=chunk)
        angles = angles.float()
        pose = torch.cat([problem.pose[:, :1], angles.reshape(problem.pose[:, 1:].shape)], 1)
        return Answer(angles, err.float(), pose)

    return solve


def run_control(cell: str, seed: int, calls: int, device, dtype, *, seconds: float = None,
                params: dict = None, recipe: dict = None, chunk: int = 65536) -> dict:
    """The cell's comparison of ``calls`` calls answered by the control."""
    import torch

    from benchmark.core import loader
    from benchmark.core.trace import Tracer
    from benchmark.reference import check, fk

    device = torch.device(device)
    wl, cfg, traffic = loader.cell(cell, params, recipe)
    r = cfg["recipes"][wl["recipe"]]
    if seconds is None:
        seconds = loader.manifest()["run_seconds"]
    c = traffic.Cell(cfg, wl, seed, seconds, device, Tracer(False))
    model = fk.Model(cfg["model"], device, dtype)
    c.setup(solver=control_solver(model, r, dtype, chunk), warmup=False)
    t0 = time.perf_counter()
    for i in range(calls):
        (c.step if hasattr(c, "step") else c.solve_call)(i)
    spent = time.perf_counter() - t0
    c.release()
    # A frame cell's control rarely finishes a batch: its open batch counts.
    numbers = c.check(include_open=True) if hasattr(c, "step") else c.check()
    correct, rows = check.compare(numbers, wl["check"]["limits"])
    return {"cell": cell, "seed": seed, "dtype": str(dtype).replace("torch.", ""),
            "calls": calls, "seconds": spent, "correct": correct, "numbers": numbers,
            "check": rows}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--calls", type=int, required=True, help="calls answered a seed")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float16", "float32"))
    ap.add_argument("--chunk", type=int, default=65536, help="swarms a plain PSO call holds")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_control(args.workload, seed, args.calls, device,
                          getattr(torch, args.dtype), chunk=args.chunk)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
