"""One run of one cell of the benchmark of ``ikpso_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root, on a machine with an NVIDIA card: loads the
port and its kernels (built into ``build/`` inside the checkout on its
first run), makes the cell's inputs on the card from ``--seed``, warms
up with one call, runs the closed loop for ``--seconds`` (``--trace 1``:
under ``torch.profiler``), then judges every answer against the plain
reference (``benchmark/reference``) and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``, each compared number with its limit
(also the last lines of standard error, after the numbers read but not
compared). Exits non-zero, printing no
result, without a card, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ikpso_tpu")


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (``/proc``), or now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(float(line.split()[1]) for line in fh if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Every build and kernel cache at a fixed path inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def fixed_hash_seed(argv: list):
    """Start this script again, in the same process, with
    ``PYTHONHASHSEED=0`` unless it has it: the hashes of strings, and with
    them the layout of every dict and set, are then the same from process
    to process, and so is a host-paced call's time (a frame cell's rate
    spread 4.4% between processes with random seeds, 1% with a fixed one;
    ``PERF.md``). The process keeps its start, so ``setup_s`` counts this."""
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})


def steady_host(pin: bool):
    """Before the window: set-up's objects frozen out of the garbage
    collector's scans and, with ``pin``, the calling thread held on one CPU
    (the last this process may use), so that the host's part of each call
    does not move with where the scheduler puts the thread. Returns what
    undoes both."""
    gc.collect()
    gc.freeze()
    allowed = os.sched_getaffinity(0)
    if pin:
        os.sched_setaffinity(0, {max(allowed)})

    def undo():
        os.sched_setaffinity(0, allowed)
        gc.unfreeze()

    return undo


def run(cell: str, seed: int, seconds: float, trace: bool, device, *,
        params: dict = None, recipe: dict = None, chips: int = 1) -> dict:
    """One run of ``cell`` on ``device``; the result line as a dict.
    ``params`` and ``recipe`` override the cell's parameters and its
    recipe's (the CPU rehearsal's tiny sizes)."""
    import torch

    from benchmark.core import loader
    from benchmark.core.trace import Tracer
    from benchmark.reference import check

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    wl, cfg, traffic = loader.cell(cell, params, recipe)
    readers = {m["name"]: (m, loader.module("metrics", m["name"]))
               for m in loader.cell_metrics(cell, trace)}

    tracer = Tracer(trace, wl["params"].get("trace_calls"))
    cellobj = traffic.Cell(cfg, wl, seed, seconds, device, tracer)
    cellobj.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # A traced run leaves the thread free: the profiler's own threads,
    # started from it, would share its CPU.
    undo = steady_host(pin=device.type == "cuda" and not trace)
    tracer.start()
    setup_s = time.time() - T_START
    window = cellobj.run_window()
    tracer.finish()
    undo()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"error: loaded in this process: {', '.join(found)}")
    tracer.read()

    r = cfg["recipes"][wl["recipe"]]
    # What a metric's reader may read.
    ctx = SimpleNamespace(window=window, setup_s=setup_s, trace=tracer.trace, cell=cellobj,
                          config=cfg, workload=wl, recipe=r, device=device,
                          dof=3 * (len(cfg["model"]["parent"]) - 1))
    metrics = {}
    for name, (entry, reader) in readers.items():
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": entry["unit"]}

    cellobj.release()
    numbers = cellobj.check()
    correct, rows = check.compare(numbers, wl["check"]["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if tracer.trace is not None:
        dev["busy_s"] = tracer.trace.busy_s()
        dev["window_s"] = tracer.trace.window_s
    out = {"correct": bool(correct), "attempted": cellobj.attempted(),
           "failed": int(numbers["failed"] + numbers["missing"]), "metrics": metrics,
           "device": dev}
    if tracer.trace is not None:
        out["breakdown"] = tracer.trace.breakdown()
    print(f"uncompared {json.dumps({k: v for k, v in numbers.items() if k not in rows})}",
          file=sys.stderr)
    out["check"] = rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="the cell, e.g. arm7.scan")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a non-negative integer")

    import torch

    from benchmark.core import loader

    cells = {w["name"]: w for w in loader.manifest()["workloads"]}
    if args.workload not in cells:
        ap.error(f"--workload: {args.workload!r} is not a cell of BENCHMARK.json "
                 f"({', '.join(cells)})")
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), chips=chips)
    found = forbidden_modules()
    if found:
        print(f"error: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    from benchmark.reference.check import lines

    for line in lines(out["check"]):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    fixed_hash_seed(sys.argv)
    sys.exit(main())
