"""The scan step's drawing instantiation in design variants, side by side on
the card: each variant is scan_step.cu built from an edited copy of
``ikpso_tpu_torch/csrc`` (nvcc with the port's flags), its ptxas registers
and spills printed, and its drawing launch timed by CUDA events in turns
(v1, v2, ..., then in reverse) at the scan path's shape (arm_7dof,
S=16,384, P=1,024, step 31 of 60) and the experiment's (reference_arm,
S=128, P=16,384, step 8 of 15), every variant's output held bit for bit to
the first's.

Variants: ``final`` (the sources as they are), ``blocks256`` (at most 256
threads a block), ``keys_per_call`` (each Philox call runs its own key
schedule instead of the plane calls in lockstep), ``first`` (both: the
first design of the drawing step).

Run from the repository root on a machine with a card:
``python3 tools/scan_step_variants.py``.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ikpso_tpu_torch.utils import kernels  # noqa: E402

PER_CALL = "#pragma unroll\n    for (uint4& w : c) w = philox4x32_10(w, key);"


def edit(text: str, name: str) -> str:
    """scan_step.cuh for variant ``name``."""
    if name in ("blocks256", "first"):
        text = text.replace("constexpr int kStepMaxThreads = 128;",
                            "constexpr int kStepMaxThreads = 256;")
        text = re.sub(r"static_assert\(step_threads\(9\).*?\n.*?\n", "", text)
    if name in ("keys_per_call", "first"):
        assert text.count("philox4x32_10_n(c, key);") == 4
        text = text.replace("philox4x32_10_n(c, key);", PER_CALL)
    return text


VARIANTS = ("final", "blocks256", "keys_per_call", "first")


def build(out: Path) -> dict:
    """Every variant's library, all nvcc processes at once."""
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for v in VARIANTS:
        d = out / v
        shutil.copytree(kernels.CSRC, d)
        (d / "scan_step.cuh").write_text(edit((d / "scan_step.cuh").read_text(), v))
        so = d / "lib.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
               str(d / "scan_step.cu")]
        procs[v] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    filt = str(Path(kernels._nvcc()).with_name("cu++filt"))
    libs = {}
    for v, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{log[-3000:]}")
        chunks = log.split("Compiling entry function '")[1:]
        names = subprocess.run([filt, *(c.split("'")[0] for c in chunks)],
                               capture_output=True, text=True).stdout.splitlines()
        rows = []
        for name, chunk in zip(names, chunks):
            regs = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            rows.append([name.split("(")[0].replace("void ikpso::", ""),
                         int(regs.group(1)) if regs else None,
                         int(spill.group(1)) if spill else None])
        print(json.dumps({"variant": v, "ptxas": rows}), flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, sig in kernels.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = sig
                getattr(lib, fn).restype = ctypes.c_int
        libs[v] = lib
    return libs


def time_shape(libs, model, swarms, particles, step, argv, reps=20):
    """The drawing step of each variant at ``step`` of a solve, in turns."""
    from chip_smoke import _cli_config, _problem, _states_equal
    from ikpso_tpu_torch.harness.scan import scan_configs
    from ikpso_tpu_torch.ops import fk as fk_ops
    from ikpso_tpu_torch.ops.fitness_kernel import make_kernel_fitness
    from ikpso_tpu_torch.pso import solver

    device = torch.device("cuda", 0)
    if argv is None:
        pso, fit = scan_configs()
    else:
        cfg = _cli_config(device, argv)[0]
        pso, fit = cfg.pso, cfg.fitness
    spec, batched = _problem(model, swarms, np.random.default_rng(13), device)
    fitness = make_kernel_fitness(spec, batched, fit)
    gen = torch.Generator(device=device).manual_seed(13)
    lo, hi = spec.limits().to(device)
    limits = torch.stack((lo, hi)).contiguous()
    state = solver.step_buffers(solver.init_swarm(
        gen, fk_ops.pose_to_angles(spec, batched.pose), particles, fitness, pso,
        limits=(lo, hi)))
    seeds = solver.step_seeds(gen, swarms, device)
    work = solver.step_work(swarms, particles, device)
    for it in range(step - 1):
        state = solver.scan_step(fitness, *state, None, limits, pso, iteration=it, work=work,
                                 seeds=seeds)
    snap = tuple(t.clone() for t in state)
    real = kernels.library

    def timed(v):
        ms = []
        kernels.library = lambda: libs[v]
        try:
            for _ in range(reps + 1):
                for a, b in zip(state, snap):
                    a.copy_(b)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda._sleep(2_000_000)
                start.record()
                out = solver.scan_step(fitness, *state, None, limits, pso, iteration=step - 1,
                                       work=work, seeds=seeds)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
        finally:
            kernels.library = real
        return ms[1:], tuple(t.clone() for t in out)

    runs, ref = {v: [] for v in VARIANTS}, None
    for v in VARIANTS + VARIANTS[::-1]:
        ms, out = timed(v)
        runs[v].append(float(np.mean(ms)))
        ref = out if ref is None else ref
        if not _states_equal(ref, out):
            raise AssertionError(f"variant {v} disagrees with {VARIANTS[0]} at {model}")
    print(json.dumps({"shape": f"{model} S={swarms} P={particles} step {step}",
                      "turn_means_ms": runs,
                      "ms": {v: float(np.mean(r)) for v, r in runs.items()}}), flush=True)


def main():
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("tools/scan_step_variants.py needs a card")
    libs = build(ROOT / "build" / "scan_step_variants")
    time_shape(libs, "arm_7dof", 16_384, 1024, 31, None)
    time_shape(libs, "reference_arm", 128, 16_384, 8,
               ["experiment", *chip_smoke.EXPERIMENT_ARGS,
                *chip_smoke.EXPERIMENT_PROTOCOLS["iter3"]])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout,
          flush=True)


if __name__ == "__main__":
    main()
