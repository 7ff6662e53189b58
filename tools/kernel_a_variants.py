"""Kernel A's short chains in design variants, side by side on the card.

Each variant is kernel A's prebuilt entry (``fused_solve.cu`` with
``fused_solve_short.cu``) built from an edited copy of
``ikpso_tpu_torch/csrc`` with the port's nvcc flags; its ptxas registers and
spills are printed, and each short-chain case is timed by CUDA events in
turns (v1, v2, ..., then in reverse, ``--rounds`` times), every variant's
output held bit for bit to the first's.

Variants: ``final`` (the sources as they are: the 256-thread instantiation
at its ``ShortMinBlocks``), ``bound_1024`` (the sources as they are, at
the 1,024-thread instantiation), ``min_blocks_<n>`` (the 256-thread
instantiation with one least block count an SM for every collider, so one
register cap), ``per_evaluation_constants`` (the walk's constants loaded
as float4 an evaluation instead of held in registers for the whole solve;
``_1024``: at the 1,024-thread instantiation), ``no_canon`` (the run-time
update branches where the canonical instantiation would run), and with
``--parent DIR`` the kernel A of another checkout
(``DIR/ikpso_tpu_torch/csrc``).

Cases: the headline (arm_7dof, S=1,048,576, P=128, 8 iterations), planar_3dof
at its preset (S=1,048,576), arm_7dof's box and capsule scenes and arm_6dof
with the orientation term and the re-kick (S=65,536, the timing phase's
shapes).

Run from the repository root on a machine with a card:
``python3 tools/kernel_a_variants.py [--parent DIR] [--rounds N]``.
"""

import argparse
import ctypes
import dataclasses
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

import chip_smoke  # noqa: E402
from ikpso_tpu_torch.utils import kernels  # noqa: E402


def edit(text: str, name: str) -> str:
    """fused_solve.cuh for the library of variant ``name``."""
    m = re.search(r"min_blocks_(\d)", name)
    if m:
        old = "TH != kShortThreads ? 1 : C == kBoxCollider ? 2 : 3;"
        assert old in text
        text = text.replace(old, f"TH != kShortThreads ? 1 : {m.group(1)};")
    if name == "per_evaluation_constants":
        old = "  auto eval = [&](const float (&xe)[D]) {\n"
        assert old in text
        text = text.replace(old, old + "    load4(c_sw, sh.sw);\n    load4(c_meta, sh.meta);\n")
    if name == "no_canon":
        old = "constexpr bool kCanon = TH == kShortThreads;"
        assert old in text
        text = text.replace(old, "constexpr bool kCanon = false;")
    return text


# (variant, its library, whether it runs the 1,024-thread instantiation)
VARIANTS = (("final", "final", False), ("bound_1024", "final", True),
            ("min_blocks_2", "min_blocks_2", False), ("min_blocks_3", "min_blocks_3", False),
            ("per_evaluation_constants", "per_evaluation_constants", False),
            ("per_evaluation_constants_1024", "per_evaluation_constants", True),
            ("no_canon", "no_canon", False))
BUILT = tuple(dict.fromkeys(lib for _, lib, _ in VARIANTS))


def build(out: Path, parent):
    """Every variant's library, all nvcc processes at once; the SASS of each
    library lands beside it."""
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for v in BUILT + (("parent",) if parent else ()):
        d = out / v
        shutil.copytree(Path(parent) / "ikpso_tpu_torch" / "csrc" if v == "parent"
                        else kernels.CSRC, d)
        srcs = [d / "fused_solve.cu"]
        if v != "parent":
            (d / "fused_solve.cuh").write_text(edit((d / "fused_solve.cuh").read_text(), v))
            srcs.append(d / "fused_solve_short.cu")
        so = d / "lib.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
               *map(str, srcs)]
        procs[v] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    objdump = str(Path(kernels._nvcc()).with_name("cuobjdump"))
    libs = {}
    for v, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{log[-3000:]}")
        rows = [[r["kernel"], r.get("registers"), r.get("spill_stores")]
                for r in chip_smoke.ptxas_report(log)
                if re.search(r"Topology<(4, 8448|3, 256)", r["kernel"])]
        print(json.dumps({"variant": v, "ptxas": rows}), flush=True)
        sass = subprocess.run([objdump, "-sass", str(so)], capture_output=True, text=True)
        (so.parent / "lib.sass").write_text(sass.stdout)
        lib = ctypes.CDLL(str(so))
        for fn, sig in kernels.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = sig
                getattr(lib, fn).restype = ctypes.c_int
        libs[v] = chip_smoke._NoBoundLibrary(lib) if v == "parent" else lib
    return libs


def cases(device):
    """``{name: (fn, reps)}``: each a fused_solve call on its inputs."""
    from ikpso_tpu_torch.pso.fused import fused_solve

    rng = np.random.default_rng(4)
    out = {}
    pso, fit = chip_smoke._headline_configs()

    def seeds(s):
        return torch.as_tensor(rng.integers(-2**31, 2**31, (s, 2), dtype=np.int64)
                               .astype(np.int32), device=device)

    spec, batched = chip_smoke._problem("arm_7dof", chip_smoke.HEADLINE_SWARMS, rng, device)
    meta, swarm = chip_smoke._packed(spec, batched, fit)
    args = (spec, pso, fit, meta, swarm, spec.limits(), seeds(chip_smoke.HEADLINE_SWARMS), 128)
    out["headline S=1048576"] = (lambda args=args: fused_solve(*args), 5)
    pre, pso_p, fit_p, spec_p, meta_p, swarm_p, lim_p, seeds_p = chip_smoke._tree_setup(
        "planar_3dof", chip_smoke.TREE_SWARMS["planar_3dof"], rng=rng, device=device)
    args_p = (spec_p, pso_p, fit_p, meta_p, swarm_p, lim_p, seeds_p, pre.particles)
    out["planar_3dof S=1048576"] = (lambda: fused_solve(*args_p), 5)
    spec, batched = chip_smoke._problem("arm_7dof", chip_smoke.TIMING_SWARMS, rng, device)
    obs = chip_smoke._scene(spec, device)
    s_t = seeds(chip_smoke.TIMING_SWARMS)
    for shape in ("box", "capsule"):
        fit_s = dataclasses.replace(fit, collision_shape=shape)
        meta_s, swarm_s = chip_smoke._packed(spec, batched, fit_s, obs)
        args_s = (spec, pso, fit_s, meta_s, swarm_s, spec.limits(), s_t, 128)
        out[f"{shape} S=65536"] = (
            lambda args_s=args_s: fused_solve(*args_s, num_obstacles=obs.count), 10)
    pso_o, fit_o = chip_smoke._orientation_configs()
    spec_o, batched_o = chip_smoke._problem("arm_6dof", chip_smoke.TIMING_SWARMS, rng, device,
                                   orientation=True)
    meta_o, swarm_o = chip_smoke._packed(spec_o, batched_o, fit_o, use_orientation=True)
    args_o = (spec_o, pso_o, fit_o, meta_o, swarm_o, spec_o.limits(), s_t, 128)
    out["orientation S=65536"] = (lambda: fused_solve(*args_o, use_orientation=True), 10)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose kernel A runs beside")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools/kernel_a_variants.py needs a card")
    libs = build(ROOT / "build" / "kernel_a_variants", args.parent)
    device = torch.device("cuda", 0)
    variants = {name: (lib, bound) for name, lib, bound in VARIANTS}
    if args.parent:
        variants["parent"] = ("parent", True)
    order = list(variants)
    real = (kernels.library, kernels.SHORT_THREADS)

    def use(v):
        lib, bound_1024 = variants[v]
        kernels.library = lambda: libs[lib]
        kernels.SHORT_THREADS = 0 if bound_1024 else real[1]

    for name, (fn, reps) in cases(device).items():
        ms, ref = {v: [] for v in order}, None
        for r in range(args.rounds):
            for v in order if r % 2 == 0 else order[::-1]:
                use(v)
                try:
                    t, out = chip_smoke.cuda_time(fn, reps=reps)
                finally:
                    kernels.library, kernels.SHORT_THREADS = real
                ms[v].append(t)
                ref = out if ref is None else ref
                if not (torch.equal(ref[0], out[0]) and torch.equal(ref[1], out[1])):
                    raise AssertionError(f"variant {v} disagrees with {order[0]} on {name}")
        print(json.dumps({"case": name, "ms": ms,
                          "mean_ms": {v: float(np.mean(t)) for v, t in ms.items()}}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout,
          flush=True)


if __name__ == "__main__":
    main()
