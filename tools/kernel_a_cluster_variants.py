"""Kernel A's cluster layout in design variants, side by side on the card.

Kernel A's cluster layout (``ikpso_tpu_torch/csrc/fused_solve_cluster.cuh``:
x in registers, v and lbest in the shared memory of a cluster of blocks a
swarm) runs the on-demand trees of 46-60 DOFs that branch
(``utils/kernels.py::on_demand_key``, ``tree_cluster``). The serial chains keep the scratch
layout; their cluster source, ``tools/kernel_a_cluster_serial.cu`` (a walk
unrolled to 51 nodes), is built here only, and launched in place of
``pso/fused.py::_launch_serial``. Each variant runs the same solves through
``pso/fused.py``'s wrapper; the cases are timed by CUDA events in turns
(v1, v2, ..., then in reverse, ``--rounds`` times) and every variant's
output is held bit for bit to the first's. The ptxas lines of the built
sources and keys and one trip of the serial source's PSO loop in SASS
(``chip_smoke.sass_loop_mix``) are printed first.

Variants: ``final`` (the sources and the layout rules as they are: the
serial chains and snake20_box in the scratch layout, the trees that
branch in the cluster layout at the least cluster that holds them),
``cluster`` / ``cluster_c4`` (a serial chain in the cluster layout at the
least cluster whose blocks hold v and lbest, or at four blocks),
``lb_global`` (a serial chain in one block of the swarm's 256 threads, v
in shared memory, lbest in a global scratch of the resident blocks: the
source built with ``IKPSO_CLUSTER_LB_GLOBAL`` against a copy of the
cluster header whose lbest rows start there), ``c4`` and ``scratch`` (a
tree in one block or over four, and in its scratch layout), and with ``--parent
DIR`` the kernel A of another checkout (``DIR/ikpso_tpu_torch/csrc``, its
own layout).

Cases: snake:50, snake:35, snake:20 and snake:16 at their preset
(S=65,536, P=256, 4 iterations); hand21 (the config document's recipe,
S=16,384, P=512, 60 iterations), hand21_p256 (the same at P=256, where
the rule keeps the scratch layout), snake20_box (``chip_smoke.py``'s
on-demand case: snake:20 among boxes, P=256, S=16,384) and hand16,
hand21 less its last finger (17 nodes, 48 DOFs, the same recipe and
swarms).

Run from the repository root on a machine with a card:
``python3 tools/kernel_a_cluster_variants.py [--parent DIR] [--rounds N]
[--cases MODEL ...]``.
"""

import argparse
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

import chip_smoke  # noqa: E402
from ikpso_tpu_torch.pso import fused  # noqa: E402
from ikpso_tpu_torch.utils import kernels  # noqa: E402

SERIAL_SOURCE = ROOT / "tools" / "kernel_a_cluster_serial.cu"
SERIAL_CASES = (("snake:50", 65_536), ("snake:35", 65_536), ("snake:20", 65_536),
                ("snake:16", 65_536))
TREE_SWARMS = 16_384
_VP, _I = ctypes.c_void_p, ctypes.c_int
SERIAL_SIGNATURES = {
    "ikpso_fused_solve_serial_cluster": [
        _I, _I, _I, _I,  # replay, cluster size, init mode, nodes
        _VP, _I, _VP, _I,  # meta, M, swarm, K
        *kernels._UPDATE,
        _VP, _I,  # lbest scratch (null: lbest in shared memory), clusters
        _VP, _VP, _I, _I, _VP,  # out gbest, out gval, S, P, stream
    ],
    # replay, cluster size, P, M, K, nodes
    "ikpso_fused_solve_serial_cluster_blocks": [_I, _I, _I, _I, _I, _I],
    "ikpso_serial_cluster_bucket": [],
}
# The cluster header's lbest rows, and where the lb_global build puts them.
LB_ROWS = "  float* lb_rows = smem + cluster_head_floats(M, K, D) + Pb * R;\n"
LB_ROWS_GLOBAL = ("  float* lb_rows = ::ikpso_lb_scratch + "
                  "static_cast<long long>(blockIdx.x) * Pb * R;\n")


def lb_global_header(out: Path) -> Path:
    """A directory holding ``fused_solve_cluster.cuh`` with its lbest rows
    in the global scratch at ``ikpso_lb_scratch``."""
    text = (kernels.CSRC / "fused_solve_cluster.cuh").read_text()
    if text.count(LB_ROWS) != 1:
        raise RuntimeError("fused_solve_cluster.cuh: its lbest rows moved; update LB_ROWS")
    out.mkdir(parents=True, exist_ok=True)
    (out / "fused_solve_cluster.cuh").write_text(text.replace(LB_ROWS, LB_ROWS_GLOBAL))
    return out


def ptxas_rows(log, match=None):
    return [[r["kernel"], r.get("registers"), r.get("spill_stores")]
            for r in chip_smoke.ptxas_report(log) if match is None or match in r["kernel"]]


def build(out: Path, parent):
    """The serial-chain cluster source in its two lbest placements and, with
    ``parent``, that checkout's prebuilt library, all nvcc processes at
    once; their ptxas lines and the serial source's PSO loop in SASS are
    printed."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    include = {"cluster": [], "lb_global": ["-DIKPSO_CLUSTER_LB_GLOBAL=1", "-I",
                                             str(lb_global_header(out / "lb_global_include"))]}
    procs = {v: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-I", str(kernels.CSRC), "-shared",
         "-o", str(out / f"{v}.so"), str(SERIAL_SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v, flags in include.items()}
    libs = {}
    if parent:
        with chip_smoke._sources(parent) as other:
            other_lib = other.library.__wrapped__()
            log = other.library_path().with_suffix(".log").read_text()
        print(json.dumps({"variant": "parent", "ptxas": ptxas_rows(log, "serial")}), flush=True)
        if not hasattr(other_lib, "ikpso_kernel_a_smem_bytes"):
            other_lib = chip_smoke._OlderLibrary(other_lib)
        if not hasattr(other_lib, "ikpso_kernel_a_short_threads"):
            other_lib = chip_smoke._NoBoundLibrary(other_lib)
        libs["parent"] = other_lib
    objdump = str(Path(kernels._nvcc()).with_name("cuobjdump"))
    for v, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{log[-3000:]}")
        sass = chip_smoke.run([objdump, "-sass", str(out / f"{v}.so")])
        loops = {f: chip_smoke.sass_loop_mix(sass, f, nested=True)
                 for f in re.findall(r"Function : (\S+)", sass)
                 if "serial_cluster_kernelILb0E" in f}
        print(json.dumps({"variant": v, "ptxas": ptxas_rows(log), "philox_loop": loops}),
              flush=True)
        lib = ctypes.CDLL(str(out / f"{v}.so"))
        for fn, sig in SERIAL_SIGNATURES.items():
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = ctypes.c_int
        libs[v] = lib
    return libs


def serial_cluster_launch(lib, c=None, lb_global=False):
    """``pso/fused.py::_launch_serial`` in the cluster layout of ``lib``
    (the serial source): ``c`` blocks a swarm (None: the least cluster
    whose blocks hold v and lbest, ``kernels.cluster_size``), with
    ``lb_global`` one block a swarm and lbest in a global scratch of
    ``P / c`` rows of ``cluster_row(D)`` floats a resident block."""
    def launch(spec, init_mode, replay, meta, swarm, update, gbest, gval, p, layout):
        s, d, m, k = swarm.shape[0], spec.dof, meta.numel(), swarm.shape[1]
        cl = 1 if lb_global else c or kernels.cluster_size(d, p, m, k)
        clusters = lib.ikpso_fused_solve_serial_cluster_blocks(replay, cl, p, m, k,
                                                               spec.num_nodes)
        if clusters <= 0:
            raise RuntimeError(f"no cluster of the serial source fits at D={d}, P={p}, c={cl}")
        clusters = min(s, clusters)
        scratch = None
        if lb_global:
            d4 = (d + 3) // 4 * 4
            row = d4 if d4 // 4 % 2 else d4 + 4
            scratch = torch.empty((clusters * cl, p // cl, row), dtype=torch.float32,
                                  device=swarm.device)
        rc = lib.ikpso_fused_solve_serial_cluster(
            replay, cl, init_mode, spec.num_nodes, meta.data_ptr(), m, swarm.data_ptr(), k,
            *update, None if scratch is None else scratch.data_ptr(), clusters,
            gbest.data_ptr(), gval.data_ptr(), s, p, kernels.stream_ptr(swarm.device))
        kernels.check(rc, "fused_solve")
    return launch


def fits(use, p):
    """Whether a variant runs at ``p`` particles: a tree's cluster of c
    blocks needs P / c <= CLUSTER_THREADS threads a block."""
    c = getattr(use, "cluster", 0)
    return not c or p // c <= kernels.CLUSTER_THREADS


# The module attributes a variant may replace, put back after each call.
PATCHED = ((kernels, "library"), (kernels, "on_demand_library"), (kernels, "tree_cluster"),
           (fused, "_launch_serial"))


def variants(libs, parent_od):
    """``{name: (serial use, tree use)}``: each a function of the case that
    puts the variant's libraries and rules in place, None where the variant
    does not apply to the case."""
    def serial(lib, c=None, lb_global=False):
        def use(case):
            fused._launch_serial = serial_cluster_launch(libs[lib], c, lb_global)
        return use

    def tree(c):
        def use(case):
            kernels.tree_cluster = lambda *a: c
        use.cluster = c
        return use

    def parent_serial(case):
        kernels.library = lambda: libs["parent"]

    def parent_tree(case):
        kernels.tree_cluster = lambda *a: 0
        kernels.on_demand_library = lambda key: parent_od[case]

    out = {"final": (lambda case: None, lambda case: None),
           "cluster": (serial("cluster"), None),
           "cluster_c4": (serial("cluster", 4), None),
           "lb_global": (serial("lb_global", lb_global=True), None),
           "c1": (None, tree(1)), "c4": (None, tree(4)), "scratch": (None, tree(0))}
    if "parent" in libs:
        out["parent"] = (parent_serial, parent_tree)
    return out


def hand16(device, swarms, rng):
    """hand21's config document less its last finger: ``(spec, pso, fit,
    particles, meta, swarm)`` at ``swarms`` reachable targets."""
    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.models.chain import IKProblem, make_chain_spec
    from ikpso_tpu_torch.ops import fk as fk_ops

    cfg = chip_smoke._config("hand21", device)
    full, base, n = cfg.spec, cfg.problem, 17
    spec = make_chain_spec(full.parent[:n], full.length[:n].cpu(),
                           full.min_rotation[:n].cpu(), full.max_rotation[:n].cpu(),
                           [4, 8, 12, 16], full.effector_weight[:n].cpu(), device=device)
    base = IKProblem(pose=base.pose[..., :n, :], origin=base.origin,
                     targets=base.targets[..., :4, :])
    lim = spec.limits().cpu().numpy()
    ang = (lim[0] + rng.random((swarms, spec.dof)) * (lim[1] - lim[0])).astype(np.float32)
    pose = fk_ops.angles_to_pose(spec, base.pose[0].expand(swarms, 3),
                                 torch.as_tensor(ang, device=device))
    batched = library.batched_problem(
        base, fk_ops.fk_points(spec, pose, base.origin)[:, list(spec.effector_idx)])
    meta, swarm = chip_smoke._packed(spec, batched, cfg.fitness)
    return spec, cfg.pso, cfg.fitness, cfg.num_particles, meta, swarm


def tree_key(spec, fit, n_obs):
    topo, collider, orient = kernels.kernel_variant(
        spec, n_obs, fit.collision_shape, False, fused.uses_distance(fit), fit.trig_impl)
    assert topo == kernels.ON_DEMAND
    return kernels.on_demand_key(spec, collider, orient, fused.uses_distance(fit),
                                 fit.trig_impl == "exact")


def cases(device):
    """``{name: (fn, kind, key, particles)}``: each a fused_solve call on
    its inputs, ``kind`` "serial" or "tree", ``key`` a tree's on-demand
    key."""
    rng = np.random.default_rng(4)
    out = {}
    for model, swarms in SERIAL_CASES:
        pre, pso, fit, spec, meta, swarm, lim, seeds = chip_smoke._tree_setup(
            model, swarms, rng=rng, device=device)
        args = (spec, pso, fit, meta, swarm, lim, seeds, pre.particles)
        out[f"{model} S={swarms}"] = (lambda args=args: fused.fused_solve(*args), "serial",
                                      None, pre.particles)
    spec, pso, fit, p, meta, swarm, _, _ = chip_smoke.od_case("hand21", device, TREE_SWARMS,
                                                              rng, philox=True)
    # hand21 at 256 particles too, and snake20_box (a chain, P = 256).
    box = chip_smoke.od_case("snake20_box", device, TREE_SWARMS, rng, philox=True)
    trees = {"hand21": (spec, pso, fit, p, meta, swarm, 0),
             "hand21_p256": (spec, pso, fit, 256, meta, swarm, 0),
             "snake20_box": (*box[:6], box[6].count),
             "hand16": (*hand16(device, TREE_SWARMS, rng), 0)}
    for name, (spec, pso, fit, p, meta, swarm, n_obs) in trees.items():
        seeds = torch.as_tensor(rng.integers(-2**31, 2**31, (TREE_SWARMS, 2), dtype=np.int64)
                                .astype(np.int32), device=device)
        args = (spec, pso, fit, meta, swarm, spec.limits(), seeds, p, None, n_obs)
        out[f"{name} S={TREE_SWARMS}"] = (lambda args=args: fused.fused_solve(*args), "tree",
                                          tree_key(spec, fit, n_obs), p)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose kernel A runs beside")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cases", nargs="+", help="the models to run (default: every case)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools/kernel_a_cluster_variants.py needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout, flush=True)
    libs = build(ROOT / "build" / "kernel_a_cluster_variants", args.parent)
    device = torch.device("cuda", 0)
    todo = {name: case for name, case in cases(device).items()
            if not args.cases or name.split()[0] in args.cases}
    keys = {name.split()[0]: key for name, (_, kind, key, _) in todo.items() if kind == "tree"}
    for name, key in keys.items():
        assert key.cluster, f"{name} has no cluster layout"
    kernels.prebuild(keys.values())
    for name, key in keys.items():
        log = kernels.on_demand_path(key).with_suffix(".log").read_text()
        print(json.dumps({"key": name, "ptxas": ptxas_rows(log, "fused_solve_tree")}),
              flush=True)
    parent_od = {}
    if args.parent:
        with chip_smoke._sources(args.parent) as other:
            other.prebuild([key._replace(cluster=False) for key in keys.values()])
            for name, key in keys.items():
                parent_od[name] = other.on_demand_library.__wrapped__(key._replace(cluster=False))
    table = variants(libs, parent_od)
    real = [(mod, n, getattr(mod, n)) for mod, n in PATCHED]
    for name, (fn, kind, _, p) in todo.items():
        case = name.split()[0]
        order = [v for v, uses in table.items()
                 if uses[kind == "tree"] is not None and fits(uses[kind == "tree"], p)]
        ms, ref = {v: [] for v in order}, None
        for r in range(args.rounds):
            for v in order if r % 2 == 0 else order[::-1]:
                table[v][kind == "tree"](case)
                try:
                    t, out = chip_smoke.cuda_time(fn, reps=1)
                finally:
                    for mod, n, f in real:
                        setattr(mod, n, f)
                ms[v].append(t)
                ref = out if ref is None else ref
                if not (torch.equal(ref[0], out[0]) and torch.equal(ref[1], out[1])):
                    raise AssertionError(f"variant {v} disagrees with {order[0]} on {name}")
        print(json.dumps({"case": name, "ms": ms,
                          "median_ms": {v: float(np.median(t)) for v, t in ms.items()}}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout,
          flush=True)


if __name__ == "__main__":
    main()
