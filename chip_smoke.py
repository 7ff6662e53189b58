#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``ikpso_tpu_torch``).

Builds the port's CUDA kernels from ``ikpso_tpu_torch/csrc``, checks each
against its plain torch version on the card (kernel B with and without a
scene -- its box and capsule branches bit for bit on three scenes, with
the share of pairs its slab reject decides, and the capsule bisection's
SASS free of int-to-float conversions --, with the orientation term, on
the two trees, on snake_30dof and on the serial-chain variant; kernel A
in replay with every init mode, collider, inertia mode, re-kick and gbest
interval, with orientation, on
the trees, on snake_30dof, the serial-chain variant and reference_arm, and
on exact ties and NaN fitness values, first minimum and NaN first as its
plain twin's torch.argmin, across a cluster's blocks too (hand21's cluster
layout, ptxas and cudaOccupancyMaxActiveClusters in the build line, its
PSO loop's SASS mix);
kernel C likewise, and the scan solve through it in replay; the
tensor-path LM polish on the card against the CPU), drives the main paths
through their entry points -- the 7-DOF headline solve
(``harness.headline.run_headline``, S=1,048,576), the 7-DOF obstacle-scene
solve (``harness.obstacles.run_obstacles``, S=524,288 with box colliders,
S=65,536 with capsules), the 6-DOF position + orientation solve
(``harness.orientation.run_orientation``, S=262,144), the dual-arm tree
(``harness.trees.run_tree``, ``dual_arm_14dof``, S=262,144), the 45-DOF
humanoid tree (``humanoid_45dof``, S=16,384), the rest of the zoo through
``run_tree`` (``planar_3dof`` S=1,048,576, ``reference_arm`` S=262,144,
``snake_30dof`` and ``snake:50`` S=65,536), the scan solver on kernel C
(``harness.scan.run_scan``, S=16,384, P=1,024, 60 iterations), the
reference's own protocol through the CLI (``experiment``: the three
published protocols, frames to converge on reference_arm at P=16,384
through kernel C, against JAX's ``parity_r02``; with ``--polish`` and
``--outdir``, the locality gate and the native diagnostics streams;
``track``: 4,096 circular paths x 100 chained frames through kernel A;
``sweep``: 1,024 waypoints with a checkpoint, cut off and resumed), the
benchmark entry (``python -m ikpso_tpu_torch.bench``: the headline record
at S=1,048,576 with its ``sol_frac``, ``--latency`` and ``--impl pallas``,
three processes at once, their launch counts read from their stderr), this
slice's paths (``gjk``: the GJK colliders against SAT on 524,288 poses and
the GJK document's solve with ``--impl jnp``; ``retries_host``: the
headline batch through the host-gather retries, and one top-k round from
the best pose; ``retries_best``: the headline recipe with every retry
from the best pose, beside JAX's 127 failures, and
``utils.profiling.Timer`` on a solve's result against CUDA events;
``sharded``: two ranks on the card over gloo, the headline
across the swarm axis on kernel A and the scan cell across the particle
axis on kernel C, each shard held bit for bit against its single-process
solve; ``sweep_multihost``: ``cli sweep --multihost`` as two processes;
``viz``) and the roofline (``utils.roofline``: kernels D and E, the kernel C and kernel A
rates, the headline's ``sol_frac``; kernel E against its integer issue
ceiling, its instructions a Philox call read from the SASS) -- with the
launch counts read around
each, times kernel/plain pairs and holds every kernel's time against its
bound (``bounds``). Every phase prints one JSON line; any failure raises
and the script exits non-zero. The last line is ``{"ok": true, "device":
{...}}``.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX and fails without a visible CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

JAX_REFERENCE_FAILURES = "18/1048576"  # JAX reference on the same batch size
REPLAY_ATOL, REPLAY_RTOL, REPLAY_VAL_ATOL = 5e-4, 1e-3, 1e-5  # tests/test_fused.py:257-258
FK_RTOL, FK_ATOL = 1e-5, 1e-6
HEADLINE_SWARMS = 1_048_576  # the arm_7dof preset's batch
OBSTACLE_SWARMS = 524_288  # bench.py --obstacles 4 --swarms 524288
CAPSULE_SWARMS = 65_536  # the capsule pipeline, cut to stay inside the time limit
ORIENTATION_SWARMS = 262_144  # the arm_6dof preset's batch
# JAX's record of the orientation row (bench_records/r2_sweep.jsonl, r2-orient3;
# taken on a TPU, quoted for accuracy only): 100.00% under 1 mm, p90 0.028 deg.
JAX_ORIENTATION = {"frac_under_1mm": 1.0, "p90_orient_err_deg": 0.028}
ORIENT_P90_DEG_BAR = 0.1
# JAX on its own targets (bench_records/r5_sweep.jsonl r5-obst-r3recipe-decay1,
# r5-capsule): the feasible share of the scene.
JAX_FEASIBLE = {"box": 0.9456, "capsule": 0.9572}
FEASIBLE_RANGE = (0.93, 0.96)
MAX_COLLIDING_PER_SWARM = 1e-4
FLT_MAX = 3.4028234663852886e38
# Kernel/plain timing batch: the plain solver's (S, P, D) temporaries
# would not fit in device memory at the headline batch.
TIMING_SWARMS = 65_536
# The scan path (bench.py --impl pallas): its JAX reference is
# `python bench.py --cpu --impl jnp --swarms 4096` (same P, inertia mode
# and iterations; S cut to a quarter to run on a CPU). The bar is that
# share less 4 standard errors of the difference of two binomial shares,
# JAX's over its swarms and the port's over SCAN_SWARMS.
SCAN_SWARMS = 16_384  # the scan path's batch (bench.py's default without the fused solver)
SCAN_JAX_FRAC_UNDER_1MM, SCAN_JAX_SWARMS = 0.9094, 4096
SCAN_FRAC_BAR = SCAN_JAX_FRAC_UNDER_1MM - 4.0 * (
    SCAN_JAX_FRAC_UNDER_1MM * (1.0 - SCAN_JAX_FRAC_UNDER_1MM)
    * (1.0 / SCAN_JAX_SWARMS + 1.0 / SCAN_SWARMS)) ** 0.5
SCAN_REPLAY_SWARMS = 256
# The zoo's paths through harness.trees.run_tree (bench.py --model <m>): the
# presets' batches, not cut, and each path's name in the kernels line.
TREE_SWARMS = {"dual_arm_14dof": 262_144, "humanoid_45dof": 16_384,
               "planar_3dof": 1_048_576, "reference_arm": 262_144, "snake_30dof": 65_536,
               "snake:50": 65_536}
TREE_PATHS = {"dual_arm_14dof": "dual_arm", "humanoid_45dof": "humanoid",
              "planar_3dof": "planar", "reference_arm": "reference_arm",
              "snake_30dof": "snake_30dof", "snake:50": "snake50"}
# Timed solves per path after one warm-up (3 where not listed): the humanoid
# solve runs 49 kernel A launches and 49 tensor-polish calls, ~20 s on the
# card; snake:50's ~5 s, host-bound (one timed solve keeps the script well
# inside its time limit).
TREE_ITERS = {"humanoid_45dof": 1, "snake:50": 1}
# JAX's records of the same recipes (bench_records/r5_sweep.jsonl r5-dualarm,
# r5-humanoid-walkfix, r5-planar-S32, r5-snake30, r5-snake150; taken on a
# TPU, quoted for accuracy only): shares rounded to 4 places, so no failure
# count (the humanoid's 0.9999 of 16,384 is 1-2 swarms); and the share
# under 1 mm each path must reach.
JAX_TREES = {
    "dual_arm_14dof": {"frac_under_1mm": 1.0, "p50_err_mm": 0.0003, "p90_err_mm": 0.0185},
    "humanoid_45dof": {"frac_under_1mm": 0.9999, "p50_err_mm": 0.0006,
                       "p90_err_mm": 0.0009},
    "planar_3dof": {"frac_under_1mm": 1.0, "p50_err_mm": 0.0001, "p90_err_mm": 0.0002},
    "snake_30dof": {"frac_under_1mm": 1.0, "p50_err_mm": 0.0006, "p90_err_mm": 0.001},
    "snake:50": {"frac_under_1mm": 1.0, "p50_err_mm": 0.0037, "p90_err_mm": 0.0067},
}
TREE_FRAC_BAR = {"dual_arm_14dof": 0.999, "humanoid_45dof": 0.999, "planar_3dof": 0.9999,
                 "snake_30dof": 0.9999, "snake:50": 0.9999}
# reference_arm has no fused row in JAX's records, and the fused kernel's
# in-kernel PRNG has no CPU lowering, so its bar is JAX's scan solver with
# the same recipe on 1,024 swarms, `JAX_PLATFORMS=cpu python
# tests/test_torch_zoo.py` (bench.py --cpu --impl jnp --model reference_arm
# --inertia-mode canonical --particles 256 --iterations 100 --polish 0
# --retries 0 --swarms 1024 --no-sol): p50 460.2116 mm, p90 1364.8679 mm,
# 1 swarm of 1,024 under 1 mm (single-shot far targets, not this model's
# protocol). The port's p50 and p90 must lie inside the 99% distribution-free
# intervals of JAX's, from the order statistics of its 1,024 errors (ranks
# 471-554 and 896-947).
REFERENCE_ARM_JAX = {"p50_err_mm": 460.2116, "p90_err_mm": 1364.8679,
                     "frac_under_1mm": 0.001, "swarms": 1024}
REFERENCE_ARM_P50_INTERVAL_MM = (409.07135009765625, 512.2057495117188)
REFERENCE_ARM_P90_INTERVAL_MM = (1233.37548828125, 1505.63330078125)
# Kernels B and C against their plain twins on the trees, snake_30dof (id 5)
# and the serial-chain variant at 17 nodes (the first past the 4-bit parent
# fields), 21 and 51.
FITNESS_MODELS = ("dual_arm_14dof", "humanoid_45dof", "snake_30dof", "snake:16", "snake:20",
                  "snake:50")
# Kernel A's replays against its plain twin: (swarms, Philox swarms, cases),
# each case a tag and PSOConfig fields over the model's base recipe. The
# snakes' base re-kicks every 2 iterations above 1e-6, reference_arm's does
# not re-kick; at 2,048 swarms the serial-chain variant's grid strides.
ZOO_REPLAY_CASES = (
    ("base", {}),
    ("uniform_rekick_all", dict(init_mode="uniform", rekick_threshold=-1.0)),
    # A threshold that splits the swarms: some kicked, some not.
    ("hybrid_rekick_split", dict(init_mode="hybrid", rekick_threshold=1.0)),
)
REPLAY_MODELS = {
    "dual_arm_14dof": (256, 256, (("base", {}), ("retry", dict(init_mode="hybrid")))),
    "humanoid_45dof": (64, 64, (("base", {}),)),
    **{m: (128, 2048, ZOO_REPLAY_CASES)
       for m in ("snake_30dof", "snake:16", "snake:20", "snake:50", "reference_arm")},
}
# Timed kernels per model: kernel A against its plain twin at the pair batch
# (the plain solve's (S, P, D) temporaries at the preset's P) and alone at the
# preset's batch; kernels B (P=128) and C (P=1,024) against their plain twins
# at their batches (None: not timed). planar_3dof runs the headline's short
# chain (arm_7dof's topology, its own limits) at the headline's shape.
TIMED_MODELS = {
    "dual_arm_14dof": (4096, 65_536, 4096),
    "humanoid_45dof": (256, 65_536, 4096),
    "snake_30dof": (1024, 8192, 1024),
    "snake:50": (256, 8192, 1024),
    "reference_arm": (512, None, None),
    "planar_3dof": (1024, None, None),
}
# The JSON-config path (harness/configs.py over cli.build_solver, the
# solve subcommand's solver): each document of ikpso_tpu_torch/configs at
# its batch, with its polish steps.
CONFIG_DIR = Path(__file__).resolve().parent / "ikpso_tpu_torch" / "configs"
CONFIGS = {"arm7_locality": (1_048_576, 4), "arm7_exact": (1_048_576, 4),
           "dual_arm_box": (262_144, 4), "hand21": (16_384, 6)}
# JAX's bars for them: `JAX_PLATFORMS=cpu python tests/test_torch_configs.py`
# (ikpso_tpu.utils.configio.load_config, the scan solver make_solver,
# wrap_with_polish with the document's scene and the steps above, on 1,024
# targets from numpy seed 0; taken on a CPU), compiled and op by op. The
# port's p50 and p90 (mm) must lie inside the hull of the two evaluations'
# 99% distribution-free intervals: where a configuration converges to the
# float32 noise floor (~0.1-0.3 um), JAX's compiled and op-by-op p50 fall
# outside each other's intervals (hand21: 0.192 and 0.214 um), and the
# port's op-by-op rounding sits between them. The raw count at >= 1 mm is
# printed beside JAX's.
JAX_CONFIGS = {
    "arm7_locality": {
        "p50_bar_mm": (1.742683700285852, 5.698193795979023),
        "p90_bar_mm": (173.17341268062592, 427.2228181362152),
        "p50_jit": (3.0752018792554736, (1.742683700285852, 5.698103923350573)),
        "p50_op_by_op": (3.075299086049199, (1.74269441049546, 5.698193795979023)),
        "p90_jit": (279.44023311138164, (173.176109790802, 427.22246050834656)),
        "p90_op_by_op": (279.4382303953172, (173.17341268062592, 427.2228181362152)),
        "failures_ge_1mm": 591,
        "failures_ge_1mm_op_by_op": 591,
        "swarms": 1024,
    },
    "arm7_exact": {
        "p50_bar_mm": (0.00011920928955078125, 0.00012731557319511921),
        "p90_bar_mm": (0.00026151431598009367, 0.0016924630017456366),
        "p50_jit": (0.00012013700256829907, (0.00011920928955078125, 0.00012287812012345967)),
        "p50_op_by_op": (0.00012287812012345967, (0.00011920928955078125, 0.00012731557319511921)),
        "p90_jit": (0.0003406104752912159, (0.00026151431598009367, 0.0016924630017456366)),
        "p90_op_by_op": (0.000313183562639097, (0.00026656007889869215, 0.0016492268741785665)),
        "failures_ge_1mm": 30,
        "failures_ge_1mm_op_by_op": 30,
        "swarms": 1024,
    },
    "dual_arm_box": {
        "p50_bar_mm": (0.0003223545945729711, 0.00039408399743479094),
        "p90_bar_mm": (0.16947831318248063, 2.8230648022145033),
        "p50_jit": (0.00034984108765456767, (0.0003223545945729711, 0.0003752097654796671)),
        "p50_op_by_op": (0.0003712453633397672, (0.00033978869851125637, 0.00039408399743479094)),
        "p90_jit": (0.580660876585171, (0.16947831318248063, 2.8229900635778904)),
        "p90_op_by_op": (0.580750597873703, (0.16961492656264454, 2.8230648022145033)),
        "failures_ge_1mm": 91,
        "failures_ge_1mm_op_by_op": 91,
        "swarms": 1024,
        "frac_targets_feasible": 1.0,
        "colliding_solutions": 0,
    },
    "hand21": {
        "p50_bar_mm": (0.00018666948164991481, 0.0002197077719756635),
        "p90_bar_mm": (0.0002600899904336984, 0.0003027230093266553),
        "p50_jit": (0.0001920593462045872, (0.00018666948164991481, 0.00019729485245534306)),
        "p50_op_by_op": (0.0002141716421988349, (0.00020845234871558205, 0.0002197077719756635)),
        "p90_jit": (0.00027178393224858155, (0.0002600899904336984, 0.0002839771582330286)),
        "p90_op_by_op": (0.0002921645204878587, (0.00028149398190180364, 0.0003027230093266553)),
        "failures_ge_1mm": 4,
        "failures_ge_1mm_op_by_op": 4,
        "swarms": 1024,
    },
}
CONFIG_COLLIDING_PER_SWARM = 1e-4
# Kernels A, B and C built on demand, each held bit for bit against its
# plain twin: (source, particles, PSOConfig fields over the source's recipe
# for the replays (None: the recipe), scene, orientation[, FitnessConfig
# fields over the source's]). A source is a document of
# ikpso_tpu_torch/configs, a tree cut from one (CUT_TREES) or a zoo model
# with its preset's recipe; "near" is a 4-box ring at 0.35 of the chain's
# reach, where random poses hit it.
ON_DEMAND_CASES = {
    "distance": ("arm7_locality", 128, None, None, False),
    "exact": ("arm7_exact", 128, None, None, False),
    "dual_arm_box": ("dual_arm_box", 1024, None, "near", False),
    "hand21": ("hand21", 512, dict(iterations=8), None, False),
    "dual_arm_orientation": ("dual_arm_14dof", 1024, None, None, True),
    "snake20_box": ("snake:20", 256, None, "near", False),
    # Keys of kernel A's tree-loop rule beside dual_arm_box and
    # dual_arm_orientation: the dual arm with the capsule collider, the
    # distance term or exact trig, and an on-demand tree of 36 DOFs with
    # and without the box scene.
    "dual_arm_capsule": ("dual_arm_box", 1024, None, "near", False,
                         dict(collision_shape="capsule")),
    "dual_arm_distance": ("dual_arm_14dof", 1024, None, None, False,
                          dict(angle_weight=3.0, distance_weight=0.7)),
    "dual_arm_exact": ("dual_arm_14dof", 1024, None, None, False, dict(trig_impl="exact")),
    "hand12": ("hand12", 512, dict(iterations=8), None, False),
    "hand12_box": ("hand12", 512, dict(iterations=8), "near", False),
}
# Trees cut from a config document: name -> (document, nodes kept, their
# effectors). hand12 is hand21 less its last two fingers: 13 nodes, 36 DOFs.
CUT_TREES = {"hand12": ("hand21", 13, (4, 8, 12))}
# Swarms of the kernel A replays and Philox runs (the scratch layout's
# Philox run strides: more swarms than the grid holds).
OD_REPLAY_SWARMS, OD_PHILOX_SWARMS = 64, {"hand21": 2048, "snake20_box": 2048}
# Timed per case: kernel A against its plain twin (swarms), kernels B (P=128)
# and C (P=1,024) against theirs (swarms).
OD_TIMED = {"distance": (65_536, 65_536, 1024), "exact": (65_536, 65_536, 1024),
            "dual_arm_box": (4096, 8192, 256), "hand21": (1024, 8192, 256),
            "dual_arm_orientation": (4096, 8192, 256), "snake20_box": (1024, 8192, 256),
            "dual_arm_capsule": (4096, 8192, 256), "dual_arm_distance": (4096, 8192, 256),
            "dual_arm_exact": (4096, 8192, 256), "hand12": (1024, 8192, 256),
            "hand12_box": (1024, 8192, 256)}
POLISH_CARD_CPU_ATOL = 1e-5  # rad: the tensor polish, card against CPU
D_RTOL = 1e-6  # kernel D vs plain: fmaf vs a float64 FMA, libdevice sinf vs torch.sin
D_STEPS = 4  # a step count at which every recurrence stays finite
# The timed launches of kernels D (elements, steps) and E (threads, steps).
D_TIMED = (1 << 22, 512)
E_TIMED = (1 << 20, 256)
# Kernel E's integer issue ceiling: 32-bit integer instructions issue on
# 64 lanes a clock per SM on Hopper; the SM clock is read while E runs, a
# queue of this many launches (~0.3 s) keeping the card busy.
INT_LANES_PER_SM_CLOCK = 64
E_CLOCK_LAUNCHES = 500


T0 = time.perf_counter()
# Every phase line also goes to this file (the whole run's record, longer
# than a terminal keeps); main() starts it afresh.
LOG = Path(__file__).resolve().parent / "out" / "chip_smoke.jsonl"


def emit(phase: str, **fields) -> None:
    line = json.dumps({"phase": phase, "t_s": time.perf_counter() - T0, **fields})
    print(line, flush=True)
    with LOG.open("a") as f:
        f.write(line + "\n")


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def card_clocks() -> str:
    """SM clock, its maximum, power draw and temperature of GPU 0 now, as
    ``nvidia-smi`` reports them (sampled beside the timed windows)."""
    return run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
                "temperature.gpu", "--format=csv,noheader"]).splitlines()[0]


def cuda_time(fn, reps: int, warmup: int = 1):
    """``(mean milliseconds per call over reps calls by CUDA events, the
    last call's result)``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    return cuda_time(fn, reps, warmup)[0]


def check_fitness(tag, got, want, *, exact: bool):
    """A fitness kernel's output against its plain twin's: equal hit
    masks, finite, and on free particles a max abs error of 0.0
    (``exact``) or within ``FK_RTOL``/``FK_ATOL``. Returns the error;
    raises on a mismatch."""
    import torch

    hit_k, hit_p = got >= FLT_MAX, want >= FLT_MAX
    free = ~hit_p
    err = float((got[free] - want[free]).abs().max()) if bool(free.any()) else 0.0
    close = (err == 0.0 if exact
             else bool(torch.allclose(got[free], want[free], rtol=FK_RTOL, atol=FK_ATOL)))
    if not (torch.equal(hit_k, hit_p) and bool(torch.isfinite(got).all()) and close):
        raise AssertionError(f"{tag}: kernel disagrees with its plain twin "
                             f"({int((hit_k != hit_p).sum())} mask mismatches, "
                             f"max abs error {err} on free particles)")
    return err


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs a GPU")
    from ikpso_tpu_torch.utils import kernels
    from ikpso_tpu_torch.utils.roofline import card_name

    card = card_name()

    nvcc = run([kernels._nvcc(), "--version"]).splitlines()[-1]
    emit("environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc, python=sys.version.split()[0],
         device_count=torch.cuda.device_count())
    return card


def _wrappers():
    from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness, fused_fitness
    from ikpso_tpu_torch.pso.fused import fused_solve
    from ikpso_tpu_torch.pso.solver import scan_step
    from ikpso_tpu_torch.utils.roofline import philox_xor, roofline_body

    return {"fused_solve": fused_solve, "fk_fitness": fk_fitness,
            "fused_fitness": fused_fitness, "scan_step": scan_step,
            "roofline_body": roofline_body, "philox_xor": philox_xor}


def reset_counts():
    """Set every kernel wrapper's launch counts, and the scan solver's
    CUDA-graph captures and replays, to 0."""
    from ikpso_tpu_torch.pso.graphs import CapturedSolve

    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["fused_solve"].variant_launches = {}
    _wrappers()["scan_step"].replay_launches = 0
    CapturedSolve.captures = CapturedSolve.replays = 0


def read_counts():
    """Every wrapper's launches (a launch into a captured CUDA graph counts
    once, at its capture); ``scan_step_replay``: the scan step's launches
    of its replay instantiation (the rest drew their uniforms);
    ``graph_captures`` and ``graph_replays``: the scan solver's CUDA
    graphs captured and replayed (``pso/graphs.py``)."""
    from ikpso_tpu_torch.pso.graphs import CapturedSolve

    counts = {name: fn.launches for name, fn in _wrappers().items()}
    counts["fused_solve_variants"] = dict(_wrappers()["fused_solve"].variant_launches)
    counts["scan_step_replay"] = _wrappers()["scan_step"].replay_launches
    counts["graph_captures"] = CapturedSolve.captures
    counts["graph_replays"] = CapturedSolve.replays
    return counts


def ptxas_report(log: str):
    """Per compiled kernel: demangled name, registers, spill bytes."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    try:
        from ikpso_tpu_torch.utils import kernels

        filt = str(Path(kernels._nvcc()).with_name("cu++filt"))
        names = run([filt, *(r["kernel"] for r in rows)]).splitlines()
        for r, name in zip(rows, names):
            name = re.sub(r"\((?:unsigned )*(?:int|long|bool)(?: long)*\)", "", name)
            r["kernel"] = name.split("(")[0].replace("void ", "").replace("ikpso::", "")
    except (OSError, RuntimeError):
        pass  # keep the mangled names
    return rows


def phase_build(on_demand=False):
    """Build the prebuilt library; with ``on_demand``, every on-demand key
    of ``ON_DEMAND_CASES`` beside it, all nvcc processes at once
    (``phase_on_demand_build``)."""
    from concurrent.futures import ThreadPoolExecutor

    from ikpso_tpu_torch.utils import kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        od = pool.submit(phase_on_demand_build) if on_demand else None
        lib = kernels.build()
        kernels.library()
        seconds = time.perf_counter() - t0
        ptxas = od.result() if od else None
    log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
    m = re.search(r"build_seconds=([\d.]+)", log)
    report = ptxas_report(log)
    # The scan step's instantiations, drawing and replay (PERF.md keeps
    # their spills at 0).
    steps = [r for r in report if "scan_step_kernel" in r["kernel"]]
    emit("build", seconds=seconds, nvcc_seconds=float(m.group(1)) if m else None,
         library=lib.name, kernels=report,
         scan_step_instantiations=len(steps),
         scan_step_registers=sorted({r.get("registers") for r in steps if "registers" in r}),
         scan_step_spill_store_bytes=max((r.get("spill_stores", 0) for r in steps), default=None),
         cluster_layout=cluster_layout_report(report, ptxas),
         with_on_demand_seconds=time.perf_counter() - t0)
    return ptxas


# Kernel A's cluster layout at the shapes of its paths: (on-demand case,
# particles).
CLUSTER_SHAPES = (("hand21", 512),)


def cluster_layout_report(report, od_ptxas=None):
    """Kernel A's cluster-layout instantiations: registers and spill bytes
    (ptxas; ``report`` the prebuilt library's, ``od_ptxas`` the on-demand
    keys'), and at each of ``CLUSTER_SHAPES`` the cluster size, the threads
    and shared bytes of a block and the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    from ikpso_tpu_torch.ops.fitness_kernel import MetaLayout
    from ikpso_tpu_torch.utils import kernels

    rows = [r for r in report if "cluster_kernel" in r["kernel"]]
    for tag, lines in (od_ptxas or {}).items():
        rows += [{**r, "case": tag} for r in lines if "cluster_kernel" in r["kernel"]]
    shapes = {}
    for name, p in CLUSTER_SHAPES if od_ptxas is not None else ():
        spec = _config(ON_DEMAND_CASES[name][0], "cpu").spec
        lay = MetaLayout(spec)
        layout = kernels.kernel_a_layout(spec, p)
        c = layout.cluster
        shapes[f"{name} P={p}"] = {
            "cluster": c, "threads_a_block": p // c, "smem_bytes_a_block": layout.smem_bytes,
            "active_clusters": kernels.on_demand_library(od_keys()[name])
            .ikpso_od_fused_solve_cluster_blocks(0, c, p, lay.meta_size, lay.swarm_size)}
    return {"kernels": rows, "max_spill_store_bytes": max(
        (r.get("spill_stores", 0) for r in rows), default=None), "shapes": shapes}


class _OlderLibrary:
    """Another checkout's prebuilt library as this checkout's wrappers call
    it, where it predates the serial-chain variant's lbest placement
    argument (it lacks ``ikpso_kernel_a_smem_bytes``): that argument is
    dropped (its serial variant keeps lbest in global scratch, which the
    caller then asks for) and every other entry point is passed through."""

    def __init__(self, lib):
        import ctypes

        from ikpso_tpu_torch.utils import kernels

        self._lib = lib
        for name in ("ikpso_fused_solve_serial", "ikpso_fused_solve_serial_blocks"):
            fn = getattr(lib, name)
            fn.argtypes = [a for i, a in enumerate(kernels.SIGNATURES[name]) if i != 1]
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def ikpso_fused_solve_serial_blocks(self, replay, lb_shared, *rest):
        assert not lb_shared
        return self._lib.ikpso_fused_solve_serial_blocks(replay, *rest)

    def ikpso_fused_solve_serial(self, replay, lb_shared, *rest):
        assert not lb_shared
        return self._lib.ikpso_fused_solve_serial(replay, *rest)


class _NoBoundLibrary:
    """Another checkout's prebuilt library whose ``ikpso_fused_solve``
    predates the thread-bound argument (it lacks
    ``ikpso_kernel_a_short_threads``: one instantiation a topology): the
    argument is dropped, every other entry point passed through."""

    def __init__(self, lib):
        import ctypes

        from ikpso_tpu_torch.utils import kernels

        self._lib = lib
        fn = getattr(lib, "ikpso_fused_solve")
        fn.argtypes = kernels.SIGNATURES["ikpso_fused_solve"][:-2] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def ikpso_fused_solve(self, *args):
        return self._lib.ikpso_fused_solve(*args[:-2], args[-1])


class _sources:
    """Point ``utils.kernels`` at another checkout's ``csrc`` (and a build
    directory of its own, and the sources of this checkout's list that it
    has) while the block runs."""

    def __init__(self, root):
        from ikpso_tpu_torch.utils import kernels

        self.kernels = kernels
        csrc = Path(root).resolve() / "ikpso_tpu_torch" / "csrc"
        self.paths = (csrc, kernels.BUILD_DIR.parent / "against",
                      tuple(src for src in kernels.SOURCES if (csrc / src).exists()))

    def __enter__(self):
        k = self.kernels
        self.saved = (k.CSRC, k.BUILD_DIR, k.SOURCES)
        k.CSRC, k.BUILD_DIR, k.SOURCES = self.paths
        return k

    def __exit__(self, *exc):
        k = self.kernels
        k.CSRC, k.BUILD_DIR, k.SOURCES = self.saved


# phase_against's kernel A cases beyond the 7-DOF ones: (tag, model or
# ON_DEMAND_CASES tag, swarms, reps). The trees at the shapes of the timing
# phases (tree_timing, on_demand_timing), so the pair medians sit beside
# those phases' bounds.
AGAINST_TREES = (("dual_arm_14dof", 262_144, 3), ("humanoid_45dof", 16_384, 3),
                 ("reference_arm", 262_144, 1), ("snake_30dof", 65_536, 3),
                 ("snake:16", 65_536, 3), ("snake:20", 65_536, 3), ("snake:35", 65_536, 1),
                 ("snake:50", 65_536, 1))
AGAINST_ON_DEMAND = (("dual_arm_box", 4096, 3), ("dual_arm_box", 262_144, 1),
                     ("dual_arm_orientation", 4096, 3), ("hand21", 16_384, 1),
                     ("snake20_box", 1024, 3), ("distance", 65_536, 10),
                     ("exact", 65_536, 10), ("dual_arm_capsule", 4096, 3),
                     ("dual_arm_distance", 4096, 3), ("dual_arm_exact", 4096, 3),
                     ("hand12", 16_384, 1), ("hand12_box", 16_384, 1))


def phase_against(other_root, device, pairs=10):
    """Build another checkout's kernels (``<other_root>/ikpso_tpu_torch/csrc``)
    with this checkout's flags and hold their ptxas lines against this
    build's: every kernel whose registers or spill bytes differ, and those
    in one build only. Then time kernel A (and kernel B's two collider
    branches) through this checkout's wrappers on each case, in ``pairs`` rounds that turn the order of the contenders
    each round, and check that every contender returns the same bits:
    the 7-DOF cases (this build against the other); the trees at the
    timing phases' shapes (the serial-chain variant in both lbest
    placements); and the on-demand cases, where this build's key in each
    state placement (in the scratch layout, at either thread bound; a
    cluster key in its other layout, and in the cluster layout at another
    cluster size) meets the other build's key as the other checkout's
    rules route it (its ``on_demand_key``). Each
    contender's row holds its placement, shared-memory bytes, ptxas lines,
    times, median and spread; a line per case, then one for all."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness
    from ikpso_tpu_torch.pso.fused import fused_solve, kernel_a_layout
    from ikpso_tpu_torch.utils import kernels

    mine = ptxas_report(kernels.build().with_suffix(".log").read_text())
    with _sources(other_root) as other:
        theirs = {r["kernel"]: r for r in
                  ptxas_report(other.build().with_suffix(".log").read_text())}
        other_lib = other.library.__wrapped__()
    if not hasattr(other_lib, "ikpso_kernel_a_smem_bytes"):
        other_lib = _OlderLibrary(other_lib)
    if not hasattr(other_lib, "ikpso_kernel_a_short_threads"):
        other_lib = _NoBoundLibrary(other_lib)
    libs = {"this": kernels.library(), "other": other_lib}
    mine = {r["kernel"]: r for r in mine}
    changed = [{"kernel": k, "this": mine[k], "other": theirs[k]}
               for k in sorted(mine.keys() & theirs.keys()) if mine[k] != theirs[k]]
    emit("ptxas_against", other=str(other_root),
         kernels_in_both=len(mine.keys() & theirs.keys()),
         changed=changed, only_this=sorted(mine.keys() - theirs.keys()),
         only_other=sorted(theirs.keys() - mine.keys()))

    # On-demand contenders: this build's key, the other build's key as the
    # other checkout's rules route it (its utils/kernels.py; sources that
    # predate IKPSO_OD_SHARED run their own placement), and this build's
    # key in the other placements (in the scratch layout, at either bound).
    od_contenders, od_cluster, keys = {}, {}, od_keys()
    theirs_keys = od_keys(checkout_kernels(other_root))
    for tag, _, _ in AGAINST_ON_DEMAND:
        key = keys[tag]
        other = theirs_keys[tag]
        if not (key.scratch or key.stream or key.shared):
            alts = {}  # a short chain: its one kernel
        elif key.cluster:
            spec_c, _, fit_c, p_c, meta_c, swarm_c, obs_c, orient_c = od_case(
                tag, "cpu", 1, np.random.default_rng(0))
            rule = kernel_a_layout(spec_c, fit_c, swarm_c, p_c,
                                   0 if obs_c is None else obs_c.count, orient_c).cluster
            forced = ({0, 4 if rule != 4 else 2} if rule else
                      {kernels.cluster_size(spec_c.dof, p_c, meta_c.numel(), swarm_c.shape[1])})
            alts = {}
            for c in sorted(forced):
                alts[f"this/c{c}" if c else "this/scratch"] = key
                od_cluster[(tag, f"this/c{c}" if c else "this/scratch")] = c
        elif key.scratch:
            alts = {f"this/{t} {'shared' if sh else 'global'}":
                    key._replace(threads=t, shared=sh)
                    for t, sh in ((1024, False), (512, False), (512, True))}
        elif key.tree:
            # The tree loop against the general loop in the same placement.
            alts = {"this/general": key._replace(tree=False)}
        else:
            alts = {f"this/{'registers' if key.shared else 'shared'}":
                    key._replace(shared=not key.shared)}
        od_contenders[tag] = {
            "this": key,
            "other": other,
            **{name: alt for name, alt in alts.items()
               if alt != key or (tag, name) in od_cluster}}
    t0 = time.perf_counter()
    od_libs, od_ptxas = {}, {}
    for who in ("this", "other"):
        todo = [(tag, name) for tag, c in od_contenders.items() for name in c
                if (name == "other") == (who == "other")]
        sources = _sources(other_root) if who == "other" else contextlib.nullcontext(kernels)
        with sources as k:
            k.prebuild({od_contenders[tag][name] for tag, name in todo})
            for tag, name in todo:
                key = od_contenders[tag][name]
                od_libs[(tag, name)] = k.on_demand_library.__wrapped__(key)
                log = k.on_demand_path(key).with_suffix(".log").read_text()
                od_ptxas[(tag, name)] = [r for r in ptxas_report(log)
                                         if r["kernel"].startswith("fused_solve")]
    build_s = time.perf_counter() - t0

    def seeds_of(rng, swarms):
        return torch.as_tensor(rng.integers(-2**31, 2**31, (swarms, 2), dtype=np.int64)
                               .astype(np.int32), device=device)

    patched = ("library", "SHARED_IDS", "serial_lbest_shared", "tree_cluster",
               "on_demand_key", "on_demand_library", "on_demand_threads", "SHORT_THREADS")

    def under(use, fn):
        """``fn()`` with a contender's libraries and placement rules in place
        (``use``), then the module's own again."""
        saved = {n: getattr(kernels, n) for n in patched}
        try:
            use()
            return fn()
        finally:
            for n, v in saved.items():
                setattr(kernels, n, v)

    def prebuilt(who, serial_shared=None, short_bound=True):
        """A build's prebuilt library and, for the serial-chain variant, an
        lbest placement (where the other build predates the placements:
        its own, registers and lbest in global scratch); without
        ``short_bound``, a short chain's 1,024-thread instantiation."""
        def use():
            kernels.library = lambda: libs[who]
            if not short_bound:
                kernels.SHORT_THREADS = 0
            if isinstance(libs[who], _OlderLibrary):
                kernels.SHARED_IDS = ()
                kernels.serial_lbest_shared = lambda *a: False
            elif serial_shared is not None:
                kernels.serial_lbest_shared = lambda *a: serial_shared
        return use

    def on_demand(tag, name):
        """An on-demand contender's key and library, its bound as the
        particle bound (and a cluster key's layout where it is forced:
        the cluster size, 0 for the scratch layout)."""
        def use():
            key, lib = od_contenders[tag][name], od_libs[(tag, name)]
            kernels.on_demand_key = lambda *a, **kw: key
            kernels.on_demand_library = lambda k: lib
            kernels.on_demand_threads = lambda spec: key.threads
            if (tag, name) in od_cluster:
                kernels.tree_cluster = lambda *a: od_cluster[(tag, name)]
        return use

    def ptxas_of(*prefixes):
        return {who: [r for name, r in rows.items() if name.startswith(prefixes)]
                for who, rows in (("this", mine), ("other", theirs))}

    rng = np.random.default_rng(4)
    pso, fit = _headline_configs()
    two = {"this": prebuilt("this"), "other": prebuilt("other")}
    # The short chains: this build at either thread bound against the other.
    short = {**two, "this/1024": prebuilt("this", short_bound=False)}
    cases = {}  # name -> (fn, reps, contenders, layout args, ptxas lines by contender)
    arm = ("fused_solve_kernel<Topology<4, 8448, 8>",
           "fused_solve_short_kernel<Topology<4, 8448, 8>")
    for swarms in (HEADLINE_SWARMS, TIMING_SWARMS):
        spec, batched = _problem("arm_7dof", swarms, rng, device)
        meta, swarm = _packed(spec, batched, fit)
        seeds = seeds_of(rng, swarms)
        args = (spec, pso, fit, meta, swarm, spec.limits(), seeds, 128)
        cases[f"arm_7dof S={swarms}"] = (lambda args=args: fused_solve(*args), 10, short,
                                         (spec, fit, swarm, 128),
                                         ptxas_of(*(f"{a}, 0, 0" for a in arm)))
    pre_p, pso_p, fit_p, spec_p, meta_p, swarm_p, lim_p, seeds_p = _tree_setup(
        "planar_3dof", TREE_SWARMS["planar_3dof"], rng=rng, device=device)
    args_p = (spec_p, pso_p, fit_p, meta_p, swarm_p, lim_p, seeds_p, pre_p.particles)
    cases[f"planar_3dof S={TREE_SWARMS['planar_3dof']}"] = (
        lambda: fused_solve(*args_p), 10, short, (spec_p, fit_p, swarm_p, pre_p.particles),
        ptxas_of(*(f"{a}, 0, 0" for a in arm)))
    obs = _scene(spec, device)
    for c, shape in enumerate(("box", "capsule"), 1):
        fit_s = dataclasses.replace(fit, collision_shape=shape)
        meta_s, _ = _packed(spec, batched, fit_s, obs)
        args = (spec, pso, fit_s, meta_s, swarm, spec.limits(), seeds, 128)
        cases[f"arm_7dof {shape} S={TIMING_SWARMS}"] = (
            lambda args=args: fused_solve(*args, num_obstacles=obs.count), 10, short,
            (spec, fit_s, swarm, 128, obs.count), ptxas_of(*(f"{a}, {c}, 0" for a in arm)))
    # Kernel B's collider branches on their own (the timing phase's shape).
    lim = spec.limits().cpu().numpy()
    x_b = torch.as_tensor((lim[0] + rng.random((TIMING_SWARMS, 128, spec.dof))
                           * (lim[1] - lim[0])).astype("float32"), device=device)
    for c, shape in enumerate(("box", "capsule"), 1):
        fit_s = dataclasses.replace(fit, collision_shape=shape)
        meta_s, _ = _packed(spec, batched, fit_s, obs)
        cases[f"B arm_7dof {shape} S={TIMING_SWARMS}"] = (
            lambda meta_s=meta_s, shape=shape: fk_fitness(
                spec, x_b, meta_s, swarm, num_obstacles=obs.count, collision_shape=shape),
            20, two, None,
            ptxas_of(f"fk_fitness_kernel<Topology<4, 8448, 8>, {c}, 0"))
    pso_o, fit_o = _orientation_configs()
    spec_o, batched_o = _problem("arm_6dof", TIMING_SWARMS, rng, device, orientation=True)
    meta_o, swarm_o = _packed(spec_o, batched_o, fit_o, use_orientation=True)
    args_o = (spec_o, pso_o, fit_o, meta_o, swarm_o, spec_o.limits(),
              seeds_of(rng, TIMING_SWARMS), 128)
    cases[f"arm_6dof orientation re-kick S={TIMING_SWARMS}"] = (
        lambda: fused_solve(*args_o, use_orientation=True), 10, short,
        (spec_o, fit_o, swarm_o, 128, 0, True),
        ptxas_of("fused_solve_kernel<Topology<3, 256, 4>, 0, 1",
                 "fused_solve_short_kernel<Topology<3, 256, 4>, 0, 1"))
    for model, swarms, reps in AGAINST_TREES:
        pre, pso_t, fit_t, spec_t, meta_t, swarm_t, lim_t, seeds_t = _tree_setup(
            model, swarms, rng=rng, device=device)
        args_t = (spec_t, pso_t, fit_t, meta_t, swarm_t, lim_t, seeds_t, pre.particles)
        contenders = two
        if kernels.topology_id(spec_t) == kernels.SERIAL:
            rule = kernel_a_layout(spec_t, fit_t, swarm_t, pre.particles).placement
            contenders = {**two, **{f"this/{placement}": prebuilt("this", shared)
                                    for placement, shared in (("global", False),
                                                              ("shared", True))
                                    if placement != rule}}
        # A tree's kernel A: the tree loop here, the general loop in a build
        # that predates it.
        names = (kernel_names(model)["A"],
                 kernel_names(model)["A"].replace("_tree_kernel", "_kernel"))
        cases[f"{model} S={swarms}"] = (lambda args_t=args_t: fused_solve(*args_t), reps,
                                        contenders, (spec_t, fit_t, swarm_t, pre.particles),
                                        ptxas_of(*dict.fromkeys(names)))
    for tag, swarms, reps in AGAINST_ON_DEMAND:
        spec_d, pso_d, fit_d, p, meta_d, swarm_d, obs_d, orient = od_case(
            tag, device, swarms, rng, philox=True)
        n_obs = 0 if obs_d is None else obs_d.count
        args_d = (spec_d, pso_d, fit_d, meta_d, swarm_d, spec_d.limits(),
                  seeds_of(rng, swarms), p)
        cases[f"{tag} S={swarms}"] = (
            lambda args_d=args_d, n_obs=n_obs, orient=orient: fused_solve(
                *args_d, num_obstacles=n_obs, use_orientation=orient),
            reps, {name: on_demand(tag, name) for name in od_contenders[tag]},
            (spec_d, fit_d, swarm_d, p, n_obs, orient),
            {name: od_ptxas[(tag, name)] for name in od_contenders[tag]})

    rows = {}
    for name, (fn, reps, contenders, layout_args, ptxas) in cases.items():
        order = list(contenders)
        ms = {who: [] for who in order}
        out = {}
        for i in range(pairs):
            turn = order[i % len(order):] + order[:i % len(order)]
            for who in (turn if i % 2 == 0 else turn[::-1]):
                t, out[who] = under(contenders[who], lambda: cuda_time(fn, reps=reps))
                ms[who].append(t)
        same = all(torch.equal(a, b) for who in order[1:]
                   for a, b in zip(out[order[0]], out[who]))
        med = {k: statistics.median(v) for k, v in ms.items()}
        row = {}
        for who in order:
            row[who] = {"ptxas": ptxas[who if who in ptxas else who.split("/")[0]],
                        "ms": ms[who], "median_ms": med[who],
                        "spread_ms": max(ms[who]) - min(ms[who])}
            if layout_args is not None:
                layout = under(contenders[who], lambda: kernel_a_layout(*layout_args))
                row[who].update(placement=layout.placement, smem_bytes=layout.smem_bytes,
                                scratch_planes=layout.scratch_planes,
                                threads=layout.threads, static_bytes=layout.static_bytes,
                                cluster=layout.cluster)
        rows[name] = {"contenders": row, "this_over_other": med["this"] / med["other"],
                      "this_faster_pairs": sum(t < o for t, o in zip(ms["this"],
                                                                     ms["other"])),
                      "fastest": min(med, key=med.get), "bitwise_equal": same}
        emit("kernel_a_against_case", case=name, **rows[name])
        if not same:
            raise AssertionError(f"kernel A ({name}): the contenders disagree")
    emit("kernel_a_against", other=str(other_root), pairs=pairs, cases=rows,
         on_demand_build_s=build_s, card=card_clocks())


def _problem(name, swarms, rng, device, orientation=False):
    """A batched problem with reachable targets (FK of random in-limit
    angles) made from a seeded numpy generator; with ``orientation``, the
    generating poses' effector rotations are the target rotations."""
    import torch

    from ikpso_tpu_torch.harness.orientation import orientation_targets
    from ikpso_tpu_torch.harness.trees import model_spec
    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.ops import fk as fk_ops

    spec, problem = model_spec(name, device)
    lim = spec.limits().cpu().numpy()
    ang = lim[0] + rng.random((swarms, spec.dof)) * (lim[1] - lim[0])
    ang = torch.as_tensor(ang.astype("float32"), device=device)
    pose = fk_ops.angles_to_pose(spec, problem.pose[0].expand(swarms, 3), ang)
    if orientation:
        targets, target_rot = orientation_targets(spec, problem, pose)
        return spec, library.batched_problem(problem, targets, target_rot=target_rot)
    targets = fk_ops.fk_points(spec, pose, problem.origin)[:, list(spec.effector_idx)]
    return spec, library.batched_problem(problem, targets)


def _packed(spec, batched, fit, obstacles=None, use_orientation=False):
    from ikpso_tpu_torch.ops import fk as fk_ops
    from ikpso_tpu_torch.ops.fitness_kernel import pack_meta, pack_swarm
    from ikpso_tpu_torch.pso.polish_soa import anchor_positions_flat

    meta = pack_meta(spec, fit, obstacles, use_orientation)
    swarm = pack_swarm(spec, batched, fk_ops.pose_to_angles(spec, batched.pose),
                       anchor_positions_flat(spec, batched), use_orientation)
    return meta, swarm


def phase_fk_fitness(device, swarms=4096, particles=128):
    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness, fk_fitness_plain

    worst = 0.0
    for name in ("arm_7dof", "reference_arm"):
        rng = np.random.default_rng(1)
        spec, batched = _problem(name, swarms, rng, device)
        meta, swarm = _packed(spec, batched, FitnessConfig(angle_weight=3.0))
        lim = spec.limits().cpu().numpy()
        x = lim[0] + rng.random((swarms, particles, spec.dof)) * (lim[1] - lim[0])
        x = torch.as_tensor(x.astype("float32"), device=device)
        got = fk_fitness(spec, x, meta, swarm)
        want = fk_fitness_plain(spec, x, meta, swarm)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        ok = torch.allclose(got, want, rtol=FK_RTOL, atol=FK_ATOL)
        emit("fk_fitness_vs_plain", model=name, swarms=swarms, particles=particles,
             max_abs_err=err, rtol=FK_RTOL, atol=FK_ATOL, ok=bool(ok))
        if not ok:
            raise AssertionError(f"kernel B disagrees with fk_fitness_plain on {name}")
    return worst


def _compare_solve(tag, spec, pso, fit, meta, swarm, seeds, particles, uniforms,
                   num_obstacles=0, bitwise=False, use_orientation=False, **extra):
    import torch

    from ikpso_tpu_torch.pso.fused import fused_solve, fused_solve_plain

    limits = spec.limits()
    kw = dict(uniforms=uniforms, num_obstacles=num_obstacles,
              use_orientation=use_orientation)
    gk, vk = fused_solve(spec, pso, fit, meta, swarm, limits, seeds, particles, **kw)
    gp, vp = fused_solve_plain(spec, pso, fit, meta, swarm, limits, seeds, particles, **kw)
    torch.cuda.synchronize()
    g_err = float((gk - gp).abs().max())
    # Values at the collision penalty compare by equality, not difference.
    both = (vk < FLT_MAX) & (vp < FLT_MAX)
    v_err = float((vk - vp)[both].abs().max()) if bool(both.any()) else 0.0
    equal = bool(torch.equal(gk, gp) and torch.equal(vk, vp))
    ok = bool(torch.isfinite(gk).all() and torch.isfinite(vk).all()
              and g_err <= REPLAY_ATOL
              and torch.equal(vk >= FLT_MAX, vp >= FLT_MAX)
              and bool(((vk - vp)[both].abs()
                        <= REPLAY_VAL_ATOL + REPLAY_RTOL * vp[both].abs()).all())
              and (equal or not bitwise))
    emit(tag, model=spec_name(spec), swarms=swarm.shape[0], particles=particles,
         iterations=pso.iterations, init_mode=pso.init_mode, obstacles=num_obstacles,
         inertia_mode=pso.inertia_mode, gbest_interval=pso.gbest_interval,
         rekick_interval=pso.rekick_interval, rekick_threshold=pso.rekick_threshold,
         orientation=use_orientation,
         gbest_max_abs_err=g_err, gval_max_abs_err=v_err, bitwise_equal=equal,
         bar="bit-identical" if bitwise else f"atol {REPLAY_ATOL}, rtol {REPLAY_RTOL}",
         **extra, ok=ok)
    if not ok:
        raise AssertionError(f"{tag}: kernel A disagrees with fused_solve_plain")
    return g_err


def spec_name(spec):
    from ikpso_tpu_torch.utils import kernels

    names = {3: "arm_6dof", 4: "arm_7dof", 7: "dual_arm_14dof", 8: "reference_arm",
             11: "snake_30dof", 16: "humanoid_45dof"}
    if spec.num_nodes in names:
        return names[spec.num_nodes]
    return (f"snake:{spec.num_nodes - 1}" if kernels.is_serial(spec)
            else kernels.topology_name(spec))


def _headline_configs():
    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.pso.config import PSOConfig

    pso = PSOConfig(iterations=8, inertia_mode="canonical", inertia=0.5,
                    inertia_end=0.2)
    return pso, FitnessConfig(angle_weight=0.0, distance_weight=0.0)


def phase_fused_replay(device, swarms=1024, particles=128,
                       models=("arm_7dof", "reference_arm")):
    import numpy as np
    import torch

    from ikpso_tpu_torch.pso.fused import num_draws

    pso, fit = _headline_configs()
    worst = 0.0
    for name, s in ((m, 256 if m == "reference_arm" else swarms) for m in models):
        rng = np.random.default_rng(2)
        spec, batched = _problem(name, s, rng, device)
        meta, swarm = _packed(spec, batched, fit)
        u = rng.random((s, num_draws(pso), spec.dof, particles), dtype=np.float32)
        seeds = torch.zeros((s, 2), dtype=torch.int32, device=device)
        worst = max(worst, _compare_solve(
            "fused_replay_vs_plain", spec, pso, fit, meta, swarm, seeds, particles,
            torch.as_tensor(u, device=device)))
    return worst


# Tie chains for kernel A's argmin: (parents, link lengths, effectors, the
# wrist DOFs), each last link of length 0, so the wrist angles leave the
# fitness unchanged bit for bit. The second has the dual arm's topology.
TIE_CHAINS = {
    "arm_7dof": ([-1, 0, 1, 2], [0.0, 1.0, 1.0, 0.0], [3], [6, 7, 8]),
    "dual_arm_14dof": ([-1, 0, 1, 2, 0, 4, 5], [0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0], [3, 6],
                       [6, 7, 8, 15, 16, 17]),
    # The humanoid's topology (id 4): each effector's own link of length 0.
    "humanoid_45dof": ([-1, 0, 1, 2, 2, 4, 5, 2, 7, 8, 0, 10, 11, 0, 13, 14],
                       [0.0, 0.5, 0.5, 0.0, 0.5, 0.5, 0.0, 0.5, 0.5, 0.0, 0.5, 0.5, 0.0, 0.5,
                        0.5, 0.0], [3, 6, 9, 12, 15],
                       [d for k in (3, 6, 9, 12, 15) for d in range(3 * (k - 1), 3 * k)]),
    # snake_30dof's topology (id 5) and a 17-node serial chain (the
    # serial-chain variant).
    "snake_30dof": (list(range(-1, 10)), [0.0] + [1.0] * 9 + [0.0], [10], [27, 28, 29]),
    "snake:16": (list(range(-1, 16)), [0.0] + [1.0] * 15 + [0.0], [16], [45, 46, 47]),
    # snake:50's 51 nodes (the serial-chain variant's scratch layout, lbest
    # in global scratch at P = 256).
    "snake:50": (list(range(-1, 50)), [0.0] + [1.0] * 49 + [0.0], [50], [147, 148, 149]),
    # reference_arm's topology (id 1): three zero-length effector links, so
    # the effectors sit on node 4 whatever their nine angles.
    "reference_arm": ([-1, 0, 1, 2, 3, 4, 4, 4], [0.0] + [1.0] * 4 + [0.0] * 3, [5, 6, 7],
                      list(range(12, 21))),
    # hand21's topology, built on demand (the cluster layout): each
    # fingertip link of length 0.
    "hand21": ([-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19],
               [0.0] + [0.3, 0.3, 0.3, 0.0] * 5, [4, 8, 12, 16, 20],
               [d for k in (4, 8, 12, 16, 20) for d in range(3 * (k - 1), 3 * k)]),
}


def phase_fused_tie(device, particles=128, model="arm_7dof"):
    """Kernel A's argmin on exact ties (``TIE_CHAINS``). All particles move
    alike in every other DOF and differently in the wrists; after one
    iteration every lval ties and the lbests differ only in the wrists, so
    gbest must carry particle 0's wrist angles, across all P / 32 warps
    (and the blocks of a cluster). Then NaN first (``_nan_first``)."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.models.chain import IKProblem, make_chain_spec
    from ikpso_tpu_torch.models.library import batched_problem
    from ikpso_tpu_torch.ops import fk as fk_ops
    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.pso.config import PSOConfig
    from ikpso_tpu_torch.pso.fused import fused_solve, kernel_a_layout, num_draws

    parents, lengths, effectors, wrist_dims = TIE_CHAINS[model]
    n = len(parents)
    spec = make_chain_spec(parents, lengths, np.full((n, 3), -np.pi), np.full((n, 3), np.pi),
                           effectors, device=device)
    problem = IKProblem(pose=torch.zeros(n, 3, device=device),
                        origin=torch.zeros(3, device=device),
                        targets=torch.zeros(len(effectors), 3, device=device))
    goal = torch.full((spec.dof,), 0.1, device=device)
    goal[wrist_dims] = 0.0
    tgt = fk_ops.effector_positions(
        spec, fk_ops.angles_to_pose(spec, problem.pose[0], goal), problem.origin)
    swarms = 4
    batched = batched_problem(problem, tgt[None].expand(swarms, len(effectors), 3))
    pso = PSOConfig(iterations=1, inertia_mode="canonical")
    fit = FitnessConfig(angle_weight=0.0)
    meta, swarm = _packed(spec, batched, fit)
    u = torch.full((swarms, num_draws(pso), spec.dof, particles), 0.6, device=device)
    wrist = torch.linspace(0.05, 0.95, particles, device=device).flip(0)
    u[:, 0, wrist_dims, :] = wrist
    want = np.float32(0.5) * (np.float32(wrist[0].item()) * np.float32(2) - np.float32(1))
    gb, gv = fused_solve(spec, pso, fit, meta, swarm, spec.limits(),
                         torch.zeros((swarms, 2), dtype=torch.int32, device=device),
                         particles, uniforms=u)
    torch.cuda.synchronize()
    got = gb[:, wrist_dims].cpu().numpy()
    ok = bool((got == want).all())
    layout = kernel_a_layout(spec, fit, swarm, particles)
    emit("fused_tie_lowest_id", model=model, swarms=swarms, particles=particles,
         tree=layout.tree, cluster=layout.cluster, threads=layout.threads,
         want=float(want), got=got[:, 0].tolist(), ok=ok)
    if not ok:
        raise AssertionError(f"kernel A broke an exact tie away from particle 0 ({model}, "
                             f"P={particles})")
    _nan_first(f"fused_tie {model}", spec, FitnessConfig(angle_weight=0.0), meta, swarm,
               particles, device)


def same_or_nan(a, b):
    """Equal, NaN where the other is NaN."""
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _nan_first(tag, spec, fit, meta, swarm, particles, device, num_obstacles=0,
               penalty=False):
    """Kernel A on a block whose fitness values mix NaN with numbers: a
    uniform init with NaN in the first position draw of particles P - 7 and
    P / 2 + 9 (a later warp, and a later block of a cluster). The plain
    twin's torch.argmin returns the first NaN, so gbest must be particle P /
    2 + 9's initial position, its first DOF NaN, and gval NaN, as
    fused_solve_plain gives them; with ``penalty`` (a scene every pose hits,
    so a NaN pose scores the collision penalty too) as fused_solve_plain
    gives them."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.pso.config import PSOConfig
    from ikpso_tpu_torch.pso.fused import (
        TWO_PI, fused_solve, fused_solve_plain, kernel_a_layout, num_draws)

    swarms = swarm.shape[0]
    pso = PSOConfig(iterations=2, inertia_mode="canonical", init_mode="uniform")
    u = torch.as_tensor(np.random.default_rng(5).random(
        (swarms, num_draws(pso), spec.dof, particles), dtype=np.float32), device=device)
    first = particles // 2 + 9
    u[:, 0, 0, [particles - 7, first]] = float("nan")
    zeros = torch.zeros((swarms, 2), dtype=torch.int32, device=device)
    lim = spec.limits()
    args = (spec, pso, fit, meta, swarm, lim, zeros, particles)
    gb, gv = fused_solve(*args, uniforms=u, num_obstacles=num_obstacles)
    want = fused_solve_plain(*args, uniforms=u, num_obstacles=num_obstacles)
    torch.cuda.synchronize()
    lo_c, hi_c = torch.clamp_min(lim[0], -TWO_PI), torch.clamp_max(lim[1], TWO_PI)
    x0 = lo_c + u[:, 0, :, first] * (hi_c - lo_c)
    ok = same_or_nan(gb, want[0]) and same_or_nan(gv, want[1]) and (
        penalty or (bool(torch.isnan(gv).all()) and same_or_nan(gb, x0)))
    layout = kernel_a_layout(spec, fit, swarm, particles, num_obstacles)
    emit("fused_nan_first", case=tag, particles=particles, nan_particles=[first,
                                                                          particles - 7],
         cluster=layout.cluster, placement=layout.placement, threads=layout.threads,
         tree=layout.tree,
         equals_plain=same_or_nan(gb, want[0]) and same_or_nan(gv, want[1]), ok=ok)
    if not ok:
        raise AssertionError(f"kernel A did not put NaN first as its plain twin ({tag}, "
                             f"P={particles})")


def phase_fused_philox(device, swarms=1024, particles=128):
    import numpy as np
    import torch

    pso, fit = _headline_configs()
    rng = np.random.default_rng(3)
    spec, batched = _problem("arm_7dof", swarms, rng, device)
    meta, swarm = _packed(spec, batched, fit)
    seeds = torch.as_tensor(
        rng.integers(-2**31, 2**31, (swarms, 2), dtype=np.int64).astype(np.int32),
        device=device)
    return _compare_solve("fused_philox_vs_plain", spec, pso, fit, meta, swarm,
                          seeds, particles, None)


def _orientation_configs(iterations=None):
    """The orientation path's base PSO and fitness settings, at
    ``iterations`` if given."""
    import dataclasses

    from ikpso_tpu_torch.harness.orientation import orientation_configs

    _, pso, fit = orientation_configs()
    return dataclasses.replace(pso, iterations=iterations or pso.iterations), fit


def phase_fk_fitness_orientation(device, swarms=TIMING_SWARMS, particles=128):
    """Kernel B's orientation branch on arm_6dof against fk_fitness_plain:
    equal values bit for bit."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness, fk_fitness_plain

    rng = np.random.default_rng(11)
    spec, batched = _problem("arm_6dof", swarms, rng, device, orientation=True)
    fit = FitnessConfig(angle_weight=3.0, orientation_weight=1.0)
    meta, swarm = _packed(spec, batched, fit, use_orientation=True)
    lim = spec.limits().cpu().numpy()
    x = lim[0] + rng.random((swarms, particles, spec.dof)) * (lim[1] - lim[0])
    x = torch.as_tensor(x.astype("float32"), device=device)
    got = fk_fitness(spec, x, meta, swarm, use_orientation=True)
    want = fk_fitness_plain(spec, x, meta, swarm, use_orientation=True)
    torch.cuda.synchronize()
    err = check_fitness("fk_fitness_orientation", got, want, exact=True)
    emit("fk_fitness_orientation", model="arm_6dof", swarms=swarms, particles=particles,
         max_abs_err=err, bitwise_equal=bool(torch.equal(got, want)),
         bar="max abs error 0.0", ok=True)
    return err


# Kernel A's branch replays: (tag, model, orientation, PSOConfig fields over
# the headline's canonical 8-iteration config).
BRANCH_CASES = (
    ("rekick", "arm_7dof", False, dict(rekick_interval=4, rekick_scale=0.5)),
    ("rekick_threshold", "arm_7dof", False,
     dict(rekick_interval=4, rekick_scale=0.5, rekick_threshold=1e-6)),
    # A threshold that splits the swarms: some kicked, some not.
    ("rekick_threshold_split", "arm_7dof", False,
     dict(rekick_interval=4, rekick_scale=0.5, rekick_threshold=1e-2)),
    ("randomized", "arm_7dof", False, dict(inertia_mode="randomized", inertia_end=-1.0)),
    ("randomized_rekick", "arm_7dof", False,
     dict(inertia_mode="randomized", inertia_end=-1.0, rekick_interval=4,
          rekick_scale=0.5)),
    ("gbest_interval", "arm_7dof", False, dict(gbest_interval=2)),
    ("arm_6dof_orientation", "arm_6dof", True,
     dict(init_mode="uniform", rekick_interval=4, rekick_scale=0.5, rekick_threshold=1e-6)),
)


def phase_fused_branch_replay(device, swarms=1024, particles=128):
    """Kernel A's randomized-inertia, gbest-interval, re-kick and
    orientation branches against fused_solve_plain on the same injected
    uniforms, bit for bit; then the arm_6dof case on the live Philox
    stream, bit for bit."""
    import dataclasses

    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.pso.fused import fused_solve_plain, num_draws

    pso0, fit0 = _headline_configs()
    worst = 0.0
    for tag, name, orient, fields in BRANCH_CASES:
        rng = np.random.default_rng(12)
        spec, batched = _problem(name, swarms, rng, device, orientation=orient)
        pso = dataclasses.replace(pso0, **fields)
        fit = dataclasses.replace(fit0, orientation_weight=1.0 if orient else 0.0)
        meta, swarm = _packed(spec, batched, fit, use_orientation=orient)
        u = torch.as_tensor(rng.random((swarms, num_draws(pso), spec.dof, particles),
                                       dtype=np.float32), device=device)
        seeds = torch.zeros((swarms, 2), dtype=torch.int32, device=device)
        kicked = []
        fused_solve_plain(spec, pso, fit, meta, swarm, spec.limits(), seeds, particles,
                          uniforms=u, use_orientation=orient,
                          on_kick=lambda k: kicked.append(int(k.sum())))
        worst = max(worst, _compare_solve(
            "fused_branch_replay", spec, pso, fit, meta, swarm, seeds, particles, u,
            bitwise=True, use_orientation=orient, case=tag, kicked_per_block=kicked))
    rng = np.random.default_rng(13)
    spec, batched = _problem("arm_6dof", swarms, rng, device, orientation=True)
    pso = dataclasses.replace(pso0, **BRANCH_CASES[-1][3])
    fit = FitnessConfig(angle_weight=0.0, distance_weight=0.0, orientation_weight=1.0)
    meta, swarm = _packed(spec, batched, fit, use_orientation=True)
    seeds = torch.as_tensor(
        rng.integers(-2**31, 2**31, (swarms, 2), dtype=np.int64).astype(np.int32),
        device=device)
    worst = max(worst, _compare_solve(
        "fused_branch_philox", spec, pso, fit, meta, swarm, seeds, particles, None,
        bitwise=True, use_orientation=True, case="arm_6dof_orientation"))
    return worst


def _scene(spec, device):
    from ikpso_tpu_torch.harness.obstacles import obstacle_scene

    return obstacle_scene(spec, 4, device)


def _rotated_scene(spec, device, rng, n=4):
    """n boxes of random orientation (unit quaternions) and size, 0.03-0.2
    of the chain's reach on a side, around its workspace."""
    import numpy as np

    from ikpso_tpu_torch.models.chain import Obstacles

    reach = float(np.abs(spec.length.cpu().numpy()).sum())
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return Obstacles.from_boxes(
        rng.normal(0.0, 0.45 * reach, (n, 3)).astype("float32"),
        (rng.uniform(0.2, 1.5, (n, 3)) * 0.15 * reach).astype("float32"),
        quats.astype("float32"), device=device)


def phase_fk_fitness_obstacles(device, swarms=4096, particles=128):
    """Kernel B's box and capsule branches against fk_fitness_plain on
    random in-limit angles, bit for bit on the hit mask and the free lanes,
    in three scenes: the slice's 4-box ring, the near ring
    (``_near_scene``) and rotated boxes; with the share of (node, obstacle)
    pairs the slab reject decides (``utils.flops.collider_work``'s mirror
    of it), which must lie strictly between 0 and 1 in each."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness, fk_fitness_plain
    from ikpso_tpu_torch.utils import flops

    errs = {}
    for shape in ("box", "capsule"):
        rng = np.random.default_rng(5)
        spec, batched = _problem("arm_7dof", swarms, rng, device)
        scenes = {"ring": _scene(spec, device), "near": _near_scene(spec, device),
                  "rotated": _rotated_scene(spec, device, rng)}
        lim = spec.limits().cpu().numpy()
        x = lim[0] + rng.random((swarms, particles, spec.dof)) * (lim[1] - lim[0])
        x = torch.as_tensor(x.astype("float32"), device=device)
        fit = FitnessConfig(angle_weight=3.0, collision_shape=shape)
        for tag, obs in scenes.items():
            meta, swarm = _packed(spec, batched, fit, obs)
            kw = dict(num_obstacles=obs.count, collision_shape=shape)
            got = fk_fitness(spec, x, meta, swarm, **kw)
            want = fk_fitness_plain(spec, x, meta, swarm, **kw)
            torch.cuda.synchronize()
            hit_k, hit_p = got >= FLT_MAX, want >= FLT_MAX
            free = ~hit_p
            err = float((got[free] - want[free]).abs().max()) if bool(free.any()) else 0.0
            stats = {}
            flops.collider_work(spec, x, meta, swarm, stats=stats, chunk=1 << 19, **kw)
            share = stats["rejected"] / stats["pairs"]
            hit_share = float(hit_p.float().mean())
            errs[shape if tag == "ring" else f"{shape} {tag}"] = err
            ok = bool(torch.equal(hit_k, hit_p) and torch.isfinite(got).all() and err == 0.0
                      and 0.0 < hit_share < 1.0 and 0.0 < share < 1.0)
            emit("fk_fitness_obstacles", collision_shape=shape, scene=tag, swarms=swarms,
                 particles=particles, obstacles=obs.count, hit_share=hit_share,
                 reject_share=share, reject_pairs=stats["pairs"],
                 mask_mismatches=int((hit_k != hit_p).sum()), max_abs_err_free=err,
                 bar="equal masks, max abs error 0.0 on free lanes", ok=ok)
            if not ok:
                raise AssertionError(f"kernel B ({shape}, {tag} scene) disagrees with "
                                     "fk_fitness_plain, or the scene does not both hit and "
                                     "miss, or the reject decides all or no pairs")
    return errs


def phase_fused_obstacles_replay(device, swarms=1024, particles=128):
    """Kernel A with the scene against fused_solve_plain in replay, one
    case per (init mode, collider) on the slice's paths; bit-identical."""
    import dataclasses

    import numpy as np
    import torch

    from ikpso_tpu_torch.pso.fused import num_draws

    pso0, fit0 = _headline_configs()
    worst = 0.0
    cases = (("uniform", "box", 24), ("hybrid", "capsule", 8), ("warm", "box", 8))
    for init_mode, shape, iters in cases:
        rng = np.random.default_rng(6)
        spec, batched = _problem("arm_7dof", swarms, rng, device)
        obs = _scene(spec, device)
        pso = dataclasses.replace(pso0, init_mode=init_mode, iterations=iters)
        fit = dataclasses.replace(fit0, collision_shape=shape)
        meta, swarm = _packed(spec, batched, fit, obs)
        u = rng.random((swarms, num_draws(pso), spec.dof, particles), dtype=np.float32)
        seeds = torch.zeros((swarms, 2), dtype=torch.int32, device=device)
        worst = max(worst, _compare_solve(
            "fused_obstacles_replay", spec, pso, fit, meta, swarm, seeds, particles,
            torch.as_tensor(u, device=device), num_obstacles=obs.count, bitwise=True,
            collision_shape=shape))
    return worst


def phase_fused_penalty_ties(device, swarms=4, particles=128):
    """Every pose collides (one box 100 on a side swallows arm_7dof's
    reach): gval must be FLT_MAX and gbest particle 0's initial position,
    the first-minimum rule on ties at the penalty, with no NaN. Then NaN
    among those poses: the box collider scores a NaN pose at the penalty
    (a NaN fails every separating-axis test), the capsule collider calls it
    no hit (its distances are NaN, jnp.maximum's rule), so it scores NaN
    and goes first; kernel A as fused_solve_plain gives them."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.models.chain import Obstacles
    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.pso.config import PSOConfig
    from ikpso_tpu_torch.pso.fused import TWO_PI, fused_solve, num_draws

    rng = np.random.default_rng(7)
    spec, batched = _problem("arm_7dof", swarms, rng, device)
    obs = Obstacles.from_boxes([(0.0, 0.0, 0.0)], [(100.0, 100.0, 100.0)], device=device)
    pso = PSOConfig(iterations=4, inertia_mode="canonical", init_mode="uniform")
    lim = spec.limits()
    lo_c, hi_c = torch.clamp_min(lim[0], -TWO_PI), torch.clamp_max(lim[1], TWO_PI)
    for shape in ("box", "capsule"):
        fit = FitnessConfig(angle_weight=0.0, collision_shape=shape)
        meta, swarm = _packed(spec, batched, fit, obs)
        u = torch.as_tensor(rng.random((swarms, num_draws(pso), spec.dof, particles),
                                       dtype=np.float32), device=device)
        gb, gv = fused_solve(spec, pso, fit, meta, swarm, lim,
                             torch.zeros((swarms, 2), dtype=torch.int32, device=device),
                             particles, uniforms=u, num_obstacles=obs.count)
        torch.cuda.synchronize()
        want = lo_c + u[:, 0, :, 0] * (hi_c - lo_c)
        ok = bool((gv == FLT_MAX).all() and torch.equal(gb, want)
                  and not torch.isnan(gb).any() and not torch.isnan(gv).any())
        emit("fused_penalty_ties", collision_shape=shape, swarms=swarms,
             particles=particles, gval=gv.tolist(),
             gbest_equals_particle0_x0=bool(torch.equal(gb, want)), ok=ok)
        if not ok:
            raise AssertionError("kernel A broke a tie at the collision penalty")
        # NaN among particles tied at the penalty: the box's penalty, the
        # capsule's miss (NaN first, gval NaN).
        _nan_first(f"penalty {shape}", spec, fit, meta, swarm, particles, device,
                   obs.count, penalty=shape == "box")


def phase_fused_fitness(device, swarms=64, particles=1024):
    """Kernel C against fused_fitness_plain on random in-limit (S, D, P)
    angles, for every collider: equal hit masks, max abs error 0.0 on
    free particles; and once at a P that is no multiple of the block."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.ops.fitness_kernel import fused_fitness, fused_fitness_plain

    errs = {}
    for shape, p in (("none", particles), ("box", particles), ("capsule", particles),
                     ("orientation", particles), ("none", 1000)):
        rng = np.random.default_rng(9)
        orient = shape == "orientation"
        spec, batched = _problem("arm_6dof" if orient else "arm_7dof", swarms, rng, device,
                                 orientation=orient)
        obs = None if shape in ("none", "orientation") else _scene(spec, device)
        fit = FitnessConfig(angle_weight=3.0, orientation_weight=1.0 if orient else 0.0,
                            collision_shape=shape if obs is not None else "box")
        meta, swarm = _packed(spec, batched, fit, obs, use_orientation=orient)
        lim = spec.limits().cpu().numpy()
        x = lim[0][:, None] + rng.random((swarms, spec.dof, p)) * (lim[1] - lim[0])[:, None]
        x = torch.as_tensor(x.astype("float32"), device=device)
        kw = dict(num_obstacles=0 if obs is None else obs.count,
                  collision_shape=fit.collision_shape, use_orientation=orient)
        got = fused_fitness(spec, x, meta, swarm, **kw)
        want = fused_fitness_plain(spec, x, meta, swarm, **kw)
        torch.cuda.synchronize()
        hit_k, hit_p = got >= FLT_MAX, want >= FLT_MAX
        free = ~hit_p
        err = float((got[free] - want[free]).abs().max())
        errs.setdefault(shape, err)
        ok = bool(torch.equal(hit_k, hit_p) and torch.isfinite(got).all() and err == 0.0
                  and (obs is None or 0.01 < float(hit_p.float().mean()) < 0.99))
        emit("fused_fitness", collision_shape=shape, swarms=swarms, particles=p,
             hit_share=float(hit_p.float().mean()),
             mask_mismatches=int((hit_k != hit_p).sum()), max_abs_err_free=err,
             bar="equal masks, max abs error 0.0 on free particles", ok=ok)
        if not ok:
            raise AssertionError(f"kernel C ({shape}, P={p}) disagrees with "
                                 "fused_fitness_plain")
    return errs


# The scan step (csrc/scan_step.cu(h)) against pso_iteration on kernel C's
# plain twin, whole solves on the same draws: case -> (model, swarms,
# particles, PSOConfig overrides of scan_configs, angle weight, scene,
# draws). "replay": torch.rand blocks injected on both sides (ScanDraws; the
# replay step). "drawing": the kernel side draws from a seeded generator
# (the drawing step, the solver's route), the plain side is fed the same
# generator's draws through drawing_route_draws (step_uniforms' blocks).
# "scan" is the scan path's own shape; "reference_arm" the experiment's P
# (64 blocks a swarm); "hook" records each step's candidate through a
# gbest_reduce hook on both sides; "on_demand_box" is the on-demand entry
# (dual_arm_box's library).
SCAN_REPLAY_CASES = {
    "scan": ("arm_7dof", SCAN_SWARMS, 1024, {}, 0.0, False, "drawing"),
    "reference_arm": ("reference_arm", 8, 16_384, {"iterations": 15}, 3.0, False, "replay"),
    "box": ("arm_7dof", SCAN_REPLAY_SWARMS, 1024, {"iterations": 20, "init_mode": "uniform"},
            0.3, True, "replay"),
    "canonical": ("arm_7dof", SCAN_REPLAY_SWARMS, 1024,
                  {"iterations": 20, "inertia_mode": "canonical", "inertia_end": 0.2}, 0.3,
                  False, "replay"),
    "rekick": ("arm_7dof", SCAN_REPLAY_SWARMS, 1024,
               {"iterations": 20, "rekick_interval": 4, "rekick_threshold": 1e-4}, 0.3,
               False, "replay"),
    "ragged": ("arm_7dof", SCAN_REPLAY_SWARMS, 1000, {"iterations": 20}, 0.3, False,
               "replay"),
    "hook": ("arm_7dof", SCAN_REPLAY_SWARMS, 1024, {"iterations": 20}, 0.3, False, "replay"),
    "on_demand_box": ("dual_arm_14dof", 64, 1024, {"iterations": 10}, 0.3, True, "replay"),
    "reference_arm_drawing": ("reference_arm", 8, 16_384, {"iterations": 15}, 3.0, False,
                              "drawing"),
    "box_drawing": ("arm_7dof", SCAN_REPLAY_SWARMS, 1024,
                    {"iterations": 20, "init_mode": "uniform"}, 0.3, True, "drawing"),
    "canonical_drawing": ("arm_7dof", SCAN_REPLAY_SWARMS, 1024,
                          {"iterations": 20, "inertia_mode": "canonical", "inertia_end": 0.2},
                          0.3, False, "drawing"),
    "rekick_drawing": ("arm_7dof", SCAN_REPLAY_SWARMS, 1024,
                       {"iterations": 20, "rekick_interval": 4, "rekick_threshold": 1e-4},
                       0.3, False, "drawing"),
    "ragged_drawing": ("arm_7dof", SCAN_REPLAY_SWARMS, 1000, {"iterations": 20}, 0.3, False,
                       "drawing"),
    # P * D odd: every other swarm's slab starts off a 16-byte boundary, the
    # step's 4-byte path.
    "odd_drawing": ("arm_7dof", SCAN_REPLAY_SWARMS, 257, {"iterations": 20}, 0.3, False,
                    "drawing"),
    "hook_drawing": ("arm_7dof", SCAN_REPLAY_SWARMS, 1024, {"iterations": 20}, 0.3, False,
                     "drawing"),
    "on_demand_box_drawing": ("dual_arm_14dof", 64, 1024, {"iterations": 10}, 0.3, True,
                              "drawing"),
}


def _states_equal(a, b):
    """Tuples of tensors equal element for element (NaN where NaN)."""
    import torch

    return all(x.shape == y.shape and torch.equal(x.isnan(), y.isnan())
               and torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0)) for x, y in zip(a, b))


def _scan_replay_case(device, name):
    """One ``SCAN_REPLAY_CASES`` solve through the step and through
    ``pso_iteration`` on kernel C's plain twin."""
    import dataclasses

    import numpy as np
    import torch

    from ikpso_tpu_torch.harness.scan import scan_configs
    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.ops.fitness_kernel import make_kernel_fitness
    from ikpso_tpu_torch.pso.solver import (ScanDraws, draws_per_iteration,
                                            drawing_route_draws, scan_step, solve)

    model, swarms, particles, over, aw, scene, mode = SCAN_REPLAY_CASES[name]
    pso = dataclasses.replace(scan_configs()[0], **over)
    fit = FitnessConfig(angle_weight=aw, distance_weight=0.0, orientation_weight=0.0)
    rng = np.random.default_rng(8)
    spec, batched = _problem(model, swarms, rng, device)
    obstacles = _scene(spec, device) if scene else None
    fitness = make_kernel_fitness(spec, batched, fit, obstacles)
    shape = (swarms, particles, spec.dof)
    if mode == "replay":
        gen = torch.Generator(device=device).manual_seed(8)
        draws = ScanDraws(
            torch.rand(shape, generator=gen, device=device) if pso.init_mode != "warm"
            else None, torch.rand(shape, generator=gen, device=device),
            torch.rand((pso.iterations, draws_per_iteration(pso)) + shape, generator=gen,
                       device=device))
        sides = {False: (None, draws), True: (None, draws)}
    else:
        sides = {False: (torch.Generator(device=device).manual_seed(8), None),
                 True: (None, drawing_route_draws(torch.Generator(device=device).manual_seed(8),
                                                  pso, *shape, device))}
    res, cands, steps, replays = {}, {False: [], True: []}, {}, {}
    for plain, fn in ((False, fitness), (True, fitness.plain)):
        before, replay_before = scan_step.launches, scan_step.replay_launches
        res[plain] = solve(spec, batched, sides[plain][0], pso, fit, obstacles=obstacles,
                           num_particles=particles, fitness_fn=fn, uniforms=sides[plain][1],
                           gbest_reduce=_recording_hook(cands[plain])
                           if name.startswith("hook") else None)
        steps[plain] = scan_step.launches - before
        replays[plain] = scan_step.replay_launches - replay_before
    torch.cuda.synchronize()
    k, p = res[False], res[True]
    equal = _states_equal((k.angles, k.fitness, k.trace), (p.angles, p.fitness, p.trace))
    cands_equal = len(cands[False]) == len(cands[True]) and all(
        _states_equal(a, b) for a, b in zip(cands[False], cands[True]))
    hits = None
    if scene:
        hits = float((fitness.plain(k.angles[:, None, :]) >= FLT_MAX).float().mean())
    want_replays = pso.iterations if mode == "replay" else 0
    ok = (equal and cands_equal and steps == {False: pso.iterations, True: 0}
          and replays == {False: want_replays, True: 0}
          and bool(torch.isfinite(k.fitness).all()))
    emit("scan_replay", case=name, model=model, swarms=swarms, particles=particles,
         iterations=pso.iterations, inertia_mode=pso.inertia_mode,
         rekick=[pso.rekick_interval, pso.rekick_threshold], scene=bool(scene),
         draws=mode, hook_candidates=len(cands[False]),
         step_launches=steps[False], replay_step_launches=replays[False],
         plain_step_launches=steps[True],
         gbest_max_abs_err=float((k.angles - p.angles).abs().max()),
         gval_max_abs_err=float((k.fitness - p.fitness).abs().max()),
         colliding_solutions=hits, bitwise_equal=equal, candidates_equal=cands_equal,
         bar="torch.equal on angles, fitness and trace; drawing: the plain side fed "
             "step_uniforms' blocks", ok=ok)
    if not ok:
        raise AssertionError(f"scan_replay {name}: the {mode} scan step disagrees with "
                             "pso_iteration on kernel C's plain twin")


def _recording_hook(rec):
    """A gbest_reduce hook that records each candidate and passes it on."""
    def hook(val, coords):
        rec.append((val.clone(), coords.clone()))
        return val, coords
    return hook


def _scan_replay_tie(device, swarms=64, particles=1024):
    """Two steps on a state whose lbest values are forced: step 0 ties the
    minimum at particles 255, 256 and 700 (a block edge and a later block:
    the first must win, and gbest take its row); step 1 puts a NaN at
    particle 900 (a NaN is the minimum), read through a recording hook."""
    import dataclasses

    import numpy as np
    import torch

    from ikpso_tpu_torch.harness.scan import scan_configs
    from ikpso_tpu_torch.ops import fk as fk_ops
    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.ops.fitness_kernel import make_kernel_fitness
    from ikpso_tpu_torch.pso.solver import (draws_per_iteration, init_swarm, pso_iteration,
                                            scan_step, step_buffers, step_work)

    pso = dataclasses.replace(scan_configs()[0], init_mode="uniform")
    fit = FitnessConfig(angle_weight=0.3, distance_weight=0.0, orientation_weight=0.0)
    rng = np.random.default_rng(10)
    spec, batched = _problem("arm_7dof", swarms, rng, device)
    fitness = make_kernel_fitness(spec, batched, fit)
    gen = torch.Generator(device=device).manual_seed(10)
    lo, hi = spec.limits().to(device)
    limits = torch.stack((lo, hi)).contiguous()
    shape = (swarms, particles, spec.dof)
    state = init_swarm(None, fk_ops.pose_to_angles(spec, batched.pose), particles, fitness,
                       pso, limits=(lo, hi),
                       uniforms=(torch.rand(shape, generator=gen, device=device),
                                 torch.rand(shape, generator=gen, device=device)))
    mine = step_buffers(state)
    plain = tuple(t.clone() for t in mine)
    work = step_work(swarms, particles, device)
    cands = {False: [], True: []}
    equal = []
    for it in range(2):
        for st in (mine, plain):
            if it == 0:
                st[3].fill_(1.0)
                st[3][:, [255, 256, 700]] = 0.0
            else:
                st[3][:, 900] = float("nan")
        u = torch.rand((draws_per_iteration(pso),) + shape, generator=gen, device=device)
        mine = scan_step(fitness, *mine, u, limits, pso, iteration=it, work=work,
                         gbest_reduce=_recording_hook(cands[False]) if it else None)
        plain = pso_iteration(*plain, u, fitness.plain, lo, hi, pso, iteration=it,
                              gbest_reduce=_recording_hook(cands[True]) if it else None)
        torch.cuda.synchronize()
        equal.append(_states_equal(mine, plain))
        if it == 0:
            first = torch.equal(mine[4], mine[2][:, 255]) and bool((mine[5] == 0.0).all())
    nan_first = (bool(cands[False][0][0].isnan().all())
                 and torch.equal(cands[False][0][1], mine[2][:, 900]))
    ok = bool(all(equal) and first and nan_first
              and _states_equal(cands[False][0], cands[True][0])
              and int(work.arrivals.abs().sum()) == 0)
    emit("scan_replay", case="tie", model="arm_7dof", swarms=swarms, particles=particles,
         tie_at=[255, 256, 700], first_minimum_won=first, nan_at=900,
         nan_candidate_won=nan_first, bitwise_equal=equal,
         bar="torch.equal on the state after each step; particle 255, then the NaN", ok=ok)
    if not ok:
        raise AssertionError("scan_replay tie: the step broke a tie or a NaN unlike "
                             "pso_iteration")


def phase_scan_replay(device):
    """The scan step, drawing and replay, against ``pso_iteration`` on kernel
    C's plain twin, bit for bit (``SCAN_REPLAY_CASES`` and a forced tie);
    returns the largest error (0.0: a difference raises)."""
    for name in SCAN_REPLAY_CASES:
        _scan_replay_case(device, name)
    _scan_replay_tie(device)
    return 0.0


def _device_events(prof):
    """``(name, start_ns, end_ns)`` of every device event in a profile (the
    kernels, memcpys and memsets), read from the raw profiler events through
    ``prof.profiler.kineto_results``, a private attribute of
    ``torch.profiler.profile``: ``key_averages()`` first parses every event
    into Python objects, which took minutes on the solves of 10^5 small
    launches."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]


def _device_ms(prof, groups):
    """Device milliseconds in a profile: busy (the union of the device events'
    spans, so events that overlap count once), and the summed spans of each
    group of kernel-name substrings ``{name: (substring, ...)}``."""
    busy, end = 0, None
    out = {name: 0 for name in groups}
    for name, t0, t1 in sorted(_device_events(prof), key=lambda e: e[1]):
        if end is None or t0 >= end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
        for group, keys in groups.items():
            if any(k in name for k in keys):
                out[group] += t1 - t0
                break
    return busy / 1e6, {k: v / 1e6 for k, v in out.items()}


def _device_ms_readings(prof, kernel):
    """One profile's device ms read three ways: the summed raw event spans,
    their union (what ``_device_ms`` reports as busy), and the self device
    time of ``key_averages()``'s device entries (the public reading); each in
    all and for kernels whose name holds ``kernel``."""
    from torch.autograd import DeviceType

    events = _device_events(prof)
    union, group = _device_ms(prof, {"k": (kernel,)})
    averages = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]

    def self_us(a):
        us = getattr(a, "self_device_time_total", None)
        return a.self_cuda_time_total if us is None else us

    return {"raw_sum_ms": sum(t1 - t0 for _, t0, t1 in events) / 1e6,
            "union_ms": union,
            "key_averages_ms": sum(self_us(a) for a in averages) / 1e3,
            "raw_kernel_ms": group["k"],
            "key_averages_kernel_ms": sum(self_us(a) for a in averages
                                          if kernel in a.key) / 1e3,
            "events": len(events)}


# Kernel A's kernels (csrc/fused_solve.cuh): the register layout (its
# general loop, the short chains, the trees' tree loop), the serial-chain
# variant, the scratch layout and the cluster layout.
KERNEL_A_NAMES = ("fused_solve_kernel", "fused_solve_short_kernel", "fused_solve_tree_kernel",
                  "fused_solve_serial_kernel", "fused_solve_tree_scratch_kernel",
                  "fused_solve_tree_cluster_kernel")
# The scan solver's device time by kernel: the step, kernel C (init), torch's
# random draws (torch.rand), and the rest ("other": every other op).
SCAN_SPLIT = {"scan_step": ("scan_step_kernel",), "kernel_c": ("fused_fitness_kernel",),
              "torch_rand": ("distribution",)}


def _rand_launches(prof):
    """Kernels of torch's random draws (``SCAN_SPLIT["torch_rand"]``: the
    init blocks' ``torch.rand``, the seed words' ``torch.randint``) in a
    profile."""
    return sum(any(k in name for k in SCAN_SPLIT["torch_rand"])
               for name, _, _ in _device_events(prof))


def _device_split(prof):
    """Device ms in a profile: busy, and its split by ``SCAN_SPLIT`` with
    the rest as ``other``; None when the profiler recorded no device time."""
    busy, ms = _device_ms(prof, SCAN_SPLIT)
    if busy <= 0:
        return None
    return {"busy": busy, **ms, "other": busy - sum(ms.values())}


def phase_scan(device, card, swarms=SCAN_SWARMS):
    """The scan solver at full size through run_scan (kernel C at init, the
    scan step each iteration), launch counts read around it; then one more
    solve under the profiler, its device time split by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ikpso_tpu_torch.harness.headline import reachable_targets
    from ikpso_tpu_torch.harness.scan import ITERATIONS, PARTICLES, build_scan_solver, run_scan
    from ikpso_tpu_torch.models import library

    torch.cuda.reset_peak_memory_stats(device)
    warmup, iters = 1, 3
    reset_counts()
    out = run_scan(swarms=swarms, device=device, seed=0, warmup=warmup, iters=iters)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    # Device busy vs wall over one more solve (not counted above).
    spec, problem = library.arm_7dof(device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    batched = library.batched_problem(problem, reachable_targets(spec, problem, swarms, gen))
    solver = build_scan_solver(spec, batched, PARTICLES, ITERATIONS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver(batched, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    split = _device_split(prof)
    readings = _device_ms_readings(prof, "scan_step_kernel")
    # The drawing step draws every iteration's uniforms: the solve's only
    # random kernels are its init velocity block and its seed words.
    rand_launches = _rand_launches(prof) if split is not None else None
    solves = warmup + iters
    ok = (launches["fused_fitness"] == solves and launches["scan_step"] == ITERATIONS * solves
          and launches["scan_step_replay"] == 0
          and (rand_launches is None or rand_launches <= 2)
          and out["finite"] and out["p50_err_mm"] < 1.0
          and out["frac_under_1mm"] >= SCAN_FRAC_BAR)
    emit("scan", **out, wall_ms=out["wall_s"] * 1e3, launches=launches,
         max_memory_allocated=peak, profiled_wall_ms=wall_ms, device_ms=split,
         scan_step_ms_per_launch=None if split is None else split["scan_step"] / ITERATIONS,
         device_idle_share=None if split is None else 1.0 - split["busy"] / wall_ms,
         device_ms_readings=readings, torch_rand_launches=rand_launches,
         rand_launches_bar="<= 2 (init velocity block, seed words): none in the loop",
         jax_frac_under_1mm=SCAN_JAX_FRAC_UNDER_1MM, frac_bar=SCAN_FRAC_BAR, card=card,
         ok=bool(ok))
    if not ok:
        raise AssertionError("scan path missed its bar or bypassed the scan step")
    return launches


def phase_roofline(device, card, e_per_call):
    """Path 2, the roofline: kernel D's three ceilings, kernel E's draw
    rate, kernel C's and kernel A's loop rates and the headline's
    sol_frac, launch counts read around them; then D and E against
    their plain twins, their timed launches and E's library yardstick."""
    import torch

    from ikpso_tpu_torch.harness.headline import headline_sol
    from ikpso_tpu_torch.utils import roofline as rl

    peak_ops = rl.PUBLISHED_PEAKS["fp32_ops_per_s"]
    reset_counts()
    rates = {
        "fma_flops_per_s": rl.measure_fma_peak(device=device),
        "compose_flops_per_s": rl.measure_compose_peak(device=device),
        "transcendental_per_s": rl.measure_transcendental_peak(device=device),
        "rng_words_per_s": rl.measure_rng_peak(device=device),
    }
    kf, ke, kb = rl.measure_fitness_kernel_rate(device=device)
    rates.update(fitness_kernel_ops_per_s=kf, fitness_kernel_evals_per_s=ke,
                 fitness_kernel_bytes_per_s=kb,
                 kernel_ops_per_s=rl.measure_megakernel_rate(device=device))
    sol = headline_sol(device=device)
    launches = read_counts()
    share = {k: rates[k] / peak_ops for k in ("fma_flops_per_s", "compose_flops_per_s",
                                             "transcendental_per_s",
                                             "fitness_kernel_ops_per_s",
                                             "kernel_ops_per_s")}
    share["rng_int_ops"] = rates["rng_words_per_s"] / 4 * rl.E_OPS_PER_STEP / peak_ops
    share["fitness_kernel_bytes_per_s"] = kb / rl.PUBLISHED_PEAKS["hbm_bytes_per_s"]

    # Outside the counted window: D's and E's timed launches, E's output
    # held against its plain twin's at that shape; D's against its plain
    # twin's at the timed element count and a step count where every
    # value stays finite.
    elems, d_steps = D_TIMED
    xd = torch.linspace(0.1, 0.9, elems, device=device, dtype=torch.float32)
    d_err = {}
    for body in rl.BODIES:
        got = rl.roofline_body(body, xd, D_STEPS)
        want = rl.roofline_body_plain(body, xd, D_STEPS)
        torch.cuda.synchronize()
        if not (torch.isfinite(want).all() and torch.allclose(got, want, rtol=D_RTOL, atol=0)):
            raise AssertionError(f"kernel D ({body}) disagrees with its plain twin")
        d_err[body] = float((got - want).abs().max())
    del got, want
    n_e, e_steps = E_TIMED
    timed = {
        "d_fma_ms": cuda_time_ms(lambda: rl.roofline_body("fma", xd, d_steps), reps=10),
        "d_fma_plain_ms": cuda_time_ms(lambda: rl.roofline_body_plain("fma", xd, d_steps),
                                       reps=1),
        "e_library_ms": cuda_time_ms(
            lambda: torch.rand(4 * n_e * e_steps, device=device), reps=5),
    }
    del xd
    timed["e_ms"], e_got = cuda_time(lambda: rl.philox_xor((7, 11), n_e, e_steps, device),
                                     reps=10)
    timed["e_plain_ms"], e_want = cuda_time(
        lambda: rl.philox_xor_plain((7, 11), n_e, e_steps, device), reps=1)
    if not torch.equal(e_got, e_want):
        raise AssertionError("kernel E disagrees with philox_xor_plain")
    # E against its integer issue ceiling, the SM clock read under load.
    for _ in range(E_CLOCK_LAUNCHES):
        rl.philox_xor((7, 11), n_e, e_steps, device)
    clocks = card_clocks()
    torch.cuda.synchronize()
    sm_hz = float(clocks.split(",")[0].split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    issue_ms = (n_e * e_steps * e_per_call
                / (INT_LANES_PER_SM_CLOCK * sms * sm_hz) * 1e3)
    timed["e_issue"] = {"int_instructions_per_call": e_per_call, "sms": sms,
                        "clocks_under_load": clocks, "issue_bound_ms": issue_ms,
                        "issue_share": issue_ms / timed["e_ms"]}
    counts = {"d_fma": rl.roofline_body_count("fma", elems, d_steps),
              "e": rl.philox_xor_count(n_e, e_steps)}
    emit("roofline", **rates, published_peaks=rl.PUBLISHED_PEAKS, share_of_published=share,
         headline_sol=sol, launches=launches, d_max_abs_err=d_err, d_rtol=D_RTOL,
         d_checked={"elems": elems, "steps": D_STEPS},
         e_bitwise_equal_at_timed_shape=True, d_timed={"elems": elems, "steps": d_steps},
         e_timed={"threads": n_e, "steps": e_steps}, **timed, card=card, ok=True)
    return launches, timed, counts, d_err, sol


def phase_obstacles(device, swarms, card, shape):
    """The obstacle-scene slice through run_obstacles, launch counts read
    around it."""
    from ikpso_tpu_torch.harness.obstacles import run_obstacles

    reset_counts()
    out = run_obstacles(swarms=swarms, device=device, seed=0, collision_shape=shape,
                        warmup=1, iters=3)
    launches = read_counts()
    variants = launches["fused_solve_variants"]
    lo, hi = FEASIBLE_RANGE
    ok = (variants.get(f"arm_7dof/warm/{shape}", 0) > 0
          and variants.get(f"arm_7dof/uniform/{shape}", 0) > 0
          and out["finite"] and out["p50_err_mm"] < 1.0
          and out["frac_under_1mm"] >= 0.999
          and lo <= out["frac_targets_feasible"] <= hi
          and out["colliding_solutions"] <= MAX_COLLIDING_PER_SWARM * swarms)
    emit("obstacles" if shape == "box" else "obstacles_capsule", **out,
         wall_ms=out["wall_s"] * 1e3, launches=launches,
         jax_frac_targets_feasible=JAX_FEASIBLE[shape], card=card, ok=bool(ok))
    if not ok:
        raise AssertionError(f"obstacle slice ({shape}) missed a bar or bypassed kernel A")
    return launches


def _stage_times(device, stages, full, problem, gen):
    """Stage walls (``utils.profiling.measure``, median of ``iters`` after 1
    warm-up) of ``stages``, ``(key, solver, problem, iters)`` tuples; then
    device busy, kernel A's, kernel C's, the scan step's and torch.rand's
    shares of it and the idle share over one more solve of ``full`` under
    the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ikpso_tpu_torch.utils.profiling import measure

    out = {}
    for key, solver, prob, iters in stages:
        out[f"{key}_ms"] = measure(solver, prob, gen, device=device, warmup=1,
                                   iters=iters)[1] * 1e3
    full(problem, gen)
    torch.cuda.synchronize()
    # Device activity only: the host side issues some 10^5 small ops a solve.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        full(problem, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, ms = _device_ms(prof, {"a": KERNEL_A_NAMES, **SCAN_SPLIT})
    out.update(profiled_wall_ms=wall_ms,
               device_busy_ms=busy if busy else None,
               kernel_a_device_ms=ms["a"] if busy else None,
               kernel_c_device_ms=ms["kernel_c"] if busy else None,
               scan_step_device_ms=ms["scan_step"] if busy else None,
               torch_rand_device_ms=ms["torch_rand"] if busy else None,
               torch_rand_launches=_rand_launches(prof) if busy else None,
               device_idle_share=1.0 - busy / wall_ms if busy else None)
    return out


def _orientation_stages(device, swarms):
    """Stage walls of the orientation path: the base solve, base + polish,
    and one retry round's base and base + polish at its bucket; then
    device busy over one more full solve."""
    import dataclasses

    import torch

    from ikpso_tpu_torch.harness.headline import headline_bucket, reachable_pose
    from ikpso_tpu_torch.harness.orientation import (
        build_orientation_solver,
        orientation_configs,
        orientation_targets,
    )
    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.pso.fused import make_fused_solver
    from ikpso_tpu_torch.pso.polish import wrap_with_polish

    pre, pso, fit = orientation_configs()
    spec, problem = library.arm_6dof(device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    targets, target_rot = orientation_targets(
        spec, problem, reachable_pose(spec, problem, swarms, gen))
    batched = library.batched_problem(problem, targets, target_rot=target_rot)
    bucket = headline_bucket(swarms, pre.retry_bucket_decay)
    retry_pso = dataclasses.replace(pso, init_mode=pre.retry_init_mode,
                                    iterations=pre.retry_iterations)
    sub = batched.take(torch.arange(bucket, device=device))

    def base(cfg):
        return make_fused_solver(spec, pso=cfg, fit=fit, num_particles=pre.particles,
                                 device=device)

    def polished(cfg):
        return wrap_with_polish(base(cfg), spec, steps=pre.polish, use_orientation=True)

    out = _stage_times(device, [
        ("base", base(pso), batched, 3), ("base_polish", polished(pso), batched, 3),
        ("retry_round_base", base(retry_pso), sub, 3),
        ("retry_round_base_polish", polished(retry_pso), sub, 3),
    ], build_orientation_solver(spec, swarms, device), batched, gen)
    out["retry_bucket"] = bucket
    return out


def phase_orientation(device, swarms, card):
    """The 6-DOF position + orientation slice through run_orientation,
    launch counts read around it; then its stage times."""
    from ikpso_tpu_torch.harness.orientation import run_orientation

    reset_counts()
    t0 = time.perf_counter()
    out = run_orientation(swarms=swarms, device=device, seed=0, warmup=1, iters=3)
    phase_s = time.perf_counter() - t0
    launches = read_counts()
    variants = launches["fused_solve_variants"]
    ok = (variants.get("arm_6dof/warm/none/orientation", 0) > 0
          and variants.get("arm_6dof/uniform/none/orientation", 0) > 0 and out["finite"]
          and out["p50_err_mm"] < 1.0 and out["frac_under_1mm"] >= 0.999
          and out["p90_orient_err_deg"] < ORIENT_P90_DEG_BAR)
    stages = _orientation_stages(device, swarms)
    emit("orientation", **out, wall_ms=out["wall_s"] * 1e3, launches=launches,
         stages=stages, run_orientation_seconds=phase_s, jax_record_tpu=JAX_ORIENTATION,
         bars={"frac_under_1mm": 0.999, "p50_err_mm": 1.0,
               "p90_orient_err_deg": ORIENT_P90_DEG_BAR}, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("orientation slice missed a bar or bypassed kernel A")
    return launches


def _tree_setup(model, swarms, device, rng, particles=None):
    """A tree's preset configs and, for ``swarms`` reachable targets, its
    packed constants, limits and Philox seed words."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.harness.trees import tree_configs

    pre, pso, fit = tree_configs(model)
    spec, batched = _problem(model, swarms, rng, device)
    meta, swarm = _packed(spec, batched, fit)
    seeds = torch.as_tensor(
        rng.integers(-2**31, 2**31, (swarms, 2), dtype=np.int64).astype(np.int32),
        device=device)
    return pre, pso, fit, spec, meta, swarm, spec.limits(), seeds


def phase_tree_fitness(device, swarms=4096, particles=128, c_swarms=64, c_particles=1024):
    """Kernels B (S=4,096, P=128) and C (S=64, P=1,024) on ``FITNESS_MODELS``
    against their plain twins on random in-limit angles: equal bit for
    bit."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness_kernel import (
        fk_fitness,
        fk_fitness_plain,
        fused_fitness,
        fused_fitness_plain,
    )
    from ikpso_tpu_torch.utils import kernels

    errs = {}
    for model in FITNESS_MODELS:
        rng = np.random.default_rng(14)
        _, _, fit, spec, meta, swarm, lim, _ = _tree_setup(model, swarms, device, rng)
        lo, hi = lim.cpu().numpy()
        x = torch.as_tensor((lo + rng.random((swarms, particles, spec.dof)) * (hi - lo))
                            .astype("float32"), device=device)
        got = fk_fitness(spec, x, meta, swarm)
        want = fk_fitness_plain(spec, x, meta, swarm)
        x_dp = torch.as_tensor((lo[:, None] + rng.random((c_swarms, spec.dof, c_particles))
                                * (hi - lo)[:, None]).astype("float32"), device=device)
        got_c = fused_fitness(spec, x_dp, meta, swarm[:c_swarms])
        want_c = fused_fitness_plain(spec, x_dp, meta, swarm[:c_swarms])
        torch.cuda.synchronize()
        errs[("B", model)] = check_fitness(f"fk_fitness {model}", got, want, exact=True)
        errs[("C", model)] = check_fitness(f"fused_fitness {model}", got_c, want_c,
                                           exact=True)
        emit("tree_fitness", model=model,
             topology=kernels.TOPOLOGY_NAMES[kernels.topology_id(spec)],
             b_shape=[swarms, particles, spec.dof],
             c_shape=[c_swarms, spec.dof, c_particles],
             b_bitwise_equal=bool(torch.equal(got, want)),
             c_bitwise_equal=bool(torch.equal(got_c, want_c)),
             max_abs_err={"B": errs[("B", model)], "C": errs[("C", model)]},
             bar="max abs error 0.0", ok=True)
        del x, got, want, x_dp, got_c, want_c
    return errs


def phase_fused_tree_replay(device):
    """Kernel A on ``REPLAY_MODELS`` at the presets' P against
    fused_solve_plain, bit for bit: in replay, the base recipe and each
    model's other cases (the dual arm's hybrid-init retry recipe; on
    snake_30dof (id 5), the serial-chain variant and reference_arm at its
    256-thread bound, uniform init with every swarm kicked and hybrid init
    with a splitting threshold), then on the live Philox stream."""
    import dataclasses

    import numpy as np
    import torch

    from ikpso_tpu_torch.pso.fused import fused_solve_plain, kernel_a_layout, num_draws
    from ikpso_tpu_torch.utils import kernels

    worst = 0.0
    for model, (s, philox_s, cases) in REPLAY_MODELS.items():
        rng = np.random.default_rng(15)
        pre, pso, fit, spec, meta, swarm, lim, _ = _tree_setup(model, s, device, rng)
        zeros = torch.zeros((s, 2), dtype=torch.int32, device=device)
        for tag, fields in cases:
            cfg = dataclasses.replace(pso, **fields)
            u = torch.as_tensor(rng.random((s, num_draws(cfg), spec.dof, pre.particles),
                                           dtype=np.float32), device=device)
            kicked = []
            fused_solve_plain(spec, cfg, fit, meta, swarm, lim, zeros, pre.particles,
                              uniforms=u, on_kick=lambda k: kicked.append(int(k.sum())))
            worst = max(worst, _compare_solve(
                "fused_tree_replay", spec, cfg, fit, meta, swarm, zeros, pre.particles, u,
                bitwise=True, case=tag, kicked_per_block=kicked))
            del u
        _, _, _, _, meta, swarm, _, seeds = _tree_setup(model, philox_s, device, rng)
        extra = {}
        if kernels.topology_id(spec) == kernels.SERIAL:
            layout = kernel_a_layout(spec, fit, swarm, pre.particles)
            extra["serial_lbest"] = layout.placement
            extra["serial_grid"] = kernels.library().ikpso_fused_solve_serial_blocks(
                0, int(layout.placement == "shared"), pre.particles, meta.numel(),
                swarm.shape[1], spec.num_nodes)
        worst = max(worst, _compare_solve(
            "fused_tree_philox", spec, pso, fit, meta, swarm, seeds, pre.particles, None,
            bitwise=True, case="base", **extra))
        del meta, swarm, seeds
    return worst


def phase_tensor_polish(device, swarms=256):
    """The tensor-path LM polish (the humanoid's, m = 15) on the card
    against the same call on the CPU: starts 0.05 rad off reachable
    solutions, the preset's 6 steps. The card call runs with the global
    TF32 flag on, which the polish must not follow."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.ops import fk as fk_ops
    from ikpso_tpu_torch.pso.polish import polish_angles
    from ikpso_tpu_torch.pso.polish_soa import true_effector_error_rows
    from ikpso_tpu_torch.pso.presets import fused_preset

    steps = fused_preset("humanoid_45dof").polish
    rng = np.random.default_rng(16)
    out = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        spec, problem = library.humanoid_45dof(device=dev)
        lo, hi = spec.limits().cpu().numpy()
        truth = lo + rng.random((swarms, spec.dof)) * (hi - lo)
        start = np.clip(truth + rng.normal(0, 0.05, truth.shape), lo, hi)
        rng = np.random.default_rng(16)  # the same draws for the second device
        truth_t = torch.as_tensor(truth.astype("float32"), device=dev)
        pose = fk_ops.angles_to_pose(spec, problem.pose[0].expand(swarms, 3), truth_t)
        batched = library.batched_problem(problem, fk_ops.fk_points(
            spec, pose, problem.origin)[:, list(spec.effector_idx)])
        x0 = torch.as_tensor(start.astype("float32"), device=dev)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            x = polish_angles(spec, batched, x0, steps=steps)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        out[where] = (x.cpu(), true_effector_error_rows(spec, batched, x0).cpu(),
                      true_effector_error_rows(spec, batched, x).cpu())
    err = float((out["card"][0] - out["cpu"][0]).abs().max())
    ok = (err <= POLISH_CARD_CPU_ATOL and bool(torch.isfinite(out["card"][0]).all())
          and float(out["card"][2].mean()) < 0.1 * float(out["card"][1].mean()))
    emit("tensor_polish_card_vs_cpu", model="humanoid_45dof", swarms=swarms, steps=steps,
         max_abs_diff_rad=err, bar_rad=POLISH_CARD_CPU_ATOL,
         bitwise_equal=bool(torch.equal(out["card"][0], out["cpu"][0])),
         mean_err_mm_before=float(out["card"][1].mean()) * 1e3,
         mean_err_mm_after={k: float(v[2].mean()) * 1e3 for k, v in out.items()},
         tf32_flag_during_card_call=True, ok=bool(ok))
    if not ok:
        raise AssertionError("the tensor polish on the card disagrees with the CPU")
    return err


def _tree_stages(device, model, swarms):
    """Stage walls of a zoo path: the base solve, base + polish, and one
    retry round at the bucket (the retry init's base and base + polish; the
    humanoid's 8-step walk of base + polish), each where the preset has
    it; then device busy over one more full solve."""
    import dataclasses

    import torch

    from ikpso_tpu_torch.harness.trees import (
        build_tree_solver,
        tree_bucket,
        tree_configs,
        tree_problem,
    )
    from ikpso_tpu_torch.pso.fused import make_fused_solver
    from ikpso_tpu_torch.pso.polish import wrap_with_polish
    from ikpso_tpu_torch.pso.restarts import wrap_solver_with_target_walk

    pre, pso, fit = tree_configs(model)
    spec, batched = tree_problem(model, swarms, device)
    gen = torch.Generator(device=device).manual_seed(1)
    bucket = min(tree_bucket(model, swarms), swarms)
    sub = batched.take(torch.arange(bucket, device=device))

    def base(cfg):
        return make_fused_solver(spec, pso=cfg, fit=fit, num_particles=pre.particles,
                                 device=device)

    def polished(cfg):
        return wrap_with_polish(base(cfg), spec, steps=pre.polish)

    stages = [("base", base(pso), batched, 3)]
    if pre.polish:
        stages.append(("base_polish", polished(pso), batched, 3))
    if pre.retry_walk:
        stages.append(("retry_round_walk", wrap_solver_with_target_walk(
            polished(pso), spec, pre.retry_walk, jitter=pre.retry_walk_jitter), sub, 1))
    elif pre.retries:
        retry = dataclasses.replace(pso, init_mode=pre.retry_init_mode or pso.init_mode)
        stages += [("retry_round_base", base(retry), sub, 3),
                   ("retry_round_base_polish", polished(retry), sub, 3)]
    out = _stage_times(device, stages, build_tree_solver(model, spec, swarms, device),
                       batched, gen)
    out["retry_bucket"] = bucket
    return out


def phase_tree(device, model, card):
    """A zoo path through run_tree at its preset's batch, launch counts read
    around it (every kernel A launch must be the model's variant: planar_3dof
    runs on arm_7dof's topology, snake:50 on the serial-chain variant); then
    its stage times. Bars: ``TREE_FRAC_BAR`` under 1 mm and p50 under 1 mm;
    reference_arm's p50 and p90 inside JAX's 99% intervals."""
    from ikpso_tpu_torch.harness.trees import model_spec, run_tree, tree_configs
    from ikpso_tpu_torch.utils import kernels

    pre, _, _ = tree_configs(model)
    swarms, iters = TREE_SWARMS[model], TREE_ITERS.get(model, 3)
    name = kernels.TOPOLOGY_NAMES[kernels.topology_id(model_spec(model)[0])]
    reset_counts()
    t0 = time.perf_counter()
    out = run_tree(model, swarms=swarms, device=device, seed=0, warmup=1, iters=iters)
    phase_s = time.perf_counter() - t0
    launches = read_counts()
    solves = 1 + iters
    # A walk round runs retry_walk base solves; a retry round without a
    # retry init mode is warm.
    retry_init = "warm" if pre.retry_walk else pre.retry_init_mode or "warm"
    per_round = pre.retry_walk or 1
    want = {f"{name}/warm/none": solves * (1 + (pre.retries * per_round
                                                if retry_init == "warm" else 0))}
    if pre.retries and retry_init != "warm":
        want[f"{name}/{retry_init}/none"] = solves * pre.retries
    if model == "reference_arm":
        lo50, hi50 = REFERENCE_ARM_P50_INTERVAL_MM
        lo90, hi90 = REFERENCE_ARM_P90_INTERVAL_MM
        accurate = lo50 <= out["p50_err_mm"] <= hi50 and lo90 <= out["p90_err_mm"] <= hi90
        jax = {**REFERENCE_ARM_JAX, "record": "CPU, scan solver, tests/test_torch_zoo.py",
               "failures_ge_1mm": round(REFERENCE_ARM_JAX["swarms"]
                                        * (1 - REFERENCE_ARM_JAX["frac_under_1mm"]))}
        bars = {"p50_err_mm": REFERENCE_ARM_P50_INTERVAL_MM,
                "p90_err_mm": REFERENCE_ARM_P90_INTERVAL_MM}
    else:
        accurate = out["p50_err_mm"] < 1.0 and out["frac_under_1mm"] >= TREE_FRAC_BAR[model]
        jax = {**JAX_TREES[model], "record": "TPU, bench_records/r5_sweep.jsonl"}
        bars = {"frac_under_1mm": TREE_FRAC_BAR[model], "p50_err_mm": 1.0}
    ok = launches["fused_solve_variants"] == want and out["finite"] and accurate
    stages = _tree_stages(device, model, swarms)
    emit(TREE_PATHS[model], **out, wall_ms=out["wall_s"] * 1e3, launches=launches,
         expected_variant_launches=want, stages=stages, run_tree_seconds=phase_s,
         timed_solves=iters, jax=jax, bars=bars, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError(f"{model} path missed a bar or bypassed its kernel A variant")
    return launches


def phase_tree_timing(device):
    """Per model of ``TIMED_MODELS``: kernel A against its plain twin at the
    pair batch and alone at the preset's batch (snake_30dof on id 5,
    snake:50 on the serial-chain variant, reference_arm at its 256-thread
    bound), kernels B and C against their plain twins; each output held
    against the plain one's, and the counted work of each timed launch
    (kicks counted from the final values and, for the rest, along the
    plain trajectory, in chunks)."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness_kernel import (
        fk_fitness,
        fk_fitness_plain,
        fused_fitness,
        fused_fitness_plain,
    )
    from ikpso_tpu_torch.pso.fused import fused_solve, fused_solve_plain
    from ikpso_tpu_torch.utils import flops

    times, counts, errs = {}, {}, {}
    clocks = {"start": card_clocks()}
    for model, (s, b_swarms, c_swarms) in TIMED_MODELS.items():
        rng = np.random.default_rng(17)
        pre, pso, fit, spec, meta, swarm, lim, seeds = _tree_setup(model, s, device, rng)
        args = (spec, pso, fit, meta, swarm, lim, seeds, pre.particles)
        times[f"fused_solve_{model}_pair_ms"], got = cuda_time(lambda: fused_solve(*args),
                                                               reps=5)
        times[f"fused_solve_{model}_pair_plain_ms"], want = cuda_time(
            lambda: fused_solve_plain(*args), reps=1)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"kernel A ({model}) disagrees with fused_solve_plain "
                                 "at the timed shape")
        kicks = flops.fused_solve_kicks(*args) if pso.rekick_interval else 0.0
        counts[f"a_{model}_pair"] = flops.fused_solve_count(
            spec, pso, fit, num_particles=pre.particles, num_swarms=s, kicks=kicks)
        del got, want, args
        big = TREE_SWARMS[model]
        pre, pso, fit, spec, meta, swarm, lim, seeds = _tree_setup(model, big, device, rng)
        args = (spec, pso, fit, meta, swarm, lim, seeds, pre.particles)
        times[f"fused_solve_{model}_ms"], (_, gval) = cuda_time(
            lambda: fused_solve(*args), reps=3)
        kicks = 0.0
        if pso.rekick_interval:
            # Replays only the swarms whose final value is at or under the
            # threshold; the others were kicked at every block start.
            kicks = flops.fused_solve_kicks(*args, gval=gval)
            times[f"fused_solve_{model}_kicked_share"] = kicks / (
                big * (pso.iterations // pso.rekick_interval - 1))
        counts[f"a_{model}"] = flops.fused_solve_count(
            spec, pso, fit, num_particles=pre.particles, num_swarms=big, kicks=kicks)
        del meta, swarm, seeds, args, gval
        if b_swarms is None:
            continue
        # Kernels B and C on random in-limit angles.
        _, _, fit, spec, meta, swarm, lim, _ = _tree_setup(model, b_swarms, device, rng)
        lo, hi = lim.cpu().numpy()
        x = torch.as_tensor((lo + rng.random((b_swarms, 128, spec.dof)) * (hi - lo))
                            .astype("float32"), device=device)
        times[f"fk_fitness_{model}_ms"], got = cuda_time(
            lambda: fk_fitness(spec, x, meta, swarm), reps=20)
        times[f"fk_fitness_{model}_plain_ms"], want = cuda_time(
            lambda: fk_fitness_plain(spec, x, meta, swarm), reps=3)
        errs[("B", model)] = check_fitness(f"fk_fitness {model}", got, want, exact=True)
        counts[f"b_{model}"] = flops.fitness_kernel_count(spec, fit, num_swarms=b_swarms,
                                                          num_particles=128)
        del x, got, want
        x_dp = torch.as_tensor((lo[:, None] + rng.random((c_swarms, spec.dof, 1024))
                                * (hi - lo)[:, None]).astype("float32"), device=device)
        sw_c = swarm[:c_swarms]
        times[f"fused_fitness_{model}_ms"], got = cuda_time(
            lambda: fused_fitness(spec, x_dp, meta, sw_c), reps=20)
        times[f"fused_fitness_{model}_plain_ms"], want = cuda_time(
            lambda: fused_fitness_plain(spec, x_dp, meta, sw_c), reps=3)
        errs[("C", model)] = check_fitness(f"fused_fitness {model}", got, want, exact=True)
        counts[f"c_{model}"] = flops.fitness_kernel_count(spec, fit, num_swarms=c_swarms,
                                                          num_particles=1024)
        del x_dp, got, want, meta, swarm, sw_c
    clocks["end"] = card_clocks()
    emit("tree_timing", **times, timed_models=TIMED_MODELS, preset_swarms=TREE_SWARMS,
         kernel_a={m: kernel_names(m)["A"].split("<")[0] for m in TIMED_MODELS},
         clocks=clocks, max_abs_err_vs_plain={f"{k}_{m}": v for (k, m), v in errs.items()},
         bar="bit-identical kernel A; max abs error 0.0 for B and C")
    return times, counts, errs


def kernel_names(model):
    """Prefixes of the demangled names of a model's kernel A, B and C
    instantiations (its compile-time topology's, or the serial-chain
    variant's)."""
    from ikpso_tpu_torch.harness.trees import model_spec
    from ikpso_tpu_torch.utils import kernels

    spec = model_spec(model)[0]
    if kernels.topology_id(spec) == kernels.SERIAL:
        return {"A": "fused_solve_serial_kernel", "B": "fk_fitness_serial_kernel",
                "C": "fused_fitness_serial_kernel"}
    n = spec.num_nodes
    topo = kernels.topology_id(spec)
    loop = "_short" if topo in kernels.SHORT_IDS else (
        "_tree" if topo in kernels.TREE_LOOP_IDS else "")
    return {"A": f"fused_solve{loop}_kernel<Topology<{n}, ",
            "B": f"fk_fitness_kernel<Topology<{n}, ",
            "C": f"fused_fitness_kernel<Topology<{n}, "}


def kernel_a_placement(spec, fit, particles, num_obstacles=0, use_orientation=False):
    """Kernel A's state placement and dynamic shared-memory bytes for a
    launch (``pso.fused.kernel_a_layout``, at the packed swarm width), the
    bytes held against the kernels' own reckoning
    (``ikpso_kernel_a_smem_bytes``)."""
    from ikpso_tpu_torch.ops.fitness_kernel import MetaLayout
    from ikpso_tpu_torch.utils import kernels

    layout = kernels.kernel_a_layout(spec, particles, num_obstacles, fit.collision_shape,
                                     use_orientation, fit.distance_weight != 0.0,
                                     fit.trig_impl)
    lay = MetaLayout(spec, num_obstacles, use_orientation)
    planes = ((1 if layout.scratch else 2) if layout.placement == "shared" else 0)
    if layout.cluster:
        bytes_c = kernels.library().ikpso_kernel_a_cluster_smem_bytes(
            lay.meta_size, lay.swarm_size, spec.dof, particles // layout.cluster)
    elif layout.tree:
        bytes_c = kernels.library().ikpso_kernel_a_tree_smem_bytes(lay.meta_size, spec.dof,
                                                                   particles)
    else:
        bytes_c = kernels.library().ikpso_kernel_a_smem_bytes(
            lay.meta_size, lay.swarm_size, spec.dof, particles, planes)
    if kernels.library().ikpso_kernel_a_short_threads() != kernels.SHORT_THREADS:
        raise AssertionError("kShortThreads and SHORT_THREADS differ")
    if bytes_c != layout.smem_bytes:
        raise AssertionError(f"kernel A's shared memory: {layout.smem_bytes} bytes "
                             f"reckoned in Python, {bytes_c} by the kernels")
    return {"placement": layout.placement, "smem_bytes": layout.smem_bytes,
            "scratch_planes": layout.scratch_planes, "threads": layout.threads,
            "static_bytes": layout.static_bytes, "cluster": layout.cluster,
            "tree": layout.tree}


def phase_ptxas():
    """The registers and spill bytes of the timed models' kernel A, B and C
    instantiations (ptxas, from the build's log; kernel A's replay build
    too), and kernel A's state placement and shared-memory bytes at each
    model's preset P."""
    from ikpso_tpu_torch.harness.trees import model_spec, tree_configs
    from ikpso_tpu_torch.utils import kernels

    report = ptxas_report(kernels.build().with_suffix(".log").read_text())
    rows = {f"{k} {m}": [r for r in report if r["kernel"].startswith(prefix)]
            for m in TIMED_MODELS for k, prefix in kernel_names(m).items()}
    placement = {}
    for m in TIMED_MODELS:
        pre, _, fit = tree_configs(m)
        placement[m] = kernel_a_placement(model_spec(m)[0], fit, pre.particles)
    emit("ptxas_models", rows=rows, kernel_a_placement=placement, ok=all(rows.values()))
    if not all(rows.values()):
        raise AssertionError("an instantiation is missing from the build: "
                             f"{[k for k, v in rows.items() if not v]}")
    return rows, placement


def phase_headline(device, swarms, card):
    from ikpso_tpu_torch.harness.headline import run_headline

    reset_counts()
    out = run_headline(swarms=swarms, device=device, seed=0, warmup=1, iters=3)
    launches = read_counts()
    ok = (launches["fused_solve_variants"].get("arm_7dof/warm/none", 0) > 0 and out["finite"]
          and out["p50_err_mm"] < 1.0 and out["frac_under_1mm"] >= 0.999)
    emit("headline", **out, wall_ms=out["wall_s"] * 1e3, launches=launches,
         jax_reference_failures=JAX_REFERENCE_FAILURES, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("headline solve missed its bar or bypassed kernel A")
    return launches


def phase_timing(device, swarms, big_swarms, particles=128):
    """Kernel and plain times at the paths' shapes, and the counted work
    of each timed launch (``utils.flops``: collider branches charged the
    work these inputs need)."""
    import dataclasses

    import numpy as np
    import torch

    from ikpso_tpu_torch.harness.scan import scan_configs
    from ikpso_tpu_torch.ops.fitness_kernel import (
        fk_fitness,
        fk_fitness_plain,
        fused_fitness,
        fused_fitness_plain,
    )
    from ikpso_tpu_torch.pso.fused import fused_solve, fused_solve_plain
    from ikpso_tpu_torch.utils import flops

    pso, fit = _headline_configs()
    clocks = {"start": card_clocks()}
    rng = np.random.default_rng(4)
    spec, batched = _problem("arm_7dof", swarms, rng, device)
    meta, swarm = _packed(spec, batched, fit)
    limits = spec.limits()
    seeds = torch.as_tensor(
        rng.integers(-2**31, 2**31, (swarms, 2), dtype=np.int64).astype(np.int32),
        device=device)
    x = torch.as_tensor(
        (limits[0].cpu().numpy() + rng.random((swarms, particles, spec.dof))
         * (limits[1] - limits[0]).cpu().numpy()).astype("float32"), device=device)
    # The paths' launch counts are read before this phase; the launches
    # made here to time kernels are not counted anywhere. Each timed
    # fitness kernel's last output is held against its timed plain twin's.
    times = {
        "fused_solve_ms": cuda_time_ms(lambda: fused_solve(
            spec, pso, fit, meta, swarm, limits, seeds, particles), reps=10),
        "fused_solve_plain_ms": cuda_time_ms(lambda: fused_solve_plain(
            spec, pso, fit, meta, swarm, limits, seeds, particles), reps=3),
    }
    errs = {}

    def time_pair(key, kernel_fn, plain_fn, reps, plain_reps, exact):
        times[f"{key}_ms"], got = cuda_time(kernel_fn, reps=reps)
        times[f"{key}_plain_ms"], want = cuda_time(plain_fn, reps=plain_reps)
        errs[key] = check_fitness(key, got, want, exact=exact)

    time_pair("fk_fitness", lambda: fk_fitness(spec, x, meta, swarm),
              lambda: fk_fitness_plain(spec, x, meta, swarm), 20, 5, exact=False)
    counts = {
        "a_none": flops.fused_solve_count(spec, pso, fit, num_particles=particles,
                                          num_swarms=swarms),
        "b_none": flops.fitness_kernel_count(spec, fit, num_swarms=swarms,
                                             num_particles=particles),
    }
    # The scene's branches: kernel B box / capsule on the same angles, and
    # kernel A's base solve (warm, 8 iterations) with the box scene.
    obs = _scene(spec, device)
    for shape in ("box", "capsule"):
        fit_s = dataclasses.replace(fit, collision_shape=shape)
        meta_s, _ = _packed(spec, batched, fit_s, obs)
        kw = dict(num_obstacles=obs.count, collision_shape=shape)
        time_pair(f"fk_fitness_{shape}", lambda: fk_fitness(spec, x, meta_s, swarm, **kw),
                  lambda: fk_fitness_plain(spec, x, meta_s, swarm, **kw), 20, 3,
                  exact=False)
        counts[f"b_{shape}"] = flops.fitness_kernel_count(
            spec, fit_s, num_swarms=swarms, num_particles=particles,
            num_obstacles=obs.count,
            collider_ops=flops.collider_work(spec, x, meta_s, swarm, **kw))
    del x
    fit_b = dataclasses.replace(fit, collision_shape="box")
    meta_b, _ = _packed(spec, batched, fit_b, obs)
    times["fused_solve_box_ms"] = cuda_time_ms(lambda: fused_solve(
        spec, pso, fit_b, meta_b, swarm, limits, seeds, particles,
        num_obstacles=obs.count), reps=10)
    times["fused_solve_box_plain_ms"] = cuda_time_ms(lambda: fused_solve_plain(
        spec, pso, fit_b, meta_b, swarm, limits, seeds, particles,
        num_obstacles=obs.count), reps=2)
    counts["a_box"] = flops.fused_solve_count(
        spec, pso, fit_b, num_particles=particles, num_swarms=swarms,
        num_obstacles=obs.count, collider_ops=flops.fused_solve_collider_work(
            spec, pso, fit_b, meta_b, swarm, limits, seeds, particles,
            num_obstacles=obs.count))
    # Kernel C at the scan path's shape: (S, D, P) = (16,384, 9, 1,024).
    _, fit_c = scan_configs()
    spec_c, batched_c = _problem("arm_7dof", SCAN_SWARMS, rng, device)
    meta_c, swarm_c = _packed(spec_c, batched_c, fit_c)
    lim = limits.cpu().numpy()
    x_dp = torch.as_tensor((lim[0][:, None] + rng.random((SCAN_SWARMS, spec.dof, 1024))
                            * (lim[1] - lim[0])[:, None]).astype("float32"), device=device)
    time_pair("fused_fitness", lambda: fused_fitness(spec_c, x_dp, meta_c, swarm_c),
              lambda: fused_fitness_plain(spec_c, x_dp, meta_c, swarm_c), 20, 3,
              exact=True)
    counts["c"] = flops.fitness_kernel_count(spec_c, fit_c, num_swarms=SCAN_SWARMS,
                                             num_particles=1024)
    del x_dp
    # The orientation path's branches: kernel A on arm_6dof with orientation
    # and the re-kick (warm, 40 iterations, the base solve) and kernel B with
    # orientation; each timed output held against its plain twin's.
    pso_o, fit_o = _orientation_configs()
    spec_o, batched_o = _problem("arm_6dof", swarms, rng, device, orientation=True)
    meta_o, swarm_o = _packed(spec_o, batched_o, fit_o, use_orientation=True)
    lim_o = spec_o.limits()
    seeds_o = torch.as_tensor(
        rng.integers(-2**31, 2**31, (swarms, 2), dtype=np.int64).astype(np.int32),
        device=device)
    args_o = (spec_o, pso_o, fit_o, meta_o, swarm_o, lim_o, seeds_o, particles)
    times["fused_solve_orientation_ms"], got = cuda_time(
        lambda: fused_solve(*args_o, use_orientation=True), reps=10)
    times["fused_solve_orientation_plain_ms"], want = cuda_time(
        lambda: fused_solve_plain(*args_o, use_orientation=True), reps=1)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("kernel A (arm_6dof, orientation, re-kick) disagrees with "
                             "fused_solve_plain at the timed shape")
    kicks = flops.fused_solve_kicks(*args_o, use_orientation=True)
    counts["a_orientation"] = flops.fused_solve_count(
        spec_o, pso_o, fit_o, num_particles=particles, num_swarms=swarms,
        use_orientation=True, kicks=kicks)
    times["fused_solve_orientation_kicked_share"] = kicks / (
        swarms * (pso_o.iterations // pso_o.rekick_interval - 1))
    lim = lim_o.cpu().numpy()
    x_o = torch.as_tensor((lim[0] + rng.random((swarms, particles, spec_o.dof))
                           * (lim[1] - lim[0])).astype("float32"), device=device)
    time_pair("fk_fitness_orientation",
              lambda: fk_fitness(spec_o, x_o, meta_o, swarm_o, use_orientation=True),
              lambda: fk_fitness_plain(spec_o, x_o, meta_o, swarm_o, use_orientation=True),
              20, 5, exact=True)
    counts["b_orientation"] = flops.fitness_kernel_count(
        spec_o, fit_o, num_swarms=swarms, num_particles=particles, use_orientation=True)
    del x_o, got, want
    spec, batched = _problem("arm_7dof", big_swarms, rng, device)
    meta, swarm = _packed(spec, batched, fit)
    seeds = torch.zeros((big_swarms, 2), dtype=torch.int32, device=device)
    times["fused_solve_big_ms"] = cuda_time_ms(lambda: fused_solve(
        spec, pso, fit, meta, swarm, limits, seeds, particles), reps=5)
    counts["a_none_big"] = flops.fused_solve_count(spec, pso, fit, num_particles=particles,
                                                   num_swarms=big_swarms)
    meta_b, swarm = _packed(spec, batched, fit_b, obs)
    times["fused_solve_box_big_ms"] = cuda_time_ms(lambda: fused_solve(
        spec, pso, fit_b, meta_b, swarm, limits, seeds, particles,
        num_obstacles=obs.count), reps=5)
    clocks["end"] = card_clocks()
    emit("timing", swarms=swarms, big_swarms=big_swarms, particles=particles,
         scan_shape=[SCAN_SWARMS, spec.dof, 1024], **times, clocks=clocks,
         max_abs_err_free_vs_plain=errs,
         bar={"fused_fitness": "equal masks, max abs error 0.0 on free particles",
              "fk_fitness_orientation": "max abs error 0.0",
              "fused_solve_orientation": "bit-identical gbest and gval",
              "fk_fitness*": f"equal masks, rtol {FK_RTOL}, atol {FK_ATOL}"})
    return times, counts, errs


# Bounds phase rows: (row, count key, time key, what was timed).
BOUND_ROWS = (
    ("A headline, no scene", "a_none_big", "fused_solve_big_ms",
     f"kernel A, S={HEADLINE_SWARMS}, P=128, warm, 8 iterations"),
    ("A no scene", "a_none", "fused_solve_ms",
     f"kernel A, S={TIMING_SWARMS}, P=128, warm, 8 iterations"),
    ("A box", "a_box", "fused_solve_box_ms",
     f"kernel A, S={TIMING_SWARMS}, P=128, warm, 8 iterations, 4 boxes"),
    ("A orientation", "a_orientation", "fused_solve_orientation_ms",
     f"kernel A, arm_6dof, S={TIMING_SWARMS}, P=128, warm, 40 iterations, re-kick every "
     "20 above 1e-6, orientation"),
    ("B none", "b_none", "fk_fitness_ms", f"kernel B, S={TIMING_SWARMS}, P=128"),
    ("B box", "b_box", "fk_fitness_box_ms", f"kernel B, S={TIMING_SWARMS}, P=128, 4 boxes"),
    ("B capsule", "b_capsule", "fk_fitness_capsule_ms",
     f"kernel B, S={TIMING_SWARMS}, P=128, 4 boxes"),
    ("B orientation", "b_orientation", "fk_fitness_orientation_ms",
     f"kernel B, arm_6dof, S={TIMING_SWARMS}, P=128, orientation"),
    ("C scan path", "c", "fused_fitness_ms", f"kernel C, S={SCAN_SWARMS}, D=9, P=1024"),
) + tuple(row for model, (pair, b_swarms, c_swarms) in TIMED_MODELS.items() for row in (
    (f"A {model}", f"a_{model}", f"fused_solve_{model}_ms",
     f"kernel A, {model}, S={TREE_SWARMS[model]}, the preset's P and base recipe"),
    (f"A {model} pair", f"a_{model}_pair", f"fused_solve_{model}_pair_ms",
     f"kernel A, {model}, S={pair}, the preset's P and base recipe"),
) + (() if b_swarms is None else (
    (f"B {model}", f"b_{model}", f"fk_fitness_{model}_ms",
     f"kernel B, {model}, S={b_swarms}, P=128"),
    (f"C {model}", f"c_{model}", f"fused_fitness_{model}_ms",
     f"kernel C, {model}, S={c_swarms}, P=1024"),
)))


BOUND_ROWS += tuple(
    (f"{k} {tag}", f"{k.lower()}_{tag}", f"{k.lower()}_{tag}_ms",
     f"kernel {k}, {tag} (built on demand), S={OD_TIMED[tag]['ABC'.index(k)]}")
    for tag in OD_TIMED for k in "ABC") + (
    ("C experiment", "c_experiment", "fused_fitness_experiment_ms",
     "kernel C, reference_arm, S=128, D=21, P=16,384, angle_weight 3.0"),
    ("A track", "a_track", "fused_solve_track_ms",
     "kernel A, arm_7dof, S=4,096, P=128, 8 iterations, re-kick every 4 above 1e-6"),
)
# The scan step's timed steps (1-based) by shape (STEP_TIMED), and the one
# of each that stands in the kernels line.
STEP_STEPS = {"scan": (1, 31, 59), "experiment": (8,)}
STEP_MAIN = {"scan": 31, "experiment": 8}


def _step_keys(key, step, replay):
    """A timed step's ``counts`` key and ``times`` key (``..._ms``; its plain
    time is the drawing step's key with ``_plain_ms``): the shape (none for
    the scan path), the replay step, then the step unless it is
    ``STEP_MAIN``'s."""
    shape = "" if key == "scan" else f"_{key}"
    at = "" if step == STEP_MAIN[key] else f"_s{step}"
    inst = "_replay" if replay else ""
    return f"step_{key}{inst}{at}", f"scan_step{inst}{shape}{at}_ms"


# The scan step's rows: "step scan path" / "step experiment" (the drawing
# step at STEP_MAIN's step), "... replay" the replay step, "... step n" the
# other timed steps.
STEP_SHAPES = {"scan": ("scan path", f"arm_7dof, S={SCAN_SWARMS}, D=9, P=1024", 60),
               "experiment": ("experiment", "reference_arm, S=128, D=21, P=16,384, "
                              "angle_weight 3.0", 15)}
BOUND_ROWS += tuple(
    ("step " + STEP_SHAPES[key][0] + (" replay" if replay else "")
     + ("" if step == STEP_MAIN[key] else f" step {step}"),
     *_step_keys(key, step, replay),
     f"scan step ({'replay' if replay else 'drawing'}), {STEP_SHAPES[key][1]}, step {step} "
     f"of {STEP_SHAPES[key][2]}")
    for key, steps in STEP_STEPS.items() for step in steps for replay in (False, True))


def phase_bounds(times, counts, roof_timed, roof_counts, card):
    """Each timed kernel launch against its roofline bound (published
    peaks); raises if any share is above 1."""
    from ikpso_tpu_torch.utils.roofline import speed_of_light_seconds

    rows = [(name, counts[c], times[t], what) for name, c, t, what in BOUND_ROWS]
    rows += [("D fma", roof_counts["d_fma"], roof_timed["d_fma_ms"], "kernel D, fma body"),
             ("E", roof_counts["e"], roof_timed["e_ms"], "kernel E")]
    out = {}
    for name, count, ms, what in rows:
        seconds, bound_by = speed_of_light_seconds(count)
        out[name] = dict(timed=what, ms=ms, bound_ms=seconds * 1e3, bound_by=bound_by,
                         share=seconds * 1e3 / ms, ops=count.ops, bytes=count.bytes)
    ok = all(r["share"] <= 1.0 for r in out.values())
    emit("bounds", rows=out, card=card, ok=ok)
    if not ok:
        raise AssertionError("a kernel ran faster than its bound: the op model is wrong")
    return out


# The on-demand keys kernel A's tree-loop rule (kernels.on_demand_key) was
# measured on, ON_DEMAND_CASES tags: the tree loop (fused_solve_tree_kernel)
# for each but dual_arm_box, which keeps the general loop.
TREE_LOOP_KEYS = ("dual_arm_box", "dual_arm_capsule", "dual_arm_distance", "dual_arm_exact",
                  "hand12", "hand12_box")


def phase_tree_loop_keys(times, bounds, od_ptxas, trees):
    """Each of ``TREE_LOOP_KEYS``: the loop it runs, its ptxas lines
    (registers and spill bytes of the Philox and the replay instantiation),
    and its kernel A time at ``OD_TIMED``'s shape beside its bound (phase
    bounds) and its issue-rate time there (``trees``, sass_kernel_a's rows,
    scaled from the ``TREE_SASS`` swarms to the timed ones)."""
    rows = {}
    for tag in TREE_LOOP_KEYS:
        swarms = OD_TIMED[tag][0]
        kernel_a = [r for r in od_ptxas[tag] if r["kernel"].startswith("fused_solve")]
        row = trees.get(tag)
        rows[tag] = {
            "loop": "tree" if any("_tree_kernel" in r["kernel"] for r in kernel_a)
                    else "general",
            "ptxas": [{"kernel": r["kernel"], "registers": r.get("registers"),
                       "spill_store_bytes": r.get("spill_stores", 0),
                       "spill_load_bytes": r.get("spill_loads", 0)} for r in kernel_a],
            "swarms": swarms, "ms": times[f"a_{tag}_ms"],
            "bound_ms": bounds[f"A {tag}"]["bound_ms"],
            "bound_by": bounds[f"A {tag}"]["bound_by"],
            "issue_bound_ms": None if row is None
                              else row["issue_bound_ms"] * swarms / TREE_SASS[tag][0],
            "loop_trip_instructions": None if row is None else row["path_instructions"]}
    emit("tree_loop_keys", keys=rows,
         max_spill_store_bytes=max(p["spill_store_bytes"] for r in rows.values()
                                   for p in r["ptxas"]))
    return rows


def _config(name, device):
    from ikpso_tpu_torch.utils.configio import load_config

    return load_config(str(CONFIG_DIR / f"{name}.json"), device)


def _near_scene(spec, device):
    """A 4-box ring at 0.35 of the chain's reach (harness/obstacles.py's
    scene sits at 0.55), where random in-limit poses of the dual arm and
    the snakes hit it."""
    import numpy as np

    from ikpso_tpu_torch.models.chain import Obstacles

    reach = float(np.abs(spec.length.cpu().numpy()).sum())
    ang = np.arange(4) * (np.pi / 2) + 0.4
    centers = np.stack([0.35 * reach * np.cos(ang), 0.35 * reach * np.sin(ang),
                        0.2 * reach * np.array([1.0, -1.0, 1.0, -1.0])], axis=-1)
    return Obstacles.from_boxes(centers.astype("float32"),
                                np.full((4, 3), 0.15 * reach, "float32"), device=device)


def od_case(tag, device, swarms, rng, philox=False):
    """One ``ON_DEMAND_CASES`` case at ``swarms`` reachable targets: ``(spec,
    pso, fit, particles, meta, swarm, obstacles, orientation)``; the PSO
    recipe cut for the replays unless ``philox``."""
    import dataclasses

    from ikpso_tpu_torch.harness.orientation import orientation_targets
    from ikpso_tpu_torch.harness.trees import model_spec, tree_configs
    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.ops import fk as fk_ops

    source, particles, cut, scene, orient, *fields = ON_DEMAND_CASES[tag]
    if source in CONFIGS:
        cfg = _config(source, device)
        spec, base, pso, fit = cfg.spec, cfg.problem, cfg.pso, cfg.fitness
    elif source in CUT_TREES:
        spec, base, pso, fit = _cut_tree(source, device)
    else:
        spec, base = model_spec(source, device)
        _, pso, fit = tree_configs(source)
        fit = dataclasses.replace(fit, orientation_weight=1.0 if orient else 0.0)
    if fields:
        fit = dataclasses.replace(fit, **fields[0])
    if cut and not philox:
        pso = dataclasses.replace(pso, **cut)
    obs = _near_scene(spec, device) if scene == "near" else None
    lim = spec.limits().cpu().numpy()
    ang = lim[0] + rng.random((swarms, spec.dof)) * (lim[1] - lim[0])
    pose = fk_ops.angles_to_pose(spec, base.pose[0].expand(swarms, 3),
                                 _t(ang.astype("float32"), device))
    if orient:
        targets, target_rot = orientation_targets(spec, base, pose)
        batched = library.batched_problem(base, targets, target_rot=target_rot)
    else:
        batched = library.batched_problem(
            base, fk_ops.fk_points(spec, pose, base.origin)[:, list(spec.effector_idx)])
    meta, swarm = _packed(spec, batched, fit, obs, use_orientation=orient)
    return spec, pso, fit, particles, meta, swarm, obs, orient


def _cut_tree(name, device):
    """``(spec, problem, pso, fit)`` of a ``CUT_TREES`` tree: its document's
    first nodes, their limits, lengths and effector weights, the document's
    recipe."""
    from ikpso_tpu_torch.models.chain import IKProblem, make_chain_spec

    doc, n, effectors = CUT_TREES[name]
    cfg = _config(doc, device)
    full, base = cfg.spec, cfg.problem
    spec = make_chain_spec(full.parent[:n], full.length[:n].cpu(),
                           full.min_rotation[:n].cpu(), full.max_rotation[:n].cpu(),
                           effectors, full.effector_weight[:n].cpu(), device=device)
    problem = IKProblem(pose=base.pose[:n], origin=base.origin,
                        targets=base.targets[:len(effectors)])
    return spec, problem, cfg.pso, cfg.fitness


def _t(a, device):
    import torch

    return torch.as_tensor(a, device=device)


def od_keys(rules=None):
    """The on-demand library of every ``ON_DEMAND_CASES`` case, by this
    checkout's rules or by ``rules``, another checkout's ``utils/kernels.py``
    (``checkout_kernels``), as this checkout's key type."""
    from ikpso_tpu_torch.pso.fused import uses_distance
    from ikpso_tpu_torch.utils import kernels

    import numpy as np

    keys = {}
    for tag in ON_DEMAND_CASES:
        spec, _, fit, _, _, _, obs, orient = od_case(tag, "cpu", 1, np.random.default_rng(0))
        topo, collider, o = kernels.kernel_variant(
            spec, 0 if obs is None else obs.count, fit.collision_shape, orient,
            uses_distance(fit), fit.trig_impl)
        if topo != kernels.ON_DEMAND:
            raise AssertionError(f"{tag} routes to a prebuilt kernel")
        keys[tag] = kernels.OnDemandKey(*(rules or kernels).on_demand_key(
            spec, collider, o, uses_distance(fit), fit.trig_impl == "exact"))
    return keys


def checkout_kernels(root):
    """``<root>/ikpso_tpu_torch/utils/kernels.py`` imported as a module of its
    own: another checkout's routing rules (its ``on_demand_key``)."""
    import importlib.util

    path = Path(root).resolve() / "ikpso_tpu_torch" / "utils" / "kernels.py"
    spec = importlib.util.spec_from_file_location(f"kernels_at_{path.parents[2].name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def od_variant(tag):
    """The ``fused_solve.variant_launches`` name of a case's warm solve."""
    import numpy as np

    from ikpso_tpu_torch.utils import kernels

    spec, _, fit, _, _, _, obs, orient = od_case(tag, "cpu", 1, np.random.default_rng(0))
    name = (f"{kernels.topology_name(spec)}/warm/"
            f"{fit.collision_shape if obs is not None else 'none'}")
    for flag, on in (("orientation", orient), ("distance", fit.distance_weight != 0.0),
                     ("exact", fit.trig_impl == "exact")):
        if on:
            name += f"/{flag}"
    return name


def phase_on_demand_build():
    """Compile every on-demand key at once (kernels.prebuild), outside any
    timed window; one ptxas report per key."""
    from ikpso_tpu_torch.utils import kernels

    keys = od_keys()
    t0 = time.perf_counter()
    seconds = kernels.prebuild(keys.values())
    wall = time.perf_counter() - t0
    ptxas = {tag: ptxas_report(kernels.on_demand_path(k).with_suffix(".log").read_text())
             for tag, k in keys.items()}
    for tag, k in keys.items():
        kernels.on_demand_library(k)
    emit("on_demand_build", seconds=wall, per_key={tag: seconds[k] for tag, k in keys.items()},
         keys={tag: k._asdict() for tag, k in keys.items()},
         libraries={tag: kernels.on_demand_path(k).name for tag, k in keys.items()},
         ptxas=ptxas, ok=True)
    return ptxas


def phase_on_demand_checks(device):
    """Kernels B (S=4,096, P=128), C (S=64, P=1,024) and A (replay at
    ``OD_REPLAY_SWARMS``, then the full recipe on Philox) of each on-demand
    case against their plain twins: equal bit for bit."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness_kernel import (
        fk_fitness,
        fk_fitness_plain,
        fused_fitness,
        fused_fitness_plain,
    )
    from ikpso_tpu_torch.pso.fused import fused_solve_plain, num_draws, uses_distance
    from ikpso_tpu_torch.utils import kernels

    errs = {}
    keys = od_keys()
    for tag in ON_DEMAND_CASES:
        rng = np.random.default_rng(21)
        spec, pso, fit, p, meta, swarm, obs, orient = od_case(tag, device, 4096, rng)
        kw = dict(num_obstacles=0 if obs is None else obs.count,
                  collision_shape=fit.collision_shape, use_orientation=orient,
                  use_distance_term=uses_distance(fit), trig_impl=fit.trig_impl)
        lo, hi = spec.limits().cpu().numpy()
        x = _t((lo + rng.random((4096, 128, spec.dof)) * (hi - lo)).astype("float32"), device)
        got_b, want_b = fk_fitness(spec, x, meta, swarm, **kw), fk_fitness_plain(
            spec, x, meta, swarm, **kw)
        x_dp = _t((lo[:, None] + rng.random((64, spec.dof, 1024)) * (hi - lo)[:, None])
                  .astype("float32"), device)
        got_c = fused_fitness(spec, x_dp, meta, swarm[:64], **kw)
        want_c = fused_fitness_plain(spec, x_dp, meta, swarm[:64], **kw)
        torch.cuda.synchronize()
        errs[("B", tag)] = check_fitness(f"fk_fitness {tag}", got_b, want_b, exact=True)
        errs[("C", tag)] = check_fitness(f"fused_fitness {tag}", got_c, want_c, exact=True)
        hit = float((want_b >= FLT_MAX).float().mean())
        if obs is not None and not 0.01 < hit < 0.99:
            raise AssertionError(f"{tag}: the check scene hits {hit} of the poses")
        del x, got_b, want_b, x_dp, got_c, want_c
        n_obs = kw["num_obstacles"]
        s = OD_REPLAY_SWARMS
        sw, zeros = swarm[:s], torch.zeros((s, 2), dtype=torch.int32, device=device)
        u = _t(rng.random((s, num_draws(pso), spec.dof, p), dtype=np.float32), device)
        kicked = []
        fused_solve_plain(spec, pso, fit, meta, sw, spec.limits(), zeros, p, uniforms=u,
                          num_obstacles=n_obs, use_orientation=orient,
                          on_kick=lambda k: kicked.append(int(k.sum())))
        errs[("A", tag)] = _compare_solve(
            "on_demand_replay", spec, pso, fit, meta, sw, zeros, p, u, num_obstacles=n_obs,
            bitwise=True, use_orientation=orient, case=tag, kicked_per_block=kicked)
        del u
        s = OD_PHILOX_SWARMS.get(tag, 1024)
        spec, pso, fit, p, meta, swarm, obs, orient = od_case(tag, device, s, rng, philox=True)
        seeds = _t(rng.integers(-2**31, 2**31, (s, 2), dtype=np.int64).astype(np.int32),
                   device)
        key = keys[tag]
        extra = {}
        if key.scratch:
            extra["scratch_grid"] = kernels.on_demand_library(key).ikpso_od_fused_solve_blocks(
                0, p, meta.numel(), swarm.shape[1])
        errs[("A", tag)] = max(errs[("A", tag)], _compare_solve(
            "on_demand_philox", spec, pso, fit, meta, swarm, seeds, p, None,
            num_obstacles=n_obs, bitwise=True, use_orientation=orient, case=tag, **extra))
        emit("on_demand_fitness", case=tag, key=key.name(), b_shape=[4096, 128, spec.dof],
             c_shape=[64, spec.dof, 1024], hit_share=hit,
             max_abs_err={"B": errs[("B", tag)], "C": errs[("C", tag)]},
             bar="max abs error 0.0", ok=True)
    return errs


def phase_config(device, name, card):
    """A document of ikpso_tpu_torch/configs at its batch through
    harness.configs.run_config (solve's solver), launch counts read around
    it; then its stage times (base solve, base + polish) and device busy
    with kernel A's share. Bars: ``JAX_CONFIGS``."""
    import torch

    from ikpso_tpu_torch.harness.cli import build_solver, pick_impl
    from ikpso_tpu_torch.harness.configs import config_problem, run_config

    swarms, polish = CONFIGS[name]
    reset_counts()
    t0 = time.perf_counter()
    out = run_config(CONFIG_DIR / f"{name}.json", swarms, polish, device, seed=0)
    phase_s = time.perf_counter() - t0
    launches = read_counts()
    jax = JAX_CONFIGS[name]
    lo50, hi50 = jax["p50_bar_mm"]
    lo90, hi90 = jax["p90_bar_mm"]
    accurate = lo50 <= out["p50_err_mm"] <= hi50 and lo90 <= out["p90_err_mm"] <= hi90
    if "colliding_solutions" in out:
        accurate = accurate and out["colliding_solutions"] <= CONFIG_COLLIDING_PER_SWARM * swarms
    cfg = _config(name, device)
    impl = pick_impl("auto", cfg, device)
    variant = od_variant({"arm7_locality": "distance", "arm7_exact": "exact"}.get(name, name))
    ok = (out["finite"] and accurate and impl == "fused"
          and launches["fused_solve_variants"] == {variant: 4})
    gen = torch.Generator(device=device).manual_seed(0)
    batched, _ = config_problem(cfg, swarms, gen)
    stages = _stage_times(device, [("base", build_solver(cfg, impl, 0, device), batched, 3)],
                          build_solver(cfg, impl, polish, device), batched, gen)
    emit(f"config_{name}", **out, wall_ms=out["wall_s"] * 1e3, launches=launches,
         expected_variant_launches={variant: 4}, stages=stages, run_config_seconds=phase_s,
         jax={**jax, "record": "CPU, scan solver, tests/test_torch_configs.py"},
         bars={"p50_err_mm": jax["p50_bar_mm"], "p90_err_mm": jax["p90_bar_mm"],
               **({"colliding_solutions": CONFIG_COLLIDING_PER_SWARM * swarms}
                  if "colliding_solutions" in out else {})},
         card=card, ok=bool(ok))
    if not ok:
        raise AssertionError(f"config {name} missed a bar or bypassed its kernel A variant")
    return launches, out


def phase_exact_vs_poly(device, exact_out, card):
    """arm7_exact's share under 1 mm against the same run with polynomial
    trig (same targets and seed): within 4 standard errors of the
    difference of two binomial shares."""
    import json as json_

    from ikpso_tpu_torch.harness.configs import run_config

    swarms, polish = CONFIGS["arm7_exact"]
    doc = json_.loads((CONFIG_DIR / "arm7_exact.json").read_text())
    doc["fitness"]["trig_impl"] = "poly"
    poly = run_config(doc, swarms, polish, device, seed=0, warmup=0, iters=1)
    a, b = exact_out["frac_under_1mm"], poly["frac_under_1mm"]
    pooled = (a + b) / 2
    se = (pooled * (1 - pooled) * 2 / swarms) ** 0.5
    ok = abs(a - b) <= 4 * se
    emit("exact_vs_poly", exact=a, poly=b, exact_failures=exact_out["failures_ge_1mm"],
         poly_failures=poly["failures_ge_1mm"], poly_p50_err_mm=poly["p50_err_mm"],
         poly_p90_err_mm=poly["p90_err_mm"], four_se=4 * se, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("arm7_exact's share under 1 mm departs from polynomial trig's")


CLI_RUNS = {
    "hand21": ("--config", "ikpso_tpu_torch/configs/hand21.json"),
    "reference_arm": (),
    "arm_7dof_preset": ("--model", "arm_7dof", "--preset"),
}
# The fitness each of them runs (solve's ``fitness_impl``).
CLI_FITNESS = {"hand21": "kernel-A", "reference_arm": "kernel-C",
               "arm_7dof_preset": "kernel-A"}


def phase_cli(card):
    """``python -m ikpso_tpu_torch.harness.cli solve`` as a user runs it,
    one process each: hand21's document (kernel A, built on demand), the
    default reference_arm (16,384 particles: the scan solver on kernel C)
    and arm_7dof's preset; each prints one JSON line with solve's keys."""
    root = Path(__file__).resolve().parent
    rows = {}
    for tag, args in CLI_RUNS.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ikpso_tpu_torch.harness.cli", "solve",
                               *args], capture_output=True, text=True, cwd=root, timeout=300)
        if proc.returncode:
            raise AssertionError(f"cli solve {tag} failed:\n{proc.stderr[-3000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        if (set(out) != {"angles", "fitness", "effector_error", "trace", "fitness_impl"}
                or out["fitness_impl"] != CLI_FITNESS[tag]):
            raise AssertionError(f"cli solve {tag} printed {sorted(out)}, fitness "
                                 f"{out.get('fitness_impl')}")
        rows[tag] = dict(seconds=time.perf_counter() - t0, dof=len(out["angles"]),
                         fitness_impl=out["fitness_impl"],
                         fitness=out["fitness"], effector_error=out["effector_error"],
                         trace_len=len(out["trace"]))
    # In process, with the launch counts read around it: the same solve on
    # the scan solver (--impl jnp), whose fitness is kernel C built on
    # demand for hand21, once at init, and whose iterations are the step's.
    iterations = 8
    reset_counts()
    line = _cli_lines(["solve", *CLI_RUNS["hand21"], "--impl", "jnp", "--particles", "1024",
                       "--iterations", str(iterations)])[-1]
    launches = read_counts()
    ok = (launches["fused_fitness"] == 1 and launches["scan_step"] == iterations
          and launches["fused_solve"] == 0 and len(line["trace"]) == iterations + 1)
    rows["hand21_jnp"] = dict(launches=launches, effector_error=line["effector_error"],
                              trace_len=len(line["trace"]))
    emit("cli", runs=rows, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("cli solve --impl jnp bypassed kernel C or the scan step")
    return launches


# The benchmark entry (python -m ikpso_tpu_torch.bench) as a user runs it:
# the default headline at its full batch (kernel A, with --sol), --latency
# (S=1,280, the 64x slope and a chain of 64 runs) and the scan solver on
# kernel C at a cut batch.
BENCH_RUNS = {
    "headline": (),
    "latency": ("--latency",),
    "pallas": ("--impl", "pallas", "--swarms", "4096", "--iterations", "20"),
}


def phase_bench(card):
    """``python -m ikpso_tpu_torch.bench`` as a user runs it, one process
    each (``BENCH_RUNS``): the headline record on the card through kernel A
    at S=1,048,576 with its failures and kernel A's ``sol_frac`` (in (0,
    1]: its bound is the published peaks); ``--latency``'s record with the
    host synchronizations one run makes; ``--impl pallas`` through kernel C
    and the scan step, and not A. The three run at once (they share the
    card, so their times are no measurement); each process's launch counts,
    ``--sol``'s keys and peak memory are read from its stderr."""
    t0 = time.perf_counter()
    outs = _spawn([[sys.executable, "-m", "ikpso_tpu_torch.bench", *args]
                   for args in BENCH_RUNS.values()])
    seconds = time.perf_counter() - t0
    rows, counts = {}, []
    for tag, (out, err) in zip(BENCH_RUNS, outs):
        extras = {}
        for line in err.splitlines():
            if line.startswith("{"):
                extras.update(json.loads(line))
        counts.append(extras["kernel_launches"])
        rows[tag] = dict(record=json.loads(out.strip().splitlines()[-1]),
                         sol_frac=extras.get("sol_frac"),
                         kernel_wall_ms=extras.get("kernel_wall_ms"),
                         peak_memory_bytes=extras["peak_memory_bytes"],
                         launches=extras["kernel_launches"],
                         host_syncs=[ln for ln in err.splitlines() if "synchronizations" in ln])
    head, lat, scan = (rows[t]["record"] for t in ("headline", "latency", "pallas"))
    sol = rows["headline"]["sol_frac"]
    checks = {
        "headline": (head["platform"] == "gpu" and head["impl"] == "fused"
                     and head["frac_under_1mm"] >= 0.999 and head["p50_err_mm"] < 1.0
                     and isinstance(head.get("failures_ge_1mm"), int)
                     and sol is not None and 0.0 < sol <= 1.0
                     and rows["headline"]["launches"]["fused_solve"] > 0),
        "latency": (lat["metric"] == "arm_7dof_latency_ms_per_1280solve_run"
                    and lat["impl"] == "fused" and lat["chained_runs"] == 64
                    and lat["chained_ms"] > 0 and lat["p50_err_mm"] < 1.0
                    and len(rows["latency"]["host_syncs"]) == 1
                    and rows["latency"]["launches"]["fused_solve"] > 0),
        "pallas": (scan["impl"] == "pallas" and scan["platform"] == "gpu"
                   and rows["pallas"]["launches"]["fused_fitness"] > 0
                   and rows["pallas"]["launches"]["scan_step"] > 0
                   and rows["pallas"]["launches"]["scan_step_replay"] == 0
                   and rows["pallas"]["launches"]["fused_solve"] == 0),
    }
    launches = _sum_counts(counts)
    ok = all(checks.values())
    emit("bench", runs=rows, checks=checks, launches=launches, seconds=seconds, card=card,
         ok=bool(ok))
    if not ok:
        raise AssertionError(f"bench: a run missed its check ({checks})")
    return launches


# The reference's own protocol (harness/experiment.py) through the CLI's
# `experiment`, as JAX's `parity` runs it (ikpso_tpu/harness/cli.py:410-427):
# reference_arm from reference_reset_targets, P=16,384, the shipped PSO
# variant (0.5/0.5/1.25, 15 randomized-inertia iterations), eps 0.025, 400
# frames at most, 128 trials a batch, an independent stream; 256 trials each,
# cut from JAX's 512 for time. The scan solver's fitness is kernel C.
EXPERIMENT_TRIALS = 256
EXPERIMENT_ARGS = ("--model", "reference_arm", "--particles", "16384", "--max-frames",
                   "400", "--trial-batch", "128", "--trials", str(EXPERIMENT_TRIALS))
EXPERIMENT_PROTOCOLS = {
    "iter1": ("--init-mode", "uniform", "--angle-weight", "0"),
    "iter2": ("--angle-weight", "0"),
    "iter3": ("--angle-weight", "3"),
}
# JAX's parity_r02 (bench_records/parity_r02.jsonl: the same protocols on
# 512 trials): mean and standard deviation of the frames to converge, all
# 512 converged. The bar: each port mean within 4 combined standard errors,
# sqrt(std^2 / 512 + std^2 / 256) with JAX's std: +-0.83, +-2.6, +-14.7.
PARITY_R02 = {"iter1": (3.21484375, 2.6968007383033514),
              "iter2": (5.859375, 8.505768159109243),
              "iter3": (39.033203125, 47.91648057463368)}
PARITY_R02_TRIALS = 512
# The reference's published means (BASELINE.md:17-23), printed beside.
PUBLISHED_FRAMES = {"iter1": 3.13, "iter2": 4.15, "iter3": 33.1}
# The locality gate and the native diagnostics: iter3 with 4 LM steps a
# frame on 32 trials, the four streams written by the port's native
# binding. At most 30 frames: trial 0, whose streams are checked, converges
# in 11-12 (it took 76 frames for all 32, at ~1.2 s of host dispatch a frame).
EXPERIMENT_POLISH_ARGS = ("--model", "reference_arm", "--particles", "16384",
                          "--max-frames", "30", "--trials", "32", "--trial-batch", "32",
                          "--polish", "4")

# Tracking (harness/trajectory.py) through the CLI's `track`: the recipe of
# docs/PERFORMANCE.md:982-992 (bench record r5-track): arm_7dof's preset
# (P=128, canonical inertia 0.5 -> 0.2, 4 LM steps), 8 iterations with a
# re-kick every 4, angle_weight 0.3, 4,096 circular paths of radius 0.25
# over 100 steps; kernel A at P=128.
TRACK_ARGS = ("--model", "arm_7dof", "--preset", "--rekick-interval", "4",
              "--angle-weight", "0.3", "--steps", "100")
TRACK_PATHS = 4096
# JAX's track at the same recipe on the CPU (the scan solver) on 256 paths,
# `PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py`: each
# path's settled (steps 25-99) p50 and p95 effector error in mm, one value per
# path, since the paths are the independent units and a path's steps are not;
# the median over paths of each, and the 99% distribution-free interval of
# each median, read on the 256 per-path values at order-statistic ranks 107
# and 150 of 256.
TRACK_JAX = {"p50_settled_mm": 1.9017210006713867, "p95_settled_mm": 2.7379310131073,
             "pooled_p50_settled_mm": 1.9386226776987314, "paths": 256}
TRACK_P50_INTERVAL_MM = (1.7401007413864136, 2.1495296955108643)
TRACK_P95_INTERVAL_MM = (2.5925939083099365, 3.0498554706573486)

# The waypoint sweep (solve_waypoints) through the CLI's `sweep`: arm_7dof's
# preset recipe (P=128, 8 iterations, 4 LM steps, 4 retry rounds) on the
# position-only cost, 1,024 waypoints jittered 0.25 around the targets, 256
# a batch, with a checkpoint.
SWEEP_ARGS = ("--model", "arm_7dof", "--preset", "--angle-weight", "0",
              "--waypoints", "1024", "--batch", "256")


def _cli_lines(argv):
    """``python -m ikpso_tpu_torch.harness.cli`` in process: its JSON lines."""
    import io

    from ikpso_tpu_torch.harness import cli

    with contextlib.redirect_stdout(io.StringIO()) as out:
        if cli.main(list(argv)) != 0:
            raise AssertionError(f"cli {argv[0]} returned non-zero")
    return [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]


def _flag(argv, name) -> int:
    """The integer value of flag ``name`` in ``argv``."""
    return int(argv[list(argv).index(name) + 1])


def _cli_config(device, argv):
    """The RunConfig and parsed arguments ``cli`` builds for ``argv``."""
    from ikpso_tpu_torch.harness import cli

    args = cli.build_parser().parse_args(list(argv))
    return cli._load(args, device), args


def phase_experiment(device, card):
    """The three published protocols through ``cli experiment`` (the scan
    solver: kernel C at init, the scan step each iteration; P=16,384),
    launch counts read around the three; then one frame of iter3's first
    batch alone and under the profiler, its device time split by kernel."""
    import math

    import torch

    from ikpso_tpu_torch.harness.trajectory import build_solver
    from ikpso_tpu_torch.models.library import batched_problem, reference_reset_targets
    from ikpso_tpu_torch.utils import seeds

    rows = {}
    reset_counts()
    for name, extra in EXPERIMENT_PROTOCOLS.items():
        before = read_counts()
        t0 = time.perf_counter()
        s = _cli_lines(["experiment", *EXPERIMENT_ARGS, *extra])[-1]
        mean_j, std_j = PARITY_R02[name]
        bar = 4.0 * std_j * math.sqrt(1.0 / PARITY_R02_TRIALS + 1.0 / EXPERIMENT_TRIALS)
        unconverged = s["trials"] - s["converged"]
        rows[name] = dict(
            frames_avg=s["frames_avg"], frames_min=s["frames_min"],
            frames_max=s["frames_max"], frames_std=s["frames_std"],
            unconverged=unconverged, solves_per_second=s["solves_per_second"],
            wall_s=s["wall_time_s"], process_s=time.perf_counter() - t0,
            fused_fitness_launches=read_counts()["fused_fitness"] - before["fused_fitness"],
            scan_step_launches=read_counts()["scan_step"] - before["scan_step"],
            graph_captures=read_counts()["graph_captures"] - before["graph_captures"],
            graph_replays=read_counts()["graph_replays"] - before["graph_replays"],
            angle_delta=s.get("angle_delta"), pos_delta=s.get("pos_delta"),
            jax_parity_r02_mean=mean_j, bar=f"|mean - {mean_j:.4f}| <= {bar:.4f}",
            published_mean=PUBLISHED_FRAMES[name],
            ok=bool(unconverged == 0 and abs(s["frames_avg"] - mean_j) <= bar))
    launches = read_counts()
    # Stages: one frame (a scan solve: kernel C, then the step) of iter3's
    # first trial batch at the reset, alone (median of 3 after 1) and profiled.
    cfg, _ = _cli_config(device, ["experiment", *EXPERIMENT_ARGS])
    batch = _flag(EXPERIMENT_ARGS, "--trial-batch")
    reset = reference_reset_targets(device=device)
    batched = batched_problem(cfg.problem, reset[None].expand(batch, *reset.shape))
    solver = build_solver(cfg.spec, pso=cfg.pso, fit=cfg.fitness,
                          num_particles=cfg.num_particles, impl="jnp", device=device)
    gen = seeds.generator(0, device)
    torch.cuda.reset_peak_memory_stats(device)
    stages = _stage_times(device, [("frame", solver, batched, 3)], solver, batched, gen)
    stages["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    ok = (all(r["ok"] for r in rows.values()) and launches["fused_solve"] == 0
          and launches["scan_step_replay"] == 0
          and all(r["fused_fitness_launches"] > 0
                  and r["scan_step_launches"] == cfg.pso.iterations
                  * r["fused_fitness_launches"] and r["graph_replays"] > 0
                  for r in rows.values()))
    emit("experiment", protocols=rows, trials=EXPERIMENT_TRIALS,
         particles=cfg.num_particles, trial_batch=batch,
         max_frames=_flag(EXPERIMENT_ARGS, "--max-frames"), launches=launches, stages=stages,
         reduced="256 trials a protocol, JAX's parity_r02 ran 512", card=card, ok=ok)
    if not ok:
        raise AssertionError("experiment missed its bar or bypassed the scan step")
    return launches


def phase_experiment_polish_diagnostics(card):
    """iter3 with the locality-gated LM polish a frame, ``--outdir``
    writing the four diagnostics streams through the port's native
    binding; the streams must exist and parse."""
    import tempfile

    from ikpso_tpu_torch import native

    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        s = _cli_lines(["experiment", *EXPERIMENT_POLISH_ARGS, "--outdir", tmp])[-1]
        launches = read_counts()
        out = Path(tmp)
        streams = {name: (out / f"IK-diagnostics-{name}.txt").read_text().splitlines()
                   for name in ("degrees", "positions", "distance", "frames")}
    degrees = [[float(v) for v in line.split(";")[:-1]] for line in streams["degrees"]]
    positions = [[float(v) for v in line.split(";")[:-1]] for line in streams["positions"]]
    distance = [float(v) for v in streams["distance"]]
    frames = [int(v) for v in streams["frames"]]
    ok = (native.available() and s["converged"] >= 1 and len(frames) == 1
          and len(degrees) == len(positions) == len(distance) == frames[0]
          and all(len(r) == 21 for r in degrees) and all(len(r) == 21 for r in positions)
          and distance[-1] <= 0.025 < (distance[0] if len(distance) > 1 else 1.0)
          and launches["fused_fitness"] > 0 and launches["scan_step"] > 0
          and launches["fused_solve"] == 0)
    emit("experiment_polish_diagnostics", summary=s, trial0_frames=frames,
         lines={k: len(v) for k, v in streams.items()}, distance_first_last=
         [distance[0], distance[-1]] if distance else None, launches=launches,
         native=native.available(), native_library=str(native.library_path()),
         card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("experiment --polish --outdir: diagnostics missing or malformed")
    return launches


def phase_track(device, card):
    """``cli track`` at the r5-track recipe (kernel A at P=128, the
    locality-gated polish a frame), launch counts read around it; then one
    frame's stages alone and profiled."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.harness import trajectory
    from ikpso_tpu_torch.harness.trajectory import build_solver, circle_paths, frame_solver
    from ikpso_tpu_torch.models.library import batched_problem
    from ikpso_tpu_torch.utils import seeds

    seen, real = [], trajectory.track_trajectories

    def recording(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    trajectory.track_trajectories = recording
    try:
        reset_counts()
        line = _cli_lines(["track", *TRACK_ARGS, "--paths", str(TRACK_PATHS), "--timeit"])[-1]
        launches = read_counts()
    finally:
        trajectory.track_trajectories = real
    # The medians over paths of each path's settled p50 / p95, as TRACK_JAX's.
    settled = np.asarray(seen[-1].errors)[line["settle"]:] * 1e3
    p50 = float(np.median(np.percentile(settled, 50, axis=0)))
    p95 = float(np.median(np.percentile(settled, 95, axis=0)))
    cfg, args = _cli_config(device, ["track", *TRACK_ARGS])
    path = circle_paths(cfg.problem.targets, steps=2, num_paths=TRACK_PATHS, seed=1)
    batched = batched_problem(cfg.problem, torch.as_tensor(path[1], device=device))
    base = build_solver(cfg.spec, pso=cfg.pso, fit=cfg.fitness,
                        num_particles=cfg.num_particles, impl="fused", device=device)
    full = frame_solver(cfg.spec, pso=cfg.pso, fit=cfg.fitness,
                        num_particles=cfg.num_particles, impl="fused", polish=args.polish,
                        device=device)
    stages = _stage_times(device, [("base", base, batched, 5), ("frame", full, batched, 5)],
                          full, batched, seeds.generator(0, device))
    steps = int(line["steps"])
    ok = (TRACK_P50_INTERVAL_MM[0] <= p50 <= TRACK_P50_INTERVAL_MM[1]
          and TRACK_P95_INTERVAL_MM[0] <= p95 <= TRACK_P95_INTERVAL_MM[1]
          and launches["fused_solve"] == 2 * steps and launches["fused_fitness"] == 0
          and bool(np.isfinite(line["err_max_settled"])))
    emit("track", **line, p50_settled_mm=p50, p95_settled_mm=p95,
         pooled_p50_settled_mm=line["err_p50_settled"] * 1e3,
         pooled_p95_settled_mm=line["err_p95_settled"] * 1e3,
         chained_solves_per_second=line["solves_per_second"], launches=launches,
         stages=stages, jax=TRACK_JAX, p50_interval_mm=TRACK_P50_INTERVAL_MM,
         p95_interval_mm=TRACK_P95_INTERVAL_MM, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("track missed JAX's intervals or bypassed kernel A")
    return launches


class _Cut(Exception):
    """Stops a sweep after a checkpoint, as a killed process would."""


def phase_sweep(device, card):
    """``cli sweep`` with a checkpoint, launch counts read around it; then
    the same sweep cut off after two batches and resumed from its
    checkpoint, which must return the uninterrupted sweep's angles and
    errors to the bit; then one batch's stages."""
    import tempfile

    import numpy as np

    from ikpso_tpu_torch.harness import trajectory
    from ikpso_tpu_torch.utils import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp:
        whole_path, cut_path = f"{tmp}/whole.npz", f"{tmp}/cut.npz"
        reset_counts()
        t0 = time.perf_counter()
        line = _cli_lines(["sweep", *SWEEP_ARGS, "--checkpoint", whole_path])[-1]
        wall = time.perf_counter() - t0
        launches = read_counts()
        real_save, saves = ckpt.save, []

        def save_then_cut(path, state):
            real_save(path, state)
            saves.append(state.cursor)
            if len(saves) == 2:
                raise _Cut

        ckpt.save = save_then_cut
        try:
            _cli_lines(["sweep", *SWEEP_ARGS, "--checkpoint", cut_path])
        except _Cut:
            pass
        finally:
            ckpt.save = real_save
        cut_cursor = ckpt.load(cut_path).cursor
        _cli_lines(["sweep", *SWEEP_ARGS, "--checkpoint", cut_path])
        whole, resumed = ckpt.load(whole_path), ckpt.load(cut_path)
    equal = bool(np.array_equal(whole.angles, resumed.angles)
                 and np.array_equal(whole.errors, resumed.errors))
    err_mm = whole.errors.astype(np.float64) * 1e3
    # Stages: one batch through solve_waypoints (kernel A, the polish and 4
    # retry rounds), alone and profiled.
    batch = _flag(SWEEP_ARGS, "--batch")
    cfg, args = _cli_config(device, ["sweep", *SWEEP_ARGS])
    rng = np.random.default_rng(0)
    tgt = cfg.problem.targets.cpu().numpy()
    wp = (tgt[None] + rng.normal(scale=0.25, size=(batch,) + tgt.shape)).astype(np.float32)

    def one_batch(problem, generator):
        del generator
        return trajectory.solve_waypoints(
            cfg.spec, problem, wp, 0, pso=cfg.pso, fit=cfg.fitness,
            num_particles=cfg.num_particles, batch_size=batch, impl="fused",
            retries=args.retries, polish=args.polish)

    stages = _stage_times(device, [("batch", one_batch, cfg.problem, 3)], one_batch,
                          cfg.problem, None)
    ok = (equal and saves == [batch, 2 * batch] and cut_cursor == 2 * batch
          and np.isfinite(err_mm).all() and launches["fused_solve"] >= 4
          and launches["fused_fitness"] == 0)
    emit("sweep", **line, wall_s=wall, frac_under_1mm=float((err_mm < 1.0).mean()),
         failures_ge_1mm=int((err_mm >= 1.0).sum()), p50_err_mm=float(np.median(err_mm)),
         resumed_equals_uninterrupted=equal, cut_after=saves, launches=launches,
         stages=stages, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("sweep: resume differs, non-finite errors or kernel A bypassed")
    return launches


def phase_slice_timing(device):
    """Kernel C at the experiment's shape (reference_arm, S=128, D=21,
    P=16,384, angle_weight 3.0) and kernel A at the track's (arm_7dof,
    S=4,096, P=128, 8 iterations, re-kick every 4): each against its plain
    twin on the same inputs (C: equal masks, max abs error 0.0; A: bit for
    bit), timed, with the counted work of the timed launch."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness_kernel import fused_fitness, fused_fitness_plain
    from ikpso_tpu_torch.pso.fused import fused_solve, fused_solve_plain
    from ikpso_tpu_torch.utils import flops

    rng = np.random.default_rng(12)
    times, counts, errs = {}, {}, {}
    cfg, _ = _cli_config(device, ["experiment", *EXPERIMENT_ARGS])
    s, p = _flag(EXPERIMENT_ARGS, "--trial-batch"), cfg.num_particles
    spec, batched = _problem("reference_arm", s, rng, device)
    meta, swarm = _packed(spec, batched, cfg.fitness)
    lim = spec.limits().cpu().numpy()
    x_dp = torch.as_tensor((lim[0][:, None] + rng.random((s, spec.dof, p))
                            * (lim[1] - lim[0])[:, None]).astype("float32"), device=device)
    times["fused_fitness_experiment_ms"], got = cuda_time(
        lambda: fused_fitness(spec, x_dp, meta, swarm), reps=20)
    times["fused_fitness_experiment_plain_ms"], want = cuda_time(
        lambda: fused_fitness_plain(spec, x_dp, meta, swarm), reps=3)
    errs["C experiment"] = check_fitness("fused_fitness experiment", got, want, exact=True)
    counts["c_experiment"] = flops.fitness_kernel_count(spec, cfg.fitness, num_swarms=s,
                                                        num_particles=p)
    del x_dp, got, want
    cfg, _ = _cli_config(device, ["track", *TRACK_ARGS])
    spec, batched = _problem("arm_7dof", TRACK_PATHS, rng, device)
    meta, swarm = _packed(spec, batched, cfg.fitness)
    seeds = torch.as_tensor(
        rng.integers(-2**31, 2**31, (TRACK_PATHS, 2), dtype=np.int64).astype(np.int32),
        device=device)
    args = (spec, cfg.pso, cfg.fitness, meta, swarm, spec.limits(), seeds, cfg.num_particles)
    times["fused_solve_track_ms"], got = cuda_time(lambda: fused_solve(*args), reps=20)
    times["fused_solve_track_plain_ms"], want = cuda_time(
        lambda: fused_solve_plain(*args), reps=1)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("kernel A disagrees with fused_solve_plain at the track shape")
    errs["A track"] = 0.0
    kicks = flops.fused_solve_kicks(*args)
    counts["a_track"] = flops.fused_solve_count(
        spec, cfg.pso, cfg.fitness, num_particles=cfg.num_particles,
        num_swarms=TRACK_PATHS, kicks=kicks)
    emit("slice_timing", **times, kicks=kicks, max_abs_err=errs,
         experiment_shape=[s, 21, p], track_shape=[TRACK_PATHS, cfg.num_particles, spec.dof],
         bar={"C experiment": "equal masks, max abs error 0.0 on free particles",
              "A track": "bit-identical gbest and gval"}, clocks=card_clocks(), ok=True)
    return times, counts, errs


# The scan step's timed launches: (key, model, swarms, particles, the steps
# timed (1-based, each on the state of the steps before it), the CLI
# arguments whose recipe it takes). The scan path's step 31 and the
# experiment's step 8 are the rows of the kernels line; steps 1 and 59 show
# how a later state moves the step (fewer lbest rows improve).
STEP_TIMED = (
    ("scan", "arm_7dof", SCAN_SWARMS, 1024, STEP_STEPS["scan"], None),
    ("experiment", "reference_arm", 128, 16_384, STEP_STEPS["experiment"],
     ["experiment", *EXPERIMENT_ARGS, *EXPERIMENT_PROTOCOLS["iter3"]]),
)


def _step_timing(device, model, swarms, particles, timed_steps, argv, reps=10):
    """Scan-step launches at ``timed_steps`` of a solve of the drawing step
    (its seed words from a seeded generator), each timed by CUDA events
    around the launch alone (the state restored before each of ``reps``
    launches after one more: each moves the same bytes, and the restore
    evicts L2; a spin kernel ahead of the start event keeps the host's
    enqueue out of the window), the drawing step and the replay step in
    turns (drawing, replay, replay, drawing) on the same uniforms (the
    replay step reads ``step_uniforms``' block of that iteration), both held
    bit for bit to ``pso_iteration`` on kernel C's plain twin fed that
    block; returns ``{step: (drawing ms, replay ms, plain ms, drawing count,
    replay count, improved, pairs)}``, each ms the median of its launches
    and ``pairs`` the means of each turn."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.harness.scan import scan_configs
    from ikpso_tpu_torch.ops import fk as fk_ops
    from ikpso_tpu_torch.ops.fitness_kernel import make_kernel_fitness
    from ikpso_tpu_torch.ops.philox import step_uniforms
    from ikpso_tpu_torch.pso.solver import (draws_per_iteration, init_swarm, pso_iteration,
                                            scan_step, step_buffers, step_seeds, step_work)
    from ikpso_tpu_torch.utils import flops

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
    state = step_buffers(init_swarm(gen, fk_ops.pose_to_angles(spec, batched.pose),
                                    particles, fitness, pso, limits=(lo, hi)))
    seeds = step_seeds(gen, swarms, device)
    work = step_work(swarms, particles, device)
    n = draws_per_iteration(pso)

    def timed(run, count):
        ms = []
        for _ in range(count + 1):
            for a, b in zip(state, snap):
                a.copy_(b)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(2_000_000)  # the card busy while the host enqueues the launch
            start.record()
            out = run()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        return ms[1:], tuple(t.clone() for t in out)

    out, it = {}, 0
    for step in timed_steps:
        for it in range(it, step - 1):
            state = scan_step(fitness, *state, None, limits, pso, iteration=it, work=work,
                              seeds=seeds)
        it = step - 1
        snap = tuple(t.clone() for t in state)
        u = step_uniforms(seeds, it, n, particles, spec.dof)

        def drawing():
            return scan_step(fitness, *state, None, limits, pso, iteration=it, work=work,
                             seeds=seeds)

        def replay():
            return scan_step(fitness, *state, u, limits, pso, iteration=it, work=work)

        pairs, runs = [], {drawing: [], replay: []}
        for first, second in ((drawing, replay), (replay, drawing)):
            a, got_a = timed(first, reps)
            b, got_b = timed(second, reps)
            runs[first] += a
            runs[second] += b
            pairs.append((np.mean(a), np.mean(b)) if first is drawing
                         else (np.mean(b), np.mean(a)))
            if not _states_equal(got_a, got_b):
                raise AssertionError(f"drawing and replay steps disagree at {model} "
                                     f"S={swarms}, step {step}")
        # pso_iteration leaves its inputs as they are; the steps update them.
        plain_ms, want = timed(lambda: pso_iteration(*state, u, fitness.plain, lo, hi, pso,
                                                     iteration=it), 1)
        if not _states_equal(got_a, want):
            raise AssertionError(f"scan step disagrees with pso_iteration at {model} "
                                 f"S={swarms}, step {step}")
        improved = int((got_a[3] < snap[3]).sum())
        kick = pso.rekick_interval > 0 and it > 0 and it % pso.rekick_interval == 0
        counts = [flops.scan_step_count(spec, pso, fit, num_swarms=swarms,
                                        num_particles=particles, improved=improved, kick=kick,
                                        drawing=drawing_step) for drawing_step in (True, False)]
        out[step] = (float(np.median(runs[drawing])), float(np.median(runs[replay])),
                     float(plain_ms[0]), *counts, improved,
                     [[float(a), float(b)] for a, b in pairs])
        for a, b in zip(state, snap):  # on from the state before the timed step
            a.copy_(b)
    return out


def phase_step_timing(device):
    """The scan step at the scan path's shape (steps 1, 31 and 59) and the
    experiment's (step 8): the drawing and the replay instantiation's
    times, the plain time, their counted work and the improved particles of
    the timed launch."""
    times, counts, improved, pairs = {}, {}, {}, {}
    for key, model, swarms, particles, steps, argv in STEP_TIMED:
        for step, (ms, replay_ms, plain_ms, count, replay_count, imp, pr) in _step_timing(
                device, model, swarms, particles, steps, argv).items():
            (count_key, ms_key), (replay_count_key, replay_ms_key) = (
                _step_keys(key, step, r) for r in (False, True))
            times[ms_key], times[replay_ms_key] = ms, replay_ms
            times[ms_key.replace("_ms", "_plain_ms")] = plain_ms
            counts[count_key], counts[replay_count_key] = count, replay_count
            improved[f"{key} step {step}"] = imp
            pairs[f"{key} step {step}"] = pr
    emit("step_timing", **times, improved=improved, drawing_replay_pairs_ms=pairs,
         shapes={k: [m, s, p, list(st)] for k, m, s, p, st, _ in STEP_TIMED},
         bar="drawing and replay steps bit-identical to each other and to pso_iteration "
             "on kernel C's plain twin fed step_uniforms' block", clocks=card_clocks(),
         ok=True)
    return times, counts


def phase_on_demand_timing(device):
    """Per ``OD_TIMED`` case: kernel A against its plain twin (each output
    held against the plain one's), kernels B and C against theirs, and the
    counted work of each timed launch (kicks and collider work along the
    plain trajectory)."""
    import numpy as np
    import torch

    from ikpso_tpu_torch.ops.fitness_kernel import (
        fk_fitness,
        fk_fitness_plain,
        fused_fitness,
        fused_fitness_plain,
    )
    from ikpso_tpu_torch.pso.fused import fused_solve, fused_solve_plain, uses_distance
    from ikpso_tpu_torch.utils import flops

    times, counts = {}, {}
    clocks = {"start": card_clocks()}
    for tag, (a_s, b_s, c_s) in OD_TIMED.items():
        rng = np.random.default_rng(22)
        spec, pso, fit, p, meta, swarm, obs, orient = od_case(tag, device, a_s, rng,
                                                              philox=True)
        n_obs = 0 if obs is None else obs.count
        seeds = _t(rng.integers(-2**31, 2**31, (a_s, 2), dtype=np.int64).astype(np.int32),
                   device)
        args = (spec, pso, fit, meta, swarm, spec.limits(), seeds, p)
        kw = dict(num_obstacles=n_obs, use_orientation=orient)
        times[f"a_{tag}_ms"], got = cuda_time(lambda: fused_solve(*args, **kw), reps=3)
        times[f"a_{tag}_plain_ms"], want = cuda_time(lambda: fused_solve_plain(*args, **kw),
                                                     reps=1)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"kernel A ({tag}) disagrees with its plain twin at the "
                                 "timed shape")
        kicks = flops.fused_solve_kicks(*args, **kw) if pso.rekick_interval else 0.0
        collider = (flops.fused_solve_collider_work(*args, num_obstacles=n_obs)
                    if n_obs else 0.0)
        counts[f"a_{tag}"] = flops.fused_solve_count(
            spec, pso, fit, num_particles=p, num_swarms=a_s, num_obstacles=n_obs,
            collider_ops=collider, use_orientation=orient, kicks=kicks)
        del got, want, args
        fkw = dict(num_obstacles=n_obs, collision_shape=fit.collision_shape,
                   use_orientation=orient, use_distance_term=uses_distance(fit),
                   trig_impl=fit.trig_impl)
        lo, hi = spec.limits().cpu().numpy()
        for kernel, s_k, p_k in (("b", b_s, 128), ("c", c_s, 1024)):
            _, _, _, _, meta_k, swarm_k, _, _ = od_case(tag, device, s_k, rng)
            if kernel == "b":
                x = _t((lo + rng.random((s_k, p_k, spec.dof)) * (hi - lo)).astype("float32"),
                       device)
                kfn, pfn = fk_fitness, fk_fitness_plain
                x_spd = x
            else:
                x = _t((lo[:, None] + rng.random((s_k, spec.dof, p_k)) * (hi - lo)[:, None])
                       .astype("float32"), device)
                kfn, pfn = fused_fitness, fused_fitness_plain
                x_spd = x.transpose(1, 2)
            times[f"{kernel}_{tag}_ms"], got = cuda_time(
                lambda: kfn(spec, x, meta_k, swarm_k, **fkw), reps=20)
            times[f"{kernel}_{tag}_plain_ms"], want = cuda_time(
                lambda: pfn(spec, x, meta_k, swarm_k, **fkw), reps=3)
            check_fitness(f"{kernel} {tag} timed", got, want, exact=True)
            work = (flops.collider_work(spec, x_spd, meta_k, swarm_k, num_obstacles=n_obs,
                                        collision_shape=fit.collision_shape,
                                        trig_impl=fit.trig_impl)
                    if n_obs else 0.0)
            counts[f"{kernel}_{tag}"] = flops.fitness_kernel_count(
                spec, fit, num_swarms=s_k, num_particles=p_k, num_obstacles=n_obs,
                collider_ops=work, use_orientation=orient)
            del x, got, want, x_spd
    clocks["end"] = card_clocks()
    emit("on_demand_timing", **times, timed=OD_TIMED, clocks=clocks,
         bar="bit-identical kernel A; max abs error 0.0 for B and C")
    return times, counts


def phase_sass_sincos():
    """The instructions libdevice's sinf and cosf issue on their fast path,
    from the SASS of two probe kernels built with the port's flags
    (cuobjdump -sass): the range reduction up to the slow-path branch and
    its reconvergence, then each polynomial and quadrant select up to the
    store; address arithmetic, loads, stores and the exit are not counted.
    Held against ``utils.flops.EXACT_SINCOS_OPS``."""
    import tempfile

    from ikpso_tpu_torch.utils import flops, kernels

    src = ('extern "C" __global__ void k_sin(const float* x, float* y) '
           '{ y[threadIdx.x] = sinf(x[threadIdx.x]); }\n'
           'extern "C" __global__ void k_cos(const float* x, float* y) '
           '{ y[threadIdx.x] = cosf(x[threadIdx.x]); }\n')
    skip = ("LDC", "S2R", "LDG", "STG", "EXIT", "ULDC", "IMAD.WIDE", "LEA", "NOP",
            "SHF.R.S32.HI")
    with tempfile.TemporaryDirectory() as tmp:
        cu, cubin = Path(tmp) / "sincos.cu", Path(tmp) / "sincos.cubin"
        cu.write_text(src)
        run([kernels._nvcc(), "-cubin", *kernels.NVCC_FLAGS[:2], "-O3", "-fmad=false",
             "-o", str(cubin), str(cu)])
        sass = run([str(Path(kernels._nvcc()).with_name("cuobjdump")), "-sass", str(cubin)])
    parts = {}
    for fn in ("k_sin", "k_cos"):
        body = sass.split(f"Function : {fn}")[1].split("Function : ")[0]
        ins = [(int(a, 16), t) for a, t in
               re.findall(r"/\*([0-9a-f]{4})\*/\s+([^;]+);", body)]
        b_addr, target = next((a, int(t.split("0x")[1], 16)) for a, t in ins
                              if re.match(r"@!P\d BRA 0x", t))
        fast = [(a, t) for a, t in ins if (a <= b_addr or a >= target)
                and not re.sub(r"^@!?P\d ", "", t).startswith(skip)
                and not (t.startswith("BRA") and a > target)]
        shared = sum(1 for a, t in fast if a <= b_addr or t.startswith("BSYNC"))
        parts[fn] = (shared, len(fast) - shared)
    total = parts["k_sin"][0] + parts["k_sin"][1] + parts["k_cos"][1]
    ok = parts["k_sin"][0] == parts["k_cos"][0] and total == flops.EXACT_SINCOS_OPS
    emit("sass_sincos", shared=parts["k_sin"][0], sin_tail=parts["k_sin"][1],
         cos_tail=parts["k_cos"][1], sincos_ops=total,
         flops_exact_sincos_ops=flops.EXACT_SINCOS_OPS, ok=bool(ok))
    if not ok:
        raise AssertionError("sinf / cosf's fast path differs from utils/flops.py's count")
    return total


def phase_sass_philox():
    """The integer instructions of one Philox call in kernel E's loop, from
    the SASS of ``roofline.cu`` built with the port's flags (cuobjdump
    -sass): the loop is the longest span closed by a backward branch in
    ``philox_xor_kernel``; its calls a trip are its wide multiplies over
    those of the lone call the compiler peels after it (the remainder of
    an odd step count); every instruction of the loop but the closing
    branch is integer work."""
    import tempfile
    from collections import Counter

    from ikpso_tpu_torch.utils import kernels

    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "roofline.cubin"
        run([kernels._nvcc(), "-cubin", *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-o", str(cubin), str(kernels.CSRC / "roofline.cu")])
        sass = run([str(Path(kernels._nvcc()).with_name("cuobjdump")), "-sass", str(cubin)])
    body = sass.split("philox_xor_kernel")[1].split("Function : ")[0]
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4})\*/\s+([^;]+);", body)]
    loops = [(int(t.split("0x")[1], 16), a) for a, t in ins
             if re.match(r"(@!?P\d )?BRA 0x", t) and int(t.split("0x")[1], 16) < a]
    start, end = max(loops, key=lambda span: span[1] - span[0])
    store = next(a for a, t in ins if t.startswith("STG"))
    loop = [t for a, t in ins if start <= a < end]
    peeled = [t for a, t in ins if end < a < store]

    def wide(block):
        return sum(t.startswith("IMAD.WIDE.U32") for t in block)

    calls = wide(loop) // wide(peeled) if wide(peeled) else 1
    per_call = len(loop) / calls
    opcodes = Counter(t.split()[0] for t in loop)
    ok = calls >= 1 and wide(loop) == calls * wide(peeled or loop) and all(
        not op.startswith(("BRA", "F", "H", "D", "LD", "ST")) for op in opcodes)
    emit("sass_philox", loop_instructions=len(loop), calls_per_trip=calls,
         int_instructions_per_call=per_call, opcodes=dict(opcodes), ok=bool(ok))
    if not ok:
        raise AssertionError("kernel E's loop is not all integer work, or its calls a "
                             "trip cannot be read")
    return per_call


# SASS instruction classes (phase_sass_kernel_a), by opcode; an opcode of
# the uniform datapath not listed is "uniform".
SASS_CLASSES = (
    ("fp32", ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FRND", "FCHK", "MUFU",
              "FSET", "HFMA2")),
    ("integer", ("IMAD", "IADD3", "IADD", "LOP3", "SHF", "VIADD", "ISETP", "SEL", "LEA",
                 "IMNMX", "VIMNMX", "PRMT", "I2FP", "F2I", "I2F", "POPC", "FLO", "IABS",
                 "IMUL")),
    ("move", ("MOV", "CS2R", "S2R", "S2UR", "R2UR", "PLOP3", "P2R", "R2P")),
    ("shared_load", ("LDS",)), ("shared_store", ("STS",)), ("local", ("LDL", "STL")),
    ("global", ("LDG", "STG", "LDC")), ("shuffle", ("SHFL",)), ("redux", ("REDUX",)),
    ("barrier", ("BAR",)),
    ("branch", ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "WARPSYNC", "BMOV", "NOP")),
)
# The headline instantiation of kernel A (arm_7dof, no scene, no
# orientation, the Philox draws) in mangled names: the short chains'
# canonical one at the 256-thread bound, or an older checkout's one.
HEADLINE_KERNEL_A = (
    r"fused_solve_short_kernelINS_8TopologyILi4ELy8448ELj8EEELi0ELb0ELb0ELi256ELb1E",
    r"fused_solve_kernelINS_8TopologyILi4ELy8448ELj8EEELi0ELb0ELb0EEE")
WARP_ISSUE_PER_SM_CLOCK = 4  # an H100 SM: four schedulers, one warp instruction a clock each
# The trees' kernel A in SASS (phase_sass_kernel_a): case -> (swarms,
# particles, iterations of its path's base solve, the pattern of its Philox
# instantiation's mangled name, without the orientation term: the tree loop,
# or the general loop of a build that predates it or of a topology that
# keeps it; an ON_DEMAND_CASES case is read from its on-demand library).
# reference_arm (8 nodes) and snake_30dof (11) at their presets' batches.
TREE_SASS = {
    "humanoid_45dof": (16_384, 512, 60,
                       r"fused_solve(?:_tree)?_kernelINS_8TopologyILi16E\w*?ELi0ELb0ELb0EEEv"),
    "dual_arm_14dof": (262_144, 1024, 8,
                       r"fused_solve(?:_tree)?_kernelINS_8TopologyILi7E\w*?ELi0ELb0ELb0EEEv"),
    "dual_arm_box": (262_144, 1024, 8,
                     r"fused_solve(?:_tree)?_kernelINS_16OnDemandTopology\w*?ELi1ELb0ELb0EEEv"),
    "reference_arm": (262_144, 256, 100,
                      r"fused_solve(?:_tree)?_kernelINS_8TopologyILi8E\w*?ELi0ELb0ELb0EEEv"),
    "snake_30dof": (65_536, 256, 4,
                    r"fused_solve(?:_tree)?_kernelINS_8TopologyILi11E\w*?ELi0ELb0ELb0EEEv"),
    **{case: (swarms, particles, iterations,
              rf"fused_solve(?:_tree)?_kernelINS_16OnDemandTopology\w*?ELi{c}ELb0ELb0EEEv")
       for case, swarms, particles, iterations, c in (
           ("dual_arm_capsule", 262_144, 1024, 8, 2), ("dual_arm_distance", 262_144, 1024, 8, 0),
           ("dual_arm_exact", 262_144, 1024, 8, 0), ("hand12", 16_384, 512, 60, 0),
           ("hand12_box", 16_384, 512, 60, 1))},
}


def sass_class(text):
    """The SASS_CLASSES class of one instruction (its predicate dropped)."""
    op = re.sub(r"^@!?U?P[T\d] ", "", text).split()[0].split(".")[0]
    for name, ops in SASS_CLASSES:
        if op in ops:
            return name
    return "uniform" if op.startswith("U") else "other"


def sass_loop_mix(sass, function, nested=False):
    """One trip of a kernel's main loop (its longest span closed by a
    backward branch; with ``nested``, its longest such span inside another:
    the PSO loop of a kernel whose grid strides over the swarms) in
    ``sass`` (cuobjdump -sass text), by instruction
    class: ``loop_static``, every instruction of the span; ``loop_path``,
    the span less its inner loops and less the blocks a forward branch
    skips that hold Philox products and no barrier (the optional draws: the
    randomized inertia's and the re-kick's, which the headline does not
    run)."""
    from collections import Counter

    body = sass.split(f"Function : {function}")[1].split("Function : ")[0]
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,5})\*/\s+([^;]+);", body)]

    def target(t):
        m = re.match(r"(?:@!?U?P[T\d] )?BRA (?:!?U?P\d, )?0x([0-9a-f]+)", t)
        return int(m.group(1), 16) if m else None

    back = [(target(t), a) for a, t in ins if target(t) is not None and target(t) < a]
    if nested:
        back = [(s, e) for s, e in back
                if any(s2 < s and e < e2 for s2, e2 in back)] or back
    start, end = max(back, key=lambda span: span[1] - span[0])
    loop = [(a, t) for a, t in ins if start <= a <= end]
    skipped = {a for s, e in back if start < s and e < end for a, _ in loop if s <= a <= e}
    draws = 0
    for a, t in loop:
        tg = target(t)
        if tg is None or tg <= a or tg > end or not t.startswith("@"):
            continue
        span = [(b, u) for b, u in loop if a < b < tg]
        if (any(u.startswith("IMAD.WIDE.U32") for _, u in span)
                and not any(u.startswith("BAR") for _, u in span)):
            draws += 1
            skipped |= {b for b, _ in span}
    path = [t for a, t in loop if a not in skipped]
    return {"loop_static": dict(Counter(sass_class(t) for _, t in loop)),
            "loop_path": dict(Counter(sass_class(t) for t in path)),
            "static_instructions": len(loop), "path_instructions": len(path),
            "inner_loops": sum(1 for s, e in back if start < s and e < end),
            "skipped_draw_blocks": draws}


def phase_sass_cluster(tag="hand21"):
    """Kernel A's cluster layout in SASS: one trip of the PSO loop (the
    loop inside the swarms' loop) of an on-demand case's Philox
    instantiation without the orientation term, by instruction class."""
    from ikpso_tpu_torch.utils import kernels

    lib = kernels.on_demand_path(od_keys()[tag])
    sass = run([str(Path(kernels._nvcc()).with_name("cuobjdump")), "-sass", str(lib)])
    function = next(f for f in re.findall(r"Function : (\S+)", sass)
                    if "fused_solve_tree_cluster_kernel" in f and "Lb0ELb0EEEv" in f)
    row = {"function": function, **sass_loop_mix(sass, function, nested=True)}
    emit("sass_cluster", case=tag, **row, ok=True)
    return row


def issue_row(sass, pattern, shape, sms, max_hz, nested=False):
    """One trip of the PSO loop of the first function in ``sass`` whose
    mangled name matches ``pattern`` (sass_loop_mix), with the issue-rate
    time of a solve of ``shape`` (swarms, particles, iterations): (iterations
    + 1) trips a warp at one warp instruction a scheduler a clock over
    ``sms`` SMs at ``max_hz``; None where no function matches."""
    function = next((f for f in re.findall(r"Function : (\S+)", sass)
                     if re.search(pattern, f)), None)
    if function is None:
        return None
    swarms, particles, iterations = shape
    row = sass_loop_mix(sass, function, nested=nested)
    row.update(function=function, shape={"swarms": swarms, "particles": particles,
                                         "iterations": iterations},
               issue_bound_ms=swarms * particles // 32 * (iterations + 1)
               * row["path_instructions"] / (WARP_ISSUE_PER_SM_CLOCK * sms * max_hz) * 1e3)
    return row


def tree_sass_rows(sass_of, sms, max_hz):
    """The trees' kernel A (TREE_SASS) in SASS (issue_row): each case whose
    library ``sass_of(case)`` gives (cuobjdump -sass text, or None to
    skip)."""
    rows = {}
    for case, (swarms, particles, iterations, pattern) in TREE_SASS.items():
        sass = sass_of(case)
        row = None if sass is None else issue_row(sass, pattern,
                                                  (swarms, particles, iterations), sms, max_hz)
        if row is not None:
            rows[case] = row
    return rows


def phase_sass_kernel_a(other_root=None, swarms=HEADLINE_SWARMS, particles=128,
                        iterations=8):
    """The headline instantiation of kernel A in SASS (cuobjdump -sass of
    the built prebuilt library): one trip of its PSO loop by instruction
    class (sass_loop_mix), and with ``other_root`` the same for that
    checkout's library, built with this checkout's flags; and the
    issue-rate time of the headline's solve, (iterations + 1) loop trips a
    warp (the init's draws and evaluation are about one trip) at one warp
    instruction a scheduler a clock, over the card's SMs at its maximum SM
    clock. The trees' kernel A likewise (tree_sass_rows: the prebuilt
    trees, and the on-demand cases' libraries where they are built), in
    ``trees``. Returns this build's row and its trees' rows."""
    import torch

    from ikpso_tpu_torch.utils import kernels

    max_hz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"]).split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps = swarms * particles // 32
    libs = {"this": kernels.build()}
    if other_root:
        with _sources(other_root) as other:
            libs["other"] = other.build()
    objdump = str(Path(kernels._nvcc()).with_name("cuobjdump"))
    out, trees = {}, {}
    for who, lib in libs.items():
        sass = run([objdump, "-sass", str(lib)])
        names = re.findall(r"Function : (\S+)", sass)
        function = next(f for pattern in HEADLINE_KERNEL_A for f in names
                        if re.search(pattern, f))
        row = sass_loop_mix(sass, function)
        per_warp = (iterations + 1) * row["path_instructions"]
        row.update(function=function, issue_bound_ms=warps * per_warp / (
            WARP_ISSUE_PER_SM_CLOCK * sms * max_hz) * 1e3)
        out[who] = row
        od = {}
        if who == "this":
            od = {tag: kernels.on_demand_path(key) for tag, key in od_keys().items()}

        def sass_of(case, sass=sass, od=od):
            if case not in ON_DEMAND_CASES:
                return sass
            return run([objdump, "-sass", str(od[case])]) if case in od and od[
                case].exists() else None

        trees[who] = tree_sass_rows(sass_of, sms, max_hz)
    emit("sass_kernel_a", **out, trees=trees, sms=sms, max_sm_hz=max_hz,
         shape={"swarms": swarms, "particles": particles, "iterations": iterations},
         ok=True)
    return out["this"], trees["this"]


# This slice's paths: GJK on the card (agreement with SAT, and the GJK
# document's solve through harness.configs with --impl jnp), host-gather
# and from-best retries on the headline batch, the sharded solves of two
# ranks on one card, the two-process sweep through the CLI, and viz.
GJK_SWARMS, GJK_PARTICLES = 4096, 128  # 4,096 x 128 random poses: 6.3 M GJK lanes a collider
GJK_AGREEMENT_BAR = 0.995  # JAX's GJK-vs-SAT bar (bench.py:449-485)
# Poses held against the CPU port's GJK: a cut of the 524,288 (the CPU
# runs ~10^6 lane-rounds a second).
GJK_CPU_POSES = 2048
GJK_CONFIG, GJK_CONFIG_SWARMS, GJK_CONFIG_POLISH = "arm7_box_gjk", 4096, 4
# JAX's bars for the GJK document: `JAX_PLATFORMS=cpu python
# tests/test_torch_configs.py arm7_box_gjk` (ikpso_tpu.utils.configio,
# the scan solver, wrap_with_polish with the document's scene and GJK
# collider, 4 steps; taken on a CPU): compiled on 1,024 targets, op by op
# on 256 (the op-by-op GJK is ~50x slower). The port's p50 and p90 (mm)
# must lie inside the hull of the two evaluations' 99% intervals.
JAX_GJK_CONFIG = {
    "p50_bar_mm": (0.00012013700256829907, 0.0001365714012990793),
    "p90_bar_mm": (0.0002980232238769531, 0.12442386650945991),
    "p50_jit": (0.00012383438274810032, (0.00012013700256829907, 0.00013328003944934608)),
    "p50_op_by_op": (0.00013328003944934608, (0.00012287812012345967, 0.0001365714012990793)),
    "p90_jit": (0.001955755033122845, (0.00032098083124765253, 0.010953732271445915)),
    "p90_op_by_op": (0.0023324050289375035, (0.0002980232238769531, 0.12442386650945991)),
    "failures_ge_1mm": 37,
    "failures_ge_1mm_op_by_op": 11,
    "swarms": 1024,
    "swarms_op_by_op": 256,
    "frac_targets_feasible": 0.9423828125,
    "colliding_solutions": 0,
}
RETRY_THRESHOLD, RETRY_ROUNDS, RETRY_BUCKET = 1e-3, 4, 1024
SHARDED_RANKS = 2
SHARDED_SCAN_SWARMS, SHARDED_SCAN_PARTICLES = 4096, 1024
MULTIHOST_TIMEOUT_S = 600


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argvs, timeout=MULTIHOST_TIMEOUT_S):
    """One process per argv, all at once, from the repository root; their
    ``(stdout, stderr)``. A process that fails or outlives ``timeout``
    fails the phase; every process is killed on the way out."""
    root = Path(__file__).resolve().parent
    procs = [subprocess.Popen(argv, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise AssertionError(f"process {i} exited {p.returncode}:\n{err[-3000:]}")
    return outs


def _sum_counts(counts):
    """The launch counts of several processes, added."""
    out = {name: sum(c.get(name, 0) for c in counts)
           for name in (*_wrappers(), "scan_step_replay")}
    variants = {}
    for c in counts:
        for k, v in c.get("fused_solve_variants", {}).items():
            variants[k] = variants.get(k, 0) + v
    out["fused_solve_variants"] = variants
    return out


def phase_gjk(device, card):
    """(a) GJK's chain-collider masks on the card against SAT's on 4,096 x
    128 random in-limit arm_7dof poses in the 4-box scene (agreement above
    JAX's 0.995), and against the CPU port's GJK on the first
    ``GJK_CPU_POSES`` poses; the peak memory of the GJK call. (b) The GJK
    document's solve through harness.configs with --impl jnp (the scan
    solver on the plain fitness: no kernel fuses GJK), launch counts read
    around it: no colliding solution under SAT or GJK past 1e-4 S, p50
    under 1 mm, p50 and p90 inside JAX's intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ikpso_tpu_torch.harness.configs import run_config
    from ikpso_tpu_torch.harness.headline import reachable_pose
    from ikpso_tpu_torch.harness.obstacles import obstacle_scene
    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.ops import fk as fk_ops
    from ikpso_tpu_torch.ops.collision import chain_collides
    from ikpso_tpu_torch.ops.gjk import GJK_ITERATIONS, chain_collides_gjk

    t_phase = time.perf_counter()
    spec, problem = library.arm_7dof(device=device)
    n = GJK_SWARMS * GJK_PARTICLES
    pose = reachable_pose(spec, problem, n, torch.Generator(device=device).manual_seed(0))
    pos, rot = fk_ops.fk(spec, pose, problem.origin)
    par = list(spec.parent[1:])

    def args(pos, rot, length, obs):
        return (pos[:, 1:], rot[:, 1:], pos[:, par], length, obs.center, obs.half_extent,
                obs.rot)

    obs = obstacle_scene(spec, 4, device=device)
    card_args = args(pos, rot, spec.length[1:], obs)
    lanes = n * len(par) * obs.count
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gjk = chain_collides_gjk(*card_args)
        torch.cuda.synchronize()
        gjk_ms = (time.perf_counter() - t0) * 1e3
    gjk_busy_ms = _device_ms(prof, {})[0]
    peak = torch.cuda.max_memory_allocated(device) - before
    t0 = time.perf_counter()
    sat = chain_collides(*card_args)
    torch.cuda.synchronize()
    sat_ms = (time.perf_counter() - t0) * 1e3
    agree = float((gjk == sat).double().mean())
    k = GJK_CPU_POSES
    spec_cpu = library.arm_7dof()[0]
    cpu = chain_collides_gjk(*args(pos[:k].cpu(), rot[:k].cpu(), spec_cpu.length[1:],
                                   obstacle_scene(spec_cpu, 4)))
    cpu_disagree = int((cpu != gjk[:k].cpu()).sum())
    del pose, pos, rot, card_args, gjk, sat

    swarms = GJK_CONFIG_SWARMS
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    out = run_config(CONFIG_DIR / f"{GJK_CONFIG}.json", swarms, GJK_CONFIG_POLISH, device,
                     seed=0, warmup=0, iters=1, impl="jnp")
    solve_s = time.perf_counter() - t0
    launches = read_counts()
    solve_peak = torch.cuda.max_memory_allocated(device)
    jax = JAX_GJK_CONFIG
    lo50, hi50 = jax["p50_bar_mm"]
    lo90, hi90 = jax["p90_bar_mm"]
    most = MAX_COLLIDING_PER_SWARM * swarms
    ok = (agree > GJK_AGREEMENT_BAR and out["finite"] and out["fitness_impl"] == "plain-gjk"
          and out["colliding_solutions"] <= most and out["colliding_solutions_gjk"] <= most
          and out["p50_err_mm"] < 1.0 and lo50 <= out["p50_err_mm"] <= hi50
          and lo90 <= out["p90_err_mm"] <= hi90
          and launches["fused_solve"] == launches["fused_fitness"] == 0
          and launches["scan_step"] == 0)
    emit("gjk", agreement=agree, agreement_bar=GJK_AGREEMENT_BAR, poses=n,
         gjk_lanes_per_collider=lanes, gjk_rounds_budget=GJK_ITERATIONS,
         gjk_call_ms=gjk_ms, gjk_call_device_busy_ms=gjk_busy_ms,
         gjk_call_device_idle_share=1.0 - gjk_busy_ms / gjk_ms if gjk_busy_ms else None,
         sat_call_ms=sat_ms, gjk_peak_bytes=peak, solve_peak_bytes=solve_peak,
         gjk_simplex_buffer_bytes=lanes * 4 * 3 * 4,
         cpu_poses=k, card_vs_cpu_disagreements=cpu_disagree,
         solve=out, solve_seconds=solve_s, fitness_that_ran=out["fitness_impl"],
         launches=launches, jax={**jax, "record": "CPU, scan solver, tests/test_torch_configs.py"},
         bars={"p50_err_mm": jax["p50_bar_mm"], "p90_err_mm": jax["p90_bar_mm"],
               "colliding_solutions": most, "p50_under_mm": 1.0},
         seconds=time.perf_counter() - t_phase, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("gjk: SAT agreement, a bar of the GJK document, or its route "
                             "missed")
    return launches


def phase_retries_host(device, card):
    """The headline batch (arm_7dof, S=1,048,576, kernel A and the polish)
    through make_retry_solver (host-gathered failures, 4 rounds, buckets of
    1,024), launch counts read around it: the rows that converged in the
    base solve are bit-identical after it, failures do not grow, and
    frac_under_1mm >= 0.999. Beside it the top-k path's failures (the
    headline recipe) and one top-k round from the best pose against one
    from the problem's."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ikpso_tpu_torch.harness.headline import (build_headline_solver, headline_bucket,
                                                  headline_configs, reachable_targets)
    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.pso.fused import make_fused_solver
    from ikpso_tpu_torch.pso.polish import wrap_with_polish
    from ikpso_tpu_torch.pso.restarts import make_retry_solver, make_topk_retry_solver

    t_phase = time.perf_counter()
    swarms = HEADLINE_SWARMS
    spec, problem = library.arm_7dof(device=device)
    batched = library.batched_problem(problem, reachable_targets(
        spec, problem, swarms, torch.Generator(device=device).manual_seed(0)))
    pre, pso, fit = headline_configs()
    base = wrap_with_polish(make_fused_solver(spec, pso=pso, fit=fit,
                                              num_particles=pre.particles, device=device),
                            spec, steps=pre.polish)

    def gen():
        return torch.Generator(device=device).manual_seed(1)

    def failures(res):
        return int((res.effector_error.double() * 1e3 >= 1.0).sum())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = base(batched, gen())
    torch.cuda.synchronize()
    base_wall = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    res = make_retry_solver(base, err_threshold=RETRY_THRESHOLD, max_rounds=RETRY_ROUNDS,
                            bucket=RETRY_BUCKET)(batched, gen())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    converged = first.effector_error <= RETRY_THRESHOLD
    stable = bool(torch.equal(res.angles[converged], first.angles[converged])
                  and torch.equal(res.effector_error[converged],
                                  first.effector_error[converged]))
    err_mm = res.effector_error.double().cpu().numpy() * 1e3
    frac = float((err_mm < 1.0).mean())
    retried = make_retry_solver(base, err_threshold=RETRY_THRESHOLD, max_rounds=RETRY_ROUNDS,
                                bucket=RETRY_BUCKET)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        retried(batched, gen())
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    busy, ms = _device_ms(prof, {"a": KERNEL_A_NAMES})
    topk = build_headline_solver(spec, swarms, device)(batched, gen())
    bucket = headline_bucket(swarms, pre.retry_bucket_decay)
    one_round = {start: failures(make_topk_retry_solver(
        base, bucket=bucket, rounds=1, err_threshold=RETRY_THRESHOLD,
        retry_start=start)(batched, gen())) for start in ("problem", "best")}
    ok = (stable and failures(res) <= failures(first) and frac >= 0.999
          and launches["fused_solve_variants"].get("arm_7dof/warm/none", 0) >= 2)
    emit("retries_host", swarms=swarms, rounds=RETRY_ROUNDS, bucket=RETRY_BUCKET,
         err_threshold=RETRY_THRESHOLD, base_wall_s=base_wall, wall_s=wall,
         profiled_wall_ms=profiled_ms, device_busy_ms=busy, kernel_a_device_ms=ms["a"],
         device_idle_share=1.0 - busy / profiled_ms if busy else None,
         base_failures_ge_1mm=failures(first),
         failures_ge_1mm=failures(res), frac_under_1mm=frac,
         p50_err_mm=float(np.median(err_mm)),
         converged_rows_bit_stable=stable, topk_path_failures_ge_1mm=failures(topk),
         jax_reference_failures=JAX_REFERENCE_FAILURES,
         one_topk_round_failures_ge_1mm=one_round, one_topk_round_bucket=bucket,
         launches=launches, seconds=time.perf_counter() - t_phase, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("retries_host: converged rows moved, failures grew, or the "
                             "accuracy bar missed")
    return launches


JAX_FROM_BEST_FAILURES = "127/1048576"  # docs/PERFORMANCE.md: the recipe from the best pose


def phase_retries_best(device, card):
    """The headline recipe (kernel A, 4 LM steps, 4 top-k rounds over
    [32768, 4096, 1024, 1024]) with every retry from the swarm's best pose
    (``make_topk_retry_solver(retry_start="best")``), its failures beside
    JAX's 127 and the recipe's own from the problem's pose; launch counts
    read around it. Then ``utils.profiling.Timer`` on one base solve's
    ``SolveResult`` against CUDA events around the same call: the timer
    must wait for the card (at least the events' time), where a clock that
    stops at the enqueue reads far less."""
    import torch

    from ikpso_tpu_torch.harness.headline import (build_headline_solver, headline_bucket,
                                                  headline_configs, reachable_targets)
    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.pso.fused import make_fused_solver
    from ikpso_tpu_torch.pso.polish import wrap_with_polish
    from ikpso_tpu_torch.pso.restarts import bucket_schedule, make_topk_retry_solver
    from ikpso_tpu_torch.utils.profiling import Timer

    t_phase = time.perf_counter()
    swarms = HEADLINE_SWARMS
    spec, problem = library.arm_7dof(device=device)
    batched = library.batched_problem(problem, reachable_targets(
        spec, problem, swarms, torch.Generator(device=device).manual_seed(0)))
    pre, pso, fit = headline_configs()
    kernel_a = make_fused_solver(spec, pso, fit, None, pre.particles, device=device)
    base = wrap_with_polish(kernel_a, spec, steps=pre.polish)
    buckets = bucket_schedule(headline_bucket(swarms, pre.retry_bucket_decay), pre.retries,
                              pre.retry_bucket_decay)
    from_best = make_topk_retry_solver(base, bucket=buckets, rounds=pre.retries,
                                       err_threshold=RETRY_THRESHOLD, retry_start="best")

    def gen():
        return torch.Generator(device=device).manual_seed(1)

    def failures(res):
        return int((res.effector_error.double() * 1e3 >= 1.0).sum())

    reset_counts()
    best = failures(from_best(batched, gen()))
    torch.cuda.synchronize()
    launches = read_counts()
    problem_start = failures(build_headline_solver(spec, swarms, device)(batched, gen()))
    timer_s, events_ms, enqueue_s = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with Timer() as t:
            start.record()
            t.sync_on(kernel_a(batched, gen()))
            end.record()
            enqueue = time.perf_counter() - t._start
        torch.cuda.synchronize()
        timer_s.append(t.elapsed_s)
        events_ms.append(start.elapsed_time(end))
        enqueue_s.append(enqueue)
    waits = all(ts * 1e3 >= ev for ts, ev in zip(timer_s, events_ms))
    ok = (waits and launches["fused_solve"] == 1 + pre.retries
          and best <= 0.01 * swarms)
    emit("retries_best", swarms=swarms, buckets=buckets, polish=pre.polish,
         failures_ge_1mm_from_best=best, failures_ge_1mm_from_problem=problem_start,
         jax_from_best_failures=JAX_FROM_BEST_FAILURES,
         jax_from_problem_failures=JAX_REFERENCE_FAILURES, launches=launches,
         timer_s=timer_s, cuda_events_ms=events_ms, enqueue_s=enqueue_s,
         timer_waits_for_the_card=waits, seconds=time.perf_counter() - t_phase, card=card,
         ok=bool(ok))
    if not ok:
        raise AssertionError("retries_best: the timer stopped before the card, the recipe "
                             "launched kernel A a wrong number of times, or from-best "
                             "retries left more than 1% failing")
    return launches


def phase_sass_bisection():
    """The SASS of the capsule bisection (``seg_obb_dist2`` in a probe
    kernel built with the port's flags): the opcode counts of its body.
    Its per-axis term (``signed_excess``) must compile to a compare, a
    select and a sign copy, with no int-to-float conversion (the product
    of ``jnp.sign``'s two compares and the clamp issued one I2FP a term)."""
    import collections
    import tempfile

    from ikpso_tpu_torch.utils import kernels

    src = ('#include "fk_fitness.cuh"\n'
           'extern "C" __global__ void k_seg(const float* q, float* y) {\n'
           '  const float* p = q + 6 * threadIdx.x;\n'
           '  const float q0[3] = {p[0], p[1], p[2]}, q1[3] = {p[3], p[4], p[5]};\n'
           '  y[threadIdx.x] = ikpso::seg_obb_dist2(q0, q1, q + 1024);\n'
           '}\n')
    with tempfile.TemporaryDirectory() as tmp:
        cu, cubin = Path(tmp) / "seg.cu", Path(tmp) / "seg.cubin"
        cu.write_text(src)
        run([kernels._nvcc(), "-cubin", *kernels.NVCC_FLAGS[:2], "-std=c++17", "-O3",
             "-fmad=false", "-I", str(kernels.CSRC), "-o", str(cubin), str(cu)])
        sass = run([str(Path(kernels._nvcc()).with_name("cuobjdump")), "-sass", str(cubin)])
    body = sass.split("Function : k_seg")[1]
    ops = collections.Counter(
        re.sub(r"^@!?P\d ", "", t).split()[0]
        for t in re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]+);", body))
    conversions = sum(n for op, n in ops.items() if op.startswith(("I2F", "F2I", "F2F")))
    ok = conversions == 0
    emit("sass_bisection", opcodes=dict(ops.most_common()), conversions=conversions,
         instructions=sum(ops.values()), ok=ok)
    if not ok:
        raise AssertionError("the capsule bisection's SASS converts ints to floats")
    return conversions


# One rank of the sharded phase: a process of a two-rank gloo group on
# cuda:0 (argv: repository root, rank, port, output directory).
SHARDED_RANK = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch

repo, rank, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
from ikpso_tpu_torch.parallel import distributed

device = distributed.rank_device(%(device)r, 0)
distributed.initialize(f"127.0.0.1:{port}", %(ranks)d, rank, device=device)
try:
    import torch.distributed as dist

    from ikpso_tpu_torch.harness.headline import (headline_bucket, headline_configs,
                                                  reachable_targets)
    from ikpso_tpu_torch.harness.scan import scan_configs
    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness, fused_fitness
    from ikpso_tpu_torch.parallel import mesh as M
    from ikpso_tpu_torch.parallel.sharded import draw_seed, make_sharded_solver, shard_seed
    from ikpso_tpu_torch.pso.fused import fused_solve
    from ikpso_tpu_torch.pso.polish import wrap_with_polish
    from ikpso_tpu_torch.pso.restarts import wrap_with_topk_retries
    from ikpso_tpu_torch.pso.solver import scan_step

    def counts():
        return dict(fused_solve=fused_solve.launches, fk_fitness=fk_fitness.launches,
                    fused_fitness=fused_fitness.launches, scan_step=scan_step.launches,
                    scan_step_replay=scan_step.replay_launches,
                    fused_solve_variants=dict(fused_solve.variant_launches))

    def reset():
        for fn in (fused_solve, fk_fitness, fused_fitness, scan_step):
            fn.launches = 0
        fused_solve.variant_launches = {}
        scan_step.replay_launches = 0

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rec = dict(rank=rank, backend=dist.get_backend(), device=str(device))
    swarms = %(headline)d
    spec, problem = library.arm_7dof(device=device)
    batched = library.batched_problem(problem, reachable_targets(spec, problem, swarms, gen(0)))
    pre, pso, fit = headline_configs()
    mesh = M.swarm_mesh()
    # (a) Kernel A across the swarm axis: this rank's shard of the base solve.
    kw = dict(pso=pso, fit=fit, num_particles=pre.particles, impl="fused")
    res = make_sharded_solver(spec, mesh, **kw)(batched, gen(1))
    block = swarms // mesh.size
    rows = slice(rank * block, (rank + 1) * block)
    np.savez(f"{out}/a{rank}.npz", angles=res.angles[rows].cpu().numpy(),
             fitness=res.fitness[rows].cpu().numpy())
    rec["swarm_seed"] = shard_seed(draw_seed(gen(1)), mesh)
    del res
    # The headline recipe around the sharded solver: polish and top-k retries.
    def build(cfg):
        return wrap_with_polish(make_sharded_solver(spec, mesh, **dict(kw, pso=cfg)), spec,
                                steps=pre.polish)

    full = wrap_with_topk_retries(
        build, pso, rounds=pre.retries, bucket=headline_bucket(swarms, pre.retry_bucket_decay),
        retry_init_mode=pre.retry_init_mode, retry_iterations=pre.retry_iterations,
        bucket_decay=pre.retry_bucket_decay)
    def profiled(run):
        """``run()`` under the profiler where there is a card: its result, its
        wall, and the device's busy ms and idle share."""
        if device.type != "cuda":
            t0 = time.perf_counter()
            return run(), time.perf_counter() - t0, None, None
        from torch.profiler import ProfilerActivity, profile

        from chip_smoke import _device_ms

        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run()
            sync()
            wall = time.perf_counter() - t0
        busy = _device_ms(prof, {})[0]
        return out, wall, busy, 1.0 - busy / (wall * 1e3)

    reset()
    res, rec["swarm_wall_s"], rec["swarm_busy_ms"], rec["swarm_idle_share"] = profiled(
        lambda: full(batched, gen(1)))
    err_mm = res.effector_error.double().cpu().numpy() * 1e3
    rec["swarm_launches"] = counts()
    rec.update(swarm_frac_under_1mm=float((err_mm < 1.0).mean()),
               swarm_failures_ge_1mm=int((err_mm >= 1.0).sum()),
               swarm_p50_err_mm=float(np.median(err_mm)))
    # (b) The scan solver (kernel C at init, the scan step each iteration)
    # across the particle axis.
    s = %(scan_swarms)d
    batched = library.batched_problem(problem, reachable_targets(spec, problem, s, gen(0)))
    scan_pso, scan_fit = scan_configs()
    pmesh = M.make_mesh((%(ranks)d,), (M.PARTICLE_AXIS,))
    solver = make_sharded_solver(spec, pmesh, pso=scan_pso, fit=scan_fit,
                                 num_particles=%(scan_particles)d, impl="jnp")
    reset()
    res, rec["particle_wall_s"], rec["particle_busy_ms"], rec["particle_idle_share"] = (
        profiled(lambda: solver(batched, gen(1))))
    err_mm = res.effector_error.double().cpu().numpy() * 1e3
    rec["particle_launches"] = counts()
    rec.update(particle_frac_under_1mm=float((err_mm < 1.0).mean()),
               particle_failures_ge_1mm=int((err_mm >= 1.0).sum()),
               particle_errors_sum=float(err_mm.sum()),
               peak_bytes=torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else None)
    json.dump(rec, open(f"{out}/rank{rank}.json", "w"))
finally:
    distributed.shutdown()
'''


def phase_sharded(device, card):
    """Two ranks on cuda:0 over gloo (one process each). (a) The headline
    batch across the swarm axis on kernel A: each rank's shard is
    bit-identical to a single-process kernel A solve of it under the
    rank's derived seed, a 1-rank mesh equals the unsharded solve bit for
    bit, and the headline recipe (polish, top-k retries) around the
    sharded solver is scored. (b) The scan cell across the particle axis
    (kernel C at init, then the scan step, its gbest candidate reduced
    across the ranks every iteration): frac_under_1mm within 4 standard
    errors of the unsharded scan solve at the same S and P; both ranks'
    kernel C and step launches read."""
    import tempfile

    import numpy as np
    import torch

    from ikpso_tpu_torch.harness.headline import headline_configs, reachable_targets
    from ikpso_tpu_torch.harness.scan import scan_configs
    from ikpso_tpu_torch.harness.trajectory import build_solver
    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.parallel.mesh import make_mesh
    from ikpso_tpu_torch.parallel.sharded import draw_seed, shard_seed, solve_sharded
    from ikpso_tpu_torch.pso.fused import make_fused_solver
    from ikpso_tpu_torch.utils import seeds

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        script = Path(tmp) / "rank.py"
        script.write_text(SHARDED_RANK % dict(
            ranks=SHARDED_RANKS, headline=HEADLINE_SWARMS, scan_swarms=SHARDED_SCAN_SWARMS,
            scan_particles=SHARDED_SCAN_PARTICLES, device=device.type))
        port = _free_port()
        root = str(Path(__file__).resolve().parent)
        t0 = time.perf_counter()
        _spawn([[sys.executable, str(script), root, str(r), str(port), tmp]
                for r in range(SHARDED_RANKS)])
        ranks_s = time.perf_counter() - t0
        recs = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(SHARDED_RANKS)]
        shards = [dict(np.load(Path(tmp) / f"a{r}.npz")) for r in range(SHARDED_RANKS)]

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    swarms = HEADLINE_SWARMS
    spec, problem = library.arm_7dof(device=device)
    batched = library.batched_problem(problem, reachable_targets(spec, problem, swarms, gen(0)))
    pre, pso, fit = headline_configs()
    kernel_a = make_fused_solver(spec, pso=pso, fit=fit, num_particles=pre.particles,
                                 device=device)
    block = swarms // SHARDED_RANKS
    shard_equal = []
    for r, (rec, shard) in enumerate(zip(recs, shards)):
        rows = torch.arange(r * block, (r + 1) * block, device=device)
        want = kernel_a(batched.take(rows), seeds.generator(rec["swarm_seed"], device))
        shard_equal.append(bool(np.array_equal(shard["angles"], want.angles.cpu().numpy())
                                and np.array_equal(shard["fitness"],
                                                   want.fitness.cpu().numpy())))
    one = make_mesh()
    got = solve_sharded(spec, batched, gen(1), one, pso=pso, fit=fit,
                        num_particles=pre.particles, impl="fused")
    want = kernel_a(batched, seeds.generator(shard_seed(draw_seed(gen(1)), one), device))
    one_rank_equal = bool(torch.equal(got.angles, want.angles)
                          and torch.equal(got.fitness, want.fitness))
    del got, want
    s, p = SHARDED_SCAN_SWARMS, SHARDED_SCAN_PARTICLES
    scan_pso, scan_fit = scan_configs()
    scan_batched = library.batched_problem(problem, reachable_targets(spec, problem, s, gen(0)))
    whole = build_solver(spec, pso=scan_pso, fit=scan_fit, num_particles=p, impl="jnp",
                         device=device)(scan_batched, gen(1))
    whole_mm = whole.effector_error.double().cpu().numpy() * 1e3
    whole_frac = float((whole_mm < 1.0).mean())
    share = min(max(whole_frac, 1.0 / s), 1.0 - 1.0 / s)
    four_se = 4.0 * (share * (1.0 - share) * 2.0 / s) ** 0.5
    frac = recs[0]["particle_frac_under_1mm"]
    same = all(r[k] == recs[0][k] for r in recs for k in (
        "swarm_frac_under_1mm", "swarm_failures_ge_1mm", "particle_frac_under_1mm",
        "particle_errors_sum"))
    iterations = scan_pso.iterations
    ok = (all(shard_equal) and one_rank_equal and same
          and recs[0]["swarm_seed"] != recs[1]["swarm_seed"]
          and all(r["backend"] == "gloo" for r in recs)
          and abs(frac - whole_frac) <= four_se
          and all(r["particle_launches"]["fused_fitness"] == 1
                  and r["particle_launches"]["scan_step"] == iterations for r in recs)
          and all(r["swarm_launches"]["fused_solve"] >= 1 for r in recs))
    launches = _sum_counts([r["swarm_launches"] for r in recs]
                           + [r["particle_launches"] for r in recs])
    emit("sharded", ranks=SHARDED_RANKS, backend=recs[0]["backend"], swarms=swarms,
         swarms_per_rank=block, shard_bit_identical=shard_equal,
         one_rank_mesh_bit_identical=one_rank_equal,
         swarm_frac_under_1mm=recs[0]["swarm_frac_under_1mm"],
         swarm_failures_ge_1mm=recs[0]["swarm_failures_ge_1mm"],
         swarm_p50_err_mm=recs[0]["swarm_p50_err_mm"],
         jax_reference_failures=JAX_REFERENCE_FAILURES,
         scan_swarms=s, scan_particles=p, particles_per_rank=p // SHARDED_RANKS,
         particle_frac_under_1mm=frac, unsharded_frac_under_1mm=whole_frac,
         four_standard_errors=four_se,
         ranks_profiled={f"rank{r['rank']}": {
             k: r[k] for k in ("swarm_wall_s", "swarm_busy_ms", "swarm_idle_share",
                               "particle_wall_s", "particle_busy_ms", "particle_idle_share")}
             for r in recs},
         rank_peak_bytes=[r["peak_bytes"] for r in recs], ranks_seconds=ranks_s,
         kernel_c_launches_by_rank=[r["particle_launches"]["fused_fitness"] for r in recs],
         scan_step_launches_by_rank=[r["particle_launches"]["scan_step"] for r in recs],
         kernel_a_launches_by_rank=[r["swarm_launches"]["fused_solve"] for r in recs],
         launches=launches, seconds=time.perf_counter() - t_phase, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("sharded: a shard differs from its single-process solve, the "
                             "ranks disagree, or the particle-sharded quality missed")
    return launches


# A process of the two-process sweep: the CLI, with the launch counts and
# each solve_waypoints rate written to a file (argv: repository root, the
# file, the CLI's arguments).
COUNTED_CLI = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
from ikpso_tpu_torch.harness import cli, trajectory
from ikpso_tpu_torch.ops.fitness_kernel import fk_fitness, fused_fitness
from ikpso_tpu_torch.pso.fused import fused_solve
from ikpso_tpu_torch.pso.solver import scan_step

rates, real = [], trajectory.solve_waypoints


def recorded(*args, **kw):
    res = real(*args, **kw)
    rates.append(res.solves_per_second)
    return res


trajectory.solve_waypoints = recorded
rc = cli.main(sys.argv[3:])
json.dump(dict(fused_solve=fused_solve.launches, fk_fitness=fk_fitness.launches,
               fused_fitness=fused_fitness.launches, scan_step=scan_step.launches,
               scan_step_replay=scan_step.replay_launches,
               fused_solve_variants=dict(fused_solve.variant_launches), rates=rates),
          open(sys.argv[2], "w"))
sys.exit(rc)
'''


def phase_sweep_multihost(device, card):
    """``cli sweep --multihost`` as two processes on the card (gloo), 1,024
    waypoints in batches of 256 on kernel A with the preset: both print the
    same merged line; each process's block (its checkpoint) equals a
    single-process solve_waypoints of the block under fold_in(seed,
    process), bit for bit; the merged rate is the sum of the two."""
    import tempfile

    import numpy as np

    from ikpso_tpu_torch.harness import trajectory
    from ikpso_tpu_torch.utils import checkpoint as ckpt
    from ikpso_tpu_torch.utils import seeds

    t_phase = time.perf_counter()
    impl = "fused" if device.type == "cuda" else "jnp"
    argv = ["sweep", *SWEEP_ARGS, "--impl", impl, "--multihost", "--num-processes", "2",
            *(["--cpu"] if device.type == "cpu" else [])]
    with tempfile.TemporaryDirectory() as tmp:
        script = Path(tmp) / "cli_counted.py"
        script.write_text(COUNTED_CLI)
        root = str(Path(__file__).resolve().parent)
        coordinator = f"127.0.0.1:{_free_port()}"
        t0 = time.perf_counter()
        outs = _spawn([[sys.executable, str(script), root, f"{tmp}/counts{i}.json", *argv,
                        "--coordinator", coordinator, "--process-id", str(i),
                        "--checkpoint", f"{tmp}/sweep.npz"] for i in range(2)])
        wall = time.perf_counter() - t0
        lines = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
        counts = [json.loads(Path(f"{tmp}/counts{i}.json").read_text()) for i in range(2)]
        blocks = [ckpt.load(f"{tmp}/sweep.npz.p{i}") for i in range(2)]
    slices = [ln.pop("local_slice") for ln in lines]
    processes = [ln.pop("process") for ln in lines]
    cfg, args = _cli_config(device, ["sweep", *SWEEP_ARGS])
    rng = np.random.default_rng(args.seed)
    base = cfg.problem.targets.cpu().numpy()
    waypoints = base[None] + rng.normal(
        scale=args.jitter, size=(args.waypoints,) + base.shape).astype(np.float32)
    equal = []
    for i, (lo, hi) in enumerate(slices):
        want = trajectory.solve_waypoints(
            cfg.spec, cfg.problem, waypoints[lo:hi], seeds.fold_in(args.seed, i),
            pso=cfg.pso, fit=cfg.fitness, obstacles=cfg.obstacles,
            num_particles=cfg.num_particles, batch_size=min(args.batch, hi - lo),
            impl=impl, retries=args.retries, retry_init_mode=args.retry_init_mode,
            retry_iterations=args.retry_iterations, polish=args.polish)
        equal.append(bool(np.array_equal(blocks[i].angles, want.angles)
                          and np.array_equal(blocks[i].errors, want.errors)))
    rates = [c["rates"][0] for c in counts]
    launches = _sum_counts(counts)
    ok = (all(equal) and lines[0] == lines[1] and processes == [0, 1]
          and slices == [[0, 512], [512, 1024]] and lines[0]["waypoints"] == 1024
          and abs(lines[0]["solves_per_second"] - sum(rates)) <= 1e-9 * sum(rates)
          and all(c["fused_solve"] >= 2 for c in counts)
          and all(c["fused_fitness"] == c["scan_step"] == 0 for c in counts))
    emit("sweep_multihost", **lines[0], local_slices=slices, blocks_bit_identical=equal,
         process_rates=rates, processes_wall_s=wall, launches=launches,
         launches_by_process=[{k: c[k] for k in ("fused_solve", "fused_fitness")}
                              for c in counts],
         seconds=time.perf_counter() - t_phase, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("sweep_multihost: the processes disagree, a block differs from "
                             "its single-process sweep, or kernel A was bypassed")
    return launches


def phase_viz(device, card):
    """``cli viz --model arm_7dof --out out/scene.html``: the page embeds
    scene_dict's payload of the same model."""
    from ikpso_tpu_torch.viz.render import scene_dict

    t_phase = time.perf_counter()
    out = "out/scene.html"
    argv = ["viz", "--model", "arm_7dof", *(["--cpu"] if device.type == "cpu" else [])]
    reset_counts()
    line = _cli_lines([*argv, "--out", out])[-1]
    launches = read_counts()
    html = (Path(__file__).resolve().parent / out).read_text()
    start = html.index("const SCENE = ") + len("const SCENE = ")
    embedded = json.loads(html[start:html.index(";\n", start)])
    cfg, _ = _cli_config(device, argv)
    want = json.loads(json.dumps(scene_dict(cfg.spec, cfg.problem, cfg.obstacles)))
    ok = line == {"written": out} and embedded == want
    emit("viz", written=out, bytes=len(html), nodes=len(embedded["nodes"]),
         payload_equals_scene_dict=embedded == want, launches=launches,
         seconds=time.perf_counter() - t_phase, card=card, ok=bool(ok))
    if not ok:
        raise AssertionError("viz: the page's payload is not scene_dict's")
    return launches


def run_phases(device, card, od_ptxas):
    """Every phase after the build, in order; returns the ``kernels``
    list of the next-to-last line."""
    b_err = phase_fk_fitness(device)
    b_obs_err = phase_fk_fitness_obstacles(device)
    b_obs_err["orientation"] = phase_fk_fitness_orientation(device)
    a_err = phase_fused_replay(device)
    a_obs_err = phase_fused_obstacles_replay(device)
    a_branch_err = phase_fused_branch_replay(device)
    phase_fused_tie(device)
    phase_fused_tie(device, particles=512)  # the short chain's 1,024-thread bound
    phase_fused_tie(device, particles=1024, model="dual_arm_14dof")
    phase_fused_tie(device, particles=512, model="humanoid_45dof")
    phase_fused_penalty_ties(device)
    phase_fused_philox(device)
    # The short chains' 1,024-thread instantiation (P > 256) on both streams.
    a_err = max(a_err, phase_fused_replay(device, swarms=256, particles=512,
                                          models=("arm_7dof", "arm_6dof")))
    phase_fused_philox(device, swarms=256, particles=512)
    c_err = phase_fused_fitness(device)
    scan_err = phase_scan_replay(device)
    tree_err = phase_tree_fitness(device)
    a_tree_err = phase_fused_tree_replay(device)
    phase_fused_tie(device, particles=256, model="snake_30dof")
    phase_fused_tie(device, particles=1024, model="snake:16")
    phase_fused_tie(device, particles=256, model="snake:50")
    phase_fused_tie(device, particles=256, model="reference_arm")
    ptxas, placement = phase_ptxas()
    od_err = phase_on_demand_checks(device)
    phase_sass_cluster()
    phase_fused_tie(device, particles=512, model="hand21")
    phase_sass_sincos()
    phase_sass_bisection()
    e_per_call = phase_sass_philox()
    a_sass, a_trees = phase_sass_kernel_a()
    phase_tensor_polish(device)
    paths = {
        "headline": phase_headline(device, HEADLINE_SWARMS, card),
        "obstacles": phase_obstacles(device, OBSTACLE_SWARMS, card, "box"),
        "obstacles_capsule": phase_obstacles(device, CAPSULE_SWARMS, card, "capsule"),
        "orientation": phase_orientation(device, ORIENTATION_SWARMS, card),
        **{TREE_PATHS[m]: phase_tree(device, m, card) for m in TREE_SWARMS},
        "scan": phase_scan(device, card),
    }
    config_out = {}
    for name in CONFIGS:
        paths[f"config_{name}"], config_out[name] = phase_config(device, name, card)
    phase_exact_vs_poly(device, config_out["arm7_exact"], card)
    paths["cli_hand21_jnp"] = phase_cli(card)
    paths["bench"] = phase_bench(card)
    paths["experiment"] = phase_experiment(device, card)
    paths["experiment_polish_diagnostics"] = phase_experiment_polish_diagnostics(card)
    paths["track"] = phase_track(device, card)
    paths["sweep"] = phase_sweep(device, card)
    paths["gjk"] = phase_gjk(device, card)
    paths["retries_host"] = phase_retries_host(device, card)
    paths["retries_best"] = phase_retries_best(device, card)
    paths["sharded"] = phase_sharded(device, card)
    paths["sweep_multihost"] = phase_sweep_multihost(device, card)
    paths["viz"] = phase_viz(device, card)
    paths["roofline"], roof_timed, roof_counts, d_err, sol = phase_roofline(device, card,
                                                                             e_per_call)
    t, counts, t_err = phase_timing(device, TIMING_SWARMS, HEADLINE_SWARMS)
    tt, tree_counts, tt_err = phase_tree_timing(device)
    t.update(tt)
    counts.update(tree_counts)
    od_t, od_counts = phase_on_demand_timing(device)
    t.update(od_t)
    counts.update(od_counts)
    st, st_counts, st_err = phase_slice_timing(device)
    t.update(st)
    counts.update(st_counts)
    step_t, step_counts = phase_step_timing(device)
    t.update(step_t)
    counts.update(step_counts)
    bounds = phase_bounds(t, counts, roof_timed, roof_counts, card)
    phase_tree_loop_keys(t, bounds, od_ptxas, a_trees)

    def by_path(name):
        return {k: v[name] for k, v in paths.items()}

    def bound_keys(row):
        r = bounds[row]
        return {"bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "share": r["share"]}

    def on_demand(name):
        """Per on-demand case: the timed kernel against its bound and plain
        twin, its max abs error against the plain twin, its ptxas lines,
        and (kernel A, and B which A inlines) the launches of its variant
        by path."""
        prefix = {"A": "fused_solve", "B": "fk_fitness_kernel", "C": "fused_fitness_kernel"}
        out = {}
        for tag in OD_TIMED:
            k = name.lower()
            row = {"ms": t[f"{k}_{tag}_ms"], "plain_ms": t[f"{k}_{tag}_plain_ms"],
                   "swarms": OD_TIMED[tag]["ABC".index(name)],
                   **bound_keys(f"{name} {tag}"), "max_abs_err": od_err[(name, tag)],
                   "ptxas": [r for r in od_ptxas[tag] if r["kernel"].startswith(prefix[name])]}
            if name != "C":
                variant = od_variant(tag)
                row["launches_by_path"] = {
                    k2: v["fused_solve_variants"].get(variant, 0) for k2, v in paths.items()}
            if name == "A":
                import numpy as np

                spec, _, fit, p, _, _, obs, orient = od_case(tag, "cpu", 1,
                                                             np.random.default_rng(0))
                row.update(kernel_a_placement(spec, fit, p, 0 if obs is None else obs.count,
                                              orient))
            out[tag] = row
        return out

    def model_variants(name):
        """Per timed model: the timed kernel against its bound and its plain
        twin, its ptxas lines, and (kernels A and B, which A inlines) the
        launches of its kernel A variant by path; kernel C runs only on the
        scan path, whose model is arm_7dof."""
        from ikpso_tpu_torch.harness.trees import model_spec
        from ikpso_tpu_torch.utils.kernels import TOPOLOGY_NAMES, topology_id

        key = {"A": "fused_solve", "B": "fk_fitness", "C": "fused_fitness"}[name]
        out = {}
        for m, (pair, b_swarms, _) in TIMED_MODELS.items():
            if name != "A" and b_swarms is None:
                continue
            topo = TOPOLOGY_NAMES[topology_id(model_spec(m)[0])]
            row = {"instantiation": topo, "ms": t[f"{key}_{m}_ms"],
                   **bound_keys(f"{name} {m}"), "ptxas": ptxas[f"{name} {m}"],
                   "max_abs_err": max(tree_err.get((name, m), 0.0),
                                      tt_err.get((name, m), 0.0))}
            if name != "C":
                row["launches_by_path"] = {
                    k: sum(n for var, n in v["fused_solve_variants"].items()
                           if var.startswith(topo + "/")) for k, v in paths.items()}
            if name == "A":
                row.update(placement[m])
                row.update(pair_ms=t[f"{key}_{m}_pair_ms"],
                           pair_plain_ms=t[f"{key}_{m}_pair_plain_ms"], pair_swarms=pair,
                           bound_pair=bound_keys(f"A {m} pair"), swarms=TREE_SWARMS[m],
                           kicked_share=t.get(f"{key}_{m}_kicked_share"))
            else:
                row["plain_ms"] = t[f"{key}_{m}_plain_ms"]
            out[m] = row
        return out

    kernels = [
        {"name": "fused_solve", "route": "cuda",
         "source": "ikpso_tpu_torch/csrc/fused_solve.cu",
         "replaces": "ikpso_tpu/pso/fused.py:539",
         "launches": paths["obstacles"]["fused_solve"],
         "launches_by_path": by_path("fused_solve"),
         "variants_by_path": by_path("fused_solve_variants"),
         "max_abs_err": max(a_err, a_obs_err, a_branch_err, a_tree_err,
                            *(v for (k, _), v in od_err.items() if k == "A")),
         "max_abs_err_branch_replay": a_branch_err,
         "max_abs_err_tree_replay": a_tree_err, "models": model_variants("A"),
         "ms": t["fused_solve_box_ms"], "plain_ms": t["fused_solve_box_plain_ms"],
         **bound_keys("A box"), "library_ms": None,
         "timed_swarms": TIMING_SWARMS, "timed": "warm, 8 iterations, 4-box scene",
         "no_scene_ms": t["fused_solve_ms"], "no_scene_plain_ms": t["fused_solve_plain_ms"],
         "orientation_ms": t["fused_solve_orientation_ms"],
         "orientation_plain_ms": t["fused_solve_orientation_plain_ms"],
         "orientation_timed": "arm_6dof, warm, 40 iterations, re-kick, orientation",
         "orientation_kicked_share": t["fused_solve_orientation_kicked_share"],
         "bound_orientation": bound_keys("A orientation"),
         "on_demand": on_demand("A"),
         "on_demand_source": "ikpso_tpu_torch/csrc/on_demand.cuh",
         "ms_at_headline_swarms": t["fused_solve_big_ms"],
         "bound_at_headline_swarms": bound_keys("A headline, no scene"),
         "issue_bound_ms_at_headline_swarms": a_sass["issue_bound_ms"],
         "issue_share_at_headline_swarms": a_sass["issue_bound_ms"]
                                           / t["fused_solve_big_ms"],
         "loop_trip_instructions": a_sass["loop_path"],
         "box_ms_at_headline_swarms": t["fused_solve_box_big_ms"],
         "headline_sol_frac": sol["sol_frac"],
         "track_shape": {"ms": t["fused_solve_track_ms"],
                         "plain_ms": t["fused_solve_track_plain_ms"],
                         **bound_keys("A track"), "max_abs_err": st_err["A track"],
                         "timed": f"arm_7dof, S={TRACK_PATHS}, P=128, 8 iterations, "
                                  "re-kick every 4 above 1e-6 (the track path's frame)"}},
        # Kernel B's device function runs inside every fused_solve and
        # fused_fitness launch; its standalone launcher is for checking and
        # timing only.
        {"name": "fk_fitness", "route": "cuda",
         "source": "ikpso_tpu_torch/csrc/fk_fitness.cuh",
         "replaces": "ikpso_tpu/ops/pallas_fitness.py:256",
         "branches": ["none", "box", "capsule", "orientation", "dual_arm_14dof",
                      "humanoid_45dof", "snake_30dof", "serial"],
         "models": model_variants("B"),
         "launches": paths["obstacles"]["fused_solve"],
         "launches_by_path": by_path("fused_solve"),
         "orientation_launches_by_path": {
             k: sum(n for var, n in v["fused_solve_variants"].items()
                    if var.endswith("/orientation")) for k, v in paths.items()},
         "standalone_launches": paths["obstacles"]["fk_fitness"],
         "inlined_into": ["fused_solve", "fused_fitness"],
         "max_abs_err": max(b_err, *b_obs_err.values(), t_err["fk_fitness"],
                            t_err["fk_fitness_box"], t_err["fk_fitness_capsule"],
                            t_err["fk_fitness_orientation"],
                            *(v for (k, _), v in {**tree_err, **tt_err, **od_err}.items()
                              if k == "B")),
         "max_abs_err_by_branch": {"none": b_err, **b_obs_err},
         "max_abs_err_at_timed_shape": {"none": t_err["fk_fitness"],
                                        "box": t_err["fk_fitness_box"],
                                        "capsule": t_err["fk_fitness_capsule"],
                                        "orientation": t_err["fk_fitness_orientation"]},
         "ms": t["fk_fitness_box_ms"], "plain_ms": t["fk_fitness_box_plain_ms"],
         **bound_keys("B box"), "library_ms": None,
         "ms_by_branch": {"none": t["fk_fitness_ms"], "box": t["fk_fitness_box_ms"],
                          "capsule": t["fk_fitness_capsule_ms"],
                          "orientation": t["fk_fitness_orientation_ms"]},
         "plain_ms_by_branch": {"none": t["fk_fitness_plain_ms"],
                                "box": t["fk_fitness_box_plain_ms"],
                                "capsule": t["fk_fitness_capsule_plain_ms"],
                                "orientation": t["fk_fitness_orientation_plain_ms"]},
         "bound_by_branch": {b: bound_keys(f"B {b}")
                             for b in ("none", "box", "capsule", "orientation")},
         "on_demand": on_demand("B"),
         "timed_swarms": TIMING_SWARMS},
        {"name": "fused_fitness", "route": "cuda",
         "source": "ikpso_tpu_torch/csrc/fused_fitness.cu",
         "replaces": "ikpso_tpu/ops/pallas_fitness.py:482",
         "launches": paths["scan"]["fused_fitness"],
         "launches_by_path": by_path("fused_fitness"),
         "max_abs_err": max(*c_err.values(), scan_err, t_err["fused_fitness"],
                            st_err["C experiment"],
                            *(v for (k, _), v in {**tree_err, **tt_err, **od_err}.items()
                              if k == "C")),
         "models": model_variants("C"),
         "max_abs_err_by_branch": c_err,
         "max_abs_err_at_scan_shape": t_err["fused_fitness"],
         "on_demand": on_demand("C"),
         "ms": t["fused_fitness_ms"], "plain_ms": t["fused_fitness_plain_ms"],
         **bound_keys("C scan path"), "library_ms": None,
         "timed": f"S={SCAN_SWARMS}, D=9, P=1024, no scene",
         "redesigned_as": "scan_step (on the card every kernel-C iteration is a step; "
                          "kernel C evaluates the init)",
         "experiment_shape": {"ms": t["fused_fitness_experiment_ms"],
                              "plain_ms": t["fused_fitness_experiment_plain_ms"],
                              **bound_keys("C experiment"),
                              "max_abs_err": st_err["C experiment"],
                              "timed": "reference_arm, S=128, D=21, P=16,384, angle_weight "
                                       "3.0 (one trial batch of the experiment path)"}},
        # The drawing step (Philox in registers) is the solver's route; the
        # replay step (ScanDraws) runs in the checks only.
        {"name": "scan_step", "route": "cuda", "instantiation": "drawing (REPLAY off)",
         "source": "ikpso_tpu_torch/csrc/scan_step.cu",
         "replaces": "ikpso_tpu/ops/pallas_fitness.py:482",
         "launches": paths["scan"]["scan_step"] - paths["scan"]["scan_step_replay"],
         "launches_by_path": {k: v["scan_step"] - v["scan_step_replay"]
                              for k, v in paths.items()},
         "replay_launches_by_path": by_path("scan_step_replay"),
         "max_abs_err": scan_err, "bar": "torch.equal against pso_iteration on kernel C's "
                                         "plain twin fed step_uniforms' block (phase "
                                         "scan_replay, step_timing)",
         "plain": "pso_iteration on fused_fitness_plain, fed ops/philox.py::step_uniforms",
         "ms": t["scan_step_ms"], "plain_ms": t["scan_step_plain_ms"],
         **bound_keys("step scan path"), "library_ms": None,
         "timed": f"S={SCAN_SWARMS}, D=9, P=1024, step 31 of 60 (scan_configs)",
         "steps": {f"step {s}": {"ms": t[_step_keys("scan", s, False)[1]],
                                 **bound_keys("step scan path"
                                              + ("" if s == STEP_MAIN["scan"]
                                                 else f" step {s}")),
                                 "replay_ms": t[_step_keys("scan", s, True)[1]],
                                 "replay_bound": bound_keys(
                                     "step scan path replay"
                                     + ("" if s == STEP_MAIN["scan"] else f" step {s}"))}
                   for s in STEP_STEPS["scan"]},
         "replay": {"ms": t["scan_step_replay_ms"], **bound_keys("step scan path replay"),
                    "plain": "pso_iteration on fused_fitness_plain, fed the same block",
                    "experiment_ms": t["scan_step_replay_experiment_ms"],
                    "experiment_bound": bound_keys("step experiment replay")},
         "experiment_shape": {"ms": t["scan_step_experiment_ms"],
                              "plain_ms": t["scan_step_experiment_plain_ms"],
                              **bound_keys("step experiment"),
                              "timed": "reference_arm, S=128, D=21, P=16,384, angle_weight "
                                       "3.0, step 8 of 15 (one trial batch of iter3)"},
         "on_demand_source": "ikpso_tpu_torch/csrc/on_demand.cuh"},
        {"name": "roofline_body", "route": "cuda",
         "source": "ikpso_tpu_torch/csrc/roofline.cu",
         "replaces": "ikpso_tpu/utils/roofline.py:74",
         "launches": paths["roofline"]["roofline_body"],
         "launches_by_path": by_path("roofline_body"),
         "max_abs_err": max(d_err.values()), "max_abs_err_by_body": d_err,
         "ms": roof_timed["d_fma_ms"], "plain_ms": roof_timed["d_fma_plain_ms"],
         **bound_keys("D fma"), "library_ms": None,
         "timed": f"fma body, {D_TIMED[0]} elements, {D_TIMED[1]} steps"},
        {"name": "philox_xor", "route": "cuda",
         "source": "ikpso_tpu_torch/csrc/roofline.cu",
         "replaces": "ikpso_tpu/utils/roofline.py:212",
         "launches": paths["roofline"]["philox_xor"],
         "launches_by_path": by_path("philox_xor"),
         "max_abs_err": 0.0,
         "ms": roof_timed["e_ms"], "plain_ms": roof_timed["e_plain_ms"],
         **bound_keys("E"), "library_ms": roof_timed["e_library_ms"],
         "library_call": "torch.rand of the same number of 32-bit draws",
         "integer_issue": roof_timed["e_issue"],
         "timed": f"{E_TIMED[0]} threads, {E_TIMED[1]} Philox calls each"},
    ]
    return kernels


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="On-card smoke test of the port.")
    ap.add_argument("--against", metavar="CHECKOUT",
                    help="only build, and compare the kernels' ptxas lines and kernel "
                         "A's times and outputs with those of another checkout's sources")
    args = ap.parse_args(argv)
    LOG.parent.mkdir(exist_ok=True)
    if not args.against:
        LOG.write_text("")
    card = phase_environment()
    import torch

    od_ptxas = phase_build(on_demand=not args.against)
    if args.against:
        phase_against(args.against, torch.device("cuda", 0))
        phase_sass_kernel_a(args.against)
        phase_sass_cluster()
        return
    kernels = run_phases(torch.device("cuda", 0), card, od_ptxas)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
