"""Kernel A on the register-layout trees in design variants, side by side on the card.

The trees (``DualArm14``, ``Humanoid45``), ``ReferenceArm`` and ``Snake30``
(reference_arm and snake_30dof, each at a 256-thread bound) and the trees'
on-demand twins (``dual_arm_box``: the dual arm among boxes; the dual arm
and the humanoid with the orientation term) run kernel A's register
layout. Each variant runs the same solves through ``pso/fused.py``'s
wrapper; the cases are
timed by CUDA events in turns (v1, v2, ..., then in reverse, ``--rounds``
times) and every variant's output is held bit for bit to the first's. The
ptxas lines of every variant's tree kernels and one trip of each one's PSO
loop in SASS (``chip_smoke.sass_loop_mix``, with the issue-rate time of
the case at one warp instruction a scheduler a clock) are printed first;
``--rounds 0`` stops there.

Variants: ``final`` (the sources and rules as they are), ``general``
(the sources with the tree loop off: ``fused_solve_kernel``, v and lbest in
``[D][P]`` planes), ``keep_root`` (the tree loop with the walk holding the
root's frame in registers, ``kReloadRoot`` off), ``key_per_group`` (the
tree loop reading the Philox key for each group of an update's draws at
every bound, ``kKeyOnce`` off), ``mb2`` and ``mb4`` (reference_arm's and
snake_30dof's ``KernelAMinBlocks`` 2 and 4 instead of 3, so at most 128 and
64 registers; the key read once an update at 128, for each group at 64, as
the rule has it), ``tree_box`` (a box key in the tree loop where the rule
keeps it off: dual_arm_box at 64 registers), ``parent`` (``--parent DIR``:
another checkout's kernel A, its own layout), and the cluster layout
(``csrc/fused_solve_cluster.cuh``: the tree's on-demand key with the
cluster layout, a swarm over c blocks, x in registers, v and lbest in each
block's shared memory) at c blocks of at most T threads and B blocks an SM
in its ``__launch_bounds__`` (so the register cap): ``cl4_256x1`` (the
committed header, up to 255 registers), ``cl4_256x2`` and ``cl2_512x1``
(128), ``cl2_256x1`` (255), ``cl2_256x2`` (128), each where P / c fits T
threads. A header of other bounds is a copy of ``csrc`` under
``build/kernel_a_tree_variants`` with those two lines replaced.

Cases: humanoid_45dof (S=16,384, P=512, 60 iterations) and its twin with
the orientation term, dual_arm_14dof (S=262,144, P=1,024, 8 iterations),
reference_arm (S=262,144, P=256, 100 iterations), snake_30dof (S=65,536,
P=256, 4 iterations, a re-kick every 2),
dual_arm_box (the config document's recipe in ``chip_smoke.py``'s near
box ring, S=262,144 and S=4,096), the dual arm with the capsule collider
there (S=262,144 and S=4,096), with the distance term and with exact trig
(S=262,144), with the orientation term (S=4,096), and hand12 without and
with the near ring (hand21's recipe, S=16,384, P=512), Philox draws, the
presets' recipes.

Run from the repository root on a machine with a card:
``python3 tools/kernel_a_tree_variants.py [--parent DIR] [--rounds N]
[--cases NAME ...] [--variants NAME ...]``.
"""

import argparse
import contextlib
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

OUT = ROOT / "build" / "kernel_a_tree_variants"
# The cluster layout's variants: name -> (blocks a swarm, the block's thread
# bound, its least blocks an SM).
CLUSTER = {"cl4_256x1": (4, 256, 1), "cl4_256x2": (4, 256, 2), "cl2_512x1": (2, 512, 1),
           "cl2_256x1": (2, 256, 1), "cl2_256x2": (2, 256, 2)}
# The lines of the cluster header that set its bounds.
CLUSTER_THREADS_LINE = "constexpr int kClusterThreads = 256;\n"
CLUSTER_BOUNDS_LINE = "__launch_bounds__(kClusterThreads, 1) fused_solve_tree_cluster_kernel("
# The tree loop's traits of the prebuilt topologies.
TREE_TRAITS = tuple(f"struct TreeLoop<{t}> {{\n  static constexpr bool value = true;"
                    for t in ("DualArm14", "Humanoid45", "ReferenceArm", "Snake30"))
# The least blocks an SM of reference_arm's and snake_30dof's kernel A, and
# the tree loop's rule for reading the key once an update.
MIN_BLOCKS = tuple(f"struct KernelAMinBlocks<{t}> {{\n  static constexpr int value = 3;"
                   for t in ("ReferenceArm", "Snake30"))
KEY_ONCE = ("constexpr bool kKeyOnce =\n"
            "      65536 / (KernelAThreads<T>::value * KernelAMinBlocks<T>::value) > 64;")


def min_blocks(b):
    """The replacements of a variant at ``b`` blocks an SM."""
    return {"fused_solve.cuh": [(m, m.replace("value = 3;", f"value = {b};"))
                                for m in MIN_BLOCKS]}


# Variants of the sources: name -> ({file: [(old, new)]}, the on-demand key's
# tree loop, None to keep the key's).
SOURCE_VARIANTS = {
    "general": ({"fused_solve.cuh": [(t, t.replace("true;", "false;")) for t in TREE_TRAITS]},
                False),
    "keep_root": ({"fused_solve.cuh": [("constexpr bool kReloadRoot = !(REPLAY && O);",
                                        "constexpr bool kReloadRoot = false;")]}, None),
    "key_per_group": ({"fused_solve.cuh": [(KEY_ONCE, "constexpr bool kKeyOnce = false;")]},
                      None),
    "mb2": (min_blocks(2), None),
    "mb4": (min_blocks(4), None),
}
# Variants of the on-demand keys alone: name -> (the key's tree loop, the
# colliders it applies to).
KEY_VARIANTS = {"tree_box": (True, (1,))}
# case -> (model or chip_smoke ON_DEMAND_CASES tag, swarms, orientation on a zoo model)
CASES = {"humanoid_45dof S=16384": ("humanoid_45dof", 16_384, False),
         "humanoid_orientation S=16384": ("humanoid_45dof", 16_384, True),
         "dual_arm_14dof S=262144": ("dual_arm_14dof", 262_144, False),
         "reference_arm S=262144": ("reference_arm", 262_144, False),
         "snake_30dof S=65536": ("snake_30dof", 65_536, False),
         "dual_arm_box S=262144": ("dual_arm_box", 262_144, False),
         "dual_arm_box S=4096": ("dual_arm_box", 4096, False),
         "dual_arm_capsule S=262144": ("dual_arm_capsule", 262_144, False),
         "dual_arm_capsule S=4096": ("dual_arm_capsule", 4096, False),
         "dual_arm_distance S=262144": ("dual_arm_distance", 262_144, False),
         "dual_arm_exact S=262144": ("dual_arm_exact", 262_144, False),
         "dual_arm_orientation S=4096": ("dual_arm_orientation", 4096, False),
         "hand12 S=16384": ("hand12", 16_384, False),
         "hand12_box S=16384": ("hand12_box", 16_384, False)}


def variant_root(name, replace):
    """A checkout root under OUT whose ``ikpso_tpu_torch/csrc`` is this
    one's with ``replace`` ({file: [(old, new)]}) applied."""
    root = OUT / name
    csrc = root / "ikpso_tpu_torch" / "csrc"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(kernels.CSRC, csrc)
    for file, pairs in replace.items():
        text = (csrc / file).read_text()
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"{file}: {old!r} moved; update the variants tool")
            text = text.replace(old, new)
        (csrc / file).write_text(text)
    return root


def case_inputs(name, device, rng):
    """``(spec, pso, fit, particles, meta, swarm, num_obstacles, orientation)``."""
    source, swarms, orient = CASES[name]
    if source in chip_smoke.ON_DEMAND_CASES:
        spec, pso, fit, p, meta, swarm, obs, orient = chip_smoke.od_case(
            source, device, swarms, rng, philox=True)
        return spec, pso, fit, p, meta, swarm, 0 if obs is None else obs.count, orient
    import dataclasses

    from ikpso_tpu_torch.harness.trees import tree_configs

    pre, pso, fit = tree_configs(source)
    fit = dataclasses.replace(fit, orientation_weight=1.0 if orient else 0.0)
    spec, batched = chip_smoke._problem(source, swarms, rng, device, orientation=orient)
    meta, swarm = chip_smoke._packed(spec, batched, fit, use_orientation=orient)
    return spec, pso, fit, pre.particles, meta, swarm, 0, orient


def case_key(spec, fit, n_obs, orient, rules=kernels):
    """The on-demand key of a case's tree, scene and terms (for a prebuilt
    tree, the key its twin would have), by this checkout's rules or by
    ``rules``, another checkout's ``utils/kernels.py``."""
    _, collider, _ = kernels.kernel_variant(spec, n_obs, fit.collision_shape, orient,
                                            fused.uses_distance(fit), fit.trig_impl)
    return kernels.OnDemandKey(*rules.on_demand_key(
        spec, collider, bool(orient), fused.uses_distance(fit), fit.trig_impl == "exact"))


def cluster_key(key):
    """``key`` with the cluster layout (beside the scratch one, which is
    built and never launched here)."""
    return key._replace(scratch=True, cluster=True, tree=False)


def plan(todo, keys, wanted, roots, parent_keys=None):
    """``{variant: {case: (root, on-demand key or None, cluster size)}}``:
    where each variant takes each case from; a key of None runs the root's
    prebuilt library; the parent runs its own key (``parent_keys``)."""
    uses = {}
    for v in sorted(wanted):
        table = {}
        for name, c in todo.items():
            spec, fit, p, n_obs, orient, key = c[0], c[2], c[3], c[6], c[7], keys[name]
            od = kernels.kernel_variant(spec, n_obs, fit.collision_shape, orient,
                                        fused.uses_distance(fit),
                                        fit.trig_impl)[0] == kernels.ON_DEMAND
            if v in CLUSTER:
                cl, t, b = CLUSTER[v]
                if p % (32 * cl) or p // cl > t:
                    continue
                root = ROOT if (t, b) == (256, 1) else roots[f"cluster_{t}x{b}"]
                table[name] = (root, cluster_key(key), cl)
            elif v in KEY_VARIANTS:
                tree, colliders = KEY_VARIANTS[v]
                if key.collider in colliders:
                    table[name] = (ROOT, key._replace(tree=tree), 0)
            elif v in SOURCE_VARIANTS:
                tree = SOURCE_VARIANTS[v][1]
                od_key = key if tree is None else key._replace(tree=tree)
                table[name] = (roots[v], od_key if od else None, 0)
            else:
                own = parent_keys[name] if v == "parent" else key
                table[name] = (roots[v], own if od else None, 0)
        uses[v] = table
    return uses


def sass_text(lib):
    return chip_smoke.run([str(Path(kernels._nvcc()).with_name("cuobjdump")), "-sass",
                           str(lib)])


def ptxas_rows(log, match):
    return [[r["kernel"], r.get("registers"), r.get("spill_stores"), r.get("spill_loads")]
            for r in chip_smoke.ptxas_report(log) if match(r["kernel"])]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose kernel A runs beside")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cases", nargs="+", help="case names' first word (default: all)")
    ap.add_argument("--variants", nargs="+", help="the variants to run (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools/kernel_a_tree_variants.py needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout, flush=True)
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_hz = float(chip_smoke.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                   "--format=csv,noheader,nounits"]).split()[0]) * 1e6
    rng = np.random.default_rng(4)
    todo = {name: case_inputs(name, device, rng) for name in CASES
            if not args.cases or name.split()[0] in args.cases}
    keys = {name: case_key(c[0], c[2], c[6], c[7]) for name, c in todo.items()}
    wanted = set(args.variants or ["final", *SOURCE_VARIANTS, *KEY_VARIANTS, "parent",
                                   *CLUSTER])
    if not args.parent:
        wanted.discard("parent")

    # The checkouts each variant builds from.
    roots = {"final": ROOT}
    for v, (replace, _) in SOURCE_VARIANTS.items():
        if v in wanted:
            roots[v] = variant_root(v, replace)
    bounds = {(t, b) for v, (_, t, b) in CLUSTER.items() if v in wanted}
    for t, b in sorted(bounds - {(256, 1)}):
        roots[f"cluster_{t}x{b}"] = variant_root(f"cluster_{t}x{b}", {
            "fused_solve_cluster.cuh": [
                (CLUSTER_THREADS_LINE, f"constexpr int kClusterThreads = {t};\n"),
                (CLUSTER_BOUNDS_LINE, CLUSTER_BOUNDS_LINE.replace(", 1)", f", {b})"))]})
    if "parent" in wanted:
        roots["parent"] = Path(args.parent).resolve()

    def sources(root):
        return (contextlib.nullcontext(kernels) if root == ROOT
                else chip_smoke._sources(root))

    parent_keys = None
    if "parent" in wanted:
        rules = chip_smoke.checkout_kernels(roots["parent"])
        parent_keys = {name: case_key(c[0], c[2], c[6], c[7], rules)
                       for name, c in todo.items()}
    uses, prebuilt, od_libs = plan(todo, keys, wanted, roots, parent_keys), {}, {}
    od_wanted = {}  # root -> {key: the first case that runs it}
    for table in uses.values():
        for name, (root, key, _) in table.items():
            if key is not None:
                od_wanted.setdefault(root, {}).setdefault(key, name)

    for root in set(roots.values()):
        with sources(root) as k:
            if any(root == r for t in uses.values() for r, key, _ in t.values()
                   if key is None):
                prebuilt[root] = k.library.__wrapped__()
                log = k.library_path().with_suffix(".log").read_text()
                sass = sass_text(k.library_path())
                rows = {name: chip_smoke.issue_row(
                            sass, chip_smoke.TREE_SASS[CASES[name][0]][3],
                            (CASES[name][1], c[3], c[1].iterations), sms, max_hz)
                        for name, c in todo.items() if CASES[name][0] in chip_smoke.TREE_SASS
                        and CASES[name][0] not in chip_smoke.ON_DEMAND_CASES}
                print(json.dumps({"root": str(root), "library": "prebuilt",
                                  "ptxas": ptxas_rows(log, lambda n: re.match(
                                      r"fused_solve(_tree)?_kernel<Topology<(7|8|11|16),", n)),
                                  "sass": rows}), flush=True)
                if not hasattr(prebuilt[root], "ikpso_kernel_a_smem_bytes"):
                    prebuilt[root] = chip_smoke._OlderLibrary(prebuilt[root])
                if not hasattr(prebuilt[root], "ikpso_kernel_a_short_threads"):
                    prebuilt[root] = chip_smoke._NoBoundLibrary(prebuilt[root])
            if root in od_wanted:
                k.prebuild(od_wanted[root])
                for key, name in od_wanted[root].items():
                    od_libs[(root, key)] = k.on_demand_library.__wrapped__(key)
                    path = k.on_demand_path(key)
                    sass = sass_text(path)
                    shape = (CASES[name][1], todo[name][3], todo[name][1].iterations)
                    kernel = ("fused_solve_tree_cluster_kernel" if key.cluster else
                              "fused_solve(?:_tree)?_kernel")
                    row = chip_smoke.issue_row(
                        sass, rf"{kernel}INS_16OnDemandTopology\w*?Lb0EEEv", shape, sms,
                        max_hz, nested=key.cluster)
                    print(json.dumps({"root": str(root), "case": name, "key": key.name(),
                                      "tree": key.tree, "cluster": key.cluster,
                                      "ptxas": ptxas_rows(path.with_suffix(".log").read_text(),
                                                          lambda n: n.startswith(
                                                              "fused_solve")),
                                      "sass": row}), flush=True)
    if args.rounds <= 0:
        return

    patched = ("library", "on_demand_library", "on_demand_key", "tree_cluster",
               "INSTANTIATED")
    saved = {n: getattr(kernels, n) for n in patched}

    def use(v, name):
        root, key, cl = uses[v][name]
        if key is None:
            kernels.library = lambda: prebuilt[root]
            return
        kernels.INSTANTIATED = {t for t in saved["INSTANTIATED"] if t[0] not in (3, 4)}
        kernels.on_demand_key = lambda *a, **kw: key
        kernels.on_demand_library = lambda k: od_libs[(root, key)]
        kernels.tree_cluster = lambda *a: cl

    for name, c in todo.items():
        spec, pso, fit, p, meta, swarm, n_obs, orient = c
        seeds = torch.as_tensor(rng.integers(-2**31, 2**31, (swarm.shape[0], 2),
                                             dtype=np.int64).astype(np.int32), device=device)

        def fn():
            return fused.fused_solve(spec, pso, fit, meta, swarm, spec.limits(), seeds, p,
                                     num_obstacles=n_obs, use_orientation=orient)

        order = [v for v in ("final", *SOURCE_VARIANTS, *KEY_VARIANTS, "parent", *CLUSTER)
                 if name in uses.get(v, {})]
        ms, ref = {v: [] for v in order}, None
        for r in range(args.rounds):
            for v in order if r % 2 == 0 else order[::-1]:
                use(v, name)
                try:
                    t, out = chip_smoke.cuda_time(fn, reps=1)
                finally:
                    for n, f in saved.items():
                        setattr(kernels, n, f)
                ms[v].append(t)
                ref = out if ref is None else ref
                if not (torch.equal(ref[0], out[0]) and torch.equal(ref[1], out[1])):
                    raise AssertionError(f"variant {v} disagrees with {order[0]} on {name}")
        med = {v: float(np.median(t)) for v, t in ms.items()}
        won = {v: sum(a < b for a, b in zip(ms[v], ms["parent"])) for v in order
               if "parent" in ms and v != "parent"}
        print(json.dumps({"case": name, "ms": ms, "median_ms": med,
                          "pairs_won_over_parent": won}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout,
          flush=True)


if __name__ == "__main__":
    main()
