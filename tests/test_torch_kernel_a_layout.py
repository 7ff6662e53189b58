"""Kernel A's state placement (``StatePlacement`` in
``ikpso_tpu_torch/csrc/fused_solve.cuh``) against its Python mirror
(``ikpso_tpu_torch/utils/kernels.py``).

(a) The CUDA traits -- ``KernelAThreads``, ``StreamDraws``,
    ``StatePlacement`` and ``KernelAMinBlocks`` -- parsed from the source
    and held equal to ``MAX_PARTICLES``, ``STREAM_IDS`` and ``SHARED_IDS``,
    so the two cannot drift; the kernels' shared-memory reckoning
    (``kernel_a_smem_bytes``, compiled with g++ against a stand-in CUDA
    runtime) equal to the Python one.
(b) Every zoo preset and every config document at its own P gets a
    placement whose shared memory fits a block (232,448 bytes on an H100).
(c) A P or a scene that does not fit raises ``ValueError`` in
    ``_check_args``, before any launch; a smaller one passes.
(d) The scratch layout's scratch is ``(grid, 2, D, P)`` where lbest is in
    shared memory and ``(grid, 3, D, P)`` where it is not, and the launch
    is told which; the cluster layout allocates none and is told its
    cluster size.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ikpso_tpu_torch.harness.trees import model_spec, tree_configs
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.models.chain import Obstacles
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.fitness_kernel import MetaLayout, pack_meta
from ikpso_tpu_torch.pso import fused
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.pso.presets import FUSED_PRESETS
from ikpso_tpu_torch.utils import kernels
from ikpso_tpu_torch.utils.configio import load_config

from test_torch_branches import STANDIN

CONFIG_DIR = Path(__file__).resolve().parents[1] / "ikpso_tpu_torch" / "configs"
FUSED_SOLVE_CUH = kernels.CSRC / "fused_solve.cuh"


# (a) The traits and their mirrors.


def _topology_ids():
    """Name of each prebuilt topology in csrc/fk_fitness.cuh -> its id in
    KERNEL_TOPOLOGIES, from the ``using Name = Topology<N, parents, mask>``
    lines."""
    src = (kernels.CSRC / "fk_fitness.cuh").read_text()
    ids = {}
    for name, n, parents, mask in re.findall(
            r"using (\w+) = Topology<(\d+), (0x[0-9A-Fa-f]+)ull, (0x[0-9A-Fa-f]+)u>", src):
        ids[name] = kernels.KERNEL_TOPOLOGIES[(int(n), int(parents, 16), int(mask, 16))]
    return ids


def _trait(name):
    """``{topology id: value}`` of a trait's explicit specialisations, and its
    primary template's value."""
    src = FUSED_SOLVE_CUH.read_text()
    primary = re.search(
        rf"template <class T>\s*struct {name} {{\s*static constexpr \w+ value = (\w+);", src)
    ids = _topology_ids()
    special = {ids[topo]: value for topo, value in re.findall(
        rf"template <>\s*struct {name}<(\w+)> {{\s*static constexpr \w+ value = (\w+);", src)}
    return special, primary.group(1)


def test_traits_match_their_python_mirrors():
    ids = _topology_ids()
    assert sorted(ids.values()) == sorted(set(kernels.KERNEL_TOPOLOGIES.values()))
    threads, default = _trait("KernelAThreads")
    assert default == "1024"
    assert {t: int(v) for t, v in threads.items()} == kernels.MAX_PARTICLES
    stream, default = _trait("StreamDraws")
    assert default == "false" and set(stream.values()) == {"true"}
    assert sorted(stream) == sorted(kernels.STREAM_IDS)
    placement, default = _trait("StatePlacement")
    assert default == "kRegisters" and set(placement.values()) == {"kShared"}
    assert sorted(placement) == sorted(kernels.SHARED_IDS)
    # Three blocks an SM only where v and lbest left the registers of a
    # 256-thread topology (the tree loop's reference_arm and snake_30dof).
    min_blocks, default = _trait("KernelAMinBlocks")
    assert default == "1" and set(min_blocks.values()) == {"3"}
    assert all(t in kernels.SHARED_IDS and kernels.MAX_PARTICLES[t] == 256
               for t in min_blocks)
    # The tree loop: trees that stream their draws and keep v and lbest in
    # shared memory.
    tree, default = _trait("TreeLoop")
    assert default == "false" and set(tree.values()) == {"true"}
    assert sorted(tree) == sorted(kernels.TREE_LOOP_IDS)
    assert set(tree) <= set(kernels.STREAM_IDS) & set(kernels.SHARED_IDS)
    # An on-demand topology takes its placement and loop from the key's macros.
    od = (kernels.CSRC / "on_demand.cuh").read_text()
    assert re.search(r"struct StatePlacement<OdTopology> {\s*static constexpr int value ="
                     r" IKPSO_OD_SHARED", od)
    assert re.search(r"struct TreeLoop<OdTopology> {\s*static constexpr bool value ="
                     r" IKPSO_OD_TREE", od)


def test_shared_memory_reckoning_matches_the_kernels(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    (tmp_path / "cuda_runtime.h").write_text(STANDIN)
    for src in kernels.CSRC.glob("*.cuh"):
        (tmp_path / src.name).write_text(
            re.sub(r"<<<.*?>>>", "", src.read_text(), flags=re.S))
    rng = np.random.default_rng(8)
    cases = [tuple(int(v) for v in row) for row in np.stack(
        [rng.integers(2, 3000, 40), rng.integers(12, 600, 40), rng.integers(3, 300, 40),
         rng.integers(1, 33, 40) * 32, rng.integers(0, 3, 40)], axis=1)]
    main = tmp_path / "smem.cpp"
    main.write_text('#include <cstdio>\n#include "fused_solve.cuh"\nint main() {\n' + "".join(
        f'  std::printf("%zu\\n", ikpso::kernel_a_smem_bytes({m}, {k}, {d}, {p}, {n}));\n'
        for m, k, d, p, n in cases) + "}\n")
    exe = tmp_path / "smem"
    proc = subprocess.run(["g++", "-std=c++17", "-I", str(tmp_path), "-o", str(exe), str(main)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = [int(v) for v in subprocess.run([str(exe)], capture_output=True,
                                          text=True).stdout.split()]
    assert got == [kernels.kernel_a_smem_bytes(*c) for c in cases]
    # 16-byte alignment of the planes after the constants.
    assert all(kernels.kernel_a_smem_bytes(m, k, d, p, 0) % 16 == 0 for m, k, d, p, _ in cases)


def test_tree_loop_shared_memory_reckoning_matches_the_kernels(tmp_path):
    # tree_smem_bytes and tree_row, compiled by g++, against the Python
    # reckoning; each row is an odd number of float4 (conflict-free 16-byte
    # accesses) and holds v and lbest at D rounded up to 4 each.
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    (tmp_path / "cuda_runtime.h").write_text(STANDIN)
    for src in kernels.CSRC.glob("*.cuh"):
        (tmp_path / src.name).write_text(
            re.sub(r"<<<.*?>>>", "", src.read_text(), flags=re.S))
    rng = np.random.default_rng(17)
    cases = [tuple(int(v) for v in row) for row in np.stack(
        [rng.integers(2, 3000, 40), rng.integers(3, 150, 40), rng.integers(1, 33, 40) * 32],
        axis=1)]
    main = tmp_path / "smem.cpp"
    main.write_text('#include <cstdio>\n#include "fused_solve.cuh"\nint main() {\n' + "".join(
        f'  std::printf("%zu %d\\n", ikpso::tree_smem_bytes({m}, {d}, {p}), '
        f'ikpso::tree_row({d}));\n' for m, d, p in cases) + "}\n")
    exe = tmp_path / "smem"
    proc = subprocess.run(["g++", "-std=c++17", "-I", str(tmp_path), "-o", str(exe), str(main)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = [int(v) for v in subprocess.run([str(exe)], capture_output=True,
                                          text=True).stdout.split()]
    assert got == [v for m, d, p in cases
                   for v in (kernels.tree_smem_bytes(m, d, p), kernels.tree_row(d))]
    for _, d, _ in cases:
        row = kernels.tree_row(d)
        assert row % 8 == 4 and row >= 2 * ((d + 3) // 4 * 4)


# (b) Every preset and config document fits.


def _zoo():
    return [*FUSED_PRESETS, "snake:16", "snake:20", "snake:35", "snake:43", "snake:50",
            "snake:100"]


@pytest.mark.parametrize("model", _zoo())
def test_every_zoo_preset_fits_a_block(model):
    pre, _, fit = tree_configs(model)
    spec = model_spec(model)[0]
    layout = kernels.kernel_a_layout(spec, pre.particles)
    assert layout.smem_bytes <= kernels.SMEM_OPTIN
    topo = kernels.topology_id(spec)
    lay = MetaLayout(spec)
    assert layout.cluster == 0  # the zoo's serial chains keep the scratch layout
    if topo == kernels.SERIAL:
        assert layout.scratch and layout.placement in ("shared", "global")
        assert layout.scratch_planes == (2 if layout.placement == "shared" else 3)
    else:
        assert not layout.scratch and layout.scratch_planes == 0
        assert layout.placement == ("shared" if topo in kernels.SHARED_IDS else "registers")
    # The trees' tree loop keeps v and lbest as a row a thread.
    assert layout.tree == (topo in kernels.TREE_LOOP_IDS)
    if layout.tree:
        assert layout.smem_bytes == kernels.tree_smem_bytes(lay.meta_size, spec.dof,
                                                            pre.particles)
        assert layout.static_bytes == kernels.tree_static_bytes(spec, 0, False,
                                                                layout.threads)
        return
    planes = {"registers": 0, "shared": 1 if layout.scratch else 2, "global": 0}
    assert layout.smem_bytes == kernels.kernel_a_smem_bytes(
        lay.meta_size, lay.swarm_size, spec.dof, pre.particles, planes[layout.placement])


def test_serial_placement_follows_the_measured_occupancy():
    # At the snakes' P = 256 four blocks fit an SM with lbest in global
    # scratch: lbest moves to shared memory while two still fit (snake:20
    # keeps three, snake:35 two), not where one does (snake:43, snake:50).
    # The serial chains keep the scratch layout: the cluster layout ran
    # slower on each of them.
    layouts = {m: kernels.kernel_a_layout(model_spec(m)[0], 256)
               for m in ("snake:16", "snake:20", "snake:35", "snake:43", "snake:50")}
    assert {m: lay.placement for m, lay in layouts.items()} == {
        "snake:16": "shared", "snake:20": "shared", "snake:35": "shared",
        "snake:43": "global", "snake:50": "global"}
    assert all(lay.scratch and lay.cluster == 0 for lay in layouts.values())
    # At P = 1,024 one block fills an SM's registers anyway: lbest moves
    # where it fits at all.
    assert kernels.kernel_a_layout(model_spec("snake:16")[0], 1024).placement == "shared"
    assert kernels.kernel_a_layout(model_spec("snake:20")[0], 1024).placement == "global"
    assert kernels.kernel_a_layout(model_spec("snake:100")[0], 32).placement == "shared"
    # hand21 (on demand, 60 DOFs, a branching tree): two blocks of 256 at
    # its P = 512, one at 256; a swarm no cluster holds (P = 80, not a
    # multiple of 32) takes its scratch layout, lbest in shared memory.
    hand = load_config(str(CONFIG_DIR / "hand21.json")).spec
    big = kernels.kernel_a_layout(hand, 512)
    assert (big.cluster, big.scratch, big.placement, big.scratch_planes) == (
        2, False, "shared", 0)
    small = kernels.kernel_a_layout(hand, 256)
    assert (small.cluster, small.scratch, small.placement, small.scratch_planes) == (
        1, False, "shared", 0)
    odd = kernels.kernel_a_layout(hand, 80)
    assert (odd.cluster, odd.scratch, odd.placement, odd.scratch_planes) == (
        0, True, "shared", 2)
    # A chain built on demand (snake:20 among boxes: 60 DOFs, no branch)
    # keeps the scratch layout at any P.
    snake20 = model_spec("snake:20")[0]
    assert not kernels.branches(snake20) and kernels.branches(hand)
    assert not kernels.on_demand_key(snake20, 1, False).cluster
    assert kernels.kernel_a_layout(snake20, 512, 4, "box").cluster == 0
    # A tree past CLUSTER_MAX_DOF DOFs (22 nodes: 63) keeps the scratch
    # layout at any P.
    wide = _tree([-1] + [0] * 21, [21])
    assert not kernels.on_demand_key(wide, 0, False).cluster
    assert kernels.kernel_a_layout(wide, 512).cluster == 0


def test_cluster_size_takes_the_least_cluster_that_fits():
    d, m, k = 150, 53, 330
    assert kernels.cluster_size(d, 256, m, k) == 2
    assert kernels.cluster_size(d, 128, m, k) == 1
    # A block holds at most CLUSTER_THREADS threads, a multiple of 32.
    assert kernels.cluster_size(60, 1024, m, k) == 4
    assert kernels.cluster_size(60, 96, m, k) == 1
    assert kernels.cluster_size(60, 2048, m, k) == 0
    # No cluster holds the planes of 400 DOFs at 1,024 particles.
    assert kernels.cluster_smem_bytes(m, k, 400, 256) > kernels.SMEM_OPTIN
    assert kernels.cluster_size(400, 1024, m, k) == 0


def test_cluster_shared_memory_reckoning_matches_the_kernels(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    (tmp_path / "cuda_runtime.h").write_text(STANDIN)
    for src in kernels.CSRC.glob("*.cuh"):
        (tmp_path / src.name).write_text(
            re.sub(r"<<<.*?>>>", "", src.read_text(), flags=re.S))
    rng = np.random.default_rng(12)
    cases = [tuple(int(v) for v in row) for row in np.stack(
        [rng.integers(2, 3000, 40), rng.integers(12, 600, 40), rng.integers(3, 300, 40),
         rng.integers(1, 9, 40) * 32], axis=1)]
    main = tmp_path / "smem.cpp"
    main.write_text('#include <cstdio>\n#include "fused_solve.cuh"\nint main() {\n' + "".join(
        f'  std::printf("%zu\\n", ikpso::cluster_smem_bytes({m}, {k}, {d}, {p}));\n'
        for m, k, d, p in cases) + "}\n")
    exe = tmp_path / "smem"
    proc = subprocess.run(["g++", "-std=c++17", "-I", str(tmp_path), "-o", str(exe), str(main)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = [int(v) for v in subprocess.run([str(exe)], capture_output=True,
                                          text=True).stdout.split()]
    assert got == [kernels.cluster_smem_bytes(*c) for c in cases]
    assert all(v % 16 == 0 for v in got)  # the planes start 16-byte aligned


@pytest.mark.parametrize("name", ["arm7_locality", "arm7_exact", "dual_arm_box", "hand21"])
def test_every_config_document_fits_a_block(name):
    cfg = load_config(str(CONFIG_DIR / f"{name}.json"))
    n_obs = 0 if cfg.obstacles is None else cfg.obstacles.count
    layout = kernels.kernel_a_layout(
        cfg.spec, cfg.num_particles, n_obs, cfg.fitness.collision_shape,
        cfg.fitness.orientation_weight != 0.0, cfg.fitness.distance_weight != 0.0,
        cfg.fitness.trig_impl)
    assert layout.smem_bytes <= kernels.SMEM_OPTIN
    want = {"arm7_locality": "registers", "arm7_exact": "registers",
            "dual_arm_box": "shared", "hand21": "shared"}[name]
    assert layout.placement == want
    assert not layout.scratch
    assert layout.cluster == (2 if name == "hand21" else 0)


def test_each_tree_takes_its_measured_loop():
    # kernel_a_layout's choice per tree (on_demand_key, from the pairs on an
    # H100 in PERF.md): the humanoid, the dual arm, reference_arm and
    # snake_30dof (at their 256-thread bound) run the tree loop, and so do
    # their twins with the orientation term, a scene, the distance term or
    # exact trig, but the box scene at 64 registers a thread (the dual arm's
    # 1,024-thread bound: dual_arm_box keeps the general loop), and a tree
    # of 18-45 DOFs of its own, with or without a scene; hand21 keeps its
    # cluster layout.
    dual, hum = library.dual_arm_14dof()[0], library.humanoid_45dof()[0]
    ref, snake = model_spec("reference_arm")[0], model_spec("snake_30dof")[0]
    box = kernels.COLLIDERS["box"]
    for spec, p in ((dual, 1024), (hum, 512), (ref, 256), (snake, 256)):
        lay = kernels.kernel_a_layout(spec, p)
        assert (lay.tree, lay.placement, lay.scratch, lay.cluster, lay.threads) == (
            True, "shared", False, 0, p)
        assert lay.smem_bytes == kernels.tree_smem_bytes(MetaLayout(spec).meta_size,
                                                         spec.dof, p)
        assert kernels.kernel_a_layout(spec, p, use_orientation=True).tree
        assert kernels.on_demand_key(spec, 0, True).tree
        for shape in ("box", "capsule"):
            c = kernels.COLLIDERS[shape]
            assert kernels.tree_fits(spec, c, False, p)
            tree = spec is not dual or shape != "box"
            lay = kernels.kernel_a_layout(spec, p, 4, shape)
            assert (lay.tree, lay.placement) == (tree, "shared")
            assert lay.static_bytes == (kernels.tree_static_bytes(spec, c, False, p)
                                        if tree else 0)
            if tree:
                assert lay.smem_bytes == kernels.tree_smem_bytes(
                    MetaLayout(spec, 4).meta_size, spec.dof, p)
        assert kernels.kernel_a_layout(spec, p, use_distance=True).tree
        assert kernels.kernel_a_layout(spec, p, trig_impl="exact").tree
    cfg = load_config(str(CONFIG_DIR / "dual_arm_box.json"))
    lay = kernels.kernel_a_layout(cfg.spec, cfg.num_particles, cfg.obstacles.count, "box")
    assert not lay.tree and lay.smem_bytes <= kernels.SMEM_OPTIN
    # The dual arm's row: v and lbest (20 floats each) and 4 more (lval with
    # a scene at 64 registers), 44 floats (11 float4).
    assert kernels.tree_row(dual.dof) == 44
    # reference_arm's row (tree_row(21) = 52 floats, 13 float4) and
    # snake_30dof's (68 floats) at P = 256.
    assert kernels.tree_row(ref.dof) == 52 and kernels.tree_row(snake.dof) == 68
    assert kernels.kernel_a_layout(ref, 256).smem_bytes - 4 * (
        MetaLayout(ref).meta_size + 3) // 16 * 16 == 53_248
    # A tree of its own of 18-45 DOFs (27 here) runs the tree loop too, at
    # its 512-thread bound.
    mid = _tree([-1, 0, 1, 2, 3, 4, 5, 6, 1, 8], [7, 9])
    assert kernels.on_demand_key(mid, 0, False).tree
    assert kernels.on_demand_key(mid, box, False).tree
    lay = kernels.kernel_a_layout(mid, 512, 4, "box")
    assert (lay.tree, lay.threads) == (True, 512)
    hand = load_config(str(CONFIG_DIR / "hand21.json")).spec
    assert (kernels.kernel_a_layout(hand, 512).cluster,
            kernels.kernel_a_layout(hand, 512).tree) == (2, False)
    # The macro reaches the generated source.
    assert "#define IKPSO_OD_TREE 1" in kernels.on_demand_source(
        kernels.on_demand_key(dual, 0, True))
    assert "#define IKPSO_OD_TREE 1" in kernels.on_demand_source(
        kernels.on_demand_key(hum, box, False))
    assert "#define IKPSO_OD_TREE 0" in kernels.on_demand_source(
        kernels.on_demand_key(dual, box, False))


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tree_loop_keys_match_the_kernels_bytes(tmp_path):
    # Every on-demand key of chip_smoke.py's TREE_LOOP_KEYS (the dual arm
    # among boxes and capsules, with the distance term or exact trig, hand12
    # without and with boxes): on_demand_key's tree flag (the tree loop but
    # for dual_arm_box), and for those in it kernel_a_layout's dynamic and
    # static bytes at the case's P and scene against the kernels' own
    # (tree_smem_bytes and sizeof(TreeShared) of the key's OnDemandTopology,
    # compiled by g++).
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    smoke = _chip_smoke()
    (tmp_path / "cuda_runtime.h").write_text(STANDIN)
    for src in kernels.CSRC.glob("*.cuh"):
        (tmp_path / src.name).write_text(
            re.sub(r"<<<.*?>>>", "", src.read_text(), flags=re.S))
    keys, rows, lines = smoke.od_keys(), [], []
    for tag in smoke.TREE_LOOP_KEYS:
        key = keys[tag]
        assert key.tree == (tag != "dual_arm_box")
        if not key.tree:
            continue
        assert key.shared and key.stream and not key.scratch
        spec, _, fit, p, meta, swarm, obs, orient = smoke.od_case(
            tag, "cpu", 2, np.random.default_rng(0))
        n_obs = 0 if obs is None else obs.count
        layout = fused.kernel_a_layout(spec, fit, swarm, p, n_obs, orient)
        assert layout.tree and layout.threads == key.threads
        topo = (f"ikpso::OnDemandTopology<ikpso::IntList<{', '.join(map(str, key.parents))}>, "
                f"ikpso::IntList<{', '.join(map(str, key.effectors))}>, {key.threads}, true, "
                f"{str(key.distance).lower()}, {str(key.exact).lower()}>")
        lines.append(f'  std::printf("%zu %zu\\n", ikpso::tree_smem_bytes({meta.numel()}, '
                     f'{spec.dof}, {p}), sizeof(ikpso::TreeShared<{topo}, '
                     f'{key.collider}, {str(key.orientation).lower()}, {key.threads}>));\n')
        rows.append((layout.smem_bytes, layout.static_bytes))
    main = tmp_path / "tree.cpp"
    main.write_text('#include <cstdio>\n#include "fused_solve.cuh"\nint main() {\n'
                    + "".join(lines) + "}\n")
    exe = tmp_path / "tree"
    proc = subprocess.run(["g++", "-std=c++17", "-I", str(tmp_path), "-o", str(exe), str(main)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = [int(v) for v in subprocess.run([str(exe)], capture_output=True,
                                          text=True).stdout.split()]
    assert got == [v for row in rows for v in row]


def test_on_demand_keys_carry_their_placement():
    hand = load_config(str(CONFIG_DIR / "hand21.json")).spec
    dual = library.dual_arm_14dof()[0]
    arm = library.arm_7dof()[0]
    key = kernels.on_demand_key(hand, 0, False)
    assert (key.threads, key.scratch, key.shared, key.cluster) == (512, True, True, True)
    assert kernels.on_demand_key(dual, 1, False).shared  # follows DualArm14
    assert not kernels.on_demand_key(arm, 0, False, True).shared  # follows Arm7Dof
    # A new tree in the register layout: shared memory from STREAM_DOF DOFs.
    short = _tree([-1, 0, 1, 2, 0], [3, 4])
    mid = _tree([-1, 0, 1, 2, 3, 4, 5, 6, 1, 8], [7, 9])
    assert not kernels.on_demand_key(short, 0, False).shared
    assert kernels.on_demand_key(mid, 0, False).shared
    # The macro reaches the generated source, and the placement the hash.
    assert "#define IKPSO_OD_SHARED 1" in kernels.on_demand_source(key)
    assert "#define IKPSO_OD_CLUSTER 1" in kernels.on_demand_source(key)
    assert (kernels.on_demand_path(key)
            != kernels.on_demand_path(key._replace(shared=False)))


def _tree(parents, effectors):
    from ikpso_tpu_torch.models.chain import make_chain_spec

    n = len(parents)
    return make_chain_spec(parents, np.ones(n, np.float32), np.full((n, 3), -np.pi),
                           np.full((n, 3), np.pi), effector_idx=effectors)


# (c) What does not fit raises before any launch.


def _boxes(count):
    rng = np.random.default_rng(9)
    return Obstacles.from_boxes(rng.normal(0, 3, (count, 3)).astype(np.float32),
                                np.full((count, 3), 0.1, np.float32))


def _args(spec, count, particles):
    swarm = torch.zeros((4, MetaLayout(spec, count).swarm_size))
    seeds = torch.zeros((4, 2), dtype=torch.int32)
    return (spec, PSOConfig(iterations=2), FitnessConfig(collision_shape="box"), swarm,
            spec.limits(), seeds, particles, None, count)


@pytest.mark.parametrize("model,count,big,small", [
    # v and lbest in shared memory: 147,456 bytes at P = 1,024.
    ("dual_arm_14dof", 1500, 1024, 512),
    # The cluster layout at P = 512 (four blocks' planes do not fit beside
    # the scene either), two blocks of 64 at 128.
    ("hand21", 3100, 512, 128),
    # Registers: the scene alone.
    ("arm_7dof", 4000, 128, None),
])
def test_what_does_not_fit_raises_before_any_launch(model, count, big, small, monkeypatch):
    spec = (load_config(str(CONFIG_DIR / "hand21.json")).spec if model == "hand21"
            else getattr(library, model)()[0])

    def no_launch(*_):
        raise AssertionError("a kernel library was asked for")

    monkeypatch.setattr(kernels, "library", no_launch)
    monkeypatch.setattr(kernels, "on_demand_library", no_launch)
    layout = kernels.kernel_a_layout(spec, big, count, "box")
    assert layout.smem_bytes > kernels.SMEM_OPTIN
    with pytest.raises(ValueError, match=f"needs {layout.smem_bytes} bytes of shared memory"):
        fused._check_args(*_args(spec, count, big))
    # The plain twin refuses it too, and so does the wrapper, before any
    # library is loaded.
    meta = pack_meta(spec, FitnessConfig(collision_shape="box"), _boxes(count))
    spec_, pso, fit, swarm, lim, seeds, p, _, n = _args(spec, count, big)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fused.fused_solve(spec_, pso, fit, meta, swarm, lim, seeds, p, num_obstacles=n)
    if small is not None:
        assert fused._check_args(*_args(spec, count, small)).smem_bytes <= kernels.SMEM_OPTIN


# (d) The scratch follows the placement.


class _Recorder:
    """A stand-in kernel library: records each call's arguments, returns 0
    (and ``blocks`` for the block-count queries)."""

    def __init__(self, blocks):
        self.blocks, self.calls = blocks, {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return self.blocks if name.endswith("_blocks") else 0
        return call


@pytest.mark.parametrize("model,particles,planes,cluster", [
    ("snake:20", 256, 2, 0), ("snake:50", 256, 3, 0), ("snake:20", 1024, 3, 0),
    ("hand21", 512, 0, 2), ("hand21", 256, 0, 1), ("hand21", 80, 2, 0),
    ("snake:100", 32, 2, 0)])
def test_scratch_shape_follows_the_placement(model, particles, planes, cluster, monkeypatch):
    spec = (load_config(str(CONFIG_DIR / "hand21.json")).spec if model == "hand21"
            else model_spec(model)[0])
    s = 6
    lay = MetaLayout(spec)
    meta = torch.zeros(lay.meta_size)
    swarm = torch.zeros((s, lay.swarm_size))
    layout = kernels.kernel_a_layout(spec, particles)
    assert (layout.scratch_planes, layout.cluster) == (planes, cluster)
    shapes = []
    scratch = fused._scratch

    def spy(*args):
        out = scratch(*args)
        shapes.append(None if out is None else tuple(out.shape))
        return out

    lib = _Recorder(blocks=4)
    monkeypatch.setattr(fused, "_scratch", spy)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "on_demand_library", lambda key: lib)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: None)
    update = (0,) * 14
    gbest, gval = torch.empty((s, spec.dof)), torch.empty(s)
    if model == "hand21":
        key = kernels.on_demand_key(spec, 0, False)
        fused._launch_on_demand(key, 0, 0, 0, (0.0,) * 4, meta, swarm, update, gbest, gval,
                                particles, layout)
        if cluster:
            # The cluster launch and its query are told the cluster size;
            # the grid is the clusters that fit at once; no scratch.
            assert lib.calls["ikpso_od_fused_solve_cluster_blocks"][1] == cluster
            args = lib.calls["ikpso_od_fused_solve_cluster"]
            assert args[1] == cluster and args[-6] == 4
            assert "ikpso_od_fused_solve" not in lib.calls and shapes == []
        else:
            assert "ikpso_od_fused_solve_cluster" not in lib.calls
            assert shapes == [(4, planes, spec.dof, particles)]
    else:
        fused._launch_serial(spec, 0, 0, meta, swarm, update, gbest, gval, particles, layout)
        shared = int(planes == 2)
        # The launch and the block-count query are told the placement.
        assert lib.calls["ikpso_fused_solve_serial_blocks"][1] == shared
        assert lib.calls["ikpso_fused_solve_serial"][1] == shared
        assert shapes == [(4, planes, spec.dof, particles)]
