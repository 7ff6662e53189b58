"""The port's benchmark entry (``ikpso_tpu_torch/bench.py``) against the
root ``bench.py``, on the CPU.

(a) Recipe parity: ``bench.py``'s ``main()`` runs with its solve stubbed
    to record its keyword arguments; the port's ``resolve_recipe`` on the
    same argv gives the same values field by field, less the TPU's
    ``swarms_per_tile`` and ``kernel_sol`` (the speed-of-light default
    differs by platform on purpose). On the card, ``--impl auto``
    resolves as ``--impl fused``.
(b) Record keys: with both solves stubbed, the port's record has JAX's
    keys less ``swarms_per_tile``, plus ``failures_ge_1mm``.
(c) Headline bits: the entry's solve of the headline recipe on the CPU at
    S=1,024 (kernel A's plain twin) equals ``harness/headline.py``'s
    solver run on the same targets and the same per-call generator, bit
    for bit.
(d) Scan distribution: ``--cpu --impl jnp`` at S=512, P=256 and 16
    iterations (cut so that each side runs in ~25 s); the port's
    ``frac_under_1mm`` lies within 4 combined binomial standard errors of
    JAX ``bench.py``'s at the same flags. Observed on an 8-core CPU: JAX
    0.2012, the port 0.2168 (seed 0).
(e) Refusals: ``--selftest`` and ``--swarms-per-tile`` are rejected, and
    the entry exits non-zero without a card unless given ``--cpu``.
(f) ``utils.roofline.megakernel_slope`` with a scene (and orientation)
    counts what ``fused_solve_count`` counts for it.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ikpso_tpu_torch import bench as port
from ikpso_tpu_torch.harness.headline import (
    build_headline_solver,
    headline_configs,
    reachable_pose,
    reachable_targets,
)
from ikpso_tpu_torch.harness.obstacles import obstacle_scene
from ikpso_tpu_torch.harness.orientation import orientation_configs, orientation_targets
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.utils import roofline, seeds
from ikpso_tpu_torch.utils.flops import fused_solve_count

from test_torch_fused import torch_single_thread  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
ZOO = ["arm_7dof", "planar_3dof", "arm_6dof", "dual_arm_14dof", "reference_arm",
       "humanoid_45dof", "snake_30dof", "snake:50"]
BOX_RETRY = ["--obstacles", "4", "--swarms", "524288", "--retries", "12",
             "--retry-iterations", "24", "--retry-init-mode", "uniform"]
CASES = {
    **{f"zoo-{m}": ["--model", m, "--impl", "fused"] for m in ZOO},
    "jnp": ["--impl", "jnp"],
    "pallas": ["--impl", "pallas"],
    "obstacles-box": ["--obstacles", "4", "--impl", "fused"],
    "obstacles-capsule": ["--obstacles", "4", "--collision-shape", "capsule",
                          "--impl", "fused"],
    "obstacles-auto": ["--obstacles", "4"],
    "box-retry": [*BOX_RETRY, "--impl", "fused"],
    "orientation": ["--model", "arm_6dof", "--orientation", "--impl", "fused"],
    "latency": ["--latency", "--impl", "fused"],
    "iterations-12": ["--iterations", "12", "--impl", "fused"],
    "walk-4": ["--walk", "4", "--impl", "fused"],
    "randomized": ["--inertia-mode", "randomized", "--impl", "fused"],
    "rekick-4": ["--rekick-interval", "4", "--impl", "fused"],
}
# Stub stats of one measured recipe, as the solves return them.
STUB = dict(wall_s=0.5, solves_per_s=2048.0, p50_err_mm=0.0001, p90_err_mm=0.0003,
            frac_under_1mm=0.9999, gflops=1.0, gtranscendentals=0.0)


def _jax_bench():
    spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_config():
    """bench.py's main() sets JAX's persistent-cache floor; restore it."""
    floor = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", floor)


def _stub_stats(obstacles, orientation):
    out = dict(STUB)
    if obstacles:
        out["frac_targets_feasible"] = 0.95
    if orientation:
        out.update(p50_orient_err_deg=0.01, p90_orient_err_deg=0.02)
    return out


def _jax_main(argv, monkeypatch, capsys):
    """bench.py's main() on ``argv`` with its solve stubbed: the keyword
    arguments of each solve call and the printed record."""
    mod = _jax_bench()
    calls = []

    def stub(spec, problem, key, **kw):
        calls.append(kw)
        out = _stub_stats(kw["obstacles"] is not None, kw["orientation"])
        if kw["chained_runs"]:
            k = kw["chained_runs"]
            out["_chained_thunk"] = lambda: dict(chained_runs=k, chained_wall_s=0.1,
                                                 chained_ms_per_run=0.1 / k * 1e3)
        return out

    monkeypatch.setattr(mod, "_target_p50_under_1mm", stub)
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    capsys.readouterr()
    assert mod.main() == 0
    return calls, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_main(argv, monkeypatch, capsys):
    """The port's main() on ``argv + --cpu`` with its solve stubbed: the
    keyword arguments of each solve call and the printed record."""
    calls = []

    def stub(**kw):
        calls.append(kw)
        stats = _stub_stats(kw["obstacles"], kw["orientation"])
        stats["failures_ge_1mm"] = 1
        if kw["chained_runs"]:
            stats.update(chained_runs=kw["chained_runs"],
                         chained_ms_per_run=0.1 / kw["chained_runs"] * 1e3)
        return port.BenchRun(stats, None)

    monkeypatch.setattr(port, "target_p50_under_1mm", stub)
    capsys.readouterr()
    assert port.main([*argv, "--cpu"]) == 0
    return calls, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _as_port(jax_kw):
    """JAX's solve keywords under the port's names: ``s`` is ``swarms``, a
    scene is its box count; the TPU's ``swarms_per_tile`` and the
    platform-bound ``kernel_sol`` are left out."""
    out = {}
    for k, v in jax_kw.items():
        if k in ("swarms_per_tile", "kernel_sol"):
            continue
        if k == "obstacles":
            v = 0 if v is None else v.count
        out["swarms" if k == "s" else k] = v
    return out


def _recipe(argv, platform="cpu"):
    return port.resolve_recipe(port.build_parser().parse_args(argv), platform)


@pytest.mark.parametrize("case", sorted(CASES))
def test_recipe_matches_bench_py(case, monkeypatch, capsys, jax_config):
    argv = CASES[case]
    calls, _ = _jax_main(argv, monkeypatch, capsys)
    got = _recipe(argv)
    want = _as_port(calls[0])
    assert set(got) - set(want) == {"model", "seed", "kernel_sol"}
    assert {k: got[k] for k in want} == want
    model = argv[argv.index("--model") + 1] if "--model" in argv else "arm_7dof"
    assert got["model"] == model and got["kernel_sol"] is False
    if "--latency" in argv:  # the 64x-batch slope's run
        assert _as_port(calls[1]) == {**want, "swarms": 64 * want["swarms"],
                                      "chained_runs": 0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_record_keys_match_bench_py(case, monkeypatch, capsys, jax_config):
    argv = CASES[case]
    _, want = _jax_main(argv, monkeypatch, capsys)
    calls, got = _port_main(argv, monkeypatch, capsys)
    keys = [k for k in want if k != "swarms_per_tile"]
    keys.insert(keys.index("frac_under_1mm") + 1, "failures_ge_1mm")
    assert list(got) == keys
    assert got["platform"] == want["platform"] == "cpu"
    for k in set(keys) - {"failures_ge_1mm", "dispatch_ms"}:  # dispatch: measured
        assert got[k] == want[k], k
    assert calls[0] == {**_recipe(argv), "device": torch.device("cpu")}


@pytest.mark.parametrize("model", ZOO)
def test_auto_on_the_card_is_fused(model):
    on_card = _recipe(["--model", model], "gpu")
    fused = _recipe(["--model", model, "--impl", "fused"], "cpu")
    assert on_card["impl"] == "fused"
    assert {**on_card, "kernel_sol": False} == fused
    # --sol's default: arm_7dof on the card, not with --latency or a scene.
    assert on_card["kernel_sol"] is (model == "arm_7dof")
    assert not _recipe(["--model", model, "--latency"], "gpu")["kernel_sol"]
    assert not _recipe(["--model", model, "--obstacles", "4"], "gpu")["kernel_sol"]
    assert not _recipe(["--model", model, "--no-sol"], "gpu")["kernel_sol"]


def test_auto_on_the_card_falls_back_where_kernel_a_refuses(capsys):
    # It does not: auto stays on kernel A on the card, and where kernel A
    # refuses (arm_7dof takes at most 1,024 particles a swarm) the entry
    # exits with kernel A's error, naming the scan solver's two fitnesses
    # as explicit choices. Kernel A's plain twin runs the same check.
    recipe = _recipe(["--particles", "2048"], "gpu")
    assert recipe["impl"] == "fused" and recipe["num_particles"] == 2048
    with pytest.raises(SystemExit) as exc:
        port.main(["--cpu", "--impl", "fused", "--particles", "2048", "--swarms", "8"])
    msg = str(exc.value.code)
    assert "kernel A refuses" in msg and "num_particles=2048" in msg
    assert "--impl pallas" in msg and "--impl jnp" in msg
    assert capsys.readouterr().out == ""


@pytest.mark.usefixtures("torch_single_thread")
def test_headline_recipe_is_bitwise_the_headline_solver():
    s = 1024
    recipe = _recipe(["--impl", "fused", "--swarms", str(s)])
    run = port.target_p50_under_1mm(**recipe, device="cpu", warmup=0, iters=1)
    spec, problem = library.arm_7dof()
    target_seed, solve_seed = seeds.split(0)
    batched = library.batched_problem(
        problem, reachable_targets(spec, problem, s, seeds.generator(target_seed, "cpu")))
    want = build_headline_solver(spec, s, "cpu")(
        batched, port.call_generator(solve_seed, 0, "cpu"))
    assert torch.equal(run.result.effector_error, want.effector_error)
    err_mm = want.effector_error.double().numpy() * 1000.0
    assert run.stats["failures_ge_1mm"] == int((err_mm >= 1.0).sum())
    assert run.stats["frac_under_1mm"] >= 0.99 and run.stats["p50_err_mm"] < 1.0
    assert run.sol is None


SCAN_ARGV = ["--impl", "jnp", "--swarms", "512", "--particles", "256", "--iterations", "16"]


@pytest.mark.usefixtures("torch_single_thread")
def test_scan_recipe_matches_bench_py_in_distribution(monkeypatch, capsys, jax_config):
    monkeypatch.setattr(sys, "argv", ["bench.py", *SCAN_ARGV, "--cpu"])
    capsys.readouterr()
    assert _jax_bench().main() == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port.main([*SCAN_ARGV, "--cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    n = 512
    assert got["swarms"] == want["swarms"] == n and got["impl"] == "jnp"
    p, q = got["frac_under_1mm"], want["frac_under_1mm"]
    se = np.sqrt(p * (1 - p) / n + q * (1 - q) / n)
    assert abs(p - q) <= 4 * max(se, 1 / n), (p, q, se)
    assert got["failures_ge_1mm"] == round((1 - p) * n)


@pytest.mark.parametrize("argv", [["--selftest", "--cpu"],
                                  ["--swarms-per-tile", "2", "--cpu"]])
def test_tpu_only_flags_are_rejected(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        port.main(argv)
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_entry_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        port.main(["--swarms", "8"])
    assert exc.value.code not in (0, None)
    proc = subprocess.run([sys.executable, "-m", "ikpso_tpu_torch.bench", "--swarms", "8"],
                          capture_output=True, text=True, timeout=120, cwd=ROOT,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "pass --cpu" in proc.stderr


def _slope_case(scene: bool, orientation: bool):
    if orientation:
        _, pso, fit = orientation_configs()
        spec, problem = library.arm_6dof()
        pose = reachable_pose(spec, problem, 4, seeds.generator(1, "cpu"))
        targets, target_rot = orientation_targets(spec, problem, pose)
    else:
        _, pso, fit = headline_configs()
        spec, problem = library.arm_7dof()
        targets = reachable_targets(spec, problem, 4, seeds.generator(1, "cpu"))
        target_rot = None
    pso = dataclasses.replace(pso, iterations=2, rekick_interval=0)
    batched = library.batched_problem(problem, targets, target_rot=target_rot)
    return spec, batched, pso, fit, obstacle_scene(spec, 4) if scene else None


@pytest.mark.parametrize("scene,orientation", [(True, False), (False, True), (True, True)])
def test_megakernel_slope_counts_the_scene(scene, orientation, monkeypatch):
    spec, batched, pso, fit, obstacles = _slope_case(scene, orientation)
    monkeypatch.setattr(roofline, "_require_cuda", lambda device: torch.device("cpu"))
    solved = []
    monkeypatch.setattr("ikpso_tpu_torch.pso.fused.fused_solve",
                        lambda *a, **kw: solved.append(kw))
    _, count = roofline.megakernel_slope(spec, batched, pso, fit, particles=32,
                                         device="cpu", obstacles=obstacles)
    n_obs = 4 if scene else 0
    assert {(kw["num_obstacles"], kw["use_orientation"]) for kw in solved} == {
        (n_obs, orientation)}
    kw = dict(num_particles=32, num_swarms=4, num_obstacles=n_obs,
              use_orientation=orientation)
    want = (fused_solve_count(spec, dataclasses.replace(pso, iterations=6), fit, **kw)
            + fused_solve_count(spec, pso, fit, **kw) * -1.0) * 0.5
    assert dataclasses.astuple(count) == pytest.approx(dataclasses.astuple(want), rel=1e-12)
