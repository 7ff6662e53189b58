"""The JSON-config ``solve`` entry point of the port against the JAX package.

(a) ``utils/configio.py``: the five documents of ``ikpso_tpu_torch/configs``,
    a zoo name, ``snake:7`` and a custom tree with target rotations load
    through both loaders to equal specs, problems (atol 0: the same
    float32 values), PSO and fitness configs and scenes; ``dump_config``
    round-trips; unknown keys raise.
(b) ``harness/cli.py``: ``solve`` on the CPU for ``hand21`` at small P and
    iterations prints the JAX CLI's keys and the fitness that ran, with an
    effector error inside the spread of JAX's at the same setting; ``--preset`` with
    ``--config`` raises; ``--impl fused`` without the card raises.
(c) ``harness/configs.py`` on the CPU at tiny S, the GJK document
    (``arm7_box_gjk``) among them; ``viz``'s page and ``scene_dict``
    against JAX's.

Run as a script (``JAX_PLATFORMS=cpu python tests/test_torch_configs.py``),
this file prints the bars ``chip_smoke.py`` holds the configurations to
(its ``JAX_CONFIGS`` and ``JAX_GJK_CONFIG``): JAX's scan solver and polish
on 1,024 reachable targets of each document, compiled and op by op (256
for the GJK document op by op), p50 and p90 effector error with their 99%
distribution-free intervals (:func:`config_bar`).
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":  # run as a script: the packages sit at the root
    sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikpso_tpu.utils import configio as jconfigio
from ikpso_tpu_torch.harness import cli, configs
from ikpso_tpu_torch.utils import configio

from test_torch_fused import torch_single_thread  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = ROOT / "ikpso_tpu_torch" / "configs"
DOCUMENTS = ("arm7_locality", "arm7_exact", "dual_arm_box", "hand21", "arm7_box_gjk")
# The polish steps each configuration runs with (``solve --polish K``):
# the presets' of arm_7dof, dual_arm_14dof and humanoid_45dof.
POLISH = {"arm7_locality": 4, "arm7_exact": 4, "dual_arm_box": 4, "hand21": 6,
          "arm7_box_gjk": 4}
CUSTOM_TREE = {
    "model": {
        "parent": [-1, 0, 1, 1], "length": [0.0, 1.0, 0.5, 0.5],
        "min_rotation": -1.5, "max_rotation": 1.5, "effector_idx": [3, 2],
        "effector_weight": [1.0, 0.5], "pose": [[0.0, 0.0, 0.1]] + [[0.2, 0.1, 0.0]] * 3,
        "origin": [0.1, 0.0, -0.2], "targets": [[1.0, 0.5, 0.0], [0.8, -0.4, 0.2]],
        "target_rot": [[0.1, 0.2, 0.3], [0.0, -0.2, 0.1]],
    },
    "pso": {"iterations": 6, "inertia_mode": "canonical", "inertia_end": 0.2,
            "rekick_interval": 3, "rekick_threshold": 1e-6},
    "fitness": {"orientation_weight": 0.5, "distance_weight": 0.25, "trig_impl": "exact"},
    "num_particles": 256,
    "obstacles": {"centers": [[1.0, 1.0, 0.0]], "full_dims": [[0.4, 0.4, 0.4]],
                  "quats": [[0.0, 0.0, 0.383, 0.924]]},
}


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _assert_same_config(got, want):
    for field in ("parent", "effector_idx"):
        assert tuple(getattr(got.spec, field)) == tuple(getattr(want.spec, field))
    for field in ("length", "min_rotation", "max_rotation", "effector_weight"):
        np.testing.assert_array_equal(_np(getattr(got.spec, field)),
                                      _np(getattr(want.spec, field)), err_msg=field)
    for field in ("pose", "origin", "targets", "target_rot"):
        g, w = getattr(got.problem, field), getattr(want.problem, field)
        assert (g is None) == (w is None), field
        if g is not None:
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=field)
    assert dataclasses.asdict(got.pso) == dataclasses.asdict(want.pso)
    assert dataclasses.asdict(got.fitness) == dataclasses.asdict(want.fitness)
    assert got.num_particles == want.num_particles
    assert (got.obstacles is None) == (want.obstacles is None)
    if got.obstacles is not None:
        for field in ("center", "half_extent", "rot"):
            np.testing.assert_allclose(_np(getattr(got.obstacles, field)),
                                       _np(getattr(want.obstacles, field)), atol=1e-6,
                                       err_msg=field)


# (a) The loader.


@pytest.mark.parametrize("source", [*DOCUMENTS, "reference_arm", "snake:7", "custom"])
def test_config_loads_like_jax(source):
    if source in DOCUMENTS:
        src = str(CONFIG_DIR / f"{source}.json")
    elif source == "custom":
        src = json.dumps(CUSTOM_TREE)
    else:
        src = {"model": source}
    _assert_same_config(configio.load_config(src), jconfigio.load_config(src))


def test_documents_keep_the_issue_recipes():
    # The two 7-DOF documents: arm_7dof's preset base solve; locality at
    # JAX's test weights (tests/test_fused.py:65), exact trig at zero weights.
    loc = configio.load_config(str(CONFIG_DIR / "arm7_locality.json"))
    ex = configio.load_config(str(CONFIG_DIR / "arm7_exact.json"))
    for cfg in (loc, ex):
        assert cfg.num_particles == 128 and cfg.pso.iterations == 8
        assert (cfg.pso.inertia_mode, cfg.pso.inertia, cfg.pso.inertia_end,
                cfg.pso.init_mode) == ("canonical", 0.5, 0.2, "warm")
    assert (loc.fitness.angle_weight, loc.fitness.distance_weight) == (3.0, 0.7)
    assert (ex.fitness.angle_weight, ex.fitness.distance_weight,
            ex.fitness.trig_impl) == (0.0, 0.0, "exact")
    # The dual arm in bench.py's 4-box scene (obstacles.obstacle_scene).
    dual = configio.load_config(str(CONFIG_DIR / "dual_arm_box.json"))
    from ikpso_tpu_torch.harness.obstacles import obstacle_scene

    scene = obstacle_scene(dual.spec, 4)
    np.testing.assert_array_equal(dual.obstacles.center.numpy(), scene.center.numpy())
    np.testing.assert_array_equal(dual.obstacles.half_extent.numpy(),
                                  scene.half_extent.numpy())
    assert dual.num_particles == 1024 and dual.pso.rekick_interval == 4
    # The hand: MediaPipe Hands' 21 landmarks, five fingertip effectors.
    hand = configio.load_config(str(CONFIG_DIR / "hand21.json"))
    assert hand.spec.num_nodes == 21 and hand.spec.dof == 60
    assert hand.spec.effector_idx == (4, 8, 12, 16, 20)
    assert float(hand.spec.min_rotation[0].abs().max()) == 0.0
    assert float(hand.spec.max_rotation[1:].min()) == 2.0
    assert hand.num_particles == 512 and hand.pso.iterations == 60


@pytest.mark.parametrize("source", ["hand21", "custom"])
def test_dump_config_round_trips(source):
    src = str(CONFIG_DIR / "hand21.json") if source == "hand21" else json.dumps(CUSTOM_TREE)
    cfg = configio.load_config(src)
    again = configio.load_config(configio.dump_config(cfg))
    if cfg.obstacles is not None:
        # dump_config writes centers and full sizes, as JAX's does.
        cfg = dataclasses.replace(cfg, obstacles=again.obstacles)
    _assert_same_config(again, cfg)
    assert json.loads(configio.dump_config(cfg)) == json.loads(
        jconfigio.dump_config(jconfigio.load_config(src)) if source == "hand21"
        else configio.dump_config(cfg))


@pytest.mark.parametrize("doc, match", [
    ({"pso": {"inertial": 0.5}}, "unknown PSOConfig keys"),
    ({"fitness": {"trig": "exact"}}, "unknown FitnessConfig keys"),
    ({"model": "arm_8dof"}, "unknown model"),
])
def test_unknown_keys_raise(doc, match):
    with pytest.raises(ValueError, match=match):
        configio.load_config(doc)
    with pytest.raises(ValueError, match=match):
        jconfigio.load_config(doc)


# (b) The CLI.


def _cli(module, *args):
    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, cwd=ROOT, timeout=600, env=env)


def test_cli_solve_hand21_on_the_cpu():
    args = ("solve", "--cpu", "--config", str(CONFIG_DIR / "hand21.json"), "--particles",
            "64", "--iterations", "4", "--polish", "2")
    proc = _cli("ikpso_tpu_torch.harness.cli", *args)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    ref = _cli("ikpso_tpu.harness.cli", *args, "--impl", "jnp")
    assert ref.returncode == 0, ref.stderr
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    # JAX's keys, and the fitness that ran (the port's line names it).
    assert set(want) == {"angles", "fitness", "effector_error", "trace"}
    assert set(got) == set(want) | {"fitness_impl"} and got["fitness_impl"] == "plain"
    assert len(got["angles"]) == len(want["angles"]) == 60
    assert len(got["trace"]) == len(want["trace"]) == 5  # init + 4 iterations
    assert np.all(np.diff(got["trace"]) <= 0.0)
    # Different random streams: the bar is JAX's spread at the same setting,
    # its solver and polish on 256 copies of the problem (one swarm each,
    # independent streams): the port's one solve lies between their least
    # and greatest error, an interval that holds a new draw with
    # probability 255/257.
    from ikpso_tpu.models import library as jlib
    from ikpso_tpu.pso.polish import wrap_with_polish
    from ikpso_tpu.pso.solver import make_solver

    cfg = jconfigio.load_config(str(CONFIG_DIR / "hand21.json"))
    pso = dataclasses.replace(cfg.pso, iterations=4)
    solver = wrap_with_polish(make_solver(cfg.spec, pso=pso, fit=cfg.fitness,
                                          num_particles=64), cfg.spec, steps=2)
    batch = jlib.batched_problem(cfg.problem, jnp.broadcast_to(cfg.problem.targets,
                                                               (256, 5, 3)))
    errs = np.asarray(jax.jit(solver)(batch, jax.random.key(1)).effector_error)
    assert errs.min() <= got["effector_error"] <= errs.max(), (got["effector_error"],
                                                              errs.min(), errs.max())


def _embedded_scene(path):
    """The scene JSON an exported page embeds."""
    html = Path(path).read_text()
    start = html.index("const SCENE = ") + len("const SCENE = ")
    return json.loads(html[start:html.index(";\n", start)])


@pytest.mark.parametrize("source", ["arm7_box_gjk", "hand21", "reference_arm"])
def test_scene_dict_matches_jax(source, tmp_path):
    from ikpso_tpu.viz.render import chain_segments as j_segments
    from ikpso_tpu.viz.render import scene_dict as j_scene
    from ikpso_tpu_torch.viz import render

    src = str(CONFIG_DIR / f"{source}.json") if source != "reference_arm" else {
        "model": source}
    cfg, jcfg = configio.load_config(src), jconfigio.load_config(src)
    swarm = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    got = render.scene_dict(cfg.spec, cfg.problem, cfg.obstacles, swarm_positions=swarm)
    want = j_scene(jcfg.spec, jcfg.problem, jcfg.obstacles, swarm_positions=swarm)
    assert set(got) == set(want)
    assert (got["parents"], got["effectors"]) == (want["parents"], want["effectors"])
    arrays = {k: v for k, v in {**got, **got.get("obstacles", {})}.items()
              if k not in ("parents", "effectors", "obstacles")}
    for key, value in arrays.items():
        np.testing.assert_allclose(value, want.get(key, want.get("obstacles", {}).get(key)),
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(
        render.chain_segments(cfg.spec, cfg.problem.pose, cfg.problem.origin),
        j_segments(jcfg.spec, jcfg.problem.pose, jcfg.problem.origin), atol=1e-6)
    page = render.export_html(cfg.spec, cfg.problem, str(tmp_path / "s.html"),
                              obstacles=cfg.obstacles)
    assert _embedded_scene(page) == json.loads(json.dumps(
        render.scene_dict(cfg.spec, cfg.problem, cfg.obstacles)))
    pytest.importorskip("matplotlib")
    assert render.plot_scene(cfg.spec, cfg.problem, cfg.obstacles,
                             path=str(tmp_path / "s.png")) is not None
    assert (tmp_path / "s.png").stat().st_size > 0


def test_cli_refusals(tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(["solve", "--cpu", "--preset", "--config",
                  str(CONFIG_DIR / "hand21.json")])
    with pytest.raises(SystemExit, match="needs the card"):
        cli.main(["solve", "--cpu", "--impl", "fused"])
    # viz is ported: the page it writes embeds JAX's scene_dict of the
    # same document (tests/test_torch_configs.py::test_scene_dict_matches_jax).
    from ikpso_tpu.viz.render import scene_dict as j_scene

    out = tmp_path / "scene.html"
    cli.main(["viz", "--cpu", "--config", str(CONFIG_DIR / "dual_arm_box.json"),
              "--out", str(out)])
    jcfg = jconfigio.load_config(str(CONFIG_DIR / "dual_arm_box.json"))
    got = _embedded_scene(out)
    want = j_scene(jcfg.spec, jcfg.problem, obstacles=jcfg.obstacles)
    assert set(got) == set(want) and got["parents"] == want["parents"]
    np.testing.assert_allclose(got["nodes"], want["nodes"], atol=1e-6)
    np.testing.assert_allclose(got["obstacles"]["centers"], want["obstacles"]["centers"])


def test_cli_picks_kernel_a_where_it_fits(monkeypatch):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    hand = configio.load_config(str(CONFIG_DIR / "hand21.json"))
    ref = configio.load_config({"model": "reference_arm"})
    assert cli.pick_impl("auto", hand, cuda) == "fused"  # 512 <= the scratch bound
    assert cli.pick_impl("auto", ref, cuda) == "jnp"  # 16,384 particles: kernel C
    assert cli.pick_impl("auto", hand, cpu) == "jnp"
    assert cli.pick_impl("jnp", hand, cuda) == "jnp"
    with pytest.raises(SystemExit, match="multiple of 32"):
        cli.pick_impl("fused", ref, cuda)


def test_cli_solve_preset_and_default_json_line(capsys, torch_single_thread):
    assert cli.main(["solve", "--cpu", "--model", "arm_7dof", "--preset"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["angles"]) == 9 and out["effector_error"] < 0.05
    assert len(out["trace"]) == 9


# (c) The batched configurations on the CPU.


@pytest.mark.parametrize("name", DOCUMENTS)
def test_run_config_on_the_cpu(name, torch_single_thread):
    cfg = json.loads((CONFIG_DIR / f"{name}.json").read_text())
    cfg["num_particles"] = 64
    cfg["pso"]["iterations"] = 2
    out = configs.run_config(cfg, swarms=8, polish=1, device="cpu", warmup=0, iters=1)
    assert out["finite"] and out["impl"] == "jnp" and out["swarms"] == 8
    if name == "dual_arm_box":
        assert out["colliding_solutions"] == 0 and 0.0 < out["frac_targets_feasible"] <= 1.0
    if name == "arm7_box_gjk":
        # The GJK scene runs the plain fitness; the anchor pose misses the
        # boxes, so no solution may hit one under either collider.
        assert out["fitness_impl"] == "plain-gjk"
        assert out["colliding_solutions"] == out["colliding_solutions_gjk"] == 0


# The bars of chip_smoke.py's configuration phases.


def order_statistic_interval(n, q, conf):
    from test_torch_zoo import order_statistic_interval as f

    return f(n, q, conf)


def jax_config_bar(name: str, swarms: int = 1024, seed: int = 0, conf: float = 0.99,
                   jit: bool = True):
    """JAX on ``swarms`` reachable targets of a document: ``load_config``,
    ``make_solver`` (the scan solver), ``wrap_with_polish`` with the
    document's scene; targets the effectors of uniform in-limit angles
    from a numpy seed, scored on the feasible ones (generating pose
    collision-free). Returns p50 / p90 (mm), their ``conf``
    distribution-free intervals, the count at >= 1 mm and, with a scene,
    the feasible share and the colliding solutions. ``jit=False`` runs
    the same program op by op (``jax.disable_jit``): XLA's compiled CPU
    code does not round op by op, and where the solutions sit at the
    float32 noise floor (~0.1-0.3 um) the two evaluations' p50 differ by
    more than either interval is wide (:func:`main`)."""
    if not jit:
        with jax.disable_jit():
            return jax_config_bar(name, swarms, seed, conf)
    from ikpso_tpu.models import library as jlib
    from ikpso_tpu.ops import fk as jfk
    from ikpso_tpu.ops.collision import get_chain_collider
    from ikpso_tpu.pso.polish import wrap_with_polish
    from ikpso_tpu.pso.solver import make_solver

    cfg = jconfigio.load_config(str(CONFIG_DIR / f"{name}.json"))
    spec, problem = cfg.spec, cfg.problem
    rng = np.random.default_rng(seed)
    lo = np.asarray(spec.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec.max_rotation[1:]).reshape(-1)
    ang = (lo + rng.random((swarms, spec.dof)) * (hi - lo)).astype(np.float32)
    pose = jfk.angles_to_pose(spec, jnp.broadcast_to(problem.pose[0], (swarms, 3)),
                              jnp.asarray(ang))
    targets = jfk.fk_points(spec, pose, problem.origin)[:, list(spec.effector_idx)]
    fit = cfg.fitness

    def collides(p):
        pos, rot = jfk.fk(spec, p, problem.origin)
        return np.asarray(get_chain_collider(fit.collision_backend, fit.collision_shape)(
            pos[..., 1:, :], rot[..., 1:, :, :], pos[..., list(spec.parent[1:]), :],
            spec.length[1:], cfg.obstacles.center, cfg.obstacles.half_extent,
            cfg.obstacles.rot, gizmo_size=fit.gizmo_size))

    feasible = np.ones(swarms, bool) if cfg.obstacles is None else ~collides(pose)
    solver = make_solver(spec, pso=cfg.pso, fit=fit, obstacles=cfg.obstacles,
                         num_particles=cfg.num_particles)
    solver = wrap_with_polish(solver, spec, steps=POLISH[name], obstacles=cfg.obstacles,
                              collision_backend=fit.collision_backend,
                              collision_shape=fit.collision_shape,
                              gizmo_size=fit.gizmo_size)
    res = jax.jit(solver)(jlib.batched_problem(problem, targets), jax.random.key(seed))
    err = np.asarray(res.effector_error).astype(np.float64) * 1000.0
    scored = np.sort(err[feasible])
    out = {"config": name, "swarms": swarms, "scored": int(scored.size), "conf": conf,
           "polish": POLISH[name], "failures_ge_1mm": int((scored >= 1.0).sum())}
    for q in (0.5, 0.9):
        r_lo, r_hi = order_statistic_interval(scored.size, q, conf)
        key = f"p{round(q * 100)}"
        out[f"{key}_err_mm"] = float(np.percentile(scored, q * 100))
        out[f"{key}_interval_mm"] = (float(scored[r_lo - 1]), float(scored[r_hi - 1]))
    if cfg.obstacles is not None:
        out["frac_targets_feasible"] = float(feasible.mean())
        out["colliding_solutions"] = int((collides(res.pose) & feasible).sum())
    return out


# The op-by-op evaluation's batch, where 1,024 targets take too long: JAX's
# GJK runs ~50x slower op by op than compiled on a CPU (~13 min at 256).
OP_BY_OP_SWARMS = {"arm7_box_gjk": 256}


def config_bar(name: str) -> dict:
    """A configuration's bar: JAX compiled and op by op on the same
    targets and key; the port's p50 and p90 must lie in the hull of the
    two evaluations' 99% intervals. On hand21 JAX's own two p50s (0.192
    and 0.214 um) fall outside each other's intervals: at the float32
    noise floor the quantile measures rounding, and the reference's
    rounding is not one thing."""
    runs = {"jit": jax_config_bar(name),
            "op_by_op": jax_config_bar(name, OP_BY_OP_SWARMS.get(name, 1024), jit=False)}
    out = {"config": name, **{k: v for k, v in runs["jit"].items()
                              if k not in ("config", "p50_err_mm", "p90_err_mm",
                                           "p50_interval_mm", "p90_interval_mm")}}
    for q in ("p50", "p90"):
        ends = [end for r in runs.values() for end in r[f"{q}_interval_mm"]]
        out[f"{q}_bar_mm"] = (min(ends), max(ends))
        for tag, r in runs.items():
            out[f"{q}_{tag}"] = (r[f"{q}_err_mm"], r[f"{q}_interval_mm"])
    out["failures_ge_1mm_op_by_op"] = runs["op_by_op"]["failures_ge_1mm"]
    out["swarms_op_by_op"] = runs["op_by_op"]["swarms"]
    return out


def main() -> None:
    """``JAX_PLATFORMS=cpu python tests/test_torch_configs.py [name ...]``:
    print each configuration's bar (:func:`config_bar`) as one JSON line
    (~10 min for the first four; arm7_box_gjk ~20 min on its own)."""
    for name in sys.argv[1:] or DOCUMENTS:
        print(json.dumps(config_bar(name)), flush=True)


if __name__ == "__main__":
    main()


def test_new_modules_import_without_jax():
    # The slice's modules, and the entry point run as a user runs it, load
    # with jax and the JAX package made unimportable.
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'ikpso_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import ikpso_tpu_torch.utils.configio, ikpso_tpu_torch.harness.cli\n"
            "import ikpso_tpu_torch.harness.configs, ikpso_tpu_torch.utils.kernels\n"
            "import ikpso_tpu_torch.ops.gjk, ikpso_tpu_torch.viz.render\n"
            "import ikpso_tpu_torch.parallel.mesh, ikpso_tpu_torch.parallel.sharded\n"
            "import ikpso_tpu_torch.parallel.distributed, ikpso_tpu_torch.utils.profiling\n"
            "import chip_smoke\n"
            "from ikpso_tpu_torch.harness import cli\n"
            "sys.exit(cli.main(['solve', '--cpu', '--config', sys.argv[1], '--particles', "
            "'32', '--iterations', '1']))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(CONFIG_DIR / "arm7_exact.json")],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # JAX's keys, and the fitness that ran (a CPU run: the plain one).
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(line) == {"angles", "fitness", "effector_error", "trace", "fitness_impl"}
    assert line["fitness_impl"] == "plain"
