"""Trajectory tracking and waypoint sweeps of the port against the JAX package.

(a) ``circle_paths`` equals JAX's to the bit.
(b) ``track_trajectories`` and ``follow_targets``: both packages' base
    solvers replaced by one deterministic stub (the warm start returned
    as the answer), so the frames' chaining, targets and origins, and the
    locality-gated LM polish are what is compared; ``arm_7dof``, S=8,
    T=6, angle_weight 0.3. Angles and errors atol 1e-4, the polish tests'
    bar (without polish, errors atol 1e-5, the row-FK bar). The follow
    stream is parsed by each package's ``_follow_updates`` from one
    ``StringIO``.
(c) ``solve_waypoints`` with the same stub, polish, a retry round and a
    checkpoint equals JAX's (atol 1e-4); with the port's real solver, a
    sweep cut off after two batches and resumed from its checkpoint
    returns exactly what an uninterrupted sweep returns.
(d) The CLI's ``track`` (circle paths and ``--follow``) and ``sweep`` on
    the CPU, and ``sweep --multihost``'s refusal.

``python tests/test_torch_trajectory.py`` prints the track bar of
``chip_smoke.py`` (``TRACK_JAX``): JAX's ``track`` on the CPU at the
card's recipe on 256 paths, ~35 s on an 8-core CPU.
"""

import contextlib
import io
import json
import sys

import jax
import numpy as np
import pytest
import torch

from ikpso_tpu.harness import cli as jcli
from ikpso_tpu.harness import trajectory as jtraj
from ikpso_tpu.models import library as jlib
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.ops.fitness import FitnessConfig as JFit
from ikpso_tpu.pso.config import PSOConfig as JPSO
from ikpso_tpu.pso.polish_soa import true_effector_error_rows as j_err_rows
from ikpso_tpu.pso.solver import SolveResult as JResult
from ikpso_tpu.utils import checkpoint as jckpt
from ikpso_tpu_torch.harness import cli, trajectory
from ikpso_tpu_torch.models import convert
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.pso.polish_soa import true_effector_error_rows
from ikpso_tpu_torch.pso.solver import SolveResult
from ikpso_tpu_torch.utils import checkpoint as ckpt
from ikpso_tpu_torch.utils import seeds

from test_torch_fused import torch_single_thread  # noqa: F401  (fixture)

ATOL = 1e-4


def _j_stub_factory(spec_j):
    def build(*args, **kw):
        def solve(prob, key):
            ang = jfk.pose_to_angles(spec_j, prob.pose)
            err = j_err_rows(spec_j, prob, ang)
            return JResult(angles=ang, fitness=err, pose=prob.pose, effector_error=err,
                           trace=err[None])
        return solve
    return build


def _stub_factory(spec):
    def build(*args, **kw):
        def solve(prob, generator):
            assert isinstance(generator, torch.Generator)
            ang = fk_ops.pose_to_angles(spec, prob.pose)
            err = true_effector_error_rows(spec, prob, ang)
            return SolveResult(angles=ang, fitness=err, pose=prob.pose,
                               effector_error=err, trace=err[None])
        return solve
    return build


@pytest.fixture
def stubbed(monkeypatch):
    """arm_7dof in both packages, each package's base solver the stub."""
    spec_j, problem_j = jlib.arm_7dof()
    spec, problem = convert.chain_spec_from(spec_j), convert.problem_from(problem_j)
    monkeypatch.setattr(jtraj, "_build_solver", _j_stub_factory(spec_j))
    monkeypatch.setattr(trajectory, "build_solver", _stub_factory(spec))
    return spec_j, problem_j, spec, problem


def test_circle_paths_equal_jax():
    targets = np.asarray([[1.0, 1.2, -0.8], [0.5, -0.1, 0.3]], np.float32)
    kw = dict(steps=7, num_paths=5, radius=0.3, revolutions=1.5, seed=4)
    got = trajectory.circle_paths(torch.as_tensor(targets), **kw)
    np.testing.assert_array_equal(got, jtraj.circle_paths(targets, **kw))
    np.testing.assert_array_equal(got[0], np.broadcast_to(targets, (5, 2, 3)))


@pytest.mark.parametrize("polish", [0, 2])
def test_track_trajectories_equal_jax(stubbed, polish):
    spec_j, problem_j, spec, problem = stubbed
    path = jtraj.circle_paths(np.asarray(problem_j.targets), steps=6, num_paths=8,
                              radius=0.25, seed=1)
    fit = JFit(angle_weight=0.3)
    want = jtraj.track_trajectories(spec_j, problem_j, path, jax.random.key(0), fit=fit,
                                    polish=polish)
    got = trajectory.track_trajectories(spec, problem, path, 0, polish=polish,
                                        fit=convert.fitness_config_from(fit))
    assert got.angles.shape == (6, 8, spec.dof) and got.final_pose.shape == (8, 4, 3)
    atol = ATOL if polish else 1e-5
    np.testing.assert_allclose(got.angles, np.asarray(want.angles), atol=atol)
    np.testing.assert_allclose(got.errors, np.asarray(want.errors), atol=atol)
    np.testing.assert_allclose(got.final_pose, np.asarray(want.final_pose), atol=atol)
    if polish:
        # The polish tracked the moving targets: errors fall along the path.
        assert got.errors[-1].mean() < 0.5 * got.errors[0].mean()


FOLLOW_STREAM = """# a comment, then every line form
[[1.0, 1.2, -0.8]]
1.05 1.15 -0.8

origin 0.1 0.0 0.0
{"targets": [[1.1, 1.1, -0.7]], "origin": [0.0, 0.05, 0.0]}
{"origin": [0.0, 0.0, 0.0]}
"""


def test_follow_targets_equal_jax(stubbed):
    spec_j, problem_j, spec, problem = stubbed
    fit = JFit(angle_weight=0.3)
    want = list(jtraj.follow_targets(
        spec_j, problem_j, jcli._follow_updates(io.StringIO(FOLLOW_STREAM)),
        jax.random.key(0), fit=fit, polish=2))
    got = list(trajectory.follow_targets(
        spec, problem, cli._follow_updates(io.StringIO(FOLLOW_STREAM)), 0,
        fit=convert.fitness_config_from(fit), polish=2))
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(5))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["angles"], w["angles"], atol=ATOL)
        np.testing.assert_allclose(g["effector_error"], w["effector_error"], atol=ATOL)
        assert ("angle_delta_max" in g) == ("angle_delta_max" in w)
        if "angle_delta_max" in g:
            assert abs(g["angle_delta_max"] - w["angle_delta_max"]) <= 2 * ATOL


@pytest.mark.parametrize("line,message", [
    ("1.0 2.0", "targets need 3\\*E floats"),
    ("origin 1 2", "origin needs exactly 3"),
    ('{"pose": [1, 2, 3]}', "expected keys"),
    ("1.0 x 2.0", "not a number"),
    ("[[1, 2, 3]]\n[[1, 2, 3], [4, 5, 6]]", "but the first update had 1"),
])
def test_follow_stream_parser_equals_jax(line, message):
    for parse in (jcli._follow_updates, cli._follow_updates):
        with pytest.raises(ValueError, match=message):
            list(parse(io.StringIO(line)))
    got = list(cli._follow_updates(io.StringIO(FOLLOW_STREAM)))
    want = list(jcli._follow_updates(io.StringIO(FOLLOW_STREAM)))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        else:
            np.testing.assert_array_equal(g, w)


def test_solve_waypoints_equal_jax(stubbed, tmp_path):
    spec_j, problem_j, spec, problem = stubbed
    rng = np.random.default_rng(5)
    waypoints = (np.asarray(problem_j.targets)[None]
                 + rng.normal(scale=0.1, size=(21, 1, 3))).astype(np.float32)
    kw = dict(batch_size=8, retries=1, polish=2)
    want = jtraj.solve_waypoints(spec_j, problem_j, waypoints, jax.random.key(0),
                                 checkpoint_path=str(tmp_path / "j.npz"), **kw)
    got = trajectory.solve_waypoints(spec, problem, waypoints, 0,
                                     checkpoint_path=str(tmp_path / "p.npz"), **kw)
    np.testing.assert_allclose(got.angles, want.angles, atol=ATOL)
    np.testing.assert_allclose(got.errors, want.errors, atol=ATOL)
    state, j_state = ckpt.load(str(tmp_path / "p.npz")), jckpt.load(str(tmp_path / "j.npz"))
    assert state.cursor == j_state.cursor == 21
    np.testing.assert_array_equal(state.angles, got.angles)
    np.testing.assert_array_equal(state.errors, got.errors)


def test_sweep_resumes_to_the_uninterrupted_result(monkeypatch, tmp_path,
                                                   torch_single_thread):
    spec, problem = (convert.chain_spec_from(jlib.arm_7dof()[0]),
                     convert.problem_from(jlib.arm_7dof()[1]))
    rng = np.random.default_rng(6)
    waypoints = (problem.targets.numpy()[None]
                 + rng.normal(scale=0.2, size=(40, 1, 3))).astype(np.float32)
    kw = dict(num_particles=32, batch_size=16, retries=1, polish=1,
              pso=convert.pso_config_from(JPSO(iterations=4)))
    whole = trajectory.solve_waypoints(spec, problem, waypoints, 11, **kw)

    path = str(tmp_path / "sweep.npz")
    real_save, saves = ckpt.save, []

    def save_then_stop(p, state):
        real_save(p, state)
        saves.append(state.cursor)
        if len(saves) == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(ckpt, "save", save_then_stop)
    with pytest.raises(KeyboardInterrupt):
        trajectory.solve_waypoints(spec, problem, waypoints, 11, checkpoint_path=path, **kw)
    assert saves == [16, 32] and ckpt.load(path).cursor == 32
    assert np.isinf(ckpt.load(path).errors[32:]).all()
    # A different seed on resume: the checkpoint's carried seed wins.
    resumed = trajectory.solve_waypoints(spec, problem, waypoints, 99,
                                         checkpoint_path=path, **kw)
    assert saves == [16, 32, 40]
    np.testing.assert_array_equal(resumed.angles, whole.angles)
    np.testing.assert_array_equal(resumed.errors, whole.errors)
    assert np.isfinite(whole.errors).all()


def test_checkpoint_round_trip(tmp_path):
    state = ckpt.fresh_state(5, 9, seed=2**62 + 3)
    j_state = jckpt.fresh_state(5, 9, jax.random.key(0))
    assert state.angles.shape == j_state.angles.shape and state.cursor == 0
    assert state.errors.dtype == j_state.errors.dtype and np.isinf(state.errors).all()
    state.angles[:2] = 1.5
    state.cursor = 2
    path = str(tmp_path / "sub" / "ck.npz")
    ckpt.save(path, state)
    back = ckpt.load(path)
    assert back.cursor == 2 and back.seed == 2**62 + 3
    np.testing.assert_array_equal(back.angles, state.angles)
    assert ckpt.load(str(tmp_path / "none.npz")) is None


def test_seeds_split_and_fold_are_deterministic_and_distinct():
    assert seeds.split(7) == seeds.split(7)
    carry, sub = seeds.split(7)
    assert len({7, carry, sub}) == 3 and 0 <= min(carry, sub)
    assert max(carry, sub) < 2**63
    folds = [seeds.fold_in(7, c) for c in range(100)]
    assert len(set(folds)) == 100 and folds == [seeds.fold_in(7, c) for c in range(100)]
    a = torch.rand(4, generator=seeds.generator(sub, "cpu"))
    assert torch.equal(a, torch.rand(4, generator=seeds.generator(sub, "cpu")))


def _cli(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(argv) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_cli_track_and_follow_on_cpu(torch_single_thread, tmp_path):
    common = ["--cpu", "--model", "arm_7dof", "--particles", "32", "--iterations", "4",
              "--rekick-interval", "2", "--polish", "2", "--angle-weight", "0.3"]
    line, = _cli(["track", *common, "--paths", "4", "--steps", "8", "--timeit"])
    assert (line["steps"], line["paths"], line["settle"]) == (8, 4, 2)
    assert line["err_p50_settled"] <= line["err_p95_settled"] <= line["err_max_settled"]
    assert line["solves_per_second"] > 0 and line["angle_delta_max"] > 0
    stream = tmp_path / "updates.txt"
    stream.write_text(FOLLOW_STREAM)
    lines = _cli(["track", *common, "--follow", str(stream), "--settle", "1"])
    assert [r["step"] for r in lines[:-1]] == list(range(5))
    assert lines[-1]["steps"] == 5 and lines[-1]["settle"] == 1


def test_cli_sweep_on_cpu(torch_single_thread, tmp_path):
    argv = ["sweep", "--cpu", "--model", "arm_7dof", "--particles", "32", "--iterations",
            "4", "--waypoints", "20", "--batch", "8", "--retries", "1",
            "--checkpoint", str(tmp_path / "ck.npz")]
    line, = _cli(argv)
    assert line["waypoints"] == 20 and line["err_p50"] <= line["err_p95"]
    assert ckpt.load(str(tmp_path / "ck.npz")).cursor == 20
    # A finished checkpoint: the rerun solves nothing and returns its errors.
    again, = _cli(argv)
    assert again["err_mean"] == line["err_mean"] and again["solves_per_second"] == 0.0
    # --multihost in one process sweeps the whole set as process 0 of 1;
    # the two-process run is tests/test_torch_multihost.py.
    one, = _cli(argv[:-2] + ["--multihost", "--num-processes", "1", "--seed", "3"])
    assert (one.pop("process"), one.pop("num_processes"), one.pop("local_slice")) == (
        0, 1, [0, 20])
    assert one["waypoints"] == 20 and np.isfinite(one["err_mean"])


# The card's track recipe (docs/PERFORMANCE.md:982-992, bench record
# r5-track): arm_7dof, the preset (P=128, canonical inertia 0.5 -> 0.2,
# polish 4), 8 iterations with a re-kick every 4, angle_weight 0.3, circle
# paths of radius 0.25 over 100 steps.
TRACK_ARGS = ("--model", "arm_7dof", "--preset", "--rekick-interval", "4",
              "--angle-weight", "0.3", "--steps", "100")


def per_path_settled_mm(errors, settle: int) -> dict:
    """Each path's settled (steps ``settle`` on) p50 and p95 effector error
    in mm: one value per path, shape (paths,) each."""
    settled = np.asarray(errors)[settle:] * 1000.0
    return {"p50": np.percentile(settled, 50, axis=0),
            "p95": np.percentile(settled, 95, axis=0)}


def track_bar(paths: int = 256, conf: float = 0.99) -> dict:
    """JAX's ``track`` on the CPU (the scan solver) at :data:`TRACK_ARGS`:
    the median over paths of each path's settled p50 and p95 effector
    error (mm), and the ``conf`` distribution-free interval of each median.
    The paths are the independent units (a path's steps are not), so each
    path gives one value of each statistic and the interval is read on
    those ``paths`` values at the order-statistic ranks for the median at
    n = ``paths``."""
    from test_torch_zoo import order_statistic_interval

    seen = []
    real = jtraj.track_trajectories

    def recording(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    jtraj.track_trajectories = recording
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            jcli.main(["track", "--cpu", "--impl", "jnp", "--paths", str(paths), *TRACK_ARGS])
    finally:
        jtraj.track_trajectories = real
    line = json.loads(out.getvalue().splitlines()[-1])
    per_path = per_path_settled_mm(seen[-1].errors, line["settle"])
    lo, hi = order_statistic_interval(paths, 0.5, conf)
    res = {"paths": paths, "conf": conf, "settle": line["settle"], "ranks": (lo, hi),
           "pooled_p50_settled_mm": line["err_p50_settled"] * 1000.0}
    for key, values in per_path.items():
        values = np.sort(values)
        res[f"{key}_settled_mm"] = float(np.median(values))
        res[f"{key}_interval_mm"] = (float(values[lo - 1]), float(values[hi - 1]))
    return res


def main() -> None:
    """``JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py``: print the
    track bar as one JSON line."""
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    print(json.dumps(track_bar()), flush=True)


if __name__ == "__main__":
    main()
