"""The reference's own protocol in the port against the JAX package.

(a) The locality polish gate (``pso/polish.py::wrap_with_polish`` with
    ``locality_weight``) picks the same rows as JAX's on ``arm_6dof`` with a
    box scene, across locality weight x orientation rows. The base solver
    is a stub that returns the perturbed starts and reports an error of -1
    on the even rows: the error gate (no locality) keeps those, the cost
    gate polishes them; the scene rejects the rows whose polished pose
    ends in a box. Masks exact; the gate's residual costs rtol 1e-5;
    angles atol 5e-4 (kernel A's replay bar, tests/test_fused.py:257):
    with orientation and locality rows from starts 0.15 rad off, an LM
    step accepted on a few ulps of difference moves a row by up to 3e-4.
(b) ``frames_to_converge``'s mechanics exactly: both packages get one
    scripted sequence of solve results (JAX's ``make_solver`` and the
    port's ``harness.trajectory.build_solver`` monkeypatched) and one float32 FK for the
    motion statistics (``tests/oracle.py``), so frames, final errors,
    the merged chunk statistics, ``summary()`` and the diagnostics files
    must be equal to the bit.
(c) With the real solvers on ``planar_3dof`` at 64 trials, P=64: the
    frame-count distributions agree (KS p > 0.01).
(d) ``harness/parity.py``: ``ks_2samp``, ``bootstrap_mean_diff_ci`` and
    ``compare_distributions`` equal JAX's on the same arrays;
    ``load_reference_frames`` equal on a workbook written here; both
    raise ``FileNotFoundError`` on a missing workbook.
(e) The CLI's ``experiment`` and ``parity`` on the CPU, and every new
    subcommand's refusal without ``--cpu`` when no card is visible.
(f) The frames' generator seeds follow the independent and session
    protocols; ``impl="fused"`` and ``run_reference_experiment`` on the CPU.
"""

import contextlib
import io
import json
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikpso_tpu.harness import experiment as jexp
from ikpso_tpu.harness import parity as jparity
from ikpso_tpu.models import library as jlib
from ikpso_tpu.models.chain import Obstacles as JObstacles
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.ops import rotations as jrot
from ikpso_tpu.ops.fitness import FitnessConfig as JFit
from ikpso_tpu.pso.config import PSOConfig as JPSO
from ikpso_tpu.pso.polish import residual_cost as j_cost
from ikpso_tpu.pso.polish import wrap_with_polish as j_wrap
from ikpso_tpu.pso.polish_soa import true_effector_error_rows as j_err_rows
from ikpso_tpu.pso.solver import SolveResult as JResult
from ikpso_tpu.utils.diagnostics import DiagnosticsWriter as JDiag
from ikpso_tpu_torch.harness import cli, experiment, parity, trajectory
from ikpso_tpu_torch.models import convert
from ikpso_tpu_torch.models.chain import Obstacles
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.pso.polish import residual_cost, wrap_with_polish
from ikpso_tpu_torch.pso.polish_soa import true_effector_error_rows
from ikpso_tpu_torch.pso.solver import SolveResult
from ikpso_tpu_torch.utils.diagnostics import DiagnosticsWriter
from ikpso_tpu_torch.utils.guards import SolveDivergedError, check_solve_result
from oracle import fk_positions_oracle

from test_torch_fused import torch_single_thread  # noqa: F401  (fixture)

ATOL = 1e-4
GATE_ATOL = 5e-4


def _gate_case(s=32, seed=40, noise=0.15):
    """arm_6dof: targets and target rotations from random in-limit poses,
    starts ``noise`` rad off them, one box on each of the first four
    targets."""
    spec_j, problem_j = jlib.arm_6dof()
    rng = np.random.default_rng(seed)
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    truth = (lo + rng.random((s, spec_j.dof)) * (hi - lo)).astype(np.float32)
    pose = jfk.angles_to_pose(spec_j, jnp.broadcast_to(problem_j.pose[0], (s, 3)),
                              jnp.asarray(truth))
    eff = list(spec_j.effector_idx)
    pos, rot = jfk.fk(spec_j, pose, problem_j.origin)
    batched_j = jlib.batched_problem(
        problem_j, pos[:, eff],
        target_rot=jrot.quaternion_to_euler_xyz(jrot.matrix_to_quaternion(rot[:, eff])))
    start = np.clip(truth + rng.normal(0, noise, truth.shape), lo, hi).astype(np.float32)
    boxes = dict(centers=np.asarray(pos[:4, eff[0]], np.float32),
                 full_dims=np.full((4, 3), 0.3, np.float32))
    return spec_j, batched_j, start, boxes


@pytest.mark.parametrize("orientation", [False, True])
@pytest.mark.parametrize("locality", [0.0, 0.05, 0.5])
def test_locality_gate_picks_jax_rows(locality, orientation):
    spec_j, batched_j, start, boxes = _gate_case()
    s = start.shape[0]
    even = np.arange(s) % 2 == 0

    def j_stub(problem, key):
        del key
        ang = jnp.asarray(start)
        err = jnp.where(jnp.asarray(even), -1.0, j_err_rows(spec_j, problem, ang))
        return JResult(angles=ang, fitness=err, effector_error=err,
                       pose=jfk.angles_to_pose(spec_j, problem.pose[:, 0], ang),
                       trace=err[None])

    spec = convert.chain_spec_from(spec_j)
    batched = convert.problem_from(batched_j)

    def stub(problem, generator):
        del generator
        ang = torch.as_tensor(start)
        err = torch.where(torch.as_tensor(even), torch.full((), -1.0),
                          true_effector_error_rows(spec, problem, ang))
        return SolveResult(angles=ang, fitness=err, effector_error=err,
                           pose=fk_ops.angles_to_pose(spec, problem.pose[:, 0], ang),
                           trace=err[None])

    kw = dict(steps=4, use_orientation=orientation, locality_weight=locality)
    want = j_wrap(j_stub, spec_j, obstacles=JObstacles.from_boxes(**boxes), **kw)(
        batched_j, jax.random.key(0))
    got = wrap_with_polish(stub, spec, obstacles=Obstacles.from_boxes(**boxes), **kw)(
        batched, torch.Generator())
    took = np.any(got.angles.numpy() != start, axis=-1)
    j_took = np.any(np.asarray(want.angles) != start, axis=-1)
    np.testing.assert_array_equal(took, j_took)
    np.testing.assert_allclose(got.angles.numpy(), np.asarray(want.angles), atol=GATE_ATOL)
    np.testing.assert_allclose(got.effector_error.numpy(),
                               np.asarray(want.effector_error), atol=GATE_ATOL)
    # Every gate kind decided some row each way.
    assert took.any() and (~took).any()
    if locality:
        # The cost gate polishes rows the error gate would keep.
        assert took[even].any()
        cost_kw = dict(use_orientation=orientation, locality_weight=locality)
        np.testing.assert_allclose(
            residual_cost(spec, batched, got.angles, **cost_kw).numpy(),
            np.asarray(j_cost(spec_j, batched_j, want.angles, **cost_kw)), rtol=1e-5)
    else:
        assert not took[even].any()


# ---------------------------------------------------------------- (b) --


def _oracle_fk_points(spec, pose, origin):
    """float32 node positions from the float64 oracle, for either package's
    arrays: both experiments then read the same motion statistics."""
    pose = np.asarray(pose.numpy() if isinstance(pose, torch.Tensor) else pose, np.float64)
    origin = np.asarray(origin.numpy() if isinstance(origin, torch.Tensor) else origin,
                        np.float64)
    parent = list(spec.parent)
    length = np.asarray(spec.length.numpy() if isinstance(spec.length, torch.Tensor)
                        else spec.length, np.float64)
    out = np.stack([fk_positions_oracle(parent, length, p, o)
                    for p, o in zip(pose.reshape(-1, *pose.shape[-2:]),
                                    np.broadcast_to(origin, pose.shape[:-2] + (3,))
                                    .reshape(-1, 3))])
    return out.reshape(pose.shape[:-2] + out.shape[-2:]).astype(np.float32)


def _scripted(chunk: int, frame: int, n: int, dof: int, eps: float):
    """Frame ``frame`` of batch ``chunk``: angles, and errors that reach
    ``eps`` at a per-trial frame (never for the last trial of a batch)."""
    conv = np.random.default_rng(chunk).integers(1, 9, size=n)
    conv[-1] = 10_000
    rng = np.random.default_rng(1000 * chunk + frame)
    angles = rng.uniform(-3.0, 3.0, size=(n, dof)).astype(np.float32)
    err = np.where(frame >= conv, rng.uniform(0.0, eps, n),
                   eps + rng.uniform(1e-3, 1.0, n)).astype(np.float32)
    return angles, err


@pytest.mark.parametrize("trials,trial_batch,rng_mode", [
    (6, None, "independent"), (7, 3, "independent"), (7, 3, "session")])
def test_frames_to_converge_mechanics_equal_jax(monkeypatch, tmp_path, trials,
                                                trial_batch, rng_mode):
    spec_j, problem_j = jlib.arm_7dof()
    spec, problem = convert.chain_spec_from(spec_j), convert.problem_from(problem_j)
    reset = np.asarray(problem_j.targets) + 0.3
    eps = 0.025

    def j_factory(*args, **kw):
        chunk = len(j_calls)
        j_calls.append(0)

        def solve(prob, key):
            j_calls[chunk] += 1
            ang, err = _scripted(chunk, j_calls[chunk], prob.pose.shape[0], spec_j.dof, eps)
            pose = jfk.angles_to_pose(spec_j, prob.pose[:, 0], jnp.asarray(ang))
            return JResult(angles=jnp.asarray(ang), fitness=jnp.asarray(err), pose=pose,
                           effector_error=jnp.asarray(err), trace=jnp.asarray(err)[None])
        return solve

    def factory(*args, **kw):
        chunk = len(calls)
        calls.append(0)

        def solve(prob, generator):
            assert isinstance(generator, torch.Generator)
            calls[chunk] += 1
            ang, err = _scripted(chunk, calls[chunk], prob.pose.shape[0], spec.dof, eps)
            ang, err = torch.as_tensor(ang), torch.as_tensor(err)
            pose = fk_ops.angles_to_pose(spec, prob.pose[:, 0], ang)
            return SolveResult(angles=ang, fitness=err, pose=pose, effector_error=err,
                               trace=err[None])
        return solve

    j_calls, calls = [], []
    monkeypatch.setattr(jexp, "make_solver", j_factory)
    monkeypatch.setattr(jfk, "fk_points", _oracle_fk_points)
    monkeypatch.setattr(trajectory, "build_solver", factory)
    monkeypatch.setattr(experiment, "fk_points", _oracle_fk_points)
    kw = dict(num_particles=64, eps_dist=eps, max_frames=12, trials=trials,
              trial_batch=trial_batch, rng_mode=rng_mode)
    with JDiag(str(tmp_path / "jax")) as jd:
        want = jexp.frames_to_converge(spec_j, problem_j, reset, jax.random.key(3),
                                       diagnostics=jd, **kw)
    with DiagnosticsWriter(str(tmp_path / "port")) as d:
        got = experiment.frames_to_converge(spec, problem, reset, 3, diagnostics=d, **kw)

    assert j_calls == calls and len(calls) == (1 if trial_batch is None else 3)
    np.testing.assert_array_equal(got.frames, want.frames)
    assert (got.frames == -1).sum() == len(calls)
    np.testing.assert_array_equal(got.final_error, want.final_error)
    assert got.angle_delta == want.angle_delta
    assert got.pos_delta == want.pos_delta
    timing = ("solves_per_second", "wall_time_s")
    assert ({k: v for k, v in got.summary().items() if k not in timing}
            == {k: v for k, v in want.summary().items() if k not in timing})
    for name in ("degrees", "positions", "frames", "distance"):
        port_file = tmp_path / "port" / f"IK-diagnostics-{name}.txt"
        assert port_file.read_bytes() == (tmp_path / "jax" / port_file.name).read_bytes()
    assert (tmp_path / "port" / "IK-diagnostics-frames.txt").read_text().strip()


def test_frames_to_converge_validates_every_frame(monkeypatch):
    spec_j, problem_j = jlib.arm_7dof()
    spec, problem = convert.chain_spec_from(spec_j), convert.problem_from(problem_j)

    def factory(*args, **kw):
        def solve(prob, generator):
            ang = torch.full((prob.pose.shape[0], spec.dof), float("nan"))
            err = torch.ones(prob.pose.shape[0])
            return SolveResult(angles=ang, fitness=err, pose=prob.pose,
                               effector_error=err, trace=err[None])
        return solve

    monkeypatch.setattr(trajectory, "build_solver", factory)
    with pytest.raises(SolveDivergedError, match="frame 1"):
        experiment.frames_to_converge(spec, problem, problem.targets, 0, trials=2)


def test_guards_match_jax():
    from ikpso_tpu.utils.guards import SolveDivergedError as JDiverged
    from ikpso_tpu.utils.guards import check_solve_result as j_check

    good = dict(angles=np.zeros((2, 3), np.float32), fitness=np.ones(2, np.float32),
                effector_error=np.ones(2, np.float32))
    res = SolveResult(pose=None, trace=None,
                      **{k: torch.as_tensor(v) for k, v in good.items()})
    check_solve_result(res)
    rejected = dict(good, fitness=np.asarray([1.0, 3.4028235e38], np.float32))
    with pytest.warns(RuntimeWarning, match="1 swarm"):
        j_check(JResult(pose=None, trace=None, **rejected))
    with pytest.warns(RuntimeWarning, match="1 swarm"):
        check_solve_result(SolveResult(pose=None, trace=None, **{
            k: torch.as_tensor(v) for k, v in rejected.items()}))
    bad = dict(good, effector_error=np.asarray([np.inf, 1.0], np.float32))
    with pytest.raises(JDiverged, match="1 non-finite values in 'effector_error'"):
        j_check(JResult(pose=None, trace=None, **bad), context="x")
    with pytest.raises(SolveDivergedError,
                       match=r"diverged \(x\): 1 non-finite values in 'effector_error'"):
        check_solve_result(SolveResult(pose=None, trace=None, **{
            k: torch.as_tensor(v) for k, v in bad.items()}), context="x")


# ---------------------------------------------------------------- (c) --


@pytest.mark.parametrize("angle_weight", [0.0, 3.0])
def test_frames_distribution_matches_jax(torch_single_thread, angle_weight):
    # planar_3dof from its canonical pose to a target 1.4 units away, 64
    # trials of 64 particles, 15 randomized-inertia iterations.
    spec_j, problem_j = jlib.planar_3dof(target=(1.5, 1.5, 0.0))
    reset = np.asarray([[0.5, 2.2, 0.0]], np.float32)
    pso, fit = JPSO(), JFit(angle_weight=angle_weight)
    kw = dict(num_particles=64, trials=64, max_frames=200)
    want = jexp.frames_to_converge(spec_j, problem_j, reset, jax.random.key(0),
                                   pso=pso, fit=fit, **kw)
    got = experiment.frames_to_converge(
        convert.chain_spec_from(spec_j), convert.problem_from(problem_j), reset, 0,
        pso=convert.pso_config_from(pso), fit=convert.fitness_config_from(fit), **kw)
    assert (got.frames > 0).all() and (want.frames > 0).all()
    _, p = parity.ks_2samp(want.frames, got.frames)
    assert p > 0.01, (np.bincount(want.frames), np.bincount(got.frames))


# ---------------------------------------------------------------- (d) --


@pytest.mark.parametrize("seed,n_a,n_b", [(0, 194, 64), (1, 20, 256), (2, 76, 76)])
def test_parity_statistics_equal_jax(seed, n_a, n_b):
    rng = np.random.default_rng(seed)
    a = rng.geometric(0.3, n_a).astype(float)
    b = rng.geometric(0.25, n_b).astype(float)
    assert parity.ks_2samp(a, b) == jparity.ks_2samp(a, b)
    assert (parity.bootstrap_mean_diff_ci(a, b, n_boot=2000)
            == jparity.bootstrap_mean_diff_ci(a, b, n_boot=2000))
    assert parity.compare_distributions(a, b) == jparity.compare_distributions(a, b)


def _workbook(path):
    """A workbook in results.xlsx's layout: column A of sheets 4, 7 and 10
    (FRAMES_1/2/3), a shared-string header, FRAMES_1 leading with a 0."""
    cols = {"sheet4": [0, 3, 1, 12, 2], "sheet7": ["h", 4, 2, 31], "sheet10": ["h", 33, 11]}
    with zipfile.ZipFile(path, "w") as z:
        for sheet, vals in cols.items():
            cells = "".join(
                f'<c r="A{i}" t="s"><v>0</v></c>' if isinstance(v, str)
                else f'<c r="A{i}"><v>{v}</v></c><c r="B{i}"><v>99</v></c>'
                for i, v in enumerate(vals, start=1))
            z.writestr(f"xl/worksheets/{sheet}.xml",
                       f"<worksheet><sheetData><row>{cells}</row></sheetData></worksheet>")


def test_load_reference_frames_equals_jax(tmp_path):
    _workbook(tmp_path / "results.xlsx")
    got = parity.load_reference_frames(str(tmp_path / "results.xlsx"))
    want = jparity.load_reference_frames(str(tmp_path / "results.xlsx"))
    assert got.keys() == want.keys() == {"iter1", "iter2", "iter3"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["iter1"], [3, 1, 12, 2])
    with pytest.raises(FileNotFoundError):
        jparity.load_reference_frames(str(tmp_path / "missing.xlsx"))
    with pytest.raises(FileNotFoundError):
        parity.load_reference_frames(str(tmp_path / "missing.xlsx"))


# ---------------------------------------------------------------- (e) --


def _cli(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(argv) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_cli_experiment_on_cpu(torch_single_thread, tmp_path):
    lines = _cli(["experiment", "--cpu", "--model", "planar_3dof", "--trials", "5",
                  "--trial-batch", "2", "--particles", "32", "--max-frames", "60",
                  "--polish", "2", "--outdir", str(tmp_path)])
    summary = lines[-1]
    assert summary["trials"] == 5 and summary["converged"] == 5
    assert summary["angle_delta"]["n"] > 0 and summary["frames_min"] >= 1
    frames = (tmp_path / "IK-diagnostics-frames.txt").read_text().split()
    assert len(frames) == 1 and int(frames[0]) >= 1
    degrees = (tmp_path / "IK-diagnostics-degrees.txt").read_text().splitlines()
    assert len(degrees) == int(frames[0])


def test_cli_parity_fails_on_the_missing_workbook_like_jax(monkeypatch, tmp_path):
    from ikpso_tpu.harness import cli as jcli

    missing = str(tmp_path / "results.xlsx")
    monkeypatch.setattr(jparity.load_reference_frames, "__defaults__", (missing,))
    with pytest.raises(FileNotFoundError) as want:
        jcli.main(["parity", "--cpu", "--trials", "2"])
    with pytest.raises(FileNotFoundError) as got:
        cli.main(["parity", "--cpu", "--trials", "2", "--xlsx", missing])
    assert str(got.value) == str(want.value)
    # The default workbook lies inside the checkout, never beside it.
    root = Path(__file__).resolve().parents[1]
    default = cli.build_parser().parse_args(["parity"]).xlsx
    assert default == parity.REFERENCE_XLSX
    assert Path(default).resolve().is_relative_to(root)


def test_cli_parity_on_a_workbook(tmp_path, torch_single_thread):
    _workbook(tmp_path / "results.xlsx")
    # iter2 (warm init, no locality) at 256 particles: 2 of 3 trials reach
    # the 0.025 bar within 40 frames.
    lines = _cli(["parity", "--cpu", "--trials", "3", "--particles", "256",
                  "--max-frames", "40", "--protocols", "iter2", "--xlsx",
                  str(tmp_path / "results.xlsx"), "--out",
                  str(tmp_path / "rec.jsonl")])
    rec = lines[-1]["results"]["iter2"]
    assert lines[-1]["metric"] == "parity" and rec["ref_n"] == 3
    assert rec["ours_n"] + rec["unconverged"] == 3 and rec["ours_n"] >= 1
    assert json.loads((tmp_path / "rec.jsonl").read_text())["results"] == lines[-1]["results"]


@pytest.mark.parametrize("name", ["experiment", "parity", "sweep", "track"])
def test_cli_runs_on_the_card_unless_cpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device is visible"):
        cli.main([name])


def test_protocol_configs_match_jax_cli():
    for name in cli.PROTOCOLS:
        pso, fit = cli.protocol_configs(name)
        assert pso.inertia_mode == "randomized" and pso.iterations == 15
        assert (pso.inertia, pso.cognitive, pso.social) == (0.5, 0.5, 1.25)
        assert fit.angle_weight == {"iter1": 0.0, "iter2": 0.0, "iter3": 3.0}[name]
        assert pso.init_mode == ("uniform" if name == "iter1" else "warm")
    assert cli.protocol_configs("iter2", "struct")[0].iterations == 10


@pytest.mark.parametrize("rng_mode", ["independent", "session"])
def test_frame_streams_follow_the_seed_protocol(monkeypatch, rng_mode):
    # Session: one stream, frame c of the whole call seeded fold_in(seed, c)
    # across batches (JAX's fold_in(session_key, counter)). Independent:
    # batch k splits the carried seed, each frame splits its batch's.
    from ikpso_tpu_torch.utils import seeds

    spec_j, problem_j = jlib.arm_7dof()
    spec, problem = convert.chain_spec_from(spec_j), convert.problem_from(problem_j)
    used = []

    def factory(*args, **kw):
        def solve(prob, generator):
            used.append(generator.initial_seed())
            n = prob.pose.shape[0]
            err = torch.full((n,), 0.03 if len(used) % 3 else 0.01)
            ang = fk_ops.pose_to_angles(spec, prob.pose)
            return SolveResult(angles=ang, fitness=err, pose=prob.pose, effector_error=err,
                               trace=err[None])
        return solve

    monkeypatch.setattr(trajectory, "build_solver", factory)
    res = experiment.frames_to_converge(spec, problem, problem.targets, 5, trials=5,
                                        trial_batch=2, max_frames=9, rng_mode=rng_mode)
    np.testing.assert_array_equal(res.frames, [3, 3, 3, 3, 3])
    assert len(used) == 9  # three batches of three frames
    if rng_mode == "session":
        assert used == [seeds.fold_in(5, c) for c in range(9)]
    else:
        want, carry = [], 5
        for _ in range(3):
            carry, batch = seeds.split(carry)
            for _ in range(3):
                batch, sub = seeds.split(batch)
                want.append(sub)
        assert used == want


def test_fused_impl_and_reference_experiment_on_cpu(torch_single_thread, monkeypatch):
    # impl="fused" runs kernel A's plain twin on CPU tensors; the shipped
    # experiment runs on the card unless asked for the CPU.
    spec_j, problem_j = jlib.planar_3dof(target=(1.5, 1.5, 0.0))
    spec, problem = convert.chain_spec_from(spec_j), convert.problem_from(problem_j)
    res = experiment.frames_to_converge(
        spec, problem, torch.tensor([[0.5, 2.2, 0.0]]), 0, trials=4, num_particles=64,
        max_frames=40, impl="fused", pso=convert.pso_config_from(JPSO()),
        fit=convert.fitness_config_from(JFit(angle_weight=0.0)))
    assert (res.frames > 0).all() and res.summary()["converged"] == 4
    ref = experiment.run_reference_experiment(0, trials=2, num_particles=64, max_frames=2,
                                              trial_batch=1, device="cpu")
    assert ref.frames.shape == (2,) and np.isfinite(ref.final_error).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiment.run_reference_experiment(0, trials=1)
