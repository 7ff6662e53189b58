"""Sharded solves of the port (ikpso_tpu_torch.parallel) in real process groups.

Each multi-rank case runs as separate OS processes joined into a gloo
process group on localhost (``spawn_ranks``: a free port, one process per
rank, a timeout on the whole group, every process killed and every group
destroyed on the way out). The ranks run the scenarios of ``WORKER`` and
save what they return; the test process holds that against JAX and
against single-process solves of the port:

  * ``distributed_argmin``: the cases of tests/test_parallel.py:66-95 on
    two ranks, with ties, which go to the lowest rank: equal to JAX's on
    a two-device mesh;
  * a 1-rank mesh equals the unsharded solve bit for bit
    (tests/test_parallel.py:96-113), with the scan solver and kernel A's
    plain twin;
  * each rank's swarm shard equals the single-process solve of that
    shard under the rank's derived seed, bit for bit, and every rank
    returns the same global result;
  * the particle-sharded solve reaches the unsharded quality bar
    (tests/test_parallel.py:36), and the 2 x 2 hybrid mesh solves (:52);
  * the sharded solver under the polish (:115) and
    ``track_trajectories(mesh=)`` (:250).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.parallel import mesh as port_mesh
from ikpso_tpu_torch.parallel.sharded import draw_seed, shard_seed, solve_sharded
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.utils import seeds

from test_torch_fused import torch_single_thread  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120

# The scenarios one rank runs; each returns a dict of arrays saved as
# ``<scenario>/<key>`` in ``rank<r>.npz``.
WORKER = r'''
import datetime, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, port, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=90))
try:
    from ikpso_tpu_torch.harness.trajectory import circle_paths, track_trajectories
    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.parallel import mesh as M
    from ikpso_tpu_torch.parallel.sharded import (distributed_argmin, draw_seed,
                                                  make_sharded_solver, shard_seed,
                                                  solve_sharded)
    from ikpso_tpu_torch.pso.config import PSOConfig
    from ikpso_tpu_torch.pso.polish import wrap_with_polish

    def planar(s, seed=0):
        spec, problem = library.planar_3dof()
        rng = np.random.default_rng(seed)
        t = problem.targets.numpy()[None] + rng.uniform(-0.4, 0.4, (s, 1, 3)) * [1, 1, 0]
        return spec, library.batched_problem(problem, torch.as_tensor(t, dtype=torch.float32))

    def result(res, mesh, seed):
        return dict(angles=res.angles, fitness=res.fitness, error=res.effector_error,
                    trace=res.trace, seed=np.int64(shard_seed(draw_seed(
                        torch.Generator().manual_seed(seed)), mesh)))

    def argmin():
        rng = np.random.default_rng(0)
        vals = rng.uniform(size=(world, 6)).astype(np.float32)
        vals[:, 0] = 0.25  # a tie across every rank: the lowest rank wins
        vals[:, 3] = vals[0, 3]
        coords = rng.normal(size=(world, 6, 3)).astype(np.float32)
        mesh = M.make_mesh((world,), (M.PARTICLE_AXIS,))
        g, c = distributed_argmin(torch.as_tensor(vals[mesh.axis_index("particle")]),
                                  torch.as_tensor(coords[mesh.axis_index("particle")]),
                                  mesh.group("particle"))
        return dict(val=g, coords=c)

    def swarm_jnp():
        spec, batched = planar(8)
        mesh = M.swarm_mesh()
        res = solve_sharded(spec, batched, torch.Generator().manual_seed(5), mesh,
                            pso=PSOConfig(iterations=10), num_particles=32)
        return result(res, mesh, 5)

    def swarm_fused():
        spec, problem = library.arm_7dof()
        rng = np.random.default_rng(7)
        t = problem.targets.numpy()[None] + 0.1 * rng.normal(size=(8, 1, 3))
        batched = library.batched_problem(problem, torch.as_tensor(t, dtype=torch.float32))
        mesh = M.swarm_mesh()
        kw = dict(pso=PSOConfig(iterations=8), fit=FitnessConfig(angle_weight=0.0),
                  num_particles=64, impl="fused")
        res = solve_sharded(spec, batched, torch.Generator().manual_seed(7), mesh, **kw)
        try:
            solve_sharded(spec, batched, torch.Generator(), M.make_mesh((world,), ("particle",)),
                          **kw)
            refused = 0
        except ValueError as e:
            refused = int("fused" in str(e))
        return dict(result(res, mesh, 7), refused=np.int64(refused))

    def particle():
        spec, batched = planar(2, seed=1)
        mesh = M.make_mesh((world,), (M.PARTICLE_AXIS,))
        res = solve_sharded(spec, batched, torch.Generator().manual_seed(0), mesh,
                            pso=PSOConfig(iterations=60), fit=FitnessConfig(angle_weight=0.0),
                            num_particles=256)
        return result(res, mesh, 0)

    def hybrid():
        spec, batched = planar(8, seed=2)
        mesh = M.hybrid_mesh(2)
        res = solve_sharded(spec, batched, torch.Generator().manual_seed(1), mesh,
                            pso=PSOConfig(iterations=30), fit=FitnessConfig(angle_weight=0.0),
                            num_particles=64)
        return dict(result(res, mesh, 1), coords=np.asarray(mesh.coords))

    def polish():
        spec, problem = library.arm_7dof()
        s = 16
        lo, hi = spec.limits().numpy()
        rng = np.random.default_rng(0)
        ang = torch.as_tensor((0.8 * lo + rng.random((s, spec.dof)) * 0.8 * (hi - lo))
                              .astype(np.float32))
        from ikpso_tpu_torch.ops import fk as fk_ops

        pose = fk_ops.angles_to_pose(spec, problem.pose[0].expand(s, 3), ang)
        targets = fk_ops.fk_points(spec, pose, problem.origin)[:, list(spec.effector_idx)]
        batched = library.batched_problem(problem, targets)
        base = make_sharded_solver(
            spec, M.swarm_mesh(), num_particles=128, fit=FitnessConfig(angle_weight=0.0),
            pso=PSOConfig(iterations=10, inertia_mode="canonical", inertia=0.5,
                          inertia_end=0.2))
        rb = base(batched, torch.Generator().manual_seed(0))
        rp = wrap_with_polish(base, spec, steps=4)(batched, torch.Generator().manual_seed(0))
        return dict(base=rb.effector_error, polished=rp.effector_error)

    def track():
        spec, problem = library.arm_7dof()
        path = circle_paths(problem.targets, steps=16, num_paths=8, seed=3, radius=0.15,
                            revolutions=0.25)
        res = track_trajectories(spec, problem, path, 5, num_particles=256,
                                 pso=PSOConfig(iterations=15, inertia_mode="canonical"),
                                 fit=FitnessConfig(angle_weight=0.3), mesh=M.swarm_mesh())
        return dict(errors=res.errors, angles=res.angles)

    saved = {}
    for name in sys.argv[6].split(","):
        for key, value in locals()[name]().items():
            saved[f"{name}/{key}"] = np.asarray(value)
    np.savez(f"{out}/rank{rank}.npz", **saved)
finally:
    dist.destroy_process_group()
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(argvs, cwd=REPO, timeout=SPAWN_TIMEOUT_S):
    """Run one process per argv (the ranks of one group), all at once;
    returns their stdouts. Any rank that fails or outlives ``timeout``
    fails the call; every process is killed on the way out."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_FLAGS")}
    env.update(OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for argv in argvs]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [o for o, _ in outs]


def run_worker(tmp, world, scenarios):
    """The ranks' saved scenario outputs, one dict per rank."""
    script = Path(tmp) / "worker.py"
    script.write_text(WORKER)
    port = free_port()
    spawn_ranks([[sys.executable, str(script), str(REPO), str(r), str(world), str(port),
                  str(tmp), ",".join(scenarios)] for r in range(world)])
    return [dict(np.load(Path(tmp) / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp("ranks2"), 2,
                      ["argmin", "swarm_jnp", "swarm_fused", "particle", "polish", "track"])


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp("ranks4"), 4, ["hybrid"])


def _planar(s, seed=0):
    spec, problem = library.planar_3dof()
    rng = np.random.default_rng(seed)
    t = problem.targets.numpy()[None] + rng.uniform(-0.4, 0.4, (s, 1, 3)) * [1, 1, 0]
    return spec, library.batched_problem(problem, torch.as_tensor(t, dtype=torch.float32))


def test_distributed_argmin_matches_jax_with_ties(two_ranks):
    from jax.sharding import PartitionSpec as P

    from ikpso_tpu.parallel.mesh import make_mesh as j_make_mesh
    from ikpso_tpu.parallel.sharded import distributed_argmin as j_argmin

    rng = np.random.default_rng(0)
    vals = rng.uniform(size=(2, 6)).astype(np.float32)
    vals[:, 0] = 0.25
    vals[:, 3] = vals[0, 3]
    coords = rng.normal(size=(2, 6, 3)).astype(np.float32)
    mesh = j_make_mesh((2,), ("particle",), devices=jax.devices()[:2])
    want_val, want_coords = jax.jit(jax.shard_map(
        lambda v, c: j_argmin(v[0], c[0], "particle"), mesh=mesh,
        in_specs=(P("particle"), P("particle")), out_specs=(P(), P())))(
            jnp.asarray(vals), jnp.asarray(coords))
    for r in two_ranks:
        np.testing.assert_array_equal(r["argmin/val"], np.asarray(want_val))
        np.testing.assert_array_equal(r["argmin/coords"], np.asarray(want_coords))
    # Ties (columns 0 and 3) take rank 0's coordinates.
    np.testing.assert_array_equal(two_ranks[0]["argmin/coords"][[0, 3]], coords[0, [0, 3]])
    first = np.argmin(vals, axis=0)
    np.testing.assert_array_equal(two_ranks[0]["argmin/coords"], coords[first, np.arange(6)])


@pytest.mark.parametrize("impl", ["jnp", "fused"])
def test_one_rank_mesh_equals_the_unsharded_solve(impl, torch_single_thread):
    # No process group: a 1-rank swarm mesh; its solve is the unsharded
    # solve under the derived seed fold_in(draw, 0), bit for bit.
    from ikpso_tpu_torch.harness.trajectory import build_solver

    if impl == "jnp":
        spec, batched = _planar(4)
    else:
        spec, problem = library.arm_7dof()
        batched = library.batched_problem(problem, problem.targets.expand(4, 1, 3) + 0.05)
    mesh = port_mesh.make_mesh()
    assert mesh.shape == {"swarm": 1} and mesh.groups == (None,)
    kw = dict(pso=PSOConfig(iterations=10), num_particles=32)
    got = solve_sharded(spec, batched, torch.Generator().manual_seed(5), mesh, impl=impl, **kw)
    seed = shard_seed(draw_seed(torch.Generator().manual_seed(5)), mesh)
    assert seed == seeds.fold_in(draw_seed(torch.Generator().manual_seed(5)), 0)
    want = build_solver(spec, impl=impl, device="cpu", **kw)(batched,
                                                             seeds.generator(seed, "cpu"))
    for field in ("angles", "fitness", "effector_error", "trace"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


@pytest.mark.parametrize("scenario", ["swarm_jnp", "swarm_fused"])
def test_each_rank_shard_equals_its_single_process_solve(two_ranks, scenario,
                                                         torch_single_thread):
    from ikpso_tpu_torch.harness.trajectory import build_solver

    if scenario == "swarm_jnp":
        spec, batched = _planar(8)
        kw = dict(pso=PSOConfig(iterations=10), num_particles=32, impl="jnp")
    else:
        spec, problem = library.arm_7dof()
        rng = np.random.default_rng(7)
        t = problem.targets.numpy()[None] + 0.1 * rng.normal(size=(8, 1, 3))
        batched = library.batched_problem(problem, torch.as_tensor(t, dtype=torch.float32))
        kw = dict(pso=PSOConfig(iterations=8), fit=FitnessConfig(angle_weight=0.0),
                  num_particles=64, impl="fused")
        assert all(r["swarm_fused/refused"] == 1 for r in two_ranks)
    r0, r1 = two_ranks
    for key in ("angles", "fitness", "error", "trace"):
        np.testing.assert_array_equal(r0[f"{scenario}/{key}"], r1[f"{scenario}/{key}"])
    assert r0[f"{scenario}/seed"] != r1[f"{scenario}/seed"]
    solver = build_solver(spec, device="cpu", **kw)
    for rank, r in enumerate(two_ranks):
        rows = slice(4 * rank, 4 * rank + 4)
        want = solver(batched.take(torch.arange(8)[rows]),
                      seeds.generator(int(r[f"{scenario}/seed"]), "cpu"))
        np.testing.assert_array_equal(r[f"{scenario}/angles"][rows], want.angles.numpy())
        np.testing.assert_array_equal(r[f"{scenario}/error"][rows],
                                      want.effector_error.numpy())
        np.testing.assert_array_equal(r[f"{scenario}/trace"][:, rows], want.trace.numpy())


def test_particle_sharded_reaches_the_unsharded_quality(two_ranks, torch_single_thread):
    # tests/test_parallel.py:36: 256 global particles over the particle
    # axis converge as one 256-particle swarm does.
    from ikpso_tpu_torch.pso.solver import solve

    r0, r1 = two_ranks
    np.testing.assert_array_equal(r0["particle/angles"], r1["particle/angles"])
    assert (r0["particle/error"] < 0.1).all(), r0["particle/error"]
    spec, batched = _planar(2, seed=1)
    whole = solve(spec, batched, torch.Generator().manual_seed(0), PSOConfig(iterations=60),
                  FitnessConfig(angle_weight=0.0), num_particles=256)
    assert (whole.effector_error.numpy() < 0.1).all()
    # The global best never worsens, and it is shared by both ranks.
    assert (np.diff(r0["particle/trace"], axis=0) <= 0).all()


def test_hybrid_mesh_solves(four_ranks):
    coords = sorted(tuple(r["hybrid/coords"]) for r in four_ranks)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in four_ranks:
        assert r["hybrid/angles"].shape == (8, 9)
        assert np.isfinite(r["hybrid/fitness"]).all()
        np.testing.assert_array_equal(r["hybrid/angles"], four_ranks[0]["hybrid/angles"])
    # The two particle ranks of a swarm block draw different streams.
    assert len({int(r["hybrid/seed"]) for r in four_ranks}) == 4


def test_sharded_solver_composes_with_polish(two_ranks):
    eb, ep = two_ranks[0]["polish/base"], two_ranks[0]["polish/polished"]
    assert (ep <= eb + 1e-6).all()
    assert np.median(ep) < 1e-4
    np.testing.assert_array_equal(ep, two_ranks[1]["polish/polished"])


def test_track_trajectories_on_a_swarm_mesh(two_ranks, torch_single_thread):
    # tests/test_parallel.py:250: each rank chains its own trajectories on
    # its own stream; the tracking quality matches the unsharded run.
    from ikpso_tpu_torch.harness.trajectory import circle_paths, track_trajectories

    spec, problem = library.arm_7dof()
    path = circle_paths(problem.targets, steps=16, num_paths=8, seed=3, radius=0.15,
                        revolutions=0.25)
    local = track_trajectories(spec, problem, path, 5, num_particles=256,
                               pso=PSOConfig(iterations=15, inertia_mode="canonical"),
                               fit=FitnessConfig(angle_weight=0.3))
    mesh_err = two_ranks[0]["track/errors"]
    assert mesh_err.shape == local.errors.shape == (16, 8)
    np.testing.assert_array_equal(mesh_err, two_ranks[1]["track/errors"])
    assert mesh_err[6:].max() < 5e-2
    assert abs(np.median(mesh_err[6:]) - np.median(local.errors[6:])) < 2e-2


def test_mesh_shapes_are_checked():
    with pytest.raises(ValueError, match="needs 2 ranks"):
        port_mesh.make_mesh((2,))
    with pytest.raises(ValueError, match="does not match"):
        port_mesh.make_mesh((1,), ("swarm", "particle"))
    spec, batched = _planar(2)
    with pytest.raises(ValueError, match="fused"):
        solve_sharded(spec, batched, torch.Generator(),
                      port_mesh.make_mesh((1,), ("particle",)), impl="fused")


def test_backend_and_device_of_a_rank():
    # gloo for host tensors and for ranks sharing a card; nccl only with a
    # card a process (none here). One process, or no coordinator: no group.
    from ikpso_tpu_torch.parallel import distributed

    assert distributed.pick_backend(2, "cpu") == "gloo"
    assert distributed.pick_backend(2, "cuda") == "gloo"  # no card visible here
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")
    assert distributed.rank_device(torch.device("cuda", 1), 0) == torch.device("cuda", 1)
    distributed.initialize(None, 2, 0)
    distributed.initialize("127.0.0.1:1", 1, 0)
    assert port_mesh.world() == (0, 1)
    with pytest.raises(ValueError, match="process_id"):
        distributed.initialize("127.0.0.1:1", 2, None)
    assert distributed.process_waypoint_slice(10) == slice(0, 10)
    np.testing.assert_array_equal(distributed.pad_to_multiple(np.arange(5), 4),
                                  [0, 1, 2, 3, 4, 4, 4, 4])
