"""The two-process waypoint sweep of the port over torch.distributed.

Port of tests/test_multihost.py: two OS processes join one gloo process
group through a localhost rendezvous
(``ikpso_tpu_torch.parallel.distributed.initialize``); each solves its
contiguous waypoint block and the results are all-gathered
(``sweep_waypoints_multihost``). Cut: W = 1,024 waypoints in batches of
256 where JAX's test sweeps 10,240 in batches of 512 (the same planar
arm, PSO and particle count), so the pair finishes in seconds on a CPU.
Beyond JAX's checks (the partition, the identical merge on both
processes, the quality), each process's block must equal, bit for bit,
a single-process ``solve_waypoints`` of that block under the process's
derived seed. The CLI's ``sweep --multihost`` runs as two processes too.
"""

import json
import sys

import numpy as np

from ikpso_tpu_torch.harness.trajectory import solve_waypoints
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.utils import seeds

from test_torch_fused import torch_single_thread  # noqa: F401 (a fixture)
from test_torch_parallel import REPO, free_port, spawn_ranks

W, BATCH = 1024, 256
PSO = dict(iterations=20, inertia_mode="canonical", inertia=0.5, inertia_end=0.2)

WORKER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch

torch.set_num_threads(1)
repo, pid, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
from ikpso_tpu_torch.parallel import distributed

distributed.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
try:
    import torch.distributed as dist

    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    from ikpso_tpu_torch.models import library
    from ikpso_tpu_torch.ops.fitness import FitnessConfig
    from ikpso_tpu_torch.pso.config import PSOConfig

    spec, problem = library.planar_3dof()
    rng = np.random.default_rng(0)
    base = problem.targets.numpy()
    waypoints = base[None] + rng.normal(scale=0.2, size=(%(w)d,) + base.shape).astype(np.float32)
    waypoints[..., 2] = base[..., 2]  # the planar arm reaches its plane only
    merged, sl = distributed.sweep_waypoints_multihost(
        spec, problem, waypoints, 0, batch_size=%(batch)d, pso=PSOConfig(**%(pso)r),
        fit=FitnessConfig(angle_weight=0.0), num_particles=64)
    np.savez(f"{out}/p{pid}.npz", angles=merged.angles, errors=merged.errors,
             slice=np.asarray([sl.start, sl.stop]), rate=merged.solves_per_second,
             waypoints=waypoints)
finally:
    distributed.shutdown()
""" % dict(w=W, batch=BATCH, pso=PSO)


def test_two_process_sweep_partitions_and_merges(tmp_path, torch_single_thread):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = free_port()
    spawn_ranks([[sys.executable, str(script), str(REPO), str(i), str(port), str(tmp_path)]
                 for i in range(2)])
    r0, r1 = (dict(np.load(tmp_path / f"p{i}.npz")) for i in range(2))
    assert r0["slice"].tolist() == [0, W // 2] and r1["slice"].tolist() == [W // 2, W]
    # Every process holds the same complete result.
    assert r0["errors"].shape == (W,)
    np.testing.assert_array_equal(r0["angles"], r1["angles"])
    np.testing.assert_array_equal(r0["errors"], r1["errors"])
    assert np.isfinite(r0["errors"]).all()
    assert np.percentile(r0["errors"], 95) < 0.2
    assert r0["rate"] == r1["rate"] > 0
    # Each block is the single-process sweep of that block under
    # fold_in(seed, process).
    spec, problem = library.planar_3dof()
    for pid, r in enumerate((r0, r1)):
        lo, hi = r["slice"]
        want = solve_waypoints(spec, problem, r["waypoints"][lo:hi], seeds.fold_in(0, pid),
                               batch_size=BATCH, pso=PSOConfig(**PSO),
                               fit=FitnessConfig(angle_weight=0.0), num_particles=64)
        np.testing.assert_array_equal(r0["angles"][lo:hi], want.angles)
        np.testing.assert_array_equal(r0["errors"][lo:hi], want.errors)


def test_cli_sweep_multihost_prints_one_merged_result():
    port = free_port()
    argv = ["sweep", "--multihost", "--cpu", "--model", "arm_7dof", "--particles", "32",
            "--iterations", "4", "--waypoints", "48", "--batch", "16", "--coordinator",
            f"127.0.0.1:{port}", "--num-processes", "2"]
    outs = spawn_ranks([[sys.executable, "-m", "ikpso_tpu_torch.harness.cli", *argv,
                         "--process-id", str(i)] for i in range(2)])
    lines = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [ln.pop("process") for ln in lines] == [0, 1]
    assert [ln.pop("local_slice") for ln in lines] == [[0, 24], [24, 48]]
    assert lines[0] == lines[1]
    assert lines[0]["waypoints"] == 48 and lines[0]["num_processes"] == 2
