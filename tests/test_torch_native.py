"""The port's native host runtime (``ikpso_tpu_torch/native``) and the
float64 oracles.

(a) The binding of ``native/ikpso_native.cpp``: the tree builder, the
    float64 host FK and effector error, the four diagnostics streams
    (byte for byte the Python writer's), as ``tests/test_native.py`` holds
    the JAX package's binding. The port builds its own copy under
    ``build/ikpso_tpu_torch/``; eight threads building into one empty
    directory at once each load a whole library.
(b) The port's FK and fitness against ``tests/oracle.py``'s float64
    ``fk_positions_oracle`` / ``fitness_oracle`` (atol 1e-4 and relative
    1e-4, the bars of tests/test_fk.py:43 and tests/test_fitness.py:20)
    and against the native FK (atol 5e-5, tests/test_native.py:44).
"""

import threading

import numpy as np
import pytest
import torch

from ikpso_tpu_torch import native
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops.fitness import FitnessConfig, fitness, true_effector_error
from ikpso_tpu_torch.utils.diagnostics import DiagnosticsWriter
from oracle import fitness_oracle, fk_positions_oracle

MODELS = ("reference_arm", "arm_7dof", "humanoid_45dof")


def _model(name):
    return getattr(library, name)()


def test_tree_builder_flattens_to_chain_spec():
    t = native.NodeTree()
    j1 = t.add_joint(0, 1.0, limits=(-1.0, 1.0))
    j2 = t.add_joint(j1, 0.5)
    e1 = t.add_effector(j2, 0.75, weight=2.0)
    e2 = t.add_effector(j2, 0.25, weight=0.5)  # a tree: two children of j2
    spec = t.to_chain_spec()
    assert spec.parent == (-1, 0, 1, 2, 2) and spec.effector_idx == (e1, e2)
    np.testing.assert_allclose(spec.length.numpy(), [0, 1.0, 0.5, 0.75, 0.25])
    np.testing.assert_allclose(spec.effector_weight.numpy(), [0, 0, 0, 2.0, 0.5])
    np.testing.assert_allclose(spec.min_rotation.numpy()[1], [-1.0] * 3)
    with pytest.raises(ValueError, match="invalid parent"):
        t.add_joint(parent=9, length=1.0)


@pytest.mark.parametrize("name", MODELS)
def test_chain_spec_round_trips_through_the_native_tree(name):
    spec, _ = _model(name)
    back = native.tree_from_chain_spec(spec).to_chain_spec()
    assert back.parent == spec.parent and back.effector_idx == spec.effector_idx
    for field in ("length", "min_rotation", "max_rotation", "effector_weight"):
        np.testing.assert_array_equal(getattr(back, field).numpy(),
                                      getattr(spec, field).numpy())


@pytest.mark.parametrize("name", MODELS)
def test_fk_matches_oracle_and_native_fk(name, rng):
    spec, problem = _model(name)
    tree = native.tree_from_chain_spec(spec)
    n = spec.num_nodes
    for _ in range(5):
        pose = rng.uniform(-np.pi, np.pi, size=(n, 3)).astype(np.float32)
        origin = rng.uniform(-1, 1, size=3).astype(np.float32)
        ours = fk_ops.fk_points(spec, torch.as_tensor(pose), torch.as_tensor(origin)).numpy()
        oracle = fk_positions_oracle(spec.parent, spec.length.numpy().astype(np.float64),
                                     pose.astype(np.float64), origin)
        np.testing.assert_allclose(ours, oracle, atol=1e-4)
        np.testing.assert_allclose(ours, tree.fk(pose, origin), atol=5e-5)
    poses = rng.uniform(-1, 1, size=(8, n, 3))
    batch = tree.fk_batch(poses, np.zeros(3))
    assert batch.shape == (8, n, 3)
    for b in range(8):
        np.testing.assert_allclose(batch[b], tree.fk(poses[b]), atol=1e-12)


def test_fitness_matches_oracle(rng):
    spec, problem = library.reference_arm()
    cfg = FitnessConfig(angle_weight=3.0, distance_weight=0.7)
    for _ in range(5):
        angles = rng.uniform(0, 2 * np.pi, size=(spec.dof,)).astype(np.float32)
        ours = float(fitness(spec, torch.as_tensor(angles), problem, config=cfg))
        ref = fitness_oracle(
            spec.parent, spec.length.numpy().astype(np.float64),
            problem.pose.numpy().astype(np.float64), problem.origin.numpy(), angles,
            spec.effector_idx, [1.0, 1.0, 1.0], problem.targets.numpy(),
            angle_weight=3.0, distance_weight=0.7)
        assert abs(ours - ref) / max(abs(ref), 1.0) < 1e-4


@pytest.mark.parametrize("name", MODELS)
def test_native_effector_error_is_oracle(name, rng):
    spec, problem = _model(name)
    tree = native.tree_from_chain_spec(spec)
    pose = rng.uniform(-np.pi, np.pi, size=(spec.num_nodes, 3)).astype(np.float32)
    ours = float(true_effector_error(spec, torch.as_tensor(pose), problem))
    theirs = tree.effector_error(pose, problem.origin, problem.targets)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    with pytest.raises(ValueError, match="targets"):
        tree.effector_error(pose, problem.origin, np.zeros((spec.num_effectors + 1, 3)))


def test_native_diagnostics_equal_python_writer(tmp_path):
    angles = np.asarray([0.25, -1.5, 3.0])
    positions = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    writer = native.make_diagnostics_writer(str(tmp_path / "nat"))
    assert isinstance(writer, native.NativeDiagnostics)
    with writer as d:
        d.log_frame(torch.as_tensor(angles), positions, 0.125)
        d.log_convergence(42)
    with DiagnosticsWriter(str(tmp_path / "py")) as d:
        d.log_frame(angles, positions, 0.125)
        d.log_convergence(42)
    for stream in ("positions", "degrees", "frames", "distance"):
        nat = (tmp_path / "nat" / f"IK-diagnostics-{stream}.txt").read_text()
        py = (tmp_path / "py" / f"IK-diagnostics-{stream}.txt").read_text()
        assert nat == py, f"{stream}: {nat!r} != {py!r}"
    # Append mode, as the reference's streams.
    with native.NativeDiagnostics(str(tmp_path / "nat")) as d:
        d.log_convergence(7)
    assert (tmp_path / "nat" / "IK-diagnostics-frames.txt").read_text() == "42\n7\n"


def test_eight_threads_building_at_once_each_load_a_whole_library(tmp_path):
    barrier = threading.Barrier(8)
    results = [None] * 8

    def build_and_load(i):
        barrier.wait(timeout=60)
        try:
            lib = native.load(tmp_path)
            tree = lib.ik_tree_create()
            results[i] = lib.ik_tree_num_nodes(tree)
            lib.ik_tree_destroy(tree)
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            results[i] = e

    threads = [threading.Thread(target=build_and_load, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert results == [0] * 8, results
    # One library, and no temporary file left behind.
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path(tmp_path).name]


def test_the_port_builds_its_own_library():
    # Never the JAX package's native/libikpso_native.so: the port's copy
    # sits in its build directory under a name that carries the hash.
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libikpso_native-")
    assert native.BUILD_DIR.parts[-2:] == ("build", "ikpso_tpu_torch")
    assert native.available() and native.load_error() is None
