"""The frozen counts and configurations against the port as it is today:
every count at each cell's shapes equals ``utils/flops.py``'s, and each
configuration's model and recipe equal the port's library and presets."""

import numpy as np
import pytest
import torch

from benchmark.core import loader
from benchmark.reference import counts

from ikpso_tpu_torch.harness.cli import protocol_configs  # noqa: E402
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.ops.fitness_kernel import MetaLayout
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.utils import flops
from ikpso_tpu_torch.utils.kernels import step_threads

LIBRARY = {"arm7": library.arm_7dof, "reference_arm": library.reference_arm}


def port_pso(r):
    from benchmark.core import recipe

    return recipe.pso_config(r)


def port_fit(r):
    return FitnessConfig(angle_weight=r["angle_weight"], distance_weight=r["distance_weight"])


@pytest.mark.parametrize("name", sorted(LIBRARY))
def test_tile_counts_frozen(name):
    cfg = loader.config(name)
    spec, _ = LIBRARY[name]()
    for r in cfg["recipes"].values():
        tile = flops.fitness_tile_count(spec, port_fit(r))
        assert tile.flops == cfg["counts"]["tile_flops"]
        assert tile.transcendentals == cfg["counts"]["tile_transcendentals"]
    lay = MetaLayout(spec, 0, False)
    assert (lay.meta_size, lay.swarm_size) == (cfg["counts"]["meta_size"],
                                               cfg["counts"]["swarm_size"])
    assert step_threads(spec.dof) == cfg["counts"]["step_threads"]


def cells():
    return sorted(p.stem for p in (loader.HERE / "workloads").glob("*.json"))


@pytest.mark.parametrize("cell", cells())
def test_counts_equal_the_port_at_the_cells_shapes(cell):
    wl = loader.workload(cell)
    cfg = loader.config(wl["config"])
    r = cfg["recipes"][wl["recipe"]]
    spec, _ = LIBRARY[wl["config"]]()
    p = wl["params"]
    s = p.get("swarms", p.get("trials"))
    pso, fit = port_pso(r), port_fit(r)
    c = cfg["counts"]
    assert r["solver"] == "scan"
    want = flops.scan_step_count(spec, pso, fit, num_swarms=s,
                                 num_particles=r["particles"], improved=0, drawing=True)
    assert counts.scan_step(c, spec.dof, r, s) == (want.ops, want.bytes)


def test_scan_step_improved_rows_add_bytes():
    cfg = loader.config("arm7")
    r = cfg["recipes"]["scan"]
    spec, _ = library.arm_7dof()
    want = flops.scan_step_count(spec, port_pso(r), port_fit(r), num_swarms=16384,
                                 num_particles=1024, improved=5000, drawing=True)
    assert counts.scan_step(cfg["counts"], 9, r, 16384, improved=5000) == (want.ops, want.bytes)


@pytest.mark.parametrize("name", sorted(LIBRARY))
def test_model_equals_the_library(name):
    m = loader.config(name)["model"]
    spec, problem = LIBRARY[name]()
    assert list(spec.parent) == m["parent"]
    assert list(spec.effector_idx) == m["effector_idx"]
    np.testing.assert_array_equal(spec.length.numpy(), np.float32(m["length"]))
    np.testing.assert_array_equal(spec.min_rotation.numpy(), np.float32(m["min_rotation"]))
    np.testing.assert_array_equal(spec.max_rotation.numpy(), np.float32(m["max_rotation"]))
    np.testing.assert_array_equal(spec.effector_weight.numpy()[m["effector_idx"]],
                                  np.float32(m["effector_weight"]))
    np.testing.assert_array_equal(problem.pose.numpy(), np.float32(m["pose"]))
    np.testing.assert_array_equal(problem.origin.numpy(), np.float32(m["origin"]))
    if name == "reference_arm":
        np.testing.assert_array_equal(library.reference_reset_targets().numpy(),
                                      np.float32(m["reset_targets"]))


def test_recipes_equal_the_ports():
    arm = loader.config("arm7")["recipes"]
    # bench.py --impl pallas: the scan solver's defaults.
    scan = port_pso(arm["scan"])
    assert scan == PSOConfig(inertia_mode="randomized", iterations=60, rekick_interval=0,
                             rekick_scale=0.5, rekick_threshold=1e-6, init_mode="warm")
    pso, fit = protocol_configs("iter3")
    it3 = loader.config("reference_arm")["recipes"]["iter3"]
    assert port_pso(it3) == pso
    assert it3["angle_weight"] == fit.angle_weight and it3["distance_weight"] == 0.0


def test_peaks_are_the_ports():
    from ikpso_tpu_torch.utils.roofline import PUBLISHED_PEAKS

    assert counts.PEAK_FP32_OPS_PER_S == PUBLISHED_PEAKS["fp32_ops_per_s"]
    assert counts.PEAK_HBM_BYTES_PER_S == PUBLISHED_PEAKS["hbm_bytes_per_s"]
    assert torch.get_default_dtype() == torch.float32
