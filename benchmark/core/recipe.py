"""The system under test, composed from a configuration's recipe.

The only module of the benchmark's core that imports ``ikpso_tpu_torch``:
it builds the port's model from the configuration's numbers and its
solver from a recipe, through the port's own entry: ``solver: "scan"`` is
``harness.trajectory.build_solver(impl="jnp")``, the scan solver
(``pso.solver``) on kernel C's fitness, packed for each problem
(``ops.fitness_kernel.make_kernel_fitness``); on the card kernel C scores
the init and each iteration is one launch of the scan step
(``csrc/scan_step.cu``).

On a CPU device the port runs the kernels' plain twins (the tests'
rehearsal); the benchmark's own entry refuses to run without a card.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def model(cfg: dict, device):
    """``(ChainSpec, IKProblem)`` of a configuration's ``model``: the
    canonical pose, origin and (where given) its reset targets."""
    from ikpso_tpu_torch.models.chain import IKProblem, make_chain_spec

    m = cfg["model"]
    spec = make_chain_spec(m["parent"], m["length"], m["min_rotation"], m["max_rotation"],
                           m["effector_idx"], m["effector_weight"], device=device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    targets = m.get("reset_targets") or [[0.0, 0.0, 0.0]] * len(m["effector_idx"])
    return spec, IKProblem(pose=f32(m["pose"]), origin=f32(m["origin"]), targets=f32(targets))


def batched(problem, targets: torch.Tensor, pose: Optional[torch.Tensor] = None):
    """The port's batched problem: one swarm a row of ``targets``
    ``(S, E, 3)``, warm-started from the canonical pose (or ``pose``)."""
    from ikpso_tpu_torch.models.library import batched_problem

    out = batched_problem(problem, targets)
    return out if pose is None else out.replace(pose=pose)


def pso_config(r: dict):
    from ikpso_tpu_torch.pso.config import PSOConfig

    kw = dict(inertia=r["inertia"], cognitive=r["cognitive"], social=r["social"],
              iterations=r["iterations"], inertia_mode=r["inertia_mode"],
              init_velocity_scale=r["init_velocity_scale"], init_mode=r["init_mode"],
              rekick_interval=r["rekick_interval"], rekick_scale=r["rekick_scale"],
              rekick_threshold=r["rekick_threshold"])
    return PSOConfig(**kw)


def fitness_config(r: dict):
    from ikpso_tpu_torch.ops.fitness import FitnessConfig

    return FitnessConfig(angle_weight=r["angle_weight"], distance_weight=r["distance_weight"],
                         orientation_weight=0.0)


def solver(spec, r: dict, device, wrap: Callable = lambda name, fn: fn) -> Callable:
    """``(problem, generator) -> SolveResult`` of recipe ``r`` on
    ``device``. ``wrap(layer, fn)`` may wrap the solver (the traced run's
    span ``"solve"``)."""
    if r["solver"] != "scan" or r["polish"] or r["retries"]:
        raise ValueError("the benchmark's recipes are the scan solver without polish or retries")
    from ikpso_tpu_torch.harness.trajectory import build_solver

    return wrap("solve", build_solver(spec, pso=pso_config(r), fit=fitness_config(r),
                                      num_particles=r["particles"], impl="jnp", device=device))
