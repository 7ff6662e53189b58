"""Carry state across from the JAX package to the port.

Builds the port's ``ChainSpec``, ``IKProblem``, ``PSOConfig`` and
``FitnessConfig`` from the JAX package's objects. The objects are read
only through ``np.asarray(getattr(obj, name))`` and dataclass fields,
so this module imports no jax: it is how the tests feed both packages
identical state (the port's "weights carried across").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem, make_chain_spec
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.pso.config import PSOConfig


def _tensor(obj, name, device):
    return torch.as_tensor(
        np.array(np.asarray(getattr(obj, name)), np.float32), device=device
    )


def chain_spec_from(spec, device="cpu") -> ChainSpec:
    """Port ``ChainSpec`` from a JAX ``ChainSpec``."""
    return make_chain_spec(
        parent=tuple(spec.parent),
        length=np.asarray(getattr(spec, "length")),
        min_rotation=np.asarray(getattr(spec, "min_rotation")),
        max_rotation=np.asarray(getattr(spec, "max_rotation")),
        effector_idx=tuple(spec.effector_idx),
        effector_weight=np.asarray(getattr(spec, "effector_weight")),
        device=device,
    )


def problem_from(problem, device="cpu") -> IKProblem:
    """Port ``IKProblem`` from a JAX ``IKProblem`` (any batch shape)."""
    return IKProblem(
        pose=_tensor(problem, "pose", device),
        origin=_tensor(problem, "origin", device),
        targets=_tensor(problem, "targets", device),
        target_rot=(
            None if problem.target_rot is None
            else _tensor(problem, "target_rot", device)
        ),
    )


def _dataclass_from(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def pso_config_from(pso) -> PSOConfig:
    """Port ``PSOConfig`` from a JAX ``PSOConfig`` (same field names)."""
    return _dataclass_from(PSOConfig, pso)


def fitness_config_from(fit) -> FitnessConfig:
    """Port ``FitnessConfig`` from a JAX ``FitnessConfig``."""
    return _dataclass_from(FitnessConfig, fit)
