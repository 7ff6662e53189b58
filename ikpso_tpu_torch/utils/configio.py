"""Runtime configuration: JSON <-> dataclasses, chain specs as data.

Port of ``ikpso_tpu/utils/configio.py`` (``RunConfig``, ``load_config``,
``dump_config``, ``_model_from_config``): the same schema, defaults and
unknown-key errors, with a ``device`` for the tensors it builds. The
schema (every section optional):

  {
    "model": "reference_arm" | "planar_3dof" | ... | "snake:<links>" |
        {"parent": [...], "length": [...], "min_rotation": ...,
         "max_rotation": ..., "effector_idx": [...], "effector_weight": [...],
         "pose": [...], "origin": [...], "targets": [...], "target_rot": [...]},
    "pso": {PSOConfig fields},
    "fitness": {FitnessConfig fields},
    "num_particles": 16384,
    "obstacles": {"centers": [...], "full_dims": [...], "quats": [...]}
  }

Any tree, the distance term and ``trig_impl`` run through the port's
kernels on the card: ``utils.kernels`` builds what the prebuilt library
lacks on demand.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.models.chain import ChainSpec, IKProblem, Obstacles, make_chain_spec
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.pso.config import PSOConfig

_MODELS = {
    "reference_arm": library.reference_arm,
    "planar_3dof": library.planar_3dof,
    "arm_6dof": library.arm_6dof,
    "arm_7dof": library.arm_7dof,
    "dual_arm_14dof": library.dual_arm_14dof,
    "snake_30dof": library.snake_30dof,
    "humanoid_45dof": library.humanoid_45dof,
}


@dataclasses.dataclass
class RunConfig:
    spec: ChainSpec
    problem: IKProblem
    pso: PSOConfig
    fitness: FitnessConfig
    num_particles: int
    obstacles: Optional[Obstacles]


def _dataclass_from_dict(cls, data: Dict[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - fields
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    return cls(**data)


def _model_from_config(model, device="cpu") -> Tuple[ChainSpec, IKProblem]:
    if isinstance(model, str):
        if model.startswith("snake:"):
            return library.snake(int(model.split(":", 1)[1]), device=device)
        if model not in _MODELS:
            raise ValueError(
                f"unknown model {model!r}; available: "
                f"{sorted(_MODELS)} or 'snake:<links>'"
            )
        return _MODELS[model](device=device)
    spec = make_chain_spec(
        parent=model["parent"],
        length=model["length"],
        min_rotation=model["min_rotation"],
        max_rotation=model["max_rotation"],
        effector_idx=model["effector_idx"],
        effector_weight=model.get("effector_weight"),
        device=device,
    )
    n = spec.num_nodes

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    target_rot = model.get("target_rot")
    problem = IKProblem(
        pose=f32(model.get("pose", np.zeros((n, 3)))),
        origin=f32(model.get("origin", (0.0, 0.0, 0.0))),
        targets=f32(model["targets"]),
        target_rot=None if target_rot is None else f32(target_rot),
    )
    return spec, problem


def load_config(source, device="cpu") -> RunConfig:
    """Build a RunConfig from a dict, JSON string, or JSON file path, its
    tensors on ``device``."""
    if isinstance(source, str):
        if source.strip().startswith("{"):
            data = json.loads(source)
        else:
            with open(source) as f:
                data = json.load(f)
    else:
        data = dict(source)

    spec, problem = _model_from_config(data.get("model", "reference_arm"), device)
    pso = _dataclass_from_dict(PSOConfig, data.get("pso", {}))
    fitness = _dataclass_from_dict(FitnessConfig, data.get("fitness", {}))
    obstacles = None
    if "obstacles" in data and data["obstacles"]:
        ob = data["obstacles"]
        obstacles = Obstacles.from_boxes(ob["centers"], ob["full_dims"], ob.get("quats"),
                                         device=device)
    return RunConfig(
        spec=spec,
        problem=problem,
        pso=pso,
        fitness=fitness,
        num_particles=int(data.get("num_particles", 16384)),
        obstacles=obstacles,
    )


def _tolist(t) -> list:
    return t.detach().cpu().numpy().tolist()


def dump_config(cfg: RunConfig) -> str:
    """Serialize a RunConfig back to JSON (custom-model form)."""
    spec, problem = cfg.spec, cfg.problem
    doc = {
        "model": {
            "parent": list(spec.parent),
            "length": _tolist(spec.length),
            "min_rotation": _tolist(spec.min_rotation),
            "max_rotation": _tolist(spec.max_rotation),
            "effector_idx": list(spec.effector_idx),
            "effector_weight": _tolist(spec.effector_weight),
            "pose": _tolist(problem.pose),
            "origin": _tolist(problem.origin),
            "targets": _tolist(problem.targets),
        },
        "pso": {
            "inertia": float(cfg.pso.inertia),
            "cognitive": float(cfg.pso.cognitive),
            "social": float(cfg.pso.social),
            "iterations": cfg.pso.iterations,
            "inertia_mode": cfg.pso.inertia_mode,
            "init_mode": cfg.pso.init_mode,
            "init_velocity_scale": float(cfg.pso.init_velocity_scale),
            "inertia_end": float(cfg.pso.inertia_end),
            "gbest_interval": cfg.pso.gbest_interval,
            "rekick_interval": cfg.pso.rekick_interval,
            "rekick_scale": float(cfg.pso.rekick_scale),
            "rekick_threshold": float(cfg.pso.rekick_threshold),
        },
        "fitness": {
            "angle_weight": float(cfg.fitness.angle_weight),
            "distance_weight": float(cfg.fitness.distance_weight),
            "orientation_weight": float(cfg.fitness.orientation_weight),
            "error_threshold": float(cfg.fitness.error_threshold),
            "collision_backend": cfg.fitness.collision_backend,
            "collision_shape": cfg.fitness.collision_shape,
            "trig_impl": cfg.fitness.trig_impl,
            "fk_impl": cfg.fitness.fk_impl,
        },
        "num_particles": cfg.num_particles,
    }
    if problem.target_rot is not None:
        doc["model"]["target_rot"] = _tolist(problem.target_rot)
    if cfg.obstacles is not None and cfg.obstacles.count:
        doc["obstacles"] = {
            "centers": _tolist(cfg.obstacles.center),
            "full_dims": _tolist(cfg.obstacles.half_extent * 2.0),
        }
    return json.dumps(doc, indent=2)
