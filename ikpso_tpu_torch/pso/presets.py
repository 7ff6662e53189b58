"""Per-model solver recipes.

Port of ``ikpso_tpu/pso/presets.py`` (``FusedPreset`` without the TPU's
``swarms_per_tile``; the ``arm_7dof``, ``arm_6dof``, ``dual_arm_14dof``
and ``humanoid_45dof`` entries, field for field). The recipe: a short
basin-finding PSO stage (canonical inertia decaying 0.5 -> 0.2), an LM
polish of each swarm's gbest, and top-k retry rounds (shrinking buckets,
diverse inits or warm target walks, per model). The ``planar_3dof``,
``reference_arm`` and ``snake_30dof`` presets wait for ROADMAP queue A
item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FusedPreset:
    """One model's recipe for the fused solver (fields as in JAX)."""

    particles: int
    iterations: int
    rekick_interval: int
    polish: int
    retries: int
    retry_init_mode: Optional[str] = None
    retry_iterations: Optional[int] = None
    retry_bucket: Optional[int] = None
    retry_walk: Optional[int] = None
    retry_walk_jitter: float = 0.0
    retry_bucket_decay: int = 1
    rekick_scale: float = 0.5
    rekick_threshold: float = 1e-6
    inertia: float = 0.5
    inertia_end: float = 0.2
    swarms: int = 262_144


FUSED_PRESETS = {
    # The headline: 1,048,576 swarms of 128 particles, 8 PSO iterations,
    # 4 LM steps, 4 retry rounds with buckets S/32 decaying 8x per round.
    "arm_7dof": FusedPreset(128, 8, 0, 4, 4, swarms=1_048_576,
                            retry_bucket_decay=8),
    # Position + orientation (the exactly determined 6-DOF task): 262,144
    # swarms of 128 particles, 40 iterations with a re-kick every 20, 4 LM
    # steps with orientation rows, then 20 uniform-init retry rounds of 80
    # iterations over a constant bucket (its wrong-basin failures do not
    # shrink geometrically).
    "arm_6dof": FusedPreset(128, 40, 20, 4, 20, "uniform", retry_iterations=80),
    # Two 7-DOF arms on one origin (D=18, two effectors): 262,144 swarms of
    # 1,024 particles, 8 iterations with a re-kick every 4, 4 LM steps,
    # then 4 hybrid-init retry rounds over a constant bucket.
    "dual_arm_14dof": FusedPreset(1024, 8, 4, 4, 4, "hybrid"),
    # The 45-DOF, 5-effector humanoid: 16,384 swarms of 512 particles, 60
    # iterations, 6 LM steps on the tensor path, then 6 retry rounds over a
    # constant bucket of 8,192, each an 8-step warm target walk.
    "humanoid_45dof": FusedPreset(512, 60, 0, 6, 6, retry_iterations=60,
                                  retry_bucket=8192, retry_walk=8, swarms=16_384),
}


def fused_preset(model: str) -> Optional[FusedPreset]:
    """Preset for a model name, or None."""
    return FUSED_PRESETS.get(model)
