"""Per-model solver recipes.

Port of ``ikpso_tpu/pso/presets.py`` (``FusedPreset`` without the TPU's
``swarms_per_tile``; every entry, field for field, and ``snake:<links>``
sharing ``snake_30dof``'s recipe). The recipe: a short basin-finding PSO
stage (canonical inertia decaying 0.5 -> 0.2), an LM polish of each
swarm's gbest, and top-k retry rounds (shrinking buckets, diverse inits
or warm target walks, per model).
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
    # The planar arm: the headline's shape, but its residual tail is
    # wrong-basin, so its 2 retry rounds start from uniform inits (buckets
    # S/32 decaying 4x per round).
    "planar_3dof": FusedPreset(128, 8, 0, 4, 2, "uniform", swarms=1_048_576,
                               retry_bucket_decay=4),
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
    # The reference's 21-DOF experiment tree on single-shot far targets
    # (not its own protocol, which re-solves per frame): 256 particles, 100
    # iterations, no polish, no retries.
    "reference_arm": FusedPreset(256, 100, 0, 0, 0),
    # The 45-DOF, 5-effector humanoid: 16,384 swarms of 512 particles, 60
    # iterations, 6 LM steps on the tensor path, then 6 retry rounds over a
    # constant bucket of 8,192, each an 8-step warm target walk.
    "humanoid_45dof": FusedPreset(512, 60, 0, 6, 6, retry_iterations=60,
                                  retry_bucket=8192, retry_walk=8, swarms=16_384),
    # Long serial chains (snake_30dof, D=30; snake:<links> shares it): 65,536
    # swarms of 256 particles, 4 iterations with a re-kick every 2, 4 LM
    # steps, 2 warm retry rounds over S/16 decaying 4x.
    "snake_30dof": FusedPreset(256, 4, 2, 4, 2, swarms=65_536, retry_bucket_decay=4),
}


def fused_preset(model: str) -> Optional[FusedPreset]:
    """Preset for a model name (``snake:<links>`` shares ``snake_30dof``'s),
    or None."""
    if model.startswith("snake:"):
        model = "snake_30dof"
    return FUSED_PRESETS.get(model)
