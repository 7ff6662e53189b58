"""Per-model solver recipes.

Port of ``ikpso_tpu/pso/presets.py`` (``FusedPreset`` without the TPU's
``swarms_per_tile``, and the ``arm_7dof`` and ``arm_6dof`` entries). The recipe: a short
basin-finding PSO stage (canonical inertia decaying 0.5 -> 0.2), an
SoA LM polish of each swarm's gbest, and top-k retry rounds with
geometrically shrinking buckets. The other models' presets wait for
ROADMAP queue A item 8.
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
}


def fused_preset(model: str) -> Optional[FusedPreset]:
    """Preset for a model name, or None."""
    return FUSED_PRESETS.get(model)
