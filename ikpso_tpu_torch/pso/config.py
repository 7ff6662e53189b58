"""PSO hyperparameters.

Port of ``ikpso_tpu/pso/config.py::PSOConfig`` (same fields, defaults
and validation). The fused kernel supports only the main-path subset;
``pso/fused.py`` refuses the rest.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PSOConfig:
    """Swarm-update hyperparameters (see the JAX ``PSOConfig`` for the
    meaning of each field)."""

    inertia: float = 0.5
    cognitive: float = 0.5
    social: float = 1.25
    iterations: int = 15
    inertia_mode: str = "randomized"
    init_velocity_scale: float = 1.0
    init_mode: str = "warm"
    inertia_end: float = -1.0
    gbest_interval: int = 1
    rekick_interval: int = 0
    rekick_scale: float = 1.0
    rekick_threshold: float = -1.0

    def __post_init__(self):
        if self.inertia_mode not in ("randomized", "canonical"):
            raise ValueError(f"unknown inertia_mode: {self.inertia_mode!r}")
        if self.init_mode not in ("warm", "uniform", "hybrid"):
            raise ValueError(f"unknown init_mode: {self.init_mode!r}")
        if self.inertia_end >= 0.0 and self.inertia_mode != "canonical":
            raise ValueError("inertia_end requires inertia_mode='canonical'")
        if self.rekick_interval < 0:
            raise ValueError("rekick_interval must be >= 0")

    def inertia_at(self, iteration):
        """Inertia coefficient for iteration ``iteration`` (linear decay
        from ``inertia`` to ``inertia_end`` when the schedule is on)."""
        if self.inertia_end < 0.0:
            return self.inertia
        span = float(max(self.iterations - 1, 1))
        frac = iteration / span
        return self.inertia + (self.inertia_end - self.inertia) * frac
