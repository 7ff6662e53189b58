"""Ancestry mask of the analytic Jacobian.

Port of ``ikpso_tpu/ops/jacobian.py::ancestry_mask`` only; the SoA LM
polish (``pso/polish_soa.py``) builds its Jacobian rows itself.
``fk_with_jacobian`` waits (ROADMAP queue A item 9).
"""

from __future__ import annotations

import numpy as np

from ikpso_tpu_torch.models.chain import ChainSpec


def ancestry_mask(spec: ChainSpec) -> np.ndarray:
    """``(E, N-1)`` float mask: 1 where node k is on the path to effector e."""
    mask = np.zeros((spec.num_effectors, spec.num_nodes - 1), np.float32)
    for ei, node in enumerate(spec.effector_idx):
        k = node
        while k > 0:
            mask[ei, k - 1] = 1.0
            k = spec.parent[k]
    return mask
