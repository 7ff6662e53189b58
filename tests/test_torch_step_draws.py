"""The scan step's draws in plain torch (``ops/philox.py::step_uniforms``).

The drawing step (``csrc/scan_step.cuh``, REPLAY off) keys the draw of
element ``e = p * D + d`` of a swarm in slot ``t = iteration * n + k`` as
word ``e % 4`` of ``philox4x32_10((e // 4, t, 0, 0), (s0, s1))``. Held
here: the generator's known-answer vector through ``step_uniforms``, the
flat counter mapping element by element (a P * D that is no multiple of 4
included), the slots' numbering across iterations, the 2^-24 grid in
[0, 1) and a Kolmogorov-Smirnov test against U[0, 1).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy import stats

from ikpso_tpu_torch.ops.philox import bits_to_uniform, philox4x32_10, step_uniforms

SEEDS = torch.tensor([[7, -5], [0, 2**31 - 1], [-2**31, 123456789]], dtype=torch.int32)


def test_step_uniforms_known_answer_vector():
    # Random123 kat_vectors: philox4x32_10(counter 0, key 0); element e of
    # slot 0 at key (0, 0) is word e of call 0.
    u = step_uniforms(torch.zeros((1, 2), dtype=torch.int32), 0, 1, 1, 4)
    words = torch.tensor([0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8])
    assert torch.equal(u[0, 0, 0], bits_to_uniform(words))


@pytest.mark.parametrize("p,d", [(16, 9), (5, 9), (7, 21), (3, 1)])
def test_step_uniforms_flat_counter_mapping(p, d):
    n, iteration = 3, 5
    u = step_uniforms(SEEDS, iteration, n, p, d)
    assert u.shape == (n, 3, p, d) and u.dtype == torch.float32
    rng = np.random.default_rng(p * d)
    picks = [(k, s, q, j) for k, s, q, j in zip(rng.integers(0, n, 12), rng.integers(0, 3, 12),
                                                rng.integers(0, p, 12), rng.integers(0, d, 12))]
    picks.append((n - 1, 2, p - 1, d - 1))  # the last element (a partial call at 5 x 9)
    for k, s, q, j in picks:
        e = int(q) * d + int(j)
        key = [torch.tensor(int(w) & 0xFFFFFFFF) for w in SEEDS[s]]
        ctr = [torch.tensor(v) for v in (e // 4, iteration * n + int(k), 0, 0)]
        assert u[k, s, q, j] == bits_to_uniform(philox4x32_10(ctr, key)[e % 4])


def test_step_uniforms_slots_follow_iteration_times_n():
    # Block k of iteration i is slot i * n + k: iteration 2's blocks of n = 3
    # are slots 6, 7, 8, each the one-slot block of that "iteration".
    u = step_uniforms(SEEDS, 2, 3, 10, 9)
    for k in range(3):
        assert torch.equal(u[k], step_uniforms(SEEDS, 6 + k, 1, 10, 9)[0])
    assert not torch.equal(u[0], u[1])


def test_step_uniforms_on_the_grid_and_uniform():
    u = step_uniforms(torch.tensor([[1, 2], [-3, 4]], dtype=torch.int32), 11, 4, 1024, 9)
    flat = u.flatten().double()
    assert float(flat.min()) >= 0.0 and float(flat.max()) < 1.0
    scaled = flat * 2.0 ** 24
    assert torch.equal(scaled, scaled.round())  # on the 2^-24 grid
    assert stats.kstest(flat.numpy(), "uniform").pvalue > 1e-4
    # No sign-trap mass: half the draws at or above 1/2.
    assert abs(float((flat >= 0.5).double().mean()) - 0.5) < 0.01
