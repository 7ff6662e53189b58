"""Philox4x32-10 in plain torch, and the bits -> U[0, 1) map.

No JAX counterpart: the TPU megakernel draws from the core's own PRNG
(``ikpso_tpu/pso/fused.py::_uniform``). On the GPU the fused kernel
(``csrc/fused_solve.cu``) runs a counter-based Philox4x32-10 in
registers; this module is the same generator in torch, so the plain
solver (``pso/fused.py::fused_solve_plain``) and the kernel draw the
same bits from the same seeds.

Generator: Philox4x32-10 as in Random123 (Salmon et al., SC'11).
Per round, with multipliers M0 = 0xD2511F53, M1 = 0xCD9E8D57:
``(hi0, lo0) = M0 * c0``, ``(hi1, lo1) = M1 * c2``,
``c = (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)``; the key is bumped by
``(0x9E3779B9, 0xBB67AE85)`` between rounds (9 bumps for 10 rounds).

Counter -> output mapping (the kernel uses it identically): the draw
of DOF ``d`` for particle ``p`` in draw slot ``t`` of a swarm with
seed words ``(s0, s1)`` is output word ``d % 4`` of

    philox4x32_10(counter=(p, t, d // 4, 0), key=(s0, s1))

with seed words read as unsigned 32-bit. Draw slots follow the TPU
kernel's order: slot 0 is the initial-velocity draw, then for
iteration ``i`` slot ``1 + 2i`` is u_cognitive and ``2 + 2i`` u_social.

Bits -> U[0, 1): ``(bits >> 8) * 2**-24`` with a LOGICAL shift on
unsigned bits. An arithmetic shift of int32 bits maps the top half of
the range to [-0.5, 0) (``ikpso_tpu/pso/fused.py:87-96``).
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * m``; ``a`` int64 in [0, 2**32).

    Split into 16-bit halves of ``m`` so no int64 product overflows.
    """
    p_lo = a * (m & 0xFFFF)  # < 2**48
    p_hi = a * (m >> 16)  # < 2**48
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (p_hi >> 16) + (t >> 32), t & MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding unsigned 32-bit words.

    ``counter`` is 4 tensors, ``key`` 2 tensors, all broadcastable;
    returns the 4 output words.
    """
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """U[0, 1) float32 from 32-bit words (int32 or int64 storage):
    the top 24 bits, shifted logically, times 2**-24."""
    u32 = bits.to(torch.int64) & MASK32
    return (u32 >> 8).to(torch.float32) * (2.0 ** -24)


def philox_uniform(seeds: torch.Tensor, slot: int, num_particles: int,
                   dof: int) -> torch.Tensor:
    """``(S, P, D)`` uniforms of draw ``slot`` for swarms with ``(S, 2)``
    int32 seed words, by the counter mapping in the module docstring."""
    dev = seeds.device
    s = seeds.shape[0]
    groups = (dof + 3) // 4
    key = seeds.to(torch.int64) & MASK32
    k0 = key[:, 0].view(s, 1, 1)
    k1 = key[:, 1].view(s, 1, 1)
    p = torch.arange(num_particles, device=dev, dtype=torch.int64).view(1, -1, 1)
    g = torch.arange(groups, device=dev, dtype=torch.int64).view(1, 1, -1)
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    t = torch.full((), slot, device=dev, dtype=torch.int64)
    words = philox4x32_10((p, t, g, zero), (k0, k1))
    words = [w.expand(s, num_particles, groups) for w in words]
    bits = torch.stack(words, dim=-1).reshape(s, num_particles, groups * 4)
    return bits_to_uniform(bits[..., :dof])
