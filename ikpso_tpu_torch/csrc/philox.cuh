// Philox4x32-10 in registers, shared by kernel A (fused_solve.cu), kernel E
// (roofline.cu) and the scan step's drawing instantiation (scan_step.cuh).
//
// Random123's Philox4x32-10 (Salmon et al., SC'11), the generator that
// ikpso_tpu_torch/ops/philox.py writes in plain torch; the counter ->
// draw mapping of the solver lives beside its caller (fused_solve.cu,
// draw()). Per round: two 32x32 -> 64-bit products (mul.hi + mul.lo
// each) and four XORs; the key is bumped between rounds, 9 times in all:
// 10 * 8 + 9 * 2 = 98 integer operations per call (4 words). The op model
// (utils/flops.py, philox_call_ops) charges only the ones a call's
// changing counter words need; the key schedule, and the work on words
// fixed for the thread, once per thread.
#pragma once

#include <cuda_runtime.h>

namespace ikpso {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// philox4x32_10 on N counters under one key, in lockstep: the key schedule
// once for the N calls (the scan step's draws of one group of four
// elements, one counter a draw slot).
template <int N>
__device__ __forceinline__ void philox4x32_10_n(uint4 (&c)[N], uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const unsigned hi0 = __umulhi(0xD2511F53u, c[i].x);
      const unsigned lo0 = 0xD2511F53u * c[i].x;
      const unsigned hi1 = __umulhi(0xCD9E8D57u, c[i].z);
      const unsigned lo1 = 0xCD9E8D57u * c[i].z;
      c[i] = make_uint4(hi1 ^ c[i].y ^ k.x, lo1, hi0 ^ c[i].w ^ k.y, lo0);
    }
  }
}

// U[0, 1) from the top 24 bits, shifted logically on unsigned bits
// (an arithmetic shift would map half the range to [-0.5, 0)).
__device__ __forceinline__ float bits_to_uniform(unsigned b) {
  return static_cast<float>(b >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

}  // namespace ikpso
