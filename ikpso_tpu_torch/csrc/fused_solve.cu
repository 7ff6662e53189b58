// Kernel A: one complete PSO solve per swarm, state resident on chip.
//
// Replaces ikpso_tpu/pso/fused.py:fused_solve_raw (kernel body
// _build_solver_kernel, helpers _uniform and _seg_rows_reduce), main-path
// branch: warm init, canonical inertia with a per-iteration schedule,
// gbest every iteration, no re-kick, position/angle cost only.
//
// Layout: one thread block per swarm, one thread per particle
// (blockDim = P, a multiple of 32, <= 1024). x, v, lbest (D floats each)
// and lval live in registers for the whole solve; the chain's packed meta,
// the swarm's constant row and the joint limits are copied to shared
// memory once. The TPU kernel's 8x128 tiles, swarm packing, roll-tree
// reductions and constant hoisting are TPU layout devices and have no
// counterpart here.
//
// gbest: a block-wide argmin over (lval, particle id) -- warp butterfly
// with __shfl_xor_sync, then one pass over the per-warp winners in shared
// memory. Ties go to the lowest particle id, the first-minimum semantics
// of pso/fused.py:255-260, 344-359 (thrust::min_element in the reference).
// The winner writes its lbest to shared memory; everyone reads it after a
// __syncthreads(). Two barriers per iteration.
//
// Random draws: Philox4x32-10 in registers, keyed by the swarm's two seed
// words, counter (particle, draw slot, dof / 4, 0), output word dof % 4;
// U = (bits >> 8) * 2^-24 on unsigned bits (pso/fused.py:87-96). The
// mapping is defined in ikpso_tpu_torch/ops/philox.py, whose torch
// Philox draws the same bits. Slot 0 is the init velocity draw, then per
// iteration u_c, u_s -- the TPU kernel's order. REPLAY=true instead reads
// uniforms[S, n_draws, D, P] from HBM (the test hook; a template flag so
// the hot path has no branch).
//
// Bound on this card: arithmetic. HBM sees only the swarm constants in
// and one (D + 1)-float row out per swarm; per particle and iteration the
// work is one FK + cost (fk_fitness.cuh), 3 Philox calls per draw slot
// (10 rounds of 2 mul.hi + 2 mul.lo each) and the velocity update. The
// design keeps all state in registers and spends shared memory only on
// the constants and the argmin scratch, so many blocks fit per SM.
#include <cuda_runtime.h>

#include <cstdint>

#include "fk_fitness.cuh"

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

__device__ __forceinline__ float bits_to_uniform(unsigned b) {
  return static_cast<float>(b >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// Uniforms of one draw slot for this particle, one per DOF.
template <int D, bool REPLAY>
__device__ __forceinline__ void draw(float (&u)[D], int slot, unsigned particle,
                                     int P, uint2 key,
                                     const float* __restrict__ u_swarm) {
  if constexpr (REPLAY) {
#pragma unroll
    for (int d = 0; d < D; ++d) u[d] = u_swarm[(slot * D + d) * P + particle];
  } else {
#pragma unroll
    for (int g = 0; g < (D + 3) / 4; ++g) {
      const uint4 w = philox4x32_10(
          make_uint4(particle, static_cast<unsigned>(slot), static_cast<unsigned>(g), 0u),
          key);
      const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * g + j < D) u[4 * g + j] = bits_to_uniform(words[j]);
      }
    }
  }
}

__device__ __forceinline__ bool better_pair(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// Block-wide argmin over (val, id); every thread gets the winning id.
__device__ __forceinline__ int block_argmin(float val, int id, float* s_wval,
                                            int* s_wid) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, val, off);
    const int oi = __shfl_xor_sync(0xffffffffu, id, off);
    if (better_pair(ov, oi, val, id)) {
      val = ov;
      id = oi;
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_wval[warp] = val;
    s_wid[warp] = id;
  }
  __syncthreads();
  float bv = s_wval[0];
  int bi = s_wid[0];
  const int nwarps = blockDim.x >> 5;
  for (int w = 1; w < nwarps; ++w) {
    if (better_pair(s_wval[w], s_wid[w], bv, bi)) {
      bv = s_wval[w];
      bi = s_wid[w];
    }
  }
  return bi;
}

template <class T, bool REPLAY>
__global__ void __launch_bounds__(1024) fused_solve_kernel(
    const float* __restrict__ meta, int M, const float* __restrict__ swarm, int K,
    const float* __restrict__ limits, const int* __restrict__ seeds,
    const float* __restrict__ inertia, int iters, float c1, float c2, float vscale,
    const float* __restrict__ uniforms, int n_draws, float* __restrict__ out_gbest,
    float* __restrict__ out_gval) {
  constexpr int D = T::D;
  extern __shared__ float smem[];
  float* s_meta = smem;
  float* s_sw = s_meta + M;
  float* s_lo = s_sw + K;
  float* s_hi = s_lo + D;
  float* s_gb = s_hi + D;
  float* s_wval = s_gb + D;
  int* s_wid = reinterpret_cast<int*>(s_wval + 32);

  const int s = blockIdx.x;
  const int P = blockDim.x;
  const int p = threadIdx.x;
  for (int i = p; i < M; i += P) s_meta[i] = meta[i];
  for (int i = p; i < K; i += P) s_sw[i] = swarm[static_cast<long long>(s) * K + i];
  for (int i = p; i < D; i += P) {
    s_lo[i] = limits[i];
    s_hi[i] = limits[D + i];
  }
  __syncthreads();

  const uint2 key = make_uint2(static_cast<unsigned>(seeds[2 * s]),
                               static_cast<unsigned>(seeds[2 * s + 1]));
  const float* u_swarm =
      REPLAY ? uniforms + static_cast<long long>(s) * n_draws * D * P : nullptr;

  float x[D], v[D], lb[D], uc[D], us[D];
  draw<D, REPLAY>(uc, 0, p, P, key, u_swarm);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x[d] = s_sw[kSwAnchor + d];
    v[d] = (uc[d] * 2.0f - 1.0f) * vscale;
    lb[d] = x[d];
  }
  float lval = fk_fitness_eval<T>(x, s_meta, s_sw);

  for (int it = 0; it < iters; ++it) {
    const int win = block_argmin(lval, p, s_wval, s_wid);
    if (p == win) {
#pragma unroll
      for (int d = 0; d < D; ++d) s_gb[d] = lb[d];
    }
    __syncthreads();
    draw<D, REPLAY>(uc, 1 + 2 * it, p, P, key, u_swarm);
    draw<D, REPLAY>(us, 2 + 2 * it, p, P, key, u_swarm);
    const float w = inertia[it];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float gb = s_gb[d];
      v[d] = w * v[d] + c1 * uc[d] * (lb[d] - x[d]) + c2 * us[d] * (gb - x[d]);
      x[d] = fminf(fmaxf(x[d] + v[d], s_lo[d]), s_hi[d]);
    }
    const float f = fk_fitness_eval<T>(x, s_meta, s_sw);
    if (f < lval) {
      lval = f;
#pragma unroll
      for (int d = 0; d < D; ++d) lb[d] = x[d];
    }
  }

  const int win = block_argmin(lval, p, s_wval, s_wid);
  if (p == win) {
#pragma unroll
    for (int d = 0; d < D; ++d) out_gbest[static_cast<long long>(s) * D + d] = lb[d];
    out_gval[s] = lval;
  }
}

template <class T>
static void launch_fused_solve(bool replay, const float* meta, int M,
                               const float* swarm, int K, const float* limits,
                               const int* seeds, const float* inertia, int iters,
                               float c1, float c2, float vscale, const float* uniforms,
                               int n_draws, float* gbest, float* gval, int S, int P,
                               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (M + K + 3 * T::D + 32) + sizeof(int) * 32;
  if (replay) {
    fused_solve_kernel<T, true><<<S, P, smem, stream>>>(
        meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2, vscale, uniforms,
        n_draws, gbest, gval);
  } else {
    fused_solve_kernel<T, false><<<S, P, smem, stream>>>(
        meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2, vscale, uniforms,
        n_draws, gbest, gval);
  }
}

}  // namespace ikpso

extern "C" int ikpso_fused_solve(int topo, int replay, const float* meta, int M,
                                 const float* swarm, int K, const float* limits,
                                 const int* seeds, const float* inertia, int iters,
                                 float c1, float c2, float vscale,
                                 const float* uniforms, int n_draws, float* gbest,
                                 float* gval, int S, int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (P <= 0 || P > 1024 || P % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (topo) {
    case 0:
      ikpso::launch_fused_solve<ikpso::Arm7Dof>(replay != 0, meta, M, swarm, K, limits,
                                                seeds, inertia, iters, c1, c2, vscale,
                                                uniforms, n_draws, gbest, gval, S, P, st);
      break;
    case 1:
      ikpso::launch_fused_solve<ikpso::ReferenceArm>(
          replay != 0, meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2, vscale,
          uniforms, n_draws, gbest, gval, S, P, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
