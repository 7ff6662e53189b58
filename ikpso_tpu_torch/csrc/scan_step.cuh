// The scan solver's step: one PSO iteration over the (S, P, D) state in one
// launch -- the re-kick, the velocity, the clamp, the fitness (kernel B's
// device function, as kernel C inlines it), the lbest update and the
// first-minimum gbest -- bit for bit pso/solver.py::pso_iteration with
// kernel C's plain twin as its fitness.
//
// Replaces, on the card, the eager update around kernel C
// (ikpso_tpu/ops/pallas_fitness.py:fused_fitness, which
// ikpso_tpu/pso/solver.py:262-274 scans and XLA fuses with the update);
// scan_step.cu instantiates the prebuilt topologies, on_demand.cuh one
// generated topology, each twice:
//
//  * REPLAY = false, the drawing step (the solver's route): each uniform
//    the update uses is drawn in registers by Philox4x32-10
//    (philox.cuh), keyed by the swarm's (S, 2) seed words, as kernel A
//    draws. The draw of element e = p * D + d of a swarm in draw slot
//    `slot` is word e % 4 of philox4x32_10(counter = (e / 4, slot, 0, 0),
//    key = (s0, s1)), so one call yields the four draws of one float4 of
//    the slab (a block's slab starts at a multiple of 4 elements: B is a
//    multiple of 4); slot = iteration * n_draws + k, k in pso_iteration's
//    block order (u_w with randomized inertia, u_c, u_s, then the kick's).
//    ops/philox.py::step_uniforms is the same block in plain torch.
//  * REPLAY = true: the iteration's (n_draws, S, P, D) block is read from
//    device memory instead (ScanDraws: injected uniforms).
//
// Bound on this card: bytes. Per particle a step reads x, v, lbest and its
// lbest value, and writes x, v, the value and lbest where it improved: 56
// floats, 224 bytes at D = 9 in the drawing step; the replay step reads
// 2-4 uniform planes besides (83 floats, 332 bytes, with randomized
// inertia). Against ~600 counted FP32 ops, and ~6.75 Philox calls of 80-98
// integer ops in the drawing step, under the ~20 ops a byte the card
// balances at. The design moves each of those bytes once:
//
//  * Pass 1, one thread a particle, a swarm ceil(P / B) blocks of B
//    threads. A block's particles are one contiguous B x D slab of each
//    (S, P, D) array. The update is elementwise, so the block walks the
//    slab's elements, not its rows: 16-byte loads and stores, consecutive
//    threads on consecutive addresses, v written straight back. Where a
//    slab is not 16-byte aligned the replay step loads 4 bytes a thread on
//    consecutive addresses, and the drawing step takes a thread's four
//    consecutive elements a trip, so that one Philox call a slot still
//    yields its four draws (the ragged end of a slab alike). Only the clamped x
//    goes through shared memory, rows padded to an odd stride (D | 1) so
//    that a thread reading its own row conflicts with no other on a bank;
//    each thread evaluates its row there, updates its lbest value, and
//    the block writes x and the improved lbest rows back from the slab.
//  * Pass 2, in the same launch: each block writes its first-minimum
//    candidate (value, particle id) to an (S, blocks) scratch and counts
//    itself in the swarm's arrival counter; the swarm's last block to
//    arrive takes the first minimum over the candidates, gathers that
//    lbest row, and applies `better = cand < gbest_val` to gbest in place
//    (or, with a gbest_reduce hook, writes the candidate for the host's
//    cross-rank reduction), then resets the counter for the next launch.
//
// Arithmetic, held to pso_iteration (-fmad=false; the coefficients are
// float32, as torch rounds a Python float against a float32 tensor):
// kicked v = (u_k * 2 - 1) * scale; v = ((w * u_w) * v or w * v)
// + (c1 * u_c) * (lbest - x) + (c2 * u_s) * (gbest - x), summed left to
// right; x = clamp(x + v, lo, hi) as torch.clamp's CUDA kernel computes
// it (NaN passes through; fmaxf then fminf otherwise, so signed zeros at a
// zero-width limit round as torch's do); lbest where f < lbest_val; ties go
// to the first minimum by particle id, a NaN counting as the minimum, as
// torch.argmin and jnp.argmin take it.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "fk_fitness.cuh"
#include "philox.cuh"

namespace ikpso {

// At most 128 threads a block: with more, smaller blocks an SM interleaves
// the drawing step's phases (Philox and the update, the evaluation, the
// write-back) better; 256-thread blocks were ~4% slower at the scan shape on
// the H100, ~19% with a key schedule a Philox call (PERF.md,
// tools/scan_step_variants.py); the replay step's time the same.
constexpr int kStepMaxThreads = 128;
// Static budget of a block's dynamic shared memory (no opt-in needed).
constexpr size_t kStepSmemBudget = 48 * 1024;

// Which swarms a step re-kicks (pso_iteration's rule, decided on the host).
enum StepKick : int { kKickNone = 0, kKickAll = 1, kKickAbove = 2 };

__device__ __forceinline__ float4 words_to_uniform(uint4 w) {
  return make_float4(bits_to_uniform(w.x), bits_to_uniform(w.y), bits_to_uniform(w.z),
                     bits_to_uniform(w.w));
}

// The drawing step's uniforms of elements 4 * call .. 4 * call + 3 of a
// swarm, one Philox call a plane the update reads (the counter mapping in
// the header): u_w with randomized inertia, u_c, u_s, and u_k with the kick;
// the planes not read are 0. The calls run in lockstep under one key
// schedule (philox4x32_10_n).
__device__ __forceinline__ void step_draws(unsigned call, int slot_w, bool randomized,
                                           bool kick, int n_draws, uint2 key, float4& uw,
                                           float4& uc, float4& us, float4& uk) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto ctr = [&](int slot) { return make_uint4(call, static_cast<unsigned>(slot), 0u, 0u); };
  const int slot_c = slot_w + (randomized ? 1 : 0);
  const int slot_k = slot_w + n_draws - 1;
  if (randomized && kick) {
    uint4 c[4] = {ctr(slot_w), ctr(slot_c), ctr(slot_c + 1), ctr(slot_k)};
    philox4x32_10_n(c, key);
    uw = words_to_uniform(c[0]);
    uc = words_to_uniform(c[1]);
    us = words_to_uniform(c[2]);
    uk = words_to_uniform(c[3]);
  } else if (randomized) {
    uint4 c[3] = {ctr(slot_w), ctr(slot_c), ctr(slot_c + 1)};
    philox4x32_10_n(c, key);
    uw = words_to_uniform(c[0]);
    uc = words_to_uniform(c[1]);
    us = words_to_uniform(c[2]);
    uk = zero;
  } else if (kick) {
    uint4 c[3] = {ctr(slot_c), ctr(slot_c + 1), ctr(slot_k)};
    philox4x32_10_n(c, key);
    uw = zero;
    uc = words_to_uniform(c[0]);
    us = words_to_uniform(c[1]);
    uk = words_to_uniform(c[2]);
  } else {
    uint4 c[2] = {ctr(slot_c), ctr(slot_c + 1)};
    philox4x32_10_n(c, key);
    uw = uk = zero;
    uc = words_to_uniform(c[0]);
    us = words_to_uniform(c[1]);
  }
}

// The row stride of the clamped-x slab in shared memory: odd, so that the
// 32 threads of a warp reading their own rows hit 32 banks.
__host__ __device__ constexpr int step_row(int d) { return d | 1; }

// A block's dynamic shared memory: the x slab, gbest and the limits, and
// the candidates' values, ids and improved flags.
__host__ __device__ constexpr size_t step_smem_bytes(int threads, int d) {
  return sizeof(float) * (static_cast<size_t>(threads) * step_row(d) + 3 * d) +
         (sizeof(float) + 2 * sizeof(int)) * threads;
}

// Threads a block of the step for D angles: the most of 128, 64, 32 whose
// shared memory fits the budget; 0 where none does.
__host__ __device__ constexpr int step_threads(int d) {
  int t = kStepMaxThreads;
  while (t >= 32 && step_smem_bytes(t, d) > kStepSmemBudget) t /= 2;
  return t >= 32 ? t : 0;
}
static_assert(step_threads(9) == 128 && step_threads(45) == 128 && step_threads(150) == 64,
              "arm_7dof, humanoid_45dof and snake:50 blocks");

// What a step reads and writes (every array contiguous, float32 but the
// ids and counters).
struct StepState {
  float* x;      // (S, P, D), updated in place
  float* v;      // (S, P, D), updated in place
  float* lbest;  // (S, P, D), improved rows rewritten
  float* lval;   // (S, P), improved entries rewritten
  const float* u;      // replay: (n_draws, S, P, D), this iteration's U[0, 1) block
  const int* seeds;    // drawing: (S, 2) Philox key words
  long long plane;  // S * P * D
  const float* limits;  // (2, D): lo, hi
  float* gbest;  // (S, D), updated in place without a hook
  float* gval;   // (S,), updated in place without a hook
  float* red_val;     // (S,) with a gbest_reduce hook, else null
  float* red_coords;  // (S, D) with a hook
  float* cand_val;    // (S, cand_stride) block candidates, cand_stride >= the blocks
  int* cand_id;
  int cand_stride;
  int* arrivals;  // (S,), zero between launches
  int vec;        // 1: the (S, P, D) pointers are 16-byte aligned and plane % 4 == 0
};

struct StepUpdate {
  float w;  // randomized: pso.inertia; canonical: inertia_at(iteration)
  float c1, c2;
  int randomized;
  int n_draws;
  int iteration;  // the drawing step's slots: iteration * n_draws + k
  int kick;       // StepKick
  float kick_scale, kick_threshold;
};

// Does (a, ia) come before (b, ib) in torch.argmin's order: a NaN first (the
// lower id among NaNs), then the lesser value, then the lower id?
__device__ __forceinline__ bool first_min_before(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a < b || (a == b && ia < ib);
}

// The first minimum of the block's n (a power of 2) pairs in s_val / s_id,
// left at index 0; every thread calls it after the pairs are written and a
// barrier.
__device__ __forceinline__ void block_first_min(float* s_val, int* s_id, int t, int n) {
  for (int h = n / 2; h > 0; h /= 2) {
    if (t < h && first_min_before(s_val[t + h], s_id[t + h], s_val[t], s_id[t])) {
      s_val[t] = s_val[t + h];
      s_id[t] = s_id[t + h];
    }
    __syncthreads();
  }
}

// A compile-time topology's evaluation (kernel B's device function on a
// row of the x slab).
template <class T, int C, bool O>
struct StepTreeWalk {
  Scene scene;
  __device__ __forceinline__ int dof() const { return T::D; }
  __device__ __forceinline__ float slack(const float* __restrict__ meta,
                                         const float* __restrict__ sw) const {
    return box_row_slack<T, C>(meta, sw, scene);
  }
  __device__ __forceinline__ float eval(const float* xr, const float* __restrict__ meta,
                                        const float* __restrict__ sw, float slack) const {
    return fk_fitness_eval_at<T, C, O>([=](int d) { return xr[d]; }, meta, sw, scene, slack);
  }
};

// The serial-chain variant: n nodes at run time.
struct StepSerialWalk {
  int n;
  __device__ __forceinline__ int dof() const { return 3 * (n - 1); }
  __device__ __forceinline__ float slack(const float*, const float*) const { return INFINITY; }
  __device__ __forceinline__ float eval(const float* xr, const float* __restrict__ meta,
                                        const float* __restrict__ sw, float) const {
    return fk_fitness_eval_serial(xr, 1, n, meta, sw);
  }
};

template <class W, bool REPLAY>
__global__ void __launch_bounds__(kStepMaxThreads) scan_step_kernel(
    W walk, const float* __restrict__ meta, const float* __restrict__ swarm, int K,
    StepState st, StepUpdate up, int P, int blocks_per_swarm) {
  extern __shared__ float smem[];
  __shared__ int s_last;
  const int D = walk.dof();
  const int R = step_row(D);
  const int B = blockDim.x;
  const int t = threadIdx.x;
  const long long s = blockIdx.x / blocks_per_swarm;
  const int b = blockIdx.x % blocks_per_swarm;
  const int p0 = b * B;
  const int nb = min(B, P - p0);
  float* tile = smem;           // [B][R]: the clamped x rows
  float* s_gb = tile + B * R;   // [D]
  float* s_lo = s_gb + D;       // [D]
  float* s_hi = s_lo + D;       // [D]
  float* s_val = s_hi + D;      // [B]
  int* s_id = reinterpret_cast<int*>(s_val + B);  // [B]
  int* s_imp = s_id + B;                          // [B]

  for (int d = t; d < D; d += B) {
    s_gb[d] = st.gbest[s * D + d];
    s_lo[d] = st.limits[d];
    s_hi[d] = st.limits[D + d];
  }
  // Read before the swarm's last block can rewrite it (pass 2 starts only
  // after every block of the swarm has arrived).
  const float gv = st.gval[s];
  const bool kick = up.kick == kKickAll || (up.kick == kKickAbove && gv > up.kick_threshold);
  __syncthreads();

  const long long g0 = (s * P + p0) * D;
  const int n_el = nb * D;
  float* x = st.x + g0;
  float* v = st.v + g0;
  const float* lb = st.lbest + g0;
  // Replay: the iteration's planes at the slab.
  const float* u_c = st.u + g0 + (up.randomized ? st.plane : 0);
  const float* u_s = u_c + st.plane;
  const float* u_w = st.u + g0;
  const float* u_k = st.u + g0 + (up.n_draws - 1) * st.plane;
  // Drawing: the iteration's first draw slot, and the slab's first Philox
  // call (p0 * D is a multiple of 4, since B is).
  const int slot_w = up.iteration * up.n_draws;
  const unsigned call0 = static_cast<unsigned>(p0) * static_cast<unsigned>(D) / 4u;
  uint2 key = make_uint2(0u, 0u);
  if constexpr (!REPLAY) {
    key = make_uint2(static_cast<unsigned>(st.seeds[2 * s]),
                     static_cast<unsigned>(st.seeds[2 * s + 1]));
  }
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // One element i of the slab: the new velocity, and the clamped x into
  // the slab's row.
  auto update = [&](int i, float xo, float vo, float lbo, float uw, float uc, float us,
                    float uk) {
    const int row = i / D;
    const int d = i - row * D;
    const float vk = kick ? (uk * 2.0f - 1.0f) * up.kick_scale : vo;
    const float inert = up.randomized ? (up.w * uw) * vk : up.w * vk;
    const float vn = (inert + (up.c1 * uc) * (lbo - xo)) + (up.c2 * us) * (s_gb[d] - xo);
    const float y = xo + vn;
    tile[row * R + d] = isnan(y) ? y : fminf(fmaxf(y, s_lo[d]), s_hi[d]);
    return vn;
  };
  const bool vec = st.vec && (g0 & 3) == 0;
  const int n4 = vec ? n_el >> 2 : 0;
  for (int j = t; j < n4; j += B) {
    const float4 xo = reinterpret_cast<const float4*>(x)[j];
    const float4 vo = reinterpret_cast<const float4*>(v)[j];
    const float4 lb4 = reinterpret_cast<const float4*>(lb)[j];
    float4 uc, us, uw, uk;
    if constexpr (REPLAY) {
      uc = __ldg(reinterpret_cast<const float4*>(u_c) + j);
      us = __ldg(reinterpret_cast<const float4*>(u_s) + j);
      uw = up.randomized ? __ldg(reinterpret_cast<const float4*>(u_w) + j) : zero4;
      uk = kick ? __ldg(reinterpret_cast<const float4*>(u_k) + j) : zero4;
    } else {
      step_draws(call0 + static_cast<unsigned>(j), slot_w, up.randomized, kick, up.n_draws,
                 key, uw, uc, us, uk);
    }
    const int i = 4 * j;
    float4 vn;
    vn.x = update(i, xo.x, vo.x, lb4.x, uw.x, uc.x, us.x, uk.x);
    vn.y = update(i + 1, xo.y, vo.y, lb4.y, uw.y, uc.y, us.y, uk.y);
    vn.z = update(i + 2, xo.z, vo.z, lb4.z, uw.z, uc.z, us.z, uk.z);
    vn.w = update(i + 3, xo.w, vo.w, lb4.w, uw.w, uc.w, us.w, uk.w);
    reinterpret_cast<float4*>(v)[j] = vn;
  }
  if constexpr (REPLAY) {
    for (int i = 4 * n4 + t; i < n_el; i += B) {
      v[i] = update(i, x[i], v[i], lb[i], up.randomized ? __ldg(u_w + i) : 0.0f,
                    __ldg(u_c + i), __ldg(u_s + i), kick ? __ldg(u_k + i) : 0.0f);
    }
  } else {
    for (int j = n4 + t; 4 * j < n_el; j += B) {
      float4 uw, uc, us, uk;
      step_draws(call0 + static_cast<unsigned>(j), slot_w, up.randomized, kick, up.n_draws,
                 key, uw, uc, us, uk);
      const float w4[4] = {uw.x, uw.y, uw.z, uw.w}, c4[4] = {uc.x, uc.y, uc.z, uc.w},
                  s4[4] = {us.x, us.y, us.z, us.w}, k4[4] = {uk.x, uk.y, uk.z, uk.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        if (i < n_el) v[i] = update(i, x[i], v[i], lb[i], w4[e], c4[e], s4[e], k4[e]);
      }
    }
  }
  __syncthreads();

  // Each thread's particle: the fitness of its clamped row, the lbest value.
  float cv = INFINITY;
  int ci = INT_MAX;
  if (t < nb) {
    const float* sw = swarm + s * K;
    const float f = walk.eval(tile + t * R, meta, sw, walk.slack(meta, sw));
    const long long pi = s * P + p0 + t;
    const float lv = st.lval[pi];
    const bool improved = f < lv;
    if (improved) st.lval[pi] = f;
    s_imp[t] = improved;
    cv = improved ? f : lv;
    ci = p0 + t;
  }
  s_val[t] = cv;
  s_id[t] = ci;
  __syncthreads();

  // x back from the slab, and the improved lbest rows.
  auto row_of = [&](int i, float& val) {
    const int row = i / D;
    val = tile[row * R + (i - row * D)];
    return s_imp[row] != 0;
  };
  for (int j = t; j < n4; j += B) {
    const int i = 4 * j;
    float4 xn;
    const bool i0 = row_of(i, xn.x), i1 = row_of(i + 1, xn.y), i2 = row_of(i + 2, xn.z),
               i3 = row_of(i + 3, xn.w);
    reinterpret_cast<float4*>(x)[j] = xn;
    float* lw = st.lbest + g0 + i;
    if (i0 && i1 && i2 && i3) {
      reinterpret_cast<float4*>(lw)[0] = xn;
    } else {
      if (i0) lw[0] = xn.x;
      if (i1) lw[1] = xn.y;
      if (i2) lw[2] = xn.z;
      if (i3) lw[3] = xn.w;
    }
  }
  for (int i = 4 * n4 + t; i < n_el; i += B) {
    float xn;
    const bool imp = row_of(i, xn);
    x[i] = xn;
    if (imp) st.lbest[g0 + i] = xn;
  }

  // Pass 2: the block's candidate, then the swarm's last block reduces.
  block_first_min(s_val, s_id, t, B);
  if (t == 0) {
    st.cand_val[s * st.cand_stride + b] = s_val[0];
    st.cand_id[s * st.cand_stride + b] = s_id[0];
    // The block's writes (a barrier orders the other threads' before this
    // thread's) reach the device before its arrival is counted.
    __threadfence();
    s_last = atomicAdd(st.arrivals + s, 1) == blocks_per_swarm - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float bv = INFINITY;
  int bi = INT_MAX;
  // L2 reads (__ldcg): the other blocks wrote these in this launch.
  for (int k = t; k < blocks_per_swarm; k += B) {
    const float kv = __ldcg(st.cand_val + s * st.cand_stride + k);
    const int ki = __ldcg(st.cand_id + s * st.cand_stride + k);
    if (first_min_before(kv, ki, bv, bi)) {
      bv = kv;
      bi = ki;
    }
  }
  s_val[t] = bv;
  s_id[t] = bi;
  __syncthreads();
  block_first_min(s_val, s_id, t, B);
  const float cand = s_val[0];
  const long long win = s * P + s_id[0];
  const bool better = cand < gv;
  for (int d = t; d < D; d += B) {
    const float c = __ldcg(st.lbest + win * D + d);
    if (st.red_coords != nullptr) {
      st.red_coords[s * D + d] = c;
    } else if (better) {
      st.gbest[s * D + d] = c;
    }
  }
  if (t == 0) {
    if (st.red_val != nullptr) {
      st.red_val[s] = cand;
    } else if (better) {
      st.gval[s] = cand;
    }
    st.arrivals[s] = 0;
  }
}

// Launch one step of S swarms of P particles, the replay step (reading
// st.u) or the drawing one (keyed by st.seeds); an error where the block's
// shared memory, the grid or the candidate scratch cannot hold the shape,
// or the step's draws are missing.
template <class W>
static cudaError_t launch_scan_step(W walk, int D, const float* meta, const float* swarm,
                                    int K, StepState st, StepUpdate up, bool replay, int S,
                                    int P, cudaStream_t stream) {
  const int threads = step_threads(D);
  if (threads == 0 || S <= 0 || P <= 0 || (replay ? st.u == nullptr : st.seeds == nullptr) ||
      up.iteration < 0 || up.n_draws < (up.randomized ? 3 : 2) ||
      (up.kick != kKickNone && up.n_draws < (up.randomized ? 4 : 3))) {
    return cudaErrorInvalidValue;
  }
  const int per_swarm = (P + threads - 1) / threads;
  if (per_swarm > st.cand_stride || static_cast<long long>(S) * per_swarm > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
  };
  st.vec = aligned(st.x) && aligned(st.v) && aligned(st.lbest) &&
           (!replay || aligned(st.u)) && (st.plane & 3) == 0;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(S) * per_swarm);
  const size_t smem = step_smem_bytes(threads, D);
  if (replay) {
    scan_step_kernel<W, true><<<blocks, threads, smem, stream>>>(walk, meta, swarm, K, st,
                                                                  up, P, per_swarm);
  } else {
    scan_step_kernel<W, false><<<blocks, threads, smem, stream>>>(walk, meta, swarm, K, st,
                                                                   up, P, per_swarm);
  }
  return cudaSuccess;
}

}  // namespace ikpso

// The C entry points' shared arguments after the topology's (kernels.py's
// _STEP): the constants, the state, the draws (replay: u; drawing: seeds),
// gbest, the hook's outputs, the update and the scratch.
#define IKPSO_STEP_PARAMS                                                                  \
  const float *meta, const float *swarm, int K, const float *limits, float *x, float *v,   \
      float *lbest, float *lval, int replay, const float *u, const int *seeds, int n_draws, \
      int iteration, float *gbest, float *gval, float *red_val, float *red_coords, float w, \
      float c1, float c2, int randomized, int kick, float kick_scale, float kick_threshold, \
      float *cand_val, int *cand_id, int cand_stride, int *arrivals, int S, int P,          \
      void *stream

#define IKPSO_STEP_STATE(D)                                                                \
  ikpso::StepState {                                                                       \
    x, v, lbest, lval, u, seeds, static_cast<long long>(S) * P * (D), limits, gbest, gval, \
        red_val, red_coords, cand_val, cand_id, cand_stride, arrivals, 0                   \
  }

#define IKPSO_STEP_UPDATE                                                                  \
  ikpso::StepUpdate {                                                                      \
    w, c1, c2, randomized, n_draws, iteration, kick, kick_scale, kick_threshold            \
  }
