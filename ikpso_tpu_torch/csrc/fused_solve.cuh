// Kernel A's kernel templates: the register layout (fused_solve_kernel, the
// short chains' fused_solve_short_kernel and the trees'
// fused_solve_tree_kernel), the scratch layout (scratch_solve:
// fused_solve_serial_kernel and fused_solve_tree_scratch_kernel) and their
// helpers. fused_solve.cu instantiates the prebuilt topologies and the
// serial-chain variant, on_demand.cuh one generated topology; the design
// notes are in fused_solve.cu.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fk_fitness.cuh"
#include "philox.cuh"

namespace ikpso {

// Init modes; ids must match INIT_MODES in ikpso_tpu_torch/pso/fused.py.
enum InitMode : int { kInitWarm = 0, kInitUniform = 1, kInitHybrid = 2 };

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

// Uniforms of DOFs 4g .. 4g+3 of one draw slot of a chain of d_total DOFs
// (one Philox call; the replay reads only the DOFs below d_total): the
// streamed form of draw(), for the topologies under StreamDraws and the
// serial-chain variant, whose d_total is a run-time value.
template <bool REPLAY>
__device__ __forceinline__ void draw_group(float (&u)[4], int g, int slot, int d_total,
                                           unsigned particle, int P, uint2 key,
                                           const float* __restrict__ u_swarm) {
  if constexpr (REPLAY) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * g + j < d_total) {
        u[j] = u_swarm[(slot * d_total + 4 * g + j) * P + particle];
      }
    }
  } else {
    const uint4 w = philox4x32_10(
        make_uint4(particle, static_cast<unsigned>(slot), static_cast<unsigned>(g), 0u),
        key);
    u[0] = bits_to_uniform(w.x);
    u[1] = bits_to_uniform(w.y);
    u[2] = bits_to_uniform(w.z);
    u[3] = bits_to_uniform(w.w);
  }
}

// An unsigned key in the order of kernel A's argmin: k(a) < k(b) exactly
// where a < b for non-NaN a, b (-0 and +0 share a key: v + 0.0f is +0 for
// both), NaN (key 0) below everything -- the plain twin's torch.argmin,
// which returns the first NaN where there is one. A warp takes its (least
// key, lowest id) with two __reduce_min_sync: the least key, then the
// least id holding it.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v + 0.0f);
  if (v != v) return 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The value of order_key k (-0 comes back as +0, a NaN as the canonical
// one): what a comparison with a threshold needs.
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float(k == 0u ? 0x7fffffffu
                                 : (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Block-wide first-minimum argmin over (val, id) in order_key's order
// (id: the thread's particle, ids ascending with the warps); every thread
// gets the winning id and, in best, the winning value as key_value gives
// it. Each warp's (least key, least id) by two __reduce_min_sync goes to
// shared memory (s_wval holds the key's bits); after the barrier every
// thread scans the warps in order (the first least key holds the least id).
__device__ __forceinline__ int block_argmin(float val, int id, float* s_wval, int* s_wid,
                                            float& best) {
  const unsigned k = order_key(val);
  const unsigned wk = __reduce_min_sync(0xffffffffu, k);
  const unsigned wi =
      __reduce_min_sync(0xffffffffu, k == wk ? static_cast<unsigned>(id) : 0xffffffffu);
  unsigned* s_wkey = reinterpret_cast<unsigned*>(s_wval);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_wkey[warp] = wk;
    s_wid[warp] = static_cast<int>(wi);
  }
  __syncthreads();
  unsigned bk = s_wkey[0];
  int bw = 0;
  const int nwarps = blockDim.x >> 5;
  for (int w = 1; w < nwarps; ++w) {
    if (s_wkey[w] < bk) {
      bk = s_wkey[w];
      bw = w;
    }
  }
  best = key_value(bk);
  return s_wid[bw];
}

// Kernel A's thread-block bound per topology (its __launch_bounds__, and so
// the most particles a swarm may have); must match MAX_PARTICLES in
// ikpso_tpu_torch/utils/kernels.py.
template <class T>
struct KernelAThreads {
  static constexpr int value = 1024;
};
template <>
struct KernelAThreads<Humanoid45> {
  static constexpr int value = 512;
};
// reference_arm's x, v and lbest are 63 floats; at 1024 threads (64
// registers) its build spilled 800-856 bytes, and its preset runs P = 256.
template <>
struct KernelAThreads<ReferenceArm> {
  static constexpr int value = 256;
};
// snake_30dof's x, v and lbest are 90 floats; its preset runs P = 256.
template <>
struct KernelAThreads<Snake30> {
  static constexpr int value = 256;
};
// An on-demand topology carries its bound, chosen when it is generated.
template <class PA, class EF, int TH, bool ST, bool DI, bool EX>
struct KernelAThreads<OnDemandTopology<PA, EF, TH, ST, DI, EX>> {
  static constexpr int value = TH;
};

// Whether kernel A draws its uniforms four DOFs at a time next to their
// use (draw_group) instead of a whole D-float array per slot (draw). The
// values and the arithmetic are the same either way; what differs is
// what the registers hold. The trees, reference_arm and snake_30dof
// stream (the tree loop's draws are streamed): two D-float draw arrays
// beside x, v and lbest exceed the registers a thread has (with whole
// arrays the humanoid ran 3.8x and the dual arm 8% slower).
// The short chains keep whole arrays: streamed, kernel A ran 2.4-2.7%
// slower on arm_7dof and 1.0% slower on arm_6dof with orientation
// (interleaved pairs on an H100, PERF.md); arm_7dof's box scene ran 0.7%
// faster streamed, but shares the headline's topology and follows it.
template <class T>
struct StreamDraws {
  static constexpr bool value = false;
};
template <>
struct StreamDraws<DualArm14> {
  static constexpr bool value = true;
};
template <>
struct StreamDraws<Humanoid45> {
  static constexpr bool value = true;
};
template <>
struct StreamDraws<ReferenceArm> {
  static constexpr bool value = true;
};
template <>
struct StreamDraws<Snake30> {
  static constexpr bool value = true;
};
template <class PA, class EF, int TH, bool ST, bool DI, bool EX>
struct StreamDraws<OnDemandTopology<PA, EF, TH, ST, DI, EX>> {
  static constexpr bool value = ST;
};

// Where kernel A keeps a particle's velocity and personal best. x stays in
// registers either way: the FK walk reads it. kRegisters: v and lbest in
// registers beside x. kShared: v and lbest in dynamic shared memory, laid
// out [D][P] each after the argmin scratch (kernel_a_smem_bytes); the
// update reads and writes them at [d * P + p], so a warp touches 32
// consecutive words, one a bank. The walk never reads them, and a block of
// a tree already fills its SM's registers, so the shared memory they take
// costs no occupancy while it takes two thirds of the state out of the
// register file (the humanoid spilled 1,360 bytes and the dual arm 608 at
// their bounds with all three in registers). The short chains keep
// registers: their x, v and lbest fit. Must match SHARED_IDS in
// ikpso_tpu_torch/utils/kernels.py; an on-demand topology's placement is
// set in on_demand.cuh (IKPSO_OD_SHARED).
enum Placement : int { kRegisters = 0, kShared = 1 };
template <class T>
struct StatePlacement {
  static constexpr int value = kRegisters;
};
template <>
struct StatePlacement<DualArm14> {
  static constexpr int value = kShared;
};
template <>
struct StatePlacement<Humanoid45> {
  static constexpr int value = kShared;
};
template <>
struct StatePlacement<ReferenceArm> {
  static constexpr int value = kShared;
};
template <>
struct StatePlacement<Snake30> {
  static constexpr int value = kShared;
};

// The least blocks of kernel A per SM that ptxas must fit (the second
// argument of __launch_bounds__): 3 where v and lbest left the registers of
// a 256-thread topology (reference_arm, snake_30dof: the tree loop, their
// rows a block 53,248 and 69,632 bytes at P = 256) and x and the walk fit
// 80 registers without a spill, so three swarms share an SM and hide each
// other's issue latency. On an H100 both ran faster than at 2 blocks (128
// registers) and at 4 (64: reference_arm's walk fits with the key read a
// group, snake_30dof's spills), PERF.md, tools/kernel_a_tree_variants.py.
template <class T>
struct KernelAMinBlocks {
  static constexpr int value = 1;
};
template <>
struct KernelAMinBlocks<ReferenceArm> {
  static constexpr int value = 3;
};
template <>
struct KernelAMinBlocks<Snake30> {
  static constexpr int value = 3;
};

// A particle's v and lbest where StatePlacement puts them: vel(d) and
// best(d) are element d, and copy_best writes the winner's lbest to
// dst[0, D) -- the winner alone from its registers, or the block together
// from shared memory (after a barrier that follows every lbest write).
template <int D, int PLACE>
struct ParticleState;
template <int D>
struct ParticleState<D, kRegisters> {
  float v[D], lb[D];
  int p;
  __device__ ParticleState(float*, int, int p) : p(p) {}
  __device__ __forceinline__ float& vel(int d) { return v[d]; }
  __device__ __forceinline__ float& best(int d) { return lb[d]; }
  __device__ __forceinline__ void copy_best(float* dst, int win) const {
    if (p == win) {
#pragma unroll
      for (int d = 0; d < D; ++d) dst[d] = lb[d];
    }
  }
};
template <int D>
struct ParticleState<D, kShared> {
  float* s_v;   // [D][P]
  float* s_lb;  // [D][P]
  int P, p;
  __device__ ParticleState(float* s_state, int P, int p)
      : s_v(s_state), s_lb(s_state + D * P), P(P), p(p) {}
  __device__ __forceinline__ float& vel(int d) { return s_v[d * P + p]; }
  __device__ __forceinline__ float& best(int d) { return s_lb[d * P + p]; }
  __device__ __forceinline__ void copy_best(float* dst, int win) const {
    for (int d = p; d < D; d += P) dst[d] = s_lb[d * P + win];
  }
};

// Kernel A's dynamic shared memory: meta, the swarm row, the limits, gbest
// and the argmin scratch (M + K + 3 D + 64 words), rounded up to 16 bytes,
// then `planes` [D][P] float planes (v and lbest in the register layout's
// shared placement; lbest in the scratch layout's). Must match
// kernel_a_smem_bytes in ikpso_tpu_torch/utils/kernels.py.
__host__ __device__ constexpr size_t smem_head_floats(int M, int K, int D) {
  return (static_cast<size_t>(M) + K + 3 * D + 64 + 3) / 4 * 4;
}
static size_t kernel_a_smem_bytes(int M, int K, int D, int P, int planes) {
  return sizeof(float) * (smem_head_floats(M, K, D) + static_cast<size_t>(planes) * D * P);
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
// A thread's row of v or lbest: D rounded up to an odd number of float4.
__host__ __device__ constexpr int cluster_row(int D) {
  return round4(D) / 4 % 2 ? round4(D) : round4(D) + 4;
}

// A block's dynamic shared memory in the cluster layout
// (fused_solve_cluster.cuh), in floats, each part 16-byte aligned
// (D4 = round4(D)): the limits lo and hi (2 D4); two slots of a block
// winner's lbest row (2 D4) and its key, id and value (2 x 4 words); each
// warp winner's key, id and value (3 x 32 words); meta and the swarm row
// (M + K, rounded up to 4); then two planes, v and lbest, of Pb rows of
// cluster_row(D) floats. Must match cluster_smem_bytes in
// ikpso_tpu_torch/utils/kernels.py.
__host__ __device__ constexpr size_t cluster_head_floats(int M, int K, int D) {
  return static_cast<size_t>(4) * round4(D) + 8 + 96 + round4(M + K);
}
static size_t cluster_smem_bytes(int M, int K, int D, int Pb) {
  return sizeof(float) *
         (cluster_head_floats(M, K, D) + static_cast<size_t>(2) * cluster_row(D) * Pb);
}

// Lets `kernel` take the card's opt-in maximum of shared memory per block
// (past the default 48 KB) less its static shared memory (static_bytes)
// as dynamic shared memory, and returns that, 0 on an error. Each launcher
// calls it once per instantiation, from a static.
template <class F>
static int allow_dynamic_smem(F kernel, size_t static_bytes = 0) {
  int device = 0, most = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess) {
    return 0;
  }
  most -= static_cast<int>(static_bytes);
  if (most < 0 || cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       most) != cudaSuccess) {
    return 0;
  }
  return most;
}

// The update's runtime branches (host-checked: gbest_interval >= 1 and it
// divides rekick_interval when the re-kick is on).
struct Update {
  int randomized;        // inertia w * u_w instead of w
  int gbest_interval;    // refresh gbest where it % gbest_interval == 0
  int rekick_interval;   // 0: no re-kick
  float rekick_scale;
  float rekick_threshold;  // < 0: kick every swarm
};

template <class T, int C, bool O, bool REPLAY>
__global__ void __launch_bounds__(KernelAThreads<T>::value, KernelAMinBlocks<T>::value)
    fused_solve_kernel(const float* __restrict__ meta, int M,
                       const float* __restrict__ swarm, int K,
                       const float* __restrict__ limits, const int* __restrict__ seeds,
                       const float* __restrict__ inertia, int iters, float c1, float c2,
                       float vscale, int init_mode, Scene scene, Update up,
                       const float* __restrict__ uniforms, int n_draws,
                       float* __restrict__ out_gbest, float* __restrict__ out_gval) {
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

  constexpr bool kStream = StreamDraws<T>::value;
  constexpr int kGroups = (D + 3) / 4;
  float x[D], uc[kStream ? 4 : D], us[kStream ? 4 : D];
  ParticleState<D, StatePlacement<T>::value> st(smem + smem_head_floats(M, K, D), P, p);
  const int n_init = init_mode == kInitWarm ? 1 : 2;
  if (init_mode == kInitWarm || (init_mode == kInitHybrid && p == 0)) {
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = s_sw[kSwAnchor + d];
  }
  if constexpr (kStream) {
    const bool draw_x = init_mode == kInitUniform || (init_mode == kInitHybrid && p != 0);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (draw_x) draw_group<REPLAY>(us, g, 0, D, p, P, key, u_swarm);
      draw_group<REPLAY>(uc, g, n_init - 1, D, p, P, key, u_swarm);
#pragma unroll
      for (int j = 0; j < 4 && 4 * g + j < D; ++j) {
        const int d = 4 * g + j;
        if (draw_x) {
          constexpr float kTwoPi = 0x1.921fb6p+2f;
          const float lo_c = fmaxf(s_lo[d], -kTwoPi);
          const float hi_c = fminf(s_hi[d], kTwoPi);
          x[d] = lo_c + us[j] * (hi_c - lo_c);
        }
        st.vel(d) = (uc[j] * 2.0f - 1.0f) * vscale;
        st.best(d) = x[d];
      }
    }
  } else {
    if (init_mode != kInitWarm) {
      // U(lo, hi) over the joint range clamped to +-2pi (pso/fused.py:269-283).
      draw<D, REPLAY>(uc, 0, p, P, key, u_swarm);
      if (init_mode == kInitUniform || p != 0) {
        constexpr float kTwoPi = 0x1.921fb6p+2f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float lo_c = fmaxf(s_lo[d], -kTwoPi);
          const float hi_c = fminf(s_hi[d], kTwoPi);
          x[d] = lo_c + uc[d] * (hi_c - lo_c);
        }
      }
    }
    draw<D, REPLAY>(uc, n_init - 1, p, P, key, u_swarm);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      st.vel(d) = (uc[d] * 2.0f - 1.0f) * vscale;
      st.best(d) = x[d];
    }
  }
  const float row_slack = box_row_slack<T, C>(s_meta, s_sw, scene);
  float lval = fk_fitness_eval<T, C, O>(x, s_meta, s_sw, scene, row_slack);

  const int dpi = (up.randomized ? 3 : 2) + (up.rekick_interval > 0 ? 1 : 0);
  // Countdowns to the next gbest refresh and the next kick block start
  // (it % gbest_interval == 0; it % rekick_interval == 0 and it > 0).
  int refresh_in = 0;
  int kick_in = up.rekick_interval;
  for (int it = 0; it < iters; ++it) {
    const bool kick = up.rekick_interval > 0 && kick_in == 0;
    kick_in = (kick ? up.rekick_interval : kick_in) - 1;
    if (refresh_in == 0) {
      refresh_in = up.gbest_interval;
      float best;
      // block_argmin's barrier follows every lbest write of the block.
      const int win = block_argmin(lval, p, s_wval, s_wid, best);
      st.copy_best(s_gb, win);
      __syncthreads();
      if (kick && (up.rekick_threshold < 0.0f || best > up.rekick_threshold)) {
        if constexpr (kStream) {
          const int slot = n_init + it * dpi + dpi - 1;
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            draw_group<REPLAY>(uc, g, slot, D, p, P, key, u_swarm);
#pragma unroll
            for (int j = 0; j < 4 && 4 * g + j < D; ++j) {
              st.vel(4 * g + j) = (uc[j] * 2.0f - 1.0f) * up.rekick_scale;
            }
          }
        } else {
          draw<D, REPLAY>(uc, n_init + it * dpi + dpi - 1, p, P, key, u_swarm);
#pragma unroll
          for (int d = 0; d < D; ++d) st.vel(d) = (uc[d] * 2.0f - 1.0f) * up.rekick_scale;
        }
      }
    }
    // The inertia term first (w * v, or (w * u_w) * v), rounded into v: the
    // same rounding as the one expression, with no third draw array live.
    --refresh_in;
    const int base = n_init + it * dpi;
    const float w = inertia[it];
    if constexpr (kStream) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float uw[4];
        if (up.randomized) draw_group<REPLAY>(uw, g, base + 2, D, p, P, key, u_swarm);
        draw_group<REPLAY>(uc, g, base, D, p, P, key, u_swarm);
        draw_group<REPLAY>(us, g, base + 1, D, p, P, key, u_swarm);
#pragma unroll
        for (int j = 0; j < 4 && 4 * g + j < D; ++j) {
          const int d = 4 * g + j;
          float vd = st.vel(d);
          vd = up.randomized ? (w * uw[j]) * vd : w * vd;
          vd = vd + c1 * uc[j] * (st.best(d) - x[d]) + c2 * us[j] * (s_gb[d] - x[d]);
          st.vel(d) = vd;
          x[d] = fminf(fmaxf(x[d] + vd, s_lo[d]), s_hi[d]);
        }
      }
    } else {
      if (up.randomized) {
        draw<D, REPLAY>(uc, base + 2, p, P, key, u_swarm);
#pragma unroll
        for (int d = 0; d < D; ++d) st.vel(d) = (w * uc[d]) * st.vel(d);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) st.vel(d) = w * st.vel(d);
      }
      draw<D, REPLAY>(uc, base, p, P, key, u_swarm);
      draw<D, REPLAY>(us, base + 1, p, P, key, u_swarm);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float gb = s_gb[d];
        const float vd =
            st.vel(d) + c1 * uc[d] * (st.best(d) - x[d]) + c2 * us[d] * (gb - x[d]);
        st.vel(d) = vd;
        x[d] = fminf(fmaxf(x[d] + vd, s_lo[d]), s_hi[d]);
      }
    }
    const float f = fk_fitness_eval<T, C, O>(x, s_meta, s_sw, scene, row_slack);
    if (f < lval) {
      lval = f;
#pragma unroll
      for (int d = 0; d < D; ++d) st.best(d) = x[d];
    }
  }

  float best;
  const int win = block_argmin(lval, p, s_wval, s_wid, best);
  st.copy_best(out_gbest + static_cast<long long>(s) * D, win);
  if (p == win) out_gval[s] = lval;
}

// ---------------------------------------------------------------------------
// Kernel A's short chains: the register layout without streamed draws
// (ShortChain: arm_7dof, which planar_3dof runs on, arm_6dof, and an
// on-demand chain placed so), fused_solve_short_kernel. The design notes
// are fused_solve.cu's "Short chains"; the arithmetic, the draws and the
// first-minimum rule are fused_solve_kernel's, op for op.

template <class T>
struct ShortChain {
  static constexpr bool value =
      StatePlacement<T>::value == kRegisters && !StreamDraws<T>::value;
};

// The short chains' second thread bound (their presets run P = 128; must
// match SHORT_THREADS in utils/kernels.py) and the least blocks an SM
// keeps at it (the second argument of __launch_bounds__), so the register
// cap: 3 blocks, 80 registers, where the walk fits them (the headline's
// instantiation takes 76, so six blocks of 128 threads an SM); 2 blocks,
// 128 registers, for the box scene, which spilled 224-372 bytes at 80 and
// ran 7% slower on an H100 (PERF.md, tools/kernel_a_variants.py). At the
// 1,024-thread bound one block, 64 registers.
constexpr int kShortThreads = 256;
template <int C, int TH>
struct ShortMinBlocks {
  static constexpr int value = TH != kShortThreads ? 1 : C == kBoxCollider ? 2 : 3;
};

// A short chain's static shared memory (fused_solve_short_kernel): the
// walk's constants at compile-time offsets -- the swarm row through the
// target rotations, meta through the effector weights and, without a
// scene, the orientation weight -- and the limits, each a whole number of
// float4, so an evaluation or an update loads them 16 bytes at a time;
// then, for the two gbest refreshes in turn, each warp's winner: its key,
// id, value and lbest. Must match short_static_bytes in
// ikpso_tpu_torch/utils/kernels.py.
template <class T, int C, bool O, int TH>
struct ShortShared {
  static constexpr int kD4 = (T::D + 3) / 4 * 4;
  static constexpr int kWarps = TH / 32;
  static constexpr int kSw =
      (kSwAnchor + T::D + 3 * T::E + 3 * (T::N - 1) + (O ? 9 * T::E : 0) + 3) / 4 * 4;
  static constexpr int kMeta = (meta_obs<T>() + (O && C == kNoCollider ? 1 : 0) + 3) / 4 * 4;
  float sw[kSw];
  float meta[kMeta];
  float lo[kD4];
  float hi[kD4];
  float lb[2][kWarps][kD4];
  unsigned key[2][kWarps];
  int id[2][kWarps];
  float val[2][kWarps];
};

// r[0, N) from 16-byte aligned shared memory, a float4 at a time.
template <int N>
__device__ __forceinline__ void load4(float (&r)[N], const float* __restrict__ s) {
  static_assert(N % 4 == 0, "whole float4");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(s + i);
    r[i] = v.x;
    r[i + 1] = v.y;
    r[i + 2] = v.z;
    r[i + 3] = v.w;
  }
}

// v[0, D) to 16-byte aligned shared memory, a float4 at a time (the pad
// after D is written with zeros and never read).
template <int D>
__device__ __forceinline__ void store4(float* __restrict__ s, const float (&v)[D]) {
#pragma unroll
  for (int i = 0; i < D; i += 4) {
    *reinterpret_cast<float4*>(s + i) =
        make_float4(v[i], i + 1 < D ? v[i + 1] : 0.0f, i + 2 < D ? v[i + 2] : 0.0f,
                    i + 3 < D ? v[i + 3] : 0.0f);
  }
}

template <class T, int C, bool O, bool REPLAY, int TH, bool CANON>
__global__ void __launch_bounds__(TH, ShortMinBlocks<C, TH>::value)
    fused_solve_short_kernel(const float* __restrict__ meta, int M,
                             const float* __restrict__ swarm, int K,
                             const float* __restrict__ limits, const int* __restrict__ seeds,
                             const float* __restrict__ inertia, int iters, float c1,
                             float c2, float vscale, int init_mode, Scene scene, Update up,
                             const float* __restrict__ uniforms, int n_draws,
                             float* __restrict__ out_gbest, float* __restrict__ out_gval) {
  constexpr int D = T::D;
  using Sh = ShortShared<T, C, O, TH>;
  __shared__ __align__(16) Sh sh;
  extern __shared__ float smem[];  // meta, for the scene boxes (kernel_a_smem_bytes)

  const int s = blockIdx.x;
  const int P = blockDim.x;
  const int p = threadIdx.x;
  const float* row = swarm + static_cast<long long>(s) * K;
  for (int i = p; i < Sh::kSw; i += P) sh.sw[i] = i < K ? row[i] : 0.0f;
  for (int i = p; i < Sh::kMeta; i += P) sh.meta[i] = i < M ? meta[i] : 0.0f;
  for (int i = p; i < Sh::kD4; i += P) {
    sh.lo[i] = i < D ? limits[i] : 0.0f;
    sh.hi[i] = i < D ? limits[D + i] : 0.0f;
  }
  if constexpr (C != kNoCollider) {
    for (int i = p; i < M; i += P) smem[i] = meta[i];
  }
  __syncthreads();

  const uint2 key = make_uint2(static_cast<unsigned>(seeds[2 * s]),
                               static_cast<unsigned>(seeds[2 * s + 1]));
  const float* u_swarm =
      REPLAY ? uniforms + static_cast<long long>(s) * n_draws * D * P : nullptr;
  const JointWeights jw = joint_weights<T>(sh.meta);
  const float row_slack = box_row_slack<T, C>(smem, sh.sw, scene);
  // The walk's constants, held in registers for the whole solve (loaded
  // once an evaluation instead, the short chains ran 1-7% slower at either
  // bound: PERF.md, tools/kernel_a_variants.py). The scene boxes (and,
  // after them, the orientation weight) stay in shared memory; without a
  // scene the weight is in c_meta.
  float c_sw[Sh::kSw], c_meta[Sh::kMeta];
  load4(c_sw, sh.sw);
  load4(c_meta, sh.meta);
  auto eval = [&](const float (&xe)[D]) {
    const float* obs = C == kNoCollider ? c_meta + meta_obs<T>() : smem + meta_obs<T>();
    return fk_fitness_walk<T, C, O>([&](int d) { return xe[d]; }, c_meta, c_sw, obs,
                                    [&] { return jw; }, scene, row_slack);
  };

  float x[D], v[D], lb[D], uc[D], us[D];
  const int n_init = init_mode == kInitWarm ? 1 : 2;
  if (init_mode == kInitWarm || (init_mode == kInitHybrid && p == 0)) {
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = sh.sw[kSwAnchor + d];
  }
  if (init_mode != kInitWarm) {
    // U(lo, hi) over the joint range clamped to +-2pi (pso/fused.py:269-283).
    draw<D, REPLAY>(uc, 0, p, P, key, u_swarm);
    if (init_mode == kInitUniform || p != 0) {
      constexpr float kTwoPi = 0x1.921fb6p+2f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float lo_c = fmaxf(sh.lo[d], -kTwoPi);
        const float hi_c = fminf(sh.hi[d], kTwoPi);
        x[d] = lo_c + uc[d] * (hi_c - lo_c);
      }
    }
  }
  draw<D, REPLAY>(uc, n_init - 1, p, P, key, u_swarm);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    v[d] = (uc[d] * 2.0f - 1.0f) * vscale;
    lb[d] = x[d];
  }
  float lval = eval(x);

  // gbest refresh: the first-minimum block argmin over (lval, p) with one
  // barrier. Each warp's winner publishes its key, id, value and lbest in
  // slot [buf][warp]; after the barrier every thread scans the warp
  // winners in warp order (the first least key holds the least id) and
  // reads the winner's row. Refreshes alternate between the two slots, so
  // a refresh's writes never meet the previous refresh's reads: those end
  // before this refresh's barrier, which every thread must reach.
  const int nwarps = P >> 5;
  int buf = 0;
  auto refresh = [&](float& best, int& win) -> const float* {
    const unsigned k = order_key(lval);
    const unsigned wk = __reduce_min_sync(0xffffffffu, k);
    const unsigned wi =
        __reduce_min_sync(0xffffffffu, k == wk ? static_cast<unsigned>(p) : 0xffffffffu);
    const int warp = p >> 5;
    if (static_cast<unsigned>(p) == wi) {
      sh.key[buf][warp] = wk;
      sh.id[buf][warp] = p;
      sh.val[buf][warp] = lval;
      store4<D>(sh.lb[buf][warp], lb);
    }
    __syncthreads();
    int ww = 0;
    unsigned bk = sh.key[buf][0];
    auto scan = [&](int w) {
      const unsigned kw = sh.key[buf][w];
      if (kw < bk) {
        bk = kw;
        ww = w;
      }
    };
    if constexpr (Sh::kWarps <= 8) {
      // Straight-line code at the short bound: no loop to set up.
#pragma unroll
      for (int w = 1; w < Sh::kWarps; ++w) {
        if (w < nwarps) scan(w);
      }
    } else {
      for (int w = 1; w < nwarps; ++w) scan(w);
    }
    best = sh.val[buf][ww];
    win = sh.id[buf][ww];
    const float* g = sh.lb[buf][ww];
    buf ^= 1;
    return g;
  };

  const int dpi = CANON ? 2 : (up.randomized ? 3 : 2) + (up.rekick_interval > 0 ? 1 : 0);
  // Countdowns to the next gbest refresh and the next kick block start
  // (it % gbest_interval == 0; it % rekick_interval == 0 and it > 0).
  int refresh_in = 0;
  int kick_in = up.rekick_interval;
  const float* g_row = sh.lb[0][0];
  for (int it = 0; it < iters; ++it) {
    bool kick = false;
    if constexpr (!CANON) {
      kick = up.rekick_interval > 0 && kick_in == 0;
      kick_in = (kick ? up.rekick_interval : kick_in) - 1;
    }
    if (CANON || refresh_in == 0) {
      refresh_in = up.gbest_interval;
      float best;
      int win;
      g_row = refresh(best, win);
      if (kick && (up.rekick_threshold < 0.0f || best > up.rekick_threshold)) {
        draw<D, REPLAY>(uc, n_init + it * dpi + dpi - 1, p, P, key, u_swarm);
#pragma unroll
        for (int d = 0; d < D; ++d) v[d] = (uc[d] * 2.0f - 1.0f) * up.rekick_scale;
      }
    }
    --refresh_in;
    // The inertia term first (w * v, or (w * u_w) * v), rounded into v.
    const int base = n_init + it * dpi;
    const float w = inertia[it];
    if (!CANON && up.randomized) {
      draw<D, REPLAY>(uc, base + 2, p, P, key, u_swarm);
#pragma unroll
      for (int d = 0; d < D; ++d) v[d] = (w * uc[d]) * v[d];
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) v[d] = w * v[d];
    }
    draw<D, REPLAY>(uc, base, p, P, key, u_swarm);
    draw<D, REPLAY>(us, base + 1, p, P, key, u_swarm);
    float gb[Sh::kD4], lo[Sh::kD4], hi[Sh::kD4];
    load4(gb, g_row);
    load4(lo, sh.lo);
    load4(hi, sh.hi);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float vd = v[d] + c1 * uc[d] * (lb[d] - x[d]) + c2 * us[d] * (gb[d] - x[d]);
      v[d] = vd;
      x[d] = fminf(fmaxf(x[d] + vd, lo[d]), hi[d]);
    }
    const float f = eval(x);
    if (f < lval) {
      lval = f;
#pragma unroll
      for (int d = 0; d < D; ++d) lb[d] = x[d];
    }
  }

  float best;
  int win;
  refresh(best, win);
  if (p == win) {
#pragma unroll
    for (int d = 0; d < D; ++d) out_gbest[static_cast<long long>(s) * D + d] = lb[d];
    out_gval[s] = lval;
  }
}

// A short chain's launch at thread bound TH: the canonical instantiation
// (CANON: canonical inertia, gbest every iteration, no re-kick, its
// branches gone at compile time) where the update is that and the draws
// are Philox's, at the short bound only; else the run-time branches.
template <class T, int C, bool O, int TH>
static cudaError_t launch_fused_solve_short(bool replay, const float* meta, int M,
                                            const float* swarm, int K, const float* limits,
                                            const int* seeds, const float* inertia,
                                            int iters, float c1, float c2, float vscale,
                                            int init_mode, Scene scene, Update up,
                                            const float* uniforms, int n_draws,
                                            float* gbest, float* gval, int S, int P,
                                            cudaStream_t stream) {
  static_assert(ShortChain<T>::value, "the register layout without streamed draws");
  constexpr size_t kStatic = sizeof(ShortShared<T, C, O, TH>);
  constexpr bool kCanon = TH == kShortThreads;
  if (P > TH) return cudaErrorInvalidValue;
  const bool canon = kCanon && !replay && !up.randomized && up.gbest_interval == 1 &&
                     up.rekick_interval == 0;
  static const int most_replay =
      allow_dynamic_smem(fused_solve_short_kernel<T, C, O, true, TH, false>, kStatic);
  static const int most_philox =
      allow_dynamic_smem(fused_solve_short_kernel<T, C, O, false, TH, false>, kStatic);
  const size_t smem = kernel_a_smem_bytes(M, K, T::D, P, 0);
  if (smem > static_cast<size_t>(replay ? most_replay : most_philox)) {
    return cudaErrorInvalidValue;
  }
#define IKPSO_SHORT_ARGS                                                              \
  meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2, vscale, init_mode, scene, up, \
      uniforms, n_draws, gbest, gval
  if (replay) {
    fused_solve_short_kernel<T, C, O, true, TH, false><<<S, P, smem, stream>>>(
        IKPSO_SHORT_ARGS);
  } else if (canon) {
    if constexpr (kCanon) {
      static const int most_canon =
          allow_dynamic_smem(fused_solve_short_kernel<T, C, O, false, TH, true>, kStatic);
      if (smem > static_cast<size_t>(most_canon)) return cudaErrorInvalidValue;
      fused_solve_short_kernel<T, C, O, false, TH, true><<<S, P, smem, stream>>>(
          IKPSO_SHORT_ARGS);
    }
  } else {
    fused_solve_short_kernel<T, C, O, false, TH, false><<<S, P, smem, stream>>>(
        IKPSO_SHORT_ARGS);
  }
#undef IKPSO_SHORT_ARGS
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Kernel A's register-layout trees (TreeLoop: DualArm14, Humanoid45,
// ReferenceArm, Snake30, and an on-demand key placed so: their twins with
// the orientation or distance term, exact trig or a scene, and the trees
// of 18-45 DOFs), fused_solve_tree_kernel: fused_solve_kernel's
// arithmetic, draws and first-minimum rule, op for op, with the short
// chains' devices for what issues around them and for the registers:
//   - the walk's constants (the swarm row's head, meta's head) and the
//     limits in 16-byte aligned static shared memory (ShortShared), read at
//     compile-time offsets, the limits as float4; the angle weight's
//     division by N - 1 computed once (JointWeights);
//   - what a thread would otherwise hold in registers across the walk read
//     again where it is used: the swarm's Philox key from static shared
//     memory for an update's draws (once, or at 64 registers a thread for
//     each group of four DOFs, its round keys then computed once a group)
//     and the replay's base at each draw, and the
//     root's frame (a constant of the swarm row) for each of the root's
//     children (fk_fitness_walk's RELOAD_ROOT), through volatile loads, so
//     that x, the walk and the draws fit the registers without a spill (an
//     H100 build: 128 registers for the humanoid, 64 for the dual arm at
//     1,024 threads, 80 for reference_arm and snake_30dof at 256 threads
//     and three blocks an SM, PERF.md); with a scene at 64 registers also
//     lval (from the particle's row) and the locality weights (kLean);
//   - v and lbest in dynamic shared memory as one row a particle (v in
//     [0, D4), lbest in [D4, 2 D4), D4 = D rounded up to 4; tree_row(D)
//     floats, an odd number of float4, so the 8 threads of a 16-byte access
//     phase meet 8 disjoint bank quads), read and written a float4 at a
//     time at compile-time offsets from the row's start: no address is kept
//     for a DOF (the [D][P] planes of fused_solve_kernel are P floats apart,
//     P a run-time value);
//   - gbest in one barrier: each warp's (least order_key, least id) by two
//     __reduce_min_sync, the warp copies its winner's lbest row into a warp
//     slot (a float4 a lane) and lane 0 writes the key and id; after the
//     barrier every thread takes the first least key over the warp slots
//     (two more __reduce_min_sync) and reads the winner's row in place. Two
//     slot sets taken in turn keep a refresh's writes off the previous
//     refresh's reads, as in the short chains.
// Must match TREE_LOOP_IDS in ikpso_tpu_torch/utils/kernels.py; an
// on-demand topology's choice is set in on_demand.cuh (IKPSO_OD_TREE).
template <class T>
struct TreeLoop {
  static constexpr bool value = false;
};
template <>
struct TreeLoop<DualArm14> {
  static constexpr bool value = true;
};
template <>
struct TreeLoop<Humanoid45> {
  static constexpr bool value = true;
};
template <>
struct TreeLoop<ReferenceArm> {
  static constexpr bool value = true;
};
template <>
struct TreeLoop<Snake30> {
  static constexpr bool value = true;
};

// A particle's row of v and lbest in fused_solve_tree_kernel: 2 D4 floats
// rounded up to an odd number of float4 (2 D4 + 4: 2 D4 is a multiple of
// 8), the first float after them lval with kLean.
__host__ __device__ constexpr int tree_row(int D) {
  return round4(D) / 2 % 2 ? 2 * round4(D) : 2 * round4(D) + 4;
}
// fused_solve_tree_kernel's static shared memory: the short chains' (the
// constants, the limits and the warp slots), then the swarm's Philox key,
// the replay's base and the two locality weights over the joint count
// (JointWeights, read there with kLean), its size a multiple of 16 bytes
// (the card rounds a kernel's static shared memory so, and the launcher
// subtracts this size from the opt-in maximum). Must match
// tree_static_bytes in ikpso_tpu_torch/utils/kernels.py.
template <class T, int C, bool O, int TH>
struct __align__(16) TreeShared {
  ShortShared<T, C, O, TH> c;
  unsigned key[2];
  const float* u;
  float jw[2];
};
// fused_solve_tree_kernel's dynamic shared memory: meta (M floats, rounded
// up to 4: the scene boxes and, with a scene, the orientation weight), then
// P rows. Must match tree_smem_bytes in ikpso_tpu_torch/utils/kernels.py.
static size_t tree_smem_bytes(int M, int D, int P) {
  return sizeof(float) * (static_cast<size_t>(round4(M)) + static_cast<size_t>(P) * tree_row(D));
}

template <class T, int C, bool O, bool REPLAY>
__global__ void __launch_bounds__(KernelAThreads<T>::value, KernelAMinBlocks<T>::value)
    fused_solve_tree_kernel(const float* __restrict__ meta, int M,
                            const float* __restrict__ swarm, int K,
                            const float* __restrict__ limits, const int* __restrict__ seeds,
                            const float* __restrict__ inertia, int iters, float c1, float c2,
                            float vscale, int init_mode, Scene scene, Update up,
                            const float* __restrict__ uniforms, int n_draws,
                            float* __restrict__ out_gbest, float* __restrict__ out_gval) {
  constexpr int D = T::D;
  using Sh = ShortShared<T, C, O, KernelAThreads<T>::value>;
  constexpr int kD4 = Sh::kD4;
  constexpr int kGroups = kD4 / 4;
  constexpr int kRow4 = tree_row(D) / 4;
  static_assert(kGroups <= 32, "a warp copies a row a float4 a lane");
  static_assert(tree_row(D) > 2 * kD4, "lval's place in the row");
  // Where a thread may hold more than 64 registers (the bound and the
  // least blocks an SM leave it 65,536 / (threads x blocks)) the update
  // reads the key once, and the refresh and kick schedules are it %
  // interval, not countdowns held in registers: the humanoid (128) then
  // fits without a spill and ran 9% faster than with the key read once a
  // group, and reference_arm (80) fits only so; at 64 registers (the dual
  // arm's 1,024-thread bound) only the key read once a group fits (an
  // H100, PERF.md, tools/kernel_a_tree_variants.py).
  constexpr bool kKeyOnce =
      65536 / (KernelAThreads<T>::value * KernelAMinBlocks<T>::value) > 64;
  // With a scene at 64 registers (the dual arm's capsule twin) the
  // collider takes the registers that lval, the locality weights and the
  // countdowns held across the solve: lval lives in the particle's row, the
  // weights in static shared memory, read where the walk adds them, and the
  // schedules are it % interval (the capsule twin spilled 24 bytes without,
  // 0 with; the trees without a scene ran ~1% slower with such reads,
  // PERF.md).
  constexpr bool kLean = C != kNoCollider && !kKeyOnce;
  __shared__ __align__(16) TreeShared<T, C, O, KernelAThreads<T>::value> ts;
  Sh& sh = ts.c;
  extern __shared__ float smem[];  // meta, then the rows (tree_smem_bytes)

  const int s = blockIdx.x;
  const int P = blockDim.x;
  const int p = threadIdx.x;
  const float* row = swarm + static_cast<long long>(s) * K;
  for (int i = p; i < Sh::kSw; i += P) sh.sw[i] = i < K ? row[i] : 0.0f;
  for (int i = p; i < Sh::kMeta; i += P) sh.meta[i] = i < M ? meta[i] : 0.0f;
  for (int i = p; i < kD4; i += P) {
    sh.lo[i] = i < D ? limits[i] : 0.0f;
    sh.hi[i] = i < D ? limits[D + i] : 0.0f;
  }
  for (int i = p; i < M; i += P) smem[i] = meta[i];
  // This particle's row (v in float4 [0, kGroups), lbest in [kGroups, 2
  // kGroups)); particle q's is (q - p) kRow4 float4 on from it.
  float4* const v4 = reinterpret_cast<float4*>(smem + round4(M)) + p * kRow4;
  float4* const lb4 = v4 + kGroups;
  if (p == 0) {
    if constexpr (kLean) {
      const JointWeights w = joint_weights<T>(meta);
      ts.jw[0] = w.angle;
      ts.jw[1] = w.distance;
    }
    ts.key[0] = static_cast<unsigned>(seeds[2 * s]);
    ts.key[1] = static_cast<unsigned>(seeds[2 * s + 1]);
    ts.u = REPLAY ? uniforms + static_cast<long long>(s) * n_draws * D * P : nullptr;
  }
  __syncthreads();

  // The swarm's Philox key, read again for an update's draws (for each
  // group of them, or once: kKeyOnce below) and once for the init's and a
  // kick's, so no register holds it across the walk; the replay's base,
  // read at each draw.
  auto key = [&]() -> uint2 {
    if constexpr (REPLAY) return make_uint2(0u, 0u);
    const volatile unsigned* k = ts.key;
    return make_uint2(k[0], k[1]);
  };
  auto u_swarm = [&]() -> const float* {
    if constexpr (!REPLAY) return nullptr;
    return *reinterpret_cast<const float* const volatile*>(&ts.u);
  };
  const JointWeights jw = kLean ? JointWeights{0.0f, 0.0f} : joint_weights<T>(sh.meta);
  const float row_slack = box_row_slack<T, C>(smem, sh.sw, scene);
  // The walk reads the root's frame again for each of its children
  // (RELOAD_ROOT), but in the replay with the orientation term, where ptxas
  // fits the walk without a spill only with the frame held (an H100 build:
  // PERF.md, tools/kernel_a_tree_variants.py).
  constexpr bool kReloadRoot = !(REPLAY && O);
  auto weights = [&] {
    if constexpr (kLean) {
      const volatile float* w = ts.jw;
      return JointWeights{w[0], w[1]};
    } else {
      return jw;
    }
  };
  auto eval = [&](const float (&xe)[D]) {
    const float* obs = C == kNoCollider ? sh.meta + meta_obs<T>() : smem + meta_obs<T>();
    return fk_fitness_walk<T, C, O, kReloadRoot>([&](int d) { return xe[d]; }, sh.meta,
                                                 sh.sw, obs, weights, scene, row_slack);
  };
  auto unpack = [](const float4 q, float (&r)[4]) {
    r[0] = q.x;
    r[1] = q.y;
    r[2] = q.z;
    r[3] = q.w;
  };
  const float4* lo4 = reinterpret_cast<const float4*>(sh.lo);
  const float4* hi4 = reinterpret_cast<const float4*>(sh.hi);

  float x[D], uc[4], us[4];
  const int n_init = init_mode == kInitWarm ? 1 : 2;
  if (init_mode == kInitWarm || (init_mode == kInitHybrid && p == 0)) {
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = sh.sw[kSwAnchor + d];
  }
  {
    const bool draw_x = init_mode == kInitUniform || (init_mode == kInitHybrid && p != 0);
    const uint2 kd = key();
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (draw_x) draw_group<REPLAY>(us, g, 0, D, p, P, kd, u_swarm());
      draw_group<REPLAY>(uc, g, n_init - 1, D, p, P, kd, u_swarm());
      float los[4], his[4], vs[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ls[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      unpack(lo4[g], los);
      unpack(hi4[g], his);
#pragma unroll
      for (int j = 0; j < 4 && 4 * g + j < D; ++j) {
        const int d = 4 * g + j;
        if (draw_x) {
          constexpr float kTwoPi = 0x1.921fb6p+2f;
          const float lo_c = fmaxf(los[j], -kTwoPi);
          const float hi_c = fminf(his[j], kTwoPi);
          x[d] = lo_c + us[j] * (hi_c - lo_c);
        }
        vs[j] = (uc[j] * 2.0f - 1.0f) * vscale;
        ls[j] = x[d];
      }
      v4[g] = make_float4(vs[0], vs[1], vs[2], vs[3]);
      lb4[g] = make_float4(ls[0], ls[1], ls[2], ls[3]);
    }
  }
  // lval: in the particle's row with kLean, else in a register.
  float lval_reg = 0.0f;
  volatile float* const s_lval = reinterpret_cast<float*>(lb4 + kGroups);
  auto lval = [&]() -> float {
    if constexpr (kLean) return *s_lval;
    return lval_reg;
  };
  auto set_lval = [&](float v) {
    if constexpr (kLean) {
      *s_lval = v;
    } else {
      lval_reg = v;
    }
  };
  set_lval(eval(x));

  int buf = 0;
  auto refresh = [&](float& best, int& win) -> const float4* {
    const unsigned k = order_key(lval());
    const unsigned wk = __reduce_min_sync(0xffffffffu, k);
    const unsigned wi =
        __reduce_min_sync(0xffffffffu, k == wk ? static_cast<unsigned>(p) : 0xffffffffu);
    const int warp = p >> 5, lane = p & 31;
    // The winner's lbest row, written by that lane, seen by its warp.
    __syncwarp();
    if (lane < kGroups) {
      reinterpret_cast<float4*>(sh.lb[buf][warp])[lane] =
          lb4[(static_cast<int>(wi) - p) * kRow4 + lane];
    }
    if (lane == 0) {
      sh.key[buf][warp] = wk;
      sh.id[buf][warp] = static_cast<int>(wi);
    }
    __syncthreads();
    // The first least key over the warps in order (warps hold ascending ids).
    const unsigned kw = lane < (P >> 5) ? sh.key[buf][lane] : 0xffffffffu;
    const unsigned bk = __reduce_min_sync(0xffffffffu, kw);
    const int ww = static_cast<int>(
        __reduce_min_sync(0xffffffffu, kw == bk ? static_cast<unsigned>(lane) : 32u));
    best = key_value(bk);
    win = sh.id[buf][ww];
    const float4* g = reinterpret_cast<const float4*>(sh.lb[buf][ww]);
    buf ^= 1;
    return g;
  };

  const int dpi = (up.randomized ? 3 : 2) + (up.rekick_interval > 0 ? 1 : 0);
  constexpr bool kModSchedule = kKeyOnce || kLean;
  // Countdowns to the next gbest refresh and the next kick block start
  // (it % gbest_interval == 0; it % rekick_interval == 0 and it > 0).
  int refresh_in = 0;
  int kick_in = up.rekick_interval;
  const float4* g_row = reinterpret_cast<const float4*>(sh.lb[0][0]);
  for (int it = 0; it < iters; ++it) {
    bool kick, refresh_now;
    if constexpr (kModSchedule) {
      kick = up.rekick_interval > 0 && it > 0 && it % up.rekick_interval == 0;
      refresh_now = it % up.gbest_interval == 0;
    } else {
      kick = up.rekick_interval > 0 && kick_in == 0;
      kick_in = (kick ? up.rekick_interval : kick_in) - 1;
      refresh_now = refresh_in == 0;
      if (refresh_now) refresh_in = up.gbest_interval;
      --refresh_in;
    }
    if (refresh_now) {
      float best;
      int win;
      g_row = refresh(best, win);
      if (kick && (up.rekick_threshold < 0.0f || best > up.rekick_threshold)) {
        const int slot = n_init + it * dpi + dpi - 1;
        const uint2 kd = key();
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          draw_group<REPLAY>(uc, g, slot, D, p, P, kd, u_swarm());
          float vs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int j = 0; j < 4 && 4 * g + j < D; ++j) {
            vs[j] = (uc[j] * 2.0f - 1.0f) * up.rekick_scale;
          }
          v4[g] = make_float4(vs[0], vs[1], vs[2], vs[3]);
        }
      }
    }
    // The inertia term first (w * v, or (w * u_w) * v), rounded into v.
    const int base = n_init + it * dpi;
    const float w = inertia[it];
    const uint2 k_update = kKeyOnce ? key() : make_uint2(0u, 0u);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const uint2 kd = kKeyOnce ? k_update : key();
      float uw[4];
      if (up.randomized) draw_group<REPLAY>(uw, g, base + 2, D, p, P, kd, u_swarm());
      draw_group<REPLAY>(uc, g, base, D, p, P, kd, u_swarm());
      draw_group<REPLAY>(us, g, base + 1, D, p, P, kd, u_swarm());
      float vs[4], ls[4], gs[4], los[4], his[4];
      unpack(v4[g], vs);
      unpack(lb4[g], ls);
      unpack(g_row[g], gs);
      unpack(lo4[g], los);
      unpack(hi4[g], his);
#pragma unroll
      for (int j = 0; j < 4 && 4 * g + j < D; ++j) {
        const int d = 4 * g + j;
        float vd = vs[j];
        vd = up.randomized ? (w * uw[j]) * vd : w * vd;
        vd = vd + c1 * uc[j] * (ls[j] - x[d]) + c2 * us[j] * (gs[j] - x[d]);
        vs[j] = vd;
        x[d] = fminf(fmaxf(x[d] + vd, los[j]), his[j]);
      }
      v4[g] = make_float4(vs[0], vs[1], vs[2], vs[3]);
    }
    const float f = eval(x);
    if (f < lval()) {
      set_lval(f);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        lb4[g] = make_float4(x[4 * g], 4 * g + 1 < D ? x[4 * g + 1] : 0.0f,
                             4 * g + 2 < D ? x[4 * g + 2] : 0.0f,
                             4 * g + 3 < D ? x[4 * g + 3] : 0.0f);
      }
    }
  }

  float best;
  int win;
  refresh(best, win);
  if (p == win) {
    const float* lb = reinterpret_cast<const float*>(lb4);
    for (int d = 0; d < D; ++d) out_gbest[static_cast<long long>(s) * D + d] = lb[d];
    out_gval[s] = lval();
  }
}

template <class T, int C, bool O = false>
static cudaError_t launch_fused_solve(bool replay, const float* meta, int M,
                                      const float* swarm, int K, const float* limits,
                                      const int* seeds, const float* inertia, int iters,
                                      float c1, float c2, float vscale, int init_mode,
                                      Scene scene, Update up, const float* uniforms,
                                      int n_draws, float* gbest, float* gval, int S,
                                      int P, cudaStream_t stream) {
  if (P > KernelAThreads<T>::value) return cudaErrorInvalidValue;
  if constexpr (ShortChain<T>::value) {
    return launch_fused_solve_short<T, C, O, KernelAThreads<T>::value>(
        replay, meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2, vscale, init_mode,
        scene, up, uniforms, n_draws, gbest, gval, S, P, stream);
  } else if constexpr (TreeLoop<T>::value) {
    static_assert(StreamDraws<T>::value && StatePlacement<T>::value == kShared,
                  "the tree loop streams its draws and keeps v and lbest in shared memory");
    constexpr size_t kStatic = sizeof(TreeShared<T, C, O, KernelAThreads<T>::value>);
    static const int most_replay =
        allow_dynamic_smem(fused_solve_tree_kernel<T, C, O, true>, kStatic);
    static const int most_philox =
        allow_dynamic_smem(fused_solve_tree_kernel<T, C, O, false>, kStatic);
    const size_t smem = tree_smem_bytes(M, T::D, P);
    if (smem > static_cast<size_t>(replay ? most_replay : most_philox)) {
      return cudaErrorInvalidValue;
    }
    if (replay) {
      fused_solve_tree_kernel<T, C, O, true><<<S, P, smem, stream>>>(
          meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2, vscale, init_mode,
          scene, up, uniforms, n_draws, gbest, gval);
    } else {
      fused_solve_tree_kernel<T, C, O, false><<<S, P, smem, stream>>>(
          meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2, vscale, init_mode,
          scene, up, uniforms, n_draws, gbest, gval);
    }
    return cudaSuccess;
  } else {
    static const int most_replay = allow_dynamic_smem(fused_solve_kernel<T, C, O, true>);
    static const int most_philox = allow_dynamic_smem(fused_solve_kernel<T, C, O, false>);
    const size_t smem = kernel_a_smem_bytes(M, K, T::D, P,
                                            StatePlacement<T>::value == kShared ? 2 : 0);
    if (smem > static_cast<size_t>(replay ? most_replay : most_philox)) {
      return cudaErrorInvalidValue;
    }
    if (replay) {
      fused_solve_kernel<T, C, O, true><<<S, P, smem, stream>>>(
          meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2, vscale, init_mode,
          scene, up, uniforms, n_draws, gbest, gval);
    } else {
      fused_solve_kernel<T, C, O, false><<<S, P, smem, stream>>>(
          meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2, vscale, init_mode,
          scene, up, uniforms, n_draws, gbest, gval);
    }
    return cudaSuccess;
  }
}

// Kernel A on the prebuilt short chains (fused_solve_short.cu): topology
// id 0 (Arm7Dof) with collider C, id 2 (Arm6Dof) without a scene, with or
// without the orientation term, at thread bound `threads` (kShortThreads,
// or the topology's KernelAThreads); cudaErrorInvalidValue for any other.
cudaError_t launch_short_prebuilt(int topo, int collider, bool orient, int threads,
                                  bool replay, const float* meta, int M, const float* swarm,
                                  int K, const float* limits, const int* seeds,
                                  const float* inertia, int iters, float c1, float c2,
                                  float vscale, int init_mode, Scene scene, Update up,
                                  const float* uniforms, int n_draws, float* gbest,
                                  float* gval, int S, int P, cudaStream_t stream);

// ---------------------------------------------------------------------------
// Kernel A's serial-chain variant: any chain whose node k hangs off node
// k - 1 with its one effector at the last node, n nodes at run time
// (snake:<links>: the compile-time topologies are a fixed list, and their
// parent words stop at 16 nodes).
//
// What rules out the design above: at snake:50 (D = 150) x, v and lbest
// are 450 floats a thread, and at P = 256 a thread has at most 255
// registers, and v and lbest together in shared memory would take 307 KB
// of a block's 227 KB. Here x and v live in global scratch laid out
// [block][planes][D][P] (x, v, then lbest where it is not in shared
// memory), so for each d a warp touches 32 consecutive floats, and a grid
// of the blocks that fit the card at once strides over the swarms, so the
// scratch is grid x planes x D x P floats (the wrapper allocates it), not
// S x planes x D x P. lbest goes to dynamic shared memory ([D][P] after
// the argmin scratch, kernel_a_smem_bytes) where the launcher is asked to
// (LB_SHARED; the serial variant takes it as a run-time argument, a tree a
// compile-time one, StatePlacement): that cuts the scratch traffic from ~7
// D to ~5 D floats a particle-evaluation, but at snake:50's P = 256 its
// 153.6 KB leave room for one block an SM where four fit without it.
// gbest, the limits, meta and the swarm row stay in shared memory, as
// above.
//
// The same layout serves a compile-time tree whose state outgrows the
// registers (fused_solve_tree_scratch_kernel, built on demand; a branching
// tree of up to 60 DOFs takes the cluster layout where a cluster holds its
// swarm, fused_solve_cluster.cuh):
// the walk is a template parameter of the shared body, scratch_solve.
//
// Everything else is the compile-time kernel's, in the same order: the
// Philox counter layout and draw slots, uniforms drawn four DOFs at a time
// (draw_group), the replay layout [S, n_draws, D, P], the inits, the
// inertia modes, gbest_interval, the re-kick and its threshold, and the
// first-minimum argmin with the lowest id on ties; so fused_solve_plain
// stays its bit-for-bit twin. An iteration updates every DOF (x and v back
// to the scratch), then walks the chain reading x back
// (fk_fitness_eval_serial); a better particle copies x into its lbest.
//
// Bound on this card: the same work as the compile-time kernel (the
// function's bytes are still the constants in and one row out a swarm),
// but each particle-evaluation also moves ~7 D floats of scratch through
// L2 and HBM (x, v and lbest read, x and v written, x read back, lbest
// written where better; ~5 D with lbest in shared memory): at snake:50
// ~4.2 KB against 15.6 k counted operations, so this variant is
// scratch-bound (share 0.11 on an H100, PERF.md).

constexpr int kSerialThreads = 1024;

// The walks of the scratch layout: a serial chain of n nodes at run time
// (fk_fitness_eval_serial), or a compile-time tree T with its collider C
// and orientation flag O (fk_fitness_eval_strided), each reading angle d
// of the particle at x[d * stride].
struct SerialWalk {
  int n;
  __device__ int dof() const { return 3 * (n - 1); }
  __device__ SerialWalk armed(const float*, const float*) const { return *this; }
  __device__ float operator()(const float* x, long long stride, const float* meta,
                              const float* sw) const {
    return fk_fitness_eval_serial(x, stride, n, meta, sw);
  }
};

template <class T, int C, bool O>
struct TreeWalk {
  Scene scene;
  __device__ static constexpr int dof() { return T::D; }
  float row_slack = INFINITY;
  // This walk for swarm row sw: its box reject's eps (box_row_slack).
  __device__ TreeWalk armed(const float* meta, const float* sw) const {
    return {scene, box_row_slack<T, C>(meta, sw, scene)};
  }
  __device__ float operator()(const float* x, long long stride, const float* meta,
                              const float* sw) const {
    return fk_fitness_eval_strided<T, C, O>(x, stride, meta, sw, scene, row_slack);
  }
};

// The scratch-layout solve (see above) for any walk W, lbest in shared
// memory where LB_SHARED; a grid of blocks strides over the S swarms.
template <class W, bool REPLAY, bool LB_SHARED>
__device__ __forceinline__ void scratch_solve(
    const W& walk, const float* __restrict__ meta, int M, const float* __restrict__ swarm,
    int K, const float* __restrict__ limits, const int* __restrict__ seeds,
    const float* __restrict__ inertia, int iters, float c1, float c2, float vscale,
    int init_mode, Update up, const float* __restrict__ uniforms, int n_draws,
    float* scratch, float* __restrict__ out_gbest, float* __restrict__ out_gval, int S) {
  const int D = walk.dof();
  const int groups = (D + 3) / 4;
  extern __shared__ float smem[];
  float* s_meta = smem;
  float* s_sw = s_meta + M;
  float* s_lo = s_sw + K;
  float* s_hi = s_lo + D;
  float* s_gb = s_hi + D;
  float* s_wval = s_gb + D;
  int* s_wid = reinterpret_cast<int*>(s_wval + 32);

  const int P = blockDim.x;
  const int p = threadIdx.x;
  const long long DP = static_cast<long long>(D) * P;
  // This thread's column of the block's scratch (and of lbest): element d
  // at [d * P].
  float* xg = scratch + blockIdx.x * (LB_SHARED ? 2 : 3) * DP + p;
  float* vg = xg + DP;
  float* lg;
  if constexpr (LB_SHARED) {
    lg = smem + smem_head_floats(M, K, D) + p;
  } else {
    lg = vg + DP;
  }
  for (int i = p; i < M; i += P) s_meta[i] = meta[i];
  for (int i = p; i < D; i += P) {
    s_lo[i] = limits[i];
    s_hi[i] = limits[D + i];
  }
  const int n_init = init_mode == kInitWarm ? 1 : 2;
  const int dpi = (up.randomized ? 3 : 2) + (up.rekick_interval > 0 ? 1 : 0);
  constexpr float kTwoPi = 0x1.921fb6p+2f;

  for (int s = blockIdx.x; s < S; s += gridDim.x) {
    // The previous swarm's last reads of s_sw, s_gb, lbest and the scratch
    // are done.
    __syncthreads();
    for (int i = p; i < K; i += P) s_sw[i] = swarm[static_cast<long long>(s) * K + i];
    __syncthreads();
    const W row_walk = walk.armed(s_meta, s_sw);
    const uint2 key = make_uint2(static_cast<unsigned>(seeds[2 * s]),
                                 static_cast<unsigned>(seeds[2 * s + 1]));
    const float* u_swarm =
        REPLAY ? uniforms + static_cast<long long>(s) * n_draws * DP : nullptr;

    const bool draw_x = init_mode == kInitUniform || (init_mode == kInitHybrid && p != 0);
    for (int g = 0; g < groups; ++g) {
      float ux[4], uv[4];
      if (draw_x) draw_group<REPLAY>(ux, g, 0, D, p, P, key, u_swarm);
      draw_group<REPLAY>(uv, g, n_init - 1, D, p, P, key, u_swarm);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 4 * g + j;
        if (d < D) {
          float xd = s_sw[kSwAnchor + d];
          if (draw_x) {
            const float lo_c = fmaxf(s_lo[d], -kTwoPi);
            const float hi_c = fminf(s_hi[d], kTwoPi);
            xd = lo_c + ux[j] * (hi_c - lo_c);
          }
          xg[d * P] = xd;
          lg[d * P] = xd;
          vg[d * P] = (uv[j] * 2.0f - 1.0f) * vscale;
        }
      }
    }
    float lval = row_walk(xg, P, s_meta, s_sw);

    int refresh_in = 0;
    int kick_in = up.rekick_interval;
    for (int it = 0; it < iters; ++it) {
      const bool kick = up.rekick_interval > 0 && kick_in == 0;
      kick_in = (kick ? up.rekick_interval : kick_in) - 1;
      if (refresh_in == 0) {
        refresh_in = up.gbest_interval;
        float best;
        const int win = block_argmin(lval, p, s_wval, s_wid, best);
        // block_argmin's barrier makes every thread's lbest writes visible:
        // the block copies the winner's column together.
        const float* lw = lg - p + win;
        for (int d = p; d < D; d += P) s_gb[d] = lw[d * P];
        __syncthreads();
        if (kick && (up.rekick_threshold < 0.0f || best > up.rekick_threshold)) {
          const int slot = n_init + it * dpi + dpi - 1;
          for (int g = 0; g < groups; ++g) {
            float uk[4];
            draw_group<REPLAY>(uk, g, slot, D, p, P, key, u_swarm);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (4 * g + j < D) {
                vg[(4 * g + j) * P] = (uk[j] * 2.0f - 1.0f) * up.rekick_scale;
              }
            }
          }
        }
      }
      --refresh_in;
      const int base = n_init + it * dpi;
      const float w = inertia[it];
      for (int g = 0; g < groups; ++g) {
        float uc[4], us[4], uw[4];
        if (up.randomized) draw_group<REPLAY>(uw, g, base + 2, D, p, P, key, u_swarm);
        draw_group<REPLAY>(uc, g, base, D, p, P, key, u_swarm);
        draw_group<REPLAY>(us, g, base + 1, D, p, P, key, u_swarm);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = 4 * g + j;
          if (d < D) {
            const float xd = xg[d * P];
            float vd = vg[d * P];
            vd = up.randomized ? (w * uw[j]) * vd : w * vd;
            vd = vd + c1 * uc[j] * (lg[d * P] - xd) + c2 * us[j] * (s_gb[d] - xd);
            xg[d * P] = fminf(fmaxf(xd + vd, s_lo[d]), s_hi[d]);
            vg[d * P] = vd;
          }
        }
      }
      const float f = row_walk(xg, P, s_meta, s_sw);
      if (f < lval) {
        lval = f;
        for (int d = 0; d < D; ++d) lg[d * P] = xg[d * P];
      }
    }

    float best;
    const int win = block_argmin(lval, p, s_wval, s_wid, best);
    const float* lw = lg - p + win;
    for (int d = p; d < D; d += P) out_gbest[static_cast<long long>(s) * D + d] = lw[d * P];
    if (p == win) out_gval[s] = lval;
  }
}

template <bool REPLAY, bool LB_SHARED>
__global__ void __launch_bounds__(kSerialThreads) fused_solve_serial_kernel(
    int n, const float* __restrict__ meta, int M, const float* __restrict__ swarm, int K,
    const float* __restrict__ limits, const int* __restrict__ seeds,
    const float* __restrict__ inertia, int iters, float c1, float c2, float vscale,
    int init_mode, Update up, const float* __restrict__ uniforms, int n_draws,
    float* scratch, float* __restrict__ out_gbest, float* __restrict__ out_gval, int S) {
  scratch_solve<SerialWalk, REPLAY, LB_SHARED>(
      SerialWalk{n}, meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2, vscale,
      init_mode, up, uniforms, n_draws, scratch, out_gbest, out_gval, S);
}

// The scratch layout for a compile-time tree whose x, v and lbest do not
// fit a thread's registers (an on-demand topology past 45 DOFs: the
// 21-keypoint hand's are 180 floats), with a scene and the orientation
// term as the register kernel takes them; its thread bound is the
// topology's (KernelAThreads), and lbest is in shared memory where its
// StatePlacement is kShared.
template <class T, int C, bool O, bool REPLAY>
__global__ void __launch_bounds__(KernelAThreads<T>::value) fused_solve_tree_scratch_kernel(
    Scene scene, const float* __restrict__ meta, int M, const float* __restrict__ swarm,
    int K, const float* __restrict__ limits, const int* __restrict__ seeds,
    const float* __restrict__ inertia, int iters, float c1, float c2, float vscale,
    int init_mode, Update up, const float* __restrict__ uniforms, int n_draws,
    float* scratch, float* __restrict__ out_gbest, float* __restrict__ out_gval, int S) {
  scratch_solve<TreeWalk<T, C, O>, REPLAY, StatePlacement<T>::value == kShared>(
      TreeWalk<T, C, O>{scene}, meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2,
      vscale, init_mode, up, uniforms, n_draws, scratch, out_gbest, out_gval, S);
}

}  // namespace ikpso
