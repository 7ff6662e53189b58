// Kernel A's cluster layout: the on-demand trees whose x, v and lbest
// outgrow one block (trees that branch, of 46-60 DOFs: utils/kernels.py,
// on_demand_key and tree_cluster), with a swarm's state kept on chip, the
// swarm spread over a thread-block cluster.
//
// What it replaces there: the scratch layout (scratch_solve in
// fused_solve.cuh) keeps x and v in a global scratch, so each
// particle-evaluation moves D floats of each through L2 and HBM, and its
// one 512-thread block an SM spills at 128 registers (hand21: 268 bytes).
// One swarm's state (3 x 60 x 512 floats at hand21, 368 KB) is larger than
// one SM's shared memory (227 KB a block), but fits the registers and
// shared memory of two SMs.
//
// The design (Hopper's thread-block clusters, sm_90):
//   - a swarm of P particles spans a cluster of c blocks (c = 1, 2 or 4,
//     chosen in Python: utils/kernels.py, cluster_size), each of Pb = P / c
//     threads <= kClusterThreads; particle p = rank * Pb + threadIdx.x keeps
//     its id in the swarm, so the Philox counters (draw_group), the replay
//     layout [S, n_draws, D, P] and the first-minimum rule are unchanged;
//   - x in registers, indexed at compile time: a tree's D is a template
//     constant;
//   - v and lbest in the block's own dynamic shared memory, a row of
//     cluster_row(D) floats a thread (cluster_row: D rounded up to a whole
//     number of float4, an odd one, so the 8 threads of a 16-byte access
//     phase meet 8 disjoint bank quads), read and written a float4 at a
//     time: group g of a thread's row sits at a compile-time offset from
//     the row's start, so no address is kept for it (at a [D / 4][P]
//     layout ptxas hoisted the group addresses and spilled them);
//   - gbest in two steps: each warp's (least order_key, least id) by two
//     __reduce_min_sync, the block's from the warp winners after one
//     barrier, published with the winner's lbest row in a slot of the
//     block's shared memory; then one cluster barrier, and every thread
//     takes the first least key over the c blocks' slots (read through
//     map_shared_rank; blocks in rank order hold ascending ids). A block
//     that does not own the winner copies its row into its own slot, the
//     owner reads its slot in place. Two slot sets taken in turn keep a
//     refresh's writes off the previous refresh's remote reads, which end
//     before the next cluster barrier;
//   - a grid of the clusters that fit the card at once
//     (cudaOccupancyMaxActiveClusters) strides over the swarms; no global
//     scratch.
// HBM then sees the constants in and one gbest row out a swarm. Everything
// else is the scratch layout's, op for op (-fmad=false): the inits, the
// inertia modes, gbest_interval, the re-kick and its threshold, so
// fused_solve_plain stays its bit-for-bit twin.
//
// Bound on this card: operations (the FK walk, Philox, the update) issued
// by 4-8 warps an SM -- one block of 128-256 threads an SM, at up to 255
// registers a thread, its v and lbest taking most of the SM's shared
// memory -- so the walk's dependent chains and the refresh's barriers are
// what the issue rate meets (hand21: ~0.45 of it on an H100, PERF.md).
// Where the scratch layout holds more warps an SM without spilling and the
// walk is one dependent chain (the serial chains, two to four blocks an
// SM; snake:20 among boxes at P = 256, two blocks an SM at 128 registers
// and 0 spill bytes), it stays faster (PERF.md): the chains keep it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fused_solve.cuh"

namespace ikpso {

// The most threads a block of the cluster layout takes (its
// __launch_bounds__, one block an SM: up to 255 registers a thread for x
// and the walk) and the most blocks a cluster has. Must match
// CLUSTER_THREADS and CLUSTER_SIZES in utils/kernels.py.
constexpr int kClusterThreads = 256;
constexpr int kClusterMax = 4;

// The cluster layout's walk on x as a register array of kDof floats: a
// compile-time tree T with its collider C and orientation flag O
// (fk_fitness_eval, as the register layout calls it). cluster_solve takes
// any walk W with these members: kDof, dof() (the DOFs at run time, at
// most kDof), armed(meta, sw) (the walk for a swarm row) and the call.
template <class T, int C, bool O>
struct TreeRegWalk {
  static constexpr int kDof = T::D;
  Scene scene;
  float row_slack = INFINITY;
  __device__ static constexpr int dof() { return T::D; }
  // This walk for swarm row sw: its box reject's eps (box_row_slack).
  __device__ TreeRegWalk armed(const float* meta, const float* sw) const {
    return {scene, box_row_slack<T, C>(meta, sw, scene)};
  }
  __device__ float operator()(const float (&x)[kDof], const float* __restrict__ meta,
                              const float* __restrict__ sw) const {
    return fk_fitness_eval<T, C, O>(x, meta, sw, scene, row_slack);
  }
};

// The cluster-layout solve (see above) for a register walk W, clusters of
// cl blocks.
template <class W, bool REPLAY>
__device__ __forceinline__ void cluster_solve(
    const W& walk, int cl, const float* __restrict__ meta, int M,
    const float* __restrict__ swarm, int K, const float* __restrict__ limits,
    const int* __restrict__ seeds, const float* __restrict__ inertia, int iters, float c1,
    float c2, float vscale, int init_mode, Update up, const float* __restrict__ uniforms,
    int n_draws, float* __restrict__ out_gbest, float* __restrict__ out_gval, int S) {
  namespace cg = cooperative_groups;
  constexpr int DB = W::kDof;
  constexpr int kGroups = (DB + 3) / 4;
  const int D = walk.dof();
  const int D4 = round4(D);
  const int R = cluster_row(D);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int Pb = blockDim.x;
  const int P = Pb * cl;
  const int t = threadIdx.x;
  const int p = rank * Pb + t;
  const int nwarps = Pb >> 5;

  extern __shared__ float smem[];
  float* s_lo = smem;
  float* s_hi = s_lo + D4;
  float* s_row = s_hi + D4;                                      // [2][D4]
  unsigned* s_slot = reinterpret_cast<unsigned*>(s_row + 2 * D4);  // [2][4]
  unsigned* s_wkey = s_slot + 8;
  int* s_wid = reinterpret_cast<int*>(s_wkey + 32);
  float* s_wval = reinterpret_cast<float*>(s_wid + 32);
  float* s_meta = s_wval + 32;
  float* s_sw = s_meta + M;
  // This block's lbest rows, and this thread's rows of v and lbest.
  float* lb_rows = smem + cluster_head_floats(M, K, D) + Pb * R;
  float4* s_v = reinterpret_cast<float4*>(smem + cluster_head_floats(M, K, D) + t * R);
  float4* s_lb = reinterpret_cast<float4*>(lb_rows + t * R);
  // Element d of particle q's lbest (q: its row in this block).
  auto lbest_at = [&](int d, int q) { return lb_rows[q * R + d]; };
  auto sync_cluster = [&] {
    if (cl > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };

  for (int i = t; i < D4; i += Pb) {
    s_lo[i] = i < D ? limits[i] : 0.0f;
    s_hi[i] = i < D ? limits[D + i] : 0.0f;
  }
  for (int i = t; i < M; i += Pb) s_meta[i] = meta[i];
  const int n_init = init_mode == kInitWarm ? 1 : 2;
  const int dpi = (up.randomized ? 3 : 2) + (up.rekick_interval > 0 ? 1 : 0);
  constexpr float kTwoPi = 0x1.921fb6p+2f;

  // gbest refresh: fills slot set `buf` (see above) and returns the
  // cluster winner's row; `best` gets its value.
  int buf = 0;
  auto refresh = [&](float lval, float& best) -> const float* {
    const unsigned k = order_key(lval);
    const unsigned wk = __reduce_min_sync(0xffffffffu, k);
    const unsigned wi =
        __reduce_min_sync(0xffffffffu, k == wk ? static_cast<unsigned>(p) : 0xffffffffu);
    if (static_cast<unsigned>(p) == wi) {
      s_wkey[t >> 5] = wk;
      s_wid[t >> 5] = p;
      s_wval[t >> 5] = lval;
    }
    __syncthreads();
    int ww = 0;
    for (int w = 1; w < nwarps; ++w) {
      if (s_wkey[w] < s_wkey[ww]) ww = w;
    }
    float* row = s_row + buf * D4;
    unsigned* slot = s_slot + buf * 4;
    const int q = s_wid[ww] - rank * Pb;
    for (int d = t; d < D; d += Pb) row[d] = lbest_at(d, q);
    if (t == 0) {
      slot[0] = s_wkey[ww];
      slot[1] = static_cast<unsigned>(s_wid[ww]);
      slot[2] = __float_as_uint(s_wval[ww]);
    }
    sync_cluster();
    int owner = rank;
    const unsigned* os = slot;
    for (int r = 0; r < cl; ++r) {
      const unsigned* rs = r == rank ? slot : cluster.map_shared_rank(slot, r);
      if (r == 0 || rs[0] < os[0]) {
        owner = r;
        os = rs;
      }
    }
    best = __uint_as_float(os[2]);
    if (owner != rank) {
      const float* orow = cluster.map_shared_rank(row, owner);
      for (int d = t; d < D; d += Pb) row[d] = orow[d];
      __syncthreads();
    }
    buf ^= 1;
    return row;
  };

  for (int s = blockIdx.x / cl; s < S; s += gridDim.x / cl) {
    // The previous swarm's last reads of s_sw are done.
    __syncthreads();
    for (int i = t; i < K; i += Pb) s_sw[i] = swarm[static_cast<long long>(s) * K + i];
    __syncthreads();
    const W row_walk = walk.armed(s_meta, s_sw);
    const uint2 key = make_uint2(static_cast<unsigned>(seeds[2 * s]),
                                 static_cast<unsigned>(seeds[2 * s + 1]));
    const float* u_swarm =
        REPLAY ? uniforms + static_cast<long long>(s) * n_draws * D * P : nullptr;

    float x[DB];
    const bool draw_x = init_mode == kInitUniform || (init_mode == kInitHybrid && p != 0);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float xs[4] = {0.0f, 0.0f, 0.0f, 0.0f}, vs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (4 * g < D) {
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
            xs[j] = xd;
            vs[j] = (uv[j] * 2.0f - 1.0f) * vscale;
          }
        }
        s_v[g] = make_float4(vs[0], vs[1], vs[2], vs[3]);
        s_lb[g] = make_float4(xs[0], xs[1], xs[2], xs[3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * g + j < DB) x[4 * g + j] = xs[j];
      }
    }
    float lval = row_walk(x, s_meta, s_sw);

    const float* gb = s_row;
    int refresh_in = 0;
    int kick_in = up.rekick_interval;
    for (int it = 0; it < iters; ++it) {
      const bool kick = up.rekick_interval > 0 && kick_in == 0;
      kick_in = (kick ? up.rekick_interval : kick_in) - 1;
      if (refresh_in == 0) {
        refresh_in = up.gbest_interval;
        float best;
        gb = refresh(lval, best);
        if (kick && (up.rekick_threshold < 0.0f || best > up.rekick_threshold)) {
          const int slot = n_init + it * dpi + dpi - 1;
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            if (4 * g < D) {
              float uk[4];
              draw_group<REPLAY>(uk, g, slot, D, p, P, key, u_swarm);
              float vs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (4 * g + j < D) vs[j] = (uk[j] * 2.0f - 1.0f) * up.rekick_scale;
              }
              s_v[g] = make_float4(vs[0], vs[1], vs[2], vs[3]);
            }
          }
        }
      }
      --refresh_in;
      const int base = n_init + it * dpi;
      const float w = inertia[it];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (4 * g < D) {
          float uc[4], us[4], uw[4];
          if (up.randomized) draw_group<REPLAY>(uw, g, base + 2, D, p, P, key, u_swarm);
          draw_group<REPLAY>(uc, g, base, D, p, P, key, u_swarm);
          draw_group<REPLAY>(us, g, base + 1, D, p, P, key, u_swarm);
          const float4 v4 = s_v[g];
          const float4 l4 = s_lb[g];
          const float4 g4 = *reinterpret_cast<const float4*>(gb + 4 * g);
          const float4 lo4 = *reinterpret_cast<const float4*>(s_lo + 4 * g);
          const float4 hi4 = *reinterpret_cast<const float4*>(s_hi + 4 * g);
          float vs[4] = {v4.x, v4.y, v4.z, v4.w};
          const float ls[4] = {l4.x, l4.y, l4.z, l4.w};
          const float gs[4] = {g4.x, g4.y, g4.z, g4.w};
          const float los[4] = {lo4.x, lo4.y, lo4.z, lo4.w};
          const float his[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int d = 4 * g + j;
            if (d < DB && d < D) {
              float vd = vs[j];
              vd = up.randomized ? (w * uw[j]) * vd : w * vd;
              vd = vd + c1 * uc[j] * (ls[j] - x[d]) + c2 * us[j] * (gs[j] - x[d]);
              vs[j] = vd;
              x[d] = fminf(fmaxf(x[d] + vd, los[j]), his[j]);
            }
          }
          s_v[g] = make_float4(vs[0], vs[1], vs[2], vs[3]);
        }
      }
      const float f = row_walk(x, s_meta, s_sw);
      if (f < lval) {
        lval = f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          if (4 * g < D) {
            s_lb[g] = make_float4(x[4 * g], 4 * g + 1 < DB ? x[4 * g + 1] : 0.0f,
                                           4 * g + 2 < DB ? x[4 * g + 2] : 0.0f,
                                           4 * g + 3 < DB ? x[4 * g + 3] : 0.0f);
          }
        }
      }
    }

    float best;
    const float* win = refresh(lval, best);
    if (rank == 0) {
      for (int d = t; d < D; d += Pb) out_gbest[static_cast<long long>(s) * D + d] = win[d];
      if (t == 0) out_gval[s] = best;
    }
  }
  // No block leaves while another of its cluster may still read its slots.
  if (cl > 1) cluster.sync();
}

template <class T, int C, bool O, bool REPLAY>
__global__ void __launch_bounds__(kClusterThreads, 1) fused_solve_tree_cluster_kernel(
    Scene scene, int cl, const float* __restrict__ meta, int M,
    const float* __restrict__ swarm, int K, const float* __restrict__ limits,
    const int* __restrict__ seeds, const float* __restrict__ inertia, int iters, float c1,
    float c2, float vscale, int init_mode, Update up, const float* __restrict__ uniforms,
    int n_draws, float* __restrict__ out_gbest, float* __restrict__ out_gval, int S) {
  cluster_solve<TreeRegWalk<T, C, O>, REPLAY>(
      TreeRegWalk<T, C, O>{scene}, cl, meta, M, swarm, K, limits, seeds, inertia, iters, c1,
      c2, vscale, init_mode, up, uniforms, n_draws, out_gbest, out_gval, S);
}

// A cluster-layout kernel's launch configuration: `grid` blocks in clusters
// of cl, Pb threads a block, smem bytes of dynamic shared memory.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int grid, int cl, int Pb, size_t smem, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cl);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(static_cast<unsigned>(grid));
    cfg.blockDim = dim3(static_cast<unsigned>(Pb));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The most clusters of `kernel` (cl blocks of Pb threads, smem bytes each)
// the card holds at once; <= 0 on an error or where none fits.
template <class F>
static int active_clusters(F kernel, int most_smem, int cl, int Pb, size_t smem) {
  if (smem > static_cast<size_t>(most_smem)) return -1;
  ClusterLaunch l(cl, cl, Pb, smem, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &l.cfg) != cudaSuccess) return -1;
  return n;
}

// Whether a swarm of P particles can run in clusters of cl blocks.
__host__ __device__ constexpr bool cluster_shape_ok(int cl, int P) {
  return (cl == 1 || cl == 2 || cl == kClusterMax) && P > 0 && P % (32 * cl) == 0 &&
         P / cl <= kClusterThreads;
}

}  // namespace ikpso
