// Kernel A's serial-chain variant in the cluster layout
// (ikpso_tpu_torch/csrc/fused_solve_cluster.cuh): a design variant that
// tools/kernel_a_cluster_variants.py builds and times against the scratch
// layout the serial chains run. Not in the port's library: on an H100 it
// ran 1.2-2.5x slower than the scratch layout on snake:16 to snake:50 (one
// block of <= 256 threads an SM at 247 registers, against the scratch
// layout's two to four blocks; PERF.md).
//
// x in registers needs its indices at compile time, so the walk is
// unrolled to a bucket of kSerialBucket nodes and takes node k where
// k < n: any chain of 2..kSerialBucket nodes runs it, at the register cost
// of the bucket's x. The bucket is sized for the longest chain that fits
// the layout at the snakes' P = 256 (snake:50, D = 150: x and the walk
// within 255 registers, v and lbest 153.6 KB a block at c = 2). A key per
// node count built on demand would fit each chain's x exactly, but costs a
// 42-71 s build at first use of every chain length.
//
// Build: nvcc with the port's flags (utils/kernels.py, NVCC_FLAGS),
// -I ikpso_tpu_torch/csrc. With -DIKPSO_CLUSTER_LB_GLOBAL=1 lbest sits in
// a global scratch of the resident blocks (P / c rows of cluster_row(D)
// floats a block, at ikpso_lb_scratch) instead of shared memory; that
// build includes a copy of fused_solve_cluster.cuh whose lbest rows start
// there (the script's lb_global_header).
#include <cuda_runtime.h>

#ifndef IKPSO_CLUSTER_LB_GLOBAL
#define IKPSO_CLUSTER_LB_GLOBAL 0
#endif

#if IKPSO_CLUSTER_LB_GLOBAL
__device__ float* ikpso_lb_scratch;
#endif

#include "fused_solve_cluster.cuh"

using namespace ikpso;

namespace {

constexpr int kSerialBucket = 51;
constexpr bool kLbGlobal = IKPSO_CLUSTER_LB_GLOBAL != 0;

// fk_fitness_eval_serial (fk_fitness.cuh) on a register array, its node
// loop unrolled to NB nodes, node k taken where k < n; the same op order.
template <int NB>
__device__ __forceinline__ float serial_walk(const float (&x)[3 * (NB - 1)], int n,
                                             const float* __restrict__ meta,
                                             const float* __restrict__ sw) {
  const int d_total = 3 * (n - 1);
  const int meta_ew = kMetaLen + (n - 1);
  const int sw_tgt = kSwAnchor + d_total;
  float rot[9], pos[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) rot[i] = sw[kSwRoot + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) pos[i] = sw[kSwOrigin + i];
  float rot_diff = 0.0f;
#pragma unroll
  for (int k = 1; k < NB; ++k) {
    if (k < n) {
      const int d0 = 3 * (k - 1);
      const float ax = x[d0], ay = x[d0 + 1], az = x[d0 + 2];
      float local[9], world[9];
      rot_xyz(ax, ay, az, local);
      mat_mul(rot, local, world);
#pragma unroll
      for (int i = 0; i < 9; ++i) rot[i] = world[i];
      const float len = meta[kMetaLen + (k - 1)];
      pos[0] = pos[0] + len * rot[0];
      pos[1] = pos[1] + len * rot[3];
      pos[2] = pos[2] + len * rot[6];
      const float da = ax - sw[kSwAnchor + d0];
      const float db = ay - sw[kSwAnchor + d0 + 1];
      const float dc = az - sw[kSwAnchor + d0 + 2];
      rot_diff = rot_diff + (da * da + db * db + dc * dc);
    }
  }
  const float ex = pos[0] - sw[sw_tgt];
  const float ey = pos[1] - sw[sw_tgt + 1];
  const float ez = pos[2] - sw[sw_tgt + 2];
  const float cost = meta[meta_ew] * (ex * ex + ey * ey + ez * ez);
  return cost + (meta[kMetaAw] / static_cast<float>(n - 1)) * rot_diff;
}

// A serial chain of n <= NB nodes as cluster_solve's register walk.
template <int NB>
struct SerialRegWalk {
  static constexpr int kDof = 3 * (NB - 1);
  int n;
  __device__ int dof() const { return 3 * (n - 1); }
  __device__ SerialRegWalk armed(const float*, const float*) const { return *this; }
  __device__ float operator()(const float (&x)[kDof], const float* __restrict__ meta,
                              const float* __restrict__ sw) const {
    return serial_walk<NB>(x, n, meta, sw);
  }
};

template <bool REPLAY>
__global__ void __launch_bounds__(kClusterThreads, 1) serial_cluster_kernel(
    int n, int cl, const float* __restrict__ meta, int M, const float* __restrict__ swarm,
    int K, const float* __restrict__ limits, const int* __restrict__ seeds,
    const float* __restrict__ inertia, int iters, float c1, float c2, float vscale,
    int init_mode, Update up, const float* __restrict__ uniforms, int n_draws,
    float* __restrict__ out_gbest, float* __restrict__ out_gval, int S) {
  cluster_solve<SerialRegWalk<kSerialBucket>, REPLAY>(
      SerialRegWalk<kSerialBucket>{n}, cl, meta, M, swarm, K, limits, seeds, inertia, iters,
      c1, c2, vscale, init_mode, up, uniforms, n_draws, out_gbest, out_gval, S);
}

// The kernel for a replay flag, allowed the card's opt-in shared memory
// (once per instantiation); most is that maximum, 0 on an error.
template <bool REPLAY>
auto allowed_kernel(int& most) {
  static const int allowed = allow_dynamic_smem(serial_cluster_kernel<REPLAY>);
  most = allowed;
  return serial_cluster_kernel<REPLAY>;
}

// The lb_global build keeps one plane (v) of the two.
size_t serial_cluster_smem(int M, int K, int n_nodes, int Pb) {
  const int D = 3 * (n_nodes - 1);
  return cluster_smem_bytes(M, K, D, Pb) -
         (kLbGlobal ? sizeof(float) * static_cast<size_t>(cluster_row(D)) * Pb : 0);
}

bool serial_cluster_ok(int cl, int P, int n_nodes) {
  return n_nodes >= 2 && n_nodes <= kSerialBucket && cluster_shape_ok(cl, P);
}

}  // namespace

// The bucket's node count.
extern "C" int ikpso_serial_cluster_bucket() { return kSerialBucket; }

// How many clusters of cl blocks fit the card at once (the grid is at most
// that many); <= 0 on an error or where one block does not fit.
extern "C" int ikpso_fused_solve_serial_cluster_blocks(int replay, int cl, int P, int M,
                                                       int K, int n_nodes) {
  if (!serial_cluster_ok(cl, P, n_nodes)) return -1;
  int most = 0;
  const auto kernel = replay ? allowed_kernel<true>(most) : allowed_kernel<false>(most);
  return active_clusters(kernel, most, cl, P / cl, serial_cluster_smem(M, K, n_nodes, P / cl));
}

// The serial-chain variant in the cluster layout: `clusters` clusters of
// cl blocks (<= ikpso_fused_solve_serial_cluster_blocks) stride over the S
// swarms; lb_scratch is null unless lbest is in global scratch.
extern "C" int ikpso_fused_solve_serial_cluster(
    int replay, int cl, int init_mode, int n_nodes, const float* meta, int M,
    const float* swarm, int K, const float* limits, const int* seeds, const float* inertia,
    int iters, float c1, float c2, float vscale, int randomized, int gbest_interval,
    int rekick_interval, float rekick_scale, float rekick_threshold, const float* uniforms,
    int n_draws, float* lb_scratch, int clusters, float* gbest, float* gval, int S, int P,
    void* stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (!serial_cluster_ok(cl, P, n_nodes) || clusters <= 0 || init_mode < kInitWarm ||
      init_mode > kInitHybrid || gbest_interval < 1 || rekick_interval < 0 ||
      (rekick_interval > 0 && rekick_interval % gbest_interval) ||
      (kLbGlobal != (lb_scratch != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int most = 0;
  const auto kernel = replay ? allowed_kernel<true>(most) : allowed_kernel<false>(most);
  const int Pb = P / cl;
  const size_t smem = serial_cluster_smem(M, K, n_nodes, Pb);
  if (smem > static_cast<size_t>(most)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#if IKPSO_CLUSTER_LB_GLOBAL
  cudaError_t rc = cudaMemcpyToSymbolAsync(ikpso_lb_scratch, &lb_scratch, sizeof(float*), 0,
                                           cudaMemcpyHostToDevice, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
#endif
  const Update up{randomized != 0, gbest_interval, rekick_interval, rekick_scale,
                  rekick_threshold};
  ClusterLaunch l(clusters * cl, cl, Pb, smem, s);
  const cudaError_t launched =
      cudaLaunchKernelEx(&l.cfg, kernel, n_nodes, cl, meta, M, swarm, K, limits, seeds,
                         inertia, iters, c1, c2, vscale, init_mode, up, uniforms, n_draws,
                         gbest, gval, S);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}
