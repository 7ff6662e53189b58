// Kernels A, B and C and the scan step for one topology and term combination
// built on demand.
//
// The prebuilt library (fused_solve.cu, fk_fitness.cu, fused_fitness.cu,
// scan_step.cu)
// holds the instantiations the ported paths were written for. Any other
// tree, and any other (topology, collider, orientation, distance, trig)
// combination -- a JSON config can name any of them -- is compiled when it
// is first asked for: ikpso_tpu_torch/utils/kernels.py writes a small .cu
// that defines the IKPSO_OD_* macros below and includes this header, and
// compiles it into a library of its own. The kernels are the prebuilt
// ones' templates (fused_solve.cuh, fk_fitness.cuh, fused_fitness.cuh,
// scan_step.cuh)
// instantiated for OnDemandTopology<...>; nothing here computes anything
// they do not.
//
// The macros (all required):
//   IKPSO_OD_PARENTS     node k's parent, k = 0..N-1 (the root's is -1)
//   IKPSO_OD_EFFECTORS   the effector nodes, in effector_idx order
//   IKPSO_OD_THREADS     kernel A's thread-block bound (the most particles)
//   IKPSO_OD_STREAM      1: kernel A draws four DOFs at a time (StreamDraws)
//   IKPSO_OD_SCRATCH     1: kernel A keeps x and v (and lbest) in global scratch
//   IKPSO_OD_CLUSTER     1: kernel A has the cluster layout
//                        (fused_solve_cluster.cuh: x in registers, v and
//                        lbest in shared memory, a swarm over a cluster)
//                        beside the scratch layout (IKPSO_OD_SCRATCH 1)
//   IKPSO_OD_SHARED      1: kernel A keeps v and lbest (the scratch layout:
//                        lbest) in dynamic shared memory (StatePlacement)
//   IKPSO_OD_TREE        1: kernel A runs the register layout's tree loop
//                        (TreeLoop: fused_solve_tree_kernel)
//   IKPSO_OD_COLLIDER    enum Collider
//   IKPSO_OD_ORIENTATION, IKPSO_OD_DISTANCE, IKPSO_OD_EXACT   0 or 1
//
// Entry points (one set per library, so fixed names): ikpso_od_fused_solve
// (kernel A; the scratch layout takes a scratch of grid x planes x D x P
// floats, planes 2 with IKPSO_OD_SHARED and 3 without, grid <=
// ikpso_od_fused_solve_blocks; with IKPSO_OD_CLUSTER,
// ikpso_od_fused_solve_cluster on clusters <=
// ikpso_od_fused_solve_cluster_blocks runs the cluster layout),
// ikpso_od_fk_fitness (kernel B's
// standalone launcher), ikpso_od_fused_fitness (kernel C) and
// ikpso_od_scan_step (the scan solver's step, drawing or replay). Each
// returns a CUDA error code, as the prebuilt ones do.
#pragma once

#include <cuda_runtime.h>

#include "fused_fitness.cuh"
#include "fused_solve.cuh"
#include "scan_step.cuh"
#if IKPSO_OD_CLUSTER
#include "fused_solve_cluster.cuh"
#endif

namespace ikpso {

using OdTopology =
    OnDemandTopology<IntList<IKPSO_OD_PARENTS>, IntList<IKPSO_OD_EFFECTORS>,
                     IKPSO_OD_THREADS, IKPSO_OD_STREAM != 0, IKPSO_OD_DISTANCE != 0,
                     IKPSO_OD_EXACT != 0>;
constexpr int kOdCollider = IKPSO_OD_COLLIDER;
constexpr bool kOdOrientation = IKPSO_OD_ORIENTATION != 0;
constexpr bool kOdScratch = IKPSO_OD_SCRATCH != 0;
static_assert(!IKPSO_OD_CLUSTER || IKPSO_OD_SCRATCH,
              "the cluster layout beside the scratch one");
static_assert(OdTopology::N >= 2 && OdTopology::parent(0) == -1, "a tree rooted at node 0");
static_assert(kOdCollider >= kNoCollider && kOdCollider <= kCapsuleCollider, "collider id");

template <>
struct StatePlacement<OdTopology> {
  static constexpr int value = IKPSO_OD_SHARED != 0 ? kShared : kRegisters;
};
template <>
struct TreeLoop<OdTopology> {
  static constexpr bool value = IKPSO_OD_TREE != 0;
};
static_assert(!IKPSO_OD_TREE || (!IKPSO_OD_SCRATCH && IKPSO_OD_SHARED && IKPSO_OD_STREAM),
              "the tree loop: the register layout, v and lbest in shared memory, streamed");

// Kernel A's dynamic shared memory at P particles: the [D][P] planes in
// shared memory are v and lbest in the register layout, lbest in the
// scratch layout.
static size_t od_smem_bytes(int M, int K, int P) {
  const int planes =
      StatePlacement<OdTopology>::value == kShared ? (kOdScratch ? 1 : 2) : 0;
  return kernel_a_smem_bytes(M, K, OdTopology::D, P, planes);
}

// Kernel A's two layouts behind a template flag (the cluster layout has
// entry points of its own, below): the member functions of a class
// template are instantiated only where called, and if constexpr discards
// the other layout, so only the chosen one is compiled. In an
// unnamed namespace: two libraries of one tree in two placements share
// the topology's type, and a static of a class with external linkage
// would be one object for both (a unique symbol), so the second library
// would never allow its own kernel the shared memory.
namespace {
template <bool SCRATCH>
struct OdKernelA {
  // The scratch layout's kernel for a replay flag, allowed the card's opt-in
  // shared memory (once per instantiation); most is that maximum.
  template <bool REPLAY>
  static auto scratch_kernel(int& most) {
    static const int allowed = allow_dynamic_smem(
        fused_solve_tree_scratch_kernel<OdTopology, kOdCollider, kOdOrientation, REPLAY>);
    most = allowed;
    return fused_solve_tree_scratch_kernel<OdTopology, kOdCollider, kOdOrientation, REPLAY>;
  }

  static int blocks(int replay, int P, int M, int K) {
    if constexpr (SCRATCH) {
      int most = 0, per_sm = 0, device = 0, sms = 0;
      const auto kernel = replay ? scratch_kernel<true>(most) : scratch_kernel<false>(most);
      const size_t smem = od_smem_bytes(M, K, P);
      if (smem > static_cast<size_t>(most)) return -1;
      const cudaError_t rc =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P, smem);
      if (rc != cudaSuccess || cudaGetDevice(&device) != cudaSuccess ||
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
              cudaSuccess) {
        return -1;
      }
      return per_sm * sms;
    } else {
      return -1;
    }
  }

  static cudaError_t launch(bool replay, Scene scene, const float* meta, int M,
                            const float* swarm, int K, const float* limits, const int* seeds,
                            const float* inertia, int iters, float c1, float c2,
                            float vscale, int init_mode, Update up, const float* uniforms,
                            int n_draws, float* scratch, int grid, float* gbest,
                            float* gval, int S, int P, cudaStream_t st) {
    if constexpr (SCRATCH) {
      int most = 0;
      const auto kernel = replay ? scratch_kernel<true>(most) : scratch_kernel<false>(most);
      const size_t smem = od_smem_bytes(M, K, P);
      if (smem > static_cast<size_t>(most)) return cudaErrorInvalidValue;
      kernel<<<grid, P, smem, st>>>(scene, meta, M, swarm, K, limits, seeds, inertia, iters,
                                    c1, c2, vscale, init_mode, up, uniforms, n_draws,
                                    scratch, gbest, gval, S);
      return cudaSuccess;
    } else {
      return launch_fused_solve<OdTopology, kOdCollider, kOdOrientation>(
          replay, meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2, vscale,
          init_mode, scene, up, uniforms, n_draws, gbest, gval, S, P, st);
    }
  }
};
}  // namespace

#if IKPSO_OD_CLUSTER
namespace {
// The cluster layout's kernel for a replay flag, allowed the card's opt-in
// shared memory (once per instantiation); most is that maximum.
template <bool REPLAY>
auto od_cluster_kernel(int& most) {
  static const int allowed = allow_dynamic_smem(
      fused_solve_tree_cluster_kernel<OdTopology, kOdCollider, kOdOrientation, REPLAY>);
  most = allowed;
  return fused_solve_tree_cluster_kernel<OdTopology, kOdCollider, kOdOrientation, REPLAY>;
}
}  // namespace
#endif

}  // namespace ikpso

#if IKPSO_OD_CLUSTER
// How many clusters of cl blocks of the cluster layout fit the card at
// once; <= 0 on an error or where one block does not fit.
extern "C" int ikpso_od_fused_solve_cluster_blocks(int replay, int cl, int P, int M, int K) {
  using namespace ikpso;
  if (!cluster_shape_ok(cl, P) || P > OdTopology::kThreads) return -1;
  int most = 0;
  const auto kernel = replay ? od_cluster_kernel<true>(most) : od_cluster_kernel<false>(most);
  return active_clusters(kernel, most, cl, P / cl,
                         cluster_smem_bytes(M, K, OdTopology::D, P / cl));
}

// Kernel A in the cluster layout: `clusters` clusters of cl blocks (<=
// ikpso_od_fused_solve_cluster_blocks) stride over the S swarms.
extern "C" int ikpso_od_fused_solve_cluster(
    int replay, int cl, int init_mode, int n_obs, float node_half, float link_half,
    float node_r2, float link_r2, const float* meta, int M, const float* swarm, int K,
    const float* limits, const int* seeds, const float* inertia, int iters, float c1,
    float c2, float vscale, int randomized, int gbest_interval, int rekick_interval,
    float rekick_scale, float rekick_threshold, const float* uniforms, int n_draws,
    int clusters, float* gbest, float* gval, int S, int P, void* stream) {
  using namespace ikpso;
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (!cluster_shape_ok(cl, P) || P > OdTopology::kThreads || clusters <= 0 ||
      init_mode < kInitWarm || init_mode > kInitHybrid || n_obs < 0 ||
      (kOdCollider == kNoCollider && n_obs) || gbest_interval < 1 || rekick_interval < 0 ||
      (rekick_interval > 0 && rekick_interval % gbest_interval)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int most = 0;
  const auto kernel = replay ? od_cluster_kernel<true>(most) : od_cluster_kernel<false>(most);
  const int Pb = P / cl;
  const size_t smem = cluster_smem_bytes(M, K, OdTopology::D, Pb);
  if (smem > static_cast<size_t>(most)) return static_cast<int>(cudaErrorInvalidValue);
  ClusterLaunch l(clusters * cl, cl, Pb, smem, static_cast<cudaStream_t>(stream));
  const cudaError_t rc = cudaLaunchKernelEx(
      &l.cfg, kernel, Scene{n_obs, node_half, link_half, node_r2, link_r2}, cl, meta, M, swarm,
      K, limits, seeds, inertia, iters, c1, c2, vscale, init_mode,
      Update{randomized != 0, gbest_interval, rekick_interval, rekick_scale, rekick_threshold},
      uniforms, n_draws, gbest, gval, S);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
#endif

// How many blocks of the scratch layout fit the card at once (its grid, and
// so its scratch); <= 0 on an error, where one block's shared memory does
// not fit, or for the register layout.
extern "C" int ikpso_od_fused_solve_blocks(int replay, int P, int M, int K) {
  using namespace ikpso;
  if (P <= 0 || P > OdTopology::kThreads) return -1;
  return OdKernelA<kOdScratch>::blocks(replay, P, M, K);
}

extern "C" int ikpso_od_fused_solve(int replay, int init_mode, int n_obs, float node_half,
                                    float link_half, float node_r2, float link_r2,
                                    const float* meta, int M, const float* swarm, int K,
                                    const float* limits, const int* seeds,
                                    const float* inertia, int iters, float c1, float c2,
                                    float vscale, int randomized, int gbest_interval,
                                    int rekick_interval, float rekick_scale,
                                    float rekick_threshold, const float* uniforms,
                                    int n_draws, float* scratch, int grid, float* gbest,
                                    float* gval, int S, int P, void* stream) {
  using namespace ikpso;
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (P <= 0 || P > OdTopology::kThreads || P % 32 != 0 || init_mode < kInitWarm ||
      init_mode > kInitHybrid || n_obs < 0 || (kOdCollider == kNoCollider && n_obs) ||
      gbest_interval < 1 || rekick_interval < 0 ||
      (rekick_interval > 0 && rekick_interval % gbest_interval) ||
      (kOdScratch && (grid <= 0 || scratch == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t rc = OdKernelA<kOdScratch>::launch(
      replay != 0, Scene{n_obs, node_half, link_half, node_r2, link_r2}, meta, M, swarm, K,
      limits, seeds, inertia, iters, c1, c2, vscale, init_mode,
      Update{randomized != 0, gbest_interval, rekick_interval, rekick_scale,
             rekick_threshold},
      uniforms, n_draws, scratch, grid, gbest, gval, S, P, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ikpso_od_fk_fitness(int n_obs, float node_half, float link_half,
                                   float node_r2, float link_r2, const float* x,
                                   const float* meta, const float* swarm, int K, float* out,
                                   long long total, int P, void* stream) {
  using namespace ikpso;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  if (n_obs < 0 || (kOdCollider == kNoCollider && n_obs) || P <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch_fk_fitness<OdTopology, kOdCollider, kOdOrientation>(
      x, meta, swarm, K, Scene{n_obs, node_half, link_half, node_r2, link_r2}, out, total, P,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ikpso_od_fused_fitness(int n_obs, float node_half, float link_half,
                                      float node_r2, float link_r2, const float* x,
                                      const float* meta, const float* swarm, int K,
                                      float* out, int S, int P, void* stream) {
  using namespace ikpso;
  if (S <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  if (n_obs < 0 || (kOdCollider == kNoCollider && n_obs) ||
      static_cast<long long>(S) * ((P + kFitnessThreads - 1) / kFitnessThreads) >
          0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch_fused_fitness<OdTopology, kOdCollider, kOdOrientation>(
      x, meta, swarm, K, Scene{n_obs, node_half, link_half, node_r2, link_r2}, out, S, P,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ikpso_od_scan_step(int n_obs, float node_half, float link_half,
                                  float node_r2, float link_r2, IKPSO_STEP_PARAMS) {
  using namespace ikpso;
  if (n_obs < 0 || (kOdCollider == kNoCollider && n_obs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t rc = launch_scan_step(
      StepTreeWalk<OdTopology, kOdCollider, kOdOrientation>{
          Scene{n_obs, node_half, link_half, node_r2, link_r2}},
      OdTopology::D, meta, swarm, K, IKPSO_STEP_STATE(OdTopology::D), IKPSO_STEP_UPDATE,
      replay != 0, S, P, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
