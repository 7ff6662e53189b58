// Kernel A's prebuilt short chains: arm_7dof (planar_3dof runs on it) with
// no scene, the box or the capsule collider, and arm_6dof with or without
// the orientation term, each at two thread bounds (kShortThreads and
// 1,024). Their kernel template is fused_solve_short_kernel
// (fused_solve.cuh); fused_solve.cu's entry point launches them through
// launch_short_prebuilt, and the design notes are in fused_solve.cu. A
// source of its own, so nvcc builds it beside fused_solve.cu's trees.
#include <cuda_runtime.h>

#include "fused_solve.cuh"

namespace ikpso {

cudaError_t launch_short_prebuilt(int topo, int collider, bool orient, int threads,
                                  bool replay, const float* meta, int M, const float* swarm,
                                  int K, const float* limits, const int* seeds,
                                  const float* inertia, int iters, float c1, float c2,
                                  float vscale, int init_mode, Scene scene, Update up,
                                  const float* uniforms, int n_draws, float* gbest,
                                  float* gval, int S, int P, cudaStream_t stream) {
#define IKPSO_SHORT(TOPO, C, O)                                                          \
  return threads == kShortThreads                                                        \
             ? launch_fused_solve_short<TOPO, C, O, kShortThreads>(                      \
                   replay, meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2,     \
                   vscale, init_mode, scene, up, uniforms, n_draws, gbest, gval, S, P,   \
                   stream)                                                               \
             : launch_fused_solve_short<TOPO, C, O, KernelAThreads<TOPO>::value>(        \
                   replay, meta, M, swarm, K, limits, seeds, inertia, iters, c1, c2,     \
                   vscale, init_mode, scene, up, uniforms, n_draws, gbest, gval, S, P,   \
                   stream)
  if (threads != kShortThreads && threads != 1024) return cudaErrorInvalidValue;
  if (topo == 0 && collider == kNoCollider && !orient) IKPSO_SHORT(Arm7Dof, kNoCollider, false);
  if (topo == 0 && collider == kBoxCollider && !orient) IKPSO_SHORT(Arm7Dof, kBoxCollider, false);
  if (topo == 0 && collider == kCapsuleCollider && !orient) {
    IKPSO_SHORT(Arm7Dof, kCapsuleCollider, false);
  }
  if (topo == 2 && collider == kNoCollider && !orient) IKPSO_SHORT(Arm6Dof, kNoCollider, false);
  if (topo == 2 && collider == kNoCollider && orient) IKPSO_SHORT(Arm6Dof, kNoCollider, true);
#undef IKPSO_SHORT
  return cudaErrorInvalidValue;
}

static_assert(KernelAThreads<Arm7Dof>::value == 1024 && KernelAThreads<Arm6Dof>::value == 1024,
              "the short chains' other bound");

}  // namespace ikpso
