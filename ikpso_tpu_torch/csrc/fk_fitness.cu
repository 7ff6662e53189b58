// Kernel B, standalone launcher: (S, P, D) angles -> (S, P) fitness.
//
// Evaluates the fk_fitness_eval device function (fk_fitness.cuh) with one
// thread per particle (fk_fitness_kernel, in the header so an on-demand
// library instantiates it too), so the device function kernels A and C
// inline can be checked and timed on its own against fk_fitness_plain.
// This library holds the prebuilt instantiations; any other (topology,
// collider, orientation, distance, trig) is built on demand
// (on_demand.cuh). The port of
// the standalone Pallas kernel (ikpso_tpu/ops/pallas_fitness.py:
// fused_fitness, lane-major (S, D, P)) is kernel C, fused_fitness.cu.
//
// The serial-chain variant (fk_fitness_eval_serial) has its own entry
// point, ikpso_fk_fitness_serial, with the node count as an argument.
//
// Bound on this card: arithmetic (see fk_fitness.cuh); memory traffic is
// D floats in and one float out per particle. Reads of x are D-strided
// per thread (the (S, P, D) layout the solver's state uses); at D = 9
// consecutive threads still touch consecutive 36-byte rows, so a warp's
// loads cover whole cache lines.
#include <cuda_runtime.h>

#include "fk_fitness.cuh"

namespace ikpso {

// The serial-chain variant: n nodes at run time (fk_fitness_eval_serial).
__global__ void fk_fitness_serial_kernel(int n, const float* __restrict__ x,
                                         const float* __restrict__ meta,
                                         const float* __restrict__ swarm, int K,
                                         float* __restrict__ out, long long total, int P) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long s = t / P;
  out[t] = fk_fitness_eval_serial(x + t * 3 * (n - 1), 1, n, meta, swarm + s * K);
}

}  // namespace ikpso

extern "C" int ikpso_fk_fitness(int topo, int collider, int orient, int n_obs,
                                float node_half,
                                float link_half, float node_r2, float link_r2,
                                const float* x, const float* meta, const float* swarm,
                                int K, float* out, long long total, int P, void* stream) {
  using namespace ikpso;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  // The orientation term is instantiated for Arm6Dof without a scene only.
  if (n_obs < 0 || (orient && (topo != 2 || collider != kNoCollider))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scene scene{n_obs, node_half, link_half, node_r2, link_r2};
  if (topo == 0 && collider == kNoCollider) {
    launch_fk_fitness<Arm7Dof, kNoCollider>(x, meta, swarm, K, scene, out, total, P, st);
  } else if (topo == 0 && collider == kBoxCollider) {
    launch_fk_fitness<Arm7Dof, kBoxCollider>(x, meta, swarm, K, scene, out, total, P, st);
  } else if (topo == 0 && collider == kCapsuleCollider) {
    launch_fk_fitness<Arm7Dof, kCapsuleCollider>(x, meta, swarm, K, scene, out, total, P,
                                                 st);
  } else if (topo == 1 && collider == kNoCollider) {
    launch_fk_fitness<ReferenceArm, kNoCollider>(x, meta, swarm, K, scene, out, total, P,
                                                 st);
  } else if (topo == 2 && collider == kNoCollider && !orient) {
    launch_fk_fitness<Arm6Dof, kNoCollider>(x, meta, swarm, K, scene, out, total, P, st);
  } else if (topo == 2 && collider == kNoCollider && orient) {
    launch_fk_fitness<Arm6Dof, kNoCollider, true>(x, meta, swarm, K, scene, out, total,
                                                  P, st);
  } else if (topo == 3 && collider == kNoCollider && !orient) {
    launch_fk_fitness<DualArm14, kNoCollider>(x, meta, swarm, K, scene, out, total, P, st);
  } else if (topo == 4 && collider == kNoCollider && !orient) {
    launch_fk_fitness<Humanoid45, kNoCollider>(x, meta, swarm, K, scene, out, total, P,
                                               st);
  } else if (topo == 5 && collider == kNoCollider && !orient) {
    launch_fk_fitness<Snake30, kNoCollider>(x, meta, swarm, K, scene, out, total, P, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ikpso_fk_fitness_serial(int n_nodes, const float* x, const float* meta,
                                       const float* swarm, int K, float* out,
                                       long long total, int P, void* stream) {
  using namespace ikpso;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  if (n_nodes < 2 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((total + kFkFitnessThreads - 1) / kFkFitnessThreads);
  fk_fitness_serial_kernel<<<blocks, kFkFitnessThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_nodes, x, meta, swarm, K, out, total, P);
  return static_cast<int>(cudaGetLastError());
}
