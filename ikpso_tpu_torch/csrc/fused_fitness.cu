// Kernel C: the standalone FK + fitness kernel, (S, D, P) angles -> (S, P).
//
// Replaces ikpso_tpu/ops/pallas_fitness.py:fused_fitness (body
// _build_kernel, wrapper make_pallas_fitness): the fitness_fn of the scan
// solver's impl="pallas" path, one evaluation of every particle per launch.
//
// Layout: one thread per particle. Thread p of swarm s reads x[s, d, p]
// for d = 0..D-1, so for each d a warp reads 32 consecutive floats: the
// lane-major layout the Pallas kernel takes, and the coalesced one here.
// A swarm spans ceil(P / 256) blocks of 256 threads (any P; the Pallas
// kernel's P % 1024 rule is a TPU tiling rule); the packed per-chain meta
// and the swarm's constant row are read through the read-only cache.
// The evaluation is kernel B's device function (fk_fitness.cuh), inlined
// for every (topology, collider, orientation) instantiation of kernel B's
// launcher, and its serial-chain variant behind its own entry point
// (ikpso_fused_fitness_serial). Any other (topology, collider,
// orientation, distance, trig) is built on demand (on_demand.cuh).
//
// Bound on this card: bytes without a scene (D + 1 floats per particle
// against ~510 counted FP32 ops, under the ~20 ops/byte the card balances
// at); the SAT / capsule arithmetic with one (PERF.md, kernel table). The
// ~510 ops issue as unfused FMUL/FADD under -fmad=false (bit-identity with
// the plain twin): at the scan shape ~0.26 ms of issue against a 0.20 ms
// byte bound.
#include <cuda_runtime.h>

#include "fused_fitness.cuh"

namespace ikpso {

// The serial-chain variant: n nodes at run time; thread p reads x[s, d, p]
// at stride P, as above.
__global__ void __launch_bounds__(kFitnessThreads) fused_fitness_serial_kernel(
    int n, const float* __restrict__ x, const float* __restrict__ meta,
    const float* __restrict__ swarm, int K, float* __restrict__ out, int P,
    int blocks_per_swarm) {
  const long long s = blockIdx.x / blocks_per_swarm;
  const int p = (blockIdx.x % blocks_per_swarm) * kFitnessThreads + threadIdx.x;
  if (p >= P) return;
  const long long d_total = 3 * (n - 1);
  out[s * P + p] =
      fk_fitness_eval_serial(x + s * d_total * P + p, P, n, meta, swarm + s * K);
}

}  // namespace ikpso

extern "C" int ikpso_fused_fitness(int topo, int collider, int orient, int n_obs,
                                   float node_half, float link_half, float node_r2,
                                   float link_r2,
                                   const float* x, const float* meta, const float* swarm,
                                   int K, float* out, int S, int P, void* stream) {
  using namespace ikpso;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  // The orientation term is instantiated for Arm6Dof without a scene only.
  if (n_obs < 0 || (orient && (topo != 2 || collider != kNoCollider)) ||
      static_cast<long long>(S) * ((P + kFitnessThreads - 1) / kFitnessThreads) >
          0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scene scene{n_obs, node_half, link_half, node_r2, link_r2};
#define IKPSO_LAUNCH(TOPO, C, O) \
  launch_fused_fitness<TOPO, C, O>(x, meta, swarm, K, scene, out, S, P, st)
  if (topo == 0 && collider == kNoCollider) {
    IKPSO_LAUNCH(Arm7Dof, kNoCollider, false);
  } else if (topo == 0 && collider == kBoxCollider) {
    IKPSO_LAUNCH(Arm7Dof, kBoxCollider, false);
  } else if (topo == 0 && collider == kCapsuleCollider) {
    IKPSO_LAUNCH(Arm7Dof, kCapsuleCollider, false);
  } else if (topo == 1 && collider == kNoCollider) {
    IKPSO_LAUNCH(ReferenceArm, kNoCollider, false);
  } else if (topo == 2 && collider == kNoCollider && !orient) {
    IKPSO_LAUNCH(Arm6Dof, kNoCollider, false);
  } else if (topo == 2 && collider == kNoCollider && orient) {
    IKPSO_LAUNCH(Arm6Dof, kNoCollider, true);
  } else if (topo == 3 && collider == kNoCollider && !orient) {
    IKPSO_LAUNCH(DualArm14, kNoCollider, false);
  } else if (topo == 4 && collider == kNoCollider && !orient) {
    IKPSO_LAUNCH(Humanoid45, kNoCollider, false);
  } else if (topo == 5 && collider == kNoCollider && !orient) {
    IKPSO_LAUNCH(Snake30, kNoCollider, false);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IKPSO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ikpso_fused_fitness_serial(int n_nodes, const float* x, const float* meta,
                                          const float* swarm, int K, float* out, int S,
                                          int P, void* stream) {
  using namespace ikpso;
  if (S <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  const int per_swarm = (P + kFitnessThreads - 1) / kFitnessThreads;
  if (n_nodes < 2 || static_cast<long long>(S) * per_swarm > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(S) * per_swarm);
  fused_fitness_serial_kernel<<<blocks, kFitnessThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      n_nodes, x, meta, swarm, K, out, P, per_swarm);
  return static_cast<int>(cudaGetLastError());
}
