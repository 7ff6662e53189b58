// Kernel B, standalone launcher: (S, P, D) angles -> (S, P) fitness.
//
// Evaluates the fk_fitness_eval device function (fk_fitness.cuh) with one
// thread per particle, so the device function the fused solver inlines
// can be checked and timed on its own against fk_fitness_plain. It is not
// a port of the standalone Pallas kernel C
// (ikpso_tpu/ops/pallas_fitness.py:fused_fitness), which takes a
// (S, D, P) lane-major layout and waits for a later port.
//
// Bound on this card: arithmetic (see fk_fitness.cuh); memory traffic is
// D floats in and one float out per particle. Reads of x are D-strided
// per thread (the (S, P, D) layout the solver's state uses); at D = 9
// consecutive threads still touch consecutive 36-byte rows, so a warp's
// loads cover whole cache lines.
#include <cuda_runtime.h>

#include "fk_fitness.cuh"

namespace ikpso {

template <class T>
__global__ void fk_fitness_kernel(const float* __restrict__ x,
                                  const float* __restrict__ meta,
                                  const float* __restrict__ swarm, int K,
                                  float* __restrict__ out, long long total, int P) {
  constexpr int D = T::D;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long s = t / P;
  float xr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) xr[d] = x[t * D + d];
  out[t] = fk_fitness_eval<T>(xr, meta, swarm + s * K);
}

template <class T>
static void launch_fk_fitness(const float* x, const float* meta, const float* swarm,
                              int K, float* out, long long total, int P,
                              cudaStream_t stream) {
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  fk_fitness_kernel<T><<<blocks, kThreads, 0, stream>>>(x, meta, swarm, K, out,
                                                         total, P);
}

}  // namespace ikpso

extern "C" int ikpso_fk_fitness(int topo, const float* x, const float* meta,
                                const float* swarm, int K, float* out,
                                long long total, int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  switch (topo) {
    case 0:
      ikpso::launch_fk_fitness<ikpso::Arm7Dof>(x, meta, swarm, K, out, total, P, st);
      break;
    case 1:
      ikpso::launch_fk_fitness<ikpso::ReferenceArm>(x, meta, swarm, K, out, total, P,
                                                    st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
