// Kernel C's kernel template (fused_fitness.cu instantiates the prebuilt
// topologies, on_demand.cuh one generated topology); see fused_fitness.cu.
#pragma once

#include <cuda_runtime.h>

#include "fk_fitness.cuh"

namespace ikpso {

constexpr int kFitnessThreads = 256;

template <class T, int C, bool O>
__global__ void __launch_bounds__(kFitnessThreads) fused_fitness_kernel(
    const float* __restrict__ x, const float* __restrict__ meta,
    const float* __restrict__ swarm, int K, Scene scene, float* __restrict__ out,
    int P, int blocks_per_swarm) {
  constexpr int D = T::D;
  const long long s = blockIdx.x / blocks_per_swarm;
  const int p = (blockIdx.x % blocks_per_swarm) * kFitnessThreads + threadIdx.x;
  if (p >= P) return;
  const float* xs = x + s * D * P + p;
  float xr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) xr[d] = __ldg(xs + static_cast<long long>(d) * P);
  out[s * P + p] = fk_fitness_eval<T, C, O>(xr, meta, swarm + s * K, scene,
                                            box_row_slack<T, C>(meta, swarm + s * K, scene));
}

template <class T, int C, bool O = false>
static void launch_fused_fitness(const float* x, const float* meta, const float* swarm,
                                 int K, Scene scene, float* out, int S, int P,
                                 cudaStream_t stream) {
  const int per_swarm = (P + kFitnessThreads - 1) / kFitnessThreads;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(S) * per_swarm);
  fused_fitness_kernel<T, C, O><<<blocks, kFitnessThreads, 0, stream>>>(
      x, meta, swarm, K, scene, out, P, per_swarm);
}

}  // namespace ikpso
