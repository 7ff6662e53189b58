// Kernels D and E: the roofline microbenchmarks.
//
// Kernel D replaces ikpso_tpu/utils/roofline.py:_time_tile_kernel with the
// bodies of measure_fma_peak, measure_compose_peak and
// measure_transcendental_peak; kernel E replaces the PRNG-draw kernel of
// measure_rng_peak. The TPU kernels run one VMEM-resident 512x128 tile per
// grid step and sum each tile's rows into the output. Here a grid-stride
// loop gives every thread many elements, each element runs the body's
// recurrence in registers, and every element's result is written out, so
// nothing can be eliminated; the slope between two step counts
// (utils/roofline.py) cancels the bytes and the launch.
//
// Bodies (template parameter B of roofline_body_kernel):
//   kFmaBody      three rotating accumulators, a = fma(a, b, h),
//                 b = fma(b, c, h), c = fma(c, a, h): one FFMA each.
//                 Written with fmaf because the library compiles with
//                 -fmad=false, which would split a*b + h into FMUL + FADD
//                 and halve the reading; fmaf is not split.
//   kComposeBody  A <- A.B then B <- B.A on two 3x3 matrices, as plain
//                 mul/add: under -fmad=false that is the instruction mix
//                 the solver kernels compile to (fk_fitness.cuh mat_mul),
//                 the faithful ceiling for their op mix.
//   kSinBody      x = sinf(x), chained (the precise libdevice sinf; the
//                 solver kernels use a polynomial instead).
// Bound on this card: the FP32 pipes (D) and the integer pipes (E); the
// bytes are one float in and one out per element (D) or one word per
// thread (E).
#include <cuda_runtime.h>

#include "fk_fitness.cuh"
#include "philox.cuh"

namespace ikpso {

enum RooflineBody : int { kFmaBody = 0, kComposeBody = 1, kSinBody = 2 };

template <int B>
__device__ __forceinline__ float roofline_body(float x, int steps) {
  if constexpr (B == kFmaBody) {
    const float h = 0.5f;
    float a = x;
    float b = fmaf(x, 0.5f, 0.1f);
    float c = fmaf(x, 0.25f, 0.2f);
    for (int k = 0; k < steps; ++k) {
      a = fmaf(a, b, h);
      b = fmaf(b, c, h);
      c = fmaf(c, a, h);
    }
    return a + b + c;
  } else if constexpr (B == kComposeBody) {
    float a[9], b[9], t[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      a[i] = x * static_cast<float>(0.1 * (i + 1));
      b[i] = x * static_cast<float>(0.05 * (i + 1)) + 0.1f;
    }
    for (int k = 0; k < steps; ++k) {
      mat_mul(a, b, t);
#pragma unroll
      for (int i = 0; i < 9; ++i) a[i] = t[i];
      mat_mul(b, a, t);
#pragma unroll
      for (int i = 0; i < 9; ++i) b[i] = t[i];
    }
    float acc = a[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) acc = acc + a[i];
#pragma unroll
    for (int i = 0; i < 9; ++i) acc = acc + b[i];
    return acc;
  } else {
    for (int k = 0; k < steps; ++k) x = sinf(x);
    return x;
  }
}

template <int B>
__global__ void roofline_body_kernel(const float* __restrict__ x, float* __restrict__ out,
                                     long long n, int steps) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = roofline_body<B>(x[i], steps);
  }
}

// Kernel E: thread t XORs the four words of philox(counter (t, k, 0, 0),
// key) over k = 0..steps-1 into its one output word.
__global__ void philox_xor_kernel(uint2 key, unsigned* __restrict__ out, long long n,
                                  int steps) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  unsigned acc = 0u;
  for (int k = 0; k < steps; ++k) {
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<unsigned>(t), static_cast<unsigned>(k), 0u, 0u), key);
    acc ^= w.x ^ w.y ^ w.z ^ w.w;
  }
  out[t] = acc;
}

}  // namespace ikpso

extern "C" int ikpso_roofline_body(int body, const float* x, float* out, long long n,
                                   int steps, int blocks, int threads, void* stream) {
  using namespace ikpso;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (steps < 0 || blocks <= 0 || threads <= 0 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (body == kFmaBody) {
    roofline_body_kernel<kFmaBody><<<blocks, threads, 0, st>>>(x, out, n, steps);
  } else if (body == kComposeBody) {
    roofline_body_kernel<kComposeBody><<<blocks, threads, 0, st>>>(x, out, n, steps);
  } else if (body == kSinBody) {
    roofline_body_kernel<kSinBody><<<blocks, threads, 0, st>>>(x, out, n, steps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ikpso_philox_xor(unsigned key0, unsigned key1, unsigned* out, long long n,
                                int steps, void* stream) {
  using namespace ikpso;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (steps < 0 || n > 0xffffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  philox_xor_kernel<<<blocks, kThreads, 0, st>>>(make_uint2(key0, key1), out, n, steps);
  return static_cast<int>(cudaGetLastError());
}
