// Kernel B, device part: FK over a static tree + the PSO cost of one particle.
//
// Replaces ikpso_tpu/ops/pallas_fitness.py:fk_fitness_tile (with _sincos,
// _rot_xyz, _mat_mul and the MetaLayout offsets). The Pallas body evaluates
// an (8, 128) particle tile per grid step with every per-node quantity a
// vector register; here one thread evaluates one particle and every
// per-node quantity is a scalar register. The tree walk is unrolled over
// a compile-time topology (Topology<N, PARENTS, EFFMASK>), as the Pallas
// kernel unrolls spec.parent at trace time, so the parent lookups fold to
// constants and the rotation/position arrays stay in registers.
//
// Bound on this card: arithmetic. Per node: 3 polynomial sincos (~20 FP32
// ops each), an Euler-XYZ matrix (~16 ops), a 3x3 compose (45 ops), a
// position update and the cost terms; inputs are D angles and a few
// constants, the output one float. The design keeps everything in
// registers and reads the packed constants (meta, swarm row) through a
// pointer the caller places in shared memory (kernel A) or global memory
// (the standalone launcher in fk_fitness.cu).
//
// Numerics: the arithmetic follows the Pallas tile op for op (same
// association, rintf = round-half-even like jnp.round, same Horner
// coefficient order); the library is compiled with -fmad=false so it also
// rounds op by op like the plain torch version (fk_fitness_plain).
//
// Supported terms: weighted squared effector error and angular locality
// (aw / (N-1)). Distance, orientation and obstacle terms are refused by
// the Python wrapper and are not compiled here.
#pragma once

#include <cstdint>

namespace ikpso {

__host__ __device__ constexpr int popcount_u32(unsigned m) {
  return m ? static_cast<int>(m & 1u) + popcount_u32(m >> 1) : 0;
}

// Tree topology as template data: node k's parent sits in bits [4k, 4k+4)
// of PARENTS (k >= 1), effector nodes are the set bits of EFFMASK, in
// ascending node order (the Python side checks effector_idx is sorted).
template <int N_, unsigned long long PARENTS_, unsigned EFFMASK_>
struct Topology {
  static constexpr int N = N_;
  static constexpr int D = 3 * (N_ - 1);
  static constexpr int E = popcount_u32(EFFMASK_);
  __host__ __device__ static constexpr int parent(int k) {
    return static_cast<int>((PARENTS_ >> (4 * k)) & 15ull);
  }
  __host__ __device__ static constexpr bool is_effector(int k) {
    return (EFFMASK_ >> k) & 1u;
  }
  __host__ __device__ static constexpr int effector_slot(int k) {
    return popcount_u32(EFFMASK_ & ((1u << k) - 1u));
  }
};

// Instantiated topologies; ids must match KERNEL_TOPOLOGIES in
// ikpso_tpu_torch/utils/kernels.py.
using Arm7Dof = Topology<4, 0x2100ull, 0x8u>;            // id 0
using ReferenceArm = Topology<8, 0x44432100ull, 0xE0u>;  // id 1

// Packed-constant offsets (MetaLayout without obstacles/orientation).
constexpr int kMetaAw = 0;
constexpr int kMetaLen = 2;
constexpr int kSwRoot = 0;
constexpr int kSwOrigin = 9;
constexpr int kSwAnchor = 12;

// Exact float32 values of the coefficients in
// ikpso_tpu/ops/pallas_fitness.py:63-73 (hex literals: no decimal rounding).
__device__ __forceinline__ void sincos_poly(float x, float& s, float& c) {
  const float r = x - rintf(x * 0x1.45f306p-3f) * 0x1.921fb6p+2f;
  const float r2 = r * r;
  float sp = -0x1.60c69p-26f;
  sp = sp * r2 + 0x1.6aee7ep-19f;
  sp = sp * r2 + -0x1.9f7ff4p-13f;
  sp = sp * r2 + 0x1.110a9p-7f;
  sp = sp * r2 + -0x1.5554dep-3f;
  sp = sp * r2 + 0x1.fffff6p-1f;
  float cp = 0x1.dd704ap-30f;
  cp = cp * r2 + -0x1.2320aap-22f;
  cp = cp * r2 + 0x1.9fa10cp-16f;
  cp = cp * r2 + -0x1.6c1098p-10f;
  cp = cp * r2 + 0x1.555508p-5f;
  cp = cp * r2 + -0x1.fffffap-2f;
  cp = cp * r2 + 0x1p+0f;
  s = sp * r;
  c = cp;
}

__device__ __forceinline__ void rot_xyz(float ax, float ay, float az, float (&r)[9]) {
  float sx, cx, sy, cy, sz, cz;
  sincos_poly(ax, sx, cx);
  sincos_poly(ay, sy, cy);
  sincos_poly(az, sz, cz);
  r[0] = cy * cz;
  r[1] = -cy * sz;
  r[2] = sy;
  r[3] = cx * sz + sx * sy * cz;
  r[4] = cx * cz - sx * sy * sz;
  r[5] = -sx * cy;
  r[6] = sx * sz - cx * sy * cz;
  r[7] = sx * cz + cx * sy * sz;
  r[8] = cx * cy;
}

__device__ __forceinline__ void mat_mul(const float (&a)[9], const float (&b)[9],
                                        float (&o)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
    }
  }
}

// Fitness of one particle: x holds its D angles; meta / sw point at the
// packed per-chain / per-swarm constants (MetaLayout).
template <class T>
__device__ __forceinline__ float fk_fitness_eval(const float (&x)[T::D],
                                                 const float* __restrict__ meta,
                                                 const float* __restrict__ sw) {
  constexpr int N = T::N;
  constexpr int D = T::D;
  constexpr int kMetaEw = kMetaLen + (N - 1);
  constexpr int kSwTgt = kSwAnchor + D;
  float rot[N][9];
  float pos[N][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) rot[0][i] = sw[kSwRoot + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) pos[0][i] = sw[kSwOrigin + i];
  float rot_diff = 0.0f;
  float cost = 0.0f;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const int d0 = 3 * (k - 1);
    const int p = T::parent(k);
    const float ax = x[d0], ay = x[d0 + 1], az = x[d0 + 2];
    float local[9];
    rot_xyz(ax, ay, az, local);
    mat_mul(rot[p], local, rot[k]);
    const float len = meta[kMetaLen + (k - 1)];
    pos[k][0] = pos[p][0] + len * rot[k][0];
    pos[k][1] = pos[p][1] + len * rot[k][3];
    pos[k][2] = pos[p][2] + len * rot[k][6];

    const float da = ax - sw[kSwAnchor + d0];
    const float db = ay - sw[kSwAnchor + d0 + 1];
    const float dc = az - sw[kSwAnchor + d0 + 2];
    rot_diff = rot_diff + (da * da + db * db + dc * dc);

    if (T::is_effector(k)) {
      const int e = T::effector_slot(k);
      const float w = meta[kMetaEw + e];
      const float ex = pos[k][0] - sw[kSwTgt + 3 * e];
      const float ey = pos[k][1] - sw[kSwTgt + 3 * e + 1];
      const float ez = pos[k][2] - sw[kSwTgt + 3 * e + 2];
      cost = cost + w * (ex * ex + ey * ey + ez * ez);
    }
  }
  return cost + (meta[kMetaAw] / static_cast<float>(N - 1)) * rot_diff;
}

}  // namespace ikpso
