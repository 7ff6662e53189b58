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
// Supported terms: weighted squared effector error, angular locality
// (aw / (N-1)), node-position locality (dw / (N-1), the distance term),
// obstacle rejection and the orientation term, with polynomial or stock
// trig. The distance term and stock ("exact") trig are compile-time traits
// of the topology type (T::kDistance, T::kExact): false for the prebuilt
// Topology<...> instantiations, the flags of an OnDemandTopology<...>,
// which utils/kernels.py generates and compiles for one request.
//
// Distance (pallas_fitness.py:335-339, 394-396): per node, the squared
// distance of its position to its anchor position (swarm row, after the
// targets), accumulated like the angular term; added after it as
// total + (dw / (N-1)) * pos_diff.
//
// Exact trig (pallas_fitness.py:76-79): sinf / cosf, the libdevice
// routines torch.sin / torch.cos reach on the card, each on its own.
//
// Orientation (pallas_fitness.py:383-392): a template flag O. For each
// effector, the squared Frobenius distance of its world rotation to the
// target rotation (9 floats, row-major, at OFF_TROT of the swarm row),
// accumulated i = 0..8 in order and added as (ow * w) * fro, the Pallas
// association; ow sits at OFF_OW of meta, after the scene boxes. O = false
// compiles exactly the evaluation without it.
//
// Obstacles (pallas_fitness.py:293-305, 341-370, 397-398): the collider is
// a template parameter C. C = kNoCollider compiles exactly the
// obstacle-free evaluation (the headline's kernel); kBoxCollider tests the
// gizmo cube at each node and the link box at the link midpoint, both
// oriented by the node's world rotation, with the 15-axis SAT;
// kCapsuleCollider tests the node sphere and the parent->node capsule by
// closed-form point / segment OBB distances (24-round bisection). The
// obstacle count is a runtime value; each obstacle's 15 floats
// (center3, half3, rot9 row-major) are read from meta at OFF_OBS. A hit
// returns FLT_MAX (COLLISION_PENALTY), applied last. The collider bodies
// keep the Pallas op order (and -fmad=false), so a hit flips at exactly
// the inputs where the plain version's does; they stop at the first
// separating axis or the first hit, and an exact slab reject on the scene
// box's axes skips the SATs or the bisection of a pair that cannot hit
// (node_hits), which leaves the result unchanged. Bound, with a scene:
// the pairs the reject does not decide, lane by lane, and those a warp
// decides only in part, whose narrow phase the warp runs for its
// undecided lanes.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace ikpso {

__host__ __device__ constexpr int popcount_u32(unsigned m) {
  return m ? static_cast<int>(m & 1u) + popcount_u32(m >> 1) : 0;
}

// Serial chains (fk_fitness_eval_serial, below): node k hangs off node k - 1
// and the last node is the one effector; the node count is a run-time
// value, so one instantiation walks chains of any length (the 4-bit parent
// fields stop at 16 nodes, and at 50 links x, v and lbest outgrow a
// thread's registers in kernel A, which keeps them in global memory there).
//
// Tree topology as template data: node k's parent sits in bits [4k, 4k+4)
// of PARENTS (k >= 1; a 64-bit word, so up to 16 nodes), effector nodes are
// the set bits of EFFMASK, in ascending node order (the Python side checks
// effector_idx is sorted). The effector terms are added in node order, as
// the Pallas tile walks the nodes.
template <int N_, unsigned long long PARENTS_, unsigned EFFMASK_>
struct Topology {
  static constexpr int N = N_;
  static constexpr int D = 3 * (N_ - 1);
  static constexpr int E = popcount_u32(EFFMASK_);
  static constexpr bool kDistance = false;
  static constexpr bool kExact = false;
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
using Arm6Dof = Topology<3, 0x100ull, 0x4u>;             // id 2
using DualArm14 = Topology<7, 0x5402100ull, 0x48u>;      // id 3
using Humanoid45 = Topology<16, 0xED0BA08725422100ull, 0x9248u>;  // id 4
static_assert(Humanoid45::parent(15) == 14 && Humanoid45::parent(13) == 0 &&
                  Humanoid45::parent(7) == 2 && Humanoid45::E == 5 &&
                  Humanoid45::effector_slot(15) == 4,
              "parent fields are unsigned 64-bit shifts up to bit 63");
static_assert(DualArm14::parent(4) == 0 && DualArm14::D == 18 && DualArm14::E == 2,
              "dual-arm topology");
using Snake30 = Topology<11, 0x98765432100ull, 0x400u>;  // id 5: snake(10)
static_assert(Snake30::parent(10) == 9 && Snake30::parent(1) == 0 && Snake30::D == 30 &&
                  Snake30::E == 1 && Snake30::is_effector(10) &&
                  Snake30::effector_slot(10) == 0,
              "snake_30dof topology: node k hangs off k - 1, effector node 10");

// A list of ints as template data, read by constexpr folds (no array, so
// device code needs no memory for it): the unrolled walks call at() and
// index_of() with constant arguments, which fold to constants.
template <int... V>
struct IntList {
  static constexpr int size = static_cast<int>(sizeof...(V));
  __host__ __device__ static constexpr int at(int i) {
    int k = 0, out = -1;
    ((k++ == i ? (out = V, 0) : 0), ...);
    return out;
  }
  __host__ __device__ static constexpr int index_of(int x) {
    int k = 0, out = -1;
    ((V == x && out < 0 ? (out = k, 0) : 0, ++k), ...);
    return out;
  }
};

// A topology compiled for one request (utils/kernels.py, on demand): any
// tree, node k's parent PARENTS::at(k) (PARENTS::at(0) = -1), the
// effectors in EFFECTORS' order (their weights and targets follow it, as
// effector_idx orders them), with the kernel traits chosen when it is
// generated: kernel A's thread-block bound THREADS, whether kernel A
// streams its draws four DOFs at a time, and the distance and exact-trig
// flags. The Topology<...> interface, so every kernel template takes it.
template <class PARENTS, class EFFECTORS, int THREADS, bool STREAM, bool DIST, bool EXACT>
struct OnDemandTopology {
  static constexpr int N = PARENTS::size;
  static constexpr int D = 3 * (N - 1);
  static constexpr int E = EFFECTORS::size;
  static constexpr int kThreads = THREADS;
  static constexpr bool kStream = STREAM;
  static constexpr bool kDistance = DIST;
  static constexpr bool kExact = EXACT;
  __host__ __device__ static constexpr int parent(int k) { return PARENTS::at(k); }
  __host__ __device__ static constexpr bool is_effector(int k) {
    return EFFECTORS::index_of(k) >= 0;
  }
  __host__ __device__ static constexpr int effector_slot(int k) {
    return EFFECTORS::index_of(k);
  }
};
static_assert(IntList<-1, 0, 1, 1>::at(3) == 1 && IntList<-1, 0, 1, 1>::at(0) == -1 &&
                  IntList<8, 4, 12>::index_of(4) == 1 &&
                  IntList<8, 4, 12>::index_of(5) == -1,
              "IntList folds");

// Scene colliders; ids must match COLLIDERS in
// ikpso_tpu_torch/utils/kernels.py.
enum Collider : int { kNoCollider = 0, kBoxCollider = 1, kCapsuleCollider = 2 };

// The runtime scene: obstacle count and collider sizes, each computed in
// double and rounded to float32 on the host
// (ops/fitness_kernel.py::scene_constants).
struct Scene {
  int count;
  float node_half;  // box: gizmo cube half extent, gizmo * 0.5
  float link_half;  // box: link box half width, gizmo * 0.125
  float node_r2;    // capsule: node sphere radius squared, (gizmo * 0.5)^2
  float link_r2;    // capsule: link capsule radius squared, (gizmo * 0.125)^2
};

// Packed-constant offsets (MetaLayout; the topology-dependent ones are
// computed in fk_fitness_eval).
constexpr int kMetaAw = 0;
constexpr int kMetaDw = 1;
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

// Stock trig (trig_impl="exact"): sinf and cosf, each the libdevice
// routine torch.sin / torch.cos call for a float32 tensor on the card.
__device__ __forceinline__ void sincos_exact(float x, float& s, float& c) {
  s = sinf(x);
  c = cosf(x);
}

template <bool EXACT = false>
__device__ __forceinline__ void rot_xyz(float ax, float ay, float az, float (&r)[9]) {
  float sx, cx, sy, cy, sz, cz;
  if constexpr (EXACT) {
    sincos_exact(ax, sx, cx);
    sincos_exact(ay, sy, cy);
    sincos_exact(az, sz, cz);
  } else {
    sincos_poly(ax, sx, cx);
    sincos_poly(ay, sy, cy);
    sincos_poly(az, sz, cz);
  }
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

// The SAT's setup, shared by the gizmo cube's and the link box's tests:
// both boxes are oriented by the node's world rotation rot, so C = Ra^T Rb
// and |C| + 1e-6 are the same for the two (pallas_fitness.py:_sat_obb
// computes them in each call, with the same arithmetic).
__device__ __forceinline__ void sat_frame(const float (&rot)[9], const float* __restrict__ ob,
                                          float (&c)[9], float (&ac)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c[3 * i + j] = rot[i] * ob[6 + j] + rot[3 + i] * ob[9 + j] + rot[6 + i] * ob[12 + j];
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) ac[k] = fabsf(c[k]) + 1e-6f;
}

// Box SAT (pallas_fitness.py:_sat_obb): does the particle box (center p,
// axes = columns of rot, half extents a) overlap the scene box
// ob = [center3, half3, rot9]? c and ac from sat_frame; T = Ra^T (ob - p).
// The 15 axes in the Pallas order, stopping at the first that separates.
__device__ __forceinline__ bool sat_obb(float px, float py, float pz,
                                        const float (&rot)[9], const float (&c)[9],
                                        const float (&ac)[9], float a0, float a1, float a2,
                                        const float* __restrict__ ob) {
  const float dx = ob[0] - px, dy = ob[1] - py, dz = ob[2] - pz;
  const float t[3] = {rot[0] * dx + rot[3] * dy + rot[6] * dz,
                      rot[1] * dx + rot[4] * dy + rot[7] * dz,
                      rot[2] * dx + rot[5] * dy + rot[8] * dz};
  const float a[3] = {a0, a1, a2};
  const float b[3] = {ob[3], ob[4], ob[5]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float rb = b[0] * ac[3 * i] + b[1] * ac[3 * i + 1] + b[2] * ac[3 * i + 2];
    if (fabsf(t[i]) > a[i] + rb) return false;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float ra = a[0] * ac[j] + a[1] * ac[3 + j] + a[2] * ac[6 + j];
    const float proj = t[0] * c[j] + t[1] * c[3 + j] + t[2] * c[6 + j];
    if (fabsf(proj) > ra + b[j]) return false;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      const float ra = a[i1] * ac[3 * i2 + j] + a[i2] * ac[3 * i1 + j];
      const float rb = b[j1] * ac[3 * i + j2] + b[j2] * ac[3 * i + j1];
      const float lhs = fabsf(t[i2] * c[3 * i1 + j] - t[i1] * c[3 * i2 + j]);
      if (lhs > ra + rb) return false;
    }
  }
  return true;
}

// Coordinates of point p in scene box ob's frame (q_i = column i of R . (p - c));
// returns |p - c|_1, the scale of the rounding in q.
__device__ __forceinline__ float box_frame(const float (&p)[3], const float* __restrict__ ob,
                                           float (&q)[3]) {
  const float d0 = p[0] - ob[0], d1 = p[1] - ob[1], d2 = p[2] - ob[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) q[i] = ob[6 + i] * d0 + ob[9 + i] * d1 + ob[12 + i] * d2;
  return (fabsf(d0) + fabsf(d1)) + fabsf(d2);
}

// max(a, 0) as jnp.maximum takes it: a NaN comes through (fmaxf would
// return 0 for it). For a number it is fmaxf's value up to the sign of a
// zero, which every caller squares or copies a sign onto.
__device__ __forceinline__ float max0_nan(float a) { return a != a ? a : fmaxf(a, 0.0f); }

// sum_i max(|q_i| - h_i, 0)^2: squared distance of a box-frame point to the
// box; NaN where a coordinate is NaN, so the capsule collider's
// `<= r^2` fails on it and a NaN pose is no hit, as in JAX's collider
// (ops/collision.py's jnp.maximum) and the plain twin's clamp_min.
__device__ __forceinline__ float excess2(const float (&q)[3], const float* __restrict__ ob) {
  const float d0 = max0_nan(fabsf(q[0]) - ob[3]);
  const float d1 = max0_nan(fabsf(q[1]) - ob[4]);
  const float d2 = max0_nan(fabsf(q[2]) - ob[5]);
  return d0 * d0 + d1 * d1 + d2 * d2;
}

// jnp.sign(q) * max(|q| - h, 0), the bisection's per-axis term: 0 at q = +-0
// (for any h, a negative half extent too), else max(|q| - h, 0) with q's
// sign. It equals the product of jnp.sign and the clamp up to the sign of
// a zero (NaN's sign, 0 times the clamp, comes out +-0 as well), and a
// signed zero moves g only where every term is zero, which g > 0 reads
// alike. A NaN q needs no NaN here: q = q0 + t b is NaN only where q0 or
// b = q1 - q0 is, so its term times b is NaN and g > 0 false either way, as
// with jnp.sign's NaN. The select and the sign copy replace the product's
// two compares, integer subtract and int-to-float conversion (I2FP in the
// SASS).
__device__ __forceinline__ float signed_excess(float q, float h) {
  return q == 0.0f ? 0.0f : copysignf(fmaxf(fabsf(q) - h, 0.0f), q);
}

// Squared distance of the segment with box-frame end points q0 -> q1 to
// the scene box (pallas_fitness.py:_seg_obb_dist2): 24 bisection rounds on
// the monotone derivative g(t).
__device__ __forceinline__ float seg_obb_dist2(const float (&q0)[3], const float (&q1)[3],
                                               const float* __restrict__ ob) {
  float b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) b[i] = q1[i] - q0[i];
  float lo = 0.0f, hi = 1.0f;
#pragma unroll 4
  for (int r = 0; r < 24; ++r) {
    const float tm = 0.5f * (lo + hi);
    float g = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float qi = q0[i] + tm * b[i];
      const float si = signed_excess(qi, ob[3 + i]);
      g = i ? g + si * b[i] : si * b[i];
    }
    const bool pred = g > 0.0f;
    hi = pred ? tm : hi;
    lo = pred ? lo : tm;
  }
  const float t = 0.5f * (lo + hi);
  float q[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) q[i] = q0[i] + t * b[i];
  return excess2(q, ob);
}

// The exact slab reject (broad phase), ahead of the narrow phase above.
//
// A (node, scene box) pair costs the Pallas tile two full SATs (box) or a
// 24-round bisection (capsule), though almost every pair is far from every
// box. The reject decides "no hit" from the box-frame coordinates q1 of the
// node pk and q0 of its parent pp: a part of the particle body is
// separated on scene axis j when every point of it lies beyond the slab
// |q_j| <= b_j by more than its radius. It never decides "hit", and it
// decides "no hit" only where the narrow phase says so, so the result
// (FLT_MAX or the cost) is bit for bit the narrow phase's; only the work
// changes. ob's half extents b_j are used as given (a negative one moves
// both sides alike).
//
// Capsule (sphere radius sqrt(node_r2) at pk, capsule radius
// r = sqrt(link_r2) about pp -> pk). The sphere keeps its test. The capsule
// is separated when, for some j, q0_j and q1_j lie beyond
// b_j + r (1 + kCapsuleSlack) + kCapsuleSlack (|q0|_1 + |q1|_1) + kRejectAbs
// on one side. Proof: seg_obb_dist2 returns excess2 at q0 + t (q1 - q0) for
// some t in [0, 1], the same q0, q1 the reject reads; in exact arithmetic
// its coordinate j lies on that side at least as far as the nearer end
// point, and the float rounding of q1 - q0, t (q1 - q0) and the sum is
// below 5 x 2^-24 (|q0_j| + |q1_j|). So max(|q_j| - b_j, 0) > r (1 + 1e-4),
// its square > link_r2 after rounding, and excess2, a sum of non-negative
// rounded squares, is at least that: the bisection's test
// excess2 <= link_r2 fails. No rotation enters, so no precondition.
//
// Box (gizmo cube of half a = node_half at pk; link box of half extents
// (len / 2, w, w), w = link_half, centered at (pk + pp) / 2: the segment
// pp -> pk, which runs along rot's x axis, swept by a square). Cube
// separated on j: |q1_j| - b_j > sqrt(3) |a| (1 + eps) + M. Link box
// separated on j: q0_j and q1_j both beyond b_j + sqrt(2) |w| (1 + eps) + M
// on one side. M = eps (|pk|_1 + |pp|_1 + |pk - c|_1 + |pp - c|_1) +
// kRejectAbs. Then the SAT's scene-face-axis test j (sat_obb's second
// loop) fires, so sat_obb returns false. Proof, with u = column j of the
// scene rotation and R = rot: proj = t . C_j = d^T R R^T u, d = c - p, is
// -q_j up to |d| |u| ||R R^T - I|| and rounding of order 2^-24 |d|; ra =
// sum_i |a_i| (|R_i . u| + 1e-6) <= sqrt(3) |a| sigma_max(R) |u| + 3e-6 |a|
// (cube; for the link box sum_i (R_i . u)^2 <= sigma_max(R)^2 |u|^2 bounds
// w (|R_1 . u| + |R_2 . u|) by sqrt(2) w sigma_max(R) |u|, and len / 2 |R_0 . u|
// is what (q0_j + q1_j) / 2 exceeds the nearer end point by, since
// pk - pp = len R_0 up to the rounding of pk; a negative len or half only
// lowers ra). The center (pk + pp) / 2 and pk round at 2^-24 |pk|_1 + |pp|_1.
// eps covers ||R R^T - I||, sigma_max(R) - 1, |u| - 1 and the 1e-6 pad;
// M's terms the rounding. The bounds hold when
//  * the root rotation is orthonormal to kRejectTau (Gershgorin on R0^T R0:
//    each row of R0^T R0 - I sums to <= kRejectTau in absolute value),
//  * every scene axis has |u|^2 within kRejectTau of 1, and
//  * with polynomial trig every angle of the walk so far is within
//    kRejectMaxAngle (4 pi, where sincos_poly's sin^2 + cos^2 is within 4e-6
//    of 1; tests/test_torch_broad_phase.py holds the poly to it), so each
//    node's local rotation and compose move sigma(R) by < 1e-5; stock trig
//    stays within a few ulps at any angle.
// Then sigma(R)^2 lies within (1 + kRejectTau)(1 + 1e-5)^(2N) - 1 of 1 down
// any chain of N nodes, and eps = 4e-3 + 5e-5 N covers that with |u| - 1.
// box_reject_slack checks the first two once per swarm row (box_row_slack),
// the walk the third; where one fails, eps is +inf and the reject decides
// nothing.
// Non-finite inputs make M infinite or NaN, so a comparison with them is
// false and the reject decides nothing either.
constexpr float kRejectTau = 2e-3f;
constexpr float kRejectMaxAngle = 12.5f;
constexpr float kRejectAbs = 1e-15f;  // keeps the thresholds off the subnormals
constexpr float kCapsuleSlack = 1e-4f;
constexpr float kSqrt2 = 1.41421356f;
constexpr float kSqrt3 = 1.73205081f;

// eps of the box reject for a topology of N nodes (rounded from double, as
// ops/fitness_kernel.py::box_reject_eps rounds it).
template <class T>
__host__ __device__ constexpr float box_reject_eps() {
  return static_cast<float>(4e-3 + 5e-5 * T::N);
}

// The box reject's eps, or +inf where the root rotation (row-major at root)
// or a scene axis is too far from orthonormal for its proof.
template <class T>
__device__ __forceinline__ float box_reject_slack(const float* __restrict__ root,
                                                  const float* __restrict__ obs,
                                                  int count) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float row = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float g = root[i] * root[j] + root[3 + i] * root[3 + j] + root[6 + i] * root[6 + j];
      row = row + fabsf(i == j ? g - 1.0f : g);
    }
    ok = ok & (row <= kRejectTau);
  }
  for (int o = 0; o < count; ++o) {
    const float* ob = obs + 15 * o;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float n2 = ob[6 + j] * ob[6 + j] + ob[9 + j] * ob[9 + j] + ob[12 + j] * ob[12 + j];
      ok = ok & (fabsf(n2 - 1.0f) <= kRejectTau);
    }
  }
  return ok ? box_reject_eps<T>() : INFINITY;
}

// The box reject's eps for swarm row sw (box_reject_slack: its root
// rotation and meta's scene boxes), the row_slack argument of
// fk_fitness_eval*. It is the same for every particle and iteration of the
// row, so a kernel computes it once a row, not once an evaluation; +inf
// (the reject decides nothing) without a box scene.
template <class T, int C>
__device__ __forceinline__ float box_row_slack(const float* __restrict__ meta,
                                               const float* __restrict__ sw, Scene scene) {
  if constexpr (C == kBoxCollider) {
    return box_reject_slack<T>(sw + kSwRoot, meta + kMetaLen + (T::N - 1) + T::E,
                               scene.count);
  }
  return INFINITY;
}

// For some axis j, do q0_j and q1_j both lie beyond ob's half extent b_j
// plus thr on one side?
__device__ __forceinline__ bool slab_reject(const float (&q0)[3], const float (&q1)[3],
                                            const float* __restrict__ ob, float thr) {
  bool out = false;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float lo = fminf(q0[j], q1[j]), hi = fmaxf(q0[j], q1[j]);
    out = out | (fmaxf(lo, -hi) - ob[3 + j] > thr);
  }
  return out;
}

// Does node k (position pk, world rotation rk, parent position pp, link
// length len) hit any scene box? slack is the box reject's eps (or +inf).
template <int C>
__device__ __forceinline__ bool node_hits(const float (&pk)[3], const float (&rk)[9],
                                          const float (&pp)[3], float len,
                                          const float* __restrict__ obs,
                                          Scene scene, float slack) {
  if constexpr (C == kBoxCollider) {
    const float pmag = ((fabsf(pk[0]) + fabsf(pk[1])) + fabsf(pk[2])) +
                       ((fabsf(pp[0]) + fabsf(pp[1])) + fabsf(pp[2]));
    const float grow = 1.0f + slack;
    const float r_cube = (kSqrt3 * fabsf(scene.node_half)) * grow;
    const float r_link = (kSqrt2 * fabsf(scene.link_half)) * grow;
    for (int o = 0; o < scene.count; ++o) {
      const float* ob = obs + 15 * o;
      float q0[3], q1[3];
      const float m1 = box_frame(pk, ob, q1);
      const float m0 = box_frame(pp, ob, q0);
      const float margin = slack * ((pmag + m1) + m0) + kRejectAbs;
      bool cube_sep = false;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        cube_sep = cube_sep | (fabsf(q1[j]) - ob[3 + j] > r_cube + margin);
      }
      const bool link_sep = slab_reject(q0, q1, ob, r_link + margin);
      if (cube_sep && link_sep) continue;
      float c[9], ac[9];
      sat_frame(rk, ob, c, ac);
      if (!cube_sep && sat_obb(pk[0], pk[1], pk[2], rk, c, ac, scene.node_half,
                               scene.node_half, scene.node_half, ob)) {
        return true;
      }
      if (!link_sep &&
          sat_obb((pk[0] + pp[0]) * 0.5f, (pk[1] + pp[1]) * 0.5f, (pk[2] + pp[2]) * 0.5f, rk,
                  c, ac, len * 0.5f, scene.link_half, scene.link_half, ob)) {
        return true;
      }
    }
  } else {
    const float r_cap = sqrtf(scene.link_r2) * (1.0f + kCapsuleSlack);
    for (int o = 0; o < scene.count; ++o) {
      const float* ob = obs + 15 * o;
      float q0[3], q1[3];
      box_frame(pk, ob, q1);
      if (excess2(q1, ob) <= scene.node_r2) return true;
      box_frame(pp, ob, q0);
      const float qmag = ((fabsf(q0[0]) + fabsf(q0[1])) + fabsf(q0[2])) +
                         ((fabsf(q1[0]) + fabsf(q1[1])) + fabsf(q1[2]));
      if (!slab_reject(q0, q1, ob, r_cap + (kCapsuleSlack * qmag + kRejectAbs)) &&
          seg_obb_dist2(q0, q1, ob) <= scene.link_r2) {
        return true;
      }
    }
  }
  return false;
}

// Meta's offsets past the link lengths for topology T: the effector
// weights, then the scene boxes (15 floats each) and, with the orientation
// term, its weight after them.
template <class T>
__host__ __device__ constexpr int meta_ew() {
  return kMetaLen + (T::N - 1);
}
template <class T>
__host__ __device__ constexpr int meta_obs() {
  return meta_ew<T>() + T::E;
}

// The two locality weights over the joint count, aw / (N-1) and
// dw / (N-1) (the distance term's), as the cost adds them; the same for
// every particle of a chain, so a caller may compute them once.
struct JointWeights {
  float angle, distance;
};
template <class T>
__device__ __forceinline__ JointWeights joint_weights(const float* __restrict__ meta) {
  JointWeights w{meta[kMetaAw] / static_cast<float>(T::N - 1), 0.0f};
  if constexpr (T::kDistance) w.distance = meta[kMetaDw] / static_cast<float>(T::N - 1);
  return w;
}

// Fitness of one particle: x(d) returns its angle d; meta / sw point at
// the packed per-chain / per-swarm constants (MetaLayout) and are read at
// compile-time offsets only; obs points at meta's scene boxes and, after
// them, the orientation weight (meta + meta_obs<T>()); weights() returns
// meta's locality weights (joint_weights), asked for after the walk.
// scene is read only when C != kNoCollider, row_slack (box_row_slack of
// sw) only when C is kBoxCollider; O adds the orientation term;
// T::kDistance the distance term, T::kExact stock trig. With RELOAD_ROOT
// the root's frame (a constant of the swarm row) is read from sw again
// for each child of the root, through a volatile load, so no register
// holds it across the walk of the root's other subtrees (the values, and
// so the bits, are the same).
template <class T, int C, bool O, bool RELOAD_ROOT = false, class X, class W>
__device__ __forceinline__ float fk_fitness_walk(X x, const float* __restrict__ meta,
                                                 const float* __restrict__ sw,
                                                 const float* __restrict__ obs, W weights,
                                                 Scene scene, float row_slack) {
  constexpr int N = T::N;
  constexpr int D = T::D;
  constexpr int kMetaEw = meta_ew<T>();
  constexpr int kSwTgt = kSwAnchor + D;
  constexpr int kSwApos = kSwTgt + 3 * T::E;
  constexpr int kSwTrot = kSwApos + 3 * (N - 1);
  float rot[N][9];
  float pos[N][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) rot[0][i] = sw[kSwRoot + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) pos[0][i] = sw[kSwOrigin + i];
  float rot_diff = 0.0f;
  float pos_diff = 0.0f;
  float cost = 0.0f;
  bool hit = false;
  [[maybe_unused]] float slack = row_slack;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const int d0 = 3 * (k - 1);
    const int p = T::parent(k);
    if constexpr (RELOAD_ROOT) {
      if (p == 0) {
        const volatile float* root = sw;
#pragma unroll
        for (int i = 0; i < 9; ++i) rot[0][i] = root[kSwRoot + i];
#pragma unroll
        for (int i = 0; i < 3; ++i) pos[0][i] = root[kSwOrigin + i];
      }
    }
    const float ax = x(d0), ay = x(d0 + 1), az = x(d0 + 2);
    float local[9];
    rot_xyz<T::kExact>(ax, ay, az, local);
    mat_mul(rot[p], local, rot[k]);
    const float len = meta[kMetaLen + (k - 1)];
    pos[k][0] = pos[p][0] + len * rot[k][0];
    pos[k][1] = pos[p][1] + len * rot[k][3];
    pos[k][2] = pos[p][2] + len * rot[k][6];

    const float da = ax - sw[kSwAnchor + d0];
    const float db = ay - sw[kSwAnchor + d0 + 1];
    const float dc = az - sw[kSwAnchor + d0 + 2];
    rot_diff = rot_diff + (da * da + db * db + dc * dc);

    if constexpr (T::kDistance) {
      const float ox = pos[k][0] - sw[kSwApos + d0];
      const float oy = pos[k][1] - sw[kSwApos + d0 + 1];
      const float oz = pos[k][2] - sw[kSwApos + d0 + 2];
      pos_diff = pos_diff + (ox * ox + oy * oy + oz * oz);
    }

    if constexpr (C == kBoxCollider && !T::kExact) {
      if (!(fabsf(ax) <= kRejectMaxAngle && fabsf(ay) <= kRejectMaxAngle &&
            fabsf(az) <= kRejectMaxAngle)) {
        slack = INFINITY;
      }
    }
    if constexpr (C != kNoCollider) {
      if (!hit) {
        hit = node_hits<C>(pos[k], rot[k], pos[p], len, obs, scene, slack);
      }
    }

    if (T::is_effector(k)) {
      const int e = T::effector_slot(k);
      const float w = meta[kMetaEw + e];
      const float ex = pos[k][0] - sw[kSwTgt + 3 * e];
      const float ey = pos[k][1] - sw[kSwTgt + 3 * e + 1];
      const float ez = pos[k][2] - sw[kSwTgt + 3 * e + 2];
      cost = cost + w * (ex * ex + ey * ey + ez * ez);
      if constexpr (O) {
        const float ow = obs[C == kNoCollider ? 0 : 15 * scene.count];
        const float* rt = sw + kSwTrot + 9 * e;
        float fro = 0.0f;
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          const float dr = rot[k][i] - rt[i];
          fro = fro + dr * dr;
        }
        cost = cost + (ow * w) * fro;
      }
    }
  }
  const JointWeights jw = weights();
  float total = cost + jw.angle * rot_diff;
  if constexpr (T::kDistance) total = total + jw.distance * pos_diff;
  if constexpr (C != kNoCollider) return hit ? FLT_MAX : total;
  return total;
}

// fk_fitness_walk with its scene boxes and weights read from meta.
template <class T, int C, bool O, class X>
__device__ __forceinline__ float fk_fitness_eval_at(X x, const float* __restrict__ meta,
                                                    const float* __restrict__ sw,
                                                    Scene scene, float row_slack) {
  return fk_fitness_walk<T, C, O>(
      x, meta, sw, meta + meta_obs<T>(), [=] { return joint_weights<T>(meta); }, scene,
      row_slack);
}

// fk_fitness_eval_at on a register array of the D angles.
template <class T, int C = kNoCollider, bool O = false>
__device__ __forceinline__ float fk_fitness_eval(const float (&x)[T::D],
                                                 const float* __restrict__ meta,
                                                 const float* __restrict__ sw,
                                                 Scene scene, float row_slack) {
  return fk_fitness_eval_at<T, C, O>([&](int d) { return x[d]; }, meta, sw, scene,
                                     row_slack);
}

// fk_fitness_eval_at on angles at x[d * stride]: the lane-major (S, D, P)
// layout and kernel A's scratch. x is not __restrict__, as in
// fk_fitness_eval_serial below.
template <class T, int C = kNoCollider, bool O = false>
__device__ __forceinline__ float fk_fitness_eval_strided(const float* x, long long stride,
                                                         const float* __restrict__ meta,
                                                         const float* __restrict__ sw,
                                                         Scene scene, float row_slack) {
  return fk_fitness_eval_at<T, C, O>([=](int d) { return x[d * stride]; }, meta, sw,
                                     scene, row_slack);
}

// Fitness of one particle of a serial chain of n nodes (n >= 2), without a
// scene or the orientation term: the walk carries one world rotation and
// one position from node to node, in fk_fitness_eval's op order. Angle d
// is read at x[d * stride] (stride 1 for a particle's (S, P, D) row, P for
// the lane-major (S, D, P) layout and kernel A's scratch). x is not
// __restrict__: kernel A's serial variant reads back angles it has just
// written, which a read-only (non-coherent) load could miss.
__device__ __forceinline__ float fk_fitness_eval_serial(const float* x, long long stride,
                                                        int n,
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
  for (int k = 1; k < n; ++k) {
    const int d0 = 3 * (k - 1);
    const float ax = x[d0 * stride], ay = x[(d0 + 1) * stride], az = x[(d0 + 2) * stride];
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
  const float ex = pos[0] - sw[sw_tgt];
  const float ey = pos[1] - sw[sw_tgt + 1];
  const float ez = pos[2] - sw[sw_tgt + 2];
  const float cost = meta[meta_ew] * (ex * ex + ey * ey + ez * ez);
  return cost + (meta[kMetaAw] / static_cast<float>(n - 1)) * rot_diff;
}

// Kernel B's standalone launcher body: (S, P, D) angles -> (S, P) fitness,
// one thread per particle (fk_fitness.cu, and on demand on_demand.cuh).
template <class T, int C, bool O>
__global__ void fk_fitness_kernel(const float* __restrict__ x,
                                  const float* __restrict__ meta,
                                  const float* __restrict__ swarm, int K, Scene scene,
                                  float* __restrict__ out, long long total, int P) {
  constexpr int D = T::D;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long s = t / P;
  float xr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) xr[d] = x[t * D + d];
  out[t] = fk_fitness_eval<T, C, O>(xr, meta, swarm + s * K, scene,
                                    box_row_slack<T, C>(meta, swarm + s * K, scene));
}

constexpr int kFkFitnessThreads = 256;

template <class T, int C, bool O = false>
static void launch_fk_fitness(const float* x, const float* meta, const float* swarm,
                              int K, Scene scene, float* out, long long total, int P,
                              cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((total + kFkFitnessThreads - 1) / kFkFitnessThreads);
  fk_fitness_kernel<T, C, O><<<blocks, kFkFitnessThreads, 0, stream>>>(x, meta, swarm, K,
                                                                      scene, out, total, P);
}

}  // namespace ikpso
