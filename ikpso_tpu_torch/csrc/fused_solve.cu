// Kernel A: one complete PSO solve per swarm, state resident on chip.
//
// Replaces ikpso_tpu/pso/fused.py:fused_solve_raw (kernel body
// _build_solver_kernel, helpers _uniform and _seg_rows_reduce), branches:
// warm, uniform or hybrid init (a runtime flag, run once before the loop);
// canonical inertia with a per-iteration schedule, or randomized inertia
// (v = (w u_w) v + ...; runtime flag); gbest refreshed every
// gbest_interval iterations; the velocity re-kick every rekick_interval
// iterations with its threshold (runtime arguments, below); the
// position/angle cost, the orientation term (template flag O) and obstacle
// rejection through the collider variants of fk_fitness_eval (template
// parameter C; the scene boxes ride in meta, which is copied to shared
// memory).
//
// Layout: one thread block per swarm, one thread per particle
// (blockDim = P, a multiple of 32, <= KernelAThreads<T>: 1024, 512 for the
// 45-DOF humanoid, so a thread may hold 128 registers instead of 64, and
// 256 for reference_arm and snake_30dof, three blocks an SM at 80
// registers, KernelAMinBlocks). Serial chains without a compile-time
// topology run the serial-chain variant, which keeps x and v (and lbest
// where it does not fit shared memory) in global scratch (scratch_solve in
// fused_solve.cuh, with the design notes of the scratch layout); a tree
// past 45 DOFs built on demand takes the same layout
// (fused_solve_tree_scratch_kernel, on_demand.cuh), and a branching tree
// of up to 60 DOFs the cluster layout instead, a swarm over a
// thread-block cluster (fused_solve_cluster.cuh). The kernel templates
// live in fused_solve.cuh; this file instantiates the prebuilt trees and
// the serial-chain variant behind the C entry points, fused_solve_short.cu
// the prebuilt short chains (below).
// x (D floats) and lval live in registers for the whole solve; v and
// lbest (D floats each) beside them for the short chains, and in dynamic
// shared memory for the trees, reference_arm and snake_30dof (StatePlacement
// in fused_solve.cuh: with all three in registers the humanoid spilled
// 1,360 bytes and the dual arm 608): [D][P] each, or, in the tree loop
// that each of these prebuilt topologies runs (fused_solve_tree_kernel,
// TreeLoop; its notes are in fused_solve.cuh), a float4 row a particle; the
// chain's packed meta, the swarm's constant row and the joint limits are
// copied to shared memory once. The trees, reference_arm and snake_30dof
// draw their uniforms four DOFs at a time next to their use
// (StreamDraws), so no D-float draw array is live beside x, v and lbest.
// The TPU kernel's 8x128 tiles, swarm packing, roll-tree reductions and
// constant hoisting are TPU layout devices and have no counterpart here.
//
// gbest (fused_solve_kernel; the short chains and the tree loop take one
// barrier, below and in fused_solve.cuh): a block-wide argmin over (lval, particle
// id) -- each warp's (least order_key, least id) by two __reduce_min_sync,
// then one pass over the per-warp winners in shared memory. Ties go to the
// lowest particle id, the first-minimum semantics of pso/fused.py:255-260,
// 344-359 (thrust::min_element in the reference), NaN first as
// torch.argmin puts it. The winner's lbest is copied to
// shared memory (by the winner from its registers, or by the block
// together where lbest is in shared memory); everyone reads it after a
// __syncthreads(). Two barriers per gbest refresh; an iteration without a
// refresh (gbest_interval > 1) has none.
//
// Short chains (fused_solve_short_kernel: the register placement with
// whole draw arrays -- arm_7dof, which planar_3dof runs on, with or without
// a scene, arm_6dof with or without the orientation term, and an
// on-demand chain placed so). What bounds them on this card is instruction
// issue: -fmad=false (the bit-for-bit contract) makes every mul and add of
// the walk its own instruction, and the SASS of the headline's loop
// (chip_smoke.py, phase sass_kernel_a) held ~1,060 warp instructions an
// iteration, ~630 of them the FP32 arithmetic, ~220 Philox's (its round
// keys already in uniform registers: the key schedule costs nothing an
// iteration), ~125 the gbest refresh, 61 scalar shared loads of the
// constants, limits and gbest, and the run-time update branches' moves;
// at one warp instruction a scheduler a clock that is ~0.85 of the time
// the kernel took. The design cuts what issues around the arithmetic,
// which stays op for op:
//   - gbest in one barrier: each warp takes its (min lval, lowest id) with
//     two __reduce_min_sync on an order-preserving unsigned key
//     (order_key), its winner publishes key, id, value and lbest in a warp
//     slot, and after the one barrier every thread scans the warp winners
//     in warp order (the first least key holds the least id) and reads the
//     winner's row in place; two slot sets taken in turn keep a refresh's
//     writes off the previous refresh's reads;
//   - the walk's constants (the swarm row's head, meta's head) and the
//     limits copied once into 16-byte aligned static shared memory
//     (ShortShared), read as float4; the constants then held in registers
//     for the whole solve, and the angle weight's division by N - 1
//     computed once (JointWeights);
//   - a second instantiation at a 256-thread bound (kShortThreads; a swarm
//     of at most 256 particles takes it, every short-chain preset runs
//     128), with the register cap of ShortMinBlocks instead of the
//     1,024-thread bound's 64, where the box scene spilled 452 bytes;
//   - at that bound, the canonical update (canonical inertia, gbest every
//     iteration, no re-kick: the headline's) as a template flag with its
//     branches gone (CANON); every other update keeps the run-time ones.
// The draws keep their counters, slots and words, so the plain twin and
// the replay are unchanged. Every argmin of kernel A takes the plain twin's
// order (order_key): a NaN lval goes before every number, the first NaN by
// particle id where there are several.
//
// Re-kick (pso/fused.py:383-426): iterations run in blocks of
// rekick_interval (a multiple of gbest_interval, so every block starts with
// a refresh). At each block start but the first, v is overwritten with
// (u_k * 2 - 1) * rekick_scale; with rekick_threshold >= 0 only if the
// swarm's min lval at the block start is above it. That min is the value
// the refresh's argmin has just found: lval does not change between the
// block start and the refresh, and every thread holds the same winner, so
// the whole block takes the same branch.
//
// Random draws: Philox4x32-10 in registers (philox.cuh), keyed by the
// swarm's two seed words, counter (particle, draw slot, dof / 4, 0),
// output word dof % 4;
// U = (bits >> 8) * 2^-24 on unsigned bits (pso/fused.py:87-96). The
// mapping is defined in ikpso_tpu_torch/ops/philox.py, whose torch
// Philox draws the same bits. Slots follow the TPU kernel's replay order
// (pso/fused.py:245-250, 390-394): the init draws first (uniform / hybrid:
// the position draw at slot 0; the velocity draw at slot n_init - 1), then
// dpi = (randomized ? 3 : 2) + (re-kick ? 1 : 0) slots per iteration:
// u_c at n_init + dpi it, u_s one after, u_w two after (randomized), and
// the kick draw of a block starting at it in its last slot,
// n_init + dpi it + dpi - 1. REPLAY=true instead reads
// uniforms[S, n_draws, D, P] from HBM (the test hook; a template flag so
// the hot path has no branch).
//
// Collision penalty: a colliding particle's fitness is FLT_MAX, so
// f < lval is false against a colliding lbest and ties at FLT_MAX go to
// the lowest particle id like every other tie; a swarm whose particles
// all collide returns particle 0's lbest with value FLT_MAX.
//
// Bound on this card: arithmetic, issued one instruction at a time (see
// Short chains). HBM sees only the swarm constants in and one
// (D + 1)-float row out per swarm; per particle and iteration the work is
// one FK + cost (fk_fitness.cuh), 3 Philox calls per draw slot (10 rounds
// of 2 mul.hi + 2 mul.lo each) and the velocity update. The short chains
// keep all state in registers and spend shared memory only on the
// constants and the argmin slots, so many blocks fit per SM; a tree's
// block fills its SM's registers on its own, so the shared memory its v
// and lbest take costs it no occupancy.
#include <cuda_runtime.h>

#include "fused_solve.cuh"

extern "C" int ikpso_fused_solve(int topo, int collider, int orient, int replay,
                                 int init_mode, int n_obs, float node_half,
                                 float link_half, float node_r2, float link_r2,
                                 const float* meta, int M, const float* swarm, int K,
                                 const float* limits, const int* seeds,
                                 const float* inertia, int iters, float c1, float c2,
                                 float vscale, int randomized, int gbest_interval,
                                 int rekick_interval, float rekick_scale,
                                 float rekick_threshold, const float* uniforms,
                                 int n_draws, float* gbest, float* gval, int S, int P,
                                 int threads, void* stream) {
  using namespace ikpso;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (P <= 0 || P > threads || P % 32 != 0 || init_mode < kInitWarm ||
      init_mode > kInitHybrid || n_obs < 0 || gbest_interval < 1 ||
      rekick_interval < 0 || (rekick_interval > 0 && rekick_interval % gbest_interval) ||
      (orient && (topo != 2 || collider != kNoCollider))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scene scene{n_obs, node_half, link_half, node_r2, link_r2};
  const Update up{randomized != 0, gbest_interval, rekick_interval, rekick_scale,
                  rekick_threshold};
  cudaError_t rc = cudaSuccess;
#define IKPSO_LAUNCH(TOPO, C, O)                                                         \
  rc = threads != KernelAThreads<TOPO>::value                                           \
           ? cudaErrorInvalidValue                                                      \
           : launch_fused_solve<TOPO, C, O>(replay != 0, meta, M, swarm, K, limits, seeds, \
                                            inertia, iters, c1, c2, vscale, init_mode,   \
                                            scene, up, uniforms, n_draws, gbest, gval, S, \
                                            P, st)
  if (topo == 0 || topo == 2) {
    rc = launch_short_prebuilt(topo, collider, orient != 0, threads, replay != 0, meta, M,
                               swarm, K, limits, seeds, inertia, iters, c1, c2, vscale,
                               init_mode, scene, up, uniforms, n_draws, gbest, gval, S, P,
                               st);
  } else if (topo == 1 && collider == kNoCollider) {
    IKPSO_LAUNCH(ReferenceArm, kNoCollider, false);
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
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The short chains' second thread bound (kShortThreads; SHORT_THREADS in
// utils/kernels.py).
extern "C" int ikpso_kernel_a_short_threads() { return ikpso::kShortThreads; }

// Kernel A's dynamic shared-memory bytes with `planes` [D][P] float planes
// after the constants (kernel_a_smem_bytes): lets a caller hold its own
// reckoning against the kernels'.
extern "C" long long ikpso_kernel_a_smem_bytes(int M, int K, int D, int P, int planes) {
  return static_cast<long long>(ikpso::kernel_a_smem_bytes(M, K, D, P, planes));
}

// Kernel A's tree-loop dynamic shared-memory bytes (tree_smem_bytes).
extern "C" long long ikpso_kernel_a_tree_smem_bytes(int M, int D, int P) {
  return static_cast<long long>(ikpso::tree_smem_bytes(M, D, P));
}

// Kernel A's cluster-layout dynamic shared-memory bytes (cluster_smem_bytes,
// Pb threads a block).
extern "C" long long ikpso_kernel_a_cluster_smem_bytes(int M, int K, int D, int Pb) {
  return static_cast<long long>(ikpso::cluster_smem_bytes(M, K, D, Pb));
}

namespace {

// The serial-chain variant's kernel for a replay flag and lbest placement,
// allowed the card's opt-in shared memory (once per instantiation); most
// is that maximum, 0 on an error.
template <bool REPLAY, bool LB_SHARED>
auto serial_kernel(int& most) {
  static const int allowed =
      ikpso::allow_dynamic_smem(ikpso::fused_solve_serial_kernel<REPLAY, LB_SHARED>);
  most = allowed;
  return ikpso::fused_solve_serial_kernel<REPLAY, LB_SHARED>;
}

auto serial_kernel(int replay, int lb_shared, int& most) {
  if (lb_shared) {
    return replay ? serial_kernel<true, true>(most) : serial_kernel<false, true>(most);
  }
  return replay ? serial_kernel<true, false>(most) : serial_kernel<false, false>(most);
}

size_t serial_smem_bytes(int M, int K, int n_nodes, int P, int lb_shared) {
  return ikpso::kernel_a_smem_bytes(M, K, 3 * (n_nodes - 1), P, lb_shared ? 1 : 0);
}

}  // namespace

// How many blocks of the serial-chain variant fit the card at once (its
// grid, and so its scratch), lbest in shared memory where lb_shared; <= 0
// on an error or where one block's shared memory does not fit.
extern "C" int ikpso_fused_solve_serial_blocks(int replay, int lb_shared, int P, int M,
                                               int K, int n_nodes) {
  using namespace ikpso;
  if (n_nodes < 2 || P <= 0 || P > kSerialThreads) return -1;
  int most = 0, per_sm = 0, device = 0, sms = 0;
  const auto kernel = serial_kernel(replay, lb_shared, most);
  const size_t smem = serial_smem_bytes(M, K, n_nodes, P, lb_shared);
  if (smem > static_cast<size_t>(most)) return -1;
  const cudaError_t rc =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P, smem);
  if (rc != cudaSuccess || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return -1;
  }
  return per_sm * sms;
}

// The serial-chain variant of kernel A; scratch holds grid x planes x D x P
// floats (planes 2 where lb_shared, else 3), grid <=
// ikpso_fused_solve_serial_blocks(...).
extern "C" int ikpso_fused_solve_serial(int replay, int lb_shared, int init_mode,
                                        int n_nodes, const float* meta, int M,
                                        const float* swarm, int K, const float* limits,
                                        const int* seeds, const float* inertia, int iters,
                                        float c1, float c2, float vscale, int randomized,
                                        int gbest_interval, int rekick_interval,
                                        float rekick_scale, float rekick_threshold,
                                        const float* uniforms, int n_draws, float* scratch,
                                        int grid, float* gbest, float* gval, int S, int P,
                                        void* stream) {
  using namespace ikpso;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (n_nodes < 2 || grid <= 0 || P <= 0 || P > kSerialThreads || P % 32 != 0 ||
      init_mode < kInitWarm || init_mode > kInitHybrid || gbest_interval < 1 ||
      rekick_interval < 0 || (rekick_interval > 0 && rekick_interval % gbest_interval)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int most = 0;
  const auto kernel = serial_kernel(replay, lb_shared, most);
  const size_t smem = serial_smem_bytes(M, K, n_nodes, P, lb_shared);
  if (smem > static_cast<size_t>(most)) return static_cast<int>(cudaErrorInvalidValue);
  const Update up{randomized != 0, gbest_interval, rekick_interval, rekick_scale,
                  rekick_threshold};
  kernel<<<grid, P, smem, st>>>(n_nodes, meta, M, swarm, K, limits, seeds, inertia, iters,
                                c1, c2, vscale, init_mode, up, uniforms, n_draws, scratch,
                                gbest, gval, S);
  return static_cast<int>(cudaGetLastError());
}
