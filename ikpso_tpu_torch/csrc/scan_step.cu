// The scan solver's step (scan_step.cuh) for the prebuilt topologies and the
// serial-chain variant: every (topology, collider, orientation) kernel C's
// launcher instantiates, so every configuration kernel C runs on the card
// has a step; any other is built on demand (on_demand.cuh). Each in two
// instantiations: the drawing step (replay = 0: Philox in registers from
// the swarms' seed words) and the replay step (replay = 1: reads u).
#include <cuda_runtime.h>

#include "scan_step.cuh"

extern "C" int ikpso_scan_step(int topo, int collider, int orient, int n_obs,
                               float node_half, float link_half, float node_r2,
                               float link_r2, IKPSO_STEP_PARAMS) {
  using namespace ikpso;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The orientation term is instantiated for Arm6Dof without a scene only.
  if (n_obs < 0 || (orient && (topo != 2 || collider != kNoCollider))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scene scene{n_obs, node_half, link_half, node_r2, link_r2};
  cudaError_t rc = cudaErrorInvalidValue;
#define IKPSO_LAUNCH(TOPO, C, O)                                                         \
  rc = launch_scan_step(StepTreeWalk<TOPO, C, O>{scene}, TOPO::D, meta, swarm, K,       \
                        IKPSO_STEP_STATE(TOPO::D), IKPSO_STEP_UPDATE, replay != 0, S, P, \
                        st)
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
  }
#undef IKPSO_LAUNCH
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ikpso_scan_step_serial(int n_nodes, IKPSO_STEP_PARAMS) {
  using namespace ikpso;
  if (n_nodes < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int D = 3 * (n_nodes - 1);
  const cudaError_t rc =
      launch_scan_step(StepSerialWalk{n_nodes}, D, meta, swarm, K, IKPSO_STEP_STATE(D),
                       IKPSO_STEP_UPDATE, replay != 0, S, P,
                       static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
