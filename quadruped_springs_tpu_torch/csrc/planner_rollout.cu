// planner_rollout: N = B·R lanes of the planner model through H knots of S
// substeps in one launch, on a Hopper card (sm_90a). Every rollout of the
// MPPI solver (solver/mppi.py through solver/mpc.py MPCProblem.lane_rollout)
// and the closed loop's executor (closed_loop.py execute_knot: H = 1, S = 10
// on the 1 kHz model) launch it once; its plain PyTorch version is
// solver/rollout.py planner_rollout_plain.
//
// Replaces, on the planner's rollouts, what the port launched per substep:
// the kernels `actuation` (scripts/pallas_microbench.py:_actuation_kernel,
// the pl.pallas_call at :96) and `contact` (:_contact_kernel, pl.pallas_call
// at :153), and the ~950 PyTorch launches of the dynamics around them per
// knot. On the TPU the JAX package runs the rollout as one jit program: a
// lax.scan of MPCProblem.dynamics (quadruped_springs_tpu/solver/mpc.py:
// 160-201) inside mppi.solve (quadruped_springs_tpu/solver/mppi.py:141-193),
// into which XLA fuses the scalarized dynamics with both kernels' math.
//
// Bound on the H100: a launch reads each problem's start (37 floats) and
// model row (169, or one row for all), each lane's commands (12 per knot) and
// writes its H + 1 states (37 floats each): at the MPPI headline (32,768
// lanes, H = 50) ~79 MB of commands and ~247 MB of states, ~0.10 ms of
// memory time. A substep is ~10,000 float operations a lane, 3.3e10 at the
// headline's 2 substeps a knot, ~0.49 ms at 67 TFLOP/s: the bound is
// operations. The design is env_substeps's (env_step.cu): four threads a
// lane, one per leg (the Go1 is a star), the legs' shares of the base's
// Schur system summed with __shfl_xor_sync in the fixed order
// (v0 + v1) + (v2 + v3), so a lane's result does not depend on the batch;
// no value crosses lanes. The state stays in registers across every knot and
// substep; after each knot thread 0 writes the base and every thread its
// leg's q and qd.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "planner_lane.cuh"

namespace {

constexpr int kThreads = 128;   // 32 lanes a block

__global__ void __launch_bounds__(kThreads)
planner_rollout_kernel(const __grid_constant__ qs::EnvConsts consts,
                       const __grid_constant__ qs::RolloutArgs args) {
  int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t lane = tid >> 2;
  if (lane >= args.n_problems * args.repeats) return;   // whole groups of four
  qs::QuadShfl quad{0xFu << (threadIdx.x & 28u)};
  qs::planner_lane(consts, args, lane, static_cast<int>(tid & 3), quad);
}

}  // namespace

extern "C" int planner_rollout(QS_PLANNER_ROLLOUT_PARAMS) {
  if (n_consts != qs::kConstsFloats) return static_cast<int>(cudaErrorInvalidValue);
  qs::EnvConsts c;
  memcpy(&c, consts, sizeof(c));
  qs::RolloutArgs args = QS_ROLLOUT_ARGS_FROM_PARAMS;
  int64_t threads = 4 * n_problems * repeats;
  unsigned int blocks = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  planner_rollout_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(c, args);
  return static_cast<int>(cudaGetLastError());
}
