// planner_rollout: N = B·R lanes of the planner model through H knots of S
// substeps in one launch, on a Hopper card (sm_90a). The closed loop's
// executor (closed_loop.py execute_knot: H = 1, S = 10 on the 1 kHz model)
// launches it once a knot; its plain PyTorch version is solver/rollout.py
// planner_rollout_plain. Its cost instantiation, planner_rollout_cost (the
// same lanes, each also summing its task cost: task_cost.cuh), is every
// rollout of the MPPI solver (solver/mppi.py through solver/mpc.py
// MPCProblem.cost_rollout); its plain version is rollout_cost_plain.
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
// operations.
//
// Design. Four threads a lane, one per leg (the Go1 is a star; env_step.cu's
// design), the legs' shares of the base's Schur system summed with
// __shfl_xor_sync in the fixed order (v0 + v1) + (v2 + v3), so a lane's
// result does not depend on the batch; no value crosses lanes. The state
// stays in registers across every knot and substep; after each knot thread
// 0 writes the base and every thread its leg's q and qd. The model (a
// LegModel a leg: 89 floats of inertias, geometry, gains, springs and
// friction) is not: a block of 128 threads (32 lanes) first stages the
// models of the scenario rows its lanes read in shared memory, each thread
// one leg of one row (one row at R = 32 or 64 and at stride 0, up to 32 at
// R = 1, 45,568 bytes; a problem of R = 64 spans two blocks and each stages
// its copy), then the lanes read every constant there at its use. That frees
// the registers that held the model: with __launch_bounds__(128, 4) the
// kernel fits in 128 registers without a spill, 16 warps an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) where the model in
// registers took 255 and allowed 8. An odd LegModel stride puts the four
// legs' copies of a member in four banks (32 at R = 1). Tensor cores
// (wgmma, TF32) do not apply: the products are 3x3 and 6x6 per lane in
// float32, and a problem's answer must stay bitwise independent of its
// batch; nor does TMA: a block reads 1.5 KB of commands a knot.
//
// The compiler contracts a multiply and an add into one FMA where both sit
// in the loop; a kernel holding the model in registers hoists the products
// of model constants out of its loop, where they stay rounded on their own.
// go1_dynamics.cuh rounds those products with mul_rn (the hip body and
// column), so this kernel computes bitwise what the model-in-registers
// kernel computed, at every knot of every lane.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (tests/torch_rollout_design_probe.py; PERF.md): the headline 2.16 -> 1.65
// ms, the full-rate row (x 25 knots x 10 substeps) 4.77 -> 3.87 ms, the
// closed loop's executor (1 lane, 10 substeps) 40.8 -> 43.4 us. The staging
// alone (12 warps at 152 registers) gave 1.93 ms; loading the next knot's
// commands during the knot gave nothing at 16 warps (1.72 ms, spilling).
// The substep loop's common path is ~2,570 SASS instructions a thread, and
// the kernel fills 61% of the SMs' issue slots with them: the rest of
// the gap to the bound is the instruction count (IEEE divisions and square
// roots, trigonometry, the base's work done by all four threads), not the
// occupancy.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "planner_lane.cuh"

namespace {

// the blocks an SM must hold (__launch_bounds__): 4 of 128 threads cap a
// thread's registers at 65,536 / 512 = 128
constexpr int kMinBlocks = 4;

// the staged models of a block: at most a row per lane, 4 legs each (at 128
// threads 45,568 bytes), under the 48 KB a launch gets without
// cudaFuncSetAttribute
constexpr size_t kMaxStagedBytes = qs::kRolloutLanes * 4 * sizeof(qs::LegModel);
static_assert(kMaxStagedBytes <= 48 * 1024, "the staged models need an opt-in");

size_t staged_bytes(int repeats, int64_t scenario_stride) {
  return qs::max_block_rows(repeats, scenario_stride) * 4 * sizeof(qs::LegModel);
}

__global__ void __launch_bounds__(qs::kRolloutThreads, kMinBlocks)
planner_rollout_kernel(const __grid_constant__ qs::EnvConsts consts,
                       const __grid_constant__ qs::RolloutArgs args) {
  extern __shared__ qs::LegModel models[];
  const qs::BlockRows rows = qs::block_rows(args, blockIdx.x);
  qs::stage_leg_model(consts, args, rows, threadIdx.x, models);
  __syncthreads();
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * qs::kRolloutLanes + (threadIdx.x >> 2);
  if (lane >= args.n_problems * args.repeats) return;   // whole groups of four
  const int leg = static_cast<int>(threadIdx.x & 3);
  qs::QuadShfl quad{0xFu << (threadIdx.x & 28u)};
  qs::planner_lane(consts, args, qs::lane_model(args, rows, models, lane, leg), lane, leg,
                   quad);
}

// The cost instantiation: the same lanes, each also summing its task cost
// (planner_lane_run<true>); its block keeps the stage costs of its 32 lanes
// after the staged models, (H, 32) floats.
__global__ void __launch_bounds__(qs::kRolloutThreads, kMinBlocks)
planner_rollout_cost_kernel(const __grid_constant__ qs::EnvConsts consts,
                            const __grid_constant__ qs::RolloutArgs args,
                            const __grid_constant__ qs::CostArgs cost, int staged_floats) {
  extern __shared__ float cost_smem[];
  qs::LegModel* models = reinterpret_cast<qs::LegModel*>(cost_smem);
  const qs::BlockRows rows = qs::block_rows(args, blockIdx.x);
  qs::stage_leg_model(consts, args, rows, threadIdx.x, models);
  __syncthreads();
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * qs::kRolloutLanes + (threadIdx.x >> 2);
  if (lane >= args.n_problems * args.repeats) return;   // whole groups of four
  const int leg = static_cast<int>(threadIdx.x & 3);
  qs::QuadShfl quad{0xFu << (threadIdx.x & 28u)};
  qs::planner_lane_run<true>(consts, args, &cost, qs::lane_model(args, rows, models, lane, leg),
                             lane, leg, quad, cost_smem + staged_floats + (threadIdx.x >> 2));
}

size_t cost_smem_bytes(int repeats, int64_t scenario_stride, int horizon) {
  return staged_bytes(repeats, scenario_stride) + qs::stage_cost_bytes(horizon);
}

}  // namespace

extern "C" int planner_rollout_cost(QS_PLANNER_ROLLOUT_COST_PARAMS) {
  if (n_consts != qs::kConstsFloats) return static_cast<int>(cudaErrorInvalidValue);
  qs::EnvConsts c;
  memcpy(&c, consts, sizeof(c));
  qs::RolloutArgs args = QS_ROLLOUT_ARGS_FROM_PARAMS;
  qs::CostArgs cost{us, costs, family, action_dim, {}};
  memcpy(cost.w, weights, sizeof(cost.w));
  const size_t smem = cost_smem_bytes(repeats, scenario_stride, horizon);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(planner_rollout_cost_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int64_t lanes = n_problems * repeats;
  unsigned int blocks = static_cast<unsigned int>((lanes + qs::kRolloutLanes - 1) /
                                                  qs::kRolloutLanes);
  const int staged_floats = static_cast<int>(staged_bytes(repeats, scenario_stride) / 4);
  planner_rollout_cost_kernel<<<blocks, qs::kRolloutThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(c, args, cost,
                                                                     staged_floats);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int planner_rollout(QS_PLANNER_ROLLOUT_PARAMS) {
  if (n_consts != qs::kConstsFloats) return static_cast<int>(cudaErrorInvalidValue);
  qs::EnvConsts c;
  memcpy(&c, consts, sizeof(c));
  qs::RolloutArgs args = QS_ROLLOUT_ARGS_FROM_PARAMS;
  int64_t lanes = n_problems * repeats;
  unsigned int blocks = static_cast<unsigned int>((lanes + qs::kRolloutLanes - 1) /
                                                  qs::kRolloutLanes);
  planner_rollout_kernel<<<blocks, qs::kRolloutThreads, staged_bytes(repeats, scenario_stride),
                           static_cast<cudaStream_t>(stream)>>>(c, args);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the kernel for R candidates a problem (stride 1, or
// 0: one row for all): out[0] its blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] threads a block,
// out[2] registers a thread, out[3] local memory bytes a thread
// (cudaFuncGetAttributes), out[4] dynamic shared memory bytes a block.
extern "C" int planner_rollout_occupancy(int repeats, int64_t scenario_stride, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, planner_rollout_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = staged_bytes(repeats, scenario_stride);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, planner_rollout_kernel,
                                                      qs::kRolloutThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = qs::kRolloutThreads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = static_cast<int>(smem);
  return 0;
}

// The same of the cost instantiation at horizon H, its shared memory the
// staged models and the (H, 32) stage costs.
extern "C" int planner_rollout_cost_occupancy(int repeats, int64_t scenario_stride,
                                              int horizon, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, planner_rollout_cost_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = cost_smem_bytes(repeats, scenario_stride, horizon);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(planner_rollout_cost_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, planner_rollout_cost_kernel,
                                                      qs::kRolloutThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = qs::kRolloutThreads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = static_cast<int>(smem);
  return 0;
}
