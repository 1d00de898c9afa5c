// env_substeps: N environments through R substeps of the 1 kHz physics in
// one launch, on a Hopper card (sm_90a). Every environment path of the port
// (QuadrupedEnv.step in every motor mode, reset's settle,
// control/utils.settle_robot_by_pd) launches it once per control step or
// settle; its plain PyTorch version is env/substeps.py env_substeps_plain.
//
// Replaces, on the environment's path, what the port launched per substep:
// the kernels `actuation` (scripts/pallas_microbench.py:_actuation_kernel,
// the pl.pallas_call at :96) and `contact_anchored` (the anchored variant of
// :_contact_kernel, pl.pallas_call at :153, that XLA fused into the TPU's
// dynamics: quadruped_springs_tpu/models/dynamics.py:357-376), and the ~500
// PyTorch launches of the dynamics around them. On the TPU the JAX package
// runs the same loop as one jit program, a lax.scan over the substeps into
// which XLA fuses the scalarized dynamics
// (quadruped_springs_tpu/env/env.py:306-354).
//
// Bound on the H100: a launch reads each environment's state (37 floats),
// anchors (8), springs and friction (7), model (169 floats of the five
// scenario fields of Go1Model, read where they lie) and commands (12 per
// substep, or 12 held) and writes 84 floats and 5 flags, ~1.3-1.7 kB an
// environment: at 1,024 environments x 10 substeps ~1.8 MB, ~0.5 µs of
// memory time. A substep is ~10,000 float operations an environment (~2,350
// per leg, ~650 for the base), 100 M at 1,024 x 10, ~1.5 µs at 67 TFLOP/s:
// the bound is operations, and it is far below one launch slot.
//
// Design. The work is a serial chain of R substeps per environment, so the
// kernel runs 4 threads an environment (the Go1 is a star: one thread per
// leg) and is latency-bound: one warp's dependent chain sets its time at
// every width the paths launch (1 to 1,024 environments), at ~3 cycles an
// instruction. State, anchors and the thread's model stay in registers
// across the R substeps (255 registers, no spill; staging the model in
// shared memory, as planner_rollout does, measured slower here); the legs'
// shares of the base's Schur system are summed with __shfl_xor_sync inside
// each group of four lanes, in a fixed order that no other environment can
// change. Blocks of 32 threads (8 environments) spread 1,024 environments
// over 128 SMs, one warp each, where blocks of 128 put four on each of 32.
// The chain is shortened where it waited on slow-path branches: sincosf for
// each sinf / cosf pair (bitwise the same over all 2^32 inputs), and the
// contact sites' roots and quotients through CheckedOps (elems.cuh), the
// correctly rounded values without the branch, the sites recomputed with
// the operators where a check fails. So every output is bitwise what the
// kernel computed with sinf, cosf, sqrtf and `/` as written.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (tests/torch_env_design_probe.py; PERF.md): 1,024 x 10 substeps 56.9 ->
// 46.6 µs, 64 x 10 54.3 -> 43.0 µs, 1 x 10 46.5 -> 38.2 µs, the oracle
// replay's 1 x 2,500 settle 9.76 -> 8.49 ms. The 6x6 solve's and the
// quaternion's roots and quotients through CheckedOps, the commands loaded a
// substep ahead and the shares summed through shared memory measured slower
// or no faster, and are not used.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "env_lane.cuh"

namespace {

constexpr int kThreads = 32;   // 8 environments a block

__global__ void __launch_bounds__(kThreads)
env_substeps_kernel(const __grid_constant__ qs::EnvConsts consts,
                    const __grid_constant__ qs::EnvArgs args) {
  int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t env = tid >> 2;
  if (env >= args.n) return;   // whole groups of four: their shuffles stay complete
  qs::QuadShfl quad{0xFu << (threadIdx.x & 28u)};
  qs::env_lane(consts, args, env, static_cast<int>(tid & 3), quad);
}

}  // namespace

extern "C" int env_substeps(QS_ENV_SUBSTEPS_PARAMS) {
  if (n_consts != qs::kConstsFloats) return static_cast<int>(cudaErrorInvalidValue);
  qs::EnvConsts c;
  memcpy(&c, consts, sizeof(c));
  qs::EnvArgs args = QS_ENV_ARGS_FROM_PARAMS;
  int64_t threads = 4 * n;
  unsigned int blocks = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  env_substeps_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(c, args);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the kernel: out[0] its blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] threads a block,
// out[2] registers a thread, out[3] local memory bytes a thread, out[4]
// shared memory bytes a block (cudaFuncGetAttributes).
extern "C" int env_substeps_occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, env_substeps_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, env_substeps_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
