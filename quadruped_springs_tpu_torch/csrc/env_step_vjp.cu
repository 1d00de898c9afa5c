// env_substeps_vjp: the reverse mode of env_substeps (env_step.cu) on a
// Hopper card (sm_90a). From the inputs of a control step of R substeps and
// the cotangents of its float outputs (the state, the anchors, the last
// substep's torques and foot forces, the summed motor torque) it gives the
// cotangents of the state, the anchors and the commands, in one launch. The
// backward of env/substeps.py _EnvSubsteps launches it once per control
// step; its plain PyTorch version is autograd through env_substeps_plain
// (env/substeps.py env_substeps_vjp_plain).
//
// Replaces, on the port's path, the reverse mode that XLA derives on the
// TPU for the JAX package's control step (quadruped_springs_tpu/env/env.py
// :306-354, a lax.scan of the anchored dyn.step that XLA fuses; PERF.md row
// 3), which scripts/train_backflip_landing_mlp.py:387 reaches through
// jax.value_and_grad of the lander's shaped return (--optimizer bptt).
//
// Bound on the H100: a launch reads what the forward reads plus the
// cotangents (~75 floats an environment) and writes ~49 floats an
// environment and the scratch of R x 84 floats (written once and read
// once): ~5 kB an environment at R = 10, ~0.1 MB at BPTT's 24 environments.
// The function's operations are one forward of the R substeps and the
// adjoint: 35,040 float operations an environment a substep, the forward's
// 10,110 of them (tests/torch_env_opcount.py counts both bodies, the base's
// work once an environment though four threads do it). The kernel does more:
// it runs the forward a second time, in the sweep's recompute of each
// substep, and each thread the base's share. At 24 x 10 that is 8.4 M
// operations, 0.13 µs at 67 TFLOP/s: the bound is operations, and far below
// one launch.
//
// Design, simple and right first: the forward's layout (four threads an
// environment, one a leg, blocks of 8 environments), the R substeps re-run
// with the forward's lane_substep<true, true>, each substep's start kept in
// the scratch (global memory), then the sweep r = R-1 .. 0 (env_lane_vjp.cuh).
// Like the forward it is one warp's dependent chain, here about seven times
// as long: 0.33 ms on an NVIDIA H100 80GB HBM3 (700 W) at every width from
// 1 to 1,024 environments x 10 substeps, against the forward's 0.04-0.05 ms
// (PERF.md, row 3′). The adjoint's intermediates do not fit in 255 registers:
// ptxas keeps the rest in a 1,528-byte stack a thread (-Xptxas -v in
// kernels.build_log()), local memory that stays in L1 at the path's widths
// (one block an SM up to 1,056 environments). Holding the leg's kinematics,
// their cotangent, the Schur system's arrays and the 6x6 factor in shared
// memory instead cut the stack to 1,080 bytes but not to zero, and made the
// kernel slower (PERF.md, row 3′); the stack it keeps is gated in
// chip_smoke.py phase 2.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "env_lane_vjp.cuh"

namespace {

constexpr int kThreads = 32;   // 8 environments a block

__global__ void __launch_bounds__(kThreads)
env_substeps_vjp_kernel(const __grid_constant__ qs::EnvConsts consts,
                        const __grid_constant__ qs::EnvArgs args,
                        const __grid_constant__ qs::EnvVjpArgs vargs) {
  int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t env = tid >> 2;
  if (env >= args.n) return;   // whole groups of four: their shuffles stay complete
  qs::QuadShfl quad{0xFu << (threadIdx.x & 28u)};
  qs::env_lane_vjp(consts, args, vargs, env, static_cast<int>(tid & 3), quad);
}

}  // namespace

extern "C" int env_substeps_vjp(QS_ENV_SUBSTEPS_ARGS, QS_ENV_VJP_PARAMS, void* stream) {
  if (n_consts != qs::kConstsFloats) return static_cast<int>(cudaErrorInvalidValue);
  qs::EnvConsts c;
  memcpy(&c, consts, sizeof(c));
  qs::EnvArgs args = QS_ENV_ARGS_FROM_PARAMS;
  qs::EnvVjpArgs vargs = QS_ENV_VJP_ARGS_FROM_PARAMS;
  int64_t threads = 4 * n;
  unsigned int blocks = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  env_substeps_vjp_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, args, vargs);
  return static_cast<int>(cudaGetLastError());
}

// As env_substeps_occupancy (env_step.cu), of env_substeps_vjp's kernel.
extern "C" int env_substeps_vjp_occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, env_substeps_vjp_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, env_substeps_vjp_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
