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
// anchors (8), springs and friction (7), packed model (169) and commands
// (12 per substep, or 12 held) and writes 84 floats and 5 flags, ~1.3-1.7 kB
// an environment: at 1,024 environments x 10 substeps ~1.8 MB, ~0.5 µs of
// memory time. A substep is ~10,000 float operations an environment (~2,350
// per leg, ~650 for the base), 100 M at 1,024 x 10, ~1.5 µs at 67 TFLOP/s:
// the bound is operations, and it is far below one launch slot, so what the
// kernel buys is the launches it removes.
// The work is a serial chain of 10 substeps per environment, so the kernel
// runs 4 threads an environment (the Go1 is a star: one thread per leg),
// 4,096 threads at 1,024 environments, ~1 warp per SM: it is latency-bound,
// and instruction-level parallelism inside a thread matters more than
// occupancy. State, anchors and the lane's model stay in registers across
// the R substeps; the legs' shares of the base's Schur system are summed
// with __shfl_xor_sync inside each group of four lanes, in a fixed order
// that no other environment can change.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "env_lane.cuh"

namespace {

constexpr int kThreads = 128;   // 32 environments a block

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
