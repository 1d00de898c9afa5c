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
// adjoint: 34,152 float operations an environment a substep, the forward's
// 10,110 of them (tests/torch_env_opcount.py counts both bodies, the base's
// work once an environment, the recompute of each substep not). At 24 x 10
// that is 8.2 M operations, 0.12 µs at 67 TFLOP/s: the bound is operations,
// and far below one launch.
//
// Design. The first version of this kernel ran the forward's layout (four
// threads an environment, one a leg, one warp a block) and was one dependent
// chain: the re-run, then for each substep the recompute of its
// intermediates from its start and its adjoint, the base's work done alike
// by the four threads, and a 1,528-byte stack a thread for the adjoint's live
// set (0.31-0.33 ms on an NVIDIA H100 80GB HBM3 at 700 W at every width).
// This kernel (env_lane_vjp.cuh) gives a block of 8 environments eight
// warps, 256 threads, 32 of them an environment. The re-run stays on warp 0
// with the forward's lane_substep<true, true>; the substeps are recomputed a
// warp each, off the adjoint's chain, the last chunk's beside the re-run as
// each start is kept (named barriers), and what the adjoint reads (the 6x6
// factor and the quaternion's update too) is left in shared memory. The
// sweep's six stages a substep spread the adjoint over four warps: the
// base's work once an environment; the leg's bias force beside its Schur
// share and its contact sites, its additions replayed in their order; the
// kinematics a joint a warp. Each warp's live set is one stage's, so the
// stack is a fraction of the first version's (phase 2 of chip_smoke.py
// gates it). One block an SM: 1,024 environments are 128 blocks, one wave on
// 132 SMs; the block's shared memory (up to 227 KB) sets the chunk of
// substeps recomputed at once (vjp_chunk), which moves no value. The
// operations are the first version's in its order (built with -fmad=false
// the two give the same bits: tests/torch_vjp_design_probe.py); with
// multiply-adds contracted, nvcc's choices differ at the values now read
// from shared memory, in the last bits. Measured: PERF.md row 3′.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "env_lane_vjp.cuh"

namespace {

constexpr int kThreads = qs::kVjpThreads;   // 8 warps for 8 environments

// Blk of env_block_vjp (env_lane_vjp.cuh) on the block's threads
struct DevBlock {
  template <class F>
  __device__ __forceinline__ void each(F&& f) {
    f(static_cast<int>(threadIdx.x));
  }
  template <class F>
  __device__ __forceinline__ void quads(int warps, F&& f) {
    if (static_cast<int>(threadIdx.x) < 32 * warps) {
      qs::QuadShfl quad{0xFu << (threadIdx.x & 28u)};
      f(static_cast<int>(threadIdx.x), quad);
    }
  }
  __device__ __forceinline__ void sync() { __syncthreads(); }
  // named barrier `id` between warp 0 (arrive) and one other warp (wait),
  // each warp whole: warp 0's writes before arrive are seen after wait
  __device__ __forceinline__ void arrive(int id) {
    __syncwarp();
    __threadfence_block();
    asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
  }
  __device__ __forceinline__ void wait(int id) {
    __syncwarp();
    asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
  }
};

__global__ void __launch_bounds__(kThreads, 1)
env_substeps_vjp_kernel(const __grid_constant__ qs::EnvConsts consts,
                        const __grid_constant__ qs::EnvArgs args,
                        const __grid_constant__ qs::EnvVjpArgs vargs, int chunk) {
  extern __shared__ float4 smem[];
  DevBlock blk;
  qs::env_block_vjp(consts, args, vargs, chunk, static_cast<int64_t>(blockIdx.x), smem, blk);
}

// the shared memory a block may take (cudaDevAttrMaxSharedMemoryPerBlockOptin)
// and the chunk a launch of `substeps` recomputes at once; 0 where none fits
int launch_chunk(int substeps, size_t* bytes) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  const int chunk = qs::vjp_chunk(substeps, static_cast<size_t>(optin));
  *bytes = qs::vjp_shared_bytes(chunk);
  return chunk;
}

}  // namespace

extern "C" int env_substeps_vjp(QS_ENV_SUBSTEPS_ARGS, QS_ENV_VJP_PARAMS, void* stream) {
  if (n_consts != qs::kConstsFloats) return static_cast<int>(cudaErrorInvalidValue);
  qs::EnvConsts c;
  memcpy(&c, consts, sizeof(c));
  qs::EnvArgs args = QS_ENV_ARGS_FROM_PARAMS;
  qs::EnvVjpArgs vargs = QS_ENV_VJP_ARGS_FROM_PARAMS;
  size_t bytes = 0;
  const int chunk = launch_chunk(substeps, &bytes);
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      env_substeps_vjp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks =
      static_cast<unsigned int>((n + qs::kVjpEnvs - 1) / qs::kVjpEnvs);
  env_substeps_vjp_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      c, args, vargs, chunk);
  return static_cast<int>(cudaGetLastError());
}

// As env_substeps_occupancy (env_step.cu), of env_substeps_vjp's kernel at
// its largest launch (every control step of 6 or more substeps): out[4] the
// shared memory a block, out[5] the chunk of substeps recomputed at once.
extern "C" int env_substeps_vjp_occupancy(int* out) {
  size_t bytes = 0;
  const int chunk = launch_chunk(qs::kVjpWarps, &bytes);
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      env_substeps_vjp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, env_substeps_vjp_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, env_substeps_vjp_kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = static_cast<int>(attr.sharedSizeBytes + bytes);
  out[5] = chunk;
  return 0;
}
