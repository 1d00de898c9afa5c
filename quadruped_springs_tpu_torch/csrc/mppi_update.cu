// mppi_update: one MPPI update of B problems and the rows of their next
// rollout in one launch, on a Hopper card (sm_90a). solver/mppi.py's solve
// launches it once before its first rollout and once after each (the fused
// accept: 1 + iterations a solve; the plain branch: twice an iteration and
// twice more); its plain PyTorch version is solver/mppi_update.py
// mppi_update_plain.
//
// Replaces what the port ran in PyTorch around each rollout: the low-pass of
// the noise (a Python loop over the H knots), the candidates and their joint
// targets, the elite weights, the weighted mean and the best tracking (~340
// launches an iteration at the headline). On the TPU the JAX package runs
// them inside one XLA computation with the rollouts: the body of
// jax.lax.scan(iteration_fused, ...) in quadruped_springs_tpu/solver/
// mppi.py:141-183 (the low-pass :150-160, the weights and mean :164-175).
//
// Bound on the H100 at the headline (B = 1,024, K = 32, H = 50, m = 6): the
// candidates read (39 MB), the draws read (39 MB), the next candidates (39
// MB) and their joint targets (79 MB) written, 60.20 µs at 3.35 TB/s: the
// bytes. What the design does about them (mppi_update.cuh):
// - every problem in flight at once: a block of 128 threads a problem,
//   __launch_bounds__(128, 8) (at most 64 registers a thread) and ~25 KB of
//   shared memory at the headline, so an SM holds 8 problems and the 132 SMs
//   1,056; where a problem has half an SM or more (the behaviours, the
//   loops, the comparison: B <= 264), 512 threads and all of its rows in one
//   or two chunks, since there a problem's latency is the launch's;
// - the candidates and the draws read once, in 16-byte cp.async pieces into
//   a ring of slots, one or two chunks in flight behind the one in use, the
//   draws' first from the start;
// - the rows and their joint targets written from the slot they were made
//   in: coalesced 16-byte stores, no re-read of the rows;
// - a problem's scalars (argmin, rank count, weights, sum_fixed) on warp 0
//   with shuffles; the weighted mean summed in sum_fixed's order as the
//   chunks arrive, its partial sums in shared memory;
// - no tensor cores: a problem's weighted mean is a (1 x K) by (K x H·m)
//   product that must keep sum_fixed's order, and the low-pass stays a
//   sequential chain along H per (row, action), as the plain version's.
// K = 32 and 64 are compile-time (mppi_update_kernel<32, ...>, <64, ...>);
// any other K runs mppi_update_kernel<0, ...>, which keeps each element's K
// products in a shared column.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (tests/
// torch_update_design_probe.py, card time alone, this design against the
// parent's in one call): 92.02 µs at the headline (the first design, one
// block of 256 threads a problem with 528 problems in flight and targets
// re-read from device memory: 201.61), 54.18 µs at full rate (108.54),
// 22.81 µs at one problem x 64 x 30 (42.06), 14.44 µs at 8 x 64 x 50
// (20.52). Its parts at the headline (torch_mppi_iteration_probe.py
// --update-parts): the proposal 26.9 µs, the candidates without targets
// 45.9, with them 71.4, the whole launch 91.4 (the draws' first chunk
// overlaps the proposal); the targets' 79 MB take ~26 µs, near the rate.
// Steps that did not pay: the division by norm in the low-pass's threads
// (93.74 against 92.02 µs), a fourth slot in the ring (112.43: fewer
// blocks an SM), 4 blocks an SM (100.16).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mppi_update.cuh"

namespace {

template <int KC, int T, int MIN_BLOCKS>
__global__ void __launch_bounds__(T, MIN_BLOCKS)
mppi_update_kernel(const __grid_constant__ qs::UpdateArgs args) {
  extern __shared__ __align__(16) float update_smem[];
  __shared__ qs::UpdateShared sh;
  __shared__ qs::JointTable jt;
  qs::DeviceBlock blk;
  qs::update_problem<KC>(blk, args, blockIdx.x, update_smem, sh, jt);
}

// the card's SMs, read once
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

using Kernel = void (*)(qs::UpdateArgs);

// the instantiation for K candidates and the launch's threads a block
template <int KC>
Kernel kernel_for(int threads) {
  return threads == qs::kUpdateWideThreads
             ? mppi_update_kernel<KC, qs::kUpdateWideThreads, qs::kUpdateWideBlocks>
             : mppi_update_kernel<KC, qs::kUpdateThreads, qs::kUpdateMinBlocks>;
}

Kernel kernel_for(int samples, int threads) {
  switch (samples) {
    case 32: return kernel_for<32>(threads);
    case 64: return kernel_for<64>(threads);
    default: return kernel_for<0>(threads);
  }
}

// the kernel of a launch, its shared memory allowed and preferred over L1
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" int mppi_update(QS_MPPI_UPDATE_PARAMS) {
  qs::UpdateArgs args = qs::update_args(
      costs, cand, cost_new, draw, sigma, norm, lower, upper, us, us_alt, cost, trace, rows,
      q_des, n_problems, samples, horizon, actions, n_elite, trace_col, iterations, out_rows,
      fused, smooth, rcp_temperature, u_min, u_max, lp_a, lp_b, joint_src, joint_sign,
      stream);
  const qs::UpdateShape shape =
      qs::update_shape(samples, horizon, actions, n_problems, sm_count());
  args.threads = shape.threads;
  args.group = shape.group;
  const size_t smem =
      qs::update_smem_bytes(samples, horizon, actions, shape.threads, shape.group);
  const Kernel kernel = kernel_for(samples, shape.threads);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_problems == 0) return 0;
  kernel<<<static_cast<unsigned int>(n_problems), shape.threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// out (6 ints): of the launch for K = samples at horizon H, m actions and B
// problems: its blocks an SM, threads a block, registers and local bytes a
// thread, shared bytes a block (dynamic and static), groups a slot
extern "C" int mppi_update_occupancy(int samples, int horizon, int actions,
                                     int64_t n_problems, int* out) {
  const qs::UpdateShape shape =
      qs::update_shape(samples, horizon, actions, n_problems, sm_count());
  const size_t smem =
      qs::update_smem_bytes(samples, horizon, actions, shape.threads, shape.group);
  const Kernel kernel = kernel_for(samples, shape.threads);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = prepare(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, shape.threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = shape.threads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = static_cast<int>(smem + attr.sharedSizeBytes);
  out[5] = shape.group;
  return 0;
}
