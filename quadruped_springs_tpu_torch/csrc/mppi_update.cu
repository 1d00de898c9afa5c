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
// Design (mppi_update.cuh): one block of 256 threads a problem, so a
// problem's result does not depend on its batch. The K costs, weights and
// (K, 256) columns of the weighted mean sit in shared memory; each thread
// sums its own column in sum_fixed's order, so no barrier splits the sum.
// The candidates stream along H, one thread per (row, action), the
// low-pass's state in a register; their joint targets follow, one thread a
// target, so that their stores (twice the candidates' bytes) coalesce.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tests/
// torch_mppi_iteration_probe.py --update-parts): the headline's iteration
// launch, through the wrapper, 0.69 ms with 128 threads and each stream
// scanning the 12 joints for its targets, 0.37 ms with a joint mask a
// stream, 0.30-0.33 ms with the targets one thread each (one launch
// between CUDA events); back to back, 0.24 ms so, of which the candidates
// without targets 0.10 ms, 0.07 with each stream loading 10 knots ahead of
// its stores (kLoadAhead; the same for the targets made them slower:
// 0.12 -> 0.18 ms). The bound is ~0.06 ms. No tensor cores: a problem's weighted
// mean is a (1 x K) by (K x H·m) product that must keep sum_fixed's order.
//
// Bound on the H100 at the headline (B = 1,024, K = 32, H = 50, m = 6):
// the candidates read (39 MB), the draws read (39 MB), the next candidates
// (39 MB) and their joint targets (79 MB) written, ~0.06 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mppi_update.cuh"

namespace {

__global__ void __launch_bounds__(qs::kUpdateThreads)
mppi_update_kernel(const __grid_constant__ qs::UpdateArgs args) {
  extern __shared__ float update_smem[];
  __shared__ qs::UpdateShared sh;
  const int64_t b = blockIdx.x;
  const int tid = static_cast<int>(threadIdx.x);
  float* c = update_smem;
  float* w = c + args.samples;
  float* cols = w + args.samples;
  if (args.costs != nullptr) {
    qs::update_load_costs(args, b, tid, c);
    __syncthreads();
    qs::update_rank(args, tid, c, sh);
    __syncthreads();
    qs::update_weights(args, tid, c, w, sh);
    __syncthreads();
    qs::update_total(args, b, tid, c, w, cols, sh);
    __syncthreads();
    qs::update_normalise(args, tid, w, sh);
    __syncthreads();
    qs::update_propose(args, b, tid, w, cols, sh);
    __syncthreads();
  }
  if (args.cost_new != nullptr) {
    qs::update_accept(args, b, tid, sh);
    __syncthreads();
    qs::update_take(args, b, tid, sh);
    __syncthreads();
  }
  qs::update_rows(args, b, tid);
  if (args.q_des != nullptr) {
    __syncthreads();
    qs::update_commands(args, b, tid);
  }
}

}  // namespace

extern "C" int mppi_update(QS_MPPI_UPDATE_PARAMS) {
  const qs::UpdateArgs args = qs::update_args(
      costs, cand, cost_new, draw, sigma, norm, lower, upper, us, us_alt, cost, trace, rows,
      q_des, n_problems, samples, horizon, actions, n_elite, trace_col, iterations, out_rows,
      fused, smooth, rcp_temperature, u_min, u_max, lp_a, lp_b, joint_src, joint_sign,
      stream);
  const size_t smem = qs::update_smem_floats(samples) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mppi_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_problems == 0) return 0;
  mppi_update_kernel<<<static_cast<unsigned int>(n_problems), qs::kUpdateThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
