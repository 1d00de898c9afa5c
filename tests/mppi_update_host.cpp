// The mppi_update kernel's body (quadruped_springs_tpu_torch/csrc/
// mppi_update.cuh) built for the CPU with a host C++ compiler, so that a CPU
// test can hold its arithmetic against the plain PyTorch version where no
// card is present. Each block (problem) runs its phases in the kernel's
// order, each phase for every thread index in turn, which is what the
// kernel's barriers between them guarantee. The entry point takes the
// kernel launcher's arguments (host pointers; the stream is ignored). Build
// (tests/test_torch_mppi_update.py does):
//   g++ -std=c++20 -O2 -shared -fPIC -o libmppi_update_host.so
//       tests/mppi_update_host.cpp   (one command)

#include <vector>

#include "../quadruped_springs_tpu_torch/csrc/mppi_update.cuh"

extern "C" int mppi_update_host(QS_MPPI_UPDATE_PARAMS) {
  const qs::UpdateArgs a = qs::update_args(
      costs, cand, cost_new, draw, sigma, norm, lower, upper, us, us_alt, cost, trace, rows,
      q_des, n_problems, samples, horizon, actions, n_elite, trace_col, iterations, out_rows,
      fused, smooth, rcp_temperature, u_min, u_max, lp_a, lp_b, joint_src, joint_sign, stream);
  std::vector<float> smem(qs::update_smem_floats(samples));
  float* c = smem.data();
  float* w = c + samples;
  float* cols = w + samples;
  const int T = qs::kUpdateThreads;
  for (int64_t b = 0; b < n_problems; ++b) {
    qs::UpdateShared sh{};
    if (costs != nullptr) {
      for (int t = 0; t < T; ++t) qs::update_load_costs(a, b, t, c);
      for (int t = 0; t < T; ++t) qs::update_rank(a, t, c, sh);
      for (int t = 0; t < T; ++t) qs::update_weights(a, t, c, w, sh);
      for (int t = 0; t < T; ++t) qs::update_total(a, b, t, c, w, cols, sh);
      for (int t = 0; t < T; ++t) qs::update_normalise(a, t, w, sh);
      for (int t = 0; t < T; ++t) qs::update_propose(a, b, t, w, cols, sh);
    }
    if (cost_new != nullptr) {
      for (int t = 0; t < T; ++t) qs::update_accept(a, b, t, sh);
      for (int t = 0; t < T; ++t) qs::update_take(a, b, t, sh);
    }
    for (int t = 0; t < T; ++t) qs::update_rows(a, b, t);
    if (q_des != nullptr)
      for (int t = 0; t < T; ++t) qs::update_commands(a, b, t);
  }
  return 0;
}
