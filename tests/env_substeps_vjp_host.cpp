// The env_substeps_vjp kernel's body (quadruped_springs_tpu_torch/csrc/
// env_lane_vjp.cuh) built for the CPU with a host C++ compiler, as
// tests/env_substeps_host.cpp builds the forward's: each environment runs as
// four host threads, one per leg, whose sums over the four are a barrier and
// the kernel's fixed order (v0 + v1) + (v2 + v3). The entry point takes the
// kernel launcher's arguments (host pointers; the stream is ignored). Build
// (tests/test_torch_env_vjp.py does):
//   g++ -std=c++20 -O2 -shared -fPIC -pthread -o libenv_substeps_vjp_host.so
//       tests/env_substeps_vjp_host.cpp   (one command)

#include <barrier>
#include <string.h>
#include <thread>
#include <vector>

#include "../quadruped_springs_tpu_torch/csrc/env_lane_vjp.cuh"

namespace {

struct HostQuad {
  std::barrier<>* bar;
  float (*slots)[32];
  int leg;

  template <int N>
  void sum(float (&v)[N]) {
    static_assert(N <= 32, "one slot row holds 32 floats");
    for (int i = 0; i < N; ++i) slots[leg][i] = v[i];
    bar->arrive_and_wait();
    for (int i = 0; i < N; ++i)
      v[i] = (slots[0][i] + slots[1][i]) + (slots[2][i] + slots[3][i]);
    bar->arrive_and_wait();
  }
};

}  // namespace

extern "C" int env_substeps_vjp_host(QS_ENV_SUBSTEPS_ARGS, QS_ENV_VJP_PARAMS, void* stream) {
  (void)stream;
  if (n_consts != qs::kConstsFloats) return 1;
  qs::EnvConsts c;
  memcpy(&c, consts, sizeof(c));
  const qs::EnvArgs args = QS_ENV_ARGS_FROM_PARAMS;
  const qs::EnvVjpArgs vargs = QS_ENV_VJP_ARGS_FROM_PARAMS;
  for (int64_t env = 0; env < n; ++env) {
    std::barrier<> bar(4);
    float slots[4][32];
    std::vector<std::thread> legs;
    for (int leg = 0; leg < 4; ++leg)
      legs.emplace_back([&, leg] {
        HostQuad quad{&bar, slots, leg};
        qs::env_lane_vjp(c, args, vargs, env, leg, quad);
      });
    for (auto& t : legs) t.join();
  }
  return 0;
}
