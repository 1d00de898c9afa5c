// The planner_rollout kernel's body (quadruped_springs_tpu_torch/csrc/
// planner_lane.cuh) built for the CPU with a host C++ compiler, so that a CPU
// test can hold its arithmetic against the plain PyTorch version where no
// card is present. Each lane runs as four host threads, one per leg, as the
// kernel runs it as four lanes of a warp; their sum over the four is a
// barrier and the kernel's fixed order (v0 + v1) + (v2 + v3). The entry
// point takes the kernel launcher's arguments (host pointers; the stream is
// ignored). Build (tests/test_torch_planner_rollout.py does):
//   g++ -std=c++20 -O2 -shared -fPIC -pthread -o libplanner_rollout_host.so
//       tests/planner_rollout_host.cpp   (one command)

#include <barrier>
#include <string.h>
#include <thread>
#include <vector>

#include "../quadruped_springs_tpu_torch/csrc/planner_lane.cuh"

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

extern "C" int planner_rollout_host(QS_PLANNER_ROLLOUT_PARAMS) {
  (void)stream;
  if (n_consts != qs::kConstsFloats) return 1;
  qs::EnvConsts c;
  memcpy(&c, consts, sizeof(c));
  const qs::RolloutArgs args = QS_ROLLOUT_ARGS_FROM_PARAMS;
  for (int64_t lane = 0; lane < n_problems * repeats; ++lane) {
    std::barrier<> bar(4);
    float slots[4][32];
    std::vector<std::thread> legs;
    for (int leg = 0; leg < 4; ++leg)
      legs.emplace_back([&, leg] {
        HostQuad quad{&bar, slots, leg};
        qs::planner_lane(c, args, lane, leg, quad);
      });
    for (auto& t : legs) t.join();
  }
  return 0;
}
