// The planner_rollout kernel's body (quadruped_springs_tpu_torch/csrc/
// planner_lane.cuh) built for the CPU with a host C++ compiler, so that a CPU
// test can hold its arithmetic against the plain PyTorch version where no
// card is present. Each block of the kernel is emulated in turn: its 128
// threads stage the models of the rows its lanes read (stage_leg_model, into
// as many slots as the launch reserves: max_block_rows), then each of its
// lanes runs as four host threads, one per leg, as the kernel runs it as four
// lanes of a warp, on the staged model its lane_model picks; their sum over
// the four is a barrier and the kernel's fixed order (v0 + v1) + (v2 + v3).
// The entry point takes the kernel launcher's arguments (host pointers; the
// stream is ignored); it returns 2 if a block reads more rows than the
// launch reserves. planner_rollout_cost_host runs the cost instantiation
// (planner_lane_run<true>: each block's stage costs in a (H, 32) array).
// Build (tests/test_torch_planner_rollout.py does):
//   g++ -std=c++20 -O2 -shared -fPIC -pthread -o libplanner_rollout_host.so
//       tests/planner_rollout_host.cpp   (one command)

#include <algorithm>
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

  // QuadShfl::sum_fixed_legs: (v0 + v2) + (v1 + v3)
  template <int N>
  void sum_fixed_legs(float (&v)[N]) {
    static_assert(N <= 32, "one slot row holds 32 floats");
    for (int i = 0; i < N; ++i) slots[leg][i] = v[i];
    bar->arrive_and_wait();
    for (int i = 0; i < N; ++i)
      v[i] = (slots[0][i] + slots[2][i]) + (slots[1][i] + slots[3][i]);
    bar->arrive_and_wait();
  }
};

// The blocks of the kernel (kCost: planner_rollout_cost_kernel's, whose
// block keeps its lanes' stage costs, (H, 32) floats), one after another.
template <bool kCost>
int run_blocks(const qs::EnvConsts& c, const qs::RolloutArgs& args, const qs::CostArgs* cost) {
  const int64_t lanes = args.n_problems * args.repeats;
  std::vector<qs::LegModel> models(4 * qs::max_block_rows(args.repeats, args.scenario_stride));
  std::vector<float> stage(kCost ? static_cast<size_t>(args.horizon) * qs::kRolloutLanes : 0);
  for (int64_t block = 0; block * qs::kRolloutLanes < lanes; ++block) {
    const qs::BlockRows rows = qs::block_rows(args, block);
    if (4 * rows.count > static_cast<int>(models.size())) return 2;
    for (int t = 0; t < qs::kRolloutThreads; ++t)
      qs::stage_leg_model(c, args, rows, t, models.data());
    const int64_t end = std::min(lanes, (block + 1) * qs::kRolloutLanes);
    for (int64_t lane = block * qs::kRolloutLanes; lane < end; ++lane) {
      std::barrier<> bar(4);
      float slots[4][32];
      std::vector<std::thread> legs;
      float* column = kCost ? stage.data() + (lane - block * qs::kRolloutLanes) : nullptr;
      for (int leg = 0; leg < 4; ++leg)
        legs.emplace_back([&, leg] {
          HostQuad quad{&bar, slots, leg};
          qs::planner_lane_run<kCost>(c, args, cost,
                                      qs::lane_model(args, rows, models.data(), lane, leg),
                                      lane, leg, quad, column);
        });
      for (auto& t : legs) t.join();
    }
  }
  return 0;
}

}  // namespace

extern "C" int planner_rollout_host(QS_PLANNER_ROLLOUT_PARAMS) {
  (void)stream;
  if (n_consts != qs::kConstsFloats) return 1;
  qs::EnvConsts c;
  memcpy(&c, consts, sizeof(c));
  return run_blocks<false>(c, QS_ROLLOUT_ARGS_FROM_PARAMS, nullptr);
}

// The cost instantiation (planner_rollout_cost's arguments)
extern "C" int planner_rollout_cost_host(QS_PLANNER_ROLLOUT_COST_PARAMS) {
  (void)stream;
  if (n_consts != qs::kConstsFloats) return 1;
  qs::EnvConsts c;
  memcpy(&c, consts, sizeof(c));
  qs::CostArgs cost{us, costs, family, action_dim, {}};
  memcpy(cost.w, weights, sizeof(cost.w));
  return run_blocks<true>(c, QS_ROLLOUT_ARGS_FROM_PARAMS, &cost);
}
