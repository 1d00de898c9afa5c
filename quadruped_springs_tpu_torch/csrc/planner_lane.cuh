// One thread's share of the planner_rollout kernel (planner_rollout.cu): leg
// `leg` of lane `lane` (problem lane / R, candidate lane % R) through H knots
// of S planner substeps, the state written after each knot, and the block's
// staging of its problems' models. It does the work of the knot loop of
// quadruped_springs_tpu_torch/solver/mppi.py's rollout over solver/mpc.py
// MPCProblem.dynamics (per substep: PD + spring torque, dynamics.step with
// the memoryless contact law at all 12 sites), whose plain PyTorch version is
// solver/rollout.py planner_rollout_plain. The substep is env_lane.cuh's
// lane_substep with the feet's memoryless law; the state stays in registers
// across every knot and substep, the model is read from the block's staged
// copy (stage_leg_model) at each use. The cost instantiation
// (planner_lane<true>) also sums each lane's task cost as it goes
// (task_cost.cuh), and writes the states only where the caller asks.

#pragma once

#include <stdint.h>

#include "env_lane.cuh"
#include "task_cost.cuh"

namespace qs {

constexpr int kStateFloats = 37;   // solver/mpc.py state_to_vec

struct RolloutArgs {
  const float* x0;      // (B,37) one start per problem
  const float* q_des;   // (B,R,H,12) joint commands, one per knot
  // (12,) gains and limits; (3,) spring rest angles; (12,) engage signs
  const float *kp, *kd, *torque_limits, *velocity_limits, *rest, *sign;
  // one row per problem (scenario_stride 1) or one for all (0): (.,3) springs,
  // (.,) friction, (., kModelFloats) packed model
  const float *spring_k, *spring_b, *friction, *model;
  int64_t scenario_stride;
  float* xs;            // (B,R,H+1,37) out; row 0 is x0
  int64_t n_problems;
  int repeats, horizon, substeps, clamp_damping;
};

// The argument list of the extern "C" entry points (planner_rollout.cu's
// launcher and tests/planner_rollout_host.cpp): the consts as a host float
// array of sizeof(EnvConsts) / 4, then RolloutArgs's members in order, then
// the stream.
#define QS_PLANNER_ROLLOUT_HEAD                                                 \
  const float *consts, int n_consts, const float *x0, const float *q_des,      \
      const float *kp, const float *kd, const float *torque_limits,            \
      const float *velocity_limits, const float *rest, const float *sign,      \
      const float *spring_k, const float *spring_b, const float *friction,     \
      const float *model, int64_t scenario_stride, float *xs,                  \
      int64_t n_problems, int repeats, int horizon, int substeps,              \
      int clamp_damping
#define QS_PLANNER_ROLLOUT_PARAMS QS_PLANNER_ROLLOUT_HEAD, void *stream

// The cost instantiation's: the rollout's (xs may be null: no states
// written), then the actions (B,R,H,m), the costs (B,R) out, the family
// (task_cost.cuh CostFamily), m and the family's kCostWeights constants as
// a host float array (tasks/costs.py kernel_weights), then the stream.
#define QS_PLANNER_ROLLOUT_COST_PARAMS                                          \
  QS_PLANNER_ROLLOUT_HEAD, const float *us, float *costs, int family,          \
      int action_dim, const float *weights, void *stream

#define QS_ROLLOUT_ARGS_FROM_PARAMS                                             \
  qs::RolloutArgs{x0, q_des, kp, kd, torque_limits, velocity_limits, rest,     \
                  sign, spring_k, spring_b, friction, model, scenario_stride,  \
                  xs, n_problems, repeats, horizon, substeps, clamp_damping}

// the state's 37 floats at x - 3·leg: the base by thread 0, each leg's q and
// qd by its thread (x is offset by the leg, so no register holds 3·leg over
// the knot's substeps)
QS_FN void write_state(float* x, const LaneState& s, int leg) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    x[13 + j] = s.q[j];
    x[25 + j] = s.qd[j];
  }
  if (leg == 0) {
    x[0] = s.pos.x;
    x[1] = s.pos.y;
    x[2] = s.pos.z;
#pragma unroll
    for (int i = 0; i < 4; ++i) x[3 + i] = s.quat[i];
    x[7] = s.lin_vel.x;
    x[8] = s.lin_vel.y;
    x[9] = s.lin_vel.z;
    x[10] = s.ang_vel.x;
    x[11] = s.ang_vel.y;
    x[12] = s.ang_vel.z;
  }
}

// A block of the kernel: 32 lanes of four threads.
constexpr int kRolloutThreads = 128;
constexpr int kRolloutLanes = kRolloutThreads / 4;

// LegModel has an odd number of floats, so the four legs' copies of a
// member, read by one warp instruction, fall in four different banks (and
// for R = 1, the 8 problems x 4 legs of a warp in 32).
static_assert(sizeof(LegModel) % 8 == 4, "one leg's model: an odd count of floats");

// The scenario rows that block `block`'s lanes read: rows (lane / R) ·
// stride of its lanes that exist, `first` to first + count - 1.
struct BlockRows {
  int64_t first;
  int count;
};

QS_FN BlockRows block_rows(const RolloutArgs& a, int64_t block) {
  const int64_t lane0 = block * kRolloutLanes;
  int64_t last = lane0 + kRolloutLanes - 1;
  const int64_t lanes = a.n_problems * a.repeats;
  if (last >= lanes) last = lanes - 1;
  const int64_t first = lane0 / a.repeats * a.scenario_stride;
  return BlockRows{first, static_cast<int>(last / a.repeats * a.scenario_stride - first + 1)};
}

// The most rows any block reads, so the models staged per block (the
// launch's dynamic shared memory): L lanes in a row hold at most
// floor((L - 2) / R) + 2 problems, and all share one row at stride 0.
inline int max_block_rows(int repeats, int64_t scenario_stride) {
  if (scenario_stride == 0) return 1;
  const int rows = (kRolloutLanes - 2) / repeats + 2;
  return rows < kRolloutLanes ? rows : kRolloutLanes;
}

// The block's staging: thread t builds leg t % 4 of its row first + t / 4
// into models[t] (its load_leg_model: the per-leg picks of the constants and
// inertia_at_com), once for every lane of the block that reads the row.
QS_FN void stage_leg_model(const EnvConsts& k, const RolloutArgs& a, const BlockRows& rows,
                           int t, LegModel* models) {
  if (t >= 4 * rows.count) return;
  const int64_t sc = rows.first + (t >> 2);
  models[t] = load_leg_model(k, a.model + sc * kModelFloats, t & 3, a.kp, a.kd,
                             a.torque_limits, a.velocity_limits, a.rest, a.sign,
                             a.spring_k + 3 * sc, a.spring_b + 3 * sc, a.friction[sc], false);
}

// the staged model of leg `leg` of lane `lane`
QS_FN const LegModel& lane_model(const RolloutArgs& a, const BlockRows& rows,
                                 const LegModel* models, int64_t lane, int leg) {
  return models[4 * (lane / a.repeats * a.scenario_stride - rows.first) + leg];
}

// What the cost instantiation adds to RolloutArgs
struct CostArgs {
  const float* us;   // (B,R,H,m) the candidates' actions
  float* costs;      // (B,R) out
  int family, action_dim;
  float w[kCostWeights];
};

QS_FN BaseState base_state(const LaneState& s) {
  return BaseState{s.pos.x,     s.pos.y,     s.pos.z,     s.quat[0],   s.quat[1],
                   s.quat[2],   s.quat[3],   s.lin_vel.x, s.lin_vel.y, s.lin_vel.z,
                   s.ang_vel.x, s.ang_vel.y, s.ang_vel.z};
}

// The stage costs a block keeps: (H, kRolloutLanes) floats after its staged
// models, a lane's column at its index in the block
inline size_t stage_cost_bytes(int horizon) {
  return static_cast<size_t>(horizon) * kRolloutLanes * sizeof(float);
}

// Lane `lane`'s rollout. kCost: also its task cost, written to
// cost->costs[lane]: at each knot the stage cost of the state before it
// and its actions, kept in `stage` (the lane's column of the block's
// stage costs, stride kRolloutLanes), then sum_fixed over the knots plus
// the terminal cost of the last state, as rollout_cost_plain sums them;
// the states are written only where a.xs is not null.
template <bool kCost, class Quad>
QS_FN void planner_lane_run(const EnvConsts& k, const RolloutArgs& a, const CostArgs* cost,
                            const LegModel& c, int64_t lane, int leg, Quad& quad,
                            float* stage) {
  const float* x = a.x0 + kStateFloats * (lane / a.repeats);
  LaneState s;
  s.pos = load3(x);
#pragma unroll
  for (int i = 0; i < 4; ++i) s.quat[i] = x[3 + i];
  s.lin_vel = load3(x + 7);
  s.ang_vel = load3(x + 10);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s.q[j] = x[13 + 3 * leg + j];
    s.qd[j] = x[25 + 3 * leg + j];
  }
  const bool clamp_damping = a.clamp_damping != 0;
  const V3 no_force = v3(0.0f, 0.0f, 0.0f);
  float no_anchor_x = 0.0f, no_anchor_y = 0.0f;
  SubstepOut o;
  const bool states = !kCost || a.xs != nullptr;
  float* out = states ? a.xs + lane * (a.horizon + 1) * kStateFloats + 3 * leg : nullptr;
  if (states) write_state(out, s, leg);
  const float* cmd = a.q_des + lane * a.horizon * 12 + 3 * leg;
  for (int t = 0; t < a.horizon; ++t) {
    if constexpr (kCost) {
      // sum_fixed(qd ** 2) over the 12 joints: (j, j + 6) and (j + 3, j + 9),
      // i.e. legs (0, 2) and (1, 3), then the pairs, then the chain over j
      float sq[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) sq[j] = rn_mul(s.qd[j], s.qd[j]);
      quad.sum_fixed_legs(sq);
      const float* u = cost->us + (lane * a.horizon + t) * cost->action_dim;
      const float v = stage_cost(cost->family, cost->w, base_state(s),
                                 action_square_sum(u, cost->action_dim),
                                 rn_add(rn_add(sq[0], sq[1]), sq[2]));
      if (leg == 0) stage[t * kRolloutLanes] = v;
    }
    for (int r = 0; r < a.substeps; ++r)
      lane_substep<false, false>(k, c, cmd, false, false, clamp_damping, false, no_force, s,
                                 no_anchor_x, no_anchor_y, o, quad);
    if (states) out += kStateFloats;
    cmd += 12;
    if (states) write_state(out, s, leg);
  }
  if constexpr (kCost) {
    if (leg == 0)
      cost->costs[lane] = rn_add(sum_fixed_strided(stage, a.horizon, kRolloutLanes),
                                 terminal_cost(cost->family, cost->w, base_state(s)));
  }
}

template <class Quad>
QS_FN void planner_lane(const EnvConsts& k, const RolloutArgs& a, const LegModel& c,
                        int64_t lane, int leg, Quad& quad) {
  planner_lane_run<false>(k, a, nullptr, c, lane, leg, quad, nullptr);
}

}  // namespace qs
