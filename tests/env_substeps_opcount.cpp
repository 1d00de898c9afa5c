// The float operations of the env_substeps and env_substeps_vjp kernels'
// bodies (quadruped_springs_tpu_torch/csrc/env_lane.cuh, env_lane_vjp.cuh),
// counted by running them on the CPU with every `float` a counting type:
// each +, -, *, / (unary minus too), sqrtf, sinf and cosf of a float is one
// operation, a comparison or a select none. What is counted is the
// function's work, not the threads': the base's work, which the four leg
// threads of a robot do alike (marked QS_BASE_WORK in the bodies), and each
// sum over the four legs count once a robot (leg 0's), and the adjoint's
// recompute of a substep's forward (QS_RECOMPUTE) not at all, so the
// adjoint's count is one forward plus the adjoint proper. The adjoint's
// block does the base's work on one lane an environment, counted as it runs. The bound of
// chip_smoke.py's FLOPS_PER_ELEM comes from these counts
// (tests/torch_env_opcount.py builds and runs this file with g++).

#include <atomic>
#include <barrier>
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <thread>
#include <vector>

namespace opcount {
inline std::atomic<int64_t> ops{0};
thread_local int leg = 0;              // the thread's leg
thread_local bool alike = false;       // in work the four legs do alike
thread_local bool recompute = false;   // in the adjoint's recompute
inline void count() {
  if (!recompute && (leg == 0 || !alike)) ++ops;
}
inline void base(bool on) { alike = on; }
inline void recomputing(bool on) { recompute = on; }
struct CF {
  float v;
  CF() = default;
  CF(float x) : v(x) {}
  CF(double x) : v(static_cast<float>(x)) {}
  CF(int x) : v(static_cast<float>(x)) {}
  explicit operator bool() const { return v != 0.0f; }
  CF& operator+=(CF o) { count(); v += o.v; return *this; }
  CF& operator-=(CF o) { count(); v -= o.v; return *this; }
  CF& operator*=(CF o) { count(); v *= o.v; return *this; }
};
inline CF operator+(CF a, CF b) { count(); return CF(a.v + b.v); }
inline CF operator-(CF a, CF b) { count(); return CF(a.v - b.v); }
inline CF operator*(CF a, CF b) { count(); return CF(a.v * b.v); }
inline CF operator/(CF a, CF b) { count(); return CF(a.v / b.v); }
inline CF operator-(CF a) { count(); return CF(-a.v); }
inline bool operator<(CF a, CF b) { return a.v < b.v; }
inline bool operator>(CF a, CF b) { return a.v > b.v; }
inline bool operator<=(CF a, CF b) { return a.v <= b.v; }
inline bool operator>=(CF a, CF b) { return a.v >= b.v; }
inline bool operator==(CF a, CF b) { return a.v == b.v; }
inline bool operator!=(CF a, CF b) { return a.v != b.v; }
}  // namespace opcount

using opcount::CF;
inline CF sqrtf(CF x) { opcount::count(); return CF(::sqrtf(x.v)); }
inline CF sinf(CF x) { opcount::count(); return CF(::sinf(x.v)); }
inline CF cosf(CF x) { opcount::count(); return CF(::cosf(x.v)); }
inline CF fmaxf(CF a, CF b) { return CF(::fmaxf(a.v, b.v)); }   // a comparison: none

#define QS_BASE_WORK(on) opcount::base(on)
#define QS_RECOMPUTE(on) opcount::recomputing(on)
#define float CF
#include "../quadruped_springs_tpu_torch/csrc/env_lane_vjp.cuh"

#include "env_vjp_host_block.h"
#undef float

namespace {

struct HostQuad {
  std::barrier<>* bar;
  CF (*slots)[32];
  int leg;

  template <int N>
  void sum(CF (&v)[N]) {
    for (int i = 0; i < N; ++i) slots[leg][i] = v[i];
    bar->arrive_and_wait();
    const bool was = opcount::alike;   // the four threads' sums: one reduction
    opcount::alike = true;
    for (int i = 0; i < N; ++i)
      v[i] = (slots[0][i] + slots[1][i]) + (slots[2][i] + slots[3][i]);
    opcount::alike = was;
    bar->arrive_and_wait();
  }
};

// the forward's body: each environment's four legs on four threads
template <class F>
int64_t count(int64_t n, F&& lane) {
  opcount::ops = 0;
  for (int64_t env = 0; env < n; ++env) {
    std::barrier<> bar(4);
    CF slots[4][32];
    std::vector<std::thread> legs;
    for (int leg = 0; leg < 4; ++leg)
      legs.emplace_back([&, leg] {
        opcount::leg = leg;
        HostQuad quad{&bar, slots, leg};
        lane(env, leg, quad);
      });
    for (auto& t : legs) t.join();
  }
  return opcount::ops;
}

// the adjoint's block (tests/env_vjp_host_block.h): a quad's host thread
// takes its slot's leg; the block's own sums over the legs (each
// environment's, on its base lane) count as they run, the quads' sums once
void set_leg(int slot) { opcount::leg = slot & 3; }
void mark_sum(bool on) {
  static thread_local bool was = false;
  if (on) {
    was = opcount::alike;
    opcount::alike = true;
  } else {
    opcount::alike = was;
  }
}

}  // namespace

// the forward's and the adjoint's operations over the launch's n x substeps
// (out[0], out[1]); the arguments are the vjp launcher's (host pointers, a
// float is a CF bitwise)
extern "C" int env_opcount(const float* consts, int n_consts, const float* pos,
                           const float* quat, const float* lin_vel, const float* ang_vel,
                           const float* q, const float* qd, const float* anchor,
                           const float* q_des, int64_t q_des_env, int64_t q_des_step,
                           const float* kp, const float* kd, const float* torque_limits,
                           const float* velocity_limits, const float* rest, const float* sign,
                           const float* spring_k, const float* spring_b, const float* friction,
                           const float* trunk_inertia6, const float* trunk_mass,
                           const float* leg_masses, const float* leg_coms,
                           const float* leg_inertias6, int64_t model_step,
                           const float* ext_force, int64_t ext_stride, float* pos_out,
                           float* quat_out, float* lin_vel_out, float* ang_vel_out,
                           float* q_out, float* qd_out, float* anchor_out, float* tau_out,
                           float* tau_m_out, float* tau_m_sum_out, float* foot_force_out,
                           bool* feet_in_contact_out, bool* invalid_contact_out, int64_t n,
                           int substeps, int on_rack, int clamp_damping, int torque_mode,
                           const float* g_pos, const float* g_quat, const float* g_lin_vel,
                           const float* g_ang_vel, const float* g_q, const float* g_qd,
                           const float* g_anchor, const float* g_tau, const float* g_tau_m,
                           const float* g_tau_m_sum, const float* g_foot_force, float* d_pos,
                           float* d_quat, float* d_lin_vel, float* d_ang_vel, float* d_q,
                           float* d_qd, float* d_anchor, float* d_q_des, float* scratch,
                           void* stream, int64_t* out) {
  (void)stream;
  if (n_consts != qs::kConstsFloats) return 1;
  qs::EnvConsts c;
  memcpy(&c, consts, sizeof(c));
  auto C = [](const float* p) { return reinterpret_cast<const CF*>(p); };
  auto M = [](float* p) { return reinterpret_cast<CF*>(p); };
  const qs::EnvArgs args{C(pos), C(quat), C(lin_vel), C(ang_vel), C(q), C(qd), C(anchor),
                         C(q_des), q_des_env, q_des_step, C(kp), C(kd), C(torque_limits),
                         C(velocity_limits), C(rest), C(sign), C(spring_k), C(spring_b),
                         C(friction), C(trunk_inertia6), C(trunk_mass), C(leg_masses),
                         C(leg_coms), C(leg_inertias6), model_step, C(ext_force), ext_stride,
                         M(pos_out), M(quat_out), M(lin_vel_out), M(ang_vel_out), M(q_out),
                         M(qd_out), M(anchor_out), M(tau_out), M(tau_m_out),
                         M(tau_m_sum_out), M(foot_force_out), feet_in_contact_out,
                         invalid_contact_out, n, substeps, on_rack, clamp_damping,
                         torque_mode};
  const qs::EnvVjpArgs vargs{C(g_pos), C(g_quat), C(g_lin_vel), C(g_ang_vel), C(g_q),
                             C(g_qd), C(g_anchor), C(g_tau), C(g_tau_m), C(g_tau_m_sum),
                             C(g_foot_force), M(d_pos), M(d_quat), M(d_lin_vel),
                             M(d_ang_vel), M(d_q), M(d_qd), M(d_anchor), M(d_q_des),
                             M(scratch)};
  out[0] = count(n, [&](int64_t env, int leg, HostQuad& quad) {
    qs::env_lane(c, args, env, leg, quad);
  });
  opcount::ops = 0;
  opcount::leg = 0;
  qs_host::on_quad_thread = set_leg;
  qs_host::run_vjp_blocks<CF>(c, args, vargs, qs_host::launch_chunk(substeps, 0), mark_sum);
  qs_host::on_quad_thread = nullptr;
  out[1] = opcount::ops;
  return 0;
}
