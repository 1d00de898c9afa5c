// The env_substeps_vjp kernel's body (quadruped_springs_tpu_torch/csrc/
// env_lane_vjp.cuh) built for the CPU in float64: every `float` of the
// bodies a double, each block run as tests/env_substeps_vjp_host.cpp runs it
// (tests/env_vjp_host_block.h). It holds the adjoint's arithmetic to the
// plain version's autograd in float64, where the two part by far less than
// the float32 spread the kernel is held to on the card: a term missing or
// wrong shows however small it is. The entry point takes the float32
// launcher's arguments (env/substeps.py vjp_launch_args; the stream and the
// float32 scratch are ignored) but the constants, which it takes in double
// (env/substeps.py consts_values), widens every input to double, and writes
// the input cotangents d_pos .. d_q_des as doubles (float64 arrays of the
// float32 results' shapes). Build (tests/test_torch_env_vjp.py does):
//   g++ -std=c++20 -O2 -shared -fPIC -pthread -o libenv_substeps_vjp_host64.so
//       tests/env_substeps_vjp_host64.cpp   (one command)

#include <barrier>
#include <cmath>
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <thread>
#include <vector>

inline double sqrtf(double x) { return std::sqrt(x); }
inline double sinf(double x) { return std::sin(x); }
inline double cosf(double x) { return std::cos(x); }
inline double fabsf(double x) { return std::fabs(x); }

#define float double
#include "../quadruped_springs_tpu_torch/csrc/env_lane_vjp.cuh"
#include "env_vjp_host_block.h"
#undef float

namespace {

// count floats from p as doubles (none where p is null)
std::vector<double> widen(const float* p, int64_t count) {
  return p == nullptr ? std::vector<double>() : std::vector<double>(p, p + count);
}
const double* data(const std::vector<double>& v) { return v.empty() ? nullptr : v.data(); }

}  // namespace

extern "C" int env_substeps_vjp_host64(
    const double* consts, int n_consts, const float* pos, const float* quat,
    const float* lin_vel, const float* ang_vel, const float* q, const float* qd,
    const float* anchor, const float* q_des, int64_t q_des_env, int64_t q_des_step,
    const float* kp, const float* kd, const float* torque_limits,
    const float* velocity_limits, const float* rest, const float* sign,
    const float* spring_k, const float* spring_b, const float* friction,
    const float* trunk_inertia6, const float* trunk_mass, const float* leg_masses,
    const float* leg_coms, const float* leg_inertias6, int64_t model_step,
    const float* ext_force, int64_t ext_stride, float*, float*, float*, float*, float*,
    float*, float*, float*, float*, float*, float*, bool* feet_in_contact_out,
    bool* invalid_contact_out, int64_t n, int substeps, int on_rack, int clamp_damping,
    int torque_mode, const float* g_pos, const float* g_quat, const float* g_lin_vel,
    const float* g_ang_vel, const float* g_q, const float* g_qd, const float* g_anchor,
    const float* g_tau, const float* g_tau_m, const float* g_tau_m_sum,
    const float* g_foot_force, double* d_pos, double* d_quat, double* d_lin_vel,
    double* d_ang_vel, double* d_q, double* d_qd, double* d_anchor, double* d_q_des,
    float*, void* stream) {
  (void)stream;
  if (n_consts != qs::kConstsFloats) return 1;
  qs::EnvConsts c;
  double* cd = reinterpret_cast<double*>(&c);
  for (int i = 0; i < n_consts; ++i) cd[i] = consts[i];
  const int64_t rows = model_step ? n : 1;
  const std::vector<double> in[] = {
      widen(pos, 3 * n), widen(quat, 4 * n), widen(lin_vel, 3 * n), widen(ang_vel, 3 * n),
      widen(q, 12 * n), widen(qd, 12 * n), widen(anchor, 8 * n), widen(q_des, q_des_env * n),
      widen(kp, 12), widen(kd, 12), widen(torque_limits, 12), widen(velocity_limits, 12),
      widen(rest, 3), widen(sign, 12), widen(spring_k, 3 * n), widen(spring_b, 3 * n),
      widen(friction, n), widen(trunk_inertia6, 36 * rows), widen(trunk_mass, rows),
      widen(leg_masses, 12 * rows), widen(leg_coms, 36 * rows),
      widen(leg_inertias6, 432 * rows), widen(ext_force, ext_stride ? 3 * n : 3)};
  const std::vector<double> g[] = {
      widen(g_pos, 3 * n), widen(g_quat, 4 * n), widen(g_lin_vel, 3 * n),
      widen(g_ang_vel, 3 * n), widen(g_q, 12 * n), widen(g_qd, 12 * n),
      widen(g_anchor, 8 * n), widen(g_tau, 12 * n), widen(g_tau_m, 12 * n),
      widen(g_tau_m_sum, 12 * n), widen(g_foot_force, 4 * n)};
  // the forward's outputs (the adjoint does not write them) and the scratch
  std::vector<double> out(3 * n + 4 * n + 3 * n + 3 * n + 12 * n * 5 + 8 * n + 4 * n);
  std::vector<double> scratch(4 * n * substeps * qs::kVjpScratchFloats);
  double* o = out.data();
  const qs::EnvArgs args{
      data(in[0]), data(in[1]), data(in[2]), data(in[3]), data(in[4]), data(in[5]),
      data(in[6]), data(in[7]), q_des_env, q_des_step, data(in[8]), data(in[9]),
      data(in[10]), data(in[11]), data(in[12]), data(in[13]), data(in[14]), data(in[15]),
      data(in[16]), data(in[17]), data(in[18]), data(in[19]), data(in[20]), data(in[21]),
      model_step, data(in[22]), ext_stride, o, o + 3 * n, o + 7 * n, o + 10 * n, o + 13 * n,
      o + 25 * n, o + 37 * n, o + 45 * n, o + 57 * n, o + 69 * n, o + 81 * n,
      feet_in_contact_out, invalid_contact_out, n, substeps, on_rack, clamp_damping,
      torque_mode};
  const qs::EnvVjpArgs vargs{
      data(g[0]), data(g[1]), data(g[2]), data(g[3]), data(g[4]), data(g[5]), data(g[6]),
      data(g[7]), data(g[8]), data(g[9]), data(g[10]), d_pos, d_quat, d_lin_vel, d_ang_vel,
      d_q, d_qd, d_anchor, d_q_des, scratch.data()};
  const int chunk = qs_host::launch_chunk(substeps, 0);
  if (chunk < 1) return 1;
  qs_host::run_vjp_blocks<double>(c, args, vargs, chunk);
  return 0;
}
