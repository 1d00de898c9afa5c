// One thread's share of a lane of the fused physics kernels: `lane_substep`,
// one substep of one leg of one robot (PD + spring torque, contact at the
// leg's foot, knee and trunk corner, the star-topology solve, the
// semi-implicit Euler update), and `env_lane`, the env_substeps kernel's
// (env_step.cu) loop of R such substeps with foot-anchor stiction. It does
// the work of the loop of quadruped_springs_tpu_torch/env/env.py
// QuadrupedEnv.step (action -> PD + spring torque -> dynamics.step with
// foot-anchor stiction), whose plain PyTorch version is env/substeps.py
// env_substeps_plain. planner_lane.cuh runs the same substep with the
// planner's memoryless foot contact.
//
// The four threads of a robot hold the same base state and compute the
// base's quantities redundantly and identically; thread `leg` holds its
// leg's joints, its foot's anchor, its foot, knee and trunk corner. Per
// substep they exchange one sum of 27 floats: each leg's share of the base's
// 6x6 Schur complement (its composite inertia less B Dinv Bᵀ) and of the
// right-hand side (its contact wrench less its bias force and B Dinv r).
// `Quad` sums over the four: __shfl_xor_sync in the kernels (QuadShfl), a
// barrier of four host threads in tests/env_substeps_host.cpp and
// tests/planner_rollout_host.cpp. Both add in the fixed order
// (v0 + v1) + (v2 + v3), so every thread gets the same sum bitwise,
// whatever the batch holds beside the robot.

#pragma once

#include <stdint.h>

#include "go1_dynamics.cuh"

// Marks around the base's work, which the four threads of a robot do alike,
// and (QS_RECOMPUTE) around the adjoint's recompute of a substep's forward:
// empty in the kernels. tests/env_substeps_opcount.cpp defines them to count
// the function's operations, the base's once a robot and the recompute not.
#ifndef QS_BASE_WORK
#define QS_BASE_WORK(on)
#endif
#ifndef QS_RECOMPUTE
#define QS_RECOMPUTE(on)
#endif

namespace qs {

// Floats per scenario of the packed model (env/substeps.py pack_model, the
// planner's rows): the trunk's mass, h = m·com and 3x3 inertia about the
// base origin, then for each leg and body its mass, local COM and the
// top-left 3x3 block of its spatial inertia about the link origin.
constexpr int kTrunkFloats = 13;
constexpr int kBodyFloats = 13;
constexpr int kModelFloats = kTrunkFloats + 12 * kBodyFloats;   // 169

struct EnvArgs {
  // state in, (N,3) (N,4) (N,3) (N,3) (N,12) (N,12) (N,4,2)
  const float *pos, *quat, *lin_vel, *ang_vel, *q, *qd, *anchor;
  // joint commands (PD targets, or torques in TORQUE mode): element
  // (env, substep r, joint) at q_des[env * q_des_env + r * q_des_step + joint]
  const float* q_des;
  int64_t q_des_env, q_des_step;
  // (12,) gains and limits; (3,) spring rest angles; (12,) engage signs
  const float *kp, *kd, *torque_limits, *velocity_limits, *rest, *sign;
  const float *spring_k, *spring_b;   // (N,3)
  const float* friction;              // (N,)
  // the model's scenario fields where models/go1_params.py Go1Model holds
  // them, B rows each: trunk_inertia6 (B,6,6), trunk_mass (B,), leg_masses
  // (B,4,3), leg_coms (B,4,3,3), leg_inertias6 (B,4,3,6,6)
  const float *trunk_inertia6, *trunk_mass, *leg_masses, *leg_coms, *leg_inertias6;
  int64_t model_step;                 // 1: a row an environment (B = N); 0: row 0 for all
  const float* ext_force;             // world force at the trunk origin, or null
  int64_t ext_stride;                 // 3, or 0: one force for all
  // state out
  float *pos_out, *quat_out, *lin_vel_out, *ang_vel_out, *q_out, *qd_out, *anchor_out;
  // the last substep's total and motor torque, the motor torque summed over
  // the substeps (N,12); the last substep's foot normal forces (N,4), feet
  // in contact (N,4) and non-foot contact (N,)
  float *tau_out, *tau_m_out, *tau_m_sum_out, *foot_force_out;
  bool *feet_in_contact_out, *invalid_contact_out;
  int64_t n;
  int substeps;
  int on_rack, clamp_damping, torque_mode;
};

// The argument list of the extern "C" entry points (env_step.cu's
// launcher and the host build of tests/env_substeps_host.cpp): the consts
// as a host float array of sizeof(EnvConsts) / 4, then EnvArgs's members in
// order (QS_ENV_SUBSTEPS_ARGS), then the stream. Both fill the same
// structures through these; env_step_vjp.cu's entry point takes the same
// arguments before its own.
#define QS_ENV_SUBSTEPS_PARAMS QS_ENV_SUBSTEPS_ARGS, void *stream
#define QS_ENV_SUBSTEPS_ARGS                                                    \
  const float *consts, int n_consts, const float *pos, const float *quat,      \
      const float *lin_vel, const float *ang_vel, const float *q,              \
      const float *qd, const float *anchor, const float *q_des,                \
      int64_t q_des_env, int64_t q_des_step, const float *kp, const float *kd, \
      const float *torque_limits, const float *velocity_limits,                \
      const float *rest, const float *sign, const float *spring_k,             \
      const float *spring_b, const float *friction,                            \
      const float *trunk_inertia6, const float *trunk_mass,                    \
      const float *leg_masses, const float *leg_coms,                          \
      const float *leg_inertias6, int64_t model_step, const float *ext_force,  \
      int64_t ext_stride,                                                      \
      float *pos_out, float *quat_out, float *lin_vel_out, float *ang_vel_out, \
      float *q_out, float *qd_out, float *anchor_out, float *tau_out,          \
      float *tau_m_out, float *tau_m_sum_out, float *foot_force_out,           \
      bool *feet_in_contact_out, bool *invalid_contact_out, int64_t n,         \
      int substeps, int on_rack, int clamp_damping, int torque_mode

#define QS_ENV_ARGS_FROM_PARAMS                                                 \
  qs::EnvArgs{pos, quat, lin_vel, ang_vel, q, qd, anchor, q_des, q_des_env,        \
          q_des_step, kp, kd, torque_limits, velocity_limits, rest, sign,      \
          spring_k, spring_b, friction, trunk_inertia6, trunk_mass,            \
          leg_masses, leg_coms, leg_inertias6, model_step, ext_force,          \
          ext_stride, pos_out, quat_out, lin_vel_out, ang_vel_out, q_out,      \
          qd_out, anchor_out, tau_out, tau_m_out, tau_m_sum_out,               \
          foot_force_out, feet_in_contact_out, invalid_contact_out, n,         \
          substeps, on_rack, clamp_damping, torque_mode}

constexpr int kConstsFloats = static_cast<int>(sizeof(EnvConsts) / sizeof(float));

#if defined(__CUDACC__)
// Sums over the four lanes of a robot (lanes 4e..4e+3 of a warp).
struct QuadShfl {
  unsigned mask;
  template <int N>
  __device__ __forceinline__ void sum(float (&v)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(mask, v[i], 1);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(mask, v[i], 2);
  }
};
#endif

// What a thread reads once: its robot's model (the trunk, its leg's
// bodies), its leg's geometry and motors, the robot's springs and friction.
struct LegModel {
  Inertia trunk;
  LegBodies bodies;
  V3 hip, thigh, corner, g;
  float kp[3], kd[3], lim[3], vlim[3], rest[3], sign[3], sk[3], sb[3];
  float mu;
};

// trunk: the robot's trunk; m, com, A: its leg's bodies' masses, local COMs
// and the top-left 3x3 blocks of their spatial inertias about the link
// origins; kp .. sign: the (12,) and (3,) tables; sk, sb: the robot's (3,)
// springs
QS_FN LegModel leg_model(const EnvConsts& k, const Inertia& trunk, const float (&m)[3],
                         const V3 (&com)[3], const M3 (&A)[3], int leg, const float* kp,
                         const float* kd, const float* torque_limits,
                         const float* velocity_limits, const float* rest, const float* sign,
                         const float* sk, const float* sb, float mu, bool zero_gains) {
  LegModel c;
  c.trunk = trunk;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    c.bodies.m[j] = m[j];
    c.bodies.c[j] = com[j];
    c.bodies.I[j] = inertia_at_com(m[j], com[j], A[j]);
  }
  c.hip = pick_leg(k.hip, leg);
  c.thigh = pick_leg(k.thigh, leg);
  c.corner = pick_leg(k.corners, leg);
  c.g = load3(k.gravity);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    c.kp[j] = zero_gains ? 0.0f : kp[3 * leg + j];
    c.kd[j] = zero_gains ? 0.0f : kd[3 * leg + j];
    c.lim[j] = torque_limits[3 * leg + j];
    c.vlim[j] = velocity_limits[3 * leg + j];
    c.rest[j] = rest[j];
    c.sign[j] = sign[3 * leg + j];
    c.sk[j] = sk[j];
    c.sb[j] = sb[j];
  }
  c.mu = mu;
  return c;
}

// leg_model from a packed model row mf (kModelFloats)
QS_FN LegModel load_leg_model(const EnvConsts& k, const float* mf, int leg, const float* kp,
                              const float* kd, const float* torque_limits,
                              const float* velocity_limits, const float* rest,
                              const float* sign, const float* sk, const float* sb, float mu,
                              bool zero_gains) {
  float m[3];
  V3 com[3];
  M3 A[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* b = mf + kTrunkFloats + (3 * leg + j) * kBodyFloats;
    m[j] = b[0];
    com[j] = load3(b + 1);
    A[j] = load33(b + 4);
  }
  return leg_model(k, Inertia{mf[0], load3(mf + 1), load33(mf + 4)}, m, com, A, leg, kp, kd,
                   torque_limits, velocity_limits, rest, sign, sk, sb, mu, zero_gains);
}

// rows 0-2, columns 0-2 of a row-major 6x6 matrix
QS_FN M3 top_left33(const float* I6) { return M3{{load3(I6), load3(I6 + 6), load3(I6 + 12)}}; }

// leg_model of environment `env` from the model's scenario fields where they
// lie (EnvArgs): the same floats pack_model copies into a row
QS_FN LegModel scenario_leg_model(const EnvConsts& k, const EnvArgs& a, int64_t env, int leg) {
  const int64_t row = env * a.model_step;
  const float* ti = a.trunk_inertia6 + 36 * row;
  const Inertia trunk{a.trunk_mass[row], v3(ti[2 * 6 + 4], ti[0 * 6 + 5], ti[1 * 6 + 3]),
                      top_left33(ti)};
  float m[3];
  V3 com[3];
  M3 A[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int64_t body = 12 * row + 3 * leg + j;
    m[j] = a.leg_masses[body];
    com[j] = load3(a.leg_coms + 3 * body);
    A[j] = top_left33(a.leg_inertias6 + 36 * body);
  }
  return leg_model(k, trunk, m, com, A, leg, a.kp, a.kd, a.torque_limits, a.velocity_limits,
                   a.rest, a.sign, a.spring_k + 3 * env, a.spring_b + 3 * env, a.friction[env],
                   a.torque_mode != 0);
}

// The robot's state: the base (world frame, every thread alike) and the
// thread's leg.
struct LaneState {
  V3 pos, lin_vel, ang_vel;
  float quat[4];
  float q[3], qd[3];
};

// What a substep leaves besides the state: the leg's total and motor
// torque, its foot's normal force and contact flag, and whether its knee or
// trunk corner touched.
struct SubstepOut {
  float tau[3], tau_m[3];
  float foot_fn;
  bool foot_inc, other_inc;
};

// f(ops) for a stage of the substep: with CheckedOps (elems.cuh) where
// kChecked, and again with IeeeOps where those could not vouch for a value;
// with IeeeOps alone otherwise. f writes its results afresh each time.
template <bool kChecked, class F>
QS_FN void with_ops(F&& f) {
  if constexpr (kChecked) {
    CheckedOps ops;
    f(ops);
    if (ops.ok) return;
  }
  IeeeOps ieee;
  f(ieee);
}

// What a leg's three contact sites give: the world forces at the foot, the
// knee and the trunk corner, the foot's normal force, its new anchor and the
// three contact flags.
struct Sites {
  V3 ff, fk, fc;
  float foot_fn, anc_x, anc_y;
  bool foot_inc, inc_k, inc_c;
};

// The contact laws at the foot (kAnchored: its anchor spring on the anchor
// (anc_x, anc_y); otherwise the memoryless law), the knee and the trunk
// corner, at their world positions and velocities.
template <bool kAnchored, class Ops>
QS_FN Sites contact_sites(const EnvConsts& k, float mu, bool clamp_damping, const V3& pf,
                          const V3& vf, const V3& pk, const V3& vk, const V3& pc, const V3& vc,
                          float anc_x, float anc_y, Ops& ops) {
  Sites o;
  float fn_k, fn_c;
  if constexpr (kAnchored) {
    anchored_foot_elem(k.foot_radius - pf.z, vf.x, vf.y, vf.z, pf.x, pf.y, anc_x, anc_y, mu,
                       k.kn, k.dn, k.kt, k.ct, clamp_damping, &o.ff.x, &o.ff.y, &o.ff.z,
                       &o.foot_fn, &o.foot_inc, &o.anc_x, &o.anc_y, ops);
  } else {
    contact_elem(k.foot_radius - pf.z, vf.x, vf.y, vf.z, mu, k.kn, k.dn, k.v_tol,
                 clamp_damping, &o.ff.x, &o.ff.y, &o.ff.z, &o.foot_fn, &o.foot_inc, ops);
    o.anc_x = anc_x;
    o.anc_y = anc_y;
  }
  contact_elem(k.knee_radius - pk.z, vk.x, vk.y, vk.z, mu, k.kn, k.dn, k.v_tol, clamp_damping,
               &o.fk.x, &o.fk.y, &o.fk.z, &fn_k, &o.inc_k, ops);
  contact_elem(k.trunk_radius - pc.z, vc.x, vc.y, vc.z, mu, k.kn, k.dn, k.v_tol,
               clamp_damping, &o.fc.x, &o.fc.y, &o.fc.z, &fn_c, &o.inc_c, ops);
  return o;
}

// One substep of leg `leg`: actuation on the command cmd (PD targets, or
// torques with torque_mode), contact (kAnchored: the feet's anchor springs
// on the anchor (anc_x, anc_y), which it updates; otherwise the memoryless
// law at the feet too), the joint limits, the star solve and the Euler
// update of `s`. f_ext is read where has_ext. kChecked: the contact sites,
// the 6x6 solve and the quaternion's update take their roots and quotients
// off the slow-path branches (with_ops), bitwise the same values.
template <bool kAnchored, bool kChecked, class Quad>
QS_FN void lane_substep(const EnvConsts& k, const LegModel& c, const float* cmd,
                        bool torque_mode, bool on_rack, bool clamp_damping, bool has_ext,
                        const V3& f_ext, LaneState& s, float& anc_x, float& anc_y,
                        SubstepOut& o, Quad& quad) {
  // ---- actuation (ops/actuation.py; TORQUE: the clipped command plus the
  // springs through the law at zero gains) -----------------------------------
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float cj = cmd[j], t, tm;
    actuation_elem(cj, s.q[j], s.qd[j], c.kp[j], c.kd[j], c.lim[j], c.sk[j], c.sb[j],
                   c.rest[j], c.sign[j], &t, &tm);
    if (torque_mode) {
      tm = clip(cj, -c.lim[j], c.lim[j]);
      t = tm + t;
    }
    o.tau[j] = t;
    o.tau_m[j] = tm;
  }

  // ---- the base's motion and the leg's articulated quantities -------------
  QS_BASE_WORK(true);
  M3 R = quat_to_m3(s.quat);
  V3 w_b = mul_t(R, s.ang_vel), v_b = mul_t(R, s.lin_vel), g_b = mul_t(R, c.g);
  QS_BASE_WORK(false);
  Leg L = leg_kinematics(k, c.hip, c.thigh, s.q, c.bodies);
  V3 f0t, f0b;
  float h[3];
  leg_bias(L, s.qd, w_b, v_b, g_b, &f0t, &f0b, h);

  // ---- contact at the foot, the knee and the trunk corner -----------------
  V3 knee = L.o[2];
  V3 foot_v = leg_point_velocity(L, s.qd, L.foot, w_b, v_b);
  V3 knee_v = leg_point_velocity(L, s.qd, knee, w_b, v_b);
  V3 corner_v = add(v_b, cross(w_b, c.corner));
  V3 pf = add(s.pos, mul(R, L.foot)), vf = mul(R, foot_v);
  V3 pk = add(s.pos, mul(R, knee)), vk = mul(R, knee_v);
  V3 pc = add(s.pos, mul(R, c.corner)), vc = mul(R, corner_v);
  Sites sites;
  with_ops<kChecked>([&](auto& ops) {
    sites = contact_sites<kAnchored>(k, c.mu, clamp_damping, pf, vf, pk, vk, pc, vc, anc_x,
                                     anc_y, ops);
  });
  const V3 ff = sites.ff, fk = sites.fk, fc = sites.fc;
  anc_x = sites.anc_x;
  anc_y = sites.anc_y;
  o.foot_fn = sites.foot_fn;
  o.foot_inc = sites.foot_inc;
  o.other_inc = sites.inc_k || sites.inc_c;
  // world forces -> base wrench and the leg's joint torques
  V3 fbf = mul_t(R, ff), fbk = mul_t(R, fk), fbc = mul_t(R, fc);
  V3 tqf = cross(L.foot, fbf), tqk = cross(knee, fbk), tqc = cross(c.corner, fbc);
  V3 wrench_t = add(add(tqf, tqk), tqc), wrench_f = add(add(fbf, fbk), fbc);

  // ---- the leg's right-hand side and 3x3 block ----------------------------
  float rhs[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float tau_c = dot6(L.sw[j], L.sv[j], tqf, fbf);
    tau_c = tau_c + dot6(L.sw[j], L.sv[j], tqk, fbk);
    rhs[j] = o.tau[j] + tau_c + joint_limit_torque(k, j, s.q[j], s.qd[j]) - h[j];
  }
  const float eps = 1e-9f;
  M3 Dinv = sym3_inv(leg_d(L, 0, 0), leg_d(L, 0, 1), leg_d(L, 0, 2), leg_d(L, 1, 1),
                     leg_d(L, 1, 2), leg_d(L, 2, 2), eps);

  float a0[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float qdd[3];
  if (on_rack) {
    // base welded in the air: a0 = 0 and the legs decouple
    V3 acc = mul(Dinv, v3(rhs[0], rhs[1], rhs[2]));
    qdd[0] = acc.x;
    qdd[1] = acc.y;
    qdd[2] = acc.z;
  } else {
    // ---- this leg's share of the base's Schur system, summed over legs -----
    float BDinv[6][3];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float sum = leg_f(L, 0, i) * at(Dinv, 0, j);
        sum = sum + leg_f(L, 1, i) * at(Dinv, 1, j);
        BDinv[i][j] = sum + leg_f(L, 2, i) * at(Dinv, 2, j);
      }
    float share[27];   // 21: the lower triangle of S's share; 6: t's
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int b = 0; b <= i; ++b) {
        float sum = BDinv[i][0] * leg_f(L, 0, b);
        sum = sum + BDinv[i][1] * leg_f(L, 1, b);
        sum = sum + BDinv[i][2] * leg_f(L, 2, b);
        share[tri(i, b)] = inertia6(L.Ic1, i, b) - sum;
      }
      float sum = BDinv[i][0] * rhs[0];
      sum = sum + BDinv[i][1] * rhs[1];
      sum = sum + BDinv[i][2] * rhs[2];
      float f = i < 3 ? at(wrench_t, i) - at(f0t, i) : at(wrench_f, i - 3) - at(f0b, i - 3);
      share[21 + i] = f - sum;
    }
    quad.sum(share);

    // ---- the base: trunk + the legs' shares, solved by every thread -------
    QS_BASE_WORK(true);
    V3 ht, hb;
    trunk_bias(c.trunk, w_b, v_b, g_b, &ht, &hb);
    V3 fe = mul_t(R, f_ext);
    float S[21], t6[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int b = 0; b <= i; ++b) S[tri(i, b)] = inertia6(c.trunk, i, b) + share[tri(i, b)];
      float hi = i < 3 ? at(ht, i) : at(hb, i - 3);
      t6[i] = -hi + share[21 + i];
      if (has_ext && i >= 3) t6[i] = t6[i] + at(fe, i - 3);
    }
    chol6_solve(S, t6, eps, a0);
    QS_BASE_WORK(false);
    float rj[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      rj[j] = rhs[j] - dot6(L.Ft[j], L.Fb[j], v3(a0[0], a0[1], a0[2]),
                            v3(a0[3], a0[4], a0[5]));
    V3 acc = mul(Dinv, v3(rj[0], rj[1], rj[2]));
    qdd[0] = acc.x;
    qdd[1] = acc.y;
    qdd[2] = acc.z;
  }

  // ---- semi-implicit Euler (dynamics.step) --------------------------------
  QS_BASE_WORK(true);
  V3 w_new = add(w_b, scale(k.dt, v3(a0[0], a0[1], a0[2])));
  V3 v_new = add(v_b, scale(k.dt, v3(a0[3], a0[4], a0[5])));
  QS_BASE_WORK(false);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s.qd[j] = clip(s.qd[j] + k.dt * qdd[j], -c.vlim[j], c.vlim[j]);
    s.q[j] = s.q[j] + k.dt * s.qd[j];
  }
  if (on_rack) {
    w_new = v3(0.0f, 0.0f, 0.0f);
    v_new = v3(0.0f, 0.0f, 0.0f);
  }
  QS_BASE_WORK(true);
  quat_integrate(s.quat, w_new, k.half_dt, k.half_dt2);
  s.lin_vel = mul(R, v_new);
  s.ang_vel = mul(R, w_new);
  s.pos = add(s.pos, scale(k.dt, s.lin_vel));
  QS_BASE_WORK(false);
}

template <class Quad>
QS_FN void env_lane(const EnvConsts& k, const EnvArgs& a, int64_t env, int leg, Quad& quad) {
  // ---- what the launch reads once -----------------------------------------
  const LegModel c = scenario_leg_model(k, a, env, leg);
  LaneState s;
  s.pos = load3(a.pos + 3 * env);
  s.lin_vel = load3(a.lin_vel + 3 * env);
  s.ang_vel = load3(a.ang_vel + 3 * env);
#pragma unroll
  for (int i = 0; i < 4; ++i) s.quat[i] = a.quat[4 * env + i];
  const int64_t m0 = 12 * env + 3 * leg;   // this leg's first motor
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s.q[j] = a.q[m0 + j];
    s.qd[j] = a.qd[m0 + j];
  }
  float anc_x = a.anchor[8 * env + 2 * leg], anc_y = a.anchor[8 * env + 2 * leg + 1];
  const bool has_ext = a.ext_force != nullptr;
  const V3 f_ext = has_ext ? load3(a.ext_force + env * a.ext_stride) : v3(0.0f, 0.0f, 0.0f);

  SubstepOut o = {};
  float tau_m_sum[3] = {0.0f, 0.0f, 0.0f};
  for (int r = 0; r < a.substeps; ++r) {
    const float* cmd = a.q_des + env * a.q_des_env + r * a.q_des_step + 3 * leg;
    lane_substep<true, true>(k, c, cmd, a.torque_mode != 0, a.on_rack != 0,
                             a.clamp_damping != 0, has_ext, f_ext, s, anc_x, anc_y, o, quad);
#pragma unroll
    for (int j = 0; j < 3; ++j) tau_m_sum[j] = r == 0 ? o.tau_m[j] : tau_m_sum[j] + o.tau_m[j];
  }

  // ---- outputs: each input was read once, each output is written once ----
  float any_other[1] = {o.other_inc ? 1.0f : 0.0f};
  quad.sum(any_other);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a.q_out[m0 + j] = s.q[j];
    a.qd_out[m0 + j] = s.qd[j];
    a.tau_out[m0 + j] = o.tau[j];
    a.tau_m_out[m0 + j] = o.tau_m[j];
    a.tau_m_sum_out[m0 + j] = tau_m_sum[j];
  }
  a.anchor_out[8 * env + 2 * leg] = anc_x;
  a.anchor_out[8 * env + 2 * leg + 1] = anc_y;
  a.foot_force_out[4 * env + leg] = o.foot_fn;
  a.feet_in_contact_out[4 * env + leg] = o.foot_inc;
  if (leg == 0) {
    a.invalid_contact_out[env] = any_other[0] > 0.0f;
    a.pos_out[3 * env] = s.pos.x;
    a.pos_out[3 * env + 1] = s.pos.y;
    a.pos_out[3 * env + 2] = s.pos.z;
    a.lin_vel_out[3 * env] = s.lin_vel.x;
    a.lin_vel_out[3 * env + 1] = s.lin_vel.y;
    a.lin_vel_out[3 * env + 2] = s.lin_vel.z;
    a.ang_vel_out[3 * env] = s.ang_vel.x;
    a.ang_vel_out[3 * env + 1] = s.ang_vel.y;
    a.ang_vel_out[3 * env + 2] = s.ang_vel.z;
#pragma unroll
    for (int i = 0; i < 4; ++i) a.quat_out[4 * env + i] = s.quat[i];
  }
}

}  // namespace qs
