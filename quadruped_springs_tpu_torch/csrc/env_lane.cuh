// One thread's share of the env_substeps kernel (env_step.cu): leg `leg` of
// environment `env` through R substeps of 1 kHz physics. It does the work of
// the loop of quadruped_springs_tpu_torch/env/env.py QuadrupedEnv.step
// (action -> PD + spring torque -> dynamics.step with foot-anchor stiction),
// whose plain PyTorch version is env/substeps.py env_substeps_plain.
//
// The four threads of an environment hold the same base state and compute
// the base's quantities redundantly and identically; thread `leg` holds its
// leg's joints, its foot's anchor, its foot, knee and trunk corner. Per
// substep they exchange one sum of 27 floats: each leg's share of the base's
// 6x6 Schur complement (its composite inertia less B Dinv Bᵀ) and of the
// right-hand side (its contact wrench less its bias force and B Dinv r).
// `Quad` sums over the four: __shfl_xor_sync in the kernel, a barrier of
// four host threads in tests/env_substeps_host.cpp. Both add in the fixed
// order (v0 + v1) + (v2 + v3), so every thread gets the same sum bitwise,
// whatever the batch holds beside the environment.

#pragma once

#include <stdint.h>

#include "go1_dynamics.cuh"

namespace qs {

// Floats per environment of the packed model (env/substeps.py pack_model):
// the trunk's mass, h = m·com and 3x3 inertia about the base origin, then
// for each leg and body its mass, local COM and the top-left 3x3 block of
// its spatial inertia about the link origin.
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
  const float* model;                 // rows of kModelFloats
  int64_t model_stride;               // kModelFloats, or 0: one model for all
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
// order, then the stream. Both fill the same structures through these.
#define QS_ENV_SUBSTEPS_PARAMS                                                  \
  const float *consts, int n_consts, const float *pos, const float *quat,      \
      const float *lin_vel, const float *ang_vel, const float *q,              \
      const float *qd, const float *anchor, const float *q_des,                \
      int64_t q_des_env, int64_t q_des_step, const float *kp, const float *kd, \
      const float *torque_limits, const float *velocity_limits,                \
      const float *rest, const float *sign, const float *spring_k,             \
      const float *spring_b, const float *friction, const float *model,        \
      int64_t model_stride, const float *ext_force, int64_t ext_stride,        \
      float *pos_out, float *quat_out, float *lin_vel_out, float *ang_vel_out, \
      float *q_out, float *qd_out, float *anchor_out, float *tau_out,          \
      float *tau_m_out, float *tau_m_sum_out, float *foot_force_out,           \
      bool *feet_in_contact_out, bool *invalid_contact_out, int64_t n,         \
      int substeps, int on_rack, int clamp_damping, int torque_mode,           \
      void *stream

#define QS_ENV_ARGS_FROM_PARAMS                                                 \
  qs::EnvArgs{pos, quat, lin_vel, ang_vel, q, qd, anchor, q_des, q_des_env,        \
          q_des_step, kp, kd, torque_limits, velocity_limits, rest, sign,      \
          spring_k, spring_b, friction, model, model_stride, ext_force,        \
          ext_stride, pos_out, quat_out, lin_vel_out, ang_vel_out, q_out,      \
          qd_out, anchor_out, tau_out, tau_m_out, tau_m_sum_out,               \
          foot_force_out, feet_in_contact_out, invalid_contact_out, n,         \
          substeps, on_rack, clamp_damping, torque_mode}

constexpr int kConstsFloats = static_cast<int>(sizeof(EnvConsts) / sizeof(float));

template <class Quad>
QS_FN void env_lane(const EnvConsts& k, const EnvArgs& a, int64_t env, int leg, Quad& quad) {
  // ---- what the launch reads once -----------------------------------------
  const float* mf = a.model + env * a.model_stride;
  Inertia trunk{mf[0], load3(mf + 1), load33(mf + 4)};
  LegBodies bodies;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* b = mf + kTrunkFloats + (3 * leg + j) * kBodyFloats;
    bodies.m[j] = b[0];
    bodies.c[j] = load3(b + 1);
    bodies.I[j] = inertia_at_com(b[0], bodies.c[j], load33(b + 4));
  }
  V3 hip = pick_leg(k.hip, leg), thigh = pick_leg(k.thigh, leg);
  V3 corner = pick_leg(k.corners, leg);
  V3 g = load3(k.gravity);
  V3 pos = load3(a.pos + 3 * env), lin_vel = load3(a.lin_vel + 3 * env);
  V3 ang_vel = load3(a.ang_vel + 3 * env);
  float quat[4] = {a.quat[4 * env], a.quat[4 * env + 1], a.quat[4 * env + 2],
                   a.quat[4 * env + 3]};
  const int64_t m0 = 12 * env + 3 * leg;   // this leg's first motor
  float q[3], qd[3], kp[3], kd[3], lim[3], vlim[3], rest[3], sign[3], sk[3], sb[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    q[j] = a.q[m0 + j];
    qd[j] = a.qd[m0 + j];
    kp[j] = a.torque_mode ? 0.0f : a.kp[3 * leg + j];
    kd[j] = a.torque_mode ? 0.0f : a.kd[3 * leg + j];
    lim[j] = a.torque_limits[3 * leg + j];
    vlim[j] = a.velocity_limits[3 * leg + j];
    rest[j] = a.rest[j];
    sign[j] = a.sign[3 * leg + j];
    sk[j] = a.spring_k[3 * env + j];
    sb[j] = a.spring_b[3 * env + j];
  }
  float anc_x = a.anchor[8 * env + 2 * leg], anc_y = a.anchor[8 * env + 2 * leg + 1];
  const float mu = a.friction[env];
  const bool has_ext = a.ext_force != nullptr;
  const V3 f_ext = has_ext ? load3(a.ext_force + env * a.ext_stride) : v3(0.0f, 0.0f, 0.0f);
  const bool clamp_damping = a.clamp_damping != 0;

  float tau[3], tau_m[3], tau_m_sum[3] = {0.0f, 0.0f, 0.0f};
  float foot_fn = 0.0f;
  bool foot_inc = false, other_inc = false;

  for (int r = 0; r < a.substeps; ++r) {
    // ---- actuation (ops/actuation.py; TORQUE: the clipped command plus the
    // springs through the law at zero gains) ---------------------------------
    const float* cmd = a.q_des + env * a.q_des_env + r * a.q_des_step + 3 * leg;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float c = cmd[j], t, tm;
      actuation_elem(c, q[j], qd[j], kp[j], kd[j], lim[j], sk[j], sb[j], rest[j], sign[j],
                     &t, &tm);
      if (a.torque_mode) {
        tm = clip(c, -lim[j], lim[j]);
        t = tm + t;
      }
      tau[j] = t;
      tau_m[j] = tm;
      tau_m_sum[j] = r == 0 ? tm : tau_m_sum[j] + tm;
    }

    // ---- the base's motion and the leg's articulated quantities -----------
    M3 R = quat_to_m3(quat);
    V3 w_b = mul_t(R, ang_vel), v_b = mul_t(R, lin_vel), g_b = mul_t(R, g);
    Leg L = leg_kinematics(k, hip, thigh, q, bodies);
    V3 f0t, f0b;
    float h[3];
    leg_bias(L, qd, w_b, v_b, g_b, &f0t, &f0b, h);

    // ---- contact at the foot (anchored), the knee and the trunk corner ----
    V3 knee = L.o[2];
    V3 foot_v = leg_point_velocity(L, qd, L.foot, w_b, v_b);
    V3 knee_v = leg_point_velocity(L, qd, knee, w_b, v_b);
    V3 corner_v = add(v_b, cross(w_b, corner));
    V3 pf = add(pos, mul(R, L.foot)), vf = mul(R, foot_v);
    V3 pk = add(pos, mul(R, knee)), vk = mul(R, knee_v);
    V3 pc = add(pos, mul(R, corner)), vc = mul(R, corner_v);
    V3 ff, fk, fc;
    float fn_k, fn_c;
    bool inc_k, inc_c;
    anchored_foot_elem(k.foot_radius - pf.z, vf.x, vf.y, vf.z, pf.x, pf.y, anc_x, anc_y, mu,
                       k.kn, k.dn, k.kt, k.ct, clamp_damping, &ff.x, &ff.y, &ff.z, &foot_fn,
                       &foot_inc, &anc_x, &anc_y);
    contact_elem(k.knee_radius - pk.z, vk.x, vk.y, vk.z, mu, k.kn, k.dn, k.v_tol,
                 clamp_damping, &fk.x, &fk.y, &fk.z, &fn_k, &inc_k);
    contact_elem(k.trunk_radius - pc.z, vc.x, vc.y, vc.z, mu, k.kn, k.dn, k.v_tol,
                 clamp_damping, &fc.x, &fc.y, &fc.z, &fn_c, &inc_c);
    other_inc = inc_k || inc_c;
    // world forces -> base wrench and the leg's joint torques
    V3 fbf = mul_t(R, ff), fbk = mul_t(R, fk), fbc = mul_t(R, fc);
    V3 tqf = cross(L.foot, fbf), tqk = cross(knee, fbk), tqc = cross(corner, fbc);
    V3 wrench_t = add(add(tqf, tqk), tqc), wrench_f = add(add(fbf, fbk), fbc);

    // ---- the leg's right-hand side and 3x3 block --------------------------
    float rhs[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float tau_c = dot6(L.sw[j], L.sv[j], tqf, fbf);
      tau_c = tau_c + dot6(L.sw[j], L.sv[j], tqk, fbk);
      rhs[j] = tau[j] + tau_c + joint_limit_torque(k, j, q[j], qd[j]) - h[j];
    }
    const float eps = 1e-9f;
    M3 Dinv = sym3_inv(leg_d(L, 0, 0), leg_d(L, 0, 1), leg_d(L, 0, 2), leg_d(L, 1, 1),
                       leg_d(L, 1, 2), leg_d(L, 2, 2), eps);

    float a0[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float qdd[3];
    if (a.on_rack) {
      // base welded in the air: a0 = 0 and the legs decouple
      V3 acc = mul(Dinv, v3(rhs[0], rhs[1], rhs[2]));
      qdd[0] = acc.x;
      qdd[1] = acc.y;
      qdd[2] = acc.z;
    } else {
      // ---- this leg's share of the base's Schur system, summed over legs ---
      float BDinv[6][3];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float s = leg_f(L, 0, i) * at(Dinv, 0, j);
          s = s + leg_f(L, 1, i) * at(Dinv, 1, j);
          BDinv[i][j] = s + leg_f(L, 2, i) * at(Dinv, 2, j);
        }
      float share[27];   // 21: the lower triangle of S's share; 6: t's
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int b = 0; b <= i; ++b) {
          float s = BDinv[i][0] * leg_f(L, 0, b);
          s = s + BDinv[i][1] * leg_f(L, 1, b);
          s = s + BDinv[i][2] * leg_f(L, 2, b);
          share[tri(i, b)] = inertia6(L.Ic1, i, b) - s;
        }
        float s = BDinv[i][0] * rhs[0];
        s = s + BDinv[i][1] * rhs[1];
        s = s + BDinv[i][2] * rhs[2];
        float c = i < 3 ? at(wrench_t, i) - at(f0t, i) : at(wrench_f, i - 3) - at(f0b, i - 3);
        share[21 + i] = c - s;
      }
      quad.sum(share);

      // ---- the base: trunk + the legs' shares, solved by every thread -----
      V3 ht, hb;
      trunk_bias(trunk, w_b, v_b, g_b, &ht, &hb);
      V3 fe = mul_t(R, f_ext);
      float S[21], t6[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int b = 0; b <= i; ++b) S[tri(i, b)] = inertia6(trunk, i, b) + share[tri(i, b)];
        float hi = i < 3 ? at(ht, i) : at(hb, i - 3);
        t6[i] = -hi + share[21 + i];
        if (has_ext && i >= 3) t6[i] = t6[i] + at(fe, i - 3);
      }
      chol6_solve(S, t6, eps, a0);
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

    // ---- semi-implicit Euler (dynamics.step) ------------------------------
    V3 w_new = add(w_b, scale(k.dt, v3(a0[0], a0[1], a0[2])));
    V3 v_new = add(v_b, scale(k.dt, v3(a0[3], a0[4], a0[5])));
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      qd[j] = clip(qd[j] + k.dt * qdd[j], -vlim[j], vlim[j]);
      q[j] = q[j] + k.dt * qd[j];
    }
    if (a.on_rack) {
      w_new = v3(0.0f, 0.0f, 0.0f);
      v_new = v3(0.0f, 0.0f, 0.0f);
    }
    quat_integrate(quat, w_new, k.half_dt, k.half_dt2);
    lin_vel = mul(R, v_new);
    ang_vel = mul(R, w_new);
    pos = add(pos, scale(k.dt, lin_vel));
  }

  // ---- outputs: each input was read once, each output is written once ----
  float any_other[1] = {other_inc ? 1.0f : 0.0f};
  quad.sum(any_other);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a.q_out[m0 + j] = q[j];
    a.qd_out[m0 + j] = qd[j];
    a.tau_out[m0 + j] = tau[j];
    a.tau_m_out[m0 + j] = tau_m[j];
    a.tau_m_sum_out[m0 + j] = tau_m_sum[j];
  }
  a.anchor_out[8 * env + 2 * leg] = anc_x;
  a.anchor_out[8 * env + 2 * leg + 1] = anc_y;
  a.foot_force_out[4 * env + leg] = foot_fn;
  a.feet_in_contact_out[4 * env + leg] = foot_inc;
  if (leg == 0) {
    a.invalid_contact_out[env] = any_other[0] > 0.0f;
    a.pos_out[3 * env] = pos.x;
    a.pos_out[3 * env + 1] = pos.y;
    a.pos_out[3 * env + 2] = pos.z;
    a.lin_vel_out[3 * env] = lin_vel.x;
    a.lin_vel_out[3 * env + 1] = lin_vel.y;
    a.lin_vel_out[3 * env + 2] = lin_vel.z;
    a.ang_vel_out[3 * env] = ang_vel.x;
    a.ang_vel_out[3 * env + 1] = ang_vel.y;
    a.ang_vel_out[3 * env + 2] = ang_vel.z;
#pragma unroll
    for (int i = 0; i < 4; ++i) a.quat_out[4 * env + i] = quat[i];
  }
}

}  // namespace qs
