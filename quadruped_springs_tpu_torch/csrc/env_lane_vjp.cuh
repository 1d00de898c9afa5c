// Reverse mode of env_lane.cuh: `lane_substep_vjp`, the adjoint of one leg's
// share of one substep (lane_substep<true, ...>: actuation, the anchored
// contact sites, the star solve and the Euler update), and `env_lane_vjp`,
// the env_substeps_vjp kernel's (env_step_vjp.cu) work for one leg of one
// environment over the R substeps of a control step. It gives the cotangents
// of a control step's inputs (the state, the anchors, the commands) from
// those of its float outputs: the adjoint of the JAX package's
// jax.value_and_grad through env.step (quadruped_springs_tpu/env/env.py
// :306-354) that scripts/train_backflip_landing_mlp.py:387 takes, whose
// plain PyTorch version is autograd through env/substeps.py
// env_substeps_plain.
//
// Layout: the forward's, four threads an environment, one a leg. The base's
// cotangents are held alike by the four threads, as the base's values are in
// the forward: what only the base reads (the Euler update, the quaternion,
// the 6x6 solve, the trunk's bias) is differentiated by every thread alike,
// and what a leg adds to a base quantity's cotangent (its share of the
// accelerations' cotangent, of the rotation's, the base velocities', gravity
// in the base frame and the position's) is summed over the four with the
// forward's `Quad` in its fixed order, so every thread again holds the same
// sum bitwise. The adjoint of the forward's sum of the legs' Schur shares
// hands every leg the base's cotangent.
//
// Design: re-run the R substeps from the inputs with the forward's own
// lane_substep<true, true> (so the states are the forward's bitwise),
// storing each substep's start (the base's 13 floats, the leg's q, qd and
// anchor: 21 floats a thread) in a scratch buffer; then sweep r = R-1 .. 0,
// recompute substep r's intermediates from its start with the IEEE
// operators (the values the forward's CheckedOps vouch for) and propagate
// the cotangent back through it.

#pragma once

#include "env_lane.cuh"
#include "go1_dynamics_vjp.cuh"

namespace qs {

constexpr int kVjpScratchFloats = 21;   // env/substeps.py VJP_SCRATCH_FLOATS

struct EnvVjpArgs {
  // cotangents of the float outputs (each may be null: zero), in the
  // outputs' layouts
  const float *g_pos, *g_quat, *g_lin_vel, *g_ang_vel, *g_q, *g_qd, *g_anchor, *g_tau,
      *g_tau_m, *g_tau_m_sum, *g_foot_force;
  // cotangents of the inputs, in the inputs' layouts (d_q_des as q_des:
  // (N,R,12), or (N,12) summed over the substeps)
  float *d_pos, *d_quat, *d_lin_vel, *d_ang_vel, *d_q, *d_qd, *d_anchor, *d_q_des;
  float* scratch;   // (4N, substeps, kVjpScratchFloats)
};

#define QS_ENV_VJP_PARAMS                                                         \
  const float *g_pos, const float *g_quat, const float *g_lin_vel,                \
      const float *g_ang_vel, const float *g_q, const float *g_qd,                \
      const float *g_anchor, const float *g_tau, const float *g_tau_m,            \
      const float *g_tau_m_sum, const float *g_foot_force, float *d_pos,          \
      float *d_quat, float *d_lin_vel, float *d_ang_vel, float *d_q, float *d_qd, \
      float *d_anchor, float *d_q_des, float *scratch

#define QS_ENV_VJP_ARGS_FROM_PARAMS                                                  \
  qs::EnvVjpArgs{g_pos, g_quat, g_lin_vel, g_ang_vel, g_q, g_qd, g_anchor, g_tau,     \
                 g_tau_m, g_tau_m_sum, g_foot_force, d_pos, d_quat, d_lin_vel,       \
                 d_ang_vel, d_q, d_qd, d_anchor, d_q_des, scratch}

// the cotangent of a thread's state: the base's (alike in the four threads)
// and its leg's
struct LaneGrad {
  V3 pos, lin_vel, ang_vel;
  float quat[4];
  float q[3], qd[3];
  float anc_x, anc_y;
};

// The adjoint of lane_substep<true, ...> from the state s and anchor (anc_x,
// anc_y) at the substep's start: g holds the cotangent of the state and
// anchor after the substep and leaves with that of the state and anchor
// before it; g_tau, g_tau_m and g_foot_fn are the cotangents of the
// substep's torques and foot normal force; g_cmd gets that of the command.
template <class Quad>
QS_FN void lane_substep_vjp(const EnvConsts& k, const LegModel& c, const float* cmd,
                            bool torque_mode, bool on_rack, bool clamp_damping, bool has_ext,
                            const V3& f_ext, const LaneState& s, float anc_x, float anc_y,
                            LaneGrad& g, const float* g_tau, const float* g_tau_m,
                            float g_foot_fn, float* g_cmd, Quad& quad) {
  // ==== the substep's forward, recomputed ====================================
  QS_RECOMPUTE(true);
  float tau[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float t, tm;
    actuation_elem(cmd[j], s.q[j], s.qd[j], c.kp[j], c.kd[j], c.lim[j], c.sk[j], c.sb[j],
                   c.rest[j], c.sign[j], &t, &tm);
    if (torque_mode) t = clip(cmd[j], -c.lim[j], c.lim[j]) + t;
    tau[j] = t;
  }
  const M3 R = quat_to_m3(s.quat);
  const V3 w_b = mul_t(R, s.ang_vel), v_b = mul_t(R, s.lin_vel), g_b = mul_t(R, c.g);
  const Leg L = leg_kinematics(k, c.hip, c.thigh, s.q, c.bodies);
  V3 f0t, f0b;
  float h[3];
  leg_bias(L, s.qd, w_b, v_b, g_b, &f0t, &f0b, h);
  const V3 knee = L.o[2];
  const V3 foot_v = leg_point_velocity(L, s.qd, L.foot, w_b, v_b);
  const V3 knee_v = leg_point_velocity(L, s.qd, knee, w_b, v_b);
  const V3 corner_v = add(v_b, cross(w_b, c.corner));
  const V3 pf = add(s.pos, mul(R, L.foot)), vf = mul(R, foot_v);
  const V3 pk = add(s.pos, mul(R, knee)), vk = mul(R, knee_v);
  const V3 pc = add(s.pos, mul(R, c.corner)), vc = mul(R, corner_v);
  IeeeOps ieee;
  const Sites sites = contact_sites<true>(k, c.mu, clamp_damping, pf, vf, pk, vk, pc, vc, anc_x,
                                          anc_y, ieee);
  const V3 fbf = mul_t(R, sites.ff), fbk = mul_t(R, sites.fk), fbc = mul_t(R, sites.fc);
  const V3 tqf = cross(L.foot, fbf), tqk = cross(knee, fbk);
  float rhs[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float tau_c = dot6(L.sw[j], L.sv[j], tqf, fbf);
    tau_c = tau_c + dot6(L.sw[j], L.sv[j], tqk, fbk);
    rhs[j] = tau[j] + tau_c + joint_limit_torque(k, j, s.q[j], s.qd[j]) - h[j];
  }
  const float eps = 1e-9f;
  const float dd[6] = {leg_d(L, 0, 0), leg_d(L, 0, 1), leg_d(L, 0, 2),
                       leg_d(L, 1, 1), leg_d(L, 1, 2), leg_d(L, 2, 2)};
  const M3 Dinv = sym3_inv(dd[0], dd[1], dd[2], dd[3], dd[4], dd[5], eps);
  float a0[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float BDinv[6][3], S[21], t6[6];
  V3 rj = v3(rhs[0], rhs[1], rhs[2]);
  if (!on_rack) {
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float sum = leg_f(L, 0, i) * at(Dinv, 0, j);
        sum = sum + leg_f(L, 1, i) * at(Dinv, 1, j);
        BDinv[i][j] = sum + leg_f(L, 2, i) * at(Dinv, 2, j);
      }
    float share[27];
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
      const V3 wrench_t = add(add(tqf, tqk), cross(c.corner, fbc));
      const V3 wrench_f = add(add(fbf, fbk), fbc);
      float f = i < 3 ? at(wrench_t, i) - at(f0t, i) : at(wrench_f, i - 3) - at(f0b, i - 3);
      share[21 + i] = f - sum;
    }
    quad.sum(share);
    V3 ht, hb;
    trunk_bias(c.trunk, w_b, v_b, g_b, &ht, &hb);
    const V3 fe = mul_t(R, f_ext);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int b = 0; b <= i; ++b) S[tri(i, b)] = inertia6(c.trunk, i, b) + share[tri(i, b)];
      float hi = i < 3 ? at(ht, i) : at(hb, i - 3);
      t6[i] = -hi + share[21 + i];
      if (has_ext && i >= 3) t6[i] = t6[i] + at(fe, i - 3);
    }
    chol6_solve(S, t6, eps, a0);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      set(rj, j, rhs[j] - dot6(L.Ft[j], L.Fb[j], v3(a0[0], a0[1], a0[2]),
                               v3(a0[3], a0[4], a0[5])));
  }
  const V3 qdd = mul(Dinv, rj);
  V3 w_new = add(w_b, scale(k.dt, v3(a0[0], a0[1], a0[2])));
  V3 v_new = add(v_b, scale(k.dt, v3(a0[3], a0[4], a0[5])));
  if (on_rack) w_new = v_new = zero3();
  QS_RECOMPUTE(false);

  // ==== the adjoint ===========================================================
  // the base's update: pos' = pos + dt lin_vel', lin_vel' = R v_new,
  // ang_vel' = R w_new, quat' = quat_integrate(quat, w_new)
  QS_BASE_WORK(true);
  V3 g_pos = g.pos;
  const V3 g_lv = add(g.lin_vel, scale(k.dt, g.pos));
  M3 gR = zero33();
  V3 g_vnew = zero3(), g_wnew = zero3();
  mul_vjp(R, v_new, g_lv, gR, g_vnew);
  mul_vjp(R, w_new, g.ang_vel, gR, g_wnew);
  float g_quat[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  quat_integrate_vjp(s.quat, w_new, k.half_dt, k.half_dt2, g.quat, g_quat, g_wnew);
  if (on_rack) g_wnew = g_vnew = zero3();
  QS_BASE_WORK(false);
  // the joints: q' = q + dt qd', qd' = min(max(qd + dt qdd, -vlim), vlim)
  float g_q[3], g_qd[3];
  V3 g_qdd = zero3();
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g_q[j] = g.q[j];
    const float x = s.qd[j] + k.dt * at(qdd, j);
    const float gx = (g.qd[j] + k.dt * g.q[j]) * minmax_pass(x, -c.vlim[j], c.vlim[j]);
    g_qd[j] = gx;
    set(g_qdd, j, k.dt * gx);
  }
  // w_new = w_b + dt a0_w, v_new = v_b + dt a0_v
  V3 g_wb = g_wnew, g_vb = g_vnew, g_gb = zero3();
  LegGrad gL = zero_leg_grad();
  M3 g_Dinv = zero33();
  V3 g_rhs = zero3();
  float g_share[27];
  V3 g_rj = zero3();
  mul_vjp(Dinv, rj, g_qdd, g_Dinv, g_rj);
  if (on_rack) {
    g_rhs = g_rj;   // qdd = Dinv rhs
#pragma unroll
    for (int i = 0; i < 27; ++i) g_share[i] = 0.0f;
  } else {
    // rj = rhs - F_jᵀ a0; this leg's share of a0's cotangent, summed
    float g_a0[6];
    const V3 a0t = v3(a0[0], a0[1], a0[2]), a0b = v3(a0[3], a0[4], a0[5]);
#pragma unroll
    for (int i = 0; i < 6; ++i) g_a0[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float gr = at(g_rj, j);
      add_at(g_rhs, j, gr);
      acc(gL.Ft[j], scale(-gr, a0t));
      acc(gL.Fb[j], scale(-gr, a0b));
#pragma unroll
      for (int i = 0; i < 6; ++i) g_a0[i] -= gr * leg_f(L, j, i);
    }
    quad.sum(g_a0);
    QS_BASE_WORK(true);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_a0[i] += k.dt * at(g_wnew, i);
      g_a0[i + 3] += k.dt * at(g_vnew, i);
    }
    // a0 = (S + eps E)⁻¹ t6; S = trunk + Σ shares, t6 = -trunk bias + Σ
    // shares (+ Rᵀ f_ext): every leg's share gets S's and t6's cotangent
    chol6_solve_vjp(S, t6, eps, g_a0, g_share, g_share + 21);
    const V3 gt_top = v3(g_share[21], g_share[22], g_share[23]);
    const V3 gt_bot = v3(g_share[24], g_share[25], g_share[26]);
    trunk_bias_vjp(c.trunk, w_b, v_b, g_b, scale(-1.0f, gt_top), scale(-1.0f, gt_bot), g_wb,
                   g_vb, g_gb);
    if (has_ext) acc(gR, outer(f_ext, gt_bot));   // fe = Rᵀ f_ext
    QS_BASE_WORK(false);
    // this leg's share: S_ib -= Σ_j BDinv_ij F_j[b] (+ Ic1), t_i = f_i -
    // Σ_j BDinv_ij rhs_j, BDinv_ij = Σ_m F_m[i] Dinv_mj
    float g_BDinv[6][3];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) g_BDinv[i][j] = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int b = 0; b <= i; ++b) {
        const float gs = g_share[tri(i, b)];
        inertia6_vjp(i, b, gs, gL.Ic1);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          g_BDinv[i][j] -= gs * leg_f(L, j, b);
          if (b < 3) add_at(gL.Ft[j], b, -gs * BDinv[i][j]);
          else add_at(gL.Fb[j], b - 3, -gs * BDinv[i][j]);
        }
      }
      const float gs = g_share[21 + i];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        g_BDinv[i][j] -= gs * rhs[j];
        add_at(g_rhs, j, -gs * BDinv[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          if (i < 3) add_at(gL.Ft[m], i, g_BDinv[i][j] * at(Dinv, m, j));
          else add_at(gL.Fb[m], i - 3, g_BDinv[i][j] * at(Dinv, m, j));
          add_at(g_Dinv, m, j, leg_f(L, m, i) * g_BDinv[i][j]);
        }
  }
  // Dinv = (D + eps E)⁻¹, D_ij = s_i · F_j (j >= i)
  float gd[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  sym3_inv_vjp(dd[0], dd[1], dd[2], dd[3], dd[4], dd[5], eps, g_Dinv, gd);
  {
    int e = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j, ++e)
        dot6_vjp(L.sw[i], L.sv[i], L.Ft[j], L.Fb[j], gd[e], gL.sw[i], gL.sv[i], gL.Ft[j],
                 gL.Fb[j]);
  }
  // rhs_j = tau_j + s_j · [tqf; fbf] + s_j · [tqk; fbk] + joint limit - h_j
  float g_tau_all[3], g_h[3];
  V3 g_tqf = zero3(), g_fbf = zero3(), g_tqk = zero3(), g_fbk = zero3();
  V3 g_tqc = zero3(), g_fbc = zero3();
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float gr = at(g_rhs, j);
    g_tau_all[j] = g_tau[j] + gr;
    g_h[j] = -gr;
    joint_limit_torque_vjp(k, j, s.q[j], s.qd[j], gr, &g_q[j], &g_qd[j]);
    dot6_vjp(L.sw[j], L.sv[j], tqf, fbf, gr, gL.sw[j], gL.sv[j], g_tqf, g_fbf);
    dot6_vjp(L.sw[j], L.sv[j], tqk, fbk, gr, gL.sw[j], gL.sv[j], g_tqk, g_fbk);
  }
  // the share's f = wrench - f0, wrench = Σ_sites [p × f_b; f_b]
  const V3 gw_t = v3(g_share[21], g_share[22], g_share[23]);
  const V3 gw_f = v3(g_share[24], g_share[25], g_share[26]);
  acc(g_tqf, gw_t);
  acc(g_tqk, gw_t);
  acc(g_tqc, gw_t);
  acc(g_fbf, gw_f);
  acc(g_fbk, gw_f);
  acc(g_fbc, gw_f);
  const V3 g_f0t = scale(-1.0f, gw_t), g_f0b = scale(-1.0f, gw_f);
  V3 g_knee = zero3(), unused = zero3();
  cross_vjp(L.foot, fbf, g_tqf, gL.foot, g_fbf);
  cross_vjp(knee, fbk, g_tqk, g_knee, g_fbk);
  cross_vjp(c.corner, fbc, g_tqc, unused, g_fbc);
  // f_b = Rᵀ f_world: the leg's shares of R's cotangent
  M3 gR_leg = zero33();
  V3 g_ff = zero3(), g_fk = zero3(), g_fc = zero3();
  mul_t_vjp(R, sites.ff, g_fbf, gR_leg, g_ff);
  mul_t_vjp(R, sites.fk, g_fbk, gR_leg, g_fk);
  mul_t_vjp(R, sites.fc, g_fbc, gR_leg, g_fc);
  // the contact sites
  V3 g_pf = zero3(), g_vf = zero3(), g_pk = zero3(), g_vk = zero3(), g_pc = zero3(),
     g_vc = zero3();
  float g_phi = 0.0f, g_anc_x = 0.0f, g_anc_y = 0.0f;
  anchored_foot_elem_vjp(k.foot_radius - pf.z, vf.x, vf.y, vf.z, pf.x, pf.y, anc_x, anc_y, c.mu,
                         k.kn, k.dn, k.kt, k.ct, clamp_damping, g_ff.x, g_ff.y,
                         g_ff.z + g_foot_fn, g.anc_x, g.anc_y, &g_phi, &g_vf.x, &g_vf.y,
                         &g_vf.z, &g_pf.x, &g_pf.y, &g_anc_x, &g_anc_y);
  g_pf.z -= g_phi;
  g_phi = 0.0f;
  contact_elem_vjp(k.knee_radius - pk.z, vk.x, vk.y, vk.z, c.mu, k.kn, k.dn, k.v_tol,
                   clamp_damping, g_fk.x, g_fk.y, g_fk.z, &g_phi, &g_vk.x, &g_vk.y, &g_vk.z);
  g_pk.z -= g_phi;
  g_phi = 0.0f;
  contact_elem_vjp(k.trunk_radius - pc.z, vc.x, vc.y, vc.z, c.mu, k.kn, k.dn, k.v_tol,
                   clamp_damping, g_fc.x, g_fc.y, g_fc.z, &g_phi, &g_vc.x, &g_vc.y, &g_vc.z);
  g_pc.z -= g_phi;
  // the sites' world positions and velocities
  V3 g_pos_leg = add(add(g_pf, g_pk), g_pc);
  V3 g_footv = zero3(), g_kneev = zero3(), g_cornerv = zero3();
  mul_vjp(R, L.foot, g_pf, gR_leg, gL.foot);
  mul_vjp(R, foot_v, g_vf, gR_leg, g_footv);
  mul_vjp(R, knee, g_pk, gR_leg, g_knee);
  mul_vjp(R, knee_v, g_vk, gR_leg, g_kneev);
  mul_vjp(R, c.corner, g_pc, gR_leg, unused);
  mul_vjp(R, corner_v, g_vc, gR_leg, g_cornerv);
  V3 g_wb_leg = zero3(), g_vb_leg = g_cornerv, g_gb_leg = zero3();
  cross_vjp(w_b, c.corner, g_cornerv, g_wb_leg, unused);
  leg_point_velocity_vjp(L, s.qd, knee, w_b, g_kneev, g_qd, g_knee, gL, g_wb_leg, g_vb_leg);
  leg_point_velocity_vjp(L, s.qd, L.foot, w_b, g_footv, g_qd, gL.foot, gL, g_wb_leg, g_vb_leg);
  acc(gL.o[2], g_knee);
  // the leg's bias force and kinematics
  leg_bias_vjp(L, s.qd, w_b, v_b, g_b, g_f0t, g_f0b, g_h, gL, g_qd, g_wb_leg, g_vb_leg,
               g_gb_leg);
  leg_kinematics_vjp(k, c.thigh, s.q, c.bodies, L, gL, g_q);
  // the four legs' shares of the base's cotangents, summed
  float base[21];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) base[3 * i + j] = at(gR_leg, i, j);
    base[9 + i] = at(g_wb_leg, i);
    base[12 + i] = at(g_vb_leg, i);
    base[15 + i] = at(g_gb_leg, i);
    base[18 + i] = at(g_pos_leg, i);
  }
  quad.sum(base);
  QS_BASE_WORK(true);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) add_at(gR, i, j, base[3 * i + j]);
    add_at(g_wb, i, base[9 + i]);
    add_at(g_vb, i, base[12 + i]);
    add_at(g_gb, i, base[15 + i]);
    add_at(g_pos, i, base[18 + i]);
  }
  // w_b = Rᵀ ang_vel, v_b = Rᵀ lin_vel, g_b = Rᵀ g, R = R(quat)
  V3 g_av = zero3(), g_lv0 = zero3();
  mul_t_vjp(R, s.ang_vel, g_wb, gR, g_av);
  mul_t_vjp(R, s.lin_vel, g_vb, gR, g_lv0);
  mul_t_vjp(R, c.g, g_gb, gR, unused);
  quat_to_m3_vjp(s.quat, gR, g_quat);
  QS_BASE_WORK(false);
  // actuation (TORQUE: the clipped command plus the springs' law at zero
  // gains, whose motor torque is not used)
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    actuation_elem_vjp(cmd[j], s.q[j], s.qd[j], c.kp[j], c.kd[j], c.lim[j], c.sk[j], c.sb[j],
                       c.rest[j], c.sign[j], g_tau_all[j], torque_mode ? 0.0f : g_tau_m[j],
                       &g_cmd[j], &g_q[j], &g_qd[j]);
    if (torque_mode)
      g_cmd[j] += (g_tau_all[j] + g_tau_m[j]) * minmax_pass(cmd[j], -c.lim[j], c.lim[j]);
  }
  g.pos = g_pos;
  g.lin_vel = g_lv0;
  g.ang_vel = g_av;
#pragma unroll
  for (int i = 0; i < 4; ++i) g.quat[i] = g_quat[i];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.q[j] = g_q[j];
    g.qd[j] = g_qd[j];
  }
  g.anc_x = g_anc_x;
  g.anc_y = g_anc_y;
}

QS_FN float load_or_zero(const float* p, int64_t i) { return p == nullptr ? 0.0f : p[i]; }
QS_FN V3 load3_or_zero(const float* p, int64_t i) {
  return p == nullptr ? zero3() : load3(p + i);
}

template <class Quad>
QS_FN void env_lane_vjp(const EnvConsts& k, const EnvArgs& a, const EnvVjpArgs& v, int64_t env,
                        int leg, Quad& quad) {
  const LegModel c = scenario_leg_model(k, a, env, leg);
  LaneState s;
  s.pos = load3(a.pos + 3 * env);
  s.lin_vel = load3(a.lin_vel + 3 * env);
  s.ang_vel = load3(a.ang_vel + 3 * env);
#pragma unroll
  for (int i = 0; i < 4; ++i) s.quat[i] = a.quat[4 * env + i];
  const int64_t m0 = 12 * env + 3 * leg;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s.q[j] = a.q[m0 + j];
    s.qd[j] = a.qd[m0 + j];
  }
  float anc_x = a.anchor[8 * env + 2 * leg], anc_y = a.anchor[8 * env + 2 * leg + 1];
  const bool has_ext = a.ext_force != nullptr;
  const V3 f_ext = has_ext ? load3(a.ext_force + env * a.ext_stride) : zero3();
  const bool torque_mode = a.torque_mode != 0, on_rack = a.on_rack != 0;
  const bool clamp_damping = a.clamp_damping != 0;
  float* scr = v.scratch + (4 * env + leg) * a.substeps * kVjpScratchFloats;

  // ---- the forward again, each substep's start kept ------------------------
  SubstepOut o = {};
  for (int r = 0; r < a.substeps; ++r) {
    float* p = scr + r * kVjpScratchFloats;
    p[0] = s.pos.x; p[1] = s.pos.y; p[2] = s.pos.z;
    p[3] = s.quat[0]; p[4] = s.quat[1]; p[5] = s.quat[2]; p[6] = s.quat[3];
    p[7] = s.lin_vel.x; p[8] = s.lin_vel.y; p[9] = s.lin_vel.z;
    p[10] = s.ang_vel.x; p[11] = s.ang_vel.y; p[12] = s.ang_vel.z;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p[13 + j] = s.q[j];
      p[16 + j] = s.qd[j];
    }
    p[19] = anc_x;
    p[20] = anc_y;
    const float* cmd = a.q_des + env * a.q_des_env + r * a.q_des_step + 3 * leg;
    lane_substep<true, true>(k, c, cmd, torque_mode, on_rack, clamp_damping, has_ext, f_ext, s,
                             anc_x, anc_y, o, quad);
  }

  // ---- the cotangents of the outputs ---------------------------------------
  LaneGrad g;
  g.pos = load3_or_zero(v.g_pos, 3 * env);
  g.lin_vel = load3_or_zero(v.g_lin_vel, 3 * env);
  g.ang_vel = load3_or_zero(v.g_ang_vel, 3 * env);
#pragma unroll
  for (int i = 0; i < 4; ++i) g.quat[i] = load_or_zero(v.g_quat, 4 * env + i);
  float g_tau_last[3], g_tau_m_last[3], g_tau_m_sum[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.q[j] = load_or_zero(v.g_q, m0 + j);
    g.qd[j] = load_or_zero(v.g_qd, m0 + j);
    g_tau_last[j] = load_or_zero(v.g_tau, m0 + j);
    g_tau_m_last[j] = load_or_zero(v.g_tau_m, m0 + j);
    g_tau_m_sum[j] = load_or_zero(v.g_tau_m_sum, m0 + j);
  }
  g.anc_x = load_or_zero(v.g_anchor, 8 * env + 2 * leg);
  g.anc_y = load_or_zero(v.g_anchor, 8 * env + 2 * leg + 1);
  const float g_fn_last = load_or_zero(v.g_foot_force, 4 * env + leg);

  // ---- the sweep back over the substeps --------------------------------------
  float g_cmd_held[3] = {0.0f, 0.0f, 0.0f};
  for (int r = a.substeps - 1; r >= 0; --r) {
    const float* p = scr + r * kVjpScratchFloats;
    LaneState s0;
    s0.pos = v3(p[0], p[1], p[2]);
#pragma unroll
    for (int i = 0; i < 4; ++i) s0.quat[i] = p[3 + i];
    s0.lin_vel = v3(p[7], p[8], p[9]);
    s0.ang_vel = v3(p[10], p[11], p[12]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s0.q[j] = p[13 + j];
      s0.qd[j] = p[16 + j];
    }
    const bool last = r == a.substeps - 1;
    float g_tau[3], g_tau_m[3], g_cmd[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_tau[j] = last ? g_tau_last[j] : 0.0f;
      g_tau_m[j] = last ? g_tau_m_sum[j] + g_tau_m_last[j] : g_tau_m_sum[j];
    }
    const float* cmd = a.q_des + env * a.q_des_env + r * a.q_des_step + 3 * leg;
    lane_substep_vjp(k, c, cmd, torque_mode, on_rack, clamp_damping, has_ext, f_ext, s0, p[19],
                     p[20], g, g_tau, g_tau_m, last ? g_fn_last : 0.0f, g_cmd, quad);
    if (a.q_des_step == 0) {
#pragma unroll
      for (int j = 0; j < 3; ++j) g_cmd_held[j] += g_cmd[j];
    } else {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        v.d_q_des[env * a.q_des_env + r * a.q_des_step + 3 * leg + j] = g_cmd[j];
    }
  }

  // ---- the cotangents of the inputs ------------------------------------------
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    v.d_q[m0 + j] = g.q[j];
    v.d_qd[m0 + j] = g.qd[j];
    if (a.q_des_step == 0) v.d_q_des[env * a.q_des_env + 3 * leg + j] = g_cmd_held[j];
  }
  v.d_anchor[8 * env + 2 * leg] = g.anc_x;
  v.d_anchor[8 * env + 2 * leg + 1] = g.anc_y;
  if (leg == 0) {
    v.d_pos[3 * env] = g.pos.x;
    v.d_pos[3 * env + 1] = g.pos.y;
    v.d_pos[3 * env + 2] = g.pos.z;
    v.d_lin_vel[3 * env] = g.lin_vel.x;
    v.d_lin_vel[3 * env + 1] = g.lin_vel.y;
    v.d_lin_vel[3 * env + 2] = g.lin_vel.z;
    v.d_ang_vel[3 * env] = g.ang_vel.x;
    v.d_ang_vel[3 * env + 1] = g.ang_vel.y;
    v.d_ang_vel[3 * env + 2] = g.ang_vel.z;
#pragma unroll
    for (int i = 0; i < 4; ++i) v.d_quat[4 * env + i] = g.quat[i];
  }
}

}  // namespace qs
