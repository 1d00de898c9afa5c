// Reverse mode of env_lane.cuh: `env_block_vjp`, the env_substeps_vjp
// kernel's (env_step_vjp.cu) work for one block of kVjpEnvs environments
// over the R substeps of a control step. It gives the cotangents of a
// control step's inputs (the state, the anchors, the commands) from those of
// its float outputs: the adjoint of the JAX package's jax.value_and_grad
// through env.step (quadruped_springs_tpu/env/env.py :306-354) that
// scripts/train_backflip_landing_mlp.py:387 takes, whose plain PyTorch
// version is autograd through env/substeps.py env_substeps_plain.
//
// A block is kVjpWarps warps. A warp's 32 lanes are the block's (environment,
// leg) slots, slot = 4 e + leg, as the forward's lanes; each phase gives each
// warp one role over those slots:
//  - the re-run: warp 0 runs the R substeps from the inputs with the
//    forward's own lane_substep<true, true> (so the states are the forward's
//    bitwise), keeping each substep's start (the base's 13 floats, the leg's
//    q, qd and anchor: 21 floats a slot) in a scratch buffer;
//  - the recompute: the substeps are swept back in chunks of at most
//    kVjpWarps - 1 (as many as the block's shared memory holds); each
//    substep of a chunk is recomputed from its start by a warp of its own,
//    all at once (the last chunk's by warps 1 .., each as soon as the re-run
//    has kept its start), and what the adjoint reads of it is left in shared
//    memory (LegRec a slot, BaseRec an environment: the leg's kinematics and
//    Schur share, its sites, the 6x6 factor, the quaternion's update);
//  - the sweep, r = R-1 .. 0, six stages a substep between block barriers:
//    (1) the joints' update and the leg's share of the base acceleration's
//    cotangent (warp 0, a slot a lane) beside the base's update (warp 1, an
//    environment a lane); (2) the sum over the legs and the 6x6 solve's
//    adjoint, once an environment (warp 1), beside the forwards stage 3 and
//    4 read (the leg's bias force, warp 2; its joints' rotations, warp 3);
//    (3) the leg's Schur share and 3x3 block (warp 0) beside its right-hand
//    side and contact sites (warp 2) and its bias force (warp 3); (4) the
//    leg's kinematics, a joint's column a warp (warps 0, 2, 3), beside the
//    sum of the legs' shares of the base's cotangent and the base's rotation
//    (warp 1); (5) a body's inertia a warp; (6) the kinematics' chain to the
//    joint angles and actuation (warp 0).
// What passes from stage to stage lies in shared memory (LegEx, BaseEx).
//
// Every operation is the one the first version's body (one thread a leg, the
// four legs' sums by shuffles) did, in its order, on the same values: the sums over the
// legs in the fixed order (v0 + v1) + (v2 + v3); where two warps run beside
// each other, the one's additions to a cotangent the other also adds to are
// handed over and added in the old order (leg_bias_vjp's). No operation reads
// another environment's values, and the shape of the launch (the chunk) only
// moves when a substep is recomputed, not what is computed: a row's answer
// depends on neither.
//
// Blk runs the phases: each(f) calls f(thread) for each thread of the block,
// quads(warps, f) f(thread, quad) for each thread of the first `warps`
// warps, quad summing over the thread's group of four lanes (the re-run's and
// the recompute's Schur shares), sync() the block barrier, arrive(id) and
// wait(id) a barrier between warp 0 and one other warp. The kernel's
// DevBlock runs them on the block's threads; the host builds of tests/
// (env_vjp_host_block.h) run them thread by thread, each group of four on
// four host threads.

#pragma once

#include <stddef.h>

#include "env_lane.cuh"
#include "go1_dynamics_vjp.cuh"

// the launch's sizes, for the launcher (host) and the body
#if defined(__CUDACC__)
#define QS_HD __host__ __device__ __forceinline__
#else
#define QS_HD inline
#endif

namespace qs {

constexpr int kVjpScratchFloats = 21;   // env/substeps.py VJP_SCRATCH_FLOATS
constexpr int kVjpEnvs = 8;             // environments a block
constexpr int kVjpSlots = 4 * kVjpEnvs; // (environment, leg) slots: a warp's lanes
constexpr int kVjpWarps = 8;
constexpr int kVjpThreads = 32 * kVjpWarps;

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

// What the sweep reads of a slot's substep, recomputed (strides of an odd
// number of floats: a warp reading one field touches 32 banks)
struct LegRec {
  Leg L;
  M3 Dinv;
  float BDinv[6][3];
  float dd[6], rhs[3], pass[3];   // pass: d qd' / d (qd + dt qdd), the clip's
  V3 rj;
  V3 tqf, fbf, tqk, fbk, fbc;     // the sites' forces in the base frame, torques
  V3 ff, fk, fc;                  // the sites' world forces
  V3 pf, vf, pk, vk, pc, vc;      // the sites' world positions and velocities
  V3 foot_v, knee_v, corner_v;    // their velocities in the base frame
  Inertia Ic2;                    // leg_kinematics's I1 + I2
};

// ... and of an environment's
struct BaseRec {
  M3 R;
  V3 w_b, v_b, g_b, w_new, v_new;
  float a0[6];
  Chol6Fwd chol;
  QuatIntFwd qi;
};

// The cotangent of the block's state and what passes between the sweep's
// stages: a slot's ...
struct LegEx {
  float gq[3], gqd[3], ganc[2];   // the leg's state and anchor (carried)
  float g_cmd_held[3];            // a held command's, summed over the substeps
  float g_a0[6];                  // (1) -> (2)
  M3 g_Dinv;                      // (1) -> (3)
  V3 g_rhs;                       // (1) -> (3)
  V3 g_rhs_all;                   // (3) -> (4), (6): with the Schur share's
  LegGrad gL;                     // (1), (3), (4), (5) -> (6)
  M3 gR_leg;                      // (3) -> (4): the leg's shares of the base's
  V3 g_wb_leg, g_vb_leg, g_pos_leg;
  float gqd_a[3], gqd_v[3];       // (3) -> (6): leg_bias_vjp's additions
  V3 gvw, gvv, gav;               // (3) -> (4)
  LegBiasTerms bias_terms;        // (3) -> (4)
  InertiaGrad gIc2;               // (4) -> (5)
  M3 gRb[3];                      // (5) -> (6): the bodies' rotations'
};

// The forwards that stage (2) computes for stages (3) to (6) of the
// substep at hand, a slot's (strides of an odd number of floats)
struct BiasSlot {
  LegBiasFwd f;
  float pad;
};
struct KinSlot {
  LegKinFwd f;
  float pad;
};

// ... and an environment's
struct BaseEx {
  V3 g_pos, g_lin_vel, g_ang_vel;   // the base's state (carried)
  float g_quat[4];
  float g_quat_new[4];              // (1) -> (4)
  M3 gR;                            // (1) -> (2) -> (4)
  V3 g_wnew, g_vnew;                // (1) -> (2)
  float g_share[27];                // (2) -> (3): the legs' Schur shares'
  V3 g_wb, g_vb, g_gb;              // (2) -> (4)
};

// A block's shared memory: the slots' models and cotangents, the
// environments' cotangents, then `chunk` substeps' records
struct VjpShared {
  LegModel* model;   // [kVjpSlots]
  LegEx* lex;        // [kVjpSlots]
  BiasSlot* bias;    // [kVjpSlots]
  KinSlot* kin;      // [kVjpSlots]
  BaseEx* bex;       // [kVjpEnvs]
  LegRec* leg;       // [chunk][kVjpSlots]
  BaseRec* base;     // [chunk][kVjpEnvs]
};

QS_HD size_t vjp_fixed_bytes() {
  return kVjpSlots * (sizeof(LegModel) + sizeof(LegEx) + sizeof(BiasSlot) + sizeof(KinSlot)) +
         kVjpEnvs * sizeof(BaseEx);
}
QS_HD size_t vjp_substep_bytes() {
  return kVjpSlots * sizeof(LegRec) + kVjpEnvs * sizeof(BaseRec);
}
// the substeps a chunk holds within `bytes` of shared memory a block (at
// most kVjpWarps - 1: one recompute a warp beside the re-run's), or 0 where
// not one fits
QS_HD int vjp_chunk(int substeps, size_t bytes) {
  if (bytes < vjp_fixed_bytes() + vjp_substep_bytes()) return 0;
  const size_t fit = (bytes - vjp_fixed_bytes()) / vjp_substep_bytes();
  int c = substeps < kVjpWarps - 1 ? substeps : kVjpWarps - 1;
  return fit < static_cast<size_t>(c) ? static_cast<int>(fit) : c;
}
QS_HD size_t vjp_shared_bytes(int chunk) {
  return vjp_fixed_bytes() + static_cast<size_t>(chunk) * vjp_substep_bytes();
}
QS_FN VjpShared vjp_shared(void* smem, int chunk) {
  char* p = static_cast<char*>(smem);
  VjpShared s;
  s.model = reinterpret_cast<LegModel*>(p);
  p += kVjpSlots * sizeof(LegModel);
  s.lex = reinterpret_cast<LegEx*>(p);
  p += kVjpSlots * sizeof(LegEx);
  s.bias = reinterpret_cast<BiasSlot*>(p);
  p += kVjpSlots * sizeof(BiasSlot);
  s.kin = reinterpret_cast<KinSlot*>(p);
  p += kVjpSlots * sizeof(KinSlot);
  s.bex = reinterpret_cast<BaseEx*>(p);
  p += kVjpEnvs * sizeof(BaseEx);
  s.leg = reinterpret_cast<LegRec*>(p);
  p += static_cast<size_t>(chunk) * kVjpSlots * sizeof(LegRec);
  s.base = reinterpret_cast<BaseRec*>(p);
  return s;
}

QS_FN float load_or_zero(const float* p, int64_t i) { return p == nullptr ? 0.0f : p[i]; }
QS_FN V3 load3_or_zero(const float* p, int64_t i) {
  return p == nullptr ? zero3() : load3(p + i);
}

// a slot's start of substep r from the scratch
QS_FN void load_start(const float* p, LaneState& s, float& anc_x, float& anc_y) {
  s.pos = v3(p[0], p[1], p[2]);
#pragma unroll
  for (int i = 0; i < 4; ++i) s.quat[i] = p[3 + i];
  s.lin_vel = v3(p[7], p[8], p[9]);
  s.ang_vel = v3(p[10], p[11], p[12]);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s.q[j] = p[13 + j];
    s.qd[j] = p[16 + j];
  }
  anc_x = p[19];
  anc_y = p[20];
}

// Substep r's forward from its start s and anchor, recomputed with the IEEE
// operators (the values the forward's CheckedOps vouch for) into the slot's
// record lr and, from leg 0, the environment's br.
template <class Quad>
QS_FN void recompute_substep(const EnvConsts& k, const LegModel& c, const float* cmd,
                             bool torque_mode, bool on_rack, bool clamp_damping, bool has_ext,
                             const V3& f_ext, const LaneState& s, float anc_x, float anc_y,
                             int leg, LegRec& lr, BaseRec& br, Quad& quad) {
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
  lr.Ic2 = inertia_add(L.I[1], L.I[2]);
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
  float S[21], t6[6];
  V3 rj = v3(rhs[0], rhs[1], rhs[2]);
  if (!on_rack) {
    float BDinv[6][3];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float sum = leg_f(L, 0, i) * at(Dinv, 0, j);
        sum = sum + leg_f(L, 1, i) * at(Dinv, 1, j);
        BDinv[i][j] = sum + leg_f(L, 2, i) * at(Dinv, 2, j);
        lr.BDinv[i][j] = BDinv[i][j];
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

  lr.L = L;
  lr.Dinv = Dinv;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float x = s.qd[j] + k.dt * at(qdd, j);
    lr.pass[j] = minmax_pass(x, -c.vlim[j], c.vlim[j]);
    lr.rhs[j] = rhs[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) lr.dd[i] = dd[i];
  lr.rj = rj;
  lr.tqf = tqf;
  lr.fbf = fbf;
  lr.tqk = tqk;
  lr.fbk = fbk;
  lr.fbc = fbc;
  lr.ff = sites.ff;
  lr.fk = sites.fk;
  lr.fc = sites.fc;
  lr.pf = pf;
  lr.vf = vf;
  lr.pk = pk;
  lr.vk = vk;
  lr.pc = pc;
  lr.vc = vc;
  lr.foot_v = foot_v;
  lr.knee_v = knee_v;
  lr.corner_v = corner_v;
  QS_RECOMPUTE(false);
  if (leg == 0) {
    br.R = R;
    br.w_b = w_b;
    br.v_b = v_b;
    br.g_b = g_b;
    br.w_new = w_new;
    br.v_new = v_new;
#pragma unroll
    for (int i = 0; i < 6; ++i) br.a0[i] = a0[i];
    // what the 6x6 solve's and the quaternion's adjoints read of their
    // forward (counted as the adjoint's work, which derived them itself before)
    if (!on_rack) chol6_fwd(S, t6, eps, br.chol);
    quat_integrate_fwd(s.quat, w_new, k.half_dt, k.half_dt2, br.qi);
  }
}

// A thread's role in the block (see the top): its warp, and its slot (4 e +
// leg) and environment; in the sweep, lanes 0-7 of warp 1 are the block's
// environments' base lanes instead (e = the lane) and its other lanes idle
struct VjpThread {
  int warp, slot, e, leg;
  int64_t env;
  bool active, base;
};

QS_FN VjpThread vjp_thread(int t, int64_t block, int64_t n, bool sweep = false) {
  VjpThread v;
  v.warp = t >> 5;
  v.slot = t & 31;
  v.leg = v.slot & 3;
  v.base = sweep && v.warp == 1;
  v.e = v.base ? v.slot : v.slot >> 2;
  v.env = block * kVjpEnvs + v.e;
  v.active = v.e < kVjpEnvs && v.env < n;
  return v;
}

template <class Blk>
QS_FN void env_block_vjp(const EnvConsts& k, const EnvArgs& a, const EnvVjpArgs& v, int chunk,
                         int64_t block, void* smem, Blk& blk) {
  const VjpShared sm = vjp_shared(smem, chunk);
  const bool torque_mode = a.torque_mode != 0, on_rack = a.on_rack != 0;
  const bool clamp_damping = a.clamp_damping != 0, has_ext = a.ext_force != nullptr;
  const int R = a.substeps;
  const float eps = 1e-9f;
  // slot s's and environment e's start of substep r in the scratch
  auto start = [&](int64_t env, int leg, int r) {
    return v.scratch + ((4 * env + leg) * R + r) * kVjpScratchFloats;
  };
  auto cmd_of = [&](int64_t env, int leg, int r) {
    return a.q_des + env * a.q_des_env + r * a.q_des_step + 3 * leg;
  };
  auto f_ext_of = [&](int64_t env) {
    return has_ext ? load3(a.ext_force + env * a.ext_stride) : zero3();
  };

  // ---- the slots' models, the cotangents of the outputs ----------------------
  blk.each([&](int t) {
    const VjpThread th = vjp_thread(t, block, a.n, true);
    if (!th.active) return;
    if (th.warp == 0) {
      sm.model[th.slot] = scenario_leg_model(k, a, th.env, th.leg);
      LegEx& x = sm.lex[th.slot];
      const int64_t m0 = 12 * th.env + 3 * th.leg;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        x.gq[j] = load_or_zero(v.g_q, m0 + j);
        x.gqd[j] = load_or_zero(v.g_qd, m0 + j);
        x.g_cmd_held[j] = 0.0f;
      }
      x.ganc[0] = load_or_zero(v.g_anchor, 8 * th.env + 2 * th.leg);
      x.ganc[1] = load_or_zero(v.g_anchor, 8 * th.env + 2 * th.leg + 1);
    } else if (th.base) {
      BaseEx& b = sm.bex[th.e];
      b.g_pos = load3_or_zero(v.g_pos, 3 * th.env);
      b.g_lin_vel = load3_or_zero(v.g_lin_vel, 3 * th.env);
      b.g_ang_vel = load3_or_zero(v.g_ang_vel, 3 * th.env);
#pragma unroll
      for (int i = 0; i < 4; ++i) b.g_quat[i] = load_or_zero(v.g_quat, 4 * th.env + i);
    }
  });
  blk.sync();

  // the chunk's substep lo + w, recomputed by the quad of warp w's thread t
  // (of warp w + 1 in the first chunk, beside the re-run)
  auto recompute = [&](const VjpThread& th, int r, int w, auto& quad) {
    const LegModel c = sm.model[th.slot];
    LaneState s;
    float anc_x, anc_y;
    load_start(start(th.env, th.leg, r), s, anc_x, anc_y);
    recompute_substep(k, c, cmd_of(th.env, th.leg, r), torque_mode, on_rack, clamp_damping,
                      has_ext, f_ext_of(th.env), s, anc_x, anc_y, th.leg,
                      sm.leg[w * kVjpSlots + th.slot], sm.base[w * kVjpEnvs + th.e], quad);
  };

  // ---- the forward again (warp 0), each substep's start kept; the last
  // chunk's substeps recomputed as their starts come (warps 1 ..) ----------
  const int lo0 = R > chunk ? R - chunk : 0;
  blk.quads(1 + R - lo0, [&](int t, auto& quad) {
    const VjpThread th = vjp_thread(t, block, a.n);
    if (th.warp > 0) {
      const int r = lo0 + th.warp - 1;
      blk.wait(th.warp);   // substep r's start is kept
      if (th.active) recompute(th, r, th.warp - 1, quad);
      return;
    }
    const int64_t env = th.env;
    const int leg = th.leg;
    LegModel c;
    LaneState s;
    float anc_x = 0.0f, anc_y = 0.0f;
    V3 f_ext = zero3();
    if (th.active) {
      c = sm.model[th.slot];
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
      anc_x = a.anchor[8 * env + 2 * leg];
      anc_y = a.anchor[8 * env + 2 * leg + 1];
      f_ext = f_ext_of(env);
    }
    SubstepOut o = {};
    for (int r = 0; r < R; ++r) {
      if (th.active) {
        float* p = start(env, leg, r);
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
      }
      if (r >= lo0) blk.arrive(1 + r - lo0);   // every lane of the warp
      // whole groups of four are active or not: their sums stay complete
      if (th.active)
        lane_substep<true, true>(k, c, cmd_of(env, leg, r), torque_mode, on_rack,
                                 clamp_damping, has_ext, f_ext, s, anc_x, anc_y, o, quad);
    }
  });
  blk.sync();

  // ---- the sweep back, a chunk of substeps at a time -------------------------
  for (int hi = R; hi > 0;) {
    const int lo = hi > chunk ? hi - chunk : 0;
    if (hi < R) {   // the chunk's substeps recomputed at once, substep lo + w by warp w
      blk.quads(hi - lo, [&](int t, auto& quad) {
        const VjpThread th = vjp_thread(t, block, a.n);
        if (th.active) recompute(th, lo + th.warp, th.warp, quad);
      });
      blk.sync();
    }
    for (int r = hi - 1; r >= lo; --r) {
      const int ci = r - lo;
      const bool last = r == R - 1;

      // (1) the joints' update and the leg's share of a0's cotangent (warp
      // 0); the base's update: pos' = pos + dt lin_vel', lin_vel' = R v_new,
      // ang_vel' = R w_new, quat' = quat_integrate(quat, w_new) (warp 1)
      blk.each([&](int t) {
        const VjpThread th = vjp_thread(t, block, a.n, true);
        if (!th.active) return;
        if (th.warp == 0) {
          const LegRec& lr = sm.leg[ci * kVjpSlots + th.slot];
          LegEx& x = sm.lex[th.slot];
          // the joints: q' = q + dt qd', qd' = min(max(qd + dt qdd, -vlim), vlim)
          float g_qd[3];
          V3 g_qdd = zero3();
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float gx = (x.gqd[j] + k.dt * x.gq[j]) * lr.pass[j];
            g_qd[j] = gx;
            set(g_qdd, j, k.dt * gx);
          }
          M3 g_Dinv = zero33();
          V3 g_rhs = zero3(), g_rj = zero3();
          V3 gFt[3], gFb[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) gFt[j] = gFb[j] = zero3();
          mul_vjp(lr.Dinv, lr.rj, g_qdd, g_Dinv, g_rj);
          if (on_rack) {
            g_rhs = g_rj;   // qdd = Dinv rhs
          } else {
            // rj = rhs - F_jᵀ a0; this leg's share of a0's cotangent
            const BaseRec& br = sm.base[ci * kVjpEnvs + th.e];
            float g_a0[6];
            const V3 a0t = v3(br.a0[0], br.a0[1], br.a0[2]);
            const V3 a0b = v3(br.a0[3], br.a0[4], br.a0[5]);
#pragma unroll
            for (int i = 0; i < 6; ++i) g_a0[i] = 0.0f;
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const float gr = at(g_rj, j);
              add_at(g_rhs, j, gr);
              acc(gFt[j], scale(-gr, a0t));
              acc(gFb[j], scale(-gr, a0b));
#pragma unroll
              for (int i = 0; i < 6; ++i) g_a0[i] -= gr * leg_f(lr.L, j, i);
            }
#pragma unroll
            for (int i = 0; i < 6; ++i) x.g_a0[i] = g_a0[i];
          }
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            x.gqd[j] = g_qd[j];
            x.gL.Ft[j] = gFt[j];
            x.gL.Fb[j] = gFb[j];
          }
          x.g_Dinv = g_Dinv;
          x.g_rhs = g_rhs;
        } else if (th.base) {
          const BaseRec& br = sm.base[ci * kVjpEnvs + th.e];
          BaseEx& b = sm.bex[th.e];
          const float* p = start(th.env, 0, r);
          const float quat[4] = {p[3], p[4], p[5], p[6]};
          const V3 g_lv = add(b.g_lin_vel, scale(k.dt, b.g_pos));
          M3 gR = zero33();
          V3 g_vnew = zero3(), g_wnew = zero3();
          mul_vjp(br.R, br.v_new, g_lv, gR, g_vnew);
          mul_vjp(br.R, br.w_new, b.g_ang_vel, gR, g_wnew);
          float g_quat[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          quat_integrate_vjp(br.qi, quat, br.w_new, k.half_dt, k.half_dt2, b.g_quat, g_quat,
                             g_wnew);
          if (on_rack) g_wnew = g_vnew = zero3();
          b.gR = gR;
          b.g_wnew = g_wnew;
          b.g_vnew = g_vnew;
#pragma unroll
          for (int i = 0; i < 4; ++i) b.g_quat_new[i] = g_quat[i];
        }
      });
      blk.sync();

      // (2) a0 = (S + eps E)⁻¹ t6, S = trunk + Σ shares, t6 = -trunk bias + Σ
      // shares (+ Rᵀ f_ext), w_new = w_b + dt a0_w, v_new = v_b + dt a0_v: the
      // cotangent of every leg's share (warp 1, once an environment); beside
      // it, the forwards of the leg's bias force (warp 2) and of its joints'
      // rotations (warp 3) that stages 3 to 6 read
      blk.each([&](int t) {
        const VjpThread th = vjp_thread(t, block, a.n, true);
        if (!th.active) return;
        if (th.base) {
          BaseEx& b = sm.bex[th.e];
          V3 g_wb = b.g_wnew, g_vb = b.g_vnew, g_gb = zero3();
          if (on_rack) {
#pragma unroll
            for (int i = 0; i < 27; ++i) b.g_share[i] = 0.0f;
          } else {
            const BaseRec& br = sm.base[ci * kVjpEnvs + th.e];
            const LegEx* x = sm.lex + 4 * th.e;
            float g_a0[6], g_share[27];
#pragma unroll
            for (int i = 0; i < 6; ++i)
              g_a0[i] = (x[0].g_a0[i] + x[1].g_a0[i]) + (x[2].g_a0[i] + x[3].g_a0[i]);
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              g_a0[i] += k.dt * at(b.g_wnew, i);
              g_a0[i + 3] += k.dt * at(b.g_vnew, i);
            }
            chol6_solve_vjp(br.chol, g_a0, g_share, g_share + 21);
            const V3 gt_top = v3(g_share[21], g_share[22], g_share[23]);
            const V3 gt_bot = v3(g_share[24], g_share[25], g_share[26]);
            trunk_bias_vjp(sm.model[4 * th.e].trunk, br.w_b, br.v_b, br.g_b,
                           scale(-1.0f, gt_top), scale(-1.0f, gt_bot), g_wb, g_vb, g_gb);
            if (has_ext) {   // fe = Rᵀ f_ext
              M3 gR = b.gR;
              acc(gR, outer(f_ext_of(th.env), gt_bot));
              b.gR = gR;
            }
#pragma unroll
            for (int i = 0; i < 27; ++i) b.g_share[i] = g_share[i];
          }
          b.g_wb = g_wb;
          b.g_vb = g_vb;
          b.g_gb = g_gb;
        } else if (th.warp == 2) {
          const LegRec& lr = sm.leg[ci * kVjpSlots + th.slot];
          const BaseRec& br = sm.base[ci * kVjpEnvs + th.e];
          const float* p = start(th.env, th.leg, r);
          const float sqd[3] = {p[16], p[17], p[18]};
          LegBiasFwd f;
          leg_bias_fwd(lr.L, sqd, br.w_b, br.v_b, br.g_b, f);
          sm.bias[th.slot].f = f;
        } else if (th.warp == 3) {
          const float* p = start(th.env, th.leg, r);
          const float sq[3] = {p[13], p[14], p[15]};
          LegKinFwd f;
          leg_kinematics_fwd(sq, f);
          sm.kin[th.slot].f = f;
        }
      });
      blk.sync();

      // (3) the leg's share: S_ib -= Σ_j BDinv_ij F_j[b] (+ Ic1), t_i = f_i -
      // Σ_j BDinv_ij rhs_j, BDinv_ij = Σ_m F_m[i] Dinv_mj; Dinv = (D + eps
      // E)⁻¹, D_ij = s_i · F_j (warp 0); beside it (warp 2) rhs_j = tau_j +
      // s_j · [tqf; fbf] + s_j · [tqk; fbk] + joint limit - h_j and the share's
      // f = wrench - f0 as far as they reach the sites' forces (their
      // additions to s_j's cotangent wait for stage 4), then the contact
      // sites, f_b = Rᵀ f_world, and the sites' world positions and
      // velocities; and (warp 3) the leg's bias force, its additions to s_j's
      // cotangent recorded for stage 4
      blk.each([&](int t) {
        const VjpThread th = vjp_thread(t, block, a.n, true);
        if (!th.active) return;
        const LegRec& lr = sm.leg[ci * kVjpSlots + th.slot];
        const Leg& L = lr.L;
        LegEx& x = sm.lex[th.slot];
        const float* g_share = sm.bex[th.e].g_share;
        if (th.warp == 0) {
          M3 g_Dinv = x.g_Dinv;
          V3 gFt[3], gFb[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            gFt[j] = x.gL.Ft[j];
            gFb[j] = x.gL.Fb[j];
          }
          InertiaGrad gIc1 = zero_inertia_grad();
          if (!on_rack) {
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
                inertia6_vjp(i, b, gs, gIc1);
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                  g_BDinv[i][j] -= gs * leg_f(L, j, b);
                  if (b < 3) add_at(gFt[j], b, -gs * lr.BDinv[i][j]);
                  else add_at(gFb[j], b - 3, -gs * lr.BDinv[i][j]);
                }
              }
              const float gs = g_share[21 + i];
#pragma unroll
              for (int j = 0; j < 3; ++j) g_BDinv[i][j] -= gs * lr.rhs[j];
            }
#pragma unroll
            for (int i = 0; i < 6; ++i)
#pragma unroll
              for (int j = 0; j < 3; ++j)
#pragma unroll
                for (int m = 0; m < 3; ++m) {
                  if (i < 3) add_at(gFt[m], i, g_BDinv[i][j] * at(lr.Dinv, m, j));
                  else add_at(gFb[m], i - 3, g_BDinv[i][j] * at(lr.Dinv, m, j));
                  add_at(g_Dinv, m, j, leg_f(L, m, i) * g_BDinv[i][j]);
                }
          }
          float gd[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          sym3_inv_vjp(lr.dd[0], lr.dd[1], lr.dd[2], lr.dd[3], lr.dd[4], lr.dd[5], eps, g_Dinv,
                       gd);
          V3 gsw[3], gsv[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) gsw[j] = gsv[j] = zero3();
          {
            int e = 0;
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
              for (int j = i; j < 3; ++j, ++e)
                dot6_vjp(L.sw[i], L.sv[i], L.Ft[j], L.Fb[j], gd[e], gsw[i], gsv[i], gFt[j],
                         gFb[j]);
          }
          x.gL.Ic1 = gIc1;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            x.gL.Ft[j] = gFt[j];
            x.gL.Fb[j] = gFb[j];
            x.gL.sw[j] = gsw[j];
            x.gL.sv[j] = gsv[j];
          }
        } else if (th.warp == 2) {
          const BaseRec& br = sm.base[ci * kVjpEnvs + th.e];
          const LegModel& c = sm.model[th.slot];
          const float* p = start(th.env, th.leg, r);
          const float sqd[3] = {p[16], p[17], p[18]};
          V3 g_rhs = x.g_rhs;
          if (!on_rack) {
#pragma unroll
            for (int i = 0; i < 6; ++i) {
              const float gs = g_share[21 + i];
#pragma unroll
              for (int j = 0; j < 3; ++j) add_at(g_rhs, j, -gs * lr.BDinv[i][j]);
            }
          }
          float g_qd[3];
          V3 g_tqf = zero3(), g_fbf = zero3(), g_tqk = zero3(), g_fbk = zero3();
          V3 g_tqc = zero3(), g_fbc = zero3();
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            float g_q = x.gq[j];
            g_qd[j] = x.gqd[j];
            const float gr = at(g_rhs, j);
            joint_limit_torque_vjp(k, j, p[13 + j], sqd[j], gr, &g_q, &g_qd[j]);
            x.gq[j] = g_q;
            // dot6_vjp(s_j, [tqf; fbf], gr) and dot6_vjp(s_j, [tqk; fbk], gr)
            // as far as they reach the sites' forces
            acc(g_tqf, scale(gr, L.sw[j]));
            acc(g_fbf, scale(gr, L.sv[j]));
            acc(g_tqk, scale(gr, L.sw[j]));
            acc(g_fbk, scale(gr, L.sv[j]));
          }
          x.g_rhs_all = g_rhs;
          // the share's f = wrench - f0, wrench = Σ_sites [p × f_b; f_b]
          const V3 gw_t = v3(g_share[21], g_share[22], g_share[23]);
          const V3 gw_f = v3(g_share[24], g_share[25], g_share[26]);
          acc(g_tqf, gw_t);
          acc(g_tqk, gw_t);
          acc(g_tqc, gw_t);
          acc(g_fbf, gw_f);
          acc(g_fbk, gw_f);
          acc(g_fbc, gw_f);
          // the contact sites
          const M3 R = br.R;
          const V3 knee = L.o[2], corner = c.corner, w_b = br.w_b;
          V3 g_foot = zero3(), g_knee = zero3(), unused = zero3();
          cross_vjp(L.foot, lr.fbf, g_tqf, g_foot, g_fbf);
          cross_vjp(knee, lr.fbk, g_tqk, g_knee, g_fbk);
          cross_vjp(corner, lr.fbc, g_tqc, unused, g_fbc);
          // f_b = Rᵀ f_world: the leg's shares of R's cotangent
          M3 gR_leg = zero33();
          V3 g_ff = zero3(), g_fk = zero3(), g_fc = zero3();
          mul_t_vjp(R, lr.ff, g_fbf, gR_leg, g_ff);
          mul_t_vjp(R, lr.fk, g_fbk, gR_leg, g_fk);
          mul_t_vjp(R, lr.fc, g_fbc, gR_leg, g_fc);
          const V3 pf = lr.pf, vf = lr.vf, pk = lr.pk, vk = lr.vk, pc = lr.pc, vc = lr.vc;
          const float g_fn = last ? load_or_zero(v.g_foot_force, 4 * th.env + th.leg) : 0.0f;
          V3 g_pf = zero3(), g_vf = zero3(), g_pk = zero3(), g_vk = zero3(), g_pc = zero3(),
             g_vc = zero3();
          float g_phi = 0.0f, g_anc_x = 0.0f, g_anc_y = 0.0f;
          anchored_foot_elem_vjp(k.foot_radius - pf.z, vf.x, vf.y, vf.z, pf.x, pf.y, p[19], p[20],
                                 c.mu, k.kn, k.dn, k.kt, k.ct, clamp_damping, g_ff.x, g_ff.y,
                                 g_ff.z + g_fn, x.ganc[0], x.ganc[1], &g_phi, &g_vf.x, &g_vf.y,
                                 &g_vf.z, &g_pf.x, &g_pf.y, &g_anc_x, &g_anc_y);
          g_pf.z -= g_phi;
          g_phi = 0.0f;
          contact_elem_vjp(k.knee_radius - pk.z, vk.x, vk.y, vk.z, c.mu, k.kn, k.dn, k.v_tol,
                           clamp_damping, g_fk.x, g_fk.y, g_fk.z, &g_phi, &g_vk.x, &g_vk.y,
                           &g_vk.z);
          g_pk.z -= g_phi;
          g_phi = 0.0f;
          contact_elem_vjp(k.trunk_radius - pc.z, vc.x, vc.y, vc.z, c.mu, k.kn, k.dn, k.v_tol,
                           clamp_damping, g_fc.x, g_fc.y, g_fc.z, &g_phi, &g_vc.x, &g_vc.y,
                           &g_vc.z);
          g_pc.z -= g_phi;
          // the sites' world positions and velocities
          const V3 g_pos_leg = add(add(g_pf, g_pk), g_pc);
          V3 g_footv = zero3(), g_kneev = zero3(), g_cornerv = zero3();
          mul_vjp(R, L.foot, g_pf, gR_leg, g_foot);
          mul_vjp(R, lr.foot_v, g_vf, gR_leg, g_footv);
          mul_vjp(R, knee, g_pk, gR_leg, g_knee);
          mul_vjp(R, lr.knee_v, g_vk, gR_leg, g_kneev);
          mul_vjp(R, corner, g_pc, gR_leg, unused);
          mul_vjp(R, lr.corner_v, g_vc, gR_leg, g_cornerv);
          V3 g_wb_leg = zero3(), g_vb_leg = g_cornerv;
          cross_vjp(w_b, corner, g_cornerv, g_wb_leg, unused);
          LegGrad gL = zero_leg_grad();
          leg_point_velocity_vjp(L, sqd, knee, w_b, g_kneev, g_qd, g_knee, gL, g_wb_leg,
                                 g_vb_leg);
          leg_point_velocity_vjp(L, sqd, L.foot, w_b, g_footv, g_qd, g_foot, gL, g_wb_leg,
                                 g_vb_leg);
          acc(gL.o[2], g_knee);
          x.gL.foot = g_foot;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            x.gL.o[j] = gL.o[j];
            x.gL.axis[j] = gL.axis[j];
            x.gqd[j] = g_qd[j];
          }
          x.gR_leg = gR_leg;
          x.g_wb_leg = g_wb_leg;
          x.g_vb_leg = g_vb_leg;
          x.g_pos_leg = g_pos_leg;
          x.ganc[0] = g_anc_x;
          x.ganc[1] = g_anc_y;
        } else if (th.warp == 3) {
          const float* p = start(th.env, th.leg, r);
          const float sqd[3] = {p[16], p[17], p[18]};
          QS_RECOMPUTE(true);
          V3 g_rhs = x.g_rhs;   // as warp 2 completes it
          if (!on_rack) {
#pragma unroll
            for (int i = 0; i < 6; ++i) {
              const float gs = g_share[21 + i];
#pragma unroll
              for (int j = 0; j < 3; ++j) add_at(g_rhs, j, -gs * lr.BDinv[i][j]);
            }
          }
          QS_RECOMPUTE(false);
          const float g_h[3] = {-g_rhs.x, -g_rhs.y, -g_rhs.z};
          const V3 g_f0t = scale(-1.0f, v3(g_share[21], g_share[22], g_share[23]));
          const V3 g_f0b = scale(-1.0f, v3(g_share[24], g_share[25], g_share[26]));
          InertiaGrad gI[3] = {zero_inertia_grad(), zero_inertia_grad(), zero_inertia_grad()};
          float gqd_a[3], gqd_v[3];
          V3 gvw, gvv, gav;
          leg_bias_vjp(sm.bias[th.slot].f, L, sqd, g_f0t, g_f0b, g_h, gI, x.bias_terms, gqd_a,
                       gqd_v, gvw, gvv, gav);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            x.gL.I[j] = gI[j];
            x.gqd_a[j] = gqd_a[j];
            x.gqd_v[j] = gqd_v[j];
          }
          x.gvw = gvw;
          x.gvv = gvv;
          x.gav = gav;
        }
      });
      blk.sync();

      // (4) the leg's kinematics, column j = 0, 1, 2 by warps 0, 2, 3 (its
      // composite inertia's column F_j and motion subspace s_j, whose
      // cotangent first takes the right-hand side's and the bias force's
      // additions, in their order); the four legs' shares of the base's
      // cotangents, summed, and w_b = Rᵀ ang_vel, v_b = Rᵀ lin_vel, g_b = Rᵀ
      // g, R = R(quat) (warp 1)
      blk.each([&](int t) {
        const VjpThread th = vjp_thread(t, block, a.n, true);
        if (!th.active) return;
        if (th.base) {
          const BaseRec& br = sm.base[ci * kVjpEnvs + th.e];
          BaseEx& b = sm.bex[th.e];
          const LegEx* x = sm.lex + 4 * th.e;
          float base[4][21];
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const V3 wb = add(x[l].g_wb_leg, x[l].gvw), vb = add(x[l].g_vb_leg, x[l].gvv);
            const V3 gb = add(zero3(), scale(-1.0f, x[l].gav));
#pragma unroll
            for (int i = 0; i < 3; ++i) {
#pragma unroll
              for (int j = 0; j < 3; ++j) base[l][3 * i + j] = at(x[l].gR_leg, i, j);
              base[l][9 + i] = at(wb, i);
              base[l][12 + i] = at(vb, i);
              base[l][15 + i] = at(gb, i);
              base[l][18 + i] = at(x[l].g_pos_leg, i);
            }
          }
          float sum[21];
#pragma unroll
          for (int i = 0; i < 21; ++i)
            sum[i] = (base[0][i] + base[1][i]) + (base[2][i] + base[3][i]);
          M3 gR = b.gR;
          V3 g_wb = b.g_wb, g_vb = b.g_vb, g_gb = b.g_gb, g_pos = b.g_pos;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) add_at(gR, i, j, sum[3 * i + j]);
            add_at(g_wb, i, sum[9 + i]);
            add_at(g_vb, i, sum[12 + i]);
            add_at(g_gb, i, sum[15 + i]);
            add_at(g_pos, i, sum[18 + i]);
          }
          const float* p = start(th.env, 0, r);
          const float quat[4] = {p[3], p[4], p[5], p[6]};
          V3 g_av = zero3(), g_lv0 = zero3(), unused = zero3();
          const M3 R = br.R;
          mul_t_vjp(R, v3(p[10], p[11], p[12]), g_wb, gR, g_av);
          mul_t_vjp(R, v3(p[7], p[8], p[9]), g_vb, gR, g_lv0);
          mul_t_vjp(R, sm.model[4 * th.e].g, g_gb, gR, unused);
          float g_quat[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) g_quat[i] = b.g_quat_new[i];
          quat_to_m3_vjp(quat, gR, g_quat);
          b.g_pos = g_pos;
          b.g_lin_vel = g_lv0;
          b.g_ang_vel = g_av;
#pragma unroll
          for (int i = 0; i < 4; ++i) b.g_quat[i] = g_quat[i];
          return;
        }
        const int j = th.warp == 0 ? 0 : th.warp - 1;   // warps 0, 2, 3
        if (th.warp != 0 && th.warp != 2 && th.warp != 3) return;
        const LegRec& lr = sm.leg[ci * kVjpSlots + th.slot];
        const Leg& L = lr.L;
        LegEx& x = sm.lex[th.slot];
        InertiaGrad gI = j == 0 ? x.gL.Ic1 : (j == 1 ? zero_inertia_grad() : x.gL.I[2]);
        V3 gsw = x.gL.sw[j], gsv = x.gL.sv[j], gaxis = x.gL.axis[j], go = x.gL.o[j];
        // dot6_vjp(s_j, [tqf; fbf], gr) and dot6_vjp(s_j, [tqk; fbk], gr), as far
        // as they reach s_j; then leg_bias_vjp's additions
        const float gr = at(x.g_rhs_all, j);
        acc(gsw, scale(gr, lr.tqf));
        acc(gsv, scale(gr, lr.fbf));
        acc(gsw, scale(gr, lr.tqk));
        acc(gsv, scale(gr, lr.fbk));
        const float* p = start(th.env, th.leg, r);
        const float sqd[3] = {p[16], p[17], p[18]};
        const float g_h[3] = {-x.g_rhs_all.x, -x.g_rhs_all.y, -x.g_rhs_all.z};
        leg_bias_vjp_apply(sm.bias[th.slot].f, sqd, g_h, x.bias_terms, j, gsw, gsv);
        leg_column_vjp(j == 0 ? L.Ic1 : (j == 1 ? lr.Ic2 : L.I[2]), L.sw[j], L.sv[j], L.o[j],
                       L.axis[j], x.gL.Ft[j], x.gL.Fb[j], gI, gsw, gsv, gaxis, go);
        if (j == 0) x.gL.Ic1 = gI;
        else if (j == 1) x.gIc2 = gI;
        else x.gL.I[2] = gI;
        x.gL.sw[j] = gsw;
        x.gL.sv[j] = gsv;
        x.gL.axis[j] = gaxis;
        x.gL.o[j] = go;
      });
      blk.sync();

      // (5) body k = 0, 1, 2's inertia about the base origin by warps 0, 2, 3
      blk.each([&](int t) {
        const VjpThread th = vjp_thread(t, block, a.n, true);
        if (!th.active || th.base) return;
        if (th.warp != 0 && th.warp != 2 && th.warp != 3) return;
        const int kb = th.warp == 0 ? 0 : th.warp - 1;
        const LegRec& lr = sm.leg[ci * kVjpSlots + th.slot];
        const LegKinFwd& f = sm.kin[th.slot].f;
        LegEx& x = sm.lex[th.slot];
        const M3 R = kb == 0 ? rot_x_sc(f.s[0], f.c[0]) : (kb == 1 ? f.R2 : f.R3);
        M3 gR = zero33();
        V3 go = x.gL.o[kb];
        leg_body_vjp(kb, sm.model[th.slot].bodies, R, lr.L.o[kb], x.gL.Ic1, x.gIc2, x.gL.I[kb],
                     gR, go);
        x.gRb[kb] = gR;
        x.gL.o[kb] = go;
      });
      blk.sync();

      // (6) the leg's kinematics' chain to the joint angles, then
      // actuation (TORQUE: the clipped command plus the springs' law at zero
      // gains, whose motor torque is not used) (warp 0)
      blk.each([&](int t) {
        const VjpThread th = vjp_thread(t, block, a.n, true);
        if (!th.active || th.warp != 0) return;
        const LegModel& c = sm.model[th.slot];
        LegEx& x = sm.lex[th.slot];
        const float* p = start(th.env, th.leg, r);
        const float sq[3] = {p[13], p[14], p[15]};
        float g_q[3], g_qd[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          g_q[j] = x.gq[j];
          g_qd[j] = x.gqd[j];
        }
#pragma unroll
        for (int j = 2; j >= 0; --j) {   // leg_bias_vjp's additions, in its order
          g_qd[j] += x.gqd_a[j];
          g_qd[j] += x.gqd_v[j];
        }
        leg_chain_vjp(k, c.thigh, sm.kin[th.slot].f, x.gRb[0], x.gRb[1], x.gRb[2], x.gL.o[1],
                      x.gL.o[2], x.gL.foot, x.gL.axis[1], x.gL.axis[2], g_q);
        const int64_t m0 = 12 * th.env + 3 * th.leg;
        const float* cmd = cmd_of(th.env, th.leg, r);
        float g_cmd[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float g_tau_m_sum = load_or_zero(v.g_tau_m_sum, m0 + j);
          const float g_tau_m = last ? g_tau_m_sum + load_or_zero(v.g_tau_m, m0 + j)
                                     : g_tau_m_sum;
          const float g_tau = last ? load_or_zero(v.g_tau, m0 + j) : 0.0f;
          const float g_tau_all = g_tau + at(x.g_rhs_all, j);
          actuation_elem_vjp(cmd[j], sq[j], p[16 + j], c.kp[j], c.kd[j], c.lim[j], c.sk[j],
                             c.sb[j], c.rest[j], c.sign[j], g_tau_all,
                             torque_mode ? 0.0f : g_tau_m, &g_cmd[j], &g_q[j], &g_qd[j]);
          if (torque_mode)
            g_cmd[j] += (g_tau_all + g_tau_m) * minmax_pass(cmd[j], -c.lim[j], c.lim[j]);
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          x.gq[j] = g_q[j];
          x.gqd[j] = g_qd[j];
          if (a.q_des_step == 0) x.g_cmd_held[j] += g_cmd[j];
          else v.d_q_des[th.env * a.q_des_env + r * a.q_des_step + 3 * th.leg + j] = g_cmd[j];
        }
      });
      blk.sync();
    }
    hi = lo;
  }

  // ---- the cotangents of the inputs ------------------------------------------
  blk.each([&](int t) {
    const VjpThread th = vjp_thread(t, block, a.n, true);
    if (!th.active) return;
    if (th.warp == 0) {
      const LegEx& x = sm.lex[th.slot];
      const int64_t m0 = 12 * th.env + 3 * th.leg;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        v.d_q[m0 + j] = x.gq[j];
        v.d_qd[m0 + j] = x.gqd[j];
        if (a.q_des_step == 0) v.d_q_des[th.env * a.q_des_env + 3 * th.leg + j] = x.g_cmd_held[j];
      }
      v.d_anchor[8 * th.env + 2 * th.leg] = x.ganc[0];
      v.d_anchor[8 * th.env + 2 * th.leg + 1] = x.ganc[1];
    } else if (th.base) {
      const BaseEx& b = sm.bex[th.e];
      const int64_t env = th.env;
      v.d_pos[3 * env] = b.g_pos.x;
      v.d_pos[3 * env + 1] = b.g_pos.y;
      v.d_pos[3 * env + 2] = b.g_pos.z;
      v.d_lin_vel[3 * env] = b.g_lin_vel.x;
      v.d_lin_vel[3 * env + 1] = b.g_lin_vel.y;
      v.d_lin_vel[3 * env + 2] = b.g_lin_vel.z;
      v.d_ang_vel[3 * env] = b.g_ang_vel.x;
      v.d_ang_vel[3 * env + 1] = b.g_ang_vel.y;
      v.d_ang_vel[3 * env + 2] = b.g_ang_vel.z;
#pragma unroll
      for (int i = 0; i < 4; ++i) v.d_quat[4 * env + i] = b.g_quat[i];
    }
  });
}

}  // namespace qs
