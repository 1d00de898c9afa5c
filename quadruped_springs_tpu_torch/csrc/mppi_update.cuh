// The body of the mppi_update kernel (mppi_update.cu): one MPPI update of a
// problem and the rows its next rollout takes, as quadruped_springs_tpu_
// torch/solver/mppi_update.py mppi_update_plain computes them. One block of
// kUpdateThreads threads a problem, so a problem's answer does not depend on
// its batch. A launch runs, in order, what its arguments ask for:
//
// 1. the proposal (costs given): a non-finite cost becomes inf; the first
//    argmin; the fused accept's best tracking (the running best cost, its
//    candidate and the trace); the n_elite-th smallest cost by a rank count
//    (exactly torch.sort(costs)[n_elite - 1], ties included); β = min;
//    w = exp(-(c - β)/λ) where c <= kth, else 0; w / max(sum_fixed(w),
//    1e-12); the weighted mean over the K candidates in sum_fixed's order,
//    clipped: the proposal (`us` with the fused accept, else `us_alt`);
// 2. the plain branch's accept (cost_new given): the proposal replaces `us`
//    where its cost is below `cost`; the trace;
// 3. the rows of the next rollout: K candidates from the draws (σ_i·draw,
//    low-passed along H (c = a·c + b·e) and renormalised per knot, row 0
//    zero with the fused accept, added to `us` and clipped), or rows of the
//    state (us; us_alt; both);
// 4. where q_des is given, the rows' joint targets through the PD
//    interface's affine action_to_command, read back from the rows just
//    written (their stores coalesced: one thread a target).
//
// The phases are functions of a thread index, the block's barrier between
// them: the kernel calls each with threadIdx.x, tests/mppi_update_host.cpp
// runs each for every index in turn. Every operation rounds on its own
// (task_cost.cuh's rn_*), in the plain version's order; λ's division is a
// product with its reciprocal (rcp_temperature: taken in double, rounded to
// float32), as PyTorch's CUDA kernels divide by a Python number.

#pragma once

#include <math.h>
#include <stdint.h>

#include "task_cost.cuh"

namespace qs {

constexpr int kUpdateThreads = 256;
// knots a stream of update_rows loads before it stores any
constexpr int kLoadAhead = 10;

// rows written by phase 3: the K candidates, or the state's
enum UpdateRows : int { kRowsCandidates = 0, kRowsUs = 1, kRowsAlt = 2, kRowsBoth = 3 };

struct UpdateArgs {
  const float* costs;     // (B,K) the candidates' costs, or null: no proposal
  const float* cand;      // (B,K,H,m) the candidates those costs are of
  const float* cost_new;  // (B,) the proposal's cost (plain accept), or null
  const float* draw;      // (B,K,H,m) standard-normal draws (kRowsCandidates)
  const float* sigma;     // σ_i: one float on the device
  const float* norm;      // (H,) the low-pass's per-knot renormalisation
  const float* lower;     // (12,) the PD interface's command limits, or null:
  const float* upper;     //   no joint targets
  float* us;              // (B,H,m) fused: the proposal; plain: the accepted
  float* us_alt;          // (B,H,m) fused: the best candidate; plain: the proposal
  float* cost;            // (B,) fused: the best cost; plain: the accepted cost
  float* trace;           // (B,iterations)
  float* rows;            // (B,R,H,m) out
  float* q_des;           // (B,R,H,12) out, or null
  int64_t n_problems;
  int samples, horizon, actions, n_elite, trace_col, iterations, out_rows, fused, smooth;
  float rcp_temperature, u_min, u_max, lp_a, lp_b;
  // action_to_command of a PD interface: joint i's target from action
  // joint_src[i] times joint_sign[i] (the mirror), or 0 where joint_src is -1
  int joint_src[12];
  float joint_sign[12];
};

#define QS_MPPI_UPDATE_PARAMS                                                     \
  const float *costs, const float *cand, const float *cost_new, const float *draw,  \
      const float *sigma, const float *norm, const float *lower, const float *upper, \
      float *us, float *us_alt, float *cost, float *trace, float *rows, float *q_des, \
      int64_t n_problems, int samples, int horizon, int actions, int n_elite,       \
      int trace_col, int iterations, int out_rows, int fused, int smooth,           \
      float rcp_temperature, float u_min, float u_max, float lp_a, float lp_b,      \
      const int *joint_src, const float *joint_sign, void *stream

inline UpdateArgs update_args(QS_MPPI_UPDATE_PARAMS) {
  (void)stream;
  UpdateArgs a{costs, cand, cost_new, draw, sigma, norm, lower, upper, us, us_alt,
               cost, trace, rows, q_des, n_problems, samples, horizon, actions, n_elite,
               trace_col, iterations, out_rows, fused, smooth, rcp_temperature, u_min,
               u_max, lp_a, lp_b, {}, {}};
  for (int i = 0; i < 12; ++i) {
    a.joint_src[i] = joint_src[i];
    a.joint_sign[i] = joint_sign[i];
  }
  return a;
}

// The block's shared memory: the scalars, then costs (K), weights (K) and
// the weighted mean's columns (K, kUpdateThreads)
struct UpdateShared {
  int ib, better;
  float kth, total;
};

inline size_t update_smem_floats(int samples) {
  return static_cast<size_t>(samples) * (2 + kUpdateThreads);
}

// phase 1a: the costs, non-finite ones inf
QS_FN void update_load_costs(const UpdateArgs& a, int64_t b, int tid, float* c) {
  for (int k = tid; k < a.samples; k += kUpdateThreads) {
    const float v = a.costs[b * a.samples + k];
    c[k] = isfinite(v) ? v : INFINITY;
  }
}

// phase 1b: the first argmin (thread 0) and the n_elite-th smallest cost
QS_FN void update_rank(const UpdateArgs& a, int tid, const float* c, UpdateShared& sh) {
  if (tid == 0) {
    int ib = 0;
    for (int k = 1; k < a.samples; ++k)
      if (c[k] < c[ib]) ib = k;
    sh.ib = ib;
  }
  for (int k = tid; k < a.samples; k += kUpdateThreads) {
    int less = 0, leq = 0;
    for (int j = 0; j < a.samples; ++j) {
      less += c[j] < c[k];
      leq += c[j] <= c[k];
    }
    if (less < a.n_elite && a.n_elite <= leq) sh.kth = c[k];   // all such c[k] equal
  }
}

// phase 1c: the truncated weights
QS_FN void update_weights(const UpdateArgs& a, int tid, const float* c, float* w,
                          const UpdateShared& sh) {
  const float beta = c[sh.ib];
  for (int k = tid; k < a.samples; k += kUpdateThreads) {
    const float e = expf(rn_mul(-rn_sub(c[k], beta), a.rcp_temperature));
    w[k] = c[k] <= sh.kth ? e : 0.0f;
  }
}

// phase 1d (thread 0): their sum, floored; the fused accept's best tracking
QS_FN void update_total(const UpdateArgs& a, int64_t b, int tid, const float* c,
                        const float* w, float* scratch, UpdateShared& sh) {
  if (tid != 0) return;
  for (int k = 0; k < a.samples; ++k) scratch[k] = w[k];
  sh.total = clamp_min_nan(sum_fixed_strided(scratch, a.samples, 1), 1e-12f);
  if (a.fused) {
    const float best = c[sh.ib];
    sh.better = best < a.cost[b];
    if (sh.better) a.cost[b] = best;
    a.trace[b * a.iterations + a.trace_col] = a.cost[b];
  }
}

// phase 1e: the weights normalised
QS_FN void update_normalise(const UpdateArgs& a, int tid, float* w, const UpdateShared& sh) {
  for (int k = tid; k < a.samples; k += kUpdateThreads) w[k] = rn_div(w[k], sh.total);
}

// phase 1f: the proposal, the weighted mean of the candidates over K (each
// thread one element of a chunk of kUpdateThreads, its products in its
// column of `cols`), clipped; the fused accept's best candidate copied
QS_FN void update_propose(const UpdateArgs& a, int64_t b, int tid, const float* w,
                          float* cols, const UpdateShared& sh) {
  const int64_t E = static_cast<int64_t>(a.horizon) * a.actions;
  const float* cand = a.cand + b * a.samples * E;
  float* prop = (a.fused ? a.us : a.us_alt) + b * E;
  for (int64_t e0 = 0; e0 < E; e0 += kUpdateThreads) {
    const int64_t e = e0 + tid;
    if (e >= E) break;
#pragma unroll 8
    for (int k = 0; k < a.samples; ++k)
      cols[k * kUpdateThreads + tid] = rn_mul(w[k], cand[k * E + e]);
    prop[e] = clamp_nan(sum_fixed_strided(cols + tid, a.samples, kUpdateThreads), a.u_min,
                        a.u_max);
    if (a.fused && sh.better) a.us_alt[b * E + e] = cand[sh.ib * E + e];
  }
}

// phase 2a (thread 0): the plain branch's accept test
QS_FN void update_accept(const UpdateArgs& a, int64_t b, int tid, UpdateShared& sh) {
  if (tid != 0) return;
  const float c_new = a.cost_new[b];
  sh.better = c_new < a.cost[b];
  if (sh.better) a.cost[b] = c_new;
  a.trace[b * a.iterations + a.trace_col] = a.cost[b];
}

// phase 2b: the accepted controls
QS_FN void update_take(const UpdateArgs& a, int64_t b, int tid, const UpdateShared& sh) {
  if (!sh.better) return;
  const int64_t E = static_cast<int64_t>(a.horizon) * a.actions;
  for (int64_t e = tid; e < E; e += kUpdateThreads) a.us[b * E + e] = a.us_alt[b * E + e];
}

// phase 3: the rows of the next rollout, one thread per (row, action)
// stream along the horizon
QS_FN void update_rows(const UpdateArgs& a, int64_t b, int tid) {
  const int H = a.horizon, m = a.actions;
  const int64_t E = static_cast<int64_t>(H) * m;
  const int R = a.out_rows == kRowsCandidates ? a.samples : (a.out_rows == kRowsBoth ? 2 : 1);
  const float sigma = a.out_rows == kRowsCandidates ? *a.sigma : 0.0f;
  for (int stream = tid; stream < R * m; stream += kUpdateThreads) {
    const int r = stream / m, j = stream % m;
    const int64_t row = b * R + r;
    const float* base = (a.out_rows == kRowsAlt || (a.out_rows == kRowsBoth && r == 1))
                            ? a.us_alt + b * E
                            : a.us + b * E;
    float c = 0.0f;
    // kLoadAhead knots at a time: their loads all issue before the first
    // store, which the compiler may not move them past (the pointers could
    // alias), so a stream waits on memory once a chunk, not once a knot
    for (int t0 = 0; t0 < H; t0 += kLoadAhead) {
      float u[kLoadAhead], d[kLoadAhead], nrm[kLoadAhead];
#pragma unroll
      for (int i = 0; i < kLoadAhead; ++i) {
        const int t = t0 + i;
        if (t >= H) break;
        u[i] = base[t * m + j];
        if (a.out_rows == kRowsCandidates) {
          d[i] = a.draw[(row * H + t) * m + j];
          nrm[i] = a.norm[t];
        }
      }
#pragma unroll
      for (int i = 0; i < kLoadAhead; ++i) {
        const int t = t0 + i;
        if (t >= H) break;
        if (a.out_rows == kRowsCandidates) {
          const float e = rn_mul(sigma, d[i]);
          float eps = e;
          if (a.smooth) {
            c = rn_add(rn_mul(a.lp_a, c), rn_mul(a.lp_b, e));
            eps = rn_div(c, nrm[i]);
          }
          if (a.fused && r == 0) eps = 0.0f;
          u[i] = clamp_nan(rn_add(u[i], eps), a.u_min, a.u_max);
        }
        a.rows[(row * H + t) * m + j] = u[i];
      }
    }
  }
}

// phase 4 (where q_des is given): the rows' joint targets, one thread per
// target, consecutive threads on consecutive targets: scale_action_to_command
// of the expanded action, as interfaces.action_to_command computes it for PD
QS_FN void update_commands(const UpdateArgs& a, int64_t b, int tid) {
  const int m = a.actions;
  const int R = a.out_rows == kRowsCandidates ? a.samples : (a.out_rows == kRowsBoth ? 2 : 1);
  const int knots = R * a.horizon;   // a problem's targets fit an int
  const float* rows = a.rows + b * knots * m;
  float* q = a.q_des + b * knots * 12;
  for (int e = tid; e < knots * 12; e += kUpdateThreads) {
    const int i = e % 12;
    const int src = a.joint_src[i];
    const float act = src < 0 ? 0.0f : rn_mul(rows[e / 12 * m + src], a.joint_sign[i]);
    const float lo = a.lower[i], hi = a.upper[i];
    // torch.minimum(torch.maximum(x, lo), hi), as interfaces._clip: a NaN stays NaN
    const float x = clamp_nan(act, -1.0f, 1.0f);
    const float cmd = rn_add(lo, rn_mul(rn_mul(0.5f, rn_add(x, 1.0f)), rn_sub(hi, lo)));
    q[e] = clamp_nan(cmd, lo, hi);
  }
}

}  // namespace qs
