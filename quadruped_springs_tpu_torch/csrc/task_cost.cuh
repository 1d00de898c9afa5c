// The task costs of the MPPI solver's four families (quadruped_springs_tpu_
// torch/tasks/costs.py make_cost: JUMPING_IN_PLACE, JUMPING_FORWARD,
// CONTINUOUS_JUMPING_FORWARD, BACKFLIP) on one lane's state, for the cost
// instantiation of planner_rollout (planner_lane.cuh), and the sums in
// models/spatial.py sum_fixed's order that it and mppi_update.cuh share.
//
// Every operation is the plain version's, in its order, rounded on its own:
// the products and sums go through rn_mul / rn_add / rn_sub (__fmul_rn, __fadd_rn,
// __fsub_rn on the card: never contracted into an FMA), as PyTorch runs
// each elementwise op of the plain version as a kernel of its own. A
// division by a Python number is a product with the number's reciprocal,
// taken in double and rounded to float32 (the constants' kRcp*:
// tasks/costs.py kernel_weights), as PyTorch's CUDA kernels divide a tensor
// by a Python number (tests/torch_mppi_iteration_probe.py --semantics); a
// host build (the CPU tests) may therefore part from the plain version on
// the CPU, which divides, by an ulp of such a term. The clamps keep a NaN,
// as torch.clamp does.

#pragma once

#include <math.h>
#include <stdint.h>

#ifndef QS_FN
#if defined(__CUDACC__)
#define QS_FN __device__ __forceinline__
#else
#define QS_FN inline
#endif
#endif

namespace qs {

#if defined(__CUDA_ARCH__)
QS_FN float rn_mul(float a, float b) { return __fmul_rn(a, b); }
QS_FN float rn_add(float a, float b) { return __fadd_rn(a, b); }
QS_FN float rn_sub(float a, float b) { return __fsub_rn(a, b); }
QS_FN float rn_div(float a, float b) { return __fdiv_rn(a, b); }
#else
QS_FN float rn_mul(float a, float b) { return a * b; }
QS_FN float rn_add(float a, float b) { return a + b; }
QS_FN float rn_sub(float a, float b) { return a - b; }
QS_FN float rn_div(float a, float b) { return a / b; }
#endif

// torch.clamp_min(x, lo) and torch.clamp(x, lo, hi): a NaN stays NaN
QS_FN float clamp_min_nan(float x, float lo) { return x < lo ? lo : x; }
QS_FN float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// sum_fixed over N terms in registers: halves added while N is even and
// above 4, an odd N above 4 adds its last term to the sum of the rest, 4 or
// fewer a chain in index order
template <int N>
QS_FN float sum_fixed_n(const float* x) {
  if constexpr (N <= 4) {
    float s = x[0];
#pragma unroll
    for (int i = 1; i < N; ++i) s = rn_add(s, x[i]);
    return s;
  } else if constexpr (N % 2 == 1) {
    return rn_add(sum_fixed_n<N - 1>(x), x[N - 1]);
  } else {
    float y[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) y[i] = rn_add(x[i], x[i + N / 2]);
    return sum_fixed_n<N / 2>(y);
  }
}

// sum_fixed over v[0], v[s], ..., v[(n-1)·s] for any n >= 1, in place (v is
// overwritten): the halves folded into the first half while the length is
// even and above 4, an odd length's last term set aside (bit `level` of
// `odd`), then the chain, then the terms set aside, innermost first
QS_FN float sum_fixed_strided(float* v, int n, int s) {
  uint32_t odd = 0;
  int levels = 0;
  for (int m = n; m > 4; ++levels) {
    if (m & 1) {
      odd |= 1u << levels;
      m -= 1;
    } else {
      const int h = m / 2;
      for (int i = 0; i < h; ++i) v[i * s] = rn_add(v[i * s], v[(i + h) * s]);
      m = h;
    }
  }
  int m = n;
  for (int l = 0; l < levels; ++l) m = (odd >> l & 1u) ? m - 1 : m / 2;
  float acc = v[0];
  for (int i = 1; i < m; ++i) acc = rn_add(acc, v[i * s]);
  for (int l = levels - 1; l >= 0; --l) {
    if (!(odd >> l & 1u)) continue;
    int len = n;   // the length at level l, whose last term was set aside
    for (int j = 0; j < l; ++j) len = (odd >> j & 1u) ? len - 1 : len / 2;
    acc = rn_add(acc, v[(len - 1) * s]);
  }
  return acc;
}

// sum_fixed(u * u) over a knot's m actions (1 <= m <= kMaxActions)
constexpr int kMaxActions = 12;

template <int M>
QS_FN float action_square_sum_n(const float* u) {
  float v[M];
#pragma unroll
  for (int j = 0; j < M; ++j) v[j] = rn_mul(u[j], u[j]);
  return sum_fixed_n<M>(v);
}

QS_FN float action_square_sum(const float* u, int m) {
  switch (m) {
    case 1: return action_square_sum_n<1>(u);
    case 2: return action_square_sum_n<2>(u);
    case 3: return action_square_sum_n<3>(u);
    case 4: return action_square_sum_n<4>(u);
    case 5: return action_square_sum_n<5>(u);
    case 6: return action_square_sum_n<6>(u);
    case 7: return action_square_sum_n<7>(u);
    case 8: return action_square_sum_n<8>(u);
    case 9: return action_square_sum_n<9>(u);
    case 10: return action_square_sum_n<10>(u);
    case 11: return action_square_sum_n<11>(u);
    default: return action_square_sum_n<12>(u);
  }
}

// The families, in tasks/costs.py KERNEL_FAMILIES's order, and the layout of
// their constants (kernel_weights): four shared, then the family's
enum CostFamily : int { kJumpInPlace = 0, kJumpForward = 1, kContinuous = 2, kBackflip = 3 };
constexpr int kCostWeights = 16;
enum SharedWeight : int { kWu = 0, kWqd = 1, kRcp2g = 2, kRcpG = 3, kFamily0 = 4 };

// what the costs read of the base: position, quaternion xyzw, world linear
// and angular velocity
struct BaseState {
  float px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz;
};

// apex height: z + clamp_min(vz, 0)² / (2g)
QS_FN float apex_height(const BaseState& b, const float* w) {
  const float c = clamp_min_nan(b.vz, 0.0f);
  return rn_add(b.pz, rn_mul(rn_mul(c, c), w[kRcp2g]));
}

// quat_to_rpy's pitch: asin(clamp(2 (w y - z x), -1, 1))
QS_FN float pitch(const BaseState& b) {
  return asinf(clamp_nan(rn_mul(2.0f, rn_sub(rn_mul(b.qw, b.qy), rn_mul(b.qz, b.qx))), -1.0f, 1.0f));
}

// 1 - quat_to_mat(q)[2, 2], with R22 = 1 - 2 (x² + y²)
QS_FN float upright(const BaseState& b) {
  return rn_sub(1.0f, rn_sub(1.0f, rn_mul(2.0f, rn_add(rn_mul(b.qx, b.qx), rn_mul(b.qy, b.qy)))));
}

// a1·b2 - a2·b1 as torch.linalg.cross computes a component: one fused
// multiply-add, fma(a1, b2, -(a2·b1)) (its CPU kernel's, held against it on
// 10^5 random inputs; the card's is held by chip_smoke.py's cost checks)
QS_FN float cross_term(float a1, float b2, float a2, float b1) {
  return fmaf(a1, b2, -rn_mul(a2, b1));
}

// quat_rotate_inv(q, ω)[1]: ω_y in the base frame, as spatial.quat_rotate
// computes it for the conjugate (-x, -y, -z, w): t = 2 (v × ω), then
// ω + w t + v × t, its second component
QS_FN float body_pitch_rate(const BaseState& b) {
  const float vx = -b.qx, vy = -b.qy, vz = -b.qz;
  const float t0 = rn_mul(2.0f, cross_term(vy, b.wz, vz, b.wy));
  const float t1 = rn_mul(2.0f, cross_term(vz, b.wx, vx, b.wz));
  const float t2 = rn_mul(2.0f, cross_term(vx, b.wy, vy, b.wx));
  return rn_add(rn_add(b.wy, rn_mul(b.qw, t1)), cross_term(vz, t0, vx, t2));
}

QS_FN float square(float x) { return rn_mul(x, x); }

// the stage cost from the state before the knot; u_sq and qd_sq: the knot's
// sum_fixed(u * u) and sum_fixed(qd ** 2)
QS_FN float stage_cost(int family, const float* w, const BaseState& b, float u_sq,
                       float qd_sq) {
  const float base = rn_add(rn_mul(w[kWu], u_sq), rn_mul(w[kWqd], qd_sq));
  const float* f = w + kFamily0;
  switch (family) {
    case kJumpInPlace:
      // base - (w_h/H)·0.5·apex + 0.15 w_x x² + 0.15 w_pitch pitch²
      return rn_add(rn_add(rn_sub(base, rn_mul(f[0], apex_height(b, w))), rn_mul(f[1], square(b.px))),
                 rn_mul(f[2], square(pitch(b))));
    case kJumpForward:
      // base + 0.15 w_pitch pitch² + 2 y²
      return rn_add(rn_add(base, rn_mul(f[0], square(pitch(b)))), rn_mul(f[1], square(b.py)));
    case kContinuous: {
      // base + 0.25 w_v (vx - v_ref)² + w_pitch pitch² + w_up upright
      //   + 600 clamp_min(0.28 - z, 0)² + w_y (y² + vy²)
      const float z_floor = clamp_min_nan(rn_sub(f[4], b.pz), 0.0f);
      float s = rn_add(base, rn_mul(f[1], square(rn_sub(b.vx, f[0]))));
      s = rn_add(s, rn_mul(f[2], square(pitch(b))));
      s = rn_add(s, rn_mul(f[3], upright(b)));
      s = rn_add(s, rn_mul(f[5], square(z_floor)));
      return rn_add(s, rn_mul(f[6], rn_add(square(b.py), square(b.vy))));
    }
    default:
      // base - 0.2 w_rot (-ω_y)
      return rn_sub(base, rn_mul(f[0], -body_pitch_rate(b)));
  }
}

QS_FN float terminal_cost(int family, const float* w, const BaseState& b) {
  const float* f = w + kFamily0;
  switch (family) {
    case kJumpInPlace:
      // -w_h apex + w_x x² + w_pitch pitch² + w_up upright
      return rn_add(rn_add(rn_add(rn_mul(f[3], apex_height(b, w)), rn_mul(f[4], square(b.px))),
                     rn_mul(f[5], square(pitch(b)))),
                 rn_mul(f[6], upright(b)));
    case kJumpForward: {
      // fwd = x + vx·2·clamp_min(vz, 0)/g;
      // -w_h apex - w_fwd fwd + w_pitch pitch² + w_up upright
      const float fwd = rn_add(b.px, rn_mul(rn_mul(rn_mul(b.vx, 2.0f), clamp_min_nan(b.vz, 0.0f)),
                                      w[kRcpG]));
      return rn_add(rn_add(rn_sub(rn_mul(f[2], apex_height(b, w)), rn_mul(f[3], fwd)),
                     rn_mul(f[4], square(pitch(b)))),
                 rn_mul(f[5], upright(b)));
    }
    case kContinuous:
      // w_h (apex - z_ref)² + w_v (vx - v_ref)² + w_pitch pitch² + 5 w_up upright
      return rn_add(rn_add(rn_add(rn_mul(f[7], square(rn_sub(apex_height(b, w), f[8]))),
                         rn_mul(f[9], square(rn_sub(b.vx, f[0])))),
                     rn_mul(f[2], square(pitch(b)))),
                 rn_mul(f[10], upright(b)));
    default: {
      // swept = -ω_y·2·clamp_min(vz, 0)/g;
      // w_h (apex - 0.7)² - w_rot swept + w_x x²
      const float vz = clamp_min_nan(b.vz, 0.0f);
      const float swept = rn_mul(rn_mul(rn_mul(-body_pitch_rate(b), 2.0f), vz), w[kRcpG]);
      return rn_add(rn_sub(rn_mul(f[1], square(rn_sub(apex_height(b, w), f[2]))), rn_mul(f[3], swept)),
                 rn_mul(f[4], square(b.px)));
    }
  }
}

}  // namespace qs
