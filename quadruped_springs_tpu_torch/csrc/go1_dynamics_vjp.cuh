// Reverse mode of go1_dynamics.cuh: the adjoint of each function the
// substep runs, for the env_substeps_vjp kernel (env_lane_vjp.cuh).
//
// Convention: fn_vjp takes fn's inputs (it recomputes what it needs of the
// forward, or takes it from fn_fwd where the chain is long: chol6_solve's
// factor, quat_integrate's rotation) and the cotangents of fn's outputs, and
// ADDS the cotangents of fn's varying inputs into its reference arguments
// (leg_bias_vjp writes its additions to the shared ones instead, for its
// caller to add where they belong). Only what varies along
// a substep is differentiated: the state, the joint angles and rates, the
// anchors and the commands; the model's masses, COMs, inertias and the
// constants of EnvConsts are not. Branches follow the primal; the
// regularisers (the 1e-9 diagonals, the 1e-12 pivot floor, quat_integrate's
// small-angle branch) are differentiated as the plain PyTorch version's
// autograd differentiates them (env/substeps.py env_substeps_plain).

#pragma once

#include "go1_dynamics.cuh"

namespace qs {

// ---------------------------------------------------------------------------
// 3-vectors and 3x3 matrices
// ---------------------------------------------------------------------------
QS_FN V3 zero3() { return V3{0.0f, 0.0f, 0.0f}; }
QS_FN M3 zero33() { return M3{{zero3(), zero3(), zero3()}}; }
QS_FN void acc(V3& a, const V3& b) { a = add(a, b); }
QS_FN void acc(M3& A, const M3& B) { A = add(A, B); }
// a bᵀ
QS_FN M3 outer(const V3& a, const V3& b) {
  return M3{{scale(a.x, b), scale(a.y, b), scale(a.z, b)}};
}
QS_FN M3 transpose(const M3& M) { return M3{{col(M, 0), col(M, 1), col(M, 2)}}; }
QS_FN void set(V3& a, int i, float v) {
  if (i == 0) a.x = v;
  else if (i == 1) a.y = v;
  else a.z = v;
}
QS_FN void add_at(V3& a, int i, float v) { set(a, i, at(a, i) + v); }
QS_FN void add_at(M3& M, int i, int j, float v) { add_at(M.r[i], j, v); }

// y = M v
QS_FN void mul_vjp(const M3& M, const V3& v, const V3& gy, M3& gM, V3& gv) {
  acc(gM, outer(gy, v));
  acc(gv, mul_t(M, gy));
}
// y = Mᵀ v
QS_FN void mul_t_vjp(const M3& M, const V3& v, const V3& gy, M3& gM, V3& gv) {
  acc(gM, outer(v, gy));
  acc(gv, mul(M, gy));
}
// c = a × b
QS_FN void cross_vjp(const V3& a, const V3& b, const V3& gc, V3& ga, V3& gb) {
  acc(ga, cross(b, gc));
  acc(gb, cross(gc, a));
}
// s = dot6([aw; av], [bw; bv])
QS_FN void dot6_vjp(const V3& aw, const V3& av, const V3& bw, const V3& bv, float gs, V3& gaw,
                    V3& gav, V3& gbw, V3& gbv) {
  acc(gaw, scale(gs, bw));
  acc(gav, scale(gs, bv));
  acc(gbw, scale(gs, aw));
  acc(gbv, scale(gs, av));
}

// quat_to_m3: the cotangent of R -> += that of the xyzw quaternion
QS_FN void quat_to_m3_vjp(const float* q, const M3& g, float* gq) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float g00 = at(g, 0, 0), g01 = at(g, 0, 1), g02 = at(g, 0, 2);
  const float g10 = at(g, 1, 0), g11 = at(g, 1, 1), g12 = at(g, 1, 2);
  const float g20 = at(g, 2, 0), g21 = at(g, 2, 1), g22 = at(g, 2, 2);
  gq[0] += 2.0f * (y * (g01 + g10) + z * (g02 + g20) + w * (g21 - g12)) - 4.0f * x * (g11 + g22);
  gq[1] += 2.0f * (x * (g01 + g10) + z * (g12 + g21) + w * (g02 - g20)) - 4.0f * y * (g00 + g22);
  gq[2] += 2.0f * (x * (g02 + g20) + y * (g12 + g21) + w * (g10 - g01)) - 4.0f * z * (g00 + g11);
  gq[3] += 2.0f * (z * (g10 - g01) + y * (g02 - g20) + x * (g21 - g12));
}

// ---------------------------------------------------------------------------
// Spatial inertias
// ---------------------------------------------------------------------------
// the cotangent of an Inertia's h and A (masses are constants of the model)
struct InertiaGrad {
  V3 h;
  M3 A;
};
QS_FN InertiaGrad zero_inertia_grad() { return InertiaGrad{zero3(), zero33()}; }
QS_FN void acc(InertiaGrad& a, const InertiaGrad& b) {
  acc(a.h, b.h);
  acc(a.A, b.A);
}

// (top, bot) = inertia_matvec(I, w, v)
QS_FN void inertia_matvec_vjp(const Inertia& I, const V3& w, const V3& v, const V3& gtop,
                              const V3& gbot, InertiaGrad& gI, V3& gw, V3& gv) {
  // top = A w + h × v
  mul_vjp(I.A, w, gtop, gI.A, gw);
  cross_vjp(I.h, v, gtop, gI.h, gv);
  // bot = -(h × w) + m v
  cross_vjp(I.h, w, scale(-1.0f, gbot), gI.h, gw);
  acc(gv, scale(I.m, gbot));
}

// (top, bot) = cross_force(vw, vv, fw, fv)
QS_FN void cross_force_vjp(const V3& vw, const V3& vv, const V3& fw, const V3& fv,
                           const V3& gtop, const V3& gbot, V3& gvw, V3& gvv, V3& gfw,
                           V3& gfv) {
  cross_vjp(vw, fw, gtop, gvw, gfw);
  cross_vjp(vv, fv, gtop, gvv, gfv);
  cross_vjp(vw, fv, gbot, gvw, gfv);
}

// body_inertia_base(m, c_loc, Ic_loc, R, o): the cotangent of its h and A ->
// += those of R and o
QS_FN void body_inertia_base_vjp(float m, const V3& c_loc, const M3& Ic_loc, const M3& R,
                                 const V3& o, const InertiaGrad& g, M3& gR, V3& go) {
  const V3 c = add(o, mul(R, c_loc));
  // A = R Ic_loc Rᵀ + m (c·c E - c cᵀ)
  const float tr = at(g.A, 0, 0) + at(g.A, 1, 1) + at(g.A, 2, 2);
  const V3 gc = add(scale(m, g.h),
                    scale(m, sub(scale(2.0f * tr, c), add(mul(g.A, c), mul_t(g.A, c)))));
  acc(go, gc);
  acc(gR, outer(gc, c_loc));
  acc(gR, add(mul(mul(g.A, R), transpose(Ic_loc)), mul(mul(transpose(g.A), R), Ic_loc)));
}

// entry (a, b) of inertia6(I): its cotangent g -> += that of I's h or A
QS_FN void inertia6_vjp(int a, int b, float g, InertiaGrad& gI) {
  if (a < 3 && b < 3) {
    add_at(gI.A, a, b, g);
    return;
  }
  if (a >= 3 && b >= 3) return;   // the mass
  const int i = a < 3 ? a : a - 3, j = a < 3 ? b - 3 : b;
  const float s = a < 3 ? g : -g;   // the block is h×, or its transpose -h×
  // h× = [[0, -hz, hy], [hz, 0, -hx], [-hy, hx, 0]]
  if (i == 0 && j == 1) add_at(gI.h, 2, -s);
  if (i == 0 && j == 2) add_at(gI.h, 1, s);
  if (i == 1 && j == 0) add_at(gI.h, 2, s);
  if (i == 1 && j == 2) add_at(gI.h, 0, -s);
  if (i == 2 && j == 0) add_at(gI.h, 1, -s);
  if (i == 2 && j == 1) add_at(gI.h, 0, s);
}

// the trunk's bias force (ht, hb) = trunk_bias(T, w_b, v_b, g_b)
QS_FN void trunk_bias_vjp(const Inertia& T, const V3& w_b, const V3& v_b, const V3& g_b,
                          const V3& ght, const V3& ghb, V3& gw_b, V3& gv_b, V3& gg_b) {
  V3 ivt, ivb;
  inertia_matvec(T, w_b, v_b, &ivt, &ivb);
  InertiaGrad unused = zero_inertia_grad();
  V3 givt = zero3(), givb = zero3(), gaw = zero3(), gav = zero3();
  // ht = I a_w + xt, hb = I a_v + xb, a = [0; -g_b]
  cross_force_vjp(w_b, v_b, ivt, ivb, ght, ghb, gw_b, gv_b, givt, givb);
  inertia_matvec_vjp(T, zero3(), scale(-1.0f, g_b), ght, ghb, unused, gaw, gav);
  acc(gg_b, scale(-1.0f, gav));
  inertia_matvec_vjp(T, w_b, v_b, givt, givb, unused, gw_b, gv_b);
}

// ---------------------------------------------------------------------------
// Small dense solves
// ---------------------------------------------------------------------------

// M = sym3_inv(d00, d01, d02, d11, d12, d22, eps): the cotangent of M (all
// nine entries) -> += those of the six d (d00 d01 d02 d11 d12 d22)
QS_FN void sym3_inv_vjp(float d00, float d01, float d02, float d11, float d12, float d22,
                        float eps, const M3& g, float* gd) {
  const float a = d00 + eps, b = d01, c = d02, d = d11 + eps, e = d12, f = d22 + eps;
  const float A = d * f - e * e;
  const float B = c * e - b * f;
  const float C = b * e - c * d;
  const float P = a * f - c * c, Q = b * c - a * e, U = a * d - b * b;
  const float det = a * A + b * B + c * C;
  const float inv = 1.0f / det;
  const float sA = at(g, 0, 0), sB = at(g, 0, 1) + at(g, 1, 0), sC = at(g, 0, 2) + at(g, 2, 0);
  const float sP = at(g, 1, 1), sQ = at(g, 1, 2) + at(g, 2, 1), sU = at(g, 2, 2);
  const float g_inv = sA * A + sB * B + sC * C + sP * P + sQ * Q + sU * U;
  const float g_det = -g_inv * inv * inv;
  float gA = sA * inv + g_det * a, gB = sB * inv + g_det * b, gC = sC * inv + g_det * c;
  const float gP = sP * inv, gQ = sQ * inv, gU = sU * inv;
  float ga = g_det * A, gb = g_det * B, gc = g_det * C, gdd = 0.0f, ge = 0.0f, gf = 0.0f;
  // A = d f - e e, B = c e - b f, C = b e - c d
  gdd += gA * f; gf += gA * d; ge -= 2.0f * e * gA;
  gc += gB * e; ge += gB * c; gb -= gB * f; gf -= gB * b;
  gb += gC * e; ge += gC * b; gc -= gC * d; gdd -= gC * c;
  // P = a f - c c, Q = b c - a e, U = a d - b b
  ga += gP * f; gf += gP * a; gc -= 2.0f * c * gP;
  gb += gQ * c; gc += gQ * b; ga -= gQ * e; ge -= gQ * a;
  ga += gU * d; gdd += gU * a; gb -= 2.0f * b * gU;
  gd[0] += ga; gd[1] += gb; gd[2] += gc; gd[3] += gdd; gd[4] += ge; gd[5] += gf;
}

// What the adjoint of chol6_solve(S, t, eps) reads of its forward: the
// factor L (packed lower triangle), the reciprocals of its diagonal, the
// pivots before their floor, the two substitutions' y and x, and each
// sub-diagonal entry before its scaling by the pivot's reciprocal (v, in
// column order). Computed off the adjoint's chain by chol6_fwd, with
// chol6_solve's operations in its order: x is chol6_solve's answer bitwise.
struct Chol6Fwd {
  float L[21], inv[6], piv[6], y[6], x[6], v[15];
};

QS_FN void chol6_fwd(const float* S, const float* t, float eps, Chol6Fwd& f) {
  int e = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = S[tri(j, j)] + eps;
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - f.L[tri(j, k)] * f.L[tri(j, k)];
    f.piv[j] = s;
    float d = sqrtf(s > 1e-12f ? s : 1e-12f);
    f.L[tri(j, j)] = d;
    f.inv[j] = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i, ++e) {
      float v = S[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) v = v - f.L[tri(i, k)] * f.L[tri(j, k)];
      f.v[e] = v;
      f.L[tri(i, j)] = v * f.inv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = t[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - f.L[tri(i, k)] * f.y[k];
    f.y[i] = s / f.L[tri(i, i)];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = f.y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - f.L[tri(k, i)] * f.x[k];
    f.x[i] = s / f.L[tri(i, i)];
  }
}

// index in Chol6Fwd::v of entry (i, j), i > j
QS_FN constexpr int chol6_v(int i, int j) { return j * 5 - j * (j - 1) / 2 + (i - j - 1); }

// x = chol6_solve(S, t, eps), its forward f (chol6_fwd): the cotangent of x
// -> those of S's packed lower triangle (gS, 21, written) and t (gt, 6,
// written), by the adjoint of each step of the factorization and the two
// substitutions
QS_FN void chol6_solve_vjp(const Chol6Fwd& f, const float* gx_in, float* gS, float* gt) {
  const float* L = f.L;
  float gL[21], gx[6], gy[6];
#pragma unroll
  for (int i = 0; i < 21; ++i) {
    gL[i] = 0.0f;
    gS[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    gx[i] = gx_in[i];
    gy[i] = 0.0f;
    gt[i] = 0.0f;
  }
  // back substitution, x_i = (y_i - Σ_{k>i} L_ki x_k) / L_ii, i = 5 .. 0
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float gs = gx[i] / L[tri(i, i)];
    gL[tri(i, i)] -= gs * f.x[i];
    gy[i] += gs;
#pragma unroll
    for (int k = i + 1; k < 6; ++k) {
      gL[tri(k, i)] -= gs * f.x[k];
      gx[k] -= gs * L[tri(k, i)];
    }
  }
  // forward substitution, y_i = (t_i - Σ_{k<i} L_ik y_k) / L_ii, i = 0 .. 5
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    const float gs = gy[i] / L[tri(i, i)];
    gL[tri(i, i)] -= gs * f.y[i];
    gt[i] += gs;
#pragma unroll
    for (int k = 0; k < i; ++k) {
      gL[tri(i, k)] -= gs * f.y[k];
      gy[k] -= gs * L[tri(i, k)];
    }
  }
  // the factorization, column j = 5 .. 0
#pragma unroll
  for (int j = 5; j >= 0; --j) {
    float g_inv = 0.0f;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      const float gv = gL[tri(i, j)] * f.inv[j];
      g_inv += gL[tri(i, j)] * f.v[chol6_v(i, j)];
      gS[tri(i, j)] += gv;
#pragma unroll
      for (int k = 0; k < j; ++k) {
        gL[tri(i, k)] -= gv * L[tri(j, k)];
        gL[tri(j, k)] -= gv * L[tri(i, k)];
      }
    }
    const float d = L[tri(j, j)];
    const float gd = gL[tri(j, j)] - g_inv * f.inv[j] * f.inv[j];
    // d = sqrt(max(s, 1e-12)): torch.clamp_min passes at the floor itself
    const float gs = f.piv[j] >= 1e-12f ? gd * 0.5f / d : 0.0f;
    gS[tri(j, j)] += gs;
#pragma unroll
    for (int k = 0; k < j; ++k) gL[tri(j, k)] -= 2.0f * gs * L[tri(j, k)];
  }
}

// What the adjoint of quat_integrate(q, w) reads of its forward, computed
// off the adjoint's chain by quat_integrate_fwd with quat_integrate's
// operations in its order
struct QuatIntFwd {
  float small, angle, half, sin_half, cos_half, k;   // small: 1 below |w|^2 = 1e-14
  float x2, y2, z2, w2;                              // dq = [w k; c]
  float norm, ux, uy, uz, uw;                        // p = q ⊗ dq, out = p / |p|
};

QS_FN void quat_integrate_fwd(const float* q, const V3& w, float half_dt, float half_dt2,
                              QuatIntFwd& f) {
  float n2 = w.x * w.x + w.y * w.y;
  n2 = n2 + w.z * w.z;
  const bool small = n2 < 1e-14f;
  const float angle = sqrtf(small ? 1.0f : n2);
  const float half = half_dt * angle;
  const float h2 = half_dt2 * n2;
  float sin_half, cos_half;
  sin_cos(half, &sin_half, &cos_half);
  const float k = small ? half_dt * (1.0f - h2 / 6.0f) : sin_half / angle;
  const float c = small ? 1.0f - h2 / 2.0f : cos_half;
  const float x2 = w.x * k, y2 = w.y * k, z2 = w.z * k, w2 = c;
  const float x1 = q[0], y1 = q[1], z1 = q[2], w1 = q[3];
  const float px = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  const float py = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  const float pz = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  const float pw = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  const float norm = sqrtf(((px * px + py * py) + pz * pz) + pw * pw);
  f.small = small ? 1.0f : 0.0f;
  f.angle = angle;
  f.half = half;
  f.sin_half = sin_half;
  f.cos_half = cos_half;
  f.k = k;
  f.x2 = x2;
  f.y2 = y2;
  f.z2 = z2;
  f.w2 = w2;
  f.norm = norm;
  f.ux = px / norm;
  f.uy = py / norm;
  f.uz = pz / norm;
  f.uw = pw / norm;
}

// quat_integrate(q, w), its forward f (quat_integrate_fwd): the cotangent of
// the new quaternion (gout) -> += those of the old one (gq) and of w
QS_FN void quat_integrate_vjp(const QuatIntFwd& f, const float* q, const V3& w, float half_dt,
                              float half_dt2, const float* gout, float* gq, V3& gw) {
  const float x2 = f.x2, y2 = f.y2, z2 = f.z2, w2 = f.w2, k = f.k, norm = f.norm;
  const float ux = f.ux, uy = f.uy, uz = f.uz, uw = f.uw;
  const float x1 = q[0], y1 = q[1], z1 = q[2], w1 = q[3];
  // out = p / |p|
  const float proj = ux * gout[0] + uy * gout[1] + uz * gout[2] + uw * gout[3];
  const float gpx = (gout[0] - ux * proj) / norm, gpy = (gout[1] - uy * proj) / norm;
  const float gpz = (gout[2] - uz * proj) / norm, gpw = (gout[3] - uw * proj) / norm;
  // p = q ⊗ dq
  gq[0] += gpx * w2 - gpy * z2 + gpz * y2 - gpw * x2;
  gq[1] += gpx * z2 + gpy * w2 - gpz * x2 - gpw * y2;
  gq[2] += -gpx * y2 + gpy * x2 + gpz * w2 - gpw * z2;
  gq[3] += gpx * x2 + gpy * y2 + gpz * z2 + gpw * w2;
  const float gx2 = gpx * w1 + gpy * z1 - gpz * y1 - gpw * x1;
  const float gy2 = -gpx * z1 + gpy * w1 + gpz * x1 - gpw * y1;
  const float gz2 = gpx * y1 - gpy * x1 + gpz * w1 - gpw * z1;
  const float gc = gpx * x1 + gpy * y1 + gpz * z1 + gpw * w1;
  // dq = [w k; c]
  const float gk = gx2 * w.x + gy2 * w.y + gz2 * w.z;
  acc(gw, scale(k, v3(gx2, gy2, gz2)));
  float gn2;
  if (f.small != 0.0f) {
    gn2 = half_dt2 * (-half_dt / 6.0f * gk - 0.5f * gc);
  } else {
    const float angle = f.angle;
    // sin_cos_vjp(half, gk / angle, gc) on the forward's sine and cosine
    const float gs = gk / angle;
    const float g_half = gs * f.cos_half - gc * f.sin_half;
    const float g_angle = -gk * f.sin_half / (angle * angle) + half_dt * g_half;
    gn2 = g_angle * 0.5f / angle;
  }
  acc(gw, scale(2.0f * gn2, w));
}

// ---------------------------------------------------------------------------
// One leg's articulated quantities
// ---------------------------------------------------------------------------

// the cotangent of a Leg (what its consumers read of it)
struct LegGrad {
  V3 o[3], axis[3], sw[3], sv[3];
  InertiaGrad I[3], Ic1;
  V3 Ft[3], Fb[3], foot;
};

QS_FN LegGrad zero_leg_grad() {
  LegGrad g;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.o[j] = g.axis[j] = g.sw[j] = g.sv[j] = g.Ft[j] = g.Fb[j] = zero3();
    g.I[j] = zero_inertia_grad();
  }
  g.Ic1 = zero_inertia_grad();
  g.foot = zero3();
  return g;
}

// rot_x(t) and rot_y(t) from t's sine and cosine
QS_FN M3 rot_x_sc(float s, float c) {
  return M3{{v3(1.0f, 0.0f, 0.0f), v3(0.0f, c, -s), v3(0.0f, s, c)}};
}
QS_FN M3 rot_y_sc(float s, float c) {
  return M3{{v3(c, 0.0f, s), v3(0.0f, 1.0f, 0.0f), v3(-s, 0.0f, c)}};
}

// What the adjoint of L = leg_kinematics(k, hip, thigh, q, bodies) reads of
// its forward: the joints' sines and cosines and the rotations R2 = R1
// Ry(q1), R3 = R2 Ry(q2) (leg_kinematics_fwd), and Ic2 = I1 + I2, which the
// caller takes as leg_kinematics computed it
struct LegKinFwd {
  float s[3], c[3];
  M3 R2, R3;
};

QS_FN void leg_kinematics_fwd(const float* q, LegKinFwd& f) {
#pragma unroll
  for (int j = 0; j < 3; ++j) sin_cos(q[j], &f.s[j], &f.c[j]);
  const M3 R1 = rot_x_sc(f.s[0], f.c[0]);
  f.R2 = mul(R1, rot_y_sc(f.s[1], f.c[1]));
  f.R3 = mul(f.R2, rot_y_sc(f.s[2], f.c[2]));
}

// The adjoint of leg_kinematics in three parts, run for j = 0, 1, 2 beside
// each other where the caller has three threads for them, then the chain:
// (a) column j: F_j = Ic_j s_j (Ic_0 = Ic1, Ic_1 = Ic2, Ic_2 = I2) and s_j =
// [axis_j; o_j × axis_j]: the cotangent of F_j -> += those of Ic_j (gI),
// s_j (gsw, gsv) and through s_j those of axis_j and o_j
QS_FN void leg_column_vjp(const Inertia& Ic, const V3& sw, const V3& sv, const V3& o,
                          const V3& axis, const V3& gFt, const V3& gFb, InertiaGrad& gI,
                          V3& gsw, V3& gsv, V3& gaxis, V3& go) {
  inertia_matvec_vjp(Ic, sw, sv, gFt, gFb, gI, gsw, gsv);
  acc(gaxis, gsw);
  cross_vjp(o, axis, gsv, go, gaxis);
}

// (b) body k's inertia about the base origin, from the cotangents the
// columns left: gIc1 and gIc2 the composites' (Ic1 = I0 + Ic2, Ic2 = I1 +
// I2), gIk body k's own (gI2 with column 2's): -> R_k's cotangent (gR, +=)
// and += o_k's
QS_FN void leg_body_vjp(int k, const LegBodies& bodies, const M3& R, const V3& o,
                        const InertiaGrad& gIc1, const InertiaGrad& gIc2, InertiaGrad gIk,
                        M3& gR, V3& go) {
  if (k == 0) {
    acc(gIk, gIc1);
  } else {
    InertiaGrad g2 = gIc2;
    acc(g2, gIc1);
    acc(gIk, g2);
  }
  body_inertia_base_vjp(bodies.m[k], bodies.c[k], bodies.I[k], R, o, gIk, gR, go);
}

// (c) foot = o2 + R3 foot_c, o2 = o1 + R2 calf, o1 = hip + R1 thigh, the
// axes columns 1 of R1 and R2, R3 = R2 Ry(q2), R2 = R1 Ry(q1), R1 = Rx(q0):
// the cotangents of the bodies' rotations (gR1-3), of o1 and o2 (after (b)),
// of the foot and of axis_1 and axis_2 -> += that of the joint angles q
QS_FN void leg_chain_vjp(const EnvConsts& k, const V3& thigh, const LegKinFwd& f, M3 gR1,
                         M3 gR2, M3 gR3, V3 g_o1, V3 g_o2, const V3& g_foot,
                         const V3& g_axis1, const V3& g_axis2, float* gq) {
  const M3 R1 = rot_x_sc(f.s[0], f.c[0]);
  acc(g_o2, g_foot);
  acc(gR3, outer(g_foot, load3(k.foot)));
  acc(g_o1, g_o2);
  acc(gR2, outer(g_o2, load3(k.calf)));
  acc(gR1, outer(g_o1, thigh));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    add_at(gR1, i, 1, at(g_axis1, i));
    add_at(gR2, i, 1, at(g_axis2, i));
  }
  // rot_y_vjp / rot_x_vjp on the forward's sine and cosine
  acc(gR2, mul_bt(gR3, rot_y_sc(f.s[2], f.c[2])));
  M3 g = mul(transpose(f.R2), gR3);
  gq[2] += (at(g, 0, 2) - at(g, 2, 0)) * f.c[2] - (at(g, 0, 0) + at(g, 2, 2)) * f.s[2];
  acc(gR1, mul_bt(gR2, rot_y_sc(f.s[1], f.c[1])));
  g = mul(transpose(R1), gR2);
  gq[1] += (at(g, 0, 2) - at(g, 2, 0)) * f.c[1] - (at(g, 0, 0) + at(g, 2, 2)) * f.s[1];
  gq[0] += (at(gR1, 2, 1) - at(gR1, 1, 2)) * f.c[0] - (at(gR1, 1, 1) + at(gR1, 2, 2)) * f.s[0];
}

// What leg_bias_vjp reads of its forward, the RNEA along the leg
// (leg_bias_fwd, with leg_bias's operations): the bodies' velocities and
// accelerations, I v, the velocity products and the forces
struct LegBiasFwd {
  V3 VW[3], VV[3], AW[3], AV[3], ivt[3], ivb[3], cw[3], cv[3];
  V3 f0t, f0b, f1t, f1b, ft2, fb2;
};

QS_FN void leg_bias_fwd(const Leg& L, const float* qd, const V3& w_b, const V3& v_b,
                        const V3& g_b, LegBiasFwd& f) {
  V3 ft[3], fb[3];
  V3 vw = w_b, vv = v_b;
  V3 aw = zero3();
  V3 av = scale(-1.0f, g_b);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    vw = add(vw, scale(qd[j], L.sw[j]));
    vv = add(vv, scale(qd[j], L.sv[j]));
    V3 cw = cross(vw, L.sw[j]);
    V3 cv = add(cross(vv, L.sw[j]), cross(vw, L.sv[j]));
    aw = add(aw, scale(qd[j], cw));
    av = add(av, scale(qd[j], cv));
    V3 ivt, ivb, iat, iab, xt, xb;
    inertia_matvec(L.I[j], vw, vv, &ivt, &ivb);
    inertia_matvec(L.I[j], aw, av, &iat, &iab);
    cross_force(vw, vv, ivt, ivb, &xt, &xb);
    ft[j] = add(iat, xt);
    fb[j] = add(iab, xb);
    f.VW[j] = vw;
    f.VV[j] = vv;
    f.AW[j] = aw;
    f.AV[j] = av;
    f.ivt[j] = ivt;
    f.ivb[j] = ivb;
    f.cw[j] = cw;
    f.cv[j] = cv;
  }
  f.f1t = add(ft[1], ft[2]);
  f.f1b = add(fb[1], fb[2]);
  f.f0t = add(ft[0], f.f1t);
  f.f0b = add(fb[0], f.f1b);
  f.ft2 = ft[2];
  f.fb2 = fb[2];
}

// What leg_bias_vjp adds to the cotangent of the motion subspaces s_j =
// [sw_j; sv_j] besides its h terms, recorded per joint in the order it adds
// them: xw1 and xw2 to sw_j, xv1 to sv_j, then qd_j gvw and qd_j gvv
struct LegBiasTerms {
  V3 xw1[3], xw2[3], xv1[3], gvw[3], gvv[3];
};

// leg_bias(L, qd, w_b, v_b, g_b) -> (f0t, f0b, h), its forward f
// (leg_bias_fwd): their cotangents -> += those of the bodies' inertias
// (gI[3]); and, written, what it adds to the cotangents that other stages
// also add to, so that it can run beside them: s_j's (t, for
// leg_bias_vjp_apply), joint j's rate (gqd_a[j], then gqd_v[j]), w_b's
// (gvw), v_b's (gvv) and g_b's (-gav)
QS_FN void leg_bias_vjp(const LegBiasFwd& f, const Leg& L, const float* qd, const V3& gf0t,
                        const V3& gf0b, const float* gh, InertiaGrad* gI, LegBiasTerms& t,
                        float* gqd_a, float* gqd_v, V3& gvw, V3& gvv, V3& gav) {
  // h_0 = s_0 · f0, h_1 = s_1 · f1, h_2 = s_2 · f[2]; f1 = f[1] + f[2], f0 = f[0] + f1
  // (their terms in s_j's cotangent: leg_bias_vjp_apply)
  const V3 gF0t = add(gf0t, scale(gh[0], L.sw[0])), gF0b = add(gf0b, scale(gh[0], L.sv[0]));
  const V3 gF1t = add(gF0t, scale(gh[1], L.sw[1])), gF1b = add(gF0b, scale(gh[1], L.sv[1]));
  V3 gft[3] = {gF0t, gF1t, gF1t}, gfb[3] = {gF0b, gF1b, gF1b};
  acc(gft[2], scale(gh[2], L.sw[2]));
  acc(gfb[2], scale(gh[2], L.sv[2]));
  V3 gaw = zero3();
  gvw = gvv = gav = zero3();
#pragma unroll
  for (int j = 2; j >= 0; --j) {
    const V3 sw = L.sw[j], sv = L.sv[j];
    // f = I a + v ×f* (I v)
    V3 givt = zero3(), givb = zero3();
    cross_force_vjp(f.VW[j], f.VV[j], f.ivt[j], f.ivb[j], gft[j], gfb[j], gvw, gvv, givt, givb);
    inertia_matvec_vjp(L.I[j], f.AW[j], f.AV[j], gft[j], gfb[j], gI[j], gaw, gav);
    inertia_matvec_vjp(L.I[j], f.VW[j], f.VV[j], givt, givb, gI[j], gvw, gvv);
    // a_j = a_{j-1} + qd_j [v_j × s_w; v_v × s_w + v_w × s_v]
    gqd_a[j] = dot(gaw, f.cw[j]) + dot(gav, f.cv[j]);
    const V3 gcw = scale(qd[j], gaw), gcv = scale(qd[j], gav);
    // cross_vjp(VW, sw, gcw, gvw, gsw), cross_vjp(VV, sw, gcv, gvv, gsw),
    // cross_vjp(VW, sv, gcv, gvw, gsv)
    acc(gvw, cross(sw, gcw));
    t.xw1[j] = cross(gcw, f.VW[j]);
    acc(gvv, cross(sw, gcv));
    t.xw2[j] = cross(gcv, f.VV[j]);
    acc(gvw, cross(sv, gcv));
    t.xv1[j] = cross(gcv, f.VW[j]);
    // v_j = v_{j-1} + qd_j s_j
    gqd_v[j] = dot(gvw, sw) + dot(gvv, sv);
    t.gvw[j] = gvw;
    t.gvv[j] = gvv;
  }
}

// leg_bias_vjp's additions to s_j's cotangent (gsw, gsv), in its order: the
// h term, then the terms t recorded
QS_FN void leg_bias_vjp_apply(const LegBiasFwd& f, const float* qd, const float* gh,
                              const LegBiasTerms& t, int j, V3& gsw, V3& gsv) {
  const V3 ft = j == 0 ? f.f0t : (j == 1 ? f.f1t : f.ft2);
  const V3 fb = j == 0 ? f.f0b : (j == 1 ? f.f1b : f.fb2);
  acc(gsw, scale(gh[j], ft));
  acc(gsv, scale(gh[j], fb));
  acc(gsw, t.xw1[j]);
  acc(gsw, t.xw2[j]);
  acc(gsv, t.xv1[j]);
  acc(gsw, scale(qd[j], t.gvw[j]));
  acc(gsv, scale(qd[j], t.gvv[j]));
}

// y = leg_point_velocity(L, qd, pt, w_b, v_b): its cotangent -> += those of
// qd, pt, L (axis, o), w_b and v_b
QS_FN void leg_point_velocity_vjp(const Leg& L, const float* qd, const V3& pt, const V3& w_b,
                                  const V3& gy, float* gqd, V3& gpt, LegGrad& gL, V3& gw_b,
                                  V3& gv_b) {
  acc(gv_b, gy);
  cross_vjp(w_b, pt, gy, gw_b, gpt);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const V3 arm = sub(pt, L.o[j]);
    gqd[j] += dot(gy, cross(L.axis[j], arm));
    V3 garm = zero3();
    cross_vjp(L.axis[j], arm, scale(qd[j], gy), gL.axis[j], garm);
    acc(gpt, garm);
    acc(gL.o[j], scale(-1.0f, garm));
  }
}

// joint_limit_torque(k, j, q, qd): its cotangent -> += those of q and qd
// (torch.clamp_min passes at the limit itself)
QS_FN void joint_limit_torque_vjp(const EnvConsts& k, int j, float q, float qd, float g,
                                  float* gq, float* gqd) {
  const float over = q - k.real_upper[j];
  const float under = k.real_lower[j] - q;
  if (over >= 0.0f) *gq -= k.jl_k * g;
  if (under >= 0.0f) *gq -= k.jl_k * g;
  const bool active = over > 0.0f || under > 0.0f;
  if (active) *gqd -= k.jl_d * g;
}

}  // namespace qs
