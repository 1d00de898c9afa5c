// Reverse mode of go1_dynamics.cuh: the adjoint of each function the
// substep runs, for the env_substeps_vjp kernel (env_lane_vjp.cuh).
//
// Convention: fn_vjp takes fn's inputs (it recomputes what it needs of the
// forward) and the cotangents of fn's outputs, and ADDS the cotangents of
// fn's varying inputs into its reference arguments. Only what varies along
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

// the adjoint of sin_cos at t: cotangents of s and c -> that of t
QS_FN float sin_cos_vjp(float t, float gs, float gc) {
  float s, c;
  sin_cos(t, &s, &c);
  return gs * c - gc * s;
}
QS_FN float rot_x_vjp(float t, const M3& g) {
  // [[1,0,0],[0,c,-s],[0,s,c]]
  return sin_cos_vjp(t, at(g, 2, 1) - at(g, 1, 2), at(g, 1, 1) + at(g, 2, 2));
}
QS_FN float rot_y_vjp(float t, const M3& g) {
  // [[c,0,s],[0,1,0],[-s,0,c]]
  return sin_cos_vjp(t, at(g, 0, 2) - at(g, 2, 0), at(g, 0, 0) + at(g, 2, 2));
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

// x = chol6_solve(S, t, eps): the cotangent of x -> those of S's packed
// lower triangle (gS, 21, written) and t (gt, 6, written), by the adjoint of
// each step of the factorization and the two substitutions
QS_FN void chol6_solve_vjp(const float* S, const float* t, float eps, const float* gx_in,
                           float* gS, float* gt) {
  float L[21], inv[6], piv[6], y[6], x[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = S[tri(j, j)] + eps;
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[tri(j, k)] * L[tri(j, k)];
    piv[j] = s;
    float d = sqrtf(s > 1e-12f ? s : 1e-12f);
    L[tri(j, j)] = d;
    inv[j] = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float v = S[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) v = v - L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = v * inv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = t[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * y[k];
    y[i] = s / L[tri(i, i)];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[tri(k, i)] * x[k];
    x[i] = s / L[tri(i, i)];
  }
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
    gL[tri(i, i)] -= gs * x[i];
    gy[i] += gs;
#pragma unroll
    for (int k = i + 1; k < 6; ++k) {
      gL[tri(k, i)] -= gs * x[k];
      gx[k] -= gs * L[tri(k, i)];
    }
  }
  // forward substitution, y_i = (t_i - Σ_{k<i} L_ik y_k) / L_ii, i = 0 .. 5
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    const float gs = gy[i] / L[tri(i, i)];
    gL[tri(i, i)] -= gs * y[i];
    gt[i] += gs;
#pragma unroll
    for (int k = 0; k < i; ++k) {
      gL[tri(i, k)] -= gs * y[k];
      gy[k] -= gs * L[tri(i, k)];
    }
  }
  // the factorization, column j = 5 .. 0
#pragma unroll
  for (int j = 5; j >= 0; --j) {
    float g_inv = 0.0f;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float v = S[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) v = v - L[tri(i, k)] * L[tri(j, k)];
      const float gv = gL[tri(i, j)] * inv[j];
      g_inv += gL[tri(i, j)] * v;
      gS[tri(i, j)] += gv;
#pragma unroll
      for (int k = 0; k < j; ++k) {
        gL[tri(i, k)] -= gv * L[tri(j, k)];
        gL[tri(j, k)] -= gv * L[tri(i, k)];
      }
    }
    const float d = L[tri(j, j)];
    const float gd = gL[tri(j, j)] - g_inv * inv[j] * inv[j];
    // d = sqrt(max(s, 1e-12)): torch.clamp_min passes at the floor itself
    const float gs = piv[j] >= 1e-12f ? gd * 0.5f / d : 0.0f;
    gS[tri(j, j)] += gs;
#pragma unroll
    for (int k = 0; k < j; ++k) gL[tri(j, k)] -= 2.0f * gs * L[tri(j, k)];
  }
}

// quat_integrate(q, w): the cotangent of the new quaternion (gout) -> += those
// of the old one (gq) and of w
QS_FN void quat_integrate_vjp(const float* q, const V3& w, float half_dt, float half_dt2,
                              const float* gout, float* gq, V3& gw) {
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
  // out = p / |p|
  const float ux = px / norm, uy = py / norm, uz = pz / norm, uw = pw / norm;
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
  if (small) {
    gn2 = half_dt2 * (-half_dt / 6.0f * gk - 0.5f * gc);
  } else {
    const float g_angle = -gk * sin_half / (angle * angle) +
                          half_dt * sin_cos_vjp(half, gk / angle, gc);
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

// L = leg_kinematics(k, hip, thigh, q, bodies): the cotangent of L -> += that
// of the joint angles q
QS_FN void leg_kinematics_vjp(const EnvConsts& k, const V3& thigh, const float* q,
                              const LegBodies& bodies, const Leg& L, LegGrad g, float* gq) {
  const M3 Rx0 = rot_x(q[0]), Ry1 = rot_y(q[1]), Ry2 = rot_y(q[2]);
  const M3 R1 = Rx0;
  const M3 R2 = mul(R1, Ry1);
  const M3 R3 = mul(R2, Ry2);
  const Inertia Ic2 = inertia_add(L.I[1], L.I[2]);
  // the composite columns F_j
  InertiaGrad gIc2 = zero_inertia_grad();
  inertia_matvec_vjp(L.Ic1, L.sw[0], L.sv[0], g.Ft[0], g.Fb[0], g.Ic1, g.sw[0], g.sv[0]);
  inertia_matvec_vjp(Ic2, L.sw[1], L.sv[1], g.Ft[1], g.Fb[1], gIc2, g.sw[1], g.sv[1]);
  inertia_matvec_vjp(L.I[2], L.sw[2], L.sv[2], g.Ft[2], g.Fb[2], g.I[2], g.sw[2], g.sv[2]);
  // Ic1 = I0 + Ic2, Ic2 = I1 + I2
  acc(g.I[0], g.Ic1);
  acc(gIc2, g.Ic1);
  acc(g.I[1], gIc2);
  acc(g.I[2], gIc2);
  // s_j = [axis_j; o_j × axis_j]
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    acc(g.axis[j], g.sw[j]);
    cross_vjp(L.o[j], L.axis[j], g.sv[j], g.o[j], g.axis[j]);
  }
  // the bodies' inertias about the base origin
  M3 gR1 = zero33(), gR2 = zero33(), gR3 = zero33();
  body_inertia_base_vjp(bodies.m[0], bodies.c[0], bodies.I[0], R1, L.o[0], g.I[0], gR1, g.o[0]);
  body_inertia_base_vjp(bodies.m[1], bodies.c[1], bodies.I[1], R2, L.o[1], g.I[1], gR2, g.o[1]);
  body_inertia_base_vjp(bodies.m[2], bodies.c[2], bodies.I[2], R3, L.o[2], g.I[2], gR3, g.o[2]);
  // foot = o2 + R3 foot_c, o2 = o1 + R2 calf, o1 = hip + R1 thigh
  acc(g.o[2], g.foot);
  acc(gR3, outer(g.foot, load3(k.foot)));
  acc(g.o[1], g.o[2]);
  acc(gR2, outer(g.o[2], load3(k.calf)));
  acc(gR1, outer(g.o[1], thigh));
  // axis_1 = column 1 of R1, axis_2 = column 1 of R2
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    add_at(gR1, i, 1, at(g.axis[1], i));
    add_at(gR2, i, 1, at(g.axis[2], i));
  }
  // R3 = R2 Ry(q2), R2 = R1 Ry(q1), R1 = Rx(q0)
  acc(gR2, mul_bt(gR3, Ry2));
  gq[2] += rot_y_vjp(q[2], mul(transpose(R2), gR3));
  acc(gR1, mul_bt(gR2, Ry1));
  gq[1] += rot_y_vjp(q[1], mul(transpose(R1), gR2));
  gq[0] += rot_x_vjp(q[0], gR1);
}

// leg_bias(L, qd, w_b, v_b, g_b) -> (f0t, f0b, h): their cotangents -> += those
// of L (sw, sv, I), qd, w_b, v_b and g_b
QS_FN void leg_bias_vjp(const Leg& L, const float* qd, const V3& w_b, const V3& v_b,
                        const V3& g_b, const V3& gf0t, const V3& gf0b, const float* gh,
                        LegGrad& gL, float* gqd, V3& gw_b, V3& gv_b, V3& gg_b) {
  V3 VW[3], VV[3], AW[3], AV[3], ft[3], fb[3];
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
    VW[j] = vw;
    VV[j] = vv;
    AW[j] = aw;
    AV[j] = av;
  }
  const V3 f1t = add(ft[1], ft[2]), f1b = add(fb[1], fb[2]);
  const V3 f0t = add(ft[0], f1t), f0b = add(fb[0], f1b);
  // h_0 = s_0 · f0, h_1 = s_1 · f1, h_2 = s_2 · f[2]; f1 = f[1] + f[2], f0 = f[0] + f1
  V3 gF0t = gf0t, gF0b = gf0b;
  dot6_vjp(L.sw[0], L.sv[0], f0t, f0b, gh[0], gL.sw[0], gL.sv[0], gF0t, gF0b);
  V3 gF1t = gF0t, gF1b = gF0b;
  dot6_vjp(L.sw[1], L.sv[1], f1t, f1b, gh[1], gL.sw[1], gL.sv[1], gF1t, gF1b);
  V3 gft[3] = {gF0t, gF1t, gF1t}, gfb[3] = {gF0b, gF1b, gF1b};
  dot6_vjp(L.sw[2], L.sv[2], ft[2], fb[2], gh[2], gL.sw[2], gL.sv[2], gft[2], gfb[2]);
  V3 gvw = zero3(), gvv = zero3(), gaw = zero3(), gav = zero3();
#pragma unroll
  for (int j = 2; j >= 0; --j) {
    const V3 sw = L.sw[j], sv = L.sv[j];
    V3 ivt, ivb;
    inertia_matvec(L.I[j], VW[j], VV[j], &ivt, &ivb);
    // f = I a + v ×f* (I v)
    V3 givt = zero3(), givb = zero3();
    cross_force_vjp(VW[j], VV[j], ivt, ivb, gft[j], gfb[j], gvw, gvv, givt, givb);
    inertia_matvec_vjp(L.I[j], AW[j], AV[j], gft[j], gfb[j], gL.I[j], gaw, gav);
    inertia_matvec_vjp(L.I[j], VW[j], VV[j], givt, givb, gL.I[j], gvw, gvv);
    // a_j = a_{j-1} + qd_j [v_j × s_w; v_v × s_w + v_w × s_v]
    const V3 cw = cross(VW[j], sw);
    const V3 cv = add(cross(VV[j], sw), cross(VW[j], sv));
    gqd[j] += dot(gaw, cw) + dot(gav, cv);
    const V3 gcw = scale(qd[j], gaw), gcv = scale(qd[j], gav);
    cross_vjp(VW[j], sw, gcw, gvw, gL.sw[j]);
    cross_vjp(VV[j], sw, gcv, gvv, gL.sw[j]);
    cross_vjp(VW[j], sv, gcv, gvw, gL.sv[j]);
    // v_j = v_{j-1} + qd_j s_j
    gqd[j] += dot(gvw, sw) + dot(gvv, sv);
    acc(gL.sw[j], scale(qd[j], gvw));
    acc(gL.sv[j], scale(qd[j], gvv));
  }
  acc(gw_b, gvw);
  acc(gv_b, gvv);
  acc(gg_b, scale(-1.0f, gav));
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
