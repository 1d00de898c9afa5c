// The Go1 forward dynamics as device functions, in the star layout of one
// leg per thread: forward kinematics, the CRBA and RNEA terms of a leg, its
// contact sites, the 3x3 and 6x6 solves and the semi-implicit Euler update.
//
// Blueprint: quadruped_springs_tpu/models/dynamics_soa.py (the scalarized
// TPU hot path: the v3/m3 algebra :34-135, body_inertia_base :137, sym3_inv
// :153, chol6_solve :170, _leg_kinematics :240, the spatial cross products
// :277-284, forward_dynamics_soa :305-568), whose order of operations the
// functions keep. Spec: quadruped_springs_tpu_torch/models/dynamics.py
// (_forward, step), whose recorded choices they keep where the two JAX paths
// differ: the anchors' |f_trial|^2 floor of 1e-12 (elems.cuh), 1e-9 on the
// 3x3 and 6x6 diagonals, 6x6 pivots floored at 1e-12, the friction norm
// floored at |v_t|^2 = 1e-12, quat_integrate's small-angle branch below
// |w|^2 = 1e-14, the damping clamp as a flag.
//
// The Go1 is a star: a leg's kinematics, inertias, bias force, sites and
// 3x3 block depend only on that leg and the base motion, so each leg is one
// thread; what the base needs from the legs is summed over the four threads
// of an environment (env_lane.cuh). Structures are small aggregates of
// floats that the compiler keeps in registers (every index is a constant
// after unrolling).

#pragma once

#include "elems.cuh"

namespace qs {

// ---------------------------------------------------------------------------
// 3-vectors and 3x3 matrices (dynamics_soa.py:34-135)
// ---------------------------------------------------------------------------
struct V3 {
  float x, y, z;
};
struct M3 {
  V3 r[3];  // rows
};

QS_FN V3 v3(float x, float y, float z) { return V3{x, y, z}; }
QS_FN V3 load3(const float* p) { return V3{p[0], p[1], p[2]}; }
QS_FN float at(const V3& a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }
QS_FN V3 add(const V3& a, const V3& b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
QS_FN V3 sub(const V3& a, const V3& b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
QS_FN V3 scale(float s, const V3& a) { return V3{s * a.x, s * a.y, s * a.z}; }
QS_FN float dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
QS_FN V3 cross(const V3& a, const V3& b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
QS_FN V3 col(const M3& M, int j) { return V3{at(M.r[0], j), at(M.r[1], j), at(M.r[2], j)}; }
// M v
QS_FN V3 mul(const M3& M, const V3& v) {
  return V3{dot(M.r[0], v), dot(M.r[1], v), dot(M.r[2], v)};
}
// Mᵀ v
QS_FN V3 mul_t(const M3& M, const V3& v) {
  return V3{M.r[0].x * v.x + M.r[1].x * v.y + M.r[2].x * v.z,
            M.r[0].y * v.x + M.r[1].y * v.y + M.r[2].y * v.z,
            M.r[0].z * v.x + M.r[1].z * v.y + M.r[2].z * v.z};
}
// A B
QS_FN M3 mul(const M3& A, const M3& B) {
  M3 out;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out.r[i] = V3{dot(A.r[i], col(B, 0)), dot(A.r[i], col(B, 1)), dot(A.r[i], col(B, 2))};
  return out;
}
// A Bᵀ
QS_FN M3 mul_bt(const M3& A, const M3& B) {
  M3 out;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out.r[i] = V3{dot(A.r[i], B.r[0]), dot(A.r[i], B.r[1]), dot(A.r[i], B.r[2])};
  return out;
}
QS_FN M3 add(const M3& A, const M3& B) {
  return M3{{add(A.r[0], B.r[0]), add(A.r[1], B.r[1]), add(A.r[2], B.r[2])}};
}
QS_FN M3 load33(const float* p) { return M3{{load3(p), load3(p + 3), load3(p + 6)}}; }
QS_FN float at(const M3& M, int i, int j) { return at(M.r[i], j); }

// sin and cos of t by one sincosf: one argument reduction, and bitwise
// sinf(t) and cosf(t) (all 2^32 inputs held against them on the card by
// tests/torch_env_design_probe.py)
QS_FN void sin_cos(float t, float* s, float* c) {
#if defined(__CUDACC__)
  sincosf(t, s, c);
#else
  *s = sinf(t);
  *c = cosf(t);
#endif
}

QS_FN M3 rot_x(float t) {
  float s, c;
  sin_cos(t, &s, &c);
  return M3{{v3(1.0f, 0.0f, 0.0f), v3(0.0f, c, -s), v3(0.0f, s, c)}};
}
QS_FN M3 rot_y(float t) {
  float s, c;
  sin_cos(t, &s, &c);
  return M3{{v3(c, 0.0f, s), v3(0.0f, 1.0f, 0.0f), v3(-s, 0.0f, c)}};
}

// xyzw quaternion -> body-to-world rotation (spatial.quat_to_mat)
QS_FN M3 quat_to_m3(const float* q) {
  float x = q[0], y = q[1], z = q[2], w = q[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  return M3{{v3(1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
             v3(2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
             v3(2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))}};
}

// q ⊗ dq then normalised: spatial.quat_integrate with its small-angle
// branch below |w|^2 = 1e-14. half_dt = f32(0.5 dt), half_dt2 =
// f32((0.5 dt)^2), rounded from double as PyTorch rounds a Python scalar.
QS_FN void quat_integrate(float* q, const V3& w, float half_dt, float half_dt2) {
  float n2 = w.x * w.x + w.y * w.y;
  n2 = n2 + w.z * w.z;
  bool small = n2 < 1e-14f;
  float angle = sqrtf(small ? 1.0f : n2);
  float half = half_dt * angle;
  float h2 = half_dt2 * n2;
  float sin_half, cos_half;
  sin_cos(half, &sin_half, &cos_half);
  float k = small ? half_dt * (1.0f - h2 / 6.0f) : sin_half / angle;
  float c = small ? 1.0f - h2 / 2.0f : cos_half;
  float x2 = w.x * k, y2 = w.y * k, z2 = w.z * k, w2 = c;
  float x1 = q[0], y1 = q[1], z1 = q[2], w1 = q[3];
  float x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  float y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  float z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  float ww = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  float norm = sqrtf(((x * x + y * y) + z * z) + ww * ww);
  q[0] = x / norm;
  q[1] = y / norm;
  q[2] = z / norm;
  q[3] = ww / norm;
}

// a·b rounded on its own, never contracted into a multiply-add with the sum
// it feeds (__fmul_rn on the card)
QS_FN float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// ---------------------------------------------------------------------------
// Spatial inertias as (m, h = m·com, A = inertia about the base origin)
// ---------------------------------------------------------------------------
struct Inertia {
  float m;
  V3 h;
  M3 A;
};

QS_FN Inertia inertia_add(const Inertia& a, const Inertia& b) {
  return Inertia{a.m + b.m, add(a.h, b.h), add(a.A, b.A)};
}

// I6 [w; v] = [A w + h × v; -(h × w) + m v]
QS_FN void inertia_matvec(const Inertia& I, const V3& w, const V3& v, V3* top, V3* bot) {
  *top = add(mul(I.A, w), cross(I.h, v));
  *bot = add(scale(-1.0f, cross(I.h, w)), scale(I.m, v));
}

// a body of mass m, local COM c and local inertia about its COM Ic, placed
// at rotation R and origin o in base coordinates (dynamics_soa.py:137).
// kHip: the hip body, whose R turns about x, so that its COM's c.x and the
// products m·c.x and c.x·c.x are constants of the model: a kernel that
// holds the model in registers computes them once before its loop, where
// nothing can contract them into the sums they feed; mul_rn rounds them
// alike where the model is read from memory inside the loop
// (planner_rollout), so both kernels keep the same rounding.
template <bool kHip = false>
QS_FN Inertia body_inertia_base(float m, const V3& c_loc, const M3& Ic_loc, const M3& R,
                                const V3& o) {
  V3 c = add(o, mul(R, c_loc));
  M3 Ic = mul_bt(mul(R, Ic_loc), R);
  float cxx = kHip ? mul_rn(c.x, c.x) : c.x * c.x;
  float cc = cxx + c.y * c.y + c.z * c.z;
  Inertia out;
  out.m = m;
  out.h = scale(m, c);
  if (kHip) out.h.x = mul_rn(m, c.x);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float ci = at(c, i);
    out.A.r[i] = v3(at(Ic, i, 0) + m * ((i == 0 ? cc : 0.0f) - (i == 0 ? cxx : ci * c.x)),
                    at(Ic, i, 1) + m * ((i == 1 ? cc : 0.0f) - ci * c.y),
                    at(Ic, i, 2) + m * ((i == 2 ? cc : 0.0f) - ci * c.z));
  }
  return out;
}

// the inertia about a body's COM from its spatial inertia's top-left block
// about the link origin, A_loc = I_com + m (c·c E - c cᵀ) (dynamics_soa.py
// _model_scalars)
QS_FN M3 inertia_at_com(float m, const V3& c, const M3& A_loc) {
  float cc = dot(c, c);
  M3 out;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float ci = at(c, i);
    out.r[i] = v3(at(A_loc, i, 0) - m * ((i == 0 ? cc : 0.0f) - ci * c.x),
                  at(A_loc, i, 1) - m * ((i == 1 ? cc : 0.0f) - ci * c.y),
                  at(A_loc, i, 2) - m * ((i == 2 ? cc : 0.0f) - ci * c.z));
  }
  return out;
}

// entry (a, b) of the 6x6 matrix [[A, h×], [(h×)ᵀ, m E]]
QS_FN float inertia6(const Inertia& I, int a, int b) {
  if (a < 3 && b < 3) return at(I.A, a, b);
  if (a >= 3 && b >= 3) return a == b ? I.m : 0.0f;
  // h× = [[0, -hz, hy], [hz, 0, -hx], [-hy, hx, 0]]; the lower-left block
  // is its transpose, -h×
  int i = a < 3 ? a : a - 3, j = a < 3 ? b - 3 : b;
  float hx = I.h.x, hy = I.h.y, hz = I.h.z;
  float e = (i == 0) ? (j == 0 ? 0.0f : (j == 1 ? -hz : hy))
          : (i == 1) ? (j == 0 ? hz : (j == 1 ? 0.0f : -hx))
                     : (j == 0 ? -hy : (j == 1 ? hx : 0.0f));
  return a < 3 ? e : -e;
}

// [vw; vv] ×f* [fw; fv]
QS_FN void cross_force(const V3& vw, const V3& vv, const V3& fw, const V3& fv, V3* top,
                       V3* bot) {
  *top = add(cross(vw, fw), cross(vv, fv));
  *bot = cross(vw, fv);
}

// a · b of 6-vectors [aw; av] · [bw; bv], summed in index order
QS_FN float dot6(const V3& aw, const V3& av, const V3& bw, const V3& bv) {
  float s = aw.x * bw.x;
  s = s + aw.y * bw.y;
  s = s + aw.z * bw.z;
  s = s + av.x * bv.x;
  s = s + av.y * bv.y;
  return s + av.z * bv.z;
}

// ---------------------------------------------------------------------------
// Small dense solves (dynamics_soa.py:153-200)
// ---------------------------------------------------------------------------

// the inverse of symmetric D + eps E by its adjugate; D given by its upper
// triangle d00, d01, d02, d11, d12, d22
QS_FN M3 sym3_inv(float d00, float d01, float d02, float d11, float d12, float d22,
                  float eps) {
  float a = d00 + eps, b = d01, c = d02, d = d11 + eps, e = d12, f = d22 + eps;
  float A = d * f - e * e;
  float B = c * e - b * f;
  float C = b * e - c * d;
  float det = a * A + b * B + c * C;
  float inv_det = 1.0f / det;
  float bc_ae = (b * c - a * e) * inv_det;
  return M3{{v3(A * inv_det, B * inv_det, C * inv_det),
             v3(B * inv_det, (a * f - c * c) * inv_det, bc_ae),
             v3(C * inv_det, bc_ae, (a * d - b * b) * inv_det)}};
}

// index of (a, b), a >= b, in a packed lower triangle of a 6x6 matrix
QS_FN constexpr int tri(int a, int b) { return a * (a + 1) / 2 + b; }

// solve (S + eps E) x = t for symmetric S given by its packed lower
// triangle, by an unrolled Cholesky with pivots floored at 1e-12
QS_FN void chol6_solve(const float* S, const float* t, float eps, float* x) {
  float L[21];
  float inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = S[tri(j, j)] + eps;
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[tri(j, k)] * L[tri(j, k)];
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
  float y[6];
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
}

// ---------------------------------------------------------------------------
// Model constants and one leg's articulated quantities
// ---------------------------------------------------------------------------

// The Go1's shared geometry and the simulator's constants, passed to the
// kernel by value (models/go1_params.py, models/dynamics.py). Every member
// is a float: the Python side packs the same layout as a float32 array
// (env/substeps.py, CONSTS_LAYOUT).
struct EnvConsts {
  float hip[4][3];        // hip joint origins in the base frame
  float thigh[4][3];      // thigh origins in the hip frame
  float calf[3];          // calf origin in the thigh frame
  float foot[3];          // foot centre in the calf frame
  float gravity[3];
  float foot_radius, knee_radius, trunk_radius;
  float corners[4][3];    // trunk collision corners in the base frame
  float real_lower[3], real_upper[3];   // joint limits (hip, thigh, calf)
  float dt, half_dt, half_dt2;
  float kn, dn, v_tol, kt, ct;          // contact
  float jl_k, jl_d;                     // joint-limit penalty
};

// row `leg` of a (4, 3) table of the constants, by selects (a run-time
// index into a kernel parameter would copy the table to local memory)
QS_FN V3 pick_leg(const float (&t)[4][3], int leg) {
  V3 a = load3(t[0]), b = load3(t[1]), c = load3(t[2]), d = load3(t[3]);
  V3 lo = leg == 0 ? a : b, hi = leg == 2 ? c : d;
  return leg < 2 ? lo : hi;
}

// a leg's three bodies: mass, local COM, inertia about the COM
struct LegBodies {
  float m[3];
  V3 c[3];
  M3 I[3];
};

// One leg's kinematics and CRBA terms at joint angles q (base frame):
// joint origins o, axes, motion subspaces s = [a; o × a], the bodies'
// inertias I and the composite columns F_j = Ic_j s_j (the leg's block
// column of the mass matrix), and the foot centre.
struct Leg {
  V3 o[3], axis[3], sw[3], sv[3];
  Inertia I[3];
  Inertia Ic1;          // the leg's composite inertia, about the base origin
  V3 Ft[3], Fb[3];      // F_j = [Ft; Fb]
  V3 foot;
};

QS_FN Leg leg_kinematics(const EnvConsts& k, const V3& hip, const V3& thigh,
                         const float* q, const LegBodies& bodies) {
  Leg L;
  M3 R1 = rot_x(q[0]);
  M3 R2 = mul(R1, rot_y(q[1]));
  M3 R3 = mul(R2, rot_y(q[2]));
  L.o[0] = hip;
  L.o[1] = add(L.o[0], mul(R1, thigh));
  L.o[2] = add(L.o[1], mul(R2, load3(k.calf)));
  L.foot = add(L.o[2], mul(R3, load3(k.foot)));
  L.axis[0] = v3(1.0f, 0.0f, 0.0f);   // hip: x of the trunk
  L.axis[1] = col(R1, 1);             // thigh: y of the hip frame
  L.axis[2] = col(R2, 1);             // calf: y of the thigh frame
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    L.sw[j] = L.axis[j];
    L.sv[j] = cross(L.o[j], L.axis[j]);
  }
  L.I[0] = body_inertia_base<true>(bodies.m[0], bodies.c[0], bodies.I[0], R1, L.o[0]);
  L.I[1] = body_inertia_base(bodies.m[1], bodies.c[1], bodies.I[1], R2, L.o[1]);
  L.I[2] = body_inertia_base(bodies.m[2], bodies.c[2], bodies.I[2], R3, L.o[2]);
  Inertia Ic2 = inertia_add(L.I[1], L.I[2]);
  L.Ic1 = inertia_add(L.I[0], Ic2);
  // the hip's column F_0 = Ic1 s_0 (inertia_matvec), its m·s_v term (the
  // leg's mass times hip × x, a product of model constants) rounded on its
  // own: a kernel that holds the model in registers computes it once before
  // its loop, where nothing can contract it, and planner_rollout, which
  // reads the model from shared memory inside the loop, must round it alike
  L.Ft[0] = add(mul(L.Ic1.A, L.sw[0]), cross(L.Ic1.h, L.sv[0]));
  L.Fb[0] = add(scale(-1.0f, cross(L.Ic1.h, L.sw[0])),
                v3(mul_rn(L.Ic1.m, L.sv[0].x), mul_rn(L.Ic1.m, L.sv[0].y),
                   mul_rn(L.Ic1.m, L.sv[0].z)));
  inertia_matvec(Ic2, L.sw[1], L.sv[1], &L.Ft[1], &L.Fb[1]);
  inertia_matvec(L.I[2], L.sw[2], L.sv[2], &L.Ft[2], &L.Fb[2]);
  return L;
}

// D[i][j] = s_i · F_j for j >= i (dynamics_soa.py: s[min] · F[max])
QS_FN float leg_d(const Leg& L, int i, int j) {
  return dot6(L.sw[i], L.sv[i], L.Ft[j], L.Fb[j]);
}

// F_j[a], entry a of column j of the leg's block B
QS_FN float leg_f(const Leg& L, int j, int a) {
  return a < 3 ? at(L.Ft[j], a) : at(L.Fb[j], a - 3);
}

// RNEA with qdd = 0 and a_root = [0; -g_base] along the leg: the spatial
// force at the hip f0 = [f0t; f0b] (the leg's share of the base's bias) and
// the joints' bias torques h (dynamics_soa.py:360-386)
QS_FN void leg_bias(const Leg& L, const float* qd, const V3& w_b, const V3& v_b,
                    const V3& g_b, V3* f0t, V3* f0b, float* h) {
  V3 vw = w_b, vv = v_b;
  V3 aw = v3(0.0f, 0.0f, 0.0f);
  V3 av = scale(-1.0f, g_b);
  V3 ft[3], fb[3];
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
  }
  V3 f1t = add(ft[1], ft[2]), f1b = add(fb[1], fb[2]);
  *f0t = add(ft[0], f1t);
  *f0b = add(fb[0], f1b);
  h[0] = dot6(L.sw[0], L.sv[0], *f0t, *f0b);
  h[1] = dot6(L.sw[1], L.sv[1], f1t, f1b);
  h[2] = dot6(L.sw[2], L.sv[2], ft[2], fb[2]);
}

// velocity in the base frame of a point pt riding on the leg's calf
QS_FN V3 leg_point_velocity(const Leg& L, const float* qd, const V3& pt, const V3& w_b,
                            const V3& v_b) {
  V3 arm_v = v3(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    arm_v = add(arm_v, scale(qd[j], cross(L.axis[j], sub(pt, L.o[j]))));
  return add(add(v_b, cross(w_b, pt)), arm_v);
}

// the trunk's bias force I_t a0 + v0 ×f* (I_t v0), a0 = [0; -g_base]
QS_FN void trunk_bias(const Inertia& T, const V3& w_b, const V3& v_b, const V3& g_b,
                      V3* ht, V3* hb) {
  V3 ivt, ivb, iat, iab, xt, xb;
  inertia_matvec(T, w_b, v_b, &ivt, &ivb);
  inertia_matvec(T, v3(0.0f, 0.0f, 0.0f), scale(-1.0f, g_b), &iat, &iab);
  cross_force(w_b, v_b, ivt, ivb, &xt, &xb);
  *ht = add(iat, xt);
  *hb = add(iab, xb);
}

// joint-limit penalty torque of joint type j (dynamics.py _forward)
QS_FN float joint_limit_torque(const EnvConsts& k, int j, float q, float qd) {
  float over = q - k.real_upper[j];
  over = over > 0.0f ? over : 0.0f;
  float under = k.real_lower[j] - q;
  under = under > 0.0f ? under : 0.0f;
  float active = (over > 0.0f || under > 0.0f) ? 1.0f : 0.0f;
  return (-k.jl_k * over + k.jl_k * under) - k.jl_d * qd * active;
}

}  // namespace qs
