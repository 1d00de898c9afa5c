// Hand-written Hopper (sm_90a) kernels of the MPC planner's and the
// environment's 1 kHz substep, and the tangent kernels of the planner's
// linearization.
//
// Each op is a per-element device function (elems.cuh, shared with the
// fused env_substeps kernel of env_step.cu) plus a thin __global__ wrapper
// and an extern "C" launcher. Launchers take raw device
// pointers and a cudaStream_t, launch on that stream, never synchronise and
// never allocate; they return cudaGetLastError() for the Python wrapper to
// check. quadruped_springs_tpu_torch/kernels.py compiles every .cu of this
// directory to an object, all at once, and links them into one library:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v \
//        -Xcompiler -fPIC -c -o planner_ops.o planner_ops.cu
// No --use_fast_math: sqrtf and '/' stay IEEE so the kernels agree with
// their PyTorch twins to rounding (FMA contraction is the only difference).
//
// The planner's kernels (actuation, contact and their tangents) are
// templates on the storage type T: float, or __nv_bfloat16 for the iLQR
// linearization in bfloat16 (MPCConfig.lin_dtype = "bf16", the JAX
// package's dynamics(..., dtype=jnp.bfloat16) knot). A bf16 launch loads
// bf16, computes in float registers and stores bf16 (round to nearest even,
// as torch's .to(torch.bfloat16)), so it moves half the bytes of the f32
// launch; its plain twin upcasts, runs the f32 twin and rounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elems.cuh"

namespace {

constexpr int kMotors = 12;   // 4 legs x (hip, thigh, calf)
constexpr int kSites = 12;    // 4 feet, 4 knees, 4 trunk corners
constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the per-element laws live in elems.cuh, shared with env_step.cu
using qs::actuation_elem;
using qs::anchored_foot_elem;
using qs::clip;
using qs::contact_elem;
using qs::damping_clip_pass;
using qs::minmax_pass;

// ---------------------------------------------------------------------------
// Kernel 1: PD motor torque + one-sided PEA spring torque.
//
// Replaces scripts/pallas_microbench.py:_actuation_kernel/fused_actuation
// (the pl.pallas_call at :96) and, on the planner path,
// quadruped_springs_tpu/ops/actuation.py pd_torque + spring_torque as
// called per substep at quadruped_springs_tpu/solver/mpc.py:182-187.
// Unlike the TPU kernel, spring stiffness and damping are per lane (the
// bench randomizes them per scenario); no springs means k = b = 0.
//
// Bound on the H100: ~10 flops per element against ten 4-byte loads (40 B,
// of which ~14 B come from device memory: q_des, q, qd and the lane's
// spring k/b, shared by its four legs; the rest are cached per-motor
// constants) and 8 B written, so it is memory- and, at 32,768 lanes x 12
// motors, launch-bound. Design:
// one thread per (lane, motor) over the row-major (N,12) arrays, so a warp
// reads 128 contiguous bytes of each operand; the 12-entry constants are
// read through the read-only cache. The real fix for launch-bound is the
// fused rollout kernel that inlines actuation_elem.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void actuation_kernel(
    const T* __restrict__ q_des, const T* __restrict__ q,
    const T* __restrict__ qd, const T* __restrict__ kp,
    const T* __restrict__ kd, const T* __restrict__ limits,
    const T* __restrict__ spring_k, const T* __restrict__ spring_b,
    const T* __restrict__ rest, const T* __restrict__ sign,
    T* __restrict__ tau, T* __restrict__ tau_motor, int64_t n) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int motor = static_cast<int>(i % kMotors);
  int64_t lane = i / kMotors;
  int joint = motor % 3;
  float t, tm;
  actuation_elem(load(q_des + i), load(q + i), load(qd + i), load(kp + motor),
                 load(kd + motor), load(limits + motor),
                 load(spring_k + lane * 3 + joint), load(spring_b + lane * 3 + joint),
                 load(rest + joint), load(sign + motor), &t, &tm);
  store(tau + i, t);
  store(tau_motor + i, tm);
}

// ---------------------------------------------------------------------------
// Kernel 2: compliant normal force + regularized Coulomb friction (the
// memoryless contact model of the planner).
//
// Replaces scripts/pallas_microbench.py:_contact_kernel/fused_contact (the
// pl.pallas_call at :153) and the memoryless branch of
// quadruped_springs_tpu/models/dynamics.py:contact_forces (:338-355,377).
// Unlike the TPU kernel it covers all 12 collision sites, not the 4 feet,
// and the impact-damping clamp is a flag, because the relaxed planner runs
// without it.
//
// Bound on the H100: ~20 flops (one sqrt, one division) against 16 B read
// (phi, v_w) plus 4 B of per-lane friction, and 17 B written per element:
// memory- and launch-bound like kernel 1. Design: one thread per
// (lane, site); v_w and f_world are (N,12,3) row-major, so a warp's 12-byte
// records form one contiguous 384-byte span.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void contact_kernel(
    const T* __restrict__ phi, const T* __restrict__ v_w,
    const T* __restrict__ mu, float kn, float dn, float v_tol,
    int clamp_damping, T* __restrict__ f_world, T* __restrict__ fn,
    bool* __restrict__ in_contact, int64_t n) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t lane = i / kSites;
  const T* v = v_w + 3 * i;
  T* f = f_world + 3 * i;
  float fx, fy, fz, fnv;
  contact_elem(load(phi + i), load(v), load(v + 1), load(v + 2), load(mu + lane),
               kn, dn, v_tol, clamp_damping != 0, &fx, &fy, &fz, &fnv,
               in_contact + i);
  store(f, fx);
  store(f + 1, fy);
  store(f + 2, fz);
  store(fn + i, fnv);
}

// ---------------------------------------------------------------------------
// Kernel 3: the environment's contact law -- kernel 2 at the knees and trunk
// corners, anchor-spring stiction (Cundall / bristle model) at the feet.
//
// Replaces, on the env path, the anchored branch of
// quadruped_springs_tpu/models/dynamics.py:contact_forces (:357-376) and
// dynamics_soa.py:426-444, which XLA fused into the TPU's dynamics graph;
// it extends scripts/pallas_microbench.py:fused_contact (the pl.pallas_call
// at :153), whose feet had no memory.
//
// The two JAX paths differ in the floor of |f_trial|^2: the structured
// path ("ref", dynamics.py:362, through spatial.safe_norm) floors it at
// 1e-12, the scalarized one ("soa", dynamics_soa.py:433-434) at 1e-18.
// This kernel and its twin follow ref (1e-12). They differ from soa only
// where |f_trial| <= mu*fn < 1e-6 N: ref then slides the anchor (its
// floored norm puts the force outside the tiny cone) and soa keeps it,
// with the tangential force below 1e-6 N either way. The ref path's slid anchor
// is computed from the unmasked clipped force and soa's from the masked
// one; both keep it only in contact, so they agree.
//
// Bound on the H100: a foot reads 36 B (phi, v, p_xy, anchor, mu) and
// writes 25 B for ~30 flops (one sqrt, three divisions); like kernel 2 it
// is memory- and launch-bound. Design: one thread per (lane, site) over
// the same row-major layout as kernel 2; threads of sites 4-11 run
// contact_elem, threads of sites 0-3 anchored_foot_elem. The branch splits
// a warp (12 sites per lane), which costs nothing measurable at this
// arithmetic intensity; the fused env-step kernel inlines the per-element
// functions instead.
// ---------------------------------------------------------------------------
__global__ void contact_anchored_kernel(
    const float* __restrict__ phi, const float* __restrict__ v_w,
    const float* __restrict__ p_w, const float* __restrict__ anchor,
    const float* __restrict__ mu, float kn, float dn, float kt, float ct,
    float v_tol, int clamp_damping, float* __restrict__ f_world,
    float* __restrict__ fn, bool* __restrict__ in_contact,
    float* __restrict__ new_anchor, int64_t n) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t lane = i / kSites;
  int site = static_cast<int>(i % kSites);
  const float* v = v_w + 3 * i;
  float* f = f_world + 3 * i;
  if (site < 4) {
    const float* p = p_w + 3 * i;
    int64_t a = 2 * (lane * 4 + site);
    anchored_foot_elem(phi[i], v[0], v[1], v[2], p[0], p[1], anchor[a],
                       anchor[a + 1], mu[lane], kn, dn, kt, ct,
                       clamp_damping != 0, f, f + 1, f + 2, fn + i,
                       in_contact + i, new_anchor + a, new_anchor + a + 1);
  } else {
    contact_elem(phi[i], v[0], v[1], v[2], mu[lane], kn, dn, v_tol,
                 clamp_damping != 0, f, f + 1, f + 2, fn + i, in_contact + i);
  }
}

// ---------------------------------------------------------------------------
// Kernels 4 and 5: forward-mode tangents (JVPs) of kernels 1 and 2, for the
// iLQR linearization, which pushes T = n + m = 43 basis tangents through
// every planner substep.
//
// They replace what JAX's forward-mode AD derives from the math of
// scripts/pallas_microbench.py:_actuation_kernel (:51-105, pallas_call at
// :96) and :_contact_kernel (:108-161, pallas_call at :153) when
// quadruped_springs_tpu/solver/ilqr.py:436-451 linearizes the dynamics.
//
// Layout: the primals are the (N,12[,3]) arrays of kernels 1 and 2; the
// tangents carry T directions in front, (T,N,12[,3]), so each direction's
// slab has the primal's layout. Branches follow the plain PyTorch
// versions' forward-mode rules: a min(max()) clip passes one half of
// each side's tangent at a tie (as jnp.clip), torch.where that of the
// selected branch.
//
// Bound on the H100: memory. Per (direction, element) actuation_jvp reads
// 12 B and writes 4 B with ~6 flops (the total torque's tangent only: no
// caller differentiates the motor's share, and writing it would add a
// quarter to the bytes); contact_jvp reads 16 B and writes 12 B with ~25
// flops. The primal (12-20 B per element) is read once, not once
// per direction. Design: one thread per (lane, motor) or (lane, site) that
// keeps the primal and its branch decisions in registers and loops over the
// T slabs, so a warp's accesses to each slab are the contiguous spans of
// kernels 1 and 2 and nothing is recomputed per direction.
// ---------------------------------------------------------------------------
struct ActuationBranches {
  float kp, kd, k, b;   // zeroed where the branch passes no tangent
};

__device__ __forceinline__ ActuationBranches actuation_branches(
    float q_des, float q, float qd, float kp, float kd, float limit, float k,
    float b, float rest, float sign) {
  float t = -kp * (q - q_des) - kd * qd;
  float pass = minmax_pass(t, -limit, limit);    // the clip's own tangent
  bool engaged = sign * (q - rest) >= 0.0f;
  ActuationBranches br;
  br.kp = pass * kp;
  br.kd = pass * kd;
  br.k = engaged ? k : 0.0f;
  br.b = engaged ? b : 0.0f;
  return br;
}

__device__ __forceinline__ float actuation_jvp_elem(
    const ActuationBranches& br, float dq_des, float dq, float dqd) {
  float dm = -br.kp * (dq - dq_des) - br.kd * dqd;
  return dm + (-br.k * dq - br.b * dqd);
}

template <typename T>
__global__ void actuation_jvp_kernel(
    const T* __restrict__ q_des, const T* __restrict__ q,
    const T* __restrict__ qd, const T* __restrict__ kp,
    const T* __restrict__ kd, const T* __restrict__ limits,
    const T* __restrict__ spring_k, const T* __restrict__ spring_b,
    const T* __restrict__ rest, const T* __restrict__ sign,
    const T* __restrict__ dq_des, const T* __restrict__ dq,
    const T* __restrict__ dqd, T* __restrict__ dtau, int64_t n,
    int n_tangents) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int motor = static_cast<int>(i % kMotors);
  int64_t lane = i / kMotors;
  int joint = motor % 3;
  ActuationBranches br = actuation_branches(
      load(q_des + i), load(q + i), load(qd + i), load(kp + motor),
      load(kd + motor), load(limits + motor), load(spring_k + lane * 3 + joint),
      load(spring_b + lane * 3 + joint), load(rest + joint), load(sign + motor));
#pragma unroll 4
  for (int t = 0; t < n_tangents; ++t) {
    int64_t j = static_cast<int64_t>(t) * n + i;
    store(dtau + j,
          actuation_jvp_elem(br, load(dq_des + j), load(dq + j), load(dqd + j)));
  }
}

// The primal quantities contact_jvp_elem needs, computed once per site.
struct ContactPrimal {
  float vx, vy;
  float de_dphi;      // d fn / d phi through the elastic term (and the clip)
  float dfn_dvz;      // d fn / d vz through the damping term
  float scale;        // mu * fn / den
  float mu_over_den;  // mu / den
  float dden_scale;   // d den / d |v_t|^2, 0 under either floor
  float inv_den;
};

__device__ __forceinline__ ContactPrimal contact_primal(
    float phi, float vx, float vy, float vz, float mu, float kn, float dn,
    float v_tol, bool clamp_damping) {
  ContactPrimal p;
  p.vx = vx;
  p.vy = vy;
  bool inc = phi > 0.0f;
  float elastic = kn * phi;
  float damping = dn * (-vz);
  // fn_raw = elastic + damping; its partials w.r.t. elastic and damping
  float w_e = 1.0f, w_d = 1.0f;
  if (clamp_damping) {
    float dy_dd, dy_de;
    damping_clip_pass(damping, elastic, &dy_dd, &dy_de);
    w_e += dy_de;
    w_d = dy_dd;
    if (damping < -elastic) {
      damping = -elastic;
    } else if (damping > elastic) {
      damping = elastic;
    }
  }
  float fn_raw = elastic + damping;
  bool live = inc && (fn_raw >= 0.0f);
  float fn = live ? fn_raw : 0.0f;
  // the floor max(fn_raw, 0) passes one half of the tangent at its tie
  float w_f = fn_raw > 0.0f ? 1.0f : 0.5f;
  p.de_dphi = live ? (w_f * w_e) * kn : 0.0f;
  p.dfn_dvz = live ? -(w_f * w_d) * dn : 0.0f;
  float vt2 = vx * vx + vy * vy;
  bool floored = vt2 < 1e-12f;
  float vt = sqrtf(floored ? 1e-12f : vt2);
  bool tol = vt < v_tol;
  float den = tol ? v_tol : vt;
  p.inv_den = 1.0f / den;
  p.mu_over_den = mu / den;
  p.scale = mu * fn / den;
  // d vt = d(vt2) / (2 vt) unless floored; d den = d vt unless vt < v_tol
  p.dden_scale = (floored || tol) ? 0.0f : 0.5f / vt;
  return p;
}

__device__ __forceinline__ void contact_jvp_elem(
    const ContactPrimal& p, float dphi, float dvx, float dvy, float dvz,
    float* dfx, float* dfy, float* dfz) {
  float dfn = p.de_dphi * dphi + p.dfn_dvz * dvz;
  float dvt2 = 2.0f * (p.vx * dvx + p.vy * dvy);
  float dden = p.dden_scale * dvt2;
  float dscale = p.mu_over_den * dfn - p.scale * dden * p.inv_den;
  *dfx = -(dscale * p.vx + p.scale * dvx);
  *dfy = -(dscale * p.vy + p.scale * dvy);
  *dfz = dfn;
}

template <typename T>
__global__ void contact_jvp_kernel(
    const T* __restrict__ phi, const T* __restrict__ v_w,
    const T* __restrict__ mu, float kn, float dn, float v_tol,
    int clamp_damping, const T* __restrict__ dphi,
    const T* __restrict__ dv_w, T* __restrict__ df_world, int64_t n,
    int n_tangents) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t lane = i / kSites;
  const T* v = v_w + 3 * i;
  ContactPrimal p = contact_primal(load(phi + i), load(v), load(v + 1), load(v + 2),
                                   load(mu + lane), kn, dn, v_tol, clamp_damping != 0);
#pragma unroll 4
  for (int t = 0; t < n_tangents; ++t) {
    int64_t j = static_cast<int64_t>(t) * n + i;
    const T* dv = dv_w + 3 * j;
    T* df = df_world + 3 * j;
    float dfx, dfy, dfz;
    contact_jvp_elem(p, load(dphi + j), load(dv), load(dv + 1), load(dv + 2), &dfx,
                     &dfy, &dfz);
    store(df, dfx);
    store(df + 1, dfy);
    store(df + 2, dfz);
  }
}

// An empty kernel: the least time one launch takes on the card, the floor
// under every kernel above at small shapes.
__global__ void noop_kernel() {}

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_actuation(const T* q_des, const T* q, const T* qd, const T* kp,
                     const T* kd, const T* limits, const T* spring_k,
                     const T* spring_b, const T* rest, const T* sign, T* tau,
                     T* tau_motor, int64_t n_lanes, void* stream) {
  int64_t n = n_lanes * kMotors;
  actuation_kernel<T><<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q_des, q, qd, kp, kd, limits, spring_k, spring_b, rest, sign, tau,
      tau_motor, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_contact(const T* phi, const T* v_w, const T* mu, float kn, float dn,
                   float v_tol, int clamp_damping, T* f_world, T* fn,
                   bool* in_contact, int64_t n_lanes, void* stream) {
  int64_t n = n_lanes * kSites;
  contact_kernel<T><<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      phi, v_w, mu, kn, dn, v_tol, clamp_damping, f_world, fn, in_contact, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_actuation_jvp(const T* q_des, const T* q, const T* qd, const T* kp,
                         const T* kd, const T* limits, const T* spring_k,
                         const T* spring_b, const T* rest, const T* sign,
                         const T* dq_des, const T* dq, const T* dqd, T* dtau,
                         int64_t n_lanes, int n_tangents, void* stream) {
  int64_t n = n_lanes * kMotors;
  actuation_jvp_kernel<T><<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      q_des, q, qd, kp, kd, limits, spring_k, spring_b, rest, sign, dq_des,
      dq, dqd, dtau, n, n_tangents);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_contact_jvp(const T* phi, const T* v_w, const T* mu, float kn,
                       float dn, float v_tol, int clamp_damping, const T* dphi,
                       const T* dv_w, T* df_world, int64_t n_lanes,
                       int n_tangents, void* stream) {
  int64_t n = n_lanes * kSites;
  contact_jvp_kernel<T><<<blocks_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      phi, v_w, mu, kn, dn, v_tol, clamp_damping, dphi, dv_w, df_world, n,
      n_tangents);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One extern "C" entry per kernel and storage type: <name> takes float
// arrays, <name>_bf16 __nv_bfloat16 arrays (the contact constants and the
// in_contact flags keep their types).
#define PLANNER_ENTRIES(SUFFIX, T)                                             \
  extern "C" int planner_actuation##SUFFIX(                                    \
      const T* q_des, const T* q, const T* qd, const T* kp, const T* kd,       \
      const T* limits, const T* spring_k, const T* spring_b, const T* rest,    \
      const T* sign, T* tau, T* tau_motor, int64_t n_lanes, void* stream) {    \
    return launch_actuation<T>(q_des, q, qd, kp, kd, limits, spring_k,        \
                               spring_b, rest, sign, tau, tau_motor, n_lanes,  \
                               stream);                                        \
  }                                                                            \
  extern "C" int planner_contact##SUFFIX(                                      \
      const T* phi, const T* v_w, const T* mu, float kn, float dn,             \
      float v_tol, int clamp_damping, T* f_world, T* fn, bool* in_contact,     \
      int64_t n_lanes, void* stream) {                                         \
    return launch_contact<T>(phi, v_w, mu, kn, dn, v_tol, clamp_damping,      \
                             f_world, fn, in_contact, n_lanes, stream);        \
  }                                                                            \
  extern "C" int planner_actuation_jvp##SUFFIX(                                \
      const T* q_des, const T* q, const T* qd, const T* kp, const T* kd,       \
      const T* limits, const T* spring_k, const T* spring_b, const T* rest,    \
      const T* sign, const T* dq_des, const T* dq, const T* dqd, T* dtau,      \
      int64_t n_lanes, int n_tangents, void* stream) {                         \
    return launch_actuation_jvp<T>(q_des, q, qd, kp, kd, limits, spring_k,    \
                                   spring_b, rest, sign, dq_des, dq, dqd,     \
                                   dtau, n_lanes, n_tangents, stream);         \
  }                                                                            \
  extern "C" int planner_contact_jvp##SUFFIX(                                  \
      const T* phi, const T* v_w, const T* mu, float kn, float dn,             \
      float v_tol, int clamp_damping, const T* dphi, const T* dv_w,            \
      T* df_world, int64_t n_lanes, int n_tangents, void* stream) {            \
    return launch_contact_jvp<T>(phi, v_w, mu, kn, dn, v_tol, clamp_damping,  \
                                 dphi, dv_w, df_world, n_lanes, n_tangents,    \
                                 stream);                                      \
  }

PLANNER_ENTRIES(, float)
PLANNER_ENTRIES(_bf16, __nv_bfloat16)

extern "C" int planner_contact_anchored(
    const float* phi, const float* v_w, const float* p_w, const float* anchor,
    const float* mu, float kn, float dn, float kt, float ct, float v_tol,
    int clamp_damping, float* f_world, float* fn, bool* in_contact,
    float* new_anchor, int64_t n_lanes, void* stream) {
  int64_t n = n_lanes * kSites;
  contact_anchored_kernel<<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      phi, v_w, p_w, anchor, mu, kn, dn, kt, ct, v_tol, clamp_damping,
      f_world, fn, in_contact, new_anchor, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int planner_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
