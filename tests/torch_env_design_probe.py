"""env_substeps's design steps side by side on the card, in one process.

    python tests/torch_env_design_probe.py --parent DIR [--rounds N] [--variants A,B,..]
        [--sass DIR]

Builds the `env_substeps` kernel (csrc/env_step.cu) in variants, all nvcc
processes at once, each into a library of its own:
  * parent: the kernel of DIR, an unpacked `git archive` of another commit
    (in a gitignored directory such as _checkout/), as that commit builds it;
    parent_nofma the same with -fmad=false (no multiply-add contracted);
  * stages: the parent with clock64() read at the boundaries of one
    substep's stages by the first thread of the first block (the stage map);
  * the design steps, each a copy of the parent's csrc/ with the text
    replaced (VARIANTS below): other block widths and environments a warp, the
    commands loaded off the chain, launch bounds, the model staged in shared
    memory, sincosf for a sinf / cosf pair, and their combinations;
  * shipped: this checkout as it builds; nofma the same with -fmad=false;
    and patches of it: its stages with the IEEE operators taken off their
    slow-path branches as the contact sites are (or the sites given back to
    the operators), 32 environments a block, the commands prefetched, the
    legs' shares summed through shared memory, its own stage map.
The parent's variants are launched with the parent's argument list (the
model packed by env/substeps.py pack_model), the shipped ones through this
checkout's env/substeps.py launch_args.

Prints one JSON line per variant (ptxas's -Xptxas -v line; the kernel's SASS
instruction counts from cuobjdump, with the substep loop's common path; its
registers, local memory and blocks an SM from cudaFuncGetAttributes and
cudaOccupancyMaxActiveBlocksPerMultiprocessor); one line with sincosf
against sinf and cosf over all 2^32 float32 bit patterns (the default build
and -fmad=false); one per setting of chip_smoke.py's phases 5 and 16 (1,024
x 10 PD with per-environment models and an external force, TORQUE, on the
rack, 64 x 10 under the landing gains, 1 x 10, 1 x 2,500 settle): per
variant the kernel's time on the card at the timed shapes (CUDA events
around back-to-back launches through ctypes, the median over rounds that
take the variants in turn, forward then backward), its outputs against the
parent's (bitwise, or the largest |d| and the first substep after which any
environment parts; the -fmad=false builds also against parent_nofma); the
stage map (cycles a stage, the median over substeps, at 1 x 2,500 and at
1,024 x 10) with the substep's cycles uninstrumented (the parent's time per
substep at 1 x 2,500 times the SM clock nvidia-smi reads under that load)
and the cycles per instruction of the substep loop; one call through each
wrapper at the timed shapes (CUDA events around the call, so the host's
time shows where the card waits for it: the parent's env/substeps.py with
its kernel, this checkout's with the shipped one); and the wrappers' host
time per call and by stage (the host clock over 1,000 calls at 1,024 x 10
and 1 x 10): the parent's env_substeps (grad check, pack_model, the checks,
the allocations, the argument list, the ctypes call) and this checkout's.
"""

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# --- text patches of the parent's csrc/ --------------------------------------

KERNEL = """  int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t env = tid >> 2;
  if (env >= args.n) return;   // whole groups of four: their shuffles stay complete
  qs::QuadShfl quad{0xFu << (threadIdx.x & 28u)};
  qs::env_lane(consts, args, env, static_cast<int>(tid & 3), quad);
"""
# E environments a warp (lanes 4E.. idle), the block's warps in a row
KERNEL_PER_WARP = """  const int lane = static_cast<int>(threadIdx.x & 31u);
  if (lane >= 4 * %(e)d) return;
  int64_t env = (static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5)) * %(e)d
                + (lane >> 2);
  if (env >= args.n) return;
  qs::QuadShfl quad{0xFu << (threadIdx.x & 28u)};
  qs::env_lane(consts, args, env, lane & 3, quad);
"""
GRID = "  int64_t threads = 4 * n;\n"
GRID_PER_WARP = "  int64_t threads = (n + %(e)d - 1) / %(e)d * 32;\n"
THREADS = "constexpr int kThreads = 128;   // 32 environments a block"
BOUNDS = "__global__ void __launch_bounds__(kThreads)"


def threads(t):
    return ("env_step.cu", THREADS, f"constexpr int kThreads = {t};")


def per_warp(e):
    return [("env_step.cu", KERNEL, KERNEL_PER_WARP % {"e": e}),
            ("env_step.cu", GRID, GRID_PER_WARP % {"e": e})]


def bounds(blocks):
    return ("env_step.cu", BOUNDS, f"__global__ void __launch_bounds__(kThreads, {blocks})")


# the commands: substep r + 1's loaded while substep r runs, a held one once
CMD_LOOP = """  for (int r = 0; r < a.substeps; ++r) {
    const float* cmd = a.q_des + env * a.q_des_env + r * a.q_des_step + 3 * leg;
    lane_substep<true>(k, c, cmd, a.torque_mode != 0, a.on_rack != 0, a.clamp_damping != 0,
                       has_ext, f_ext, s, anc_x, anc_y, o, quad);
"""
CMD_PREFETCH = """  const float* src = a.q_des + env * a.q_des_env + 3 * leg;
  float cmd[3] = {src[0], src[1], src[2]};
  for (int r = 0; r < a.substeps; ++r) {
    float next[3] = {cmd[0], cmd[1], cmd[2]};
    if (a.q_des_step != 0 && r + 1 < a.substeps) {
      const float* p = src + (r + 1) * a.q_des_step;
      next[0] = p[0];
      next[1] = p[1];
      next[2] = p[2];
    }
    lane_substep<true>(k, c, cmd, a.torque_mode != 0, a.on_rack != 0, a.clamp_damping != 0,
                       has_ext, f_ext, s, anc_x, anc_y, o, quad);
    cmd[0] = next[0];
    cmd[1] = next[1];
    cmd[2] = next[2];
"""
CMD = ("env_lane.cuh", CMD_LOOP, CMD_PREFETCH)

# each thread's LegModel staged in shared memory (128 threads a block)
LOAD_MODEL = """  const LegModel c = load_leg_model(k, a.model + env * a.model_stride, leg, a.kp, a.kd,
                                    a.torque_limits, a.velocity_limits, a.rest, a.sign,
                                    a.spring_k + 3 * env, a.spring_b + 3 * env,
                                    a.friction[env], a.torque_mode != 0);
"""
STAGED_MODEL = """  __shared__ LegModel staged[128];
  staged[threadIdx.x] = load_leg_model(k, a.model + env * a.model_stride, leg, a.kp, a.kd,
                                       a.torque_limits, a.velocity_limits, a.rest, a.sign,
                                       a.spring_k + 3 * env, a.spring_b + 3 * env,
                                       a.friction[env], a.torque_mode != 0);
  const LegModel& c = staged[threadIdx.x];
"""
SMEM = ("env_lane.cuh", LOAD_MODEL, STAGED_MODEL)

# sincosf for the sinf / cosf pairs of rot_x, rot_y (two sites) and quat_integrate
SINCOS_KIN = ("go1_dynamics.cuh", "  float c = cosf(t), s = sinf(t);\n",
              "  float s, c;\n  sincosf(t, &s, &c);\n", 2)
SINCOS_QUAT = ("go1_dynamics.cuh",
               """  float k = small ? half_dt * (1.0f - h2 / 6.0f) : sinf(half) / angle;
  float c = small ? 1.0f - h2 / 2.0f : cosf(half);
""", """  float sin_half, cos_half;
  sincosf(half, &sin_half, &cos_half);
  float k = small ? half_dt * (1.0f - h2 / 6.0f) : sin_half / angle;
  float c = small ? 1.0f - h2 / 2.0f : cos_half;
""")

# the shipped kernel's stages with the IEEE operators, taken off the
# slow-path branches as the sites are (env_lane.cuh with_ops): the 6x6 solve
# (its roots, reciprocals and quotients; or its substitutions' quotients
# alone, through the pivots' reciprocals) and quat_integrate
CHOL6 = "    chol6_solve(S, t6, eps, a0);\n"
CHOL6_OPS = [
    ("go1_dynamics.cuh",
     "QS_FN void chol6_solve(const float* S, const float* t, float eps, float* x) {\n",
     "template <class Ops>\n"
     "QS_FN void chol6_solve(const float* S, const float* t, float eps, float* x, Ops& ops) {\n"),
    ("go1_dynamics.cuh", "    y[i] = s / L[tri(i, i)];\n", "    y[i] = ops.div(s, L[tri(i, i)], inv[i]);\n"),
    ("go1_dynamics.cuh", "    x[i] = s / L[tri(i, i)];\n", "    x[i] = ops.div(s, L[tri(i, i)], inv[i]);\n"),
    ("env_lane.cuh", CHOL6,
     "    with_ops<kChecked>([&](auto& ops) { chol6_solve(S, t6, eps, a0, ops); });\n")]
PIVOTS_OPS = [("go1_dynamics.cuh", "    float d = sqrtf(s > 1e-12f ? s : 1e-12f);\n",
               "    float d = ops.sqrt(s > 1e-12f ? s : 1e-12f);\n"),
              ("go1_dynamics.cuh", "    inv[j] = 1.0f / d;\n",
               "    inv[j] = ops.div(1.0f, d, ops.recip(d));\n")]
QUAT_OPS = [
    ("go1_dynamics.cuh",
     "QS_FN void quat_integrate(float* q, const V3& w, float half_dt, float half_dt2) {\n",
     "template <class Ops>\nQS_FN void quat_integrate(float* q, const V3& w, float half_dt, "
     "float half_dt2,\n                          Ops& ops) {\n"),
    ("go1_dynamics.cuh", "  float angle = sqrtf(small ? 1.0f : n2);\n",
     "  float angle = ops.sqrt(small ? 1.0f : n2);\n"),
    ("go1_dynamics.cuh", ": sin_half / angle;\n", ": ops.div(sin_half, angle, ops.recip(angle));\n"),
    ("go1_dynamics.cuh", """  float norm = sqrtf(((x * x + y * y) + z * z) + ww * ww);
  q[0] = x / norm;
  q[1] = y / norm;
  q[2] = z / norm;
  q[3] = ww / norm;
""", """  float norm = ops.sqrt(((x * x + y * y) + z * z) + ww * ww);
  float rnorm = ops.recip(norm);
  q[0] = ops.div(x, norm, rnorm);
  q[1] = ops.div(y, norm, rnorm);
  q[2] = ops.div(z, norm, rnorm);
  q[3] = ops.div(ww, norm, rnorm);
"""),
    ("env_lane.cuh", "  quat_integrate(s.quat, w_new, k.half_dt, k.half_dt2);\n", """  float quat[4];
  with_ops<kChecked>([&](auto& ops) {
#pragma unroll
    for (int i = 0; i < 4; ++i) quat[i] = s.quat[i];
    quat_integrate(quat, w_new, k.half_dt, k.half_dt2, ops);
  });
#pragma unroll
  for (int i = 0; i < 4; ++i) s.quat[i] = quat[i];
""")]
SITES = "  with_ops<kChecked>([&](auto& ops) {\n    sites = contact_sites"
SITES_IEEE = ("env_lane.cuh", SITES, SITES.replace("with_ops<kChecked>", "with_ops<false>"))
# the legs' shares summed through shared memory (each thread stores its 27,
# every thread adds the four rows in the order (v0 + v1) + (v2 + v3)) in
# place of the shuffles
QUAD_SMEM_DEF = """struct QuadSmem {
  float* slot;   // this leg's row
  float* rows;   // the environment's first row
  unsigned mask;
  template <int N>
  __device__ __forceinline__ void sum(float (&v)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) slot[i] = v[i];
    __syncwarp(mask);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = (rows[i] + rows[33 + i]) + (rows[66 + i] + rows[99 + i]);
    __syncwarp(mask);
  }
};

__global__ void __launch_bounds__(kThreads)"""
QUAD_SMEM = [("env_step.cu", "__global__ void __launch_bounds__(kThreads)", QUAD_SMEM_DEF),
             ("env_step.cu", """  qs::QuadShfl quad{0xFu << (threadIdx.x & 28u)};
  qs::env_lane(consts, args, env, static_cast<int>(tid & 3), quad);""",
              """  __shared__ float sums[kThreads / 4][133];
  float* rows = sums[threadIdx.x >> 2];
  QuadSmem quad{rows + 33 * (threadIdx.x & 3u), rows, 0xFu << (threadIdx.x & 28u)};
  qs::env_lane(consts, args, env, static_cast<int>(tid & 3), quad);""")]


# the stage map: clock64() at the stage boundaries of lane_substep, kept for
# substep r < kStampSubsteps by thread 0 of block 0 (environment 0, leg 0)
STAMP_DEFS = """namespace qs {

constexpr int kStampSubsteps = 2560;
constexpr int kStamps = 16;
__device__ long long qs_stamps[kStampSubsteps * kStamps];
#define QS_STAGE(i)                            \\
  do {                                         \\
    long long t_ = clock64();                  \\
    if (qs_stamp) qs_stamp[i] = t_;            \\
  } while (0)
// the clock read waits for v (the loaded command) to arrive
#define QS_STAGE_AFTER(i, v)                                                   \\
  do {                                                                         \\
    long long t_;                                                              \\
    float v_ = (v);                                                            \\
    asm volatile("{\\n\\t.reg .pred qp;\\n\\tsetp.eq.f32 qp, %1, %1;\\n\\t"         \\
                 "@qp mov.u64 %0, %%clock64;\\n\\t@!qp mov.u64 %0, %%clock64;\\n\\t}" \\
                 : "=l"(t_) : "f"(v_) : "memory");                              \\
    if (qs_stamp) qs_stamp[i] = t_;                                            \\
  } while (0)
"""
STAGE_NAMES = ("command", "actuation", "quat_to_m3, mul_t", "leg_kinematics", "leg_bias",
               "three sites", "wrench, rhs", "sym3_inv", "BDinv, 27 shares", "quad.sum",
               "trunk_bias, 6x6", "chol6_solve", "legs' accelerations",
               "Euler, quat_integrate")
# boundary b of STAGE_BOUNDARIES ends stage STAGE_NAMES[b]; b0 is the start
STAGES = [
    ("env_lane.cuh", "namespace qs {\n", STAMP_DEFS),
    ("env_lane.cuh", "                        SubstepOut& o, Quad& quad) {\n",
     "                        SubstepOut& o, Quad& quad, long long* qs_stamp = nullptr) {\n"
     "  QS_STAGE(15);\n  QS_STAGE_AFTER(0, (cmd[0] + cmd[1]) + cmd[2]);\n"),
    ("env_lane.cuh", "  // ---- the base's motion and the leg's articulated quantities",
     "  QS_STAGE(1);\n  // ---- the base's motion and the leg's articulated quantities"),
    ("env_lane.cuh", "g_b = mul_t(R, c.g);\n", "g_b = mul_t(R, c.g);\n  QS_STAGE(2);\n"),
    ("env_lane.cuh", "s.q, c.bodies);\n", "s.q, c.bodies);\n  QS_STAGE(3);\n"),
    ("env_lane.cuh", "&f0b, h);\n", "&f0b, h);\n  QS_STAGE(4);\n"),
    ("env_lane.cuh", ("  o.other_inc = inc_k || inc_c;\n",
                      "  o.other_inc = sites.inc_k || sites.inc_c;\n"),
     lambda old: old + "  QS_STAGE(5);\n"),
    ("env_lane.cuh", "  const float eps = 1e-9f;\n", "  QS_STAGE(6);\n  const float eps = 1e-9f;\n"),
    ("env_lane.cuh", "leg_d(L, 2, 2), eps);\n", "leg_d(L, 2, 2), eps);\n  QS_STAGE(7);\n"),
    ("env_lane.cuh", "    quad.sum(share);\n",
     "    QS_STAGE(8);\n    quad.sum(share);\n    QS_STAGE(9);\n"),
    ("env_lane.cuh", ("    chol6_solve(S, t6, eps, a0);\n", CHOL6),
     lambda old: "    QS_STAGE(10);\n" + old + "    QS_STAGE(11);\n"),
    ("env_lane.cuh", "  // ---- semi-implicit Euler (dynamics.step)",
     "  QS_STAGE(12);\n  // ---- semi-implicit Euler (dynamics.step)"),
    ("env_lane.cuh", "  s.pos = add(s.pos, scale(k.dt, s.lin_vel));\n}\n",
     "  s.pos = add(s.pos, scale(k.dt, s.lin_vel));\n  QS_STAGE(13);\n}\n"),
    ("env_lane.cuh", "has_ext, f_ext, s, anc_x, anc_y, o, quad);\n",
     "has_ext, f_ext, s, anc_x, anc_y, o, quad,\n"
     "                       blockIdx.x == 0 && threadIdx.x == 0 && r < kStampSubsteps\n"
     "                           ? qs_stamps + kStamps * r : nullptr);\n"),
]

# the shipped kernel with 32 environments a block, and with the commands
# prefetched
SHIPPED_T128 = ("env_step.cu", "constexpr int kThreads = 32;   // 8 environments a block",
                "constexpr int kThreads = 128;")
SHIPPED_CMD = ("env_lane.cuh", """  for (int r = 0; r < a.substeps; ++r) {
    const float* cmd = a.q_des + env * a.q_des_env + r * a.q_des_step + 3 * leg;
    lane_substep<true, true>(k, c, cmd, a.torque_mode != 0, a.on_rack != 0,
                             a.clamp_damping != 0, has_ext, f_ext, s, anc_x, anc_y, o, quad);
""", """  const float* src = a.q_des + env * a.q_des_env + 3 * leg;
  float cmd[3] = {src[0], src[1], src[2]};
  for (int r = 0; r < a.substeps; ++r) {
    float next[3] = {cmd[0], cmd[1], cmd[2]};
    if (a.q_des_step != 0 && r + 1 < a.substeps) {
      const float* p = src + (r + 1) * a.q_des_step;
      next[0] = p[0];
      next[1] = p[1];
      next[2] = p[2];
    }
    lane_substep<true, true>(k, c, cmd, a.torque_mode != 0, a.on_rack != 0,
                             a.clamp_damping != 0, has_ext, f_ext, s, anc_x, anc_y, o, quad);
    cmd[0] = next[0];
    cmd[1] = next[1];
    cmd[2] = next[2];
""")

# name: (csrc/ of "parent" or "this", nvcc flags, text patches (file, old,
# new[, count]) applied to a copy of that csrc/)
T32, T64 = threads(32), threads(64)
VARIANTS = {
    "parent": ("parent", [], []),
    "parent_nofma": ("parent", ["-fmad=false"], []),
    "stages": ("parent", [], STAGES),
    "t32": ("parent", [], [T32]),
    "t64": ("parent", [], [T64]),
    "t32_e1": ("parent", [], [T32, *per_warp(1)]),
    "t32_e2": ("parent", [], [T32, *per_warp(2)]),
    "t32_e4": ("parent", [], [T32, *per_warp(4)]),
    "t32_b12": ("parent", [], [T32, bounds(12)]),
    "cmd": ("parent", [], [CMD]),
    "smem": ("parent", [], [SMEM]),
    "sincos_kin": ("parent", [], [SINCOS_KIN]),
    "sincos_quat": ("parent", [], [SINCOS_QUAT]),
    "t32_cmd_sincos": ("parent", [], [T32, CMD, SINCOS_KIN, SINCOS_QUAT]),
    "t32_e1_cmd_sincos": ("parent", [], [T32, *per_warp(1), CMD, SINCOS_KIN, SINCOS_QUAT]),
    "shipped": ("this", [], []),
    "nofma": ("this", ["-fmad=false"], []),
    # the shipped kernel less one of its steps, or with one more
    "shipped_t128": ("this", [], [SHIPPED_T128]),
    "shipped_cmd": ("this", [], [SHIPPED_CMD]),
    "shipped_chol6": ("this", [], CHOL6_OPS + PIVOTS_OPS),
    "shipped_subst": ("this", [], CHOL6_OPS),
    "shipped_quat": ("this", [], QUAT_OPS),
    "shipped_no_sites": ("this", [], [SITES_IEEE]),
    "shipped_smem_sum": ("this", [], QUAD_SMEM),
    "stages_shipped": ("this", [], STAGES),
}
SASS_OF = ("parent", "shipped")

# One more translation unit around the kernel's source: what the card makes
# of its kernel, and the stage map's clocks where the variant keeps them.
PROBE_UNIT = r"""
#include "%s"
extern "C" int probe_kernel(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, env_substeps_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, env_substeps_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
#ifdef QS_STAGE
extern "C" int probe_stamps(long long* out, long long count) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, qs::qs_stamps, count * sizeof(long long)));
}
#endif
"""

# sincosf against sinf and cosf, bit for bit, over every float32 bit
# pattern; each call gets an opaque copy of x, so that no pass of the
# compiler can merge the calls. out[0]: mismatches at non-NaN x, out[1] at NaN.
SINCOS_UNIT = r"""
#include <cuda_runtime.h>
__global__ void sincos_check_kernel(unsigned long long base, unsigned long long* bad) {
  unsigned int bits = static_cast<unsigned int>(
      base + static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  float x = __uint_as_float(bits), x1 = x, x2 = x, x3 = x;
  asm volatile("" : "+f"(x1));
  asm volatile("" : "+f"(x2));
  asm volatile("" : "+f"(x3));
  float s1 = sinf(x1), c1 = cosf(x2), s2, c2;
  sincosf(x3, &s2, &c2);
  if (__float_as_uint(s1) != __float_as_uint(s2) || __float_as_uint(c1) != __float_as_uint(c2))
    atomicAdd(bad + (x == x ? 0 : 1), 1ull);
}
extern "C" int sincos_mismatches(long long* out) {
  unsigned long long* d = nullptr;
  cudaError_t err = cudaMalloc(&d, 2 * sizeof(unsigned long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaMemset(d, 0, 2 * sizeof(unsigned long long));
  for (unsigned long long chunk = 0; chunk < 4; ++chunk)
    sincos_check_kernel<<<1u << 20, 1024>>>(chunk << 30, d);
  unsigned long long h[2];
  err = cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  cudaFree(d);
  out[0] = static_cast<long long>(h[0]);
  out[1] = static_cast<long long>(h[1]);
  return static_cast<int>(err);
}
"""

# CheckedOps (csrc/elems.cuh) against the IEEE operators, bit for bit where
# it keeps ok: sqrt and the reciprocal 1 / b over every float32 bit pattern;
# quotients over 2^32 pairs of each kind: any bits, operands drawn within the
# admitted exponent ranges, the same with mantissas at the ends of their
# range, and quotients through b's correctly rounded reciprocal (as
# chol6_solve divides by its pivots). out[2 * kind]: inputs kept (ok),
# out[2 * kind + 1]: those that differ from the operator.
CHECK_UNIT = r"""
#include "%s"
__device__ unsigned mix(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu; x ^= x >> 16;
  return x;
}
__device__ void count(bool ok, bool differ, unsigned long long* out) {
  const unsigned kept = __popc(__ballot_sync(0xffffffffu, ok));
  const unsigned bad = __popc(__ballot_sync(0xffffffffu, ok && differ));
  if ((threadIdx.x & 31u) == 0u) {
    atomicAdd(out, static_cast<unsigned long long>(kept));
    atomicAdd(out + 1, static_cast<unsigned long long>(bad));
  }
}
__device__ unsigned operand(unsigned r, unsigned m, unsigned lo, unsigned span, bool ends) {
  unsigned mant = ends ? ((m & 1u) ? 0x7fffffu - ((m >> 1) & 0xffu) : (m >> 1) & 0xffu)
                       : m & 0x7fffffu;
  return (r & 0x80000000u) | ((lo + r %% span) << 23) | mant;
}
__global__ void check_kernel(int kind, unsigned long long base, unsigned long long* out) {
  const unsigned i = static_cast<unsigned>(base + static_cast<unsigned long long>(blockIdx.x) *
                                               blockDim.x + threadIdx.x);
  qs::CheckedOps ops;
  float got, want;
  if (kind == 0) {                      // sqrt, every x
    float x = __uint_as_float(i), y = x;
    asm volatile("" : "+f"(y));
    got = ops.sqrt(x);
    want = sqrtf(y);
  } else if (kind == 1) {               // 1 / b, every b
    float b = __uint_as_float(i), y = b;
    asm volatile("" : "+f"(y));
    got = ops.div(1.0f, b, ops.recip(b));
    want = 1.0f / y;
  } else {
    const unsigned r1 = mix(i), r2 = mix(i ^ 0x9e3779b9u), r3 = mix(r1 + 0x7f4a7c15u),
                   r4 = mix(r2 + 0x632be5abu);
    unsigned ab, bb;
    if (kind == 2) {                    // any bits
      ab = r1;
      bb = r2;
    } else {                            // within the admitted exponents
      ab = operand(r1, r3, 37u, 121u, kind == 4);
      bb = operand(r2, r4, 97u, 61u, kind == 4);
    }
    float a = __uint_as_float(ab), b = __uint_as_float(bb), ya = a, yb = b;
    asm volatile("" : "+f"(ya), "+f"(yb));
    const float rb = kind == 5 ? 1.0f / yb : ops.recip(b);
    got = ops.div(a, b, rb);
    want = ya / yb;
  }
  count(ops.ok, __float_as_uint(got) != __float_as_uint(want), out + 2 * kind);
}
extern "C" int check_ops(long long* out) {
  unsigned long long* d = nullptr;
  cudaError_t err = cudaMalloc(&d, 12 * sizeof(unsigned long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaMemset(d, 0, 12 * sizeof(unsigned long long));
  for (int kind = 0; kind < 6; ++kind)
    for (unsigned long long chunk = 0; chunk < 4; ++chunk)
      check_kernel<<<1u << 20, 1024>>>(kind, chunk << 30, d);
  unsigned long long h[12];
  err = cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  cudaFree(d);
  for (int i = 0; i < 12; ++i) out[i] = static_cast<long long>(h[i]);
  return static_cast<int>(err);
}
"""
CHECK_KINDS = ("sqrt, every x", "1 / b, every b", "a / b, any bits",
               "a / b, admitted exponents", "a / b, admitted exponents, mantissas at the ends",
               "a / b through RN(1 / b)")

# The parent's entry point, as it was before the kernel read Go1Model's
# fields in place: the consts, the state, the commands and their strides,
# the tables, springs, friction, the model packed by pack_model and its
# stride, the force and its stride, the 13 outputs, n, substeps, on_rack,
# clamp, torque_mode, the stream
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
PARENT_ARGTYPES = ([_P, ctypes.c_int] + [_P] * 8 + [_I64, _I64] + [_P] * 10 + [_I64, _P, _I64]
                   + [_P] * 13 + [_I64] + [ctypes.c_int] * 4 + [_P])
TIMED = {"env": 100, "env_landing_64": 100, "fidelity_1x10": 100, "fidelity_1x2500_settle": 3}
STAGE_AT = ("fidelity_1x2500_settle", "env")


def patch(text, old, new, count=1, what=""):
    """text with `old` (or the one of a tuple of alternatives that it holds)
    replaced by `new` (or by new(the text replaced)), `count` times."""
    for alt in (old if isinstance(old, tuple) else (old,)):
        if text.count(alt) == count:
            return text.replace(alt, new(alt) if callable(new) else new)
    raise RuntimeError(f"{what} no longer holds {count} of the text a variant replaces: "
                       f"{str(old)[:60]!r}")


def source_dir(tmp, name, base, patches, parent):
    """The csrc/ a variant builds from: the parent's or this one, or a copy
    of either with `patches` applied."""
    root = parent if base == "parent" else ROOT
    src = os.path.join(root, "quadruped_springs_tpu_torch", "csrc")
    if not patches:
        return src
    copy = os.path.join(tmp, "csrc_" + name)
    shutil.copytree(src, copy)
    for fname, old, new, *count in patches:
        path = os.path.join(copy, fname)
        with open(path) as f:
            text = patch(f.read(), old, new, *count, what=f"{name}: {fname}")
        with open(path, "w") as f:
            f.write(text)
    return copy


def build(tmp, parent, names):
    """Every variant's library and the sincos checker (default and
    -fmad=false), all nvcc processes started together. Returns ({name:
    (ctypes library, ptxas line of the kernel, library path)}, {flags:
    checker library})."""
    from quadruped_springs_tpu_torch import kernels

    nvcc = kernels._nvcc()
    procs = {}
    for name in names:
        base, flags, patches = VARIANTS[name]
        src = os.path.join(source_dir(tmp, name, base, patches, parent), "env_step.cu")
        unit = os.path.join(tmp, name + ".cu")
        with open(unit, "w") as f:
            f.write(PROBE_UNIT % src)
        lib = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (lib, flags, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, *flags, "-shared", "-o", lib, unit],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    unit = os.path.join(tmp, "sincos.cu")
    with open(unit, "w") as f:
        f.write(SINCOS_UNIT)
    check_unit = os.path.join(tmp, "check_ops.cu")
    with open(check_unit, "w") as f:
        f.write(CHECK_UNIT % os.path.join(ROOT, "quadruped_springs_tpu_torch", "csrc",
                                          "elems.cuh"))
    lib = os.path.join(tmp, "libcheck_ops.so")
    procs[("check_ops", ())] = (lib, (), subprocess.Popen(
        [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", lib, check_unit],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for flags in ((), ("-fmad=false",)):
        lib = os.path.join(tmp, f"libsincos{len(flags)}.so")
        procs[("sincos", flags)] = (lib, flags, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, *flags, "-shared", "-o", lib, unit],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, checkers = {}, {}
    for name, (lib, flags, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        if isinstance(name, tuple):
            checkers[name[0] if name[0] == "check_ops" else " ".join(flags) or "default"] = \
                ctypes.CDLL(lib)
            continue
        lines = log.splitlines()
        i = next(i for i, line in enumerate(lines)
                 if "Compiling entry function" in line and "env_substeps_kernel" in line)
        libs[name] = (ctypes.CDLL(lib), " | ".join(x.strip() for x in lines[i + 2:i + 4]), lib)
    return libs, checkers


def kernel_sass(lib_path, cuobjdump):
    """The kernel's SASS (cuobjdump -sass)."""
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    return text.split("env_substeps_kernel", 1)[1].split("Function :", 1)[0]


def substep_loop(body):
    """The instructions of the kernel's substep loop that run on every pass:
    the loop is the largest backward branch; left out are the ranges that a
    forward conditional branch skips to reach a slow path (a CALL, or the
    local-memory loop of sinf's and cosf's reduction of huge arguments).
    Returns (address, opcode) pairs."""
    ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);", body)]
    target = lambda rest: int(re.search(r"0x([0-9a-f]+)", rest).group(1), 16)
    back = [(target(rest), a) for a, op, rest in ins if op == "BRA" and target(rest) < a]
    lo, hi = max(back, key=lambda r: r[1] - r[0])
    cold = []
    for a, op, rest in ins:
        if op == "BRA" and lo <= a <= hi and target(rest) > a:
            skipped = [o for b, o, _ in ins if a < b < target(rest)]
            if len(skipped) < 200 and any(o.startswith(("CALL", "STL")) for o in skipped):
                cold.append((a, target(rest)))
    return [(a, op) for a, op, _ in ins
            if lo <= a <= hi and not any(c0 < a < c1 for c0, c1 in cold)]


def sass_counts(body):
    """Instructions of the kernel in its SASS, in all and by kind, and of
    its substep loop's common path (substep_loop)."""
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", body)
    kinds = ("LDG", "STG", "LDL", "STL", "LDS", "STS", "SHFL", "MUFU", "FFMA", "FMUL", "FADD",
             "FSETP", "FSEL", "BRA", "CALL")
    count = lambda ops, k: sum(1 for o in ops if o == k or o.startswith(k + "."))
    loop = [op for _, op in substep_loop(body)]
    return {"instructions": len(ops), **{k: count(ops, k) for k in kinds},
            "substep_loop": len(loop),
            "substep_loop_by_kind": {k: count(loop, k) for k in kinds + ("MOV",)}}


def nvidia_smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


# --- the two argument lists ---------------------------------------------------

OUT_FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd", "anchor", "tau", "tau_m",
              "tau_m_sum", "foot_forces", "feet_in_contact", "invalid_contact")


def flat_out(out):
    """A SubstepsOut's 13 tensors in the kernel's order."""
    r = out.robot
    return [r.pos, r.quat, r.lin_vel, r.ang_vel, r.q, r.qd, out.anchor, out.tau, out.tau_m,
            out.tau_m_sum, out.foot_forces, out.feet_in_contact, out.invalid_contact]


def parent_outputs(torch, n, dev):
    """The 13 outputs as the parent's launch_args made them: 14 allocations."""
    e = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)
    return [e(n, 3), e(n, 4), e(n, 3), e(n, 3), e(n, 12), e(n, 12), e(n, 4, 2), e(n, 12),
            e(n, 12), e(n, 12), e(n, 4), e(n, 4, dtype=torch.bool), e(n, dtype=torch.bool)]


def parent_launch(torch, ss, args):
    """The parent's launch_args: (the entry point's arguments but the stream, the
    13 outputs, what must stay alive)."""
    rows = ss.pack_model(args[3])
    outs = parent_outputs(torch, args[0].q.shape[0], args[0].q.device)
    return parent_arg_list(ss, args, rows, outs), outs, rows


def parent_arg_list(ss, args, rows, outs):
    """The parent's argument list of the entry point but the stream."""
    (robot, anchor, q_des, model, params, kp, kd, lim, vlim, k, b, rest, sign, substeps,
     ext, torque) = args
    n = robot.q.shape[0]
    q_env, q_step = (substeps * 12, 12) if q_des.dim() == 3 else (12, 0)
    consts = ss.consts_array(ss._params_key(params))
    ext_stride = 0 if ext is None or ext.dim() == 1 else 3
    lst = [consts, len(consts),
           *(t.data_ptr() for t in (robot.pos, robot.quat, robot.lin_vel, robot.ang_vel,
                                    robot.q, robot.qd, anchor, q_des)),
           q_env, q_step,
           *(t.data_ptr() for t in (kp, kd, lim, vlim, rest, sign, k, b, params.friction, rows)),
           0 if rows.shape[0] == 1 else ss.MODEL_FLOATS,
           None if ext is None else ext.data_ptr(), ext_stride,
           *(t.data_ptr() for t in outs),
           n, substeps, int(params.on_rack), int(params.clamp_damping), int(torque)]
    return lst


def this_launch(torch, ss, args):
    """This checkout's launch_args: (arguments but the stream, outputs, None)."""
    (robot, anchor, q_des, model, params, kp, kd, lim, vlim, k, b, rest, sign, substeps,
     ext, torque) = args
    lst, out = ss.launch_args(robot, anchor, q_des, model, params.friction, params, kp, kd, lim,
                              vlim, k, b, rest, sign, substeps, ext, torque)
    return lst, flat_out(out), None


def with_substeps(torch, args, substeps):
    """The arguments cut to the first `substeps` substeps."""
    args = list(args)
    if args[2].dim() == 3:
        args[2] = args[2][:, :substeps].contiguous()
    args[13] = substeps
    return tuple(args)


# --- the wrappers' host time ---------------------------------------------------

def host_us(fn, calls, reps=5):
    """Host time of one call of fn in µs: the median over reps of the mean
    over `calls` calls (the queue synchronised after each rep)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return statistics.median(out)


def parent_wrapper(torch, parent, lib):
    """The parent's env/substeps.py, its kernels module pointed at the
    parent's library (the parent's argument list)."""
    from quadruped_springs_tpu_torch import kernels

    spec = importlib.util.spec_from_file_location(
        "parent_substeps", os.path.join(parent, "quadruped_springs_tpu_torch", "env",
                                        "substeps.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.kernels = types.SimpleNamespace(
        library=lambda: lib, check_tensor=kernels.check_tensor,
        check_launch=kernels.check_launch, stream_handle=kernels.stream_handle)
    return mod


def wrapper_breakdown(torch, ss, parent_mod, args, calls, shipped):
    """Host µs per call of each wrapper and of the parent's stages."""
    from quadruped_springs_tpu_torch import kernels

    (robot, anchor, q_des, model, params, kp, kd, lim, vlim, k, b, rest, sign, substeps,
     ext, torque) = args
    n, dev = robot.q.shape[0], robot.q.device
    tensors = [*(getattr(robot, f.name) for f in dataclasses.fields(robot)), anchor, q_des, kp,
               kd, lim, vlim, k, b, rest, sign, ext, params.friction,
               *(getattr(model, f) for f in ("trunk_inertia6", "trunk_mass", "leg_masses",
                                             "leg_coms", "leg_inertias6"))]
    rows = ss.pack_model(model)
    q_shape = (n, substeps, 12) if q_des.dim() == 3 else (n, 12)
    checks = [("pos", robot.pos, (n, 3)), ("quat", robot.quat, (n, 4)),
              ("lin_vel", robot.lin_vel, (n, 3)), ("ang_vel", robot.ang_vel, (n, 3)),
              ("q", robot.q, (n, 12)), ("qd", robot.qd, (n, 12)),
              ("foot_anchor", anchor, (n, 4, 2)), ("q_des", q_des, q_shape),
              ("kp", kp, (12,)), ("kd", kd, (12,)), ("torque_limits", lim, (12,)),
              ("velocity_limits", vlim, (12,)), ("rest_angles3", rest, (3,)),
              ("engage_sign", sign, (12,)), ("spring_k", k, (n, 3)), ("spring_b", b, (n, 3)),
              ("friction", params.friction, (n,)), ("model", rows, tuple(rows.shape))]
    if ext is not None:
        checks.append(("ext_force_world", ext, tuple(ext.shape)))
    lib = parent_mod.kernels.library()
    launch, outs, _ = parent_launch(torch, ss, args)
    stream = kernels.stream_handle(dev)

    def grad_check():
        return torch.is_grad_enabled() and any(torch.is_tensor(t) and t.requires_grad
                                               for t in tensors)

    def check_all():
        for name, t, shape in checks:
            kernels.check_tensor(name, t, shape, dev)

    def allocate():
        return parent_outputs(torch, n, dev)

    sizes = [3, 4, 3, 3, 12, 12, 8, 12, 12, 12, 4]

    def grouped():
        e = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)
        return [*e(3, n, 3).unbind(0), *e(2, n, 4).unbind(0), *e(5, n, 12).unbind(0),
                e(n, 4, 2), e(n, 4, dtype=torch.bool), e(n, dtype=torch.bool)]

    def carve():
        buf = torch.empty(sum(sizes) * n * 4 + 5 * n, dtype=torch.uint8, device=dev)
        floats = buf[:sum(sizes) * n * 4].view(torch.float32).split([s * n for s in sizes])
        flags = buf[sum(sizes) * n * 4:].view(torch.bool)
        return [f.view(n, -1) for f in floats] + [flags[:4 * n].view(n, 4), flags[4 * n:]]

    def arg_list():
        return parent_arg_list(ss, args, rows, outs)

    def device_context():
        with torch.cuda.device(dev):
            pass

    def call():
        with torch.cuda.device(dev):
            return lib.env_substeps(*launch, kernels.stream_handle(dev))

    def raw_call():
        return lib.env_substeps(*launch, stream)

    stages = {"grad_check": grad_check, "pack_model": lambda: ss.pack_model(model),
              "checks": check_all, "allocations_14": allocate,
              "allocations_one_carved": carve, "allocations_grouped": grouped,
              "argument_list": arg_list,
              "ctypes_call_in_device_context": call, "ctypes_call": raw_call,
              "stream_handle": lambda: kernels.stream_handle(dev),
              "device_context": device_context}
    rec = {"parent_wrapper_us": host_us(lambda: parent_mod.env_substeps(*args), calls),
           "parent_stages_us": {name: host_us(fn, calls) for name, fn in stages.items()}}
    if shipped:
        rec["shipped_wrapper_us"] = host_us(lambda: ss.env_substeps(*args), calls)
        launch = lambda: ss.launch_args(robot, anchor, q_des, model, params.friction, params, kp,
                                        kd, lim, vlim, k, b, rest, sign, substeps, ext, torque)
        prepared, kept = launch()
        rec["shipped_stages_us"] = {
            "launch_args": host_us(launch, calls),
            "allocate_outputs": host_us(lambda: ss.allocate_outputs(n, dev), calls),
            "kernels.launch": host_us(lambda: kernels.launch(
                dev, "env_substeps", kernels.library().env_substeps, prepared), calls)}
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--variants", help="comma-separated subset of VARIANTS (parent and "
                    "parent_nofma are always built)")
    ap.add_argument("--sass")
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_env_design_probe: no CUDA card")
    import chip_smoke
    from quadruped_springs_tpu_torch import env_bench, kernels
    from quadruped_springs_tpu_torch.env import substeps as ss
    from quadruped_springs_tpu_torch.env.wrappers import LANDING_KD, LANDING_KP

    parent = os.path.abspath(a.parent)
    names = list(VARIANTS) if a.variants is None else ["parent", "parent_nofma"] + [
        v for v in a.variants.split(",") if v not in ("parent", "parent_nofma")]
    head = {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": nvidia_smi("name,power.limit")}
    emit = lambda rec: print(json.dumps({**head, **rec}), flush=True)
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs, checkers = build(tmp, parent, names)
        emit({"built": len(libs), "seconds": time.perf_counter() - t0})
        loop_instructions = {}
        for name, (lib, ptxas, path) in libs.items():
            fn = lib.env_substeps
            fn.argtypes = PARENT_ARGTYPES if VARIANTS[name][0] == "parent" else \
                kernels.ENV_SUBSTEPS_ARGTYPES
            fn.restype = ctypes.c_int
            lib.probe_kernel.argtypes = [ctypes.c_void_p]
            occ = (ctypes.c_int * 5)()
            assert lib.probe_kernel(occ) == 0
            rec = {"variant": name, "flags": VARIANTS[name][1], "ptxas": ptxas,
                   "blocks_per_sm": occ[0], "threads_per_block": occ[1], "registers": occ[2],
                   "local_bytes": occ[3], "shared_bytes": occ[4],
                   "warps_per_sm": occ[0] * occ[1] // 32}
            if os.path.isfile(cuobjdump):
                body = kernel_sass(path, cuobjdump)
                rec["sass"] = sass_counts(body)
                loop_instructions[name] = rec["sass"]["substep_loop"]
                if a.sass and name in SASS_OF:
                    os.makedirs(a.sass, exist_ok=True)
                    with open(os.path.join(a.sass, f"env_substeps_{name}.sass"), "w") as f:
                        f.write(body)
            emit(rec)
        ops_lib = checkers.pop("check_ops")
        out = (ctypes.c_longlong * 12)()
        ops_lib.check_ops.argtypes = [ctypes.c_void_p]
        assert ops_lib.check_ops(out) == 0
        emit({"checked_ops_vs_ieee": {kind: {"inputs": 2 ** 32, "kept": out[2 * i],
                                             "differ": out[2 * i + 1]}
                                      for i, kind in enumerate(CHECK_KINDS)}})
        sincos = {}
        for flags, lib in checkers.items():
            out = (ctypes.c_longlong * 2)()
            lib.sincos_mismatches.argtypes = [ctypes.c_void_p]
            assert lib.sincos_mismatches(out) == 0
            sincos[flags] = {"mismatches_not_nan": out[0], "mismatches_nan": out[1]}
        emit({"sincosf_vs_sinf_cosf": sincos, "inputs": 2 ** 32})

        landing = [torch.full((12,), g, device="cuda") for g in (LANDING_KP, LANDING_KD)]
        settings, _ = chip_smoke.env_substeps_settings(torch, env_bench, landing)
        settings.update(chip_smoke.fidelity_substeps_settings(torch))
        stream = kernels.stream_handle(torch.device("cuda"))
        launchers = {"parent": lambda args: parent_launch(torch, ss, args),
                     "this": lambda args: this_launch(torch, ss, args)}

        def run(name, args):
            lst, outs, keep = launchers[VARIANTS[name][0]](args)
            assert libs[name][0].env_substeps(*lst, stream) == 0
            torch.cuda.synchronize()
            return outs

        def parts(x, y):
            return not all(torch.equal(p, q) for p, q in zip(x, y))

        def first_parted(name, args, other):
            """The fewest substeps after which `name`'s outputs part from
            `other`'s (bisection; both part after all of them)."""
            lo, hi = 0, args[13]
            while hi - lo > 1:
                mid = (lo + hi) // 2
                cut = with_substeps(torch, args, mid)
                if parts(run(name, cut), run(other, cut)):
                    hi = mid
                else:
                    lo = mid
            return hi

        parent_mod = parent_wrapper(torch, os.path.abspath(a.parent), libs["parent"][0])

        def through_wrappers(args, reps):
            """CUDA-event ms of one call through each wrapper (the parent's
            env/substeps.py with its kernel, this one's with the shipped
            kernel), the median over reps taken in turn."""
            calls = {"parent": lambda: parent_mod.env_substeps(*args),
                     "shipped": lambda: ss.env_substeps(*args)}
            out = {name: [] for name in calls}
            for fn in calls.values():
                fn()
            torch.cuda.synchronize()
            for r in range(reps):
                for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    calls[name]()
                    end.record()
                    end.synchronize()
                    out[name].append(start.elapsed_time(end))
            return {name: statistics.median(t) for name, t in out.items()}

        sm_clock, results = None, {}
        for setting, args in settings.items():
            n, substeps = args[0].q.shape[0], args[13]
            outs = {name: run(name, args) for name in libs if not name.startswith("stages")}
            rec = {"setting": setting, "envs": n, "substeps": substeps, "variants": {}}
            times = {name: [] for name in outs}
            if setting in TIMED:
                inner = TIMED[setting]
                prepared = {name: launchers[VARIANTS[name][0]](args) for name in outs}
                order = list(outs)
                for r in range(a.rounds):
                    for name in (order if r % 2 == 0 else order[::-1]):
                        fn, lst = libs[name][0].env_substeps, prepared[name][0]
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        for _ in range(inner):
                            fn(*lst, stream)
                        end.record()
                        end.synchronize()
                        times[name].append(start.elapsed_time(end) / inner)
                # the SM clock under the parent's load
                fn, lst = libs["parent"][0].env_substeps, prepared["parent"][0]
                for _ in range(max(1, 200 // inner)):
                    fn(*lst, stream)
                rec["nvidia_smi_under_load"] = nvidia_smi("clocks.sm,clocks.max.sm,power.draw")
                torch.cuda.synchronize()
                if "shipped" in libs:
                    rec["through_wrapper_ms"] = through_wrappers(args, 6 if inner < 10 else 40)
                if setting == "fidelity_1x2500_settle":
                    sm_clock = float(rec["nvidia_smi_under_load"].split()[0]) * 1e6
            ref = outs["parent"]
            for name, got in outs.items():
                v = {}
                if times[name]:
                    v["ms"] = statistics.median(times[name])
                    v["ms_all"] = times[name]
                floats = [(g - r).abs().max() for g, r in zip(got, ref)
                          if g.dtype == torch.float32]
                v["bitwise_parent"] = not parts(got, ref)
                v["max_abs_diff_parent"] = float(max(floats))
                v["fields_parted"] = [f for f, g, r in zip(OUT_FIELDS, got, ref)
                                      if not torch.equal(g, r)]
                if not v["bitwise_parent"]:
                    v["first_substep_parted"] = first_parted(name, args, "parent")
                if "-fmad=false" in VARIANTS[name][1]:
                    v["bitwise_parent_nofma"] = not parts(got, outs["parent_nofma"])
                rec["variants"][name] = v
            results[setting] = rec
            emit(rec)

        for stages, of in (("stages", "parent"), ("stages_shipped", "shipped")):
            if stages not in libs or of not in libs:
                continue
            lib = libs[stages][0]
            lib.probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
            for setting in STAGE_AT:
                args = settings[setting]
                count = 2560 * 16
                for _ in range(2):   # the second launch runs warm
                    run(stages, args)
                stamps = (ctypes.c_longlong * count)()
                assert lib.probe_stamps(stamps, count) == 0
                substeps = min(args[13], 2560)
                rows = [stamps[16 * r:16 * r + 16] for r in range(1, substeps)]
                order = [15, 0, *range(1, 14)]   # start, command, stages 1-13
                cycles = {STAGE_NAMES[b]: statistics.median(row[b] - row[p] for row in rows)
                          for p, b in zip(order, order[1:])}
                whole = statistics.median(row[13] - row[15] for row in rows)
                # one substep's end to the next one's start: the loop's own
                between = statistics.median(rows[i + 1][15] - rows[i][13]
                                            for i in range(len(rows) - 1)) if len(rows) > 1 else 0
                rec = {"stage_map": setting, "of": of, "cycles": cycles, "substep_cycles": whole,
                       "loop_cycles": between, "substeps_read": len(rows)}
                timed = results[setting]["variants"][of]
                if "ms" in timed and sm_clock:
                    # the kernel uninstrumented: its time a substep in SM cycles
                    cyc = timed["ms"] * 1e-3 / args[13] * sm_clock
                    rec["uninstrumented_substep_cycles"] = cyc
                    rec["sm_clock_hz"] = sm_clock
                    if of in loop_instructions:
                        rec["substep_loop_instructions"] = loop_instructions[of]
                        rec["cycles_per_instruction"] = cyc / loop_instructions[of]
                emit(rec)

        # the wrappers' host time at 1,024 x 10 and 1 x 10
        for setting in ("env", "fidelity_1x10"):
            emit({"wrapper_host_us": setting, "calls": 1000,
                  **wrapper_breakdown(torch, ss, parent_mod, settings[setting], 1000,
                                    "shipped" in libs)})


if __name__ == "__main__":
    main()
