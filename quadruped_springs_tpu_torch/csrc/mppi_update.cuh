// The body of the mppi_update kernel (mppi_update.cu): one MPPI update of a
// problem and the rows its next rollout takes, as quadruped_springs_tpu_
// torch/solver/mppi_update.py mppi_update_plain computes them. One block a
// problem, so a problem's answer does not depend on its batch. A launch
// runs, in order, what its arguments ask for:
//
// 1. the proposal (costs given), its scalars on warp 0 (update_scalars): a
//    non-finite cost becomes inf; the first argmin; the fused accept's best
//    tracking (the running best cost, its candidate and the trace); the
//    n_elite-th smallest cost by a rank count (exactly torch.sort(costs)
//    [n_elite - 1], ties included); β = min; w = exp(-(c - β)/λ) where
//    c <= kth, else 0; w / max(sum_fixed(w), 1e-12); then the weighted mean
//    over the K candidates in sum_fixed's order, clipped: the proposal (`us`
//    with the fused accept, else `us_alt`);
// 2. the plain branch's accept (cost_new given): the proposal replaces `us`
//    where its cost is below `cost`; the trace;
// 3. the rows of the next rollout: K candidates from the draws (σ_i·draw,
//    low-passed along H (c = a·c + b·e) and renormalised per knot, row 0
//    zero with the fused accept, added to `us` and clipped), or rows of the
//    state (us; us_alt; both);
// 4. where q_des is given, the rows' joint targets through the PD
//    interface's affine action_to_command, from the rows while they are in
//    shared memory.
//
// The candidates and the draws reach shared memory in chunks (cp.async:
// 16-byte pieces, 4-byte ones at a row's unaligned ends) through a ring of
// slots, each `group` groups of kGroupRows rows (update_shape: one group at
// the headline's 8 problems an SM, all of a problem's rows when it has an
// SM to itself). For K = 32 and 64 (compile-time) a group of the
// candidates is the four rows sum_fixed's first two levels pair, so that
// each element's weighted mean is summed in sum_fixed's order as the groups
// arrive; other K keep each element's K products in a shared column. The
// draws' first chunk has a slot of its own and is in flight before the
// proposal starts. A chunk of draws is low-passed in place (a thread a
// (row, action) stream), made into candidates (a thread an element), and
// written out with its joint targets (16-byte stores, consecutive threads on
// consecutive pieces) from its slot, while the next chunk is low-passed.
//
// The phases are functions of a thread index (and of the number of threads
// that share the work) or, for the scalars, of a lane of warp 0, run through
// a Block: the kernel's (DeviceBlock: threadIdx.x, __syncthreads, cp.async,
// __shfl_sync) or tests/mppi_update_host.cpp's (every index in turn,
// memcpy, the lanes as fibers whose shuffles meet at a barrier). Every
// operation rounds on its own (task_cost.cuh's rn_*), in the plain version's
// order; λ's division is a product with its reciprocal (rcp_temperature:
// taken in double, rounded to float32), as PyTorch's CUDA kernels divide by
// a Python number.

#pragma once

#include <math.h>
#include <stdint.h>

#include "task_cost.cuh"

#if defined(__CUDACC__)
#define QS_HD __host__ __device__ __forceinline__
#else
#define QS_HD inline
#endif

namespace qs {

// threads a block: kUpdateThreads where the SMs hold several problems each
// (8 at most: 8 x 128 threads cap a thread at 64 registers, and 8 blocks
// an SM hold 1,056 problems on the H100's 132 SMs), kUpdateWideThreads
// where a problem has half an SM or more
constexpr int kUpdateThreads = 128;
constexpr int kUpdateMinBlocks = 8;
constexpr int kUpdateWideThreads = 512;
constexpr int kUpdateWideBlocks = 2;
// a group: the 4 rows of the candidates one term of the mean's sum pairs
// (update_mean_chunk), and the unit of a slot; the mean's ring of slots,
// and the rows' (those and the draws' first chunk's own)
constexpr int kGroupRows = 4;
constexpr int kCandSlots = 3;
constexpr int kDrawSlots = kCandSlots + 1;
// shared memory an SM has for its blocks, a block's own reserve, a block's
// most
constexpr int kSmemPerSM = 228 * 1024;
constexpr int kSmemReserve = 1024;
constexpr int kSmemMaxBlock = 227 * 1024;

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
  // the launch's threads a block and groups a slot (update_shape)
  int threads, group;
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
               u_max, lp_a, lp_b, {}, {}, kUpdateThreads, 1};
  for (int i = 0; i < 12; ++i) {
    a.joint_src[i] = joint_src[i];
    a.joint_sign[i] = joint_sign[i];
  }
  return a;
}

// A block's scalars and its joint table (static shared memory)
struct UpdateShared {
  int ib, better;
};

struct JointTable {
  int src[12];
  float sign[12], lo[12], scale[12], hi[12];   // scale: hi - lo
};

// The block's dynamic shared memory, in floats, each region at a 16-byte
// boundary: costs (K) and weights (K), norm by element (H·m), the tile of
// `us` the candidates are drawn around (H·m), the weighted mean's partial
// sums (3 H·m), the slots (kDrawSlots x group x kGroupRows rows of P
// floats: a row and room to sit at its source's 16-byte offset), and for K
// outside {32, 64} the products' columns (K x threads)
struct UpdateLayout {
  int P, c, w, norm, tile, part, slots, slot_floats, cols, floats;
};

QS_HD bool update_general(int samples) { return samples != 32 && samples != 64; }

QS_HD UpdateLayout update_layout(int samples, int horizon, int actions, int threads,
                                 int group) {
  UpdateLayout L{};
  const int E = horizon * actions;
  L.P = (E + 6) / 4 * 4;
  int off = 0;
  auto take = [&](int floats) {   // a region at a 16-byte boundary
    const int at = off;
    off = (off + floats + 3) / 4 * 4;
    return at;
  };
  L.c = take(samples);
  L.w = take(samples);
  L.norm = take(E);
  L.tile = take(E);
  L.part = take(3 * E);
  L.slots = off;
  L.slot_floats = group * kGroupRows * L.P;
  off += kDrawSlots * L.slot_floats;
  L.cols = off;
  off += update_general(samples) ? samples * threads : 0;
  L.floats = off;
  return L;
}

QS_HD size_t update_smem_bytes(int samples, int horizon, int actions, int threads, int group) {
  return static_cast<size_t>(update_layout(samples, horizon, actions, threads, group).floats) *
         sizeof(float);
}

// A launch's shape for B problems on `sms` SMs: the threads a block (wide
// where an SM holds at most kUpdateWideBlocks of them) and the groups a
// slot: the most, a power of 2 up to all of a problem's rows, whose shared
// memory still lets an SM hold its share of the problems; at least 1. Any
// shape gives the same bits.
struct UpdateShape {
  int threads, group;
};

QS_HD UpdateShape update_shape(int samples, int horizon, int actions, int64_t n_problems,
                               int sms) {
  const int64_t waves = (n_problems + sms - 1) / (sms > 0 ? sms : 1);
  const int per_sm = waves < 1 ? 1 : (waves > kUpdateMinBlocks ? kUpdateMinBlocks
                                                               : static_cast<int>(waves));
  int budget = kSmemPerSM / per_sm - kSmemReserve -
               static_cast<int>(sizeof(UpdateShared) + sizeof(JointTable));
  if (budget > kSmemMaxBlock - 512) budget = kSmemMaxBlock - 512;
  const int threads = per_sm <= kUpdateWideBlocks &&
                              update_smem_bytes(samples, horizon, actions, kUpdateWideThreads,
                                                1) <= static_cast<size_t>(budget)
                          ? kUpdateWideThreads
                          : kUpdateThreads;
  const int most = (samples + kGroupRows - 1) / kGroupRows;
  int group = 1;
  while (2 * group <= most && update_smem_bytes(samples, horizon, actions, threads,
                                                2 * group) <= static_cast<size_t>(budget))
    group *= 2;
  return {threads, group};
}

QS_HD int imin(int x, int y) { return x < y ? x : y; }

// a float pointer's offset from a 16-byte boundary, in floats
QS_HD int shift_of(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
}

// 16 bytes at a 16-byte boundary: to registers, from registers, copied
#if defined(__CUDA_ARCH__)
QS_FN void load4(const float* s, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(s);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
QS_FN void store4(float* d, const float (&v)[4]) {
  *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
}
QS_FN void store16(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
}
QS_FN int lowest_lane(unsigned x) { return __ffs(static_cast<int>(x)) - 1; }
#else
QS_FN void load4(const float* s, float (&v)[4]) {
  for (int i = 0; i < 4; ++i) v[i] = s[i];
}
QS_FN void store4(float* d, const float (&v)[4]) {
  for (int i = 0; i < 4; ++i) d[i] = v[i];
}
QS_FN void store16(float* d, const float* s) {
  for (int i = 0; i < 4; ++i) d[i] = s[i];
}
QS_FN int lowest_lane(unsigned x) { return __builtin_ctz(x); }
#endif

#if defined(__CUDACC__)
// Warp 0's shuffles
struct WarpShfl {
  __device__ __forceinline__ float shfl(float v, int src) { return __shfl_sync(~0u, v, src); }
  __device__ __forceinline__ int shfl(int v, int src) { return __shfl_sync(~0u, v, src); }
  __device__ __forceinline__ float shfl_xor(float v, int m) { return __shfl_xor_sync(~0u, v, m); }
  __device__ __forceinline__ int shfl_xor(int v, int m) { return __shfl_xor_sync(~0u, v, m); }
  __device__ __forceinline__ float shfl_down(float v, int d) { return __shfl_down_sync(~0u, v, d); }
  __device__ __forceinline__ unsigned ballot(bool p) { return __ballot_sync(~0u, p); }
  __device__ __forceinline__ void sync() { __syncwarp(); }
};

// The kernel's block: each thread runs a phase for its own index; cp.async
// copies into shared memory, waited on per thread before the barrier
struct DeviceBlock {
  template <class F>
  __device__ __forceinline__ void threads(F&& f) {
    f(static_cast<int>(threadIdx.x));
  }
  template <class F>
  __device__ __forceinline__ void warp(F&& f) {
    if (threadIdx.x < 32) {
      WarpShfl w;
      f(static_cast<int>(threadIdx.x), w);
    }
  }
  __device__ __forceinline__ void sync() { __syncthreads(); }
  __device__ __forceinline__ void copy16(float* d, const float* s) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(d))),
                 "l"(s)
                 : "memory");
  }
  __device__ __forceinline__ void copy4(float* d, const float* s) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(d))),
                 "l"(s)
                 : "memory");
  }
  __device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
  template <int N>
  __device__ __forceinline__ void wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  }
};
#endif

// A chunk: n rows of a problem's (rows, H·m) array `src` in a slot. The
// draws' chunks (quarter 0) are consecutive rows r0, r0 + 1, ..., one run
// in the slot at the source's 16-byte offset `shift` (src null: the
// state's rows, at 0); the candidates' (quarter = K/4) hold groups: steps
// s0, s0 + 1, ... of the mean (update_mean_chunk), a row every P floats,
// each at its own source's offset
struct Chunk {
  float* slot;
  const float* src;
  int n, r0, s0, quarter, shift;
};

// the candidates' rows of step s of the mean for K = KC are c, c + K/4,
// c + K/2, c + 3K/4, whose products sum_fixed's first two levels add
// ((p_c + p_c+K/2) + (p_c+K/4 + p_c+3K/4): Q_c), the steps in the order the
// rest of sum_fixed adds the Q: K = 32, the chain over j of Q_j + Q_j+4;
// K = 64, of (Q_j + Q_j+8) + (Q_j+4 + Q_j+12)
template <int KC>
QS_FN int mean_step_row(int s) {
  if constexpr (KC == 32) {
    return (s >> 1) + 4 * (s & 1);
  } else {
    const int q = s & 3;
    return (s >> 2) + 8 * (q & 1) + 4 * (q >> 1);
  }
}

// the source row of a chunk's i-th row
template <int KC>
QS_FN int chunk_src_row(const Chunk& ch, int i) {
  return ch.quarter == 0 ? ch.r0 + i
                         : mean_step_row<KC>(ch.s0 + i / kGroupRows) +
                               (i % kGroupRows) * ch.quarter;
}

template <int KC>
QS_FN float* chunk_row(const Chunk& ch, int i, int P, int E) {
  if (ch.quarter == 0) return ch.slot + ch.shift + i * E;
  return ch.slot + i * P +
         shift_of(ch.src + static_cast<int64_t>(chunk_src_row<KC>(ch, i)) * E);
}

// A run of n floats cut where 16-byte pieces can go: `head` floats up to a
// 16-byte boundary of the source, `body` pieces, the floats after; piece p
// of pieces() starts at float at(p) and is 16 bytes where wide(p)
struct Run {
  int head, body, n;
  QS_FN Run(const float* src, int n_) : n(n_) {
    head = imin((4 - shift_of(src)) & 3, n);
    body = (n - head) >> 2;
  }
  QS_FN int pieces() const { return n - 3 * body; }
  QS_FN bool wide(int p) const { return p >= head && p < head + body; }
  QS_FN int at(int p) const { return p < head ? p : (wide(p) ? head + 4 * (p - head)
                                                             : p + 3 * body); }
};

// this thread's share of the chunk's copies, in 16-byte pieces where the
// source allows: a draws' chunk is one run; a candidates' chunk a run a
// row, walked as (row, piece) with room for the most pieces a row has
template <int KC, class Block>
QS_FN void issue_chunk(Block& blk, int tid, int nt, const Chunk& ch, int P, int E) {
  if (ch.quarter == 0) {
    const float* g = ch.src + static_cast<int64_t>(ch.r0) * E;
    float* d = ch.slot + ch.shift;
    const Run run(g, ch.n * E);
    for (int p = tid; p < run.pieces(); p += nt) {
      const int o = run.at(p);
      if (run.wide(p))
        blk.copy16(d + o, g + o);
      else
        blk.copy4(d + o, g + o);
    }
    return;
  }
  const int per_row = E / 4 + 6;
  int i = tid / per_row, p = tid - i * per_row;
  while (i < ch.n) {
    const float* g = ch.src + static_cast<int64_t>(chunk_src_row<KC>(ch, i)) * E;
    float* d = chunk_row<KC>(ch, i, P, E);
    const Run run(g, E);
    for (; p < per_row; p += nt) {
      if (p >= run.pieces()) continue;
      const int o = run.at(p);
      if (run.wide(p))
        blk.copy16(d + o, g + o);
      else
        blk.copy4(d + o, g + o);
    }
    i += p / per_row;
    p %= per_row;
  }
}

// n floats from shared memory to device memory: 16-byte stores where the
// two sit at the same offset from a 16-byte boundary
QS_FN void store_run(int tid, int nt, float* dst, const float* src, int n) {
  if (shift_of(dst) != shift_of(src)) {
    for (int e = tid; e < n; e += nt) dst[e] = src[e];
    return;
  }
  const Run run(dst, n);
  for (int p = tid; p < run.pieces(); p += nt) {
    const int o = run.at(p);
    if (run.wide(p))
      store16(dst + o, src + o);
    else
      dst[o] = src[o];
  }
}

// scale_action_to_command of a joint of the expanded action, as
// interfaces.action_to_command computes it for PD: src, sign, lo, hi - lo, hi
QS_FN float joint_target(int src, float sign, float lo, float scale, float hi,
                         const float* act) {
  const float a = src < 0 ? 0.0f : rn_mul(act[src], sign);
  // torch.minimum(torch.maximum(x, lo), hi), as interfaces._clip: a NaN stays NaN
  const float x = clamp_nan(a, -1.0f, 1.0f);
  const float cmd = rn_add(lo, rn_mul(rn_mul(0.5f, rn_add(x, 1.0f)), scale));
  return clamp_nan(cmd, lo, hi);
}

// phase 3c-4, one chunk, by nt threads: its rows to `rows`, then their
// joint targets, 4 a thread, consecutive threads on consecutive 16 bytes
// of the chunk's run (a multiple of 3 of the threads, so that a thread's
// quarter of a knot's 12 targets stays the same from step to step)
template <int KC>
QS_FN void update_write_chunk(const UpdateArgs& a, int64_t b, int tid, int nt, const Chunk& ch,
                              int P, int R, const JointTable& jt) {
  const int H = a.horizon, m = a.actions, E = H * m;
  store_run(tid, nt, a.rows + (b * R + ch.r0) * E, chunk_row<KC>(ch, 0, P, E), ch.n * E);
  const int nq = nt / 3 * 3;
  if (a.q_des == nullptr || tid >= nq) return;
  float* q = a.q_des + (b * R + ch.r0) * H * 12;
  const bool vec = shift_of(q) == 0;
  const int quarter = tid % 3;
  int src[4];
  float sign[4], lo[4], scale[4], hi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = 4 * quarter + j;
    src[j] = jt.src[i];
    sign[j] = jt.sign[i];
    lo[j] = jt.lo[i];
    scale[j] = jt.scale[i];
    hi[j] = jt.hi[i];
  }
  const int step = nq / 3;   // knots a step
  int i = (tid / 3) / H, t = tid / 3 - i * H;
  const float* row = i < ch.n ? chunk_row<KC>(ch, i, P, E) : nullptr;
  for (int f = tid; f < ch.n * H * 3; f += nq) {
    const float* act = row + t * m;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = joint_target(src[j], sign[j], lo[j], scale[j], hi[j], act);
    if (vec) {
      store4(q + 4 * f, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) q[4 * f + j] = v[j];
    }
    t += step;
    if (t >= H) {
      while (t >= H) {
        t -= H;
        ++i;
      }
      row = i < ch.n ? chunk_row<KC>(ch, i, P, E) : nullptr;
    }
  }
}

// phase 3a, one chunk of draws in place, by nt threads: a thread a (row,
// action) stream along H, the low-pass's state in a register; leaves
// σ_i·draw low-passed (c), or σ_i·draw where the low-pass is off
template <int KC>
QS_FN void update_lowpass(const UpdateArgs& a, int tid, int nt, const Chunk& ch, int P) {
  const int H = a.horizon, m = a.actions, E = H * m;
  const float sigma = *a.sigma, lp_a = a.lp_a, lp_b = a.lp_b;
  for (int s = tid; s < ch.n * m; s += nt) {
    const int i = s / m, j = s - i * m;
    float* d = chunk_row<KC>(ch, i, P, E) + j;
    if (!a.smooth) {
      for (int t = 0; t < H; ++t) d[t * m] = rn_mul(sigma, d[t * m]);
      continue;
    }
    float c = 0.0f;
    for (int t = 0; t < H; ++t) {
      c = rn_add(rn_mul(lp_a, c), rn_mul(lp_b, rn_mul(sigma, d[t * m])));
      d[t * m] = c;
    }
  }
}

// phase 3b, one chunk in place, every element: renormalised per knot (the
// low-pass), row 0 zero with the fused accept, added to the tile, clipped
QS_FN float candidate(const UpdateArgs& a, float d, float norm, float tile, bool zero) {
  float eps = a.smooth ? rn_div(d, norm) : d;
  if (zero) eps = 0.0f;
  return clamp_nan(rn_add(tile, eps), a.u_min, a.u_max);
}

// (the chunk's run, 4 elements a thread in 16-byte pieces where the run
// starts at a 16-byte boundary, the norm and tile read by element where
// H·m is not a multiple of 4)
QS_FN void update_candidates(const UpdateArgs& a, int tid, int nt, const Chunk& ch,
                             const float* tile, const float* norm) {
  const int E = a.horizon * a.actions, n = ch.n * E;
  float* d = ch.slot + ch.shift;
  // the fused accept's row 0: the chunk's first E elements
  const int zero_end = a.fused && ch.r0 == 0 ? E : 0;
  if (ch.shift == 0 && n % 4 == 0) {
    for (int f = 4 * tid, e = f % E; f < n; f += 4 * nt) {
      float v[4], nv[4], tv[4];
      load4(d + f, v);
      if (E % 4 == 0) {
        load4(norm + e, nv);
        load4(tile + e, tv);
      } else {
#pragma unroll
        for (int j = 0, ej = e; j < 4; ++j, ej = ej + 1 < E ? ej + 1 : 0) {
          nv[j] = norm[ej];
          tv[j] = tile[ej];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = candidate(a, v[j], nv[j], tv[j], f + j < zero_end);
      store4(d + f, v);
      e += 4 * nt;
      while (e >= E) e -= E;
    }
    return;
  }
  for (int f = tid, e = tid % E; f < n; f += nt) {
    d[f] = candidate(a, d[f], norm[e], tile[e], f < zero_end);
    e += nt;
    while (e >= E) e -= E;
  }
}

// the first argmin over the warp: the lower index on a tie
template <class W>
QS_FN void argmin_warp(W& wp, float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = wp.shfl_xor(v, off);
    const int oi = wp.shfl_xor(i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// sum_fixed over K = 32·V values, lane l holding l, l + 32, ...: for K = 64
// the halves first in each lane, then the halves at 16, 8 and 4 across
// lanes, then lanes 0-3 chained in index order; every lane gets the sum
template <int V, class W>
QS_FN float warp_sum_fixed(W& wp, const float (&v)[V]) {
  static_assert(V == 1 || V == 2, "K = 32 or 64");
  float s = V == 2 ? rn_add(v[0], v[V - 1]) : v[0];
  s = rn_add(s, wp.shfl_down(s, 16));
  s = rn_add(s, wp.shfl_down(s, 8));
  s = rn_add(s, wp.shfl_down(s, 4));
  const float s0 = wp.shfl(s, 0), s1 = wp.shfl(s, 1), s2 = wp.shfl(s, 2), s3 = wp.shfl(s, 3);
  return rn_add(rn_add(rn_add(s0, s1), s2), s3);
}

QS_FN bool elite_cut(int less, int leq, int n_elite) { return less < n_elite && n_elite <= leq; }

// phase 1a, warp 0: the costs, their argmin, the n_elite-th smallest, the
// normalised weights (to shared `w`); the fused accept's best tracking
template <int KC, class W>
QS_FN void update_scalars(const UpdateArgs& a, int64_t b, int lane, W& wp, float* sm,
                          const UpdateLayout& L, UpdateShared& sh) {
  const int K = a.samples;
  const float* costs = a.costs + b * K;
  float* w = sm + L.w;
  float best;
  int ib;
  if constexpr (KC != 0) {
    constexpr int V = KC / 32;
    float c[V], wv[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float x = costs[lane + 32 * v];
      c[v] = isfinite(x) ? x : INFINITY;
    }
    best = c[0];
    ib = lane;
#pragma unroll
    for (int v = 1; v < V; ++v)
      if (c[v] < best) {
        best = c[v];
        ib = lane + 32 * v;
      }
    argmin_warp(wp, best, ib);
    int less[V] = {}, leq[V] = {};
    for (int src = 0; src < 32; ++src) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float x = wp.shfl(c[u], src);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          less[v] += x < c[v];
          leq[v] += x <= c[v];
        }
      }
    }
    bool hit = false;
    float kv = 0.0f;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (!hit && elite_cut(less[v], leq[v], a.n_elite)) {   // all such c[v] equal
        hit = true;
        kv = c[v];
      }
    const float kth = wp.shfl(kv, lowest_lane(wp.ballot(hit)));
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float e = expf(rn_mul(-rn_sub(c[v], best), a.rcp_temperature));
      wv[v] = c[v] <= kth ? e : 0.0f;
    }
    const float total = clamp_min_nan(warp_sum_fixed<V>(wp, wv), 1e-12f);
#pragma unroll
    for (int v = 0; v < V; ++v) w[lane + 32 * v] = rn_div(wv[v], total);
  } else {
    float* c = sm + L.c;
    best = INFINITY;
    ib = K;
    for (int k = lane; k < K; k += 32) {
      const float x = costs[k];
      c[k] = isfinite(x) ? x : INFINITY;
      if (k == lane || c[k] < best) {
        best = c[k];
        ib = k;
      }
    }
    argmin_warp(wp, best, ib);
    wp.sync();
    bool hit = false;
    float kv = 0.0f;
    for (int k = lane; k < K; k += 32) {
      int less = 0, leq = 0;
      for (int j = 0; j < K; ++j) {
        less += c[j] < c[k];
        leq += c[j] <= c[k];
      }
      if (!hit && elite_cut(less, leq, a.n_elite)) {
        hit = true;
        kv = c[k];
      }
    }
    const float kth = wp.shfl(kv, lowest_lane(wp.ballot(hit)));
    for (int k = lane; k < K; k += 32) {
      const float e = expf(rn_mul(-rn_sub(c[k], best), a.rcp_temperature));
      w[k] = c[k] <= kth ? e : 0.0f;
    }
    wp.sync();
    float total = 0.0f;
    if (lane == 0) {
      float* scratch = sm + L.cols;
      for (int k = 0; k < K; ++k) scratch[k] = w[k];
      total = sum_fixed_strided(scratch, K, 1);
    }
    total = clamp_min_nan(wp.shfl(total, 0), 1e-12f);
    for (int k = lane; k < K; k += 32) w[k] = rn_div(w[k], total);
  }
  if (lane == 0) {
    sh.ib = ib;
    if (a.fused) {
      sh.better = best < a.cost[b];
      if (sh.better) a.cost[b] = best;
      a.trace[b * a.iterations + a.trace_col] = a.cost[b];
    }
  }
}

// phase 1b, one chunk of the candidates (steps s0 .. s0 + groups - 1), by
// nt threads: each element's Q of each step, folded into its partial sums
// in `part` (the chain, and one or two pending terms); after the last step
// the clipped sum is the proposal
template <int KC>
QS_FN void update_mean_chunk(const UpdateArgs& a, int tid, int nt, const Chunk& ch, int P,
                             const float* w, float* part, float* prop, float* tile) {
  const int E = a.horizon * a.actions, q = ch.quarter;
  constexpr int per_term = KC / 16;   // steps a term of the chain takes
  float* acc = part;
  float* p0 = part + E;
  float* p1 = part + 2 * E;
  for (int g = 0; g < ch.n / kGroupRows; ++g) {
    const int s = ch.s0 + g, c = mean_step_row<KC>(s), step = s % per_term;
    const bool first = s / per_term == 0, last = s == KC / kGroupRows - 1;
    const float* r0 = chunk_row<KC>(ch, 4 * g, P, E);
    const float* r1 = chunk_row<KC>(ch, 4 * g + 1, P, E);
    const float* r2 = chunk_row<KC>(ch, 4 * g + 2, P, E);
    const float* r3 = chunk_row<KC>(ch, 4 * g + 3, P, E);
    const float w0 = w[c], w1 = w[c + q], w2 = w[c + 2 * q], w3 = w[c + 3 * q];
    for (int e = tid; e < E; e += nt) {
      const float Q = rn_add(rn_add(rn_mul(w0, r0[e]), rn_mul(w2, r2[e])),
                             rn_add(rn_mul(w1, r1[e]), rn_mul(w3, r3[e])));
      float term;
      if (step == 0) {
        p0[e] = Q;
        continue;
      }
      if constexpr (KC == 32) {
        term = rn_add(p0[e], Q);
      } else {
        if (step == 1) {
          p0[e] = rn_add(p0[e], Q);
          continue;
        }
        if (step == 2) {
          p1[e] = Q;
          continue;
        }
        term = rn_add(p0[e], rn_add(p1[e], Q));
      }
      const float sum = first ? term : rn_add(acc[e], term);
      if (!last) {
        acc[e] = sum;
        continue;
      }
      const float v = clamp_nan(sum, a.u_min, a.u_max);
      prop[e] = v;
      if (a.fused) tile[e] = v;
    }
  }
}

// phase 1b for K outside the compiled set: each element's K products in
// this thread's column of `cols` (nt columns), summed in sum_fixed's order,
// clipped
QS_FN void update_mean_general(const UpdateArgs& a, int64_t b, int tid, int nt, const float* w,
                               float* cols, float* prop, float* tile) {
  const int K = a.samples;
  const int64_t E = static_cast<int64_t>(a.horizon) * a.actions;
  const float* cand = a.cand + b * K * E;
  for (int64_t e = tid; e < E; e += nt) {
    for (int k = 0; k < K; ++k) cols[k * nt + tid] = rn_mul(w[k], cand[k * E + e]);
    const float v = clamp_nan(sum_fixed_strided(cols + tid, K, nt), a.u_min, a.u_max);
    prop[e] = v;
    if (a.fused) tile[e] = v;
  }
}

// the fused accept's best candidate, where it beat the running best
QS_FN void update_copy_best(const UpdateArgs& a, int64_t b, int tid, int nt,
                            const UpdateShared& sh) {
  if (!a.fused || !sh.better) return;
  const int64_t E = static_cast<int64_t>(a.horizon) * a.actions;
  const float* best = a.cand + (b * a.samples + sh.ib) * E;
  for (int64_t e = tid; e < E; e += nt) a.us_alt[b * E + e] = best[e];
}

// The whole update of problem b by a.threads threads; Block: DeviceBlock,
// or the host build's
template <int KC, class Block>
QS_FN void update_problem(Block& blk, const UpdateArgs& a, int64_t b, float* sm,
                          UpdateShared& sh, JointTable& jt) {
  const int K = a.samples, H = a.horizon, m = a.actions, E = H * m, G = a.group;
  const int nt = a.threads;
  const UpdateLayout L = update_layout(K, H, m, nt, G);
  const bool cands = a.out_rows == kRowsCandidates;
  const int R = cands ? K : (a.out_rows == kRowsBoth ? 2 : 1);
  const bool propose = a.costs != nullptr;
  const int nc = propose && KC != 0 ? KC / kGroupRows / G : 0;
  const int rows_a_chunk = G * kGroupRows;
  const int nd = cands ? (K + rows_a_chunk - 1) / rows_a_chunk : 0;
  float* tile = sm + L.tile;
  float* norm = sm + L.norm;
  float* prop = propose ? (a.fused ? a.us : a.us_alt) + b * E : nullptr;
  const float* cand = propose ? a.cand + b * K * E : nullptr;
  const float* draw = cands ? a.draw + b * K * E : nullptr;
  auto slot = [&](int s) { return sm + L.slots + s * L.slot_floats; };
  auto cand_chunk = [&](int c) {
    return Chunk{slot(c % kCandSlots), cand, rows_a_chunk, 0, c * G, K / kGroupRows, 0};
  };
  auto draw_chunk = [&](int i) {
    const int r0 = i * rows_a_chunk;
    return Chunk{slot((i + kDrawSlots - 1) % kDrawSlots), draw, imin(rows_a_chunk, K - r0), r0,
                 0, 0, shift_of(draw + static_cast<int64_t>(r0) * E)};
  };
  // the low-pass's threads where it runs beside a write-out: the last
  // warps, two streams a thread, at most half the block
  const int lp_threads = imin((imin(rows_a_chunk, K) * m + 63) / 64 * 32, nt / 2);

  // in flight from the start: the draws' first chunk, the mean's first
  // kCandSlots - 1 chunks (a group of copies each, empty or not); the
  // small tables
  blk.threads([&](int tid) {
    if (cands) issue_chunk<KC>(blk, tid, nt, draw_chunk(0), L.P, E);
    blk.commit();
    for (int c = 0; c < kCandSlots - 1; ++c) {
      if (c < nc) issue_chunk<KC>(blk, tid, nt, cand_chunk(c), L.P, E);
      blk.commit();
    }
    if (a.q_des != nullptr && tid < 12) {
      jt.src[tid] = a.joint_src[tid];
      jt.sign[tid] = a.joint_sign[tid];
      jt.lo[tid] = a.lower[tid];
      jt.hi[tid] = a.upper[tid];
      jt.scale[tid] = rn_sub(a.upper[tid], a.lower[tid]);
    }
    if (cands && a.smooth)
      for (int e = tid; e < E; e += nt) norm[e] = a.norm[e / m];
    if (cands && !(propose && a.fused))
      for (int e = tid; e < E; e += nt) tile[e] = a.us[b * E + e];
  });

  if (propose) {
    blk.warp([&](int lane, auto& wp) { update_scalars<KC>(a, b, lane, wp, sm, L, sh); });
    if constexpr (KC != 0) {
      for (int c = 0; c < nc; ++c) {
        blk.threads([&](int) { blk.template wait<kCandSlots - 2>(); });
        blk.sync();
        blk.threads([&](int tid) {
          if (c == 0) update_copy_best(a, b, tid, nt, sh);
          if (c + kCandSlots - 1 < nc)
            issue_chunk<KC>(blk, tid, nt, cand_chunk(c + kCandSlots - 1), L.P, E);
          blk.commit();
          update_mean_chunk<KC>(a, tid, nt, cand_chunk(c), L.P, sm + L.w, sm + L.part, prop,
                                tile);
        });
      }
    } else {
      blk.sync();
      blk.threads([&](int tid) {
        update_copy_best(a, b, tid, nt, sh);
        update_mean_general(a, b, tid, nt, sm + L.w, sm + L.cols, prop, tile);
      });
    }
  }

  if (a.cost_new != nullptr) {
    // the plain branch's accept test, then the accepted controls (and the
    // candidates' tile)
    blk.sync();
    blk.threads([&](int tid) {
      if (tid != 0) return;
      const float c_new = a.cost_new[b];
      sh.better = c_new < a.cost[b];
      if (sh.better) a.cost[b] = c_new;
      a.trace[b * a.iterations + a.trace_col] = a.cost[b];
    });
    blk.sync();
    blk.threads([&](int tid) {
      for (int e = tid; e < E; e += nt) {
        float v = a.us[b * E + e];
        if (sh.better) {
          v = a.us_alt[b * E + e];
          a.us[b * E + e] = v;
        }
        if (cands) tile[e] = v;
      }
    });
  }

  if (cands) {
    // iteration i: chunk i - 1's candidates made from its low-passed draws
    // (every thread, every element), chunk i + 2 issued; then chunk i - 1
    // written out while chunk i's draws are low-passed (the last warps)
    for (int i = 0; i <= nd; ++i) {
      blk.threads([&](int) {
        if (i == 0)
          blk.template wait<0>();
        else if (i < nd)
          blk.template wait<kDrawSlots - 3>();
      });
      blk.sync();
      blk.threads([&](int tid) {
        if (i > 0) update_candidates(a, tid, nt, draw_chunk(i - 1), tile, norm);
        if (i == 0)
          for (int k = 1; k <= kDrawSlots - 3; ++k) {
            if (k < nd) issue_chunk<KC>(blk, tid, nt, draw_chunk(k), L.P, E);
            blk.commit();
          }
        if (i + kDrawSlots - 2 < nd)
          issue_chunk<KC>(blk, tid, nt, draw_chunk(i + kDrawSlots - 2), L.P, E);
        blk.commit();
      });
      if (i > 0) blk.sync();
      blk.threads([&](int tid) {
        const bool both = i > 0 && i < nd;
        const int nw = both ? nt - lp_threads : nt;
        if (i > 0 && tid < nw)
          update_write_chunk<KC>(a, b, tid, nw, draw_chunk(i - 1), L.P, R, jt);
        if (i < nd && (!both || tid >= nw))
          update_lowpass<KC>(a, both ? tid - nw : tid, both ? lp_threads : nt, draw_chunk(i),
                             L.P);
      });
    }
  } else {
    // rows of the state, through slot 0
    const Chunk ch{slot(0), nullptr, R, 0, 0, 0, 0};
    blk.sync();
    blk.threads([&](int tid) {
      for (int r = 0; r < R; ++r) {
        const float* base = (a.out_rows == kRowsAlt || r == 1) ? a.us_alt : a.us;
        for (int e = tid; e < E; e += nt) ch.slot[r * E + e] = base[b * E + e];
      }
    });
    blk.sync();
    blk.threads([&](int tid) { update_write_chunk<KC>(a, b, tid, nt, ch, L.P, R, jt); });
  }
}

}  // namespace qs
