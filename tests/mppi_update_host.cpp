// The mppi_update kernel's body (quadruped_springs_tpu_torch/csrc/
// mppi_update.cuh) built for the CPU with a host C++ compiler, so that a CPU
// test can hold its arithmetic against the plain PyTorch version where no
// card is present. Each block (problem) runs update_problem through
// HostBlock: a phase for every thread index in turn (what the kernel's
// barriers between phases guarantee), the cp.async copies as plain copies
// done when issued, and the scalars' phase on 32 lanes of warp 0 whose
// shuffles meet at a barrier. The entry points take the kernel
// launcher's arguments (host pointers; the stream is ignored), the warp's
// sum_fixed alone, and the layout of a block's shared memory. The 32 lanes
// are fibers (ucontext) on the calling thread: a lane runs to its next
// barrier and hands over to the next lane, lane 31 back to lane 0, which is
// the warp's lockstep where every lane meets every barrier in the same
// order. Build (tests/test_torch_mppi_update.py does):
//   g++ -std=c++20 -O2 -shared -fPIC -o libmppi_update_host.so
//       tests/mppi_update_host.cpp   (one command)

#include <string.h>
#include <ucontext.h>

#include <functional>
#include <vector>

#include "../quadruped_springs_tpu_torch/csrc/mppi_update.cuh"

namespace {

// The 32 lanes of warp 0 as fibers; `body` runs on each
struct Fibers {
  ucontext_t main, lane[32];
  std::vector<char> stacks[32];
  std::function<void(int)> body;
  int started = 0;
  float fslots[32];
  int islots[32];

  // lane -> the next one, which runs to its own next barrier
  void barrier(int l) { swapcontext(&lane[l], &lane[(l + 1) & 31]); }
};

thread_local Fibers* g_fibers = nullptr;

void fiber_entry() {
  Fibers* fb = g_fibers;
  fb->body(fb->started++);
}

// A lane of warp 0: a shuffle writes the lane's value, meets the other 31
// lanes at the barrier, reads its source's, and meets them again
struct HostWarp {
  Fibers* fb;
  int lane;

  float shfl(float v, int src) {
    fb->fslots[lane] = v;
    fb->barrier(lane);
    const float r = fb->fslots[src & 31];
    fb->barrier(lane);
    return r;
  }
  int shfl(int v, int src) {
    fb->islots[lane] = v;
    fb->barrier(lane);
    const int r = fb->islots[src & 31];
    fb->barrier(lane);
    return r;
  }
  float shfl_xor(float v, int m) { return shfl(v, lane ^ m); }
  int shfl_xor(int v, int m) { return shfl(v, lane ^ m); }
  float shfl_down(float v, int d) { return shfl(v, lane + d < 32 ? lane + d : lane); }
  unsigned ballot(bool p) {
    fb->islots[lane] = p ? 1 : 0;
    fb->barrier(lane);
    unsigned mask = 0;
    for (int l = 0; l < 32; ++l) mask |= static_cast<unsigned>(fb->islots[l] != 0) << l;
    fb->barrier(lane);
    return mask;
  }
  void sync() { fb->barrier(lane); }
};

// f(lane, warp) on the 32 lanes; a lane that returns hands over to the next,
// the last back to the caller
template <class F>
void run_warp(F&& f) {
  static thread_local Fibers fb;
  fb.body = [&](int lane) {
    HostWarp w{&fb, lane};
    f(lane, w);
  };
  fb.started = 0;
  for (int l = 0; l < 32; ++l) {
    fb.stacks[l].resize(1 << 16);
    getcontext(&fb.lane[l]);
    fb.lane[l].uc_stack.ss_sp = fb.stacks[l].data();
    fb.lane[l].uc_stack.ss_size = fb.stacks[l].size();
    fb.lane[l].uc_link = l < 31 ? &fb.lane[l + 1] : &fb.main;
    makecontext(&fb.lane[l], fiber_entry, 0);
  }
  Fibers* outer = g_fibers;
  g_fibers = &fb;
  swapcontext(&fb.main, &fb.lane[0]);
  g_fibers = outer;
}

struct HostBlock {
  int n;
  template <class F>
  void threads(F&& f) {
    for (int t = 0; t < n; ++t) f(t);
  }
  template <class F>
  void warp(F&& f) {
    run_warp(f);
  }
  void sync() {}
  void copy16(float* d, const float* s) { memcpy(d, s, 16); }
  void copy4(float* d, const float* s) { *d = *s; }
  void commit() {}
  template <int N>
  void wait() {}
};

// the launch's shape: update_shape's for an H100's 132 SMs, or, where set
// (mppi_update_host_set_shape), these threads a block and groups a slot
qs::UpdateShape g_shape{0, 0};

template <int KC>
void run_problems(qs::UpdateArgs a) {
  const qs::UpdateShape shape =
      g_shape.threads > 0 ? g_shape
                          : qs::update_shape(a.samples, a.horizon, a.actions, a.n_problems, 132);
  a.threads = shape.threads;
  a.group = shape.group;
  const qs::UpdateLayout L =
      qs::update_layout(a.samples, a.horizon, a.actions, a.threads, a.group);
  // 16-byte aligned, as the kernel's dynamic shared memory
  std::vector<float> smem(static_cast<size_t>(L.floats) + 4);
  float* sm = smem.data();
  while (qs::shift_of(sm) != 0) ++sm;
  for (int64_t b = 0; b < a.n_problems; ++b) {
    HostBlock blk{a.threads};
    qs::UpdateShared sh{};
    qs::JointTable jt{};
    qs::update_problem<KC>(blk, a, b, sm, sh, jt);
  }
}

}  // namespace

extern "C" int mppi_update_host(QS_MPPI_UPDATE_PARAMS) {
  const qs::UpdateArgs a = qs::update_args(
      costs, cand, cost_new, draw, sigma, norm, lower, upper, us, us_alt, cost, trace, rows,
      q_des, n_problems, samples, horizon, actions, n_elite, trace_col, iterations, out_rows,
      fused, smooth, rcp_temperature, u_min, u_max, lp_a, lp_b, joint_src, joint_sign, stream);
  switch (samples) {
    case 32: run_problems<32>(a); break;
    case 64: run_problems<64>(a); break;
    default: run_problems<0>(a); break;
  }
  return 0;
}

// warp_sum_fixed over each of n rows of K = 32 or 64 values (w: (n, K))
extern "C" int mppi_update_host_sum(const float* w, int K, int n, float* out) {
  if (K != 32 && K != 64) return 1;
  for (int r = 0; r < n; ++r)
    run_warp([&](int lane, HostWarp& wp) {
      const float* x = w + static_cast<int64_t>(r) * K;
      float s;
      if (K == 32) {
        const float v[1] = {x[lane]};
        s = qs::warp_sum_fixed<1>(wp, v);
      } else {
        const float v[2] = {x[lane], x[lane + 32]};
        s = qs::warp_sum_fixed<2>(wp, v);
      }
      if (lane == 0) out[r] = s;
    });
  return 0;
}

extern "C" void mppi_update_host_set_shape(int threads, int group) {
  g_shape = {threads, group};
}

// the dynamic shared bytes of a launch at K, H, m, 128 threads a block and
// one group a slot (the wrapper's check), and the shape of a launch of B
// problems on `sms` SMs (threads, groups)
extern "C" int64_t mppi_update_host_smem(int samples, int horizon, int actions) {
  return static_cast<int64_t>(
      qs::update_smem_bytes(samples, horizon, actions, qs::kUpdateThreads, 1));
}

extern "C" void mppi_update_host_shape(int samples, int horizon, int actions,
                                       int64_t n_problems, int sms, int* out) {
  const qs::UpdateShape shape = qs::update_shape(samples, horizon, actions, n_problems, sms);
  out[0] = shape.threads;
  out[1] = shape.group;
}
