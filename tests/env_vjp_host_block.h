// The env_substeps_vjp kernel's block (quadruped_springs_tpu_torch/csrc/
// env_lane_vjp.cuh env_block_vjp) on the CPU, for the host builds of its
// body (tests/env_substeps_vjp_host.cpp, env_substeps_vjp_host64.cpp,
// env_substeps_opcount.cpp). Include after the body, with `float` as the
// build defines it.
//
// HostBlock runs each phase of a block thread by thread, which is what the
// kernel's barriers between phases guarantee: each(f) calls f(t) for t = 0,
// 1, ..., 255 in turn; quads(warps, f) runs the first `warps` warps' groups
// of four lanes one group at a time, warp 0's first, each group on four host
// threads whose sums over the four (HostQuad) meet at a barrier and add in
// the kernel's fixed order (v0 + v1) + (v2 + v3); the named barriers between
// warp 0 and another warp (arrive, wait) hold already. run_vjp_blocks runs the launch's blocks
// one after another in a buffer of the block's shared memory at `chunk`.

#pragma once

#include <barrier>
#include <stdint.h>
#include <thread>
#include <vector>

namespace qs_host {

// called with the lane's slot as each host thread of a quad starts
// (env_substeps_opcount.cpp's hook), or null
inline void (*on_quad_thread)(int slot) = nullptr;

template <class T>
struct HostQuad {
  std::barrier<>* bar;
  T (*slots)[32];
  int leg;
  void (*on_sum)(bool) = nullptr;   // around the adds (the opcount's hook), or null

  template <int N>
  void sum(T (&v)[N]) {
    static_assert(N <= 32, "one slot row holds 32 values");
    for (int i = 0; i < N; ++i) slots[leg][i] = v[i];
    bar->arrive_and_wait();
    if (on_sum) on_sum(true);
    for (int i = 0; i < N; ++i)
      v[i] = (slots[0][i] + slots[1][i]) + (slots[2][i] + slots[3][i]);
    if (on_sum) on_sum(false);
    bar->arrive_and_wait();
  }
};

template <class T>
struct HostBlock {
  void (*on_sum)(bool) = nullptr;

  template <class F>
  void each(F&& f) {
    for (int t = 0; t < qs::kVjpThreads; ++t) f(t);
  }
  template <class F>
  void quads(int warps, F&& f) {
    for (int g = 0; g < 8 * warps; ++g) {
      std::barrier<> bar(4);
      T slots[4][32];
      std::vector<std::thread> lanes;
      for (int i = 0; i < 4; ++i)
        lanes.emplace_back([&, i] {
          if (on_quad_thread) on_quad_thread((4 * g + i) & 31);
          HostQuad<T> quad{&bar, slots, i, on_sum};
          f(4 * g + i, quad);
        });
      for (auto& t : lanes) t.join();
    }
  }
  void sync() {}
  // warp 0's groups run before the other warps': its writes come first
  void arrive(int) {}
  void wait(int) {}
};

// the chunk a launch of `substeps` substeps recomputes at once: the card's
// (an H100's 227 KB a block, in the build's `float`) where `chunk` is 0
inline int launch_chunk(int substeps, int chunk) {
  return chunk > 0 ? chunk : qs::vjp_chunk(substeps, 232448 / 4 * sizeof(float));
}

// the launch's blocks, one after another
template <class T>
void run_vjp_blocks(const qs::EnvConsts& c, const qs::EnvArgs& args, const qs::EnvVjpArgs& vargs,
                    int chunk, void (*on_sum)(bool) = nullptr) {
  std::vector<char> smem(qs::vjp_shared_bytes(chunk) + 64);
  void* sm = smem.data();
  const int64_t blocks = (args.n + qs::kVjpEnvs - 1) / qs::kVjpEnvs;
  for (int64_t b = 0; b < blocks; ++b) {
    HostBlock<T> blk{on_sum};
    qs::env_block_vjp(c, args, vargs, chunk, b, sm, blk);
  }
}

}  // namespace qs_host
