// The env_substeps_vjp kernel's body (quadruped_springs_tpu_torch/csrc/
// env_lane_vjp.cuh env_block_vjp) built for the CPU with a host C++
// compiler: each block of 8 environments runs phase by phase, thread by
// thread, each group of four lanes whose Schur shares are summed on four host
// threads (tests/env_vjp_host_block.h). The entry point takes the kernel
// launcher's arguments (host pointers; the stream is ignored); the chunk of
// substeps recomputed at once is the card's (an H100's 227 KB of shared
// memory a block) unless env_substeps_vjp_host_set_chunk sets another.
// Build (tests/test_torch_env_vjp.py does):
//   g++ -std=c++20 -O2 -shared -fPIC -pthread -o libenv_substeps_vjp_host.so
//       tests/env_substeps_vjp_host.cpp   (one command)

#include <string.h>

#include "../quadruped_springs_tpu_torch/csrc/env_lane_vjp.cuh"
#include "env_vjp_host_block.h"

namespace {
int g_chunk = 0;   // 0: the card's
}  // namespace

extern "C" int env_substeps_vjp_host(QS_ENV_SUBSTEPS_ARGS, QS_ENV_VJP_PARAMS, void* stream) {
  (void)stream;
  if (n_consts != qs::kConstsFloats) return 1;
  qs::EnvConsts c;
  memcpy(&c, consts, sizeof(c));
  const qs::EnvArgs args = QS_ENV_ARGS_FROM_PARAMS;
  const qs::EnvVjpArgs vargs = QS_ENV_VJP_ARGS_FROM_PARAMS;
  const int chunk = qs_host::launch_chunk(substeps, g_chunk);
  if (chunk < 1) return 1;
  qs_host::run_vjp_blocks<float>(c, args, vargs, chunk);
  return 0;
}

// the chunk of substeps later calls recompute at once (0: the card's), and
// the card's at `substeps`
extern "C" void env_substeps_vjp_host_set_chunk(int chunk) { g_chunk = chunk; }
extern "C" int env_substeps_vjp_host_chunk(int substeps) {
  return qs_host::launch_chunk(substeps, 0);
}
