"""planner_rollout's design steps side by side on the card, in one process.

    python tests/torch_rollout_design_probe.py --parent DIR [--rounds N] [--sass DIR]

Builds the `planner_rollout` kernel (csrc/planner_rollout.cu) in variants,
all nvcc processes at once, each into a library of its own:
  * parent: the kernel of DIR, an unpacked `git archive` of another commit
    (in a gitignored directory such as _checkout/), as that commit builds it;
    parent_nofma the same with -fmad=false (no multiply-add contracted);
  * t128_b4: this checkout as it builds (each problem's model staged in
    shared memory; 128 threads a block, 4 blocks an SM: at most 128
    registers a thread), nofma the same with -fmad=false;
  * t128_b1, t128_b3: at launch bounds (128) and (128, 3) (at most 255 and
    168 registers); t32_b15: 32 threads a block, 15 blocks an SM (at most
    136 registers: 15 warps an SM);
  * cmd_regs_b4, prefetch_b4: t128_b4 with the knot's three commands held in
    registers over its substeps, read after the knot or, prefetched, while
    it runs; fence_b4: t128_b4 with a compiler fence a substep that forbids
    hoisting the staged model's loads out of the loop; unpinned_b4: t128_b4
    with the products of model constants in the hip's body and column
    (mul_rn) left to the compiler to contract.
Each variant but the parents' is a copy of this csrc/ with the text
replaced.
The kernel's registers, local memory and blocks an SM at each shape come
from this checkout's entry point planner_rollout_occupancy, and for the
parent, which has none, from the same CUDA calls in one more translation
unit around its source (without dynamic shared memory, as it launches).

Prints one JSON line per variant (ptxas's -Xptxas -v line, the kernel's SASS
instruction counts from cuobjdump; --sass DIR writes the parent's and
t128_b4's SASS there) and one per shape: the MPPI headline (1,024
TEST_RANDOMIZER problems x 32 candidates x H = 50 x 2 substeps of the
relaxed model, chip_smoke.py phase 19's problems and candidates), the
full-rate row (x 25 knots x 10 substeps) and the closed loop's executor (1 x
1 x 1 x 10 on the nominal row): per variant the kernel's time on the card
(CUDA events around back-to-back launches through ctypes, the median over
rounds that take the variants in turn, forward then backward), its warps
an SM, the share of the SMs' issue slots its substep loop's instructions
fill (substep_loop's count x warps x substeps over the time x SMs x 4
schedulers x the SM clock nvidia-smi reads), and its output against the
parent's (bitwise, or the largest |d|;
the -fmad=false builds also against parent_nofma; the lanes whose every
knot is bitwise the parent's and the first knot where any lane parts),
and the SM clock that nvidia-smi reads while t128_b4 runs.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# planner_lane.cuh's knot loop, and the two loops the cmd_regs and prefetch
# variants put in its place
KNOT_LOOP = """  const float* cmd = a.q_des + lane * a.horizon * 12 + 3 * leg;
  for (int t = 0; t < a.horizon; ++t) {
    for (int r = 0; r < a.substeps; ++r)
      lane_substep<false>(k, c, cmd, false, false, clamp_damping, false, no_force, s,
                          no_anchor_x, no_anchor_y, o, quad);
    out += kStateFloats;
    cmd += 12;
    write_state(out, s, leg);
  }
"""
CMD_LOOP = """  const float* src = a.q_des + lane * a.horizon * 12 + 3 * leg;
  float cmd[3], next[3];
  for (int j = 0; j < 3; ++j) next[j] = cmd[j] = src[j];
  for (int t = 0; t < a.horizon; ++t) {
    if (%(prefetch)d && t + 1 < a.horizon)
      for (int j = 0; j < 3; ++j) next[j] = src[12 * (t + 1) + j];
    for (int r = 0; r < a.substeps; ++r)
      lane_substep<false>(k, c, cmd, false, false, clamp_damping, false, no_force, s,
                          no_anchor_x, no_anchor_y, o, quad);
    out += kStateFloats;
    write_state(out, s, leg);
    if (t + 1 < a.horizon)
      for (int j = 0; j < 3; ++j) cmd[j] = %(prefetch)d ? next[j] : src[12 * (t + 1) + j];
  }
"""

# go1_dynamics.cuh's hip column and hip body with their model-constant
# products pinned by mul_rn, and as they were before
MUL_RN = """  L.Fb[0] = add(scale(-1.0f, cross(L.Ic1.h, L.sw[0])),
                v3(mul_rn(L.Ic1.m, L.sv[0].x), mul_rn(L.Ic1.m, L.sv[0].y),
                   mul_rn(L.Ic1.m, L.sv[0].z)));
"""
NO_MUL_RN = """  L.Fb[0] = add(scale(-1.0f, cross(L.Ic1.h, L.sw[0])), scale(L.Ic1.m, L.sv[0]));
"""

# the blocks of 128 threads an SM must hold, and the block's threads
MIN_BLOCKS = ("planner_rollout.cu", "constexpr int kMinBlocks = 4;")
THREADS = ("planner_lane.cuh", "constexpr int kRolloutThreads = 128;")
blocks = lambda n: (*MIN_BLOCKS, f"constexpr int kMinBlocks = {n};")
FENCED_LOOP = KNOT_LOOP.replace("""    for (int r = 0; r < a.substeps; ++r)
      lane_substep<false>(k, c, cmd, false, false, clamp_damping, false, no_force, s,
                          no_anchor_x, no_anchor_y, o, quad);
""", """    for (int r = 0; r < a.substeps; ++r) {
      asm volatile("" ::: "memory");
      lane_substep<false>(k, c, cmd, false, false, clamp_damping, false, no_force, s,
                          no_anchor_x, no_anchor_y, o, quad);
    }
""")

# name: (csrc/ of "parent" or "this", nvcc flags, text patches of this
# csrc/ (file, old, new) applied to a copy)
VARIANTS = {
    "parent": ("parent", [], []),
    "parent_nofma": ("parent", ["-fmad=false"], []),
    "t128_b4": ("this", [], []),
    "nofma": ("this", ["-fmad=false"], []),
    "t128_b1": ("this", [], [blocks(1)]),
    "t128_b3": ("this", [], [blocks(3)]),
    "t32_b15": ("this", [], [blocks(15), (*THREADS, "constexpr int kRolloutThreads = 32;")]),
    "cmd_regs_b4": ("this", [], [("planner_lane.cuh", KNOT_LOOP, CMD_LOOP % {"prefetch": 0})]),
    "prefetch_b4": ("this", [], [("planner_lane.cuh", KNOT_LOOP, CMD_LOOP % {"prefetch": 1})]),
    "fence_b4": ("this", [], [("planner_lane.cuh", KNOT_LOOP, FENCED_LOOP)]),
    "unpinned_b4": ("this", [], [("go1_dynamics.cuh", MUL_RN, NO_MUL_RN),
                                  ("go1_dynamics.cuh", "body_inertia_base<true>(",
                                   "body_inertia_base<false>(")]),
}
SASS_OF = ("parent", "t128_b4")

# One more translation unit around the kernel's source: what the card makes
# of its kernel (planner_rollout_occupancy's numbers) at `smem` bytes of
# dynamic shared memory, 128 threads a block.
PROBE_UNIT = r"""
#include "%s"
extern "C" int probe_kernel(long long smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, planner_rollout_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, planner_rollout_kernel, 128,
                                                      static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = 128;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = static_cast<int>(smem);
  return 0;
}
"""


def source_dir(tmp, name, base, patches, parent):
    """The csrc/ a variant builds from: the parent's, this one, or a copy of
    this one with `patches` applied."""
    if base == "parent":
        return os.path.join(parent, "quadruped_springs_tpu_torch", "csrc")
    here = os.path.join(ROOT, "quadruped_springs_tpu_torch", "csrc")
    if not patches:
        return here
    copy = os.path.join(tmp, "csrc_" + name)
    shutil.copytree(here, copy)
    for fname, old, new in patches:
        path = os.path.join(copy, fname)
        text = open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"{fname} no longer holds the text the {name} variant replaces")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return copy


def build(tmp, parent):
    """Every variant's library, all nvcc processes started together.
    Returns {name: (ctypes library, ptxas line of the kernel)}."""
    from quadruped_springs_tpu_torch import kernels

    nvcc = kernels._nvcc()
    procs = {}
    for name, (base, flags, patches) in VARIANTS.items():
        src = os.path.join(source_dir(tmp, name, base, patches, parent), "planner_rollout.cu")
        unit = os.path.join(tmp, name + ".cu")
        with open(unit, "w") as f:
            f.write(PROBE_UNIT % src)
        lib = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, *flags, "-shared", "-o", lib, unit],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        i = next(i for i, line in enumerate(lines)
                 if "Compiling entry function" in line and "planner_rollout_kernel" in line)
        out[name] = (ctypes.CDLL(lib), " | ".join(x.strip() for x in lines[i + 2:i + 4]))
    return out


def kernel_sass(lib_path, cuobjdump):
    """The kernel's SASS (cuobjdump -sass)."""
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    return text.split("planner_rollout_kernel", 1)[1].split("Function :", 1)[0]


def substep_loop(body):
    """The instructions of the kernel's substep loop that run on every pass:
    the loop is the largest backward branch inside the largest (the knot
    loop); left out are the ranges that a forward conditional branch skips
    to reach a slow path (a CALL, or the local-memory loop of sinf's and
    cosf's reduction of huge arguments). Returns (address, opcode) pairs."""
    ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);", body)]
    target = lambda rest: int(re.search(r"0x([0-9a-f]+)", rest).group(1), 16)
    back = [(t, a) for a, op, rest in ins if op == "BRA" and target(rest) < a
            for t in [target(rest)]]
    outer = max(back, key=lambda r: r[1] - r[0])
    lo, hi = max((r for r in back if outer[0] <= r[0] and r[1] < outer[1]),
                 key=lambda r: r[1] - r[0])
    cold = []
    for i, (a, op, rest) in enumerate(ins):
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
    kinds = ("LDS", "STS", "LDG", "STG", "LDL", "STL", "SHFL", "BAR", "LDC", "MUFU", "FFMA",
             "FMUL", "FADD")
    count = lambda ops, k: sum(1 for o in ops if o == k or o.startswith(k + "."))
    loop = [op for _, op in substep_loop(body)]
    return {"instructions": len(ops), **{k: count(ops, k) for k in kinds},
            "substep_loop": len(loop),
            "substep_loop_by_kind": {k: count(loop, k) for k in kinds + ("MOV",)}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--sass")
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_rollout_design_probe: no CUDA card")
    import chip_smoke
    from quadruped_springs_tpu_torch import closed_loop, kernels
    from quadruped_springs_tpu_torch.control import interfaces as ci
    from quadruped_springs_tpu_torch.solver import mppi
    from quadruped_springs_tpu_torch.solver import rollout as ro
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    head = {"device": torch.cuda.get_device_name(0), "nvidia_smi": card.strip()}
    emit = lambda rec: print(json.dumps({**head, **rec}), flush=True)
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, os.path.abspath(a.parent))
        loop_instructions = {}
        for name, (lib, ptxas) in libs.items():
            fn = lib.planner_rollout
            fn.argtypes, fn.restype = kernels.PLANNER_ROLLOUT_ARGTYPES, ctypes.c_int
            lib.probe_kernel.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
            if not name.startswith("parent"):
                lib.planner_rollout_occupancy.argtypes = [ctypes.c_int, ctypes.c_int64,
                                                          ctypes.c_void_p]
            rec = {"variant": name, "flags": VARIANTS[name][1], "ptxas": ptxas}
            if os.path.isfile(cuobjdump):
                body = kernel_sass(os.path.join(tmp, f"lib{name}.so"), cuobjdump)
                rec["sass"] = sass_counts(body)
                loop_instructions[name] = rec["sass"]["substep_loop"]
                if a.sass and name in SASS_OF:
                    os.makedirs(a.sass, exist_ok=True)
                    with open(os.path.join(a.sass, f"planner_rollout_{name}.sass"), "w") as f:
                        f.write(body)
            emit(rec)

        shapes = {}
        for setting, mk, horizon in (("headline", MPCConfig, chip_smoke.HORIZON),
                                     ("full_rate", MPCConfig.full_rate,
                                      chip_smoke.FULL_RATE_HORIZON)):
            prob = MPCProblem(mk(horizon=horizon), "cuda")
            x0, scen = chip_smoke.rollout_problems(torch, prob, chip_smoke.BATCH, 31)
            eps = 0.3 * torch.randn((chip_smoke.BATCH, chip_smoke.SAMPLES, horizon,
                                     prob.action_dim), device="cuda",
                                    generator=torch.Generator("cuda").manual_seed(32))
            us = torch.clamp(prob.task_warm_start()[None, None] + mppi._smooth_noise(eps),
                             -1.0, 1.0)
            shapes[setting] = (x0, ci.action_to_command(prob.iface, us).contiguous(),
                               prob.rollout_lanes(scen), prob.rollout_consts(), 5)
        prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE"), "cuda")
        lanes, consts = closed_loop.executor(prob)
        extend = prob.task_warm_start(crouch_knots=6)[-1]
        shapes["executor"] = (prob.default_x0()[None].contiguous(), ci.action_to_command(
            prob.iface, extend.expand(1, 1, 1, -1)).contiguous(), lanes, consts, 200)

        stream = kernels.stream_handle(torch.device("cuda"))
        for setting, (x0, q_des, lanes, consts, inner) in shapes.items():
            B, R, H, _ = q_des.shape
            stride = 0 if lanes.spring_k.shape[0] == 1 else 1
            outs, times = {}, {name: [] for name in libs}
            for name, (lib, _) in libs.items():
                args, outs[name] = ro.launch_args(x0, q_des, lanes, consts)
                assert lib.planner_rollout(*args, stream) == 0
            torch.cuda.synchronize()
            args, _ = ro.launch_args(x0, q_des, lanes, consts)   # the timed launches' output
            order = list(libs)
            for k in range(a.rounds):
                for name in (order if k % 2 == 0 else order[::-1]):
                    run = libs[name][0].planner_rollout
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(inner):
                        run(*args, stream)
                    end.record()
                    end.synchronize()
                    times[name].append(start.elapsed_time(end) / inner)
            rec = {"shape": setting, "lanes": B * R, "horizon": H, "substeps": consts.substeps,
                   "variants": {}}
            if setting != "executor":   # the SM clock under t128_b4's load
                run = libs["t128_b4"][0].planner_rollout
                for _ in range(100):
                    run(*args, stream)
                rec["nvidia_smi_under_load"] = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                     "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
                torch.cuda.synchronize()
                sm_hz = float(rec["nvidia_smi_under_load"].split()[0]) * 1e6
                # a warp instruction issues per cycle and scheduler, four an SM
                issue_per_s = torch.cuda.get_device_properties(0).multi_processor_count * 4 * sm_hz
            for name, (lib, _) in libs.items():
                occ = (ctypes.c_int * 5)()
                if name.startswith("parent"):
                    assert lib.probe_kernel(0, occ) == 0
                else:
                    assert lib.planner_rollout_occupancy(R, stride, occ) == 0
                d = (outs[name] - outs["parent"]).abs().max()
                same = (outs[name] == outs["parent"]).reshape(B * R, H + 1, -1).all(-1)
                differ = (~same).any(0).nonzero()
                rec["variants"][name] = {
                    "ms": statistics.median(times[name]), "ms_all": times[name],
                    "threads_per_block": occ[1], "registers": occ[2], "local_bytes": occ[3],
                    "smem_bytes": occ[4], "blocks_per_sm": occ[0],
                    "warps_per_sm": occ[0] * occ[1] // 32,
                    "bitwise_parent": bool(torch.equal(outs[name], outs["parent"])),
                    "max_abs_diff_parent": float(d),
                    "lanes_bitwise_parent": int(same.all(-1).sum()),
                    "first_knot_parted": int(differ[0]) if len(differ) else None}
                if setting != "executor" and name in loop_instructions:
                    warp_instructions = (loop_instructions[name] * B * R * 4 // 32 * H
                                         * consts.substeps)
                    rec["variants"][name]["issue_share"] = warp_instructions / (
                        statistics.median(times[name]) * 1e-3 * issue_per_s)
                if "-fmad=false" in VARIANTS[name][1]:
                    rec["variants"][name]["bitwise_parent_nofma"] = bool(
                        torch.equal(outs[name], outs["parent_nofma"]))
            emit(rec)


if __name__ == "__main__":
    main()
