"""Design variants of the mppi_update kernel (csrc/mppi_update.cu) on the
card: each variant is this tree's csrc/ (or the parent's) with text patches
applied to a copy, built alone with nvcc (all variants at once), and timed
at widths of chip_smoke.mppi_widths through this tree's wrapper with the
variant's library in place of the package's: the iteration's launch (fused:
the proposal with the next candidates; else the proposal's row), its time
on the card alone (torch.profiler, chip_smoke.device_time_ms). The exact
variants are held bitwise to mppi_update_plain at each width; the
"knock_*" variants leave out a part of the work (wrong results), so that
the difference to "this" is that part's share. Needs a card and nvcc.

    mkdir -p _checkout/parent && git archive PARENT | tar -x -C _checkout/parent
    python tests/torch_update_design_probe.py --parent _checkout/parent \\
        [--variants this,parent,...] [--widths headline,full_rate,...]

One JSON line per width: {variant: device µs}, the ptxas line of each
variant's kernels, and the card.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CUH = "mppi_update.cuh"
WIDE = ("mppi_update.cuh", "  const int threads = per_sm <= kUpdateWideBlocks &&",
        "  const int threads = false &&")
# name: (csrc/ of "parent" or "this", exact, text patches (file, old, new))
VARIANTS = {
    "parent": ("parent", True, []),
    "this": ("this", True, []),
    "narrow_only": ("this", True, [WIDE]),
    "min_blocks_4": ("this", True, [(CUH, "constexpr int kUpdateMinBlocks = 8;",
                                     "constexpr int kUpdateMinBlocks = 4;")]),
    "ring_4": ("this", True, [(CUH, "constexpr int kCandSlots = 3;",
                               "constexpr int kCandSlots = 4;")]),
    "div_lowpass": ("this", True, [
        (CUH, "QS_FN void update_lowpass(const UpdateArgs& a, int tid, int nt, const Chunk& ch, int P) {",
         "QS_FN void update_lowpass(const UpdateArgs& a, int tid, int nt, const Chunk& ch, int P,\n"
         "                          const float* nrm) {"),
        (CUH, "      d[t * m] = c;", "      d[t * m] = rn_div(c, nrm[t * m + j]);"),
        (CUH, "  float eps = a.smooth ? rn_div(d, norm) : d;", "  float eps = d;"),
        (CUH, """draw_chunk(i),
                             L.P);""", """draw_chunk(i),
                             L.P, norm);""")]),
    "lp_a_stream_a_thread": ("this", True, [
        (CUH, "  const int lp_threads = imin((imin(rows_a_chunk, K) * m + 63) / 64 * 32, nt / 2);",
         "  const int lp_threads = imin((imin(rows_a_chunk, K) * m + 31) / 32 * 32, nt / 2);")]),
    "knock_targets": ("this", False, [(CUH, "  if (a.q_des == nullptr || tid >= nq) return;",
                                       "  return;")]),
    "knock_lowpass": ("this", False, [(CUH, "  for (int s = tid; s < ch.n * m; s += nt) {",
                                       "  for (int s = tid; s < 0; s += nt) {")]),
    "knock_candidates": ("this", False, [(CUH, """  const int E = a.horizon * a.actions, n = ch.n * E;
  float* d = ch.slot + ch.shift;""", """  return;
  const int E = a.horizon * a.actions, n = ch.n * E;
  float* d = ch.slot + ch.shift;""")]),
    "knock_mean": ("this", False, [(CUH, """    for (int e = tid; e < E; e += nt) {
      const float Q""", """    for (int e = tid; e < 0; e += nt) {
      const float Q""")]),
    "knock_rows_store": ("this", False, [(CUH, "  store_run(tid, nt, a.rows + (b * R + ch.r0) * E,",
                                          "  if (false) store_run(tid, nt, a.rows + (b * R + ch.r0) * E,")]),
}
WIDTHS = ("headline", "full_rate", "behaviour_jumping_forward", "behaviour_continuous",
          "compare", "closed_loop")


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


def build(tmp, parent, names):
    """Each variant's library of mppi_update.cu alone, all nvcc processes
    started together. Returns {name: (launcher, ptxas lines)}."""
    from quadruped_springs_tpu_torch import kernels

    nvcc = kernels._nvcc()
    procs = {}
    for name in names:
        base, _, patches = VARIANTS[name]
        src = os.path.join(source_dir(tmp, name, base, patches, parent), "mppi_update.cu")
        lib = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        usage = [" | ".join(x.strip() for x in lines[i + 2:i + 4])
                 for i, line in enumerate(lines)
                 if "Compiling entry function" in line and "mppi_update_kernel" in line]
        fn = ctypes.CDLL(lib).mppi_update
        fn.argtypes = kernels.MPPI_UPDATE_ARGTYPES
        fn.restype = ctypes.c_int
        out[name] = (fn, usage)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--widths", default=",".join(WIDTHS))
    ap.add_argument("--check-patches", action="store_true",
                    help="apply every variant's patches to a copy and stop (no card)")
    a = ap.parse_args(argv)
    if a.check_patches:
        with tempfile.TemporaryDirectory() as tmp:
            for name, (base, _, patches) in VARIANTS.items():
                if base == "this":
                    source_dir(tmp, name, base, patches, a.parent)
        print(json.dumps({"patches": "apply", "variants": list(VARIANTS)}))
        return
    import torch

    from quadruped_springs_tpu_torch import kernels
    from quadruped_springs_tpu_torch.solver import mppi_update as mu
    from quadruped_springs_tpu_torch.solver.mppi import MPPIConfig
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip()}), flush=True)
    names = a.variants.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, os.path.abspath(a.parent), names)
        print(json.dumps({"ptxas": {n: u for n, (_, u) in libs.items()}}), flush=True)
        widths = cs.mppi_widths()
        gen = torch.Generator("cuda").manual_seed(7)
        for setting in a.widths.split(","):
            task, full_rate, B, K, H, fused, _ = widths[setting]
            prob = MPCProblem((MPCConfig.full_rate if full_rate else MPCConfig)(
                task=task, horizon=H), "cuda")
            m = prob.action_dim
            cfg = MPPIConfig(horizon=H, n_samples=K, fused_accept=fused)
            s = mu.UpdateSettings(fused, cfg.smooth, max(int(K * cfg.elite_frac), 1),
                                  cfg.temperature, cfg.u_min, cfg.u_max, prob.iface)
            us0 = torch.clamp(0.5 * torch.randn(B, H, m, generator=gen, device="cuda"), -1, 1)
            state = mu.UpdateState(us0, us0.clone(),
                                   torch.full((B,), float("inf"), device="cuda"),
                                   torch.zeros(B, 2, device="cuda"))
            costs = -60.0 + torch.randn(B, K, generator=gen, device="cuda")
            costs[1::4, 3], costs[2::4, 1:] = float("nan"), float("inf")
            kw = dict(costs=costs, cand=torch.clamp(0.5 * torch.randn(
                B, K, H, m, generator=gen, device="cuda"), -1, 1))
            if fused:
                kw.update(draw=torch.randn(B, K, H, m, generator=gen, device="cuda"),
                          sigma=torch.full((1,), cfg.sigma, device="cuda"),
                          norm=mu.lowpass_norm(H, device="cuda"))
            else:
                kw.update(rows=mu.ROWS_ALT)
            copy = lambda st: mu.UpdateState(*(t.clone() for t in (st.us, st.us_alt, st.cost,
                                                                   st.trace)))
            want = mu.mppi_update_plain(copy(state), s, **kw)
            row = {"shape": [B, K, H, m], "fused": fused}
            for name in names:
                fn, _ = libs[name]
                lib = types.SimpleNamespace(mppi_update=fn)
                orig = kernels.library
                kernels.library = lambda lib=lib: lib
                try:
                    got = mu.mppi_update(copy(state), s, **kw)
                    torch.cuda.synchronize()
                    same = all(cs._diff(torch, x, y) == 0.0 for x, y in (
                        (got[0].us, want[0].us), (got[0].us_alt, want[0].us_alt),
                        (got[0].cost, want[0].cost), (got[0].trace, want[0].trace),
                        (got[1], want[1]), (got[2], want[2])))
                    if VARIANTS[name][1] and not same:
                        raise AssertionError(f"{name} parts from mppi_update_plain at {setting}")
                    st = copy(state)
                    us = cs.device_time_ms(torch, lambda: mu.mppi_update(st, s, **kw),
                                           "mppi_update_kernel")
                finally:
                    kernels.library = orig
                row[name] = None if us is None else round(us * 1e3, 2)
            print(json.dumps({"width": setting, **row}), flush=True)


if __name__ == "__main__":
    main()
