"""The env_substeps_vjp kernel of this tree against another tree's (the
parent's) and against variants of it on the card, in one process: each
variant's csrc/env_step_vjp.cu (this tree's or the parent's, or a copy of
this tree's csrc/ with text patches applied, or either built with other
nvcc flags) built alone with nvcc (all at once) and launched through this
tree's wrapper at chip_smoke.py phase 26's settings (BPTT's 24 touchdown
states, 1,024 environments interpolated, held, TORQUE, on the rack, at the
edges, and one environment; 10 substeps). The "knock_*" variants leave out
a part of the work (wrong results), so that their difference to "this" is
that part's share of the time; the "*_nofma" variants are built with
-fmad=false (no multiply-add contracted), where this tree's kernel and the
parent's run the same operations in the same order. Needs a card and nvcc.

    mkdir -p _checkout/parent && git archive PARENT | tar -x -C _checkout/parent
    python tests/torch_vjp_design_probe.py --parent _checkout/parent \\
        [--order parent,this,this,parent,knock_chol,...] [--settings bptt_24,env,...] \\
        [--check] [--bptt] [--check-patches]

Prints JSON lines: the card (nvidia-smi name, power.limit); each variant's
ptxas line (registers, stack, spills, shared memory) and this tree's launch
(env_substeps_vjp_occupancy); for each setting, in the order given, each
variant's time on the card alone (torch.profiler, chip_smoke.device_time_ms)
and the CUDA-event median of back-to-back launches, and the largest |this -
parent| of each input cotangent (0: bitwise), and of this_nofma - parent_nofma
where both ran; with --check, this tree's cotangents held to the plain
version by env/substeps.py check_vjp (phase 26's rule); with --bptt, the
seconds of the lander's BPTT smoke run (chip_smoke.BEHAVIOUR_TRAINERS
["landing_bptt"]) from this tree's and the parent's own checkouts, in the
order given (knock and nofma variants left out), and its seconds a BPTT
iteration.
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
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


LANE = "env_lane_vjp.cuh"
SWEEP = ("    for (int r = hi - 1; r >= lo; --r) {", "    for (int r = hi - 1; r >= hi; --r) {")


def _skip(text):
    """A patch that prefixes `if (false) ` to the statement starting with text."""
    indent = text[:len(text) - len(text.lstrip())]
    return (LANE, text, indent + "if (false) " + text.lstrip())


# name: (the tree it starts from, text patches (file, old, new), extra nvcc flags)
VARIANTS = {
    "parent": ("parent", [], []),
    "this": ("this", [], []),
    "parent_nofma": ("parent", [], ["-fmad=false"]),
    "this_nofma": ("this", [], ["-fmad=false"]),
    # the sweep left out (the re-run and the recompute stay)
    "no_sweep": ("this", [(LANE, *SWEEP)], []),
    # the re-run alone
    "rerun_only": ("this", [
        (LANE, *SWEEP),
        _skip("      if (th.active) recompute(th, r, th.warp - 1, quad);"),
        _skip("        if (th.active) recompute(th, lo + th.warp, th.warp, quad);")], []),
    "knock_chol": ("this", [
        (LANE, "            chol6_solve_vjp(br.chol, g_a0, g_share, g_share + 21);",
         "            for (int i = 0; i < 27; ++i) g_share[i] = g_a0[i % 6];")], []),
    "knock_share": ("this", [
        (LANE, "          InertiaGrad gIc1 = zero_inertia_grad();\n          if (!on_rack) {",
         "          InertiaGrad gIc1 = zero_inertia_grad();\n          if (false) {")], []),
    "knock_contact": ("this", [_skip("          anchored_foot_elem_vjp(k.foot_radius"),
                               _skip("          contact_elem_vjp(k.knee_radius"),
                               _skip("          contact_elem_vjp(k.trunk_radius")], []),
    "knock_bias": ("this", [_skip("          leg_bias_vjp(sm.bias[th.slot].f,")], []),
    "knock_kin": ("this", [_skip("        leg_column_vjp(j == 0"), _skip("        leg_body_vjp(kb,"),
                           _skip("        leg_chain_vjp(k, c.thigh,")], []),
}


def source_dir(tmp, name, trees):
    """The csrc/ a variant builds from: its tree's, or a copy of it with its
    patches applied."""
    base, patches, _ = VARIANTS[name]
    here = os.path.join(trees[base], "quadruped_springs_tpu_torch", "csrc")
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


def build(tmp, trees, names):
    """Each variant's env_step_vjp.cu alone, all nvcc processes started
    together. Returns {name: (library, launcher, ptxas lines)}."""
    from quadruped_springs_tpu_torch import kernels

    nvcc = kernels._nvcc()
    procs = {}
    for name in names:
        src = os.path.join(source_dir(tmp, name, trees), "env_step_vjp.cu")
        lib = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, *VARIANTS[name][2], "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        usage = [" | ".join(x.strip() for x in lines[i + 2:i + 4])
                 for i, line in enumerate(lines)
                 if "Compiling entry function" in line and "env_substeps_vjp_kernel" in line]
        handle = ctypes.CDLL(lib)
        fn = handle.env_substeps_vjp
        fn.argtypes = kernels.ENV_SUBSTEPS_VJP_ARGTYPES
        fn.restype = ctypes.c_int
        out[name] = (handle, fn, usage)
    return out


def bptt_seconds(root, cs, tmp, name):
    """The lander's BPTT smoke run from the checkout at `root`: wall seconds
    of the process, its BPTT stage's seconds and seconds an iteration."""
    module, args, _ = cs.BEHAVIOUR_TRAINERS["landing_bptt"]
    out = os.path.join(tmp, f"bptt_{name}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"quadruped_springs_tpu_torch.{module}", *args,
                           "--out", out], cwd=root, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
    # the lander exits 1 where its save gate fails (the smoke budget's does)
    if proc.returncode != (0 if res.get("gate_ok", True) else 1) or not res:
        raise RuntimeError(f"{name}: the BPTT smoke run failed:\n{proc.stderr[-3000:]}")
    stage = res["stage_seconds"]["bptt"]
    return {"wall_s": wall, "bptt_stage_s": stage, "iterations": res["iterations"],
            "s_per_iteration": stage / res["iterations"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--order", default="parent,this,this,parent")
    ap.add_argument("--settings", default="")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--bptt", action="store_true")
    ap.add_argument("--check-patches", action="store_true",
                    help="apply every variant's patches to a copy and stop (no card)")
    a = ap.parse_args(argv)
    trees = {"this": ROOT, "parent": os.path.abspath(a.parent)}
    if a.check_patches:
        with tempfile.TemporaryDirectory() as tmp:
            for name in VARIANTS:
                source_dir(tmp, name, trees)
        print(json.dumps({"patches": "apply", "variants": list(VARIANTS)}))
        return
    import torch

    from quadruped_springs_tpu_torch import env_bench, kernels
    from quadruped_springs_tpu_torch.env import substeps as ss
    from quadruped_springs_tpu_torch.env.wrappers import LANDING_KD, LANDING_KP

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"card": card.strip(), "kind": kind}), flush=True)
    order = a.order.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, trees, sorted(set(order) | {"this", "parent"}))
        print(json.dumps({"ptxas": {n: u for n, (_, _, u) in libs.items()}}), flush=True)
        occ = (ctypes.c_int * 6)()
        libs["this"][0].env_substeps_vjp_occupancy.argtypes = [ctypes.c_void_p]
        err = libs["this"][0].env_substeps_vjp_occupancy(occ)
        print(json.dumps({"this_launch": {"err": err, "blocks_per_sm": occ[0],
                                          "threads": occ[1], "registers": occ[2],
                                          "local_bytes": occ[3], "shared_bytes": occ[4],
                                          "chunk": occ[5]}}), flush=True)
        landing = [torch.full((12,), g, device="cuda") for g in (LANDING_KP, LANDING_KD)]
        settings, _ = cs.env_substeps_vjp_settings(torch, env_bench, landing, kind)
        names = a.settings.split(",") if a.settings else list(settings)
        stream = kernels.stream_handle(torch.device("cuda"))
        orig = kernels.library
        for setting in names:
            args = settings[setting]
            cot = cs.vjp_cotangents(torch, ss, args, 260)
            row = {"setting": setting, "environments": args[0].q.shape[0]}
            grads = {}
            for i, name in enumerate(order):
                fn = libs[name][1]
                kernels.library = lambda fn=fn: types.SimpleNamespace(env_substeps_vjp=fn)
                try:
                    got = ss.env_substeps_vjp(*args, cot)
                    torch.cuda.synchronize()
                    grads.setdefault(name, got)
                    dev = cs.device_time_ms(torch, lambda: ss.env_substeps_vjp(*args, cot),
                                            "env_substeps_vjp_kernel")
                    launch, _, keep = ss.vjp_launch_args(*args, cot)
                    ev = cs.cuda_time_ms(torch, lambda: fn(*launch, stream), reps=10, inner=5)
                finally:
                    kernels.library = orig
                row[f"{name}_{i}_device_us"] = None if dev is None else dev * 1e3
                row[f"{name}_{i}_event_us"] = ev * 1e3
            for x, y in (("this", "parent"), ("this_nofma", "parent_nofma")):
                if x in grads and y in grads:
                    row[f"max_abs_{x}_minus_{y}"] = {
                        k: float((g - h).abs().max()) for k, g, h in
                        zip(ss.VJP_FIELDS, grads[x], grads[y])}
            if a.check:
                r = ss.check_vjp(args, cot, grads["this"], cs.REL_TOL, cs.ENV_SPREAD)
                row["check_vjp"] = {"failures": r["failures"][:3],
                                    "max_abs_err": r["max_abs_err"],
                                    "spread_used": r["spread_used"], "along": len(r["along"]),
                                    "kinks": r["kinks"]}
            print(json.dumps(row), flush=True)
        if a.bptt:
            for i, name in enumerate(n for n in order if n in trees):
                print(json.dumps({"bptt_smoke": name, "turn": i,
                                  **bptt_seconds(trees[name], cs, tmp, f"{name}{i}")}),
                      flush=True)


if __name__ == "__main__":
    main()
