"""Launches, device time and wall time of the port's hot paths on the card.

    python tests/torch_path_profile.py [--root DIR] [--label NAME] [--headline]

Imports quadruped_springs_tpu_torch from DIR (default: this checkout), so that
one call to the card can profile two commits in turn (an unpacked
`git archive` of the other one as DIR): parent, change, change, parent.
Prints one JSON line per path:
  * knot: one planner knot (MPCProblem.dynamics, the relaxed 200 Hz model, 2
    substeps) at 32,768 lanes: 1024 TEST_RANDOMIZER scenarios x 32 samples,
    the MPPI headline's shape;
  * substep: one environment substep at 1024 environments
    (env_bench.profile_steps over 3 control steps after a 600-substep settle);
  * lin_block: one block of the iLQR linearization: vmap over the 43 basis
    tangents of torch.func.jvp of the knot at 5,120 lanes (1024 problems x 5
    knots);
  * headline (--headline): bench.run's MPPI solve at full width, one warm-up
    and one timed solve.
Device time and launches come from torch.profiler (kernels on the card, per
call); wall time from the host clock around torch.cuda.synchronize(),
untraced, the median over repeats. The kernel classes split the device time
by name: cuBLAS's gemm/gemv, the hand-written kernels, elementwise, the rest.
"""

import argparse
import json
import os
import statistics
import sys
import time

CLASSES = (("gemm/gemv", ("gemm", "gemv", "cublas")),
           ("hand kernels", ("actuation_kernel", "contact_kernel", "actuation_jvp",
                             "contact_jvp", "contact_anchored")),
           ("elementwise", ("elementwise",)), ("reduce", ("reduce",)),
           ("cat/copy", ("Cat", "copy")))


def profile(torch, fn, calls, reps=5):
    """fn() `calls` times per repeat: wall ms per call (median of reps,
    untraced) and, over one traced repeat, launches and device ms per call."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / calls)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launches, busy_us, classes = 0, 0.0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        launches += e.count
        busy_us += us
        cls = next((c for c, pats in CLASSES if any(p in e.key for p in pats)), "other")
        classes[cls] = classes.get(cls, 0.0) + us / 1e3 / calls
    wall = statistics.median(walls)
    device = busy_us / 1e3 / calls
    return {"launches": launches / calls, "device_ms": device, "wall_ms": wall,
            "device_busy_share": device / wall,
            "classes_ms": dict(sorted(classes.items(), key=lambda kv: -kv[1]))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--headline", action="store_true")
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    from quadruped_springs_tpu_torch import bench, env_bench
    from quadruped_springs_tpu_torch.env import randomizers as rnd
    from quadruped_springs_tpu_torch.solver import ilqr
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    if not torch.cuda.is_available():
        raise SystemExit("torch_path_profile: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import quadruped_springs_tpu_torch as pkg
    head = {"label": a.label, "package": os.path.dirname(pkg.__file__),
            "device": torch.cuda.get_device_name(0)}
    emit = lambda path, rec: print(json.dumps({**head, "path": path, **rec}), flush=True)

    prob = MPCProblem(MPCConfig(), "cuda")
    scen = rnd.sample_scenario(prob.cfg, "TEST_RANDOMIZER",
                               torch.Generator("cuda").manual_seed(0), n=1024)
    with torch.no_grad():
        lanes = prob.lane_params(scen, 32)
        x = prob.default_x0().expand(1024 * 32, -1).contiguous()
        u = prob.task_warm_start()[0].expand(1024 * 32, -1).contiguous()
        emit("knot", {"lanes": 1024 * 32, **profile(torch, lambda: prob.dynamics(x, u, lanes),
                                                    calls=5)})

    env = env_bench.QuadrupedEnv(env_bench.bench_config(600), device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    state, _ = env.reset(gen, 1024)
    actions = env.get_init_action().expand(1024, -1)
    emit("substep", {"envs": 1024, **env_bench.profile_steps(env, state, actions, gen,
                                                             steps=3)})

    lanes5 = prob.lane_params(scen, 5)
    z = torch.cat([x[:5120], u[:5120]], dim=-1)
    block = lambda: ilqr._basis_jvp(lambda z: prob.dynamics(z[:, :37], z[:, 37:], lanes5), z)
    emit("lin_block", {"lanes": 5120, "tangents": 43, **profile(torch, block, calls=1,
                                                                reps=3),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30})

    if a.headline:
        rec = bench.run(batch=1024, runs=1, device="cuda")
        emit("headline", {"solves_per_s": rec["value"],
                          "mean_final_cost": rec["mean_final_cost"]})


if __name__ == "__main__":
    main()
