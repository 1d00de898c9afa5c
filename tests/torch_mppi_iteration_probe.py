"""The MPPI iteration's kernels on the card (planner_rollout_cost: the task
cost summed inside the rollout; mppi_update) against another tree of the
package, usually the parent commit's: the headline and full-rate rows of
quadruped_springs_tpu_torch.bench, each tree in its own process, in the
order given (parent, change, change, parent by default), so that the host's
drift between calls falls on both alike. Each process prints bench's
solves/s, the mean final cost and a digest of the final costs (equal
digests: bitwise equal answers). Needs a card.

    mkdir -p _checkout/parent && git archive PARENT | tar -x -C _checkout/parent
    python tests/torch_mppi_iteration_probe.py --parent _checkout/parent [--runs 3]
        [--order pccp] [--rows headline,full_rate] [--semantics] [--update-parts]
        [--update-problems 1024 132 1] [--update-widths] [--root TREE]

--semantics first prints how PyTorch's CUDA kernels round what the plain
versions compute and the kernels mirror (csrc/task_cost.cuh): a division by
a Python number against a product with its reciprocal (float32's, or
double's rounded to float32) and a true division, and
torch.linalg.cross against fma(a1, b2, -(a2·b1)) and the unfused form, over
2^20 random inputs each. --update-parts times mppi_update at the
headline's width with parts of its work switched off (update_parts), and
the wrapper's host time a call. --update-widths times the iteration's
mppi_update launch at every width of chip_smoke.mppi_widths (update_widths).
With --root, both import the package from that tree (the parent's, for its
times in the same call). One JSON line per measurement.
"""

import argparse
import json
import os
import subprocess
import sys

ROW = r"""
import hashlib, json, sys, time
import torch
from quadruped_springs_tpu_torch import bench
full_rate = sys.argv[1] == "full_rate"
kw = dict(full_rate=True, horizon=25) if full_rate else {}
rec = bench.run(runs=int(sys.argv[2]), device="cuda", **kw)
costs = rec["costs"].cpu().numpy()
print(json.dumps({"value": rec["value"], "mean_final_cost": rec["mean_final_cost"],
                  "costs_sha1": hashlib.sha1(costs.tobytes()).hexdigest()}))
"""


def semantics():
    import numpy as np
    import torch

    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(1 << 20, generator=gen, device="cuda")
    out = {}
    for d in (19.62, 9.81, 0.05, 0.51):
        rcp = np.float32(1.0) / np.float32(d)
        out[f"x / {d}"] = {"reciprocal_product": bool(torch.equal(x / d, x * float(rcp))),
                           "double_reciprocal_product": bool(torch.equal(
                               x / d, x * float(np.float32(1.0 / d)))),
                           "division": bool(torch.equal(x / d, x / torch.tensor(
                               d, dtype=torch.float32, device="cuda")))}
    a = torch.randn(1 << 20, 3, generator=gen, device="cuda")
    b = torch.randn(1 << 20, 3, generator=gen, device="cuda")
    c = torch.linalg.cross(a, b)[:, 0].cpu().numpy().astype(np.float64)
    a1, a2 = a[:, 1].cpu().numpy().astype(np.float64), a[:, 2].cpu().numpy().astype(np.float64)
    b1, b2 = b[:, 1].cpu().numpy().astype(np.float64), b[:, 2].cpu().numpy().astype(np.float64)
    f32 = lambda v: v.astype(np.float32).astype(np.float64)
    out["cross"] = {"fma(a1,b2,-(a2 b1))": float(np.mean(f32(a1 * b2 - f32(a2 * b1)) == c)),
                    "fma(-a2,b1,a1 b2)": float(np.mean(f32(f32(a1 * b2) - a2 * b1) == c)),
                    "unfused": float(np.mean(f32(f32(a1 * b2) - f32(a2 * b1)) == c))}
    print(json.dumps({"semantics": out}), flush=True)


def _chip_smoke(here):
    """chip_smoke.py of the tree at `here`, as a module (its timers and
    mppi_widths)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here,
                                                                             "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def update_parts(here, reps=10, B=1024, inner=10):
    """mppi_update at the headline's width (1,024 x 32 x 50, m = 6) with
    parts of its work switched off through its arguments: the scalars (the
    proposal at H = 1: argmin, rank count, weights, a 6-element mean), the
    proposal (the scalars and the weighted mean, one row of the state out),
    the state's row alone, the candidates alone (with and without their
    joint targets, and without the low-pass), and the whole iteration
    launch: CUDA-event medians over `reps` timings of `inner` back-to-back
    launches (a launch's share; where the wrapper's host time exceeds the
    kernel's, that host time) and its time on the card alone (torch.profiler,
    chip_smoke.device_time_ms), at B problems (--update-problems). Then the
    wrapper's host time a call: the iteration launch called 200 times
    before one synchronize, at B and at 1 problem."""
    import statistics
    import time

    import torch

    from quadruped_springs_tpu_torch.solver import mppi_update as mu
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    K, H = 32, 50
    prob = MPCProblem(MPCConfig(horizon=H), "cuda")
    m = prob.action_dim
    gen = torch.Generator("cuda").manual_seed(0)

    def inputs(B, H):
        us0 = torch.clamp(0.5 * torch.randn(B, H, m, generator=gen, device="cuda"), -1, 1)
        state = mu.UpdateState(us0, us0.clone(),
                               torch.full((B,), float("inf"), device="cuda"),
                               torch.zeros(B, 1, device="cuda"))
        costs = -60.0 + torch.randn(B, K, generator=gen, device="cuda")
        cand = torch.clamp(0.5 * torch.randn(B, K, H, m, generator=gen, device="cuda"), -1, 1)
        draw = torch.randn(B, K, H, m, generator=gen, device="cuda")
        kw = dict(sigma=torch.full((1,), 0.3, device="cuda"),
                  norm=mu.lowpass_norm(H, device="cuda"))
        return state, costs, cand, draw, kw

    settings = lambda fused=True, smooth=True, iface=prob.iface: mu.UpdateSettings(
        fused, smooth, K // 2, 0.05, -1.0, 1.0, iface)
    state, costs, cand, draw, kw = inputs(B, H)
    state1, costs1, cand1, _, _ = inputs(B, 1)
    parts = {"scalars_h1": (state1, settings(iface=None),
                            dict(costs=costs1, cand=cand1, rows=mu.ROWS_US)),
             "proposal_only": (state, settings(iface=None),
                               dict(costs=costs, cand=cand, rows=mu.ROWS_US)),
             "state_row_only": (state, settings(iface=None), dict(rows=mu.ROWS_US)),
             "candidates_only": (state, settings(), dict(draw=draw, **kw)),
             "candidates_no_targets": (state, settings(iface=None), dict(draw=draw, **kw)),
             "candidates_no_lowpass": (state, settings(smooth=False), dict(draw=draw, **kw)),
             "iteration": (state, settings(), dict(costs=costs, cand=cand, draw=draw, **kw))}
    cs = _chip_smoke(here)
    out, device = {}, {}
    for name, (st, s, args) in parts.items():
        fn = lambda: mu.mppi_update(st, s, **args)
        fn()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        out[name] = statistics.median(times)
        device[name] = cs.device_time_ms(torch, fn, "mppi_update_kernel")
    host = {}
    for n in (B, 1):
        st, c, cd, dr, k = inputs(n, H)
        s = settings()
        fn = lambda: mu.mppi_update(st, s, costs=c, cand=cd, draw=dr, **k)
        fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            samples.append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        host[f"{n}_problems"] = statistics.median(samples)
    print(json.dumps({"mppi_update_parts_ms": out, "mppi_update_parts_device_ms": device,
                      "problems": B, "wrapper_host_us_a_call": host,
                      "package": os.path.dirname(mu.__file__)}), flush=True)


def update_widths(here):
    """The iteration's mppi_update launch (fused: the proposal with the next
    candidates; else the proposal's row) at every width of
    chip_smoke.mppi_widths, on seeded inputs: its time on the card alone
    (torch.profiler, chip_smoke.device_time_ms) and through its wrapper
    (CUDA events, 10 back-to-back launches), in this process's package."""
    import torch

    from quadruped_springs_tpu_torch.solver import mppi_update as mu
    from quadruped_springs_tpu_torch.solver.mppi import MPPIConfig
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    cs = _chip_smoke(here)
    gen = torch.Generator("cuda").manual_seed(7)
    out = {}
    for setting, (task, full_rate, B, K, H, fused, _) in cs.mppi_widths().items():
        prob = MPCProblem((MPCConfig.full_rate if full_rate else MPCConfig)(task=task,
                                                                           horizon=H), "cuda")
        m = prob.action_dim
        cfg = MPPIConfig(horizon=H, n_samples=K, fused_accept=fused)
        s = mu.UpdateSettings(fused, cfg.smooth, max(int(K * cfg.elite_frac), 1),
                              cfg.temperature, cfg.u_min, cfg.u_max, prob.iface)
        us0 = torch.clamp(0.5 * torch.randn(B, H, m, generator=gen, device="cuda"), -1, 1)
        state = mu.UpdateState(us0, us0.clone(), torch.full((B,), float("inf"), device="cuda"),
                               torch.zeros(B, 2, device="cuda"))
        kw = dict(costs=-60.0 + torch.randn(B, K, generator=gen, device="cuda"),
                  cand=torch.clamp(0.5 * torch.randn(B, K, H, m, generator=gen,
                                                     device="cuda"), -1, 1))
        if fused:
            kw.update(draw=torch.randn(B, K, H, m, generator=gen, device="cuda"),
                      sigma=torch.full((1,), cfg.sigma, device="cuda"),
                      norm=mu.lowpass_norm(H, device="cuda"))
        else:
            kw.update(rows=mu.ROWS_ALT)
        fn = lambda: mu.mppi_update(state, s, **kw)
        out[setting] = {"shape": [B, K, H, m], "fused": fused,
                        "device_ms": cs.device_time_ms(torch, fn, "mppi_update_kernel"),
                        "ms": cs.cuda_time_ms(torch, fn, reps=5, inner=10)}
    print(json.dumps({"mppi_update_widths": out, "package": os.path.dirname(mu.__file__)}),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--semantics", action="store_true")
    ap.add_argument("--update-parts", action="store_true")
    ap.add_argument("--update-problems", type=int, nargs="+", default=[1024])
    ap.add_argument("--update-widths", action="store_true")
    ap.add_argument("--root", default=None,
                    help="import the package from this tree for --semantics, "
                         "--update-parts and --update-widths (default: this one)")
    ap.add_argument("--rows", default="headline,full_rate")
    a = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.abspath(a.root) if a.root else here)
    if a.semantics:
        semantics()
    if a.update_parts:
        for B in a.update_problems:
            update_parts(here, B=B)
    if a.update_widths:
        update_widths(here)
    trees = {"p": os.path.abspath(a.parent), "c": here}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip()}), flush=True)
    for row in filter(None, a.rows.split(",")):
        for which in a.order:
            proc = subprocess.run([sys.executable, "-c", ROW, row, str(a.runs)],
                                  cwd=trees[which], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{which} {row} failed:\n{proc.stderr[-4000:]}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"row": row, "tree": "parent" if which == "p" else "change",
                              **rec}), flush=True)


if __name__ == "__main__":
    main()
