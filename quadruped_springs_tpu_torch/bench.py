"""Headline benchmark of the port: batched MPC solves/s on one device.

Runs the problem of the root ``bench.py``: JUMPING_IN_PLACE with springs on
the relaxed 200 Hz planner model, 1024 TEST_RANDOMIZER scenarios, H=50
knots, 10 iterations; on its MPPI path (K=32 samples, fused accept) or,
with ``--ilqr``, on its exact float32 iLQR path (8 line-search candidates,
``--relin-every k`` for the lagged linearization). One untimed warm-up
solve, then ``--runs`` timed solves bracketed by
``torch.cuda.synchronize()``. Prints one JSON line: metric (naming the
device), value (solves/s), unit, mean_final_cost.

    python -m quadruped_springs_tpu_torch.bench                 # on the GPU
    python -m quadruped_springs_tpu_torch.bench --ilqr
    python -m quadruped_springs_tpu_torch.bench --device cpu --batch 2 \\
        --samples 4 --horizon 4 --iterations 1 --runs 1         # tiny CPU check

A CUDA device that is not available is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from quadruped_springs_tpu_torch.env import randomizers as rnd
from quadruped_springs_tpu_torch.solver import ilqr as ilqr_solver
from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem
from quadruped_springs_tpu_torch.solver.mppi import MPPIConfig


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run(batch: int = 1024, horizon: int = 50, iterations: int = 10,
        samples: int = 32, runs: int = 3, device="cuda", seed: int = 0,
        full_rate: bool = False, springs: bool = True, ilqr: bool = False,
        relin_every: int = 1) -> dict:
    """Time the batched solve; returns the JSON record plus the final costs
    (`costs`, (batch,)) and the number of solve calls made (`solves`). With
    `ilqr`, also the last solve's ILQRSolution (`solution`), its seconds
    per stage (`stage_times`), the mean cost of the warm start's rollout
    (`warm_start_mean_cost`, one more rollout of H knots before the solves)
    and the solved problem (`problem`: the MPCProblem, x0, u0, scenarios)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA requested but torch.cuda.is_available() is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mk = MPCConfig.full_rate if full_rate else MPCConfig
    cfg = mk(task="JUMPING_IN_PLACE", enable_springs=springs, horizon=horizon,
             iterations=iterations, n_alphas=8, relin_every=relin_every)
    prob = MPCProblem(cfg, device)
    gen = torch.Generator(device).manual_seed(seed)
    scenarios = rnd.sample_scenario(prob.cfg, "TEST_RANDOMIZER", gen, n=batch)
    x0 = prob.default_x0().expand(batch, -1)
    u0 = prob.task_warm_start().expand(batch, -1, -1)
    mcfg = MPPIConfig(horizon=horizon, iterations=iterations, n_samples=samples,
                      fused_accept=True)
    noise_gen = torch.Generator(device)

    extra = {}
    if ilqr:
        warm = dataclasses.replace(prob.ilqr_config, iterations=0)
        extra["warm_start_mean_cost"] = float(ilqr_solver.solve_batched(
            prob.lane_dynamics(scenarios), prob.stage_cost, prob.terminal_cost, x0, u0,
            warm).cost.mean())
        extra["problem"] = (prob, x0, u0, scenarios)

    def solve():
        if ilqr:
            extra["stage_times"] = {}
            extra["solution"] = prob.solve_batch(x0, u0, scenarios, extra["stage_times"])
            return extra["solution"].cost
        noise_gen.manual_seed(seed + 1)      # every run solves the same problem
        return prob.solve_mppi(x0, u0, noise_gen, mcfg, scenarios).cost

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    costs = solve()
    sync()
    t0 = time.perf_counter()
    for _ in range(runs):
        costs = solve()
    sync()
    dt = (time.perf_counter() - t0) / runs
    if ilqr:
        desc = (f"iLQR H={horizon}, {iterations} iters, exact-f32"
                + (f", relin/{relin_every}" if relin_every > 1 else ""))
    else:
        desc = f"MPPI H={horizon}, {iterations} iters, K={samples}, fused"
    return {
        **extra,
        "metric": (f"MPC solves/s ({desc}, {cfg.planner_desc}, batch {batch}, "
                   "domain-randomized" + ("" if springs else ", no-springs")
                   + f", torch port on {device_name(device)})"),
        "value": batch / dt,
        "unit": "solves/s",
        "mean_final_cost": float(costs.mean()),
        "costs": costs,
        "solves": 1 + runs,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-rate", action="store_true")
    ap.add_argument("--no-springs", action="store_true")
    ap.add_argument("--ilqr", action="store_true")
    ap.add_argument("--relin-every", type=int, default=1)
    a = ap.parse_args(argv)
    rec = run(a.batch, a.horizon, a.iterations, a.samples, a.runs, a.device, a.seed,
              a.full_rate, not a.no_springs, a.ilqr, a.relin_every)
    print(json.dumps({k: rec[k] for k in ("metric", "value", "unit", "mean_final_cost")}))
    return rec


if __name__ == "__main__":
    main()
