"""Headline benchmark of the port: batched MPC solves/s on one device.

Runs the problem of the root ``bench.py``: JUMPING_IN_PLACE with springs on
the relaxed 200 Hz planner model (``--full-rate``: the 1 kHz execution
model), 1024 TEST_RANDOMIZER scenarios, H=50 knots, 10 iterations; on its
MPPI path (K=32 samples, fused accept) or, with ``--ilqr``, on its iLQR
path (8 line-search candidates): by default the JAX bench's row, Jacobians
of a bfloat16 knot relinearized every 3rd iteration; with ``--exact`` the
exact float32 row (``--relin-every k`` overrides the period of either).
One untimed warm-up solve, then ``--runs`` timed solves bracketed by
``torch.cuda.synchronize()``. Prints the JSON line of ``bench.py`` (its
eight keys and their rounding), the metric naming the port's device.

    python -m quadruped_springs_tpu_torch.bench                 # on the GPU
    python -m quadruped_springs_tpu_torch.bench --ilqr [--exact]
    python -m quadruped_springs_tpu_torch.bench --full-rate --horizon 25
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
from quadruped_springs_tpu_torch.env_bench import device_name, resolve_device
from quadruped_springs_tpu_torch.solver import ilqr as ilqr_solver
from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem
from quadruped_springs_tpu_torch.solver.mppi import MPPIConfig

# The project's north-star target (BASELINE.json): 10,000 MPC solves/s at
# H=50 on 16 chips, i.e. 625 solves/s per chip. A target, not a rate that
# anything measured; vs_baseline is the measured solves/s over it, as
# bench.py computes it.
PER_CHIP_TARGET = 10000.0 / 16.0
# the JAX bench's default iLQR row (bench.py without --exact)
ILQR_LIN_DTYPE, ILQR_RELIN_EVERY = "bf16", 3


def run(batch: int = 1024, horizon: int = 50, iterations: int = 10,
        samples: int = 32, runs: int = 3, device="cuda", seed: int = 0,
        full_rate: bool = False, springs: bool = True, ilqr: bool = False,
        exact: bool = False, relin_every: int | None = None) -> dict:
    """Time the batched solve; returns the JSON record (unrounded; `line`
    rounds it) plus the final costs (`costs`, (batch,)) and the number of
    solve calls made (`solves`). `ilqr` solves with iLQR: the bf16
    linearization relinearized every 3rd iteration, or with `exact` the
    float32 one every iteration; `relin_every` overrides the period. With
    `ilqr`, also the last solve's ILQRSolution (`solution`), its seconds
    per stage (`stage_times`), the mean cost of the warm start's rollout
    (`warm_start_mean_cost`, one more rollout of H knots before the solves)
    and the solved problem (`problem`: the MPCProblem, x0, u0, scenarios)."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mk = MPCConfig.full_rate if full_rate else MPCConfig
    lin_dtype, relin = ("f32", 1) if exact else (ILQR_LIN_DTYPE, ILQR_RELIN_EVERY)
    cfg = mk(task="JUMPING_IN_PLACE", enable_springs=springs, horizon=horizon,
             iterations=iterations, n_alphas=8,
             relin_every=relin if relin_every is None else relin_every,
             lin_dtype=lin_dtype if ilqr else "f32")
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
    if ilqr and cfg.lin_dtype == "f32":
        desc = (f"iLQR H={horizon}, {iterations} iters, exact-f32"
                + (f", relin/{cfg.relin_every}" if cfg.relin_every > 1 else ""))
    elif ilqr:
        desc = f"iLQR H={horizon}, {iterations} iters, bf16-lin, relin/{cfg.relin_every}"
    else:
        desc = f"MPPI H={horizon}, {iterations} iters, K={samples}, fused"
    value = batch / dt
    return {
        **extra,
        "metric": (f"MPC solves/s/chip ({desc}, {cfg.planner_desc}, batch {batch}, "
                   "domain-randomized" + ("" if springs else ", no-springs")
                   + f", torch port on {device_name(device)})"),
        "value": value,
        "unit": "solves/s",
        "vs_baseline": value / PER_CHIP_TARGET,
        "mean_final_cost": float(costs.mean()),
        # bench.py's XLA cost analysis has no counterpart in eager PyTorch:
        # no operation count, so no share of a peak (bench.py's own nulls)
        "mfu": None,
        "flops_per_solve": None,
        "mfu_peak_assumed": None,
        "costs": costs,
        "solves": 1 + runs,
    }


def line(rec: dict) -> dict:
    """bench.py's JSON line from a run() record: its eight keys, rounded as
    bench.py rounds them."""
    return {"metric": rec["metric"], "value": round(rec["value"], 2), "unit": rec["unit"],
            "vs_baseline": round(rec["vs_baseline"], 4),
            "mean_final_cost": round(rec["mean_final_cost"], 2),
            "mfu": rec["mfu"], "flops_per_solve": rec["flops_per_solve"],
            "mfu_peak_assumed": rec["mfu_peak_assumed"]}


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
    ap.add_argument("--exact", action="store_true",
                    help="with --ilqr: float32 linearization every iteration")
    ap.add_argument("--relin-every", type=int, default=None)
    a = ap.parse_args(argv)
    rec = run(a.batch, a.horizon, a.iterations, a.samples, a.runs, a.device, a.seed,
              a.full_rate, not a.no_springs, a.ilqr, a.exact, a.relin_every)
    print(json.dumps(line(rec)))
    return rec


if __name__ == "__main__":
    main()
