"""Entry points of the port, the counterpart of the root ``__graft_entry__.py``.

entry()               -> (fn, example_args): the flagship forward step, one
                         iLQR MPC solve on the analytic Go1 model.
dryrun_multichip(n)   -> spawns n ranks (one per card, or gloo processes on
                         the CPU), each solves its share of a batch of
                         domain-randomized BACKFLIP scenarios (BASELINE
                         config 5: H=50, 10 iLQR iterations, 8 line-search
                         candidates) through parallel/scenarios.sharded_solve,
                         and the global statistics come from collectives.

    python -m quadruped_springs_tpu_torch.graft_entry [--device cpu]
    python -m quadruped_springs_tpu_torch.graft_entry dryrun N [BATCH] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch


def _problem(horizon, iterations, n_alphas=4, task="JUMPING_IN_PLACE", device=None):
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem
    return MPCProblem(MPCConfig(task=task, enable_springs=True, horizon=horizon,
                                iterations=iterations, n_alphas=n_alphas), device)


def entry(device=None):
    """(fn, (x0, u0)) with fn(x0, u0) -> (us, cost) on `device` (the card
    unless the caller names another)."""
    prob = _problem(horizon=25, iterations=5, n_alphas=6, device=device)
    x0 = prob.default_x0()
    u0 = prob.default_warm_start()

    def fn(x0, u0):
        sol = prob.solve(x0, u0)
        return sol.us, sol.cost

    return fn, (x0, u0)


def _dryrun_rank(rank: int, world: int, batch: int, horizon: int, iterations: int):
    """One rank of dryrun_multichip: its share of the sharded BACKFLIP solve,
    the global statistics, and the report line (printed by rank 0)."""
    from quadruped_springs_tpu_torch.parallel.scenarios import (
        global_stats, sample_scenario_batch, sharded_solve)

    device = (torch.device("cuda", torch.cuda.current_device())
              if torch.distributed.get_backend() == "nccl" else torch.device("cpu"))
    prob = _problem(horizon=horizon, iterations=iterations, n_alphas=8, task="BACKFLIP",
                    device=device)
    # every rank draws the same batch from the same seed and solves its rows
    gen = torch.Generator(device).manual_seed(0)
    scenarios = sample_scenario_batch(prob.cfg, "TEST_RANDOMIZER", gen, batch)
    x0s = prob.default_x0().expand(batch, -1)
    u0s = prob.task_warm_start().expand(batch, -1, -1)
    us, costs, diverged = sharded_solve(prob, x0s, u0s, scenarios)
    stats = global_stats(costs, diverged)
    if us.shape != (batch // world, horizon, prob.action_dim):
        raise AssertionError(f"rank {rank}: controls of shape {tuple(us.shape)}")
    if not bool(torch.isfinite(stats["mean_cost"])):
        raise AssertionError(f"rank {rank}: non-finite mean cost")
    out = {"mean_cost": float(stats["mean_cost"]), "best_cost": float(stats["best_cost"]),
           "n_diverged": int(stats["n_diverged"])}
    if rank == 0:
        print(f"dryrun_multichip ok: {world} devices, batch {batch}, "
              f"mean cost {out['mean_cost']:.3f}, diverged {out['n_diverged']}",
              flush=True)
    return out


def dryrun_multichip(n_devices: int, batch: int | None = None, device=None) -> dict:
    """Run the sharded BACKFLIP solve on n_devices ranks: the cards (NCCL)
    unless `device` is "cpu" (gloo processes). batch defaults to 2 per rank
    and must divide over them (4096 is BASELINE config 5). Returns rank 0's
    global statistics."""
    from quadruped_springs_tpu_torch.parallel.mesh import launch

    batch = 2 * n_devices if batch is None else batch
    if batch % n_devices:
        raise ValueError("batch must divide evenly over the devices")
    return launch(_dryrun_rank, n_devices, (batch, 50, 10), device)[0]


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m quadruped_springs_tpu_torch.graft_entry")
    p.add_argument("mode", nargs="?", choices=("entry", "dryrun"), default="entry")
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("batch", nargs="?", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device type (default: the card)")
    ns = p.parse_args(argv)
    if ns.mode == "dryrun":
        dryrun_multichip(ns.n_devices, ns.batch, ns.device)
    else:
        fn, args = entry(ns.device)
        out = fn(*args)
        print("entry ok:", [tuple(t.shape) for t in out])


if __name__ == "__main__":
    main()
