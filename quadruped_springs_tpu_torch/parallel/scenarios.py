"""Scenario-parallel batched solves over ranks: the port of
``quadruped_springs_tpu.parallel.scenarios``.

Thousands of domain-randomized scenarios (the 4096-backflip config of
BASELINE.json) split into contiguous row blocks, one per rank
(``mesh.scenario_rows``); each rank solves its rows with the batched iLQR
(``MPCProblem.solve_batch``); global reductions (mean and best cost,
divergence count) are collectives of the process group.

A diverged scenario (NaN or infinite cost or controls) is flagged in
`diverged` and leaves the other rows as they would be without it: every
step of ``ilqr.solve_batched`` is per problem (dynamics and costs per lane,
per-matrix solves and factorizations, the line search's best candidate,
acceptance and regularization by masked selects per problem). The one sum
over the batch, that of the stage and terminal costs whose gradient gives
the cost derivatives, passes a gradient of one to every problem whatever
the others hold.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from quadruped_springs_tpu_torch.env import randomizers as rnd
from quadruped_springs_tpu_torch.env.env import take
from quadruped_springs_tpu_torch.parallel.mesh import scenario_rows


def sample_scenario_batch(cfg, mode: str, generator: torch.Generator, n: int,
                          curriculum_level=0.0) -> rnd.ScenarioParams:
    """n scenarios of a randomizer mode, drawn from `generator` on its device."""
    return rnd.sample_scenario(cfg, mode, generator, n, curriculum_level)


def sharded_solve(problem, x0s, u_inits, scenarios, mesh=None):
    """Solve this rank's rows of a batch of MPC problems.

    problem: solver.mpc.MPCProblem on this rank's device. x0s (N,37),
    u_inits (N,H,m) and scenarios (a ScenarioParams of N) hold the whole
    batch on every rank; N must divide over the ranks of `mesh` (of the
    default group when None). Returns (us (n,H,m), costs (n,), diverged
    (n,) bool) for the rank's n = N / world rows.
    """
    rows = scenario_rows(x0s.shape[0], mesh)
    idx = torch.arange(rows.start, rows.stop, device=x0s.device)
    sol = problem.solve_batch(x0s[rows], u_inits[rows], take(scenarios, idx))
    diverged = ~(torch.isfinite(sol.cost) & torch.isfinite(sol.us).all(dim=(1, 2)))
    return sol.us, sol.cost, diverged


def global_stats(costs, diverged, mesh=None) -> dict:
    """Mean and best cost over the undiverged scenarios of all ranks, and
    the number diverged: a SUM and a MIN all-reduce over the default process
    group, which a `mesh` of scenario_mesh spans (no reduction without a
    group). Returns tensors on the costs' device."""
    ok = ~diverged
    sums = torch.stack([torch.where(ok, costs, torch.zeros_like(costs)).sum(),
                        ok.sum().to(costs.dtype), diverged.sum().to(costs.dtype)])
    best = torch.where(ok, costs, torch.full_like(costs, float("inf"))).min()
    if dist.is_initialized():
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(best, op=dist.ReduceOp.MIN)
    return {"mean_cost": sums[0] / torch.clamp_min(sums[1], 1.0),
            "best_cost": best,
            "n_diverged": sums[2].to(torch.int64)}

