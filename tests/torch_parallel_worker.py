"""Rank functions of tests/test_torch_parallel.py. They live in a module of
their own, which imports torch and the port only, so that the spawned gloo
ranks import neither jax nor the test module."""

import torch

from quadruped_springs_tpu_torch.parallel import mesh as pmesh
from quadruped_springs_tpu_torch.parallel.riccati import sharded_lqt_backward
from quadruped_springs_tpu_torch.parallel.scenarios import (
    global_stats,
    sample_scenario_batch,
    sharded_solve,
)
from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

# the small Go1 sizes of tests/test_torch_ilqr_go1.py
SOLVE_CONFIG = MPCConfig(task="BACKFLIP", horizon=10, iterations=3, n_alphas=4)
NAN_ROW = 1


def solve_inputs(n: int):
    """The batch every rank (and the unsharded reference) solves: n
    TEST_RANDOMIZER scenarios from a seeded CPU generator, the task warm
    start from the default state."""
    prob = MPCProblem(SOLVE_CONFIG, "cpu")
    gen = torch.Generator("cpu").manual_seed(3)
    scenarios = sample_scenario_batch(prob.cfg, "TEST_RANDOMIZER", gen, n)
    x0s = prob.default_x0().expand(n, -1).contiguous()
    u0s = prob.task_warm_start().expand(n, -1, -1).contiguous()
    return prob, x0s, u0s, scenarios


def check_ranks(rank: int, world: int, lq_problems: dict) -> dict:
    """Every sharded path of the port on this rank: sharded_lqt_backward on
    each LQ problem (numpy arrays, a batch of one), then sharded_solve of
    2·world problems without and with a NaN start in row NAN_ROW, and the
    global statistics of both. Returns numpy arrays (this rank's rows)."""
    mesh = pmesh.scenario_mesh("cpu")
    out = {"mesh_shape": tuple(mesh.mesh.shape), "rows": pmesh.scenario_rows(2 * world, mesh)}
    for name, (args, reg) in lq_problems.items():
        t = [torch.from_numpy(a) for a in args]
        ks, Ks = sharded_lqt_backward(*t, torch.tensor([reg], dtype=t[0].dtype), mesh=mesh)
        out[f"{name}_ks"], out[f"{name}_Ks"] = ks.numpy(), Ks.numpy()
    prob, x0s, u0s, scenarios = solve_inputs(2 * world)
    x0s_nan = x0s.clone()
    x0s_nan[NAN_ROW] = float("nan")
    for tag, x in (("clean", x0s), ("nan", x0s_nan)):
        us, costs, diverged = sharded_solve(prob, x, u0s, scenarios, mesh)
        stats = global_stats(costs, diverged, mesh)
        out[tag] = {"us": us.numpy(), "costs": costs.numpy(), "diverged": diverged.numpy(),
                    **{k: v.numpy() for k, v in stats.items()}}
    return out


def unsharded_reference(n: int) -> dict:
    """solve_batch of the same n problems in one call."""
    prob, x0s, u0s, scenarios = solve_inputs(n)
    sol = prob.solve_batch(x0s, u0s, scenarios)
    return {"us": sol.us.numpy(), "costs": sol.cost.numpy()}


def fail_on_rank_one(rank: int, world: int) -> int:
    """A rank function whose second rank raises."""
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def sleep_long(rank: int, world: int) -> int:
    """A rank function that outlasts any launch timeout of the tests."""
    import time
    time.sleep(600)
    return rank
