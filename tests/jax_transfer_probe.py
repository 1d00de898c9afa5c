#!/usr/bin/env python3
"""How the iLQR leg of the open-loop transfer gate moves when its plan's start
moves in the last bits. The JAX side.

The gate (tests/test_transfer.py, iLQR leg): the JAX package's iLQR plan
(JUMPING_IN_PLACE, H = 50, 10 iterations, 8 alphas, on the relaxed planner
model) from the settled fidelity env, executed open loop on that env through
record_golden_trace; the executed apex must lie within 25% of the planned one.
This script runs that plan-and-execute on the CPU from perturbed starts. Seed
0 plans from the settled state itself; any other seed from that state times
float32(1 + 1e-7 x numpy.random.default_rng(seed).standard_normal(37)), a
change of about one float32 ulp per entry. tests/torch_transfer_probe.py
moves the port's start in the same pattern. Prints one JSON line per seed
(planned and executed apex, their relative gap, and whether it lies outside
the band) and a last line with the share outside.

    python tests/jax_transfer_probe.py --seeds 0 1 2 ... 23

About a minute on the CPU for seeds 0-23, tracing and compiling included.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from quadruped_springs_tpu.solver.mpc import MPCConfig, MPCProblem, state_to_vec  # noqa: E402
from quadruped_springs_tpu.utils import verification as V  # noqa: E402

BAND = 0.25   # tests/test_transfer.py: |planned - executed| < 0.25 planned


def start_factor(seed: int, n: int = 37) -> np.ndarray:
    """The per-entry factor that moves the plan's start: 1 for seed 0."""
    if seed == 0:
        return np.ones(n, np.float32)
    z = np.random.default_rng(seed).standard_normal(n)
    return (1.0 + 1e-7 * z).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    a = p.parse_args(argv)
    prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=50, iterations=10,
                                n_alphas=8))
    env = V.fidelity_env("JUMPING_IN_PLACE")
    state, _ = env.reset(jax.random.PRNGKey(0))
    x0, u0 = state_to_vec(state.robot), prob.task_warm_start()
    outside = 0
    for seed in a.seeds:
        x = x0 * jnp.asarray(start_factor(seed))
        sol = prob.solve(x, u0)
        rows = np.asarray(V.record_golden_trace(env, sol.us, jax.random.PRNGKey(2)))
        got = V.split_trace(rows, env.action_dim)
        planned, executed = float(jnp.max(sol.xs[:, 2])), float(got["pos"][:, 2].max())
        gap = (executed - planned) / planned
        outside += abs(gap) >= BAND
        print(json.dumps({"package": "jax", "device": "cpu", "seed": seed,
                          "planned_apex_m": planned, "executed_apex_m": executed,
                          "relative_gap": gap, "outside_band": bool(abs(gap) >= BAND)}),
              flush=True)
    print(json.dumps({"package": "jax", "starts": len(a.seeds), "outside_band": outside,
                      "share_outside": outside / len(a.seeds)}))


if __name__ == "__main__":
    main()
