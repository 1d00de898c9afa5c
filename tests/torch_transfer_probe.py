"""How the iLQR leg of the open-loop transfer gate (tests/test_transfer.py,
chip_smoke.py phase 17) moves when its plan's start moves in the last bits.

    python tests/torch_transfer_probe.py [--device cpu] [--seeds 0 1 2 ...]

The port's iLQR plan (JUMPING_IN_PLACE, H = 50, 10 iterations, 8 alphas, on
the relaxed planner model) from the settled fidelity env, executed open loop
on that env through record_golden_trace. Seed 0 plans from the settled state
itself; any other seed from that state times float32(1 + 1e-7 x
numpy.random.default_rng(seed).standard_normal(37)), a change of about one
float32 ulp per entry: the pattern of tests/jax_transfer_probe.py, which runs
the JAX package's leg from the same starts. All starts are planned as one
batch and executed as the lanes of one fidelity env; a problem's plan does
not depend on the batch it is solved in (tests/test_torch_batch_invariance.py).
Prints one JSON line per seed (planned and executed apex, their relative gap,
which the gate bounds by 25%) and a last line with the share outside the band.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem, state_to_vec  # noqa: E402
from quadruped_springs_tpu_torch.utils import verification as V  # noqa: E402

BAND = 0.25   # tests/test_transfer.py: |planned - executed| < 0.25 planned


def start_factor(seed: int, n: int = 37) -> np.ndarray:
    """The per-entry factor that moves the plan's start: 1 for seed 0."""
    if seed == 0:
        return np.ones(n, np.float32)
    z = np.random.default_rng(seed).standard_normal(n)
    return (1.0 + 1e-7 * z).astype(np.float32)


def probe(seeds, device="cuda"):
    """The gate's iLQR leg from each seed's start: one record per seed."""
    prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=50, iterations=10,
                                n_alphas=8), device)
    env = V.fidelity_env("JUMPING_IN_PLACE", device=device)
    state, _ = env.reset(torch.Generator(device).manual_seed(0), 1)
    x0, u0 = state_to_vec(state.robot), prob.task_warm_start()
    factors = torch.as_tensor(np.stack([start_factor(s) for s in seeds]), device=device)
    sol = prob.solve_batch(x0 * factors, u0.expand(len(seeds), -1, -1))
    rows = V.record_golden_trace(env, sol.us, torch.Generator(device).manual_seed(2))
    out = []
    for i, seed in enumerate(seeds):
        got = V.split_trace(rows[i].cpu().numpy(), env.action_dim)
        planned, executed = float(sol.xs[i, :, 2].max()), float(got["pos"][:, 2].max())
        gap = (executed - planned) / planned
        out.append({"package": "torch", "device": str(device), "seed": seed,
                    "planned_apex_m": planned, "executed_apex_m": executed,
                    "relative_gap": gap, "outside_band": bool(abs(gap) >= BAND)})
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    a = p.parse_args(argv)
    recs = probe(a.seeds, a.device)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    outside = sum(r["outside_band"] for r in recs)
    print(json.dumps({"package": "torch", "starts": len(recs), "outside_band": outside,
                      "share_outside": outside / len(recs)}))


if __name__ == "__main__":
    main()
