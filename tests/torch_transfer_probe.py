"""How the iLQR leg of the open-loop transfer gate (tests/test_transfer.py,
chip_smoke.py phase 17) moves when its plan's start moves in the last bits.

    python tests/torch_transfer_probe.py [--device cpu] [--seeds 0 1 2 ...]

The port's iLQR plan (JUMPING_IN_PLACE, H = 50, 10 iterations, 8 alphas, on
the relaxed planner model) from the settled fidelity env, executed open loop
on that env through record_golden_trace. Seed 0 plans from the settled state
itself; any other seed from that state times (1 + 1e-7 x a standard normal
draw of that seed), a change of about one float32 ulp. Prints one JSON line
per seed: planned and executed apex and their relative gap, which the gate
bounds by 25%.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quadruped_springs_tpu_torch.solver import ilqr  # noqa: E402
from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem, state_to_vec  # noqa: E402
from quadruped_springs_tpu_torch.utils import verification as V  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    a = p.parse_args(argv)
    prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=50, iterations=10,
                                n_alphas=8), a.device)
    env = V.fidelity_env("JUMPING_IN_PLACE", device=a.device)
    state, _ = env.reset(torch.Generator(a.device).manual_seed(0), 1)
    x0, u0 = state_to_vec(state.robot), prob.task_warm_start()
    for seed in a.seeds:
        gen = torch.Generator(a.device).manual_seed(seed)
        x = x0 * (1 + 1e-7 * torch.randn(x0.shape, generator=gen, device=a.device)) if seed else x0
        sol = ilqr.first_problem(prob.solve_batch(x, u0[None]))
        rows = V.record_golden_trace(env, sol.us[None], torch.Generator(a.device).manual_seed(2))
        got = V.split_trace(rows[0].cpu().numpy(), env.action_dim)
        planned, executed = float(sol.xs[:, 2].max()), float(got["pos"][:, 2].max())
        print(json.dumps({"device": str(a.device), "seed": seed, "planned_apex_m": planned,
                          "executed_apex_m": executed,
                          "relative_gap": (executed - planned) / planned}), flush=True)


if __name__ == "__main__":
    main()
