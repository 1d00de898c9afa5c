"""Closed-loop (receding-horizon) iLQR MPC on the stiff 1 kHz environment.

Port of the JAX package's ``examples/run_closed_loop_mpc.py`` (its iLQR
path): every ``--replan-every`` control knots the iLQR problem is solved on
the relaxed planner model from the robot's current state, warm-started from
the shifted previous plan; the plan's first action is executed on
``QuadrupedEnv`` (10 x 1 kHz substeps on the stiff contact model with foot
anchor stiction), and the plan is shifted. Feedback re-planning absorbs the
mismatch between the planner's and the executor's contact models.

    python -m quadruped_springs_tpu_torch.closed_loop                  # on the GPU
    python -m quadruped_springs_tpu_torch.closed_loop --device cpu --steps 6 \\
        --horizon 8 --iterations 2                                     # tiny CPU check

Prints one JSON line: planned and executed ballistic apex, final height,
upright. A CUDA device that is not available is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import json

import torch

from quadruped_springs_tpu_torch.env import randomizers as rnd
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.solver.mpc import (
    MPCConfig,
    MPCProblem,
    state_to_vec,
    vec_to_state,
)

_G = 9.81


def ballistic_apex(z, vz):
    return z + torch.clamp_min(vz, 0.0) ** 2 / (2 * _G)


def run(n_steps: int = 40, replan_every: int = 5, horizon: int = 20,
        iterations: int = 4, n_alphas: int = 4, device="cuda") -> dict:
    """Run the loop for n_steps 100 Hz knots from the standing pose on the
    nominal robot; returns the closed-loop transfer metrics (planned apex on
    the planner model against the apex executed on the stiff environment)
    and the number of solves."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but torch.cuda.is_available() is False")
    prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=horizon,
                                iterations=iterations, n_alphas=n_alphas), device)
    env = QuadrupedEnv(EnvConfig(enable_springs=True, motor_control_mode="PD",
                                 action_space_mode="SYMMETRIC",
                                 task_env="JUMPING_IN_PLACE",
                                 observation_space_mode="ARS_BASIC", obs_noise=False),
                       device=device)
    # the planner's start state, without a settle, on the nominal scenario
    state, _ = env.reset(scenario=rnd.nominal_params(prob.cfg, 1),
                         desired_robot_state=vec_to_state(prob.default_x0()[None]))
    u_warm = prob.task_warm_start(crouch_knots=6)
    heights, apexes, planned, airborne = [], [], [], []
    for t in range(n_steps):
        if t % replan_every == 0:
            sol = prob.solve(state_to_vec(state.robot)[0], u_warm)
            u_warm = sol.us
            planned.append(ballistic_apex(sol.xs[:, 2], sol.xs[:, 9]).max())
        action = u_warm[0]
        u_warm = torch.cat([u_warm[1:], u_warm[-1:]], dim=0)
        state, *_ = env.step(state, action[None])
        heights.append(state.robot.pos[0, 2])
        airborne.append(~state.feet_in_contact[0].any())
        apexes.append(ballistic_apex(state.robot.pos[0, 2], state.robot.lin_vel[0, 2]))
    heights, planned = torch.stack(heights), torch.stack(planned)
    return {
        "planner": prob.config.planner_desc,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "knots": n_steps,
        "solves": len(planned),
        "planned_apex_max_m": float(planned.max()),
        "planned_apex_first_m": float(planned[0]),
        "executed_apex_m": float(torch.stack(apexes).max()),
        "min_height_m": float(heights.min()),
        "max_height_m": float(heights.max()),
        "airborne_knots": int(torch.stack(airborne).sum()),
        "final_z_m": float(heights[-1]),
        "upright": bool(heights[-1] > 0.15),
        "finite": bool(torch.isfinite(state_to_vec(state.robot)).all()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=40, help="100 Hz control knots")
    ap.add_argument("--replan-every", type=int, default=5)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--iterations", type=int, default=4)
    a = ap.parse_args(argv)
    out = run(a.steps, a.replan_every, a.horizon, a.iterations, device=a.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
