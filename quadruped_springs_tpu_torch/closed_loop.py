"""Closed-loop (receding-horizon) MPC on the stiff 1 kHz simulator.

Port of the JAX package's ``examples/run_closed_loop_mpc.py``: every
``--replan-every`` control knots the problem is solved from the robot's
current state, warm-started from the shifted previous plan; the plan's first
action is executed, and the plan is shifted. The executor is the JAX loop's
``execute_knot``: 10 x 1 kHz substeps of PD plus spring torque and
``dynamics.step`` at ``default_sim_params(0.001)`` (180 kN/m, 100 N s/m,
the damping clamp on, memoryless friction: no foot anchors) on the nominal
scenario's model, which is the planner's rollout at H = 1, S = 10: one
``planner_rollout`` kernel launch per executed knot on the card.

The default loop plans with iLQR (H = 20, 4 iterations, 4 alphas) on the
relaxed 200 Hz planner model; feedback re-planning absorbs the mismatch
between the planner's and the executor's contact. ``--full-rate`` plans with
MPPI (H = 25, 4 iterations, K = 32, fused accept) on the execution-rate
model itself (MPCConfig.full_rate), so planner and executor share the
contact constants; its draws come from one torch.Generator seeded with 3.

    python -m quadruped_springs_tpu_torch.closed_loop                  # on the GPU
    python -m quadruped_springs_tpu_torch.closed_loop --full-rate
    python -m quadruped_springs_tpu_torch.closed_loop --device cpu --steps 6 \\
        --horizon 8 --iterations 2                                     # tiny CPU check

Prints one JSON line: planned and executed ballistic apex, final height,
upright. A CUDA device that is not available is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from quadruped_springs_tpu_torch.control import interfaces as ci
from quadruped_springs_tpu_torch.env import randomizers as rnd
from quadruped_springs_tpu_torch.env_bench import device_name, resolve_device
from quadruped_springs_tpu_torch.models import dynamics as dyn
from quadruped_springs_tpu_torch.solver.mpc import (
    MPCConfig,
    MPCProblem,
    state_to_vec,
    vec_to_state,
)
from quadruped_springs_tpu_torch.solver.mppi import MPPIConfig
from quadruped_springs_tpu_torch.solver.rollout import (
    RolloutConsts,
    RolloutLanes,
    planner_rollout,
)

_G = 9.81
EXEC_SUBSTEPS = 10                 # 1 kHz substeps per 100 Hz knot
FULL_RATE_HORIZON, FULL_RATE_SAMPLES, FULL_RATE_SEED = 25, 32, 3


def ballistic_apex(z, vz):
    return z + torch.clamp_min(vz, 0.0) ** 2 / (2 * _G)


def executor(prob: MPCProblem) -> tuple[RolloutLanes, RolloutConsts]:
    """The executor's constants: the nominal scenario's one row (model and
    springs, the 1 kHz simulator's friction) and the 1 kHz simulator's
    contact parameters, EXEC_SUBSTEPS substeps a knot."""
    params = dyn.default_sim_params(0.001)
    nominal = rnd.nominal_params(prob.cfg)
    ground = torch.full_like(nominal.friction, params.friction)
    lanes = prob.rollout_lanes(dataclasses.replace(nominal, friction=ground))
    return lanes, prob.rollout_consts(params, EXEC_SUBSTEPS)


def execute_knot(prob: MPCProblem, lanes: RolloutLanes, consts: RolloutConsts,
                 state: dyn.RobotState, action: torch.Tensor):
    """One 100 Hz knot on the stiff simulator (10 x 1 kHz substeps) for N
    lanes: action (N,m), through planner_rollout (N problems of one
    candidate, H = 1). Returns (state, info): info["feet_in_contact"] (N,4)
    holds the feet touching the ground at the knot's end."""
    q_des = ci.action_to_command(prob.iface, action).contiguous()
    xs = planner_rollout(state_to_vec(state).contiguous(), q_des[:, None, None], lanes,
                         consts)
    state = vec_to_state(xs[:, 0, 1])
    feet = dyn.foot_state_world(lanes.model, state)[0]
    return state, {"feet_in_contact": feet[..., 2] < lanes.model.foot_radius}


def run(n_steps: int = 40, replan_every: int = 5, horizon: int | None = None,
        iterations: int = 4, n_alphas: int = 4, device="cuda",
        full_rate: bool = False) -> dict:
    """Run the loop for n_steps 100 Hz knots from the planner's default
    start on the nominal robot; returns the closed-loop transfer metrics
    (the largest planned apex against the apex the executor reached) and
    the number of solves. The horizon defaults to 20 knots (25 with
    full_rate)."""
    device = resolve_device(device)
    if full_rate:
        horizon = FULL_RATE_HORIZON if horizon is None else horizon
        prob = MPCProblem(MPCConfig.full_rate(task="JUMPING_IN_PLACE", horizon=horizon,
                                              iterations=iterations), device)
        mcfg = MPPIConfig(horizon=horizon, iterations=iterations,
                          n_samples=FULL_RATE_SAMPLES, fused_accept=True)
        gen = torch.Generator(device).manual_seed(FULL_RATE_SEED)
    else:
        horizon = 20 if horizon is None else horizon
        prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=horizon,
                                    iterations=iterations, n_alphas=n_alphas), device)
    lanes, consts = executor(prob)
    state = vec_to_state(prob.default_x0()[None])
    u_warm = prob.task_warm_start(crouch_knots=6)
    heights, apexes, planned, airborne = [], [], [], []
    for t in range(n_steps):
        if t % replan_every == 0:
            x = state_to_vec(state)
            if full_rate:
                sol = prob.solve_mppi(x, u_warm[None], gen, mcfg)
                us, xs = sol.us[0], sol.xs[0]
            else:
                sol = prob.solve(x[0], u_warm)
                us, xs = sol.us, sol.xs
            u_warm = us
            planned.append(ballistic_apex(xs[:, 2], xs[:, 9]).max())
        action = u_warm[0]
        u_warm = torch.cat([u_warm[1:], u_warm[-1:]], dim=0)
        state, info = execute_knot(prob, lanes, consts, state, action[None])
        heights.append(state.pos[0, 2])
        airborne.append(~info["feet_in_contact"][0].any())
        apexes.append(ballistic_apex(state.pos[0, 2], state.lin_vel[0, 2]))
    heights, planned = torch.stack(heights), torch.stack(planned)
    return {
        "planner": prob.config.planner_desc,
        "solver": "mppi" if full_rate else "ilqr",
        "device": device_name(device),
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
        "finite": bool(torch.isfinite(state_to_vec(state)).all()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=40, help="100 Hz control knots")
    ap.add_argument("--replan-every", type=int, default=5)
    ap.add_argument("--horizon", type=int, default=None,
                    help="20 knots (25 with --full-rate) by default")
    ap.add_argument("--iterations", type=int, default=4)
    ap.add_argument("--full-rate", action="store_true",
                    help="MPPI on the execution-rate model (MPCConfig.full_rate)")
    a = ap.parse_args(argv)
    out = run(a.steps, a.replan_every, a.horizon, a.iterations, device=a.device,
              full_rate=a.full_rate)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
