"""Demonstration collection: an expert policy runs episodes under a
landing / rest autopilot flattened into a mode machine per control step,
and one demo row is recorded per step.

Port of ``quadruped_springs_tpu.env.demo_pipeline``, batched over N
episodes at once. Phases per environment: POLICY -> TAKEOFF -> LANDING ->
REST. Rows follow ``utils/demo.py``: [action (filtered), q, qd, base pos,
quat, lin vel, ang vel, landing flag].
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from quadruped_springs_tpu_torch.control import interfaces as ci
from quadruped_springs_tpu_torch.env.env import select
from quadruped_springs_tpu_torch.runtime import trajstore
from quadruped_springs_tpu_torch.utils import demo as demo_util

PHASE_POLICY = 0
PHASE_TAKEOFF = 1
PHASE_LANDING = 2
PHASE_REST = 3

_G = 9.81


@torch.no_grad()
def collect_demo(env, policy_fn: Callable, generator: torch.Generator | None = None,
                 n: int = 1, max_steps: int = 200, rest_duration: float | None = None,
                 autopilot: bool = True, start=None):
    """Run N episodes, recording a demo row per control step.

    policy_fn: obs (N, obs_dim) -> action (N, A), the expert.
    autopilot: True hands control to the landing / rest mode machine at
      take-off. False lets the policy drive the whole episode; the phase
      then tracks the same milestones for the recorded landing flag only
      (controller switched and descending, latched).
    start: optional (state, obs) to start from instead of env.reset.
    Returns (rows (max_steps, N, row_dim), valid (max_steps, N) bool, final
    env state). No phase switches the motor gains: rows record actions only,
    so a phase run under other gains could not be cloned.
    """
    if rest_duration is None:
        rest_duration = 1.0 if env.config.enable_springs else 0.3
    n_ramp = max(int(rest_duration / env.env_time_step), 1)
    dev = env.device
    # landing hold: with springs the deep-crouch pose [0, 1.0, -2.1]; the
    # standing landing pose tips over at the springs' second touch-down
    landing_action = (ci.command_to_action(
        env.iface, torch.tensor([0.0, 1.0, -2.1] * 4, device=dev))
        if env.config.enable_springs else env.get_landing_action())
    rest_action = env.get_init_action()

    state, obs = env.reset(generator, n) if start is None else start
    n = obs.shape[0]
    phase = torch.full((n,), PHASE_POLICY, dtype=torch.int32, device=dev)
    held = torch.zeros(n, env.action_dim, device=dev)
    peak_deadline, rest_i = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    settle = torch.zeros(n, dtype=torch.int32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    rows, valids = [], []
    for _ in range(max_steps):
        pol_a = policy_fn(obs)
        if autopilot:
            ramp = torch.clamp_max((rest_i + 1.0) / n_ramp, 1.0)[:, None]
            rest_a = held * (1 - ramp) + ramp * rest_action
            ph = phase[:, None]
            action = torch.where(ph == PHASE_POLICY, pol_a, torch.where(
                ph == PHASE_TAKEOFF, held, torch.where(
                    ph == PHASE_LANDING, landing_action, rest_a)))
        else:
            action = pol_a
        state2, obs2, _, d2, _ = env.step(state, action, generator)

        t = env.sim_time(state2)
        vz = state2.robot.lin_vel[:, 2]
        switched = state2.task.switched_controller
        enter_takeoff = (phase == PHASE_POLICY) & switched
        if not autopilot:
            enter_takeoff = enter_takeoff & (vz <= 0.0)
        phase2 = torch.where(enter_takeoff, PHASE_TAKEOFF if autopilot else PHASE_LANDING,
                             phase)
        peak_deadline = torch.where(enter_takeoff, t + vz / _G, peak_deadline)
        held2 = torch.where(enter_takeoff[:, None], action, held)
        phase2 = torch.where((phase2 == PHASE_TAKEOFF) & (t >= peak_deadline),
                             PHASE_LANDING, phase2)
        # rest trigger: all four feet grounded with |vz| < 0.08 m/s for 10
        # consecutive control steps (the settled form of the rest condition;
        # ramping through the springs' re-hop would land mid-ramp)
        quiet = state2.feet_in_contact.all(-1) & (vz.abs() < 0.08)
        settle2 = torch.where(quiet, settle + 1, 0)
        landed = (phase2 == PHASE_LANDING) & (settle2 >= 10)
        phase2 = torch.where(landed, PHASE_REST, phase2)
        # the ramp starts from the current pose, not from the landing action
        start_a = ci.command_to_action(env.iface, state2.robot.q)
        held2 = torch.where(landed[:, None], start_a, held2)
        rest_i = torch.where(phase2 == PHASE_REST, rest_i + 1, rest_i)

        # the filtered action is recorded: what the motors tracked
        rows.append(demo_util.demo_row(state2.last_filtered_action, state2.robot,
                                       phase2 >= PHASE_LANDING))
        valids.append(~done)
        state = select(done, state, state2)
        obs = torch.where(done[:, None], obs, obs2)
        phase, held, settle, done = phase2, held2, settle2, done | d2
    return torch.stack(rows), torch.stack(valids), state


def save_demo_library(path: str, rows, valid) -> None:
    """Persist the valid rows of one episode, rows (T, row_dim) and valid
    (T,), through the trajectory store."""
    rows = rows.cpu().numpy() if torch.is_tensor(rows) else np.asarray(rows)
    valid = valid.cpu().numpy() if torch.is_tensor(valid) else np.asarray(valid)
    trajstore.write(path, rows[valid])


def load_demo_library(path: str, device=None) -> torch.Tensor:
    return torch.as_tensor(trajstore.read(path), device=device)
