"""Continuous-jumping per-jump autopilot as a branch-free env adapter.

Port of ``quadruped_springs_tpu.env.continuous_autopilot``: the phase
machine of ``LandingWrapperContinuous`` (hold_landing=True) as one action
selection per control step, so the adapter looks like a plain environment
(`reset(generator, n) -> (state, obs)`, `step(state, action, generator) ->
(state, obs, reward, done, info)`) whose state carries the autopilot's
phase per environment, and every trainer runs through the autopilot
unchanged. The policy is asked at every control step but its output is
executed only in the POLICY phase; `info["policy_in_control"]` marks those
steps, and PPO masks its policy-gradient terms to them.

Phases, per environment:
  POLICY   the policy's action is executed; when the task detects a jump
           after the step, enter TAKEOFF holding that action, with
           deadline = sim time + vz/g
  TAKEOFF  the held action until sim time >= deadline, then LANDING
  LANDING  the landing action while flying; at touch-down control returns
           to POLICY

Every decision is a masked select on device tensors: a step reads nothing
on the host.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_springs_tpu_torch.env.env import EnvState, QuadrupedEnv

_G = 9.81

POLICY = 0
TAKEOFF = 1
LANDING = 2


@dataclasses.dataclass(frozen=True)
class APState:
    """The env state plus the autopilot's, every field with a leading N."""
    env: EnvState
    phase: torch.Tensor      # (N,) int32
    held: torch.Tensor       # (N, action_dim) action held through take-off
    deadline: torch.Tensor   # (N,) sim time of the ballistic peak


class ContinuousAutopilotEnv:
    """QuadrupedEnv plus the per-jump landing autopilot, with the surface
    the trainers use."""

    def __init__(self, env: QuadrupedEnv, hold_landing: bool = True):
        self.env = env
        self.hold_landing = hold_landing
        self.landing_action = env.get_landing_action()

    @property
    def action_dim(self):
        return self.env.action_dim

    @property
    def obs_dim(self):
        return self.env.obs_dim

    @property
    def config(self):
        return self.env.config

    @property
    def device(self):
        return self.env.device

    @property
    def env_time_step(self):
        return self.env.env_time_step

    def sim_time(self, state: APState):
        return self.env.sim_time(state.env)

    def get_init_action(self):
        return self.env.get_init_action()

    def get_landing_action(self):
        return self.env.get_landing_action()

    def reset(self, generator: torch.Generator | None = None, n: int = 1, **kw):
        state, obs = self.env.reset(generator, n, **kw)
        return self.start(state), obs

    def start(self, state: EnvState) -> APState:
        """The adapter's state over env states fresh from a reset: every
        environment in POLICY."""
        n, dev = state.sim_step_counter.shape[0], state.sim_step_counter.device
        return APState(
            env=state,
            phase=torch.full((n,), POLICY, dtype=torch.int32, device=dev),
            held=torch.zeros(n, self.env.action_dim, device=dev),
            deadline=torch.zeros(n, device=dev))

    def step(self, state: APState, action: torch.Tensor,
             generator: torch.Generator | None = None):
        env = self.env
        # the phase is resolved before the step, as the wrapper checks its
        # loop conditions before each inner env.step: peak reached ->
        # LANDING; touch-down -> control back to POLICY
        t = env.sim_time(state.env)
        flying = ~state.env.feet_in_contact.any(-1)
        phase = torch.where((state.phase == TAKEOFF) & (t >= state.deadline),
                            LANDING if self.hold_landing else POLICY, state.phase)
        phase = torch.where((phase == LANDING) & ~flying, POLICY, phase)

        in_policy = phase == POLICY
        exec_action = torch.where(
            in_policy[:, None], action,
            torch.where((phase == TAKEOFF)[:, None], state.held, self.landing_action))
        env2, obs, r, done, info = env.step(state.env, exec_action, generator)

        # the jump trigger after the step: hold the action just executed,
        # with the peak's deadline from the post-step vertical velocity
        trigger = in_policy & env2.task.is_jumping & ~done
        phase2 = torch.where(trigger, TAKEOFF, phase)
        held2 = torch.where(trigger[:, None], exec_action, state.held)
        deadline2 = torch.where(trigger, env.sim_time(env2) + env2.robot.lin_vel[:, 2] / _G,
                                state.deadline)
        info = dict(info)
        info["policy_in_control"] = in_policy
        return (APState(env=env2, phase=phase2, held=held2, deadline=deadline2),
                obs, r, done, info)
