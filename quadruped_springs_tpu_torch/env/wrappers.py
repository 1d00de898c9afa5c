"""Wrappers: the landing autopilot over the batched environment.

Port of ``LandingWrapper``, ``StepOut`` and ``episode_metrics`` of
``quadruped_springs_tpu.env.wrappers``. Once the task has switched to its
landing controller, one wrapper step runs the rest of the episode: the
take-off phase repeats the policy's action until the flight peak (or, in
the "until_grounded" variant, until the robot touches down), then the
landing phase holds the landing action with soft gains until the episode
ends.

JAX runs these phases as `lax.cond` / `lax.while_loop`, which under `vmap`
step every lane and keep the new state only where the lane's predicate
holds. The port does the same over the batch: each loop iteration steps all
N environments and selects, per environment, the new state where its mask
holds and the old one elsewhere, so an environment outside the mask does not
advance (counters, anchors, task state, observation). Deciding whether to
go on is one `mask.any()` per iteration: one device-to-host sync each.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_springs_tpu_torch.env.env import EnvState, QuadrupedEnv, select

LANDING_KP = 60.0
LANDING_KD = 1.5
_G = 9.81


@dataclasses.dataclass(frozen=True)
class StepOut:
    state: EnvState
    obs: torch.Tensor          # (N, obs_dim)
    reward: torch.Tensor       # (N,)
    done: torch.Tensor         # (N,) bool
    max_height: torch.Tensor   # (N,)
    max_fwd: torch.Tensor      # (N,)


def _pack(out) -> StepOut:
    state, obs, reward, done, info = out
    return StepOut(state, obs, reward, done, info["max_height"], info["max_fwd"])


class LandingWrapper:
    """Post-take-off autopilot.

    variant="peak_timer": the take-off phase repeats the action until the
      vz/g peak timer, set when the controller switched, elapses.
    variant="until_grounded": the take-off phase ends when any foot touches.
    """

    def __init__(self, env: QuadrupedEnv, variant: str = "peak_timer"):
        if variant not in ("peak_timer", "until_grounded"):
            raise ValueError(f"unknown variant {variant!r}")
        self.env = env
        self.variant = variant
        self.landing_action = env.get_landing_action()
        self._landing_gains = (torch.full((12,), LANDING_KP, device=env.device),
                               torch.full((12,), LANDING_KD, device=env.device))
        self.syncs = 0   # mask.any() reads on the host, for PERF.md's count

    def _any(self, mask: torch.Tensor) -> bool:
        self.syncs += 1
        return bool(mask.any())

    def _loop(self, out: StepOut, cond, action, generator, kp=None, kd=None) -> StepOut:
        """While any environment meets cond, step all and keep the step
        where cond held."""
        while True:
            mask = cond(out)
            if not self._any(mask):
                return out
            new = _pack(self.env.step(out.state, action, generator, kp=kp, kd=kd))
            out = select(mask, new, out)

    def step(self, state: EnvState, action: torch.Tensor,
             generator: torch.Generator | None = None) -> StepOut:
        env = self.env
        out = _pack(env.step(state, action, generator))
        switched = out.state.task.switched_controller & ~out.done
        if not self._any(switched):
            return out
        # take-off phase: repeat the action until the peak (or touch-down)
        deadline = env.sim_time(out.state) + out.state.robot.lin_vel[:, 2] / _G
        if self.variant == "until_grounded":
            def take_off(o):
                return switched & ~o.state.feet_in_contact.any(-1) & ~o.done
        else:
            def take_off(o):
                return switched & (env.sim_time(o.state) < deadline) & ~o.done
        out = self._loop(out, take_off, action, generator)
        # landing phase: the landing action with soft gains, to the end
        landing = self.landing_action.expand(action.shape[0], -1)
        kp, kd = self._landing_gains
        return self._loop(out, lambda o: switched & ~o.done, landing, generator, kp, kd)

    def reset(self, generator: torch.Generator, n: int = 1):
        return self.env.reset(generator, n)


def episode_metrics(rewards: torch.Tensor, infos: dict) -> dict:
    """Per-environment episode KPIs from step outputs stacked over time:
    rewards (T,N), infos["max_height"] and ["max_fwd"] (T,N),
    infos["feet_forces"] (T,N,4). Each value is (N,)."""
    return {
        "return": rewards.sum(0),
        "max_height": infos["max_height"].amax(0),
        "max_fwd": infos["max_fwd"].amax(0),
        "peak_feet_force": infos["feet_forces"].sum(-1).amax(0),
    }
