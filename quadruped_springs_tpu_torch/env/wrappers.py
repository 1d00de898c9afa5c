"""Wrappers: the hybrid-control autopilots over the batched environment.

Port of ``quadruped_springs_tpu.env.wrappers``: ``LandingWrapper`` (both
exit criteria), ``LandingWrapperBackflip`` (both variants),
``LandingWrapperContinuous`` (both ``hold_landing`` settings),
``GoToRestWrapper``, ``RestTruncationWrapper``, ``StepOut`` and
``episode_metrics``. Once a wrapper's trigger fires in an environment, one
wrapper step runs that environment through the autopilot's phases (repeat
or drive a take-off action, hold a landing action, ramp to rest), a variable
number of env steps.

JAX runs these phases as `lax.cond` / `lax.while_loop`, which under `vmap`
step every lane and keep the new state only where the lane's predicate
holds. The port does the same over the batch: each loop iteration steps all
N environments and selects, per environment, the new state where its mask
holds and the old one elsewhere, so an environment outside the mask does not
advance (counters, anchors, task state, observation). Deciding whether to
go on is one `mask.any()` per iteration: one device-to-host sync each,
counted in `syncs`. The wrapper states (`armed`, `h_prev`) are (N,) tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from quadruped_springs_tpu_torch.control import interfaces as ci
from quadruped_springs_tpu_torch.env.env import EnvState, QuadrupedEnv, select
from quadruped_springs_tpu_torch.models import spatial as sp

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


@functools.lru_cache(maxsize=None)
def take_off_action(device: torch.device) -> torch.Tensor:
    """The backflip autopilot's take-off action on a device, made once (a
    host -> device copy per call would synchronise the stream)."""
    return torch.tensor(LandingWrapperBackflip.TAKE_OFF_ACTION, device=device)


def _flying(o: StepOut) -> torch.Tensor:
    return ~o.state.feet_in_contact.any(-1)


class _Autopilot:
    """What the autopilot wrappers share: the env, the landing action, the
    masked loop and the count of its host reads."""

    def __init__(self, env: QuadrupedEnv):
        self.env = env
        self.landing_action = env.get_landing_action()
        self.syncs = 0   # mask.any() reads on the host

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

    def _landing(self, n: int) -> torch.Tensor:
        return self.landing_action.expand(n, -1)

    def reset(self, generator: torch.Generator, n: int = 1, **kw):
        return self.env.reset(generator, n, **kw)


class LandingWrapper(_Autopilot):
    """Post-take-off autopilot.

    variant="peak_timer": the take-off phase repeats the action until the
      vz/g peak timer, set when the controller switched, elapses.
    variant="until_grounded": the take-off phase ends when any foot touches.
    """

    def __init__(self, env: QuadrupedEnv, variant: str = "peak_timer"):
        if variant not in ("peak_timer", "until_grounded"):
            raise ValueError(f"unknown variant {variant!r}")
        super().__init__(env)
        self.variant = variant
        self._landing_gains = (torch.full((12,), LANDING_KP, device=env.device),
                               torch.full((12,), LANDING_KD, device=env.device))

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
                return switched & _flying(o) & ~o.done
        else:
            def take_off(o):
                return switched & (env.sim_time(o.state) < deadline) & ~o.done
        out = self._loop(out, take_off, action, generator)
        # landing phase: the landing action with soft gains, to the end
        kp, kd = self._landing_gains
        return self._loop(out, lambda o: switched & ~o.done,
                          self._landing(action.shape[0]), generator, kp, kd)


@dataclasses.dataclass(frozen=True)
class BackflipLandingState:
    armed: torch.Tensor  # (N,) bool: the "until_grounded" variant's one-shot flag


class LandingWrapperBackflip(_Autopilot):
    """Backflip autopilot. Once the task triggers, drive the fixed take-off
    action [0,1,-1]*2 until the unwrapped pitch exceeds 5π/8, then hold the
    landing action. No gain switch in either variant.

    variant="hold": the landing phase runs to the episode's end; the
      autopilot can trigger again.
    variant="until_grounded": the landing phase ends as soon as a foot
      touches, and the autopilot fires once per episode: carry the
      BackflipLandingState from init_state() through step().
    """

    TAKE_OFF_ACTION = (0.0, 1.0, -1.0, 0.0, 1.0, -1.0)
    PITCH_THRESHOLD = 5 * math.pi / 8

    def __init__(self, env: QuadrupedEnv, variant: str = "hold"):
        if env.action_dim != 6:
            raise ValueError("backflip landing wrapper expects SYMMETRIC actions")
        if variant not in ("hold", "until_grounded"):
            raise ValueError(f"unknown variant {variant!r}")
        super().__init__(env)
        self.variant = variant
        self.take_off_action = take_off_action(env.device)

    def init_state(self, n: int = 1) -> BackflipLandingState:
        return BackflipLandingState(
            armed=torch.ones(n, dtype=torch.bool, device=self.env.device))

    def _autopilot(self, out: StepOut, active: torch.Tensor, generator) -> StepOut:
        env, n = self.env, out.done.shape[0]
        take_off = self.take_off_action.expand(n, -1)

        def pitch(o):
            return sp.pitch_unwrapped_yxz(o.state.robot.quat,
                                          o.state.task.switched_controller)

        # do-while: the take-off phase steps once before it checks the
        # pitch, which matters when the unwrapped pitch is already past the
        # threshold at the trigger
        first = active & ~out.done
        out = select(first, _pack(env.step(out.state, take_off, generator)), out)
        out = self._loop(
            out, lambda o: active & (pitch(o) < self.PITCH_THRESHOLD) & ~o.done,
            take_off, generator)
        if self.variant == "until_grounded":
            def land(o):
                return active & _flying(o) & ~o.done
        else:
            def land(o):
                return active & ~o.done
        return self._loop(out, land, self._landing(n), generator)

    def step(self, state: EnvState, action: torch.Tensor,
             generator: torch.Generator | None = None,
             wstate: BackflipLandingState | None = None):
        """One policy step. For variant="until_grounded" pass and carry
        `wstate`: returns (StepOut, new wstate) then, a plain StepOut for
        "hold"."""
        out = _pack(self.env.step(state, action, generator))
        armed = torch.ones_like(out.done) if wstate is None else wstate.armed
        switched = out.state.task.switched_controller & ~out.done & armed
        if self._any(switched):
            out = self._autopilot(out, switched, generator)
        if self.variant == "until_grounded":
            return out, BackflipLandingState(armed=armed & ~switched)
        return out


@dataclasses.dataclass(frozen=True)
class ContinuousLandingState:
    armed: torch.Tensor  # (N,) bool: the autopilot arms again at every jump


class LandingWrapperContinuous(_Autopilot):
    """Per-jump autopilot for continuous jumping: when a jump is detected,
    repeat the action to the peak (hold_landing=True then holds the landing
    action until touch-down); arms again at every jump."""

    def __init__(self, env: QuadrupedEnv, hold_landing: bool = True):
        super().__init__(env)
        self.hold_landing = hold_landing

    def init_state(self, n: int = 1) -> ContinuousLandingState:
        return ContinuousLandingState(
            armed=torch.ones(n, dtype=torch.bool, device=self.env.device))

    def step(self, state: EnvState, wstate: ContinuousLandingState, action: torch.Tensor,
             generator: torch.Generator | None = None):
        env = self.env
        out = _pack(env.step(state, action, generator))
        jumping = out.state.task.is_jumping & wstate.armed & ~out.done
        if self._any(jumping):
            deadline = env.sim_time(out.state) + out.state.robot.lin_vel[:, 2] / _G
            out = self._loop(
                out, lambda o: jumping & (env.sim_time(o.state) < deadline) & ~o.done,
                action, generator)
            if self.hold_landing:
                out = self._loop(out, lambda o: jumping & _flying(o) & ~o.done,
                                 self._landing(action.shape[0]), generator)
        return out, ContinuousLandingState(armed=torch.ones_like(wstate.armed))


@dataclasses.dataclass(frozen=True)
class GoToRestState:
    h_prev: torch.Tensor  # (N,) base height at the previous control step


class GoToRestWrapper(_Autopilot):
    """After the jump has landed, ramp the action to the init pose (over
    1.0 s with springs, 0.3 s without) under soft gains (kp 60; kd 0.8 with
    springs, 1.5 without), then hold it to the episode's end.

    `rest_condition`: the controller has switched (a jump happened), all
    four feet are in contact and the base height rose since the previous
    control step (the rebound after the impact).
    """

    def __init__(self, env: QuadrupedEnv):
        super().__init__(env)
        springs = env.config.enable_springs
        self.duration = 1.0 if springs else 0.3
        self.n_ramp = max(int(self.duration / env.env_time_step), 1)
        self.target_action = env.get_init_action()
        self._rest_gains = (torch.full((12,), 60.0, device=env.device),
                            torch.full((12,), 0.8 if springs else 1.5, device=env.device))

    def init_state(self, state: EnvState) -> GoToRestState:
        return GoToRestState(h_prev=state.robot.pos[:, 2])

    def rest_condition(self, h_prev: torch.Tensor, out: StepOut) -> torch.Tensor:
        grounded = out.state.feet_in_contact.all(-1)
        has_jumped = out.state.task.switched_controller
        stopped_landing = (out.state.robot.pos[:, 2] - h_prev) > 0
        return has_jumped & grounded & stopped_landing

    def step(self, state: EnvState, wstate: GoToRestState, action: torch.Tensor,
             generator: torch.Generator | None = None):
        """One policy step with the rest trigger; returns (StepOut, wstate)."""
        out = _pack(self.env.step(state, action, generator))
        trigger = self.rest_condition(wstate.h_prev, out) & ~out.done
        if self._any(trigger):
            start = ci.command_to_action(self.env.iface, out.state.robot.q)
            out = self.rest_phase(out.state, start, generator, _pre=out, mask=trigger)
        return out, GoToRestState(h_prev=out.state.robot.pos[:, 2])

    def rest_phase(self, state: EnvState, start_action: torch.Tensor,
                   generator: torch.Generator | None = None,
                   _pre: StepOut | None = None, mask: torch.Tensor | None = None):
        """Ramp start -> init action over the duration, then hold the init
        action until the episode ends, in the environments of `mask` (all by
        default). Returns the final StepOut."""
        env = self.env
        kp, kd = self._rest_gains
        if _pre is None:
            out = _pack(env.step(state, start_action, generator, kp=kp, kd=kd))
        else:
            out = _pre
        if mask is None:
            mask = torch.ones_like(out.done)
        for i in range(self.n_ramp):
            frac = min((i + 1.0) / self.n_ramp, 1.0)
            a = start_action * (1 - frac) + frac * self.target_action
            nxt = _pack(env.step(out.state, a, generator, kp=kp, kd=kd))
            out = select(mask & ~out.done, nxt, out)
        return self._loop(out, lambda o: mask & ~o.done,
                          self.target_action.expand_as(start_action), generator, kp, kd)


class RestTruncationWrapper:
    """Ends the episode when the rest condition fires (a jump happened, all
    feet grounded, the base height rose over this control step): the MDP the
    agent sees when GoToRestWrapper runs the rest of the episode and returns
    only its last step. No wrapper state: the pre-step and the post-step
    heights are compared. Attribute access delegates to the wrapped env, so
    the trainers take it in place of one."""

    def __init__(self, env: QuadrupedEnv):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, state: EnvState, action: torch.Tensor,
             generator: torch.Generator | None = None, **kw):
        state2, obs, reward, done, info = self.env.step(state, action, generator, **kw)
        rest = (state2.task.switched_controller & state2.feet_in_contact.all(-1)
                & ((state2.robot.pos[:, 2] - state.robot.pos[:, 2]) > 0))
        return state2, obs, reward, done | rest, info

    def reset(self, generator: torch.Generator | None = None, n: int = 1, **kw):
        return self.env.reset(generator, n, **kw)


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
