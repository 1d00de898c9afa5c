"""Branch-free flattened backflip episode: the autopilot's phase machine as
one action selection per control step.

Port of ``quadruped_springs_tpu.env.flat_rollout``. The phase machine of
``LandingWrapperBackflip(variant="until_grounded")`` is driven by monotone
phase flags, per environment:

  LAUNCH   task not switched            -> launch_fn(obs)
  FLIP     switched, pitch < 5π/8       -> the take-off action
           (at least one flip step even if the pitch is already past the
           threshold when the task switches, as the wrapper's do-while)
  DESCENT  pitch passed, still flying   -> the landing action
  LANDED   grounded after the flip      -> lander_fn(obs)

Every environment takes the same fixed number of steps and every decision
is a masked select, so whole episodes run over the batch with no read on
the host; the action source at each step matches the wrapper's.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_springs_tpu_torch.env.env import EnvState, QuadrupedEnv, select
from quadruped_springs_tpu_torch.env.wrappers import LandingWrapperBackflip, take_off_action
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.utils import demo as demo_util


@dataclasses.dataclass(frozen=True)
class BackflipPhase:
    """Monotone phase flags of an episode, (N,) bool each."""
    flip_stepped: torch.Tensor   # at least one take-off step taken
    pitch_passed: torch.Tensor   # unwrapped pitch reached 5π/8 after the switch
    returned: torch.Tensor       # grounded after the flip: control is back
    done: torch.Tensor           # episode ended (state frozen from here on)


def init_phase(n: int, device=None) -> BackflipPhase:
    f = lambda: torch.zeros(n, dtype=torch.bool, device=device)
    return BackflipPhase(flip_stepped=f(), pitch_passed=f(), returned=f(), done=f())


def backflip_episode(env: QuadrupedEnv, launch_fn, lander_fn, state0: EnvState,
                     obs0: torch.Tensor, n_knots: int,
                     generator: torch.Generator | None = None, record_rows: bool = False):
    """Run N flattened backflip episodes for a fixed n_knots.

    launch_fn, lander_fn: obs (N, obs_dim) -> action (N, 6) in [-1, 1]
    (normalisation inside). Returns (final state frozen at done, final
    phase, traj): traj is a dict of stacks over the steps, (n_knots, N, ...):
    obs (the step's input), action, phase code (0 launch / 1 flip /
    2 descent / 3 landed), up_z, z, done, returned, reward; with
    record_rows=True also "row", demonstration rows (filtered action, robot
    state after the step, landing flag) and "row_valid".
    """
    n = obs0.shape[0]
    take_off = take_off_action(obs0.device).expand(n, -1)
    thr = LandingWrapperBackflip.PITCH_THRESHOLD
    landing = env.get_landing_action().expand(n, -1)
    state, obs, ph = state0, obs0, init_phase(n, obs0.device)
    steps = []
    for _ in range(n_knots):
        switched = state.task.switched_controller
        in_flip = switched & ~ph.pitch_passed
        in_descent = ph.pitch_passed & ~ph.returned
        phase_code = torch.where(
            ph.returned, 3, torch.where(in_descent, 2, torch.where(in_flip, 1, 0)))
        action = torch.where(
            ph.returned[:, None], lander_fn(obs),
            torch.where(in_descent[:, None], landing,
                        torch.where(in_flip[:, None], take_off, launch_fn(obs))))
        state2, obs2, r, d, _ = env.step(state, action, generator)
        # the flags follow the wrapper's checks after its step
        flip_stepped = ph.flip_stepped | in_flip
        pitch = sp.pitch_unwrapped_yxz(state2.robot.quat, state2.task.switched_controller)
        pitch_passed = ph.pitch_passed | (flip_stepped & (pitch >= thr))
        flying = ~state2.feet_in_contact.any(-1)
        returned = ph.returned | (pitch_passed & ~flying)
        ph2 = BackflipPhase(flip_stepped=flip_stepped, pitch_passed=pitch_passed,
                            returned=returned, done=ph.done | d)
        # freeze at the first done step: the final pose is the state at done
        was_done = ph.done
        state_n = select(was_done, state, state2)
        obs_n = torch.where(was_done[:, None], obs, obs2)
        ph_n = select(was_done, ph, ph2)
        out = {"obs": obs, "action": action, "phase": phase_code,
               "up_z": sp.quat_to_mat(state_n.robot.quat)[:, 2, 2],
               "z": state_n.robot.pos[:, 2], "done": ph_n.done, "returned": ph_n.returned,
               "reward": torch.where(was_done, 0.0, r)}
        if record_rows:
            # the landing flag is the descent phase onward; rows past done
            # are marked invalid
            out["row"] = demo_util.demo_row(state_n.last_filtered_action, state_n.robot,
                                            ph_n.pitch_passed)
            out["row_valid"] = ~was_done
        steps.append(out)
        state, obs, ph = state_n, obs_n, ph_n
    traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    return state, ph, traj
