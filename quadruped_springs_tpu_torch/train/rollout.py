"""Batched rollouts for the trainers.

Port of ``quadruped_springs_tpu.train.rollout``. The environment axis N is
the env's own batch axis; a rollout is a Python loop of batched env steps
under ``torch.no_grad()`` in which every decision is a masked select, so it
reads nothing on the host:

  * `episode_returns`: episodic, done-masked rollouts for ARS and evaluation.
  * `segment_rollout`: fixed-length segments with auto-reset for PPO.

Auto-reset swaps in states gathered from a pre-settled *reset bank* instead
of settling again inside the rollout: same distribution, O(1) per step.
`env` is a QuadrupedEnv or anything with its reset/step surface
(RestTruncationWrapper, ContinuousAutopilotEnv).
"""

from __future__ import annotations

from typing import Callable

import torch

from quadruped_springs_tpu_torch.env.env import select, take
from quadruped_springs_tpu_torch.utils import demo as demo_util


def make_reset_bank(env, generator: torch.Generator, n: int, curriculum_level=None):
    """n pre-settled reset states and their first observations, from one
    batched reset. `curriculum_level` (a Python number) widens the
    randomisation ranges: the trainer-driven curriculum."""
    return env.reset(generator, n, curriculum_level=curriculum_level)


def make_rsi_bank(env, demo: torch.Tensor, generator: torch.Generator, n: int):
    """Reset bank with reference-state initialisation: each entry spawns at
    a random demo row (one in five within the first 20%) in that row's
    recorded robot state, with the imitation index set to match."""
    idx = demo_util.rsi_index(generator, int(demo.shape[0]), n)
    rs = demo_util.demo_robot_state(demo, idx, env.action_dim)
    return env.reset(generator, desired_robot_state=rs, demo_start_idx=idx)


@torch.no_grad()
def episode_returns(env, policy_fn: Callable, states, obs0: torch.Tensor, max_steps: int,
                    generator: torch.Generator | None = None):
    """Roll full episodes from the given start states; returns the
    per-episode return (N,) and a dict: length, max_height, max_fwd (N,)
    and the observation moments obs_count (), obs_sum, obs_sumsq (d,) over
    the post-step observation of every step that was live before it.
    policy_fn: obs (N, d) -> action (N, A). The state freezes after done
    (no reset: episodic semantics)."""
    n, d = obs0.shape
    dev = obs0.device
    state, obs = states, obs0
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    ret, mh, mf = (torch.zeros(n, device=dev) for _ in range(3))
    length = torch.zeros(n, dtype=torch.int32, device=dev)
    oc = torch.zeros((), dtype=obs0.dtype, device=dev)
    osum, osq = (torch.zeros(d, dtype=obs0.dtype, device=dev) for _ in range(2))
    for _ in range(max_steps):
        state2, obs2, r, d2, info = env.step(state, policy_fn(obs), generator)
        keep = ~done
        ret = ret + torch.where(keep, r, 0.0)
        length = length + keep.to(torch.int32)
        mh = torch.maximum(mh, torch.where(keep, info["max_height"], 0.0))
        mf = torch.maximum(mf, torch.where(keep, info["max_fwd"], 0.0))
        live = keep[:, None].to(obs.dtype)
        oc = oc + keep.sum()
        osum = osum + (obs2 * live).sum(0)
        osq = osq + (obs2 * obs2 * live).sum(0)
        state = select(done, state, state2)
        obs = torch.where(done[:, None], obs, obs2)
        done = done | d2
    return ret, {"length": length, "max_height": mh, "max_fwd": mf,
                 "obs_count": oc, "obs_sum": osum, "obs_sumsq": osq}


@torch.no_grad()
def segment_rollout(env, action_fn: Callable, states, obs: torch.Tensor, bank,
                    generator: torch.Generator | None, T: int,
                    noise: torch.Tensor | None = None,
                    reset_idx: torch.Tensor | None = None):
    """T-step segment with auto-reset from the bank.

    action_fn(obs, nu, eps_prev) -> (action, logp, value, eps), over the
    batch: `nu` is the step's standard-normal draw (N, A) and `eps` the
    exploration-noise state threaded through the segment (AR(1)-correlated
    exploration, zeroed where an episode ends). The env executes the action
    clipped to [-1, 1]; the stored one stays unclipped, so its logp is the
    Gaussian's. `noise` (T, N, A) and `reset_idx` (T, N) give the draws
    instead of the generator. Returns (states, obs, traj dict with a leading
    time axis).
    """
    bank_states, bank_obs = bank
    n_bank, n = bank_obs.shape[0], obs.shape[0]
    dev = obs.device
    eps = torch.zeros(n, env.action_dim, device=dev)
    steps = []
    for t in range(T):
        nu = (torch.randn(n, env.action_dim, generator=generator, device=dev)
              if noise is None else noise[t])
        idx = (torch.randint(0, n_bank, (n,), generator=generator, device=dev)
               if reset_idx is None else reset_idx[t])
        action, logp, value, eps2 = action_fn(obs, nu, eps)
        states2, obs2, r, done, info = env.step(states, torch.clamp(action, -1.0, 1.0),
                                                generator)
        steps.append({"obs": obs, "action": action, "logp": logp, "value": value,
                      "reward": r, "done": done,
                      # steps where the policy's action was executed: an
                      # autopilot adapter reports them; a plain env executes all
                      "pg_mask": info.get("policy_in_control", torch.ones_like(done))})
        # auto-reset where done
        states = select(done, take(bank_states, idx), states2)
        obs = torch.where(done[:, None], bank_obs[idx], obs2)
        eps = torch.where(done[:, None], 0.0, eps2)
    traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    return states, obs, traj
