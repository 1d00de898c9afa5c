"""Evaluation harness: save a trained policy with its env configuration,
rebuild both, roll deterministic episodes.

Port of ``quadruped_springs_tpu.train.evaluate``. The artifact is a
directory with ``config.json`` (algorithm, env kwargs, network widths) and
``state.pt`` (the policy's tensors and its observation statistics).
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.train import normalize as vnorm
from quadruped_springs_tpu_torch.train import rollout as ro
from quadruped_springs_tpu_torch.train.networks import MLPPolicy, linear_policy_apply
from quadruped_springs_tpu_torch.utils import checkpoint as ckpt


def save_experiment(path: str, env_config: EnvConfig, algo: str, train_state) -> None:
    """Persist the env kwargs and the policy of a trainer state (`algo` is
    "ars" or "ppo")."""
    os.makedirs(path, exist_ok=True)
    meta = {"algo": algo, "env": dataclasses.asdict(env_config)}
    if algo == "ars":
        art = {"W": train_state.W, "obs_norm": train_state.obs_norm}
    else:
        meta["hidden"] = list(train_state.net.hidden)
        art = {"params": train_state.net.state_dict(), "obs_norm": train_state.obs_norm}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(meta, f, indent=2)
    ckpt.save(os.path.join(path, "state"), art)


def load_experiment(path: str, device=None):
    """Rebuild (env, deterministic policy obs (N, d) -> action (N, A)) from
    a saved experiment, on `device` (the card by default)."""
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    env = QuadrupedEnv(EnvConfig(**meta["env"]), device=device)
    art = ckpt.restore(os.path.join(path, "state"), env.device)
    obs_norm = vnorm.RunningNorm(**art["obs_norm"])
    if meta["algo"] == "ars":
        def policy(obs):
            return linear_policy_apply(art["W"], vnorm.normalize(obs_norm, obs))
    else:
        net = MLPPolicy(env.obs_dim, env.action_dim, meta["hidden"]).to(env.device)
        net.load_state_dict(art["params"])

        @torch.no_grad()
        def policy(obs):
            return torch.clamp(net(vnorm.normalize(obs_norm, obs))[0], -1.0, 1.0)

    return env, policy


def evaluate_policy(env, policy, generator: torch.Generator, n_episodes: int = 8,
                    max_steps: int = 1000) -> dict:
    """Deterministic batched evaluation; the KPIs as Python floats."""
    states, obs = ro.make_reset_bank(env, generator, n_episodes)
    rets, info = ro.episode_returns(env, policy, states, obs, max_steps, generator)
    return {
        "return_mean": float(rets.mean()),
        "return_std": float(rets.std(unbiased=False)),
        "episode_len_mean": float(info["length"].float().mean()),
        "max_height": float(info["max_height"].max()),
        "max_fwd": float(info["max_fwd"].max()),
    }
