"""ARS, Augmented Random Search: the stage-1 trainer.

Port of ``quadruped_springs_tpu.train.ars``: ARS-v2 (normalised
observations, top-b direction averaging; Mania, Guy, Recht 2018). The JAX
package vmaps an episode rollout over the 2·D perturbed policies; here they
are folded into the environment axis: one rollout of N = 2·D·bank lanes,
each lane carrying its own W by gather and its action a batched product
clipped to ±1. With observation noise each bank entry draws one noise
stream, and every (sign, direction) lane of that entry replays it: r+ and
r− of a direction see the same scenario and the same noise, the common
random numbers of JAX's vmap over one bank of keyed states.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from quadruped_springs_tpu_torch.env.env import draw_noise, take
from quadruped_springs_tpu_torch.train import normalize as vnorm
from quadruped_springs_tpu_torch.train import rollout as ro
from quadruped_springs_tpu_torch.train.networks import linear_policy_apply


@dataclasses.dataclass(frozen=True)
class ARSConfig:
    n_directions: int = 16
    top_directions: int = 8
    step_size: float = 0.02
    delta_std: float = 0.025
    episode_steps: int = 200      # 100 Hz control steps (2 s episodes)
    reset_bank_size: int = 16
    # the curriculum level rises by this per learner iteration (clipped to
    # 1); the reset bank samples scenarios at the current level
    curriculum_increase: float = 0.0
    # a warm-started fine-tune must not refresh the observation statistics:
    # the policy is W(normalize(obs)), so rescaling its inputs changes the
    # behaviour with the weights untouched
    freeze_obs_norm: bool = False


@dataclasses.dataclass(frozen=True)
class ARSState:
    W: torch.Tensor               # (action_dim, obs_dim)
    obs_norm: vnorm.RunningNorm
    generator: torch.Generator    # on the env's device; train_step draws from it
    iteration: int
    curriculum_level: float       # in [0, 1]


class ARSTrainer:
    def __init__(self, env, config: ARSConfig = ARSConfig()):
        self.env = env
        self.config = config
        # sparse tasks pay their reward at the episode's end: if episodes
        # cannot finish inside the rollout, every return is zero
        ep_horizon_s = config.episode_steps * env.env_time_step
        if env.config.max_ep_len > ep_horizon_s:
            warnings.warn(
                f"ARS episode_steps={config.episode_steps} ({ep_horizon_s:.2f} s) is "
                f"shorter than the env timeout max_ep_len={env.config.max_ep_len} s: "
                "episodes that survive never terminate inside the rollout, so sparse "
                "terminal rewards are never paid (all-zero returns). Lower max_ep_len "
                "or raise episode_steps.")

    def init(self, generator: torch.Generator) -> ARSState:
        dev = self.env.device
        return ARSState(
            W=torch.zeros(self.env.action_dim, self.env.obs_dim, device=dev),
            obs_norm=vnorm.RunningNorm.create(self.env.obs_dim, dev),
            generator=generator, iteration=0,
            curriculum_level=float(self.env.config.curriculum_level))

    def increase_curriculum_level(self, ts: ARSState, value: float) -> ARSState:
        """Manual level bump; ARSConfig.curriculum_increase is the automatic one."""
        return dataclasses.replace(
            ts, curriculum_level=min(max(ts.curriculum_level + value, 0.0), 1.0))

    def _policy(self, W, obs_norm):
        return lambda obs: linear_policy_apply(W, vnorm.normalize(obs_norm, obs))

    @torch.no_grad()
    def train_step(self, ts: ARSState, deltas: torch.Tensor | None = None, bank=None):
        """One learner iteration; returns (new state, metrics of 0-d tensors).
        `deltas` (D, A, obs_dim), already scaled by delta_std, and `bank`
        (states, obs) of reset_bank_size entries replace the draws. With
        observation noise the generator then draws one noise stream per
        bank entry (the drawn bank's first observations come from it)."""
        cfg, gen = self.config, ts.generator
        D, B = cfg.n_directions, cfg.reset_bank_size
        if deltas is None:
            deltas = torch.randn((D, *ts.W.shape), generator=gen,
                                 device=ts.W.device) * cfg.delta_std
        noise = draw_noise(self.env, gen, B, cfg.episode_steps)
        if bank is None:
            bank = ro.make_reset_bank(self.env, gen, B, curriculum_level=ts.curriculum_level,
                                      noise=noise)
        # lanes ordered (sign, direction, bank entry)
        W_lanes = torch.cat([ts.W + deltas, ts.W - deltas]).repeat_interleave(B, dim=0)
        entry = torch.arange(B, device=ts.W.device).repeat(2 * D)
        rets, info = ro.episode_returns(self.env, self._policy(W_lanes, ts.obs_norm),
                                        *take(bank, entry), cfg.episode_steps,
                                        gen if noise is None else noise.take(entry))
        r_plus, r_minus = rets.view(2, D, B).mean(-1)

        # top-b directions by max(r+, r-)
        score = torch.maximum(r_plus, r_minus)
        order = torch.argsort(-score, stable=True)[:cfg.top_directions]
        rp, rm, ds = r_plus[order], r_minus[order], deltas[order]
        sigma = torch.cat([rp, rm]).std(unbiased=False) + 1e-8
        update = torch.einsum("d,dij->ij", rp - rm, ds) / (cfg.top_directions * sigma)
        W = ts.W + cfg.step_size / cfg.delta_std * update

        # the statistics take every live observation of this iteration's rollouts
        obs_norm = ts.obs_norm if cfg.freeze_obs_norm else vnorm.update_from_moments(
            ts.obs_norm, info["obs_count"], info["obs_sum"], info["obs_sumsq"])
        metrics = {"mean_return": rets.mean(), "best_return": score.max(), "sigma_r": sigma,
                   "curriculum_level": ts.curriculum_level,
                   "live_steps": info["obs_count"]}
        return dataclasses.replace(
            ts, W=W, obs_norm=obs_norm, iteration=ts.iteration + 1,
            curriculum_level=min(max(ts.curriculum_level + cfg.curriculum_increase, 0.0),
                                 1.0)), metrics

    @torch.no_grad()
    def evaluate(self, ts: ARSState, n_episodes: int = 8,
                 generator: torch.Generator | None = None, bank=None):
        """Deterministic episodes on fresh scenarios, from a generator of
        its own (seeded by the iteration) unless one is given, so evaluating
        does not move the training stream. `bank` (states, obs) replaces
        the draw of the n_episodes starts. Each episode has a noise stream
        of its own, as in train_step."""
        if generator is None:
            generator = torch.Generator(self.env.device).manual_seed(123 + ts.iteration)
        n = n_episodes if bank is None else bank[1].shape[0]
        noise = draw_noise(self.env, generator, n, self.config.episode_steps)
        states, obs = (ro.make_reset_bank(self.env, generator, n_episodes, noise=noise)
                       if bank is None else bank)
        rets, info = ro.episode_returns(self.env, self._policy(ts.W, ts.obs_norm), states,
                                        obs, self.config.episode_steps,
                                        generator if noise is None else noise)
        return {"return_mean": rets.mean(), "return_std": rets.std(unbiased=False),
                "max_height": info["max_height"].max(), "max_fwd": info["max_fwd"].max()}
