"""Policy and value networks of the trainers.

Port of ``quadruped_springs_tpu.train.networks``: an MLP actor-critic for
PPO and a linear policy for ARS. The sub-modules keep the flax names
(`pi_0`, `pi_1`, `pi_out`, `vf_0`, `vf_1`, `vf_out`, `log_std`), which carry
the actor/critic split of ``PPOTrainer.warm_start`` and the layout of the
committed policy files (``convert.mlp_policy_params``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class MLPPolicy(nn.Module):
    """Diagonal-Gaussian actor (tanh MLP mean, free log-std) and a value
    head: forward(obs (..., obs_dim)) -> (mean (..., A), log_std (A,),
    value (...,)). Initialised as flax's Dense: LeCun-normal weights (a
    normal truncated at two standard deviations, drawn from `generator`),
    zero biases, log_std = -0.5."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = tuple(hidden)
        widths = (obs_dim, *self.hidden)
        for tower, out in (("pi", action_dim), ("vf", 1)):
            for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
                setattr(self, f"{tower}_{i}", nn.Linear(a, b))
            setattr(self, f"{tower}_out", nn.Linear(widths[-1], out))
        self.log_std = nn.Parameter(torch.full((action_dim,), -0.5))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                with torch.no_grad():
                    m.weight.copy_(_lecun_normal(m.weight.shape, generator))
                    m.bias.zero_()

    def _tower(self, name: str, x):
        for i in range(len(self.hidden)):
            x = torch.tanh(getattr(self, f"{name}_{i}")(x))
        return getattr(self, f"{name}_out")(x)

    def forward(self, obs):
        return self._tower("pi", obs), self.log_std, self._tower("vf", obs)[..., 0]


def _lecun_normal(shape, generator):
    """(out, in) weights: a standard normal truncated to [-2, 2] through the
    inverse CDF, scaled so that the variance is 1 / in."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=generator)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return x * (math.sqrt(1.0 / shape[1]) / 0.87962566103423978)


def linear_policy_apply(W: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """obs (..., obs_dim); W (A, obs_dim), or (N, A, obs_dim) with one policy
    per environment of obs (N, obs_dim)."""
    return torch.clamp((W @ obs[..., None])[..., 0], -1.0, 1.0)


def sample_action(net, obs, generator: torch.Generator | None = None,
                  deterministic: bool = False):
    mean, log_std, value = net(obs)
    if deterministic:
        a, logp = mean, torch.zeros(mean.shape[:-1], device=mean.device)
    else:
        eps = torch.randn(mean.shape, generator=generator, device=mean.device)
        a = mean + torch.exp(log_std) * eps
        logp = gaussian_logp(a, mean, log_std)
    return torch.clamp(a, -1.0, 1.0), logp, value


def gaussian_logp(a, mean, log_std):
    var = torch.exp(2 * log_std)
    return (-0.5 * ((a - mean) ** 2 / var + 2 * log_std + math.log(2 * math.pi))).sum(-1)
