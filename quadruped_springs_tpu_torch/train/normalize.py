"""Running observation normalisation.

Port of ``quadruped_springs_tpu.train.normalize``: the statistics are an
explicit dataclass of tensors merged batch by batch (parallel Welford).
Variances are the population's (ddof 0), as ``jnp.var``'s.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RunningNorm:
    mean: torch.Tensor   # (d,)
    var: torch.Tensor    # (d,)
    count: torch.Tensor  # ()

    @classmethod
    def create(cls, dim: int, device=None):
        return cls(mean=torch.zeros(dim, device=device), var=torch.ones(dim, device=device),
                   count=torch.tensor(1e-4, dtype=torch.float32, device=device))


def update(rn: RunningNorm, batch: torch.Tensor) -> RunningNorm:
    """Merge a (N, d) batch of observations."""
    n = float(batch.shape[0])
    b_mean = batch.mean(0)
    b_var = batch.var(0, unbiased=False)
    delta = b_mean - rn.mean
    tot = rn.count + n
    mean = rn.mean + delta * n / tot
    var = (rn.var * rn.count + b_var * n + delta**2 * rn.count * n / tot) / tot
    return RunningNorm(mean=mean, var=var, count=tot)


def update_from_moments(rn: RunningNorm, count, total, total_sq) -> RunningNorm:
    """Merge raw moment sums (count (), total (d,), total_sq (d,)), for
    streams summed inside a rollout."""
    n = torch.clamp_min(count, 1e-8)
    b_mean = total / n
    b_var = torch.clamp_min(total_sq / n - b_mean**2, 0.0)
    delta = b_mean - rn.mean
    tot = rn.count + count
    mean = rn.mean + delta * count / tot
    var = (rn.var * rn.count + b_var * count + delta**2 * rn.count * count / tot) / tot
    return RunningNorm(mean=mean, var=var, count=tot)


def normalize(rn: RunningNorm, obs: torch.Tensor, clip: float = 10.0):
    return torch.clamp((obs - rn.mean) / torch.sqrt(rn.var + 1e-8), -clip, clip)
