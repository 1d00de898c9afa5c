"""MPPI (model-predictive path integral) solver, batched over scenarios.

Port of ``quadruped_springs_tpu.solver.mppi``. Where the JAX solver handles
one problem and is vmapped, ``solve`` takes B problems at once: x0 (B,n),
u_init (B,H,m). The K candidates of every problem roll out together as
B·K lanes. ``rollout(x0, us)`` runs R sequences per problem (R = K for
the samples, 1 or 2 for the exact re-evaluations) through the whole
horizon: us (B,R,H,m) -> xs (B,R,H+1,n) (``MPCProblem.lane_rollout``: one
``planner_rollout`` kernel launch on the card). The sums over the horizon
and over the samples are elementwise adds in a fixed order
(``models/spatial.py``), so a problem's solution does not depend on how
many problems share its batch.

The bfloat16 sample path of the JAX solver (``sample_dtype``) is not
ported: it cost solution quality.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from quadruped_springs_tpu_torch.models import spatial as sp


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    horizon: int = 50
    iterations: int = 10
    n_samples: int = 64          # K rollouts per iteration
    sigma: float = 0.3           # exploration std in action units
    sigma_decay: float = 0.93    # annealing: σ_i = σ·decay^i
    temperature: float = 0.05    # λ: softmax sharpness over costs
    smooth: bool = True          # time-correlated (low-passed) noise
    elite_frac: float = 0.5      # weights over the best fraction only
    u_min: float = -1.0
    u_max: float = 1.0
    # Fold the accept/reject rollout into the next iteration's candidates
    # (candidate 0 = the unperturbed proposal) and settle proposal vs best
    # with one exact evaluation of each after the loop.
    fused_accept: bool = False


@dataclasses.dataclass(frozen=True)
class MPPISolution:
    us: torch.Tensor          # (B,H,m) updated control sequences
    xs: torch.Tensor          # (B,H+1,n) rollouts of us
    cost: torch.Tensor        # (B,) costs of us
    cost_trace: torch.Tensor  # (B,iterations)


_LP_A, _LP_B = 0.7, 0.3      # first-order low-pass of the exploration noise


def _smooth_noise(eps):
    """Low-pass (B,K,H,m) noise along H, renormalised exactly per step:
    Var(c_t) = b²(1-a^{2(t+1)})/(1-a²)·σ², so dividing by its square root
    restores the marginal std at every horizon step."""
    a, b = _LP_A, _LP_B
    c = torch.zeros_like(eps[:, :, 0])
    steps = []
    for t in range(eps.shape[2]):
        c = a * c + b * eps[:, :, t]
        steps.append(c)
    t = torch.arange(eps.shape[2], dtype=eps.dtype, device=eps.device)
    norm = b * torch.sqrt((1.0 - a ** (2.0 * (t + 1.0))) / (1.0 - a * a))
    return torch.stack(steps, dim=2) / norm[:, None]


def solve(rollout: Callable, stage_cost: Callable, terminal_cost: Callable,
          x0: torch.Tensor, u_init: torch.Tensor, config: MPPIConfig = MPPIConfig(),
          generator: torch.Generator | None = None,
          noise: torch.Tensor | None = None) -> MPPISolution:
    """Minimize Σ l(x,u,t) + lf(x_H) for B problems by iterated
    importance-weighted sampling.

    x0: (B,n). u_init: (B,H,m). `noise` optionally gives the standard-normal
    draws, (iterations,B,K,H,m); otherwise each iteration draws them from
    `generator` on x0's device.
    """
    B, H, m = u_init.shape
    K = config.n_samples
    n_elite = max(int(K * config.elite_frac), 1)
    dev, dtype = x0.device, x0.dtype
    clip_u = lambda u: torch.clamp(u, config.u_min, config.u_max)
    ts = torch.arange(H, device=dev)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    if noise is not None and noise.shape != (config.iterations, B, K, H, m):
        raise ValueError(f"noise shape {tuple(noise.shape)}, expected "
                         f"{(config.iterations, B, K, H, m)}")

    def rollout_cost(us):
        """us (B,R,H,m) -> xs (B,R,H+1,n), costs (B,R)."""
        xs = rollout(x0, us)
        cost = sp.sum_fixed(stage_cost(xs[:, :, :-1], us, ts)) + terminal_cost(xs[:, :, -1])
        return xs, cost

    def perturbation(i):
        draw = noise[i] if noise is not None else torch.randn(
            (B, K, H, m), generator=generator, device=dev, dtype=dtype)
        eps = sigmas[i] * draw
        return _smooth_noise(eps) if config.smooth else eps

    def softmax_update(costs, cand):
        """Elite-truncated importance weights (robust to diverged samples)
        and the clipped weighted mean of the candidates."""
        kth = torch.sort(costs, dim=-1).values[:, n_elite - 1:n_elite]
        beta = costs.min(dim=-1, keepdim=True).values
        w = torch.exp(-(costs - beta) / config.temperature)
        w = torch.where(costs <= kth, w, torch.zeros_like(w))
        w = w / torch.clamp_min(sp.sum_fixed(w), 1e-12)[:, None]
        return clip_u(sp.sum_fixed(w[:, :, None, None] * cand, 1))

    us0 = clip_u(u_init)
    sigmas = config.sigma * config.sigma_decay ** torch.arange(
        config.iterations, dtype=dtype, device=dev)
    trace = []
    if config.fused_accept:
        us_prop, us_best = us0, us0
        cost_best = inf.expand(B)
        rows = torch.arange(B, device=dev)
        for i in range(config.iterations):
            eps = perturbation(i)
            eps = torch.cat([torch.zeros_like(eps[:, :1]), eps[:, 1:]], dim=1)
            cand = clip_u(us_prop[:, None] + eps)
            _, costs = rollout_cost(cand)
            costs = torch.where(torch.isfinite(costs), costs, inf)
            ib = torch.argmin(costs, dim=-1)
            c_ib = costs[rows, ib]
            better = c_ib < cost_best
            us_best = torch.where(better[:, None, None], cand[rows, ib], us_best)
            cost_best = torch.where(better, c_ib, cost_best)
            us_prop = softmax_update(costs, cand)
            trace.append(cost_best)
        # settle proposal vs best with the exact dynamics, both in one rollout
        xs_pb, cost_pb = rollout_cost(torch.stack([us_prop, us_best], dim=1))
        take_b = cost_pb[:, 1] < cost_pb[:, 0]
        us = torch.where(take_b[:, None, None], us_best, us_prop)
        xs = torch.where(take_b[:, None, None], xs_pb[:, 1], xs_pb[:, 0])
        cost = torch.where(take_b, cost_pb[:, 1], cost_pb[:, 0])
        return MPPISolution(us=us, xs=xs, cost=cost, cost_trace=torch.stack(trace, -1))

    _, cost = rollout_cost(us0[:, None])
    cost = cost[:, 0]
    us = us0
    for i in range(config.iterations):
        cand = clip_u(us[:, None] + perturbation(i))
        _, costs = rollout_cost(cand)
        costs = torch.where(torch.isfinite(costs), costs, inf)
        us_new = softmax_update(costs, cand)
        _, cost_new = rollout_cost(us_new[:, None])
        better = cost_new[:, 0] < cost
        us = torch.where(better[:, None, None], us_new, us)
        cost = torch.where(better, cost_new[:, 0], cost)
        trace.append(cost)
    xs, _ = rollout_cost(us[:, None])
    return MPPISolution(us=us, xs=xs[:, 0], cost=cost, cost_trace=torch.stack(trace, -1))
