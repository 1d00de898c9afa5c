"""MPPI (model-predictive path integral) solver, batched over scenarios.

Port of ``quadruped_springs_tpu.solver.mppi``. Where the JAX solver handles
one problem and is vmapped, ``solve`` takes B problems at once: x0 (B,n),
u_init (B,H,m). The K candidates of every problem roll out together as
B·K lanes. ``rollout_cost(x0, us, q_des, states)`` runs R sequences per
problem (R = K for the samples, 1 or 2 for the exact re-evaluations)
through the whole horizon and returns their costs (B,R), and their states
where asked (``MPCProblem.cost_rollout``: one ``planner_rollout_cost``
kernel launch on the card, the task cost summed in it). Between two
rollouts one ``mppi_update`` call (``solver/mppi_update.py``: one kernel
launch on the card) turns the costs into the proposal and the next rows.
The sums over the horizon and over the samples are adds in a fixed order
(``models/spatial.py`` sum_fixed's), so a problem's solution does not
depend on how many problems share its batch.

The bfloat16 sample path of the JAX solver (``sample_dtype``) is not
ported: it cost solution quality.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from quadruped_springs_tpu_torch.control import interfaces as ci
from quadruped_springs_tpu_torch.solver import mppi_update as mu
from quadruped_springs_tpu_torch.solver.rollout import total_cost


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


def _smooth_noise(eps):
    """Low-pass (B,K,H,m) noise along H, renormalised exactly per step, as
    mppi_update does it (mppi_update.lowpass)."""
    return mu.lowpass(eps, mu.lowpass_norm(eps.shape[2], eps.dtype, eps.device))


@functools.lru_cache(maxsize=None)
def _schedule(sigma: float, decay: float, iterations: int, horizon: int, device, dtype):
    """(sigmas (iterations,), lowpass_norm (H,)) on the device, made once."""
    sigmas = sigma * decay ** torch.arange(iterations, dtype=dtype, device=device)
    return sigmas, mu.lowpass_norm(horizon, dtype, device)


def solve(rollout: Callable, stage_cost: Callable, terminal_cost: Callable,
          x0: torch.Tensor, u_init: torch.Tensor, config: MPPIConfig = MPPIConfig(),
          generator: torch.Generator | None = None,
          noise: torch.Tensor | None = None) -> MPPISolution:
    """Minimize Σ l(x,u,t) + lf(x_H) for B problems by iterated
    importance-weighted sampling, the cost summed in PyTorch
    (rollout.total_cost) over rollout(x0, us) -> xs. See solve_costed."""

    def rollout_cost(x0, us, q_des, states):
        xs = rollout(x0, us)
        return xs, total_cost(stage_cost, terminal_cost, xs, us)

    return solve_costed(rollout_cost, x0, u_init, config, generator, noise)


def solve_costed(rollout_cost: Callable, x0: torch.Tensor, u_init: torch.Tensor,
                 config: MPPIConfig = MPPIConfig(), generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None,
                 iface: ci.ControlInterface | None = None) -> MPPISolution:
    """Minimize Σ l(x,u,t) + lf(x_H) for B problems by iterated
    importance-weighted sampling.

    rollout_cost(x0, us (B,R,H,m), q_des (B,R,H,12) or None, states) ->
    (xs (B,R,H+1,n) or None unless states, costs (B,R)). x0: (B,n).
    u_init: (B,H,m). `noise` optionally gives the standard-normal draws,
    (iterations,B,K,H,m); otherwise each iteration draws them from
    `generator` on x0's device. iface: a PD interface, whose joint targets
    of the rows come with them from mppi_update (q_des), or None. Between
    two rollouts one mppi_update call does the update (on the card one
    launch).
    """
    B, H, m = u_init.shape
    K = config.n_samples
    dev, dtype = x0.device, x0.dtype
    x0 = x0.contiguous()
    if config.iterations < 1:
        raise ValueError(f"MPPI needs at least one iteration, got {config.iterations}")
    if noise is not None and noise.shape != (config.iterations, B, K, H, m):
        raise ValueError(f"noise shape {tuple(noise.shape)}, expected "
                         f"{(config.iterations, B, K, H, m)}")
    settings = mu.UpdateSettings(
        fused=config.fused_accept, smooth=config.smooth,
        n_elite=max(int(K * config.elite_frac), 1), temperature=config.temperature,
        u_min=config.u_min, u_max=config.u_max, iface=iface)
    sigmas, norm = _schedule(config.sigma, config.sigma_decay, config.iterations, H, dev, dtype)
    last = config.iterations - 1

    def draw(i):
        return noise[i].contiguous() if noise is not None else torch.randn(
            (B, K, H, m), generator=generator, device=dev, dtype=dtype)

    def update(state, i=None, **kw):
        """mppi_update; with i, the rows are iteration i's candidates."""
        if i is not None:
            kw.update(rows=mu.ROWS_CANDIDATES, draw=draw(i), sigma=sigmas[i:i + 1])
        return mu.mppi_update(state, settings, norm=norm, **kw)

    us0 = torch.clamp(u_init, config.u_min, config.u_max)
    trace = torch.empty(B, config.iterations, dtype=dtype, device=dev)
    if config.fused_accept:
        cost_best = torch.full((B,), float("inf"), dtype=dtype, device=dev)
        state, cand, q_des = update(mu.UpdateState(us0, us0.clone(), cost_best, trace), 0)
        for i in range(config.iterations):
            _, costs = rollout_cost(x0, cand, q_des, False)
            next_rows = dict(rows=mu.ROWS_BOTH) if i == last else dict(i=i + 1)
            state, cand, q_des = update(state, costs=costs, cand=cand, trace_col=i,
                                        **next_rows)
        # settle proposal vs best with the exact dynamics, both in one rollout
        xs_pb, cost_pb = rollout_cost(x0, cand, q_des, True)
        take_b = cost_pb[:, 1] < cost_pb[:, 0]
        us = torch.where(take_b[:, None, None], state.us_alt, state.us)
        xs = torch.where(take_b[:, None, None], xs_pb[:, 1], xs_pb[:, 0])
        cost = torch.where(take_b, cost_pb[:, 1], cost_pb[:, 0])
        return MPPISolution(us=us, xs=xs, cost=cost, cost_trace=state.trace)

    state, rows, q_des = update(mu.UpdateState(us0, torch.empty_like(us0),
                                               torch.empty(B, dtype=dtype, device=dev), trace),
                                rows=mu.ROWS_US)
    _, cost0 = rollout_cost(x0, rows, q_des, False)
    state.cost = cost0[:, 0]
    state, cand, q_des = update(state, 0)
    for i in range(config.iterations):
        _, costs = rollout_cost(x0, cand, q_des, False)
        state, prop, q_prop = update(state, costs=costs, cand=cand, rows=mu.ROWS_ALT)
        _, cost_new = rollout_cost(x0, prop, q_prop, False)
        next_rows = dict(rows=mu.ROWS_US) if i == last else dict(i=i + 1)
        state, cand, q_des = update(state, cost_new=cost_new[:, 0], trace_col=i, **next_rows)
    xs, _ = rollout_cost(x0, cand, q_des, True)
    return MPPISolution(us=state.us, xs=xs[:, 0], cost=state.cost, cost_trace=state.trace)
