"""MPC cost models, batched over leading dimensions.

Port of ``quadruped_springs_tpu.tasks.costs`` for the planner slice:
JUMPING_IN_PLACE and the shared base stage cost. ``stage_cost(x, u, t)``
takes x (..., 37), u (..., m) and t broadcastable to x's leading shape;
``terminal_cost(x)`` takes x (..., 37). State layout as in solver/mpc.py:
[pos(3), quat(4), v(3), w(3), q(12), qd(12)].
"""

from __future__ import annotations

import torch

from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.models.go1_params import Go1Config

_G = 9.81


def _pos(x):
    return x[..., 0:3]


def _quat(x):
    return x[..., 3:7]


def _vel(x):
    return x[..., 7:10]


def _qd(x):
    return x[..., 25:37]


def _apex_height(x):
    """Predicted ballistic apex: z + max(vz,0)²/2g."""
    return _pos(x)[..., 2] + torch.clamp_min(_vel(x)[..., 2], 0.0) ** 2 / (2 * _G)


def _pitch(x):
    return sp.quat_to_rpy(_quat(x))[..., 1]


def _upright(x):
    """1 - local_up·ẑ (0 when upright, 2 when inverted)."""
    return 1.0 - sp.quat_to_mat(_quat(x))[..., 2, 2]


def make_cost(task: str, cfg: Go1Config, action_dim: int, horizon: int):
    """Return (stage_cost, terminal_cost) for a task key.

    Only JUMPING_IN_PLACE (and its aliases) is ported; the other tasks of
    the JAX module are still to port (ROADMAP queue 1, item 6).
    """
    w_u = 1e-2          # control smoothness / magnitude
    w_qd = 2e-4         # joint-velocity damping

    def base_stage(x, u, t):
        return w_u * torch.sum(u * u, dim=-1) + w_qd * torch.sum(_qd(x) ** 2, dim=-1)

    if task.startswith("JUMPING_IN_PLACE") or task in ("JIP_PPO",):
        w_h, w_x, w_pitch, w_up = 60.0, 8.0, 4.0, 10.0

        def stage(x, u, t):
            return (base_stage(x, u, t)
                    - (w_h / horizon) * 0.5 * _apex_height(x)
                    + 0.15 * w_x * _pos(x)[..., 0] ** 2
                    + 0.15 * w_pitch * _pitch(x) ** 2)

        def terminal(x):
            return (-w_h * _apex_height(x)
                    + w_x * _pos(x)[..., 0] ** 2
                    + w_pitch * _pitch(x) ** 2
                    + w_up * _upright(x))

        return stage, terminal

    raise KeyError(f"task {task!r}: the port has only JUMPING_IN_PLACE so far; "
                   "the other task costs are still to port (ROADMAP queue 1, item 6)")
