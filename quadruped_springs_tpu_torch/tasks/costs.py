"""MPC cost models, batched over leading dimensions.

Port of ``quadruped_springs_tpu.tasks.costs``: every task key of the JAX
module (JUMPING_IN_PLACE, JUMPING_FORWARD, CONTINUOUS_JUMPING_FORWARD* with
its ``overrides``, BACKFLIP, RECOVERY and the NO_TASK fallback).
``stage_cost(x, u, t)`` takes x (..., 37), u (..., m) and t broadcastable to
x's leading shape; ``terminal_cost(x)`` takes x (..., 37). State layout as in
solver/mpc.py: [pos(3), quat(4), v(3), w(3), q(12), qd(12)]. The JAX module
holds the reasons for each weight.
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_springs_tpu_torch.models import dynamics as dyn
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.models.go1_params import Go1Config, build_model

_G = 9.81


def _pos(x):
    return x[..., 0:3]


def _quat(x):
    return x[..., 3:7]


def _vel(x):
    return x[..., 7:10]


def _omega(x):
    return x[..., 10:13]


def _q(x):
    return x[..., 13:25]


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


def _posture(cfg: Go1Config, x):
    return sp.sum_fixed((_q(x) - cfg.init_joint_angles) ** 2)


def _body_pitch_rate(x):
    """ω_y in the base frame."""
    return sp.quat_rotate_inv(_quat(x), _omega(x))[..., 1]


# The families the cost instantiation of the planner's rollout computes on
# the card (csrc/task_cost.cuh): every task MPPI's callers plan with.
# RECOVERY (its knee and trunk sites need the kinematics) and NO_TASK keep
# their PyTorch cost on every device.
KERNEL_FAMILIES = ("JUMPING_IN_PLACE", "JUMPING_FORWARD", "CONTINUOUS_JUMPING_FORWARD",
                   "BACKFLIP")
# each family's weights: JUMPING_IN_PLACE (w_h, w_x, w_pitch, w_up),
# JUMPING_FORWARD (w_h, w_fwd, w_pitch, w_up), CONTINUOUS_JUMPING_FORWARD
# (w_v, w_h, w_pitch, w_y, w_up, z_ref, v_ref; `overrides` may set z_ref,
# v_ref, w_v, w_h), BACKFLIP (w_h, w_rot, w_x, target apex)
_WEIGHTS = {"JUMPING_IN_PLACE": (60.0, 8.0, 4.0, 10.0),
            "JUMPING_FORWARD": (40.0, 30.0, 4.0, 10.0),
            "CONTINUOUS_JUMPING_FORWARD": (12.0, 20.0, 3.0, 4.0, 8.0, 0.48, 2.2),
            "BACKFLIP": (30.0, 25.0, 4.0, 0.7)}
_W_U, _W_QD = 1e-2, 2e-4   # control magnitude, joint-velocity damping


def cost_family(task: str) -> str | None:
    """The task's family of KERNEL_FAMILIES, or None (RECOVERY, NO_TASK)."""
    if task.startswith("JUMPING_IN_PLACE") or task == "JIP_PPO":
        return "JUMPING_IN_PLACE"
    if task.startswith("JUMPING_FORWARD") or task == "JF_PPO":
        return "JUMPING_FORWARD"
    for family in KERNEL_FAMILIES[2:]:
        if task.startswith(family):
            return family
    return None


def _continuous_weights(overrides: dict | None):
    w_v, w_h, w_pitch, w_y, w_up, z_ref, v_ref = _WEIGHTS["CONTINUOUS_JUMPING_FORWARD"]
    ov = overrides or {}
    return (float(ov.get("w_v", w_v)), float(ov.get("w_h", w_h)), w_pitch, w_y, w_up,
            float(ov.get("z_ref", z_ref)), float(ov.get("v_ref", v_ref)))


def kernel_weights(task: str, horizon: int, overrides: dict | None = None):
    """(family index into KERNEL_FAMILIES, constants) of the task's cost as
    the rollout's cost kernel reads them, or None outside KERNEL_FAMILIES.
    The constants are make_cost's, each product of Python numbers taken in
    double as make_cost's expressions take it, then rounded to float32 as
    PyTorch rounds a scalar operand; a division by a number is a product
    with its reciprocal (taken in double, rounded to float32), as PyTorch's
    CUDA kernels divide a tensor by a Python number. The first four of
    every family: w_u, w_qd, 1/(2g), 1/g."""
    family = cost_family(task)
    if family is None:
        return None
    rcp = lambda v: float(np.float32(1.0 / v))
    if family == "JUMPING_IN_PLACE":
        w_h, w_x, w_pitch, w_up = _WEIGHTS[family]
        consts = ((w_h / horizon) * 0.5, 0.15 * w_x, 0.15 * w_pitch,
                  -w_h, w_x, w_pitch, w_up)
    elif family == "JUMPING_FORWARD":
        w_h, w_fwd, w_pitch, w_up = _WEIGHTS[family]
        consts = (0.15 * w_pitch, 2.0, -w_h, w_fwd, w_pitch, w_up)
    elif family == "CONTINUOUS_JUMPING_FORWARD":
        w_v, w_h, w_pitch, w_y, w_up, z_ref, v_ref = _continuous_weights(overrides)
        consts = (v_ref, w_v * 0.25, w_pitch, w_up, 0.28, 600.0, w_y,
                  w_h, z_ref, w_v, w_up * 5.0)
    else:
        w_h, w_rot, w_x, target_apex = _WEIGHTS[family]
        consts = (0.2 * w_rot, w_h, target_apex, w_rot, w_x)
    head = (_W_U, _W_QD, rcp(2 * _G), rcp(_G))
    return (KERNEL_FAMILIES.index(family),
            tuple(float(np.float32(v)) for v in head + consts))


def make_cost(task: str, cfg: Go1Config, action_dim: int, horizon: int,
              overrides: dict | None = None):
    """Return (stage_cost, terminal_cost) for a task key.

    JUMPING_IN_PLACE*: apex height at x = 0 with a flat pitch.
    JUMPING_FORWARD*: apex height plus ballistic forward range.
    CONTINUOUS_JUMPING_FORWARD*: forward hopping that tracks a speed;
      `overrides` may set z_ref, v_ref, w_v, w_h.
    BACKFLIP*: 2π of pitch at a 0.7 m apex.
    RECOVERY: righting to the upright stand with knees and trunk clear of
      the ground.
    Any other key (NO_TASK): regulation to the init pose.
    """
    w_u, w_qd = _W_U, _W_QD

    def base_stage(x, u, t):
        return w_u * sp.sum_fixed(u * u) + w_qd * sp.sum_fixed(_qd(x) ** 2)

    family = cost_family(task)
    if family == "JUMPING_IN_PLACE":
        w_h, w_x, w_pitch, w_up = _WEIGHTS[family]

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

    if family == "JUMPING_FORWARD":
        w_h, w_fwd, w_pitch, w_up = _WEIGHTS[family]

        def stage(x, u, t):
            return (base_stage(x, u, t)
                    + 0.15 * w_pitch * _pitch(x) ** 2
                    + 2.0 * _pos(x)[..., 1] ** 2)

        def terminal(x):
            vx = _vel(x)[..., 0]
            vz = _vel(x)[..., 2]
            # ballistic forward range from the terminal state
            fwd = _pos(x)[..., 0] + vx * 2 * torch.clamp_min(vz, 0.0) / _G
            return (-w_h * _apex_height(x) - w_fwd * fwd
                    + w_pitch * _pitch(x) ** 2 + w_up * _upright(x))

        return stage, terminal

    if family == "CONTINUOUS_JUMPING_FORWARD":
        # forward speed is tracked, not maximized: the task caps each jump's
        # credited distance
        w_v, w_h, w_pitch, w_y, w_up, z_ref, v_ref = _continuous_weights(overrides)

        def stage(x, u, t):
            # soft base-height floor: a deeper crouch drives the calf into
            # the ground, an invalid-contact termination in the env
            z_floor = torch.clamp_min(0.28 - _pos(x)[..., 2], 0.0)
            return (base_stage(x, u, t)
                    + w_v * 0.25 * (_vel(x)[..., 0] - v_ref) ** 2
                    + w_pitch * _pitch(x) ** 2
                    + w_up * _upright(x)
                    + 600.0 * z_floor ** 2
                    + w_y * (_pos(x)[..., 1] ** 2 + _vel(x)[..., 1] ** 2))

        def terminal(x):
            return (w_h * (_apex_height(x) - z_ref) ** 2
                    + w_v * (_vel(x)[..., 0] - v_ref) ** 2
                    + w_pitch * _pitch(x) ** 2
                    + w_up * 5.0 * _upright(x))

        return stage, terminal

    if family == "BACKFLIP":
        w_h, w_rot, w_x, target_apex = _WEIGHTS[family]

        def stage(x, u, t):
            # reward pitch-back angular velocity
            return base_stage(x, u, t) - 0.2 * w_rot * (-_body_pitch_rate(x))

        def terminal(x):
            # flight-phase rotation budget: ω_y · 2 vz / g ≈ total pitch swept
            vz = torch.clamp_min(_vel(x)[..., 2], 0.0)
            swept = -_body_pitch_rate(x) * 2.0 * vz / _G
            return (w_h * (_apex_height(x) - target_apex) ** 2
                    - w_rot * swept
                    + w_x * _pos(x)[..., 0] ** 2)

        return stage, terminal

    if task == "RECOVERY":
        model = build_model(device=cfg.init_joint_angles.device)
        w_up, w_z, w_q, w_w, w_clear = 60.0, 30.0, 1.0, 0.3, 2000.0
        clear_margin = 0.01

        def bumper_violation(x):
            """Squared penetration of the knee and trunk sites into a
            clear_margin band above the ground (non-foot ground contact
            terminates the episode)."""
            flat = x.reshape(-1, x.shape[-1])
            st = dyn.RobotState(pos=_pos(flat), quat=_quat(flat), lin_vel=_vel(flat),
                                ang_vel=_omega(flat), q=_q(flat), qd=_qd(flat))
            p_w, _, radii, _ = dyn.site_state_world(model, st)
            gap = p_w[:, 4:, 2] - radii[4:] - clear_margin
            return sp.sum_fixed(torch.clamp_max(gap, 0.0) ** 2).reshape(x.shape[:-1])

        def stage(x, u, t):
            return (base_stage(x, u, t)
                    + w_up * 0.25 * _upright(x)
                    + w_z * 0.1 * (_pos(x)[..., 2] - 0.30) ** 2
                    + w_w * sp.sum_fixed(_omega(x) ** 2)
                    + w_q * 0.1 * _posture(cfg, x)
                    + w_clear * bumper_violation(x))

        def terminal(x):
            return (w_up * _upright(x)
                    + w_z * (_pos(x)[..., 2] - 0.30) ** 2
                    + w_q * _posture(cfg, x)
                    + w_w * sp.sum_fixed(_omega(x) ** 2)
                    + 0.5 * sp.sum_fixed(_vel(x) ** 2)
                    + w_clear * bumper_violation(x))

        return stage, terminal

    # NO_TASK / fallback: regulation to the init pose
    def stage(x, u, t):
        return base_stage(x, u, t) + 0.5 * _posture(cfg, x)

    def terminal(x):
        return 5.0 * _posture(cfg, x) + 20.0 * (_pos(x)[..., 2] - 0.3) ** 2

    return stage, terminal
