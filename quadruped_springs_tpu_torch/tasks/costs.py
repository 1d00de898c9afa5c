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
    w_u = 1e-2          # control smoothness / magnitude
    w_qd = 2e-4         # joint-velocity damping

    def base_stage(x, u, t):
        return w_u * sp.sum_fixed(u * u) + w_qd * sp.sum_fixed(_qd(x) ** 2)

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

    if task.startswith("JUMPING_FORWARD") or task in ("JF_PPO",):
        w_h, w_fwd, w_pitch, w_up = 40.0, 30.0, 4.0, 10.0

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

    ov = overrides or {}

    if task.startswith("CONTINUOUS_JUMPING_FORWARD"):
        w_v, w_h, w_pitch, w_y, w_up = 12.0, 20.0, 3.0, 4.0, 8.0
        # forward speed is tracked, not maximized: the task caps each jump's
        # credited distance
        z_ref = float(ov.get("z_ref", 0.48))
        v_ref = float(ov.get("v_ref", 2.2))
        w_v = float(ov.get("w_v", w_v))
        w_h = float(ov.get("w_h", w_h))

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

    if task.startswith("BACKFLIP"):
        w_h, w_rot, w_x = 30.0, 25.0, 4.0
        target_apex = 0.7

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
