"""Control interfaces: policy action [-1,1]^d <-> motor command.

Port of ``quadruped_springs_tpu.control.interfaces``. Transforms broadcast
over leading dimensions: an action is (..., action_dim), a command
(..., 12). For CARTESIAN_PD the interface-space command is foot positions
in the leg frames, turned into joint angles by the analytic IK of
``models/kinematics.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from quadruped_springs_tpu_torch.models import kinematics as kin
from quadruped_springs_tpu_torch.models.go1_params import NUM_MOTORS, Go1Config

MOTOR_MODES = ("PD", "CARTESIAN_PD", "TORQUE")
ACTION_MODES = ("DEFAULT", "SYMMETRIC", "SYMMETRIC_NO_HIP")
_ACTION_DIMS = {"DEFAULT": 12, "SYMMETRIC": 6, "SYMMETRIC_NO_HIP": 4}


@dataclasses.dataclass(frozen=True)
class ControlInterface:
    motor_control_mode: str
    action_space_mode: str
    action_dim: int
    symm_idx: int
    lower_lim: torch.Tensor       # (12,) command-space lower bound
    upper_lim: torch.Tensor       # (12,)
    init_pose: torch.Tensor       # (12,) command-space init reference
    settling_pose: torch.Tensor   # (12,)
    landing_pose: torch.Tensor    # (12,)


def make_interface(cfg: Go1Config, motor_control_mode: str = "PD",
                   action_space_mode: str = "SYMMETRIC",
                   task_env: str = "NO_TASK") -> ControlInterface:
    if motor_control_mode not in MOTOR_MODES:
        raise ValueError(f"unknown motor control mode {motor_control_mode}")
    if action_space_mode not in ACTION_MODES:
        raise ValueError(f"unknown action space mode {action_space_mode}")

    if motor_control_mode == "PD":
        lower = cfg.rl_lower_angle_joint
        upper = cfg.rl_upper_angle_joint
        if task_env == "BACKFLIP":
            # raise the rear-thigh upper limits (indices 7: RR, 10: RL)
            upper = upper.clone()
            upper[[7, 10]] = math.pi / 2
        init, settling, landing = (cfg.init_joint_angles, cfg.angle_settling_pose,
                                   cfg.angle_landing_pose)
        symm_idx = 0
    elif motor_control_mode == "CARTESIAN_PD":
        lower = cfg.rl_lower_cartesian_pos
        upper = cfg.rl_upper_cartesian_pos
        init, settling, landing = (cfg.nominal_foot_pos, cfg.cartesian_settling_pose,
                                   cfg.cartesian_landing_pose)
        symm_idx = 1
    else:  # TORQUE
        lower = -cfg.torque_limits
        upper = cfg.torque_limits
        init = torch.zeros(NUM_MOTORS, dtype=upper.dtype, device=upper.device)
        settling = landing = init
        symm_idx = 0

    return ControlInterface(
        motor_control_mode=motor_control_mode,
        action_space_mode=action_space_mode,
        action_dim=_ACTION_DIMS[action_space_mode],
        symm_idx=symm_idx,
        lower_lim=lower,
        upper_lim=upper,
        init_pose=init,
        settling_pose=settling,
        landing_pose=landing,
    )


def _clip(x, lo, hi):
    """x clipped to [lo, hi] (tensors). Written as min(max(x, lo), hi)
    because its derivative at a tie is then one half, as jax.numpy.clip's
    is, where torch.clamp's is one: the jumping tasks' warm starts sit at
    actions of exactly ±1, and the iLQR linearization there must agree with
    the JAX package's."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _clip_unit(a):
    one = torch.ones_like(a)
    return _clip(a, -one, one)


def scale_action_to_command(iface: ControlInterface, a12):
    a = _clip_unit(a12)
    cmd = iface.lower_lim + 0.5 * (a + 1.0) * (iface.upper_lim - iface.lower_lim)
    return _clip(cmd, iface.lower_lim, iface.upper_lim)


def scale_command_to_action(iface: ControlInterface, cmd):
    c = _clip(cmd, iface.lower_lim, iface.upper_lim)
    a = -1.0 + 2.0 * (c - iface.lower_lim) / (iface.upper_lim - iface.lower_lim)
    return _clip_unit(a)


@functools.lru_cache(maxsize=None)
def _mirror_on(symm_idx: int, device: torch.device, dtype: torch.dtype):
    # made once per device: writing the -1 into a device tensor at every call
    # copies it from the host, which synchronises the stream
    mirror = np.ones(3)
    mirror[symm_idx] = -1.0
    return torch.as_tensor(mirror, dtype=dtype, device=device)


def _mirror(iface: ControlInterface, like):
    return _mirror_on(iface.symm_idx, like.device, like.dtype)


def expand_action(iface: ControlInterface, action):
    """(..., action_dim) -> (..., 12) default action."""
    mode = iface.action_space_mode
    if mode == "DEFAULT":
        return action
    if mode == "SYMMETRIC":
        mirror = _mirror(iface, action)
        fr, rr = action[..., 0:3], action[..., 3:6]
        return torch.cat([fr, fr * mirror, rr, rr * mirror], dim=-1)
    # SYMMETRIC_NO_HIP: a zero at symm_idx, the same action left and right
    zero = torch.zeros_like(action[..., :1])
    i = iface.symm_idx

    def ins(v):
        return torch.cat([v[..., :i], zero, v[..., i:]], dim=-1)

    fr, rr = ins(action[..., 0:2]), ins(action[..., 2:4])
    return torch.cat([fr, fr, rr, rr], dim=-1)


def contract_action(iface: ControlInterface, action12):
    """(..., 12) -> (..., action_dim)."""
    mode = iface.action_space_mode
    if mode == "DEFAULT":
        return action12
    fr, rr = action12[..., 0:3], action12[..., 6:9]
    if mode == "SYMMETRIC":
        return torch.cat([fr, rr], dim=-1)
    keep = [i for i in range(3) if i != iface.symm_idx]
    return torch.cat([fr[..., keep], rr[..., keep]], dim=-1)


def action_to_command(iface: ControlInterface, action):
    """Policy action (..., action_dim) -> motor command (..., 12): desired
    joint angles for PD and, through the IK, for CARTESIAN_PD; raw torques
    for TORQUE."""
    cmd = scale_action_to_command(iface, expand_action(iface, action))
    if iface.motor_control_mode == "CARTESIAN_PD":
        cmd = kin.inverse_kinematics_flat(cmd)
    return cmd


# the robot-level command (joint angles, or torques for TORQUE) is what
# action_to_command returns
action_to_robot_command = action_to_command


def command_to_action(iface: ControlInterface, command):
    """Motor command (..., 12) in interface space -> policy action (for
    CARTESIAN_PD the command is foot positions)."""
    return contract_action(iface, scale_command_to_action(iface, command))


def reference_to_command(iface: ControlInterface, reference):
    """Project a reference pose onto the achievable command set."""
    return action_to_command(iface, command_to_action(iface, reference))


def init_action(iface: ControlInterface):
    """Action that drives the robot toward the init pose."""
    return command_to_action(iface, iface.init_pose)


def landing_action(iface: ControlInterface):
    return command_to_action(iface, iface.landing_pose)


def settling_action(iface: ControlInterface):
    return command_to_action(iface, iface.settling_pose)
