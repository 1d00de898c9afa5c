"""Sensors (the observation space), batched over environments.

Port of ``quadruped_springs_tpu.sensors.sensors``: each of the 17 sensors is
a (name, dim, read, limits) record and a suite is an ordered tuple of
sensors (12 suites). Readings come from a ``SensorContext`` assembled once
per control step, every field with a leading N. Noise is Gaussian with the
suite's per-entry standard deviation, drawn from an explicit
``torch.Generator``; entries whose standard deviation is 0 pass through
exactly. The environment builds its suite's limit tables once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from quadruped_springs_tpu_torch.models import kinematics as kin
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.models.go1_params import NUM_LEGS, NUM_MOTORS, Go1Config

STD_COEFF = 0.01


@dataclasses.dataclass(frozen=True)
class SensorContext:
    """Everything a sensor can read, for N environments."""
    pos: torch.Tensor            # (N,3) base position, world
    quat: torch.Tensor           # (N,4) xyzw
    lin_vel: torch.Tensor        # (N,3) world
    ang_vel: torch.Tensor        # (N,3) world
    q: torch.Tensor              # (N,12)
    qd: torch.Tensor             # (N,12)
    feet_contact: torch.Tensor   # (N,4) bool
    feet_pos: torch.Tensor       # (N,12) leg frame (analytic kinematics)
    feet_vel: torch.Tensor       # (N,12)
    switched_controller: torch.Tensor  # (N,) bool, the task's landing flag
    is_jumping: torch.Tensor     # (N,) bool, the continuous-jumping flag


def make_context(state, feet_contact, switched_controller=None, is_jumping=None):
    """A SensorContext from a dynamics RobotState and the feet's contact bools."""
    fp, fv = kin.foot_pos_and_vel(state.q, state.qd)
    false = torch.zeros(state.q.shape[0], dtype=torch.bool, device=state.q.device)
    return SensorContext(
        pos=state.pos, quat=state.quat, lin_vel=state.lin_vel, ang_vel=state.ang_vel,
        q=state.q, qd=state.qd, feet_contact=feet_contact, feet_pos=fp, feet_vel=fv,
        switched_controller=false if switched_controller is None else switched_controller,
        is_jumping=false if is_jumping is None else is_jumping)


@dataclasses.dataclass(frozen=True)
class SensorSpec:
    name: str
    dim: int
    read: Callable[[SensorContext], torch.Tensor]   # -> (N, dim)
    limits: Callable[[Go1Config], tuple]            # -> numpy (high, low, noise_std)


def _arr(x):
    return np.atleast_1d(np.asarray(x, np.float64))


def _np(t):
    return t.detach().cpu().numpy().astype(np.float64)


def _col(x):
    return x[:, None]


# --- limit tables -----------------------------------------------------------

def _height_limits(cfg):
    return _arr(0.4), _arr(0.1), _arr(0.4 * STD_COEFF * 0.8)


def _joint_pos_limits(cfg):
    hi, lo = _np(cfg.rl_upper_angle_joint), _np(cfg.rl_lower_angle_joint)
    return hi, lo, np.maximum(np.abs(hi), np.abs(lo)) * STD_COEFF * 0.1


def _joint_vel_limits(cfg):
    hi = _np(cfg.rl_velocity_limits)
    return hi, -hi, hi * STD_COEFF * 0.6


def _feet_pos_limits(cfg):
    noise = np.tile([0.1, 0.05, 0.1], NUM_LEGS) * STD_COEFF
    return _np(cfg.rl_upper_cartesian_pos), _np(cfg.rl_lower_cartesian_pos), noise


def _feet_vel_limits(cfg):
    hi = np.full(NUM_MOTORS, 10.0)
    # as in the reference: the low limit of the feet velocity is minus the
    # feet *position* high limit
    return hi, -_np(cfg.rl_upper_cartesian_pos), hi * STD_COEFF


def _lin_vel_limits(cfg):
    hi = np.full(3, 5.0)
    return hi, -hi, hi * STD_COEFF * 0.8


def _ang_vel_limits(cfg):
    hi = np.full(3, 3.0)
    return hi, -hi, hi * STD_COEFF


def _quat_limits(cfg):
    one = np.ones(4)
    return one, np.zeros(4), one * STD_COEFF


def _pitch_limits(cfg):
    hi = _arr(math.pi)
    return hi, -hi, hi * STD_COEFF * 0.9


def _pitch_rate_limits(cfg):
    hi = _arr(5.0)
    return hi, -hi, hi * STD_COEFF


def _rpy_limits(cfg):
    hi = np.full(3, math.pi)
    return hi, -hi, hi * STD_COEFF


def _flag_limits(cfg):
    return _arr(1.0), _arr(0.0), _arr(0.0)


def _contact_limits(cfg):
    return np.ones(NUM_LEGS), np.zeros(NUM_LEGS), np.zeros(NUM_LEGS)


def _vel_limits_5(cfg):
    return _arr(5.0), _arr(-5.0), _arr(5.0 * STD_COEFF * 0.8)


# --- sensor registry --------------------------------------------------------

SENSORS = {
    "BooleanContact": SensorSpec(
        "BoolContatc", NUM_LEGS,  # the reference's spelling of the name
        lambda c: c.feet_contact.to(torch.float32), _contact_limits),
    "Height": SensorSpec("Height", 1, lambda c: c.pos[:, 2:3], _height_limits),
    "JointPosition": SensorSpec("Encoder", 12, lambda c: c.q, _joint_pos_limits),
    "JointVelocity": SensorSpec("JointVelocity", 12, lambda c: c.qd, _joint_vel_limits),
    "FeetPosition": SensorSpec("FeetPosition", 12, lambda c: c.feet_pos, _feet_pos_limits),
    "FeetVelocity": SensorSpec("FeetVelocity", 12, lambda c: c.feet_vel, _feet_vel_limits),
    "LinearVelocity": SensorSpec(
        "Base Linear Velocity", 3, lambda c: c.lin_vel, _lin_vel_limits),
    "AngularVelocity": SensorSpec(
        "Base Angular Velocity", 3, lambda c: c.ang_vel, _ang_vel_limits),
    "Quaternion": SensorSpec("Quaternion", 4, lambda c: c.quat, _quat_limits),
    "Pitch": SensorSpec(
        "Pitch", 1, lambda c: sp.quat_to_rpy(c.quat)[:, 1:2], _pitch_limits),
    "PitchRate": SensorSpec(
        # body-frame pitch rate
        "Pitch rate", 1, lambda c: sp.quat_rotate_inv(c.quat, c.ang_vel)[:, 1:2],
        _pitch_rate_limits),
    "OrientationRPY": SensorSpec(
        "Orientation Roll Pitch Yaw", 3, lambda c: sp.quat_to_rpy(c.quat), _rpy_limits),
    "VelocityX": SensorSpec(
        "Base Height Velocity X", 1, lambda c: c.lin_vel[:, 0:1], _vel_limits_5),
    "BaseHeightVelocity": SensorSpec(
        "Base Linear Velocity z direction", 1, lambda c: c.lin_vel[:, 2:3],
        _vel_limits_5),
    "Landing": SensorSpec(
        "is landing", 1, lambda c: _col(c.switched_controller.to(torch.float32)),
        _flag_limits),
    "Jumping": SensorSpec(
        "is jumping", 1, lambda c: _col(c.is_jumping.to(torch.float32)), _flag_limits),
    "PitchBackFlip": SensorSpec(
        "Pitch-BackFlip", 1,
        lambda c: _col(sp.pitch_unwrapped_yxz(c.quat, c.switched_controller)),
        _pitch_limits),
}

SUITES = {
    "ENCODER": ("JointPosition", "JointVelocity"),
    "ENCODER_2": ("LinearVelocity", "AngularVelocity", "JointPosition", "JointVelocity"),
    "CARTESIAN_NO_IMU": ("FeetPosition", "FeetVelocity"),
    "ARS_BASIC": ("JointPosition", "JointVelocity", "Pitch", "Height",
                  "BaseHeightVelocity"),
    "ARS_SENSOR": ("JointPosition", "JointVelocity", "Pitch", "PitchRate",
                   "Height", "BaseHeightVelocity"),
    "LANDING_SENSOR": ("JointPosition", "JointVelocity", "Pitch", "PitchRate",
                       "Height", "BaseHeightVelocity", "Landing"),
    "PPO_BASIC": ("JointPosition", "JointVelocity", "Pitch", "Height",
                  "BaseHeightVelocity", "Landing"),
    "PPO_BASIC_X": ("JointPosition", "JointVelocity", "Pitch", "Height",
                    "BaseHeightVelocity", "VelocityX", "Landing"),
    "PPO_BASIC_CONTACT": ("JointPosition", "JointVelocity", "Pitch", "Height",
                          "BaseHeightVelocity", "Landing", "BooleanContact"),
    "ARS_BACKFLIP": ("JointPosition", "JointVelocity", "Height",
                     "BaseHeightVelocity", "PitchBackFlip"),
    "PPO_BACKFLIP": ("JointPosition", "JointVelocity", "Height",
                     "BaseHeightVelocity", "PitchBackFlip", "Landing"),
    "PPO_CONTINUOUS_JUMPING_FORWARD": ("JointPosition", "JointVelocity", "Height",
                                       "BaseHeightVelocity", "Pitch", "Landing",
                                       "Jumping"),
}


def suite_specs(suite: str):
    try:
        return tuple(SENSORS[k] for k in SUITES[suite])
    except KeyError as e:
        raise KeyError(f"unknown sensor suite or sensor: {e}") from e


def obs_dim(suite: str) -> int:
    return sum(s.dim for s in suite_specs(suite))


def obs_limits(suite: str, cfg: Go1Config, device=None):
    """Concatenated (high, low, noise_std) of the suite, float32 (obs_dim,)
    tensors on `device` (cfg's by default). Reads cfg on the host, so a
    caller on a hot path builds them once (the env does, at construction)."""
    if device is None:
        device = cfg.init_joint_angles.device
    parts = [s.limits(cfg) for s in suite_specs(suite)]
    return tuple(torch.as_tensor(np.concatenate([p[i] for p in parts]),
                                 dtype=torch.float32, device=device)
                 for i in range(3))


def read_obs(suite: str, ctx: SensorContext) -> torch.Tensor:
    """Noise-free flat observation (N, obs_dim)."""
    return torch.cat([s.read(ctx) for s in suite_specs(suite)], dim=-1)


def add_obs_noise(clean: torch.Tensor, noise_std: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """clean plus Gaussian noise of per-entry std `noise_std`, drawn from
    `generator` (on clean's device); entries of std 0 pass through exactly."""
    noise = torch.randn(clean.shape, generator=generator, device=clean.device,
                        dtype=clean.dtype)
    return clean + noise * noise_std


def read_noisy_obs(suite: str, cfg: Go1Config, ctx: SensorContext,
                   generator: torch.Generator) -> torch.Tensor:
    """Flat observation plus Gaussian noise of the suite's std, drawn from
    `generator` (on the observation's device)."""
    clean = read_obs(suite, ctx)
    return add_obs_noise(clean, obs_limits(suite, cfg, clean.device)[2], generator)
