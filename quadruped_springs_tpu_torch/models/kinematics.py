"""Analytic leg kinematics in the leg (hip) frame: FK, Jacobian, IK.

Port of ``quadruped_springs_tpu.models.kinematics``: the closed-form per-leg
model with hip link l1 = 0.0847 that control and observations use. It is
not the dynamics tree of ``models/dynamics.py`` (hip and thigh offsets of
the URDF), and the two are kept apart on purpose. Functions broadcast over
leading dimensions; legs are FR, FL, RR, RL, with side sign -1 for the
right legs.
"""

from __future__ import annotations

import functools

import torch

from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.models.go1_params import (
    CALF_LINK_LENGTH,
    HIP_LINK_LENGTH,
    SIDE_SIGN,
    THIGH_LINK_LENGTH,
)

_L1 = HIP_LINK_LENGTH
_L2 = THIGH_LINK_LENGTH
_L3 = CALF_LINK_LENGTH


@functools.lru_cache(maxsize=None)
def _side_sign_on(device: torch.device, dtype: torch.dtype):
    # made once per device: a host -> device copy per call would stall the stream
    return torch.as_tensor(SIDE_SIGN, dtype=dtype, device=device)


def _side_sign(like):
    return _side_sign_on(like.device, like.dtype)


def _trig(q_legs):
    s1, s2, s3 = torch.sin(q_legs).unbind(-1)
    c1, c2, c3 = torch.cos(q_legs).unbind(-1)
    return s1, s2, s3, c1, c2, c3, c2 * c3 - s2 * s3, s2 * c3 + c2 * s3


def foot_position(q_legs, side_sign=None):
    """(..., 4, 3) joint angles [hip, thigh, calf] -> (..., 4, 3) foot xyz."""
    if side_sign is None:
        side_sign = _side_sign(q_legs)
    s1, s2, s3, c1, c2, c3, c23, s23 = _trig(q_legs)
    x = -_L3 * s23 - _L2 * s2
    y = _L1 * side_sign * c1 + _L3 * s1 * c23 + _L2 * c2 * s1
    z = _L1 * side_sign * s1 - _L3 * c1 * c23 - _L2 * c1 * c2
    return torch.stack([x, y, z], dim=-1)


def foot_jacobian(q_legs, side_sign=None):
    """(..., 4, 3) -> (..., 4, 3, 3) d(foot position)/dq per leg."""
    if side_sign is None:
        side_sign = _side_sign(q_legs)
    s1, s2, s3, c1, c2, c3, c23, s23 = _trig(q_legs)
    zero = torch.zeros_like(s1)
    rows = [
        [zero, -_L3 * c23 - _L2 * c2, -_L3 * c23],
        [-side_sign * _L1 * s1 + _L2 * c2 * c1 + _L3 * c23 * c1,
         -_L2 * s2 * s1 - _L3 * s23 * s1, -_L3 * s23 * s1],
        [side_sign * _L1 * c1 + _L2 * c2 * s1 + _L3 * c23 * s1,
         _L2 * s2 * c1 + _L3 * s23 * c1, _L3 * s23 * c1],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def foot_pos_and_vel(q, qd):
    """Feet positions and velocities, flat (..., 12) in and out."""
    q_legs = q.reshape(q.shape[:-1] + (4, 3))
    qd_legs = qd.reshape(qd.shape[:-1] + (4, 3))
    pos = foot_position(q_legs)
    vel = sp.mv(foot_jacobian(q_legs), qd_legs)
    return pos.reshape(q.shape), vel.reshape(q.shape)


def inverse_kinematics(foot_xyz, side_sign=None):
    """Closed-form leg IK: (..., 4, 3) foot positions -> joint angles."""
    if side_sign is None:
        side_sign = _side_sign(foot_xyz)
    x, y, z = foot_xyz.unbind(-1)
    D = (y**2 + z**2 - _L1**2 + x**2 - _L2**2 - _L3**2) / (2 * _L3 * _L2)
    D = torch.clamp(D, -1.0, 1.0)
    sqrt1mD2 = torch.sqrt(torch.clamp_min(1.0 - D**2, 1e-12))
    wrist = torch.atan2(-sqrt1mD2, D)
    sqrt_comp = torch.clamp_min(y**2 + z**2 - _L1**2, 0.0)
    sqrt_comp_s = torch.sqrt(torch.clamp_min(sqrt_comp, 1e-12)) * (sqrt_comp > 0)
    shoulder = -torch.atan2(z, y) - torch.atan2(sqrt_comp_s, side_sign * _L1)
    elbow = torch.atan2(-x, sqrt_comp_s) - torch.atan2(
        _L3 * torch.sin(wrist), _L2 + _L3 * torch.cos(wrist))
    return torch.stack([-shoulder, elbow, wrist], dim=-1)


def inverse_kinematics_flat(foot_pos_flat):
    """(..., 12) -> (..., 12)."""
    legs = foot_pos_flat.reshape(foot_pos_flat.shape[:-1] + (4, 3))
    return inverse_kinematics(legs).reshape(foot_pos_flat.shape)
