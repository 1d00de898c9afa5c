"""Hopf-oscillator CPG (central pattern generator).

Port of ``quadruped_springs_tpu.control.cpg``: the polar Hopf equations with
4x4 phase-coupling matrices (TROT / WALK / PACE / BOUND), integrated at
1 kHz, mapped to Cartesian foot (x, z) references, and the joint-PD plus
Cartesian-PD (JᵀF) torque law. The state is X (..., 2, 4) = [r; θ]; every
function broadcasts over leading axes.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from quadruped_springs_tpu_torch.models import kinematics as kin
from quadruped_springs_tpu_torch.models.go1_params import SIDE_SIGN, Go1Config

_PI = math.pi

# phase-coupling matrices PHI[i, j]
GAITS = {
    "TROT": np.array([[0, -_PI, -_PI, 0], [_PI, 0, 0, _PI], [_PI, 0, 0, _PI],
                      [0, -_PI, -_PI, 0]]),
    "WALK": np.array([[0, -_PI, -_PI / 2, _PI / 2], [_PI, 0, _PI / 2, 3 * _PI / 2],
                      [_PI / 2, -_PI / 2, 0, _PI], [-_PI / 2, -3 * _PI / 2, -_PI, 0]]),
    "BOUND": np.array([[0, 0, -_PI, -_PI], [0, 0, -_PI, -_PI], [_PI, _PI, 0, 0],
                       [_PI, _PI, 0, 0]]),
    "PACE": np.array([[0, -_PI, 0, -_PI], [_PI, 0, _PI, 0], [0, -_PI, 0, -_PI],
                      [_PI, 0, _PI, 0]]),
}


@functools.lru_cache(maxsize=None)
def _gait_on(gait: str, device: torch.device):
    """(Φ, 1 - I) on a device, made once."""
    phi = torch.as_tensor(GAITS[gait], dtype=torch.float32, device=device)
    return phi, 1.0 - torch.eye(4, device=device)


@dataclasses.dataclass(frozen=True)
class HopfParams:
    mu: float = 2.0
    omega_swing: float = 2 * _PI
    omega_stance: float = 2 * _PI
    gait: str = "TROT"
    coupling_strength: float = 1.0
    couple: bool = True
    time_step: float = 0.001
    ground_clearance: float = 0.05
    ground_penetration: float = 0.01
    robot_height: float = 0.25
    des_step_len: float = 0.04
    alpha: float = 50.0


def init_state(params: HopfParams, generator: torch.Generator, n: int | None = None):
    """X = [[r (4)], [θ (4)]] ((n, 2, 4) if n is given): r random in
    [0, 0.1), θ at the gait's offsets."""
    dev = generator.device
    lead = () if n is None else (n,)
    r0 = torch.rand((*lead, 4), generator=generator, device=dev) * 0.1
    theta0 = _gait_on(params.gait, dev)[0][0].expand(*lead, 4)
    return torch.stack([r0, theta0], dim=-2)


def cpg_update(params: HopfParams, X: torch.Tensor):
    """One integration step; returns (X_next, foot_x (..., 4), foot_z (..., 4)).

      ṙ_i = α (μ - r_i²) r_i
      θ̇_i = ω (swing or stance by sin θ) + Σ_j r_j c sin(θ_j - θ_i - Φ_ij)
    """
    r, theta = X[..., 0, :], X[..., 1, :]
    r_dot = params.alpha * (params.mu - r**2) * r
    theta_dot = torch.where(torch.sin(theta) > 0, params.omega_swing, params.omega_stance)
    if params.couple:
        phi, off_diag = _gait_on(params.gait, X.device)
        diff = theta[..., None, :] - theta[..., :, None] - phi   # [i, j] = θ_j - θ_i - Φ_ij
        theta_dot = theta_dot + (r[..., None, :] * params.coupling_strength
                                 * torch.sin(diff) * off_diag).sum(-1)
    r = r + params.time_step * r_dot
    theta = torch.remainder(theta + params.time_step * theta_dot, 2 * _PI)
    x = -params.des_step_len * r * torch.cos(theta)
    sin_t = torch.sin(theta)
    amp = torch.where(sin_t > 0, params.ground_clearance, params.ground_penetration)
    z = -params.robot_height + amp * sin_t
    return torch.stack([r, theta], dim=-2), x, z


def cpg_torques(cfg: Go1Config, q, qd, foot_x, foot_z, foot_y: float = 0.0838,
                kp_joint=None, kd_joint=None):
    """Joint-PD plus Cartesian-PD (JᵀF) torques (..., 12):

    τ = kp (q_des - q) + kd (0 - q̇) + Jᵀ [kp_C (p_des - p) + kd_C (-v)]
    with q_des from the IK of the desired foot position."""
    side = torch.as_tensor(SIDE_SIGN, dtype=foot_x.dtype, device=foot_x.device)
    des_xyz = torch.stack([foot_x, (side * foot_y).expand_as(foot_x), foot_z], dim=-1)
    q_legs = q.reshape(*q.shape[:-1], 4, 3)
    qd_legs = qd.reshape(*qd.shape[:-1], 4, 3)
    q_des = kin.inverse_kinematics(des_xyz)
    kp_j = cfg.motor_kp.reshape(4, 3) if kp_joint is None else kp_joint
    kd_j = cfg.motor_kd.reshape(4, 3) if kd_joint is None else kd_joint
    tau = kp_j * (q_des - q_legs) + kd_j * (0.0 - qd_legs)
    J = kin.foot_jacobian(q_legs)
    p = kin.foot_position(q_legs)
    v = torch.einsum("...lij,...lj->...li", J, qd_legs)
    F = (torch.einsum("ab,...lb->...la", cfg.kp_cartesian, des_xyz - p)
         + torch.einsum("ab,...lb->...la", cfg.kd_cartesian, -v))
    tau = tau + torch.einsum("...lji,...lj->...li", J, F)
    return tau.reshape(q.shape)
