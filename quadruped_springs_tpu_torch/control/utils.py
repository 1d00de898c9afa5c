"""Control-interface utilities.

Port of ``quadruped_springs_tpu.control.utils``: joint configurations from a
base height or pitch, and a joint-PD settle to the init pose that works in
any motor control mode.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_springs_tpu_torch.env import randomizers as rnd
from quadruped_springs_tpu_torch.models import kinematics as kin
from quadruped_springs_tpu_torch.models.go1_params import (
    NUM_LEGS,
    THIGH_LINK_LENGTH,
    X_OFFSET,
)


def find_config_from_height(des_height: torch.Tensor) -> torch.Tensor:
    """Joint configuration (..., 12) putting the base at des_height (...)
    with the feet under the hips: q = [0, arccos(h / 2L), -2·q_thigh]·4."""
    des_height = torch.as_tensor(des_height, dtype=torch.float32)
    q_thigh = torch.arccos(des_height / (2 * THIGH_LINK_LENGTH))
    q = torch.stack([torch.zeros_like(q_thigh), q_thigh, -2.0 * q_thigh], dim=-1)
    return q.repeat(*([1] * (q.dim() - 1)), NUM_LEGS)


def des_feet_pos_from_pitch(phi_des: torch.Tensor, feet_pos: torch.Tensor) -> torch.Tensor:
    """Desired leg-frame foot positions (..., 12) giving the base pitch
    phi_des (...) while the feet stay on the ground; feet_pos (..., 12) are
    the current ones (FR, FL, RR, RL xyz)."""
    phi_des = torch.as_tensor(phi_des, dtype=feet_pos.dtype, device=feet_pos.device)
    r = X_OFFSET
    c, s = torch.cos(phi_des), torch.sin(phi_des)
    front = torch.stack([r - r * c, torch.zeros_like(c), r * s], dim=-1)
    rear = torch.stack([-r + r * c, torch.zeros_like(c), -r * s], dim=-1)
    return torch.cat([front, front, rear, rear], dim=-1) + feet_pos


def pose_from_pitch(phi_des, q: torch.Tensor) -> torch.Tensor:
    """Joint angles (..., 12) giving the base pitch phi_des from the stance
    of q (..., 12): desired foot targets through the IK."""
    legs = q.shape[:-1] + (4, 3)
    feet_pos = kin.foot_position(q.reshape(legs)).reshape(q.shape)
    des = des_feet_pos_from_pitch(phi_des, feet_pos)
    return kin.inverse_kinematics(des.reshape(legs)).reshape(q.shape)


@torch.no_grad()
def settle_robot_by_pd(env, generator: torch.Generator, n: int = 1, steps: int = 1500,
                       kp=None, kd=None):
    """Joint-PD settle of N robots to the init pose whatever the env's motor
    mode, after a reset; returns the settled EnvState. On the card the
    `steps` substeps are one launch of the `env_substeps` kernel."""
    state, _ = env.reset(generator, n)
    cfg = env.cfg
    kp = cfg.motor_kp if kp is None else kp
    kd = cfg.motor_kd if kd is None else kd
    if steps == 0:
        return state
    model = rnd.model_from_params(state.scenario)
    params = env._scenario_sim_params(state.scenario)
    q_des = cfg.init_joint_angles.expand(state.robot.q.shape).contiguous()
    out = env.physics(state.robot, state.foot_anchor, q_des, model, params,
                      env._springs(state.scenario), kp, kd, steps)
    robot, anchor = out.robot, out.anchor
    return dataclasses.replace(state, robot=robot, foot_anchor=anchor)
