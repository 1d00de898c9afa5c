"""Actuation ops: PD motor model + one-sided PEA spring law.

Port of ``quadruped_springs_tpu.ops.actuation``. ``pd_torque`` and
``spring_torque`` are the plain PyTorch versions; ``actuation_torque``
computes their sum in one pass, through the CUDA kernel ``actuation`` of
``csrc/planner_ops.cu`` for CUDA tensors and through the plain versions for
CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_springs_tpu_torch import kernels
from quadruped_springs_tpu_torch.models.go1_params import NUM_MOTORS, SIDE_SIGN

# Per-motor activation sign: the spring engages where sign*(q - rest) >= 0.
# Hip: left legs +1, right legs -1; thigh +1; calf -1.
SPRING_ENGAGE_SIGN = np.stack(
    [SIDE_SIGN, np.ones(4), -np.ones(4)], axis=-1).reshape(NUM_MOTORS)


def pd_torque(q_des, q, qd, kp, kd, torque_limits, qd_des=None):
    """PD position control to torque, clipped to ±torque_limits."""
    if qd_des is None:
        qd_des = torch.zeros_like(qd)
    tau = -kp * (q - q_des) - kd * (qd - qd_des)
    return torch.clamp(tau, -torque_limits, torque_limits)


def torque_command(tau_cmd, torque_limits):
    """TORQUE mode: the commanded torque clipped to ±torque_limits."""
    return torch.clamp(tau_cmd, -torque_limits, torque_limits)


def spring_torque(q, qd, stiffness3, damping3, rest_angles3, engage_sign):
    """One-sided PEA spring torque for all 12 joints.

    q, qd: (..., 12). stiffness3/damping3/rest_angles3: (3,) or (..., 3) per
    joint type, tiled over the 4 legs along the last axis. engage_sign: (12,)
    SPRING_ENGAGE_SIGN on q's device.
    """
    k12 = torch.tile(stiffness3, (4,))
    b12 = torch.tile(damping3, (4,))
    r12 = torch.tile(rest_angles3, (4,))
    engaged = engage_sign * (q - r12) >= 0.0
    tau = -k12 * (q - r12) - b12 * qd
    return torch.where(engaged, tau, torch.zeros_like(tau))


def actuation_torque(q_des, q, qd, kp, kd, torque_limits, spring_k, spring_b,
                     rest_angles3, engage_sign):
    """Motor torque plus spring torque for N lanes: (tau_total, tau_motor).

    q_des, q, qd: (N,12). kp, kd, torque_limits, engage_sign: (12,).
    spring_k, spring_b: (N,3) per lane (zeros without springs). rest_angles3:
    (3,). CUDA tensors launch the `actuation` kernel; CPU tensors take
    pd_torque + spring_torque.
    """
    if q.device.type == "cpu":
        tau_m = pd_torque(q_des, q, qd, kp, kd, torque_limits)
        return tau_m + spring_torque(q, qd, spring_k, spring_b, rest_angles3,
                                     engage_sign), tau_m
    if q.device.type != "cuda":
        raise ValueError(f"actuation_torque: no kernel for device {q.device}")
    n = q.shape[0]
    dev = q.device
    for name, t, shape in (
            ("q_des", q_des, (n, 12)), ("q", q, (n, 12)), ("qd", qd, (n, 12)),
            ("kp", kp, (12,)), ("kd", kd, (12,)),
            ("torque_limits", torque_limits, (12,)),
            ("spring_k", spring_k, (n, 3)), ("spring_b", spring_b, (n, 3)),
            ("rest_angles3", rest_angles3, (3,)),
            ("engage_sign", engage_sign, (12,))):
        kernels.check_tensor(name, t, shape, dev)
    tau = torch.empty_like(q)
    tau_m = torch.empty_like(q)
    if n == 0:
        return tau, tau_m
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.planner_actuation(
            q_des.data_ptr(), q.data_ptr(), qd.data_ptr(), kp.data_ptr(),
            kd.data_ptr(), torque_limits.data_ptr(), spring_k.data_ptr(),
            spring_b.data_ptr(), rest_angles3.data_ptr(), engage_sign.data_ptr(),
            tau.data_ptr(), tau_m.data_ptr(), n, kernels.stream_handle(dev))
    kernels.check_launch("planner_actuation", err)
    actuation_torque.launches += 1
    return tau, tau_m


actuation_torque.launches = 0
