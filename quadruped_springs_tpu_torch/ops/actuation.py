"""Actuation ops: PD motor model + one-sided PEA spring law.

Port of ``quadruped_springs_tpu.ops.actuation``. ``pd_torque`` and
``spring_torque`` are the plain PyTorch versions; ``actuation_torque``
computes their sum in one pass, through the CUDA kernel ``actuation`` of
``csrc/planner_ops.cu`` for CUDA tensors and through the plain versions for
CPU tensors. On CUDA tensors it is a ``torch.autograd.Function`` whose
forward-mode tangent is the CUDA kernel ``actuation_jvp`` (the iLQR
linearization pushes 43 tangents through every substep); on CPU tensors
PyTorch differentiates the plain versions. Reverse mode raises. On the card
only the total torque carries a tangent: the motor's share (read by sensors
and rewards, differentiated by nothing) is marked non-differentiable, so the
memory-bound tangent kernel does not write it. bfloat16 tensors (the
bf16 linearization knot) launch the kernels' bf16 storage variants, whose
plain version is ``actuation_plain``: the f32 twin on the upcast inputs,
rounded to bf16.
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


def spring_energy(q, stiffness3, rest_angles3, engage_sign):
    """Elastic energy ½ k (q - q̄)² of the engaged springs, (..., 12) (the
    reference monitor's spring-energy plot)."""
    k12 = torch.tile(stiffness3, (4,))
    r12 = torch.tile(rest_angles3, (4,))
    engaged = engage_sign * (q - r12) >= 0.0
    return torch.where(engaged, 0.5 * k12 * (q - r12) ** 2, torch.zeros_like(q))


def actuation_plain(q_des, q, qd, kp, kd, torque_limits, spring_k, spring_b,
                    rest_angles3, engage_sign):
    """The plain version of the `actuation` kernel: (pd_torque + spring_torque,
    pd_torque). bfloat16 arguments are upcast, run through the f32 twin and
    the results rounded to bf16, as the kernel's bf16 variant computes in f32
    registers between a bf16 load and a bf16 store."""
    args = (q_des, q, qd, kp, kd, torque_limits, spring_k, spring_b, rest_angles3,
            engage_sign)
    if q.dtype == torch.bfloat16:
        return tuple(t.to(q.dtype) for t in actuation_plain(*(a.float() for a in args)))
    tau_m = pd_torque(q_des, q, qd, kp, kd, torque_limits)
    return tau_m + spring_torque(q, qd, spring_k, spring_b, rest_angles3,
                                 engage_sign), tau_m


def _check_actuation_primals(q_des, q, qd, kp, kd, torque_limits, spring_k, spring_b,
                             rest_angles3, engage_sign):
    n, dev, dtype = q.shape[0], q.device, q.dtype
    for name, t, shape in (
            ("q_des", q_des, (n, 12)), ("q", q, (n, 12)), ("qd", qd, (n, 12)),
            ("kp", kp, (12,)), ("kd", kd, (12,)),
            ("torque_limits", torque_limits, (12,)),
            ("spring_k", spring_k, (n, 3)), ("spring_b", spring_b, (n, 3)),
            ("rest_angles3", rest_angles3, (3,)),
            ("engage_sign", engage_sign, (12,))):
        kernels.check_tensor(name, t, shape, dev, dtype)
    return n, dev


def _launch_actuation(*primals):
    """Launch the `actuation` kernel on the ten arguments of
    actuation_torque: (tau, tau_motor)."""
    n, dev = _check_actuation_primals(*primals)
    q = primals[1]
    tau = torch.empty_like(q)
    tau_m = torch.empty_like(q)
    if n == 0:
        return tau, tau_m
    with torch.cuda.device(dev):
        err = kernels.entry("planner_actuation", q.dtype)(
            *(t.data_ptr() for t in primals), tau.data_ptr(), tau_m.data_ptr(), n,
            kernels.stream_handle(dev))
    kernels.check_launch("planner_actuation", err)
    if q.dtype == torch.float32:
        actuation_torque.launches += 1
    else:
        actuation_torque.bf16_launches += 1
    return tau, tau_m


def _launch_actuation_jvp(*args):
    """Launch the `actuation_jvp` kernel on the ten primal arguments and
    the tangents dq_des, dq, dqd (T,N,12): dtau (T,N,12), the tangent of
    the total torque."""
    primals, tangents = args[:10], args[10:]
    n, dev = _check_actuation_primals(*primals)
    n_tangents = tangents[1].shape[0]
    dtype = primals[1].dtype
    for name, t in zip(("dq_des", "dq", "dqd"), tangents):
        kernels.check_tensor(name, t, (n_tangents, n, 12), dev, dtype)
    dtau = torch.empty_like(tangents[1])
    if n == 0 or n_tangents == 0:
        return dtau
    with torch.cuda.device(dev):
        err = kernels.entry("planner_actuation_jvp", dtype)(
            *(t.data_ptr() for t in args), dtau.data_ptr(), n, n_tangents,
            kernels.stream_handle(dev))
    kernels.check_launch("planner_actuation_jvp", err)
    if dtype == torch.float32:
        actuation_torque.jvp_launches += 1
    else:
        actuation_torque.bf16_jvp_launches += 1
    return dtau


class _ActuationJvp(torch.autograd.Function):
    """The `actuation_jvp` kernel: ten primals, then dq_des, dq, dqd with
    the tangent directions leading, (T,N,12)."""

    @staticmethod
    def forward(*args):
        return _launch_actuation_jvp(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        tangents = kernels.stack_tangents(info, in_dims, args[10:], 10)
        dtau = _ActuationJvp.apply(*args[:10], *tangents)
        return dtau.reshape(info.batch_size, -1, *dtau.shape[1:]), 0

    @staticmethod
    def backward(ctx, *grads):
        kernels.no_backward("actuation_jvp")


class _Actuation(torch.autograd.Function):
    """The `actuation` kernel with its forward-mode rule."""

    @staticmethod
    def forward(*primals):
        return _launch_actuation(*primals)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)
        ctx.set_materialize_grads(False)   # a missing tangent stays None
        ctx.mark_non_differentiable(output[1])   # tau_motor: see the module docstring

    @staticmethod
    def jvp(ctx, dq_des, dq, dqd, *constants):
        if any(t is not None for t in constants):
            raise NotImplementedError("actuation_torque: tangents of the gains, limits "
                                      "and spring constants are not implemented")
        primals = ctx.saved_tensors
        tangents = [kernels.tangent_or_zeros(t, p)[None].contiguous()
                    for t, p in zip((dq_des, dq, dqd), primals)]
        return _ActuationJvp.apply(*primals, *tangents)[0], None

    @staticmethod
    def vmap(info, in_dims, *primals):
        kernels.no_primal_vmap("actuation_torque")

    @staticmethod
    def backward(ctx, *grads):
        kernels.no_backward("actuation_torque")


def actuation_torque(q_des, q, qd, kp, kd, torque_limits, spring_k, spring_b,
                     rest_angles3, engage_sign):
    """Motor torque plus spring torque for N lanes: (tau_total, tau_motor).

    q_des, q, qd: (N,12). kp, kd, torque_limits, engage_sign: (12,).
    spring_k, spring_b: (N,3) per lane (zeros without springs). rest_angles3:
    (3,). All float32, or all bfloat16. CUDA tensors launch the `actuation`
    kernel (and, under forward-mode differentiation, `actuation_jvp` for
    tau_total's tangent; tau_motor then carries none), of the arguments'
    storage type; CPU tensors take actuation_plain.
    """
    if q.device.type == "cpu":
        return actuation_plain(q_des, q, qd, kp, kd, torque_limits, spring_k, spring_b,
                               rest_angles3, engage_sign)
    if q.device.type != "cuda":
        raise ValueError(f"actuation_torque: no kernel for device {q.device}")
    return _Actuation.apply(q_des, q, qd, kp, kd, torque_limits, spring_k, spring_b,
                            rest_angles3, engage_sign)


actuation_torque.launches = 0            # `actuation` kernel
actuation_torque.jvp_launches = 0        # `actuation_jvp` kernel
actuation_torque.bf16_launches = 0       # their bf16 storage variants
actuation_torque.bf16_jvp_launches = 0
