"""R substeps of the environment's 1 kHz physics in one call.

``env_substeps`` advances N environments through R substeps of actuation
(PD + spring torque, or TORQUE mode's clipped command plus the springs) and
``models/dynamics.step`` with foot-anchor stiction. On CUDA tensors it
launches the fused CUDA kernel ``env_substeps`` of ``csrc/env_step.cu`` once
(the kernel or an error: there is no fallback); on CPU tensors it runs
``env_substeps_plain``, the loop that ``QuadrupedEnv.step`` ran before the
kernel, lifted out without a change to its math. ``QuadrupedEnv.step``,
reset's settle and ``control/utils.settle_robot_by_pd`` call it.

Nothing differentiates through the environment: the wrapper raises on
inputs that require grad. The Go1's geometry (joint origins, foot radius,
trunk corners, gravity) is the fixed one of ``go1_params``; the kernel reads
the model's five per-scenario fields where ``Go1Model`` holds them, one row
per environment or one for all. The wrapper's host time is part of every
control step: it reads each argument's metadata once, allocates the outputs
and launches, and makes no other launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from quadruped_springs_tpu_torch import kernels
from quadruped_springs_tpu_torch.models import dynamics as dyn
from quadruped_springs_tpu_torch.models import go1_params as gp
from quadruped_springs_tpu_torch.models.go1_params import Go1Model
from quadruped_springs_tpu_torch.ops import actuation as act

# floats per environment of pack_model (csrc/env_lane.cuh kModelFloats)
TRUNK_FLOATS, BODY_FLOATS = 13, 13
MODEL_FLOATS = TRUNK_FLOATS + 12 * BODY_FLOATS


@dataclasses.dataclass(frozen=True)
class SubstepsOut:
    """What the R substeps leave: the new state and anchors, the last
    substep's total and motor torque (N,12), the motor torque summed over
    the substeps (N,12), and the last substep's foot normal forces (N,4),
    feet in contact (N,4) and non-foot contact (N,)."""
    robot: dyn.RobotState
    anchor: torch.Tensor
    tau: torch.Tensor
    tau_m: torch.Tensor
    tau_m_sum: torch.Tensor
    foot_forces: torch.Tensor
    feet_in_contact: torch.Tensor
    invalid_contact: torch.Tensor


def env_substeps_plain(robot: dyn.RobotState, anchor, q_des, model: Go1Model,
                       params: dyn.SimParams, kp, kd, torque_limits, velocity_limits,
                       spring_k, spring_b, rest_angles3, engage_sign, substeps: int,
                       ext_force_world=None, torque_mode: bool = False) -> SubstepsOut:
    """The plain PyTorch version of the `env_substeps` kernel: per substep the
    actuation law (actuation_plain; in TORQUE mode the clipped command plus
    the springs at zero gains) and dynamics.step with the plain contact law.
    Arguments as env_substeps."""
    zero = torch.zeros_like(kp) if torque_mode else None
    tau_m_sum = None
    for i in range(substeps):
        cmd = q_des[:, i] if q_des.dim() == 3 else q_des
        if torque_mode:
            # raw torques; the springs come from the actuation law with zero
            # PD gains, whose motor torque is then exactly 0
            tau_m = act.torque_command(cmd, torque_limits)
            tau_s, _ = act.actuation_plain(cmd, robot.q, robot.qd, zero, zero,
                                           torque_limits, spring_k, spring_b,
                                           rest_angles3, engage_sign)
            tau = tau_m + tau_s
        else:
            tau, tau_m = act.actuation_plain(cmd, robot.q, robot.qd, kp, kd, torque_limits,
                                             spring_k, spring_b, rest_angles3, engage_sign)
        robot, info = dyn.step(model, params, robot, tau, velocity_limits,
                               ext_force_world=ext_force_world, foot_anchor=anchor,
                               plain=True)
        anchor = info["new_anchor"]
        tau_m_sum = tau_m if tau_m_sum is None else tau_m_sum + tau_m
    return SubstepsOut(robot, anchor, tau, tau_m, tau_m_sum, info["foot_forces"],
                       info["feet_in_contact"], info["invalid_contact"])


def pack_model(model: Go1Model) -> torch.Tensor:
    """The per-scenario fields of `model` as one contiguous (B, MODEL_FLOATS)
    float32 tensor, B its scenario count (the planner's rows,
    solver/rollout.py; the env_substeps kernel reads the same floats from the
    fields themselves): per row the trunk's mass,
    h = m·com (the skew block of its spatial inertia) and the top-left 3x3
    of its spatial inertia, then for each leg and body its mass, local COM
    and the top-left 3x3 of its spatial inertia about the link origin."""
    ti = model.trunk_inertia6
    b = ti.shape[0]
    trunk = torch.cat([model.trunk_mass.reshape(b, 1),
                       torch.stack([ti[:, 2, 4], ti[:, 0, 5], ti[:, 1, 3]], dim=-1),
                       ti[:, :3, :3].reshape(b, 9)], dim=-1)
    legs = torch.cat([model.leg_masses[..., None], model.leg_coms,
                      model.leg_inertias6[..., :3, :3].reshape(b, 4, 3, 9)], dim=-1)
    return torch.cat([trunk, legs.reshape(b, 12 * BODY_FLOATS)], dim=-1).contiguous()


# the layout of csrc/go1_dynamics.cuh EnvConsts: (name, floats)
CONSTS_LAYOUT = (("hip", 12), ("thigh", 12), ("calf", 3), ("foot", 3), ("gravity", 3),
                 ("radii", 3), ("corners", 12), ("real_lower", 3), ("real_upper", 3),
                 ("dt", 3), ("contact", 5), ("joint_limit", 2))


@functools.lru_cache(maxsize=64)
def consts_array(params_key: tuple) -> ctypes.Array:
    """The kernel's EnvConsts as a host float array: the Go1's geometry and
    the SimParams scalars in `params_key` (dt, kn, dn, v_tol, kt, ct,
    joint-limit stiffness and damping). dt / 2 and (dt / 2)^2 are rounded
    from double, as PyTorch rounds the Python scalars of quat_integrate."""
    dt, kn, dn, v_tol, kt, ct, jl_k, jl_d = params_key
    parts = {
        "hip": gp.HIP_ORIGINS, "thigh": gp.THIGH_ORIGINS, "calf": gp.CALF_ORIGIN,
        "foot": gp.FOOT_ORIGIN, "gravity": [0.0, 0.0, -gp.GRAVITY],
        "radii": [gp.FOOT_RADIUS, dyn.KNEE_RADIUS, dyn.TRUNK_RADIUS],
        "corners": dyn.TRUNK_CORNERS, "real_lower": dyn.REAL_LOWER[:3],
        "real_upper": dyn.REAL_UPPER[:3], "dt": [dt, 0.5 * dt, (0.5 * dt) ** 2],
        "contact": [kn, dn, v_tol, kt, ct], "joint_limit": [jl_k, jl_d]}
    flat = []
    for name, count in CONSTS_LAYOUT:
        values = np.asarray(parts[name], np.float64).reshape(-1)
        assert values.size == count, name
        flat.extend(values.tolist())
    return (ctypes.c_float * len(flat))(*np.asarray(flat, np.float32).tolist())


def _params_key(params: dyn.SimParams) -> tuple:
    return tuple(float(x) for x in (
        params.dt, params.contact_stiffness, params.contact_damping, params.slip_vel_tol,
        params.tangential_stiffness, params.tangential_damping,
        params.joint_limit_stiffness, params.joint_limit_damping))


ROBOT_FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")
# the model's per-scenario fields (go1_params.SCENARIO_FIELDS) as the kernel
# reads them, and each one's shape after its B rows
MODEL_FIELDS = (("trunk_inertia6", (6, 6)), ("trunk_mass", ()), ("leg_masses", (4, 3)),
                ("leg_coms", (4, 3, 3)), ("leg_inertias6", (4, 3, 6, 6)))


def allocate_outputs(n: int, dev: torch.device) -> SubstepsOut:
    """The kernel's outputs for n environments, uninitialised and each
    contiguous; the outputs of one shape are the rows of one allocation
    (fewer calls into the allocator: a control step's host time)."""
    e = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)
    pos, lin_vel, ang_vel = e(3, n, 3).unbind(0)
    quat, foot_forces = e(2, n, 4).unbind(0)
    q, qd, tau, tau_m, tau_m_sum = e(5, n, 12).unbind(0)
    return SubstepsOut(
        robot=dyn.RobotState(pos, quat, lin_vel, ang_vel, q, qd), anchor=e(n, 4, 2), tau=tau,
        tau_m=tau_m, tau_m_sum=tau_m_sum, foot_forces=foot_forces,
        feet_in_contact=e(n, 4, dtype=torch.bool), invalid_contact=e(n, dtype=torch.bool))


def launch_args(robot: dyn.RobotState, anchor, q_des, model: Go1Model, friction, params,
                kp, kd, torque_limits, velocity_limits, spring_k, spring_b, rest_angles3,
                engage_sign, substeps: int, ext_force_world, torque_mode: bool):
    """Check every argument from its metadata (device, dtype, shape,
    contiguity; no value is read) and allocate the outputs. Returns (the
    entry point's arguments but the stream, the outputs as a SubstepsOut).
    The arguments hold raw pointers: the caller keeps every tensor alive
    until the launch is enqueued."""
    n, dev = robot.q.shape[0], robot.q.device
    if substeps < 1:
        raise ValueError(f"env_substeps: substeps {substeps}, need at least 1")
    if q_des.dim() == 3:
        q_shape, q_env, q_step = (n, substeps, 12), substeps * 12, 12
    else:
        q_shape, q_env, q_step = (n, 12), 12, 0
    fields = [(name, getattr(model, name), shape) for name, shape in MODEL_FIELDS]
    rows = fields[1][1].shape[0] if fields[1][1].dim() == 1 else -1
    if rows not in (1, n):
        raise ValueError(f"env_substeps: model rows {tuple(fields[1][1].shape)} for "
                         f"{n} environments")
    state = [getattr(robot, f) for f in ROBOT_FIELDS]
    checks = [*zip(ROBOT_FIELDS, state, ((n, 3), (n, 4), (n, 3), (n, 3), (n, 12), (n, 12))),
              ("foot_anchor", anchor, (n, 4, 2)), ("q_des", q_des, q_shape),
              ("kp", kp, (12,)), ("kd", kd, (12,)), ("torque_limits", torque_limits, (12,)),
              ("velocity_limits", velocity_limits, (12,)),
              ("rest_angles3", rest_angles3, (3,)), ("engage_sign", engage_sign, (12,)),
              ("spring_k", spring_k, (n, 3)), ("spring_b", spring_b, (n, 3)),
              ("friction", friction, (n,)),
              *((name, t, (rows, *shape)) for name, t, shape in fields)]
    ext_stride = 0
    if ext_force_world is not None:
        ext_stride = 3 if ext_force_world.dim() == 2 else 0
        checks.append(("ext_force_world", ext_force_world, (n, 3) if ext_stride else (3,)))
    kernels.check_tensors(checks, dev)
    out = allocate_outputs(n, dev)
    consts = consts_array(_params_key(params))
    r = out.robot
    args = [consts, len(consts), *(t.data_ptr() for t in state), anchor.data_ptr(),
            q_des.data_ptr(), q_env, q_step,
            *(t.data_ptr() for t in (kp, kd, torque_limits, velocity_limits, rest_angles3,
                                     engage_sign, spring_k, spring_b, friction)),
            *(t.data_ptr() for _, t, _ in fields), 0 if rows == 1 else 1,
            None if ext_force_world is None else ext_force_world.data_ptr(), ext_stride,
            *(t.data_ptr() for t in (r.pos, r.quat, r.lin_vel, r.ang_vel, r.q, r.qd,
                                     out.anchor, out.tau, out.tau_m, out.tau_m_sum,
                                     out.foot_forces, out.feet_in_contact,
                                     out.invalid_contact)),
            n, substeps, int(params.on_rack), int(params.clamp_damping), int(torque_mode)]
    return args, out


def occupancy() -> dict:
    """What the card makes of the env_substeps kernel: its registers and
    local memory a thread (cudaFuncGetAttributes), threads and shared memory
    a block, blocks and warps an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = (ctypes.c_int * 5)()
    kernels.check_launch("env_substeps_occupancy", kernels.library().env_substeps_occupancy(out))
    return {"blocks_per_sm": out[0], "threads_per_block": out[1], "registers": out[2],
            "local_bytes": out[3], "shared_bytes": out[4],
            "warps_per_sm": out[0] * out[1] // 32}


def env_substeps(robot: dyn.RobotState, anchor, q_des, model: Go1Model,
                 params: dyn.SimParams, kp, kd, torque_limits, velocity_limits,
                 spring_k, spring_b, rest_angles3, engage_sign, substeps: int,
                 ext_force_world=None, torque_mode: bool = False) -> SubstepsOut:
    """N environments through `substeps` substeps of the 1 kHz physics.

    robot: the state (N rows); anchor: (N,4,2) foot anchors, world xy.
    q_des: (N,substeps,12) joint commands, one per substep, or (N,12) held
    for all of them (PD targets; TORQUE mode: torques). kp, kd,
    torque_limits, velocity_limits, engage_sign: (12,); rest_angles3: (3,);
    spring_k, spring_b: (N,3) (zeros without springs). params: the
    SimParams, friction a float or (N,). model: its per-scenario fields
    with 1 or N rows, contiguous. ext_force_world: None, (N,3) or (3,)
    world force at the trunk origin in every substep. torque_mode: q_des are
    torques (the non-RL TORQUE interface). All float32. CUDA tensors launch
    the `env_substeps` kernel once; CPU tensors run env_substeps_plain.
    """
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in (
                *(getattr(robot, f) for f in ROBOT_FIELDS), anchor, q_des, kp, kd,
                torque_limits, velocity_limits, spring_k, spring_b, rest_angles3,
                engage_sign, ext_force_world, params.friction,
                *(getattr(model, f) for f in gp.SCENARIO_FIELDS))):
        raise ValueError("env_substeps: nothing differentiates through the environment; "
                         "call it on tensors that do not require grad")
    dev = robot.q.device
    if dev.type == "cpu":
        return env_substeps_plain(robot, anchor, q_des, model, params, kp, kd,
                                  torque_limits, velocity_limits, spring_k, spring_b,
                                  rest_angles3, engage_sign, substeps, ext_force_world,
                                  torque_mode)
    if dev.type != "cuda":
        raise ValueError(f"env_substeps: no kernel for device {dev}")
    n = robot.q.shape[0]
    friction = params.friction
    if not torch.is_tensor(friction):
        friction = torch.full((n,), float(friction), dtype=torch.float32, device=dev)
    args, out = launch_args(robot, anchor, q_des, model, friction, params, kp, kd,
                            torque_limits, velocity_limits, spring_k, spring_b,
                            rest_angles3, engage_sign, substeps, ext_force_world,
                            torque_mode)
    if n == 0:
        return out
    kernels.launch(dev, "env_substeps", kernels.library().env_substeps, args)
    env_substeps.launches += 1
    return out


env_substeps.launches = 0   # `env_substeps` kernel
