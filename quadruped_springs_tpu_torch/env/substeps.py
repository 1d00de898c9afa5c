"""R substeps of the environment's 1 kHz physics in one call.

``env_substeps`` advances N environments through R substeps of actuation
(PD + spring torque, or TORQUE mode's clipped command plus the springs) and
``models/dynamics.step`` with foot-anchor stiction. On CUDA tensors it
launches the fused CUDA kernel ``env_substeps`` of ``csrc/env_step.cu`` once
(the kernel or an error: there is no fallback); on CPU tensors it runs
``env_substeps_plain``, the loop that ``QuadrupedEnv.step`` ran before the
kernel, lifted out without a change to its math. ``QuadrupedEnv.step``,
reset's settle and ``control/utils.settle_robot_by_pd`` call it.

Reverse mode: the state (the six RobotState fields), the anchors and the
commands may require grad, as the JAX package's ``jax.value_and_grad``
through ``env.step`` differentiates them
(scripts/train_backflip_landing_mlp.py:387). On CPU tensors autograd runs
through ``env_substeps_plain``; on CUDA tensors ``_EnvSubsteps`` launches the
forward kernel unchanged and its backward launches the hand-written adjoint
``env_substeps_vjp`` (``csrc/env_step_vjp.cu``) once. The model, gains,
limits, springs, friction and external force are never differentiated: the
wrapper raises where one of them requires grad. The Go1's geometry (joint
origins, foot radius, trunk corners, gravity) is the fixed one of
``go1_params``; the kernel reads
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
    flat = consts_values(params_key)
    return (ctypes.c_float * len(flat))(*np.asarray(flat, np.float32).tolist())


def consts_values(params_key: tuple) -> list:
    """consts_array's values in double, before their rounding to float."""
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
    return flat


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


def occupancy(kernel: str = "env_substeps") -> dict:
    """What the card makes of the env_substeps kernel (or `kernel`
    "env_substeps_vjp", at its largest launch): its registers and local
    memory a thread (cudaFuncGetAttributes), threads and shared memory a
    block, blocks and warps an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
    env_substeps_vjp's also the substeps it recomputes at once ("chunk")."""
    out = (ctypes.c_int * 6)()
    name = kernel + "_occupancy"
    kernels.check_launch(name, getattr(kernels.library(), name)(out))
    occ = {"blocks_per_sm": out[0], "threads_per_block": out[1], "registers": out[2],
           "local_bytes": out[3], "shared_bytes": out[4],
           "warps_per_sm": out[0] * out[1] // 32}
    if kernel == "env_substeps_vjp":
        occ["chunk"] = out[5]
    return occ


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
    the `env_substeps` kernel once; CPU tensors run env_substeps_plain. The
    state, anchor and q_des may require grad: on CUDA tensors the backward
    is one `env_substeps_vjp` launch, on CPU tensors autograd through the
    plain version.
    """
    grad = torch.is_grad_enabled()
    if grad and any(torch.is_tensor(t) and t.requires_grad for t in (
            kp, kd, torque_limits, velocity_limits, spring_k, spring_b, rest_angles3,
            engage_sign, ext_force_world, params.friction,
            *(getattr(model, f) for f in gp.SCENARIO_FIELDS))):
        raise ValueError("env_substeps: only the state, the anchors and the commands are "
                         "differentiated; the model, gains, limits, springs, friction and "
                         "external force must not require grad")
    dev = robot.q.device
    if dev.type == "cpu":
        return env_substeps_plain(robot, anchor, q_des, model, params, kp, kd,
                                  torque_limits, velocity_limits, spring_k, spring_b,
                                  rest_angles3, engage_sign, substeps, ext_force_world,
                                  torque_mode)
    if dev.type != "cuda":
        raise ValueError(f"env_substeps: no kernel for device {dev}")
    rest = (model, params, kp, kd, torque_limits, velocity_limits, spring_k, spring_b,
            rest_angles3, engage_sign, substeps, ext_force_world, torque_mode)
    diff = (*(getattr(robot, f) for f in ROBOT_FIELDS), anchor, q_des)
    if grad and any(t.requires_grad for t in diff):
        outs = _EnvSubsteps.apply(rest, *diff)
        return SubstepsOut(dyn.RobotState(*outs[:6]), *outs[6:])
    return _launch(robot, anchor, q_des, *rest)


def _launch(robot, anchor, q_des, model, params, kp, kd, torque_limits, velocity_limits,
            spring_k, spring_b, rest_angles3, engage_sign, substeps, ext_force_world,
            torque_mode) -> SubstepsOut:
    """One launch of the `env_substeps` kernel on CUDA tensors."""
    dev = robot.q.device
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


# -- reverse mode ---------------------------------------------------------------

# the float outputs of SubstepsOut, in the order of the kernel's cotangent
# arguments: the robot's six fields, then these
GRAD_OUTPUTS = (*ROBOT_FIELDS, "anchor", "tau", "tau_m", "tau_m_sum", "foot_forces")
# floats a thread keeps per substep in the adjoint's scratch: the base's 13
# (pos, quat, lin_vel, ang_vel) and its leg's q, qd and anchor
VJP_SCRATCH_FLOATS = 21


def output_fields(out: SubstepsOut) -> list:
    """The GRAD_OUTPUTS fields of a SubstepsOut, in that order."""
    return [getattr(out.robot, f) if f in ROBOT_FIELDS else getattr(out, f)
            for f in GRAD_OUTPUTS]


def env_substeps_vjp_plain(robot: dyn.RobotState, anchor, q_des, model: Go1Model,
                           params: dyn.SimParams, kp, kd, torque_limits, velocity_limits,
                           spring_k, spring_b, rest_angles3, engage_sign, substeps: int,
                           ext_force_world, torque_mode: bool, cotangents):
    """The plain version of the `env_substeps_vjp` kernel: autograd through
    env_substeps_plain. cotangents: one tensor or None per GRAD_OUTPUTS
    field (None: zero). Returns the cotangents of (the robot's six fields,
    anchor, q_des), in q_des's own (N,R,12) or held (N,12) form."""
    with torch.enable_grad():
        prim = [t.detach().requires_grad_() for t in (
            *(getattr(robot, f) for f in ROBOT_FIELDS), anchor, q_des)]
        out = env_substeps_plain(dyn.RobotState(*prim[:6]), prim[6], prim[7], model, params,
                                 kp, kd, torque_limits, velocity_limits, spring_k, spring_b,
                                 rest_angles3, engage_sign, substeps, ext_force_world,
                                 torque_mode)
        pairs = [(o, g) for o, g in zip(output_fields(out), cotangents) if g is not None]
        if not pairs:
            return tuple(torch.zeros_like(p) for p in prim)
        grads = torch.autograd.grad([o for o, _ in pairs], prim, [g for _, g in pairs],
                                    allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g for p, g in zip(prim, grads))


def env_substeps_vjp(robot: dyn.RobotState, anchor, q_des, model: Go1Model,
                     params: dyn.SimParams, kp, kd, torque_limits, velocity_limits,
                     spring_k, spring_b, rest_angles3, engage_sign, substeps: int,
                     ext_force_world, torque_mode: bool, cotangents):
    """The cotangents of env_substeps's inputs from those of its float
    outputs: the arguments of env_substeps, then `cotangents`, one tensor
    (the output's shape) or None (zero) per GRAD_OUTPUTS field. Returns the
    cotangents of (pos, quat, lin_vel, ang_vel, q, qd, anchor, q_des); a held
    (N,12) q_des gets the sum over the substeps. CUDA tensors launch the
    `env_substeps_vjp` kernel once (it re-runs the forward from the inputs);
    CPU tensors run env_substeps_vjp_plain."""
    args = (robot, anchor, q_des, model, params, kp, kd, torque_limits, velocity_limits,
            spring_k, spring_b, rest_angles3, engage_sign, substeps, ext_force_world,
            torque_mode)
    dev = robot.q.device
    if dev.type == "cpu":
        return env_substeps_vjp_plain(*args, cotangents)
    if dev.type != "cuda":
        raise ValueError(f"env_substeps_vjp: no kernel for device {dev}")
    launch, grads, _keep = vjp_launch_args(*args, cotangents)
    if robot.q.shape[0]:
        kernels.launch(dev, "env_substeps_vjp", kernels.library().env_substeps_vjp, launch)
        env_substeps_vjp.launches += 1
    return grads


env_substeps_vjp.launches = 0   # `env_substeps_vjp` kernel


def vjp_launch_args(robot, anchor, q_des, model, params, kp, kd, torque_limits,
                    velocity_limits, spring_k, spring_b, rest_angles3, engage_sign,
                    substeps: int, ext_force_world, torque_mode: bool, cotangents):
    """The `env_substeps_vjp` entry point's arguments but the stream (the
    forward's, then the cotangents, the results and the scratch), the
    results (the input cotangents, uninitialised: the kernel writes every
    one) and the tensors the arguments point into that the caller does not
    hold (the forward's outputs, which the kernel does not write, the
    cotangents made contiguous, the scratch), to be kept alive until the
    launch is enqueued. Checked from metadata as launch_args
    checks the forward's."""
    n, dev = robot.q.shape[0], robot.q.device
    friction = params.friction
    if not torch.is_tensor(friction):
        friction = torch.full((n,), float(friction), dtype=torch.float32, device=dev)
    args, out = launch_args(robot, anchor, q_des, model, friction, params, kp, kd,
                            torque_limits, velocity_limits, spring_k, spring_b,
                            rest_angles3, engage_sign, substeps, ext_force_world,
                            torque_mode)
    if len(cotangents) != len(GRAD_OUTPUTS):
        raise ValueError(f"env_substeps_vjp: {len(cotangents)} cotangents, expected "
                         f"{len(GRAD_OUTPUTS)}")
    gs = [None if g is None else g.contiguous() for g in cotangents]
    kernels.check_tensors([(name, g, tuple(o.shape)) for name, g, o in
                           zip(GRAD_OUTPUTS, gs, output_fields(out)) if g is not None], dev)
    prim = (*(getattr(robot, f) for f in ROBOT_FIELDS), anchor, q_des)
    grads = tuple(torch.empty_like(p) for p in prim)
    scratch = torch.empty((4 * n, substeps, VJP_SCRATCH_FLOATS), dtype=torch.float32,
                          device=dev)
    args = (args + [None if g is None else g.data_ptr() for g in gs]
            + [g.data_ptr() for g in grads] + [scratch.data_ptr()])
    return args, grads, (out, gs, scratch)


class _EnvSubsteps(torch.autograd.Function):
    """env_substeps on CUDA tensors with reverse mode: forward launches the
    `env_substeps` kernel as without grad (its outputs bitwise the same),
    backward launches `env_substeps_vjp` once. Arguments: the tuple of
    env_substeps's other arguments, then the robot's six fields, anchor and
    q_des."""

    @staticmethod
    def forward(ctx, rest, pos, quat, lin_vel, ang_vel, q, qd, anchor, q_des):
        robot = dyn.RobotState(pos, quat, lin_vel, ang_vel, q, qd)
        out = _launch(robot, anchor, q_des, *rest)
        ctx.rest = rest
        ctx.save_for_backward(pos, quat, lin_vel, ang_vel, q, qd, anchor, q_des)
        ctx.mark_non_differentiable(out.feet_in_contact, out.invalid_contact)
        ctx.set_materialize_grads(False)
        return (*output_fields(out), out.feet_in_contact, out.invalid_contact)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        robot = dyn.RobotState(*saved[:6])
        d = env_substeps_vjp(robot, saved[6], saved[7], *ctx.rest, grads[:len(GRAD_OUTPUTS)])
        return (None, *d)


# -- the env_substeps_vjp kernel held to its plain version ------------------------

# the input cotangents env_substeps_vjp returns, in its order
VJP_FIELDS = (*ROBOT_FIELDS, "anchor", "q_des")


def vjp_rows(grads) -> dict:
    """env_substeps_vjp's results as {field: (N, k) float64}."""
    return {k: g.reshape(g.shape[0], -1).double() for k, g in zip(VJP_FIELDS, grads)}


def float64_args(args) -> tuple:
    """env_substeps's arguments with every float32 tensor in float64 (the
    model's too): the plain version runs in either."""
    up = lambda t: t.double() if torch.is_tensor(t) and t.dtype == torch.float32 else t
    tree = lambda x: dataclasses.replace(x, **{f.name: up(getattr(x, f.name))
                                               for f in dataclasses.fields(x)})
    return (tree(args[0]), up(args[1]), up(args[2]), tree(args[3]),
            dataclasses.replace(args[4], friction=up(args[4].friction)),
            *(up(t) for t in args[5:13]), args[13], up(args[14]), args[15])


def _substep_args(args, r: int, robot, anchor) -> tuple:
    """env_substeps's arguments for substep r of `args` alone, from (robot,
    anchor)."""
    q_des = args[2]
    cmd = q_des[:, r].contiguous() if q_des.dim() == 3 else q_des
    return (robot, anchor, cmd, *args[3:13], 1, *args[14:])


def substep_starts(args) -> list:
    """The (robot, anchor) at the start of each of the R substeps of
    env_substeps(*args), as env_substeps runs them (on CUDA tensors the
    kernel: one substep a launch, bitwise its R-substep launch's chain)."""
    starts = [(args[0], args[1])]
    for r in range(args[13] - 1):
        out = env_substeps(*_substep_args(args, r, *starts[-1]))
        starts.append((out.robot, out.anchor))
    return starts


def vjp_branch_flips(args, starts=None) -> torch.Tensor:
    """Per environment, whether env_substeps's forward (on CUDA tensors the
    kernel) and the plain version's part at a branch along the control
    step: each run substep by substep from the same start along its own
    trajectory (given `starts`, substep_starts', each substep from those:
    a branch the two take apart within one substep), and compared at every
    substep at a spring's engagement, a clip of the motor torque or of the
    joint velocity, a joint past its limit, each foot's contact and slide
    (its anchor moved) and the other sites' contact. (N,) bool."""
    lim, vlim, rest12 = args[7], args[8], torch.tile(args[11], (4,))
    sign, dev = args[12], args[0].q.device
    lower = torch.as_tensor(dyn.REAL_LOWER, dtype=torch.float32, device=dev)
    upper = torch.as_tensor(dyn.REAL_UPPER, dtype=torch.float32, device=dev)

    def flags(robot, anchor, out):
        return torch.cat([sign * (robot.q - rest12) >= 0, out.tau_m.abs() >= lim,
                          out.robot.qd.abs() >= vlim, (robot.q > upper) | (robot.q < lower),
                          out.feet_in_contact, (out.anchor != anchor).any(-1),
                          out.invalid_contact[:, None]], dim=1)

    flips = torch.zeros(args[0].q.shape[0], dtype=torch.bool, device=dev)
    sides = [(args[0], args[1])] * 2
    for r in range(args[13]):
        if starts is not None:
            sides = [starts[r]] * 2
        outs = [f(*_substep_args(args, r, *side)) for f, side in
                zip((env_substeps, env_substeps_plain), sides)]
        fk, fp = (flags(*side, o) for side, o in zip(sides, outs))
        flips |= (fk != fp).any(dim=1)
        sides = [(o.robot, o.anchor) for o in outs]
    return flips


def vjp_along(args, cotangents, starts) -> tuple:
    """The plain version's cotangents of env_substeps(*args)'s inputs taken
    along given substep starts (substep_starts): autograd through each
    substep alone from its start, the cotangents chained back from the last.
    Along the kernel's own starts it takes the kernel's side of a branch the
    two trajectories take apart, so at such a kink it is the derivative the
    kernel must give; a branch the two take apart within one substep from
    the same start (vjp_branch_flips with starts) it does not follow.
    Arguments as env_substeps_vjp; the starts' dtype is that of args."""
    g = dict(zip(GRAD_OUTPUTS, cotangents))
    carry = [g[f] for f in ROBOT_FIELDS] + [g["anchor"]]
    cmds = []
    for r in reversed(range(args[13])):
        last = r == args[13] - 1
        d = env_substeps_vjp_plain(
            *_substep_args(args, r, *starts[r]),
            carry + [g["tau"] if last else None, g["tau_m"] if last else None,
                     g["tau_m_sum"], g["foot_forces"] if last else None])
        carry, cmds = list(d[:7]), [d[7]] + cmds
    return (*carry, torch.stack(cmds, 1) if args[2].dim() == 3 else sum(cmds))


def check_vjp(args, cotangents, got, rel_tol: float, spread: float) -> dict:
    """Hold `got`, the env_substeps_vjp kernel's cotangents on env_substeps's
    arguments `args` and the output cotangents `cotangents` (None: zero),
    to its plain version, per environment and input field: |got - plain|
    <= rel_tol·(1 + |plain|) + spread x s, s the plain version's own spread
    (over the field's columns, the larger of its change under a one-ulp
    change of its start and its distance to itself run in float64). The
    kernel's forward parts from the plain version's by rounding, and along
    a stiff control step the derivatives at the two trajectories part by
    more; at a kink (a branch taken apart by the two forwards) by the jump.
    So an environment outside that rule passes only if it keeps the same
    rule against the plain version taken along the kernel's own substep
    starts (vjp_along), s that chain's distance to itself in float64; which
    of them part at a branch (vjp_branch_flips) is reported. Returns
    max_abs_err (over every environment, against what it was held to),
    spread_used (the largest share of its spread allowance an environment
    used), along (the environments held along the kernel's starts), kinks
    (those of them at a proven kink), within (those where the two take a
    branch apart even within one substep from the kernel's start, so that
    the reference along the starts has the other side of that kink too),
    failed (the environments that failed) and failures (one message each;
    empty when the kernel passes)."""
    robot = args[0]
    moved = list(args)
    moved[0] = dataclasses.replace(robot, q=torch.nextafter(robot.q, robot.q + 1.0))
    want = vjp_rows(env_substeps_vjp_plain(*args, cotangents))
    again = vjp_rows(env_substeps_vjp_plain(*moved, cotangents))
    exact = vjp_rows(env_substeps_vjp_plain(*float64_args(args), _double(cotangents)))
    got = vjp_rows(got)
    spreads = {k: torch.maximum((again[k] - w).abs(), (exact[k] - w).abs()) for k, w in
               want.items()}
    rule = _vjp_rule(got, want, spreads, rel_tol, spread)
    outside = rule["outside"].nonzero().flatten().tolist()
    failures, failed, kinks, within = [], [], [], []
    if outside:
        idx = torch.as_tensor(outside, device=robot.q.device)
        sub = _take_args(args, idx)
        cot = [None if c is None else c[idx] for c in cotangents]
        flips = vjp_branch_flips(sub).tolist()
        starts = substep_starts(sub)
        along = vjp_rows(vjp_along(sub, cot, starts))
        along64 = vjp_rows(vjp_along(float64_args(sub), _double(cot),
                                     [(_float64_robot(r), a.double()) for r, a in starts]))
        at = _vjp_rule({k: v[idx] for k, v in got.items()}, along,
                       {k: (along64[k] - v).abs() for k, v in along.items()}, rel_tol, spread)
        inner = vjp_branch_flips(sub, starts).tolist()
        kinks = [i for i, f in zip(outside, flips) if f]
        within = [i for i, f in zip(outside, inner) if f]
        for j, i in enumerate(outside):
            if bool(at["outside"][j]):
                what = (" (a kink within one substep)" if inner[j] else
                        " (a kink)" if flips[j] else "")
                failed.append(i)
                failures.append(f"environment {i}{what}: {rule['first'][i]}; along the "
                                f"kernel's substep starts {at['first'][j]}")
        rule["err"] = max(rule["err"], at["err"])
        rule["used"] = max(rule["used"], at["used"])
    return {"max_abs_err": rule["err"], "spread_used": rule["used"], "along": outside,
            "kinks": kinks, "within": within, "failed": failed, "failures": failures}


def _vjp_rule(got, want, spreads, rel_tol, spread) -> dict:
    """check_vjp's rule on {field: (N, k)} rows: the environments outside
    it (N,) bool, the first message of each ({environment: text}), the
    largest |got - want| and share of the spread allowance used over the
    environments inside it."""
    n = next(iter(want.values())).shape[0]
    outside = torch.zeros(n, dtype=torch.bool, device=next(iter(want.values())).device)
    first, err, used = {}, 0.0, 0.0
    for k, w in want.items():
        if not bool(torch.isfinite(got[k]).all()):
            raise AssertionError(f"env_substeps_vjp d_{k}: non-finite cotangents")
        d = (got[k] - w).abs()
        s = spreads[k].amax(dim=1, keepdim=True)
        slack = d - rel_tol * (1.0 + w.abs())
        bad = slack > spread * s
        outside |= bad.any(dim=1)
        for i, j in bad.nonzero().tolist():
            first.setdefault(i, f"d_{k}: |kernel - plain| {float(d[i, j])} at column {j} "
                                f"(plain {float(w[i, j])}) over {rel_tol}·(1+|plain|) + "
                                f"{spread} x the spread {float(s[i, 0])}")
        inside = ~bad.any(dim=1, keepdim=True)
        err = max(err, float(torch.where(inside, d, torch.zeros_like(d)).max()))
        over = torch.where(inside & (slack > 0), slack.clamp_min(0.0) / s.clamp_min(1e-30),
                           torch.zeros_like(d))
        used = max(used, float(over.max()))
    return {"outside": outside, "first": first, "err": err, "used": used}


def _double(cotangents) -> list:
    return [None if c is None else c.double() for c in cotangents]


def _float64_robot(robot: dyn.RobotState) -> dyn.RobotState:
    return dyn.RobotState(*(getattr(robot, f).double() for f in ROBOT_FIELDS))


def _take_args(args, idx) -> tuple:
    """env_substeps's arguments for the environments idx of `args`."""
    n = args[0].q.shape[0]
    rows = lambda t: (t[idx].contiguous() if torch.is_tensor(t) and t.dim() and t.shape[0] == n
                      else t)
    model = dataclasses.replace(args[3], **{f: rows(getattr(args[3], f))
                                            for f in gp.SCENARIO_FIELDS})
    params = dataclasses.replace(args[4], friction=rows(args[4].friction))
    ext = args[14]
    if torch.is_tensor(ext) and ext.dim() == 2:
        ext = ext[idx].contiguous()
    return (_take_robot(args[0], idx), args[1][idx].contiguous(), args[2][idx].contiguous(),
            model, params, *args[5:9], rows(args[9]), rows(args[10]), *args[11:14], ext,
            args[15])


def _take_robot(robot: dyn.RobotState, idx) -> dyn.RobotState:
    return dyn.RobotState(*(getattr(robot, f)[idx].contiguous() for f in ROBOT_FIELDS))


def edge_states(args, limits=(), upside_down=(), folded=()) -> tuple:
    """env_substeps's arguments with the environments of `limits` lifted
    0.3 m and past their joint limits (legs 0 and 1's hips 0.02 rad over
    the upper, legs 2 and 3's calves 0.02 rad under the lower, each moving
    further out at 0.5 rad/s), those of `upside_down` on their back with the
    trunk's corners 2 mm in the ground, and those of `folded` level, at
    rest, with the legs folded (thigh 0.3, calf -2.7 rad) and the lowest
    knee 2 mm in: where the joint-limit torque and the knee and trunk-corner
    contact act, for check_vjp's callers (chip_smoke.py phase 26, the
    tests)."""
    robot = args[0]
    pos, quat = robot.pos.clone(), robot.quat.clone()
    lin_vel, ang_vel = robot.lin_vel.clone(), robot.ang_vel.clone()
    q, qd = robot.q.clone(), robot.qd.clone()
    limits, upside_down, folded = list(limits), list(upside_down), list(folded)
    pos[limits, 2] += 0.3
    for j, bound, out in ((0, dyn.REAL_UPPER, 1.0), (3, dyn.REAL_UPPER, 1.0),
                          (8, dyn.REAL_LOWER, -1.0), (11, dyn.REAL_LOWER, -1.0)):
        q[limits, j] = float(bound[j]) + 0.02 * out
        qd[limits, j] = 0.5 * out
    quat[upside_down] = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=quat.dtype, device=quat.device)
    pos[upside_down, 2] = dyn.TRUNK_RADIUS - 0.002
    quat[folded] = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=quat.dtype, device=quat.device)
    q[folded] = torch.tensor([0.0, 0.3, -2.7] * 4, dtype=q.dtype, device=q.device)
    for t in (lin_vel, ang_vel, qd):
        t[upside_down + folded] = 0.0
    moved = dyn.RobotState(pos, quat, lin_vel, ang_vel, q, qd)
    if folded:
        knees = dyn.site_state_world(args[3], moved)[0][folded, 4:8, 2].amin(dim=1)
        pos[folded, 2] -= knees - (dyn.KNEE_RADIUS - 0.002)
    return (moved, *args[1:])
