"""The planner's rollout: B·R lanes of the planner model through H knots in
one call.

``planner_rollout`` runs N = B·R lanes (R candidate control sequences for
each of B problems, scenario-major) from each problem's start through H
knots of S substeps of the planner model (per substep: PD plus the
one-sided spring torque, ``dynamics.step`` with the memoryless contact law
at all 12 sites) and returns every knot's state. On CUDA tensors it launches
the CUDA kernel ``planner_rollout`` of ``csrc/planner_rollout.cu`` once (the
kernel or an error: there is no fallback); on CPU tensors it runs
``planner_rollout_plain``, the knot loop of ``MPCProblem.dynamics`` that
MPPI's rollout ran before the kernel, on the plain actuation and contact
laws. The MPPI solver (through ``MPCProblem.lane_rollout``) and the closed
loop's executor (``closed_loop.execute_knot``: H = 1, S = 10 on the 1 kHz
model) call it.

The commands are the knots' joint targets, ``action_to_command`` of the
candidates, computed before the call for all knots at once (the same
elementwise map the knot applied per knot). Nothing differentiates through
the rollout: it raises under ``torch.func`` transforms and in reverse mode.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_springs_tpu_torch import kernels
from quadruped_springs_tpu_torch.env import substeps as ss
from quadruped_springs_tpu_torch.models import dynamics as dyn
from quadruped_springs_tpu_torch.models.go1_params import Go1Model
from quadruped_springs_tpu_torch.ops import actuation as act

N_STATE = 37   # solver/mpc.py state_to_vec


@dataclasses.dataclass(frozen=True)
class RolloutLanes:
    """The scenarios of a rollout's problems, S rows: one per problem
    (S = B), or one for all of them (S = 1, the nominal robot). Built by
    `make`, which packs the model for the kernel once."""
    model: Go1Model          # S scenarios
    packed: torch.Tensor     # (S, MODEL_FLOATS): env/substeps.py pack_model
    spring_k: torch.Tensor   # (S,3); zeros without springs
    spring_b: torch.Tensor   # (S,3)
    friction: torch.Tensor   # (S,)

    @classmethod
    def make(cls, model: Go1Model, spring_k, spring_b, friction) -> "RolloutLanes":
        return cls(model=model, packed=ss.pack_model(model), spring_k=spring_k.contiguous(),
                   spring_b=spring_b.contiguous(), friction=friction.contiguous())


@dataclasses.dataclass(frozen=True)
class RolloutConsts:
    """What every lane shares: the motors' gains and limits (12,), the
    springs' rest angles (3,) and engage signs (12,), the planner's
    SimParams (dt, contact, joint-limit penalty, damping clamp; its friction
    is not read: the lanes carry theirs) and the substeps per knot."""
    kp: torch.Tensor
    kd: torch.Tensor
    torque_limits: torch.Tensor
    velocity_limits: torch.Tensor
    rest: torch.Tensor
    sign: torch.Tensor
    params: dyn.SimParams
    substeps: int


def _state_vec(s: dyn.RobotState) -> torch.Tensor:
    return torch.cat([s.pos, s.quat, s.lin_vel, s.ang_vel, s.q, s.qd], dim=-1)


def planner_rollout_plain(x0, q_des, lanes: RolloutLanes,
                          consts: RolloutConsts) -> torch.Tensor:
    """The plain PyTorch version of the `planner_rollout` kernel: per knot
    and substep actuation_plain, then dynamics.step with the plain contact
    law. Arguments and result as planner_rollout; any device and float
    type."""
    B, R, H, _ = q_des.shape
    n = B * R
    rep = n // lanes.spring_k.shape[0]
    per_lane = lambda t: t.repeat_interleave(rep, dim=0).contiguous()
    model = lanes.model.repeat_lanes(rep)
    spring_k, spring_b = per_lane(lanes.spring_k), per_lane(lanes.spring_b)
    params = dataclasses.replace(consts.params, friction=per_lane(lanes.friction))
    x = x0.repeat_interleave(R, dim=0)
    s = dyn.RobotState(pos=x[:, 0:3], quat=x[:, 3:7], lin_vel=x[:, 7:10],
                       ang_vel=x[:, 10:13], q=x[:, 13:25], qd=x[:, 25:37])
    cmds = q_des.reshape(n, H, 12)
    xs = [x]
    for t in range(H):
        cmd = cmds[:, t].contiguous()
        for _ in range(consts.substeps):
            tau, _ = act.actuation_plain(cmd, s.q.contiguous(), s.qd.contiguous(), consts.kp,
                                         consts.kd, consts.torque_limits, spring_k, spring_b,
                                         consts.rest, consts.sign)
            s, _ = dyn.step(model, params, s, tau, consts.velocity_limits, plain=True)
        xs.append(_state_vec(s))
    return torch.stack(xs, dim=1).reshape(B, R, H + 1, N_STATE)


def launch_args(x0, q_des, lanes: RolloutLanes, consts: RolloutConsts):
    """Check every argument from its metadata (device, dtype float32, shape,
    contiguity; no value is read) and allocate the output. Returns (the
    entry point's arguments but the stream, xs). The arguments hold raw
    pointers: the caller keeps every tensor alive until the launch is
    enqueued."""
    if q_des.dim() != 4:
        raise ValueError(f"planner_rollout: q_des of shape {tuple(q_des.shape)}, "
                         "expected (B, R, H, 12)")
    B, R, H, _ = q_des.shape
    dev = x0.device
    if consts.substeps < 1:
        raise ValueError(f"planner_rollout: substeps {consts.substeps}, need at least 1")
    rows = lanes.spring_k.shape[0]
    if rows not in (1, B):
        raise ValueError(f"planner_rollout: {rows} scenario rows for {B} problems")
    for name, t, shape in (
            ("x0", x0, (B, N_STATE)), ("q_des", q_des, (B, R, H, 12)),
            ("kp", consts.kp, (12,)), ("kd", consts.kd, (12,)),
            ("torque_limits", consts.torque_limits, (12,)),
            ("velocity_limits", consts.velocity_limits, (12,)),
            ("rest", consts.rest, (3,)), ("sign", consts.sign, (12,)),
            ("spring_k", lanes.spring_k, (rows, 3)), ("spring_b", lanes.spring_b, (rows, 3)),
            ("friction", lanes.friction, (rows,)),
            ("model", lanes.packed, (rows, ss.MODEL_FLOATS))):
        kernels.check_tensor(name, t, shape, dev)
    xs = torch.empty(B, R, H + 1, N_STATE, dtype=torch.float32, device=dev)
    consts_arr = ss.consts_array(ss._params_key(consts.params))
    args = [consts_arr, len(consts_arr),
            *(t.data_ptr() for t in (x0, q_des, consts.kp, consts.kd, consts.torque_limits,
                                     consts.velocity_limits, consts.rest, consts.sign,
                                     lanes.spring_k, lanes.spring_b, lanes.friction,
                                     lanes.packed)),
            0 if rows == 1 else 1, xs.data_ptr(), B, R, H, consts.substeps,
            int(consts.params.clamp_damping)]
    return args, xs


def _launch(x0, q_des, lanes: RolloutLanes, consts: RolloutConsts) -> torch.Tensor:
    args, xs = launch_args(x0, q_des, lanes, consts)
    if xs.numel() == 0:
        return xs
    dev = x0.device
    with torch.cuda.device(dev):
        err = kernels.library().planner_rollout(*args, kernels.stream_handle(dev))
    kernels.check_launch("planner_rollout", err)
    planner_rollout.launches += 1
    return xs


class _Rollout(torch.autograd.Function):
    """The rollout on either device, so that a torch.func transform or a
    backward pass meets an explicit refusal on both."""

    @staticmethod
    def forward(x0, q_des, lanes, consts):
        if x0.device.type == "cpu":
            return planner_rollout_plain(x0, q_des, lanes, consts)
        if x0.device.type != "cuda":
            raise ValueError(f"planner_rollout: no kernel for device {x0.device}")
        return _launch(x0, q_des, lanes, consts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def jvp(ctx, *tangents):
        kernels.no_backward("planner_rollout")

    @staticmethod
    def vmap(info, in_dims, *args):
        kernels.no_primal_vmap("planner_rollout")

    @staticmethod
    def backward(ctx, *grads):
        kernels.no_backward("planner_rollout")


def planner_rollout(x0, q_des, lanes: RolloutLanes, consts: RolloutConsts) -> torch.Tensor:
    """B problems x R candidates through H knots of the planner model.

    x0: (B,37) each problem's start (solver/mpc.py state_to_vec's layout:
    pos, quat xyzw, world linear and angular velocity, q, qd). q_des:
    (B,R,H,12) the joint targets of each candidate at each knot. lanes: the
    problems' scenarios (one row each, or one for all). All float32 and
    contiguous; on a CUDA tensor the `planner_rollout` kernel launches once
    (an error raises), on a CPU tensor planner_rollout_plain runs. Returns
    xs (B,R,H+1,37), row 0 the start.
    """
    tensors = (x0, q_des, lanes.spring_k, lanes.spring_b, lanes.friction, consts.kp,
               consts.kd, consts.torque_limits, consts.velocity_limits, consts.rest,
               consts.sign)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"planner_rollout: dtype {t.dtype}; the rollout takes float32")
    if q_des.dim() != 4 or q_des.shape[-1] != 12 or x0.shape != (q_des.shape[0], N_STATE):
        raise ValueError(f"planner_rollout: x0 {tuple(x0.shape)} and q_des "
                         f"{tuple(q_des.shape)}, expected (B, 37) and (B, R, H, 12)")
    return _Rollout.apply(x0, q_des, lanes, consts)


planner_rollout.launches = 0   # `planner_rollout` kernel
