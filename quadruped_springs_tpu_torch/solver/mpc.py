"""MPC problem assembly: Go1 planner dynamics + task costs + the iLQR and
MPPI solvers.

Port of ``quadruped_springs_tpu.solver.mpc``. Of the JAX MPCConfig, the
scan unroll factors (``ilqr_unroll``, ``substep_unroll``) have no
counterpart in eager PyTorch. ``lin_dtype="bf16"`` linearizes on a knot
computed in bfloat16 (``MPCProblem.dynamics`` with lanes built for that
type), as the JAX package's ``dynamics(..., dtype=jnp.bfloat16)`` does.

State vector layout (n=37): [pos(3), quat(4), lin_vel(3), ang_vel(3),
q(12), qd(12)].
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_springs_tpu_torch.control import interfaces as ci
from quadruped_springs_tpu_torch.env import randomizers as rnd
from quadruped_springs_tpu_torch.models import dynamics as dyn
from quadruped_springs_tpu_torch.models.go1_params import Go1Model, go1_config
from quadruped_springs_tpu_torch.ops import actuation as act
from quadruped_springs_tpu_torch.solver import ilqr, mppi
from quadruped_springs_tpu_torch.solver.rollout import (
    RolloutConsts,
    RolloutLanes,
    TaskCost,
    planner_rollout,
    planner_rollout_cost,
    total_cost,
)
from quadruped_springs_tpu_torch.tasks import costs as task_costs

N_STATE = 37


def state_to_vec(s: dyn.RobotState) -> torch.Tensor:
    return torch.cat([s.pos, s.quat, s.lin_vel, s.ang_vel, s.q, s.qd], dim=-1)


def vec_to_state(x: torch.Tensor) -> dyn.RobotState:
    return dyn.RobotState(pos=x[..., 0:3], quat=x[..., 3:7], lin_vel=x[..., 7:10],
                          ang_vel=x[..., 10:13], q=x[..., 13:25], qd=x[..., 25:37])


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    task: str = "JUMPING_IN_PLACE"
    enable_springs: bool = True
    motor_control_mode: str = "PD"
    action_space_mode: str = "SYMMETRIC"
    horizon: int = 50
    action_repeat: int = 10       # 1 kHz substeps per 100 Hz knot (execution)
    time_step: float = 0.001
    iterations: int = 10
    n_alphas: int = 8
    # Riccati sweep of the iLQR solver: "sequential" or "parallel"
    # (ILQRConfig.backward), and its relinearization period
    # (ILQRConfig.relin_every).
    backward: str = "sequential"
    relin_every: int = 1
    # dtype of the A/B Jacobian sweep only ("f32" or "bf16"): rollouts,
    # costs and the Riccati sweep stay f32 (ilqr.solve_batched's
    # dynamics_lin).
    lin_dtype: str = "f32"
    # Planner integration: 2 substeps per 100 Hz knot (200 Hz) on a relaxed
    # contact (4 kN/m, 40 N s/m) by default; MPCConfig.full_rate() plans on
    # the 1 kHz execution model instead. The JAX module gives the reasons.
    solver_substeps: int = 2
    contact_stiffness: float = 4000.0
    contact_damping: float = 40.0
    clamp_damping: bool = False
    # Task-cost parameter overrides as a hashable (key, value) tuple, e.g.
    # (("v_ref", 1.8),); tasks/costs.make_cost documents the keys per task.
    cost_overrides: tuple = ()
    # Task whose action scaling the control interface takes (BACKFLIP raises
    # the rear-thigh upper limits), for a solver that plans another cost
    # inside that task's episode. None = same as `task`.
    iface_task: str | None = None

    @classmethod
    def full_rate(cls, **kw) -> "MPCConfig":
        """Execution-rate planner: 10x1 ms substeps, kn=180 kN/m, dn=100 N s/m,
        damping clamp on (memoryless friction, no anchor stiction)."""
        kw.setdefault("solver_substeps", 10)
        kw.setdefault("contact_stiffness", 180000.0)
        kw.setdefault("contact_damping", 100.0)
        kw.setdefault("clamp_damping", True)
        return cls(**kw)

    @property
    def planner_desc(self) -> str:
        """One-token description of the planner model, e.g. 'planner@200Hz-4kN-relaxed'."""
        hz = int(round(self.solver_substeps / (self.time_step * self.action_repeat)))
        return (f"planner@{hz}Hz-{self.contact_stiffness / 1000:g}kN"
                + ("" if self.clamp_damping else "-relaxed"))


@dataclasses.dataclass(frozen=True)
class LaneParams:
    """Per-lane constants of the planner dynamics for N = B·R lanes
    (scenario-major), built once per solve and reused by every knot."""
    model: Go1Model          # scenario fields with N lanes
    params: dyn.SimParams    # friction (N,)
    spring_k: torch.Tensor   # (N,3); zeros without springs
    spring_b: torch.Tensor   # (N,3)


LIN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def cast_floats(obj, dtype: torch.dtype):
    """A tensor, or a dataclass with its floating tensors (and those of the
    dataclasses it holds) cast to dtype; anything else as it is."""
    if torch.is_tensor(obj):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: cast_floats(getattr(obj, f.name), dtype)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


class MPCProblem:
    """Static problem definition on one device; exposes dynamics/cost/solve."""

    def __init__(self, config: MPCConfig = MPCConfig(), device=None):
        """On `device`: the CUDA card unless the caller names another."""
        self.config = config
        self.device = torch.device(device if device is not None else "cuda")
        self.cfg = go1_config(config.enable_springs, self.device)
        self.iface = ci.make_interface(self.cfg, config.motor_control_mode,
                                       config.action_space_mode,
                                       config.iface_task or config.task)
        self.action_dim = self.iface.action_dim
        knot_dt = config.time_step * config.action_repeat
        self.sim_params = dataclasses.replace(
            dyn.default_sim_params(knot_dt / config.solver_substeps),
            contact_stiffness=config.contact_stiffness,
            contact_damping=config.contact_damping,
            clamp_damping=config.clamp_damping)
        self.stage_cost, self.terminal_cost = task_costs.make_cost(
            config.task, self.cfg, self.action_dim, config.horizon,
            overrides=dict(config.cost_overrides))
        self.ilqr_config = ilqr.ILQRConfig(
            horizon=config.horizon, iterations=config.iterations,
            n_alphas=config.n_alphas, backward=config.backward,
            relin_every=config.relin_every)
        self.engage_sign = torch.as_tensor(act.SPRING_ENGAGE_SIGN, dtype=torch.float32,
                                           device=self.device)
        if config.lin_dtype not in LIN_DTYPES:
            raise ValueError(f"lin_dtype {config.lin_dtype!r}: expected one of "
                             f"{sorted(LIN_DTYPES)}")
        self._knot_constants = {}
        self._nominal_lanes = None

    def knot_constants(self, dtype: torch.dtype) -> dict:
        """The robot constants a knot reads, in dtype, made once per type."""
        if dtype not in self._knot_constants:
            cfg, c = self.cfg, lambda t: cast_floats(t, dtype)
            self._knot_constants[dtype] = {
                "iface": c(self.iface), "kp": c(cfg.motor_kp), "kd": c(cfg.motor_kd),
                "torque_limits": c(cfg.torque_limits), "rest": c(cfg.spring_rest_angles),
                "velocity_limits": c(cfg.velocity_limits), "sign": c(self.engage_sign)}
        return self._knot_constants[dtype]

    def lane_params(self, scenario: rnd.ScenarioParams | None = None,
                    repeats: int = 1, dtype: torch.dtype = torch.float32) -> LaneParams:
        """Expand B scenarios (nominal: one) to B·repeats lanes. With a dtype
        other than float32 every constant is cast to it, the contact
        stiffness and damping rounded to it, as the JAX package's knot casts
        its SimParams."""
        if scenario is None:
            scenario = rnd.nominal_params(self.cfg)
        model = rnd.model_from_params(scenario).repeat_lanes(repeats)
        per_lane = lambda t: t.repeat_interleave(repeats, dim=0).contiguous()
        k, b = per_lane(scenario.spring_stiffness), per_lane(scenario.spring_damping)
        if not self.cfg.enable_springs:
            k, b = torch.zeros_like(k), torch.zeros_like(b)
        params = dataclasses.replace(self.sim_params,
                                     friction=per_lane(scenario.friction))
        lanes = LaneParams(model=model, params=params, spring_k=k, spring_b=b)
        if dtype == torch.float32:
            return lanes
        rounded = lambda v: float(torch.tensor(v, dtype=dtype))
        lanes = cast_floats(lanes, dtype)
        return dataclasses.replace(lanes, params=dataclasses.replace(
            lanes.params, contact_stiffness=rounded(params.contact_stiffness),
            contact_damping=rounded(params.contact_damping)))

    # -- dynamics: one 100 Hz control knot = solver_substeps planner substeps --
    def dynamics(self, x: torch.Tensor, u: torch.Tensor,
                 lanes: LaneParams) -> torch.Tensor:
        """One planner knot for N lanes: x (N,37), u (N,m) -> (N,37), with
        the lanes' constants from lane_params. The knot computes in the
        lanes' type: with lanes built for bfloat16, x and u are cast to it,
        every state and intermediate is bf16 (the kernels launch their bf16
        variants), and the result is cast back to x's type."""
        dtype = lanes.spring_k.dtype
        c = self.knot_constants(dtype)
        q_des = ci.action_to_command(c["iface"], u.to(dtype)).contiguous()
        s = vec_to_state(x.to(dtype))
        for _ in range(self.config.solver_substeps):
            tau, _ = act.actuation_torque(
                q_des, s.q.contiguous(), s.qd.contiguous(), c["kp"], c["kd"],
                c["torque_limits"], lanes.spring_k, lanes.spring_b, c["rest"], c["sign"])
            s, _ = dyn.step(lanes.model, lanes.params, s, tau, c["velocity_limits"])
        return state_to_vec(s).to(x.dtype)

    def lane_dynamics(self, scenario: rnd.ScenarioParams,
                      dtype: torch.dtype = torch.float32):
        """The solvers' dynamics for B problems, one scenario each:
        f(x (B,R,n), u (B,R,m)) -> (B,R,n) for R lanes per problem, the knot
        computed in dtype. The lanes' constants are built once per R and
        reused by every knot."""
        lanes = {}

        def dyn_fn(x, u):
            B, R = x.shape[:2]
            if R not in lanes:
                lanes[R] = self.lane_params(scenario, R, dtype)
            out = self.dynamics(x.reshape(B * R, -1), u.reshape(B * R, -1), lanes[R])
            return out.reshape(B, R, -1)

        return dyn_fn

    # -- rollout: H knots of B·R lanes in one planner_rollout call ------------
    def rollout_consts(self, params: dyn.SimParams | None = None,
                       substeps: int | None = None) -> RolloutConsts:
        """What every lane of a rollout shares: the robot's gains and limits,
        the planner's SimParams and substeps per knot (or those given)."""
        cfg = self.cfg
        return RolloutConsts(
            kp=cfg.motor_kp, kd=cfg.motor_kd, torque_limits=cfg.torque_limits,
            velocity_limits=cfg.velocity_limits, rest=cfg.spring_rest_angles,
            sign=self.engage_sign, params=self.sim_params if params is None else params,
            substeps=self.config.solver_substeps if substeps is None else substeps)

    def rollout_lanes(self, scenario: rnd.ScenarioParams | None = None) -> RolloutLanes:
        """A rollout's scenarios: lane_params' model, springs and friction,
        one row per problem, or the nominal robot's one row for all of them
        when `scenario` is None; the model packed for the kernel once."""
        lanes = self.lane_params(scenario)
        return RolloutLanes.make(lanes.model, lanes.spring_k, lanes.spring_b,
                                 lanes.params.friction)

    def cost_rollout(self, scenario: rnd.ScenarioParams | RolloutLanes | None = None):
        """MPPI's rollout with its task cost for B problems, one scenario
        each (the nominal robot for all when None, its model packed once a
        problem; a RolloutLanes: scenarios packed by the caller, once for
        many solves): rollout_cost(x0 (B,n),
        us (B,R,H,m), q_des (B,R,H,12) or None, states) -> (xs (B,R,H+1,n)
        or None unless states, costs (B,R)). A task of KERNEL_FAMILIES
        rolls out through planner_rollout_cost (one launch on the card, the
        cost summed in it); RECOVERY and NO_TASK through planner_rollout,
        then their PyTorch cost (total_cost). q_des None: the commands are
        computed here."""
        if isinstance(scenario, RolloutLanes):
            lanes = scenario
        elif scenario is None:
            if self._nominal_lanes is None:
                self._nominal_lanes = self.rollout_lanes(None)
            lanes = self._nominal_lanes
        else:
            lanes = self.rollout_lanes(scenario)
        consts = self.rollout_consts()
        weights = task_costs.kernel_weights(self.config.task, self.config.horizon,
                                            dict(self.config.cost_overrides))
        cost = None if weights is None else TaskCost(self.stage_cost, self.terminal_cost,
                                                     *weights)

        def rollout_cost(x0, us, q_des, states):
            if q_des is None:
                q_des = ci.action_to_command(self.iface, us).contiguous()
            if cost is None:
                xs = planner_rollout(x0.contiguous(), q_des, lanes, consts)
                return xs, total_cost(self.stage_cost, self.terminal_cost, xs, us)
            return planner_rollout_cost(x0.contiguous(), us.contiguous(), q_des, lanes, consts,
                                        cost, states)

        return rollout_cost

    # -- solve ------------------------------------------------------------
    def solve_batch(self, x0s: torch.Tensor, u_inits: torch.Tensor,
                    scenarios: rnd.ScenarioParams | None = None,
                    stage_times: dict | None = None) -> ilqr.ILQRSolution:
        """iLQR solve of B problems: x0s (B,37), u_inits (B,H,m), one
        scenario per problem (nominal when None). With lin_dtype "bf16" the
        Jacobians come from the bf16 knot. See ilqr.solve_batched."""
        if scenarios is None:
            scenarios = rnd.nominal_params(self.cfg, x0s.shape[0])
        lin_dtype = LIN_DTYPES[self.config.lin_dtype]
        dyn_lin = (None if lin_dtype == torch.float32
                   else self.lane_dynamics(scenarios, lin_dtype))
        return ilqr.solve_batched(self.lane_dynamics(scenarios), self.stage_cost,
                                  self.terminal_cost, x0s, u_inits, self.ilqr_config,
                                  stage_times, dynamics_lin=dyn_lin)

    def solve(self, x0: torch.Tensor, u_init: torch.Tensor,
              scenario: rnd.ScenarioParams | None = None) -> ilqr.ILQRSolution:
        """iLQR solve of one problem: x0 (37,), u_init (H,m); `scenario`
        holds one scenario. The solution has no batch axis."""
        return ilqr.first_problem(self.solve_batch(x0[None], u_init[None], scenario))

    def mpc_step(self, x0: torch.Tensor, u_warm: torch.Tensor,
                 scenario: rnd.ScenarioParams | None = None):
        """Receding-horizon step: solve, apply the first control on the
        planner model, shift the plan. Returns (x1, u0, u_next, cost)."""
        sol = self.solve(x0, u_warm, scenario)
        x1 = self.dynamics(x0[None], sol.us[:1], self.lane_params(scenario))[0]
        u_next = torch.cat([sol.us[1:], sol.us[-1:]], dim=0)
        return x1, sol.us[0], u_next, sol.cost

    def solve_mppi(self, x0: torch.Tensor, u_init: torch.Tensor,
                   generator: torch.Generator | None = None,
                   config: mppi.MPPIConfig | None = None,
                   scenario: rnd.ScenarioParams | RolloutLanes | None = None,
                   noise: torch.Tensor | None = None) -> mppi.MPPISolution:
        """Sampling-based solve of B problems: x0 (B,37), u_init (B,H,m), one
        scenario per problem (the nominal robot for all when None; or their
        rollout_lanes, packed once for many solves). Every
        rollout is one cost_rollout call; with a PD interface mppi_update
        writes the rows' joint targets. See mppi.solve_costed for `noise`.
        """
        if config is None:
            config = mppi.MPPIConfig(horizon=self.config.horizon,
                                     iterations=self.config.iterations)
        iface = self.iface if self.iface.motor_control_mode == "PD" else None
        return mppi.solve_costed(self.cost_rollout(scenario), x0, u_init, config, generator,
                                 noise, iface)

    # -- convenience -------------------------------------------------------
    def default_x0(self) -> torch.Tensor:
        z3 = torch.zeros(3, device=self.device)
        return state_to_vec(dyn.RobotState(
            pos=self.cfg.init_position,
            quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.device),
            lin_vel=z3, ang_vel=z3, q=self.cfg.init_joint_angles,
            qd=torch.zeros(12, device=self.device)))

    def default_warm_start(self) -> torch.Tensor:
        a0 = ci.command_to_action(self.iface, self.iface.init_pose)
        return a0.expand(self.config.horizon, self.action_dim)

    def task_warm_start(self, crouch_knots: int | None = None) -> torch.Tensor:
        """Crouch-then-extend warm start for the jumping tasks."""
        H = self.config.horizon
        task = self.config.task
        if crouch_knots is None:
            crouch_knots = max(H // 3, 4)
        hold = self.default_warm_start()
        if self.config.action_space_mode != "SYMMETRIC":
            return hold
        if "JUMPING" in task or "BACKFLIP" in task:
            t = lambda v: torch.tensor(v, device=self.device)
            crouch = t([0.0, 0.4, -0.8, 0.0, 0.4, -0.8])
            extend = t([0.0, -0.4, 1.0, 0.0, -0.4, 1.0])
            if task.startswith("BACKFLIP"):
                extend = t([0.0, -0.2, 0.6, 0.0, -0.6, 1.0])
            ramp = (torch.arange(H, device=self.device) < crouch_knots)[:, None]
            return torch.where(ramp, crouch, extend)
        return hold
