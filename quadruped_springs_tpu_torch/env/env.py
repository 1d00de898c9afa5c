"""QuadrupedEnv: the functional 1 kHz environment, batched over N environments.

Port of ``quadruped_springs_tpu.env.env``. The env is a plain class holding
config-derived constants on one device; ``EnvState`` is a dataclass of
tensors, every field with a leading N:

    env = QuadrupedEnv(EnvConfig(...), device="cuda")
    state, obs = env.reset(generator, n=1024)
    state, obs, reward, done, info = env.step(state, action, generator)

Step: store the action -> optional Butterworth filter -> action_repeat
substeps (optional interpolation -> action to joint command -> PD + spring
torque -> 1 kHz dynamics step with foot-anchor stiction) -> task update ->
reward -> termination (task, or sim time past the episode length) ->
end-of-episode bonus -> observation. Reset: scenario -> settle
`settling_steps` substeps holding the init reference (skipped when a
desired robot state is injected) -> one contact evaluation to prime the
contact info -> task, filter and observation.

On CUDA tensors a control step's physics (all action_repeat substeps) is
one launch of the fused `env_substeps` kernel (``env/substeps.py``), and so
is reset's settle; reset's contact priming launches the memoryless
`contact` kernel once. Randomness comes only from the ``torch.Generator``
passed in, on the env's device, or from ``NoiseStreams``: observation noise
that belongs to the scenario a lane replays, as a JAX EnvState's key does
(a lane's noise at env step t is its stream's row t, whatever the batch).
Nothing in reset or step reads a device value on the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from quadruped_springs_tpu_torch.control import interfaces as ci
from quadruped_springs_tpu_torch.env import randomizers as rnd
from quadruped_springs_tpu_torch.env import substeps as ss
from quadruped_springs_tpu_torch.models import dynamics as dyn
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.models.go1_params import go1_config
from quadruped_springs_tpu_torch.ops import action_filter as af
from quadruped_springs_tpu_torch.ops import actuation as act
from quadruped_springs_tpu_torch.sensors import sensors as sn
from quadruped_springs_tpu_torch.tasks import tasks as tk

OBSERVATION_EPS = 0.01
EPISODE_LENGTH = 10.0  # seconds


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """The configuration surface of the JAX EnvConfig (see its comments)."""
    is_rl_gym_interface: bool = True
    time_step: float = 0.001
    action_repeat: int = 10
    motor_control_mode: str = "PD"
    task_env: str = "NO_TASK"
    observation_space_mode: str = "ENCODER"
    action_space_mode: str = "SYMMETRIC"
    on_rack: bool = False
    enable_springs: bool = False
    enable_action_interpolation: bool = False
    enable_action_filter: bool = False
    env_randomizer_mode: str = "GROUND_RANDOMIZER"
    curriculum_level: float = 0.0
    settling_steps: int = 2500
    max_ep_len: float = EPISODE_LENGTH
    obs_noise: bool = True
    demo_norm: str = "remaining"
    iface_task: str | None = None


@dataclasses.dataclass(frozen=True)
class EnvState:
    robot: dyn.RobotState
    task: tk.TaskState
    scenario: rnd.ScenarioParams
    filter_state: af.ButterFilterState
    foot_anchor: torch.Tensor           # (N,4,2) stiction anchors, world xy
    last_action: torch.Tensor           # (N,action_dim)
    last_filtered_action: torch.Tensor  # (N,action_dim)
    observed_torques: torch.Tensor      # (N,12) PD-clipped motor torques
    spring_torques: torch.Tensor        # (N,12)
    feet_in_contact: torch.Tensor       # (N,4) bool
    feet_forces: torch.Tensor           # (N,4)
    invalid_contact: torch.Tensor       # (N,) bool
    sim_step_counter: torch.Tensor      # (N,) int32
    env_step_counter: torch.Tensor      # (N,) int32


@dataclasses.dataclass(frozen=True)
class NoiseStreams:
    """Observation noise per scenario, passed where a generator is passed.

    The JAX env keeps a PRNG key in its state and splits it at every step,
    so every replay of one start state sees one noise sequence, in any batch
    (``quadruped_springs_tpu/env/env.py:387-388, 406-409``). Here lane i's
    standard-normal draw at env step t (its own ``env_step_counter``: an
    autopilot takes a varying number of env steps per call) is
    ``draws[rows[i], min(t, T)]``; the reset's observation is row 0.
    """
    draws: torch.Tensor   # (streams, T + 1, obs_dim) standard normals
    rows: torch.Tensor    # (N,) int64: the stream of each lane

    def take(self, idx: torch.Tensor) -> "NoiseStreams":
        """The streams of lanes idx (M,): lane j replays lane idx[j]'s."""
        return NoiseStreams(self.draws, self.rows[idx])

    def at(self, step: torch.Tensor) -> torch.Tensor:
        """(N, obs_dim) draws at each lane's env step (N,); past the last
        row the last row again (only lanes whose episode has ended get
        there, and their observation is dropped)."""
        t = torch.clamp(step.to(torch.int64), max=self.draws.shape[1] - 1)
        return self.draws[self.rows, t]


def max_env_steps(env) -> int:
    """Env steps an episode of `env` can take before its timeout ends it."""
    return math.ceil(env.config.max_ep_len / env.env_time_step) + 1


def draw_noise(env, generator: torch.Generator, n: int, steps: int):
    """n streams of steps + 1 rows from `generator`, one per lane; None when
    the env has no observation noise (the generator is then not drawn)."""
    if not env.config.obs_noise:
        return None
    draws = torch.randn((n, steps + 1, env.obs_dim), generator=generator,
                        device=env.device)
    return NoiseStreams(draws, torch.arange(n, device=env.device))


def select(mask: torch.Tensor, new, old):
    """Per environment, `new` where mask (N,) is True and `old` elsewhere,
    through every tensor of a (nested) state dataclass."""
    if new is old:
        return new
    if torch.is_tensor(new):
        return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)
    return dataclasses.replace(new, **{
        f.name: select(mask, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(new)})


def take(tree, idx: torch.Tensor):
    """Rows idx (M,) of every tensor of a (nested) state dataclass, a tuple
    or a tensor with a leading N: the gather beside `select` (a reset bank's
    entries handed to M lanes)."""
    if torch.is_tensor(tree):
        return tree[idx]
    if isinstance(tree, tuple):
        return tuple(take(t, idx) for t in tree)
    return dataclasses.replace(tree, **{
        f.name: take(getattr(tree, f.name), idx) for f in dataclasses.fields(tree)})


class QuadrupedEnv:
    """Holds config-derived constants on one device; reset and step are
    functions of an explicit EnvState."""

    def __init__(self, config: EnvConfig = EnvConfig(),
                 demo_actions: torch.Tensor | None = None, device=None):
        if config.motor_control_mode == "TORQUE" and config.is_rl_gym_interface:
            raise ValueError("TORQUE motor control mode is not supported for the RL "
                             "gym interface")
        self.config = config
        self.device = torch.device(device if device is not None else "cuda")
        dev = self.device
        self.cfg = go1_config(config.enable_springs, dev)
        self.iface = ci.make_interface(self.cfg, config.motor_control_mode,
                                       config.action_space_mode,
                                       config.iface_task or config.task_env)
        self.action_dim = self.iface.action_dim
        td = tk.get_task(config.task_env)
        if (config.env_randomizer_mode != "NONE"
                and rnd.is_curriculum(config.env_randomizer_mode)):
            td = tk.apply_curriculum(td)
        self.task_def = dataclasses.replace(td, max_ep_len=config.max_ep_len)
        self.env_time_step = config.time_step * config.action_repeat
        self.filter_coeffs = af.butter_coeffs(1.0 / self.env_time_step, device=dev)
        self.sim_params = dyn.default_sim_params(config.time_step, config.on_rack)
        self.suite = config.observation_space_mode
        self.demo_actions = (None if demo_actions is None
                             else torch.as_tensor(demo_actions, dtype=torch.float32,
                                                  device=dev))
        self.demo_len = None if demo_actions is None else int(self.demo_actions.shape[0])
        if self.task_def.kind in ("demo", "continuous_demo") and demo_actions is None:
            raise ValueError(f"task {config.task_env} needs demo_actions")
        hi, lo, self._obs_noise_std = sn.obs_limits(self.suite, self.cfg)
        self.observation_high = hi + OBSERVATION_EPS
        self.observation_low = lo - OBSERVATION_EPS
        self.obs_dim = int(hi.shape[0])
        self._init_z = 1.0 if config.on_rack else float(self.cfg.init_position[2])
        # device constants, made once (a host -> device copy per call would
        # synchronise the stream)
        self.engage_sign = torch.as_tensor(act.SPRING_ENGAGE_SIGN, dtype=torch.float32,
                                           device=dev)
        self._identity_quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        self._init_action = ci.init_action(self.iface)
        # settling drives joint-space PD toward the init pose: the achievable
        # projection of it for the RL interfaces, the raw angles for TORQUE
        if config.motor_control_mode == "CARTESIAN_PD":
            self._settle_q_des = ci.action_to_command(self.iface, self._init_action)
        elif config.motor_control_mode == "TORQUE":
            self._settle_q_des = self.cfg.init_joint_angles
        else:
            self._settle_q_des = ci.reference_to_command(self.iface, self.iface.init_pose)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _init_robot_state(self, n: int) -> dyn.RobotState:
        z3 = torch.zeros(n, 3, device=self.device)
        pos = z3.clone()
        pos[:, 2] = self._init_z
        return dyn.RobotState(
            pos=pos, quat=self._identity_quat.expand(n, 4).contiguous(),
            lin_vel=z3, ang_vel=z3.clone(),
            q=self.cfg.init_joint_angles.expand(n, 12).contiguous(),
            qd=torch.zeros(n, 12, device=self.device))

    def _scenario_sim_params(self, scenario: rnd.ScenarioParams) -> dyn.SimParams:
        return dataclasses.replace(self.sim_params, friction=scenario.friction.contiguous())

    def _springs(self, scenario: rnd.ScenarioParams):
        k = scenario.spring_stiffness.contiguous()
        b = scenario.spring_damping.contiguous()
        if not self.config.enable_springs:
            k, b = torch.zeros_like(k), torch.zeros_like(b)
        return k, b

    def physics(self, robot, anchor, q_des, model, params, springs, kp, kd, substeps,
                ext_force_world=None, torque_mode=False) -> ss.SubstepsOut:
        """`substeps` substeps of the 1 kHz physics from (robot, anchor):
        q_des (N,substeps,12) or (N,12) held. One `env_substeps` launch on
        CUDA tensors."""
        cfg = self.cfg
        return ss.env_substeps(robot, anchor, q_des, model, params, kp, kd,
                               cfg.torque_limits, cfg.velocity_limits, springs[0],
                               springs[1], cfg.spring_rest_angles, self.engage_sign,
                               substeps, ext_force_world, torque_mode)

    def _feet_anchor(self, model, robot):
        p_w, _, _ = dyn.foot_state_world(model, robot)
        return p_w[..., :2].contiguous()

    def _sensor_ctx(self, state: EnvState) -> sn.SensorContext:
        return sn.make_context(state.robot, state.feet_in_contact,
                               switched_controller=state.task.switched_controller,
                               is_jumping=state.task.is_jumping)

    def _task_ctx(self, state: EnvState) -> tk.TaskCtx:
        r = state.robot
        return tk.TaskCtx(
            pos=r.pos, lin_vel=r.lin_vel, rpy=sp.quat_to_rpy(r.quat), quat=r.quat,
            q=r.q, qd=r.qd, motor_torques=state.observed_torques,
            feet_in_contact=state.feet_in_contact, feet_forces=state.feet_forces,
            invalid_contact=state.invalid_contact, sim_time=self.sim_time(state),
            is_flying=~state.feet_in_contact.any(-1), last_action=state.last_action,
            is_fallen_height=self.cfg.is_fallen_height)

    def sim_time(self, state: EnvState) -> torch.Tensor:
        return state.sim_step_counter.to(torch.float32) * self.config.time_step

    # ------------------------------------------------------------------
    # reset
    # ------------------------------------------------------------------
    def reset(self, generator: torch.Generator | None = None, n: int = 1,
              desired_robot_state: dyn.RobotState | None = None,
              curriculum_level: float | None = None,
              demo_start_idx: torch.Tensor | int | None = None,
              scenario: rnd.ScenarioParams | None = None,
              noise: NoiseStreams | None = None):
        """Reset N environments; returns (state, obs (N, obs_dim)).

        `generator` (on the env's device) draws the scenarios and the
        observation noise; `noise` gives the noise instead (row 0 of each
        lane's stream). `scenario` gives N scenarios instead of drawing
        them (N then comes from it, as it does from `desired_robot_state`,
        which skips the settle: the reference-state-initialisation path).
        `curriculum_level` overrides EnvConfig.curriculum_level for the
        draw; `demo_start_idx` sets the demo tasks' start index.
        """
        if scenario is not None:
            n = scenario.friction.shape[0]
        elif desired_robot_state is not None:
            n = desired_robot_state.q.shape[0]
        if scenario is None:
            if generator is None:
                raise ValueError("reset needs a generator to draw the scenarios")
            level = (self.config.curriculum_level if curriculum_level is None
                     else curriculum_level)
            scenario = rnd.sample_scenario(self.cfg, self.config.env_randomizer_mode,
                                           generator, n, level)
        model = rnd.model_from_params(scenario)
        params = self._scenario_sim_params(scenario)

        if desired_robot_state is None:
            robot = self._init_robot_state(n)
            # the stiction anchors start under the feet
            anchor = self._feet_anchor(model, robot)
            # settling does not advance the sim counter
            if self.config.settling_steps:
                out = self.physics(robot, anchor, self._settle_q_des.expand(n, 12).contiguous(),
                                   model, params, self._springs(scenario), self.cfg.motor_kp,
                                   self.cfg.motor_kd, self.config.settling_steps)
                robot, anchor = out.robot, out.anchor
        else:
            robot = desired_robot_state
            anchor = self._feet_anchor(model, robot)

        last_action = self._init_action.expand(n, self.action_dim).contiguous()
        # prime the contact info from one memoryless dynamics evaluation
        zeros12 = torch.zeros(n, 12, device=self.device)
        _, _, cinfo = dyn.forward_dynamics(model, params, robot, zeros12)
        task_state = tk.init_task_state(self._task_ctx0(robot, cinfo))
        if demo_start_idx is not None:
            if torch.is_tensor(demo_start_idx):
                start = demo_start_idx.to(self.device, torch.int32).expand(n).clone()
            else:
                start = torch.full((n,), int(demo_start_idx), dtype=torch.int32,
                                   device=self.device)
            task_state = dataclasses.replace(task_state, demo_counter=start,
                                             demo_start=start.clone())
        counter = torch.zeros(n, dtype=torch.int32, device=self.device)
        state = EnvState(
            robot=robot, task=task_state, scenario=scenario,
            filter_state=af.filter_reset(last_action), foot_anchor=anchor,
            last_action=last_action, last_filtered_action=last_action,
            observed_torques=zeros12, spring_torques=zeros12,
            feet_in_contact=cinfo["feet_in_contact"], feet_forces=cinfo["foot_forces"],
            invalid_contact=cinfo["invalid_contact"], sim_step_counter=counter,
            env_step_counter=counter.clone())
        return state, self._observe(state, generator if noise is None else noise)

    def _task_ctx0(self, robot, cinfo) -> tk.TaskCtx:
        n = robot.q.shape[0]
        return tk.TaskCtx(
            pos=robot.pos, lin_vel=robot.lin_vel, rpy=sp.quat_to_rpy(robot.quat),
            quat=robot.quat, q=robot.q, qd=robot.qd,
            motor_torques=torch.zeros(n, 12, device=self.device),
            feet_in_contact=cinfo["feet_in_contact"], feet_forces=cinfo["foot_forces"],
            invalid_contact=torch.zeros(n, dtype=torch.bool, device=self.device),
            sim_time=torch.zeros(n, device=self.device),
            is_flying=~cinfo["feet_in_contact"].any(-1),
            last_action=torch.zeros(n, self.action_dim, device=self.device),
            is_fallen_height=self.cfg.is_fallen_height)

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------
    def step(self, state: EnvState, action: torch.Tensor,
             generator: torch.Generator | None = None, kp=None, kd=None,
             ext_force_world: torch.Tensor | None = None):
        """One 100 Hz control step of every environment.

        action: (N, action_dim). kp, kd: optional (12,) gains replacing the
        motor gains (the landing wrappers' soft gains). ext_force_world:
        optional (N,3) or (3,) world force at the trunk origin in every
        substep. `generator`, a torch.Generator or NoiseStreams, gives the
        observation noise (needed when EnvConfig.obs_noise). Returns (state, obs, reward, done, info).
        """
        cfgc, cfg = self.config, self.cfg
        model = rnd.model_from_params(state.scenario)
        params = self._scenario_sim_params(state.scenario)
        springs = self._springs(state.scenario)
        kp = cfg.motor_kp if kp is None else kp
        kd = cfg.motor_kd if kd is None else kd

        curr = action
        filt_state = state.filter_state
        if cfgc.enable_action_filter:
            filt_state, curr = af.filter_step(self.filter_coeffs, filt_state, curr)
        prev = state.last_filtered_action if cfgc.enable_action_filter else state.last_action

        def command(a):
            return (ci.action_to_command(self.iface, a) if cfgc.is_rl_gym_interface
                    else a).contiguous()

        repeat = cfgc.action_repeat
        if cfgc.enable_action_interpolation:
            # one command per substep, (N, repeat, 12)
            q_des = torch.stack([command(prev + ((i + 1.0) / repeat) * (curr - prev))
                                 for i in range(repeat)], dim=1)
        else:
            q_des = command(curr)
        # the non-RL TORQUE interface commands raw torques (plus the springs)
        torque_mode = not cfgc.is_rl_gym_interface and cfgc.motor_control_mode == "TORQUE"
        out = self.physics(state.robot, state.foot_anchor.contiguous(), q_des, model, params,
                           springs, kp, kd, repeat, ext_force_world, torque_mode)

        state = dataclasses.replace(
            state, robot=out.robot, foot_anchor=out.anchor, filter_state=filt_state,
            # the action actually applied (the raw one without the filter)
            last_action=action, last_filtered_action=curr,
            observed_torques=out.tau_m, spring_torques=out.tau - out.tau_m,
            feet_in_contact=out.feet_in_contact, feet_forces=out.foot_forces,
            invalid_contact=out.invalid_contact,
            sim_step_counter=state.sim_step_counter + cfgc.action_repeat,
            env_step_counter=state.env_step_counter + 1)

        ctx = self._task_ctx(state)
        task_state = tk.task_on_step(self.task_def, state.task, ctx)
        state = dataclasses.replace(state, task=task_state)
        reward = tk.task_reward(self.task_def, task_state, ctx, self.demo_actions,
                                self.demo_len, demo_norm=cfgc.demo_norm)
        task_term = tk.task_terminated(self.task_def, task_state, ctx, self.demo_len)
        timeout = self.sim_time(state) > cfgc.max_ep_len
        done = task_term | timeout
        reward = reward + torch.where(
            done, tk.task_reward_end(self.task_def, task_state, ctx), 0.0)
        obs = self._observe(state, generator)
        info = {
            "task_terminated": task_term,
            "timeout": timeout,
            "max_height": task_state.relative_max_height,
            "max_fwd": task_state.max_forward_distance,
            "feet_forces": state.feet_forces,
            "switched_controller": task_state.switched_controller,
            # the control step's mean motor torque (the physics-fidelity
            # gate's quantity)
            "mean_motor_torque": out.tau_m_sum / repeat,
        }
        return state, obs, reward, done, info

    def _observe(self, state: EnvState, generator) -> torch.Tensor:
        ctx = self._sensor_ctx(state)
        if self.config.obs_noise:
            if generator is None:
                raise ValueError("obs_noise is on: pass a generator for the noise")
            clean = sn.read_obs(self.suite, ctx)
            if isinstance(generator, NoiseStreams):
                return clean + generator.at(state.env_step_counter) * self._obs_noise_std
            return sn.add_obs_noise(clean, self._obs_noise_std, generator)
        return sn.read_obs(self.suite, ctx)

    # ------------------------------------------------------------------
    # the reference getters, (action_dim,) each
    # ------------------------------------------------------------------
    def get_landing_action(self):
        return ci.landing_action(self.iface)

    def get_settling_action(self):
        return ci.settling_action(self.iface)

    def get_init_action(self):
        return self._init_action
