"""Tasks (reward and termination), batched over environments.

Port of ``quadruped_springs_tpu.tasks.tasks``: every task is a static
``TaskDef``, a ``TaskState`` of (N, ...) tensors and branch-free update,
reward and termination functions, so N environments in different phases
update in one pass. Registry keys, constants and formulas are the JAX
module's (which names their sources in the reference).

The continuous-jumping tasks keep per-jump statistics in fixed (N,
MAX_JUMPS) buffers, written per lane by a scatter at the lane's own
jump_counter and never past capacity; the mean, max and last-jump
statistics are streaming accumulators, exact at any jump count.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from quadruped_springs_tpu_torch.models import spatial as sp

MAX_JUMPS = 128
_G = 9.81       # take-off detector constant


@dataclasses.dataclass(frozen=True)
class TaskCtx:
    """What the tasks read each control step, for N environments."""
    pos: torch.Tensor                # (N,3) base position, world
    lin_vel: torch.Tensor            # (N,3)
    rpy: torch.Tensor                # (N,3) roll-pitch-yaw
    quat: torch.Tensor               # (N,4)
    q: torch.Tensor                  # (N,12)
    qd: torch.Tensor                 # (N,12)
    motor_torques: torch.Tensor      # (N,12) observed (PD-clipped) torques
    feet_in_contact: torch.Tensor    # (N,4) bool
    feet_forces: torch.Tensor        # (N,4) normal force magnitudes
    invalid_contact: torch.Tensor    # (N,) bool
    sim_time: torch.Tensor           # (N,) seconds
    is_flying: torch.Tensor          # (N,) bool, all feet off the ground
    last_action: torch.Tensor        # (N,action_dim)
    is_fallen_height: float = 0.10


@dataclasses.dataclass(frozen=True)
class TaskState:
    """The union of every task's state (unused fields keep their defaults);
    every field has a leading N."""
    switched_controller: torch.Tensor   # bool
    all_feet_in_air: torch.Tensor       # bool
    time_take_off: torch.Tensor
    pose_take_off: torch.Tensor         # (N,3)
    yaw_take_off: torch.Tensor
    init_height: torch.Tensor
    max_flight_time: torch.Tensor
    max_forward_distance: torch.Tensor
    max_pitch: torch.Tensor             # |rpy pitch| tracker
    relative_max_height: torch.Tensor
    max_delta_x: torch.Tensor
    max_height: torch.Tensor            # max |z|
    old_torque: torch.Tensor            # (N,12)
    new_torque: torch.Tensor            # (N,12)
    max_pitch_bf: torch.Tensor          # backflip: unwrapped-pitch tracker
    old_fwd: torch.Tensor               # JUMPING_FORWARD_PPO
    actual_fwd: torch.Tensor
    cumulative_fwd: torch.Tensor        # continuous jumping (v1)
    cumulative_flight_time: torch.Tensor
    is_jumping: torch.Tensor            # bool
    fwd_array: torch.Tensor             # (N,MAX_JUMPS) continuous (v2 / PPO)
    height_array: torch.Tensor          # (N,MAX_JUMPS)
    performance_array: torch.Tensor     # (N,MAX_JUMPS)
    jump_counter: torch.Tensor          # int32
    good_jump_counter: torch.Tensor     # int32
    max_jump_height: torch.Tensor
    first_jump: torch.Tensor            # bool
    end_jump: torch.Tensor              # bool
    fwd_sum: torch.Tensor               # streaming per-jump sums
    height_sum: torch.Tensor
    perf_sum: torch.Tensor
    max_perf: torch.Tensor
    last_perf: torch.Tensor
    demo_counter: torch.Tensor          # int32, demo tasks
    demo_start: torch.Tensor            # int32, the RSI spawn index


def init_task_state(ctx: TaskCtx) -> TaskState:
    n, dev = ctx.pos.shape[0], ctx.pos.device
    f = lambda: torch.zeros(n, dtype=torch.float32, device=dev)
    i = lambda: torch.zeros(n, dtype=torch.int32, device=dev)
    b = lambda v: torch.full((n,), v, dtype=torch.bool, device=dev)
    buf = lambda: torch.zeros(n, MAX_JUMPS, dtype=torch.float32, device=dev)
    return TaskState(
        switched_controller=b(False), all_feet_in_air=b(False),
        time_take_off=ctx.sim_time.to(torch.float32), pose_take_off=ctx.pos,
        yaw_take_off=ctx.rpy[:, 2], init_height=ctx.pos[:, 2],
        max_flight_time=f(), max_forward_distance=f(), max_pitch=f(),
        relative_max_height=f(), max_delta_x=f(), max_height=f(),
        old_torque=ctx.motor_torques, new_torque=ctx.motor_torques,
        max_pitch_bf=f(), old_fwd=f(), actual_fwd=f(), cumulative_fwd=f(),
        cumulative_flight_time=f(), is_jumping=b(False),
        fwd_array=buf(), height_array=buf(), performance_array=buf(),
        jump_counter=i(), good_jump_counter=i(), max_jump_height=f(),
        first_jump=b(True), end_jump=b(False), fwd_sum=f(), height_sum=f(),
        perf_sum=f(), max_perf=f(), last_perf=f(), demo_counter=i(), demo_start=i())


_replace = dataclasses.replace


# ---------------------------------------------------------------------------
# Shared machinery, branch-free
# ---------------------------------------------------------------------------

def _time_to_peak(ctx: TaskCtx):
    return ctx.lin_vel[:, 2] / _G


def jumping_distance(ts: TaskState, ctx: TaskCtx):
    """Yaw-aligned forward distance since take-off, floored at 0."""
    yaw = ts.yaw_take_off
    d = ctx.pos - ts.pose_take_off
    return torch.clamp_min(torch.cos(yaw) * d[:, 0] + torch.sin(yaw) * d[:, 1], 0.0)


def _update_common(ts: TaskState, ctx: TaskCtx, continuous: bool,
                   track_fwd_in_flight: bool = True) -> TaskState:
    """The per-step jumping bookkeeping as one branch-free update."""
    switch = ts.switched_controller | (ctx.is_flying & (_time_to_peak(ctx) > 0.06))
    z = ctx.pos[:, 2]
    rel_max_h = torch.maximum(ts.relative_max_height,
                              torch.clamp_min(z - ts.init_height, 0.0))
    max_h = torch.maximum(ts.max_height, z.abs())
    max_dx = torch.maximum(ts.max_delta_x, ctx.pos[:, 0].abs())
    max_pitch = torch.maximum(ts.max_pitch, ctx.rpy[:, 1].abs())

    entering_flight = ctx.is_flying & ~ts.all_feet_in_air
    in_flight = ctx.is_flying & ts.all_feet_in_air
    landing = ~ctx.is_flying & ts.all_feet_in_air
    grounded = ~ctx.is_flying & ~ts.all_feet_in_air

    time_take_off = torch.where(entering_flight, ctx.sim_time, ts.time_take_off)
    pose_take_off = torch.where(entering_flight[:, None], ctx.pos, ts.pose_take_off)
    yaw_take_off = torch.where(entering_flight, ctx.rpy[:, 2], ts.yaw_take_off)

    jd = jumping_distance(_replace(ts, pose_take_off=pose_take_off,
                                   yaw_take_off=yaw_take_off), ctx)
    fwd = ts.max_forward_distance
    fwd_update = (in_flight | landing) if track_fwd_in_flight else landing
    fwd = torch.where(fwd_update, torch.maximum(fwd, jd), fwd)
    if not continuous:
        fwd = torch.where(grounded, torch.zeros_like(fwd), fwd)

    flight_time = torch.where(
        landing, torch.maximum(ctx.sim_time - time_take_off, ts.max_flight_time),
        ts.max_flight_time)
    return _replace(
        ts, switched_controller=switch, all_feet_in_air=ctx.is_flying,
        time_take_off=time_take_off, pose_take_off=pose_take_off,
        yaw_take_off=yaw_take_off, max_flight_time=flight_time,
        max_forward_distance=fwd, max_pitch=max_pitch, relative_max_height=rel_max_h,
        max_delta_x=max_dx, max_height=max_h, old_torque=ts.new_torque,
        new_torque=ctx.motor_torques)


def is_fallen(ctx: TaskCtx):
    """Local up tilted below 0.85 and the base below the fallen height."""
    local_up_z = sp.quat_to_mat(ctx.quat)[:, 2, 2]
    return (local_up_z < 0.85) & (ctx.pos[:, 2] < ctx.is_fallen_height)


def default_terminated(ts: TaskState, ctx: TaskCtx):
    return is_fallen(ctx) | ctx.invalid_contact


def _norm(v):
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=-1), 1e-12))


# ---------------------------------------------------------------------------
# Task definitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TaskDef:
    """Static task definition; `kind` selects the update and reward family."""
    name: str
    kind: str
    continuous: bool = False
    max_height_task: float = 0.9
    max_forward_distance_task: float = 1.3
    min_height: float = 0.29
    max_height: float = 1.0
    max_contact_force: float = 800.0
    k_h: float = 0.023
    k_tau: float = 0.015
    k_tau_sigma: float = 0.1
    k_contact: float = 3e-4
    k_pos: float = 0.013
    k_pos_sigma: float = 40.0
    k_pitch: float = 0.014
    k_pitch_sigma: float = 26.0
    k_fwd: float = 0.038
    max_fwd: float = 1.3
    k_energy: float = 0.0035
    k_energy_sigma: float = 0.01
    jump_limit: float = 0.5
    time_limit: float = 1.0
    height_limit: float = 0.5
    fwd_weight: float = 0.7
    height_weight: float = 0.3
    performance_bound: float = 0.85
    bf_max_height: float = 0.7
    bf_min_height: float = 0.3
    max_ep_len: float = 10.0
    max_height_randomized: float = 0.0
    max_fwd_randomized: float = 0.0


def task_on_step(td: TaskDef, ts: TaskState, ctx: TaskCtx) -> TaskState:
    if td.kind == "no_task":
        return ts
    if td.kind in ("continuous", "continuous_ppo", "continuous_demo"):
        if td.kind == "continuous" and td.name != "CONTINUOUS_JUMPING_FORWARD3":
            return _on_step_continuous_v1(td, ts, ctx)
        return _on_step_continuous_v2(td, ts, ctx)
    ts = _update_common(ts, ctx, continuous=False)
    if td.kind in ("backflip", "backflip_ppo"):
        pitch_bf = sp.pitch_unwrapped_yxz(ctx.quat, ts.switched_controller)
        ts = _replace(ts, max_pitch_bf=torch.maximum(ts.max_pitch_bf, pitch_bf))
    if td.name.startswith("JUMPING_FORWARD_PPO"):
        ts = _replace(ts, old_fwd=ts.actual_fwd, actual_fwd=ts.max_forward_distance)
    if td.kind == "demo":
        ts = _replace(ts, demo_counter=ts.demo_counter + 1)
    return ts


def _on_step_continuous_v1(td: TaskDef, ts: TaskState, ctx: TaskCtx) -> TaskState:
    ts2 = _update_common(ts, ctx, continuous=True, track_fwd_in_flight=False)
    entering = ctx.is_flying & ~ts.all_feet_in_air
    landing = ~ctx.is_flying & ts.all_feet_in_air
    is_jumping = torch.where(entering, _time_to_peak(ctx) > 0.06,
                             ts.is_jumping & ~landing)
    # as in the reference, the running max fwd / flight time accumulates
    cum_fwd = torch.where(
        landing, ts.cumulative_fwd + torch.clamp_max(ts2.max_forward_distance,
                                                     td.jump_limit),
        ts.cumulative_fwd)
    cum_ft = torch.where(
        landing, ts.cumulative_flight_time + torch.clamp_max(ts2.max_flight_time,
                                                             td.time_limit),
        ts.cumulative_flight_time)
    return _replace(ts2, is_jumping=is_jumping, cumulative_fwd=cum_fwd,
                    cumulative_flight_time=cum_ft)


def _on_step_continuous_v2(td: TaskDef, ts: TaskState, ctx: TaskCtx) -> TaskState:
    ts2 = _update_common(ts, ctx, continuous=True)
    entering = ctx.is_flying & ~ts.all_feet_in_air
    in_flight = ctx.is_flying & ts.all_feet_in_air
    landing = ~ctx.is_flying & ts.all_feet_in_air
    z = ctx.pos[:, 2]

    max_jh = torch.where(entering, z, torch.where(
        in_flight, torch.maximum(ts.max_jump_height, z), ts.max_jump_height))
    is_jumping = torch.where(entering, _time_to_peak(ctx) > 0.06,
                             ts.is_jumping & ~landing)
    # end-of-jump statistics (the very first landing is not a jump)
    record = landing & ~ts.first_jump
    jd = torch.clamp_max(jumping_distance(ts2, ctx), td.jump_limit)
    jh = torch.clamp_max(max_jh, td.height_limit)
    perf = td.fwd_weight * jd / td.jump_limit + td.height_weight * jh / td.height_limit
    # each lane writes its own slot; never past capacity
    in_buf = (record & (ts.jump_counter < MAX_JUMPS))[:, None]
    idx = torch.clamp_max(ts.jump_counter, MAX_JUMPS - 1).long()[:, None]

    def put(buf, v):
        return torch.where(in_buf, buf.scatter(1, idx, v[:, None]), buf)

    rec_f = record.to(torch.float32)
    new = _replace(
        ts2, is_jumping=is_jumping, max_jump_height=max_jh,
        fwd_array=put(ts.fwd_array, jd), height_array=put(ts.height_array, jh),
        performance_array=put(ts.performance_array, perf),
        jump_counter=ts.jump_counter + record.to(torch.int32),
        good_jump_counter=ts.good_jump_counter
        + (record & (perf >= td.performance_bound)).to(torch.int32),
        first_jump=ts.first_jump & ~landing, end_jump=record,
        fwd_sum=ts.fwd_sum + rec_f * jd, height_sum=ts.height_sum + rec_f * jh,
        perf_sum=ts.perf_sum + rec_f * perf,
        max_perf=torch.where(record, torch.maximum(ts.max_perf, perf), ts.max_perf),
        last_perf=torch.where(record, perf, ts.last_perf))
    if td.kind == "continuous_demo":
        new = _replace(new, demo_counter=ts.demo_counter + 1)
    return new


# ---------------------------------------------------------------------------
# Dense (per-step) rewards
# ---------------------------------------------------------------------------

def _clipped_height(td: TaskDef, ctx: TaskCtx):
    h = ctx.pos[:, 2]
    ok = (h >= td.min_height) & (h <= td.max_height)
    return torch.where(ok, h, torch.zeros_like(h))


def _over_contact_force(td: TaskDef, ctx: TaskCtx, excess_only: bool):
    f = ctx.feet_forces.sum(-1)
    val = f - td.max_contact_force if excess_only else f
    return torch.where(f > td.max_contact_force, val, torch.zeros_like(f))


def _rew_smoothing(td: TaskDef, ts: TaskState):
    return td.k_tau * torch.exp(-td.k_tau_sigma * _norm(ts.old_torque - ts.new_torque))


def _zeros(ctx: TaskCtx):
    return torch.zeros(ctx.pos.shape[0], dtype=torch.float32, device=ctx.pos.device)


def task_reward(td: TaskDef, ts: TaskState, ctx: TaskCtx,
                demo_actions: torch.Tensor | None = None,
                demo_len: int | None = None,
                demo_norm: str = "remaining") -> torch.Tensor:
    """Per-step reward (N,); the sparse tasks give 0."""
    k = td.kind
    if k in ("no_task", "sparse", "continuous", "backflip"):
        return _zeros(ctx)

    if k in ("demo", "continuous_demo"):
        # on_step has already advanced the counter: step t is scored
        # against demo action t
        idx = torch.clamp(ts.demo_counter - 1, 0, demo_actions.shape[0] - 1).long()
        r = torch.exp(-0.35 * _norm(demo_actions[idx] - ctx.last_action))
        if demo_norm == "full":
            return r / float(demo_len)
        delta = torch.clamp_min(float(demo_len) - ts.demo_start.to(torch.float32), 1.0)
        return r / delta

    rew_h = td.k_h * _clipped_height(td, ctx)
    rew_smooth = _rew_smoothing(td, ts)
    rew_pitch = td.k_pitch * torch.exp(-td.k_pitch_sigma * ctx.rpy[:, 1].abs())

    if k == "ppo_in_place":
        rew_contact = -td.k_contact * _over_contact_force(td, ctx, excess_only=False)
        rew_pos = td.k_pos * torch.exp(-td.k_pos_sigma * ctx.pos[:, 0].abs())
        return (0.05 * rew_pos + 0.5 * rew_contact + 0.2 * rew_smooth
                + 0.45 * rew_h + 0.3 * rew_pitch)

    if k == "ppo_forward":
        rew_contact = -td.k_contact * _over_contact_force(td, ctx, excess_only=False)
        fwd = ts.actual_fwd
        fwd_ok = (fwd <= td.max_fwd) & (fwd != ts.old_fwd)
        rew_fwd = td.k_fwd * torch.where(fwd_ok, fwd, torch.zeros_like(fwd))
        return (0.4 * rew_contact + 0.2 * rew_smooth + 0.25 * rew_h
                + 0.3 * rew_pitch + 0.4 * rew_fwd)

    if k == "backflip_ppo":
        rew_contact = -td.k_contact * _over_contact_force(td, ctx, excess_only=False)
        pitch_bf = sp.pitch_unwrapped_yxz(ctx.quat, ts.switched_controller)
        rew_pitch_bf = td.k_pitch * torch.where(ctx.pos[:, 2] > 0.5, pitch_bf,
                                                torch.zeros_like(pitch_bf))
        return 0.4 * rew_contact + 0.2 * rew_smooth + 0.25 * rew_h + 0.3 * rew_pitch_bf

    if k == "continuous_ppo":
        rew_contact = -td.k_contact * _over_contact_force(td, ctx, excess_only=True)
        rew_pitch_c = rew_pitch * torch.where(ts.is_jumping, 1.5, 1.0)
        actual_fwd = torch.where(ts.is_jumping, jumping_distance(ts, ctx), 0.0)
        rew_fwd = td.k_fwd * actual_fwd
        energy = _norm(ctx.motor_torques * ctx.qd)
        rew_energy = td.k_energy * torch.exp(-td.k_energy_sigma * energy)
        return (0.5 * rew_contact + 0.2 * rew_smooth + 0.3 * rew_h
                + 0.2 * rew_pitch_c + 0.75 * rew_fwd + 0.1 * rew_energy
                + 0.2 * _rew_end_jump(td, ts)) * 0.8

    raise ValueError(f"unknown task kind {k}")


def _entropy_fwd(ts: TaskState):
    """Normalised entropy of the recorded per-jump forward distances (at
    least 3 slots); exact whenever jump_counter <= MAX_JUMPS."""
    n = torch.clamp_min(ts.jump_counter, 3)
    slots = torch.arange(MAX_JUMPS, device=ts.fwd_array.device)
    mask = slots < torch.clamp_max(ts.jump_counter, MAX_JUMPS)[:, None]
    fwd = torch.where(mask, ts.fwd_array, torch.zeros_like(ts.fwd_array))
    total = fwd.sum(-1)
    p = fwd / torch.clamp_min(total, 1e-12)[:, None]
    logp = torch.where(p > 0, torch.log2(torch.clamp_min(p, 1e-12)), torch.zeros_like(p))
    ent = -(p * logp).sum(-1) / torch.log2(n.to(torch.float32))
    valid = (ts.jump_counter > 0) & (total >= 0.05)
    return torch.where(valid, ent, torch.zeros_like(ent))


def _avg_performance(ts: TaskState):
    """Average over the recorded jumps, zero-padded to at least 3."""
    return ts.perf_sum / torch.clamp_min(ts.jump_counter, 3).to(torch.float32)


def _rew_end_jump(td: TaskDef, ts: TaskState):
    rew_entropy = torch.exp((_entropy_fwd(ts) - 1.0) / 0.3)
    active = (~ts.first_jump) & ts.end_jump & (ts.last_perf > 0.8)
    rew = (ts.last_perf * rew_entropy * 0.35 + ts.last_perf * 0.65) * 0.2
    return torch.where(active, rew, torch.zeros_like(rew))


def continuous_jump_stats(ts: TaskState, lane: int = 0) -> dict:
    """Host-side KPIs of one environment of a continuous task: the per-jump
    lists hold the recorded jumps (at most MAX_JUMPS), the means and maxima
    come from the streaming accumulators."""
    n_jumps = int(ts.jump_counter[lane])
    n_rec = min(n_jumps, MAX_JUMPS)
    row = lambda t: [round(float(v), 3) for v in t[lane, :n_rec].cpu().numpy()]
    per = lambda t: round(float(t[lane]) / max(n_jumps, 1), 4)
    return {
        "n_jumps": n_jumps,
        "n_jumps_recorded": n_rec,
        "good_jumps": int(ts.good_jump_counter[lane]),
        "per_jump_fwd_m": row(ts.fwd_array),
        "per_jump_height_m": row(ts.height_array),
        "per_jump_performance": row(ts.performance_array),
        "mean_perf": per(ts.perf_sum),
        "max_perf": round(float(ts.max_perf[lane]), 4),
        "mean_fwd_m": per(ts.fwd_sum),
        "mean_height_m": per(ts.height_sum),
    }


# ---------------------------------------------------------------------------
# End-of-episode rewards
# ---------------------------------------------------------------------------

def task_reward_end(td: TaskDef, ts: TaskState, ctx: TaskCtx) -> torch.Tensor:
    k = td.kind
    terminated = task_terminated(td, ts, ctx)
    pitch_term = lambda: torch.exp(-ts.max_pitch**2 / 0.15**2)

    if k in ("no_task", "demo", "continuous_demo"):
        return _zeros(ctx)

    if td.name == "JUMPING_IN_PLACE":
        h = torch.clamp(ts.relative_max_height / td.max_height_task, 0.0, 1.0)
        r = 0.7 * h + h * 0.3 * pitch_term()
        r = r + h * 0.05 * torch.exp(-ts.max_delta_x**2 / 0.05)
        return r + torch.where(terminated, -0.08 * (1 + 0.8 * h), 0.1 * h)

    if td.name == "JUMPING_FORWARD":
        h = torch.clamp(ts.relative_max_height / td.max_height_task, 0.0, 1.0)
        f = torch.clamp(ts.max_forward_distance / td.max_forward_distance_task, 0.0, 1.0)
        bm = (h + f) / 2
        r = 0.25 * h + 0.5 * f * h + h * 0.25 * pitch_term()
        return r + torch.where(terminated, -0.08 * (1 + 1.2 * bm), 0.1 * bm)

    if td.name == "CONTINUOUS_JUMPING_FORWARD":
        t_n = ts.cumulative_flight_time / td.time_limit
        d_n = ts.cumulative_fwd / td.jump_limit
        bm = (t_n + d_n) / 2
        r = 0.25 * t_n + 0.5 * d_n + t_n * 0.25 * pitch_term()
        return r + torch.where(terminated, 0.0, 0.1 * bm)

    if td.name == "CONTINUOUS_JUMPING_FORWARD2":
        t_n = torch.clamp_max(ts.max_flight_time, td.time_limit) / td.time_limit
        d_n = torch.clamp_max(ts.max_forward_distance, td.jump_limit) / td.jump_limit
        bm = (t_n + d_n) / 2
        r = 0.25 * t_n + 0.5 * d_n + d_n * 0.15 * pitch_term()
        r = r + 0.4 * (ctx.sim_time / td.max_ep_len) * bm
        return r + torch.where(terminated, 0.0, 0.2 * bm)

    if td.name == "CONTINUOUS_JUMPING_FORWARD3":
        avg = _avg_performance(ts)
        rew_ent = torch.exp((_entropy_fwd(ts) - 1.0) / 0.3)
        rew_avg = avg * 0.15 * pitch_term()
        rew_avg = rew_avg + avg * 0.4 * (ctx.sim_time / td.max_ep_len)
        rew_avg = rew_avg + (avg * rew_ent * 0.2 + avg * 0.25)
        r = 0.8 * rew_avg + 0.2 * ts.max_perf + 0.1 * ts.good_jump_counter
        return r + torch.where(terminated, 0.0, 0.2 * avg)

    if td.name == "BACKFLIP":
        span = td.bf_max_height - td.bf_min_height
        h = torch.clamp(ts.max_height - td.bf_min_height, 0.0, span) / span
        p = ts.max_pitch_bf / (2 * math.pi)
        r = 0.4 * p + 0.4 * h + h * p
        return r + torch.where(ts.switched_controller & ~terminated, 0.2, 0.0)

    if k == "ppo_in_place":
        return torch.where(terminated, -0.25 * ts.max_height, 0.0)

    if k == "ppo_forward":
        bonus = 0.05 * (ts.max_forward_distance + ts.max_height) / 2
        return torch.where(terminated, 0.0, bonus)

    if k == "backflip_ppo":
        bonus = 0.2 * (0.7 * ts.max_pitch_bf / 5 + 0.3 * ts.max_height) / 2
        return torch.where(terminated, 0.0, bonus)

    if k == "continuous_ppo":
        r = _avg_performance(ts) * torch.exp((_entropy_fwd(ts) - 1.0) / 0.3)
        return torch.where(terminated, r - 1.0, r)

    raise ValueError(f"unknown task {td.name}")


# ---------------------------------------------------------------------------
# Termination
# ---------------------------------------------------------------------------

def task_terminated(td: TaskDef, ts: TaskState, ctx: TaskCtx,
                    demo_len: int | None = None) -> torch.Tensor:
    if td.kind == "no_task":
        return torch.zeros(ctx.pos.shape[0], dtype=torch.bool, device=ctx.pos.device)
    if td.name in ("BACKFLIP", "BACKFLIP_PPO", "BACKFLIP_DEMO"):
        # backflip: ground height only, no orientation gate
        base = (ctx.pos[:, 2] < ctx.is_fallen_height) | ctx.invalid_contact
    else:
        base = default_terminated(ts, ctx)
    if td.kind in ("demo", "continuous_demo") and demo_len is not None:
        base = base | (ts.demo_counter >= demo_len)
    return base


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def _ppo_common(**kw):
    return dict(
        min_height=0.29, max_contact_force=800.0, k_tau=0.015, k_tau_sigma=0.1,
        k_contact=3e-4, k_pos=0.013, k_pos_sigma=40.0, k_pitch=0.014,
        k_pitch_sigma=26.0, **kw)


TASKS = {
    "NO_TASK": TaskDef("NO_TASK", "no_task"),
    "JUMPING_IN_PLACE": TaskDef("JUMPING_IN_PLACE", "sparse", max_height_task=0.9),
    "JUMPING_FORWARD": TaskDef(
        "JUMPING_FORWARD", "sparse", max_height_task=0.3, max_forward_distance_task=1.3),
    "JUMPING_IN_PLACE_PPO": TaskDef(
        "JUMPING_IN_PLACE_PPO", "ppo_in_place", max_height=1.0, k_h=0.023,
        **_ppo_common()),
    "JUMPING_IN_PLACE_PPO_HP": TaskDef(
        "JUMPING_IN_PLACE_PPO_HP", "ppo_in_place", max_height=1.25, k_h=0.023,
        max_height_randomized=1.1, **_ppo_common()),
    "JUMPING_FORWARD_PPO": TaskDef(
        "JUMPING_FORWARD_PPO", "ppo_forward", max_height=0.9, k_h=0.026,
        k_fwd=0.038, max_fwd=1.3, **_ppo_common()),
    "JUMPING_FORWARD_PPO_HP": TaskDef(
        "JUMPING_FORWARD_PPO_HP", "ppo_forward", max_height=1.1, k_h=0.026,
        k_fwd=0.038, max_fwd=1.4, max_height_randomized=1.0,
        max_fwd_randomized=1.3, **_ppo_common()),
    "BACKFLIP": TaskDef("BACKFLIP", "backflip", bf_max_height=0.7, bf_min_height=0.3),
    "BACKFLIP_PPO": TaskDef(
        "BACKFLIP_PPO", "backflip_ppo", max_height=0.7, k_h=0.026, max_fwd=1.1,
        **_ppo_common()),
    "CONTINUOUS_JUMPING_FORWARD": TaskDef(
        "CONTINUOUS_JUMPING_FORWARD", "continuous", continuous=True,
        jump_limit=0.5, time_limit=0.15),
    "CONTINUOUS_JUMPING_FORWARD2": TaskDef(
        "CONTINUOUS_JUMPING_FORWARD2", "continuous", continuous=True,
        jump_limit=0.5, time_limit=0.35),
    "CONTINUOUS_JUMPING_FORWARD3": TaskDef(
        "CONTINUOUS_JUMPING_FORWARD3", "continuous", continuous=True,
        jump_limit=0.6, height_limit=0.45, fwd_weight=0.7, height_weight=0.3,
        performance_bound=0.7),
    "CONTINUOUS_JUMPING_FORWARD_PPO": TaskDef(
        "CONTINUOUS_JUMPING_FORWARD_PPO", "continuous_ppo", continuous=True,
        min_height=0.35, max_height=0.5, max_contact_force=600.0, max_fwd=0.9,
        k_h=0.006, k_tau=0.0032, k_tau_sigma=0.15, k_contact=6e-5,
        k_pitch=0.0043, k_pitch_sigma=26.0, k_fwd=0.0075, k_energy=0.0035,
        k_energy_sigma=0.01, jump_limit=0.6, height_limit=0.5,
        fwd_weight=0.7, height_weight=0.3, performance_bound=0.85),
    "JUMPING_IN_PLACE_DEMO": TaskDef("JUMPING_IN_PLACE_DEMO", "demo"),
    "JUMPING_FORWARD_DEMO": TaskDef("JUMPING_FORWARD_DEMO", "demo"),
    "BACKFLIP_DEMO": TaskDef("BACKFLIP_DEMO", "demo"),
    "CONTINUOUS_JUMPING_FORWARD_DEMO": TaskDef(
        "CONTINUOUS_JUMPING_FORWARD_DEMO", "continuous_demo", continuous=True,
        jump_limit=0.5, height_limit=0.5),
}


def get_task(name: str) -> TaskDef:
    try:
        return TASKS[name]
    except KeyError:
        raise KeyError(f"unknown task {name!r}; available: {sorted(TASKS)}") from None


def apply_curriculum(td: TaskDef) -> TaskDef:
    """The parameter change applied when env randomization has a curriculum."""
    changes = {}
    if td.max_height_randomized > 0:
        changes["max_height"] = td.max_height_randomized
    if td.max_fwd_randomized > 0:
        changes["max_fwd"] = td.max_fwd_randomized
    return dataclasses.replace(td, **changes) if changes else td
