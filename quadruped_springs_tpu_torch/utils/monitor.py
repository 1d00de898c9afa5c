"""State monitoring, KPI extraction and plotting: the port of
``quadruped_springs_tpu.utils.monitor``.

Recording is a rollout of N environments that stacks the robot state per
control step (time-major, (T, N, ...) tensors on the env's device); KPIs,
plots and trajectory export read one lane of it on the host. "Video" is
trajectory export through the trajectory store for offline rendering
(utils/render.py). ``plot_rollout`` imports matplotlib when it is called.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from quadruped_springs_tpu_torch.env.env import QuadrupedEnv, select
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.ops import actuation as act


def record_rollout(env: QuadrupedEnv, policy_fn: Callable, generator: torch.Generator,
                   max_steps: int = 200, n: int = 1) -> dict:
    """Roll one episode of n environments for max_steps control steps,
    recording per control step; an environment that is done keeps its last
    state and is marked invalid. policy_fn maps observations (n, obs_dim)
    to actions (n, A) or (A,). Returns a dict of (T, n, ...) tensors."""
    state, obs = env.reset(generator, n)
    done = torch.zeros(n, dtype=torch.bool, device=env.device)
    recs = []
    for _ in range(max_steps):
        action = policy_fn(obs).expand(n, env.action_dim)
        state2, obs2, r, d2, _ = env.step(state, action, generator)
        recs.append({
            "time": env.sim_time(state2),
            "base_pos": state2.robot.pos,
            "base_rpy": sp.quat_to_rpy(state2.robot.quat),
            "base_vel": state2.robot.lin_vel,
            "q": state2.robot.q,
            "qd": state2.robot.qd,
            "tau_motor": state2.observed_torques,
            "tau_spring": state2.spring_torques,
            "feet_forces": state2.feet_forces,
            "feet_contact": state2.feet_in_contact,
            "reward": r,
            "action": action,
            "valid": ~done,
        })
        state = select(done, state, state2)
        obs = torch.where(done[:, None], obs, obs2)
        done = done | d2
    return {k: torch.stack([rec[k] for rec in recs]) for k in recs[0]}


def spring_energy_trace(env: QuadrupedEnv, recs) -> torch.Tensor:
    """Per step and environment, the total elastic energy Σ ½k(q-q̄)² of
    the engaged springs, (T, n)."""
    cfg = env.cfg
    return act.spring_energy(recs["q"], cfg.spring_stiffness, cfg.spring_rest_angles,
                             env.engage_sign).sum(-1)


def _lane(recs, lane: int) -> dict:
    return {k: v[:, lane].cpu().numpy() for k, v in recs.items()}


def kpis(recs, lane: int = 0) -> dict:
    """One environment's episode KPIs (the EvaluationWrapper infos)."""
    r = _lane(recs, lane)
    valid = r["valid"]
    z = r["base_pos"][:, 2]
    x = r["base_pos"][:, 0]
    return {
        "steps": int(valid.sum()),
        "return": float(r["reward"][valid].sum()) if valid.any() else 0.0,
        "max_height": float(z[valid].max()) if valid.any() else 0.0,
        "max_fwd": float(x[valid].max()) if valid.any() else 0.0,
        "peak_feet_force": float(
            r["feet_forces"].sum(-1)[valid].max()) if valid.any() else 0.0,
        "flight_fraction": float(
            (~r["feet_contact"].any(-1))[valid].mean()) if valid.any() else 0.0,
    }


def export_trajectory(path: str, recs, lane: int = 0) -> None:
    """Persist one environment's valid steps through the trajectory store
    (render offline from state)."""
    from quadruped_springs_tpu_torch.runtime import trajstore
    r = _lane(recs, lane)
    valid = r["valid"]
    cols = [r[k].reshape(valid.shape[0], -1) for k in
            ("time", "base_pos", "base_rpy", "base_vel", "q", "qd",
             "tau_motor", "tau_spring", "feet_forces")]
    rows = np.concatenate(cols, axis=1)[valid].astype(np.float32)
    trajstore.write(path, rows)


JOINT_TYPES = ("hip", "thigh", "calf")


def plot_rollout(recs, path_prefix: str, env: QuadrupedEnv | None = None,
                 spring_energy=None, lane: int = 0) -> list:
    """The ten MonitorState plot families of one environment (height,
    angles, motor_torque, motor_true_velocity, feet_normal_forces,
    elastic_potential_energy, forward_jumping, pitch, pitch_rate, actions)
    saved as PNGs, headless; returns the paths. Pass `env` to draw the
    torque and velocity limits and the per-joint-type spring energy."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    r = _lane(recs, lane)
    valid = r["valid"]
    t = r["time"][valid]
    q = r["q"][valid]
    qd = r["qd"][valid]
    tau = r["tau_motor"][valid]
    pos = r["base_pos"][valid]
    rpy = r["base_rpy"][valid]
    actions = r["action"][valid]
    out = []

    def fig_save(name, fig):
        p = f"{path_prefix}_{name}.png"
        fig.savefig(p, dpi=100, bbox_inches="tight")
        plt.close(fig)
        out.append(p)

    def per_type_rows(title, data, limits=None, unit=""):
        """3 stacked axes (hip/thigh/calf), 4 legs per axis, dashed limits."""
        fig, axs = plt.subplots(nrows=3, sharex=True, figsize=(8, 7))
        fig.suptitle(title)
        for j, (ax, nm) in enumerate(zip(axs, JOINT_TYPES)):
            ax.plot(t, data[:, j + np.array([0, 3, 6, 9])])
            if limits is not None:
                ax.plot(t, np.full_like(t, limits[j]), "k--", lw=0.8)
                ax.plot(t, np.full_like(t, -limits[j]), "k--", lw=0.8)
            ax.set_ylabel(f"{nm} {unit}")
        axs[-1].set_xlabel("time [s]")
        return fig

    tl = env.cfg.torque_limits[:3].cpu().numpy() if env is not None else None
    vl = env.cfg.velocity_limits[:3].cpu().numpy() if env is not None else None

    # 1 height(t)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(t, pos[:, 2])
    fig.suptitle("height(t)")
    ax.set_xlabel("time [s]"); ax.set_ylabel("h [m]")
    fig_save("height", fig)
    # 2 motor angles
    fig_save("angles", per_type_rows("motor angles", q, unit="[rad]"))
    # 3 motor torques (with limits)
    fig_save("motor_torque", per_type_rows("motor torques", tau, tl, "[Nm]"))
    # 4 motor velocities (with limits)
    fig_save("motor_true_velocity",
             per_type_rows("motor velocities", qd, vl, "[rad/s]"))
    # 5 feet normal forces
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(t, r["feet_forces"][valid])
    fig.suptitle("feet normal forces")
    ax.set_xlabel("time [s]"); ax.set_ylabel("F [N]")
    fig_save("feet_normal_forces", fig)
    # 6 elastic potential energy per joint type
    fig, axs = plt.subplots(nrows=3, sharex=True, figsize=(8, 7))
    fig.suptitle("elastic energy")
    if spring_energy is None and env is not None:
        e12 = act.spring_energy(torch.as_tensor(q, device=env.device),
                                env.cfg.spring_stiffness, env.cfg.spring_rest_angles,
                                env.engage_sign).cpu().numpy()
    else:
        e12 = None
    for j, (ax, nm) in enumerate(zip(axs, JOINT_TYPES)):
        if e12 is not None:
            ax.plot(t, e12[:, j + np.array([0, 3, 6, 9])])
        ax.set_ylabel(f"{nm} [J]")
    axs[-1].set_xlabel("time [s]")
    fig_save("elastic_potential_energy", fig)
    # 7 forward jumping x-z path
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(pos[:, 0], pos[:, 2])
    fig.suptitle("Jump forward motion")
    ax.set_xlabel("x [m]"); ax.set_ylabel("h [m]")
    fig_save("forward_jumping", fig)
    # 8 pitch
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(t, rpy[:, 1])
    ax.set_title("pitch"); ax.set_xlabel("time [s]"); ax.set_ylabel("p [rad]")
    fig_save("pitch", fig)
    # 9 pitch rate (finite difference of recorded pitch)
    fig, ax = plt.subplots(figsize=(8, 4))
    if len(t) > 1:
        ax.plot(t[1:], np.diff(np.unwrap(rpy[:, 1])) / np.maximum(np.diff(t), 1e-9))
    ax.set_title("pitch rate"); ax.set_xlabel("time [s]")
    ax.set_ylabel("dp/dt [rad/s]")
    fig_save("pitch_rate", fig)
    # 10 actions 2x3 grid (front / rear x hip/thigh/calf)
    fig, axs = plt.subplots(nrows=2, ncols=3, sharex=True, sharey=True, figsize=(9, 5))
    fig.suptitle("actions")
    labels = [["hip front", "thigh front", "calf front"],
              ["hip rear", "thigh rear", "calf rear"]]
    A = actions.shape[1]
    for i in range(2):
        for j in range(3):
            idx = i * 3 + j
            if idx < A:
                axs[i][j].plot(np.arange(actions.shape[0]), actions[:, idx])
            axs[i][j].set_ylabel(labels[i][j], fontsize=8)
            axs[i][j].set_xlabel("time steps", fontsize=8)
    fig_save("actions", fig)
    return out
