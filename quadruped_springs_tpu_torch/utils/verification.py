"""Golden-trace verification: the acceptance gate of BASELINE.json.

Port of ``quadruped_springs_tpu.utils.verification`` (its docstring gives
the gate's rationale). Replays stored action sequences through the port's
simulator and compares the joint-torque and state traces against a stored
trace: either one recorded by a simulator (``record_golden_trace``) or one
from the independent rigid-contact LCP oracle (``record_oracle_trace``,
``utils/lcp_oracle.py``), which ``tests/data/oracle_*.qsts`` hold for the
four jump tasks with springs and two without.

Trace format: trajstore rows
  [t(1), action(A), q(12), qd(12), tau_motor(12), tau_mean(12),
   base pos(3), quat(4), lin vel(3), ang vel(3)]
tau_motor is the last substep's motor torque, tau_mean the control step's
mean motor torque; the <2% gate runs on tau_mean.

``record_golden_trace`` is batched over N action sequences that share one
environment: actions (N,T,A) give rows (N,T,row), kept on the device and
stacked once at the end. The gate's phase logic is NumPy on the host.

CLI (the card unless --device names another):
  python -m quadruped_springs_tpu_torch.utils.verification record OUT.qsts
  python -m quadruped_springs_tpu_torch.utils.verification verify TRACE.qsts
  python -m quadruped_springs_tpu_torch.utils.verification record-oracle TASK OUT.qsts
  python -m quadruped_springs_tpu_torch.utils.verification verify-oracle TASK TRACE.qsts
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from quadruped_springs_tpu_torch.control import interfaces as ci
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.ops import actuation as act
from quadruped_springs_tpu_torch.runtime import trajstore
from quadruped_springs_tpu_torch.utils import lcp_oracle as lo


def _row(env, t, action, state, tau_mean):
    r = state.robot
    return torch.cat([t[:, None], action, r.q, r.qd, state.observed_torques, tau_mean,
                      r.pos, r.quat, r.lin_vel, r.ang_vel], dim=-1)


def record_golden_trace(env: QuadrupedEnv, actions: torch.Tensor,
                        generator: torch.Generator) -> torch.Tensor:
    """Roll N action sequences (N,T,A) from one reset of N environments;
    return the (N,T,row) trace on the env's device."""
    n, horizon = actions.shape[:2]
    state, _ = env.reset(generator, n)
    rows = []
    for t in range(horizon):
        action = actions[:, t]
        state, _, _, _, info = env.step(state, action, generator)
        rows.append(_row(env, env.sim_time(state), action, state,
                         info["mean_motor_torque"]))
    return torch.stack(rows, dim=1)


def split_trace(trace: np.ndarray, action_dim: int):
    A = action_dim
    out = {}
    off = 1
    out["t"] = trace[:, 0]
    out["action"] = trace[:, off:off + A]; off += A
    out["q"] = trace[:, off:off + 12]; off += 12
    out["qd"] = trace[:, off:off + 12]; off += 12
    out["tau"] = trace[:, off:off + 12]; off += 12
    out["tau_mean"] = trace[:, off:off + 12]; off += 12
    out["pos"] = trace[:, off:off + 3]; off += 3
    out["quat"] = trace[:, off:off + 4]; off += 4
    return out


def classify_phases(ref, action_dim: int, stance_z: float | None = None,
                    event_window: int = 3):
    """Label each knot of a reference trace for the phase-resolved gate:
    0 = static (quiet stance or ballistic flight), 1 = loaded-dynamic
    (commands ramping or the body in motion), 2 = impact (windows of
    `event_window` knots around real flight boundaries). `stance_z` defaults
    to the trace's own settled height before the first commanded change.
    Returns (labels, flight, starts, ends). The JAX module explains each
    threshold."""
    z = ref["pos"][:, 2]
    T = len(z)
    if stance_z is None:
        da0 = np.abs(np.diff(ref["action"], axis=0)).max(axis=1)
        changed = np.where(da0 > 1e-6)[0]
        lead = int(changed[0]) + 1 if len(changed) else T
        stance_z = float(np.median(z[:max(min(lead, T // 4), 1)]))
    flight = z > stance_z + 0.06
    # "loaded-dynamic" = commands ramping recently OR the body still in
    # motion (e.g. the crouch-catch rebound after the ramp ended): static
    # means truly quiescent stance.
    moving = np.zeros(T, bool)
    da = np.abs(np.diff(ref["action"], axis=0)).max(axis=1)
    idx = np.where(da > 1e-6)[0]
    for i in idx:
        moving[max(i - 1, 0):min(i + 12, T)] = True
    dz = np.abs(np.gradient(z))
    moving |= dz > 0.0015  # >0.15 m/s body motion
    labels = np.where(moving & ~flight, 1, 0)
    # impact windows around flight-interval boundaries. Only REAL jumps
    # count as flight events (≥5 knots long, apex ≥ stance+0.10 m) —
    # post-landing rebounds that graze the threshold are impact, not
    # flight.
    impact = np.zeros(T, bool)
    f = flight.astype(int)
    raw_starts = list(np.where(np.diff(f) == 1)[0] + 1)
    raw_ends = list(np.where(np.diff(f) == -1)[0] + 1)
    starts, ends = [], []
    for s in raw_starts:
        e = next((e for e in raw_ends if e > s), T)
        if (e - s) >= 5 and z[s:e].max() > stance_z + 0.10:
            starts.append(int(s))
            if e < T:
                ends.append(int(e))
        else:
            impact[max(s - 2, 0):min(e + 4, T)] = True
            flight[s:e] = False
    w = event_window + 1
    for s in starts:
        impact[max(s - w, 0):min(s + w, T)] = True
    for e in ends:
        impact[max(e - w, 0):min(e + 10, T)] = True
    labels = np.where(flight & ~impact, 0, labels)
    labels = np.where(impact, 2, labels)
    return labels, flight, list(starts), list(ends)


def verify_against_trace(env: QuadrupedEnv, trace_path: str,
                         generator: torch.Generator, tol_frac: float = 0.02,
                         tol_dynamic: float = 0.05,
                         tol_event_knots: int = 3,
                         tol_apex_m: float = 0.03) -> dict:
    """Replay the trace's actions on one environment; the phase-resolved
    fidelity gate against the stored trace. Torque deviations are knot-mean
    motor torque as a fraction of the torque limit.

    "pass" needs, up to the first touchdown: static and flight knots within
    tol_frac, loaded-dynamic knots within tol_dynamic; the same number of
    flights with every toe-off and touchdown within tol_event_knots; each
    apex within tol_apex_m; and the replay ending upright iff the stored run
    does. Post-touchdown knots are reported, not gated (see the JAX module).
    """
    trace = trajstore.read(trace_path)
    ref = split_trace(trace, env.action_dim)
    actions = torch.as_tensor(ref["action"], device=env.device)[None]
    rows = record_golden_trace(env, actions, generator)[0].cpu().numpy()
    got = split_trace(rows, env.action_dim)

    tau_lim = env.cfg.torque_limits.cpu().numpy()
    dev = (np.abs(got["tau_mean"] - ref["tau_mean"]) / tau_lim).max(axis=1)
    tau_dev_instant = np.abs(got["tau"] - ref["tau"]) / tau_lim
    z_ref = ref["pos"][:, 2]
    z_got = got["pos"][:, 2]

    labels, flight_ref, starts_ref, ends_ref = classify_phases(
        ref, env.action_dim, event_window=tol_event_knots)
    _, flight_got, starts_got, ends_got = classify_phases(
        got, env.action_dim, event_window=tol_event_knots)

    T = len(dev)
    first_td = min(ends_ref + ends_got) if (ends_ref or ends_got) else T
    pre = np.arange(T) < (first_td - 2)
    m_static = pre & (labels == 0)
    m_dyn = pre & (labels == 1)
    static_max = float(dev[m_static].max()) if m_static.any() else 0.0
    dynamic_max = float(dev[m_dyn].max()) if m_dyn.any() else 0.0

    # contact-event timing: match each oracle event to the nearest of ours
    def event_offsets(ev_ref, ev_got):
        offs = []
        for e in ev_ref:
            if len(ev_got) == 0:
                return [10**3]
            offs.append(int(min(abs(g - e) for g in ev_got)))
        return offs or [0]

    ev_off = max(event_offsets(starts_ref, starts_got)
                 + event_offsets(ends_ref, ends_got))
    n_flights_match = len(starts_ref) == len(starts_got)

    # per-flight apex comparison
    apex_devs = []
    for s_r, e_r in zip(starts_ref, ends_ref):
        apex_devs.append(abs(float(z_ref[s_r:e_r].max())
                             - float(z_got[s_r:min(e_r + 6, T)].max())))
    apex_max = max(apex_devs) if apex_devs else 0.0

    def _upright(tr):
        return bool(tr["pos"][-1, 2] > 0.20) and bool(
            abs(tr["quat"][-1, 0]) + abs(tr["quat"][-1, 1]) < 0.3)

    # behavioral equality: the replay ends upright iff the oracle run does
    # (a scripted partial backflip may legitimately end tipped in both)
    upright = _upright(got) == _upright(ref)

    report = {
        "steps": int(trace.shape[0]),
        # domain accounting: what fraction of knots each gate tier covers
        "gated_fraction_strict": float(m_static.mean()),
        "gated_fraction_dynamic": float(m_dyn.mean()),
        "gated_fraction_event_only": float((pre & (labels == 2)).mean()),
        "ungated_fraction_post_touchdown": float((~pre).mean()),
        "static_flight_max_dev_frac": static_max,
        "dynamic_max_dev_frac": dynamic_max,
        "event_timing_max_offset_knots": int(ev_off),
        "n_flights": [len(starts_ref), len(starts_got)],
        "apex_max_dev_m": apex_max,
        "ends_upright": upright,
        "post_impact_max_dev_frac_ungated": float(dev[~pre].max())
        if (~pre).any() else 0.0,
        "mean_torque_dev_frac_pre_touchdown": float(dev[pre].mean())
        if pre.any() else 0.0,
        "max_torque_dev_frac_instant": float(tau_dev_instant[pre].max())
        if pre.any() else 0.0,
        "max_height_dev_m_pre_touchdown": float(
            np.abs(z_got - z_ref)[pre].max()) if pre.any() else 0.0,
        "pass": bool(static_max < tol_frac
                     and dynamic_max < tol_dynamic
                     and n_flights_match
                     and ev_off <= tol_event_knots
                     and apex_max < tol_apex_m
                     and upright),
        "tolerances": {"static_flight": tol_frac, "dynamic": tol_dynamic,
                       "event_knots": tol_event_knots,
                       "apex_m": tol_apex_m},
        "gate": ("phase-resolved knot-mean motor torque vs torque limit "
                 "(pre-touchdown pointwise: static/flight strict + "
                 "loaded-dynamic loose; impacts by event timing, apex, "
                 "and behavioral landing)"),
    }
    return report


def _default_env(device=None):
    return QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="JUMPING_IN_PLACE",
        observation_space_mode="ARS_BASIC", action_space_mode="SYMMETRIC",
        obs_noise=False), device=device)


def fidelity_env(task: str, enable_springs: bool = True, device=None,
                 settling_steps: int = EnvConfig.settling_steps) -> QuadrupedEnv:
    """Deterministic env for physics-fidelity traces on `device` (the card
    unless the caller names another): no randomization (mu=1.0, nominal
    masses and springs, the oracle's setup), no observation noise;
    `enable_springs` picks the PEA robot or the rigid baseline.
    `settling_steps` cuts the env's settle (a test at a reduced size)."""
    return QuadrupedEnv(EnvConfig(
        enable_springs=enable_springs, task_env=task,
        observation_space_mode="ARS_BASIC", action_space_mode="SYMMETRIC",
        env_randomizer_mode="NONE", obs_noise=False, settling_steps=settling_steps),
        device=device)


def _ramped_script(knots, horizon, device):
    """Piecewise-linear action schedule (horizon, A) through (time, pose)
    knots: ramped, not stepped, commands (see the JAX module)."""
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    t = torch.arange(horizon, dtype=torch.float32, device=device)
    out = f32(knots[0][1]).expand(horizon, len(knots[0][1]))
    for (t0, a0), (t1, a1) in zip(knots[:-1], knots[1:]):
        frac = torch.clamp((t - t0) / max(t1 - t0, 1), 0.0, 1.0)[:, None]
        seg = (1 - frac) * f32(a0) + frac * f32(a1)
        out = torch.where((t >= t0)[:, None], seg, out)
    return out


def task_action_script(task: str, horizon: int = 170, device=None) -> torch.Tensor:
    """Scripted SYMMETRIC action sequences (horizon, 6) of the four jump
    motions (settle stance -> crouch -> launch -> flight -> landing ->
    go-to-rest), the fidelity gate's workloads; on `device` (the card unless
    the caller names another). Layout: [hip, thigh, calf] x (front pair,
    rear pair)."""
    device = torch.device(device if device is not None else "cuda")
    stand = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    crouch = [0.0, 0.4, -0.8, 0.0, 0.4, -0.8]
    land = [0.0, 0.2, -0.4, 0.0, 0.2, -0.4]

    def one_jump(extend):
        return _ramped_script(
            [(0, stand), (10, crouch), (28, crouch), (34, extend),
             (44, extend), (52, land), (100, land), (112, stand),
             (horizon - 1, stand)], horizon, device)

    if task == "JUMPING_IN_PLACE":
        return one_jump([0.0, -0.4, 1.0, 0.0, -0.4, 1.0])
    if task == "JUMPING_FORWARD":
        # thighs swept back on extension -> forward launch
        return one_jump([0.0, -0.55, 1.0, 0.0, -0.3, 0.85])
    if task == "BACKFLIP":
        # rear legs extend harder -> pitch-back rotation
        return one_jump([0.0, -0.2, 0.6, 0.0, -0.6, 1.0])
    if task == "CONTINUOUS_JUMPING_FORWARD":
        # two jump cycles + go-to-rest: the open-loop comparability limit
        extend = [0.0, -0.5, 1.0, 0.0, -0.3, 0.8]
        cyc = []
        for k in range(2):
            o = 10 + 55 * k
            cyc += [(o, crouch), (o + 18, crouch), (o + 24, extend),
                    (o + 32, extend), (o + 38, land)]
        return _ramped_script(
            [(0, stand)] + cyc + [(135, land), (147, stand),
                                  (horizon - 1, stand)], horizon, device)
    raise KeyError(f"no action script for task {task!r}")


def record_oracle_trace(env: QuadrupedEnv, actions: torch.Tensor,
                        settling_steps: int | None = None) -> np.ndarray:
    """Roll the action sequence (T, A) on the rigid-contact LCP oracle.

    Mirrors env.reset + env.step (settle by PD hold, then action_repeat
    1 kHz substeps per control knot with PD + one-sided spring torques,
    velocity clamp), integrating with lcp_oracle.LCPOracle (its smooth terms
    on the env's device) instead of the compliant model. Returns (T, row)
    float64 rows in the trace format.
    """
    cfg = env.cfg
    cfgc = env.config
    if settling_steps is None:
        settling_steps = cfgc.settling_steps
    host = lambda t: t.detach().cpu().numpy().astype(np.float64)
    oracle = lo.LCPOracle(enable_springs=cfgc.enable_springs, device=env.device)
    oracle._vel_lim = host(cfg.velocity_limits)

    kp = host(cfg.motor_kp) * np.ones(12)
    kd = host(cfg.motor_kd) * np.ones(12)
    tlim = host(cfg.torque_limits)
    k12 = np.tile(host(cfg.spring_stiffness), 4)
    d12 = np.tile(host(cfg.spring_damping), 4)
    r12 = np.tile(host(cfg.spring_rest_angles), 4)
    engage_sign = np.asarray(act.SPRING_ENGAGE_SIGN, np.float64)

    def motor_tau(q_des, st):
        return np.clip(-kp * (st.q - q_des) - kd * st.qd, -tlim, tlim)

    def spring_tau(st):
        # the one-sided law of ops/actuation.spring_torque, f64 NumPy
        if not cfgc.enable_springs:
            return np.zeros(12)
        engaged = engage_sign * (st.q - r12) >= 0.0
        return np.where(engaged, -k12 * (st.q - r12) - d12 * st.qd, 0.0)

    st = lo.OracleState(
        pos=np.array([0.0, 0.0, float(cfg.init_position[2])]),
        quat=np.array([0.0, 0.0, 0.0, 1.0]),
        lin_vel=np.zeros(3), ang_vel=np.zeros(3),
        q=host(cfg.init_joint_angles), qd=np.zeros(12))

    settle_q = host(ci.reference_to_command(env.iface, env.iface.init_pose))
    for _ in range(settling_steps):
        st = oracle.step(st, motor_tau(settle_q, st) + spring_tau(st))

    rows = []
    sim_t = 0.0
    q_cmds = host(ci.action_to_command(env.iface, actions.to(env.device, torch.float32)))
    for a, q_des in zip(host(actions), q_cmds):
        tau_sum = np.zeros(12)
        for _ in range(cfgc.action_repeat):
            tau_m = motor_tau(q_des, st)
            tau_sum += tau_m
            st = oracle.step(st, tau_m + spring_tau(st))
            sim_t += cfgc.time_step
        rows.append(np.concatenate([
            [sim_t], a, st.q, st.qd, tau_m, tau_sum / cfgc.action_repeat,
            st.pos, st.quat, st.lin_vel, st.ang_vel]))
    return np.stack(rows)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m quadruped_springs_tpu_torch.utils.verification",
        description="record or verify golden and oracle traces through the port")
    p.add_argument("mode", choices=("record", "verify", "record-oracle", "verify-oracle"))
    p.add_argument("args", nargs="+", metavar="TASK|PATH")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ns = p.parse_args(argv)
    gen = torch.Generator(ns.device).manual_seed(0)
    oracle_mode = ns.mode.endswith("-oracle")
    if len(ns.args) != (2 if oracle_mode else 1):
        p.error(f"{ns.mode} takes {'TASK PATH' if oracle_mode else 'PATH'}")
    if ns.mode == "record":
        env, path = _default_env(ns.device), ns.args[0]
        actions = task_action_script("JUMPING_IN_PLACE", device=ns.device)
        rows = record_golden_trace(env, actions[None], gen)[0]
        trajstore.write(path, rows.cpu().numpy())
        print(f"recorded {rows.shape[0]} steps -> {path}")
    elif ns.mode == "record-oracle":
        task, path = ns.args
        env = fidelity_env(task, device=ns.device)
        rows = record_oracle_trace(env, task_action_script(task, device=ns.device))
        trajstore.write(path, rows)
        print(f"oracle-recorded {rows.shape[0]} steps ({task}) -> {path}")
    elif ns.mode == "verify":
        env = _default_env(ns.device)
        print(json.dumps(verify_against_trace(env, ns.args[0], gen), indent=2))
    else:
        task, path = ns.args
        env = fidelity_env(task, device=ns.device)
        print(json.dumps(verify_against_trace(env, path, gen), indent=2))


if __name__ == "__main__":
    main(sys.argv[1:])
