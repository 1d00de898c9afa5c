"""The JAX package's examples as the port's entry points, one run each.

Each run is the port of one script of examples/, at its configuration, and
returns (and prints as one JSON line) the quantities that script prints:

  episode         examples/run_episode.py: a scripted crouch (30 control
                  steps) then extension through LandingWrapper on a
                  GROUND_RANDOMIZER environment
  cpg             examples/run_cpg.py: Hopf-CPG locomotion in TORQUE mode at
                  1 kHz (action_repeat 1), the CPG integrated and its
                  joint-PD plus Cartesian-PD torques applied every step
  cartesian_jump  examples/run_cartesian_jump.py: the same jump in foot space
                  through the CARTESIAN_PD interface; the example's `result`
  mpc             examples/run_mpc.py: iLQR (H = 25, 6 iterations, 6 line
                  search candidates) on JUMPING_IN_PLACE from the default
                  start; --mppi: MPPI (8 iterations, K = 32) instead;
                  --batch N: N copies solved as one batch
  backflip        examples/run_backflip.py: iLQR on the BACKFLIP cost (H = 60,
                  14 iterations, 8 candidates) and the rotation it plans
  quickstart      examples/train_quickstart.py: 3 ARS steps (8 directions, a
                  bank of 4, 60-step episodes), then a 4-episode evaluation

Random draws come from torch.Generators seeded as the examples seed their
keys; a run's injection arguments (a scenario, a CPG start, MPPI draws, ARS
draws) replace them, so a test can give the JAX package's.

    python -m quadruped_springs_tpu_torch.examples episode
    python -m quadruped_springs_tpu_torch.examples mpc --mppi
    python -m quadruped_springs_tpu_torch.examples backflip --horizon 60 --iters 14

A CUDA device that is not available is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from quadruped_springs_tpu_torch.compare_springs import ballistic_apex
from quadruped_springs_tpu_torch.control import cpg as cpg_mod
from quadruped_springs_tpu_torch.env import wrappers as wr
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.env_bench import device_name, resolve_device
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem
from quadruped_springs_tpu_torch.solver.mppi import MPPIConfig
from quadruped_springs_tpu_torch.train.ars import ARSConfig, ARSTrainer

CROUCH = (0.0, 0.4, -0.8, 0.0, 0.4, -0.8)
EXTEND = (0.0, -0.4, 1.0, 0.0, -0.4, 1.0)
# foot space (SYMMETRIC [x, y, z] for FR and RR): z = +1 pulls the foot to
# -0.14 m (deep crouch), z = -1 drives it to -0.39 m (full extension)
CARTESIAN_CROUCH = (0.0, 0.0, 0.55, 0.0, 0.0, 0.55)
CARTESIAN_EXTEND = (0.0, 0.0, -1.0, 0.0, 0.0, -1.0)
CROUCH_STEPS = 30
# run_mpc.py: iLQR at H = 25, 6 iterations, 6 line search candidates; with
# --mppi MPPI's 8 iterations of K = 32 (the accept rollout every iteration)
MPC_HORIZON, MPC_ITERATIONS, MPC_ALPHAS = 25, 6, 6
MPPI_ITERATIONS, MPPI_SAMPLES = 8, 32
# run_backflip.py: iLQR at H = 60, 14 iterations, 8 candidates
BACKFLIP_HORIZON, BACKFLIP_ITERATIONS, BACKFLIP_ALPHAS = 60, 14, 8


def _finish(rec: dict, device: torch.device, t0: float) -> dict:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {**rec, "wall_s": time.perf_counter() - t0, "device": device_name(device)}


def _scripted_jump(env, wrapper, state, crouch, extend, max_steps, generator):
    """Crouch for CROUCH_STEPS control steps, then extend, through the
    landing wrapper until the episode ends or max_steps; returns (last
    StepOut, its step, the summed reward)."""
    crouch, extend = (torch.tensor(a, device=env.device)[None] for a in (crouch, extend))
    out, total = None, 0.0
    for t in range(max_steps):
        out = wrapper.step(state, crouch if t < CROUCH_STEPS else extend, generator)
        state = out.state
        total += float(out.reward[0])
        if bool(out.done[0]):
            break
    return out, t, total


@torch.no_grad()
def episode(device=None, scenario=None, settle: int | None = None,
            max_steps: int = 120) -> dict:
    """examples/run_episode.py: reset height, observation size and feet in
    contact, then the scripted jump's return, heights and the controller
    switch. `scenario` replaces the reset's draw of the ground; `settle`
    and `max_steps` cut the env's 2,500 settling substeps and the
    episode's 120 control steps (a test)."""
    device, t0 = resolve_device(device), time.perf_counter()
    kw = {} if settle is None else {"settling_steps": settle}
    env = QuadrupedEnv(EnvConfig(
        enable_springs=True, motor_control_mode="PD", action_space_mode="SYMMETRIC",
        task_env="JUMPING_IN_PLACE", observation_space_mode="ARS_BASIC",
        env_randomizer_mode="GROUND_RANDOMIZER", **kw), device=device)
    gen = torch.Generator(device).manual_seed(0)
    state, obs = env.reset(gen, scenario=scenario)
    rec = {"reset_height_m": float(state.robot.pos[0, 2]), "obs_dim": int(obs.shape[-1]),
           "feet_in_contact": state.feet_in_contact[0].tolist()}
    out, t, total = _scripted_jump(env, wr.LandingWrapper(env), state, CROUCH, EXTEND,
                                   max_steps, gen)
    rec.update({"end_step": t, "return": total, "max_height_m": float(out.max_height[0]),
                "max_fwd_m": float(out.max_fwd[0]),
                "final_height_m": float(out.state.robot.pos[0, 2]),
                "controller_switched": bool(out.state.task.switched_controller[0])})
    return _finish(rec, device, t0)


def cpg_env(device) -> QuadrupedEnv:
    """run_cpg.py's environment: the rigid robot in TORQUE mode, one 1 kHz
    substep a control step, no task, randomization or observation noise."""
    return QuadrupedEnv(EnvConfig(
        is_rl_gym_interface=False, motor_control_mode="TORQUE", action_repeat=1,
        enable_springs=False, task_env="NO_TASK", observation_space_mode="ENCODER",
        action_space_mode="DEFAULT", env_randomizer_mode="NONE", obs_noise=False),
        device=device)


@torch.no_grad()
def cpg(gait: str = "TROT", seconds: float = 3.0, device=None, X0=None,
        n_steps: int | None = None) -> dict:
    """examples/run_cpg.py: forward travel, mean and least height, the final
    base position over seconds x 1,000 steps (n_steps where given) of 1 kHz
    CPG locomotion. X0 (2, 4) replaces the CPG's random start."""
    device, t0 = resolve_device(device), time.perf_counter()
    env = cpg_env(device)
    params = cpg_mod.HopfParams(gait=gait, omega_swing=8 * math.pi,
                                omega_stance=4 * math.pi, des_step_len=0.05)
    state, _ = env.reset(torch.Generator(device).manual_seed(0))
    X = (cpg_mod.init_state(params, torch.Generator(device).manual_seed(1)) if X0 is None
         else torch.as_tensor(X0, dtype=torch.float32, device=device))
    steps = int(seconds * 1000) if n_steps is None else n_steps
    pos = []
    for _ in range(steps):
        X, fx, fz = cpg_mod.cpg_update(params, X)
        tau = cpg_mod.cpg_torques(env.cfg, state.robot.q, state.robot.qd, fx, fz)
        state, *_ = env.step(state, tau)
        pos.append(state.robot.pos[0])
    pos = torch.stack(pos).cpu().numpy()
    h_min = float(pos[:, 2].min())
    return _finish({"gait": gait, "seconds": steps / 1000.0,
                    "forward_travel_m": float(pos[-1, 0] - pos[0, 0]),
                    "mean_height_m": float(pos[:, 2].mean()), "min_height_m": h_min,
                    "final_pos": pos[-1].tolist(), "upright": h_min > 0.12}, device, t0)


@torch.no_grad()
def cartesian_jump(device=None, scenario=None, max_steps: int = 120) -> dict:
    """examples/run_cartesian_jump.py run(): the jump in foot space through
    LandingWrapper; the example's `result` (relative apex, final height,
    the trunk's up axis, upright, controller switch, steps). `scenario`
    replaces the reset's draw of the ground; `max_steps` cuts the
    episode's 120 control steps (a test)."""
    device, t0 = resolve_device(device), time.perf_counter()
    env = QuadrupedEnv(EnvConfig(
        enable_springs=True, motor_control_mode="CARTESIAN_PD", action_space_mode="SYMMETRIC",
        task_env="JUMPING_IN_PLACE", observation_space_mode="CARTESIAN_NO_IMU",
        settling_steps=600, max_ep_len=2.0, obs_noise=False), device=device)
    gen = torch.Generator(device).manual_seed(0)
    state, _ = env.reset(gen, scenario=scenario)
    out, t, _ = _scripted_jump(env, wr.LandingWrapper(env), state, CARTESIAN_CROUCH,
                               CARTESIAN_EXTEND, max_steps, gen)
    state = out.state
    up_z, z = float(sp.quat_to_mat(state.robot.quat)[0, 2, 2]), float(state.robot.pos[0, 2])
    return _finish({"interface": "CARTESIAN_PD / SYMMETRIC",
                    "apex_rel_m": float(out.max_height[0]), "final_z": z, "up_z": up_z,
                    "upright": up_z > 0.85 and z > 0.15,
                    "controller_switched": bool(state.task.switched_controller[0]),
                    "steps": t}, device, t0)


def _plan_record(cost_trace, cost, xs, us) -> dict:
    """run_mpc.py's printout of a solution: the cost trace (and whether it
    never rises by more than 1e-5), its first entry and the final cost,
    the plan's largest height and ballistic apex, its controls."""
    trace = np.asarray(cost_trace.cpu(), dtype=np.float64)
    return {"cost_trace": trace.tolist(), "initial_cost": float(trace[0]),
            "final_cost": float(cost), "monotone": bool(np.all(np.diff(trace) <= 1e-5)),
            "max_height_m": float(xs[:, 2].max()),
            "predicted_apex_m": float(ballistic_apex(xs)),
            "controls_finite": bool(torch.isfinite(us).all()),
            "u_absmax": float(us.abs().max())}


@torch.no_grad()
def mpc(device=None, horizon: int = MPC_HORIZON, iterations: int = MPC_ITERATIONS,
        batch: int = 0, mppi: bool = False, parallel_riccati: bool = False,
        mppi_iterations: int = MPPI_ITERATIONS, draws: torch.Tensor | None = None) -> dict:
    """examples/run_mpc.py: one iLQR solve of JUMPING_IN_PLACE from the
    default start and warm start (with mppi: one MPPI solve from the task's
    warm start, its draws from a generator seeded 0 or `draws`,
    (mppi_iterations, 1, K, H, m)); with batch, `batch` copies solved as
    one batch, their least and largest cost. `horizon`, `iterations` and
    `mppi_iterations` cut the example's solves (a test)."""
    device, t0 = resolve_device(device), time.perf_counter()
    prob = MPCProblem(MPCConfig(
        task="JUMPING_IN_PLACE", enable_springs=True, horizon=horizon, iterations=iterations,
        n_alphas=MPC_ALPHAS, backward="parallel" if parallel_riccati else "sequential"), device)
    x0, u0 = prob.default_x0(), prob.default_warm_start()
    if mppi:
        sol = prob.solve_mppi(
            x0[None], prob.task_warm_start()[None], torch.Generator(device).manual_seed(0),
            MPPIConfig(horizon=horizon, iterations=mppi_iterations, n_samples=MPPI_SAMPLES),
            noise=draws)
        rec = _plan_record(sol.cost_trace[0], sol.cost[0], sol.xs[0], sol.us[0])
    else:
        sol = prob.solve(x0, u0)
        rec = _plan_record(sol.cost_trace, sol.cost, sol.xs, sol.us)
    rec["solver"] = "mppi" if mppi else "ilqr"
    if batch:
        sols = prob.solve_batch(x0.expand(batch, -1).contiguous(),
                                u0.expand(batch, -1, -1).contiguous())
        rec.update({"batch": batch, "batch_cost_min": float(sols.cost.min()),
                    "batch_cost_max": float(sols.cost.max())})
    return _finish(rec, device, t0)


@torch.no_grad()
def backflip(device=None, horizon: int = BACKFLIP_HORIZON,
             iterations: int = BACKFLIP_ITERATIONS) -> dict:
    """examples/run_backflip.py: one iLQR solve of BACKFLIP from the default
    start and the task's warm start; the cost trace's ends and whether it
    is monotone, the pitch rotation the plan spans (unwrapped), its apex."""
    device, t0 = resolve_device(device), time.perf_counter()
    prob = MPCProblem(MPCConfig(task="BACKFLIP", horizon=horizon, iterations=iterations,
                                n_alphas=BACKFLIP_ALPHAS), device)
    sol = prob.solve(prob.default_x0(), prob.task_warm_start())
    pitch = sp.pitch_unwrapped_yxz(sol.xs[:, 3:7], torch.zeros((), dtype=torch.bool,
                                                                device=device))
    rotation = np.unwrap(pitch.cpu().numpy().astype(np.float64))
    total = float(rotation.max() - rotation.min())
    trace = np.asarray(sol.cost_trace.cpu(), dtype=np.float64)
    return _finish({"horizon": horizon, "iterations": iterations,
                    "cost_trace": trace.tolist(),
                    "initial_cost": float(trace[0]), "final_cost": float(trace[-1]),
                    "monotone": bool(np.all(np.diff(trace) <= 1e-5)),
                    "rotation_rad": total, "rotation_deg": math.degrees(total),
                    "apex_height_m": float(sol.xs[:, 2].max()),
                    "controls_finite": bool(torch.isfinite(sol.us).all())}, device, t0)


@torch.no_grad()
def quickstart(device=None, steps: int = 3, draws=None, env_overrides=None,
               episode_steps: int = 60) -> dict:
    """examples/train_quickstart.py: `steps` ARS train_steps (each step's
    mean and best return and seconds) and a 4-episode evaluation. `draws`,
    where given, holds per step (deltas, bank) and last the evaluation's
    bank, replacing the trainer's draws; `env_overrides` and
    `episode_steps` cut the example's episodes (a test)."""
    device, t0 = resolve_device(device), time.perf_counter()
    env = QuadrupedEnv(EnvConfig(**{
        "enable_springs": True, "task_env": "JUMPING_IN_PLACE",
        "observation_space_mode": "ARS_BASIC", "action_space_mode": "SYMMETRIC",
        "settling_steps": 500,
        # the sparse task pays its reward at the episode's end: it must end
        # inside the 60-step rollout
        "max_ep_len": 0.5, **(env_overrides or {})}), device=device)
    trainer = ARSTrainer(env, ARSConfig(n_directions=8, top_directions=4,
                                        episode_steps=episode_steps, reset_bank_size=4))
    ts = trainer.init(torch.Generator(device).manual_seed(0))
    records = []
    for i in range(steps):
        s0 = time.perf_counter()
        deltas, bank = (None, None) if draws is None else draws[i]
        ts, m = trainer.train_step(ts, deltas=deltas, bank=bank)
        records.append({"mean_return": float(m["mean_return"]),
                        "best_return": float(m["best_return"]),
                        "seconds": time.perf_counter() - s0})
    ev = trainer.evaluate(ts, n_episodes=4, bank=None if draws is None else draws[steps])
    return _finish({"episodes_per_step": 2 * 8 * 4, "steps": records,
                    "eval_return_mean": float(ev["return_mean"]),
                    "eval_return_std": float(ev["return_std"]),
                    "eval_max_height_m": float(ev["max_height"]),
                    "W_absmax": float(ts.W.abs().max())}, device, t0)


RUNS = {"episode": episode, "cpg": cpg, "cartesian_jump": cartesian_jump, "mpc": mpc,
        "backflip": backflip, "quickstart": quickstart}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("run", choices=tuple(RUNS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--gait", default="TROT", help="cpg only")
    ap.add_argument("--seconds", type=float, default=3.0, help="cpg only")
    ap.add_argument("--mppi", action="store_true", help="mpc only")
    ap.add_argument("--batch", type=int, default=0, help="mpc only")
    ap.add_argument("--parallel-riccati", action="store_true", help="mpc only")
    ap.add_argument("--horizon", type=int, default=BACKFLIP_HORIZON, help="backflip only")
    ap.add_argument("--iters", type=int, default=BACKFLIP_ITERATIONS, help="backflip only")
    ap.add_argument("--steps", type=int, default=3, help="quickstart only")
    a = ap.parse_args(argv)
    if a.run == "cpg":
        rec = RUNS[a.run](gait=a.gait, seconds=a.seconds, device=a.device)
    elif a.run == "mpc":
        rec = RUNS[a.run](device=a.device, batch=a.batch, mppi=a.mppi,
                          parallel_riccati=a.parallel_riccati)
    elif a.run == "backflip":
        rec = RUNS[a.run](device=a.device, horizon=a.horizon, iterations=a.iters)
    elif a.run == "quickstart":
        rec = RUNS[a.run](device=a.device, steps=a.steps)
    else:
        rec = RUNS[a.run](device=a.device)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
