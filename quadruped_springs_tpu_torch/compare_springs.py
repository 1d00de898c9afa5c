"""Springs against rigid: the project's namesake comparison, planned and learned.

The port of the JAX package's two comparison scripts, each at its script's
configuration:

  planned   scripts/compare_springs.py: the same MPPI solver plans
            JUMPING_IN_PLACE on the relaxed 200 Hz planner
            (MPCConfig(horizon=50, iterations=10, n_alphas=8)) for the robot
            with parallel elastic springs and for the rigid one; N_SOLVES
            solves from the task's warm start (MPPIConfig(horizon=50,
            iterations=10): K = 64, sigma 0.3, the accept rollout every
            iteration) run as one batch of N_SOLVES rows; the best plan by
            cost, followed by LANDING_KNOTS knots of the landing action, runs
            open loop on each robot's stiff 1 kHz fidelity environment
  learned   scripts/compare_springs_learned.py: budget-matched ARS (16
            directions, top 8, 110-step episodes, a reset bank of 8, step
            0.02, delta std 0.03; 150 iterations, no early stop) on the
            sparse jump for both robots, each iteration one train_step and
            a 4-episode evaluation

Both robots share every limit and hyperparameter; EnvConfig.enable_springs
and MPCConfig.enable_springs pick the robot (with it the PD gains: kp 75
against [55, 60, 60]). The planned draws come from a torch.Generator
seeded PLANNED_SEED (1) for each robot (the JAX script gives both robots
the same keys); `draws`, (iterations, N_SOLVES, K, H, m) standard normals,
replaces them (a test injects JAX's). The JAX package's draws differ from the port's, so the
port's numbers are compared with the committed ones
(docs/springs_vs_rigid.json, docs/springs_vs_rigid_learned.json) by their
bars, not digit by digit; the port never writes those files.

    python -m quadruped_springs_tpu_torch.compare_springs planned [--out FILE]
    python -m quadruped_springs_tpu_torch.compare_springs learned --iters 150 \\
        [--configs springs,rigid]

prints one JSON line (and writes it to --out where given). A CUDA device
that is not available is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.env_bench import device_name, resolve_device
from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem, state_to_vec
from quadruped_springs_tpu_torch.solver.mppi import MPPIConfig
from quadruped_springs_tpu_torch.train.ars import ARSConfig, ARSTrainer
from quadruped_springs_tpu_torch.utils import verification as V

N_SOLVES = 8          # MPPI is stochastic; single solves are too noisy to compare
LANDING_KNOTS = 70    # 0.7 s of the landing action after the 0.5 s plan
SETTLE = V.EnvConfig.settling_steps   # the fidelity env's settle: 2,500 substeps
CONFIGS = {"springs": True, "rigid": False}
PLANNED_SEED = 1      # the JAX script's PRNGKey(1)
G = 9.81
# the JAX package's committed results, never written by the port
COMMITTED = ("springs_vs_rigid.json", "springs_vs_rigid_learned.json")


def ballistic_apex(xs: torch.Tensor) -> torch.Tensor:
    """The apex each plan predicts: max over its knots of z + max(vz, 0)²/2g;
    xs (..., H+1, 37) -> (...). Plans launch as late as pays, so their
    realized z under-measures the jump."""
    z, vz = xs[..., 2], xs[..., 9]
    return (z + torch.clamp_min(vz, 0.0) ** 2 / (2 * G)).amax(-1)


def execution_row(trace: np.ndarray, action_dim: int) -> dict:
    """An executed trace's (T, row) executed apex, peak |motor torque|, the
    motors' positive mechanical work (spring work is free: that is the
    point), final height and uprightness, unrounded."""
    got = V.split_trace(trace, action_dim)
    z, tau, qd = got["pos"][:, 2], got["tau"], got["qd"]
    motor_power = np.maximum(np.sum(tau * qd, axis=1), 0.0)
    return {"executed_apex_m": float(z.max()),
            "peak_motor_torque_Nm": float(np.abs(tau).max()),
            "motor_work_J": float(motor_power.sum()) * 0.01,
            "final_z_m": float(z[-1]),
            "upright": bool(abs(got["quat"][-1, 0]) + abs(got["quat"][-1, 1]) < 0.5)}


def seed_draws(seed: int, device, iterations: int = 10, n_solves: int = N_SOLVES,
               n_samples: int = 64, horizon: int = 50, action_dim: int = 6) -> torch.Tensor:
    """The planned run's standard normals for one seed, (iterations,
    n_solves, K, H, m), drawn at once from a torch.Generator seeded `seed`."""
    return torch.randn((iterations, n_solves, n_samples, horizon, action_dim), device=device,
                       generator=torch.Generator(device).manual_seed(seed))


def planned_rows(enable_springs: bool, device, seeds=(1,), horizon: int = 50,
                 iterations: int = 10, n_samples: int = 64, n_solves: int = N_SOLVES,
                 draws: torch.Tensor | None = None, landing_knots: int = LANDING_KNOTS,
                 settle: int = SETTLE) -> list:
    """scripts/compare_springs.py's row of one robot for each seed,
    unrounded, with its solves' costs and planned apexes: the n_solves
    solves of every seed as one batch of len(seeds) x n_solves rows (a
    row's solve does not depend on its batch), each seed's best plan and
    the landing action as one lane of one fidelity env. `draws` (one
    seed's, (iterations, n_solves, K, H, m)) replaces the seeds' draws."""
    t0 = time.time()
    prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=horizon,
                                iterations=iterations, n_alphas=8,
                                enable_springs=enable_springs), device)
    env = V.fidelity_env("JUMPING_IN_PLACE", enable_springs, device, settle)
    state, _ = env.reset(torch.Generator(device).manual_seed(0))
    if draws is None:
        draws = torch.cat([seed_draws(s, device, iterations, n_solves, n_samples, horizon,
                                      prob.action_dim) for s in seeds], dim=1)
    rows = draws.shape[1]
    x0 = state_to_vec(state.robot).expand(rows, -1).contiguous()
    u0 = prob.task_warm_start().expand(rows, -1, -1).contiguous()
    mcfg = MPPIConfig(horizon=horizon, iterations=iterations, n_samples=n_samples)
    sol = prob.solve_mppi(x0, u0, None, mcfg, noise=draws)
    costs = sol.cost.view(-1, n_solves)
    apexes = ballistic_apex(sol.xs).view(-1, n_solves)
    best = torch.argmin(costs, dim=1)
    us = sol.us.view(-1, n_solves, horizon, prob.action_dim)[torch.arange(len(best)), best]
    land = env.get_landing_action().expand(len(best), landing_knots, -1)
    trace = V.record_golden_trace(env, torch.cat([us, land], dim=1),
                                  torch.Generator(device).manual_seed(2)).cpu().numpy()
    out = []
    for i, b in enumerate(best.tolist()):
        out.append({
            "n_solves": n_solves,
            "planned_apex_best_m": float(apexes[i, b]),
            "planned_apex_mean_m": float(apexes[i].mean()),
            "planned_apex_max_m": float(apexes[i].max()),
            "best_cost": float(costs[i, b]),
            "mean_cost": float(costs[i].mean()),
            **execution_row(trace[i], env.action_dim),
            "wall_s": time.time() - t0,
            "best": b, "costs": costs[i].tolist(), "apexes": apexes[i].tolist()})
    return out


DIGITS = {"best_cost": 2, "mean_cost": 2, "peak_motor_torque_Nm": 2, "motor_work_J": 2,
          "wall_s": 1}
ROW_KEYS = ("n_solves", "planned_apex_best_m", "planned_apex_mean_m", "planned_apex_max_m",
            "best_cost", "mean_cost", "executed_apex_m", "peak_motor_torque_Nm",
            "motor_work_J", "final_z_m", "upright", "wall_s")


def rounded(row: dict) -> dict:
    """A row's 12 keys with the script's rounding."""
    return {k: (round(row[k], DIGITS.get(k, 3)) if isinstance(row[k], float) else row[k])
            for k in ROW_KEYS}


def bars(springs: dict, rigid: dict) -> bool:
    """tests/test_artifacts.py's mechanical bars on the two rows: both
    upright, the peak motor torque at the 33.55 N m limit on both, springs'
    executed apex above rigid's by more than 0.15 m."""
    return bool(springs["upright"] and rigid["upright"]
                and round(springs["peak_motor_torque_Nm"], 2) == 33.55
                and round(rigid["peak_motor_torque_Nm"], 2) == 33.55
                and springs["executed_apex_m"] > rigid["executed_apex_m"] + 0.15)


def summary(springs: dict, rigid: dict) -> dict:
    """The comparison's three numbers, from the two rows as the script rounds them."""
    s, r = springs, rigid
    return {"apex_gain_m": round(s["executed_apex_m"] - r["executed_apex_m"], 3),
            "apex_gain_pct": round(100 * (s["executed_apex_m"]
                                          / max(r["executed_apex_m"], 1e-6) - 1), 1),
            "planned_mean_gain_m": round(s["planned_apex_mean_m"]
                                         - r["planned_apex_mean_m"], 3)}


@torch.no_grad()
def planned(device=None, horizon: int = 50, iterations: int = 10, n_samples: int = 64,
            n_solves: int = N_SOLVES, draws: torch.Tensor | None = None,
            settle: int = SETTLE, landing_knots: int = LANDING_KNOTS) -> dict:
    """Both robots' rows, rounded as the script rounds them, and the
    summary; both robots take the draws of seed PLANNED_SEED (or `draws`),
    as the JAX script gives both its keys. The keyword arguments cut the
    script's sizes (a test)."""
    device = resolve_device(device)
    out = {label: rounded(planned_rows(CONFIGS[label], device, (PLANNED_SEED,), horizon,
                                       iterations, n_samples, n_solves, draws, landing_knots,
                                       settle)[0])
           for label in CONFIGS}
    out["summary"] = summary(out["springs"], out["rigid"])
    return {**out, "device": device_name(device), "seed": PLANNED_SEED}


# -- learned ------------------------------------------------------------------

def learned_env(enable_springs: bool, device, **overrides) -> QuadrupedEnv:
    """The script's environment (its EnvConfig fields replaced by
    `overrides`, a test at a reduced size)."""
    return QuadrupedEnv(EnvConfig(**{
        "enable_springs": enable_springs, "task_env": "JUMPING_IN_PLACE",
        "observation_space_mode": "ARS_BASIC", "action_space_mode": "SYMMETRIC",
        "settling_steps": 600, "max_ep_len": 1.0, **overrides}), device=device)


LEARNED_ARS = ARSConfig(n_directions=16, top_directions=8, episode_steps=110,
                        reset_bank_size=8, step_size=0.02, delta_std=0.03)


def iters_to(curve: list, thresh: float):
    """The first iteration whose evaluation apex reaches thresh, else None."""
    for c in curve:
        if c["eval_max_height"] >= thresh:
            return c["iter"]
    return None


def curve_summary(curve: list) -> dict:
    """A learning curve's best apex, mean apex over its last 10 iterations
    and the first iterations at 0.5 m and 0.75 m."""
    return {"best_apex_m": max([-1.0] + [c["eval_max_height"] for c in curve]),
            "final10_apex_mean_m": sum(c["eval_max_height"] for c in curve[-10:]) / 10.0,
            "iters_to_0p5m": iters_to(curve, 0.5),
            "iters_to_0p75m": iters_to(curve, 0.75)}


@torch.no_grad()
def run_config(enable_springs: bool, iters: int, seed: int, device=None, draws=None,
               ars_config: ARSConfig = LEARNED_ARS, env_overrides=None,
               verbose: bool = False) -> dict:
    """scripts/compare_springs_learned.py run_config: `iters` ARS iterations
    with an evaluation after each. `draws`, where given, holds per
    iteration (deltas, bank, eval_bank) to replace the trainer's draws;
    `ars_config` and `env_overrides` replace the script's configuration (a
    test at a reduced size)."""
    device = resolve_device(device)
    env = learned_env(enable_springs, device, **(env_overrides or {}))
    ars = ARSTrainer(env, ars_config)
    ts = ars.init(torch.Generator(device).manual_seed(seed))
    tag = "springs" if enable_springs else "rigid"
    curve, best_apex = [], -1.0
    t0 = time.time()
    for i in range(iters):
        deltas, bank, eval_bank = (None, None, None) if draws is None else draws[i]
        W0 = ts.W
        ts, m = ars.train_step(ts, deltas=deltas, bank=bank)
        ev = ars.evaluate(ts, n_episodes=4, bank=eval_bank)
        apex = float(ev["max_height"])
        best_apex = max(best_apex, apex)
        # the script's four keys, then the step's spread of returns and
        # change of W (0 where the top returns tie)
        curve.append({"iter": i, "mean_return": float(m["mean_return"]),
                      "eval_return": float(ev["return_mean"]), "eval_max_height": apex,
                      "sigma_r": float(m["sigma_r"]),
                      "dW_max": float((ts.W - W0).abs().max())})
        if verbose and i % 10 == 9:
            print(f"[{tag} {i:03d}] train {float(m['mean_return']):+.3f} "
                  f"apex {apex:.3f} m (best {best_apex:.3f})", flush=True)
    return {"enable_springs": enable_springs, **curve_summary(curve),
            "wall_s": round(time.time() - t0, 1), "curve": curve, "W": ts.W}


def advantage_pct(results: dict) -> float:
    s, r = results["springs"]["best_apex_m"], results["rigid"]["best_apex_m"]
    return round(100.0 * (s - r) / r, 1)


def learned(iters: int = 150, seed: int = 0, device=None, configs=tuple(CONFIGS),
            verbose: bool = False) -> dict:
    """scripts/compare_springs_learned.py main: one run_config per robot
    (each record without its final W) and, with both, the springs'
    advantage in best apex."""
    device = resolve_device(device)
    results = {"task": "JUMPING_IN_PLACE", "trainer": "ARS (stage 1a of "
               "examples/train_two_stage.py, identical budget, no early stop)",
               "iters": iters, "seed": seed}
    for label in configs:
        rec = run_config(CONFIGS[label], iters, seed, device, verbose=verbose)
        del rec["W"]
        results[label] = rec
    if {"springs", "rigid"} <= set(configs):
        results["springs_advantage_pct"] = advantage_pct(results)
    return {**results, "device": device_name(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("run", choices=("planned", "learned"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="learned only: the trainer's seed")
    ap.add_argument("--iters", type=int, default=150, help="learned only")
    ap.add_argument("--configs", default="springs,rigid", help="learned only")
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    a = ap.parse_args(argv)
    if a.out and os.path.basename(a.out) in COMMITTED:
        raise SystemExit(f"--out {a.out}: the JAX package's committed result is the "
                         "reference; write the port's elsewhere")
    configs = tuple(a.configs.split(","))
    if not set(configs) <= set(CONFIGS):
        raise SystemExit(f"--configs: expected a subset of {sorted(CONFIGS)}")
    if a.run == "planned":
        rec = planned(device=a.device)
    else:
        rec = learned(iters=a.iters, seed=a.seed, device=a.device,
                      configs=configs, verbose=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rec, f, indent=2)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
