"""The stages of the learned continuous-jumping trainer.

Port of the stage logic of ``examples/train_continuous_policy.py``: the
policy trains through the per-jump landing autopilot
(``env/continuous_autopilot.py``). ARS learns a linear policy on
CONTINUOUS_JUMPING_FORWARD3 (the task's own terminal scoring), behaviour
cloning copies it into the PPO network on its own on-policy states (the
steps where the policy's action was executed), and PPO fine-tunes the clone
on the dense CONTINUOUS_JUMPING_FORWARD_PPO reward with the policy
gradient masked to those steps, frozen observation statistics and a BC
anchor; each stage is scored on fixed evaluation seeds by the task's
per-jump statistics, and the better of BC and PPO is gated on fresh seeds.

Every stage is a function of its trainers, its state (made by the caller
from a ``torch.Generator`` or from given draws) and its budget; every
comparison and selection is a pure function of the evaluation records, in
the JAX script's formula and order. Where the script keeps an earlier
iterate of the PPO network, the stage keeps a copy: the port's trainer
updates the network in place.

An evaluation record carries the script's keys (``good_jumps_per_seed``,
``good_jumps_mean``, ``good_jumps_min``, ``mean_perf_mean``, ``per_seed``);
each seed's entry is ``continuous_jump_stats`` plus how its episode ended
(``task_terminated``, ``timeout``) in place of the script's ``crashed``,
which is ``done`` and so true for every episode that reached its timeout.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import numpy as np
import torch

from quadruped_springs_tpu_torch.env.continuous_autopilot import ContinuousAutopilotEnv
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv, select
from quadruped_springs_tpu_torch.tasks.tasks import continuous_jump_stats
from quadruped_springs_tpu_torch.train import bc
from quadruped_springs_tpu_torch.train import normalize as vnorm
from quadruped_springs_tpu_torch.train import rollout as ro
from quadruped_springs_tpu_torch.train.ars import ARSConfig
from quadruped_springs_tpu_torch.train.behaviour import clip
from quadruped_springs_tpu_torch.train.networks import linear_policy_apply
from quadruped_springs_tpu_torch.train.ppo import PPOConfig
from quadruped_springs_tpu_torch.train.two_stage import log_none

SCORE_TASK = "CONTINUOUS_JUMPING_FORWARD3"
PPO_TASK = "CONTINUOUS_JUMPING_FORWARD_PPO"
SETTLE = 600
EVAL_SEEDS = tuple(30000 + i for i in range(8))
GATE_SEEDS = tuple(40000 + i for i in range(4))
# the script's generator seeds: ARS's draws, the collection's lanes, BC's
# network, the PPO trainer's init and the warm start's fresh critic
SEEDS = dict(ars=0, collect=11, bc=2, ppo=3, critic=4)
COLLECT_LANES = 8
ARS_EVAL_EVERY, PPO_EVAL_EVERY = 20, 10
PERF_WEIGHT = 0.1           # a stage's score: good jumps + 0.1 x mean performance
FINETUNE_HOLD = 0.5         # PPO's good-jump mean may fall this far below BC's
GATE_GOOD_JUMPS = 4         # every gate seed at least this many good jumps
BC_ITERS = 4000
BC_LOG_STD = -2.0
KPI_SECONDS, KPI_STEPS, KPI_SEED = 6.0, 610, 0
ARS = ARSConfig(n_directions=16, top_directions=8, reset_bank_size=8, step_size=0.02,
                delta_std=0.03)
PPO = PPOConfig(n_envs=32, segment_len=100, reset_bank_size=16, gamma=0.99, gae_lambda=0.95,
                lr=1e-4, kl_stop=0.02, freeze_obs_norm=True, noise_rho=0.9, bc_coef=30.0)
CRITIC_WARMUP_LR = 3e-4


def env_config(task: str, seconds: float) -> EnvConfig:
    """The script's `make_env` configuration."""
    return EnvConfig(enable_springs=True, task_env=task,
                     observation_space_mode="PPO_CONTINUOUS_JUMPING_FORWARD",
                     action_space_mode="SYMMETRIC", settling_steps=SETTLE, max_ep_len=seconds)


def make_env(task: str, seconds: float, device) -> ContinuousAutopilotEnv:
    return ContinuousAutopilotEnv(QuadrupedEnv(env_config(task, seconds), device=device))


def episode_steps(seconds: float) -> int:
    """Control steps of an evaluation or ARS episode: the timeout and 10 more."""
    return int(seconds * 100) + 10


# -- policies: the action clipped to ±1 as jnp.clip (one half at a tie) -------

def linear_policy(W, obs_norm) -> Callable:
    return lambda obs: clip(linear_policy_apply(W, vnorm.normalize(obs_norm, obs)), -1.0, 1.0)


def mlp_policy(net, obs_norm) -> Callable:
    """The deterministic policy of a PPO network: its clipped mean."""
    return lambda obs: clip(net(vnorm.normalize(obs_norm, obs))[0], -1.0, 1.0)


# -- masked episodes and their scores -----------------------------------------

@torch.no_grad()
def masked_episode(env, policy: Callable, state, obs: torch.Tensor, n_steps: int, noise,
                   record: bool = False):
    """n_steps control steps of every lane (the script's `make_eval` and
    `collect`): a lane that is done keeps its state and observation. Returns
    (final state, ended (N,), task_terminated (N,), timeout (N,), rows):
    how each lane's episode ended, and with `record` the (obs, action,
    keep) of every step, (T, N, ...), keep marking the steps the policy
    drove a live lane (its action executed), else None."""
    n, dev = obs.shape[0], obs.device
    done, terminated, timeout = (torch.zeros(n, dtype=torch.bool, device=dev)
                                 for _ in range(3))
    rows = []
    for _ in range(n_steps):
        a = policy(obs)
        state2, obs2, _, d2, info = env.step(state, a, noise)
        if record:
            rows.append((obs, a, info["policy_in_control"] & ~done))
        ends = d2 & ~done
        terminated = terminated | (ends & info["task_terminated"])
        timeout = timeout | (ends & info["timeout"])
        state = select(done, state, state2)
        obs = torch.where(done[:, None], obs, obs2)
        done = done | d2
    if record:
        rows = tuple(torch.stack(r) for r in zip(*rows))
    return state, done, terminated, timeout, (rows if record else None)


def scores(task_state, terminated, timeout) -> dict:
    """The script's `eval_scores` record of final task states (N lanes)."""
    per_seed = []
    for i in range(terminated.shape[0]):
        s = continuous_jump_stats(task_state, i)
        s["task_terminated"] = bool(terminated[i])
        s["timeout"] = bool(timeout[i])
        per_seed.append(s)
    good = [s["good_jumps"] for s in per_seed]
    return {"good_jumps_per_seed": good,
            "good_jumps_mean": float(np.mean(good)),
            "good_jumps_min": int(np.min(good)),
            "mean_perf_mean": float(np.mean([s["mean_perf"] for s in per_seed])),
            "per_seed": per_seed}


class Evaluator:
    """Deterministic episodes of n_steps from one start per seed (the
    script's jitted `ev` on fixed keys): each lane's scenario and
    observation-noise stream from a generator of its own seed
    (``rollout.seeded_reset``), reset once; every policy is scored from
    that start."""

    def __init__(self, env: ContinuousAutopilotEnv, seeds: Sequence[int], n_steps: int):
        self.env, self.seeds, self.n_steps, self._start = env, tuple(seeds), n_steps, None

    def __call__(self, policy: Callable) -> dict:
        if self._start is None:
            state, obs, noise = ro.seeded_reset(self.env.env, self.seeds)
            self._start = self.env.start(state), obs, noise
        state, obs, noise = self._start
        sf, _, term, tout, _ = masked_episode(self.env, policy, state, obs, self.n_steps, noise)
        return scores(sf.env.task, term, tout)


# -- pure comparisons, selections and gates ------------------------------------

def stage_score(e: dict) -> float:
    return e["good_jumps_mean"] + PERF_WEIGHT * e["mean_perf_mean"]


def ars_improved(curve: list) -> bool:
    return bool(curve[-1]["mean_return"] > curve[0]["mean_return"])


def stage_comparison(bc_eval: dict, ppo_eval: dict) -> dict:
    """PPO against BC by score (recorded), and the fine-tune's no-regress
    gate: PPO's good-jump mean within FINETUNE_HOLD of its initializer's."""
    improves = ppo_eval["good_jumps_mean"] >= bc_eval["good_jumps_mean"] - FINETUNE_HOLD
    return {"ppo_improves_on_bc": bool(stage_score(ppo_eval) > stage_score(bc_eval)),
            "finetune_improves_on_initializer": bool(improves),
            "finetune_is_noop": bool(not improves)}


def selected_stage(bc_eval: dict, ppo_eval: dict) -> str:
    """PPO when its score is at least BC's, else BC."""
    return "ppo" if stage_score(ppo_eval) >= stage_score(bc_eval) else "bc"


def gate_entries(gate: dict) -> dict:
    return {"gate_eval": gate,
            "policy_sustains_4_good_jumps": bool(gate["good_jumps_min"] >= GATE_GOOD_JUMPS)}


# -- stages -------------------------------------------------------------------

def ars_stage(ars, ts, iters: int, evaluate: Evaluator, draws=None, log=log_none):
    """Stage 1 (``:174-208``): ARS train steps; every ARS_EVAL_EVERY-th an
    evaluation, the best (W, statistics) kept by stage_score, strictly
    greater, from -1. draws[i]: (deltas, bank) of iteration i. Returns (W,
    statistics, entries)."""
    curve = []
    best = (-1.0, ts.W, ts.obs_norm, None)
    for i in range(iters):
        deltas, bank = (None, None) if draws is None else draws[i]
        ts, m = ars.train_step(ts, deltas=deltas, bank=bank)
        rec = {"iter": i, "mean_return": float(m["mean_return"])}
        if i % ARS_EVAL_EVERY == ARS_EVAL_EVERY - 1:
            sc = evaluate(linear_policy(ts.W, ts.obs_norm))
            rec.update(good_jumps_mean=sc["good_jumps_mean"], mean_perf=sc["mean_perf_mean"])
            if stage_score(sc) > best[0]:
                best = (stage_score(sc), ts.W, ts.obs_norm, sc)
            log(f"[ARS {i:03d}] ret {rec['mean_return']:+.3f} good/seed "
                f"{sc['good_jumps_per_seed']} perf {sc['mean_perf_mean']:.3f}")
        curve.append(rec)
    _, W, on, ev = best
    if ev is None:
        ev = evaluate(linear_policy(W, on))
    log(f"[ARS] best good/seed {ev['good_jumps_per_seed']} perf {ev['mean_perf_mean']:.3f}")
    return W, on, {"ars_curve": curve, "ars_improved": ars_improved(curve), "ars_eval": ev}


def keep_rows(rows):
    """Stage 2's dataset (``:213-240``) from a recorded masked episode's
    (obs, action, keep) rows: the (observation, action) of every step the
    policy drove a live lane, in the script's order (time-major, then
    lane)."""
    o, a, keep = rows
    mask = keep.reshape(-1)
    return o.reshape(-1, o.shape[-1])[mask], a.reshape(-1, a.shape[-1])[mask]


def bc_stage(net, obs, acts):
    """Stage 2's fit (``:242-245``): the PPO network's actor regressed on the
    rows, BC_ITERS full-batch iterations, log_std set to BC_LOG_STD.
    Returns (net, statistics, entries)."""
    net, norm, mse = bc.fit(net, obs, acts, iters=BC_ITERS, log_std=BC_LOG_STD)
    return net, norm, {"bc_rows": int(obs.shape[0]), "bc_mse": float(mse)}


def ppo_init(trainer, warm_trainer, generator, bc_net, bc_norm, obs, acts):
    """Stage 3's state (``:263-270``): both trainers anchored to the
    BC-normalised demo rows; the trainer's init from the generator, then the
    BC actor and statistics warm-started under a fresh critic (seed
    SEEDS["critic"])."""
    for tr in (trainer, warm_trainer):
        tr.set_bc_anchor(vnorm.normalize(bc_norm, obs), acts)
    ps = trainer.init(generator)
    return trainer.warm_start(ps, bc_net, bc_norm, seed=SEEDS["critic"], reset_value=True)


def ppo_stage(trainer, warm_trainer, ps, warmup_iters: int, iters: int, evaluate: Evaluator,
              draws=None, log=log_none):
    """Stage 3 (``:271-293``): the critic warm-up (the actor frozen, its
    trainer's lr on the state's optimiser), then masked PPO; every
    PPO_EVAL_EVERY-th iteration an evaluation, the best network by
    stage_score kept, strictly greater, from -1 (the warmed-up network
    while none is kept). draws: {"warmup": [...], "ppo": [...]}, a
    train_step's draws per iteration. Returns (last state, kept network, its
    statistics, entries): ppo_eval is the kept one's record, else the last
    iterate's."""
    draws = draws or {}
    for i in range(warmup_iters):
        ps, _ = warm_trainer.train_step(ps, **(draws["warmup"][i] if "warmup" in draws else {}))
    curve = []
    best = {"score": -1.0, "net": copy.deepcopy(ps.net), "eval": None}
    for i in range(iters):
        ps, m = trainer.train_step(ps, **(draws["ppo"][i] if "ppo" in draws else {}))
        rec = {"iter": i, "mean_reward": float(m["mean_reward"])}
        if i % PPO_EVAL_EVERY == PPO_EVAL_EVERY - 1:
            sc = evaluate(mlp_policy(ps.net, ps.obs_norm))
            rec.update(good_jumps_mean=sc["good_jumps_mean"], mean_perf=sc["mean_perf_mean"])
            if stage_score(sc) > best["score"]:
                best.update(score=stage_score(sc), net=copy.deepcopy(ps.net), eval=sc)
            log(f"[PPO {i:03d}] r {rec['mean_reward']:+.4f} kl {float(m['kl_est']):.4f} "
                f"good/seed {sc['good_jumps_per_seed']} perf {sc['mean_perf_mean']:.3f}")
        curve.append(rec)
    ppo_eval = best["eval"] if best["eval"] is not None else evaluate(
        mlp_policy(ps.net, ps.obs_norm))
    return ps, best["net"], ps.obs_norm, {"ppo_curve": curve, "ppo_eval": ppo_eval}
