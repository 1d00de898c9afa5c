"""The stages of the two-stage learn-then-imitate trainers.

Port of the stage orchestration of ``examples/train_two_stage.py`` (jump in
place, jump forward) and ``examples/train_two_stage_backflip.py``: ARS
learns a jump, a landing continuation with longer episodes teaches it to
land, its episodes become demonstrations, behaviour cloning fits them, a
BC-anchored PPO polish on the *_DEMO reward improves the clone closed loop,
and PPO fine-tunes on the dense *_PPO reward warm-started from the
imitation actor (the reference's method, ``load_model.py:45-47``).

Every stage is a plain function of its trainers, its state (made by the
caller from a ``torch.Generator`` or from given draws) and its budgets; it
returns what the next stage reads and its entries of the results dict,
under the JAX script's keys. Every gate and selection is a pure function of
the numbers it reads, in the JAX script's formula and order, with its
constants. `draws`, where a stage takes them, replace the trainers' draws
per iteration (a test injects JAX's).

The trainers update a PPO network in place, where the JAX package keeps
immutable parameters; the stages copy a network wherever the JAX script
keeps an earlier iterate (the BC initializer, the fine-tune's best).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from quadruped_springs_tpu_torch.env import demo_pipeline as dp
from quadruped_springs_tpu_torch.env import flat_rollout as fr
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.train import bc
from quadruped_springs_tpu_torch.train import normalize as vnorm
from quadruped_springs_tpu_torch.train import rollout as ro
from quadruped_springs_tpu_torch.train.networks import linear_policy_apply
from quadruped_springs_tpu_torch.train.ppo import PPOConfig

N_ROWS = 185                 # a complete jump demo: 1.85 s of control steps
N_KNOTS = 140                # 1.4 s flattened flip episode (the flip ends ~0.8-1.0 s)
ROT_BAR = 2 * math.pi - 0.1  # full rotation: max unwrapped pitch
UP_Z_BAR, Z_BAR = 0.85, 0.15   # upright: R[2,2] and base height
DEMO_HOLD = 0.02             # the polish's demo return may fall this far below BC's
APEX_HOLD = 0.02             # apex means may fall this far below the initializer's
FWD_HOLD = 0.05              # forward distance may fall this far below the warm start's
FT_BAR_SCALE, HEIGHT_CAP = 0.95, 0.68   # fine-tune bar: 0.95 x min(ARS apex, cap)
FT_APEX_FLOOR = 0.5          # and at least this apex
TRIM_ROWS, MIN_ROWS = 10, 20   # the jump demos' fallback: trim its last 10 rows, keep 20
PROBE_STEPS = 200            # the dense probe's and the demo evaluation's episode
BC_LOG_STD = -2.0
BC_SEED, BC_DATA_SEED = 22, 21
BC_ITERS = 3000
# the scripts' PPO stages: the BC-anchored polish, at lr 3e-4 where the demos
# are near-identical (in place) and 1e-4 where they differ (the scripts'
# finding: at 3e-4 the demo return oscillates below BC's), and the dense
# fine-tune, whose critic warm-up runs at CRITIC_WARMUP_LR
POLISH_PPO = PPOConfig(n_envs=32, segment_len=64, reset_bank_size=16, gamma=0.3,
                       gae_lambda=0.9, lr=3e-4, kl_stop=0.03, freeze_obs_norm=True,
                       noise_rho=0.0, bc_coef=300.0)
POLISH_LR = {"in_place": 3e-4, "forward": 1e-4, "backflip": 1e-4}
FINETUNE_PPO = PPOConfig(n_envs=32, segment_len=64, reset_bank_size=16, lr=1e-4,
                         kl_stop=0.02, ent_coef=0.0, freeze_obs_norm=True, noise_rho=0.9)
CRITIC_WARMUP_LR = 3e-4
DEMO_EVAL_LANES = 8          # the demo evaluation's lanes


def log_none(*_a, **_k):
    pass


# -- pure gates and selections ------------------------------------------------

def ars_improved(curve: list) -> bool:
    return bool(curve[-1]["eval_return"] > curve[0]["eval_return"])


def reward_improved(curve: list) -> bool:
    r = [c["mean_reward"] for c in curve]
    return bool(np.mean(r[-10:]) > np.mean(r[:10]))


def keep_demos(rows: np.ndarray, valid: np.ndarray):
    """The jump trainers' demo rule: keep every episode with all N_ROWS rows
    valid that landed (a landing flag in its valid rows); if none, the
    longest episode trimmed of its last TRIM_ROWS rows (at least MIN_ROWS).
    rows (N, T, C), valid (N, T). Returns ([(episode, rows to save)], the
    number of complete episodes): episode d's first n rows are saved, the
    valid ones among them."""
    picks, complete = [], 0
    for d in range(rows.shape[0]):
        n_valid = int(valid[d].sum())
        landed = bool(rows[d, :n_valid, -1].any())
        if n_valid == N_ROWS and landed:
            complete += 1
            picks.append((d, rows.shape[1]))
    if not picks:
        d = int(np.argmax(valid.sum(axis=1)))
        picks.append((d, max(int(valid[d].sum()) - TRIM_ROWS, MIN_ROWS)))
    return picks, complete


def keep_flip_demos(valid: np.ndarray, ok: np.ndarray):
    """The flip trainer's demo rule: keep every episode that flipped and
    landed upright (`ok`); if none, the longest one whole. valid (N, T).
    Returns ([(episode, rows to save)], the number of complete flips)."""
    picks = [(i, valid.shape[1]) for i in range(valid.shape[0]) if bool(ok[i])]
    complete = len(picks)
    if not picks:
        picks.append((int(np.argmax(valid.sum(axis=1))), valid.shape[1]))
    return picks, complete


def polish_gates(bc_demo_return: float, demo_return: float, bc_apex_mean: float,
                 apex_mean: float) -> dict:
    """The jump polish's final-iterate gates: its demo return held against
    BC's (the gate) and improved on it (recorded), its probe's apex mean
    held against BC's (the transfer gate; `ppo_imitate_improved` is its
    legacy name)."""
    held = apex_mean >= bc_apex_mean - APEX_HOLD
    return {"ppo_imitate_demo_held": bool(demo_return >= bc_demo_return - DEMO_HOLD),
            "ppo_imitate_demo_improved": bool(demo_return > bc_demo_return),
            "ppo_imitate_transfer_held": bool(held), "ppo_imitate_improved": bool(held)}


def flip_polish_gates(bc_demo_return: float, demo_return: float, bc_probe: dict,
                      probe: dict) -> dict:
    """The flip polish's final-iterate gates: the demo return as the jumps',
    the transfer held when upright and rotation counts each stay within 1 of
    BC's probe."""
    return {"ppo_imitate_demo_held": bool(demo_return >= bc_demo_return - DEMO_HOLD),
            "ppo_imitate_demo_improved": bool(demo_return > bc_demo_return),
            "ppo_imitate_transfer_held": bool(
                probe["upright_count"] >= bc_probe["upright_count"] - 1
                and probe["rotation_count"] >= bc_probe["rotation_count"] - 1)}


def select_warm_start(gates: dict, polish: tuple, bc_init: tuple) -> dict:
    """The fine-tune's warm start: the polish's final iterate when both its
    gates hold, else BC's (the polish then recorded as a no-op). polish and
    bc_init: (apex mean, forward distance) of each. Returns the results'
    entries."""
    ok = gates["ppo_imitate_demo_held"] and gates["ppo_imitate_transfer_held"]
    am, fw = polish if ok else bc_init
    return {"ppo_imitate_is_noop": bool(not ok),
            "warmstart_stage": "ppo_imitate" if ok else "bc",
            "warmstart_apex_mean_m": am, "warmstart_fwd_m": fw}


def finetune_bar(ars_best_apex: float) -> float:
    return FT_BAR_SCALE * min(ars_best_apex, HEIGHT_CAP)


def finetune_score(task: str, apex_max: float, apex_mean: float, fwd: float, bar: float,
                   ws_apex_mean: float, ws_fwd: float) -> float:
    """The fine-tune's selection criterion at a probe: the apex mean in
    place; forward, the least margin over its three gates."""
    if task == "forward":
        return min(apex_max - bar, apex_mean - (ws_apex_mean - APEX_HOLD),
                   fwd - (ws_fwd - FWD_HOLD))
    return apex_mean


def finetune_gates(task: str, apex_max: float, apex_mean: float, fwd: float, bar: float,
                   ws_apex_mean: float, ws_fwd: float) -> dict:
    """The selected fine-tune against the ARS-cap bar and against its own
    warm start (apex mean; forward also the distance)."""
    improves = apex_mean >= ws_apex_mean - APEX_HOLD
    if task == "forward":
        improves = improves and fwd >= ws_fwd - FWD_HOLD
    return {"finetune_matches_ars": bool(apex_max >= FT_APEX_FLOOR and apex_max >= bar),
            "finetune_gate_bar_m": bar,
            "finetune_improves_on_initializer": bool(improves),
            "finetune_is_noop": bool(not improves)}


def flip_score(probe: dict) -> float:
    """The flip fine-tune's selection: upright flips first, apex the tiebreak."""
    return probe["upright_count"] + 0.1 * probe["apex_mean_m"]


def flip_finetune_gates(ft_probe: dict, expert_probe: dict, im_probe: dict) -> dict:
    """The selected flip fine-tune: every probe seed rotated and at least
    the expert's upright count; against its initializer, the upright count
    within 1 of the polish's."""
    improves = ft_probe["upright_count"] >= im_probe["upright_count"] - 1
    return {"finetune_flip_ok": bool(ft_probe["rotation_count"] == ft_probe["n"]
                                     and ft_probe["upright_count"]
                                     >= expert_probe["upright_count"]),
            "finetune_improves_on_initializer": bool(improves),
            "finetune_is_noop": bool(not improves)}


def flip_selected_stage(gates: dict) -> str:
    return ("ppo_finetune" if gates["finetune_flip_ok"]
            and gates["finetune_improves_on_initializer"] else "ppo_imitate")


def nominal_flip_ok(probe: dict) -> bool:
    return bool(probe["rotation_count"] == probe["n"] and probe["upright_count"] == probe["n"])


# -- evaluation ---------------------------------------------------------------

def mlp_policy(net, obs_norm):
    """The deterministic policy of a PPO network: its clipped mean."""
    return lambda obs: torch.clamp(net(vnorm.normalize(obs_norm, obs))[0], -1.0, 1.0)


def linear_policy(W, obs_norm):
    """An ARS policy: W on the normalised observation, clipped."""
    return lambda obs: linear_policy_apply(W, vnorm.normalize(obs_norm, obs))


def cat_trees(trees):
    """Concatenate batched states (dataclasses of tensors) along the lanes."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.cat(trees)
    if isinstance(first, tuple):
        return tuple(cat_trees(list(t)) for t in zip(*trees))
    return dataclasses.replace(first, **{
        f.name: cat_trees([getattr(t, f.name) for t in trees])
        for f in dataclasses.fields(first)})


def seeded_bank(env, seeds, device):
    """One reset lane per seed, each from a generator of its own seed (the
    JAX script's PRNGKey(seed) per probe lane), as one batch."""
    lanes = [env.reset(torch.Generator(device).manual_seed(s), 1) for s in seeds]
    return cat_trees([s for s, _ in lanes]), torch.cat([o for _, o in lanes])


class EpisodeProbe:
    """Deterministic episodes of PROBE_STEPS control steps from a fixed bank
    (the JAX script's jitted probe / demo_eval / wide_eval): a fresh
    observation-noise generator of `noise_seed` per call, so one policy
    always scores the same."""

    def __init__(self, env, bank, noise_seed: int):
        self.env, self.bank, self.seed = env, bank, noise_seed

    @torch.no_grad()
    def __call__(self, policy):
        gen = torch.Generator(self.env.device).manual_seed(self.seed)
        return ro.episode_returns(self.env, policy, *self.bank, PROBE_STEPS, gen)

    def summary(self, policy):
        """(mean return, mean length, mean apex, max apex, max forward)."""
        rets, info = self(policy)
        return tuple(float(x) for x in (
            rets.mean(), info["length"].to(torch.float32).mean(),
            info["max_height"].mean(), info["max_height"].max(), info["max_fwd"].max()))

    def mean_return(self, policy) -> float:
        return float(self(policy)[0].mean())


class FlipProbe:
    """The flip's deployed surface (the JAX script's flip_probe_fn / score):
    the policy launches, the flattened autopilot finishes, N_KNOTS steps
    from a fixed bank of one lane per seed; counts of full rotations and of
    upright landings, the mean pitch and apex (rounded to 3 digits as the
    script's). The flip envs carry no observation noise."""

    def __init__(self, env, bank):
        self.env, self.bank = env, bank

    @torch.no_grad()
    def __call__(self, launch_fn) -> dict:
        landing = self.env.get_landing_action()
        sf, _, _ = fr.backflip_episode(self.env, launch_fn,
                                       lambda o: landing.expand(o.shape[0], -1),
                                       *self.bank, N_KNOTS)
        return flip_score_of(sf)


def flip_outcome(sf):
    """(rotated, upright) per lane of a final flip state."""
    r22 = sp.quat_to_mat(sf.robot.quat)[:, 2, 2]
    rot = sf.task.max_pitch_bf >= ROT_BAR
    return rot, (r22 > UP_Z_BAR) & (sf.robot.pos[:, 2] > Z_BAR)


def flip_score_of(sf) -> dict:
    rot, up = flip_outcome(sf)
    return {"rotation_count": int(rot.sum()), "upright_count": int((rot & up).sum()),
            "n": int(rot.shape[0]),
            "pitch_mean_rad": round(float(sf.task.max_pitch_bf.mean()), 3),
            "apex_mean_m": round(float(sf.task.relative_max_height.mean()), 3)}


# -- stages -------------------------------------------------------------------

def ars_jump_stage(ars, ts, iters: int, target_apex: float, draws=None, log=log_none):
    """Stage 1a (``train_two_stage.py:125-160``): ARS on the sparse jump,
    a 4-episode evaluation after every step, the best (W, statistics) by
    evaluation apex kept, stopped once it reaches target_apex. draws[i]:
    (deltas, bank, eval bank) of iteration i. Returns (best W, its
    statistics, entries)."""
    curve = []
    best_W, best_on, best_apex = ts.W, ts.obs_norm, -1.0
    for i in range(iters):
        deltas, bank, eval_bank = (None, None, None) if draws is None else draws[i]
        ts, m = ars.train_step(ts, deltas=deltas, bank=bank)
        ev = ars.evaluate(ts, n_episodes=4, bank=eval_bank)
        apex = float(ev["max_height"])
        if apex > best_apex:
            best_W, best_on, best_apex = ts.W, ts.obs_norm, apex
        curve.append({"iter": i, "mean_return": float(m["mean_return"]),
                      "eval_return": float(ev["return_mean"]),
                      "eval_max_height": apex, "eval_max_fwd": float(ev["max_fwd"])})
        if i % 10 == 9:
            log(f"[ARS-jump {i:03d}] train {float(m['mean_return']):+.3f}  eval "
                f"{curve[-1]['eval_return']:+.3f}  apex {apex:.3f} m (best {best_apex:.3f})")
        if best_apex >= target_apex:
            log(f"[ARS-jump] target apex {target_apex} reached at iter {i}")
            break
    return best_W, best_on, {"ars_curve": curve, "ars_improved": ars_improved(curve),
                             "ars_jump_best_apex_m": best_apex}


def ars_land_stage(ars, ts, iters: int, wide_eval: EpisodeProbe, draws=None, log=log_none):
    """Stage 1b (``:162-212``): ARS from the best jump iterate (ts carries
    it) on 1.9 s episodes, the 16-lane wide evaluation every 10th
    iteration, the best by evaluation return kept. Returns (W, statistics,
    entries)."""
    curve = []
    best = (-9.9, ts.W, ts.obs_norm, 0.0, 0.0, 0.0)
    for i in range(iters):
        deltas, bank = (None, None) if draws is None else draws[i]
        ts, m = ars.train_step(ts, deltas=deltas, bank=bank)
        if i % 10 == 9:
            r, ln, am, ax, fw = wide_eval.summary(linear_policy(ts.W, ts.obs_norm))
            curve.append({"iter": i, "eval_return": r, "mean_len": ln, "apex_mean": am,
                          "apex_max": ax, "fwd_max": fw})
            log(f"[ARS-land {i:03d}] ret {r:+.3f} len {ln:5.1f} apex mean {am:.3f} "
                f"max {ax:.3f} fwd {fw:.3f}")
            if r > best[0]:
                best = (r, ts.W, ts.obs_norm, am, ax, fw)
    _, W, on, am, ax, fw = best
    log(f"[ARS] expert: apex mean {am:.3f} max {ax:.3f} fwd {fw:.3f}")
    return W, on, {"ars_land_curve": curve, "ars_best_apex_m": ax, "ars_apex_mean_m": am,
                   "ars_best_fwd_m": fw}


def save_demos(rows: np.ndarray, valid: np.ndarray, picks, path_of: Callable, device):
    """Write each picked episode's rows through the trajectory store and read
    them back (the JAX script's save-then-load). Returns the kept demos."""
    kept = []
    for d, n in picks:
        path = path_of(len(kept))
        dp.save_demo_library(path, rows[d, :n], valid[d, :n])
        kept.append(dp.load_demo_library(path, device))
    return kept


def collect_jump_demos(env, expert, n_demos: int, generator, path_of: Callable,
                       log=log_none):
    """Stage 2 (``:214-250``): the expert drives n_demos episodes of N_ROWS
    steps on the landing env (no autopilot); the keep rule picks the
    demos. Returns (kept demos, entries)."""
    rows, valid, _ = dp.collect_demo(env, expert, generator, n=n_demos, max_steps=N_ROWS,
                                     autopilot=False)
    rows = rows.transpose(0, 1).cpu().numpy()
    valid = valid.transpose(0, 1).cpu().numpy()
    picks, complete = keep_demos(rows, valid)
    if complete == 0:
        log(f"[demo] WARNING: no complete episode; using trimmed {picks[0][1]}-row fallback")
    kept = save_demos(rows, valid, picks, path_of, env.device)
    entries = {"demo_episodes": len(kept), "demo_episodes_complete": complete,
               "demo_steps": int(sum(d.shape[0] for d in kept))}
    log(f"[demo] kept {len(kept)}/{n_demos} episodes ({entries['demo_steps']} rows)")
    return kept, entries


def collect_flip_demos(env, expert, n_demos: int, generator, path_of: Callable,
                       log=log_none):
    """The flip's stage 2 (``train_two_stage_backflip.py:170-209``): the
    expert launches, the flattened autopilot finishes, rows recorded; the
    flip keep rule picks the demos. Returns (kept demos, entries)."""
    state, obs = env.reset(generator, n_demos)
    landing = env.get_landing_action()
    sf, _, traj = fr.backflip_episode(env, expert, lambda o: landing.expand(o.shape[0], -1),
                                      state, obs, N_KNOTS, generator, record_rows=True)
    rot, up = flip_outcome(sf)
    rows = traj["row"].transpose(0, 1).cpu().numpy()
    valid = traj["row_valid"].transpose(0, 1).cpu().numpy()
    picks, complete = keep_flip_demos(valid, (rot & up).cpu().numpy())
    kept = save_demos(rows, valid, picks, path_of, env.device)
    entries = {"demo_episodes": n_demos, "demo_episodes_complete": complete,
               "demo_steps": int(sum(d.shape[0] for d in kept))}
    log(f"[demo] kept {complete}/{n_demos} complete flips ({entries['demo_steps']} rows)")
    return kept, entries


def bc_dataset(demo_env, kept, generators=None):
    """The BC pairs of every kept demo (demo i's reset draws from a generator
    seeded BC_DATA_SEED + i), in demo order. Returns (per-demo obs, per-demo
    actions)."""
    obs_list, act_list = [], []
    for i, d in enumerate(kept):
        gen = (torch.Generator(demo_env.device).manual_seed(BC_DATA_SEED + i)
               if generators is None else generators[i])
        o, a = bc.demo_dataset(demo_env, d, gen)
        obs_list.append(o)
        act_list.append(a)
    return obs_list, act_list


def bc_stage(net, obs_list, act_list):
    """Stage 3a (``:309-325``): full-batch regression of a fresh network's
    actor on the demos concatenated in order, BC_ITERS iterations, log_std
    set to BC_LOG_STD. Returns (net, statistics, entries)."""
    net, norm, mse = bc.fit(net, torch.cat(obs_list), torch.cat(act_list), iters=BC_ITERS,
                            log_std=BC_LOG_STD)
    return net, norm, {"bc_mse": float(mse)}


def bc_anchor(task: str, obs_list, act_list):
    """The polish's BC anchor (``:335-347``): demo 0's rows where the demos
    differ (forward, backflip), all rows in place."""
    if task in ("forward", "backflip"):
        return obs_list[0], act_list[0]
    return torch.cat(obs_list), torch.cat(act_list)


def polish_init(trainer, warm_trainer, generator, bc_net, bc_norm, anchor):
    """The polish's state (``:348-353``): the trainer's init from the
    generator (its RSI bank and lanes), holding a copy of the BC network, its
    statistics, a fresh optimiser; both trainers anchored to the normalised
    anchor rows."""
    obs, acts = anchor
    for tr in (trainer, warm_trainer):
        tr.set_bc_anchor(vnorm.normalize(bc_norm, obs), acts)
    ps = trainer.init(generator, net=copy.deepcopy(bc_net))
    return dataclasses.replace(ps, obs_norm=bc_norm)


def _ppo_steps(trainer, ps, iters: int, draws, on_step: Callable | None = None):
    for i in range(iters):
        ps, m = trainer.train_step(ps, **({} if draws is None else draws[i]))
        if on_step is not None:
            on_step(i, ps, m)
    return ps


def _log_warmup(log, name: str):
    return lambda i, ps, m: i % 10 == 9 and log(f"[{name} {i:03d}] vf {float(m['vf_loss']):.5f}")


def jump_polish_score(probe: EpisodeProbe, demo_eval: EpisodeProbe):
    """The jumps' polish evaluation: (the curve's entries, the final
    iterate's) of a policy, from the dense probe and the demo evaluation."""
    def score(pol):
        _, _, am, ax, fw = probe.summary(pol)
        de = demo_eval.mean_return(pol)
        return ({"eval_apex_mean": am, "eval_apex_max": ax, "demo_return": de},
                {"ppo_imitate_apex_m": ax, "ppo_imitate_apex_mean_m": am,
                 "ppo_imitate_fwd_m": fw, "ppo_imitate_demo_return": de})
    return score


def flip_polish_score(probe: FlipProbe, demo_eval: EpisodeProbe):
    """The flip's polish evaluation, on the deployed surface."""
    def score(pol):
        pr, de = probe(pol), demo_eval.mean_return(pol)
        return ({"demo_return": de, "upright_count": pr["upright_count"]},
                {"ppo_imitate_probe": pr, "ppo_imitate_demo_return": de})
    return score


def polish_stage(trainer, warm_trainer, ps, warmup_iters: int, iters: int, score: Callable,
                 draws=None, log=log_none):
    """Stage 3b (``train_two_stage.py:348-390``, ``train_two_stage_backflip.py:
    278-300``): the critic warm-up with the actor frozen, then the
    BC-anchored polish; every 10th iteration and on the final iterate
    `score(policy)` (jump_polish_score, flip_polish_score) gives the curve's
    entries and the final iterate's, on which the caller takes the gates.
    draws: {"warmup": [...], "polish": [...]}, each a train_step's draws
    per iteration. Returns (final state, entries)."""
    draws = draws or {}
    ps = _ppo_steps(warm_trainer, ps, warmup_iters, draws.get("warmup"),
                    _log_warmup(log, "PPO-imitate-warmup"))
    curve = []

    def record(i, ps, m):
        rec = {"iter": i, "mean_reward": float(m["mean_reward"]),
               "bc_mse": float(m["bc_mse"])}
        if i % 10 == 9:
            rec.update(score(mlp_policy(ps.net, ps.obs_norm))[0])
            log(f"[PPO-imitate {i:03d}] {rec}")
        curve.append(rec)

    ps = _ppo_steps(trainer, ps, iters, draws.get("polish"), record)
    final = score(mlp_policy(ps.net, ps.obs_norm))[1]
    log(f"[PPO-imitate] final iterate: {final}")
    return ps, {"ppo_imitate_curve": curve, **final}


def finetune_init(trainer, generator, warm_net, warm_norm, critic_seed: int = 3):
    """The fine-tune's state (``:442-447``): the trainer's init, then the
    warm start's actor and statistics with a fresh critic (seed
    critic_seed) and a fresh optimiser."""
    fs = trainer.init(generator)
    return trainer.warm_start(fs, warm_net, warm_norm, seed=critic_seed, reset_value=True)


def jump_finetune_eval(task: str, probe: EpisodeProbe, bar: float, warm: dict):
    """The jumps' fine-tune evaluation of a policy: (the curve's entries, its
    finetune_score, no probe record). warm: select_warm_start's entries."""
    ws = warm["warmstart_apex_mean_m"], warm["warmstart_fwd_m"]

    def evaluate(pol):
        r, _, am, ax, fw = probe.summary(pol)
        return ({"eval_apex_mean": am, "eval_apex_max": ax, "eval_return": r,
                 "eval_fwd_max": fw}, finetune_score(task, ax, am, fw, bar, *ws), None)
    return evaluate


def flip_finetune_eval(probe: FlipProbe):
    """The flip's fine-tune evaluation: the curve's entries, flip_score, the
    probe."""
    def evaluate(pol):
        pr = probe(pol)
        return ({"upright_count": pr["upright_count"], "rotation_count": pr["rotation_count"],
                 "apex_mean": pr["apex_mean_m"]}, flip_score(pr), pr)
    return evaluate


def finetune_stage(trainer, warm_trainer, fs, warmup_iters: int, iters: int,
                   evaluate: Callable, draws=None, log=log_none):
    """Stage 4 (``train_two_stage.py:448-486``, ``train_two_stage_backflip.py:
    322-352``): the critic warm-up (its trainer's lr, CRITIC_WARMUP_LR, on
    the state's optimiser; the actor frozen), then PPO on the dense reward;
    every 5th iteration `evaluate(policy)` (jump_finetune_eval,
    flip_finetune_eval) gives the curve's entries, a score and a probe, and
    the best iterate by score is kept, from -9.9: the warmed-up initializer
    while none beats it (the flip script's -1.0 is the same floor, its
    scores never being negative). draws: {"warmup": [...], "finetune":
    [...]}. Returns (last state, best network, best's probe or None,
    entries)."""
    draws = draws or {}
    fs = _ppo_steps(warm_trainer, fs, warmup_iters, draws.get("warmup"),
                    _log_warmup(log, "PPO-critic-warmup"))
    curve, best = [], {"score": -9.9, "net": copy.deepcopy(fs.net), "probe": None}

    def record(i, fs, m):
        rec = {"iter": i, "mean_reward": float(m["mean_reward"])}
        if i % 5 == 4:
            entries, score, probe = evaluate(mlp_policy(fs.net, fs.obs_norm))
            rec.update(entries)
            if score > best["score"]:
                best.update(score=score, net=copy.deepcopy(fs.net), probe=probe)
            if i % 10 == 9:
                log(f"[PPO-finetune {i:03d}] kl {float(m['kl_est']):.4f} {rec}")
        curve.append(rec)

    fs = _ppo_steps(trainer, fs, iters, draws.get("finetune"), record)
    return fs, best["net"], best["probe"], {
        "ppo_finetune_curve": curve, "ppo_finetune_reward_improved": reward_improved(curve)}


def jump_finetune_entries(task: str, probe: EpisodeProbe, fs, best_net, bar: float,
                          warm: dict) -> dict:
    """The jumps' fine-tune results (``:487-531``): the kept iterate and the
    last one probed, the gates on the kept one."""
    r, _, am, ax, fw = probe.summary(mlp_policy(best_net, fs.obs_norm))
    r2, _, am2, ax2, _ = probe.summary(mlp_policy(fs.net, fs.obs_norm))
    return {"ppo_finetune_final_apex_m": ax, "ppo_finetune_final_apex_mean_m": am,
            "ppo_finetune_final_fwd_m": fw, "ppo_finetune_final_return": r,
            "ppo_finetune_last_iter_apex_m": ax2, "ppo_finetune_last_iter_apex_mean_m": am2,
            "ppo_finetune_last_iter_return": r2,
            **finetune_gates(task, ax, am, fw, bar, warm["warmstart_apex_mean_m"],
                             warm["warmstart_fwd_m"])}


def flip_finetune_entries(probe: FlipProbe, fs, best_probe, expert_probe: dict,
                          im_probe: dict) -> dict:
    """The flip's fine-tune results (``train_two_stage_backflip.py:353-380``):
    the kept iterate's probe (the last one's if none was kept), the last
    one's, the flip gates."""
    last = probe(mlp_policy(fs.net, fs.obs_norm))
    ft_probe = last if best_probe is None else best_probe
    return {"ppo_finetune_probe": ft_probe, "ppo_finetune_last_iter_probe": last,
            **flip_finetune_gates(ft_probe, expert_probe, im_probe)}
