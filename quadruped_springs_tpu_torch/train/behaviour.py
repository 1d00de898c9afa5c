"""The behaviour-policy trainers' shared pieces: the backflip launch and its
landing policies.

Port of what ``scripts/train_behavior_policies.py``,
``train_backflip_landing_mlp.py``, ``train_backflip_robust_joint.py`` and
``validate_backflip_robust.py`` share, as plain functions:

  * the ridge fit of the behaviour-cloned launch and the scripted
    crouch-and-launch demonstration (`ridge_fit`, `script_action`,
    `collect_script_demo`);
  * seeded episodes through ``LandingWrapperBackflip`` over a batch of lanes
    (`wrapper_episode`, `run_to_touchdown`): each lane replays one seed's
    scenario and observation-noise stream (``rollout.seeded_reset``), and a
    lane that is done freezes and stops earning reward where the scripts'
    serial loops ``break``;
  * the shaped objectives of the lander (`stab_score`) and of the joint
    launch-and-lander training (`episode_score`, over the flattened
    autopilot episode of ``env/flat_rollout.py``);
  * policies with one parameter set per lane (`linear_act`, `mlp_act`), their
    products through ``models/spatial.mv``, so a candidate's result does
    not depend on how many candidates share the launch;
  * ``jax.flatten_util.ravel_pytree``'s layout of the scripts' parameter
    dicts (`FlatLayout`: keys sorted, each leaf row-major);
  * the two ARS updates of the scripts, copied exactly in numpy
    (`behaviour_update`, `flat_update`);
  * the gate's rows on the host (`flip_rows`), read from
    ``two_stage.flip_lanes``: full rotation (max unwrapped pitch >= 2π − 0.1),
    up_z > 0.85 and base height > 0.15 m.

The ARS draws come from ``np.random.default_rng(0)`` in the scripts' order,
so with the same parameters the port's δ are the JAX scripts' own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from quadruped_springs_tpu_torch.env import flat_rollout as fr
from quadruped_springs_tpu_torch.env import wrappers as wr
from quadruped_springs_tpu_torch.env.env import (EnvConfig, NoiseStreams, QuadrupedEnv,
                                                  select, take)
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.train import normalize as vnorm
from quadruped_springs_tpu_torch.train import rollout as ro
from quadruped_springs_tpu_torch.train.two_stage import ROT_BAR, UP_Z_BAR, Z_BAR, flip_lanes

Z_STAND = 0.30                   # the lander's standing height
SETTLE = 2500                    # the scripts' settle (EnvConfig's default)
# the scripted launch: a 6-step crouch ramp, then the extension
CROUCH = (0.0, 0.5, -0.9, 0.0, 0.5, -0.9)
LAUNCH = (0.0, -0.3, 0.7, 0.0, -1.0, 1.0)


def flip_env(device, randomizer: str = "GROUND_RANDOMIZER", obs_noise: bool = True,
             max_ep_len: float = 4.0) -> QuadrupedEnv:
    """The scripts' backflip env: springs, BACKFLIP, the ARS_BACKFLIP
    observation, symmetric actions."""
    return QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="BACKFLIP", observation_space_mode="ARS_BACKFLIP",
        action_space_mode="SYMMETRIC", obs_noise=obs_noise, max_ep_len=max_ep_len,
        env_randomizer_mode=randomizer, settling_steps=SETTLE), device=device)


# -- numpy pieces, as the scripts write them ---------------------------------

def ridge_fit(O, A, lam=1e-3):
    mean = O.mean(0)
    var = O.var(0) + 1e-8
    X = (O - mean) / np.sqrt(var)
    W = np.linalg.solve(X.T @ X + lam * np.eye(X.shape[1]), X.T @ A).T
    return W, mean, var


def behaviour_update(W, rp, rm, deltas, top_b: int, step_size: float, delta_std: float):
    """train_behavior_policies.py's update: top-b directions by max(r+, r−),
    float64 δ (D, A, obs_dim)."""
    order = np.argsort(-np.maximum(rp, rm))[:top_b]
    sigma = np.std(np.concatenate([rp[order], rm[order]])) + 1e-8
    upd = np.einsum("d,dij->ij", rp[order] - rm[order], deltas[order])
    return W + step_size / delta_std * upd / (top_b * sigma)


def flat_update(flat, rp, rm, deltas, step_size: float):
    """The lander's and the joint trainer's update over a flat parameter
    vector: the top half of the directions, float32 δ (D, P)."""
    order = np.argsort(-np.maximum(rp, rm))[:len(rp) // 2]
    sigma = np.std(np.concatenate([rp[order], rm[order]])) + 1e-8
    return flat + step_size / (len(order) * sigma) * ((rp[order] - rm[order]) @ deltas[order])


class FlatLayout:
    """``jax.flatten_util.ravel_pytree``'s layout of a nested dict of
    arrays: the leaves in sorted-key order, each row-major."""

    def __init__(self, template: dict):
        self.leaves = []

        def walk(tree, path):
            for k in sorted(tree):
                if isinstance(tree[k], dict):
                    walk(tree[k], path + (k,))
                else:
                    self.leaves.append((path + (k,), tuple(np.shape(tree[k]))))

        walk(template, ())
        self.size = sum(math.prod(s) for _, s in self.leaves)

    def ravel(self, tree: dict) -> np.ndarray:
        parts = []
        for path, _ in self.leaves:
            leaf = tree
            for k in path:
                leaf = leaf[k]
            parts.append(np.asarray(leaf, np.float32).ravel())
        return np.concatenate(parts)

    def unravel(self, flat) -> dict:
        """flat (P,) numpy, or (N, P) tensor -> the dict, leaves (N, *shape)
        for a tensor (one parameter set per lane)."""
        out, i = {}, 0
        lead = tuple(flat.shape[:-1])
        for path, shape in self.leaves:
            n = math.prod(shape)
            leaf = flat[..., i:i + n].reshape(lead + shape)
            i += n
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return out


def cat_tree(trees: Sequence):
    """Lanes of several (nested) state dataclasses or tensors, concatenated."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.cat(list(trees))
    return dataclasses.replace(first, **{
        f.name: cat_tree([getattr(t, f.name) for t in trees])
        for f in dataclasses.fields(first)})


# -- policies, one parameter set per lane --------------------------------------

def linear_act(W: torch.Tensor, on: vnorm.RunningNorm) -> Callable:
    """obs (N, d) -> clip(W normalize(obs)), W (A, d) or (N, A, d)."""
    return lambda o: torch.clamp(sp.mv(W, vnorm.normalize(on, o)), -1.0, 1.0)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """x clipped to [lo, hi] as min(max(x, lo), hi): the values of
    torch.clamp, and jnp.clip's derivative at a tie, one half (torch.clamp's
    is one). The lander starts at W2 = 0 and b2 = the landing action, so an
    action component exactly at ±1 is plausible where BPTT differentiates."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def mlp_act(p: dict, on: vnorm.RunningNorm) -> Callable:
    """The scripts' one-hidden-layer lander, clip(W2 tanh(W1 o + b1) + b2)
    of the normalised observation; leaves shared or (N, ...) per lane."""
    def act(o):
        h = torch.tanh(sp.mv(p["W1"], vnorm.normalize(on, o)) + p["b1"])
        return clip(sp.mv(p["W2"], h) + p["b2"], -1.0, 1.0)
    return act


def lanes_params(flat: np.ndarray, layout: FlatLayout, cand: torch.Tensor, device) -> dict:
    """Candidates' flat parameters (C, P) unravelled per lane: lane i gets
    candidate cand[i]."""
    return layout.unravel(torch.as_tensor(flat, dtype=torch.float32, device=device)[cand])


# -- episodes -------------------------------------------------------------------

def script_action(i: int, device) -> torch.Tensor:
    """The scripted launch at control step i: the crouch ramped over 6
    steps, then the extension."""
    if i < 6:
        return torch.tensor(CROUCH, device=device) * min((i + 1) / 6, 1.0)
    return torch.tensor(LAUNCH, device=device)


@torch.no_grad()
def collect_script_demo(env, n_seeds: int = 8, max_steps: int = 40, start=None):
    """The scripted launch on seeds 0..n_seeds-1 (one lane each; `start`
    (state, obs, noise) gives the lanes instead), recording (obs, action)
    before each step until two steps after the take-off switch, as the
    script's loop (which steps on past a done episode); returns (O, A)
    float32, seed by seed as the script appends."""
    state, obs, noise = ro.seeded_reset(env, range(n_seeds)) if start is None else start
    n = obs.shape[0]
    extra = torch.zeros(n, dtype=torch.int32, device=obs.device)
    active = torch.ones(n, dtype=torch.bool, device=obs.device)
    O, A, M = [], [], []
    for i in range(max_steps):
        a = script_action(i, obs.device).expand(n, -1)
        O.append(obs)
        A.append(a)
        M.append(active)
        state, obs, _, _, _ = env.step(state, a, noise)
        extra = extra + (active & state.task.switched_controller).to(torch.int32)
        active = active & (extra < 2)
        if not bool(active.any()):
            break
    O, A, M = (torch.stack(x, 1).cpu().numpy() for x in (O, A, M))
    return (np.concatenate([O[k][M[k]] for k in range(n)]),
            np.concatenate([A[k][M[k]] for k in range(n)]))


@torch.no_grad()
def wrapper_episode(w: wr.LandingWrapperBackflip | wr.LandingWrapper, act: Callable, state,
                    obs: torch.Tensor, noise: NoiseStreams | torch.Generator | None,
                    max_steps: int):
    """The scripts' serial episode over lanes: act(obs, armed) -> actions
    (armed is None for LandingWrapper and the "hold" variant;
    "until_grounded" carries the one-shot state, and the action source
    follows it). Stops when every lane is done, a done lane frozen at its
    done step; one host read per policy step. Returns (final state, summed
    reward (N,) float64, as the scripts' float sums)."""
    n = obs.shape[0]
    v2 = getattr(w, "variant", None) == "until_grounded"
    wstate = w.init_state(n) if v2 else None
    done = torch.zeros(n, dtype=torch.bool, device=obs.device)
    total = torch.zeros(n, dtype=torch.float64, device=obs.device)
    for _ in range(max_steps):
        a = act(obs, None if wstate is None else wstate.armed)
        if v2:
            out, w2 = w.step(state, a, noise, wstate)
            wstate = select(done, wstate, w2)
        else:
            out = w.step(state, a, noise)
        total = total + torch.where(done, 0.0, out.reward.to(torch.float64))
        state = select(done, state, out.state)
        obs = torch.where(done[:, None], obs, out.obs)
        done = done | out.done
        if bool(done.all()):
            break
    return state, total


def launch_then_lander(launch: Callable, lander: Callable) -> Callable:
    """The deployed pair: the launch while the autopilot is armed, the
    lander after it has fired."""
    return lambda o, armed: torch.where(armed[:, None], launch(o), lander(o))


def seeded_episodes(env, act: Callable, seeds: Sequence[int], variant: str,
                    max_steps: int, lanes: torch.Tensor | None = None):
    """wrapper_episode on one lane per seed (each its seed's scenario and
    noise), or on `lanes` (M,) indices into the seeds (several lanes
    replaying one seed). Returns (final state, summed reward)."""
    w = wr.LandingWrapperBackflip(env, variant=variant)
    state, obs, noise = ro.seeded_reset(env, seeds)
    if lanes is not None:
        state, obs = take(state, lanes), obs[lanes]
        noise = None if noise is None else noise.take(lanes)
    return wrapper_episode(w, act, state, obs, noise, max_steps)


def flip_rows(state) -> list[dict]:
    """Per lane, ``two_stage.flip_lanes`` of a final state on the host: the
    scripts' per-episode records (pitch_rad, up_z, z, apex, rotation,
    upright)."""
    g = {k: v.tolist() for k, v in flip_lanes(state).items()}
    return [dict(zip(g, lane)) for lane in zip(*g.values())]


@torch.no_grad()
def run_to_touchdown(w: wr.LandingWrapperBackflip, launch: Callable, state, obs, noise,
                     max_steps: int = 40):
    """The frozen launch through the "until_grounded" autopilot until it
    returns control, per lane (the landing trainer's `run_to_touchdown`).
    Returns (state and obs where the lane stopped, rotation (N,) bool, crashed
    (N,) bool): crashed unless the autopilot fired in a step that did not
    end the episode within max_steps."""
    n = obs.shape[0]
    wstate = w.init_state(n)
    stopped = torch.zeros(n, dtype=torch.bool, device=obs.device)
    fired_ok = stopped.clone()
    for _ in range(max_steps):
        out, w2 = w.step(state, launch(obs), noise, wstate)
        live = ~stopped
        fired = live & wstate.armed & ~w2.armed
        fired_ok = fired_ok | (fired & ~out.done)
        state = select(stopped, state, out.state)
        obs = torch.where(stopped[:, None], obs, out.obs)
        wstate = select(stopped, wstate, w2)
        stopped = stopped | fired | (live & out.done)
        if bool(stopped.all()):
            break
    return state, obs, flip_lanes(state)["rotation"] & fired_ok, ~fired_ok


# -- shaped objectives --------------------------------------------------------

def stab_return(env, act: Callable, state0, obs0, noise, horizon: int):
    """The lander's shaped stabilisation return from touchdown states, per
    lane (train_backflip_landing_mlp.py `stab_score`): the env steps on
    after done as the script's scan does, the shaped terms stop. Returns
    (total (N,), strict (N,) bool). Differentiable: under grad, the total's
    gradient runs back through every env.step (the lander's --optimizer
    bptt); `stab_score` is the same under no_grad."""
    state, obs = state0, obs0
    done_ever = torch.zeros(obs0.shape[0], dtype=torch.bool, device=obs0.device)
    rews = []
    for _ in range(horizon):
        state2, obs2, _, d, _ = env.step(state, act(obs), noise)
        alive = ~done_ever
        up_z = sp.quat_to_mat(state2.robot.quat)[:, 2, 2]
        z = state2.robot.pos[:, 2]
        w2 = sp.sum_fixed(state2.robot.ang_vel ** 2)
        rews.append(torch.where(
            alive,
            0.4 * clip(up_z, 0.0, 1.0) + 0.3 * torch.exp(-20.0 * (z - Z_STAND) ** 2)
            + 0.1 * torch.exp(-0.3 * w2) + 0.3, 0.0) / horizon)
        done_ever = done_ever | d
        state, obs = state2, obs2
    g = flip_lanes(state)
    up_f, rot_f = g["up_z"], g["pitch_rad"]
    alive_f = (~done_ever).to(torch.float32)
    strict = ~done_ever & g["upright"]
    terminal = (torch.where(strict, 1.0, 0.0)
                + 0.5 * alive_f * clip(up_f, 0.0, 1.0)
                + 0.5 * alive_f * torch.sigmoid(30.0 * (up_f - UP_Z_BAR))
                + 0.5 * alive_f * torch.sigmoid(200.0 * (rot_f - ROT_BAR)))
    return sp.sum_fixed(torch.stack(rews), 0) + terminal, strict


stab_score = torch.no_grad()(stab_return)
stab_score.__doc__ = """stab_return under no_grad: the ARS paths' scorer."""


@torch.no_grad()
def episode_score(env, launch: Callable, lander: Callable, state0, obs0, noise, knots: int):
    """The joint trainer's smoothed gate over the flattened autopilot
    episode, per lane (train_backflip_robust_joint.py `episode_score`).
    Returns (score (N,), strict (N,) bool)."""
    state_f, _, traj = fr.backflip_episode(env, launch, lander, state0, obs0, knots, noise)
    g = flip_lanes(state_f)
    pitch_f, up_f, z_f = g["pitch_rad"], g["up_z"], g["z"]
    alive_frac = 1.0 - sp.sum_fixed(traj["done"].to(torch.float32), 0) / knots
    score = (2.0 * torch.sigmoid(60.0 * (pitch_f - ROT_BAR))
             + 0.5 * torch.clamp(pitch_f / (2 * math.pi), 0.0, 1.0)
             + 1.0 * torch.clamp(up_f, 0.0, 1.0)
             + 1.0 * torch.sigmoid(30.0 * (up_f - UP_Z_BAR))
             + 0.5 * torch.sigmoid(50.0 * (z_f - Z_BAR))
             + 0.3 * alive_frac)
    return score, g["rotation"] & g["upright"]


def candidate_means(values: torch.Tensor, n_cand: int) -> np.ndarray:
    """Lanes ordered (candidate, scenario) -> each candidate's mean, float32
    on the host as the scripts' jnp.mean."""
    v = values.view(n_cand, -1)
    return (sp.sum_fixed(v.T, 0) / v.shape[1]).cpu().numpy()
