"""Observation noise that belongs to the scenario, not to the lane's place.

The JAX env keeps a PRNG key in its state and splits it at every step
(``quadruped_springs_tpu/env/env.py:387-388, 406-409``). ``ARSTrainer``'s
``train_step`` evaluates all 2·D perturbed policies on one bank of such
states (``quadruped_springs_tpu/train/ars.py:109-122``), so the + and −
episodes of a direction see the same scenario and the same noise: at δ = 0
their returns are equal by construction. The port's env draws the noise of
a lane from ``NoiseStreams`` (one stream per scenario, read at the lane's
own env step), and ARS gathers one stream per bank entry for every lane of
that entry. These tests hold: r+ == r− bitwise at δ = 0 on a noisy env (the
port, and the JAX package's own step), a lane's return independent of its
batch (ARS's candidates, the seeded episodes, the flattened flip), the
reset's noise from row 0 of the stream, and the paths without noise
drawing nothing from the generator (so they stay bitwise as before).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env.env import EnvConfig as JEnvConfig
from quadruped_springs_tpu.env.env import QuadrupedEnv as JQuadrupedEnv
from quadruped_springs_tpu.train.ars import ARSConfig as JARSConfig
from quadruped_springs_tpu.train.ars import ARSTrainer as JARSTrainer
from quadruped_springs_tpu_torch.env import env as tenv
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv, take
from quadruped_springs_tpu_torch.train import ars as tars
from quadruped_springs_tpu_torch.train import behaviour as bh
from quadruped_springs_tpu_torch.train import rollout as ro

FWD = dict(enable_springs=True, task_env="JUMPING_FORWARD", observation_space_mode="ARS_BASIC",
           action_space_mode="SYMMETRIC", settling_steps=20, max_ep_len=0.03)
SMALL = dict(n_directions=3, top_directions=2, episode_steps=4, reset_bank_size=2)


def _env(**kw):
    return QuadrupedEnv(EnvConfig(**dict(FWD, **kw)), device="cpu")


def _spy_returns(monkeypatch):
    """Record the per-lane returns of ARS's rollout."""
    seen = {}
    orig = ro.episode_returns

    def spy(*a, **k):
        rets, info = orig(*a, **k)
        seen["rets"] = rets
        return rets, info

    monkeypatch.setattr(tars.ro, "episode_returns", spy)
    return seen


def _trainer(env, seed=0):
    tr = tars.ARSTrainer(env, tars.ARSConfig(**SMALL))
    ts = tr.init(torch.Generator().manual_seed(seed))
    W = 0.3 * torch.randn(ts.W.shape, generator=torch.Generator().manual_seed(1))
    return tr, tars.dataclasses.replace(ts, W=W)


def test_ars_plus_and_minus_share_scenario_and_noise(monkeypatch):
    """δ = 0 on a noisy env: each bank entry's r+ and r− bitwise equal, for
    every direction, and the update is zero (sigma_r is its 1e-8 floor).
    Before the repair every lane drew fresh noise from the generator."""
    seen = _spy_returns(monkeypatch)
    tr, ts = _trainer(_env(obs_noise=True))
    ts2, m = tr.train_step(ts, deltas=torch.zeros(SMALL["n_directions"], *ts.W.shape))
    r = seen["rets"].view(2, SMALL["n_directions"], SMALL["reset_bank_size"])
    assert torch.equal(r[0], r[1])
    assert not torch.equal(r[0, :, 0], r[0, :, 1])  # two scenarios, two returns
    assert float(m["sigma_r"]) == pytest.approx(1e-8, rel=1e-6)
    assert torch.equal(ts2.W, ts.W)


def test_jax_ars_plus_and_minus_are_equal_by_construction():
    """The JAX package's step with δ = 1e-30 (W ± δ == W in float32) on a
    noisy env: its sigma_r is the 1e-8 floor and W does not move, so r+ ==
    r− for every direction."""
    env = JQuadrupedEnv(JEnvConfig(**dict(FWD, obs_noise=True)))
    tr = JARSTrainer(env, JARSConfig(n_directions=2, top_directions=1, episode_steps=3,
                                     reset_bank_size=2, delta_std=1e-30))
    ts = tr.init(jax.random.PRNGKey(0))
    ts = ts.replace(W=jnp.full_like(ts.W, 0.1))
    ts2, m = tr.train_step(ts)
    assert float(m["sigma_r"]) == np.float32(1e-8)
    np.testing.assert_array_equal(np.asarray(ts2.W), np.asarray(ts.W))
    assert float(m["mean_return"]) != 0.0


def test_ars_lane_return_does_not_depend_on_its_batch(monkeypatch):
    """One candidate on one bank entry, alone and among the 2·D candidates
    of the step: bitwise the same return (its scenario's noise, its W)."""
    seen = _spy_returns(monkeypatch)
    env = _env(obs_noise=True)
    tr, ts = _trainer(env)
    D, B = SMALL["n_directions"], SMALL["reset_bank_size"]
    deltas = 0.05 * torch.randn(D, *ts.W.shape, generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(7)
    ts = tars.dataclasses.replace(ts, generator=gen)
    state0 = gen.get_state()
    tr.train_step(ts, deltas=deltas)
    batch = seen["rets"].view(2, D, B)
    # the same draws again: the bank's streams, then the bank
    gen.set_state(state0)
    noise = tenv.draw_noise(env, gen, B, SMALL["episode_steps"])
    bank = ro.make_reset_bank(env, gen, B, noise=noise)
    for sign, d, b in ((0, 1, 1), (1, 2, 0)):
        W = (ts.W + deltas[d] if sign == 0 else ts.W - deltas[d])[None]
        idx = torch.tensor([b])
        alone, _ = ro.episode_returns(env, tr._policy(W, ts.obs_norm), *take(bank, idx),
                                      SMALL["episode_steps"], noise.take(idx))
        assert torch.equal(alone[0], batch[sign, d, b])


def test_seeded_lanes_do_not_depend_on_their_batch():
    """A seed's lane (its scenario, then its noise stream, from its own
    generator) is the same alone and among other seeds: the reset's
    observation and an episode's return bitwise."""
    env = _env(obs_noise=True)
    s3, o3, n3 = ro.seeded_reset(env, [5, 6, 7])
    s1, o1, n1 = ro.seeded_reset(env, [6])
    assert torch.equal(o3[1], o1[0])
    assert torch.equal(n3.draws[1], n1.draws[0])
    W = 0.3 * torch.randn(env.action_dim, env.obs_dim,
                          generator=torch.Generator().manual_seed(3))
    act = bh.linear_act(W, tars.vnorm.RunningNorm.create(env.obs_dim))
    r3, _ = ro.episode_returns(env, act, s3, o3, 4, n3)
    r1, _ = ro.episode_returns(env, act, s1, o1, 4, n1)
    assert torch.equal(r3[1], r1[0])


def test_flat_flip_score_does_not_depend_on_the_candidates_batch():
    """The joint trainer's flattened-episode score of one candidate alone
    and among 8 candidates, each lane its own parameters (products through
    spatial.mv): bitwise equal."""
    bh_env = QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="BACKFLIP", observation_space_mode="ARS_BACKFLIP",
        action_space_mode="SYMMETRIC", max_ep_len=4.0, settling_steps=20,
        env_randomizer_mode="TEST_RANDOMIZER"), device="cpu")
    state, obs, noise = ro.seeded_reset(bh_env, [0, 1])
    rng = np.random.default_rng(0)
    template = {"W": np.zeros((6, bh_env.obs_dim)), "mlp": {
        "W1": np.zeros((4, bh_env.obs_dim)), "b1": np.zeros(4), "W2": np.zeros((6, 4)),
        "b2": np.zeros(6)}}
    layout = bh.FlatLayout(template)
    cand = (0.3 * rng.standard_normal((8, layout.size))).astype(np.float32)
    on = tars.vnorm.RunningNorm.create(bh_env.obs_dim)

    def score(c_idx, ent):
        p = bh.lanes_params(cand, layout, torch.as_tensor(c_idx), "cpu")
        ent = torch.as_tensor(ent)
        sc, _ = bh.episode_score(bh_env, bh.linear_act(p["W"], on), bh.mlp_act(p["mlp"], on),
                                 take(state, ent), obs[ent], noise.take(ent), 4)
        return sc

    many = score(np.repeat(np.arange(8), 2), np.tile([0, 1], 8))
    alone = score([5], [1])
    assert torch.equal(alone[0], many[5 * 2 + 1])


def test_reset_noise_is_row_zero_of_the_stream():
    """The noisy reset observation is the clean one plus row 0 of each
    lane's stream times the suite's std; a step reads the row of the lane's
    own env step counter."""
    noisy, clean = _env(obs_noise=True), _env(obs_noise=False)
    scen_state, _, noise = ro.seeded_reset(noisy, [3, 4])
    s_c, o_c = clean.reset(scenario=scen_state.scenario)
    s_n, o_n = noisy.reset(scenario=scen_state.scenario, noise=noise)
    np.testing.assert_array_equal(o_n, o_c + noise.draws[:, 0] * noisy._obs_noise_std)
    a = torch.zeros(2, noisy.action_dim)
    s_c2, o_c2, *_ = clean.step(s_c, a)
    # lane 1 one step ahead: its draw is row 2, lane 0's row 1
    s_n = tenv.dataclasses.replace(s_n, env_step_counter=torch.tensor([0, 1], dtype=torch.int32))
    _, o_n2, *_ = noisy.step(s_n, a, noise)
    want = o_c2 + noise.draws[torch.arange(2), torch.tensor([1, 2])] * noisy._obs_noise_std
    np.testing.assert_array_equal(o_n2, want)


def test_paths_without_noise_draw_nothing():
    """obs_noise=False: no stream is drawn and the generator does not move,
    so ARS's draws (and every result) are what they were before the
    repair."""
    env = _env(obs_noise=False)
    gen = torch.Generator().manual_seed(11)
    before = gen.get_state()
    assert tenv.draw_noise(env, gen, 4, 10) is None
    assert torch.equal(gen.get_state(), before)
    state, obs, noise = ro.seeded_reset(env, [1, 2])
    assert noise is None and obs.shape == (2, env.obs_dim)
