"""The port's training stack below PPO on the CPU against the JAX package:
RunningNorm, the networks, the rollouts with injected draws, one ARS
train_step on JAX's own deltas and reset bank, the evaluation harness and
the checkpoint. Tolerances are stated at each comparison; rollouts through
the stiff simulator follow tests/test_torch_env.py (a few control steps from
a JAX reset carried across by ``convert.env_state``).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.train import ars as jars
from quadruped_springs_tpu.train import networks as jnets
from quadruped_springs_tpu.train import normalize as jnorm
from quadruped_springs_tpu.train import rollout as jro
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.env import env as tenv
from quadruped_springs_tpu_torch.train import ars as tars
from quadruped_springs_tpu_torch.train import evaluate as tev
from quadruped_springs_tpu_torch.train import networks as tnets
from quadruped_springs_tpu_torch.train import normalize as tnorm
from quadruped_springs_tpu_torch.train import rollout as tro
from quadruped_springs_tpu_torch.utils import checkpoint as tckpt
from tests.conftest import env_factory

BASE = dict(enable_springs=True, motor_control_mode="PD", action_space_mode="SYMMETRIC",
            task_env="JUMPING_IN_PLACE_PPO", observation_space_mode="ARS_BASIC",
            obs_noise=False, settling_steps=50, max_ep_len=0.06)
_jax_env = env_factory(**BASE)


def _envs(**kw):
    return _jax_env(**kw), tenv.QuadrupedEnv(tenv.EnvConfig(**dict(BASE, **kw)), device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, err_msg="", **tol):
    got = got.detach() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=err_msg, **tol)


def _same_norm(t, j, tol=1e-6):
    for f in ("mean", "var", "count"):
        _close(getattr(t, f), getattr(j, f), f, rtol=tol, atol=tol)


def test_running_norm_updates_match_jax():
    """update (population variance), update_from_moments and normalize, to 1e-6."""
    rng = np.random.default_rng(0)
    jn, tn = jnorm.RunningNorm.create(5), tnorm.RunningNorm.create(5, "cpu")
    for n in (7, 1, 30):
        batch = (rng.standard_normal((n, 5)) * [1, 2, 0.1, 5, 1] + [0, 1, -1, 3, 0]).astype(
            np.float32)
        jn, tn = jnorm.update(jn, jnp.asarray(batch)), tnorm.update(tn, _t(batch))
        _same_norm(tn, jn)
    batch = rng.standard_normal((12, 5)).astype(np.float32)
    moments = (np.float32(12.0), batch.sum(0), (batch * batch).sum(0))
    jn2 = jnorm.update_from_moments(jn, *map(jnp.asarray, moments))
    tn2 = tnorm.update_from_moments(tn, *map(_t, moments))
    _same_norm(tn2, jn2)
    # no live step at all: the statistics stay
    zero = (np.float32(0.0), np.zeros(5, np.float32), np.zeros(5, np.float32))
    _same_norm(tnorm.update_from_moments(tn, *map(_t, zero)),
               jnorm.update_from_moments(jn, *map(jnp.asarray, zero)))
    obs = (20 * rng.standard_normal((4, 5))).astype(np.float32)
    _close(tnorm.normalize(tn2, _t(obs)), jnorm.normalize(jn2, jnp.asarray(obs)),
           rtol=1e-6, atol=1e-6)
    _same_norm(convert.running_norm(jn2), jn2, tol=0)


@pytest.mark.parametrize("hidden", [(64, 64), (8,), (16, 8, 4)])
def test_mlp_policy_forward_and_logp_from_flax_parameters(hidden):
    """A flax parameter tree carried into the module: mean, log_std, value
    and gaussian_logp to 1e-6; the module's parameter names and shapes."""
    rng = np.random.default_rng(1)
    jnet = jnets.MLPPolicy(6, hidden)
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros(11))
    params = jax.tree.map(lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape),
                                                          jnp.float32), params)
    net = convert.mlp_policy(jax.tree.map(np.asarray, params), "cpu")
    assert net.hidden == hidden
    names = [n for n, _ in net.named_parameters()]
    assert set(names) == {"log_std"} | {
        f"{t}_{i}.{p}" for t in ("pi", "vf") for i in [*range(len(hidden)), "out"]
        for p in ("weight", "bias")}
    obs = rng.standard_normal((5, 11)).astype(np.float32)
    a = rng.standard_normal((5, 6)).astype(np.float32)
    jm, jls, jv = jnet.apply(params, jnp.asarray(obs))
    tm, tls, tv = net(_t(obs))
    _close(tm, jm, rtol=1e-6, atol=1e-6)
    _close(tls, jls, rtol=0, atol=0)
    _close(tv, jv, rtol=1e-6, atol=1e-6)
    _close(tnets.gaussian_logp(_t(a), tm, tls), jnets.gaussian_logp(jnp.asarray(a), jm, jls),
           rtol=1e-6, atol=1e-5)
    # deterministic sampling: the clipped mean, zero logp
    ta, tlp, _ = tnets.sample_action(net, _t(10 * obs), deterministic=True)
    ja, jlp, _ = jnets.sample_action(params, jnet.apply, jnp.asarray(10 * obs), None, True)
    _close(ta, ja, rtol=1e-6, atol=1e-6)
    _close(tlp, jlp)
    sa, slp, _ = tnets.sample_action(net, _t(obs), torch.Generator().manual_seed(0))
    assert float(sa.detach().abs().max()) <= 1.0 and slp.shape == (5,)


def test_fresh_mlp_policy_is_initialised_as_flax_initialises():
    """LeCun-normal weights (variance 1 / fan-in, truncated at 2 sigma), zero
    biases, log_std -0.5; the same generator seed gives the same network."""
    net = tnets.MLPPolicy(300, 6, (400, 64), generator=torch.Generator().manual_seed(0))
    w = net.pi_0.weight
    assert abs(float(w.std()) * 300 ** 0.5 - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 / 0.87962566 / 300 ** 0.5 + 1e-6
    assert float(net.vf_out.bias.abs().max()) == 0.0
    _close(net.log_std, np.full(6, -0.5, np.float32))
    again = tnets.MLPPolicy(300, 6, (400, 64), generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.vf_1.weight, net.vf_1.weight)
    jp = jnets.MLPPolicy(6, (400, 64)).init(jax.random.PRNGKey(0), jnp.zeros(300))["params"]
    assert abs(float(jnp.std(jp["pi_0"]["kernel"])) / float(w.std()) - 1.0) < 0.02


def test_linear_policy_apply_shared_and_per_lane():
    rng = np.random.default_rng(2)
    W = rng.standard_normal((3, 6, 9)).astype(np.float32)
    obs = rng.standard_normal((3, 9)).astype(np.float32)
    want = jax.vmap(jnets.linear_policy_apply)(jnp.asarray(W), jnp.asarray(obs))
    _close(tnets.linear_policy_apply(_t(W), _t(obs)), want, rtol=1e-6, atol=1e-6)
    shared = jax.vmap(jnets.linear_policy_apply, in_axes=(None, 0))(jnp.asarray(W[0]),
                                                                    jnp.asarray(obs))
    _close(tnets.linear_policy_apply(_t(W[0]), _t(obs)), shared, rtol=1e-6, atol=1e-6)
    assert float(np.abs(np.asarray(want)).max()) == 1.0       # the clip is reached


def _bank(jenv, seed, n):
    jbank = jro.make_reset_bank(jenv, jax.random.PRNGKey(seed), n)
    return jbank, (convert.env_state(jbank[0]), _t(jbank[1]))


def test_episode_returns_match_jax():
    """9 control steps from a JAX reset bank of 3 under one linear policy;
    the episode times out at its 6th step (in float32 60 ms exceeds 0.06 s),
    so the last three steps are frozen. Returns
    to 1e-5, lengths exact, the moments of the post-step observations over
    live steps to 2e-3 relative (joint velocities after stiff substeps)."""
    jenv, tenv_ = _envs()
    (jstates, jobs), (tstates, tobs) = _bank(jenv, 0, 3)
    W = (0.05 * np.random.default_rng(3).standard_normal((6, jenv.obs_dim))).astype(
        np.float32)
    jret, jinfo = jax.jit(lambda s, o: jro.episode_returns(
        jenv, lambda ob: jax.vmap(jnets.linear_policy_apply, (None, 0))(jnp.asarray(W), ob),
        s, o, 9))(jstates, jobs)
    tret, tinfo = tro.episode_returns(
        tenv_, lambda ob: tnets.linear_policy_apply(_t(W), ob), tstates, tobs, 9)
    assert tinfo["length"].tolist() == np.asarray(jinfo["length"]).tolist() == [6, 6, 6]
    _close(tret, jret, rtol=0, atol=1e-5)
    _close(tinfo["obs_count"], jinfo["obs_count"])
    assert float(tinfo["obs_count"]) == 18.0
    _close(tinfo["obs_sum"], jinfo["obs_sum"], rtol=2e-3, atol=2e-2)
    _close(tinfo["obs_sumsq"], jinfo["obs_sumsq"], rtol=2e-3, atol=2e-2)
    _close(tinfo["max_height"], jinfo["max_height"], rtol=0, atol=2e-5)
    _close(tinfo["max_fwd"], jinfo["max_fwd"], rtol=0, atol=2e-5)


def test_segment_rollout_matches_jax_with_injected_draws():
    """8 steps of 3 lanes with auto-reset from a bank of 2 (the episode
    times out at its 6th step): the same normal draws and bank indices on both
    sides, through an AR(1) action function. The stored action is the
    unclipped one, eps restarts at the reset, the lanes continue from the
    bank's rows."""
    jenv, tenv_ = _envs()
    jbank, tbank = _bank(jenv, 1, 2)
    T, n, A = 8, 3, jenv.action_dim
    rng = np.random.default_rng(4)
    nu = rng.standard_normal((T, n, A)).astype(np.float32)
    idx = rng.integers(0, 2, (T, n))
    start = np.array([0, 1, 1])
    W = (0.05 * rng.standard_normal((A, jenv.obs_dim))).astype(np.float32)
    rho = 0.9

    def action_fn(xp, lin):
        def fn(obs, nu_t, eps_prev):
            eps = rho * eps_prev + np.sqrt(1 - rho * rho) * nu_t
            a = lin(obs) + 1.5 * eps
            return a, xp.sum(a, -1), xp.sum(obs, -1), eps
        return fn

    # the JAX rollout draws from keys: the same loop body with the draws given
    jfn = action_fn(jnp, lambda o: o @ jnp.asarray(W).T)

    def jax_segment(states, obs):
        def step(carry, inp):
            states, obs, eps = carry
            nu_t, idx_t = inp
            action, logp, value, eps2 = jfn(obs, nu_t, eps)
            s2, o2, r, done, info = jax.vmap(jenv.step)(states, jnp.clip(action, -1.0, 1.0))
            rs = jax.tree.map(lambda a: a[idx_t], jbank[0])
            sel = lambda new, old: jnp.where(
                done.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)
            out = {"obs": obs, "action": action, "logp": logp, "value": value, "reward": r,
                   "done": done}
            return (jax.tree.map(sel, s2, rs), jnp.where(done[:, None], jbank[1][idx_t], o2),
                    jnp.where(done[:, None], 0.0, eps2)), out
        eps0 = jnp.zeros((n, A))
        return jax.lax.scan(step, (states, obs, eps0), (jnp.asarray(nu), jnp.asarray(idx)))

    take = lambda tree: jax.tree.map(lambda a: a[start], tree)
    (js, jobs, _), jtraj = jax.jit(jax_segment)(take(jbank[0]), take(jbank[1]))
    ts, tobs, ttraj = tro.segment_rollout(
        tenv_, action_fn(torch, lambda o: o @ _t(W).T), tenv.take(tbank[0], _t(start)),
        tbank[1][_t(start)], tbank, None, T, noise=_t(nu), reset_idx=_t(idx))
    np.testing.assert_array_equal(ttraj["done"], jtraj["done"])
    assert ttraj["done"].sum(0).tolist() == [1, 1, 1] and bool(ttraj["done"][5].all())
    assert bool(ttraj["pg_mask"].all()) and ttraj["pg_mask"].dtype == torch.bool
    assert float(ttraj["action"].abs().max()) > 1.0          # stored unclipped
    # test_torch_env's 2e-3 per control step on the observation, over the 6
    # steps of an episode; logp and value here are sums of 6 and 27 of them
    for k, tol in (("obs", 1.2e-2), ("action", 1.2e-2), ("logp", 5e-2), ("value", 5e-2),
                   ("reward", 1e-5)):
        _close(ttraj[k], jtraj[k], k, rtol=0, atol=tol)
    # after the reset at step 5, step 6 starts from the bank's rows
    _close(ttraj["obs"][6], np.asarray(jbank[1])[idx[5]], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ts.sim_step_counter, js.sim_step_counter)
    assert ts.sim_step_counter.tolist() == [20, 20, 20]
    _close(tobs, jobs, rtol=0, atol=4e-3)
    # the generator path draws its own noise and indices
    gen = torch.Generator().manual_seed(0)
    _, _, drawn = tro.segment_rollout(
        tenv_, action_fn(torch, lambda o: o @ _t(W).T), tenv.take(tbank[0], _t(start)),
        tbank[1][_t(start)], tbank, gen, 3)
    assert drawn["action"].shape == (3, n, A) and bool(torch.isfinite(drawn["action"]).all())


def test_ars_train_step_matches_jax_on_its_own_draws():
    """One ARS train_step (4 directions, top 2, bank 2, 7-step episodes that
    time out at their 6th step) with the deltas and the reset bank JAX's train_step
    draws from its key: returns within 1e-5 absolute, the update of W to 1e-4
    of its largest entry, the statistics to 2e-3 (rollout observations), the
    metrics, iteration and curriculum level."""
    jenv, tenv_ = _envs(env_randomizer_mode="TEST_RANDOMIZER_CURRICULUM")
    kw = dict(n_directions=4, top_directions=2, episode_steps=7, reset_bank_size=2,
              step_size=0.02, delta_std=0.3, curriculum_increase=0.25)
    jtr, ttr = jars.ARSTrainer(jenv, jars.ARSConfig(**kw)), tars.ARSTrainer(
        tenv_, tars.ARSConfig(**kw))
    jts = jtr.init(jax.random.PRNGKey(5))
    W0 = (0.02 * np.random.default_rng(5).standard_normal(jts.W.shape)).astype(np.float32)
    jts = jts.replace(W=jnp.asarray(W0), curriculum_level=jnp.asarray(0.5, jnp.float32))
    # the draws of jars.ARSTrainer.train_step, from the same key
    _, k_delta, k_bank = jax.random.split(jts.key, 3)
    deltas = jax.random.normal(k_delta, (4,) + jts.W.shape) * 0.3
    jbank = jro.make_reset_bank(jenv, k_bank, 2, curriculum_level=jts.curriculum_level)
    jts2, jm = jtr.train_step(jts)

    tts = dataclasses.replace(ttr.init(torch.Generator().manual_seed(0)), W=_t(W0),
                              curriculum_level=0.5)
    tts2, tm = ttr.train_step(tts, deltas=_t(deltas),
                              bank=(convert.env_state(jbank[0]), _t(jbank[1])))
    for k in ("mean_return", "best_return", "sigma_r"):
        _close(tm[k], jm[k], k, rtol=1e-3, atol=1e-5)
    assert float(jm["sigma_r"]) > 1e-4       # the returns differ: a real update
    dW_j, dW_t = np.asarray(jts2.W) - W0, tts2.W.numpy() - W0
    assert np.abs(dW_j).max() > 1e-3
    _close(dW_t, dW_j, rtol=0, atol=1e-4 * np.abs(dW_j).max())
    _same_norm(tts2.obs_norm, jts2.obs_norm, tol=2e-3)
    assert float(tts2.obs_norm.count) == pytest.approx(2 * 4 * 2 * 6, abs=1e-3)
    assert tts2.iteration == int(jts2.iteration) == 1
    assert tts2.curriculum_level == pytest.approx(float(jts2.curriculum_level)) == 0.75
    assert ttr.increase_curriculum_level(tts2, 0.5).curriculum_level == 1.0
    # frozen statistics stay; the generator path draws its own deltas and bank
    frozen = tars.ARSTrainer(tenv_, tars.ARSConfig(**dict(kw, freeze_obs_norm=True)))
    tts3, _ = frozen.train_step(tts)
    assert tts3.obs_norm is tts.obs_norm and not torch.equal(tts3.W, tts.W)
    ev = ttr.evaluate(tts2, n_episodes=2)
    assert set(ev) == {"return_mean", "return_std", "max_height", "max_fwd"}
    assert all(bool(torch.isfinite(v)) for v in ev.values())


def test_ars_warns_when_episodes_cannot_end_inside_the_rollout():
    _, tenv_ = _envs()
    with pytest.warns(UserWarning, match="shorter than the env timeout"):
        tars.ARSTrainer(tenv_, tars.ARSConfig(episode_steps=3))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tars.ARSTrainer(tenv_, tars.ARSConfig(episode_steps=7))


def test_rsi_bank_spawns_at_demo_rows():
    """make_rsi_bank: every entry sits in the robot state of the demo row it
    drew, with the imitation index set to that row; rsi_index stays inside
    the demo and favours its first fifth."""
    from quadruped_springs_tpu_torch.utils import demo as tdemo

    rng = np.random.default_rng(6)
    T = 40
    demo = np.concatenate([rng.uniform(-1, 1, (T, 6)), 0.1 * rng.standard_normal((T, 38))],
                          axis=1).astype(np.float32)
    demo[:, 6:18] += np.array([0.0, np.pi / 4, -np.pi / 2] * 4, np.float32)
    demo[:, 30:33] = [0.0, 0.0, 0.32]
    demo[:, 33:37] = [0.0, 0.0, 0.0, 1.0]
    env = tenv.QuadrupedEnv(tenv.EnvConfig(**dict(BASE, task_env="JUMPING_IN_PLACE_DEMO")),
                            demo_actions=_t(demo[:, :6]), device="cpu")
    gen = torch.Generator().manual_seed(1)
    states, obs = tro.make_rsi_bank(env, _t(demo), gen, 16)
    idx = states.task.demo_counter.long()
    assert obs.shape == (16, env.obs_dim) and torch.equal(states.task.demo_start.long(), idx)
    _close(states.robot.q, demo[idx.numpy(), 6:18])
    _close(states.robot.pos, demo[idx.numpy(), 30:33])
    draws = tdemo.rsi_index(gen, T, 4000)
    assert int(draws.min()) >= 0 and int(draws.max()) == T - 1
    early = float((draws < 8).float().mean())
    assert abs(early - (0.2 + 0.8 * 0.2)) < 0.03


def test_experiment_and_checkpoint_roundtrip(tmp_path):
    """save_experiment / load_experiment for both algorithms: the reloaded
    deterministic policy gives the saved one's actions; evaluate_policy's
    KPIs are finite floats; checkpoint.save / restore keep a nested tree."""
    from quadruped_springs_tpu_torch.train.ppo import PPOConfig, PPOTrainer

    _, tenv_ = _envs(obs_noise=True)
    gen = torch.Generator().manual_seed(2)
    ats = tars.ARSTrainer(tenv_, tars.ARSConfig(episode_steps=7)).init(gen)
    ats = dataclasses.replace(ats, W=torch.randn(ats.W.shape, generator=gen) * 0.1,
                              obs_norm=tnorm.update(ats.obs_norm,
                                                    torch.randn(9, tenv_.obs_dim)))
    ptr = PPOTrainer(tenv_, PPOConfig(n_envs=2, reset_bank_size=2, hidden=(8, 4)))
    pts = ptr.init(gen)
    obs = torch.randn(3, tenv_.obs_dim)
    want = {"ars": tnets.linear_policy_apply(ats.W, tnorm.normalize(ats.obs_norm, obs)),
            "ppo": torch.clamp(pts.net(tnorm.normalize(pts.obs_norm, obs))[0], -1, 1)}
    for algo, ts in (("ars", ats), ("ppo", pts)):
        path = str(tmp_path / algo)
        tev.save_experiment(path, tenv_.config, algo, ts)
        env2, policy = tev.load_experiment(path, "cpu")
        assert env2.config == tenv_.config
        _close(policy(obs), want[algo].detach(), rtol=0, atol=0)
        kpis = tev.evaluate_policy(env2, policy, gen, n_episodes=2, max_steps=3)
        assert set(kpis) == {"return_mean", "return_std", "episode_len_mean", "max_height",
                             "max_fwd"}
        assert all(isinstance(v, float) and np.isfinite(v) for v in kpis.values())
        assert kpis["episode_len_mean"] == 3.0
    tree = {"a": torch.arange(3), "norm": ats.obs_norm, "n": 3, "l": [torch.ones(2), "x"]}
    tckpt.save(str(tmp_path / "sub" / "tree"), tree)
    back = tckpt.restore(str(tmp_path / "sub" / "tree"), "cpu")
    assert torch.equal(back["a"], tree["a"]) and back["n"] == 3 and back["l"][1] == "x"
    _close(back["norm"]["var"], ats.obs_norm.var)
