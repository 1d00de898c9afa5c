"""The port's PPO trainer on the CPU against the JAX package: GAE and the
loss (value 1e-5, gradient 1e-4 of its largest entry) on one JAX-made batch
in every configuration of the loss's terms, minibatch updates against optax
(clip by global norm, then Adam), the `kl_stop` freeze as a masked update,
warm start, and whole train_steps on the port alone (which statistics
normalise what, what changes, what stays).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quadruped_springs_tpu.train import ppo as jppo
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.env import env as tenv
from quadruped_springs_tpu_torch.env.continuous_autopilot import ContinuousAutopilotEnv
from quadruped_springs_tpu_torch.train import normalize as tnorm
from quadruped_springs_tpu_torch.train import ppo as tppo
from tests.conftest import env_factory

BASE = dict(enable_springs=True, motor_control_mode="PD", action_space_mode="SYMMETRIC",
            task_env="JUMPING_IN_PLACE_PPO", observation_space_mode="ARS_BASIC",
            obs_noise=False, settling_steps=20, max_ep_len=0.06)
_jax_env = env_factory(**BASE)
HIDDEN = (8, 8)


def _port_env(**kw):
    return tenv.QuadrupedEnv(tenv.EnvConfig(**dict(BASE, **kw)), device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, err_msg="", **tol):
    got = got.detach() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=err_msg, **tol)


def _trainers(**cfg):
    """A JAX and a port trainer of one configuration (no rollout is made:
    the JAX env is only asked its dimensions), random parameters on both."""
    cfg = dict(hidden=HIDDEN, **cfg)
    jtr = jppo.PPOTrainer(_jax_env(), jppo.PPOConfig(**cfg))
    ttr = tppo.PPOTrainer(_port_env(), tppo.PPOConfig(**cfg))
    params = jtr.net.init(jax.random.PRNGKey(0), jnp.zeros(jtr.env.obs_dim))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: x + 0.2 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32), params)
    return jtr, ttr, params, convert.mlp_policy(jax.tree.map(np.asarray, params), "cpu")


def _batch(n, obs_dim, seed=1, masked=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"obs_n": f(n, obs_dim), "action": 0.5 * f(n, 6), "logp": -4.0 + f(n),
            "adv": f(n), "ret": f(n),
            "pg_mask": rng.random(n) < 0.6 if masked else np.ones(n, bool)}


def _grads_by_name(jgrads):
    return {k: _t(v) for k, v in convert.mlp_policy_params(
        jax.tree.map(np.asarray, jgrads)).items()}


def test_gae_matches_jax():
    jtr, ttr, _, _ = _trainers(gamma=0.9, gae_lambda=0.8)
    rng = np.random.default_rng(2)
    T, n = 7, 3
    traj = {"reward": rng.standard_normal((T, n)).astype(np.float32),
            "value": rng.standard_normal((T, n)).astype(np.float32),
            "done": rng.random((T, n)) < 0.3}
    last = rng.standard_normal(n).astype(np.float32)
    jadv, jret = jtr._gae({k: jnp.asarray(v) for k, v in traj.items()}, jnp.asarray(last))
    tadv, tret = ttr._gae({k: _t(v) for k, v in traj.items()}, _t(last))
    _close(tadv, jadv, rtol=1e-5, atol=1e-5)
    _close(tret, jret, rtol=1e-5, atol=1e-5)


LOSS_CASES = {
    "plain": (dict(), False),
    "masked_entropy": (dict(ent_coef=0.01, clip_eps=0.1), True),
    "all_masked_out": (dict(), None),
    "freeze_actor": (dict(freeze_actor=True, ent_coef=0.01), True),
    "anchor": (dict(anchor_coef=2.0), True),
    "bc": (dict(bc_coef=300.0, vf_coef=0.25), True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_gradient_match_jax(case):
    """The loss, each reported term and the gradient by parameter. The
    advantage normalisation, KL and surrogate are masked means with a floor
    of 1 on the mask's sum ("all_masked_out": every term of the policy
    gradient is 0 and the value loss remains)."""
    cfg, masked = LOSS_CASES[case]
    jtr, ttr, params, net = _trainers(**cfg)
    batch = _batch(24, jtr.env.obs_dim, masked=bool(masked))
    if masked is None:
        batch["pg_mask"][:] = False
    rng = np.random.default_rng(3)
    if "anchor_coef" in cfg:
        anchor = jax.tree.map(
            lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32), params)
        jtr.set_anchor(anchor)
        ttr.set_anchor(convert.mlp_policy(jax.tree.map(np.asarray, anchor), "cpu"))
    if "bc_coef" in cfg:
        bo = rng.standard_normal((10, jtr.env.obs_dim)).astype(np.float32)
        ba = rng.uniform(-1, 1, (10, 6)).astype(np.float32)
        jtr.set_bc_anchor(bo, ba)
        ttr.set_bc_anchor(bo, ba)
    (jloss, jaux), jgrads = jax.value_and_grad(jtr._loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, taux = ttr._loss(net, {k: _t(v) for k, v in batch.items()})
    tloss.backward()
    _close(tloss, jloss, rtol=1e-5, atol=1e-5)
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k], jaux[k], k, rtol=1e-5, atol=1e-5)
    want = _grads_by_name(jgrads["params"])
    scale = max(float(g.abs().max()) for g in want.values())
    for name, p in net.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        _close(got, want[name], name, rtol=0, atol=1e-4 * scale)
    actor = [n for n, p in net.named_parameters() if not n.startswith("vf_")]
    if case in ("all_masked_out", "freeze_actor"):
        assert all(float(want[n].abs().max()) == 0.0 for n in actor)
    else:
        assert all(float(want[n].abs().max()) > 0.0 for n in actor)
    if "anchor_coef" in cfg:
        assert float(taux["anchor_mse"].detach()) > 0 and not any(
            p.requires_grad for p in ttr.anchor_net.parameters())
    if "bc_coef" in cfg:
        assert float(taux["bc_mse"].detach()) > 0


def _optax_updates(jtr, params, batches, kl_stop=0.0):
    """The minibatch loop of jppo.PPOTrainer.train_step on given minibatches."""
    opt_state = jtr.tx.init(params)
    halted, auxs = jnp.asarray(False), []
    for b in batches:
        (_, aux), grads = jax.value_and_grad(jtr._loss, has_aux=True)(
            params, {k: jnp.asarray(v) for k, v in b.items()})
        updates, opt_state2 = jtr.tx.update(grads, opt_state, params)
        params2 = optax.apply_updates(params, updates)
        if kl_stop > 0.0:
            halted = halted | (aux["kl_est"] > kl_stop)
            keep = lambda new, old: jax.tree.map(lambda a, b: jnp.where(halted, b, a), new, old)
            params2, opt_state2 = keep(params2, params), keep(opt_state2, opt_state)
        params, opt_state = params2, opt_state2
        auxs.append(aux)
    return params, opt_state, auxs


def _port_state(ttr, net):
    return tppo.PPOState(net=net, optimizer=ttr._optimizer(net), obs_norm=None,
                         env_states=None, obs=None, bank=None, generator=None, iteration=0)


def _same_params(net, jparams, tol):
    want = convert.mlp_policy_params(jax.tree.map(np.asarray, jparams))
    for name, p in net.named_parameters():
        _close(p, want[name], name, rtol=0, atol=tol)


def test_minibatch_updates_match_optax():
    """Three clipped Adam steps (lr 3e-3, max_grad_norm 0.5; the gradient's
    norm is ~10, so every step is clipped) against optax's
    clip_by_global_norm + adam: parameters to 2e-6 after steps of 3e-3.
    What remains: clip_grad_norm_ scales by max_norm / (norm + 1e-6), optax
    by max_norm / norm (a relative 1e-7 here), and the rounding of Adam's
    bias correction."""
    cfg = dict(lr=3e-3, max_grad_norm=0.5)
    jtr, ttr, params, net = _trainers(**cfg)
    batches = [_batch(16, jtr.env.obs_dim, seed=s) for s in (4, 5, 6)]
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    jparams, _, _ = _optax_updates(jtr, params, batches)
    ts = _port_state(ttr, net)
    halted = torch.zeros((), dtype=torch.bool)
    for b in batches:
        halted, loss, aux = ttr._minibatch_update(ts, {k: _t(v) for k, v in b.items()}, halted)
    assert not bool(halted) and bool(torch.isfinite(loss))
    _same_params(net, jparams, tol=2e-6)
    moved = max(float((p.detach() - before[n]).abs().max()) for n, p in net.named_parameters())
    assert moved > 5e-3


def test_kl_stop_freezes_parameters_and_optimizer_state_as_jax_does():
    """With kl_stop between the KL estimates of the minibatches, the update
    that first exceeds it and every later one are undone: parameters, Adam's
    moments and its step count stay at the last accepted update's, as the
    masked select of the JAX train_step keeps them."""
    cfg = dict(lr=3e-3, kl_stop=1e-9)
    jtr, ttr, params, net = _trainers(**cfg)
    b0 = _batch(16, jtr.env.obs_dim, seed=7)
    # the first minibatch's stored logp is the current policy's: its KL is 0
    mean, log_std, _ = jtr.net.apply(params, jnp.asarray(b0["obs_n"]))
    b0["logp"] = np.asarray(jppo.gaussian_logp(jnp.asarray(b0["action"]), mean, log_std))
    batches = [b0, _batch(16, jtr.env.obs_dim, seed=8), dict(b0)]
    jparams, jopt, jaux = _optax_updates(jtr, params, batches, kl_stop=1e-9)
    assert float(jaux[0]["kl_est"]) <= 1e-9 < float(jaux[1]["kl_est"])
    ts = _port_state(ttr, net)
    halted, seen = torch.zeros((), dtype=torch.bool), []
    for b in batches:
        halted, _, aux = ttr._minibatch_update(ts, {k: _t(v) for k, v in b.items()}, halted)
        seen.append(bool(halted))
    assert seen == [False, True, True]
    _same_params(net, jparams, tol=2e-6)
    adam = jopt[1][0]
    assert int(adam.count) == 1
    steps = {float(s["step"]) for s in ts.optimizer.state.values()}
    assert steps == {1.0}
    want_mu = convert.mlp_policy_params(jax.tree.map(np.asarray, adam.mu))
    for name, p in net.named_parameters():
        _close(ts.optimizer.state[p]["exp_avg"], want_mu[name], name, rtol=0, atol=1e-6)


def test_warm_start_copies_the_actor_and_restarts_the_critic():
    _, ttr, _, src = _trainers()
    ts = _port_state(ttr, ttr.make_net(0))
    norm = tnorm.update(tnorm.RunningNorm.create(ttr.env.obs_dim, "cpu"),
                        torch.randn(5, ttr.env.obs_dim))
    warm = ttr.warm_start(ts, src, norm, seed=3, log_std=-1.0)
    fresh = ttr.make_net(3).state_dict()
    for k, v in warm.net.state_dict().items():
        if k == "log_std":
            _close(v, np.full(6, -1.0, np.float32))
        elif k.startswith("vf_"):
            assert torch.equal(v, fresh[k]) and not torch.equal(v, src.state_dict()[k])
        else:
            assert torch.equal(v, src.state_dict()[k])
    assert warm.obs_norm is norm and warm.optimizer is not ts.optimizer
    assert not warm.optimizer.state
    kept = ttr.warm_start(ts, src, norm, reset_value=False)
    assert all(torch.equal(v, src.state_dict()[k]) for k, v in kept.net.state_dict().items())


def test_train_step_on_the_port():
    """Two train_steps at a tiny width: the metrics' names are JAX's and
    finite; every parameter moves; the rollout and the batch are normalised
    with the statistics of before the step, which then take the segment's
    observations; the lanes and the iteration advance; frozen statistics
    stay; an autopilot adapter's pg_mask reaches the loss."""
    env = _port_env(obs_noise=True)
    cfg = tppo.PPOConfig(n_envs=3, segment_len=8, reset_bank_size=2, hidden=HIDDEN,
                         n_epochs=2, n_minibatches=2, noise_rho=0.5)
    tr = tppo.PPOTrainer(env, cfg)
    gen = torch.Generator().manual_seed(0)
    ts = tr.init(gen)
    assert ts.obs.shape == (3, env.obs_dim) and ts.bank[1].shape == (2, env.obs_dim)
    before = {n: p.detach().clone() for n, p in ts.net.named_parameters()}
    seen = []
    loss = tr._loss
    tr._loss = lambda net, b: (seen.append(b), loss(net, b))[1]
    ts1, m = tr.train_step(ts)
    assert set(m) == {"loss", "anchor_mse", "bc_mse", "pg_loss", "vf_loss", "approx_kl",
                      "kl_est", "mean_reward", "episode_rate"}
    assert all(bool(torch.isfinite(v)) and v.dim() == 0 for v in m.values())
    assert len(seen) == 4 and all(b["obs_n"].shape == (12, env.obs_dim) for b in seen)
    # identity statistics at the first step: the batch holds raw observations
    # (clipped at 10), though the returned statistics have moved
    assert float(ts1.obs_norm.count) == pytest.approx(24, abs=1e-3)
    assert float(ts.obs_norm.count) == pytest.approx(1e-4)
    assert float(torch.cat([b["obs_n"] for b in seen]).abs().max()) == 10.0
    assert float(m["episode_rate"]) == pytest.approx(3 / 24)
    for n, p in ts1.net.named_parameters():
        assert not torch.equal(p, before[n]), n
    assert ts1.iteration == 1 and ts1.net is ts.net
    assert int(ts1.env_states.sim_step_counter.max()) <= 60
    ts2, _ = tr.train_step(ts1)
    assert float(ts2.obs_norm.count) == pytest.approx(48, abs=1e-3)
    ev = tr.evaluate(ts2, n_episodes=2, max_steps=3)
    assert all(bool(torch.isfinite(v)) for v in ev.values())

    frozen = tppo.PPOTrainer(env, dataclasses.replace(cfg, freeze_obs_norm=True, kl_stop=0.05))
    fs = frozen.init(gen)
    fs1, _ = frozen.train_step(fs)
    assert fs1.obs_norm is fs.obs_norm

    ap = tppo.PPOTrainer(ContinuousAutopilotEnv(env), cfg)
    ps = ap.init(gen)
    ps = dataclasses.replace(ps, env_states=dataclasses.replace(
        ps.env_states, phase=torch.tensor([0, 1, 0], dtype=torch.int32),
        deadline=torch.tensor([0.0, 0.025, 0.0])))
    masks = []
    ap._loss = lambda net, b: (masks.append(b["pg_mask"]), loss(net, b))[1]
    ap.train_step(ps)
    # lane 1 holds its take-off action for its first 3 steps (then lands)
    assert 2 * (24 - 8) <= int(torch.cat(masks).sum()) <= 2 * (24 - 3)


def test_train_step_takes_injected_draws():
    """Given the noise, the reset indices and the permutations, two trainers
    from equal networks take the same step whatever their generators hold."""
    env = _port_env()
    cfg = tppo.PPOConfig(n_envs=2, segment_len=4, reset_bank_size=2, hidden=HIDDEN,
                         n_epochs=1, n_minibatches=2)
    tr = tppo.PPOTrainer(env, cfg)
    a = tr.init(torch.Generator().manual_seed(1))
    b = dataclasses.replace(a, net=tr.make_net(9), generator=torch.Generator().manual_seed(5))
    b.net.load_state_dict(a.net.state_dict())
    b = dataclasses.replace(b, optimizer=tr._optimizer(b.net))
    rng = np.random.default_rng(0)
    draws = dict(noise=_t(rng.standard_normal((4, 2, 6)).astype(np.float32)),
                 reset_idx=_t(rng.integers(0, 2, (4, 2))),
                 perms=_t(np.stack([rng.permutation(8)])))
    a1, ma = tr.train_step(a, **draws)
    b1, mb = tr.train_step(b, **draws)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for (n, p), q in zip(a1.net.named_parameters(), b1.net.parameters()):
        assert torch.equal(p, q), n
