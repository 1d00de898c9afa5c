"""The chain of the two-stage trainers' stages (train/two_stage.py) on the CPU
against the JAX package's building blocks, in the JAX script's order
(examples/train_two_stage.py) with JAX's draws injected, at tiny budgets:
one ARS step of the jump stage, two committed demos cut to a few rows, the
BC dataset (each demo's reset from its own seed, 21 + i) and its
concatenation order, bc.fit at 50 iterations from JAX's initialisation
(seed 22), the polish's anchor rows for each task, one critic warm-up step
and one BC-anchored polish step (bc_coef 300) from JAX's polish state; then
the fine-tune's state (a fresh critic on the warm start's actor), one critic
warm-up step at its own lr and one fine-tune step on the dense task through
RestTruncationWrapper, and the fine-tune's probe schedule and kept iterate.
Tolerances are stated at each comparison.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env.env import EnvConfig as JEnvConfig
from quadruped_springs_tpu.env.env import QuadrupedEnv as JEnv
from quadruped_springs_tpu.env.wrappers import RestTruncationWrapper as JRest
from quadruped_springs_tpu.train import ars as jars
from quadruped_springs_tpu.train import bc as jbc
from quadruped_springs_tpu.train import normalize as jnorm
from quadruped_springs_tpu.train import ppo as jppo
from quadruped_springs_tpu.train import rollout as jro
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.env import env as tenv
from quadruped_springs_tpu_torch.env.wrappers import RestTruncationWrapper as TRest
from quadruped_springs_tpu_torch.runtime import trajstore
from quadruped_springs_tpu_torch.train import ars as tars
from quadruped_springs_tpu_torch.train import ppo as tppo
from quadruped_springs_tpu_torch.train import rollout as tro
from quadruped_springs_tpu_torch.train import two_stage as st
from tests.conftest import env_factory

BASE = dict(enable_springs=True, motor_control_mode="PD", action_space_mode="SYMMETRIC",
            observation_space_mode="ARS_BASIC", settling_steps=50)
JUMP = dict(BASE, task_env="JUMPING_IN_PLACE", obs_noise=False, max_ep_len=0.06)
DEMO = dict(BASE, task_env="JUMPING_IN_PLACE_DEMO", obs_noise=False, max_ep_len=2.5,
            demo_norm="full")
DENSE = dict(BASE, task_env="JUMPING_IN_PLACE_PPO", obs_noise=False, max_ep_len=2.0)
ROWS = 8
ARS = dict(n_directions=4, top_directions=2, episode_steps=7, reset_bank_size=2,
           step_size=0.02, delta_std=0.3)
SMALL_PPO = dict(n_envs=2, segment_len=4, reset_bank_size=2, n_epochs=1, n_minibatches=2)
PPO = dict(SMALL_PPO, gamma=0.3, gae_lambda=0.9, lr=3e-4, kl_stop=0.03, freeze_obs_norm=True,
           noise_rho=0.0, bc_coef=300.0)
# the JAX script's fine-tune config (examples/train_two_stage.py:436-438), cut
FINETUNE = dict(SMALL_PPO, lr=1e-4, kl_stop=0.02, ent_coef=0.0, freeze_obs_norm=True,
                noise_rho=0.9)
_jax_jump = env_factory(**JUMP)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, err_msg="", **tol):
    got = got.detach() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=err_msg, **tol)


def _demos():
    return [trajstore.read(f"examples/out/demo_jip_{i}.qsts")[:ROWS] for i in range(2)]


def _params_close(net, jparams, before, atol):
    """Every parameter within atol of JAX's, after a step that moved some
    parameter (from `before`, the port's network's state before it)."""
    want = convert.mlp_policy_params(jax.tree.map(np.asarray, jparams))
    assert max(float((want[k] - before[k]).abs().max()) for k in want) > 1e-4
    for name, p in net.named_parameters():
        _close(p, want[name], name, rtol=0, atol=atol)


def jax_ppo_draws(key, cfg, n_bank, action_dim):
    """The draws of jppo.PPOTrainer.train_step from state key `key`: (next
    key, the port's train_step keywords)."""
    key, k_roll, k_perm = jax.random.split(key, 3)
    noise, idx = [], []
    for k_t in jax.random.split(k_roll, cfg.segment_len):
        k_act, k_reset = jax.random.split(k_t)
        noise.append(np.asarray(jax.random.normal(k_act, (cfg.n_envs, action_dim))))
        idx.append([int(jax.random.randint(k, (), 0, n_bank))
                    for k in jax.random.split(k_reset, cfg.n_envs)])
    n = cfg.n_envs * cfg.segment_len
    perms = [np.asarray(jax.random.permutation(k, n))
             for k in jax.random.split(k_perm, cfg.n_epochs)]
    return key, {"noise": _t(np.stack(noise)), "reset_idx": _t(np.array(idx)),
                 "perms": _t(np.stack(perms))}


def test_ars_jump_stage_takes_jax_draws():
    """One iteration of ars_jump_stage with the deltas and bank JAX's
    train_step draws: the kept W within 1e-4 of the update's largest entry
    (tests/test_torch_train.py's tolerance), the curve's training return to
    1e-5; the stage's record and flags."""
    jenv = _jax_jump()
    tenv_ = tenv.QuadrupedEnv(tenv.EnvConfig(**JUMP), device="cpu")
    jtr, ttr = jars.ARSTrainer(jenv, jars.ARSConfig(**ARS)), tars.ARSTrainer(
        tenv_, tars.ARSConfig(**ARS))
    jts = jtr.init(jax.random.PRNGKey(0))
    W0 = (0.02 * np.random.default_rng(5).standard_normal(jts.W.shape)).astype(np.float32)
    jts = jts.replace(W=jnp.asarray(W0))
    _, k_delta, k_bank = jax.random.split(jts.key, 3)
    deltas = jax.random.normal(k_delta, (4,) + jts.W.shape) * 0.3
    jbank = jro.make_reset_bank(jenv, k_bank, 2, curriculum_level=jts.curriculum_level)
    jts2, jm = jtr.train_step(jts)
    tts = dataclasses.replace(ttr.init(torch.Generator().manual_seed(0)), W=_t(W0))
    eval_bank = tro.make_reset_bank(tenv_, torch.Generator().manual_seed(1), 4)
    W, on, entries = st.ars_jump_stage(
        ttr, tts, 1, 0.75, draws=[(_t(deltas), (convert.env_state(jbank[0]), _t(jbank[1])),
                                   eval_bank)])
    dW = np.asarray(jts2.W) - W0
    assert np.abs(dW).max() > 1e-3
    _close(W.numpy() - W0, dW, rtol=0, atol=1e-4 * np.abs(dW).max())
    _close(on.count, jts2.obs_norm.count, rtol=0, atol=1e-3)
    (rec,) = entries["ars_curve"]
    _close(rec["mean_return"], jm["mean_return"], rtol=0, atol=1e-5)
    assert entries["ars_improved"] is False      # one record: not above itself
    assert entries["ars_jump_best_apex_m"] == rec["eval_max_height"]


@pytest.fixture(scope="module")
def chain():
    """The JAX script's stage 3 on JAX's building blocks and the port's stage
    functions, side by side: the BC dataset, the fit, the polish state."""
    demos = _demos()
    jenv = JEnv(JEnvConfig(**DEMO), demo_actions=jnp.asarray(demos[0][:, :6]))
    tenv_ = tenv.QuadrupedEnv(tenv.EnvConfig(**DEMO), demo_actions=_t(demos[0][:, :6]),
                              device="cpu")
    jobs, jacts = [], []
    for i, d in enumerate(demos):
        o, a = jbc.demo_dataset(jenv, jnp.asarray(d), jax.random.PRNGKey(21 + i))
        jobs.append(np.asarray(o))
        jacts.append(np.asarray(a))
    tobs, tacts = st.bc_dataset(tenv_, [_t(d) for d in demos])
    jcfg = jppo.PPOConfig(**PPO)
    jtr = jppo.PPOTrainer(jenv, jcfg, demo=jnp.asarray(demos[0]))
    jparams, jon, jmse = jbc.fit(jtr.net, jnp.concatenate(jobs), jnp.concatenate(jacts),
                                 jax.random.PRNGKey(22), iters=50, log_std=-2.0)
    return dict(demos=demos, jenv=jenv, tenv=tenv_, jobs=jobs, jacts=jacts, tobs=tobs,
                tacts=tacts, jtr=jtr, jcfg=jcfg, jparams=jparams, jon=jon, jmse=jmse)


def test_bc_dataset_keeps_the_demo_order(chain):
    """Demo i's block is its own rows (its action rows exactly), in demo order;
    the observations of rows 1.. to 1e-5 and of the reset row to 5e-2 (the
    port's reset draws its own friction: tests/test_torch_pipeline.py)."""
    assert [o.shape[0] for o in chain["tobs"]] == [ROWS, ROWS]
    for d, to, ta, jo, ja in zip(chain["demos"], chain["tobs"], chain["tacts"], chain["jobs"],
                                 chain["jacts"]):
        _close(ta, ja, rtol=0, atol=0)
        _close(ta, d[:, :6], rtol=0, atol=0)
        _close(to[1:], jo[1:], rtol=0, atol=1e-5)
        _close(to[0], jo[0], rtol=0, atol=5e-2)
    cat = torch.cat(chain["tacts"])
    _close(cat[:ROWS], chain["demos"][0][:, :6], rtol=0, atol=0)
    _close(cat[ROWS:], chain["demos"][1][:, :6], rtol=0, atol=0)


def test_bc_stage_matches_jax_fit(chain, monkeypatch):
    """bc_stage from JAX's initialisation (seed 22) on JAX's dataset: after 50
    full-batch Adam steps at lr 1e-3 every parameter within 1e-5, a hundredth
    of one step (Adam divides each gradient entry by its own scale, so an
    entry whose gradient sits near 0 carries the float32 rounding of the
    sums into its steps), the statistics and the loss to 1e-6, log_std -2."""
    jobs = jnp.concatenate(chain["jobs"])
    on = jnorm.update(jnorm.RunningNorm.create(jobs.shape[1]), jobs)
    init = chain["jtr"].net.init(jax.random.PRNGKey(22), jnorm.normalize(on, jobs)[0])
    net = convert.mlp_policy(jax.tree.map(np.asarray, init), "cpu")
    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    monkeypatch.setattr(st, "BC_ITERS", 50)
    net, norm, entries = st.bc_stage(net, [_t(o) for o in chain["jobs"]],
                                     [_t(a) for a in chain["jacts"]])
    want = convert.mlp_policy_params(jax.tree.map(np.asarray, chain["jparams"]))
    moved = max(float(np.abs(want[k].numpy() - before[k].numpy()).max()) for k in want
                if k.startswith("pi_"))
    assert moved > 10 * 1e-3
    for name, p in net.named_parameters():
        _close(p, want[name], name, rtol=0, atol=1e-5)
    for f in ("mean", "var", "count"):
        _close(getattr(norm, f), getattr(chain["jon"], f), f, rtol=1e-6, atol=1e-6)
    _close(entries["bc_mse"], chain["jmse"], rtol=1e-6, atol=1e-6)
    assert float(net.log_std[0]) == -2.0


@pytest.mark.parametrize("task", ["in_place", "forward", "backflip"])
def test_bc_anchor_rows_follow_the_scripts(task, chain):
    """In place all demos' rows (the script's bc_obs, bc_acts); forward and
    the flip demo 0's rows."""
    obs, acts = st.bc_anchor(task, chain["tobs"], chain["tacts"])
    n = 2 * ROWS if task == "in_place" else ROWS
    want_o = np.concatenate(chain["jobs"])[:n]
    want_a = np.concatenate(chain["jacts"])[:n]
    assert obs.shape[0] == acts.shape[0] == n
    _close(acts, want_a, rtol=0, atol=0)
    _close(obs[1:ROWS], want_o[1:ROWS], rtol=0, atol=1e-5)


def _jax_segment(jtr, jps):
    """The segment jtr.train_step(jps) rolls: its rollout with the key it
    splits off, as (states, obs, traj) of the port's types."""
    _, k_roll, _ = jax.random.split(jps.key, 3)
    states, obs, traj = jax.jit(lambda ps: jro.segment_rollout(
        jtr.env, jtr._action_fn(ps.params, ps.obs_norm), ps.env_states, ps.obs, ps.bank,
        k_roll, jtr.config.segment_len))(jps)
    return convert.env_state(states), _t(obs), {k: _t(v) for k, v in traj.items()}


def test_polish_warmup_and_step_match_jax(chain, monkeypatch):
    """The polish from JAX's state (its RSI bank and lanes from PRNGKey(1),
    BC's parameters and statistics, the in-place anchor of all rows): one
    critic warm-up step (the actor frozen, the BC anchor live) and one
    polish step through polish_stage, each with the draws JAX's train_step
    takes from its key. The port's own segment with those draws against
    JAX's: done flags exact, observations and actions within 1e-2 and
    rewards within 1e-3 over the 4 steps (the stiff simulator parts the two
    by ~2e-3 a control step: tests/test_torch_train.py). Then each step's
    update on JAX's segment (the rollout replaced by it): every parameter
    within 2e-6 of JAX's after steps of lr 3e-4 (tests/test_torch_ppo.py's
    bound), the warm-up's actor moved by the BC anchor alone."""
    jtr, jcfg, jenv = chain["jtr"], chain["jcfg"], chain["jenv"]
    jwarm = jppo.PPOTrainer(jenv, dataclasses.replace(jcfg, freeze_actor=True),
                            demo=jtr.demo)
    bc_obs, bc_acts = jnp.concatenate(chain["jobs"]), jnp.concatenate(chain["jacts"])
    for tr in (jtr, jwarm):
        tr.set_bc_anchor(jnorm.normalize(chain["jon"], bc_obs), bc_acts)
    jps = jtr.init(jax.random.PRNGKey(1))
    jps = jps.replace(params=chain["jparams"], obs_norm=chain["jon"],
                      opt_state=jtr.tx.init(chain["jparams"]))

    tenv_ = chain["tenv"]
    tcfg = tppo.PPOConfig(**PPO)
    ttr = tppo.PPOTrainer(tenv_, tcfg, demo=_t(chain["demos"][0]))
    twarm = tppo.PPOTrainer(tenv_, dataclasses.replace(tcfg, freeze_actor=True),
                            demo=_t(chain["demos"][0]))
    net = convert.mlp_policy(jax.tree.map(np.asarray, chain["jparams"]), "cpu")
    norm = convert.running_norm(chain["jon"])
    anchor = st.bc_anchor("in_place", [_t(o) for o in chain["jobs"]],
                          [_t(a) for a in chain["jacts"]])
    ps = st.polish_init(ttr, twarm, torch.Generator().manual_seed(1), net, norm, anchor)
    assert ps.net is not net and ps.obs_norm is norm
    _close(ttr.bc_anchor[0], jtr.bc_anchor[0], rtol=0, atol=1e-6)
    # JAX's polish state: its bank and lanes
    bank = (convert.env_state(jps.bank[0]), _t(jps.bank[1]))
    ps = dataclasses.replace(ps, bank=bank, env_states=convert.env_state(jps.env_states),
                             obs=_t(jps.obs))
    monkeypatch.setattr(st, "PROBE_STEPS", 3)
    probe = st.EpisodeProbe(tenv_, tro.make_reset_bank(
        tenv_, torch.Generator().manual_seed(5), 2), 5)
    score = st.jump_polish_score(probe, probe)
    rollout = tro.segment_rollout

    def step(jtrainer, jps, stage):
        """One train_step of each package; returns JAX's new state and the
        port's stage entries."""
        key, draws = jax_ppo_draws(jps.key, jcfg, 2, 6)
        seg = _jax_segment(jtrainer, jps)
        jps1, jm = jtrainer.train_step(jps)
        assert bool(jnp.all(jps1.key == key))
        trainer = twarm if stage == "warmup" else ttr
        own = rollout(tenv_, trainer._action_fn(ps.net, ps.obs_norm), ps.env_states, ps.obs,
                      ps.bank, None, jcfg.segment_len, noise=draws["noise"],
                      reset_idx=draws["reset_idx"])[2]
        np.testing.assert_array_equal(own["done"], seg[2]["done"])
        for k, tol in (("obs", 1e-2), ("action", 1e-2), ("reward", 1e-3)):
            _close(own[k], seg[2][k], k, rtol=0, atol=tol)
        monkeypatch.setattr(tppo.ro, "segment_rollout", lambda *a, **k: seg)
        return jps1, jm, draws

    before = {k: v.detach().clone() for k, v in ps.net.state_dict().items()}
    jps1, _, draws = step(jwarm, jps, "warmup")
    ps, entries = st.polish_stage(ttr, twarm, ps, 1, 0, score, draws={"warmup": [draws]})
    monkeypatch.setattr(tppo.ro, "segment_rollout", rollout)
    assert entries["ppo_imitate_curve"] == []
    _params_close(ps.net, jps1.params, before, 2e-6)
    assert not torch.equal(ps.net.pi_0.weight, before["pi_0.weight"])

    before = {k: v.detach().clone() for k, v in ps.net.state_dict().items()}
    jps2, jm, draws = step(jtr, jps1, "polish")
    ps, entries = st.polish_stage(ttr, twarm, ps, 0, 1, score, draws={"polish": [draws]})
    _params_close(ps.net, jps2.params, before, 2e-6)
    (rec,) = entries["ppo_imitate_curve"]
    _close(rec["bc_mse"], jm["bc_mse"], rtol=1e-5, atol=0)
    _close(rec["mean_reward"], jm["mean_reward"], rtol=1e-6, atol=0)


def _no_probe(policy):
    raise AssertionError("the fine-tune probes every 5th iteration only")


def test_finetune_warmup_and_step_match_jax(monkeypatch):
    """The fine-tune from JAX's state: finetune_init on the port's trainer of
    st.FINETUNE_PPO (the JAX script's ft_cfg, cut) keeps the warm start's
    actor and statistics under a fresh critic; with JAX's fresh critic
    (warm_start from PRNGKey(3)) and its lanes loaded, one critic warm-up
    step (its trainer at st.CRITIC_WARMUP_LR, the actor frozen) and one
    fine-tune step at lr 1e-4 through finetune_stage, on the dense task
    through RestTruncationWrapper, each with the draws JAX's train_step
    takes from its key and JAX's segment in place of the rollout: every
    parameter within 2e-6 of JAX's after each step (tests/test_torch_ppo.py's
    bound), the warm-up's actor unmoved. The two steps share one Adam state
    at two step sizes, as optax's transforms share the JAX package's
    opt_state: the fine-tune's first Adam step is the state's third, with
    the actor's moments still 0, where an entry whose gradient lies below
    Adam's eps (1e-8) moves in proportion to it, so the float32 rounding
    that leaves such a gradient (a cancelled sum) decides a fraction of a
    step. The actor's entries with a gradient below 1e-7 in some minibatch
    of the fine-tune step (measured: 134 of its 6,348, the farthest, one
    tanh unit's input at a gradient of 2.5e-9, off JAX's by 9.6e-6) are
    held within one step, lr, and to be under 5% of the actor; every other
    entry, the critic's all, within 2e-6."""
    tcfg = dataclasses.replace(st.FINETUNE_PPO, **SMALL_PPO)
    jcfg = jppo.PPOConfig(**FINETUNE)
    assert {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(jcfg)} == \
        dataclasses.asdict(jcfg)
    assert st.CRITIC_WARMUP_LR == 3e-4
    jenv = JRest(JEnv(JEnvConfig(**DENSE)))
    jft = jppo.PPOTrainer(jenv, jcfg)
    jwarm = jppo.PPOTrainer(jenv, dataclasses.replace(jcfg, lr=3e-4, freeze_actor=True))
    obs_dim = jenv.obs_dim
    src = jft.net.init(jax.random.PRNGKey(22), jnp.zeros(obs_dim))
    jon = jnorm.update(jnorm.RunningNorm.create(obs_dim), jnp.asarray(
        np.random.default_rng(3).standard_normal((16, obs_dim)), jnp.float32))
    jfs = jft.warm_start(jft.init(jax.random.PRNGKey(2)), src, jon, jax.random.PRNGKey(3),
                         reset_value=True)

    tenv_ = TRest(tenv.QuadrupedEnv(tenv.EnvConfig(**DENSE), device="cpu"))
    ttr = tppo.PPOTrainer(tenv_, tcfg)
    twarm = tppo.PPOTrainer(tenv_, dataclasses.replace(tcfg, lr=st.CRITIC_WARMUP_LR,
                                                       freeze_actor=True))
    src_net = convert.mlp_policy(jax.tree.map(np.asarray, src), "cpu")
    norm = convert.running_norm(jon)
    fs = st.finetune_init(ttr, torch.Generator().manual_seed(2), src_net, norm)
    assert fs.net is not src_net and fs.obs_norm is norm
    for (k, v), w in zip(fs.net.state_dict().items(), src_net.state_dict().values()):
        if not k.startswith("vf_"):
            assert torch.equal(v, w), k
        elif k.endswith("weight"):          # a fresh critic (its biases start at 0)
            assert not torch.equal(v, w), k
    # JAX's fresh critic and lanes
    fs.net.load_state_dict(convert.mlp_policy_params(jax.tree.map(np.asarray, jfs.params)))
    fs = dataclasses.replace(fs, bank=(convert.env_state(jfs.bank[0]), _t(jfs.bank[1])),
                             env_states=convert.env_state(jfs.env_states), obs=_t(jfs.obs))

    jdraws, segs, jstates = [], [], [jfs]
    for jtrainer in (jwarm, jft):
        _, draws = jax_ppo_draws(jstates[-1].key, jcfg, 2, 6)
        jdraws.append(draws)
        segs.append(_jax_segment(jtrainer, jstates[-1]))
        jstates.append(jtrainer.train_step(jstates[-1])[0])
    net = fs.net                   # the trainers update it in place
    initial, warmed, calls = {k: v.detach().clone() for k, v in net.state_dict().items()}, {}, []

    def rollout(*a, **k):
        """JAX's segments in turn; the network as the fine-tune step finds it."""
        if calls:
            warmed.update({k: v.detach().clone() for k, v in net.state_dict().items()})
        calls.append(1)
        return segs[len(calls) - 1]

    monkeypatch.setattr(tppo.ro, "segment_rollout", rollout)
    grads, update = [], ttr._minibatch_update

    def recorded(ts, sl, halted):
        """The fine-tune's minibatch updates, each one's clipped gradient kept."""
        out = update(ts, sl, halted)
        grads.append({n: p.grad.detach().clone() for n, p in ts.net.named_parameters()})
        return out

    monkeypatch.setattr(ttr, "_minibatch_update", recorded)
    fs, best_net, best_probe, entries = st.finetune_stage(
        ttr, twarm, fs, 1, 1, _no_probe, draws={"warmup": [jdraws[0]], "finetune": [jdraws[1]]})
    assert len(calls) == 2
    want = convert.mlp_policy_params(jax.tree.map(np.asarray, jstates[1].params))
    assert max(float((want[k] - initial[k]).abs().max()) for k in want) > 1e-4
    for name, p in warmed.items():
        _close(p, want[name], name, rtol=0, atol=2e-6)
        if not name.startswith("vf_"):
            assert torch.equal(p, initial[name]), name
    assert len(grads) == SMALL_PPO["n_minibatches"]
    want = convert.mlp_policy_params(jax.tree.map(np.asarray, jstates[2].params))
    assert max(float((want[k] - warmed[k]).abs().max()) for k in want) > 1e-5
    n_tiny = n_actor = 0
    for name, p in fs.net.named_parameters():
        tiny = torch.stack([g[name].abs() for g in grads]).amin(0) < 1e-7
        if name.startswith("vf_"):          # moments from the warm-up: no such entry
            tiny = torch.zeros_like(tiny)
        else:
            n_tiny, n_actor = n_tiny + int(tiny.sum()), n_actor + p.numel()
        _close(p[~tiny], want[name][~tiny], name, rtol=0, atol=2e-6)
        _close(p[tiny], want[name][tiny], name, rtol=0, atol=tcfg.lr)
    assert n_tiny < 0.05 * n_actor
    # no probe ran: the kept iterate is the warmed-up initializer
    assert best_probe is None and [c["iter"] for c in entries["ppo_finetune_curve"]] == [0]
    for name, p in best_net.state_dict().items():
        assert torch.equal(p, warmed[name]), name


class _CountingTrainer:
    """A stand-in trainer: each train_step adds 1 to the network's bias."""

    def train_step(self, ps):
        with torch.no_grad():
            ps.net.bias.add_(1.0)
        return ps, {"mean_reward": torch.tensor(float(ps.net.bias[0])),
                    "kl_est": torch.tensor(0.0)}


@pytest.mark.parametrize("scores, kept", [((0.1, 0.5, 0.3), 9), ((-9.9, -10.0, -11.0), None),
                                          ((0.2, 0.2, 0.1), 4)])
def test_finetune_stage_probes_every_5th_and_keeps_the_best(scores, kept):
    """finetune_stage evaluates after iterations 4, 9, 14 and keeps a copy of
    the network at the first highest score above -9.9, else the warmed-up
    initializer's; the curve carries the evaluation's entries there."""
    ps = dataclasses.make_dataclass("S", ["net", "obs_norm"])(torch.nn.Linear(1, 1), None)
    with torch.no_grad():
        ps.net.bias.zero_()
    calls = []

    def evaluate(policy):
        calls.append(float(ps.net.bias[0]))
        return {"eval": calls[-1]}, scores[len(calls) - 1], f"probe {len(calls)}"

    fs, best, probe, entries = st.finetune_stage(_CountingTrainer(), _CountingTrainer(), ps,
                                                 2, 15, evaluate)
    assert calls == [7.0, 12.0, 17.0]          # 2 warm-up steps, then iterations 4, 9, 14
    curve = entries["ppo_finetune_curve"]
    assert [i for i, c in enumerate(curve) if "eval" in c] == [4, 9, 14]
    assert best is not fs.net and float(fs.net.bias[0]) == 17.0
    want = 2.0 if kept is None else 3.0 + kept
    assert float(best.bias[0]) == want
    assert probe == (None if kept is None else f"probe {(kept + 1) // 5}")
    assert entries["ppo_finetune_reward_improved"] is True
