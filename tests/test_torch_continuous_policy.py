"""The learned continuous-jumping trainer (train_continuous_policy.py over
train/continuous.py) held to the JAX script examples/train_continuous_policy.py.

The script parses its arguments in main() and is never imported: the tests
take its functions and blocks with ``ast`` and ``exec`` them with their
globals supplied (the JAX package's modules, the env, stubs). No script is
edited. Held here, on the CPU, at small sizes:

  (a) the env config field for field and its obs_dim / action_dim for both
      tasks; the ARS and PPO configurations, the budgets and the smoke cut;
  (b) the masked evaluation (the script's make_eval / eval_scores) from
      JAX's reset states of seeds 30000-30001 at --seconds 1.5, converted
      with the autopilot's state and JAX's observation noise, the committed
      continuous policy acting; lane 1's sim clock started 0.5 s late, so it
      is done 50 control steps early and keeps its state after: per seed
      good_jumps and n_jumps equal, mean_perf within 2e-3, how each episode
      ended as JAX's done;
  (c) the collection's keep mask (the script's `collect`, its policy the
      same network) exactly, so the BC row count; the rows within
      1e-5·(1+|x|) + 10 x the port's own spread, per step and lane the
      largest change of its row under a one-ulp change of the start (the
      joint angles): stiff contact carries a rounding of either simulator
      into the joint velocities within ten control steps (measured: the
      rows part by 3e-4 there and by up to 1.9 late in the episode, the
      port against itself as far), the spread rule of the fused kernels'
      checks (chip_smoke.py ENV_SPREAD);
  (d) one ARS step (4 directions, the top 2, a bank of 2, 0.5 s episodes)
      with JAX's deltas and bank, one set of rollouts (each lane's return
      and observation moments by jro.episode_returns) handed to both
      train_steps in place of their own (the masked episodes are (b) and
      (c)): W, the statistics and the training return within 1e-6;
  (e) the critic warm-up step and one PPO step (bc_coef 30 on anchor rows
      whose actions sit 0.05 from the network's, pg_mask from the
      autopilot, noise_rho 0.9, frozen statistics) from JAX's warm-started
      state with JAX's draws and segments: within
      tests/test_torch_two_stage_chain.py's tolerances (2e-6; an entry
      whose gradient falls below 1e-7 in a minibatch within one step, lr,
      under 5% of the actor);
  (f) the comparisons, the selection and the gate against the script's own
      block on hand-built records, ties included;
  (g) a full run's npz read by the script's load_policy: every leaf bitwise;
  (h) --smoke --device cpu: returns, prints the summary lines, writes nothing.
(g) and (h) run the entry point with its widths cut (module constants
patched: settle 20, 2 lanes, 0.05 s episodes).
"""

import ast
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.train import ars as jars
from quadruped_springs_tpu.train import normalize as jnorm
from quadruped_springs_tpu.train import ppo as jppo
from quadruped_springs_tpu.train import rollout as jro
from quadruped_springs_tpu.train.networks import linear_policy_apply as jlinear
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch import train_continuous_policy as tcp
from quadruped_springs_tpu_torch.env.continuous_autopilot import APState
from quadruped_springs_tpu_torch.env.env import NoiseStreams
from quadruped_springs_tpu_torch.train import ars as tars
from quadruped_springs_tpu_torch.train import continuous as cont
from quadruped_springs_tpu_torch.train import ppo as tppo
from tests.test_torch_two_stage_chain import jax_ppo_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "train_continuous_policy.py")
POLICY = os.path.join(ROOT, "examples", "policies", "continuous_policy.npz")
SECONDS = 1.5
N_STEPS = int(SECONDS * 100) + 10
SEEDS = (30000, 30001)
SHIFT = 500                    # lane 1's sim clock starts 0.5 s late
PERF_TOL = 2e-3
ROW_TOL = 1e-5
SPREAD = 10.0
SMALL_PPO = dict(n_envs=2, segment_len=4, reset_bank_size=2, n_epochs=1, n_minibatches=2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree():
    with open(SCRIPT) as f:
        return ast.parse(f.read())


def _exec(nodes, ns):
    exec(compile(ast.Module(body=list(nodes), type_ignores=[]), SCRIPT, "exec"), ns)
    return ns


def _function(name, **glob):
    """The script's function `name`, top level or nested in main()."""
    node = next(n for n in ast.walk(_tree()) if isinstance(n, ast.FunctionDef)
                and n.name == name)
    return _exec([node], dict(glob))[name]


def _main_body():
    return next(n for n in _tree().body if isinstance(n, ast.FunctionDef)
                and n.name == "main").body


def _call_kwargs(func_name):
    """The keywords of the first call of `func_name` in main(), evaluated."""
    call = next(n for n in ast.walk(ast.Module(body=_main_body(), type_ignores=[]))
                if isinstance(n, ast.Call) and ast.unparse(n.func) == func_name)
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if not isinstance(k.value, ast.Name)}


def _script():
    """The script's top-level helpers with the JAX package's modules."""
    return {name: _function(name, jax=jax, jnp=jnp, np=np)
            for name in ("make_env", "make_eval", "eval_scores", "load_policy")}


def _jax_noise(keys, steps: int, obs_dim: int):
    """The standard normals of the JAX env's observation noise from each
    lane's state key over `steps` steps (env.step splits its key once a
    step, jax.random.normal of the second half), as NoiseStreams rows:
    row t is step t's, row 0 (the reset's) unused."""
    def one(key):
        def body(k, _):
            k, k_obs = jax.random.split(k)
            return k, jax.random.normal(k_obs, (obs_dim,))
        _, draws = jax.lax.scan(body, key, None, length=steps)
        return jnp.concatenate([jnp.zeros((1, obs_dim)), draws])
    draws = jax.jit(jax.vmap(one))(keys)
    return NoiseStreams(_t(draws), torch.arange(draws.shape[0]))


def _ap_state(jst):
    """A batched JAX APState as the port's."""
    return APState(env=convert.env_state(jst.env), phase=_t(jst.phase), held=_t(jst.held),
                   deadline=_t(jst.deadline))


class _ClockShift:
    """The script's env with the lane of seed SEEDS[1] starting its sim clock
    SHIFT substeps late: it times out SHIFT / 10 control steps early."""

    def __init__(self, env):
        self.env, self.obs_dim, self.action_dim = env, env.obs_dim, env.action_dim

    def reset(self, key):
        st, obs = self.env.reset(key)
        late = jnp.where(key[-1] == SEEDS[1], SHIFT, 0).astype(st.env.sim_step_counter.dtype)
        return st.replace(env=st.env.replace(
            sim_step_counter=st.env.sim_step_counter + late)), obs

    def step(self, st, a):
        return self.env.step(st, a)


# -- (a) configuration ----------------------------------------------------------

@pytest.mark.parametrize("task", [cont.SCORE_TASK, cont.PPO_TASK])
def test_env_config_matches_the_script(task):
    jenv = _script()["make_env"](task, 4.0)
    got = cont.env_config(task, 4.0)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(jenv.config, f.name), f.name
    tenv = cont.make_env(task, 4.0, "cpu")
    assert (tenv.obs_dim, tenv.action_dim) == (jenv.obs_dim, jenv.action_dim)
    assert (cont.episode_steps(4.0), cont.episode_steps(1.5)) == (410, 160)


def test_trainer_configs_and_budgets_match_the_script():
    """ARSConfig's and PPOConfig's keywords, the critic warm-up's lr and
    freeze, argparse's defaults and the smoke cut, the seeds."""
    ars = _call_kwargs("ARSConfig")
    assert ars.pop("episode_steps", None) is None           # n_steps, a name
    assert {k: getattr(cont.ARS, k) for k in ars} == ars
    ppo = _call_kwargs("PPOConfig")
    assert {k: getattr(cont.PPO, k) for k in ppo} == ppo
    assert _call_kwargs("dataclasses.replace") == {"lr": cont.CRITIC_WARMUP_LR,
                                                   "freeze_actor": True}
    body = ast.unparse(ast.Module(body=_main_body(), type_ignores=[]))
    for k, v in tcp.DEFAULTS.items():
        assert f"'--{k.replace('_', '-')}', type={type(v).__name__}, default={v}" in body
    smoke = next(st for st in _main_body() if isinstance(st, ast.If)
                 and ast.unparse(st.test) == "args.smoke")
    args = types.SimpleNamespace(**tcp.DEFAULTS)
    _exec(smoke.body, {"args": args})
    assert vars(args) == tcp.SMOKE
    for seed, key in ((cont.SEEDS["ars"], "ars.init(jax.random.PRNGKey(0))"),
                      (cont.SEEDS["collect"], "jax.random.split(jax.random.PRNGKey(11), 8)"),
                      (cont.SEEDS["bc"], "jax.random.PRNGKey(2), iters=4000, log_std=-2.0"),
                      (cont.SEEDS["ppo"], "ppo.init(jax.random.PRNGKey(3))"),
                      (cont.SEEDS["critic"], "bc_norm, jax.random.PRNGKey(4)")):
        assert key in body and str(seed) in key
    assert "PRNGKey(30000 + i) for i in range(8)" in body and cont.EVAL_SEEDS[-1] == 30007
    assert "PRNGKey(40000 + i) for i in range(4)" in body and cont.GATE_SEEDS[-1] == 40003
    assert (cont.BC_ITERS, cont.BC_LOG_STD, cont.COLLECT_LANES) == (4000, -2.0, 8)
    assert (cont.KPI_SECONDS, cont.KPI_STEPS) == (6.0, 610)
    assert "make_eval(kpi_env, mlp_apply, 610)" in body


# -- (b), (c) the masked evaluation and the collection --------------------------

@pytest.fixture(scope="module")
def episode():
    """The script's make_eval, eval_scores and collect on the committed
    continuous policy from seeds SEEDS (lane 1's clock shifted), and the
    port's masked_episode from JAX's reset states with JAX's noise."""
    s = _script()
    jenv = s["make_env"](cont.SCORE_TASK, SECONDS)
    net = jppo.PPOTrainer(jenv).net
    params, jon = s["load_policy"](POLICY, net, jenv.obs_dim)
    mlp_apply = _function("mlp_apply", net=net)
    env = _ClockShift(jenv)
    keys = jnp.stack([jax.random.PRNGKey(k) for k in SEEDS])
    ev = s["make_eval"](env, mlp_apply, N_STEPS)
    jrec = s["eval_scores"](ev, params, jon, keys)
    _, jdone = ev(params, jon, keys)
    collect = _function("collect", jax=jax, jnp=jnp, score_env=env, ars_W=params, ars_on=jon,
                        vnorm=jnorm, linear_policy_apply=mlp_apply, n_steps=N_STEPS)
    jrows = jax.device_get(collect(keys))
    jst, jobs = jax.jit(jax.vmap(env.reset))(keys)

    tenv = cont.make_env(cont.SCORE_TASK, SECONDS, "cpu")
    policy = cont.mlp_policy(convert.mlp_policy(jax.tree.map(np.asarray, params), "cpu"),
                             convert.running_norm(jon))
    noise = _jax_noise(jst.env.key, N_STEPS, jenv.obs_dim)
    start = _ap_state(jst)
    out = cont.masked_episode(tenv, policy, start, _t(jobs), N_STEPS, noise, record=True)
    q = start.env.robot.q
    nudged = dataclasses.replace(start, env=dataclasses.replace(start.env, robot=dataclasses.replace(
        start.env.robot, q=torch.nextafter(q, torch.full_like(q, np.inf)))))
    spread = cont.masked_episode(tenv, policy, nudged, _t(jobs), N_STEPS, noise, record=True)[4]
    return dict(jrec=jrec, jdone=np.asarray(jdone), jrows=jrows, out=out, spread=spread)


def test_masked_eval_matches_the_script(episode):
    sf, done, term, tout, _ = episode["out"]
    rec = cont.scores(sf.env.task, term, tout)
    jrec = episode["jrec"]
    assert set(rec) == set(jrec)
    for got, want in zip(rec["per_seed"], jrec["per_seed"]):
        assert got["good_jumps"] == want["good_jumps"] and got["n_jumps"] == want["n_jumps"]
        assert abs(got["mean_perf"] - want["mean_perf"]) <= PERF_TOL
        assert set(got) == (set(want) - {"crashed"}) | {"task_terminated", "timeout"}
        assert got["task_terminated"] or got["timeout"]
    assert rec["good_jumps_per_seed"] == jrec["good_jumps_per_seed"]
    assert rec["good_jumps_min"] == jrec["good_jumps_min"]
    assert abs(rec["mean_perf_mean"] - jrec["mean_perf_mean"]) <= PERF_TOL
    assert done.tolist() == episode["jdone"].tolist() == [True, True]
    assert tout.tolist() == [True, True] and not term.any()
    assert min(rec["good_jumps_per_seed"]) >= 1          # the policy jumps


def test_collection_mask_and_rows_match_the_script(episode):
    o, a, keep = episode["out"][4]
    jo, ja, jkeep = episode["jrows"]
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    # lane 1 is done 50 steps before lane 0 and keeps no row after it; the
    # autopilot's phases leave steps out of both
    last = [int(np.nonzero(jkeep[:, i])[0].max()) for i in range(2)]
    assert last[0] - last[1] >= SHIFT // 10 - 5 and not jkeep[:last[0]].all()
    obs_d, act_d = cont.keep_rows((o, a, keep))
    mask = jkeep.reshape(-1)
    want_o, want_a = jo.reshape(-1, jo.shape[-1])[mask], ja.reshape(-1, ja.shape[-1])[mask]
    assert obs_d.shape[0] == act_d.shape[0] == int(mask.sum()) > 0
    so, sa, skeep = episode["spread"]
    np.testing.assert_array_equal(skeep.numpy(), jkeep)
    for got, want, own, other in ((obs_d, want_o, o, so), (act_d, want_a, a, sa)):
        spread = np.abs(own.numpy() - other.numpy()).max(axis=-1, keepdims=True)
        spread = spread.reshape(-1, 1)[mask]
        err = np.abs(got.numpy() - want)
        bound = ROW_TOL * (1 + np.abs(want)) + SPREAD * spread
        assert (err <= bound).all(), (float(err.max()), float((err - bound).max()))


# -- (d) one ARS step -----------------------------------------------------------

def test_ars_step_takes_jax_draws_and_rollouts(monkeypatch):
    """One ars_stage iteration with the deltas and bank JAX's train_step
    draws from its key, and one set of rollouts of every (sign, direction,
    bank entry) lane given to both packages' train_step in place of their
    own (an evaluation after the step, stubbed, so the stage keeps the
    updated W): W, the statistics and the training return within 1e-6 of
    JAX's. The rollouts are jro.episode_returns's from the bank with
    JAX's noise; two compilations of them part already in the JAX package
    (a lane's return by up to 0.06 at 0.5 s: the stiff contact carries the
    rounding), so each train_step is handed the same ones: JAX's through
    ro.episode_returns, which looks its policy up by its actions on a probe
    observation."""
    seconds, steps, n_dir, bank_size = 0.5, cont.episode_steps(0.5), 4, 2
    jenv = _script()["make_env"](cont.SCORE_TASK, seconds)
    kw = dict(n_directions=n_dir, top_directions=2, episode_steps=steps,
              reset_bank_size=bank_size, step_size=cont.ARS.step_size,
              delta_std=cont.ARS.delta_std)
    jtr = jars.ARSTrainer(jenv, jars.ARSConfig(**kw))
    jts = jtr.init(jax.random.PRNGKey(0))
    _, k_delta, k_bank = jax.random.split(jts.key, 3)
    deltas = jax.random.normal(k_delta, (n_dir,) + jts.W.shape) * kw["delta_std"]
    jbank = jro.make_reset_bank(jenv, k_bank, bank_size, curriculum_level=jts.curriculum_level)
    Ws = jnp.concatenate([jts.W + deltas, jts.W - deltas])
    policy = lambda W: lambda o: jax.vmap(jlinear, in_axes=(None, 0))(
        W, jnorm.normalize(jts.obs_norm, o))

    @jax.jit
    def lanes(Ws):
        def one(W):
            rets, info = jro.episode_returns(jenv, policy(W), jbank[0], jbank[1], steps)
            return rets, info["obs_count"], info["obs_sum"], info["obs_sumsq"]
        return jax.vmap(one)(Ws)

    rets, oc, osum, osq = lanes(Ws)
    assert np.ptp(np.asarray(rets)) > 1e-2         # the returns differ across lanes
    probe = jnp.asarray(np.random.default_rng(3).standard_normal((4, jenv.obs_dim)),
                        jnp.float32)
    acts = jnp.stack([policy(W)(probe) for W in Ws])

    def given_returns(env, policy_fn, states, obs0, max_steps):
        k = jnp.argmin(jnp.abs(acts - policy_fn(probe)).sum(axis=(1, 2)))
        return rets[k], {"obs_count": oc[k], "obs_sum": osum[k], "obs_sumsq": osq[k]}

    monkeypatch.setattr(jars.ro, "episode_returns", given_returns)
    jts2, jm = jtr.train_step(jts)

    def port_returns(env, policy, states, obs, n, noise):
        assert obs.shape[0] == 2 * n_dir * bank_size and n == steps
        return _t(rets).reshape(-1), {"obs_count": _t(oc.sum()), "obs_sum": _t(osum.sum(0)),
                                      "obs_sumsq": _t(osq.sum(0))}

    tenv = cont.make_env(cont.SCORE_TASK, seconds, "cpu")
    ttr = tars.ARSTrainer(tenv, dataclasses.replace(cont.ARS, **kw))
    monkeypatch.setattr(tars.ro, "episode_returns", port_returns)
    monkeypatch.setattr(cont, "ARS_EVAL_EVERY", 1)
    record = {"good_jumps_mean": 1.0, "mean_perf_mean": 0.5, "good_jumps_per_seed": [1]}
    W, on, entries = cont.ars_stage(ttr, ttr.init(torch.Generator().manual_seed(0)), 1,
                                    lambda policy: record,
                                    draws=[(_t(deltas), (_ap_state(jbank[0]), _t(jbank[1])))])
    assert np.abs(np.asarray(jts2.W)).max() > 1e-2
    np.testing.assert_allclose(W.numpy(), np.asarray(jts2.W), rtol=0, atol=1e-6)
    for f in ("mean", "var", "count"):
        want = np.asarray(getattr(jts2.obs_norm, f))
        np.testing.assert_allclose(getattr(on, f).numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=f)
    (rec,) = entries["ars_curve"]
    np.testing.assert_allclose(rec["mean_return"], float(jm["mean_return"]), rtol=0, atol=1e-6)
    assert entries["ars_eval"] is record and entries["ars_improved"] is False


# -- (e) the critic warm-up and one PPO step -----------------------------------

def _params_close(net, want, grads, lr):
    """tests/test_torch_two_stage_chain.py's rule after a PPO step: every
    parameter within 2e-6 of JAX's, but an actor entry whose clipped
    gradient falls below 1e-7 in some minibatch (Adam's moments from 0 move
    it by the float32 rounding of a cancelled sum) within one step, lr; such
    entries under 5% of the actor."""
    n_tiny = n_actor = 0
    for name, p in net.named_parameters():
        tiny = torch.stack([g[name].abs() for g in grads]).amin(0) < 1e-7
        if name.startswith("vf_"):
            tiny = torch.zeros_like(tiny)
        else:
            n_tiny, n_actor = n_tiny + int(tiny.sum()), n_actor + p.numel()
        np.testing.assert_allclose(p.detach()[~tiny], want[name][~tiny], rtol=0, atol=2e-6,
                                   err_msg=name)
        np.testing.assert_allclose(p.detach()[tiny], want[name][tiny], rtol=0, atol=lr,
                                   err_msg=name)
    assert n_tiny < 0.05 * n_actor, n_tiny


def _recording(trainer, monkeypatch):
    """Each minibatch update's clipped gradients, kept."""
    grads, update = [], trainer._minibatch_update

    def recorded(ts, sl, halted):
        out = update(ts, sl, halted)
        grads.append({n: p.grad.detach().clone() for n, p in ts.net.named_parameters()})
        return out

    monkeypatch.setattr(trainer, "_minibatch_update", recorded)
    return grads


def test_ppo_warmup_and_step_match_jax(episode, monkeypatch):
    """ppo_init from the committed network as the BC stage's result keeps the
    actor and statistics under a fresh critic and anchors both trainers to
    the normalised rows; with JAX's warm-started critic and lanes loaded,
    one critic warm-up step (lr 3e-4, the actor moved by the BC anchor
    alone) and one masked PPO step at lr 1e-4 through ppo_stage, each with
    the draws JAX's train_step takes from its key and JAX's segment in
    place of the rollout (pg_mask the autopilot's), every parameter held by
    _params_close. The anchor rows are 64 collected rows with their actions
    moved 0.05 (seeded) from the network's: on the network's own actions
    the BC gradient is the rounding of a zero residual."""
    s = _script()
    jenv = s["make_env"](cont.PPO_TASK, SECONDS)
    jcfg = jppo.PPOConfig(**{**{f.name: getattr(cont.PPO, f.name)
                                for f in dataclasses.fields(jppo.PPOConfig)}, **SMALL_PPO})
    jtr = jppo.PPOTrainer(jenv, jcfg)
    jwarm = jppo.PPOTrainer(jenv, dataclasses.replace(jcfg, lr=3e-4, freeze_actor=True))
    params, jon = s["load_policy"](POLICY, jtr.net, jenv.obs_dim)
    jo, ja, jkeep = episode["jrows"]
    mask = jkeep.reshape(-1)
    obs_d = jo.reshape(-1, jo.shape[-1])[mask][:64]
    act_d = np.clip(ja.reshape(-1, ja.shape[-1])[mask][:64] + np.float32(0.05) * np.random.default_rng(
        7).standard_normal((64, ja.shape[-1])).astype(np.float32), -1, 1)
    for tr in (jtr, jwarm):
        tr.set_bc_anchor(jnorm.normalize(jon, jnp.asarray(obs_d)), jnp.asarray(act_d))
    jps = jtr.warm_start(jtr.init(jax.random.PRNGKey(3)), params, jon, jax.random.PRNGKey(4),
                         reset_value=True)

    tenv = cont.make_env(cont.PPO_TASK, SECONDS, "cpu")
    tcfg = dataclasses.replace(cont.PPO, **SMALL_PPO)
    ttr = tppo.PPOTrainer(tenv, tcfg)
    twarm = tppo.PPOTrainer(tenv, dataclasses.replace(tcfg, lr=cont.CRITIC_WARMUP_LR,
                                                      freeze_actor=True))
    bc_net = convert.mlp_policy(jax.tree.map(np.asarray, params), "cpu")
    bc_norm = convert.running_norm(jon)
    ps = cont.ppo_init(ttr, twarm, torch.Generator().manual_seed(3), bc_net, bc_norm,
                       _t(obs_d), _t(act_d))
    for tr in (ttr, twarm):
        np.testing.assert_allclose(tr.bc_anchor[0], np.asarray(jtr.bc_anchor[0]), rtol=0,
                                   atol=1e-6)
        assert torch.equal(tr.bc_anchor[1], _t(act_d))
    assert ps.net is not bc_net and ps.obs_norm is bc_norm
    for (k, v), w in zip(ps.net.state_dict().items(), bc_net.state_dict().values()):
        if not k.startswith("vf_"):
            assert torch.equal(v, w), k
        elif k.endswith("weight"):
            assert not torch.equal(v, w), k
    ps.net.load_state_dict(convert.mlp_policy_params(jax.tree.map(np.asarray, jps.params)))
    ps = dataclasses.replace(ps, bank=(_ap_state(jps.bank[0]), _t(jps.bank[1])),
                             env_states=_ap_state(jps.env_states), obs=_t(jps.obs))

    seg_fn = jax.jit(lambda tr_params, on, st, ob, bank, key: jro.segment_rollout(
        jenv, jtr._action_fn(tr_params, on), st, ob, bank, key, jcfg.segment_len))
    draws, segs, jstates = [], [], [jps]
    for jtrainer in (jwarm, jtr):
        j = jstates[-1]
        _, d = jax_ppo_draws(j.key, jcfg, jcfg.reset_bank_size, jenv.action_dim)
        draws.append(d)
        _, k_roll, _ = jax.random.split(j.key, 3)
        st, ob, traj = seg_fn(j.params, j.obs_norm, j.env_states, j.obs, j.bank, k_roll)
        segs.append((_ap_state(st), _t(ob), {k: _t(v) for k, v in traj.items()}))
        jstates.append(jtrainer.train_step(j)[0])
    assert 0 < float(segs[1][2]["pg_mask"].float().mean()) <= 1

    net = ps.net
    initial, warmed, calls = {k: v.detach().clone() for k, v in net.state_dict().items()}, {}, []

    def rollout(*a, **k):
        if calls:
            warmed.update({k: v.detach().clone() for k, v in net.state_dict().items()})
        calls.append(1)
        return segs[len(calls) - 1]

    monkeypatch.setattr(tppo.ro, "segment_rollout", rollout)
    wgrads, grads = _recording(twarm, monkeypatch), _recording(ttr, monkeypatch)
    evals, last_eval = [], {"good_jumps_mean": 0.0, "mean_perf_mean": 0.0}
    ps, kept, kept_norm, entries = cont.ppo_stage(
        ttr, twarm, ps, 1, 1, lambda pol: evals.append(1) or last_eval,
        draws={"warmup": [draws[0]], "ppo": [draws[1]]})
    assert len(calls) == 2 and evals == [1] and entries["ppo_eval"] is last_eval
    assert len(wgrads) == len(grads) == SMALL_PPO["n_minibatches"]
    for got, want, g, lr in ((warmed, jstates[1], wgrads, cont.CRITIC_WARMUP_LR),
                             (None, jstates[2], grads, tcfg.lr)):
        want = convert.mlp_policy_params(jax.tree.map(np.asarray, want.params))
        if got is None:
            assert max(float((want[k] - warmed[k]).abs().max()) for k in want) > 1e-5
            _params_close(ps.net, want, g, lr)
        else:
            assert max(float((want[k] - initial[k]).abs().max()) for k in want) > 1e-4
            _params_close(types.SimpleNamespace(named_parameters=lambda: (
                (k, v) for k, v in got.items())), want, g, lr)
    # no evaluation ran: the kept network is the warmed-up one
    for name, p in kept.state_dict().items():
        assert torch.equal(p, warmed[name]), name
    assert kept_norm is bc_norm


# -- (f) comparisons, selection and the gate -----------------------------------

def _record(good, perf):
    return {"good_jumps_per_seed": list(good), "good_jumps_mean": float(np.mean(good)),
            "good_jumps_min": int(np.min(good)), "mean_perf_mean": perf, "per_seed": []}


@pytest.mark.parametrize("bc, ppo, gate", [
    (([4, 6], 0.5), ([5, 5], 0.5), [4, 4]),          # equal scores: PPO selected, no gain
    (([4, 6], 0.5), ([4, 5], 0.5), [3, 9]),          # 0.5 below BC: still "improves"
    (([4, 6], 0.5), ([4, 4], 0.9), [4, 5]),          # more than 0.5 below: a no-op
    (([4, 6], 0.7), ([5, 5], 0.6), [0, 0]),          # BC by its performance term
    (([1, 2], 0.2), ([9, 9], 0.8), [12, 4])])
def test_selection_and_gate_follow_the_script(bc, ppo, gate):
    bc_eval, ppo_eval, gate_eval = _record(*bc), _record(*ppo), _record(gate, 0.5)
    calls = []

    def eval_scores(ev, params, norm, keys):
        calls.append((params, norm, int(keys.shape[0])))
        return gate_eval

    ns = _exec(_selection_block(), dict(
        jax=jax, jnp=jnp, results={}, bc_eval=bc_eval, ppo_eval=ppo_eval,
        best_ppo=(1.0, types.SimpleNamespace(params="ppo", obs_norm="ppo_norm"), ppo_eval),
        bc_params="bc", bc_norm="bc_norm", ev="ev", eval_scores=eval_scores))
    want = ns["results"]
    got = {**cont.stage_comparison(bc_eval, ppo_eval),
           "selected_stage": cont.selected_stage(bc_eval, ppo_eval),
           **cont.gate_entries(gate_eval)}
    assert got == want
    norm = {"ppo": "ppo_norm", "bc": "bc_norm"}[want["selected_stage"]]
    assert calls == [(want["selected_stage"], norm, len(cont.GATE_SEEDS))]


def _selection_block():
    """main()'s statements from `def stage_score` through the gate's flag."""
    body = _main_body()
    start = next(i for i, s in enumerate(body) if isinstance(s, ast.FunctionDef)
                 and s.name == "stage_score")
    end = next(i for i, s in enumerate(body) if "policy_sustains_4_good_jumps" in
               ast.unparse(s) and isinstance(s, ast.Assign))
    return body[start:end + 1]


# -- (g), (h) the entry point at a cut size ------------------------------------

@pytest.fixture
def cut(monkeypatch):
    """Every width and episode cut: settle 20, 2 evaluation / gate / collection
    lanes, ARS 2 directions on a bank of 2, PPO 2 lanes x 4 steps, 5 BC
    iterations, 0.05 s episodes (15 steps), the KPI episode 5 steps, an
    evaluation every second iteration."""
    monkeypatch.setattr(cont, "SETTLE", 20)
    monkeypatch.setattr(cont, "EVAL_SEEDS", SEEDS)
    monkeypatch.setattr(cont, "GATE_SEEDS", (40000, 40001))
    monkeypatch.setattr(cont, "COLLECT_LANES", 2)
    monkeypatch.setattr(cont, "BC_ITERS", 5)
    monkeypatch.setattr(cont, "ARS", dataclasses.replace(
        cont.ARS, n_directions=2, top_directions=1, reset_bank_size=2))
    monkeypatch.setattr(cont, "PPO", dataclasses.replace(cont.PPO, **SMALL_PPO))
    monkeypatch.setattr(cont, "ARS_EVAL_EVERY", 2)
    monkeypatch.setattr(cont, "PPO_EVAL_EVERY", 2)
    monkeypatch.setattr(cont, "KPI_STEPS", 5)
    monkeypatch.setattr(tcp, "SMOKE", dict(tcp.SMOKE, seconds=0.05))


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or np.isfinite(x)


def _examples_stamp():
    return sorted((os.path.join(d, f), os.stat(os.path.join(d, f)).st_mtime_ns)
                  for d, _, files in os.walk(os.path.join(ROOT, "examples")) for f in files)


def test_smoke_writes_nothing(cut, tmp_path, capsys):
    """(h) --smoke --device cpu: the results carry the committed JAX
    artifact's keys, every number finite; the script's two summary lines
    and the timing line printed; neither --out nor examples/ written."""
    before = _examples_stamp()
    results = tcp.main(["--smoke", "--device", "cpu", "--out", str(tmp_path / "out")])
    lines = capsys.readouterr().out.strip().splitlines()
    with open(os.path.join(ROOT, "examples", "out", "continuous_policy_results.json")) as f:
        assert set(results) == set(json.load(f))
    assert _finite(results)
    assert set(json.loads(lines[-3])) == set(tcp.SUMMARY)
    assert lines[-2].startswith("gate: ") and set(json.loads(lines[-2][6:])) == set(
        tcp.GATE_SUMMARY)
    timing = json.loads(lines[-1])
    assert set(timing["stage_seconds"]) == {"ars", "bc", "ppo", "gate"}
    assert [c["iter"] for c in results["ars_curve"]] == [0, 1, 2]
    assert "good_jumps_mean" in results["ars_curve"][1]
    assert not (tmp_path / "out").exists() and _examples_stamp() == before
    with pytest.raises(SystemExit):
        tcp.main(["--smoke", "--device", "cpu", "--out", os.path.join(ROOT, "examples", "x")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tcp.main(["--smoke"])


def test_full_run_files_load_in_the_script(cut, tmp_path, capsys, monkeypatch):
    """(g) A full run at the cut size writes the npz, the KPI, results and
    timing files; the script's load_policy reads the npz to the selected
    network's leaves and statistics, bitwise."""
    out = tmp_path / "run"
    saved = []
    save = tcp.save_flat_mlp_policy
    monkeypatch.setattr(tcp, "save_flat_mlp_policy",
                        lambda path, net, norm: saved.append((net, norm)) or save(path, net, norm))
    results = tcp.main(["--device", "cpu", "--out", str(out), "--seconds", "0.05",
                        "--ars-iters", "1", "--ppo-iters", "0",
                        "--ppo-critic-warmup-iters", "0"])
    capsys.readouterr()
    assert sorted(p.name for p in out.iterdir()) == [
        "continuous_policy.npz", "continuous_policy_kpis.json",
        "continuous_policy_results.json", "continuous_policy_timing.json"]
    kpi = json.loads((out / "continuous_policy_kpis.json").read_text())
    assert kpi["sim_seconds"] == 6.0 and kpi["driver"].startswith(
        f"policy ({results['selected_stage']})")
    jenv = _script()["make_env"](cont.SCORE_TASK, 4.0)
    params, jon = _script()["load_policy"](str(out / "continuous_policy.npz"),
                                           jppo.PPOTrainer(jenv).net, jenv.obs_dim)
    ((net, on),) = saved
    want = convert.mlp_policy_params(jax.tree.map(np.asarray, params))
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k
    for f in ("mean", "var", "count"):
        assert np.array_equal(getattr(on, f).numpy(), np.asarray(getattr(jon, f))), f
