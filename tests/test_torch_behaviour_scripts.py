"""The behaviour trainers' pieces held to the JAX scripts' own functions.

Each script runs code at import (argparse at module level), so the tests
never import one: they parse it with ``ast``, take the named function or
the block of its training loop, and ``exec`` it with its globals supplied
(the JAX env, ``on``, ``args``, ``unravel``, stubs for the scorers). No
script is edited. Held here:

  * ``ridge_fit`` within 1e-6; ``mlp_apply`` within 1e-6 and ``mlp_init``'s
    structure; ``jax.flatten_util.ravel_pytree``'s layout bitwise;
  * ``collect_script_demo``'s actions and keep rule exactly, on stub envs
    that switch the controller at given steps;
  * ``stab_score`` and ``make_score``'s ``episode_score`` within 2e-3 (no
    observation noise, 10 control steps) on two JAX reset states and on
    three made from them where the rotation and terminal terms are in their
    sensitive range: in the air, rolled to up_z 0.88 or 0.82, the pitch
    tracker 0.02 rad above or below the rotation bar, and one lane timing
    out at its fourth step;
  * each training loop with stub scorers: the numpy draws (seeds, bank
    indices, δ) in the script's order and the ARS update bitwise, the best
    iterate and what is saved.
"""

import ast
import os
import time
import types

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env import flat_rollout as jfr
from quadruped_springs_tpu.env.env import EnvConfig as JEnvConfig
from quadruped_springs_tpu.env.env import QuadrupedEnv as JQuadrupedEnv
from quadruped_springs_tpu.models import spatial as jsp
from quadruped_springs_tpu.train import normalize as jnorm
from quadruped_springs_tpu.train.networks import linear_policy_apply as jlinear
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch import train_backflip_landing_mlp as lm
from quadruped_springs_tpu_torch import train_backflip_robust_joint as rj
from quadruped_springs_tpu_torch import train_behavior_policies as tbp
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.train import behaviour as bh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICIES = os.path.join(ROOT, "examples", "policies")
BEHAVIOR = "train_behavior_policies.py"
LANDING = "train_backflip_landing_mlp.py"
JOINT = "train_backflip_robust_joint.py"
FLIP = dict(enable_springs=True, task_env="BACKFLIP", observation_space_mode="ARS_BACKFLIP",
            action_space_mode="SYMMETRIC", obs_noise=False, max_ep_len=4.0,
            settling_steps=200, env_randomizer_mode="TEST_RANDOMIZER")
HORIZON = 10
TOL = 2e-3


def _tree(script):
    with open(os.path.join(ROOT, "scripts", script)) as f:
        return ast.parse(f.read())


def _exec(script, nodes, ns):
    exec(compile(ast.Module(body=list(nodes), type_ignores=[]), script, "exec"), ns)
    return ns


def _function(script, name, **glob):
    node = next(n for n in ast.walk(_tree(script))
                if isinstance(n, ast.FunctionDef) and n.name == name)
    return _exec(script, [node], dict(glob))[name]


def _loop_block(script, first, keep_defs=()):
    """The statements of the block holding `for i in range(args.iters)`,
    from the one assigning `first` through the loop; function definitions
    other than keep_defs left out (the test supplies them)."""
    for node in ast.walk(_tree(script)):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        loops = [k for k, s in enumerate(body) if isinstance(s, ast.For)
                 and ast.unparse(s.iter) == "range(args.iters)"]
        if not loops:
            continue
        start = next((k for k, s in enumerate(body) if isinstance(s, ast.Assign)
                      and first in ast.unparse(s.targets[0])), None)
        if start is None:
            continue
        return [s for s in body[start:loops[0] + 1]
                if not isinstance(s, ast.FunctionDef) or s.name in keep_defs]
    raise LookupError(script)


def _quiet(*a, **k):
    pass


def _t(x):
    return torch.from_numpy(np.array(x))


# -- numpy pieces ---------------------------------------------------------------

def test_ridge_fit_matches_the_script():
    rng = np.random.default_rng(0)
    O = rng.standard_normal((90, 27)).astype(np.float32) * 3 + 1
    A = rng.uniform(-1, 1, (90, 6)).astype(np.float32)
    want = _function(BEHAVIOR, "ridge_fit", np=np)(O, A)
    got = bh.ridge_fit(O, A)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def _joint_params():
    d, m = (np.load(os.path.join(POLICIES, f)) for f in ("backflip_ars.npz",
                                                          "backflip_landing_mlp.npz"))
    return {"W": np.asarray(d["W"], np.float32),
            "mlp": {k: np.asarray(m[k], np.float32) for k in ("W1", "b1", "W2", "b2")}}


def test_flat_layout_is_ravel_pytrees():
    """The joint dict and the MLP dict: the flat vector bitwise
    jax.flatten_util.ravel_pytree's (keys sorted: W, W1, W2, b1, b2), and
    unravel giving back every leaf bitwise."""
    params = _joint_params()
    for tree in (params, params["mlp"]):
        jflat, junravel = jax.flatten_util.ravel_pytree(
            jax.tree.map(jnp.asarray, tree))
        layout = bh.FlatLayout(tree)
        flat = layout.ravel(tree)
        np.testing.assert_array_equal(flat, np.asarray(jflat))
        assert flat.dtype == np.float32 and layout.size == flat.size
        back, jback = layout.unravel(flat), junravel(jflat)
        for leaf, jleaf in zip(jax.tree.leaves(back), jax.tree.leaves(jback)):
            np.testing.assert_array_equal(leaf, np.asarray(jleaf))
        lanes = layout.unravel(torch.as_tensor(np.stack([flat, 2 * flat])))
        for leaf, jleaf in zip(jax.tree.leaves(lanes), jax.tree.leaves(jback)):
            np.testing.assert_array_equal(leaf[1].numpy(), 2 * np.asarray(jleaf))


def test_mlp_apply_and_init_follow_the_script():
    params = _joint_params()["mlp"]
    on_np = np.load(os.path.join(POLICIES, "backflip_ars.npz"))
    jon = jnorm.RunningNorm(*(jnp.asarray(on_np[k]) for k in ("mean", "var", "count")))
    on = convert.load_linear_policy(os.path.join(POLICIES, "backflip_ars.npz"), "cpu")[1]
    apply = _function(LANDING, "mlp_apply", jnp=jnp)
    obs = np.random.default_rng(1).standard_normal((5, 27)).astype(np.float32)
    want = jax.vmap(lambda o: apply(jax.tree.map(jnp.asarray, params),
                                    jnorm.normalize(jon, o)))(jnp.asarray(obs))
    got = bh.mlp_act({k: _t(v) for k, v in params.items()}, on)(_t(obs))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    landing = np.float32([0.0, 0.3, -0.6, 0.0, 0.3, -0.6])
    jinit = _function(LANDING, "mlp_init", jax=jax, jnp=jnp)(
        jax.random.PRNGKey(3), 27, 32, landing)
    init = lm.mlp_init(27, 32, torch.as_tensor(landing))
    for k in ("W1", "b1", "W2", "b2"):
        assert init[k].shape == jinit[k].shape and init[k].dtype == jinit[k].dtype
    for k in ("b1", "W2", "b2"):
        np.testing.assert_array_equal(init[k], np.asarray(jinit[k]))
    assert 0.07 < init["W1"].std() < 0.13


class _StubEnv:
    """Switches lane k's controller from step switch_at[k] on; observations
    count the steps. The script's env (reset(key) of one seed, step) or,
    with port=True, the port's (every lane at once)."""

    def __init__(self, switch_at, port):
        self.switch_at, self.port, self.seed = np.asarray(switch_at), port, 0

    def _state(self, t):
        sw = t >= (self.switch_at if self.port else self.switch_at[self.seed])
        return types.SimpleNamespace(t=t, task=types.SimpleNamespace(
            switched_controller=torch.as_tensor(sw) if self.port else np.bool_(sw)))

    def reset(self, key):
        self.seed = int(np.asarray(key)[-1])
        return self._state(0), np.zeros(3, np.float32)

    def step(self, state, a, noise=None):
        t = state.t + 1
        obs = (torch.full((len(self.switch_at), 3), float(t)) if self.port
               else np.full(3, t, np.float32))
        return self._state(t), obs, None, None, None


def test_collect_script_demo_follows_the_script():
    """The scripted actions and the keep rule (until two steps after the
    switch, or max_steps), seed by seed: the same (obs, action) rows."""
    switch_at = [3, 7, 40, 0]
    crouch = jnp.array([0.0, 0.5, -0.9, 0.0, 0.5, -0.9])
    launch_a = jnp.array([0.0, -0.3, 0.7, 0.0, -1.0, 1.0])

    def action_at(i):
        frac = min((i + 1) / 6, 1.0)
        return frac * crouch if i < 6 else launch_a

    want = _function(BEHAVIOR, "collect_script_demo", jax=jax, np=np)(
        _StubEnv(switch_at, False), action_at, n_seeds=4, max_steps=12)
    start = (types.SimpleNamespace(t=0), torch.zeros(4, 3), None)
    got = bh.collect_script_demo(_StubEnv(switch_at, True), 4, 12, start=start)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the shaped objectives on the JAX env ---------------------------------------

ROT_BAR = 2 * np.pi - 0.1
# lanes 2-4: (up_z of the roll, pitch tracker) in the air; lane 4 times out
SENSITIVE = ((0.88, ROT_BAR + 0.02), (0.82, ROT_BAR - 0.02), (0.88, ROT_BAR + 0.02))
TIMEOUT_LANE, TIMEOUT_SUBSTEPS = 4, 3965   # 4.0 s episode: done at its 4th step


def _sensitive(js):
    """The two reset states, then SENSITIVE's three made from them: raised
    0.15 m, rolled about x to the up_z given, at rest, the pitch tracker set."""
    js = jax.tree.map(lambda x: x[jnp.array([0, 1, 0, 1, 0])], js)
    up, pitch = (np.float32(v) for v in zip(*SENSITIVE))
    half = np.arccos(up) / 2
    quat = np.stack([np.sin(half), 0 * half, 0 * half, np.cos(half)], -1).astype(np.float32)
    r = js.robot
    robot = r.replace(pos=r.pos.at[2:, 2].add(0.15), quat=r.quat.at[2:].set(quat),
                      lin_vel=r.lin_vel.at[2:].set(0.0), ang_vel=r.ang_vel.at[2:].set(0.0))
    return js.replace(robot=robot,
                      task=js.task.replace(max_pitch_bf=js.task.max_pitch_bf.at[2:].set(pitch)),
                      sim_step_counter=js.sim_step_counter.at[TIMEOUT_LANE].set(TIMEOUT_SUBSTEPS))


@pytest.fixture(scope="module")
def flip_states():
    jenv = JQuadrupedEnv(JEnvConfig(**FLIP))
    tenv = QuadrupedEnv(EnvConfig(**FLIP), device="cpu")
    js, jobs = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(4), 2))
    js, jobs = _sensitive(js), jobs[jnp.array([0, 1, 0, 1, 0])]
    d = np.load(os.path.join(POLICIES, "backflip_ars.npz"))
    jon = jnorm.RunningNorm(*(jnp.asarray(d[k]) for k in ("mean", "var", "count")))
    on = convert.load_linear_policy(os.path.join(POLICIES, "backflip_ars.npz"), "cpu")[1]
    return jenv, tenv, js, jobs, jon, on


def test_stab_score_matches_the_script(flip_states):
    jenv, tenv, js, jobs, jon, on = flip_states
    params = _joint_params()["mlp"]
    mlp_apply = _function(LANDING, "mlp_apply", jnp=jnp)
    stab = _function(LANDING, "stab_score", jax=jax, jnp=jnp, env=jenv, on=jon,
                     vnorm=jnorm, sp=jsp, mlp_apply=mlp_apply, Z_STAND=0.30,
                     args=types.SimpleNamespace(horizon=HORIZON))
    jtot, jstrict = jax.jit(jax.vmap(stab, in_axes=(None, 0, 0)))(
        jax.tree.map(jnp.asarray, params), js, jobs)
    tot, strict = bh.stab_score(tenv, bh.mlp_act({k: _t(v) for k, v in params.items()}, on),
                                convert.env_state(js), _t(jobs), None, HORIZON)
    np.testing.assert_allclose(tot, np.asarray(jtot), rtol=0, atol=TOL)
    np.testing.assert_array_equal(strict, np.asarray(jstrict))
    # the made lanes reach both sides of the upright bar and the done path
    assert np.asarray(jstrict)[2:].tolist() == [True, False, False]


def test_episode_score_matches_the_script(flip_states):
    jenv, tenv, js, jobs, jon, on = flip_states
    params = _joint_params()
    jflat, unravel = jax.flatten_util.ravel_pytree(jax.tree.map(jnp.asarray, params))
    make_score = _function(JOINT, "make_score", jax=jax, jnp=jnp, unravel=unravel, on=jon,
                           vnorm=jnorm, sp=jsp, fr=jfr, linear_policy_apply=jlinear,
                           TWO_PI_BAR=2 * np.pi - 0.1,
                           args=types.SimpleNamespace(knots=HORIZON))
    jsc, jstrict = jax.jit(jax.vmap(make_score(jenv), in_axes=(None, 0, 0)))(jflat, js, jobs)
    layout = bh.FlatLayout(params)
    p = bh.lanes_params(layout.ravel(params)[None], layout,
                        torch.zeros(len(jobs), dtype=torch.long), "cpu")
    sc, strict = bh.episode_score(tenv, bh.linear_act(p["W"], on), bh.mlp_act(p["mlp"], on),
                                  convert.env_state(js), _t(jobs), None, HORIZON)
    np.testing.assert_allclose(sc, np.asarray(jsc), rtol=0, atol=TOL)
    np.testing.assert_array_equal(strict, np.asarray(jstrict))
    # the gate passes above the bars and fails below them (the timed-out
    # lane keeps its pose: only its alive fraction drops)
    assert np.asarray(jstrict)[2:].tolist() == [True, False, True]


# -- the training loops with stub scorers ---------------------------------------

def _record():
    calls = []
    return calls, lambda *a: calls.append(tuple(np.array(x, copy=True) if not isinstance(
        x, (int, float, str)) else x for x in a))


def test_behaviour_loop_draws_and_updates_as_the_script():
    """train_behavior_policies.py's fine-tune loop: the two training seeds
    and the float64 δ in the script's order, the ± candidates, the update
    bitwise, the best (gate, reward) iterate and the early stop."""
    K = np.random.default_rng(5).standard_normal((6, 27)).astype(np.float32)

    def ret(W, seeds):
        W = np.asarray(W, np.float32)
        return float(np.sum(np.tanh(W * K)) * 0.1 + seeds[0] % 7 * 0.01 - seeds[1] % 5 * 0.01)

    def rows(W):
        # the script reads the pose, the port the verdicts of flip_rows
        s = float(np.sum(np.asarray(W, np.float32) * K))
        return [{"pitch_rad": 6.3 if s > 0.02 * k - 0.04 else 1.0, "up_z": 0.9, "z": 0.3,
                 "apex": 0.5, "reward": s * 0.01 + k, "rotation": s > 0.02 * k - 0.04,
                 "upright": True} for k in range(4)]

    W0 = (0.1 * np.random.default_rng(6).standard_normal((6, 27))).astype(np.float32)
    seen, rec = _record()
    ns = dict(np=np, jnp=jnp, args=types.SimpleNamespace(iters=8), Wj=jnp.asarray(W0),
              on=None, n_eval=4, print=_quiet, eval_rows=rows,
              ret_W=lambda W, seeds: (rec(W, list(seeds)), ret(W, seeds))[1])
    _exec(BEHAVIOR, _loop_block(BEHAVIOR, "n_dir", keep_defs=("score",)), ns)
    got_seen, got_rec = _record()

    def returns_fn(W_cand, seeds):
        out = []
        for W in W_cand:
            got_rec(W, list(seeds))
            out.append(ret(W, seeds))
        return np.array(out)

    (sc, W_best), curve = tbp.ars_loop(W0, returns_fn, rows, 8, 4, _quiet)
    assert len(got_seen) == len(seen) and len(curve) == ns["i"] + 1
    for (gw, gs), (w, s) in zip(got_seen, seen):
        np.testing.assert_array_equal(gw, w)
        assert list(gs) == list(s)
    assert sc == ns["best"][0]
    np.testing.assert_array_equal(W_best, ns["best"][1])
    np.testing.assert_array_equal(W_best.dtype, ns["best"][1].dtype)


def _flat_stubs(n_train):
    K = np.random.default_rng(8).standard_normal(40).astype(np.float32)

    def returns(cand, idx):
        cand, idx = np.asarray(cand), np.asarray(idx)
        return (np.tanh(cand @ K) * 0.1 + idx.sum() * 1e-3).astype(np.float32)

    def key(p):
        p = np.asarray(p)
        return (int(abs(np.sum(p[:5])) * 10) % 5, int(abs(np.sum(p[5:10])) * 10) % 3,
                float(np.float32(np.tanh(np.sum(p)))))

    def failures(p):
        return np.flatnonzero(np.asarray(p)[:n_train] > 0)

    return returns, key, failures


@pytest.mark.parametrize("hard_frac", [0.0, 0.5])
def test_landing_loop_draws_and_updates_as_the_script(hard_frac):
    """train_backflip_landing_mlp.py's phase 2: the minibatch (hard cases
    too) and float32 δ in the script's order, the flat update bitwise, the
    probe-selected best and its saves, the early stop."""
    n_train = 9
    returns, key, failures = _flat_stubs(n_train)
    flat0 = (0.1 * np.random.default_rng(9).standard_normal(40)).astype(np.float32)
    args = types.SimpleNamespace(iters=45, n_dir=3, delta_std=0.03, step_size=0.02,
                                 probe_every=5, n_probe=2, hard_frac=hard_frac,
                                 optimizer="ars", train_states=4, out="lander")
    seen, rec = _record()
    saved, save = _record()
    ns = dict(np=np, jnp=jnp, args=args, time=time, print=_quiet, n_train=n_train,
              idx_train=np.arange(n_train), idx_val=np.arange(n_train, 12), params=flat0,
              flat0=flat0, unravel=lambda x: x,
              ars_returns=lambda cand, idx: (rec(cand, idx), returns(cand, idx))[1],
              eval_params=lambda p, idx: (0.0, key(p)[2]), probe=lambda p: key(p)[:2],
              train_failures=failures, save_candidate=lambda p, path: save(p))
    ns["sample_minibatch"] = _function(LANDING, "sample_minibatch", **ns)
    _exec(LANDING, _loop_block(LANDING, "rng"), ns)
    got_seen, got_rec = _record()
    got_saved, got_save = _record()
    best, iters = lm.ars_loop(flat0, args, n_train,
                              lambda c, i: (got_rec(c, i), returns(c, i))[1], key, failures,
                              got_save, _quiet)
    assert iters == ns["i"] + 1 and len(got_seen) == len(seen)
    for (gc, gi), (c, i) in zip(got_seen, seen):
        np.testing.assert_array_equal(gc, c)
        np.testing.assert_array_equal(gi, i)
    assert best[0] == ns["best"][0]
    np.testing.assert_array_equal(best[1], ns["best"][1])
    assert best[1].dtype == np.float32 and len(got_saved) == len(saved)
    for (g,), (w,) in zip(got_saved, saved):
        np.testing.assert_array_equal(g, w)


def test_joint_loop_draws_and_updates_as_the_script():
    """train_backflip_robust_joint.py's loop: the scenario indices and
    float32 δ in the script's order, the flat update bitwise, the
    (nominal, probe strict, probe score) best and its saves."""
    returns, key, _ = _flat_stubs(10)
    flat0 = (0.1 * np.random.default_rng(10).standard_normal(40)).astype(np.float32)
    args = types.SimpleNamespace(iters=12, n_train=10, train_scen=4, n_dir=3,
                                 delta_std=0.02, step_size=0.015, probe_every=4, n_probe=5)
    seen, rec = _record()
    saved, save = _record()
    ns = dict(np=np, jnp=jnp, args=args, time=time, print=_quiet, flat0=flat0,
              unravel=lambda x: x, save_params=lambda p: save(p),
              ars_returns=lambda cand, idx: (rec(cand, idx), returns(cand, idx))[1],
              eval_train=lambda f: (0.5, 1), eval_probe=lambda f: (key(f)[2], key(f)[1]),
              eval_nom=lambda f: (0.0, key(f)[0]))
    _exec(JOINT, _loop_block(JOINT, "rng"), ns)
    got_seen, got_rec = _record()
    got_saved, got_save = _record()
    best = rj.ars_loop(flat0, args, lambda c, i: (got_rec(c, i), returns(c, i))[1], key,
                       got_save, _quiet)
    assert len(got_seen) == len(seen) == args.iters
    for (gc, gi), (c, i) in zip(got_seen, seen):
        np.testing.assert_array_equal(gc, c)
        np.testing.assert_array_equal(gi, i)
    assert best[0] == ns["best"][0]
    np.testing.assert_array_equal(best[1], ns["best"][1])
    assert len(got_saved) == len(saved)
    for (g,), (w,) in zip(got_saved, saved):
        np.testing.assert_array_equal(g, w)
