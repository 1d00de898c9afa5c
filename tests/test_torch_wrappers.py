"""The port's autopilot wrappers on the CPU against the JAX package's:
LandingWrapperBackflip (both variants), LandingWrapperContinuous (both
hold_landing settings), GoToRestWrapper and RestTruncationWrapper, each over
a short scripted episode from a JAX reset carried across by
``convert.env_state``, on two lanes of which only lane 0 triggers the
autopilot (lane 1 holds the init action).

Control flow is held exactly at every policy step: done flags, controller
switch, wrapper state and the sim-step counters (how many env steps each
lane's autopilot ran). Robot states follow tests/test_torch_env.py: after
hundreds of stiff substeps the two paths differ in the last digits, so the
final base height and joint angles are held to 2e-3 (m, rad).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env import wrappers as jwr
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.env import env as tenv
from quadruped_springs_tpu_torch.env import wrappers as twr
from tests.conftest import env_factory

BASE = dict(enable_springs=True, motor_control_mode="PD", action_space_mode="SYMMETRIC",
            task_env="JUMPING_IN_PLACE", observation_space_mode="ARS_BASIC",
            obs_noise=False, settling_steps=600, max_ep_len=1.0)
_jax_env = env_factory(**BASE)
CROUCH = np.float32([0.0, 0.4, -0.8, 0.0, 0.4, -0.8])
EXTEND = np.float32([0.0, -0.4, 1.0, 0.0, -0.4, 1.0])
FLIP_EXTEND = np.float32([0.0, -0.2, 0.6, 0.0, -0.6, 1.0])
POSE_TOL = 2e-3


def _envs(**kw):
    return _jax_env(**kw), tenv.QuadrupedEnv(tenv.EnvConfig(**dict(BASE, **kw)), device="cpu")


def _reset_both(jenv, seed=0, n=2):
    """Two settled JAX environments and their converted copy."""
    js, jobs = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(seed), n))
    ts = convert.env_state(js)
    return js, jobs, ts, torch.from_numpy(np.asarray(jobs))


def _same_flow(tout, jout, ts, js, step):
    np.testing.assert_array_equal(tout.done, jout.done, err_msg=f"done at step {step}")
    np.testing.assert_array_equal(ts.sim_step_counter, js.sim_step_counter,
                                  err_msg=f"sim steps at step {step}")
    np.testing.assert_array_equal(ts.task.switched_controller, js.task.switched_controller)


def _same_pose(ts, js):
    np.testing.assert_allclose(ts.robot.pos[:, 2], js.robot.pos[:, 2], rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(ts.robot.q, js.robot.q, rtol=0, atol=POSE_TOL)


def test_env_state_carries_every_field_of_a_jax_state():
    jenv, tenv_ = _envs()
    js, jobs, ts, _ = _reset_both(jenv)
    single = convert.env_state(jax.tree.map(lambda x: x[0], js))
    for f in dataclasses.fields(ts):
        got, one, want = getattr(ts, f.name), getattr(single, f.name), getattr(js, f.name)
        if dataclasses.is_dataclass(got):
            for g in dataclasses.fields(got):
                np.testing.assert_array_equal(getattr(got, g.name), getattr(want, g.name))
                assert getattr(one, g.name).shape == getattr(got, g.name)[:1].shape
        else:
            np.testing.assert_array_equal(got, want)
            assert one.shape == got[:1].shape
    assert ts.sim_step_counter.dtype == torch.int32 and ts.feet_in_contact.dtype == torch.bool
    # the converted state steps as the port's own would: same observation
    _, tobs, *_ = tenv_.step(ts, tenv_.get_init_action().expand(2, -1))
    _, jobs2, *_ = jax.vmap(jenv.step)(js, jnp.tile(jenv.get_init_action(), (2, 1)))
    np.testing.assert_allclose(tobs, jobs2, rtol=0, atol=2e-3)


@pytest.mark.parametrize("variant", ["hold", "until_grounded"])
def test_backflip_wrapper_matches_jax(variant):
    """Crouch 12 steps, then a rear-biased extension until the task switches
    (lane 0); lane 1 stands. "hold" runs lane 0 to the episode's end inside
    one wrapper step; "until_grounded" hands back at touch-down with the
    one-shot flag cleared in lane 0 only."""
    kw = dict(task_env="BACKFLIP", observation_space_mode="ARS_BACKFLIP", max_ep_len=1.2)
    jenv, tenv_ = _envs(**kw)
    js, _, ts, _ = _reset_both(jenv, seed=2)
    jw = jwr.LandingWrapperBackflip(jenv, variant)
    tw = twr.LandingWrapperBackflip(tenv_, variant)
    init_a = np.asarray(jenv.get_init_action(), np.float32)
    grounded = variant == "until_grounded"
    if grounded:
        jws = jax.vmap(lambda _: jw.init_state())(jnp.arange(2))
        tws = tw.init_state(2)
        jstep = jax.vmap(lambda s, a, w: jw.step(s, a, w))
    else:
        jstep = jax.vmap(lambda s, a: jw.step(s, a))
    fired = None
    for i in range(40):
        a = np.stack([CROUCH if i < 12 else FLIP_EXTEND, init_a])
        if grounded:
            jout, jws = jstep(js, jnp.asarray(a), jws)
            tout, tws = tw.step(ts, torch.from_numpy(a), wstate=tws)
            np.testing.assert_array_equal(tws.armed, jws.armed)
        else:
            jout = jstep(js, jnp.asarray(a))
            tout = tw.step(ts, torch.from_numpy(a))
        js, ts = jout.state, tout.state
        _same_flow(tout, jout, ts, js, i)
        if bool(ts.task.switched_controller[0]):
            fired = i
            break
    assert fired is not None and not bool(ts.task.switched_controller[1])
    # lane 1 took one env step per policy step; lane 0's autopilot ran on
    assert int(ts.sim_step_counter[1]) == 10 * (fired + 1)
    assert int(ts.sim_step_counter[0]) > int(ts.sim_step_counter[1]) + 50
    if grounded:
        assert tws.armed.tolist() == [False, True]
        assert bool(ts.feet_in_contact[0].any()) or bool(tout.done[0])
    else:
        assert tout.done.tolist() == [True, False]
    _same_pose(ts, js)
    np.testing.assert_allclose(ts.task.max_pitch_bf, js.task.max_pitch_bf, rtol=0, atol=5e-3)
    assert tw.syncs > 0


def test_backflip_take_off_is_a_do_while():
    """With the unwrapped pitch already past 5π/8 at the trigger, the
    take-off phase still takes exactly one step with the take-off action
    (then the landing phase), and an unarmed lane none."""
    env = tenv.QuadrupedEnv(tenv.EnvConfig(**dict(
        BASE, task_env="BACKFLIP", observation_space_mode="ARS_BACKFLIP",
        settling_steps=0, max_ep_len=0.2)), device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(0), 2)
    # both lanes airborne, pitched back by 2.5 rad > 5π/8, controller switched
    half = torch.tensor(-2.5 / 2)
    quat = torch.stack([torch.zeros(()), torch.sin(half), torch.zeros(()), torch.cos(half)])
    state = dataclasses.replace(
        state, robot=dataclasses.replace(state.robot, quat=quat.expand(2, 4).contiguous(),
                                         pos=state.robot.pos + torch.tensor([0.0, 0.0, 0.5])),
        task=dataclasses.replace(state.task,
                                 switched_controller=torch.tensor([True, True])))
    actions = []
    step = env.step
    env.step = lambda s, a, *r, **k: (actions.append(a.clone()), step(s, a, *r, **k))[1]
    w = twr.LandingWrapperBackflip(env, "until_grounded")
    a = env.get_init_action().expand(2, -1)
    out, ws = w.step(state, a, wstate=twr.BackflipLandingState(torch.tensor([True, False])))
    take_off = torch.tensor(w.TAKE_OFF_ACTION)
    n_take_off = sum(bool((x[0] == take_off).all()) for x in actions)
    assert n_take_off == 1 and len(actions) > 2
    assert ws.armed.tolist() == [False, False]
    # the unarmed lane took the policy step alone
    assert out.state.sim_step_counter.tolist()[1] == 10 < out.state.sim_step_counter.tolist()[0]


@pytest.mark.parametrize("hold_landing", [True, False])
def test_continuous_wrapper_matches_jax(hold_landing):
    """A relaxation oscillator (crouch until the thigh is deep, then extend)
    hops lane 0 through the per-jump autopilot; lane 1 stands. The wrapper
    arms again after every step."""
    kw = dict(task_env="CONTINUOUS_JUMPING_FORWARD3",
              observation_space_mode="PPO_CONTINUOUS_JUMPING_FORWARD", max_ep_len=4.0)
    jenv, tenv_ = _envs(**kw)
    js, jobs, ts, tobs = _reset_both(jenv, seed=3)
    jw = jwr.LandingWrapperContinuous(jenv, hold_landing)
    tw = twr.LandingWrapperContinuous(tenv_, hold_landing)
    jws = jax.vmap(lambda _: jw.init_state())(jnp.arange(2))
    tws = tw.init_state(2)
    jstep = jax.vmap(jw.step)
    init_a = np.asarray(jenv.get_init_action(), np.float32)

    def policy(obs):
        return np.stack([EXTEND if float(obs[0, 1]) > 0.95 else CROUCH, init_a])

    for i in range(62):
        jout, jws = jstep(js, jws, jnp.asarray(policy(np.asarray(jobs))))
        tout, tws = tw.step(ts, tws, torch.from_numpy(policy(tobs.numpy())))
        js, jobs, ts, tobs = jout.state, jout.obs, tout.state, tout.obs
        _same_flow(tout, jout, ts, js, i)
        np.testing.assert_array_equal(ts.task.jump_counter, js.task.jump_counter)
        assert tws.armed.tolist() == [True, True]
        if bool(tout.done.any()):
            break
    assert int(ts.task.jump_counter[0]) >= 1 and int(ts.task.jump_counter[1]) == 0
    assert int(ts.sim_step_counter[0]) > int(ts.sim_step_counter[1])
    assert int(ts.sim_step_counter[1]) == 10 * (i + 1)
    _same_pose(ts, js)


def test_go_to_rest_wrapper_matches_jax():
    """With the jumped latch forced in lane 0, a crouch then a release makes
    a grounded, rising robot: the rest condition fires there, the ramp and
    the hold run lane 0 to the episode's end (1 s) and drive its joints to
    the init pose; lane 1, never latched, takes single steps."""
    jenv, tenv_ = _envs()
    js, _, ts, _ = _reset_both(jenv, seed=1)
    latch = np.array([True, False])
    js = js.replace(task=js.task.replace(switched_controller=jnp.asarray(latch)))
    ts = dataclasses.replace(ts, task=dataclasses.replace(
        ts.task, switched_controller=torch.from_numpy(latch)))
    jw, tw = jwr.GoToRestWrapper(jenv), twr.GoToRestWrapper(tenv_)
    assert tw.n_ramp == jw.n_ramp == 100
    jws, tws = jax.vmap(jw.init_state)(js), tw.init_state(ts)
    jstep = jax.vmap(jw.step)
    release = np.float32([0.0, -0.1, 0.2, 0.0, -0.1, 0.2])
    for i in range(20):
        a = np.tile(CROUCH if i < 10 else release, (2, 1))
        jout, jws = jstep(js, jws, jnp.asarray(a))
        tout, tws = tw.step(ts, tws, torch.from_numpy(a))
        # the rest condition on the same inputs
        np.testing.assert_array_equal(
            tw.rest_condition(tws.h_prev - 0.01, tout),
            jax.vmap(jw.rest_condition)(jws.h_prev - 0.01, jout))
        js, ts = jout.state, tout.state
        _same_flow(tout, jout, ts, js, i)
        np.testing.assert_allclose(tws.h_prev, jws.h_prev, rtol=0, atol=POSE_TOL)
        if bool(tout.done[0]):
            break
    assert tout.done.tolist() == [True, False] and i >= 10
    assert int(ts.sim_step_counter[1]) == 10 * (i + 1)
    assert int(ts.sim_step_counter[0]) > 1000
    _same_pose(ts, js)
    err = (ts.robot.q[0] - tenv_.cfg.init_joint_angles).abs().max()
    assert float(err) < 0.4


def test_rest_phase_alone_and_rest_truncation_match_jax():
    """`rest_phase` entered directly (no trigger) on both lanes, for 0.3 s of
    episode; and RestTruncationWrapper's done flag on a latched lane during
    the grounded recovery, with its attribute delegation."""
    kw = dict(task_env="JUMPING_IN_PLACE_PPO", max_ep_len=0.3)
    jenv, tenv_ = _envs(**kw)
    js, _, ts, _ = _reset_both(jenv, seed=4)
    start = np.tile(CROUCH, (2, 1))
    jout = jax.vmap(lambda s, a: jwr.GoToRestWrapper(jenv).rest_phase(s, a))(
        js, jnp.asarray(start))
    tout = twr.GoToRestWrapper(tenv_).rest_phase(ts, torch.from_numpy(start))
    assert tout.done.tolist() == [True, True]
    _same_flow(tout, jout, tout.state, jout.state, 0)
    _same_pose(tout.state, jout.state)

    latch = np.array([True, False])
    js = js.replace(task=js.task.replace(switched_controller=jnp.asarray(latch)))
    ts = dataclasses.replace(ts, task=dataclasses.replace(
        ts.task, switched_controller=torch.from_numpy(latch)))
    jw, tw = jwr.RestTruncationWrapper(jenv), twr.RestTruncationWrapper(tenv_)
    assert tw.action_dim == tenv_.action_dim and tw.obs_dim == tenv_.obs_dim
    jstep = jax.jit(jax.vmap(jw.step))
    init_a = np.asarray(jenv.get_init_action(), np.float32)
    small = np.float32([0.0, 0.2, -0.4, 0.0, 0.2, -0.4])
    truncated = []
    for i in range(20):
        a = np.tile(small if i < 10 else init_a, (2, 1))
        js, _, jr, jd, _ = jstep(js, jnp.asarray(a))
        ts, _, tr, td, _ = tw.step(ts, torch.from_numpy(a))
        np.testing.assert_array_equal(td, jd, err_msg=f"step {i}")
        np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-5)
        truncated.append(td.tolist())
    assert any(t[0] for t in truncated) and not any(t[1] for t in truncated)


def test_wrappers_reject_what_the_jax_ones_reject():
    env = tenv.QuadrupedEnv(tenv.EnvConfig(**dict(
        BASE, task_env="BACKFLIP", observation_space_mode="ARS_BACKFLIP",
        action_space_mode="DEFAULT")), device="cpu")
    with pytest.raises(ValueError, match="SYMMETRIC"):
        twr.LandingWrapperBackflip(env)
    sym = tenv.QuadrupedEnv(tenv.EnvConfig(**BASE), device="cpu")
    with pytest.raises(ValueError, match="variant"):
        twr.LandingWrapperBackflip(sym, "peak_timer")
    with pytest.raises(ValueError, match="variant"):
        twr.LandingWrapper(sym, "hold")
