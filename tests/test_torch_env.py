"""The port's environment slice end to end on the CPU, against the JAX
package: QuadrupedEnv.reset through the desired-robot-state path on
JAX-sampled scenarios and single control steps after it (the PD, CARTESIAN_PD
with filter and interpolation, and non-RL TORQUE modes), a short settle
held to the standing KPIs, the LandingWrapper on a crouch-then-extend
episode, the per-environment masking of the wrapper's loops, and the
env_bench entry point at a tiny size.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env import wrappers as jwr
from quadruped_springs_tpu.models import dynamics as jdyn
from quadruped_springs_tpu_torch import convert, env_bench
from quadruped_springs_tpu_torch.env import env as tenv
from quadruped_springs_tpu_torch.env import wrappers as twr
from quadruped_springs_tpu_torch.models import dynamics as tdyn
from tests.conftest import env_factory

N = 3
BASE = dict(enable_springs=True, motor_control_mode="PD", action_space_mode="SYMMETRIC",
            task_env="JUMPING_IN_PLACE", observation_space_mode="ARS_BASIC",
            obs_noise=False)
_jax_env = env_factory(**BASE)


def _port_env(**kw):
    return tenv.QuadrupedEnv(tenv.EnvConfig(**dict(BASE, **kw)), device="cpu")


def _standing_states(seed, n=N):
    """Near the settled stance: feet pressed ~2 mm into the ground, joints
    and velocities perturbed."""
    rng = np.random.default_rng(seed)
    init_q = np.array([0.0, np.pi / 4, -np.pi / 2] * 4)
    f32 = lambda a: np.asarray(a, np.float32)
    quat = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)) + 0.02 * rng.standard_normal((n, 4))
    return dict(pos=f32(np.array([0.0, 0.0, 0.326]) + [0.01, 0.01, 0.002]
                        * rng.standard_normal((n, 3))),
                quat=f32(quat / np.linalg.norm(quat, axis=-1, keepdims=True)),
                lin_vel=f32(0.1 * rng.standard_normal((n, 3))),
                ang_vel=f32(0.1 * rng.standard_normal((n, 3))),
                q=f32(init_q + 0.05 * rng.standard_normal((n, 12))),
                qd=f32(0.5 * rng.standard_normal((n, 12))))


def _both_reset(jenv, tenv_, d, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    js, jobs = jax.vmap(lambda k, s: jenv.reset(k, desired_robot_state=s))(
        keys, jdyn.RobotState(**{k: jnp.asarray(v) for k, v in d.items()}))
    ts, tobs = tenv_.reset(scenario=convert.scenario_params(js.scenario),
                           desired_robot_state=tdyn.RobotState(
                               **{k: torch.from_numpy(v) for k, v in d.items()}))
    return js, jobs, ts, tobs


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=err_msg, **tol)


# After one control step (10 substeps at 180 kN/m) the two implementations
# differ by the f32 rounding of the 18x18 solves (qdd ~1e-4 relative in
# stiff contact, tests/test_torch_dynamics.py), integrated ten times. On
# these inputs: positions and angles within 1e-6, joint velocities within
# 6.4e-4 rad/s, anchors within 2.6e-7 m, contact forces within 0.016 N over
# three steps; the bounds below sit 5-20x above that, per step taken.
TOL_STEP = {"pos": 5e-6, "quat": 5e-6, "q": 5e-6, "lin_vel": 2e-3, "ang_vel": 2e-3,
            "qd": 2e-3}


def _compare_env_state(ts, js, scale=1.0):
    for f, tol in TOL_STEP.items():
        _close(getattr(ts.robot, f), getattr(js.robot, f), f, rtol=0, atol=tol * scale)
    _close(ts.foot_anchor, js.foot_anchor, "foot_anchor", rtol=0, atol=2e-6 * scale)
    _close(ts.feet_forces, js.feet_forces, "feet_forces", rtol=1e-3, atol=0.5 * scale)
    _close(ts.observed_torques, js.observed_torques, "tau_m", rtol=0, atol=0.05 * scale)
    for f in ("feet_in_contact", "invalid_contact", "sim_step_counter",
              "env_step_counter"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f)
    assert ts.sim_step_counter.dtype == torch.int32


def test_reset_then_steps_match_jax():
    """Reset through desired_robot_state on JAX-sampled GROUND_RANDOMIZER
    scenarios (friction per environment), then 3 control steps of random
    actions: states, anchors, contact, counters, observation, reward, done
    and the task trackers. The tolerance widens with the step count, since
    stiff contact carries each step's rounding into the next."""
    jenv, tenv_ = _jax_env(), _port_env()
    d = _standing_states(0)
    js, jobs, ts, tobs = _both_reset(jenv, tenv_, d)
    _close(tobs, jobs, rtol=0, atol=1e-6)
    _close(ts.foot_anchor, js.foot_anchor, rtol=0, atol=1e-7)
    _close(ts.feet_forces, js.feet_forces, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(ts.feet_in_contact, js.feet_in_contact)
    assert bool(ts.feet_in_contact.any())
    for f in dataclasses.fields(ts.task):
        _close(getattr(ts.task, f.name), getattr(js.task, f.name), f.name, rtol=0, atol=1e-6)
    rng = np.random.default_rng(1)
    jstep = jax.jit(jax.vmap(jenv.step))
    for k in range(1, 4):
        a = rng.uniform(-1, 1, (N, tenv_.action_dim)).astype(np.float32)
        js, jobs, jr, jd, jinfo = jstep(js, jnp.asarray(a))
        ts, tobs, tr, td, tinfo = tenv_.step(ts, torch.from_numpy(a))
        _compare_env_state(ts, js, scale=k)
        _close(tobs, jobs, rtol=0, atol=2e-3 * k)
        _close(tr, jr, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(td, jd)
        _close(tinfo["mean_motor_torque"], jinfo["mean_motor_torque"], rtol=0,
               atol=0.05 * k)
        for f in ("relative_max_height", "max_height", "init_height"):
            _close(getattr(ts.task, f), getattr(js.task, f), f, rtol=0, atol=2e-5 * k)


MODES = {
    # CARTESIAN_PD through the IK, with the Butterworth filter and the
    # per-substep interpolation of the command
    "cartesian_filter_interp": (dict(motor_control_mode="CARTESIAN_PD",
                                     enable_action_filter=True,
                                     enable_action_interpolation=True), False),
    # the non-RL TORQUE interface: raw torques plus the springs
    "torque_non_rl": (dict(motor_control_mode="TORQUE", is_rl_gym_interface=False,
                           action_space_mode="DEFAULT", task_env="NO_TASK"), False),
    # PD without springs, with the landing gains and a push on the trunk
    "pd_gains_push": (dict(enable_springs=False, action_space_mode="DEFAULT",
                           task_env="JUMPING_FORWARD_PPO"), True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_one_step_in_each_mode_matches_jax(mode):
    kw, push = MODES[mode]
    jenv, tenv_ = _jax_env(**kw), _port_env(**kw)
    js, _, ts, _ = _both_reset(jenv, tenv_, _standing_states(2), seed=3)
    rng = np.random.default_rng(4)
    if kw.get("motor_control_mode") == "TORQUE":
        a = rng.uniform(-5, 5, (N, 12)).astype(np.float32)
    else:
        a = rng.uniform(-1, 1, (N, tenv_.action_dim)).astype(np.float32)
    extra_j, extra_t = {}, {}
    if push:
        gains = [np.full(12, 60.0, np.float32), np.full(12, 1.5, np.float32)]
        force = np.array([30.0, -20.0, 10.0], np.float32)
        extra_j = dict(kp=jnp.asarray(gains[0]), kd=jnp.asarray(gains[1]),
                       ext_force_world=jnp.asarray(force))
        extra_t = dict(kp=torch.from_numpy(gains[0]), kd=torch.from_numpy(gains[1]),
                       ext_force_world=torch.from_numpy(force))
    js, jobs, jr, jd, _ = jax.jit(jax.vmap(lambda s, x: jenv.step(s, x, **extra_j)))(
        js, jnp.asarray(a))
    ts, tobs, tr, td, _ = tenv_.step(ts, torch.from_numpy(a), **extra_t)
    _compare_env_state(ts, js)
    _close(ts.spring_torques, js.spring_torques, rtol=0, atol=0.05)
    _close(ts.last_filtered_action, js.last_filtered_action, rtol=0, atol=1e-6)
    _close(ts.filter_state.yhist, js.filter_state.yhist, rtol=0, atol=1e-6)
    _close(tobs, jobs, rtol=0, atol=2e-3)
    _close(tr, jr, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(td, jd)


def test_demo_task_from_an_rsi_start_matches_jax():
    """An imitation task spawned mid-demo (reset's demo_start_idx): the
    demo counter starts at the spawn index, each step is scored against the
    matching demo action and normalised by the remaining demo steps, and
    the episode terminates at the demo's end."""
    from quadruped_springs_tpu.env.env import EnvConfig, QuadrupedEnv

    kw = dict(BASE, task_env="JUMPING_IN_PLACE_DEMO")
    demo = np.random.default_rng(8).uniform(-1, 1, (12, 6)).astype(np.float32)
    jenv = QuadrupedEnv(EnvConfig(**kw), demo_actions=jnp.asarray(demo))
    tenv_ = tenv.QuadrupedEnv(tenv.EnvConfig(**kw), demo_actions=torch.from_numpy(demo), device="cpu")
    d = _standing_states(5)
    keys = jax.random.split(jax.random.PRNGKey(9), N)
    js, _ = jax.vmap(lambda k, s: jenv.reset(k, desired_robot_state=s, demo_start_idx=9))(
        keys, jdyn.RobotState(**{k: jnp.asarray(v) for k, v in d.items()}))
    ts, _ = tenv_.reset(scenario=convert.scenario_params(js.scenario), demo_start_idx=9,
                        desired_robot_state=tdyn.RobotState(
                            **{k: torch.from_numpy(v) for k, v in d.items()}))
    assert ts.task.demo_counter.tolist() == [9] * N
    jstep = jax.jit(jax.vmap(jenv.step))
    for k in range(3):
        a = demo[9 + k] + np.float32(0.1 * k)
        a = np.tile(a, (N, 1))
        js, _, jr, jd, _ = jstep(js, jnp.asarray(a))
        ts, _, tr, td, _ = tenv_.step(ts, torch.from_numpy(a))
        _close(tr, jr, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(td, jd)
    assert bool(td.all()) and int(ts.task.demo_counter[0]) == 12


def test_short_settle_holds_standing_kpis():
    """A 100-substep settle from the initial pose on JAX-sampled scenarios:
    the robots drop onto their feet. Over 100 stiff substeps the paths
    drift apart in the last digits, so the port is held to the KPIs: every
    foot in contact and no other site, base height within 1 mm of JAX's and
    in the standing band of tests/test_env.py (0.25, 0.36), anchors within
    0.1 mm of JAX's."""
    jenv, tenv_ = _jax_env(settling_steps=100), _port_env(settling_steps=100)
    keys = jax.random.split(jax.random.PRNGKey(7), N)
    js, _ = jax.vmap(jenv.reset)(keys)
    ts, _ = tenv_.reset(scenario=convert.scenario_params(js.scenario))
    assert bool(ts.feet_in_contact.all()) and not bool(ts.invalid_contact.any())
    np.testing.assert_array_equal(ts.feet_in_contact, js.feet_in_contact)
    z = ts.robot.pos[:, 2]
    assert bool(((z > 0.25) & (z < 0.36)).all())
    _close(z, js.robot.pos[:, 2], rtol=0, atol=1e-3)
    _close(ts.foot_anchor, js.foot_anchor, rtol=0, atol=1e-4)
    _close(ts.robot.q, js.robot.q, rtol=0, atol=1e-2)


CROUCH = [0.0, 0.4, -0.8, 0.0, 0.4, -0.8]
EXTEND = [0.0, -0.4, 1.0, 0.0, -0.4, 1.0]


@pytest.mark.parametrize("variant", ["peak_timer", "until_grounded"])
def test_landing_wrapper_episode_matches_jax(variant):
    """The examples/run_episode.py flow on 2 environments: settle, crouch for
    30 steps, extend until done, through LandingWrapper, with the episode
    cut to 1.5 s (past the landing) to bound the test's time. Hundreds of
    stiff substeps separate the paths in the last digits, so the port is
    held to the episode's KPIs: the jump (max relative height > 0.2 m, within
    1 mm of JAX's; 0.469 m measured, 2e-5 m apart), the controller switch,
    the control step the episode ends at, and a final height within 1 mm of
    JAX's."""
    kw = dict(settling_steps=600, max_ep_len=1.5)
    jenv, tenv_ = _jax_env(**kw), _port_env(**kw)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    js, _ = jax.vmap(jenv.reset)(keys)
    ts, _ = tenv_.reset(scenario=convert.scenario_params(js.scenario))
    jw, tw = jwr.LandingWrapper(jenv, variant), twr.LandingWrapper(tenv_, variant)
    jstep = jax.vmap(jw.step)
    ends_j, ends_t = [None, None], [None, None]
    for k in range(120):
        a = np.tile(np.float32(CROUCH if k < 30 else EXTEND), (2, 1))
        jout = jstep(js, jnp.asarray(a))
        tout = tw.step(ts, torch.from_numpy(a))
        js, ts = jout.state, tout.state
        for i in range(2):
            if ends_j[i] is None and bool(jout.done[i]):
                ends_j[i] = k
            if ends_t[i] is None and bool(tout.done[i]):
                ends_t[i] = k
        if all(e is not None for e in ends_j + ends_t):
            break
    assert ends_t == ends_j and None not in ends_t
    assert bool(ts.task.switched_controller.all())
    np.testing.assert_array_equal(ts.task.switched_controller, js.task.switched_controller)
    assert bool((tout.max_height > 0.2).all())
    _close(tout.max_height, jout.max_height, rtol=0, atol=1e-3)
    _close(ts.robot.pos[:, 2], js.robot.pos[:, 2], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ts.sim_step_counter, js.sim_step_counter)
    assert tw.syncs > 0
    metrics = twr.episode_metrics(torch.stack([tout.reward, tout.reward]),
                                  {"max_height": torch.stack([tout.max_height] * 2),
                                   "max_fwd": torch.stack([tout.max_fwd] * 2),
                                   "feet_forces": torch.stack([ts.feet_forces] * 2)})
    _close(metrics["return"], 2 * tout.reward.numpy(), rtol=1e-6)
    want = jwr.episode_metrics(jnp.stack([jout.reward[0]] * 2),
                               {"max_height": jnp.stack([jout.max_height[0]] * 2),
                                "max_fwd": jnp.stack([jout.max_fwd[0]] * 2),
                                "feet_forces": jnp.stack([js.feet_forces[0]] * 2)})
    _close(metrics["max_height"][0], want["max_height"], rtol=0, atol=1e-3)


def test_wrapper_masks_environments_outside_the_loop():
    """An environment whose controller has not switched does not advance
    while the wrapper runs another environment's landing loop: its
    counters, anchors, task state and observation stay those of the single
    env.step it took."""
    env = _port_env(settling_steps=0, max_ep_len=0.3)
    state, _ = env.reset(torch.Generator().manual_seed(0), 2)
    # lane 0 is mid-flight going up with the controller switched; lane 1 stands
    task = dataclasses.replace(state.task, switched_controller=torch.tensor([True, False]))
    robot = dataclasses.replace(state.robot, pos=state.robot.pos + torch.tensor(
        [[0.0, 0.0, 0.3], [0.0, 0.0, 0.0]]))
    state = dataclasses.replace(state, task=task, robot=robot)
    a = env.get_init_action().expand(2, -1)
    single = env.step(state, a)
    out = twr.LandingWrapper(env).step(state, a)
    assert bool(out.done[0]) and int(out.state.sim_step_counter[0]) > 300
    for name in ("sim_step_counter", "foot_anchor", "feet_forces"):
        assert torch.equal(getattr(out.state, name)[1], getattr(single[0], name)[1])
    assert torch.equal(out.obs[1], single[1][1])
    assert torch.equal(out.state.task.relative_max_height[1],
                       single[0].task.relative_max_height[1])


def test_obs_noise_needs_a_generator_and_a_step_counter_of_int32():
    env = tenv.QuadrupedEnv(tenv.EnvConfig(**dict(BASE, obs_noise=True, settling_steps=0)),
                             device="cpu")
    with pytest.raises(ValueError, match="generator"):
        env.reset(n=2)
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen, 2)
    with pytest.raises(ValueError, match="generator"):
        env.step(state, env.get_init_action().expand(2, -1))
    state, obs2, *_ = env.step(state, env.get_init_action().expand(2, -1), gen)
    assert obs2.shape == (2, env.obs_dim) and state.sim_step_counter.dtype == torch.int32


def test_env_bench_main_tiny_on_cpu(capsys):
    rec = env_bench.main(["--device", "cpu", "--batch", "2", "--settle", "20",
                          "--steps", "2", "--segments", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "sim_steps_per_s", "realtime_factor", "reset_s"}
    assert "on cpu" in line["metric"] and "batch 2" in line["metric"]
    assert line["sim_steps_per_s"] > 0
    np.testing.assert_allclose(line["realtime_factor"], line["sim_steps_per_s"] * 1e-3)
    assert int(rec["state"].sim_step_counter[0]) == 2 * 2 * 10
