"""Parity of the port's control-step modules with the JAX package on the CPU:
the analytic leg kinematics (FK, Jacobian, IK and its round trip) and the
CARTESIAN_PD command, the Butterworth action filter over 20 steps, every
sensor suite's observation and limits, the noise of read_noisy_obs, and the
task state machines (update, reward, termination, end-of-episode reward) of
one task of every kind on a scripted sequence of jumps. Inputs come from a
numpy seed and go to both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.control import interfaces as jci
from quadruped_springs_tpu.models import dynamics as jdyn
from quadruped_springs_tpu.models import go1_params as jgp
from quadruped_springs_tpu.models import kinematics as jkin
from quadruped_springs_tpu.models import spatial as jsp
from quadruped_springs_tpu.ops import action_filter as jaf
from quadruped_springs_tpu.sensors import sensors as jsn
from quadruped_springs_tpu.tasks import tasks as jtk
from quadruped_springs_tpu_torch.control import interfaces as tci
from quadruped_springs_tpu_torch.models import dynamics as tdyn
from quadruped_springs_tpu_torch.models import go1_params as tgp
from quadruped_springs_tpu_torch.models import kinematics as tkin
from quadruped_springs_tpu_torch.models import spatial as tsp
from quadruped_springs_tpu_torch.ops import action_filter as taf
from quadruped_springs_tpu_torch.sensors import sensors as tsn
from quadruped_springs_tpu_torch.tasks import tasks as ttk

t = torch.from_numpy


def _f32(a):
    return np.array(a, np.float32)


# --- kinematics, IK, CARTESIAN_PD -------------------------------------------

def test_kinematics_and_ik_match_jax():
    """FK, Jacobian and feet velocities to 1e-6 (same closed forms in f32);
    the IK (atan2, sqrt of a difference of squares) to 2e-5 rad against JAX,
    and FK(IK(p)) back to p within 2e-6 m over the working range."""
    rng = np.random.default_rng(0)
    init_q = np.asarray(jgp.go1_config(True).init_joint_angles)
    q = _f32(init_q + 0.4 * rng.standard_normal((16, 12)))
    qd = _f32(3.0 * rng.standard_normal((16, 12)))
    legs = q.reshape(16, 4, 3)
    np.testing.assert_allclose(tkin.foot_position(t(legs)), jkin.foot_position(legs),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tkin.foot_jacobian(t(legs)), jkin.foot_jacobian(legs),
                               rtol=1e-6, atol=1e-6)
    for got, want in zip(tkin.foot_pos_and_vel(t(q), t(qd)),
                         jkin.foot_pos_and_vel(q, qd)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    cfg = jgp.go1_config(True)
    lo, hi = np.asarray(cfg.rl_lower_cartesian_pos), np.asarray(cfg.rl_upper_cartesian_pos)
    feet = _f32(lo + rng.uniform(0, 1, (16, 12)) * (hi - lo))
    q_ik = tkin.inverse_kinematics_flat(t(feet))
    np.testing.assert_allclose(q_ik, jkin.inverse_kinematics_flat(feet), rtol=0, atol=2e-5)
    back = tkin.foot_position(q_ik.reshape(16, 4, 3)).reshape(16, 12)
    np.testing.assert_allclose(back, feet, rtol=0, atol=2e-6)


@pytest.mark.parametrize("action_mode", ["DEFAULT", "SYMMETRIC", "SYMMETRIC_NO_HIP"])
def test_cartesian_pd_command_matches_jax(action_mode):
    jif = jci.make_interface(jgp.go1_config(True), "CARTESIAN_PD", action_mode)
    tif = tci.make_interface(tgp.go1_config(True, "cpu"), "CARTESIAN_PD", action_mode)
    a = _f32(np.random.default_rng(1).uniform(-1.2, 1.2, (32, tif.action_dim)))
    got = tci.action_to_command(tif, t(a))
    want = jax.vmap(lambda x: jci.action_to_command(jif, x))(a)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    for name in ("init_action", "landing_action", "settling_action"):
        np.testing.assert_allclose(getattr(tci, name)(tif), getattr(jci, name)(jif),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tci.reference_to_command(tif, tif.init_pose),
                               jci.reference_to_command(jif, jif.init_pose), atol=2e-5)


# --- action filter ------------------------------------------------------------

def test_action_filter_matches_jax_over_20_steps():
    """20 steps of the order-2 IIR from a primed history on 3 environments;
    both sides hold float32 coefficients of the same float64 design."""
    rng = np.random.default_rng(2)
    x0 = _f32(rng.uniform(-1, 1, (3, 6)))
    xs = _f32(rng.uniform(-1, 1, (20, 3, 6)))
    jc, tc = jaf.butter_coeffs(100.0), taf.butter_coeffs(100.0)
    np.testing.assert_array_equal(tc.b, jc.b)
    np.testing.assert_array_equal(tc.a, jc.a)
    js = jax.vmap(lambda a: jaf.filter_reset(6, a))(x0)
    ts = taf.filter_reset(t(x0))
    jstep = jax.jit(jax.vmap(lambda s, x: jaf.filter_step(jc, s, x)))
    for x in xs:
        js, jy = jstep(js, x)
        ts, ty = taf.filter_step(tc, ts, t(x))
        np.testing.assert_allclose(ty, jy, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.yhist, js.yhist, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.xhist, js.xhist, rtol=0, atol=0)


# --- sensors ------------------------------------------------------------------

def _robot(n, seed):
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-1.0, 1.0, (n, 3))
    quat = _f32(jsp.rpy_to_quat(rpy))
    init_q = np.asarray(jgp.go1_config(True).init_joint_angles)
    return dict(pos=_f32(rng.uniform(-0.5, 0.5, (n, 3)) + [0, 0, 0.5]), quat=quat,
                lin_vel=_f32(rng.standard_normal((n, 3))),
                ang_vel=_f32(rng.standard_normal((n, 3))),
                q=_f32(init_q + 0.4 * rng.standard_normal((n, 12))),
                qd=_f32(3.0 * rng.standard_normal((n, 12)))), rng


def _contexts(n=8, seed=3):
    d, rng = _robot(n, seed)
    contact = rng.uniform(size=(n, 4)) < 0.5
    switched, jumping = rng.uniform(size=n) < 0.5, rng.uniform(size=n) < 0.5
    jstate = jdyn.RobotState(**{k: jnp.asarray(v) for k, v in d.items()})
    jctx = jax.vmap(lambda r, c, s, j: jsn.make_context(
        r, c, switched_controller=s, is_jumping=j))(
        jstate, jnp.asarray(contact), jnp.asarray(switched), jnp.asarray(jumping))
    tctx = tsn.make_context(tdyn.RobotState(**{k: t(v) for k, v in d.items()}),
                            t(contact), switched_controller=t(switched),
                            is_jumping=t(jumping))
    return jctx, tctx


@pytest.mark.parametrize("suite", sorted(tsn.SUITES))
def test_sensor_suite_matches_jax(suite):
    """Observation and (high, low, noise_std) of every suite. The readings
    are the same f32 closed forms (feet kinematics, rpy, the backflip
    pitch), so they agree to a few ulp."""
    assert tsn.SUITES[suite] == jsn.SUITES[suite]
    jctx, tctx = _contexts()
    got = tsn.read_obs(suite, tctx)
    want = jax.vmap(lambda c: jsn.read_obs(suite, c))(jctx)
    assert got.shape == want.shape == (8, tsn.obs_dim(suite))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for g, w in zip(tsn.obs_limits(suite, tgp.go1_config(True, "cpu")),
                    jsn.obs_limits(suite, jgp.go1_config(True))):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


def test_noisy_obs_std_and_exact_zero_std_entries():
    """read_noisy_obs adds N(0, std²) per entry from the generator: over 20,000
    copies of one context the sample std of every entry is within 3% of the
    suite's std (the estimate's own spread is ~0.5%), its mean within 4
    standard errors of the clean value, the zero-std entries (contact bools,
    the landing flag) pass through exactly, and a reseeded generator repeats
    the draw."""
    suite = "PPO_BASIC_CONTACT"
    _, tctx = _contexts(1)
    n = 20000
    big = dataclasses.replace(tctx, **{f.name: getattr(tctx, f.name).expand(
        (n,) + getattr(tctx, f.name).shape[1:]) for f in dataclasses.fields(tctx)})
    cfg = tgp.go1_config(True, "cpu")
    clean = tsn.read_obs(suite, big)
    noisy = tsn.read_noisy_obs(suite, cfg, big, torch.Generator().manual_seed(0))
    _, _, std = tsn.obs_limits(suite, cfg)
    zero = std == 0
    assert zero.sum() == 5
    assert torch.equal(noisy[:, zero], clean[:, zero])
    sample_std = (noisy - clean)[:, ~zero].std(0)
    np.testing.assert_allclose(sample_std, std[~zero], rtol=0.03)
    mean_err = (noisy - clean)[:, ~zero].mean(0).abs()
    assert torch.all(mean_err < 4 * std[~zero] / n ** 0.5)
    again = tsn.read_noisy_obs(suite, cfg, big, torch.Generator().manual_seed(0))
    assert torch.equal(again, noisy)


# --- tasks --------------------------------------------------------------------

T_STEPS = 60
N_LANES = 3
DEMO_LEN = 20
ACTION_DIM = 6


def _scripted_contexts():
    """Per control step, a TaskCtx of 3 environments whose jumps are out of
    phase: standing, a take-off at vz = 2.5 m/s (past the controller-switch
    threshold), a flight that pitches the trunk through 2π (the backflip
    unwrap), touch-down on two feet, standing, a second short hop, and an
    invalid contact on environment 2's last step."""
    rng = np.random.default_rng(4)
    out = []
    for k in range(T_STEPS):
        pos, vel, rpy, contact = [], [], [], []
        for lane, off in enumerate((0, 7, 15)):
            s = k - off
            if 10 <= s < 25:                        # first flight
                tf = (s - 10) * 0.01
                z, vz, fly = 0.3 + 2.5 * tf - 4.9 * tf ** 2, 2.5 - 9.81 * tf, True
                pitch = 2 * np.pi * (s - 10) / 15
            elif 35 <= s < 40:                      # second, short hop
                tf = (s - 35) * 0.01
                z, vz, fly, pitch = 0.3 + 0.4 * tf, 0.4, True, 0.1
            else:
                z, vz, fly, pitch = 0.3, 0.0, False, 0.05 * np.sin(s)
            x = 0.02 * max(s - 10, 0) if s < 25 else 0.3 + 0.01 * max(s - 35, 0)
            pos.append([x, 0.01 * lane, z])
            vel.append([0.5 if fly else 0.0, 0.0, vz])
            rpy.append([0.02 * lane, pitch, 0.1 * lane])
            contact.append([False] * 4 if fly else
                           ([True, True, False, False] if s in (25, 40) else [True] * 4))
        pos, vel, rpy = _f32(pos), _f32(vel), _f32(rpy)
        contact = np.array(contact)
        quat = _f32(jsp.rpy_to_quat(rpy))
        invalid = np.zeros(N_LANES, bool)
        invalid[2] = k == T_STEPS - 1
        out.append(dict(
            pos=pos, lin_vel=vel, rpy=_f32(jsp.quat_to_rpy(quat)), quat=quat,
            q=_f32(rng.standard_normal((N_LANES, 12))),
            qd=_f32(rng.standard_normal((N_LANES, 12))),
            motor_torques=_f32(10 * rng.standard_normal((N_LANES, 12))),
            feet_in_contact=contact,
            feet_forces=_f32(np.where(contact, rng.uniform(0, 400, (N_LANES, 4)), 0.0)),
            invalid_contact=invalid, sim_time=_f32(np.full(N_LANES, 0.01 * (k + 1))),
            is_flying=~contact.any(-1),
            last_action=_f32(rng.uniform(-1, 1, (N_LANES, ACTION_DIM)))))
    return out


# one task key per TaskDef.kind, plus both continuous state machines and
# the registered names whose rewards are special-cased
TASK_KEYS = ["NO_TASK", "JUMPING_IN_PLACE", "JUMPING_FORWARD", "JUMPING_IN_PLACE_PPO",
             "JUMPING_FORWARD_PPO", "BACKFLIP", "BACKFLIP_PPO",
             "CONTINUOUS_JUMPING_FORWARD", "CONTINUOUS_JUMPING_FORWARD3",
             "CONTINUOUS_JUMPING_FORWARD_PPO", "JUMPING_IN_PLACE_DEMO",
             "CONTINUOUS_JUMPING_FORWARD_DEMO"]


@pytest.mark.parametrize("key", TASK_KEYS)
def test_task_machine_matches_jax(key):
    """Update, reward, termination and end-of-episode reward at every step
    of the scripted sequence, and the final state, against JAX. Same f32
    formulas; the entropy and exp terms differ by a few ulp: 1e-5."""
    jtd, ttd = jtk.get_task(key), ttk.get_task(key)
    assert dataclasses.asdict(jtd) == dataclasses.asdict(ttd)
    demo = _f32(np.random.default_rng(5).uniform(-1, 1, (DEMO_LEN, ACTION_DIM)))
    ctxs = _scripted_contexts()
    fallen = jgp.go1_config(True).is_fallen_height
    jctx = lambda c: jtk.TaskCtx(**{k: jnp.asarray(v) for k, v in c.items()},
                                 is_fallen_height=fallen)
    tctx = lambda c: ttk.TaskCtx(**{k: t(v) for k, v in c.items()},
                                 is_fallen_height=fallen)

    def jstep(ts, c):
        ts = jtk.task_on_step(jtd, ts, c)
        return (ts, jtk.task_reward(jtd, ts, c, jnp.asarray(demo), DEMO_LEN),
                jtk.task_terminated(jtd, ts, c, DEMO_LEN), jtk.task_reward_end(jtd, ts, c))

    jfn = jax.jit(jax.vmap(jstep))
    js = jax.vmap(jtk.init_task_state)(jctx(ctxs[0]))
    ts = ttk.init_task_state(tctx(ctxs[0]))
    for c in ctxs:
        js, jr, jterm, jend = jfn(js, jctx(c))
        tc = tctx(c)
        ts = ttk.task_on_step(ttd, ts, tc)
        tr = ttk.task_reward(ttd, ts, tc, t(demo), DEMO_LEN)
        np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(ttk.task_terminated(ttd, ts, tc, DEMO_LEN), jterm)
        np.testing.assert_allclose(ttk.task_reward_end(ttd, ts, tc), jend,
                                   rtol=1e-5, atol=1e-6)
    for f in dataclasses.fields(ts):
        got, want = getattr(ts, f.name), np.asarray(getattr(js, f.name))
        assert got.dtype == torch.from_numpy(want).dtype, f.name
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f.name)
    if key != "NO_TASK":
        assert bool(ts.switched_controller.all())
    if key == "CONTINUOUS_JUMPING_FORWARD3":
        assert int(ts.jump_counter.sum()) > 0 and float(ts.fwd_array.abs().sum()) > 0
        for lane in range(N_LANES):
            want = jtk.continuous_jump_stats(jax.tree.map(lambda x: x[lane], js))
            assert ttk.continuous_jump_stats(ts, lane) == want


def test_jump_buffers_stop_at_capacity():
    """Past MAX_JUMPS recorded jumps the per-jump buffers are not written
    (each lane at its own count); the streaming sums still grow."""
    td = ttk.get_task("CONTINUOUS_JUMPING_FORWARD3")
    ctxs = _scripted_contexts()
    ts = ttk.init_task_state(ttk.TaskCtx(**{k: t(v) for k, v in ctxs[0].items()}))
    counts = torch.tensor([ttk.MAX_JUMPS - 1, ttk.MAX_JUMPS, 5], dtype=torch.int32)
    ts = dataclasses.replace(ts, jump_counter=counts, first_jump=torch.zeros(3, dtype=bool),
                             all_feet_in_air=torch.ones(3, dtype=bool),
                             max_jump_height=torch.full((3,), 0.4))
    landing = dict(ctxs[30], feet_in_contact=np.ones((3, 4), bool),
                   is_flying=np.zeros(3, bool))
    ts2 = ttk.task_on_step(td, ts, ttk.TaskCtx(**{k: t(v) for k, v in landing.items()}))
    assert torch.equal(ts2.jump_counter, counts + 1)
    written = ts2.performance_array != ts.performance_array
    assert written[0, ttk.MAX_JUMPS - 1] and written[2, 5]
    assert not written[1].any() and written.sum() == 2
    assert torch.all(ts2.perf_sum > ts.perf_sum)


def test_pitch_unwrapped_and_quat_helpers_match_jax():
    d, rng = _robot(32, 6)
    quat, v = d["quat"], _f32(rng.standard_normal((32, 3)))
    switched = rng.uniform(size=32) < 0.5
    np.testing.assert_allclose(tsp.pitch_unwrapped_yxz(t(quat), t(switched)),
                               jsp.pitch_unwrapped_yxz(quat, switched), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tsp.quat_rotate_inv(t(quat), t(v)),
                               jsp.quat_rotate_inv(quat, v), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsp.rpy_to_quat(t(_f32(jsp.quat_to_rpy(quat)))), quat,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsp.safe_norm(torch.zeros(2, 3)), [1e-6, 1e-6], rtol=1e-6)
