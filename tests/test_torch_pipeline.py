"""The port's demo pipeline, autopilot adapters, CPG, control utilities and
trajectory store on the CPU against the JAX package. Tolerances are stated
at each comparison; closed-loop pieces run a few control steps from a JAX
reset carried across by ``convert.env_state`` and hold phases, counters and
flags exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.control import cpg as jcpg
from quadruped_springs_tpu.control import utils as jcu
from quadruped_springs_tpu.env import continuous_autopilot as jca
from quadruped_springs_tpu.env import demo_pipeline as jdp
from quadruped_springs_tpu.env import flat_rollout as jfr
from quadruped_springs_tpu.models.go1_params import go1_config as jgo1_config
from quadruped_springs_tpu.runtime import trajstore as jts
from quadruped_springs_tpu.train import bc as jbc
from quadruped_springs_tpu.train import networks as jnets
from quadruped_springs_tpu.train import normalize as jnorm
from quadruped_springs_tpu.utils import demo as jdemo
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.control import cpg as tcpg
from quadruped_springs_tpu_torch.control import utils as tcu
from quadruped_springs_tpu_torch.env import continuous_autopilot as tca
from quadruped_springs_tpu_torch.env import demo_pipeline as tdp
from quadruped_springs_tpu_torch.env import env as tenv
from quadruped_springs_tpu_torch.env import flat_rollout as tfr
from quadruped_springs_tpu_torch.models.go1_params import go1_config as tgo1_config
from quadruped_springs_tpu_torch.runtime import trajstore as tts
from quadruped_springs_tpu_torch.train import bc as tbc
from quadruped_springs_tpu_torch.train import normalize as tnorm
from quadruped_springs_tpu_torch.train.networks import MLPPolicy, linear_policy_apply
from quadruped_springs_tpu_torch.utils import demo as tdemo
from tests.conftest import env_factory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_JIP = os.path.join(ROOT, "examples", "out", "demo_jip_0.qsts")
BASE = dict(enable_springs=True, motor_control_mode="PD", action_space_mode="SYMMETRIC",
            task_env="JUMPING_IN_PLACE", observation_space_mode="ARS_BASIC",
            obs_noise=False, settling_steps=600, max_ep_len=2.0)
_jax_env = env_factory(**BASE)
CROUCH = np.float32([0.0, 0.4, -0.8, 0.0, 0.4, -0.8])
EXTEND = np.float32([0.0, -0.4, 1.0, 0.0, -0.4, 1.0])


def _envs(**kw):
    return _jax_env(**kw), tenv.QuadrupedEnv(tenv.EnvConfig(**dict(BASE, **kw)), device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, err_msg="", **tol):
    got = got.detach() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=err_msg, **tol)


# -- trajectory store and demo rows -------------------------------------------

def test_trajstore_reads_what_the_jax_binding_wrote_and_the_reverse(tmp_path):
    rows = np.random.default_rng(0).standard_normal((37, 44)).astype(np.float32)
    a, b = str(tmp_path / "jax.qsts"), str(tmp_path / "port.qsts")
    jts.write(a, rows)
    tts.write(b, rows)
    np.testing.assert_array_equal(tts.read(a), rows)
    np.testing.assert_array_equal(jts.read(b), rows)
    assert open(a, "rb").read() == open(b, "rb").read()
    committed = tts.read(DEMO_JIP)
    np.testing.assert_array_equal(committed, jts.read(DEMO_JIP))
    assert committed.shape == (185, 44) and committed.dtype == np.float32
    # a damaged payload fails the CRC; a file that is no store fails to open
    raw = bytearray(open(b, "rb").read())
    raw[-1] ^= 0xFF
    open(b, "wb").write(raw)
    with pytest.raises(IOError, match="CRC"):
        tts.read(b)
    assert tts.read(b, verify=False).shape == (37, 44)
    with pytest.raises(IOError, match="cannot open"):
        tts.read(str(tmp_path / "missing.qsts"))
    with pytest.raises(ValueError, match=r"\(T, C\)"):
        tts.write(b, rows[0])


def test_demo_rows_split_and_gather_as_jax():
    demo = tts.read(DEMO_JIP)
    parts = tdemo.read_demo(_t(demo), 6)
    for got, want in zip(parts, jax.vmap(lambda r: jdemo.read_demo(r, 6))(jnp.asarray(demo))):
        _close(got, want, rtol=0, atol=0)
    idx = np.array([0, 17, 184, 17])
    rs = tdemo.demo_robot_state(_t(demo), _t(idx), 6)
    want = jax.vmap(lambda i: jdemo.demo_robot_state(jnp.asarray(demo), i, 6))(
        jnp.asarray(idx))
    for f in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        _close(getattr(rs, f), getattr(want, f), f, rtol=0, atol=0)
    assert tdemo.demo_robot_state(_t(demo), 5, 6).q.shape == (1, 12)
    row = tdemo.demo_row(parts[0][idx], rs, _t(demo[idx, -1]) > 0.5)
    _close(row, demo[idx], rtol=0, atol=0)
    _close(tdemo.demo_actions(_t(demo), 6), jdemo.demo_actions(jnp.asarray(demo), 6))


def test_demo_library_roundtrip(tmp_path):
    rows = torch.randn(9, 44)
    valid = torch.tensor([True] * 6 + [False] * 3)
    path = str(tmp_path / "lib.qsts")
    tdp.save_demo_library(path, rows, valid)
    back = tdp.load_demo_library(path, "cpu")
    assert torch.equal(back, rows[:6])
    _close(back, jdp.load_demo_library(path), rtol=0, atol=0)
    tdemo.save_demo(str(tmp_path / "rows.npy"), rows)
    _close(tdemo.load_demo(str(tmp_path / "rows.npy")), rows)


# -- demo collection and behaviour cloning ------------------------------------

@pytest.mark.parametrize("autopilot", [True, False])
def test_collect_demo_rows_match_jax(autopilot):
    """10 control steps of a linear expert from a JAX reset: rows (filtered
    action, robot state after the step, landing flag) to the tolerances of
    a few control steps (positions 1e-5 per step, velocities 2e-3 per step),
    validity exact."""
    jenv, tenv_ = _envs()
    key = jax.random.PRNGKey(0)
    # a weak feedback: a strong one on the joint velocities amplifies the
    # last digits fourfold per step
    W = (0.01 * np.random.default_rng(1).standard_normal((6, jenv.obs_dim))).astype(
        np.float32)
    jrows, jvalid, jstate = jax.jit(lambda k: jdp.collect_demo(
        jenv, lambda o: jnets.linear_policy_apply(jnp.asarray(W), o), k, max_steps=10,
        autopilot=autopilot))(key)
    js0, jobs0 = jenv.reset(key)
    trows, tvalid, tstate = tdp.collect_demo(
        tenv_, lambda o: linear_policy_apply(_t(W), o), max_steps=10, autopilot=autopilot,
        start=(convert.env_state(js0), _t(jobs0)[None]))
    assert trows.shape == (10, 1, 44) and bool(tvalid.all())
    np.testing.assert_array_equal(tvalid[:, 0], jvalid)
    steps = np.arange(1, 11)[:, None]
    err = np.abs(trows[:, 0].numpy() - np.asarray(jrows)) / steps
    for name, cols, tol in (("action", slice(0, 6), 1e-4), ("q", slice(6, 18), 1e-5),
                            ("qd", slice(18, 30), 2e-3), ("pose", slice(30, 37), 1e-5),
                            ("velocity", slice(37, 43), 2e-3)):
        assert err[:, cols].max() <= tol, (name, err[:, cols].max())
    np.testing.assert_array_equal(trows[:, 0, 43], jrows[:, 43])
    np.testing.assert_array_equal(tstate.sim_step_counter, [int(jstate.sim_step_counter)])


def test_collect_demo_autopilot_lands_and_rests_a_jump():
    """The whole mode machine on the port: a crouch-then-extend expert jumps;
    the autopilot takes over at take-off (the landing flag rises), holds the
    crouch landing pose and ramps to rest; two lanes with different
    frictions, batched."""
    env = tenv.QuadrupedEnv(tenv.EnvConfig(**BASE), device="cpu")
    t = [0]

    def expert(obs):
        t[0] += 1
        return _t(CROUCH if t[0] <= 30 else EXTEND).expand(obs.shape[0], -1)

    rows, valid, state = tdp.collect_demo(env, expert, torch.Generator().manual_seed(0), n=2,
                                          max_steps=200)
    landing = rows[..., -1]
    assert bool(state.task.switched_controller.all())
    assert bool((landing.sum(0) > 50).all()) and not bool(landing[:30].any())
    # the flag latches: once set it stays
    assert bool((landing[1:] >= landing[:-1]).all())
    assert bool((state.task.relative_max_height > 0.2).all())
    assert bool(valid[:100].all())


def test_bc_dataset_causal_pairing_and_fit_on_a_committed_demo():
    """demo_dataset on examples/out/demo_jip_0.qsts against JAX: observation
    t is the robot state of row t-1 (the reset state for t = 0), paired with
    action t, to 1e-5; fit lowers the regression loss and leaves the critic
    and sets log_std as JAX's does."""
    demo = tts.read(DEMO_JIP)[:12]
    kw = dict(settling_steps=50)
    jenv, tenv_ = _envs(**kw)
    jobs, jacts = jbc.demo_dataset(jenv, jnp.asarray(demo), jax.random.PRNGKey(0))
    # the port's reset draws its own friction, which no ARS_BASIC observation
    # of a fresh reset shows apart from the settled pose: give it JAX's
    tobs, tacts = tbc.demo_dataset(tenv_, _t(demo), torch.Generator().manual_seed(0))
    assert tobs.shape == (12, tenv_.obs_dim) and tacts.shape == (12, 6)
    _close(tacts, jacts, rtol=0, atol=0)
    _close(tobs[1:], jobs[1:], rtol=0, atol=1e-5)
    _close(tobs[0], jobs[0], rtol=0, atol=5e-2)      # two settles on two frictions
    # the pairing: observation 1 shows row 0's joint angles
    _close(tobs[1, :12], demo[0, 6:18], rtol=0, atol=1e-6)

    net = MLPPolicy(tenv_.obs_dim, 6, (16, 16), generator=torch.Generator().manual_seed(1))
    critic = net.vf_0.weight.detach().clone()
    with torch.no_grad():
        first = float(((net(tnorm.normalize(tnorm.update(tnorm.RunningNorm.create(
            tenv_.obs_dim, "cpu"), tobs), tobs))[0] - tacts) ** 2).mean())
    net, on, mse = tbc.fit(net, tobs, tacts, iters=150, lr=1e-2, log_std=-1.5)
    assert float(mse) < 0.2 * first
    assert torch.equal(net.vf_0.weight, critic)
    _close(net.log_std, np.full(6, -1.5, np.float32))
    jon = jnorm.update(jnorm.RunningNorm.create(jenv.obs_dim), jobs)
    _close(on.mean[:12], jon.mean[:12], rtol=0, atol=5e-3)
    _close(on.count, jon.count)
    # JAX's fit from its own initialisation reaches the same order of loss
    _, _, jmse = jbc.fit(jnets.MLPPolicy(6, (16, 16)), jobs, jacts, jax.random.PRNGKey(1),
                         iters=150, lr=1e-2)
    assert 0.2 < float(mse) / float(jmse) < 5.0


# -- the branch-free autopilot adapters ---------------------------------------

def test_continuous_autopilot_env_matches_jax():
    """110 control steps of the relaxation oscillator through the adapter on
    two lanes (lane 1 stands): phase, policy_in_control, done and counters
    exact at every step, held action and deadline to 1e-6 / 1e-4."""
    kw = dict(task_env="CONTINUOUS_JUMPING_FORWARD3",
              observation_space_mode="PPO_CONTINUOUS_JUMPING_FORWARD", max_ep_len=4.0)
    jenv, tenv_ = _envs(**kw)
    jaenv, taenv = jca.ContinuousAutopilotEnv(jenv), tca.ContinuousAutopilotEnv(tenv_)
    jstate, jobs = jax.vmap(jaenv.reset)(jax.random.split(jax.random.PRNGKey(3), 2))
    tstate = tca.APState(env=convert.env_state(jstate.env), phase=_t(jstate.phase),
                         held=_t(jstate.held), deadline=_t(jstate.deadline))
    tobs = _t(jobs)
    fresh, _ = taenv.reset(torch.Generator().manual_seed(0), 2)
    assert fresh.phase.dtype == tstate.phase.dtype == torch.int32
    assert fresh.held.shape == (2, 6) and fresh.deadline.tolist() == [0.0, 0.0]
    jstep = jax.jit(jax.vmap(jaenv.step))
    init_a = np.asarray(jenv.get_init_action(), np.float32)
    policy = lambda obs: np.stack([EXTEND if float(obs[0, 1]) > 0.95 else CROUCH, init_a])
    phases = set()
    for i in range(110):
        jstate, jobs, jr, jd, jinfo = jstep(jstate, jnp.asarray(policy(np.asarray(jobs))))
        tstate, tobs, tr, td, tinfo = taenv.step(tstate, _t(policy(tobs.numpy())))
        np.testing.assert_array_equal(tstate.phase, jstate.phase, err_msg=f"step {i}")
        np.testing.assert_array_equal(tinfo["policy_in_control"], jinfo["policy_in_control"])
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tstate.env.task.jump_counter,
                                      jstate.env.task.jump_counter)
        _close(tstate.held, jstate.held, rtol=0, atol=1e-6)
        _close(tstate.deadline, jstate.deadline, rtol=0, atol=1e-4)
        _close(tr, jr, rtol=0, atol=1e-4)
        phases.add(int(tstate.phase[0]))
        assert int(tstate.phase[1]) == tca.POLICY
    assert phases == {tca.POLICY, tca.TAKEOFF, tca.LANDING}
    assert int(tstate.env.task.jump_counter[0]) >= 1
    assert taenv.sim_time(tstate).tolist() == pytest.approx([1.1, 1.1])
    assert (taenv.action_dim, taenv.obs_dim) == (6, tenv_.obs_dim)
    assert taenv.config is tenv_.config and taenv.env_time_step == tenv_.env_time_step
    _close(tstate.env.robot.pos[:, 2], jstate.env.robot.pos[:, 2], rtol=0, atol=2e-3)


def test_flat_backflip_episode_matches_jax():
    """The committed launch policy through the flattened autopilot for 60
    steps on two frictions: the phase code of every step, the flags and the
    done step exact; the final pose to 5e-3 (the bound the JAX package holds
    its own wrapper to against this rollout); demonstration rows recorded."""
    kw = dict(task_env="BACKFLIP", observation_space_mode="ARS_BACKFLIP", max_ep_len=4.0)
    jenv, tenv_ = _envs(**kw)
    d = np.load(os.path.join(ROOT, "examples", "policies", "backflip_ars.npz"))
    W, on = convert.load_linear_policy(
        os.path.join(ROOT, "examples", "policies", "backflip_ars.npz"), "cpu")
    jW = jnp.asarray(d["W"], jnp.float32)
    jon = jnorm.RunningNorm(jnp.asarray(d["mean"]), jnp.asarray(d["var"]),
                            jnp.asarray(d["count"]))
    jlanding = jnp.asarray(jenv.get_landing_action())
    js0, jobs0 = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(5), 2))
    jsf, jph, jtraj = jax.jit(jax.vmap(lambda s, o: jfr.backflip_episode(
        jenv, lambda x: jnets.linear_policy_apply(jW, jnorm.normalize(jon, x)),
        lambda x: jlanding, s, o, 60, record_rows=True)))(js0, jobs0)
    landing = tenv_.get_landing_action()
    tsf, tph, ttraj = tfr.backflip_episode(
        tenv_, lambda x: linear_policy_apply(W, tnorm.normalize(on, x)),
        lambda x: landing.expand(x.shape[0], -1), convert.env_state(js0), _t(jobs0), 60,
        record_rows=True)
    # the JAX stacks are (lane, step, ...), the port's (step, lane, ...)
    np.testing.assert_array_equal(ttraj["phase"].T, jtraj["phase"])
    assert set(np.unique(ttraj["phase"])) >= {0, 1, 2}
    for k in ("done", "returned", "row_valid"):
        np.testing.assert_array_equal(ttraj[k].T, jtraj[k], err_msg=k)
    for f in ("flip_stepped", "pitch_passed", "returned", "done"):
        np.testing.assert_array_equal(getattr(tph, f), getattr(jph, f), err_msg=f)
    assert bool(tph.pitch_passed.all())
    np.testing.assert_array_equal(tsf.sim_step_counter, jsf.sim_step_counter)
    _close(ttraj["action"].transpose(0, 1)[:, :12], jtraj["action"][:, :12], rtol=0, atol=1e-3)
    _close(ttraj["reward"].T, jtraj["reward"], rtol=0, atol=1e-4)
    for f in ("pos", "quat", "q"):
        _close(getattr(tsf.robot, f), getattr(jsf.robot, f), f, rtol=0, atol=5e-3)
    _close(ttraj["up_z"].T, jtraj["up_z"], rtol=0, atol=5e-3)
    assert ttraj["row"].shape == (60, 2, 44)
    np.testing.assert_array_equal(ttraj["row"][..., -1].T, jtraj["row"][..., -1])
    _close(tsf.task.max_pitch_bf, jsf.task.max_pitch_bf, rtol=0, atol=5e-3)


# -- CPG and control utilities -------------------------------------------------

@pytest.mark.parametrize("gait,couple", [("TROT", True), ("WALK", True), ("BOUND", True),
                                          ("PACE", True), ("TROT", False)])
def test_cpg_update_matches_jax(gait, couple):
    """300 integration steps from one random state, one lane and a batch: the
    oscillator state and the foot references to 1e-6 per step taken (the
    phases wrap at 2π; compared on the circle)."""
    kw = dict(gait=gait, couple=couple, omega_swing=5 * 2 * np.pi, omega_stance=2 * 2 * np.pi)
    jp, tp = jcpg.HopfParams(**kw), tcpg.HopfParams(**kw)
    X0 = np.asarray(jcpg.init_state(jp, jax.random.PRNGKey(0)), np.float32)
    assert tcpg.init_state(tp, torch.Generator().manual_seed(0)).shape == (2, 4)
    batch = tcpg.init_state(tp, torch.Generator().manual_seed(0), 3)
    assert batch.shape == (3, 2, 4) and float(batch[:, 0].max()) < 0.1
    _close(batch[:, 1], np.tile(X0[1], (3, 1)), rtol=0, atol=1e-6)
    jX, tX = jnp.asarray(X0), _t(np.stack([X0, X0]))
    jstep = jax.jit(lambda X: jcpg.cpg_update(jp, X))
    for k in range(300):
        jX, jx, jz = jstep(jX)
        tX, tx, tz = tcpg.cpg_update(tp, tX)
    tol = 1e-6 * 300
    _close(tX[0, 0], jX[0], rtol=0, atol=tol)
    dtheta = np.angle(np.exp(1j * (tX[0, 1].numpy() - np.asarray(jX[1]))))
    assert np.abs(dtheta).max() < tol
    _close(tx[0], jx, rtol=0, atol=tol)
    _close(tz[0], jz, rtol=0, atol=tol)
    assert torch.equal(tX[0], tX[1])
    _close(tX[0, 0], np.full(4, np.sqrt(tp.mu), np.float32), rtol=0, atol=1e-3)


def test_cpg_torques_match_jax():
    rng = np.random.default_rng(2)
    jcfg, tcfg = jgo1_config(True), tgo1_config(True, "cpu")
    q = (np.array([0.0, np.pi / 4, -np.pi / 2] * 4) + 0.2 * rng.standard_normal((3, 12))).astype(
        np.float32)
    qd = rng.standard_normal((3, 12)).astype(np.float32)
    fx = (0.04 * rng.standard_normal((3, 4))).astype(np.float32)
    fz = (-0.25 + 0.03 * rng.standard_normal((3, 4))).astype(np.float32)
    want = jax.vmap(lambda *a: jcpg.cpg_torques(jcfg, *a))(*map(jnp.asarray, (q, qd, fx, fz)))
    got = tcpg.cpg_torques(tcfg, *map(_t, (q, qd, fx, fz)))
    _close(got, want, rtol=1e-5, atol=1e-4)
    one = tcpg.cpg_torques(tcfg, _t(q[0]), _t(qd[0]), _t(fx[0]), _t(fz[0]),
                           kp_joint=torch.full((4, 3), 50.0), kd_joint=torch.full((4, 3), 1.0))
    jone = jcpg.cpg_torques(jcfg, *map(jnp.asarray, (q[0], qd[0], fx[0], fz[0])),
                            kp_joint=jnp.full((4, 3), 50.0), kd_joint=jnp.full((4, 3), 1.0))
    _close(one, jone, rtol=1e-5, atol=1e-4)


def test_control_utils_geometry_matches_jax():
    """find_config_from_height, des_feet_pos_from_pitch and pose_from_pitch
    to 1e-6, single and batched."""
    h = np.float32([0.20, 0.28, 0.32])
    want = jax.vmap(jcu.find_config_from_height)(jnp.asarray(h))
    _close(tcu.find_config_from_height(_t(h)), want, rtol=0, atol=1e-6)
    _close(tcu.find_config_from_height(0.28), want[1], rtol=0, atol=1e-6)
    rng = np.random.default_rng(3)
    phi = np.float32([0.1, -0.2, 0.0])
    feet = (0.1 * rng.standard_normal((3, 12))).astype(np.float32)
    _close(tcu.des_feet_pos_from_pitch(_t(phi), _t(feet)),
           jax.vmap(jcu.des_feet_pos_from_pitch)(jnp.asarray(phi), jnp.asarray(feet)),
           rtol=0, atol=1e-6)
    q = (np.array([0.0, np.pi / 4, -np.pi / 2] * 4) + 0.05 * rng.standard_normal((3, 12))).astype(
        np.float32)
    _close(tcu.pose_from_pitch(_t(phi), _t(q)),
           jax.vmap(jcu.pose_from_pitch)(jnp.asarray(phi), jnp.asarray(q)), rtol=0, atol=2e-6)
    _close(tcu.pose_from_pitch(0.1, _t(q[0])), jcu.pose_from_pitch(0.1, jnp.asarray(q[0])),
           rtol=0, atol=2e-6)
    # zero pitch keeps the pose
    _close(tcu.pose_from_pitch(0.0, _t(q[2])), q[2], rtol=0, atol=1e-5)


def test_settle_robot_by_pd_reaches_the_stance_in_torque_mode():
    """A non-RL TORQUE env settled by joint PD for 400 substeps: standing
    height, all feet down, joints at the init pose (the KPIs of
    tests/test_control_utils.py)."""
    env = tenv.QuadrupedEnv(tenv.EnvConfig(
        enable_springs=True, motor_control_mode="TORQUE", is_rl_gym_interface=False,
        action_space_mode="DEFAULT", task_env="NO_TASK", obs_noise=False,
        settling_steps=0), device="cpu")
    state = tcu.settle_robot_by_pd(env, torch.Generator().manual_seed(0), n=2, steps=400)
    z = state.robot.pos[:, 2]
    assert bool(((z > 0.25) & (z < 0.36)).all())
    assert float((state.robot.q - env.cfg.init_joint_angles).abs().max()) < 0.1
    assert float(state.robot.qd.abs().max()) < 1.0
    assert state.sim_step_counter.tolist() == [0, 0]
