"""The environment's physics in one call (quadruped_springs_tpu_torch/env/
substeps.py) on the CPU: its plain version over a control step of 10
substeps against the JAX package's lax.scan of the anchored dyn.step (both
JAX paths, "ref" and "soa"); the fused CUDA kernel's body
(csrc/env_lane.cuh), built for the CPU with g++ by tests/env_substeps_host.cpp,
against the plain version; QuadrupedEnv.step, reset and settle_robot_by_pd
through the wrapper against the per-substep loop they ran before; the
wrapper's checks. Inputs come from numpy seeds and go to every side. The
kernel itself runs on the card in tests/test_torch_kernels.py (`gpu`: this
file imports jax, which the card's machine need not have): against the
plain version, and rows 0-7 bitwise at 1,024, 8 and 2 environments.
"""

import ctypes
import dataclasses
import functools
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env import randomizers as jrnd
from quadruped_springs_tpu.models import dynamics as jdyn
from quadruped_springs_tpu.models.go1_params import go1_config as jgo1_config
from quadruped_springs_tpu.ops import actuation as jact
from quadruped_springs_tpu_torch import convert, kernels
from quadruped_springs_tpu_torch.control import utils as tcu
from quadruped_springs_tpu_torch.env import env as tenv
from quadruped_springs_tpu_torch.env import substeps as ss
from quadruped_springs_tpu_torch.models import dynamics as tdyn
from quadruped_springs_tpu_torch.models.go1_params import SCENARIO_FIELDS, go1_config
from quadruped_springs_tpu_torch.ops import actuation as act

N, R = 8, 10
INIT_Q = np.array([0.0, np.pi / 4, -np.pi / 2] * 4)
# lanes of the "pd" case: 0-1 stance, 2 push-off (saturated extension), 3
# flight, 4 on the friction cone's boundary (anchors 5 cm off, friction
# 0.3: the feet slide), 5 pushed by an external force, 6-7 stance with
# larger commands; every case interpolates its command over the substeps
STANCE, PUSH_OFF, FLIGHT, CONE, PUSHED = (0, 1), 2, 3, 4, 5


@functools.lru_cache(maxsize=None)
def _case(case: str):
    """Seeded numpy inputs of one case and JAX-sampled TEST_RANDOMIZER
    scenarios (masses, springs, friction) per lane."""
    rng = np.random.default_rng({"pd": 0, "torque": 1, "on_rack": 2}[case])
    f32 = lambda a: np.asarray(a, np.float32)
    quat = np.tile([0.0, 0.0, 0.0, 1.0], (N, 1)) + 0.02 * rng.standard_normal((N, 4))
    d = dict(pos=np.array([0.0, 0.0, 0.326]) + [0.01, 0.01, 0.002] * rng.standard_normal((N, 3)),
             quat=quat / np.linalg.norm(quat, axis=-1, keepdims=True),
             lin_vel=0.1 * rng.standard_normal((N, 3)),
             ang_vel=0.1 * rng.standard_normal((N, 3)),
             q=INIT_Q + 0.05 * rng.standard_normal((N, 12)),
             qd=0.5 * rng.standard_normal((N, 12)))
    stance = list(STANCE)       # level, in the init pose, nearly at rest
    d["quat"][stance] = [0.0, 0.0, 0.0, 1.0]
    d["q"][stance] = INIT_Q + 0.002 * rng.standard_normal((2, 12))
    for k in ("lin_vel", "ang_vel", "qd"):
        d[k][stance] *= 0.1
    d["pos"][FLIGHT, 2] += 0.15
    d["lin_vel"][FLIGHT] = [0.3, 0.0, 1.0]
    d = {k: f32(v) for k, v in d.items()}
    prev = d["q"] + 0.05 * rng.standard_normal((N, 12))
    curr = prev + 0.3 * rng.standard_normal((N, 12))
    curr[stance] = prev[stance]
    curr[PUSH_OFF] = d["q"][PUSH_OFF] + np.tile([0.0, -0.8, 1.2], 4)   # saturates
    frac = (np.arange(R)[None, :, None] + 1.0) / R
    q_des = f32(prev[:, None] + frac * (curr - prev)[:, None])
    if case == "torque":
        q_des = f32(np.repeat(rng.uniform(-8.0, 8.0, (N, 1, 12)), R, axis=1))
    ext = np.zeros((N, 3), np.float32)
    ext[PUSHED] = [30.0, -20.0, 10.0]
    keys = jax.random.split(jax.random.PRNGKey({"pd": 3, "torque": 4, "on_rack": 5}[case]), N)
    scen = jax.vmap(lambda k: jrnd.sample_scenario(jgo1_config(True), "TEST_RANDOMIZER", k))(keys)
    friction = np.array(scen.friction, np.float32)
    friction[CONE] = 0.3
    scen = scen.replace(friction=jnp.asarray(friction))
    feet_at = jax.vmap(lambda sc, s: jdyn.foot_state_world(jrnd.model_from_params(sc), s)[0])
    feet = np.asarray(feet_at(scen, jdyn.RobotState(**{k: jnp.asarray(v) for k, v in d.items()})))
    # the stance lanes' feet pressed 0.2 mm into the ground on average (about
    # the static deflection under the robot's weight)
    d["pos"][stance, 2] -= feet[stance, :, 2].mean(-1) - (0.02 - 0.0002)
    if case == "on_rack":
        d["pos"][:, 2] = 1.0
    feet = np.asarray(feet_at(scen, jdyn.RobotState(**{k: jnp.asarray(v) for k, v in d.items()})))
    anchor = feet[..., :2] + 1e-4 * rng.standard_normal((N, 4, 2))
    anchor[CONE] += 0.05
    return d, f32(anchor), q_des, ext, scen


def _torch_args(case: str, device="cpu"):
    """env_substeps's arguments for a case, on `device`."""
    d, anchor, q_des, ext, scen = _case(case)
    t = lambda a: torch.as_tensor(np.array(a), device=device)
    cfg = go1_config(True, device)
    model = convert.go1_model(jax.vmap(jrnd.model_from_params)(scen), device)
    params = tdyn.SimParams(friction=t(scen.friction), on_rack=case == "on_rack")
    robot = tdyn.RobotState(**{k: t(v) for k, v in d.items()})
    cmd = t(q_des[:, 0]) if case == "torque" else t(q_des)   # TORQUE: one command held
    sign = torch.as_tensor(act.SPRING_ENGAGE_SIGN, dtype=torch.float32, device=device)
    return (robot, t(anchor), cmd, model, params, cfg.motor_kp, cfg.motor_kd,
            cfg.torque_limits, cfg.velocity_limits, t(scen.spring_stiffness),
            t(scen.spring_damping), cfg.spring_rest_angles, sign, R, t(ext), case == "torque")


@functools.lru_cache(maxsize=None)
def _jax_control_step(impl: str, on_rack: bool):
    """JAX's control step, jitted and vmapped over the lanes: per substep
    pd_torque (or, where the lane's flag says TORQUE, torque_command) plus
    spring_torque, then dyn.step with foot anchors, as a lax.scan over the
    substeps. The flag is data, so the PD and TORQUE cases share a compile."""
    cfg = jgo1_config(True)

    def lane(sc, s, a, cmds, f_ext, torque):
        model = jrnd.model_from_params(sc)
        params = jdyn.default_sim_params().replace(friction=sc.friction, on_rack=on_rack)

        def substep(carry, cmd):
            r, anc = carry
            tau_m = jnp.where(torque, jact.torque_command(cmd, cfg.torque_limits),
                              jact.pd_torque(cmd, r.q, r.qd, cfg.motor_kp, cfg.motor_kd,
                                             cfg.torque_limits))
            tau = tau_m + jact.spring_torque(r.q, r.qd, sc.spring_stiffness,
                                             sc.spring_damping, cfg.spring_rest_angles)
            r2, info = jdyn.step(model, params, r, tau, cfg.velocity_limits,
                                 ext_force_world=f_ext, foot_anchor=anc, impl=impl)
            return (r2, info["new_anchor"]), (tau_m, info["foot_forces"],
                                               info["feet_in_contact"],
                                               info["invalid_contact"])

        (r, anc), (tau_m, fn, inc, inv) = jax.lax.scan(substep, (s, a), cmds)
        return r, anc, tau_m[-1], tau_m.sum(0), fn[-1], inc[-1], inv[-1]

    return jax.jit(jax.vmap(lane))


@functools.lru_cache(maxsize=None)
def _jax_scan(impl: str, case: str):
    d, anchor, q_des, ext, scen = _case(case)
    jstate = jdyn.RobotState(**{k: jnp.asarray(v) for k, v in d.items()})
    out = _jax_control_step(impl, case == "on_rack")(
        scen, jstate, jnp.asarray(anchor), jnp.asarray(q_des), jnp.asarray(ext),
        jnp.full(N, case == "torque"))
    return jax.tree.map(np.asarray, out)


# The tolerances of tests/test_torch_env.py for one control step (10
# substeps at 180 kN/m): the two implementations differ by the f32 rounding
# of the 18x18 solves (qdd ~1e-4 relative in stiff contact), integrated ten
# times.
TOL_STATE = {"pos": 5e-6, "quat": 5e-6, "q": 5e-6, "lin_vel": 2e-3, "ang_vel": 2e-3,
             "qd": 2e-3}
TOL_OUT = {"anchor": dict(rtol=0, atol=2e-6), "tau_m": dict(rtol=0, atol=0.05),
           "tau_m_sum": dict(rtol=0, atol=0.05 * R),
           "foot_forces": dict(rtol=1e-3, atol=0.5)}


def _fields(out):
    """A SubstepsOut's float fields and its two boolean ones, as numpy."""
    floats = {f: getattr(out.robot, f) for f in TOL_STATE}
    floats.update({f: getattr(out, f) for f in TOL_OUT})
    bools = {f: getattr(out, f) for f in ("feet_in_contact", "invalid_contact")}
    as_np = lambda m: {k: v.detach().cpu().numpy() for k, v in m.items()}
    return as_np(floats), as_np(bools)


def _jax_fields(jout):
    r, anc, tau_m, tau_m_sum, fn, inc, inv = jout
    floats = {f: getattr(r, f) for f in TOL_STATE}
    floats.update(anchor=anc, tau_m=tau_m, tau_m_sum=tau_m_sum, foot_forces=fn)
    return floats, {"feet_in_contact": inc, "invalid_contact": inv}


def _tol(field):
    return dict(rtol=0, atol=TOL_STATE[field]) if field in TOL_STATE else TOL_OUT[field]


def _within(got, want, spread, field):
    tol = _tol(field)
    excess = np.abs(got - want) - (tol["atol"] + tol["rtol"] * np.abs(want) + spread)
    assert np.all(excess <= 0), f"{field}: max excess over the bound {excess.max()}"


@pytest.mark.parametrize("impl,case", [("ref", "pd"), ("ref", "torque"), ("ref", "on_rack"),
                                       ("soa", "pd"), ("soa", "torque")])
def test_plain_control_step_matches_jax_scan(impl, case):
    """env_substeps_plain over R = 10 substeps against JAX's scan of the
    anchored dyn.step. "ref": the tolerances of tests/test_torch_env.py
    (TOL_STATE, TOL_OUT). "soa": those plus the elementwise |soa - ref|
    spread of the two JAX paths on the same inputs (their sums and solves
    run in other orders; on these inputs it reaches 3e-4 rad/s in qd). The
    on-rack case runs against ref only: its solve has no Schur step, where
    the paths differ."""
    got, got_b = _fields(ss.env_substeps_plain(*_torch_args(case)))
    want, want_b = _jax_fields(_jax_scan(impl, case))
    spread = ({k: 0.0 for k in want} if impl == "ref" else
              {k: np.abs(want[k] - _jax_fields(_jax_scan("ref", case))[0][k]) for k in want})
    for k in want:
        _within(got[k], want[k], spread[k], k)
    for k in want_b:
        np.testing.assert_array_equal(got_b[k], want_b[k], err_msg=k)
    inc = got_b["feet_in_contact"]
    if case == "pd":   # the lanes sit in their regimes
        anchor0 = _case(case)[1]
        slid = np.abs(got["anchor"] - anchor0).max(-1) > 1e-3
        assert inc[list(STANCE)].all() and not inc[FLIGHT].any()
        assert (inc[CONE] & slid[CONE]).any() and got["foot_forces"][PUSH_OFF].max() > 100.0
    if case == "on_rack":
        assert not inc.any() and np.all(got["lin_vel"] == 0.0)


# --- the kernel's body, built for the CPU ------------------------------------

@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """The kernel's body built with g++ (tests/env_substeps_host.cpp), once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's body for the CPU")
    src = Path(__file__).with_name("env_substeps_host.cpp")
    lib = tmp_path_factory.mktemp("host_build") / "libenv_substeps_host.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-o",
                    str(lib), str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).env_substeps_host
    fn.argtypes = kernels.ENV_SUBSTEPS_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _host_run(fn, args):
    """The host build on env_substeps's CPU arguments, through the wrapper's
    own argument packing."""
    (robot, anchor, q_des, model, params, kp, kd, lim, vlim, k, b, rest, sign, substeps,
     ext, torque) = args
    launch, out = ss.launch_args(robot, anchor, q_des, model, params.friction, params,
                                 kp, kd, lim, vlim, k, b, rest, sign, substeps, ext, torque)
    assert fn(*launch, None) == 0
    return out


@pytest.mark.parametrize("case", ["pd", "torque", "on_rack", "pd_shared"])
def test_kernel_body_on_the_host_matches_plain(case, host_build):
    """The kernel's body (csrc/env_lane.cuh: the legs as four threads that
    sum their shares of the base's Schur system) built with g++, against
    env_substeps_plain over R = 10 substeps, at the tolerances of
    tests/test_torch_env.py (TOL_STATE, TOL_OUT): the same float32 math in
    soa's order, without FMA. "pd_shared": one model row and one (3,)
    external force for every lane (the stride-0 inputs)."""
    args = list(_torch_args(case.removesuffix("_shared")))
    if case == "pd_shared":
        m = args[3]
        args[3] = dataclasses.replace(m, **{f: getattr(m, f)[:1] for f in (
            "trunk_inertia6", "trunk_mass", "leg_masses", "leg_coms", "leg_inertias6")})
        args[14] = args[14][PUSHED].contiguous()
    got, got_b = _fields(_host_run(host_build, args))
    want, want_b = _fields(ss.env_substeps_plain(*args))
    for k in want:
        _within(got[k], want[k], 0.0, k)
    for k in want_b:
        np.testing.assert_array_equal(got_b[k], want_b[k], err_msg=k)


def _model_rows(model, rows):
    """`model` with its scenario fields cut to `rows` (a slice): contiguous
    views that start inside the fields' storage."""
    return dataclasses.replace(model, **{f: getattr(model, f)[rows]
                                         for f in SCENARIO_FIELDS})


@pytest.mark.parametrize("env", [0, 5])
def test_kernel_body_reads_the_model_rows_where_they_lie(env, host_build):
    """The kernel reads the model's five scenario fields in place (no packed
    copy), a row an environment or one row for all: environment `env` of a
    launch at N rows is bitwise what it is in a launch whose one row is its
    own (the fields sliced to env:env+1, so the row starts inside their
    storage); and at N rows against env_substeps_plain as in the pd case."""
    args = list(_torch_args("pd"))
    every = _fields(_host_run(host_build, args))
    one = list(args)
    one[3] = _model_rows(args[3], slice(env, env + 1))
    alone = _fields(_host_run(host_build, one))
    for got, want in zip(every, alone):
        for k in want:
            np.testing.assert_array_equal(got[k][env], want[k][env], err_msg=k)
    want, want_b = _fields(ss.env_substeps_plain(*args))
    for k in want:
        _within(every[0][k], want[k], 0.0, k)


# --- the environment through the wrapper, against its loop before it ---------

def _inline_physics(env, robot, anchor, q_des, model, params, springs, kp, kd, substeps,
                    ext=None, torque_mode=False):
    """The per-substep loop QuadrupedEnv.step and reset ran before
    env_substeps (actuation_torque, then dyn.step with the anchors)."""
    cfg = env.cfg
    zero = torch.zeros(12)
    tau_m_sum = None
    for i in range(substeps):
        cmd = q_des[:, i] if q_des.dim() == 3 else q_des
        if torque_mode:
            tau_m = act.torque_command(cmd, cfg.torque_limits)
            tau_s, _ = act.actuation_torque(cmd, robot.q, robot.qd, zero, zero,
                                            cfg.torque_limits, *springs,
                                            cfg.spring_rest_angles, env.engage_sign)
            tau = tau_m + tau_s
        else:
            tau, tau_m = act.actuation_torque(cmd, robot.q, robot.qd, kp, kd,
                                              cfg.torque_limits, *springs,
                                              cfg.spring_rest_angles, env.engage_sign)
        robot, info = tdyn.step(model, params, robot, tau, cfg.velocity_limits,
                                ext_force_world=ext, foot_anchor=anchor)
        anchor = info["new_anchor"]
        tau_m_sum = tau_m if tau_m_sum is None else tau_m_sum + tau_m
    return robot, anchor, tau, tau_m, tau_m_sum, info


BASE = dict(enable_springs=True, action_space_mode="SYMMETRIC", task_env="JUMPING_IN_PLACE",
            observation_space_mode="ARS_BASIC", obs_noise=False, settling_steps=30)
MODES = {"pd_interp": dict(motor_control_mode="PD", enable_action_interpolation=True),
         "torque_non_rl": dict(motor_control_mode="TORQUE", is_rl_gym_interface=False,
                               action_space_mode="DEFAULT", task_env="NO_TASK"),
         "pd_gains_push": dict(motor_control_mode="PD")}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_env_reset_and_step_match_the_inline_loop(mode):
    """QuadrupedEnv.reset (its 30-substep settle) and one step through
    env_substeps give bitwise what the per-substep loop gave: state,
    anchors, torques, contact and the mean motor torque."""
    env = tenv.QuadrupedEnv(tenv.EnvConfig(**dict(BASE, **MODES[mode])), device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(0), 3)
    model = tenv.rnd.model_from_params(state.scenario)
    params = env._scenario_sim_params(state.scenario)
    springs = env._springs(state.scenario)
    robot0 = env._init_robot_state(3)
    settled = _inline_physics(env, robot0, env._feet_anchor(model, robot0),
                              env._settle_q_des.expand(3, 12).contiguous(), model, params,
                              springs, env.cfg.motor_kp, env.cfg.motor_kd, 30)
    for f in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        assert torch.equal(getattr(state.robot, f), getattr(settled[0], f)), f
    assert torch.equal(state.foot_anchor, settled[1])

    rng = np.random.default_rng(7)
    if mode == "torque_non_rl":
        action = torch.from_numpy(rng.uniform(-5, 5, (3, 12)).astype(np.float32))
        q_des, kw = action, {}
    else:
        action = torch.from_numpy(rng.uniform(-1, 1, (3, env.action_dim)).astype(np.float32))
        command = lambda a: tenv.ci.action_to_command(env.iface, a).contiguous()
        q_des = (torch.stack([command(state.last_action + ((i + 1.0) / 10)
                                      * (action - state.last_action)) for i in range(10)], 1)
                 if mode == "pd_interp" else command(action))
        kw = ({} if mode == "pd_interp" else
              dict(kp=torch.full((12,), 60.0), kd=torch.full((12,), 1.5),
                   ext_force_world=torch.tensor([30.0, -20.0, 10.0])))
    new, _, _, _, info = env.step(state, action, **kw)
    robot, anchor, tau, tau_m, tau_m_sum, cinfo = _inline_physics(
        env, state.robot, state.foot_anchor, q_des, model, params, springs,
        kw.get("kp", env.cfg.motor_kp), kw.get("kd", env.cfg.motor_kd), 10,
        kw.get("ext_force_world"), mode == "torque_non_rl")
    for f in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        assert torch.equal(getattr(new.robot, f), getattr(robot, f)), f
    assert torch.equal(new.foot_anchor, anchor)
    assert torch.equal(new.observed_torques, tau_m)
    assert torch.equal(new.spring_torques, tau - tau_m)
    assert torch.equal(info["mean_motor_torque"], tau_m_sum / 10)
    assert torch.equal(new.feet_forces, cinfo["foot_forces"])
    assert torch.equal(new.feet_in_contact, cinfo["feet_in_contact"])
    assert torch.equal(new.invalid_contact, cinfo["invalid_contact"])


def test_settle_robot_by_pd_matches_the_inline_loop():
    """control/utils.settle_robot_by_pd (one env_substeps call) against the
    per-substep loop it ran, bitwise, from the same reset."""
    env = tenv.QuadrupedEnv(tenv.EnvConfig(**dict(BASE, settling_steps=0)), device="cpu")
    got = tcu.settle_robot_by_pd(env, torch.Generator().manual_seed(1), n=2, steps=25)
    state, _ = env.reset(torch.Generator().manual_seed(1), 2)
    model = tenv.rnd.model_from_params(state.scenario)
    robot, anchor, *_ = _inline_physics(
        env, state.robot, state.foot_anchor,
        env.cfg.init_joint_angles.expand(2, 12).contiguous(), model,
        env._scenario_sim_params(state.scenario), env._springs(state.scenario),
        env.cfg.motor_kp, env.cfg.motor_kd, 25)
    for f in ("pos", "quat", "q", "qd"):
        assert torch.equal(getattr(got.robot, f), getattr(robot, f)), f
    assert torch.equal(got.foot_anchor, anchor)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Grad-requiring gains (the model, limits, springs and friction too:
    only the state, anchors and commands are differentiated) raise on every
    device, and not under no_grad; launch_args (the CUDA
    path's checks, device-agnostic) rejects a non-contiguous state, a
    wrong dtype, a model of neither 1 nor N rows, a model field that is
    not contiguous, of another dtype or of rows unlike the others, and
    q_des of another substep count, from metadata alone."""
    args = list(_torch_args("pd"))
    grad = list(args)
    grad[5] = args[5].clone().requires_grad_()
    with pytest.raises(ValueError, match="grad"):
        ss.env_substeps(*grad)
    with torch.no_grad():
        ss.env_substeps(*grad)
    robot, anchor, q_des, model, params = args[:5]
    rest = args[5:13]

    def check(robot=robot, anchor=anchor, q_des=q_des, model=model, substeps=R):
        return ss.launch_args(robot, anchor, q_des, model, params.friction, params, *rest,
                              substeps, None, False)

    check()
    check(model=_model_rows(model, slice(3, 4)))
    with pytest.raises(ValueError, match="contiguous"):
        check(robot=dataclasses.replace(robot, q=robot.q.t().contiguous().t()))
    with pytest.raises(TypeError, match="dtype"):
        check(anchor=anchor.double())
    with pytest.raises(ValueError, match="model rows"):
        check(model=_model_rows(model, slice(0, 2)))
    with pytest.raises(ValueError, match="leg_inertias6: not contiguous"):
        check(model=dataclasses.replace(
            model, leg_inertias6=model.leg_inertias6.transpose(-1, -2)))
    with pytest.raises(TypeError, match="leg_coms: dtype"):
        check(model=dataclasses.replace(model, leg_coms=model.leg_coms.double()))
    with pytest.raises(ValueError, match="trunk_inertia6: shape"):
        check(model=dataclasses.replace(model, trunk_inertia6=model.trunk_inertia6[:1]))
    with pytest.raises(ValueError, match="shape"):
        check(substeps=R - 1)
    with pytest.raises(ValueError, match="at least 1"):
        check(substeps=0)
