"""The planner's rollout in one call (quadruped_springs_tpu_torch/solver/
rollout.py) on the CPU: its plain version over H knots against a
jax.lax.scan of the JAX package's MPCProblem.dynamics (relaxed and full
rate, springs on and off, problems in stance, push-off and flight); the
CUDA kernel's body (csrc/planner_lane.cuh), built for the CPU with g++ by
tests/planner_rollout_host.cpp, against the plain version; solve_mppi
through MPCProblem.lane_rollout against JAX's solve_mppi with JAX's draws
injected; the wrapper's refusals. Inputs come from numpy seeds and go to
every side. The kernel itself runs on the card in tests/test_torch_kernels.py
and chip_smoke.py."""

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
from quadruped_springs_tpu.solver import mpc as jmpc
from quadruped_springs_tpu.solver import mppi as jmppi
from quadruped_springs_tpu_torch import convert, kernels
from quadruped_springs_tpu_torch.control import interfaces as ci
from quadruped_springs_tpu_torch.solver import mpc as tmpc
from quadruped_springs_tpu_torch.solver import mppi as tmppi
from quadruped_springs_tpu_torch.solver import rollout as ro

B, R, H = 3, 4, 8
STANCE, PUSH_OFF, FLIGHT = 0, 1, 2          # the problems
EXTEND = np.array([0.0, -0.4, 1.0, 0.0, -0.4, 1.0])
CROUCH = np.array([0.0, 0.4, -0.8, 0.0, 0.4, -0.8])
CASES = {"relaxed": (False, True), "relaxed_no_springs": (False, False),
         "full_rate": (True, True), "full_rate_no_springs": (True, False)}


@functools.lru_cache(maxsize=None)
def _problems(full_rate: bool, springs: bool, horizon: int = H):
    kw = dict(task="JUMPING_IN_PLACE", enable_springs=springs, horizon=horizon)
    jmk, tmk = ((jmpc.MPCConfig.full_rate, tmpc.MPCConfig.full_rate) if full_rate
                else (jmpc.MPCConfig, tmpc.MPCConfig))
    return jmpc.MPCProblem(jmk(**kw)), tmpc.MPCProblem(tmk(**kw), "cpu")


@functools.lru_cache(maxsize=None)
def _case(springs: bool):
    """Seeded starts (B,37), candidates (B,R,H,m) and JAX-sampled
    TEST_RANDOMIZER scenarios (B): problem 0 stands (feet pressed into the
    ground) on small commands around the init action, problem 1 crouches for
    3 knots and extends (push-off), problem 2 starts 15 cm up at 1 m/s
    (flight) on random commands."""
    jprob, _ = _problems(False, springs)
    rng = np.random.default_rng(7)
    x0 = np.tile(np.asarray(jprob.default_x0()), (B, 1))
    x0[:, 13:25] += 0.02 * rng.standard_normal((B, 12))
    x0[STANCE, 2] -= 0.01
    x0[FLIGHT, 2] += 0.15
    x0[FLIGHT, 9] = 1.0
    m = jprob.action_dim
    a_init = np.asarray(jprob.default_warm_start())[0]
    us = np.empty((B, R, H, m))
    us[STANCE] = a_init + 0.1 * rng.standard_normal((R, H, m))
    ramp = (np.arange(H) < 3)[:, None]
    us[PUSH_OFF] = np.where(ramp, CROUCH, EXTEND) + 0.05 * rng.standard_normal((R, H, m))
    us[FLIGHT] = rng.uniform(-1.0, 1.0, (R, H, m))
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    scen = jax.vmap(lambda k: jrnd.sample_scenario(jprob.cfg, "TEST_RANDOMIZER", k))(keys)
    return (x0.astype(np.float32), np.clip(us, -1.0, 1.0).astype(np.float32), scen)


@functools.lru_cache(maxsize=None)
def _jax_rollout(full_rate: bool, springs: bool):
    """A lax.scan of JAX's MPCProblem.dynamics over the knots, vmapped over
    the B·R lanes (each with its problem's scenario)."""
    jprob, _ = _problems(full_rate, springs)

    def lane(x, us, sc):
        def knot(x, u):
            x2 = jprob.dynamics(x, u, sc)
            return x2, x2
        return jnp.concatenate([x[None], jax.lax.scan(knot, x, us)[1]])

    return jax.jit(jax.vmap(lane))


def _torch_inputs(tprob, x0, us, scen):
    q_des = ci.action_to_command(tprob.iface, torch.from_numpy(us)).contiguous()
    return (torch.from_numpy(x0), q_des,
            tprob.rollout_lanes(convert.scenario_params(scen)), tprob.rollout_consts())


# Each knot is held as tests/test_torch_slice.py's knot test holds one knot:
# relaxed 1e-4, full rate 1e-3, of 1 + |x|. Over 8 knots the rounding
# compounds through the stiff contact: JAX and the plain version (the 18x18
# solve is LU in JAX's structured path, closed form here) part at the first
# knot by 1.5e-5 (relaxed) and 2.2e-5 (full rate) of 1 + |x|, at the eighth
# by up to 9.3e-3 (a joint velocity of the full-rate model without
# springs), as far as two rollouts from starts one float32 ulp apart part.
# So each lane's knot is also allowed SPREAD times the reference's own
# spread, the rule chip_smoke.py holds the kernels to: the larger of its
# change under a one-ulp change of its start (every joint angle one ulp up)
# and its distance to the plain version run in float64, each the largest
# over the state. Measured: JAX's excess over the knot tolerance uses at most
# 4.5 spreads, the kernel's body's 2.0.
TOL = {False: 1e-4, True: 1e-3}
SPREAD = 10.0


def _moved(x0):
    """x0 with every joint angle one float32 ulp up."""
    x1 = x0.copy()
    x1[..., 13:25] = np.nextafter(x1[..., 13:25], np.float32(np.inf))
    return x1


def _float64_plain(x0, q_des, lanes, consts):
    f64 = lambda t: tmpc.cast_floats(t, torch.float64)
    return ro.planner_rollout_plain(torch.from_numpy(x0).double(), q_des.double(),
                                    f64(lanes), f64(consts)).numpy()


def _assert_within(got, want, refs, tol, name):
    """|got - want| <= tol·(1 + |want|) + SPREAD x the spread, per lane and
    knot: the largest |ref - want| over the state and the refs."""
    slack = np.abs(got - want) - tol * (1.0 + np.abs(want))
    spread = np.max([np.abs(r - want).max(-1, keepdims=True) for r in refs], axis=0)
    bad = slack > SPREAD * spread
    assert not bad.any(), (name, np.argwhere(bad)[:5], float(slack.max()))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax(case):
    """planner_rollout_plain over H = 8 knots of B = 3 problems x R = 4
    candidates against JAX's scan of MPCProblem.dynamics, every knot's
    state, to TOL and SPREAD above; the problems sit in their regimes
    (stance on the feet, the flight problem in the air at knot 1, the
    push-off lifting the base)."""
    full_rate, springs = CASES[case]
    x0, us, scen = _case(springs)
    jprob, tprob = _problems(full_rate, springs)
    lane_scen = jax.tree.map(lambda a: jnp.repeat(a, R, axis=0), scen)
    jax_run = lambda x: np.asarray(_jax_rollout(full_rate, springs)(
        np.repeat(x, R, axis=0), us.reshape(B * R, H, -1), lane_scen)).reshape(
        B, R, H + 1, 37)
    want = jax_run(x0)
    got = ro.planner_rollout(*_torch_inputs(tprob, x0, us, scen)).numpy()
    tol = TOL[full_rate]
    np.testing.assert_allclose(got[:, :, 1], want[:, :, 1], rtol=tol, atol=tol)
    x0_t, q_des, lanes, consts = _torch_inputs(tprob, x0, us, scen)
    refs = [jax_run(_moved(x0)), _float64_plain(x0, q_des, lanes, consts)]
    _assert_within(got, want, refs, tol, case)
    assert got[STANCE, :, 1, 2].max() < 0.33                   # stands on its feet
    assert np.all(got[FLIGHT, :, 1, 2] > 0.45)                 # in the air
    assert got[PUSH_OFF, :, -1, 9].max() > 0.3                 # pushed off upward


# --- the kernel's body, built for the CPU ------------------------------------

@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """The kernel's body built with g++ (tests/planner_rollout_host.cpp), once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's body for the CPU")
    src = Path(__file__).with_name("planner_rollout_host.cpp")
    lib = tmp_path_factory.mktemp("host_build") / "libplanner_rollout_host.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-o",
                    str(lib), str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).planner_rollout_host
    fn.argtypes = kernels.PLANNER_ROLLOUT_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("shared", [False, True], ids=["per_problem", "one_scenario"])
@pytest.mark.parametrize("case", ["relaxed", "full_rate"])
def test_kernel_body_on_the_host_matches_plain(case, shared, host_build):
    """The kernel's body (csrc/planner_lane.cuh: four threads a lane that
    sum the legs' shares of the base's Schur system, the state in registers
    over every knot) built with g++, through the wrapper's argument packing,
    against planner_rollout_plain: every knot's state held as the plain
    version is held to JAX above, the spread the plain version's own (the
    same float32 math in the scalarized order, without FMA). "one_scenario": one scenario row for every problem (the
    stride-0 model of the nominal robot)."""
    full_rate, springs = CASES[case]
    x0, us, scen = _case(springs)
    _, tprob = _problems(full_rate, springs)
    x0_t, q_des, lanes, consts = _torch_inputs(tprob, x0, us, scen)
    if shared:
        lanes = tprob.rollout_lanes(None)
    args, xs = ro.launch_args(x0_t, q_des, lanes, consts)
    assert host_build(*args, None) == 0
    plain = lambda x: ro.planner_rollout_plain(torch.from_numpy(x), q_des, lanes,
                                               consts).numpy()
    want = plain(x0)
    tol = TOL[full_rate]
    np.testing.assert_allclose(xs[:, :, 1].numpy(), want[:, :, 1], rtol=tol, atol=tol)
    refs = [plain(_moved(x0)), _float64_plain(x0, q_des, lanes, consts)]
    _assert_within(xs.numpy(), want, refs, tol, case)
    np.testing.assert_array_equal(xs[:, :, 0].numpy(), np.repeat(x0[:, None], R, 1))


# --- the solve through the rollout, against JAX -------------------------------

@pytest.mark.parametrize("full_rate", [False, True], ids=["relaxed", "full_rate"])
def test_solve_mppi_through_lane_rollout_matches_jax(full_rate, monkeypatch):
    """solve_mppi (every rollout one lane_rollout call) against JAX's
    solve_mppi with JAX's draws injected, B = 2 scenarios x K = 8 samples,
    2 iterations, fused accept, at the tolerances of
    tests/test_torch_slice.py's solve test (its reasons: the two packages'
    rounding through the stiff contact; full rate plans H = 4)."""
    horizon, ks, iters = (4 if full_rate else 6), 8, 2
    jprob, tprob = _problems(full_rate, True, horizon)
    cfg = dict(horizon=horizon, iterations=iters, n_samples=ks, fused_accept=True)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    scen = jax.vmap(lambda k: jrnd.sample_scenario(jprob.cfg, "TEST_RANDOMIZER", k))(
        jax.random.split(jax.random.PRNGKey(0), 2))
    x0 = jnp.broadcast_to(jprob.default_x0(), (2, 37))
    u0 = jnp.broadcast_to(jprob.task_warm_start(), (2, horizon, jprob.action_dim))
    jcfg = jmppi.MPPIConfig(**cfg)
    jsol = jax.jit(jax.vmap(lambda x, u, k, s: jprob.solve_mppi(x, u, k, jcfg, s)))(
        x0, u0, keys, scen)
    noise = jax.vmap(lambda k: jax.vmap(
        lambda ki: jax.random.normal(ki, (ks, horizon, jprob.action_dim), jnp.float32))(
        jax.random.split(k, iters)))(keys)
    noise = torch.from_numpy(np.array(noise)).transpose(0, 1).contiguous()
    calls = []
    rollout = tprob.lane_rollout

    def counted(scenario):
        f = rollout(scenario)
        return lambda x, u: calls.append(u.shape) or f(x, u)

    monkeypatch.setattr(tprob, "lane_rollout", counted)
    tsol = tprob.solve_mppi(torch.from_numpy(np.array(x0)), torch.from_numpy(np.array(u0)),
                            None, tmppi.MPPIConfig(**cfg), convert.scenario_params(scen), noise)
    assert len(calls) == iters + 1          # one rollout per iteration, one to settle
    xs_tol = 5e-3 if full_rate else 1e-3
    np.testing.assert_allclose(tsol.us, jsol.us, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsol.cost, jsol.cost, rtol=1e-5)
    np.testing.assert_allclose(tsol.cost_trace, jsol.cost_trace, rtol=1e-5)
    np.testing.assert_allclose(tsol.xs, jsol.xs, rtol=xs_tol, atol=xs_tol)


# --- the wrapper's refusals ----------------------------------------------------

def test_wrapper_refuses_bf16_wrong_shapes_and_vmap():
    x0, us, scen = _case(True)
    _, tprob = _problems(False, True)
    x0_t, q_des, lanes, consts = _torch_inputs(tprob, x0, us, scen)
    with pytest.raises(TypeError, match="float32"):
        ro.planner_rollout(x0_t.bfloat16(), q_des, lanes, consts)
    with pytest.raises(TypeError, match="float32"):
        ro.planner_rollout(x0_t, q_des.bfloat16(), lanes, consts)
    with pytest.raises(ValueError, match="expected"):
        ro.planner_rollout(x0_t, q_des[:, :, :, :6], lanes, consts)
    with pytest.raises(ValueError, match="expected"):
        ro.planner_rollout(x0_t[:2], q_des, lanes, consts)
    with pytest.raises(ValueError, match="scenario rows"):
        ro.launch_args(x0_t, q_des, dataclasses.replace(
            lanes, spring_k=lanes.spring_k[:2]), consts)
    with pytest.raises(NotImplementedError, match="vmap"):
        torch.func.vmap(lambda x: ro.planner_rollout(x, q_des, lanes, consts))(
            x0_t[None].expand(2, -1, -1))
    with pytest.raises(ValueError, match="no kernel for device"):
        ro.planner_rollout(x0_t.to("meta"), q_des.to("meta"), lanes, consts)
