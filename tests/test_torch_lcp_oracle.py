"""The port's rigid-contact LCP oracle (utils/lcp_oracle.py) and the four
diagnostics of models/dynamics.py it builds on (mass_matrix,
kinetic_energy, potential_energy, inverse_dynamics), against the JAX
package on the CPU, in float32 and float64.

The JAX oracle evaluates its smooth terms in float32 (its OracleState.
to_robot_state casts); the port's evaluates them in float64. The float64
comparison gives the JAX oracle float64 smooth terms inside
jax.enable_x64 (its model cast to float64, the state passed uncast) and
the port the same model values, so both integrate the same equations in
float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env.env import EnvConfig as JEnvConfig
from quadruped_springs_tpu.env.env import QuadrupedEnv as JQuadrupedEnv
from quadruped_springs_tpu.models import dynamics as jdyn
from quadruped_springs_tpu.models.go1_params import build_model as jbuild_model
from quadruped_springs_tpu.models.go1_params import go1_config as jgo1_config
from quadruped_springs_tpu.utils import lcp_oracle as jlo
from quadruped_springs_tpu.utils import verification as JV
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.models import dynamics as tdyn
from quadruped_springs_tpu_torch.models.go1_params import build_model
from quadruped_springs_tpu_torch.utils import lcp_oracle as tlo
from quadruped_springs_tpu_torch.utils import verification as V

CFG = jgo1_config(True)
Q_INIT = np.asarray(CFG.init_joint_angles, np.float64)
STEPS = 50


def _init(cls, z=0.32):
    """tests/test_lcp_oracle.py's initial state."""
    return cls(pos=np.array([0.0, 0.0, z]), quat=np.array([0.0, 0.0, 0.0, 1.0]),
               lin_vel=np.zeros(3), ang_vel=np.zeros(3), q=Q_INIT.copy(), qd=np.zeros(12))


def _pd(st, q_des, kp=75.0):
    """tests/test_lcp_oracle.py's PD law."""
    kd = np.asarray(CFG.motor_kd, np.float64) * np.ones(12)
    lim = np.asarray(CFG.torque_limits, np.float64)
    return np.clip(-kp * (st.q - q_des) - kd * st.qd, -lim, lim)


def _roll(oracle, st, n=STEPS):
    out = []
    for _ in range(n):
        st = oracle.step(st, _pd(st, Q_INIT))
        out.append(np.concatenate([st.pos, st.quat, st.lin_vel, st.ang_vel, st.q, st.qd]))
    return np.stack(out)


def _as_dtype(model, dtype):
    return dataclasses.replace(model, **{
        f.name: getattr(model, f.name).to(dtype) for f in dataclasses.fields(model)
        if torch.is_tensor(getattr(model, f.name))})


def _jax_f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64)
                        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


@pytest.fixture(scope="module")
def jax_model():
    return jbuild_model()


def test_oracle_matches_jax_in_float64(jax_model, monkeypatch):
    """50 PD steps from the init stance (feet landing: contact rows, PGS,
    split impulse), both in float64: within 1e-8 + 1e-8·|x|."""
    monkeypatch.setattr(jlo.OracleState, "to_robot_state", lambda self: jdyn.RobotState(
        *(jnp.asarray(getattr(self, f), jnp.float64)
          for f in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"))))
    with jax.enable_x64(True):
        joracle = jlo.LCPOracle()
        joracle.model = _jax_f64(jax_model)
        joracle._terms = jax.jit(lambda s: jlo._smooth_terms(joracle.model, s))
        want = _roll(joracle, _init(jlo.OracleState))
    oracle = tlo.LCPOracle(device="cpu")
    oracle.model = _as_dtype(convert.go1_model(jax_model, "cpu"), torch.float64)
    got = _roll(oracle, _init(tlo.OracleState))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)
    assert np.abs(got[:, 2] - got[0, 2]).max() > 1e-3     # it moved


def test_oracle_matches_the_jax_oracle_as_shipped():
    """Against the JAX oracle with its float32 smooth terms and its own
    model: within 1e-5 over the same 50 steps (measured 1.2e-6)."""
    got = _roll(tlo.LCPOracle(device="cpu"), _init(tlo.OracleState))
    want = _roll(jlo.LCPOracle(), _init(jlo.OracleState))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_oracle_flight_matches_the_port_dynamics():
    """tests/test_lcp_oracle.py::test_flight_phase_matches_production_dynamics
    on the port: with no contact the oracle is the smooth dynamics, so 20
    torque-free steps from 1 m agree with the port's dyn.step."""
    oracle = tlo.LCPOracle(device="cpu")
    st = _init(tlo.OracleState, z=1.0)
    rs = st.to_robot_state("cpu")
    model = _as_dtype(oracle.model, torch.float32)
    params = tdyn.default_sim_params(0.001)
    vel = torch.full((12,), 30.1)
    for _ in range(20):
        st = oracle.step(st, np.zeros(12))
        rs, _ = tdyn.step(model, params, rs, torch.zeros(1, 12), vel)
    assert not oracle.feet_in_contact(st).any()
    np.testing.assert_allclose(st.pos, rs.pos[0].numpy(), atol=2e-4)
    np.testing.assert_allclose(st.q, rs.q[0].numpy(), atol=2e-4)
    np.testing.assert_allclose(st.lin_vel, rs.lin_vel[0].numpy(), atol=2e-3)


def test_record_oracle_trace_matches_jax():
    """A shortened oracle recording (a 20-substep settle, the first 3
    steps of the BACKFLIP script) through both packages: the same rows
    within 1e-5 (JAX's smooth terms are float32), and the state crosses
    between the packages through convert.oracle_state."""
    jenv = JQuadrupedEnv(JEnvConfig(**dict(
        enable_springs=True, task_env="BACKFLIP", observation_space_mode="ARS_BASIC",
        action_space_mode="SYMMETRIC", env_randomizer_mode="NONE", obs_noise=False)))
    env = V.fidelity_env("BACKFLIP", device="cpu")
    want = JV.record_oracle_trace(jenv, JV.task_action_script("BACKFLIP")[:3], 20)
    got = V.record_oracle_trace(env, V.task_action_script("BACKFLIP", device="cpu")[:3], 20)
    assert got.shape == want.shape == (3, 1 + 6 + 4 * 12 + 13)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    st = _init(jlo.OracleState)
    ported = convert.oracle_state(st)
    assert isinstance(ported, tlo.OracleState)
    for f in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        np.testing.assert_array_equal(getattr(ported, f), getattr(st, f))
    back = tlo.OracleState.from_robot_state(ported.to_robot_state("cpu", torch.float64))
    np.testing.assert_array_equal(back.q, st.q)


def _states(seed, n=3):
    """Random states: near the stance, tilted, with velocities."""
    rng = np.random.default_rng(seed)
    quat = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)) + 0.2 * rng.standard_normal((n, 4))
    return dict(pos=np.array([0.0, 0.0, 0.3]) + 0.05 * rng.standard_normal((n, 3)),
                quat=quat / np.linalg.norm(quat, axis=-1, keepdims=True),
                lin_vel=rng.standard_normal((n, 3)), ang_vel=rng.standard_normal((n, 3)),
                q=Q_INIT + 0.3 * rng.standard_normal((n, 12)),
                qd=3.0 * rng.standard_normal((n, 12)))


# float32: rounding of the 18x18 products at |M| ~ 10, |h| ~ 1e2; float64:
# the same equations on the same model values
DIAG_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4), torch.float64: dict(rtol=1e-10,
                                                                            atol=1e-10)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_dynamics_diagnostics_match_jax(jax_model, dtype):
    d = _states(7)
    rng = np.random.default_rng(8)
    a0, qdd = rng.standard_normal((3, 6)), 10.0 * rng.standard_normal((3, 12))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    tmodel = _as_dtype(convert.go1_model(jax_model, "cpu"), dtype)
    ts = tdyn.RobotState(**{k: torch.tensor(v, dtype=dtype) for k, v in d.items()})
    got = {"M": tdyn.mass_matrix(tmodel, ts.q),
           "ke": tdyn.kinetic_energy(tmodel, ts),
           "pe": tdyn.potential_energy(tmodel, ts),
           "id": tdyn.inverse_dynamics(tmodel, ts, torch.tensor(a0, dtype=dtype),
                                       torch.tensor(qdd, dtype=dtype))}
    with jax.enable_x64(dtype == torch.float64):
        model = _jax_f64(jax_model) if dtype == torch.float64 else jax_model
        js = jdyn.RobotState(**{k: jnp.asarray(v, np_dtype) for k, v in d.items()})
        want = {"M": jax.vmap(lambda q: jdyn.mass_matrix(model, q))(js.q),
                "ke": jax.vmap(lambda s: jdyn.kinetic_energy(model, s))(js),
                "pe": jax.vmap(lambda s: jdyn.potential_energy(model, s))(js),
                "id": jax.vmap(lambda s, a, b: jdyn.inverse_dynamics(model, s, a, b))(
                    js, jnp.asarray(a0, np_dtype), jnp.asarray(qdd, np_dtype))}
        want = {k: np.asarray(v) for k, v in want.items()}
    for k in want:
        assert got[k].dtype == dtype
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **DIAG_TOL[dtype])
    # M is symmetric positive definite
    M = got["M"].double()
    np.testing.assert_allclose(M.numpy(), M.transpose(-1, -2).numpy(), atol=1e-6)
    assert bool((torch.linalg.eigvalsh(M) > 0).all())


def test_inverse_dynamics_inverts_forward_dynamics():
    """ID(FD(tau)) == tau_gen in float64 on airborne lanes (no contact):
    the base rows 0, the joint rows the applied torque (the joint-limit
    penalty is zero within the limits), up to the 1e-9 that solve_star adds
    to the diagonals of its blocks, times the accelerations."""
    model = build_model(dtype=torch.float64, device="cpu")
    d = _states(9)
    d["pos"][:, 2] = 1.5
    d["q"] = Q_INIT + 0.05 * np.random.default_rng(10).standard_normal((3, 12))
    state = tdyn.RobotState(**{k: torch.tensor(v) for k, v in d.items()})
    tau = torch.tensor(np.random.default_rng(11).uniform(-20, 20, (3, 12)))
    a0, qdd, info = tdyn.forward_dynamics(model, tdyn.default_sim_params(), state, tau)
    assert not bool(info["feet_in_contact"].any())
    tau_gen = tdyn.inverse_dynamics(model, state, a0, qdd)
    tol = 2e-9 * float(torch.cat([a0, qdd], dim=-1).abs().max())
    want = torch.cat([torch.zeros(3, 6, dtype=torch.float64), tau], dim=-1)
    np.testing.assert_allclose(tau_gen.numpy(), want.numpy(), rtol=0, atol=tol)
