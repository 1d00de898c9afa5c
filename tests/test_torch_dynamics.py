"""Parity of the port's dynamics (quadruped_springs_tpu_torch.models.dynamics)
with the JAX package, on the CPU: the contact twin over all 12 sites with
the damping clamp on and off, forward dynamics against both JAX paths
(structured "ref" and scalarized "soa") in the contact, deep-contact and
flight regimes on randomized models with an external force, the Euler
step, and the on-rack mode. Inputs come from a numpy seed and go to both sides.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env import randomizers as jrnd
from quadruped_springs_tpu.models import dynamics as jdyn
from quadruped_springs_tpu.models.go1_params import build_model, go1_config
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.models import dynamics as tdyn

N = 8
REGIMES = {"contact": 0.30, "deep_contact": 0.15, "flight": 0.8}

# Tolerances of tests/test_dynamics_soa.py, which holds the two JAX paths to
# each other: the 18x18 solve in f32 amplifies rounding by the mass
# matrix's condition number, and every implementation orders its sums (and
# solves: LU, adjugate, Cholesky) differently. The accelerations are held
# to these plus the two JAX paths' own elementwise disagreement, which
# exceeds them on the deepest stiff-contact lanes here (|qdd| ~ 1e6).
TOL_A0 = dict(rtol=2e-4, atol=2e-3)
TOL_QDD = dict(rtol=2e-4, atol=2e-2)
TOL_FOOT_POS = dict(rtol=0, atol=1e-5)
TOL_FOOT_VEL = dict(rtol=0, atol=1e-4)
TOL_FORCES = dict(rtol=1e-4, atol=1e-2)


def _random_states(seed, z, n=N):
    """Random states biased upright, feet near the ground for z ~ 0.3."""
    rng = np.random.default_rng(seed)
    quat = rng.standard_normal((n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    quat = quat + 4.0 * np.array([0.0, 0.0, 0.0, 1.0])
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    init_q = np.asarray(go1_config(True).init_joint_angles)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        pos=f32(np.array([0.0, 0.0, z]) + 0.02 * rng.standard_normal((n, 3))),
        quat=f32(quat),
        lin_vel=f32(0.5 * rng.standard_normal((n, 3))),
        ang_vel=f32(0.5 * rng.standard_normal((n, 3))),
        q=f32(init_q + 0.3 * rng.standard_normal((n, 12))),
        qd=f32(2.0 * rng.standard_normal((n, 12))),
    )


def _jstate(d):
    return jdyn.RobotState(**{k: jnp.asarray(v) for k, v in d.items()})


def _tstate(d):
    return tdyn.RobotState(**{k: torch.from_numpy(v) for k, v in d.items()})


def _close(actual, expected, **tol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected), **tol)


def _close_within_spread(actual, expected, spread, rtol, atol):
    """|actual - expected| <= atol + rtol·|expected| + spread, elementwise."""
    actual, expected = np.asarray(actual), np.asarray(expected)
    bound = atol + rtol * np.abs(expected) + np.asarray(spread)
    excess = np.abs(actual - expected) - bound
    assert np.all(excess <= 0), f"max excess over the bound: {excess.max()}"


def _regime_inputs():
    """States of every regime stacked on one lane axis (N lanes each), one
    JAX-sampled TEST_RANDOMIZER scenario per lane (masses, offset mass,
    friction), joint torques, and an external trunk force on odd lanes."""
    states = [_random_states(int(z * 100), z) for z in REGIMES.values()]
    d = {k: np.concatenate([s[k] for s in states]) for k in states[0]}
    n = len(REGIMES) * N
    rng = np.random.default_rng(7)
    tau = (5.0 * rng.standard_normal((n, 12))).astype(np.float32)
    f_ext = np.zeros((n, 3), np.float32)
    f_ext[1::2] = [20.0, -10.0, 5.0]
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    scen = jax.vmap(lambda k: jrnd.sample_scenario(go1_config(True), "TEST_RANDOMIZER",
                                                   k))(keys)
    return d, tau, f_ext, scen


def _torch_lanes(scen):
    model = convert.go1_model(jax.vmap(jrnd.model_from_params)(scen))
    params = tdyn.SimParams(friction=torch.from_numpy(np.array(scen.friction)))
    return model, params


def _regime(regime):
    i = list(REGIMES).index(regime)
    return slice(i * N, (i + 1) * N)


@functools.lru_cache(maxsize=None)
def _jax_forward(impl):
    """JAX forward dynamics of all regimes' lanes in one vmapped call (one
    compile per impl)."""
    d, tau, f_ext, scen = _regime_inputs()

    def fd(sc, s, t, f):
        params = jdyn.default_sim_params().replace(friction=sc.friction)
        return jdyn.forward_dynamics(jrnd.model_from_params(sc), params, s, t, f,
                                     impl=impl)

    a0, qdd, info = jax.jit(jax.vmap(fd))(scen, _jstate(d), jnp.asarray(tau),
                                          jnp.asarray(f_ext))
    return a0, qdd, info


@functools.lru_cache(maxsize=None)
def _torch_forward():
    d, tau, f_ext, scen = _regime_inputs()
    model, params = _torch_lanes(scen)
    return tdyn.forward_dynamics(model, params, _tstate(d), torch.from_numpy(tau),
                                 torch.from_numpy(f_ext))


@pytest.mark.parametrize("impl", ["ref", "soa"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_forward_dynamics_matches_jax(regime, impl):
    """Randomized models, per-lane friction and an external force on half
    the lanes, against both JAX paths."""
    sl = _regime(regime)
    a_j, qdd_j, info_j = _jax_forward(impl)
    a_t, qdd_t, info_t = _torch_forward()
    (a_ref, qdd_ref, _), (a_soa, qdd_soa, _) = _jax_forward("ref"), _jax_forward("soa")
    spread_a, spread_qdd = np.abs(a_soa - a_ref)[sl], np.abs(qdd_soa - qdd_ref)[sl]
    _close_within_spread(a_t[sl], a_j[sl], spread_a, **TOL_A0)
    _close_within_spread(qdd_t[sl], qdd_j[sl], spread_qdd, **TOL_QDD)
    for k, tol in (("foot_pos_world", TOL_FOOT_POS), ("foot_vel_world", TOL_FOOT_VEL),
                   ("foot_forces", TOL_FORCES)):
        _close(info_t[k][sl], info_j[k][sl], **tol)
    for k in ("feet_in_contact", "invalid_contact"):
        np.testing.assert_array_equal(info_t[k][sl], info_j[k][sl])
    assert info_t["feet_in_contact"][sl].any() == (regime != "flight")


def test_step_matches_jax():
    """One Euler step of every regime's lanes on the planner's relaxed
    contact (4 kN/m, no damping clamp, dt = 5 ms) against the JAX default
    (structured) path. The velocities carry the accelerations times dt."""
    d, tau, f_ext, scen = _regime_inputs()
    vel_lim = go1_config(True).velocity_limits
    jplanner = jdyn.default_sim_params(0.005).replace(
        contact_stiffness=jnp.asarray(4000.0), contact_damping=jnp.asarray(40.0),
        clamp_damping=False)

    def st(sc, s, t, f):
        params = jplanner.replace(friction=sc.friction)
        return jdyn.step(jrnd.model_from_params(sc), params, s, t, vel_lim, f,
                         impl="ref")[0]

    js = jax.jit(jax.vmap(st))(scen, _jstate(d), jnp.asarray(tau), jnp.asarray(f_ext))
    model, params = _torch_lanes(scen)
    params = dataclasses.replace(params, dt=0.005, contact_stiffness=4000.0,
                                 contact_damping=40.0, clamp_damping=False)
    ts, _ = tdyn.step(model, params, _tstate(d), torch.from_numpy(tau),
                      torch.tensor(np.asarray(vel_lim)), torch.from_numpy(f_ext))
    for f in ("pos", "quat", "q"):
        _close(getattr(ts, f), getattr(js, f), rtol=0, atol=1e-5)
    _close(ts.lin_vel, js.lin_vel, rtol=2e-4, atol=1e-5)
    _close(ts.ang_vel, js.ang_vel, rtol=2e-4, atol=1e-5)
    _close(ts.qd, js.qd, rtol=2e-4, atol=1e-4)


def test_on_rack_matches_jax():
    d = _random_states(2, 1.0)
    tau = np.ones((N, 12), np.float32)
    model, params = build_model(), jdyn.default_sim_params(on_rack=True)
    _, qdd_j, _ = jax.jit(jax.vmap(lambda s, t: jdyn.forward_dynamics(
        model, params, s, t, impl="ref")))(_jstate(d), jnp.asarray(tau))
    a_t, qdd_t, _ = tdyn.forward_dynamics(convert.go1_model(model),
                                          convert.sim_params(params), _tstate(d),
                                          torch.from_numpy(tau))
    assert torch.all(a_t == 0)
    _close(qdd_t, qdd_j, **TOL_QDD)


def _contact_inputs(seed, n=64):
    """Site positions within ±1 cm of touching and velocities up to ~1 m/s,
    plus hand-placed edge rows: φ ≤ 0 exactly, tangential speed² below the
    1e-12 floor, and tangential speed just below and above v_tol = 0.02."""
    rng = np.random.default_rng(seed)
    radii = np.asarray(jdyn.contact_sites(build_model(),
                                          jdyn.leg_fk_base(build_model(),
                                                           jnp.zeros(12)))[1])
    p_w = rng.uniform(-0.5, 0.5, (n, 12, 3))
    p_w[..., 2] = radii + rng.uniform(-0.01, 0.01, (n, 12))
    v_w = rng.standard_normal((n, 12, 3))
    p_w[0, :, 2] = radii                        # φ = 0: not in contact
    p_w[1:5, :, 2] = radii - 0.005              # in contact
    v_w[1, :, :2] = 3e-7                        # |v_t|² = 1.8e-13 < 1e-12
    v_w[2, :, :2] = 0.0
    v_w[3, :, :2] = [0.0199, 0.0]               # just below v_tol
    v_w[4, :, :2] = [0.0, 0.0201]               # just above v_tol
    mu = rng.uniform(0.5, 1.0, n)
    f32 = lambda a: np.array(a, np.float32)
    return f32(p_w), f32(v_w), f32(radii), f32(mu)


@pytest.mark.parametrize("clamp", [False, True], ids=["clamp_off", "clamp_on"])
def test_contact_forces_match_jax(clamp):
    """The contact twin (and the CPU branch of contact_forces) against JAX's
    memoryless contact_forces with per-lane friction. Same operations in
    the same order on IEEE f32, so only the last bit may differ."""
    p_w, v_w, radii, mu = _contact_inputs(17)
    kn, dn = 4000.0, 40.0
    jmodel = build_model()
    base = jdyn.default_sim_params().replace(
        contact_stiffness=jnp.asarray(kn), contact_damping=jnp.asarray(dn),
        clamp_damping=clamp)
    f_j, fn_j, inc_j, _ = jax.vmap(lambda p, v, m: jdyn.contact_forces(
        jmodel, base.replace(friction=m), p, v, jnp.asarray(radii)))(
        jnp.asarray(p_w), jnp.asarray(v_w), jnp.asarray(mu))
    phi = torch.from_numpy(radii) - torch.from_numpy(p_w)[..., 2]
    twin = tdyn.contact_forces_plain(phi, torch.from_numpy(v_w), torch.from_numpy(mu),
                                     kn, dn, 0.02, clamp)
    params = tdyn.SimParams(dt=0.005, contact_stiffness=kn, contact_damping=dn,
                            friction=torch.from_numpy(mu), clamp_damping=clamp)
    wrapped = tdyn.contact_forces(convert.go1_model(jmodel), params,
                                  torch.from_numpy(p_w), torch.from_numpy(v_w),
                                  torch.from_numpy(radii))
    for f_t, fn_t, inc_t in (twin, wrapped[:3]):
        _close(f_t, f_j, rtol=1e-6, atol=1e-6)
        _close(fn_t, fn_j, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(inc_t, inc_j)
    assert not np.asarray(inc_j)[0].any() and np.asarray(inc_j)[1:5].all()
    assert wrapped[3] is None


def test_foot_anchor_is_not_ported_yet():
    """Foot-anchor stiction is ported now (tests/test_torch_stiction.py holds
    it to JAX): contact_forces takes foot_anchor and returns the new
    anchors, here of a foot pressed 1 cm into the ground 1 mm from its
    anchor, which stays (the spring force is inside the friction cone)."""
    model = convert.go1_model(build_model())
    p_w = torch.zeros(1, 12, 3)
    p_w[0, :, 2] = 1.0
    p_w[0, 0, 2] = 0.01
    anchor = torch.zeros(1, 4, 2)
    anchor[0, 0, 0] = 1e-3
    f, fn, inc, new = tdyn.contact_forces(model, tdyn.default_sim_params(), p_w,
                                          torch.zeros(1, 12, 3), torch.full((12,), 0.02),
                                          foot_anchor=anchor)
    assert bool(inc[0, 0]) and not bool(inc[0, 1:].any())
    assert torch.equal(new[0, 0], anchor[0, 0])
    np.testing.assert_allclose(f[0, 0].numpy(), [120.0, 0.0, 1800.0], rtol=1e-5)
