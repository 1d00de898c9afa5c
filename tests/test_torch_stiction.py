"""Parity of the port's foot-anchor stiction with the JAX package on the CPU:
the anchored contact law (the twin of the `contact_anchored` CUDA kernel and
the CPU branch of contact_forces) against JAX's structured ("ref")
contact_forces in every regime with the damping clamp on and off, the
|f_trial|² floor the port shares with ref, the anchored forward dynamics
against both JAX paths ("ref" and "soa") within their spread, and one
anchored Euler step. Inputs come from a numpy seed and go to both sides.
"""

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

N = 64
KN, DN, KT, CT = 180000.0, 100.0, 120000.0, 60.0
RADII = np.array([0.02] * 4 + [0.008] * 4 + [0.055] * 4, np.float32)
# Same IEEE f32 operations in the same order as JAX's ref path: forces of
# up to ~2 kN may differ in the last bit (2.4e-4 N), anchors at |x| <= 0.5 m
# by one ulp (6e-8 m).
TOL_F = dict(rtol=1e-6, atol=1e-5)
TOL_ANCHOR = dict(rtol=0, atol=1e-7)


def _contact_inputs(seed):
    """Sites within ±1 cm of the ground moving at up to ~0.5 m/s, anchors
    0-3 mm from the feet (inside and on the friction cone), plus hand-placed
    lanes: 0 φ = 0 exactly, 1 airborne, 2 deep inside the cone, 3 far on the
    cone boundary, 4 |f_trial| = 0 exactly (anchor under a still foot)."""
    rng = np.random.default_rng(seed)
    p_w = rng.uniform(-0.5, 0.5, (N, 12, 3))
    p_w[..., 2] = RADII + rng.uniform(-0.01, 0.01, (N, 12))
    v_w = 0.3 * rng.standard_normal((N, 12, 3))
    anchor = p_w[:, :4, :2] + rng.uniform(-3e-3, 3e-3, (N, 4, 2))
    p_w[0, :, 2] = RADII
    p_w[1, :, 2] = RADII + 0.01
    p_w[2:5, :, 2] = RADII - 0.004
    v_w[2:5] = 0.0
    anchor[2] = p_w[2, :4, :2] + 1e-5
    anchor[3] = p_w[3, :4, :2] + 0.05
    mu = rng.uniform(0.5, 1.0, N)
    f32 = lambda a: np.array(a, np.float32)
    p_w, v_w, anchor = f32(p_w), f32(v_w), f32(anchor)
    anchor[4] = p_w[4, :4, :2]
    return p_w, v_w, anchor, f32(mu)


def _jax_contact(p_w, v_w, anchor, mu, clamp):
    base = jdyn.default_sim_params().replace(clamp_damping=clamp)
    model = build_model()
    return jax.jit(jax.vmap(lambda p, v, a, m: jdyn.contact_forces(
        model, base.replace(friction=m), p, v, jnp.asarray(RADII), a)))(
        p_w, v_w, anchor, mu)


@pytest.mark.parametrize("clamp", [False, True], ids=["clamp_off", "clamp_on"])
def test_anchored_contact_matches_jax_ref(clamp):
    p_w, v_w, anchor, mu = _contact_inputs(3)
    want = _jax_contact(p_w, v_w, anchor, mu, clamp)
    t = torch.from_numpy
    phi = t(RADII) - t(p_w)[..., 2]
    twin = tdyn.contact_forces_anchored_plain(
        phi, t(v_w), t(p_w)[:, :4, :2], t(anchor), t(mu), KN, DN, KT, CT, 0.02, clamp)
    params = tdyn.SimParams(friction=t(mu), clamp_damping=clamp)
    wrapped = tdyn.contact_forces(convert.go1_model(build_model()), params, t(p_w),
                                  t(v_w), t(RADII), t(anchor))
    for got in (twin, wrapped):
        np.testing.assert_allclose(got[0], want[0], **TOL_F)
        np.testing.assert_allclose(got[1], want[1], **TOL_F)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[3], want[3], **TOL_ANCHOR)
    inc = np.asarray(want[2])[:, :4]
    new = np.asarray(want[3])
    # the hand-placed regimes are where they were meant to be
    assert not inc[:2].any() and inc[2:5].all()
    np.testing.assert_array_equal(new[:2], p_w[:2, :4, :2])      # re-anchored
    np.testing.assert_array_equal(new[2], anchor[2])             # stuck
    np.testing.assert_array_equal(new[4], anchor[4])             # f_trial = 0
    assert np.all(np.abs(new[3] - anchor[3]) > 0.01)             # slid
    ft = np.linalg.norm(np.asarray(want[0])[:, :4, :2], axis=-1)
    fmax = mu[:, None] * np.asarray(want[1])[:, :4]
    on_cone = inc & np.isclose(ft, fmax, rtol=1e-5)
    assert on_cone[5:].sum() > 10 and (inc & ~on_cone)[5:].sum() > 10


def test_anchor_floor_follows_ref():
    """Where |f_trial| <= μ·fn < 1e-6 N the two JAX paths part: ref floors
    |f_trial|² at 1e-12, so the force looks 1e-6 N strong and the anchor
    slides to the cone; soa (floor 1e-18) keeps it. The port follows ref.
    A foot at the origin 4e-13 m from its anchor, still, on a 0.01 N/m
    ground pressed 1e-5 m: f_trial = 4.8e-8 N, μ·fn = 1e-7 N."""
    t = torch.tensor
    phi = t([[1e-5] + [-1.0] * 11])
    v_w = torch.zeros(1, 12, 3)
    foot = torch.zeros(1, 4, 2)
    anchor = torch.zeros(1, 4, 2)
    anchor[0, 0, 0] = 4e-13
    _, fn, inc, new = tdyn.contact_forces_anchored_plain(
        phi, v_w, foot, anchor, t([1.0]), 0.01, 0.0, KT, CT, 0.02, True)
    p_w = np.zeros((12, 3), np.float32)
    p_w[:, 2] = RADII - phi[0].numpy()
    base = jdyn.default_sim_params().replace(contact_stiffness=jnp.asarray(0.01),
                                             contact_damping=jnp.asarray(0.0))
    _, fn_j, _, new_j = jdyn.contact_forces(build_model(), base, jnp.asarray(p_w),
                                            jnp.zeros((12, 3)), jnp.asarray(RADII),
                                            jnp.asarray(anchor[0].numpy()))
    assert bool(inc[0, 0])
    np.testing.assert_allclose(fn[0, 0], 1e-7, rtol=1e-4)
    # the two sides press the ground by 1e-5 m up to f32 rounding of 0.02 - z
    np.testing.assert_allclose(new[0].numpy(), np.asarray(new_j), rtol=1e-3, atol=0)
    assert 0 < float(new[0, 0, 0]) < 1e-13          # slid, as ref does


# --- anchored dynamics against both JAX paths --------------------------------

REGIMES = {"contact": 0.30, "deep_contact": 0.15}


def _states(seed, z, n=16):
    rng = np.random.default_rng(seed)
    quat = rng.standard_normal((n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    quat = quat + 4.0 * np.array([0.0, 0.0, 0.0, 1.0])
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    init_q = np.asarray(go1_config(True).init_joint_angles)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        pos=f32(np.array([0.0, 0.0, z]) + 0.02 * rng.standard_normal((n, 3))),
        quat=f32(quat), lin_vel=f32(0.3 * rng.standard_normal((n, 3))),
        ang_vel=f32(0.3 * rng.standard_normal((n, 3))),
        q=f32(init_q + 0.3 * rng.standard_normal((n, 12))),
        qd=f32(1.0 * rng.standard_normal((n, 12))))


@functools.lru_cache(maxsize=None)
def _dynamics_inputs():
    """States of both regimes, one JAX-sampled TEST_RANDOMIZER scenario per
    lane, torques, and anchors 0.1 mm to 30 cm from the feet (log-uniform),
    so that feet pressed up to 0.2 m deep sit inside and on the cone."""
    states = [_states(int(z * 100) + 1, z) for z in REGIMES.values()]
    d = {k: np.concatenate([s[k] for s in states]) for k in states[0]}
    n = d["q"].shape[0]
    rng = np.random.default_rng(11)
    tau = (5.0 * rng.standard_normal((n, 12))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    scen = jax.vmap(lambda k: jrnd.sample_scenario(go1_config(True), "TEST_RANDOMIZER",
                                                   k))(keys)
    jstate = jdyn.RobotState(**{k: jnp.asarray(v) for k, v in d.items()})
    feet = jax.vmap(lambda sc, s: jdyn.foot_state_world(
        jrnd.model_from_params(sc), s)[0])(scen, jstate)
    anchor = (np.asarray(feet)[..., :2]
              + rng.choice([-1.0, 1.0], (n, 4, 2))
              * 10.0 ** rng.uniform(-4.0, -0.5, (n, 4, 2))).astype(np.float32)
    return d, tau, anchor, scen


def _torch_side():
    d, tau, anchor, scen = _dynamics_inputs()
    model = convert.go1_model(jax.vmap(jrnd.model_from_params)(scen))
    params = tdyn.SimParams(friction=torch.from_numpy(np.array(scen.friction)))
    state = tdyn.RobotState(**{k: torch.from_numpy(v) for k, v in d.items()})
    return model, params, state, torch.from_numpy(tau), torch.from_numpy(anchor)


@functools.lru_cache(maxsize=None)
def _jax_forward(impl):
    d, tau, anchor, scen = _dynamics_inputs()

    def fd(sc, s, t, a):
        params = jdyn.default_sim_params().replace(friction=sc.friction)
        return jdyn.forward_dynamics(jrnd.model_from_params(sc), params, s, t,
                                     impl=impl, foot_anchor=a)

    state = jdyn.RobotState(**{k: jnp.asarray(v) for k, v in d.items()})
    return jax.jit(jax.vmap(fd))(scen, state, jnp.asarray(tau), jnp.asarray(anchor))


def _within_spread(actual, expected, spread, rtol, atol):
    actual, expected = np.asarray(actual), np.asarray(expected)
    excess = np.abs(actual - expected) - (atol + rtol * np.abs(expected) + spread)
    assert np.all(excess <= 0), f"max excess over the bound: {excess.max()}"


@pytest.mark.parametrize("impl", ["ref", "soa"])
def test_anchored_forward_dynamics_matches_jax(impl):
    """Anchored forward dynamics on randomized models in the contact and
    deep-contact regimes against each JAX path, held to the tolerances of
    tests/test_torch_dynamics.py plus the elementwise soa-ref spread (the
    18x18 solve in f32 at 180 kN/m amplifies rounding, and the paths order
    their sums and solves differently)."""
    model, params, state, tau, anchor = _torch_side()
    a_t, qdd_t, info_t = tdyn.forward_dynamics(model, params, state, tau,
                                               foot_anchor=anchor)
    a_j, qdd_j, info_j = _jax_forward(impl)
    (a_r, qdd_r, info_r), (a_s, qdd_s, info_s) = _jax_forward("ref"), _jax_forward("soa")
    _within_spread(a_t, a_j, np.abs(a_s - a_r), rtol=2e-4, atol=2e-3)
    _within_spread(qdd_t, qdd_j, np.abs(qdd_s - qdd_r), rtol=2e-4, atol=2e-2)
    for k, tol in (("new_anchor", dict(rtol=0, atol=1e-7)),
                   ("contact_force_world", dict(rtol=1e-4, atol=1e-2)),
                   ("foot_forces", dict(rtol=1e-4, atol=1e-2))):
        _within_spread(info_t[k], info_j[k], np.abs(info_s[k] - info_r[k]), **tol)
    for k in ("feet_in_contact", "invalid_contact"):
        np.testing.assert_array_equal(info_t[k], info_j[k])
    inc = np.asarray(info_j["feet_in_contact"])
    moved = np.any(np.asarray(info_j["new_anchor"]) != _dynamics_inputs()[2], axis=-1)
    assert inc.mean() > 0.5 and (inc & moved).any() and (inc & ~moved).any()


def test_anchored_step_matches_jax():
    """One 1 ms Euler step with anchors against JAX's default CPU (ref)
    path; the velocities carry qdd·dt, so they inherit its tolerance."""
    d, tau, anchor, scen = _dynamics_inputs()
    vel_lim = go1_config(True).velocity_limits

    def st(sc, s, t, a):
        params = jdyn.default_sim_params().replace(friction=sc.friction)
        return jdyn.step(jrnd.model_from_params(sc), params, s, t, vel_lim,
                         foot_anchor=a, impl="ref")

    js, jinfo = jax.jit(jax.vmap(st))(
        scen, jdyn.RobotState(**{k: jnp.asarray(v) for k, v in d.items()}),
        jnp.asarray(tau), jnp.asarray(anchor))
    model, params, state, t_tau, t_anchor = _torch_side()
    ts, tinfo = tdyn.step(model, params, state, t_tau, torch.tensor(np.asarray(vel_lim)),
                          foot_anchor=t_anchor)
    for f in ("pos", "quat", "q"):
        np.testing.assert_allclose(getattr(ts, f), getattr(js, f), rtol=0, atol=1e-5)
    for f in ("lin_vel", "ang_vel"):
        np.testing.assert_allclose(getattr(ts, f), getattr(js, f), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(ts.qd, js.qd, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(tinfo["new_anchor"], jinfo["new_anchor"], rtol=0, atol=1e-7)
