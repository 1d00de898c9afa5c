"""The tie rule of the actuation and contact clips against the JAX package's.

``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, and JAX differentiates
``maximum`` and ``minimum`` at a tie as one half to each argument. Each clip
below is placed exactly at its bound with values that are exact in float32
(powers of two, or a command solved for the limit and checked to land on
it), and the Jacobians of the port's plain versions by ``torch.func.jacfwd``
(forward mode) and ``jacrev`` (reverse mode) are held to ``jax.jacfwd`` and
``jax.jacrev`` of the JAX package's functions, exactly (both sides compute
the same products of powers of two and halves):

  * ``ops/actuation.py`` ``pd_torque`` and ``torque_command``: the torque
    clip at +limit, -limit, inside and outside, in q_des, q and qd;
  * ``models/dynamics.py`` ``contact_forces_plain``: the damping clip at
    +elastic and -elastic (the second puts the normal force's floor at its
    tie too), the floor's tie without the damping clip, inside and
    outside, in the penetration and the site velocities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.models import dynamics as jdyn
from quadruped_springs_tpu.ops import actuation as jact
from quadruped_springs_tpu_torch.models import dynamics as tdyn
from quadruped_springs_tpu_torch.ops import actuation as tact

KP, KD = 32.0, 0.5
LIMIT = np.float32([8.0, 8.0, 8.0])
KN, DN, V_TOL, MU = 4096.0, 32.0, 0.02, 0.75
PHI = 2.0 ** -10                  # elastic force KN·PHI = 4 N


def _jacobians(fn_torch, fn_jax, args):
    """(torch jacfwd, torch jacrev, jax jacfwd, jax jacrev) of fn in every
    argument, as numpy."""
    t_args = tuple(torch.tensor(a) for a in args)
    j_args = tuple(jnp.asarray(a) for a in args)
    idx = tuple(range(len(args)))
    fwd = torch.func.jacfwd(fn_torch, argnums=idx)(*t_args)
    rev = torch.func.jacrev(fn_torch, argnums=idx)(*t_args)
    jfwd = jax.jacfwd(fn_jax, argnums=idx)(*j_args)
    jrev = jax.jacrev(fn_jax, argnums=idx)(*j_args)
    as_np = lambda tree: [np.asarray(x) for x in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy() if torch.is_tensor(t) else t, tree,
                     is_leaf=torch.is_tensor))]
    return as_np(fwd), as_np(rev), as_np(jfwd), as_np(jrev)


def _pd_inputs():
    """q_des solved so that the three joints' PD torque sits at +limit,
    -limit and inside."""
    q = np.float32([0.25, 0.25, 0.25])
    qd = np.float32([0.0, 0.0, 0.5])
    q_des = np.float32([0.5, 0.0, 0.3])        # 32·0.25 = 8, 32·(-0.25) = -8, inside
    tau = -KP * (q - q_des) - KD * qd
    assert tau[0] == LIMIT[0] and tau[1] == -LIMIT[1] and abs(tau[2]) < LIMIT[2]
    return q_des, q, qd


def _go1_tie():
    """Go1's gains (kp 100, kd 1) at a command 0.237 rad ahead of the joint,
    and the limit set to the torque that gives in float32: the torque sits
    exactly on its limit."""
    kp, kd = np.float32(100.0), np.float32(1.0)
    q, qd = np.float32([0.31]), np.float32([0.0])
    q_des = np.float32([0.547])
    tau = np.float32(-kp * (q - q_des) - kd * qd)
    assert tau.dtype == np.float32 and abs(float(tau[0]) - 23.7) < 1e-4
    return q_des, q, qd, kp, kd, tau


def test_pd_torque_tie_matches_jax():
    """jnp.clip's one half at ±limit, one inside, in every argument; the
    values equal."""
    q_des, q, qd = _pd_inputs()
    lim_t, lim_j = torch.tensor(LIMIT), jnp.asarray(LIMIT)
    f_t = lambda a, b, c: tact.pd_torque(a, b, c, KP, KD, lim_t)
    f_j = lambda a, b, c: jact.pd_torque(a, b, c, KP, KD, lim_j)
    assert np.array_equal(f_t(*map(torch.tensor, (q_des, q, qd))).numpy(),
                          np.asarray(f_j(q_des, q, qd)))
    fwd, rev, jfwd, jrev = _jacobians(f_t, f_j, (q_des, q, qd))
    for got in (fwd, rev):
        for g, w in zip(got, jfwd):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(jfwd, jrev):
        np.testing.assert_array_equal(g, w)
    # the tie halves the inside derivative d tau / d q_des = kp
    assert np.diag(jfwd[0]).tolist() == [0.5 * KP, 0.5 * KP, KP]


def test_pd_torque_tie_at_go1_gains_matches_jax():
    q_des, q, qd, kp, kd, lim = _go1_tie()
    f_t = lambda a, b, c: tact.pd_torque(a, b, c, float(kp), float(kd), torch.tensor(lim))
    f_j = lambda a, b, c: jact.pd_torque(a, b, c, float(kp), float(kd), jnp.asarray(lim))
    fwd, rev, jfwd, jrev = _jacobians(f_t, f_j, (q_des, q, qd))
    for got in (fwd, rev, jrev):
        for g, w in zip(got, jfwd):
            np.testing.assert_array_equal(g, w)
    assert float(jfwd[0][0, 0]) == 0.5 * float(kp)


def test_torque_command_tie_matches_jax():
    cmd = np.float32([8.0, -8.0, 3.0, 9.0])
    lim = np.float32([8.0, 8.0, 8.0, 8.0])
    f_t = lambda c: tact.torque_command(c, torch.tensor(lim))
    f_j = lambda c: jact.torque_command(c, jnp.asarray(lim))
    fwd, rev, jfwd, jrev = _jacobians(f_t, f_j, (cmd,))
    for got in (fwd, rev, jrev):
        np.testing.assert_array_equal(got[0], jfwd[0])
    assert np.diag(jfwd[0]).tolist() == [0.5, 0.5, 1.0, 0.0]


# site z velocities: the damping DN·(-vz) at +elastic, at -elastic (the
# floor's tie as well), inside, and clipped above
CONTACT_VZ = np.float32([-0.125, 0.125, 0.0625, -0.25, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                         0.0])


@pytest.mark.parametrize("clamp_damping", [True, False])
def test_contact_ties_match_jax(clamp_damping):
    """The damping clip and the normal force's floor (jnp.clip and
    jnp.maximum in JAX): every Jacobian of the forces and fn in the
    penetration and the site velocities equal JAX's; without the damping
    clip site 1 still sits on the floor's tie (elastic + damping = 0)."""
    phi = np.full(12, PHI, np.float32)
    phi[5:] = -PHI                                   # out of contact
    v_w = np.zeros((12, 3), np.float32)
    v_w[:, 2] = CONTACT_VZ
    v_w[:, 0] = np.float32(0.5)                      # sliding: the cone's scale is live
    params = jdyn.SimParams(contact_stiffness=jnp.float32(KN), contact_damping=jnp.float32(DN),
                            friction=jnp.float32(MU), slip_vel_tol=V_TOL,
                            clamp_damping=clamp_damping)

    def f_t(ph, v):
        f, fn, _ = tdyn.contact_forces_plain(ph[None], v[None], MU, KN, DN, V_TOL,
                                             clamp_damping)
        return f[0], fn[0]

    def f_j(ph, v):
        p_w = jnp.zeros((12, 3)).at[:, 2].set(-ph)
        f, fn, _, _ = jdyn.contact_forces(None, params, p_w, v, radii=jnp.zeros(12))
        return f, fn

    got = f_t(torch.tensor(phi), torch.tensor(v_w))
    want = f_j(jnp.asarray(phi), jnp.asarray(v_w))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[1][1]) == 0.0                   # site 1 on the floor
    fwd, rev, jfwd, jrev = _jacobians(f_t, f_j, (phi, v_w))
    for got in (fwd, rev, jrev):
        for g, w in zip(got, jfwd):
            np.testing.assert_array_equal(g, w)
    d_fn_d_vz = np.asarray(jfwd[3])[np.arange(12), np.arange(12), 2]   # site by site
    d_fn_d_phi = np.diag(np.asarray(jfwd[2]))
    if clamp_damping:
        # +elastic: d fn/d phi = KN (1 + 1/2), d fn/d vz = -DN/2; -elastic,
        # where the floor ties too: one half of one half; inside: KN and -DN;
        # clipped above: 2 KN and 0; clipped below (fn = 0 on the floor): 0
        assert d_fn_d_phi[:5].tolist() == [1.5 * KN, 0.25 * KN, KN, 2 * KN, 0.0]
        assert d_fn_d_vz[:5].tolist() == [-0.5 * DN, -0.25 * DN, -DN, 0.0, 0.0]
    else:
        # the floor's tie at site 1 (4 - 32·0.125 = 0): one half
        assert d_fn_d_phi[1] == 0.5 * KN and d_fn_d_vz[1] == -0.5 * DN

