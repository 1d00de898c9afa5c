"""Parity of the port's actuation (quadruped_springs_tpu_torch.ops.actuation)
with the JAX package on the CPU, where actuation_torque runs its plain twin:
PD + one-sided spring torque with per-scenario spring stiffness/damping,
including joints exactly at the spring's rest angle (engaged: sign·Δq = 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.models.go1_params import go1_config
from quadruped_springs_tpu.ops import actuation as jact
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.ops import actuation as tact

SIGN = torch.as_tensor(tact.SPRING_ENGAGE_SIGN, dtype=torch.float32)


def _inputs(seed, n=64):
    """Joint states around the init pose, commands across the RL range,
    springs ±10% per lane; rows 0-1 exactly at rest, row 2 saturating."""
    cfg = go1_config(True)
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(cfg.rl_lower_angle_joint), np.asarray(cfg.rl_upper_angle_joint)
    q_des = lo + rng.uniform(size=(n, 12)) * (hi - lo)
    q = np.asarray(cfg.init_joint_angles) + 0.5 * rng.standard_normal((n, 12))
    qd = 3.0 * rng.standard_normal((n, 12))
    k = np.asarray(cfg.spring_stiffness) * rng.uniform(0.9, 1.1, (n, 3))
    b = np.asarray(cfg.spring_damping) * rng.uniform(0.9, 1.1, (n, 3))
    rest12 = np.tile(np.asarray(cfg.spring_rest_angles), 4)
    q[0] = q[1] = rest12
    qd[1] = 0.0
    q_des[2] = q[2] + 10.0
    f32 = lambda a: np.asarray(a, np.float32)
    return cfg, f32(q_des), f32(q), f32(qd), f32(k), f32(b)


@pytest.mark.parametrize("springs", [True, False], ids=["springs", "no_springs"])
def test_actuation_matches_jax(springs):
    """Same elementwise operations in the same order on IEEE f32: equal to
    the last bit, so the tolerance is one f32 ulp of the torque scale."""
    cfg, q_des, q, qd, k, b = _inputs(3)
    if not springs:
        k, b = np.zeros_like(k), np.zeros_like(b)
    tau_m_j = jact.pd_torque(q_des, q, qd, cfg.motor_kp, cfg.motor_kd, cfg.torque_limits)
    tau_j = tau_m_j + jact.spring_torque(q, qd, k, b, cfg.spring_rest_angles)
    tcfg = convert.go1_config(cfg)
    t = torch.from_numpy
    tau_t, tau_m_t = tact.actuation_torque(
        t(q_des), t(q), t(qd), tcfg.motor_kp, tcfg.motor_kd, tcfg.torque_limits,
        t(k), t(b), tcfg.spring_rest_angles, SIGN)
    np.testing.assert_allclose(tau_m_t, tau_m_j, rtol=0, atol=4e-6)
    np.testing.assert_allclose(tau_t, tau_j, rtol=0, atol=4e-6)
    # at rest with qd = 0 the engaged spring adds exactly nothing
    np.testing.assert_array_equal(tau_t[1], tau_m_t[1])
    np.testing.assert_allclose(tau_m_t[2].abs().numpy(), np.asarray(cfg.torque_limits))


def test_spring_engages_at_exact_rest():
    """sign·(q - rest) == 0 counts as engaged in both implementations: the
    damping term acts there."""
    cfg = go1_config(True)
    rest12 = np.tile(np.asarray(cfg.spring_rest_angles, np.float32), 4)[None]
    qd = np.full((1, 12), 0.5, np.float32)
    k3, b3 = np.array(cfg.spring_stiffness), np.array(cfg.spring_damping)
    tau_j = np.asarray(jact.spring_torque(rest12, qd, k3, b3, cfg.spring_rest_angles))
    tau_t = tact.spring_torque(torch.from_numpy(rest12), torch.from_numpy(qd),
                               torch.from_numpy(k3), torch.from_numpy(b3),
                               torch.from_numpy(np.array(cfg.spring_rest_angles)), SIGN)
    np.testing.assert_array_equal(tau_t.numpy(), tau_j)
    np.testing.assert_allclose(tau_j, -np.tile(b3, 4)[None] * 0.5, rtol=1e-6)


def test_pd_torque_matches_jax_with_qd_des():
    cfg, q_des, q, qd, _, _ = _inputs(4)
    qd_des = 0.5 * qd[::-1].copy()
    want = jact.pd_torque(q_des, q, qd, cfg.motor_kp, cfg.motor_kd, cfg.torque_limits,
                          qd_des)
    tcfg = convert.go1_config(cfg)
    t = torch.from_numpy
    got = tact.pd_torque(t(q_des), t(q), t(qd), tcfg.motor_kp, tcfg.motor_kd,
                         tcfg.torque_limits, t(qd_des))
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


def test_actuation_torque_raises_without_a_kernel():
    """Only CPU tensors take the plain twin; other devices launch the kernel
    or raise."""
    z = torch.zeros(2, 12, device="meta")
    c = torch.zeros(12, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tact.actuation_torque(z, z, z, c, c, c, torch.zeros(2, 3, device="meta"),
                              torch.zeros(2, 3, device="meta"),
                              torch.zeros(3, device="meta"), c)
