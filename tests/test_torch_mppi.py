"""The port's MPPI solver (quadruped_springs_tpu_torch.solver.mppi) on the
double integrator: the behavioural checks of tests/test_mppi.py with torch's
own noise, and parity with JAX mppi.solve when both get the same noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.solver import mppi as jmppi
from quadruped_springs_tpu_torch.solver import mppi as tmppi

DT, H = 0.1, 20
A = np.array([[1.0, DT], [0.0, 1.0]], np.float32)
B = np.array([[0.0], [DT]], np.float32)
TARGET = np.array([1.0, 0.0], np.float32)


def _dynamics(x, u):
    return x @ torch.from_numpy(A).T + u @ torch.from_numpy(B).T


def _rollout(x0, us):
    """The knot loop over _dynamics: x0 (B,n), us (B,R,H,m) -> xs (B,R,H+1,n)."""
    x = x0[:, None].expand(us.shape[0], us.shape[1], x0.shape[-1])
    xs = [x]
    for t in range(us.shape[2]):
        x = _dynamics(x, us[:, :, t])
        xs.append(x)
    return torch.stack(xs, dim=2)


def _torch_problem():
    target = torch.from_numpy(TARGET)
    stage = lambda x, u, t: 0.01 * torch.sum(u * u, dim=-1)
    terminal = lambda x: torch.sum((x - target) ** 2, dim=-1)
    return _rollout, stage, terminal


def _jax_problem():
    dynamics = lambda x, u: A @ x + B @ u
    stage = lambda x, u, t: 0.01 * jnp.sum(u ** 2)
    terminal = lambda x: jnp.sum((x - TARGET) ** 2)
    return dynamics, stage, terminal


def _solve_torch(cfg, batch=1, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return tmppi.solve(*_torch_problem(), torch.zeros(batch, 2), torch.zeros(batch, H, 1),
                       cfg, gen)


BASE = dict(horizon=H, iterations=30, n_samples=64, sigma=0.4, temperature=0.05,
            smooth=False)


def test_double_integrator_reaches_target():
    sol = _solve_torch(tmppi.MPPIConfig(**BASE), batch=4)
    # within 10% of the converged gradient-based optimum (iLQR: 0.1180)
    assert torch.all(sol.cost < 0.118 * 1.10), sol.cost
    # monotone: iterations only accept improvements
    assert torch.all(torch.diff(sol.cost_trace, dim=-1) <= 1e-6)
    assert float(sol.us.abs().max()) <= 1.0 + 1e-6
    assert sol.us.shape == (4, H, 1) and sol.xs.shape == (4, H + 1, 2)


def test_fused_accept_matches_quality():
    """Candidate 0 pinned to the proposal; the same quality band as the
    per-iteration accept, and the returned cost is the exact cost of us."""
    ref = _solve_torch(tmppi.MPPIConfig(**BASE), batch=4)
    fused = _solve_torch(tmppi.MPPIConfig(**BASE, fused_accept=True), batch=4)
    assert torch.all(fused.cost < 0.118 * 1.10), fused.cost
    assert torch.all((fused.cost - ref.cost).abs() < 0.25 * ref.cost)
    _, stage, terminal = _torch_problem()
    x = torch.zeros(4, 2)
    total = torch.zeros(4)
    for t in range(H):
        total = total + stage(x, fused.us[:, t], t)
        x = _dynamics(x, fused.us[:, t])
    np.testing.assert_allclose(total + terminal(x), fused.cost, rtol=1e-5)
    np.testing.assert_allclose(fused.xs[:, -1], x, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["accept", "fused"])
@pytest.mark.parametrize("smooth", [False, True], ids=["white", "smooth"])
def test_solve_matches_jax_with_injected_noise(fused, smooth):
    """The JAX draws (split(key, iterations) -> normal(k, (K,H,m))) injected
    into the port: the same float32 arithmetic up to summation order, so
    us, cost and the cost trace agree to 1e-5."""
    cfg = dict(BASE, iterations=10, n_samples=16, smooth=smooth, fused_accept=fused)
    jcfg, tcfg = jmppi.MPPIConfig(**cfg), tmppi.MPPIConfig(**cfg)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    x0, u_init = jnp.zeros((3, 2)), jnp.full((3, H, 1), 0.1)
    jsol = jax.jit(jax.vmap(lambda x, u, k: jmppi.solve(*_jax_problem(), x, u, k, jcfg)))(
        x0, u_init, keys)
    noise = jax.vmap(lambda k: jax.vmap(
        lambda ki: jax.random.normal(ki, (16, H, 1), jnp.float32))(
        jax.random.split(k, tcfg.iterations)))(keys)            # (B, iters, K, H, m)
    noise = torch.from_numpy(np.array(noise)).transpose(0, 1).contiguous()
    tsol = tmppi.solve(*_torch_problem(), torch.from_numpy(np.array(x0)),
                       torch.from_numpy(np.array(u_init)), tcfg, noise=noise)
    np.testing.assert_allclose(tsol.us, jsol.us, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tsol.cost, jsol.cost, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsol.cost_trace, jsol.cost_trace, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsol.xs, jsol.xs, rtol=1e-5, atol=1e-5)


def test_noise_shape_is_checked():
    with pytest.raises(ValueError, match="noise shape"):
        tmppi.solve(*_torch_problem(), torch.zeros(1, 2), torch.zeros(1, H, 1),
                    tmppi.MPPIConfig(**BASE), noise=torch.zeros(1, 1, 64, H, 1))


@pytest.mark.parametrize("fused", [False, True], ids=["accept", "fused"])
def test_zero_iterations_raise(fused):
    """A solve without an iteration has no proposal to settle or accept."""
    with pytest.raises(ValueError, match="at least one iteration"):
        tmppi.solve(*_torch_problem(), torch.zeros(1, 2), torch.zeros(1, H, 1),
                    tmppi.MPPIConfig(**{**BASE, "iterations": 0, "fused_accept": fused}))
