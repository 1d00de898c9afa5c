"""The port's iLQR solver (quadruped_springs_tpu_torch.solver.ilqr) against
the JAX package on the CPU: the sequential Riccati sweep fed JAX's inputs,
the parallel-in-time sweep and its building blocks, and whole solves of the
toy problems of tests/test_ilqr.py, tests/test_ilqr_parallel.py and
tests/test_ilqr_variants.py, also against the analytic LQR answer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.solver import ilqr as jilqr
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.solver import ilqr as tilqr

T = lambda a: torch.from_numpy(np.asarray(a, np.float32))


def _lq_inputs(seed, H=12, n=5, m=2, indefinite=False):
    """Seeded inputs of a backward pass: stable-ish A, dense B, PSD lxx and
    Vxx, luu PSD or (indefinite) with a negative eigenvalue that the PD
    shift must cover."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    A = np.eye(n) + 0.1 * rng.standard_normal((H, n, n))
    B = rng.standard_normal((H, n, m))
    sq = lambda M: M @ np.swapaxes(M, -1, -2)
    lxx = sq(rng.standard_normal((H, n, n))) / n
    luu = sq(rng.standard_normal((H, m, m))) / m + 0.1 * np.eye(m)
    if indefinite:
        luu = luu - 1.5 * np.eye(m)
    lux = 0.1 * rng.standard_normal((H, m, n))
    lx, lu = rng.standard_normal((H, n)), rng.standard_normal((H, m))
    Vx, Vxx = rng.standard_normal(n), sq(rng.standard_normal((n, n))) / n
    return tuple(map(f32, (A, B, lx, lu, lxx, luu, lux, Vx, Vxx)))


def _stack(problems):
    """Per-problem input tuples -> torch tensors with a leading problem axis."""
    return [T(np.stack(parts)) for parts in zip(*problems)]


@pytest.mark.parametrize("pd_shift", ["gershgorin", "eig"])
@pytest.mark.parametrize("reg_mode", ["control", "tassa"])
def test_riccati_sequential_matches_jax(reg_mode, pd_shift):
    """Three problems (one with an indefinite luu) through JAX's sweep one by
    one and through the port's at once: gains and dV to 1e-4 relative to
    their scale (f32 products summed in another order, a Cholesky from
    another library). Under the exact "eig" shift the indefinite problem's
    Q_uu, regularized by only reg = 1e-3, loses positive definiteness down
    the sweep: both implementations flag it (ok=False), and its gains are
    not compared."""
    kw = dict(reg_mode=reg_mode, pd_shift=pd_shift)
    problems = [_lq_inputs(0), _lq_inputs(1, indefinite=True), _lq_inputs(2)]
    regs = np.array([1.0, 1e-3, 10.0], np.float32)
    ks, Ks, dV, ok = tilqr.riccati_sequential(*_stack(problems), T(regs),
                                              tilqr.ILQRConfig(**kw))
    assert ks.shape == (3, 12, 2) and Ks.shape == (3, 12, 2, 5)
    for i, (inputs, reg) in enumerate(zip(problems, regs)):
        jks, jKs, jdV, jok = jilqr.riccati_sequential(
            *map(jnp.asarray, inputs), jnp.asarray(reg), jilqr.ILQRConfig(**kw))
        assert bool(jok) == bool(ok[i]) == (pd_shift == "gershgorin" or i != 1)
        if not bool(jok):
            continue
        for got, want in ((ks[i], jks), (Ks[i], jKs), (dV[i], jdV)):
            want = np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())


def test_riccati_sequential_flags_a_failed_factorization():
    """A NaN in one problem's luu makes its Q_uu factorization fail: both
    implementations report ok=False for it; the port keeps the other
    problem of the batch ok."""
    good, bad = _lq_inputs(3), list(_lq_inputs(4))
    bad[5] = bad[5].copy()
    bad[5][6, 0, 0] = np.nan
    *_, jok = jilqr.riccati_sequential(*map(jnp.asarray, bad), jnp.asarray(1.0),
                                       jilqr.ILQRConfig())
    *_, ok = tilqr.riccati_sequential(*_stack([good, bad]), torch.ones(2),
                                      tilqr.ILQRConfig())
    assert not bool(jok)
    assert ok.tolist() == [True, False]


def _jax_elements(inputs, reg):
    return jilqr.lqt_elements(*map(jnp.asarray, inputs), jnp.asarray(reg))


def test_lqt_combine_and_identity_match_jax():
    """One composition of neighbouring elements, batched over (problem,
    knot) in the port, against JAX; composing with the identity element on
    either side returns the element."""
    inputs = _lq_inputs(5)
    (jel, _), (tel, _) = _jax_elements(inputs, 0.5), tilqr.lqt_elements(
        *_stack([inputs]), T([0.5]))
    for got, want in zip(tel, jel):
        np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-5)
    later, earlier = tuple(e[:, 1:] for e in tel), tuple(e[:, :-1] for e in tel)
    got = tilqr.lqt_combine(later, earlier)
    want = jax.vmap(jilqr.lqt_combine)(tuple(e[1:] for e in jel), tuple(e[:-1] for e in jel))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w, rtol=1e-4, atol=1e-4)
    ident = tilqr.lqt_identity_element(5, torch.float32, batch_shape=(1, 13))
    jident = jilqr.lqt_identity_element(5, jnp.float32, batch_shape=(13,))
    for g, w in zip(ident, jident):
        np.testing.assert_array_equal(g[0], w)
    for composed in (tilqr.lqt_combine(ident, tel), tilqr.lqt_combine(tel, ident)):
        for g, w in zip(composed, tel):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_parallel_lqt_backward_matches_jax_and_sequential():
    """The associative-scan sweep against JAX's on the same inputs, and
    against the port's sequential sweep. With one control (m = 1) the
    Gershgorin bound is exact, so the same LM shift (reg + 1e-6) enters both
    sweeps and the gains agree to the scans' rounding (the tolerances of
    tests/test_ilqr_parallel.py: 2e-3 on the controls)."""
    problems = [_lq_inputs(6, m=1), _lq_inputs(7, m=1)]
    regs = np.array([1e-6, 1e-6], np.float32)
    ks, Ks, dV, ok = tilqr._parallel_lqt_backward(*_stack(problems), T(regs))
    sks, sKs, _, sok = tilqr.riccati_sequential(*_stack(problems), T(regs),
                                                tilqr.ILQRConfig())
    assert ok.all() and sok.all() and (dV == 0).all()
    for i, inputs in enumerate(problems):
        jks, jKs, _, jok = jilqr._parallel_lqt_backward(*map(jnp.asarray, inputs),
                                                        jnp.asarray(regs[i]))
        assert bool(jok)
        np.testing.assert_allclose(ks[i], jks, rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(Ks[i], jKs, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(ks, sks, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(Ks, sKs, rtol=1e-3, atol=2e-3)


# -- whole solves of the JAX tests' toy problems ---------------------------

_DT = 0.1
_A = np.array([[1.0, _DT], [0.0, 1.0]], np.float32)
_B = np.array([[0.0], [_DT]], np.float32)
_Q = np.diag([1.0, 0.1]).astype(np.float32)
_R = np.array([[0.1]], np.float32)


def _lqr(cross_terms):
    """The double integrator of tests/test_ilqr.py, or with the cross and
    linear cost terms of tests/test_ilqr_parallel.py: (jax fns, torch fns)."""
    A, B, Q, R = map(jnp.asarray, (_A, _B, _Q, _R))
    c = 1.0 if cross_terms else 0.0
    jfns = (lambda x, u: A @ x + B @ u,
            lambda x, u, t: 0.5 * (x @ Q @ x + u @ R @ u) + c * 0.3 * u.sum() * x[0],
            lambda x: 0.5 * x @ Q @ x + c * 0.2 * x[1])
    At, Bt, Qt, Rt = map(T, (_A, _B, _Q, _R))
    quad = lambda v, M: ((v @ M) * v).sum(-1)
    tfns = (lambda x, u: x @ At.T + u @ Bt.T,
            lambda x, u, t: 0.5 * (quad(x, Qt) + quad(u, Rt)) + c * 0.3 * u.sum(-1) * x[..., 0],
            lambda x: 0.5 * quad(x, Qt) + c * 0.2 * x[..., 1])
    return jfns, tfns


def _pendulum():
    """The nonlinear toy system of tests/test_ilqr_variants.py (n=3, m=1)."""
    dt = 0.05

    def jdyn(x, u):
        a = 3.0 * jnp.sin(x[0]) + 2.0 * u[0]
        return jnp.stack([x[0] + dt * x[1], x[1] + dt * a, x[2] + dt * u[0] ** 2])

    def tdyn(x, u):
        a = 3.0 * torch.sin(x[..., 0]) + 2.0 * u[..., 0]
        return torch.stack([x[..., 0] + dt * x[..., 1], x[..., 1] + dt * a,
                            x[..., 2] + dt * u[..., 0] ** 2], dim=-1)

    jfns = (jdyn, lambda x, u, t: 0.05 * jnp.sum(u ** 2) + 0.1 * (x[0] - jnp.pi) ** 2,
            lambda x: 10.0 * (x[0] - jnp.pi) ** 2 + 1.0 * x[1] ** 2)
    tfns = (tdyn,
            lambda x, u, t: 0.05 * (u ** 2).sum(-1) + 0.1 * (x[..., 0] - torch.pi) ** 2,
            lambda x: 10.0 * (x[..., 0] - torch.pi) ** 2 + 1.0 * x[..., 1] ** 2)
    return jfns, tfns


@pytest.mark.parametrize("backward", ["sequential", "parallel"])
def test_lqr_double_integrator_matches_jax_and_riccati(backward):
    """On an LQ problem one iteration is the exact Newton step: the port's
    cost matches JAX's to 1e-4 and the discrete Riccati optimum within 2%
    (the bound of tests/test_ilqr.py), with a non-increasing trace."""
    jfns, tfns = _lqr(cross_terms=False)
    H, x0 = 30, np.array([1.0, 0.0], np.float32)
    kw = dict(horizon=H, iterations=3, n_alphas=4, reg_init=1e-6, u_min=-10.0,
              u_max=10.0, backward=backward)
    jsol = jilqr.solve(*jfns, jnp.asarray(x0), jnp.zeros((H, 1)), jilqr.ILQRConfig(**kw))
    sol = tilqr.solve(*tfns, T(x0), torch.zeros(H, 1),
                      convert.ilqr_config(jilqr.ILQRConfig(**kw)))
    P = _Q.astype(np.float64)
    for _ in range(H):
        K = np.linalg.solve(_R + _B.T @ P @ _B, _B.T @ P @ _A)
        P = _Q + _A.T @ P @ (_A - _B @ K)
    assert float(sol.cost) <= 0.5 * x0 @ P @ x0 * 1.02 + 1e-6
    np.testing.assert_allclose(sol.cost, jsol.cost, rtol=1e-4)
    np.testing.assert_allclose(sol.cost_trace, jsol.cost_trace, rtol=1e-4)
    np.testing.assert_allclose(sol.us, jsol.us, atol=2e-3)
    assert sol.us.shape == (H, 1) and sol.xs.shape == (H + 1, 2)
    assert torch.all(torch.diff(sol.cost_trace) <= 1e-6)


def test_parallel_backward_matches_sequential_on_lqr_with_cross_terms():
    """tests/test_ilqr_parallel.py's LQ problem with cross and linear terms,
    both sweeps, against each other and against JAX."""
    jfns, tfns = _lqr(cross_terms=True)
    H, x0 = 16, np.array([1.0, -0.5], np.float32)
    sols = {}
    for backward in ("sequential", "parallel"):
        kw = dict(horizon=H, iterations=4, n_alphas=4, reg_init=1e-6, u_min=-10.0,
                  u_max=10.0, backward=backward)
        jsol = jilqr.solve(*jfns, jnp.asarray(x0), jnp.zeros((H, 1)),
                           jilqr.ILQRConfig(**kw))
        sols[backward] = tilqr.solve(*tfns, T(x0), torch.zeros(H, 1),
                                     tilqr.ILQRConfig(**kw))
        np.testing.assert_allclose(sols[backward].cost, jsol.cost, rtol=1e-4)
        np.testing.assert_allclose(sols[backward].us, jsol.us, atol=2e-3)
    np.testing.assert_allclose(sols["parallel"].cost, sols["sequential"].cost, rtol=1e-4)
    np.testing.assert_allclose(sols["parallel"].us, sols["sequential"].us, atol=2e-3)


def test_ilqr_respects_control_bounds():
    dynamics = lambda x, u: x + 0.1 * u
    stage = lambda x, u, t: 0.0 * (u ** 2).sum(-1)
    terminal = lambda x: ((x - 100.0) ** 2).sum(-1)      # wants huge controls
    sol = tilqr.solve(dynamics, stage, terminal, torch.zeros(1), torch.zeros(5, 1),
                      tilqr.ILQRConfig(horizon=5, iterations=5, n_alphas=4))
    jsol = jilqr.solve(lambda x, u: x + 0.1 * u, lambda x, u, t: 0.0 * jnp.sum(u ** 2),
                       lambda x: jnp.sum((x - 100.0) ** 2), jnp.zeros(1), jnp.zeros((5, 1)),
                       jilqr.ILQRConfig(horizon=5, iterations=5, n_alphas=4))
    assert float(sol.us.abs().max()) <= 1.0 + 1e-6
    np.testing.assert_allclose(sol.cost, jsol.cost, rtol=1e-4)


@pytest.mark.parametrize("relin_every", [1, 2])
def test_pendulum_batch_matches_jax(relin_every):
    """The nonlinear pendulum, three problems at once, 15 iterations, exact
    and lagged linearization: final costs against JAX's solve_batched at the
    tolerance tests/test_ilqr_variants.py holds the two JAX solvers to
    (2e-3 relative), every trace non-increasing, and the batch equal to
    solving each problem alone."""
    jfns, tfns = _pendulum()
    rng = np.random.default_rng(0)
    x0s = (0.1 * rng.standard_normal((3, 3))).astype(np.float32)
    kw = dict(horizon=40, iterations=15, relin_every=relin_every)
    jsol = jilqr.solve_batched(jax.vmap(jfns[0]), jfns[1], jfns[2], jnp.asarray(x0s),
                               jnp.zeros((3, 40, 1)), jilqr.ILQRConfig(**kw))
    dyn_b = lambda x, u: tfns[0](x, u)
    sol = tilqr.solve_batched(dyn_b, tfns[1], tfns[2], T(x0s), torch.zeros(3, 40, 1),
                              tilqr.ILQRConfig(**kw))
    assert sol.cost_trace.shape == (3, 15) and sol.reg.shape == (3,)
    assert torch.all(torch.diff(sol.cost_trace, dim=-1) <= 1e-5)
    np.testing.assert_allclose(sol.cost, jsol.cost, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(sol.us, jsol.us, atol=5e-3)
    one = tilqr.solve(*tfns, T(x0s[1]), torch.zeros(40, 1), tilqr.ILQRConfig(**kw))
    np.testing.assert_allclose(one.cost, sol.cost[1], rtol=1e-5)
    np.testing.assert_allclose(one.us, sol.us[1], atol=1e-4)


def test_convert_carries_configs_and_solutions():
    jcfg = jilqr.ILQRConfig(horizon=7, iterations=3, n_alphas=2, reg_mode="tassa",
                            relin_every=2, unroll=4)
    tcfg = convert.ilqr_config(jcfg)
    assert (tcfg.horizon, tcfg.iterations, tcfg.n_alphas, tcfg.reg_mode, tcfg.relin_every) \
        == (7, 3, 2, "tassa", 2)
    jfns, _ = _lqr(cross_terms=False)
    jsol = jilqr.solve(*jfns, jnp.asarray([1.0, 0.0]), jnp.zeros((6, 1)),
                       jilqr.ILQRConfig(horizon=6, iterations=2, n_alphas=2))
    sol = convert.ilqr_solution(jsol)
    assert sol.us.shape == (1, 6, 1) and sol.xs.shape == (1, 7, 2)
    assert sol.cost_trace.shape == (1, 2) and sol.reg.shape == (1,)
    np.testing.assert_array_equal(sol.us[0], jsol.us)
