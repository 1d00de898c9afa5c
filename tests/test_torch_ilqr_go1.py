"""The iLQR slice of the port on the Go1 problem against the JAX package on
the CPU: Jacobians of a planner knot, whole solve_batch solves carried
across with convert.py, mpc_step, the forward-mode plumbing of the kernels'
autograd Functions (with plain launchers standing in for the CUDA ones), the
bench and closed-loop entry points at a tiny size, and the default device.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vmap

from quadruped_springs_tpu.env import randomizers as jrnd
from quadruped_springs_tpu.solver import mpc as jmpc
from quadruped_springs_tpu_torch import bench, closed_loop, convert
from quadruped_springs_tpu_torch.env.env import QuadrupedEnv
from quadruped_springs_tpu_torch.models import dynamics as tdyn
from quadruped_springs_tpu_torch.models.go1_params import go1_config
from quadruped_springs_tpu_torch.ops import actuation as tact
from quadruped_springs_tpu_torch.solver import ilqr as tilqr
from quadruped_springs_tpu_torch.solver import mpc as tmpc

N = 4
REGIMES = {"stance": (0.30, 0.0), "pushoff": (0.32, 1.5), "flight": (0.55, 1.0)}


def _scenarios(cfg, n, seed=5):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.vmap(lambda k: jrnd.sample_scenario(cfg, "TEST_RANDOMIZER", k))(keys)


def _states(seed, z, vz, x0):
    """Perturbed standing states at base height z with upward speed vz, and
    actions inside the clip."""
    rng = np.random.default_rng(seed)
    x = np.tile(x0, (N, 1))
    x[:, 2] = z + 0.005 * rng.standard_normal(N)
    quat = 0.05 * rng.standard_normal((N, 4)) + np.array([0, 0, 0, 1.0])
    x[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    x[:, 7:10] = 0.2 * rng.standard_normal((N, 3))
    x[:, 9] += vz
    x[:, 10:13] = 0.3 * rng.standard_normal((N, 3))
    x[:, 13:25] += 0.15 * rng.standard_normal((N, 12))
    x[:, 25:37] = rng.standard_normal((N, 12))
    u = rng.uniform(-0.9, 0.9, (N, 6))
    return np.concatenate([x, u], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _knot_jacobian_problems(full_rate: bool):
    """Both packages' planner problems of a rate and JAX's vmapped knot
    Jacobian, jitted once: the regimes share its compile."""
    jmk, tmk = ((jmpc.MPCConfig.full_rate, tmpc.MPCConfig.full_rate) if full_rate
                else (jmpc.MPCConfig, tmpc.MPCConfig))
    jprob, tprob = jmpc.MPCProblem(jmk()), tmpc.MPCProblem(tmk(), "cpu")
    jac = jax.jit(jax.vmap(jax.jacfwd(lambda z, s: jprob.dynamics(z[:37], z[37:], s))))
    return jprob, tprob, jac


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("full_rate", [False, True], ids=["relaxed", "full_rate"])
def test_knot_jacobian_matches_jax(full_rate, regime):
    """The 37x43 Jacobian of MPCProblem.dynamics on 4 randomized scenarios
    against jax.jacfwd, elementwise relative to each lane's max |J|. Relaxed
    planner (2 substeps, 4 kN/m): 1e-5 (measured up to 1.5e-6). Full rate
    (10 substeps at 180 kN/m with the damping clamp): the stiff contact
    amplifies f32 rounding through five times as many substeps: measured
    2e-7 in flight, 3.6e-6 at push-off and up to 5.7e-4 in stance (a lane
    with max |J| = 8,680), held to 1e-3 (the spread between JAX's own two
    implementations of this Jacobian was not measured)."""
    jprob, tprob, jac = _knot_jacobian_problems(full_rate)
    scen = _scenarios(jprob.cfg, N)
    z = _states(list(REGIMES).index(regime), *REGIMES[regime], np.asarray(jprob.default_x0()))
    want = np.asarray(jac(jnp.asarray(z), scen))
    lanes = tprob.lane_params(convert.scenario_params(scen))
    _, cols = tilqr._basis_jvp(lambda z: tprob.dynamics(z[:, :37], z[:, 37:], lanes),
                               torch.from_numpy(z))
    got = cols.permute(1, 2, 0).numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    rel = (np.abs(got - want) / scale).max()
    assert rel <= (1e-3 if full_rate else 1e-5), rel
    assert scale.min() > 10.0


def test_knot_jacobian_at_saturated_actions_matches_jax():
    """Along the rollout of the jumping task's own warm start, whose extend
    phase commands u = ±1 exactly: there the action clip sits on its tie and
    both packages pass half the tangent, so the B columns of the saturated
    actions agree too (torch.clamp would pass all of it: twice JAX's)."""
    H = 12
    jprob = jmpc.MPCProblem(jmpc.MPCConfig(horizon=H))
    tprob = tmpc.MPCProblem(tmpc.MPCConfig(horizon=H), "cpu")
    us = np.asarray(jprob.task_warm_start())
    assert (np.abs(us[-1]) == 1.0).any() and (np.abs(us[0]) < 1.0).all()
    step = jax.jit(jprob.dynamics)
    x, xs = jprob.default_x0(), []
    for t in range(H):
        xs.append(np.asarray(x))
        x = step(x, jnp.asarray(us[t]))
    z = np.concatenate([np.stack(xs), us], axis=-1).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jax.jacfwd(
        lambda z: jprob.dynamics(z[:37], z[37:]))))(jnp.asarray(z)))
    lanes = tprob.lane_params(repeats=H)
    _, cols = tilqr._basis_jvp(lambda z: tprob.dynamics(z[:, :37], z[:, 37:], lanes),
                               torch.from_numpy(z))
    got = cols.permute(1, 2, 0).numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got - want) / scale).max() <= 1e-5
    saturated = np.abs(us) == 1.0                           # (H,6)
    b_cols = np.abs(want[:, :, 37:]).max(axis=1)            # (H,6)
    # half a tangent, not none (where the torque clip saturates too, B is 0)
    assert (b_cols[saturated] > 1.0).sum() >= 4


def _solve_pair(**kw):
    """solve_batch of 3 scenarios by both packages from the task's own warm
    start, whose extend phase sits on the action clip (u = ±1 exactly)."""
    kw = dict(task="JUMPING_IN_PLACE", horizon=10, n_alphas=4, **kw)
    jcfg = jmpc.MPCConfig(**kw)
    jprob, tprob = jmpc.MPCProblem(jcfg), tmpc.MPCProblem(convert.mpc_config(jcfg), "cpu")
    scen = _scenarios(jprob.cfg, 3, seed=1)
    x0 = np.tile(np.asarray(jprob.default_x0()), (3, 1))
    u0 = np.tile(np.asarray(jprob.task_warm_start()), (3, 1, 1))
    jsol = jprob.solve_batch(jnp.asarray(x0), jnp.asarray(u0), scen)
    tscen = convert.scenario_params(scen)
    tsol = tprob.solve_batch(torch.from_numpy(x0), torch.from_numpy(u0), tscen)
    return convert.ilqr_solution(jsol), tsol, tprob, tscen


@pytest.mark.parametrize("kw", [dict(iterations=3), dict(iterations=4, relin_every=2),
                                dict(iterations=3, backward="parallel")],
                         ids=["exact", "relin2", "parallel"])
def test_solve_batch_matches_jax(kw):
    """Whole solves. The backward pass of this contact problem is badly
    conditioned in f32 (value Hessians reach the 1e7 clamp, gains of 400):
    a 1e-5 relative change of A, which the two packages' independent
    rollouts produce, moves the first accepted cost by 5e-4 relative
    (measured by perturbing JAX's own A and B), and later iterations may
    accept at another alpha. So the first iteration's cost is held to 2e-3
    relative and the final cost to 15%; the rollout (xs, cost) of the
    returned controls, the trace's shape and its monotonicity are exact
    properties and held as such."""
    jsol, tsol, tprob, tscen = _solve_pair(**kw)
    its = kw["iterations"]
    assert tsol.cost_trace.shape == (3, its) and tsol.xs.shape == (3, 11, 37)
    assert torch.all(torch.diff(tsol.cost_trace, dim=-1) <= 0)
    assert torch.isfinite(tsol.us).all() and tsol.us.abs().max() <= 1.0
    np.testing.assert_allclose(tsol.cost_trace[:, 0], jsol.cost_trace[:, 0], rtol=2e-3)
    np.testing.assert_allclose(tsol.cost, jsol.cost, rtol=0.15)
    # the returned cost and states are those of the returned controls
    dyn_fn = tprob.lane_dynamics(tscen)
    x, total = tsol.xs[:, :1], torch.zeros(3)
    for t in range(10):
        total = total + tprob.stage_cost(x[:, 0], tsol.us[:, t], t)
        x = dyn_fn(x, tsol.us[:, None, t])
        np.testing.assert_allclose(x[:, 0], tsol.xs[:, t + 1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(total + tprob.terminal_cost(x[:, 0]), tsol.cost, rtol=1e-5)


def test_solve_improves_the_jump_and_mpc_step_shifts_the_plan():
    """tests/test_ilqr.py's Go1 checks on the port: the plan's apex clears
    0.40 m with a non-increasing trace, and mpc_step returns the first
    control, the planner's next state and the plan shifted by one knot, as
    JAX's does."""
    prob = tmpc.MPCProblem(tmpc.MPCConfig(task="JUMPING_IN_PLACE", horizon=20,
                                          iterations=5, n_alphas=4), "cpu")
    sol = prob.solve(prob.default_x0(), prob.task_warm_start())
    apex = (sol.xs[:, 2] + torch.clamp_min(sol.xs[:, 9], 0.0) ** 2 / (2 * 9.81)).max()
    assert float(apex) > 0.40 and torch.isfinite(sol.us).all()
    assert torch.all(torch.diff(sol.cost_trace) <= 0)

    kw = dict(task="CONTINUOUS_JUMPING_FORWARD_PPO", horizon=8, iterations=2, n_alphas=2)
    jprob, prob = jmpc.MPCProblem(jmpc.MPCConfig(**kw)), tmpc.MPCProblem(
        tmpc.MPCConfig(**kw), "cpu")
    x0, u = prob.default_x0(), 0.9 * prob.default_warm_start() + 0.05
    x1, u0, u_next, cost = prob.mpc_step(x0, u)
    sol = prob.solve(x0, u)
    assert torch.equal(u0, sol.us[0]) and torch.equal(u_next[:-1], sol.us[1:])
    assert torch.equal(u_next[-1], sol.us[-1]) and torch.equal(cost, sol.cost)
    np.testing.assert_allclose(x1, sol.xs[1], rtol=1e-6, atol=1e-6)
    jx1, ju0, ju_next, jcost = jprob.mpc_step(jnp.asarray(x0.numpy()), jnp.asarray(u.numpy()))
    assert x1.shape == jx1.shape and u_next.shape == ju_next.shape
    # the cost after two iterations, held as test_solve_batch_matches_jax
    # holds final costs (measured 0.8% apart)
    np.testing.assert_allclose(cost, jcost, rtol=0.05)


def _plain_actuation(q_des, q, qd, kp, kd, limits, k, b, rest, sign):
    tau_m = tact.pd_torque(q_des, q, qd, kp, kd, limits)
    return tau_m + tact.spring_torque(q, qd, k, b, rest, sign), tau_m


def _plain_actuation_jvp(*args):
    primals, consts, tangents = args[:3], args[3:10], args[10:]
    f = lambda a, b, c: _plain_actuation(a, b, c, *consts)
    return vmap(lambda a, b, c: jvp(f, primals, (a, b, c))[1][0])(*tangents)


def _plain_contact_jvp(phi, v_w, mu, dphi, dv, *consts):
    f = lambda p, v: tdyn.contact_forces_plain(p, v, mu, *consts)[0]
    return vmap(lambda a, b: jvp(f, (phi, v_w), (a, b))[1])(dphi, dv)


def test_kernel_functions_forward_mode_plumbing(monkeypatch):
    """The autograd Functions that bind the CUDA kernels, driven on the CPU
    with the kernels' plain versions in place of the launchers: the
    linearization's vmap-of-jvp through them equals differentiating the plain
    dynamics, the tangent launcher sees all 43 directions in one call with
    the primal unbatched, a plain call takes the forward launcher once, and
    reverse mode raises."""
    calls = []

    def record(name, fn):
        def wrapped(*args):
            calls.append((name, tuple(a.shape for a in args if torch.is_tensor(a))))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tact, "_launch_actuation", record("act", _plain_actuation))
    monkeypatch.setattr(tact, "_launch_actuation_jvp", record("act_jvp", _plain_actuation_jvp))
    monkeypatch.setattr(tdyn, "_launch_contact", record(
        "contact", lambda *a: tdyn.contact_forces_plain(*a)))
    monkeypatch.setattr(tdyn, "_launch_contact_jvp", record("contact_jvp", _plain_contact_jvp))
    plain_contact = tdyn.contact_forces

    def contact_through_function(model, params, p_w, v_w, radii, foot_anchor=None):
        phi = radii - p_w[..., 2]
        return (*tdyn._Contact.apply(phi, v_w, params.friction, params.contact_stiffness,
                                     params.contact_damping, params.slip_vel_tol,
                                     params.clamp_damping), None)

    prob = tmpc.MPCProblem(tmpc.MPCConfig(), "cpu")
    lanes = prob.lane_params(repeats=N)
    z = torch.from_numpy(_states(9, 0.30, 0.5, prob.default_x0().numpy()))
    f = lambda z: prob.dynamics(z[:, :37], z[:, 37:], lanes)
    want_x, want = tilqr._basis_jvp(f, z)
    # route CPU tensors through the Functions, as CUDA tensors are
    monkeypatch.setattr(tact, "actuation_torque", lambda *a: tact._Actuation.apply(*a))
    monkeypatch.setattr(tdyn, "contact_forces", contact_through_function)
    got_x, got = tilqr._basis_jvp(f, z)
    np.testing.assert_allclose(got_x, want_x, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    names = [c[0] for c in calls]
    assert names == ["act", "act_jvp", "contact", "contact_jvp"] * 2   # two substeps
    assert calls[1][1][0] == (N, 12) and calls[1][1][-1] == (43, N, 12)
    assert calls[3][1][0] == (N, 12) and calls[3][1][-1] == (43, N, 12, 3)

    calls.clear()
    with torch.no_grad():
        f(z)
    assert [c[0] for c in calls] == ["act", "contact"] * 2
    with pytest.raises(NotImplementedError, match="reverse-mode"):
        f(z.clone().requires_grad_()).sum().backward()
    with pytest.raises(NotImplementedError, match="vmap"):
        vmap(f)(z[None])
    monkeypatch.setattr(tdyn, "contact_forces", plain_contact)


def test_bench_ilqr_and_closed_loop_tiny_on_cpu(capsys):
    rec = bench.main(["--device", "cpu", "--batch", "2", "--horizon", "4", "--iterations",
                      "2", "--runs", "1", "--ilqr", "--exact", "--relin-every", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "iLQR H=4, 2 iters, exact-f32, relin/2" in line["metric"]
    assert "on cpu" in line["metric"] and line["value"] > 0
    assert rec["solution"].cost_trace.shape == (2, 2)
    assert set(rec["stage_times"]) == {"rollout", "linearize", "cost_derivatives",
                                       "backward", "line_search"}
    out = closed_loop.main(["--device", "cpu", "--steps", "12", "--replan-every", "4",
                            "--horizon", "8", "--iterations", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["finite"] and out["solves"] == 3 and out["airborne_knots"] > 0
    assert out["executed_apex_m"] > 0.40


def test_entry_points_default_to_the_card():
    """Without a device the entry points build on the CUDA card, and raise
    where there is none: no quiet fallback to the CPU."""
    if torch.cuda.is_available():
        assert tmpc.MPCProblem().device.type == "cuda"
        assert go1_config().motor_kp.device.type == "cuda"
        return
    for build in (tmpc.MPCProblem, QuadrupedEnv, go1_config):
        with pytest.raises((RuntimeError, AssertionError)):
            build()
