"""The port's closed loop (quadruped_springs_tpu_torch.closed_loop) against the
JAX package's examples/run_closed_loop_mpc.py on the CPU: its executor knot by
knot on a fixed action sequence, the iLQR loop at the JAX loop's defaults,
and the full-rate MPPI loop's entry point at a tiny size."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.control import interfaces as jci
from quadruped_springs_tpu.env import randomizers as jrnd
from quadruped_springs_tpu.models import dynamics as jdyn
from quadruped_springs_tpu.ops import actuation as jact
from quadruped_springs_tpu.solver import mpc as jmpc
from quadruped_springs_tpu_torch import closed_loop
from quadruped_springs_tpu_torch.solver import mpc as tmpc

KNOTS = 20


def _jax_executor(prob):
    """examples/run_closed_loop_mpc.py's execute_knot (it is local to run())."""
    c = prob.cfg
    scen = jrnd.nominal_params(c)
    model = jrnd.model_from_params(scen)
    params = jdyn.default_sim_params(0.001)

    @jax.jit
    def execute_knot(state, action):
        q_des = jci.action_to_command(prob.iface, action)

        def sub(s, _):
            tau = jact.pd_torque(q_des, s.q, s.qd, c.motor_kp, c.motor_kd, c.torque_limits)
            tau = tau + jact.spring_torque(s.q, s.qd, scen.spring_stiffness,
                                           scen.spring_damping, c.spring_rest_angles)
            return jdyn.step(model, params, s, tau, c.velocity_limits)[0], None

        return jax.lax.scan(sub, state, None, length=10)[0]

    return execute_knot


def test_executor_matches_jax():
    """KNOTS knots of the jumping task's crouch-then-extend warm start from
    the loop's start state, through both executors. Knots 0-6 (falling onto
    the feet and crouching) agree to 8.6e-6 on every entry, held to 1e-4.
    From knot 7 the extension drives joints into their 30.1 rad/s velocity
    limit and the torque clip while the feet leave the ground, and a
    rounding-level difference there moves a joint velocity by up to 0.55
    rad/s for a knot (measured at knot 10); after take-off the flight keeps
    the base velocities ~0.02 apart. Held per entry group: base pose 3e-3
    (9.7e-4 measured), base velocities 0.1 (0.061), joint angles 1e-2
    (2.6e-3), joint velocities 1.5 (0.55); the last base height to 2e-3
    (1.2e-4)."""
    jprob = jmpc.MPCProblem(jmpc.MPCConfig(task="JUMPING_IN_PLACE", horizon=KNOTS))
    tprob = tmpc.MPCProblem(tmpc.MPCConfig(task="JUMPING_IN_PLACE", horizon=KNOTS), "cpu")
    jexec = _jax_executor(jprob)
    lanes, params = closed_loop.executor(tprob)
    us = np.array(jprob.task_warm_start(crouch_knots=6))
    js = jmpc.vec_to_state(jprob.default_x0())
    ts = tmpc.vec_to_state(tprob.default_x0()[None])
    groups = {"pose": (slice(0, 7), 3e-3), "velocity": (slice(7, 13), 0.1),
              "q": (slice(13, 25), 1e-2), "qd": (slice(25, 37), 1.5)}
    for t in range(KNOTS):
        js = jexec(js, jnp.asarray(us[t]))
        ts, _ = closed_loop.execute_knot(tprob, lanes, params, ts,
                                         torch.from_numpy(us[t][None]))
        d = np.abs(np.asarray(jmpc.state_to_vec(js)) - tmpc.state_to_vec(ts)[0].numpy())
        if t <= 6:
            assert d.max() <= 1e-4, (t, d.max())
        for name, (sl, tol) in groups.items():
            assert d[sl].max() <= tol, (t, name, d[sl].max())
    assert abs(float(js.pos[2]) - float(ts.pos[0, 2])) <= 2e-3
    assert float(ts.pos[0, 2]) > 0.45              # the extension launched the robot


def test_ilqr_loop_matches_jax():
    """The iLQR loop at the JAX loop's defaults (H = 20, 4 iterations, 4
    alphas, a solve every 5 knots) over KNOTS knots, through take-off (at
    10 knots the robot is still pushing off, and the ballistic apex of a
    state in push-off moves with the knot it is read at). The backward pass
    of this contact problem is badly conditioned in f32, so the two
    packages' rounding can move the accepted steps (test_torch_ilqr_go1.py's
    solve parity holds final costs to 15%; with the port's products summed
    as a plain chain its first plan here was 6.2% from JAX's). Measured:
    first plan 0.559 (JAX) and 0.560 m (port), planned maximum 0.634 and
    0.637 m, executed 0.626 and 0.645 m. Each held to 10% of JAX's; both
    loops jump (executed > 0.45 m) and end upright."""
    from examples.run_closed_loop_mpc import run

    want = run(n_steps=KNOTS, replan_every=5, verbose=False)
    got = closed_loop.run(KNOTS, 5, device="cpu")
    assert got["solves"] == KNOTS // 5 and got["finite"]
    for key in ("planned_apex_first_m", "planned_apex_max_m", "executed_apex_m"):
        assert abs(got[key] - want[key]) <= 0.10 * want[key], (key, got, want)
    assert got["executed_apex_m"] > 0.45 and want["executed_apex_m"] > 0.45
    assert got["upright"] and want["upright"]


def test_full_rate_loop_tiny_on_cpu(capsys):
    """The MPPI path (--full-rate) through its entry point at a tiny size:
    the execution-rate planner, finite, one JSON line."""
    out = closed_loop.main(["--device", "cpu", "--steps", "6", "--replan-every", "3",
                            "--horizon", "4", "--iterations", "2", "--full-rate"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["planner"] == "planner@1000Hz-180kN" and out["solver"] == "mppi"
    assert out["finite"] and out["solves"] == 2 and out["knots"] == 6
    assert out["executed_apex_m"] > 0.3


@pytest.mark.parametrize("full_rate", [False, True], ids=["ilqr", "full_rate"])
def test_loop_launch_plan(full_rate, monkeypatch):
    """The loop solves every replan_every knots and executes every knot
    through execute_knot, with the solver and horizon of its mode."""
    calls = {"solve": 0, "mppi": 0, "exec": 0}
    knot = closed_loop.execute_knot

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(closed_loop, "execute_knot", count("exec", knot))
    monkeypatch.setattr(tmpc.MPCProblem, "solve", count("solve", tmpc.MPCProblem.solve))
    monkeypatch.setattr(tmpc.MPCProblem, "solve_mppi",
                        count("mppi", tmpc.MPCProblem.solve_mppi))
    out = closed_loop.run(4, 2, horizon=3, iterations=1, device="cpu", full_rate=full_rate)
    assert calls == {"solve": 0 if full_rate else 2, "mppi": 2 if full_rate else 0,
                     "exec": 4}
    assert out["solves"] == 2
