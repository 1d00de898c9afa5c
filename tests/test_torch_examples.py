"""The examples as the port's entry points (quadruped_springs_tpu_torch/
examples.py) on the CPU at a cut size, against the JAX examples' own lines.

Each JAX example's computation is rebuilt here at the same cut (the
examples run at import or print only), or called where it returns its
numbers (examples/run_cartesian_jump.py run). Tolerances:
- heights, positions and travel: 1e-3 m (tests/test_torch_env.py: after
  hundreds of stiff substeps the packages part in the last digits); the
  summed reward 1e-3 relative and 1e-5 absolute; control flow (the step an
  episode ends at, feet in contact, the controller switch) exactly;
- iLQR (mpc, backflip): tests/test_torch_ilqr_go1.py's: the first
  iteration's cost 2e-3 relative, the final cost 15% (the backward pass is
  badly conditioned in float32), the trace monotone in both;
- MPPI (mpc --mppi) with JAX's draws: tests/test_torch_mpc_behaviours.py's:
  us 1e-5, costs 1e-5 relative.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.control import cpg as jcpg
from quadruped_springs_tpu.env import wrappers as jwr
from quadruped_springs_tpu.env.env import EnvConfig as JEnvConfig
from quadruped_springs_tpu.env.env import QuadrupedEnv as JQuadrupedEnv
from quadruped_springs_tpu.models import spatial as jsp
from quadruped_springs_tpu.solver import mpc as jmpc
from quadruped_springs_tpu.solver import mppi as jmppi
from quadruped_springs_tpu.train import ars as jars
from quadruped_springs_tpu.train import rollout as jro
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch import examples as ex

SETTLE, STEPS, CPG_STEPS, H, ITERS = 300, 40, 200, 6, 2
CROUCH = jnp.array([0.0, 0.4, -0.8, 0.0, 0.4, -0.8])
EXTEND = jnp.array([0.0, -0.4, 1.0, 0.0, -0.4, 1.0])


def _close_m(got, want, name):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, err_msg=name)


def test_episode_matches_jax_example():
    """examples/run_episode.py's lines with the settle cut to SETTLE and
    STEPS control steps, on the ground the JAX example draws from
    PRNGKey(0) (injected into the port)."""
    env = JQuadrupedEnv(JEnvConfig(
        enable_springs=True, motor_control_mode="PD", action_space_mode="SYMMETRIC",
        task_env="JUMPING_IN_PLACE", observation_space_mode="ARS_BASIC",
        env_randomizer_mode="GROUND_RANDOMIZER", settling_steps=SETTLE))
    wrapper = jwr.LandingWrapper(env)
    state, obs = env.reset(jax.random.PRNGKey(0))
    reset_h, feet = float(state.robot.pos[2]), np.asarray(state.feet_in_contact).tolist()
    total = 0.0
    for t in range(STEPS):
        out = wrapper.step(state, CROUCH if t < 30 else EXTEND)
        state = out.state
        total += float(out.reward)
        if bool(out.done):
            break
    got = ex.episode(device="cpu", settle=SETTLE, max_steps=STEPS,
                     scenario=convert.scenario_params(state.scenario))
    _close_m(got["reset_height_m"], reset_h, "reset height")
    assert got["feet_in_contact"] == feet and got["obs_dim"] == obs.shape[0]
    assert got["end_step"] == t
    np.testing.assert_allclose(got["return"], total, rtol=1e-3, atol=1e-5)
    _close_m(got["max_height_m"], float(out.max_height), "max height")
    _close_m(got["max_fwd_m"], float(out.max_fwd), "max fwd")
    _close_m(got["final_height_m"], float(state.robot.pos[2]), "final height")
    assert got["controller_switched"] == bool(state.task.switched_controller)
    assert got["max_height_m"] > 0.2 and got["controller_switched"]   # the example's jump


def test_cpg_matches_jax_example():
    """examples/run_cpg.py's scan over CPG_STEPS 1 kHz steps (TROT), from
    the CPG start the JAX example draws from PRNGKey(1)."""
    env = JQuadrupedEnv(JEnvConfig(
        is_rl_gym_interface=False, motor_control_mode="TORQUE", action_repeat=1,
        enable_springs=False, task_env="NO_TASK", observation_space_mode="ENCODER",
        action_space_mode="DEFAULT", env_randomizer_mode="NONE", obs_noise=False))
    params = jcpg.HopfParams(gait="TROT", omega_swing=8 * jnp.pi, omega_stance=4 * jnp.pi,
                             des_step_len=0.05)
    state, _ = env.reset(jax.random.PRNGKey(0))
    X = jcpg.init_state(params, jax.random.PRNGKey(1))

    @jax.jit
    def step_fn(carry, _):
        state, X = carry
        X, fx, fz = jcpg.cpg_update(params, X)
        tau = jcpg.cpg_torques(env.cfg, state.robot.q, state.robot.qd, fx, fz)
        state, _, _, _, _ = env.step(state, tau)
        return (state, X), state.robot.pos

    _, pos = jax.lax.scan(step_fn, (state, X), None, length=CPG_STEPS)
    pos = np.asarray(pos)
    got = ex.cpg(device="cpu", X0=torch.from_numpy(np.asarray(X)), n_steps=CPG_STEPS)
    _close_m(got["forward_travel_m"], pos[-1, 0] - pos[0, 0], "forward travel")
    _close_m(got["mean_height_m"], pos[:, 2].mean(), "mean height")
    _close_m(got["min_height_m"], pos[:, 2].min(), "min height")
    _close_m(got["final_pos"], pos[-1], "final position")
    assert got["upright"] == bool(pos[:, 2].min() > 0.12) and got["seconds"] == 0.2


def test_cartesian_jump_matches_jax_example():
    """examples/run_cartesian_jump.py run() (its 600-substep settle; the
    episode ends inside STEPS control steps) against the port's run on the
    ground the JAX run drew."""
    from examples.run_cartesian_jump import run

    want, state = run(verbose=False)
    got = ex.cartesian_jump(device="cpu", max_steps=STEPS,
                            scenario=convert.scenario_params(state.scenario))
    assert want["steps"] < STEPS and got["steps"] == want["steps"]
    for k in ("interface", "upright", "controller_switched"):
        assert got[k] == want[k], k
    for k in ("apex_rel_m", "final_z"):
        _close_m(got[k], want[k], k)
    np.testing.assert_allclose(got["up_z"], want["up_z"], rtol=0, atol=1e-3)
    # tests/test_closed_loop_behaviors.py's gate on the example
    assert got["apex_rel_m"] >= 0.25 and got["controller_switched"] and got["upright"]


def _jax_mpc_problem(**kw):
    return jmpc.MPCProblem(jmpc.MPCConfig(task="JUMPING_IN_PLACE", enable_springs=True,
                                          horizon=H, iterations=ITERS, n_alphas=6, **kw))


def _same_ilqr(got, trace, cost):
    trace = np.asarray(trace)
    np.testing.assert_allclose(got["initial_cost"], trace[0], rtol=2e-3)
    np.testing.assert_allclose(got["final_cost"], float(cost), rtol=0.15)
    assert len(got["cost_trace"]) == len(trace)
    assert got["monotone"] and bool(np.all(np.diff(trace) <= 1e-5))
    assert got["controls_finite"]


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_mpc_ilqr_matches_jax_example(parallel):
    """examples/run_mpc.py's iLQR solve at H = 6, 2 iterations (6 line
    search candidates; --parallel-riccati), and --batch 2."""
    prob = _jax_mpc_problem(backward="parallel" if parallel else "sequential")
    x0, u0 = prob.default_x0(), prob.default_warm_start()
    sol = prob.solve(x0, u0)
    got = ex.mpc(device="cpu", horizon=H, iterations=ITERS, parallel_riccati=parallel,
                 batch=0 if parallel else 2)
    _same_ilqr(got, sol.cost_trace, sol.cost)
    assert got["solver"] == "ilqr" and got["u_absmax"] <= 1.0
    if not parallel:
        sols = prob.solve_batch(jnp.broadcast_to(x0, (2,) + x0.shape),
                                jnp.broadcast_to(u0, (2,) + u0.shape))
        np.testing.assert_allclose([got["batch_cost_min"], got["batch_cost_max"]],
                                   [float(sols.cost.min()), float(sols.cost.max())], rtol=0.15)
        # a row's solve does not depend on its batch: the copies agree
        assert got["batch_cost_min"] == got["batch_cost_max"] == got["final_cost"]


def test_mpc_mppi_matches_jax_example():
    """examples/run_mpc.py --mppi at H = 6, 2 iterations (K = 32) with the
    draws the JAX example makes from PRNGKey(0) injected."""
    prob = _jax_mpc_problem()
    cfg = jmppi.MPPIConfig(horizon=H, iterations=ITERS, n_samples=32)
    sol = prob.solve_mppi(prob.default_x0(), prob.task_warm_start(), jax.random.PRNGKey(0),
                          cfg)
    draws = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (32, H, 6), jnp.float32))(
        jax.random.split(jax.random.PRNGKey(0), ITERS)))[:, None]
    got = ex.mpc(device="cpu", horizon=H, iterations=ITERS, mppi=True, mppi_iterations=ITERS,
                 draws=torch.from_numpy(draws.copy()))
    np.testing.assert_allclose(got["cost_trace"], np.asarray(sol.cost_trace), rtol=1e-5)
    np.testing.assert_allclose(got["final_cost"], float(sol.cost), rtol=1e-5)
    zs, vz = np.asarray(sol.xs[:, 2]), np.asarray(sol.xs[:, 9])
    _close_m(got["max_height_m"], zs.max(), "max height")
    _close_m(got["predicted_apex_m"], (zs + np.maximum(vz, 0) ** 2 / (2 * 9.81)).max(), "apex")
    np.testing.assert_allclose(got["u_absmax"], float(np.abs(sol.us).max()), rtol=0, atol=1e-5)
    assert got["solver"] == "mppi" and got["controls_finite"]


def test_backflip_matches_jax_example():
    """examples/run_backflip.py at H = 6, 2 iterations: the cost trace, and
    the rotation and apex of the plan, held where the two plans agree (the
    final costs to 15%: the rotation within 0.05 rad, the apex 1e-2 m)."""
    prob = jmpc.MPCProblem(jmpc.MPCConfig(task="BACKFLIP", horizon=H, iterations=ITERS,
                                          n_alphas=8))
    sol = prob.solve(prob.default_x0(), prob.task_warm_start())
    xs = np.asarray(sol.xs)
    pitch = np.array([float(jsp.pitch_unwrapped_yxz(jnp.asarray(q), jnp.asarray(False)))
                      for q in xs[:, 3:7]])
    rotation = np.unwrap(pitch)
    got = ex.backflip(device="cpu", horizon=H, iterations=ITERS)
    _same_ilqr(got, sol.cost_trace, sol.cost)
    np.testing.assert_allclose(got["rotation_rad"], rotation.max() - rotation.min(), rtol=0,
                               atol=0.05)
    np.testing.assert_allclose(got["rotation_deg"], math.degrees(got["rotation_rad"]))
    np.testing.assert_allclose(got["apex_height_m"], xs[:, 2].max(), rtol=0, atol=1e-2)


def test_quickstart_step_matches_jax_example():
    """examples/train_quickstart.py's trainer (8 directions, top 4, a bank
    of 4) for one train_step and the 4-episode evaluation, with JAX's
    deltas, reset bank and evaluation bank injected, its episodes cut to 12
    steps timing out at 0.1 s without observation noise (as
    tests/test_torch_compare_springs.py cuts the learned comparison's: under
    feedback the lanes' episodes end at different steps in the two
    packages over the example's 60): returns 1e-3 relative and 1e-5 absolute, the update of
    W to 1e-4 of its largest entry, the evaluation's apex 1e-3 m."""
    cut_env, cut_steps = dict(max_ep_len=0.1, obs_noise=False), 12
    kw = dict(enable_springs=True, task_env="JUMPING_IN_PLACE",
              observation_space_mode="ARS_BASIC", action_space_mode="SYMMETRIC",
              settling_steps=500, max_ep_len=0.5)
    env = JQuadrupedEnv(JEnvConfig(**{**kw, **cut_env}))
    tr = jars.ARSTrainer(env, jars.ARSConfig(n_directions=8, top_directions=4,
                                             episode_steps=cut_steps, reset_bank_size=4))
    ts = tr.init(jax.random.PRNGKey(0))
    _, k_delta, k_bank = jax.random.split(ts.key, 3)
    deltas = jax.random.normal(k_delta, (8,) + ts.W.shape) * tr.config.delta_std
    bank = jro.make_reset_bank(env, k_bank, 4, curriculum_level=ts.curriculum_level)
    ts2, m = tr.train_step(ts)
    ev = tr.evaluate(ts2, n_episodes=4)
    eval_bank = jro.make_reset_bank(env, jax.random.fold_in(ts2.key, 123), 4)
    t = lambda x: torch.from_numpy(np.array(x))
    tb = lambda b: (convert.env_state(b[0]), t(b[1]))
    got = ex.quickstart(device="cpu", steps=1, draws=[(t(deltas), tb(bank)), tb(eval_bank)],
                        env_overrides=cut_env, episode_steps=cut_steps)
    assert float(m["sigma_r"]) > 1e-4
    for k, v in (("mean_return", m["mean_return"]), ("best_return", m["best_return"])):
        np.testing.assert_allclose(got["steps"][0][k], float(v), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got["eval_return_mean"], float(ev["return_mean"]), rtol=1e-3,
                               atol=1e-5)
    _close_m(got["eval_max_height_m"], float(ev["max_height"]), "eval apex")
    dW = np.abs(np.asarray(ts2.W)).max()
    np.testing.assert_allclose(got["W_absmax"], dW, rtol=1e-4)


# the cut each run's main() is driven at: keyword arguments of the runs the
# command line does not set
CUTS = {"episode": {"settle": 50, "max_steps": 2}, "cartesian_jump": {"max_steps": 2},
        "mpc": {"horizon": 4, "iterations": 1, "mppi_iterations": 1}}


@pytest.mark.parametrize("argv", [["episode"], ["cartesian_jump"], ["cpg", "--seconds", "0.01"],
                                  ["mpc", "--mppi"],
                                  ["backflip", "--horizon", "4", "--iters", "1"]])
def test_entry_point_prints_one_json_line(argv, capsys, monkeypatch):
    """main() of each run at a tiny size on the CPU (its CUTS on top of the
    command line): one JSON line, the run's record with `device` and
    `wall_s`, finite numbers; the card is the default and its absence an
    error."""
    run = argv[0]
    monkeypatch.setitem(ex.RUNS, run, functools.partial(ex.RUNS[run], **CUTS.get(run, {})))
    rec = ex.main(argv + ["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec and rec["device"] == "cpu" and rec["wall_s"] > 0
    assert all(np.isfinite(v) for v in rec.values() if isinstance(v, float))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ex.main(argv)
