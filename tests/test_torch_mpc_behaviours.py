"""The MPC behaviour drivers (quadruped_springs_tpu_torch/mpc_behaviours.py)
on the CPU at a reduced size (H = 8, K = 8, 2 iterations, a short settle, at
most 10 control steps): each driver's first plan against the JAX example's
solve (the example's MPCConfig and MPPIConfig at those sizes) from the same
settled state with JAX's draws injected; each driver's JSON line carries
the JAX example's keys; closed_loop.execute_knot through the rollout equals
the substep loop it replaced. The full configurations run on the card in
chip_smoke.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.solver import mpc as jmpc
from quadruped_springs_tpu.solver import mppi as jmppi
from quadruped_springs_tpu_torch import closed_loop, mpc_behaviours
from quadruped_springs_tpu_torch.control import interfaces as ci
from quadruped_springs_tpu_torch.models import dynamics as dyn
from quadruped_springs_tpu_torch.ops import actuation as act
from quadruped_springs_tpu_torch.solver import mpc as tmpc

H, K, ITERS, SETTLE, STEPS = 8, 8, 2, 200, 6
SIZES = dict(horizon=H, iterations=ITERS, n_samples=K, settle=SETTLE)
# the keys of the JSON record each JAX example prints
# (examples/run_jumping_forward_mpc.py run, examples/run_backflip_closed_loop.py
# run, examples/run_continuous_jumping_mpc.py run with the JAX package's
# tasks.continuous_jump_stats)
JAX_KEYS = {
    "jumping_forward": {"driver", "planned_apex_m", "fwd_distance_m", "task_fwd_peak_m",
                        "apex_rel_m", "final_z", "steps", "sim_s"},
    "backflip": {"launch", "pitch_unwrapped_rad", "full_rotation", "apex_rel_m", "final_z",
                 "upright", "steps", "sim_s"},
    "continuous": {"sim_seconds", "n_jumps", "n_jumps_recorded", "good_jumps",
                   "per_jump_fwd_m", "per_jump_height_m", "per_jump_performance",
                   "mean_perf", "max_perf", "mean_fwd_m", "mean_height_m", "total_fwd_m",
                   "final_z_m", "max_z_m"},
}


def _jax_solve_keys(name: str, seed: int, n: int):
    """The keys of the example's first n solves: PRNGKey(seed + 1) for the
    one-plan drivers, a split chain from it for the receding horizon."""
    key = jax.random.PRNGKey(seed + 1)
    if name != "continuous":
        return [key]
    keys = []
    for _ in range(n):
        key, k = jax.random.split(key)
        keys.append(k)
    return keys


def _draws(keys, m):
    """The draws JAX's mppi.solve makes from each key, as the port's
    (iterations, 1, K, H, m) noise."""
    return [torch.from_numpy(np.array(jax.vmap(
        lambda ki: jax.random.normal(ki, (K, H, m), jnp.float32))(
        jax.random.split(k, ITERS))))[:, None].contiguous() for k in keys]


def _jax_ground_friction(seed: int) -> float:
    """The GROUND_RANDOMIZER friction the JAX backflip example's
    env.reset(PRNGKey(seed)) draws (its scenario key, split(key, 3)[1])."""
    from quadruped_springs_tpu.env import randomizers as jrnd
    from quadruped_springs_tpu.models.go1_params import go1_config

    k_scen = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
    return float(jrnd.sample_scenario(go1_config(True), "GROUND_RANDOMIZER", k_scen).friction)


@pytest.mark.parametrize("name", ["jumping_forward", "backflip", "continuous"])
def test_first_plan_matches_jax_example(name, monkeypatch):
    """The driver's first plan (recorded at its solve_mppi call, with the
    state it solved from; the backflip on the JAX example's ground of seed
    0) against the JAX example's MPC problem and MPPI solve from that
    state, with its warm start, the key the example passes and JAX's draws
    injected into the port. The rollouts part as in
    tests/test_torch_slice.py's solve test (the 18x18 solve's rounding
    differs), and the tolerances are its relaxed ones: us 1e-5, costs 1e-5
    relative, states 1e-3."""
    seen = []
    solve = tmpc.MPCProblem.solve_mppi

    def record(self, x0, u_init, *args, **kw):
        sol = solve(self, x0, u_init, *args, **kw)
        seen.append((x0.clone(), u_init.clone(), sol))
        return sol

    monkeypatch.setattr(tmpc.MPCProblem, "solve_mppi", record)
    p = mpc_behaviours.PLANNERS[name]
    m = 6
    keys = _jax_solve_keys(name, 0, STEPS)
    kw = dict(max_steps=STEPS) if name == "continuous" else dict(max_steps=2)
    if name == "backflip":
        kw["friction"] = _jax_ground_friction(0)
    mpc_behaviours.DRIVERS[name](device="cpu", draws=_draws(keys, m), **SIZES, **kw)
    x0, u0, tsol = seen[0]
    jprob = jmpc.MPCProblem(jmpc.MPCConfig(task=p.task, horizon=H, iterations=ITERS,
                                           n_alphas=4))
    jcfg = jmppi.MPPIConfig(horizon=H, iterations=ITERS, n_samples=K, sigma=p.sigma,
                            fused_accept=True)
    warm = jprob.task_warm_start(crouch_knots=p.crouch_knots)[:H]
    np.testing.assert_array_equal(u0[0].numpy(), np.asarray(warm))
    jsol = jprob.solve_mppi(jnp.asarray(x0[0].numpy()), warm, keys[0], jcfg)
    np.testing.assert_allclose(tsol.us[0], jsol.us, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsol.cost[0], jsol.cost, rtol=1e-5)
    np.testing.assert_allclose(tsol.cost_trace[0], jsol.cost_trace, rtol=1e-5)
    np.testing.assert_allclose(tsol.xs[0], jsol.xs, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["jumping_forward", "backflip", "continuous"])
def test_driver_prints_the_jax_examples_keys(name, capsys):
    """The entry point at a tiny size: one JSON line holding every key of
    the JAX example's record, finite numbers, one solve per replan."""
    rec = mpc_behaviours.main([name, "--device", "cpu", "--horizon", "4", "--samples", "4",
                               "--iterations", "1", "--settle", "100", "--max-steps", "4"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec and JAX_KEYS[name] <= set(rec)
    assert rec["solves"] == (2 if name == "continuous" else 1)
    assert all(np.isfinite(v) for v in rec.values() if isinstance(v, float))


@pytest.mark.parametrize("seed", [0, 9])
def test_backflip_ground_is_the_seeds_draw_or_the_given_friction(seed):
    """The backflip driver's ground is the env's GROUND_RANDOMIZER draw of
    the seed for every seed; `friction` (a check injecting the JAX
    example's scenario) replaces the drawn friction."""
    from quadruped_springs_tpu_torch.env import randomizers as rnd
    from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv

    env = QuadrupedEnv(EnvConfig(enable_springs=True, task_env="BACKFLIP",
                                 observation_space_mode="ARS_BACKFLIP",
                                 action_space_mode="SYMMETRIC"), device="cpu")
    drawn = rnd.sample_scenario(env.cfg, env.config.env_randomizer_mode,
                                torch.Generator("cpu").manual_seed(seed), 1).friction
    tiny = dict(device="cpu", horizon=4, n_samples=4, iterations=1, settle=100, max_steps=2)
    rec = mpc_behaviours.backflip(seed=seed, **tiny)
    assert rec["friction"] == float(drawn[0])
    assert mpc_behaviours.backflip(seed=seed, friction=0.5, **tiny)["friction"] == 0.5


def _loop_knot(prob, lanes, consts, state, action):
    """The executor's loop before the rollout kernel: 10 x actuation_torque
    then dynamics.step at the 1 kHz simulator's constants."""
    c = prob.cfg
    params = dyn.default_sim_params(0.001)
    model = lanes.model.repeat_lanes(action.shape[0])
    springs = [t.expand(action.shape[0], 3).contiguous()
               for t in (lanes.spring_k, lanes.spring_b)]
    q_des = ci.action_to_command(prob.iface, action).contiguous()
    for _ in range(closed_loop.EXEC_SUBSTEPS):
        tau, _ = act.actuation_torque(q_des, state.q.contiguous(), state.qd.contiguous(),
                                      c.motor_kp, c.motor_kd, c.torque_limits, *springs,
                                      c.spring_rest_angles, prob.engage_sign)
        state, info = dyn.step(model, params, state, tau, c.velocity_limits)
    return state, info


def test_execute_knot_through_the_rollout_equals_the_loop():
    """Three lanes of the executor over 8 knots of random actions (stance,
    crouch, take-off): execute_knot (planner_rollout at H = 1, S = 10 on the
    nominal row) and the loop it replaced agree bitwise on the CPU."""
    prob = tmpc.MPCProblem(tmpc.MPCConfig(task="JUMPING_IN_PLACE"), "cpu")
    lanes, consts = closed_loop.executor(prob)
    assert consts.substeps == 10 and consts.params.contact_stiffness == 180000.0
    rng = np.random.default_rng(5)
    x0 = prob.default_x0().expand(3, -1)
    a = tmpc.vec_to_state(x0.contiguous())
    b = tmpc.vec_to_state(x0.contiguous())
    for _ in range(8):
        action = torch.from_numpy(rng.uniform(-1, 1, (3, prob.action_dim)).astype(np.float32))
        a, info = closed_loop.execute_knot(prob, lanes, consts, a, action)
        b, _ = _loop_knot(prob, lanes, consts, b, action)
        torch.testing.assert_close(tmpc.state_to_vec(a), tmpc.state_to_vec(b), rtol=0, atol=0)
        assert info["feet_in_contact"].shape == (3, 4)
