"""The springs-vs-rigid comparisons (quadruped_springs_tpu_torch/
compare_springs.py) on the CPU at a reduced size, against the JAX package.

planned: both robots at H = 6, K = 4, 2 iterations, 2 solves and a 600-substep
settle, with the draws scripts/compare_springs.py makes from
split(PRNGKey(1), 2) injected; the JAX side is the script's lines rebuilt
here (the script runs at import). The plans are held at
tests/test_torch_mpc_behaviours.py's tolerances (us 1e-5, costs 1e-5
relative, states 1e-3 plus twice the JAX package's own spread, the settled
start 1e-3); the rows' planned apexes to 1e-3 m and costs to
1e-5 relative. Then one given plan (the task's warm start and the landing
action, 76 control steps) through both packages' fidelity envs: the
executed apex and final height to 1e-3 m, the peak motor torque to 1e-3
N m, the motors' work to 1e-2 relative (tests/test_torch_env.py: hundreds
of stiff substeps part the two packages in the last digits).

learned: the script's configuration (every field of its EnvConfig and
ARSConfig), then one iteration of scripts/compare_springs_learned.py's
run_config (the JAX script's own function) cut to 2 directions, top 1, a
bank of 2 and 22-step episodes that time out at 0.2 s without observation
noise (the script's 256 lanes x 110 steps take minutes on the CPU, and over
110 steps the lanes' episodes end at different steps in the two packages:
stiff contact under feedback, and observation noise the port draws
differently) against the port's with JAX's deltas, reset bank and
evaluation bank injected, at tests/test_torch_train.py::test_ars_train_step_matches_jax_on_
its_own_draws's tolerances (returns 1e-3 relative and 1e-5 absolute, the
update of W to 1e-4 of its largest entry); the curve's summaries on the
committed curves; the entry points' JSON at a tiny size.
"""

import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env.env import QuadrupedEnv as JQuadrupedEnv
from quadruped_springs_tpu.solver import mpc as jmpc
from quadruped_springs_tpu.solver import mppi as jmppi
from quadruped_springs_tpu.train import ars as jars
from quadruped_springs_tpu.train import rollout as jro
from quadruped_springs_tpu.utils import verification as jV
from quadruped_springs_tpu_torch import compare_springs as cs
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.solver import mpc as tmpc
from tests.torch_compare_springs_probe import jax_draws

REPO = pathlib.Path(__file__).resolve().parents[1]
H, K, ITERS, N, SETTLE = 6, 4, 2, 2, 600
TRACE_STEPS = H + cs.LANDING_KNOTS
XS_SPREAD = 2.0
# the learned iteration's cut: 2 directions, top 1, a bank of 2, 7-step
# episodes that time out at their 6th step, no observation noise
CUT_ARS = dict(n_directions=2, top_directions=1, reset_bank_size=2, episode_steps=22)
CUT_ENV = dict(max_ep_len=0.2, obs_noise=False)
_jax_envs = {}


def _jax_fidelity_env(springs: bool):
    """The JAX package's fidelity env with the settle cut to SETTLE (one
    instance per robot: its jitted methods key on the instance)."""
    if springs not in _jax_envs:
        cfg = jV.fidelity_env("JUMPING_IN_PLACE", enable_springs=springs).config
        _jax_envs[springs] = JQuadrupedEnv(dataclasses.replace(cfg, settling_steps=SETTLE))
    return _jax_envs[springs]


def _jax_execute(env, us):
    """The script's execution and row of a plan (T, m): record_golden_trace
    from PRNGKey(2), then its apex, peak torque, motor work, final height,
    uprightness (unrounded)."""
    got = jV.split_trace(np.asarray(jV.record_golden_trace(env, us, jax.random.PRNGKey(2))),
                         env.action_dim)
    z, tau, qd = got["pos"][:, 2], got["tau"], got["qd"]
    return {"executed_apex_m": float(z.max()),
            "peak_motor_torque_Nm": float(np.abs(tau).max()),
            "motor_work_J": float(np.maximum(np.sum(tau * qd, axis=1), 0.0).sum()) * 0.01,
            "final_z_m": float(z[-1]),
            "upright": bool(abs(got["quat"][-1, 0]) + abs(got["quat"][-1, 1]) < 0.5)}, z


def _same_execution(got: dict, want: dict):
    for k in ("executed_apex_m", "final_z_m"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["peak_motor_torque_Nm"], want["peak_motor_torque_Nm"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["motor_work_J"], want["motor_work_J"], rtol=1e-2)
    assert got["upright"] == want["upright"]


@pytest.mark.parametrize("springs", [True, False], ids=["springs", "rigid"])
def test_planned_row_matches_the_jax_script(springs, monkeypatch):
    """The port's row of one robot with JAX's draws against the script's
    lines: the settled start, each solve's plan, the rows' planned apexes
    and costs, and the best plan executed with the landing action."""
    seen = []
    solve = tmpc.MPCProblem.solve_mppi

    def record(self, x0, u_init, *args, **kw):
        sol = solve(self, x0, u_init, *args, **kw)
        seen.append((x0.clone(), u_init.clone(), sol))
        return sol

    monkeypatch.setattr(tmpc.MPCProblem, "solve_mppi", record)
    draws = torch.from_numpy(jax_draws(1, N, H, K, ITERS))
    row, = cs.planned_rows(springs, torch.device("cpu"), horizon=H, iterations=ITERS,
                           n_samples=K, n_solves=N, draws=draws, settle=SETTLE)
    (x0, u0, tsol), = seen

    # scripts/compare_springs.py, its sizes cut; the plan from the port's start
    prob = jmpc.MPCProblem(jmpc.MPCConfig(task="JUMPING_IN_PLACE", horizon=H,
                                          iterations=ITERS, n_alphas=8,
                                          enable_springs=springs))
    env = _jax_fidelity_env(springs)
    state, _ = env.reset(jax.random.PRNGKey(0))
    # the settle's 600 stiff substeps part the packages in the last digits;
    # the settled velocities (~1e-2) by up to 3.2e-4
    np.testing.assert_allclose(x0[0], np.asarray(jmpc.state_to_vec(state.robot)), rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(u0[0].numpy(), np.asarray(prob.task_warm_start()))
    mcfg = jmppi.MPPIConfig(horizon=H, iterations=ITERS, n_samples=K)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    xj = jnp.asarray(x0[0].numpy())
    sols = jax.jit(jax.vmap(lambda k: prob.solve_mppi(xj, prob.task_warm_start(), k,
                                                      mcfg)))(keys)
    np.testing.assert_allclose(tsol.us, sols.us, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsol.cost, sols.cost, rtol=1e-5)
    np.testing.assert_allclose(tsol.cost_trace, sols.cost_trace, rtol=1e-5)
    # states: 1e-3 (1 + |JAX|) plus XS_SPREAD x the JAX package's own spread,
    # the larger of its rollouts' change under a start one ulp up in every
    # joint angle and under the port's plans in place of its own (they agree
    # to 1e-5): at knot 6 of the rigid robot's first plan a joint rate moves
    # 2.1e-2 between JAX's rollouts of the two plans, and the port lies
    # 2.0e-2 from JAX there (stiff contact at the plan's end)
    roll = jax.jit(jax.vmap(lambda x, u: jnp.concatenate(
        [x[None], jax.lax.scan(lambda c, a: (prob.dynamics(c, a),) * 2, x, u)[1]]),
        in_axes=(None, 0)))
    jxs = np.asarray(roll(xj, sols.us))
    np.testing.assert_array_equal(jxs, np.asarray(sols.xs))
    x_ulp = xj.at[13:25].set(jnp.nextafter(xj[13:25], jnp.inf))
    spread = np.maximum(np.abs(np.asarray(roll(x_ulp, sols.us)) - jxs),
                        np.abs(np.asarray(roll(xj, jnp.asarray(tsol.us.numpy()))) - jxs))
    gap = np.abs(tsol.xs.numpy() - jxs)
    assert (gap <= 1e-3 * (1 + np.abs(jxs)) + XS_SPREAD * spread).all(), (
        gap.max(), np.unravel_index(gap.argmax(), gap.shape))
    z, vz = sols.xs[..., 2], sols.xs[..., 9]
    apexes = np.asarray(jnp.max(z + jnp.maximum(vz, 0.0) ** 2 / (2 * 9.81), axis=-1))
    best = int(jnp.argmin(sols.cost))
    assert row["best"] == best
    np.testing.assert_allclose(row["apexes"], apexes, rtol=0, atol=1e-3)
    for k, v in (("planned_apex_best_m", apexes[best]), ("planned_apex_mean_m", apexes.mean()),
                 ("planned_apex_max_m", apexes.max())):
        np.testing.assert_allclose(row[k], v, rtol=0, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(row["best_cost"], float(sols.cost[best]), rtol=1e-5)
    np.testing.assert_allclose(row["mean_cost"], float(jnp.mean(sols.cost)), rtol=1e-5)
    land = env.get_landing_action()
    us = jnp.concatenate([sols.us[best], jnp.broadcast_to(land, (70,) + land.shape)], axis=0)
    want, _ = _jax_execute(env, us)
    _same_execution(row, want)
    assert row["n_solves"] == N


@pytest.mark.parametrize("springs", [True, False], ids=["springs", "rigid"])
def test_given_plan_executes_as_in_jax(springs):
    """The task's warm start at H = 50 followed by the landing action (76
    control steps: the crouch, the push-off and the flight) through both
    packages' fidelity envs: the execution's numbers and the height trace."""
    tprob = tmpc.MPCProblem(tmpc.MPCConfig(task="JUMPING_IN_PLACE", horizon=50,
                                           enable_springs=springs), "cpu")
    env_t = cs.V.fidelity_env("JUMPING_IN_PLACE", springs, "cpu", SETTLE)
    plan = torch.cat([tprob.task_warm_start(),
                      env_t.get_landing_action().expand(TRACE_STEPS - 50, -1)])
    trace = cs.V.record_golden_trace(env_t, plan[None], torch.Generator().manual_seed(2))
    got = cs.execution_row(trace[0].numpy(), env_t.action_dim)
    want, z = _jax_execute(_jax_fidelity_env(springs), jnp.asarray(plan.numpy()))
    _same_execution(got, want)
    assert want["executed_apex_m"] > 0.4            # the plan jumps
    np.testing.assert_allclose(cs.V.split_trace(trace[0].numpy(), env_t.action_dim)["pos"][:, 2],
                               z, rtol=0, atol=1e-3)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run_config(monkeypatch, springs, iters, cut):
    """scripts/compare_springs_learned.py run_config(springs, iters, 0), its
    EnvConfig and ARSConfig replaced by the cut where `cut`; returns its
    record, its trainers and per train_step (state in, state out, metrics)."""
    from quadruped_springs_tpu.env import env as jenv_mod

    trainers, trained = [], []
    train_step = jars.ARSTrainer.train_step

    def record(self, ts):
        out = train_step(self, ts)
        trained.append((ts, *out))
        return out

    init = jars.ARSTrainer.__init__

    def record_init(self, *a, **kw):
        init(self, *a, **kw)
        trainers.append(self)

    monkeypatch.setattr(jars.ARSTrainer, "train_step", record)
    monkeypatch.setattr(jars.ARSTrainer, "__init__", record_init)
    if cut:
        ars_cfg, env_cfg = jars.ARSConfig, jenv_mod.EnvConfig
        monkeypatch.setattr(jars, "ARSConfig", lambda **kw: ars_cfg(**{**kw, **CUT_ARS}))
        monkeypatch.setattr(jenv_mod, "EnvConfig", lambda **kw: env_cfg(**{**kw, **CUT_ENV}))
    want = _script("compare_springs_learned").run_config(springs, iters, 0)
    return want, trainers, trained


@pytest.mark.parametrize("springs", [True, False], ids=["springs", "rigid"])
def test_learned_configuration_is_the_scripts(springs, monkeypatch):
    """run_config's environment and trainer are the script's: every field of
    the EnvConfig and ARSConfig the JAX script builds (run for 0
    iterations) has the port's value, and the empty curve's summaries
    agree."""
    want, (trainer,), _ = _jax_run_config(monkeypatch, springs, 0, cut=False)
    tenv = cs.learned_env(springs, "cpu")
    for f in dataclasses.fields(trainer.env.config):
        assert getattr(tenv.config, f.name) == getattr(trainer.env.config, f.name), f.name
    assert dataclasses.asdict(trainer.config) == {
        k: v for k, v in dataclasses.asdict(cs.LEARNED_ARS).items()
        if k in dataclasses.asdict(trainer.config)}
    got = cs.run_config(springs, 0, 0, "cpu")
    for k in ("enable_springs", "best_apex_m", "final10_apex_mean_m", "iters_to_0p5m",
              "iters_to_0p75m", "curve"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("springs", [True, False], ids=["springs", "rigid"])
def test_learned_iteration_matches_the_jax_script(springs, monkeypatch):
    """One iteration of the script's run_config at the cut (CUT_ARS, CUT_ENV:
    over the script's 110 steps the lanes' episodes end at different steps
    in the two packages, stiff contact under feedback) against the port's
    run_config on the draws JAX's trainer makes from the script's key: the
    curve's entry (train and evaluation return, evaluation apex), the update
    of W, the summaries."""
    want, (trainer,), ((jts, jts2, jm),) = _jax_run_config(monkeypatch, springs, 1, cut=True)
    cfg = dataclasses.replace(cs.LEARNED_ARS, **CUT_ARS)
    # train_step's split of the init key; evaluate's bank from fold_in of the
    # key it leaves
    _, k_delta, k_bank = jax.random.split(jts.key, 3)
    deltas = jax.random.normal(k_delta, (cfg.n_directions,) + jts.W.shape) * cfg.delta_std
    bank = jro.make_reset_bank(trainer.env, k_bank, cfg.reset_bank_size,
                               curriculum_level=jts.curriculum_level)
    eval_bank = jro.make_reset_bank(trainer.env, jax.random.fold_in(jts2.key, 123), 4)
    t = lambda x: torch.from_numpy(np.array(x))
    tb = lambda b: (convert.env_state(b[0]), t(b[1]))
    got = cs.run_config(springs, 1, 0, "cpu", draws=[(t(deltas), tb(bank), tb(eval_bank))],
                        ars_config=cfg, env_overrides=CUT_ENV)
    gc, wc = got["curve"][0], want["curve"][0]
    assert float(jm["sigma_r"]) > 1e-4       # the returns differ: a real update
    for k in ("mean_return", "eval_return"):
        np.testing.assert_allclose(gc[k], wc[k], rtol=1e-3, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(gc["eval_max_height"], wc["eval_max_height"], rtol=0, atol=1e-3)
    dW_j = np.asarray(jts2.W) - np.asarray(jts.W)
    assert np.abs(dW_j).max() > 1e-3
    np.testing.assert_allclose(got["W"].numpy() - np.asarray(jts.W), dW_j, rtol=0,
                               atol=1e-4 * np.abs(dW_j).max())
    for k in ("best_apex_m", "final10_apex_mean_m"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3, err_msg=k)
    assert (got["iters_to_0p5m"], got["iters_to_0p75m"]) == (want["iters_to_0p5m"],
                                                             want["iters_to_0p75m"])
    assert got["enable_springs"] == want["enable_springs"] == springs


def test_summaries_reproduce_the_committed_results():
    """curve_summary and advantage_pct on the committed learned curves, and
    summary on the committed planned rows, give the committed numbers."""
    learned = json.loads((REPO / "docs/springs_vs_rigid_learned.json").read_text())
    for label in ("springs", "rigid"):
        got = cs.curve_summary(learned[label]["curve"])
        for k, v in got.items():
            assert v == learned[label][k], (label, k)
    assert cs.advantage_pct(learned) == learned["springs_advantage_pct"]
    assert cs.iters_to([{"iter": 0, "eval_max_height": 0.1}], 0.5) is None
    planned = json.loads((REPO / "docs/springs_vs_rigid.json").read_text())
    assert cs.summary(planned["springs"], planned["rigid"]) == planned["summary"]


def test_entry_points_print_the_scripts_keys(capsys, tmp_path, monkeypatch):
    """Both subcommands at a tiny size: one JSON line with the scripts'
    keys (the planned rows' 12 and the summary's 3; the learned record's),
    device and seed; --out writes the same object and refuses the
    committed results' names; without --device, no card is an error."""
    rec = cs.planned(device="cpu", horizon=4, iterations=1, n_samples=4, n_solves=2,
                     settle=100, landing_knots=4)
    ref = json.loads((REPO / "docs/springs_vs_rigid.json").read_text())
    for label in ("springs", "rigid"):
        assert list(rec[label]) == list(ref[label])
    assert list(rec["summary"]) == list(ref["summary"])
    assert rec["device"] == "cpu" and rec["seed"] == 1
    with pytest.raises(SystemExit):
        cs.main(["planned", "--device", "cpu", "--out", str(tmp_path / "springs_vs_rigid.json")])
    out = tmp_path / "learned.json"
    rec = cs.main(["learned", "--device", "cpu", "--iters", "0", "--configs", "springs",
                   "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec == json.loads(out.read_text())
    learned = json.loads((REPO / "docs/springs_vs_rigid_learned.json").read_text())
    assert set(learned["springs"]) <= set(rec["springs"])
    assert {"task", "trainer", "iters", "seed"} <= set(rec) and rec["device"] == "cpu"
    # the records name the card as torch.cuda names it
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: f"card {device}")
    assert cs.device_name(torch.device("cuda", 0)) == "card cuda:0"
    monkeypatch.undo()
    if not torch.cuda.is_available():       # the card is the default, its absence an error
        for run in ("planned", "learned"):
            with pytest.raises(RuntimeError, match="CUDA"):
                cs.main([run, "--iters", "0"])
