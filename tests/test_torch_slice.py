"""The port's planner slice end to end on the CPU: MPCProblem.dynamics over a
knot and the whole fused-accept MPPI solve against the JAX package on
JAX-sampled scenarios with JAX's noise injected, the jax-free import of the
port, its bench entry point at a tiny size, and chip_smoke.py's refusal to
run without a CUDA card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env import randomizers as jrnd
from quadruped_springs_tpu.solver import mpc as jmpc
from quadruped_springs_tpu.solver import mppi as jmppi
from quadruped_springs_tpu_torch import bench, convert
from quadruped_springs_tpu_torch.solver import mpc as tmpc
from quadruped_springs_tpu_torch.solver import mppi as tmppi

REPO = Path(__file__).resolve().parents[1]
B, K, H, ITERS = 2, 8, 6, 2


def _problems(horizon=H, iterations=ITERS, full_rate=False):
    kw = dict(task="JUMPING_IN_PLACE", horizon=horizon, iterations=iterations)
    jmk, tmk = ((jmpc.MPCConfig.full_rate, tmpc.MPCConfig.full_rate) if full_rate
                else (jmpc.MPCConfig, tmpc.MPCConfig))
    return jmpc.MPCProblem(jmk(**kw)), tmpc.MPCProblem(tmk(**kw), "cpu")


def _jax_scenarios(jprob, n, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.jit(jax.vmap(lambda k: jrnd.sample_scenario(jprob.cfg, "TEST_RANDOMIZER",
                                                           k)))(keys)


@pytest.mark.parametrize("full_rate", [False, True], ids=["relaxed", "full_rate"])
def test_dynamics_knot_matches_jax(full_rate):
    """One 100 Hz knot from perturbed standing states on 4 JAX-sampled
    scenarios. The two implementations solve the 18x18 system differently
    (LU vs closed form) in f32. Relaxed model (2 substeps of 5 ms at 4
    kN/m): after two steps the states (joint velocities up to 30 rad/s)
    differ by ~5e-5 (4.4e-5 measured), held to 1e-4. Full rate (10 substeps
    of 1 ms at 180 kN/m, the damping clamp on): the stiff contact amplifies
    the rounding through five times as many steps, 3.4e-4 measured (1.0e-4
    of 1 + |x|), held to 1e-3."""
    jprob, tprob = _problems(full_rate=full_rate)
    tol = 1e-3 if full_rate else 1e-4
    scen = _jax_scenarios(jprob, 4)
    rng = np.random.default_rng(0)
    x = np.tile(np.asarray(jprob.default_x0()), (4, 1))
    x[:, 13:25] += 0.1 * rng.standard_normal((4, 12))
    x[:, 25:37] = rng.standard_normal((4, 12))
    x[:, 2] -= 0.01                                   # feet pressed into the ground
    x = x.astype(np.float32)
    u = rng.uniform(-1, 1, (4, jprob.action_dim)).astype(np.float32)
    want = jax.jit(jax.vmap(jprob.dynamics))(x, u, scen)
    lanes = tprob.lane_params(convert.scenario_params(scen))
    got = tprob.dynamics(torch.from_numpy(x), torch.from_numpy(u), lanes)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert not np.allclose(np.asarray(want), x, atol=1e-3)   # the knot moved


# (horizon, us atol, cost and trace rtol, xs rtol and atol) per planner model
MPPI_CASE = {False: (H, 1e-5, 1e-5, 1e-3), True: (4, 1e-5, 1e-5, 5e-3)}


@pytest.mark.parametrize("full_rate", [False, True], ids=["relaxed", "full_rate"])
def test_solve_mppi_matches_jax_with_injected_noise(full_rate):
    """The whole fused-accept solve, B=2 scenarios x K=8 samples, two
    iterations, with the JAX draws injected. The rollouts solve the 18x18
    system differently (closed form vs LU) in f32. Relaxed model (H=6, 12
    substeps of 5 ms): joint velocities of up to 30 rad/s differ by ~3e-4,
    xs held to 1e-3; the costs sum those states into O(30) values that agree
    to ~1e-7 relative, and the softmax weights exp(-Δc/0.05) turn a cost
    difference δ into a relative weight change of δ/0.05, so costs and us
    are held to 1e-5. Full rate (1 ms substeps at 180 kN/m, the damping
    clamp on): the stiff contact amplifies the rounding. At H=6 (60 substeps)
    a sample crosses a contact switch where the two packages' rounding moves
    its joint velocities by O(1) (measured: 0.68 rad/s, and its cost by
    6e-4 relative), so the full-rate case plans H=4 (40 substeps): us part
    by 9e-8 (held to 1e-5), costs by 7e-8 relative (1e-5), xs by 6.7e-4 at
    a joint velocity of 7.9 rad/s (5e-3)."""
    horizon, us_tol, cost_tol, xs_tol = MPPI_CASE[full_rate]
    jprob, tprob = _problems(horizon=horizon, full_rate=full_rate)
    H = horizon
    cfg = dict(horizon=H, iterations=ITERS, n_samples=K, fused_accept=True)
    jcfg, tcfg = jmppi.MPPIConfig(**cfg), tmppi.MPPIConfig(**cfg)
    scen = _jax_scenarios(jprob, B)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    x0 = jnp.broadcast_to(jprob.default_x0(), (B, 37))
    u0 = jnp.broadcast_to(jprob.task_warm_start(), (B, H, jprob.action_dim))
    jsol = jax.jit(jax.vmap(lambda x, u, k, s: jprob.solve_mppi(x, u, k, jcfg, s)))(
        x0, u0, keys, scen)
    m = jprob.action_dim
    noise = jax.vmap(lambda k: jax.vmap(
        lambda ki: jax.random.normal(ki, (K, H, m), jnp.float32))(
        jax.random.split(k, ITERS)))(keys)                 # (B, iters, K, H, m)
    noise = torch.from_numpy(np.array(noise)).transpose(0, 1).contiguous()
    tsol = tprob.solve_mppi(torch.from_numpy(np.array(x0)), torch.from_numpy(np.array(u0)),
                            None, tcfg, convert.scenario_params(scen), noise)
    np.testing.assert_allclose(tsol.us, jsol.us, rtol=0, atol=us_tol)
    np.testing.assert_allclose(tsol.cost, jsol.cost, rtol=cost_tol)
    np.testing.assert_allclose(tsol.cost_trace, jsol.cost_trace, rtol=cost_tol)
    np.testing.assert_allclose(tsol.xs, jsol.xs, rtol=xs_tol, atol=xs_tol)
    assert torch.all(tsol.cost_trace[:, -1] <= tsol.cost_trace[:, 0])


def test_solve_mppi_nominal_per_iteration_accept():
    """The per-iteration accept branch on the Go1 problem, nominal scenario:
    finite plans, a monotone cost trace, the returned cost that of `us`."""
    _, tprob = _problems(horizon=4, iterations=3)
    cfg = tmppi.MPPIConfig(horizon=4, iterations=3, n_samples=6, sigma=0.2)
    x0 = tprob.default_x0().expand(2, -1)
    u0 = tprob.task_warm_start().expand(2, -1, -1)
    sol = tprob.solve_mppi(x0, u0, torch.Generator().manual_seed(3), cfg)
    assert torch.isfinite(sol.us).all() and torch.isfinite(sol.cost).all()
    assert torch.all(torch.diff(sol.cost_trace, dim=-1) <= 1e-5)
    lanes = tprob.lane_params(repeats=1)
    x, total = x0[:1], torch.zeros(1)
    for t in range(4):
        total = total + tprob.stage_cost(x, sol.us[:1, t], t)
        x = tprob.dynamics(x, sol.us[:1, t], lanes)
    np.testing.assert_allclose(total + tprob.terminal_cost(x), sol.cost[:1], rtol=1e-5)


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax, flax and orbax out of
    sys.modules (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import quadruped_springs_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'orbax'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 14     # every module of the slice was imported


@pytest.mark.parametrize("flags,desc", [([], "planner@200Hz-4kN-relaxed"),
                                         (["--full-rate"], "planner@1000Hz-180kN"),
                                         (["--no-springs"], "no-springs"),
                                         (["--ilqr", "--exact"], "iLQR H=4, 1 iters, exact-f32,"),
                                         (["--ilqr"], "iLQR H=4, 1 iters, bf16-lin, relin/3,")])
def test_bench_main_tiny_on_cpu(capsys, flags, desc):
    """The line of bench.py: its eight keys, its rounding (value 2 decimals,
    vs_baseline = value / 625 to 4, mean_final_cost 2), the three keys of
    XLA's cost analysis null; the metric names the row and the device."""
    rec = bench.main(["--device", "cpu", "--batch", "2", "--samples", "4", "--horizon", "4",
                      "--iterations", "1", "--runs", "1", *flags])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "mean_final_cost", "mfu",
                          "flops_per_solve", "mfu_peak_assumed"]
    assert line["metric"].startswith("MPC solves/s/chip (")
    assert "torch port on cpu" in line["metric"] and desc in line["metric"]
    assert line["unit"] == "solves/s"
    assert line["value"] == round(rec["value"], 2) > 0
    assert line["vs_baseline"] == round(rec["value"] / 625.0, 4)
    assert line["mean_final_cost"] == round(rec["mean_final_cost"], 2)
    assert np.isfinite(line["mean_final_cost"])
    assert line["mfu"] is None and line["flops_per_solve"] is None
    assert line["mfu_peak_assumed"] is None
    assert rec["costs"].shape == (2,) and rec["solves"] == 2


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No card, no result: a non-zero exit and no JSON line, from the repo
    and from a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("the refusal is only observable on a machine without a CUDA card")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120, env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
