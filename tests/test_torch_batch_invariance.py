"""A problem's answer does not depend on how many problems share its batch.

The planner knot, its 43 basis tangents (the iLQR linearization), a short
BACKFLIP solve_batch and short MPPI solves of the bench's problem (its
headline row and its full-rate row) and of the planned springs-vs-rigid
comparison's (both robots) are run
on the first rows of a batch of ROWS problems, alone and in the whole batch,
and must agree bitwise: the small products, sums and the Cholesky solve on
these paths are elementwise ops summed in a fixed order (models/spatial.py),
so nothing sums in an order the batch size picks. chip_smoke.py phase 18
holds the same on the card at 1,024, 8 and 2 rows. Tolerance: none
(torch.equal).
"""

import numpy as np
import pytest
import torch

from quadruped_springs_tpu_torch.env import randomizers as rnd
from quadruped_springs_tpu_torch.env.env import take
from quadruped_springs_tpu_torch.solver import ilqr
from quadruped_springs_tpu_torch.solver.mppi import MPPIConfig
from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

ROWS = 8
HORIZON, ITERATIONS, ALPHAS = 4, 2, 4


@pytest.fixture(scope="module")
def problems():
    prob = MPCProblem(MPCConfig(task="BACKFLIP", horizon=HORIZON, iterations=ITERATIONS,
                                n_alphas=ALPHAS), "cpu")
    rng = np.random.default_rng(0)
    scen = rnd.sample_scenario(prob.cfg, "TEST_RANDOMIZER",
                               torch.Generator("cpu").manual_seed(0), n=ROWS)
    x0 = prob.default_x0() + torch.as_tensor(
        1e-3 * rng.standard_normal((ROWS, 37)), dtype=torch.float32)
    u0 = torch.clamp(prob.task_warm_start() + torch.as_tensor(
        0.1 * rng.standard_normal((ROWS, HORIZON, prob.action_dim)), dtype=torch.float32),
        -1.0, 1.0)

    def rows(k):
        return x0[:k], u0[:k], take(scen, torch.arange(k))

    return prob, rows


def _knot(prob, x0, u0, scen, lanes):
    x = x0[:, None].expand(-1, lanes, -1).contiguous()
    u = u0[:, None, 0].expand(-1, lanes, -1).contiguous()
    return prob.lane_dynamics(scen)(x, u)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("lanes", [1, ALPHAS])
def test_knot_is_batch_invariant(problems, k, lanes):
    prob, rows = problems
    whole = _knot(prob, *rows(ROWS), lanes)
    assert torch.equal(_knot(prob, *rows(k), lanes), whole[:k])


@pytest.mark.parametrize("k", [1, 2])
def test_knot_tangents_are_batch_invariant(problems, k):
    prob, rows = problems

    def tangents(x0, u0, scen):
        f = prob.lane_dynamics(scen)
        z = torch.cat([x0, u0[:, 0]], dim=-1)[:, None]
        return ilqr._basis_jvp(lambda z: f(z[..., :37], z[..., 37:]), z)[1]

    whole = tangents(*rows(ROWS))
    assert whole.shape == (37 + prob.action_dim, ROWS, 1, 37)
    assert torch.equal(tangents(*rows(k)), whole[:, :k])


@pytest.mark.parametrize("k", [1, 2])
def test_solve_batch_is_batch_invariant(problems, k):
    prob, rows = problems
    whole = prob.solve_batch(*rows(ROWS))
    part = prob.solve_batch(*rows(k))
    assert bool(torch.isfinite(whole.cost).all())
    for field in ("cost", "cost_trace", "us", "xs", "reg"):
        assert torch.equal(getattr(part, field), getattr(whole, field)[:k]), field


def _mppi_setting(setting):
    """The MPPI problem, its config and scenarios of one setting: the
    headline's (JUMPING_IN_PLACE on the relaxed model, fused accept,
    TEST_RANDOMIZER scenarios); the full-rate row's (planned on the 1 kHz
    execution model: H = 25, 10 substeps a knot at 180 kN/m, the damping
    clamp on; fused accept); the planned springs-vs-rigid comparison's for
    each robot (compare_springs.planned_rows: the nominal robot,
    MPPIConfig's defaults, K = 64 and the accept rollout every iteration,
    not fused)."""
    gen = torch.Generator("cpu").manual_seed(1)
    if setting == "headline":
        prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=HORIZON,
                                    iterations=ITERATIONS), "cpu")
        cfg = MPPIConfig(horizon=HORIZON, iterations=ITERATIONS, n_samples=8, fused_accept=True)
    elif setting == "full_rate":
        prob = MPCProblem(MPCConfig.full_rate(task="JUMPING_IN_PLACE", horizon=25,
                                              iterations=ITERATIONS), "cpu")
        assert prob.config.solver_substeps == 10 and prob.sim_params.clamp_damping
        cfg = MPPIConfig(horizon=25, iterations=ITERATIONS, n_samples=8, fused_accept=True)
        gen = torch.Generator("cpu").manual_seed(3)
    else:
        prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=HORIZON,
                                    iterations=ITERATIONS, n_alphas=8,
                                    enable_springs=setting == "compare_springs"), "cpu")
        cfg = MPPIConfig(horizon=HORIZON, iterations=ITERATIONS)
        assert (cfg.n_samples, cfg.fused_accept) == (64, False)
        return prob, cfg, None
    return prob, cfg, rnd.sample_scenario(prob.cfg, "TEST_RANDOMIZER", gen, n=ROWS)


@pytest.mark.parametrize("k,setting", [
    pytest.param(k, setting, id=str(k) if setting == "headline" else f"{setting}-{k}")
    for setting in ("headline", "full_rate", "compare_springs", "compare_rigid")
    for k in (1, 2)])
def test_solve_mppi_is_batch_invariant(k, setting):
    """An MPPI solve with its standard-normal draws given, the rows' draws
    the same at every batch size (_mppi_setting): rows 0-k-1 of 8 bitwise
    those of a batch of k."""
    prob, cfg, scen = _mppi_setting(setting)
    x0 = prob.default_x0().expand(ROWS, -1)
    u0 = prob.task_warm_start().expand(ROWS, -1, -1)
    noise = torch.randn((ITERATIONS, ROWS, cfg.n_samples, cfg.horizon, prob.action_dim),
                        generator=torch.Generator("cpu").manual_seed(2))

    def solve(k):
        return prob.solve_mppi(x0[:k], u0[:k], config=cfg, noise=noise[:, :k],
                               scenario=None if scen is None else take(scen, torch.arange(k)))

    whole, part = solve(ROWS), solve(k)
    assert bool(torch.isfinite(whole.cost).all())
    for field in ("cost", "cost_trace", "us", "xs"):
        assert torch.equal(getattr(part, field), getattr(whole, field)[:k]), field
