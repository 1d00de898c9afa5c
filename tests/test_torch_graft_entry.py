"""The port's graft_entry.entry against the root __graft_entry__.entry of
the JAX package on the CPU: the same example arguments, and the same
flagship solve (one iLQR MPC solve of JUMPING_IN_PLACE, H = 25, 5
iterations, 6 line-search candidates).

The solve is badly conditioned in float32 (tests/test_torch_ilqr_go1.py::
test_solve_batch_matches_jax: a 1e-5 relative change of A moves the first
accepted cost by 5e-4 relative, and later iterations may accept another
alpha), so the two packages' controls part after the first iteration, and
from then on a solve's final cost is chaotic in the last bits of its start.
Measured on the CPU, with the start moved by float32(1 + 1e-7 N(0,1)) per
seed (numpy, seeds 1-11): JAX's own final cost ranges over -24.13 to -34.45
(-24.67 from the entry's start; 6 of the 11 moved starts land more than 15%
from it), the port's over -24.12 to -35.50 (-29.26 from the entry's start).
One start's final costs are two draws from that spread, so they are held
over the entry's start and the 11 moved ones: the mean final costs to that
test's 15%, both ways (measured -27.66 against -28.45). The first
iteration, before the packages part, is held at the entry's start to that
test's 2e-3 relative (measured 8.9e-5), and both cost traces must not
increase. What is exact is held exactly: each package's cost is the cost of
its controls under the other package's model, to ROLLOUT_RTOL; and the
port's batched solve of all starts gives the entry's answer bitwise in its
first row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from quadruped_springs_tpu.solver import mpc as jmpc
from quadruped_springs_tpu_torch import graft_entry
from quadruped_springs_tpu_torch.solver import mpc as tmpc

COST_RTOL = 0.15        # tests/test_torch_ilqr_go1.py::test_solve_batch_matches_jax
FIRST_RTOL = 2e-3       # the same test's bound on the first iteration's cost
MOVED_STARTS = 11
# a 25-knot rollout of the same controls by both packages: 7.4e-5 and 5.5e-5
# measured, the stiff contact carrying each knot's rounding into the next
ROLLOUT_RTOL = 2e-4


def _jax_rollout_cost(jprob, x0, us):
    def knot(x, ut):
        u, t = ut
        return jprob.dynamics(x, u), jprob.stage_cost(x, u, t)

    H = us.shape[0]
    xH, stage = jax.lax.scan(knot, x0, (us, jnp.arange(H)))
    return stage.sum() + jprob.terminal_cost(xH)


def _torch_rollout_cost(tprob, x0, us):
    lanes = tprob.lane_params()
    x, total = x0[None], torch.zeros(1)
    for t in range(us.shape[0]):
        total = total + tprob.stage_cost(x, us[None, t], t)
        x = tprob.dynamics(x, us[None, t], lanes)
    return (total + tprob.terminal_cost(x))[0]


def _moved_starts(x0):
    """The entry's start, then MOVED_STARTS starts moved by float32(1 + 1e-7
    N(0,1)), one numpy seed each (1, 2, ...)."""
    return [x0] + [(x0 * (1 + 1e-7 * np.random.default_rng(seed).standard_normal(x0.shape))
                    ).astype(np.float32) for seed in range(1, MOVED_STARTS + 1)]


@pytest.fixture(scope="module")
def solves():
    jfn, jargs = jentry.entry()
    jsolve = jax.jit(jfn)
    jus, jcost = jsolve(*jargs)
    fn, args = graft_entry.entry("cpu")
    us, cost = fn(*args)
    # the cost traces of the same solves, through the entries' own problems
    jtrace = jax.jit(jentry._problem(horizon=25, iterations=5, n_alphas=6).solve)(
        *jargs).cost_trace
    tprob = graft_entry._problem(horizon=25, iterations=5, n_alphas=6, device="cpu")
    trace = tprob.solve(*args).cost_trace
    # the same solves from the moved starts: JAX's entry one start at a time,
    # the port's all starts as one batch
    starts = _moved_starts(np.asarray(jargs[0]))
    jcosts = [float(jsolve(jnp.asarray(x), jargs[1])[1]) for x in starts]
    batch = tprob.solve_batch(torch.from_numpy(np.stack(starts)),
                              args[1].expand(len(starts), -1, -1))
    return {"jargs": [np.asarray(a) for a in jargs], "jus": np.asarray(jus),
            "jcost": float(jcost), "args": args, "us": us, "cost": float(cost),
            "jtrace": np.asarray(jtrace), "trace": trace.numpy(),
            "jcosts": np.asarray(jcosts), "batch_us": batch.us,
            "costs": batch.cost.numpy()}


def test_entry_matches_jax(solves):
    for got, want in zip(solves["args"], solves["jargs"]):
        np.testing.assert_array_equal(got.numpy(), want)
    us, jus = solves["us"], solves["jus"]
    assert us.shape == jus.shape == (25, 6) and bool(torch.isfinite(us).all())
    assert float(us.abs().max()) <= 1.0
    trace, jtrace = solves["trace"], solves["jtrace"]
    assert trace[-1] == solves["cost"] and jtrace[-1] == np.float32(solves["jcost"])
    np.testing.assert_allclose(trace[0], jtrace[0], rtol=FIRST_RTOL)
    assert (np.diff(trace) <= 0).all() and (np.diff(jtrace) <= 0).all()
    costs, jcosts = solves["costs"], solves["jcosts"]
    assert costs[0] == solves["cost"] and torch.equal(solves["batch_us"][0], us)
    assert jcosts[0] == solves["jcost"] and np.isfinite(costs).all()
    np.testing.assert_allclose(costs.mean(), jcosts.mean(), rtol=COST_RTOL)


def test_entry_costs_are_those_of_its_controls_under_the_other_model(solves):
    cfg = dict(task="JUMPING_IN_PLACE", enable_springs=True, horizon=25, iterations=5,
               n_alphas=6)
    jprob = jmpc.MPCProblem(jmpc.MPCConfig(**cfg))
    tprob = tmpc.MPCProblem(tmpc.MPCConfig(**cfg), "cpu")
    x0 = solves["jargs"][0]
    port_under_jax = float(jax.jit(_jax_rollout_cost, static_argnums=0)(
        jprob, jnp.asarray(x0), jnp.asarray(solves["us"].numpy())))
    jax_under_port = float(_torch_rollout_cost(tprob, torch.from_numpy(x0),
                                               torch.from_numpy(solves["jus"].copy())))
    np.testing.assert_allclose(port_under_jax, solves["cost"], rtol=ROLLOUT_RTOL)
    np.testing.assert_allclose(jax_under_port, solves["jcost"], rtol=ROLLOUT_RTOL)
