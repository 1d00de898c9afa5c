"""The port's graft_entry.entry against the root __graft_entry__.entry of
the JAX package on the CPU: the same example arguments, and the same
flagship solve (one iLQR MPC solve of JUMPING_IN_PLACE, H = 25, 5
iterations, 6 line-search candidates).

The solve is badly conditioned in float32 (tests/test_torch_ilqr_go1.py::
test_solve_batch_matches_jax: a 1e-5 relative change of A moves the first
accepted cost by 5e-4 relative, and later iterations may accept another
alpha), so the two packages' controls part after the first iterations and
their final costs are held to that test's 15%. What is exact is held
exactly: each package's cost is the cost of its controls under the other
package's model, to ROLLOUT_RTOL.
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


@pytest.fixture(scope="module")
def solves():
    jfn, jargs = jentry.entry()
    jus, jcost = jax.jit(jfn)(*jargs)
    fn, args = graft_entry.entry("cpu")
    us, cost = fn(*args)
    return {"jargs": [np.asarray(a) for a in jargs], "jus": np.asarray(jus),
            "jcost": float(jcost), "args": args, "us": us, "cost": float(cost)}


def test_entry_matches_jax(solves):
    for got, want in zip(solves["args"], solves["jargs"]):
        np.testing.assert_array_equal(got.numpy(), want)
    us, jus = solves["us"], solves["jus"]
    assert us.shape == jus.shape == (25, 6) and bool(torch.isfinite(us).all())
    assert float(us.abs().max()) <= 1.0
    np.testing.assert_allclose(solves["cost"], solves["jcost"], rtol=COST_RTOL)


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
