"""A small bf16-linearized iLQR solve_batch (MPCConfig lin_dtype "bf16",
relinearized every 3rd iteration: the JAX bench's default iLQR row) against
the JAX package's, on the CPU.

JAX's bf16 knot runs its scalarized ("soa") dynamics, whose bf16 Jacobian
XLA's CPU compiler did not finish compiling in 15 minutes; the JAX solve
runs op by op under jax.disable_jit() instead (two to three minutes here for
2 problems, H = 2, 3 iterations), which rounds each op's result to bf16 as
the code is written. That is most of this file's time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from quadruped_springs_tpu.solver import mpc as jmpc
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.solver import mpc as tmpc

from test_torch_ilqr_go1 import _scenarios

B = 2


def test_bf16_linearized_solve_batch_matches_jax():
    """2 randomized scenarios from the task's warm start, H = 2, 3
    iterations, 2 alphas, relinearized every 3rd iteration (one bf16
    linearization, at the warm start's rollout). The two packages' bf16
    Jacobians part by up to the JAX bf16 knot's own distance from its f32
    Jacobian (test_torch_bf16_lin.py), which moves the accepted steps:
    measured, the final costs part by 9.6e-5 relative (the exact-f32 solves
    of a like problem, 3 scenarios and H = 4: 7e-8). Held to 2e-4 relative;
    the trace's shape, its monotonicity and finiteness are exact
    properties. At this size the Jacobians' precision barely moves the
    answer (JAX's own bf16- and f32-linearized solves part by 4.1e-5 and
    8.1e-5), so the bf16 numbers are held in test_torch_bf16_lin.py; here
    the solve must differ from the port's f32-linearized one, which shows it
    took its Jacobians from the bf16 knot."""
    kw = dict(task="JUMPING_IN_PLACE", horizon=2, n_alphas=2, iterations=3,
              relin_every=3, lin_dtype="bf16")
    jcfg = jmpc.MPCConfig(**kw)
    jprob, tprob = jmpc.MPCProblem(jcfg), tmpc.MPCProblem(convert.mpc_config(jcfg), "cpu")
    scen = _scenarios(jprob.cfg, B, seed=1)
    x0 = np.tile(np.asarray(jprob.default_x0()), (B, 1))
    u0 = np.tile(np.asarray(jprob.task_warm_start()), (B, 1, 1))
    with jax.disable_jit():
        want = jprob.solve_batch(jnp.asarray(x0), jnp.asarray(u0), scen)
    got = tprob.solve_batch(torch.from_numpy(x0), torch.from_numpy(u0),
                            convert.scenario_params(scen))
    f32 = tmpc.MPCProblem(convert.mpc_config(jmpc.MPCConfig(**{**kw, "lin_dtype": "f32"})),
                          "cpu").solve_batch(torch.from_numpy(x0), torch.from_numpy(u0),
                                             convert.scenario_params(scen))
    assert got.cost_trace.shape == (B, 3) and bool(torch.isfinite(got.cost).all())
    assert bool((got.cost_trace[:, 1:] <= got.cost_trace[:, :-1]).all())
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=2e-4)
    assert not torch.equal(got.us, f32.us)
    # the warm start itself was improved on, by both
    first = np.asarray(want.cost_trace)[:, 0]
    assert (np.asarray(want.cost) <= first).all() and (got.cost.numpy() < 0).all()
