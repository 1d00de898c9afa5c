"""Parity of the port's JUMPING_IN_PLACE costs (quadruped_springs_tpu_torch.
tasks.costs) with the JAX package on the CPU, batched over leading axes."""

import jax
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.models.go1_params import go1_config as jax_go1_config
from quadruped_springs_tpu.tasks import costs as jcosts
from quadruped_springs_tpu_torch.models.go1_params import go1_config
from quadruped_springs_tpu_torch.tasks import costs as tcosts

H, M = 50, 6


def _states(seed, shape=(4, 8)):
    """Random planner states: heights 0.2-0.8 m, velocities of either sign
    (the apex term clips vz at 0), tilted unit quaternions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (37,))
    x[..., 2] = rng.uniform(0.2, 0.8, shape)
    quat = rng.standard_normal(shape + (4,)) + 3.0 * np.array([0, 0, 0, 1.0])
    x[..., 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    u = rng.uniform(-1, 1, shape + (M,))
    return x.astype(np.float32), u.astype(np.float32)


@pytest.mark.parametrize("task", ["JUMPING_IN_PLACE", "JIP_PPO"])
def test_jumping_in_place_costs_match_jax(task):
    """f32 with transcendental functions (atan2, asin) from two libraries:
    agree to a few ulp of the cost scale (|cost| ~ 1-60)."""
    x, u = _states(0)
    j_stage, j_term = jcosts.make_cost(task, jax_go1_config(True), M, H)
    t_stage, t_term = tcosts.make_cost(task, go1_config(True, "cpu"), M, H)
    flat_x, flat_u = x.reshape(-1, 37), u.reshape(-1, M)
    want_stage = jax.vmap(lambda a, b: j_stage(a, b, 0))(flat_x, flat_u).reshape(x.shape[:-1])
    want_term = jax.vmap(j_term)(flat_x).reshape(x.shape[:-1])
    got_stage = t_stage(torch.from_numpy(x), torch.from_numpy(u), torch.zeros(x.shape[:-1]))
    got_term = t_term(torch.from_numpy(x))
    assert got_stage.shape == got_term.shape == x.shape[:-1]
    np.testing.assert_allclose(got_stage, want_stage, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_term, want_term, rtol=1e-5, atol=1e-5)


def test_other_tasks_are_not_ported_yet():
    """Named for the slice that had only JUMPING_IN_PLACE and raised KeyError
    for the rest: now every key of the JAX module returns a cost pair (held
    to JAX in test_torch_costs_all.py), and an unknown key falls back to the
    NO_TASK regulation cost, as in JAX."""
    x, u = (torch.from_numpy(a) for a in _states(1))
    cfg = go1_config(True, "cpu")
    t = torch.zeros(x.shape[:-1])
    fallback = tcosts.make_cost("NO_TASK", cfg, M, H)
    for task in ("BACKFLIP", "JUMPING_FORWARD", "CONTINUOUS_JUMPING_FORWARD_PPO",
                 "RECOVERY", "SOME_UNKNOWN_TASK"):
        stage, term = tcosts.make_cost(task, cfg, M, H)
        assert stage(x, u, t).shape == term(x).shape == x.shape[:-1]
        same = torch.equal(stage(x, u, t), fallback[0](x, u, t))
        assert same == (task == "SOME_UNKNOWN_TASK")
