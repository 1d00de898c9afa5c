"""Every task cost of the port (quadruped_springs_tpu_torch.tasks.costs)
against the JAX package on the CPU: value, gradient and Hessian of the stage
and the terminal cost on seeded random states, including cost_overrides.

f32 with transcendental functions (atan2, asin) from two libraries: values,
gradients and Hessians agree to 1e-5·(1 + |ref|) but for RECOVERY, whose
2000-weighted bumper penalty squares site heights computed through the leg
kinematics: its derivatives reach 1e3-1e4 and are held to 1e-4·(1 + |ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.models.go1_params import go1_config as jax_go1_config
from quadruped_springs_tpu.tasks import costs as jcosts
from quadruped_springs_tpu_torch.models.go1_params import go1_config
from quadruped_springs_tpu_torch.solver.ilqr import _basis_jvp
from quadruped_springs_tpu_torch.tasks import costs as tcosts

H, M, N = 50, 6, 12
TASKS = {
    "JUMPING_IN_PLACE": ("JUMPING_IN_PLACE", None),
    "JUMPING_FORWARD": ("JUMPING_FORWARD", None),
    "JF_PPO": ("JF_PPO", None),
    "CONTINUOUS_JUMPING_FORWARD_PPO": ("CONTINUOUS_JUMPING_FORWARD_PPO", None),
    "CONTINUOUS_overrides": ("CONTINUOUS_JUMPING_FORWARD",
                             {"z_ref": 0.4, "v_ref": 1.8, "w_v": 9.0, "w_h": 25.0}),
    "BACKFLIP": ("BACKFLIP", None),
    "RECOVERY": ("RECOVERY", None),
    "NO_TASK": ("NO_TASK", None),
}


def _states(seed):
    """Random planner states: heights 0.15-0.6 m (the crouch floor and the
    bumper band on either side), velocities of either sign, tilted unit
    quaternions, joints around the init pose."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, 37))
    x[:, 2] = rng.uniform(0.15, 0.6, N)
    quat = rng.standard_normal((N, 4)) + 3.0 * np.array([0, 0, 0, 1.0])
    x[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    x[:, 13:25] = (np.asarray(jax_go1_config(True).init_joint_angles)
                   + 0.3 * rng.standard_normal((N, 12)))
    u = rng.uniform(-1, 1, (N, M))
    return x.astype(np.float32), u.astype(np.float32)


def _assert_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    excess = np.abs(got - want) - rel * (1.0 + np.abs(want))
    assert np.all(excess <= 0), f"max excess over the bound: {excess.max()}"


@pytest.mark.parametrize("which", ["stage", "terminal"])
@pytest.mark.parametrize("name", list(TASKS))
def test_cost_value_gradient_hessian_match_jax(name, which):
    task, overrides = TASKS[name]
    rel = 1e-4 if task == "RECOVERY" else 1e-5
    x, u = _states(sorted(TASKS).index(name))
    j_stage, j_term = jcosts.make_cost(task, jax_go1_config(True), M, H, overrides)
    t_stage, t_term = tcosts.make_cost(task, go1_config(True, "cpu"), M, H, overrides)
    if which == "stage":
        z = np.concatenate([x, u], axis=-1)
        jf = lambda z: j_stage(z[:37], z[37:], 3)
        tf = lambda z: t_stage(z[..., :37], z[..., 37:], torch.full(z.shape[:-1], 3))
    else:
        z = x
        jf, tf = j_term, t_term
    want = jax.jit(jax.vmap(lambda z: (jf(z), jax.grad(jf)(z), jax.hessian(jf)(z))))(
        jnp.asarray(z))
    zt = torch.from_numpy(z)
    value = tf(zt)
    grad, cols = _basis_jvp(torch.func.grad(lambda z: tf(z).sum()), zt)
    assert value.shape == (N,)
    _assert_close(value, want[0], rel)
    _assert_close(grad, want[1], rel)
    _assert_close(cols.permute(1, 2, 0), want[2], rel)
    assert np.abs(np.asarray(want[2])).max() > 0
