"""The bfloat16 linearization (MPCConfig.lin_dtype = "bf16") against the JAX
package's dynamics(..., dtype=jnp.bfloat16) knot on the CPU: the knot's
37x43 Jacobians, a small bf16-linearized solve_batch, the bf16 knot through
the kernels' autograd Functions, and the configuration.

JAX's bf16 knot runs its scalarized ("soa") dynamics, whose bf16 graph takes
XLA's CPU compiler many minutes under jacfwd; here it runs op by op under
jax.disable_jit() (about a minute), each op's result rounded to bf16 as the
code is written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vmap

from quadruped_springs_tpu.solver import mpc as jmpc
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.models import dynamics as tdyn
from quadruped_springs_tpu_torch.ops import actuation as tact
from quadruped_springs_tpu_torch.solver import ilqr as tilqr
from quadruped_springs_tpu_torch.solver import mpc as tmpc

from test_torch_ilqr_go1 import REGIMES, _scenarios, _states


def test_bf16_knot_jacobian_matches_jax():
    """The Jacobians of the relaxed planner knot at the stance, push-off and
    flight states of test_torch_ilqr_go1.py (4 randomized scenarios each),
    elementwise relative to each lane's max |J|. The bf16 knot rounds every
    intermediate, and the two packages round at other places (the port's
    kernels compute in f32 between a bf16 load and store; JAX's scalarized
    path rounds op by op), so the tolerance is JAX's own bf16-against-f32
    spread at these states, measured here: each package's bf16 Jacobian sits
    about that far from the f32 one, so the two may part by up to twice it.
    A knot linearized in f32 would pass that too (it sits one spread from
    JAX's bf16 Jacobian), so the port's bf16 Jacobian must also sit at least
    half the spread from the f32 one: measured 0.87-0.99 of it per regime,
    where an f32 Jacobian sits 1e-7-2e-6 away."""
    jprob, tprob = jmpc.MPCProblem(jmpc.MPCConfig()), tmpc.MPCProblem(tmpc.MPCConfig(), "cpu")
    scen = jax.tree.map(lambda a: jnp.concatenate([a] * len(REGIMES)),
                        _scenarios(jprob.cfg, 4))
    z = np.concatenate([_states(i, *REGIMES[r], np.asarray(jprob.default_x0()))
                        for i, r in enumerate(REGIMES)])
    jac = lambda dt: jax.vmap(jax.jacfwd(
        lambda z, s: jprob.dynamics(z[:37], z[37:], s, dtype=dt)))
    want32 = np.asarray(jax.jit(jac(None))(jnp.asarray(z), scen))
    with jax.disable_jit():
        want16 = np.asarray(jac(jnp.bfloat16)(jnp.asarray(z), scen))
    lanes = tprob.lane_params(convert.scenario_params(scen), dtype=torch.bfloat16)
    _, cols = tilqr._basis_jvp(lambda z: tprob.dynamics(z[:, :37], z[:, 37:], lanes),
                               torch.from_numpy(z))
    got16 = cols.permute(1, 2, 0).numpy()
    assert cols.dtype == torch.float32 and np.isfinite(got16).all()
    scale = np.abs(want32).max(axis=(1, 2), keepdims=True)
    rel = lambda a, b: (np.abs(a - b) / scale).max(axis=(1, 2)).reshape(len(REGIMES), 4)
    jax_spread = rel(want16, want32).max(axis=1)          # per regime
    gap = rel(got16, want16).max(axis=1)
    from_f32 = rel(got16, want32).max(axis=1)
    assert (jax_spread > 0).all()
    assert (gap <= 2 * jax_spread).all(), (gap, jax_spread)
    assert (from_f32 >= 0.5 * jax_spread).all(), (from_f32, jax_spread)


def test_bf16_knot_through_the_kernel_functions(monkeypatch):
    """The bf16 knot through the autograd Functions that bind the kernels,
    driven on the CPU with the plain versions in place of the launchers (as
    test_torch_ilqr_go1.py's f32 plumbing test does): every launcher gets
    bfloat16 arrays, the tangent launchers all 43 directions in one call,
    and the Jacobian equals the one the CPU path differentiates directly.
    Both compute the same ops in the same order: held bitwise."""
    seen = []

    def record(name, fn):
        def wrapped(*args):
            tensors = [a for a in args if torch.is_tensor(a)]
            seen.append((name, {a.dtype for a in tensors}, tuple(tensors[-1].shape)))
            return fn(*args)
        return wrapped

    def act_jvp(*args):
        primals, consts, tangents = args[:3], args[3:10], args[10:]
        f = lambda a, b, c: tact.actuation_plain(a, b, c, *consts)[0]
        return vmap(lambda a, b, c: jvp(f, primals, (a, b, c))[1])(*tangents)

    def contact_jvp(phi, v_w, mu, dphi, dv, *consts):
        f = lambda p, v: tdyn.contact_forces_plain(p, v, mu, *consts)[0]
        return vmap(lambda a, b: jvp(f, (phi, v_w), (a, b))[1])(dphi, dv)

    def contact_through_function(model, params, p_w, v_w, radii, foot_anchor=None):
        mu = params.friction
        return (*tdyn._Contact.apply(radii - p_w[..., 2], v_w, mu, params.contact_stiffness,
                                     params.contact_damping, params.slip_vel_tol,
                                     params.clamp_damping), None)

    prob = tmpc.MPCProblem(tmpc.MPCConfig(), "cpu")
    lanes = prob.lane_params(repeats=4, dtype=torch.bfloat16)
    z = torch.from_numpy(_states(9, 0.30, 0.5, prob.default_x0().numpy()))
    f = lambda z: prob.dynamics(z[:, :37], z[:, 37:], lanes)
    want = tilqr._basis_jvp(f, z)[1]
    monkeypatch.setattr(tact, "_launch_actuation", record("act", tact.actuation_plain))
    monkeypatch.setattr(tact, "_launch_actuation_jvp", record("act_jvp", act_jvp))
    monkeypatch.setattr(tdyn, "_launch_contact", record(
        "contact", lambda *a: tdyn.contact_forces_plain(*a)))
    monkeypatch.setattr(tdyn, "_launch_contact_jvp", record("contact_jvp", contact_jvp))
    monkeypatch.setattr(tact, "actuation_torque", lambda *a: tact._Actuation.apply(*a))
    monkeypatch.setattr(tdyn, "contact_forces", contact_through_function)
    got = tilqr._basis_jvp(f, z)[1]
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert [s[0] for s in seen] == ["act", "act_jvp", "contact", "contact_jvp"] * 2
    assert all(s[1] == {torch.bfloat16} for s in seen), seen
    assert seen[1][2] == (43, 4, 12) and seen[3][2] == (43, 4, 12, 3)


def test_lin_dtype_config():
    """lin_dtype takes "f32" and "bf16" (the JAX package's values): a JAX
    MPCConfig with bf16 converts, and the bf16 problem builds its bf16
    lanes with the contact constants rounded to bf16; anything else raises."""
    jcfg = jmpc.MPCConfig.full_rate(lin_dtype="bf16", relin_every=3)
    cfg = convert.mpc_config(jcfg)
    assert (cfg.lin_dtype, cfg.relin_every) == ("bf16", 3)
    prob = tmpc.MPCProblem(cfg, "cpu")
    lanes = prob.lane_params(repeats=2, dtype=torch.bfloat16)
    assert lanes.spring_k.dtype == lanes.model.leg_inertias6.dtype == torch.bfloat16
    assert lanes.params.friction.dtype == torch.bfloat16
    assert lanes.params.contact_stiffness == 180224.0      # 180 kN/m in bf16
    assert lanes.params.contact_damping == 100.0
    with pytest.raises(ValueError, match="lin_dtype"):
        tmpc.MPCProblem(tmpc.MPCConfig(lin_dtype="fp8"), "cpu")
