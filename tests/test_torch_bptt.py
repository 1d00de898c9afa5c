"""The landing trainer's --optimizer bptt held to the JAX script's.

The script runs code at import, so, as tests/test_torch_behaviour_scripts.py
does, its functions and its training loop are taken with ``ast`` and
``exec``'d with their globals supplied; no script is edited. Held here:

  * the loss and gradient: JAX's ``bptt_loss`` (``jax.value_and_grad`` of
    minus the mean ``stab_score`` over bank entries) at HORIZON 10 on five
    backflip states (two resets and three in the rotation and upright terms'
    sensitive range), with the committed lander's parameters, against the
    port's ``bptt_loss`` differentiated by autograd through every env.step
    (env_substeps_plain on the CPU): the loss within 2e-3 (the stab_score
    tolerance of tests/test_torch_behaviour_scripts.py), the gradient within
    1e-3 of its largest JAX magnitude, every entry finite, in
    ``ravel_pytree``'s order;
  * the update: ``torch.nn.utils.clip_grad_norm_(1.0)`` then
    ``torch.optim.Adam(lr, eps=1e-8)`` (BpttStep) against optax's
    ``chain(clip_by_global_norm(1.0), adam(lr))`` on the same gradients,
    after one and three steps, the clip active or not, within 1e-6;
  * the loop: the script's phase 2 with ``--optimizer bptt`` and a stub loss
    (the minibatch draws, the updates, the probe-selected best and its
    saves) against train_loop with BpttStep on the same stub.
"""

import os
import time
import types

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quadruped_springs_tpu.env.env import EnvConfig as JEnvConfig
from quadruped_springs_tpu.env.env import QuadrupedEnv as JQuadrupedEnv
from quadruped_springs_tpu.models import spatial as jsp
from quadruped_springs_tpu.train import normalize as jnorm
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch import train_backflip_landing_mlp as lm
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.train import behaviour as bh
from tests.test_torch_behaviour_scripts import (FLIP, LANDING, POLICIES, _exec, _flat_stubs,
                                                _function, _joint_params, _loop_block, _quiet,
                                                _record, _sensitive, _t)

HORIZON = 10
LOSS_TOL, GRAD_TOL, ADAM_TOL = 2e-3, 1e-3, 1e-6


@pytest.fixture(scope="module")
def bptt_case():
    """Five backflip states, the committed lander's parameters, and JAX's
    value_and_grad of the script's bptt_loss over bank entries IDX."""
    jenv = JQuadrupedEnv(JEnvConfig(**FLIP))
    js, jobs = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(4), 2))
    js, jobs = _sensitive(js), jobs[jnp.array([0, 1, 0, 1, 0])]
    d = np.load(os.path.join(POLICIES, "backflip_ars.npz"))
    jon = jnorm.RunningNorm(*(jnp.asarray(d[k]) for k in ("mean", "var", "count")))
    params = _joint_params()["mlp"]
    mlp_apply = _function(LANDING, "mlp_apply", jnp=jnp)
    stab = _function(LANDING, "stab_score", jax=jax, jnp=jnp, env=jenv, on=jon,
                     vnorm=jnorm, sp=jsp, mlp_apply=mlp_apply, Z_STAND=0.30,
                     args=types.SimpleNamespace(horizon=HORIZON))
    loss = _function(LANDING, "bptt_loss", jax=jax, jnp=jnp, bank=js, bank_obs=jobs,
                     stab_score=stab)
    idx = np.array([4, 0, 2, 3])
    jl, jg = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, params), jnp.asarray(idx))
    return js, jobs, params, idx, float(jl), np.asarray(jax.flatten_util.ravel_pytree(jg)[0])


def test_bptt_loss_and_gradient_match_the_script(bptt_case):
    """The port's loss and autograd gradient against jax.value_and_grad of
    the script's bptt_loss (module docstring's tolerances)."""
    js, jobs, params, idx, jl, jg = bptt_case
    env = QuadrupedEnv(EnvConfig(**FLIP), device="cpu")
    on = convert.load_linear_policy(os.path.join(POLICIES, "backflip_ars.npz"), "cpu")[1]
    layout = bh.FlatLayout(params)
    flat = torch.as_tensor(layout.ravel(params)).requires_grad_()
    loss = lm.bptt_loss(env, on, layout, convert.env_state(js), _t(jobs), None, HORIZON)(
        flat, idx)
    (grad,) = torch.autograd.grad(loss, flat)
    g = grad.numpy()
    assert np.isfinite(g).all() and np.isfinite(jg).all()
    assert abs(float(loss.detach()) - jl) <= LOSS_TOL
    np.testing.assert_allclose(g, jg, rtol=0, atol=GRAD_TOL * np.abs(jg).max())
    assert np.abs(jg).max() > 1e-3          # the states do give a gradient


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("scale", [0.01, 50.0])
def test_clipped_adam_matches_optax(steps, scale):
    """BpttStep's update (clip_grad_norm_ to 1, then Adam at lr, eps 1e-8) on
    given gradients against optax's chain(clip_by_global_norm(1.0),
    adam(lr)): the iterate after `steps` updates within ADAM_TOL, with the
    gradients' norm below the clip (scale 0.01) or far above it (50)."""
    rng = np.random.default_rng(3)
    flat0 = (0.1 * rng.standard_normal(40)).astype(np.float32)
    grads = [(scale * rng.standard_normal(40) / np.sqrt(40)).astype(np.float32)
             for _ in range(steps)]
    calls = iter(grads)
    step = lm.BpttStep(lambda p, idx: (p * torch.as_tensor(next(calls))).sum(), flat0, 3e-3,
                       "cpu")
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(3e-3))
    p, state = jnp.asarray(flat0), None
    state = opt.init(p)
    flat = flat0
    for g in grads:
        flat = step(flat, None, None)
        upd, state = opt.update(jnp.asarray(g), state)
        p = optax.apply_updates(p, upd)
    np.testing.assert_allclose(flat, np.asarray(p), rtol=0, atol=ADAM_TOL)
    assert step.grad_norms == pytest.approx([float(np.linalg.norm(g)) for g in grads],
                                            rel=1e-5)


def test_bptt_loop_draws_and_updates_as_the_script():
    """The script's phase 2 under --optimizer bptt with a stub loss (its
    jit(value_and_grad), optax's update, ravel_pytree's flat iterate)
    against train_loop with BpttStep on the same stub: the minibatches in
    the script's order, every iterate within ADAM_TOL, the same best and
    saves."""
    n_train = 9
    _, key, failures = _flat_stubs(n_train)
    K = np.random.default_rng(8).standard_normal(40).astype(np.float32)
    flat0 = (0.1 * np.random.default_rng(9).standard_normal(40)).astype(np.float32)
    args = types.SimpleNamespace(iters=12, probe_every=3, n_probe=2, hard_frac=0.0,
                                 optimizer="bptt", train_states=4, lr=3e-3, out="lander")
    saved, save = _record()

    def jloss(p, idx):
        return jnp.sum(jnp.tanh(p * K)) * (1.0 + 0.01 * jnp.sum(idx))

    # the block defines the script's own bptt_loss (over its bank); its
    # value_and_grad is taken of the stub instead
    jax_ns = types.SimpleNamespace(jit=jax.jit, flatten_util=jax.flatten_util,
                                   value_and_grad=lambda f: jax.value_and_grad(jloss))
    ns = dict(np=np, jnp=jnp, jax=jax_ns, args=args, time=time, print=_quiet, n_train=n_train,
              idx_train=np.arange(n_train), idx_val=np.arange(n_train, 12), params=flat0,
              flat0=flat0, unravel=lambda x: x,
              eval_params=lambda p, idx: (0.0, key(p)[2]), probe=lambda p: key(p)[:2],
              train_failures=failures, save_candidate=lambda p, path: save(p))
    ns["sample_minibatch"] = _function(LANDING, "sample_minibatch", **ns)
    _exec(LANDING, _loop_block(LANDING, "rng"), ns)
    got_seen, got_rec = _record()
    got_saved, got_save = _record()

    def loss(p, idx):
        got_rec(np.asarray(idx))
        return torch.sum(torch.tanh(p * torch.as_tensor(K))) * (1.0 + 0.01 * float(np.sum(idx)))

    step = lm.BpttStep(loss, flat0, args.lr, "cpu")
    best, iters = lm.train_loop(flat0, args, n_train, step, key, failures, got_save, _quiet,
                                "bptt")
    assert iters == ns["i"] + 1 == args.iters and len(got_seen) == args.iters
    # the key's validation term is tanh of the iterate's sum: within rounding
    assert best[0][:2] == ns["best"][0][:2] and len(got_saved) == len(saved) > 0
    assert best[0][2] == pytest.approx(ns["best"][0][2], abs=ADAM_TOL * 40)
    np.testing.assert_allclose(best[1], ns["best"][1], rtol=0, atol=ADAM_TOL)
    np.testing.assert_allclose(step.flat, np.asarray(ns["flat"]), rtol=0, atol=ADAM_TOL)
    for (g,), (w,) in zip(got_saved, saved):
        np.testing.assert_allclose(g, w, rtol=0, atol=ADAM_TOL)
    # the minibatches: the script's numpy draws in its order
    rng = np.random.default_rng(0)
    for (idx,) in got_seen:
        np.testing.assert_array_equal(idx, rng.choice(n_train, args.train_states,
                                                      replace=False))
