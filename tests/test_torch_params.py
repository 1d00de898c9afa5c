"""Parity of the port's parameters with the JAX package on the CPU: the robot
config, build_model on JAX-sampled TEST_RANDOMIZER scenarios, the control
interfaces (all action modes, the BACKFLIP limit raise), the converters of
quadruped_springs_tpu_torch.convert, and the torch scenario sampler's ranges
and mass conservation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.control import interfaces as jci
from quadruped_springs_tpu.env import randomizers as jrnd
from quadruped_springs_tpu.models import dynamics as jdyn
from quadruped_springs_tpu.models import go1_params as jgp
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.control import interfaces as tci
from quadruped_springs_tpu_torch.env import randomizers as trnd
from quadruped_springs_tpu_torch.models import go1_params as tgp


def _fields_equal(port_obj, jax_obj, rtol=0.0, atol=0.0):
    for f in dataclasses.fields(port_obj):
        got, want = getattr(port_obj, f.name), getattr(jax_obj, f.name)
        if torch.is_tensor(got):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                       atol=atol, err_msg=f.name)
        else:
            assert got == want, f.name


@pytest.mark.parametrize("springs", [True, False])
def test_go1_config_equal(springs):
    _fields_equal(tgp.go1_config(springs, "cpu"), jgp.go1_config(springs))


def _jax_scenarios(n=16, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    cfg = jgp.go1_config(True)
    return jax.jit(jax.vmap(lambda k: jrnd.sample_scenario(cfg, "TEST_RANDOMIZER", k)))(keys)


def test_build_model_matches_jax_on_randomized_scenarios():
    """f32 sums of the same terms: agree to 1e-6 (the spatial inertias are
    O(1) and below)."""
    scen = _jax_scenarios()
    want = jax.jit(jax.vmap(jrnd.model_from_params))(scen)
    got = trnd.model_from_params(convert.scenario_params(scen))
    for f in tgp.SCENARIO_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    shared = jgp.build_model()
    for f in ("hip_origins", "thigh_origins", "calf_origin", "foot_origin",
              "joint_axes", "gravity"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(shared, f)))


def test_default_model_matches_jax():
    got, want = tgp.build_model(), jgp.build_model()
    for f in tgp.SCENARIO_FIELDS:
        np.testing.assert_allclose(getattr(got, f)[0].numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert got.foot_radius == want.foot_radius


IFACE_CASES = [("PD", "DEFAULT", "NO_TASK"), ("PD", "SYMMETRIC", "JUMPING_IN_PLACE"),
               ("PD", "SYMMETRIC_NO_HIP", "NO_TASK"), ("PD", "DEFAULT", "BACKFLIP"),
               ("PD", "SYMMETRIC", "BACKFLIP"), ("TORQUE", "SYMMETRIC", "NO_TASK"),
               ("CARTESIAN_PD", "SYMMETRIC", "NO_TASK")]


@pytest.mark.parametrize("motor,action,task", IFACE_CASES)
def test_interface_transforms_match_jax(motor, action, task):
    jcfg = jgp.go1_config(True)
    jif = jci.make_interface(jcfg, motor, action, task)
    tif = tci.make_interface(tgp.go1_config(True, "cpu"), motor, action, task)
    _fields_equal(tif, jif)
    rng = np.random.default_rng(1)
    a = rng.uniform(-1.2, 1.2, (8, tif.action_dim)).astype(np.float32)
    cmd = rng.uniform(-3, 3, (8, 12)).astype(np.float32)
    t = torch.from_numpy
    # CARTESIAN_PD's action_to_command goes through the analytic IK (atan2,
    # sqrt): a few ulp; the affine transforms hold to 1e-6 in every mode
    ik_tol = 1e-5 if motor == "CARTESIAN_PD" else 1e-6
    pairs = [
        (tci.expand_action(tif, t(a)), jax.vmap(lambda x: jci.expand_action(jif, x))(a),
         1e-6),
        (tci.contract_action(tif, t(cmd)),
         jax.vmap(lambda x: jci.contract_action(jif, x))(cmd), 1e-6),
        (tci.command_to_action(tif, t(cmd)),
         jax.vmap(lambda x: jci.command_to_action(jif, x))(cmd), 1e-6),
        (tci.action_to_command(tif, t(a)),
         jax.vmap(lambda x: jci.action_to_command(jif, x))(a), ik_tol),
    ]
    for got, want, tol in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    if task == "BACKFLIP":
        np.testing.assert_allclose(tif.upper_lim[[7, 10]].numpy(), np.pi / 2, rtol=1e-6)


def test_convert_round_trips():
    """JAX objects -> port dataclasses -> numpy give back the JAX values,
    with Python fields kept as Python values."""
    jcfg = jgp.go1_config(True)
    _fields_equal(convert.go1_config(jcfg), jcfg)
    jif = jci.make_interface(jcfg, "PD", "SYMMETRIC", "BACKFLIP")
    _fields_equal(convert.control_interface(jif), jif)

    single = jrnd.sample_scenario(jcfg, "TEST_RANDOMIZER", jax.random.PRNGKey(4))
    one = convert.scenario_params(single)
    assert one.base_mass.shape == (1,)
    _fields_equal(one, jax.tree.map(lambda x: x[None], single))
    batch = _jax_scenarios(4)
    _fields_equal(convert.scenario_params(batch), batch)

    jm = jgp.build_model()
    m1 = convert.go1_model(jm)
    assert m1.trunk_mass.shape == (1,) and m1.hip_origins.shape == (4, 3)
    _fields_equal(dataclasses.replace(m1, **{f: getattr(m1, f)[0]
                                             for f in tgp.SCENARIO_FIELDS}), jm)
    mb = convert.go1_model(jax.jit(jax.vmap(jrnd.model_from_params))(batch))
    assert mb.leg_inertias6.shape == (4, 4, 3, 6, 6) and mb.calf_origin.shape == (3,)

    jp = jdyn.default_sim_params(0.005).replace(
        contact_stiffness=jnp.asarray(4000.0), clamp_damping=False)
    p = convert.sim_params(jp)
    assert (p.dt, p.contact_stiffness, p.friction, p.clamp_damping) == (0.005, 4000.0,
                                                                        1.0, False)
    p_lane = convert.sim_params(jp.replace(friction=batch.friction))
    np.testing.assert_array_equal(p_lane.friction.numpy(), np.asarray(batch.friction))


def test_torch_sampler_ranges_and_mass_conservation():
    cfg = tgp.go1_config(True, "cpu")
    gen = torch.Generator().manual_seed(0)
    s = trnd.sample_scenario(cfg, "TEST_RANDOMIZER", gen, n=512)
    leg = torch.as_tensor(tgp.LEG_MASSES, dtype=torch.float32)
    assert torch.all((s.leg_masses >= 0.9 * leg - 1e-6) & (s.leg_masses <= 1.1 * leg + 1e-6))
    assert torch.all((s.offset_mass >= 0) & (s.offset_mass <= trnd.MAX_MASS_OFFSET))
    assert torch.all(s.offset_pos.abs() <= torch.tensor(trnd.MAX_POS_MASS_OFFSET) + 1e-7)
    assert torch.all((s.friction >= 0.5) & (s.friction <= 1.0))
    for got, nominal in ((s.spring_stiffness, cfg.spring_stiffness),
                         (s.spring_damping, cfg.spring_damping)):
        assert torch.all((got >= 0.9 * nominal - 1e-6) & (got <= 1.1 * nominal + 1e-6))
    total = (s.base_mass + s.offset_mass + 4 * s.leg_masses.sum(-1)
             + s.foot_masses.sum(-1))
    nominal_total = tgp.TRUNK_MASS + 4 * (tgp.LEG_MASSES.sum() + tgp.FOOT_MASS)
    np.testing.assert_allclose(total.numpy(), nominal_total, rtol=1e-6)
    # the model keeps the total: trunk + legs (feet merged into the calves)
    model = trnd.model_from_params(s)
    model_total = model.trunk_mass + model.leg_masses.sum((-1, -2))
    np.testing.assert_allclose(model_total.numpy(), nominal_total + tgp.BASE_MASS
                               + tgp.IMU_MASS, rtol=1e-6)
    # no-spring robots keep zero springs; GROUND_RANDOMIZER touches friction only
    s0 = trnd.sample_scenario(tgp.go1_config(False, "cpu"), "TEST_RANDOMIZER", gen, n=8)
    assert torch.all(s0.spring_stiffness == 0)
    g = trnd.sample_scenario(cfg, "GROUND_RANDOMIZER", gen, n=8)
    assert torch.all(g.base_mass == tgp.TRUNK_MASS) and not torch.all(g.friction == 1.0)
    # the curriculum widens the ranges: offset mass up to 4 kg, springs ±30%
    c = trnd.sample_scenario(cfg, "TEST_RANDOMIZER_CURRICULUM", gen, n=512,
                             curriculum_level=1.0)
    assert c.offset_mass.max() > trnd.MAX_MASS_OFFSET
    assert c.offset_mass.max() <= trnd.CURRICULUM_MAX_MASS_OFFSET
    ratio = c.spring_stiffness / cfg.spring_stiffness
    assert ratio.min() < 0.85 and ratio.max() > 1.15
    assert ratio.min() >= 0.7 - 1e-6 and ratio.max() <= 1.3 + 1e-6
