"""The port's utilities on the CPU: each case of tests/test_utils_aux.py
mirrored one for one (profiling timers, sanitizers, cameras, timer), then
the registry, the trace writer, the monitor (recording, KPIs, spring
energy, export, plots) and the renderer, against the JAX package where it
has a counterpart to compare with.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from quadruped_springs_tpu.env.env import EnvConfig as JEnvConfig
from quadruped_springs_tpu.env.env import QuadrupedEnv as JQuadrupedEnv
from quadruped_springs_tpu.models import dynamics as jdyn
from quadruped_springs_tpu.models import spatial as jsp
from quadruped_springs_tpu.models.go1_params import build_model as jbuild_model
from quadruped_springs_tpu.ops import actuation as jact
from quadruped_springs_tpu.runtime import trajstore as jtrajstore
from quadruped_springs_tpu.utils import camera as jcam
from quadruped_springs_tpu.utils import monitor as jmonitor
from quadruped_springs_tpu.utils import registry as jregistry
from quadruped_springs_tpu.utils import render as jrender
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.ops import actuation as act
from quadruped_springs_tpu_torch.runtime import trajstore
from quadruped_springs_tpu_torch.utils import monitor, profiling, registry, render, sanitize
from quadruped_springs_tpu_torch.utils import timer as tm
from quadruped_springs_tpu_torch.utils.camera import CAMERA_MODES, make_camera


# -- tests/test_utils_aux.py, one for one ---------------------------------------

def test_time_fn_and_throughput():
    f = lambda x: x * 2.0
    dt = profiling.time_fn(f, torch.ones(8))
    assert dt > 0
    out = profiling.solve_throughput(f, 8, torch.ones(8))
    assert out["solves_per_second"] > 0


def test_annotate_scope_runs():
    with profiling.annotate("phase"):
        torch.ones(4) + 1


def test_checked_flags_nan():
    def f(x):
        return torch.log(x)
    err, _ = sanitize.checked(f)(torch.tensor(-1.0))
    with pytest.raises(Exception):
        err.throw()
    err, _ = sanitize.checked(f)(torch.tensor(2.0))
    err.throw()  # no error on clean input


def test_finite_mask():
    tree = {"a": torch.tensor([[1.0, 2.0], [math.nan, 1.0], [3.0, 4.0]]),
            "b": torch.tensor([1.0, 2.0, math.inf])}
    mask = sanitize.finite_mask(tree)
    assert mask.tolist() == [True, False, False]


def test_assert_finite_raises():
    with pytest.raises(FloatingPointError):
        sanitize.assert_finite(torch.tensor([1.0, math.nan]))
    sanitize.assert_finite(torch.tensor([1.0, 2.0]))


def test_camera_modes_produce_tracks():
    t = np.linspace(0, 2, 40)
    base = np.stack([t, 0 * t, 0.3 + 0.2 * np.sin(t)], axis=-1)
    for mode in CAMERA_MODES:
        track = make_camera(mode, base)
        eye = track.eye()
        assert eye.shape == (40, 3)
        assert np.all(np.isfinite(eye))
        # the port's copy computes what the JAX package's does
        np.testing.assert_array_equal(eye, jcam.make_camera(mode, base).eye())
    with pytest.raises(KeyError):
        make_camera("BOGUS", base)


def test_timer_countdown():
    t = tm.timer_init(device="cpu")
    assert not bool(tm.time_up(t, 0.0))
    t = tm.start_timer(t, now=1.0, duration=0.5)
    assert not bool(tm.time_up(t, 1.4))
    assert bool(tm.time_up(t, 1.5))
    assert not bool(tm.time_up(tm.reset_timer(t), 99.0))


# -- beyond tests/test_utils_aux.py ----------------------------------------------

def test_timer_lanes_and_card_default():
    t = tm.start_timer(tm.timer_init(device="cpu"), torch.tensor([0.0, 1.0, 2.0]), 0.5)
    assert tm.time_up(t, 1.6).tolist() == [True, True, False]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tm.timer_init()


def test_checked_names_the_operation_and_sees_through_masks():
    """A NaN generated inside and masked out of the result is still found,
    as JAX's checkify finds it; NaN inputs are not blamed on the op."""
    err, out = sanitize.checked(lambda x: torch.where(x > 0, torch.sqrt(x), 0.0))(
        torch.tensor([-1.0, 4.0]))
    assert out.tolist() == [0.0, 2.0] and "sqrt" in err.get()
    err, _ = sanitize.checked(lambda x: x + 1)(torch.tensor([math.nan]))
    assert err.get() is None


def test_debug_nans_raises_in_backward():
    x = torch.tensor([-1.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with sanitize.debug_nans():
            torch.sqrt(x).sum().backward()


def test_trace_writes_a_profile(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.annotate("matmul"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    files = os.listdir(tmp_path)
    assert files and os.path.getsize(tmp_path / files[0]) > 100
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            with profiling.trace(str(tmp_path)):
                pass


def test_registry_matches_jax():
    assert registry.REGISTRIES == jregistry.REGISTRIES
    assert registry.validate("task_env", "BACKFLIP") == "BACKFLIP"
    with pytest.raises(KeyError, match="options"):
        registry.validate("task_env", "BOGUS")
    with pytest.raises(KeyError, match="axes"):
        registry.validate("bogus_axis", "X")


def test_spring_energy_matches_jax():
    rng = np.random.default_rng(0)
    q = (np.array([0.0, np.pi / 4, -np.pi / 2] * 4)
         + 0.4 * rng.standard_normal((5, 12))).astype(np.float32)
    k, rest = np.array([20.0, 20.0, 30.0], np.float32), np.array(
        [0.0, np.pi / 4, -np.pi / 2 + 0.3], np.float32)
    got = act.spring_energy(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(rest),
                            torch.tensor(act.SPRING_ENGAGE_SIGN, dtype=torch.float32))
    want = jact.spring_energy(jnp.asarray(q), jnp.asarray(k), jnp.asarray(rest))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert (got > 0).any() and (got == 0).any()


def test_skeleton_and_projection_match_jax():
    rng = np.random.default_rng(1)
    T = 4
    q = (np.array([0.0, 0.8, -1.5] * 4) + 0.3 * rng.standard_normal((T, 12))).astype(np.float32)
    pos = (np.array([0.0, 0.0, 0.3]) + 0.1 * rng.standard_normal((T, 3))).astype(np.float32)
    rpy = (0.3 * rng.standard_normal((T, 3))).astype(np.float32)
    legs, trunk = render.skeleton_points(*(torch.from_numpy(a) for a in (q, pos, rpy)))
    jlegs, jtrunk = jrender.skeleton_points(q, pos, rpy)
    assert legs.shape == (T, 4, 4, 3) and trunk.shape == (T, 5, 3)
    np.testing.assert_allclose(legs.numpy(), jlegs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(trunk.numpy(), jtrunk, rtol=0, atol=1e-6)
    eye, target = np.array([1.0, -1.0, 0.8]), np.array([0.0, 0.0, 0.3])
    got = render._project(legs.double(), torch.tensor(eye), torch.tensor(target))
    want = jrender._project(np.asarray(jlegs, np.float64), eye, target)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the foot of the chain is the dynamics' foot position
    model = jbuild_model()
    R = jsp.quat_to_mat(jsp.rpy_to_quat(jnp.asarray(rpy[0])))
    foot = pos[0] + np.asarray(jdyn.leg_fk_base(model, jnp.asarray(q[0]))["foot"]) @ np.asarray(R).T
    np.testing.assert_allclose(legs[0, :, 3].numpy(), foot, atol=1e-6)


def test_monitor_records_and_exports(tmp_path):
    """tests/test_pipeline.py::test_monitor_records_and_exports on the port,
    on two environments (T, N, ...)."""
    env = QuadrupedEnv(EnvConfig(enable_springs=True, task_env="JUMPING_IN_PLACE",
                                 observation_space_mode="ARS_BASIC",
                                 action_space_mode="SYMMETRIC", obs_noise=False,
                                 settling_steps=100, max_ep_len=0.5), device="cpu")
    policy = lambda obs: env.get_init_action()
    recs = monitor.record_rollout(env, policy, torch.Generator("cpu").manual_seed(0), 30, n=2)
    assert recs["base_pos"].shape == (30, 2, 3)
    k = monitor.kpis(recs)
    assert k["steps"] > 0 and np.isfinite(k["return"])
    u = monitor.spring_energy_trace(env, recs)
    assert u.shape == (30, 2) and bool((u >= 0).all())
    path = str(tmp_path / "traj.qsts")
    monitor.export_trajectory(path, recs, lane=1)
    assert trajstore.read(path).shape == (monitor.kpis(recs, lane=1)["steps"], 1 + 3 * 3 + 12 * 4 + 4)
    plots = monitor.plot_rollout(recs, str(tmp_path / "plot"), env=env)
    assert len(plots) == 10
    names = {os.path.basename(p) for p in plots}
    for fam in ("height", "angles", "motor_torque", "motor_true_velocity",
                "feet_normal_forces", "elastic_potential_energy",
                "forward_jumping", "pitch", "pitch_rate", "actions"):
        assert f"plot_{fam}.png" in names, fam
    for p in plots:
        assert os.path.getsize(p) > 1000
    vid = render.render_rollout(recs, str(tmp_path / "vid.gif"), camera_mode="CLASSIC",
                                stride=5)
    assert os.path.exists(vid) and os.path.getsize(vid) > 1000


# the monitor against the JAX package's: the init action held for MONITOR_T
# control steps after a 100-substep settle, one environment. Per-step bounds
# of tests/test_torch_verification.py (TOL_STEP), widened linearly with the
# step count; measured over 20 steps: q 8.3e-7, qd 4.5e-4, base_pos 2.2e-7,
# base_rpy 2.8e-7, base_vel 3.3e-6, tau_motor 5.4e-4, tau_spring 1.6e-4,
# feet_forces 1.9e-2 N (of 145 N)
MONITOR_KW = dict(enable_springs=True, task_env="JUMPING_IN_PLACE",
                  observation_space_mode="ARS_BASIC", action_space_mode="SYMMETRIC",
                  obs_noise=False, settling_steps=100, max_ep_len=0.5,
                  env_randomizer_mode="NONE")
MONITOR_T = 20
MONITOR_TOL = {"time": 0.0, "base_pos": 5e-6, "base_rpy": 5e-6, "base_vel": 2e-3, "q": 5e-6,
               "qd": 2e-3, "tau_motor": 0.05, "tau_spring": 0.05, "feet_forces": 0.05,
               "feet_contact": 0.0, "reward": 1e-6, "action": 0.0, "valid": 0.0}
EXPORT_COLS = (("time", 1), ("base_pos", 3), ("base_rpy", 3), ("base_vel", 3), ("q", 12),
               ("qd", 12), ("tau_motor", 12), ("tau_spring", 12), ("feet_forces", 4))


@pytest.fixture(scope="module")
def monitor_recs():
    jenv = JQuadrupedEnv(JEnvConfig(**MONITOR_KW))
    init = jenv.get_init_action()
    jrecs = jmonitor.record_rollout(jenv, lambda obs: init, jax.random.PRNGKey(0), MONITOR_T)
    env = QuadrupedEnv(EnvConfig(**MONITOR_KW), device="cpu")
    recs = monitor.record_rollout(env, lambda obs: env.get_init_action(),
                                  torch.Generator("cpu").manual_seed(0), MONITOR_T)
    return jenv, {k: np.asarray(v) for k, v in jrecs.items()}, env, recs


def test_monitor_recording_and_kpis_match_jax(monitor_recs):
    jenv, jrecs, env, recs = monitor_recs
    steps = np.arange(1, MONITOR_T + 1)
    assert recs.keys() == jrecs.keys()
    for k, tol in MONITOR_TOL.items():
        got, want = recs[k][:, 0].numpy(), jrecs[k]
        assert got.shape == want.shape, k
        err = np.abs(got.astype(np.float64) - want).reshape(MONITOR_T, -1).max(-1)
        assert (err <= tol * steps).all(), (k, err.max())
    got, want = monitor.kpis(recs), jmonitor.kpis(jrecs)
    assert got.keys() == want.keys()
    assert got["steps"] == want["steps"] == MONITOR_T
    assert got["flight_fraction"] == want["flight_fraction"]
    T = MONITOR_T
    for k, tol in (("return", 1e-6 * T), ("max_height", 5e-6 * T), ("max_fwd", 5e-6 * T),
                   ("peak_feet_force", 0.05 * T)):
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    np.testing.assert_allclose(monitor.spring_energy_trace(env, recs)[:, 0].numpy(),
                               np.asarray(jmonitor.spring_energy_trace(jenv, jrecs)),
                               rtol=1e-4)


def test_export_trajectory_matches_jax(monitor_recs, tmp_path):
    """Both packages' exports, each read back through its own trajstore:
    the same columns, within the recording's bounds over MONITOR_T steps."""
    _, jrecs, _, recs = monitor_recs
    path, jpath = str(tmp_path / "port.qsts"), str(tmp_path / "jax.qsts")
    monitor.export_trajectory(path, recs)
    jmonitor.export_trajectory(jpath, jrecs)
    got, want = trajstore.read(path), jtrajstore.read(jpath)
    assert got.shape == want.shape == (MONITOR_T, sum(w for _, w in EXPORT_COLS))
    tol = np.concatenate([np.full(w, MONITOR_TOL[k] * MONITOR_T) for k, w in EXPORT_COLS])
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max(0)
