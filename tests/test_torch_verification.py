"""The port's golden-trace verification (utils/verification.py) against the
JAX package's on the CPU: trace splitting and phase labels on all six
committed oracle traces, the scripted action sequences of the four jump
tasks, record_golden_trace over a shortened settle and a 20-step prefix of
the JUMPING_IN_PLACE script (batched over two sequences), the gate's report
on that trace against JAX's, and the full gate on one committed oracle
trace through the port at full length.
"""

import os

import jax
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env.env import EnvConfig as JEnvConfig
from quadruped_springs_tpu.env.env import QuadrupedEnv as JQuadrupedEnv
from quadruped_springs_tpu.runtime import trajstore as jtrajstore
from quadruped_springs_tpu.utils import verification as JV
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.runtime import trajstore
from quadruped_springs_tpu_torch.utils import verification as V

DATA = os.path.join(os.path.dirname(__file__), "data")
TRACES = [("JUMPING_IN_PLACE", True), ("JUMPING_FORWARD", True), ("BACKFLIP", True),
          ("CONTINUOUS_JUMPING_FORWARD", True), ("JUMPING_IN_PLACE", False),
          ("JUMPING_FORWARD", False)]
TASKS = ("JUMPING_IN_PLACE", "JUMPING_FORWARD", "BACKFLIP", "CONTINUOUS_JUMPING_FORWARD")
SHORT = dict(enable_springs=True, task_env="JUMPING_IN_PLACE",
             observation_space_mode="ARS_BASIC", action_space_mode="SYMMETRIC",
             obs_noise=False, settling_steps=200, env_randomizer_mode="NONE")
PREFIX = 20


def _path(task, springs):
    return os.path.join(DATA, f"oracle_{task.lower()}{'' if springs else '_nospring'}.qsts")


@pytest.mark.parametrize("task,springs", TRACES,
                         ids=[f"{t.lower()}{'' if s else '_nospring'}" for t, s in TRACES])
def test_split_and_classify_match_jax_on_the_committed_traces(task, springs):
    """Both read the file through their own trajstore binding; the split and
    the phase labels, flights and events are equal exactly."""
    trace = trajstore.read(_path(task, springs))
    np.testing.assert_array_equal(trace, jtrajstore.read(_path(task, springs)))
    got, want = V.split_trace(trace, 6), JV.split_trace(trace, 6)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for window in (0, 3):
        out = V.classify_phases(got, 6, event_window=window)
        ref = JV.classify_phases(want, 6, event_window=window)
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])
        assert out[2:] == ref[2:]
    assert len(ref[2]) >= 1      # every trace holds a real flight


@pytest.mark.parametrize("task", TASKS)
def test_task_action_script_matches_jax(task):
    got = V.task_action_script(task, device="cpu").numpy()
    want = np.asarray(JV.task_action_script(task))
    assert got.shape == want.shape == (170, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    with pytest.raises(KeyError):
        V.task_action_script("BOGUS", device="cpu")


@pytest.fixture(scope="module")
def short_traces(tmp_path_factory):
    """JAX's record_golden_trace of the JUMPING_IN_PLACE script's first
    PREFIX steps after a 200-substep settle, written as a trace, and the
    port's rows of the same script and of a second, perturbed one, batched."""
    jenv = JQuadrupedEnv(JEnvConfig(**SHORT))
    actions = JV.task_action_script("JUMPING_IN_PLACE")[:PREFIX]
    jrows = np.asarray(JV.record_golden_trace(jenv, actions, jax.random.PRNGKey(0)))
    path = str(tmp_path_factory.mktemp("golden") / "golden.qsts")
    jtrajstore.write(path, jrows)
    env = QuadrupedEnv(EnvConfig(**SHORT), device="cpu")
    a = torch.tensor(np.asarray(actions))
    batch = torch.stack([a, torch.clamp(a + 0.1, -1.0, 1.0)])
    rows = V.record_golden_trace(env, batch, torch.Generator("cpu").manual_seed(0))
    return {"jenv": jenv, "env": env, "path": path, "jrows": jrows, "rows": rows}


# per column group: tests/test_torch_env.py's per-step tolerances, widened
# linearly with the step count (stiff contact carries each step's rounding
# into the next), over PREFIX steps
TOL_STEP = {"q": 5e-6, "qd": 2e-3, "tau": 0.05, "tau_mean": 0.05, "pos": 5e-6,
            "quat": 5e-6, "vel": 2e-3, "action": 0.0, "t": 0.0}


def test_record_golden_trace_matches_jax(short_traces):
    rows, jrows = short_traces["rows"], short_traces["jrows"]
    assert rows.shape == (2,) + jrows.shape and rows.device.type == "cpu"
    got = V.split_trace(rows[0].numpy(), 6)
    want = JV.split_trace(jrows, 6)
    steps = np.arange(1, PREFIX + 1)[:, None]
    got["vel"], want["vel"] = rows[0, :, -6:].numpy(), jrows[:, -6:]   # lin, ang
    for k, tol in TOL_STEP.items():
        err = np.abs(got[k] - want[k])
        assert (err <= tol * steps).all(), (k, err.max(), (err / (tol * steps)).max())
    # the second lane ran its own actions from the same settle
    assert not np.allclose(rows[1].numpy(), rows[0].numpy())
    np.testing.assert_array_equal(rows[1, :, 1:7].numpy(),
                                  np.clip(jrows[:, 1:7] + np.float32(0.1), -1, 1))


def test_verify_report_matches_jax_on_a_jax_trace(short_traces):
    """The port's replay of JAX's trace passes with the report keys of JAX's
    own replay; its deviations are the two simulators' (within the per-step
    bounds above), JAX's own are 0."""
    jreport = JV.verify_against_trace(short_traces["jenv"], short_traces["path"],
                                      jax.random.PRNGKey(0))
    report = V.verify_against_trace(short_traces["env"], short_traces["path"],
                                    torch.Generator("cpu").manual_seed(0))
    assert report.keys() == jreport.keys()
    assert report["pass"] and jreport["pass"]
    assert jreport["static_flight_max_dev_frac"] < 1e-5
    for k in ("steps", "gated_fraction_strict", "gated_fraction_dynamic",
              "gated_fraction_event_only", "ungated_fraction_post_touchdown",
              "event_timing_max_offset_knots", "n_flights", "ends_upright", "tolerances",
              "gate"):
        assert report[k] == jreport[k], k
    assert report["static_flight_max_dev_frac"] < 0.05 * PREFIX / 23.7
    assert report["max_height_dev_m_pre_touchdown"] < 5e-6 * PREFIX


def test_verify_against_committed_oracle_trace_full_length():
    """The BASELINE gate of tests/test_golden_trace.py through the port on
    the CPU: the fidelity env, the 2,500-substep settle and all 170 control
    steps of the JUMPING_IN_PLACE oracle trace."""
    env = V.fidelity_env("JUMPING_IN_PLACE", device="cpu")
    report = V.verify_against_trace(env, _path("JUMPING_IN_PLACE", True),
                                    torch.Generator("cpu").manual_seed(0))
    assert report["steps"] >= 170
    assert report["pass"], report
    assert report["static_flight_max_dev_frac"] < 0.02, report
    assert report["mean_torque_dev_frac_pre_touchdown"] < 0.02, report
    assert report["max_height_dev_m_pre_touchdown"] < 0.03, report
    assert report["gated_fraction_strict"] >= 0.15, report
    assert report["ungated_fraction_post_touchdown"] <= 0.55, report


def test_fidelity_env_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        V.fidelity_env("JUMPING_IN_PLACE")
    with pytest.raises((RuntimeError, AssertionError)):
        V.task_action_script("JUMPING_IN_PLACE")
