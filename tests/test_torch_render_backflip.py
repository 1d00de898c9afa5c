"""render_backflip's record mode held to the JAX script examples/render_backflip.py.

The script's ``run(seed=0)`` runs as it is (taken with ``ast``, nothing of
the JAX package edited): the test replaces the JAX renderer with one that
keeps the recorded trace (``q``, ``base_pos``, ``base_rpy``) and writes
nothing but the script's directory under tmp_path, keeps the env's reset
state, and counts the launch policy's calls (the steps before the switch).
The port's record mode runs on the CPU from that reset state, converted.
Held: the steps recorded and the switch step equal; every recorded field
within 1e-5 up to the switch and within 1e-4 over the whole flip (measured:
6.9e-6 and 5.3e-5 in q, the largest; the flip is not chaotic at this
start); the maximum unwrapped pitch within 1e-5. Then ``--trace`` renders
the recorded trace's first steps to a non-empty gif under tmp_path, and
record mode refuses an ``--out`` under examples/.
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env.env import QuadrupedEnv as JQuadrupedEnv
from quadruped_springs_tpu.train import networks as jnets
from quadruped_springs_tpu.utils import render as jrender
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch import render_backflip as rb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "render_backflip.py")
TO_SWITCH, WHOLE = 1e-5, 1e-4
PITCH_TOL = 1e-5


@pytest.fixture(scope="module")
def flip(tmp_path_factory):
    """The script's run(seed=0) and the port's record() from its reset state."""
    with open(SCRIPT) as f:
        node = next(n for n in ast.parse(f.read()).body
                    if isinstance(n, ast.FunctionDef) and n.name == "run")
    ns = {"jax": jax, "os": os, "__file__": SCRIPT}
    exec(compile(ast.Module(body=[node], type_ignores=[]), SCRIPT, "exec"), ns)
    kept = {}
    mp = pytest.MonkeyPatch()
    reset, linear = JQuadrupedEnv.reset, jnets.linear_policy_apply

    def keep_reset(self, *a, **k):
        out = reset(self, *a, **k)
        kept.setdefault("reset", out)
        return out

    def count_policy(*a):
        kept["policy_calls"] = kept.get("policy_calls", 0) + 1
        return linear(*a)

    def keep_recs(recs, path, **kw):
        kept["recs"], kept["render_kw"] = recs, kw
        return path

    mp.setattr(JQuadrupedEnv, "reset", keep_reset)
    mp.setattr(jnets, "linear_policy_apply", count_policy)
    mp.setattr(jrender, "render_rollout", keep_recs)
    out = tmp_path_factory.mktemp("jax") / "backflip.gif"
    try:
        _, jstate = ns["run"](str(out), seed=0, verbose=False)
    finally:
        mp.undo()
    state, obs = kept["reset"]
    trace, tstate = rb.record("cpu", start=(convert.env_state(state),
                                            torch.tensor(np.asarray(obs))[None]))
    return dict(kept=kept, jstate=jstate, trace=trace, tstate=tstate)


def test_record_matches_the_script(flip):
    kept, trace = flip["kept"], flip["trace"]
    recs = kept["recs"]
    steps = len(recs["q"])
    assert len(trace["q"]) == steps and trace["valid"].all() and recs["valid"].all()
    switch = int(trace["switch_step"])
    assert switch == kept["policy_calls"] and 0 < switch < steps
    for k in rb.TRACE_FIELDS:
        err = np.abs(trace[k] - np.asarray(recs[k])).max(axis=1)
        assert err[:switch].max() <= TO_SWITCH, (k, float(err[:switch].max()))
        assert err.max() <= WHOLE, (k, float(err.max()), int(err.argmax()))
    assert abs(float(flip["tstate"].task.max_pitch_bf[0])
               - float(flip["jstate"].task.max_pitch_bf)) <= PITCH_TOL
    assert float(flip["tstate"].task.max_pitch_bf[0]) > 2 * np.pi - 0.1    # a full flip
    assert kept["render_kw"] == {"camera_mode": rb.CAMERA, "stride": rb.STRIDE,
                                 "fps": rb.FPS}


def test_trace_mode_writes_a_gif(flip, tmp_path, capsys):
    """The first 12 recorded steps rendered (6 frames at stride 2)."""
    path = tmp_path / "trace.npz"
    np.savez(path, **{k: v[:12] if k != "switch_step" else v
                      for k, v in flip["trace"].items()})
    gif = tmp_path / "gif" / "backflip.gif"
    written = rb.main(["--trace", str(path), "--gif", str(gif)])
    assert written == str(gif) and gif.stat().st_size > 0
    assert "wrote" in capsys.readouterr().out


def test_record_mode_refuses_examples_and_a_missing_card():
    with pytest.raises(SystemExit):
        rb.main(["--device", "cpu", "--out", os.path.join(ROOT, "examples", "out", "x.npz")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            rb.record()
