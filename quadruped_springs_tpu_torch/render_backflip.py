"""The learned closed-loop backflip, recorded, and rendered where matplotlib is.

Port of ``examples/render_backflip.py``: one BACKFLIP environment (no
observation noise, 4 s timeout) from the seed's reset; the committed launch
policy ``examples/policies/backflip_ars.npz`` acts until the task switches
the controller, then the LandingWrapperBackflip rule at control-step
granularity: the fixed take-off action until the unwrapped pitch reaches
5π/8, then the landing action; at most 220 control steps, stopping at
``done``.

    python -m quadruped_springs_tpu_torch.render_backflip [--seed 0] [--out FILE.npz]
    python -m quadruped_springs_tpu_torch.render_backflip --trace FILE.npz --gif OUT.gif

Record mode writes the trace (``q``, ``base_pos``, ``base_rpy`` of every
step, ``valid``, ``switch_step``: the steps the policy acted before the
switch) to ``--out`` (default ``runs/render_backflip/backflip.npz`` of the
checkout, never under ``examples/``), prints the steps recorded and the
maximum unwrapped pitch, and never imports matplotlib. ``--trace`` renders
such a file with ``utils/render.render_rollout`` (the BACKFLIP camera,
every second step, 25 frames a second), which needs matplotlib. Record mode
runs on the card unless ``--device cpu`` is given; a CUDA device that is
not available is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np
import torch

from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.env.wrappers import LandingWrapperBackflip
from quadruped_springs_tpu_torch.env_bench import resolve_device
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.train import normalize as vnorm
from quadruped_springs_tpu_torch.train.networks import linear_policy_apply
from quadruped_springs_tpu_torch.train_two_stage import out_dir

POLICY = Path(__file__).resolve().parents[1] / "examples" / "policies" / "backflip_ars.npz"
MAX_STEPS = 220
CAMERA, STRIDE, FPS = "BACKFLIP", 2, 25
TRACE_FIELDS = ("q", "base_pos", "base_rpy")


def env_config() -> EnvConfig:
    """The script's environment (its settle, EnvConfig's default)."""
    return EnvConfig(enable_springs=True, task_env="BACKFLIP",
                     observation_space_mode="ARS_BACKFLIP", action_space_mode="SYMMETRIC",
                     obs_noise=False, max_ep_len=4.0)


@torch.no_grad()
def record(device="cuda", seed: int = 0, start=None, max_steps: int = MAX_STEPS):
    """One episode of the script's loop; `start` (state, obs) of one
    environment replaces the seed's reset (a test gives JAX's). Returns
    (trace: numpy arrays of the recorded steps and `switch_step`, final
    state)."""
    device = resolve_device(device)
    env = QuadrupedEnv(env_config(), device=device)
    W, on = convert.load_linear_policy(POLICY, device)
    state, obs = (env.reset(torch.Generator(device).manual_seed(seed), 1) if start is None
                  else start)
    take_off = torch.tensor(LandingWrapperBackflip.TAKE_OFF_ACTION, device=device)[None]
    landing = env.get_landing_action()[None]
    trace = {k: [] for k in TRACE_FIELDS}
    policy_steps = 0
    for _ in range(max_steps):
        switched = state.task.switched_controller
        if not bool(switched[0]):
            a = linear_policy_apply(W, vnorm.normalize(on, obs))
            policy_steps += 1
        else:
            pitch = float(sp.pitch_unwrapped_yxz(state.robot.quat, switched)[0])
            a = take_off if pitch < LandingWrapperBackflip.PITCH_THRESHOLD else landing
        state, obs, _, done, _ = env.step(state, a)
        trace["q"].append(state.robot.q[0])
        trace["base_pos"].append(state.robot.pos[0])
        trace["base_rpy"].append(sp.quat_to_rpy(state.robot.quat)[0])
        if bool(done[0]):
            break
    out = {k: torch.stack(v).cpu().numpy() for k, v in trace.items()}
    out["valid"] = np.ones(len(trace["q"]), bool)
    out["switch_step"] = np.asarray(policy_steps if policy_steps < len(trace["q"]) else -1)
    return out, state


def render(trace_path, gif_path) -> str:
    """Render a recorded trace (one environment) through render_rollout;
    returns the file written."""
    from quadruped_springs_tpu_torch.utils import render as rnd

    with np.load(trace_path) as d:
        recs = {k: torch.as_tensor(d[k])[:, None] for k in (*TRACE_FIELDS, "valid")}
    Path(gif_path).parent.mkdir(parents=True, exist_ok=True)
    return rnd.render_rollout(recs, str(gif_path), camera_mode=CAMERA, stride=STRIDE, fps=FPS)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="the trace's .npz (record mode)")
    ap.add_argument("--trace", default=None, help="render this trace instead of recording")
    ap.add_argument("--gif", default=None, help="the rendered file (--trace)")
    a = ap.parse_args(argv)
    if a.trace is not None:
        path = render(a.trace, a.gif or str(Path(a.trace).with_suffix(".gif")))
        print(f"wrote {path} ({Path(path).stat().st_size} bytes)")
        return path
    out = (out_dir(Path(a.out).parent, "render_backflip") / Path(a.out).name if a.out
           else out_dir(None, "render_backflip") / "backflip.npz")
    trace, state = record(a.device, a.seed)
    np.savez(out, **trace)
    print(f"steps recorded: {len(trace['q'])}")
    print(f"switch step: {int(trace['switch_step'])}")
    print(f"max unwrapped pitch: {math.degrees(float(state.task.max_pitch_bf[0])):.0f} deg")
    print(f"wrote {out}")
    return trace


if __name__ == "__main__":
    main()
