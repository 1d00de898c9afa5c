#!/usr/bin/env python3
"""The port's backflip replay at chosen frictions: the counterpart of
tests/jax_backflip_friction_probe.py, which runs the JAX package's.

policy_replay.backflip replays `examples/policies/backflip_ars.npz` on a batch
of GROUND_RANDOMIZER frictions. This script runs the same replay (the
"hold" LandingWrapperBackflip, the same settle and step budget) with every
lane in lane 0's scenario of that replay (seed 0) and its friction replaced
by one of the values given, one lane per value, and prints one JSON line
per friction with the gate's KPIs and verdict.

    python tests/torch_backflip_friction_probe.py 0.6058 0.6107 0.632 0.876
    python tests/torch_backflip_friction_probe.py --device cpu 0.632
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from quadruped_springs_tpu_torch import policy_replay as pr  # noqa: E402
from quadruped_springs_tpu_torch.env.env import take  # noqa: E402


@torch.no_grad()
def run(frictions, device="cuda", lanes: int = 64, seed: int = 0, settle: int = 2500,
        max_steps: int = 60) -> list:
    device = torch.device(device)
    env = pr._flip_env(device, settle, obs_noise=False)
    w = pr.wr.LandingWrapperBackflip(env, variant="hold")
    W, on = pr.convert.load_linear_policy(pr.POLICY_DIR / "backflip_ars.npz", device)
    gen = torch.Generator(device).manual_seed(seed)
    drawn = pr.rnd.sample_scenario(env.cfg, env.config.env_randomizer_mode, gen, lanes)
    scenario = take(drawn, torch.zeros(len(frictions), dtype=torch.long, device=device))
    scenario = pr.dataclasses.replace(scenario, friction=torch.tensor(
        frictions, dtype=torch.float32, device=device))
    state, obs = env.reset(gen, scenario=scenario)
    state, _ = pr.bh.wrapper_episode(
        w, lambda o, armed: pr.linear_policy_apply(W, pr.vnorm.normalize(on, o)), state, obs,
        gen, max_steps)
    rec = pr._flip_result(state)
    return [{"friction": f, "ok": rec["ok"][i], "up_z": rec["up_z"][i],
             "pitch_rad": rec["pitch_rad"][i], "final_z": rec["final_z"][i],
             "bars": rec["bars"]} for i, f in enumerate(frictions)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("frictions", type=float, nargs="+")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_backflip_friction_probe: no CUDA card (pass --device cpu)")
    for row in run(a.frictions, a.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
