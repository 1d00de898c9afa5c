"""Replay of the committed policies on the batched 1 kHz environment.

The port of the replay functions behind the JAX package's closed-loop
behaviour gates (``tests/test_closed_loop_behaviors.py``), batched over
lanes: every lane draws its own scenario (and observation noise) from one
``torch.Generator``, and each function returns the per-lane KPIs with the
gate's bars applied.

  backflip         examples/policies/backflip_ars.npz launches, the
                   LandingWrapperBackflip ("hold") autopilot finishes
                   (examples/run_backflip_closed_loop.py `run`)
  backflip_robust  backflip_launch_robust.npz + backflip_landing_mlp.npz
                   under TEST_RANDOMIZER with observation noise, through
                   the "until_grounded" autopilot (`run_robust`);
                   `nominal=True`: GROUND_RANDOMIZER, no noise
  forward          forward_ars.npz through LandingWrapper
                   (examples/run_jumping_forward_mpc.py with its learned policy)
  two_stage        backflip_two_stage.npz launches, the flattened autopilot
                   episode finishes (examples/train_two_stage_backflip.py
                   `flip_probe_fn`)
  continuous       continuous_policy.npz through ContinuousAutopilotEnv for
                   410 steps (examples/train_continuous_policy.py
                   `make_eval` / `eval_scores`)

    python -m quadruped_springs_tpu_torch.policy_replay --behavior all
    python -m quadruped_springs_tpu_torch.policy_replay --device cpu \\
        --behavior forward --lanes 1 --settle 600

prints one JSON record per behaviour. A CUDA device that is not available
is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.env import flat_rollout as fr
from quadruped_springs_tpu_torch.env import randomizers as rnd
from quadruped_springs_tpu_torch.env import wrappers as wr
from quadruped_springs_tpu_torch.env.continuous_autopilot import ContinuousAutopilotEnv
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.env_bench import resolve_device
from quadruped_springs_tpu_torch.tasks.tasks import continuous_jump_stats
from quadruped_springs_tpu_torch.train import behaviour as bh
from quadruped_springs_tpu_torch.train import continuous as cont
from quadruped_springs_tpu_torch.train import normalize as vnorm
from quadruped_springs_tpu_torch.train import rollout as ro
from quadruped_springs_tpu_torch.train.networks import linear_policy_apply
from quadruped_springs_tpu_torch.train.two_stage import ROT_BAR, UP_Z_BAR, Z_BAR, flip_lanes

POLICY_DIR = Path(__file__).resolve().parents[1] / "examples" / "policies"
FWD_BAR, APEX_BAR = 0.30, 0.10   # jumping forward: distance and apex
GOOD_JUMPS_BAR, MEAN_PERF_BAR = 4, 0.6
# `backflip_ars.npz` is gated by the JAX package on one scenario, the friction
# its seed 0 draws. Across the randomizer's range [0.5, 1.0] the policy does
# not land upright everywhere, in the JAX package as little as here: both
# rotate fully and fall over at every friction tried up to 0.6058 and land
# upright at every one from 0.6107 up (tests/jax_backflip_friction_probe.py
# beside this replay, per friction). Lanes from the edge up are held to the bars.
GATE_FRICTION = 0.8758191466331482
UPRIGHT_FRICTION_EDGE = 0.611
FLIP_KNOTS = 140                 # 1.4 s flattened episode (the flip ends by ~1.0 s)
CONTINUOUS_STEPS = 410


def _flip_env(device, settle, **kw) -> QuadrupedEnv:
    return QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="BACKFLIP", observation_space_mode="ARS_BACKFLIP",
        action_space_mode="SYMMETRIC", max_ep_len=4.0, settling_steps=settle, **kw),
        device=device)


def _flip_result(state) -> dict:
    """The backflip gates' KPIs of a final EnvState, per lane
    (``two_stage.flip_lanes``): `rotation`, `upright` (the pose alone) and
    `ok` (both)."""
    g = flip_lanes(state)
    ok = g["rotation"] & g["upright"]
    return {"lanes": int(ok.shape[0]), "passed": int(ok.sum()),
            "full_rotation": int(g["rotation"].sum()),
            "bars": {"pitch_rad": ROT_BAR, "up_z": UP_Z_BAR, "final_z": Z_BAR},
            "pitch_rad": g["pitch_rad"].tolist(), "up_z": g["up_z"].tolist(),
            "final_z": g["z"].tolist(), "apex_rel_m": g["apex"].tolist(),
            "rotation": g["rotation"].tolist(), "upright": g["upright"].tolist(),
            "ok": ok.tolist()}


@torch.no_grad()
def backflip(lanes: int = 64, device=None, seed: int = 0, settle: int = 2500,
             max_steps: int = 60) -> dict:
    """Lane 0 runs the scenario of the JAX gate (GATE_FRICTION), the other
    lanes keep their GROUND_RANDOMIZER draws; `gated` marks the lanes whose
    friction the policy can be held to (UPRIGHT_FRICTION_EDGE and above)."""
    device = resolve_device(device)
    env = _flip_env(device, settle, obs_noise=False)
    w = wr.LandingWrapperBackflip(env, variant="hold")
    W, on = convert.load_linear_policy(POLICY_DIR / "backflip_ars.npz", device)
    gen = torch.Generator(device).manual_seed(seed)
    scenario = rnd.sample_scenario(env.cfg, env.config.env_randomizer_mode, gen, lanes)
    friction = scenario.friction.clone()
    friction[0] = GATE_FRICTION
    scenario = dataclasses.replace(scenario, friction=friction)
    state, obs = env.reset(gen, scenario=scenario)
    state, _ = bh.wrapper_episode(
        w, lambda o, armed: linear_policy_apply(W, vnorm.normalize(on, o)), state, obs, gen,
        max_steps)
    rec = _flip_result(state)
    gated = (friction >= UPRIGHT_FRICTION_EDGE).tolist()
    return {"behavior": "backflip", "friction": friction.tolist(), "gated": gated,
            "gated_lanes": sum(gated),
            "gated_passed": sum(ok and g for ok, g in zip(rec["ok"], gated)),
            "sim_s": env.sim_time(state).tolist(), **rec}


@torch.no_grad()
def backflip_robust(lanes: int = 64, nominal: bool = False, device=None, seed: int = 0,
                    settle: int = 2500, max_steps: int = 120, seeds=None,
                    launch=POLICY_DIR / "backflip_launch_robust.npz",
                    lander=POLICY_DIR / "backflip_landing_mlp.npz") -> dict:
    """The launch policy flies until the autopilot has fired in a lane, the
    landing policy after it. Every lane draws from one generator seeded
    `seed`, or, with `seeds`, lane i replays seed i's own scenario and
    noise stream (``rollout.seeded_reset``: validate_backflip_robust's
    one episode per seed). `launch`, `lander`: the policy files."""
    device = resolve_device(device)
    env = _flip_env(device, settle, obs_noise=not nominal,
                    env_randomizer_mode="GROUND_RANDOMIZER" if nominal
                    else "TEST_RANDOMIZER")
    w = wr.LandingWrapperBackflip(env, variant="until_grounded")
    W, on = convert.load_linear_policy(launch, device)
    lander_fn, _ = convert.load_small_mlp(lander, device)
    if seeds is None:
        noise = torch.Generator(device).manual_seed(seed)
        state, obs = env.reset(noise, lanes)
    else:
        state, obs, noise = ro.seeded_reset(env, seeds)
    state, _ = bh.wrapper_episode(
        w, bh.launch_then_lander(lambda o: linear_policy_apply(W, vnorm.normalize(on, o)),
                                 lambda o: lander_fn(vnorm.normalize(on, o))),
        state, obs, noise, max_steps)
    return {"behavior": "backflip_nominal" if nominal else "backflip_robust",
            "randomizer": env.config.env_randomizer_mode, "obs_noise": not nominal,
            **_flip_result(state)}


@torch.no_grad()
def forward(lanes: int = 64, device=None, seed: int = 0, settle: int = 2500,
            max_steps: int = 60) -> dict:
    """Jumping forward in the gate's own configuration: no randomizer, every
    lane the same nominal scenario."""
    device = resolve_device(device)
    env = QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="JUMPING_FORWARD", observation_space_mode="ARS_BASIC",
        action_space_mode="SYMMETRIC", obs_noise=False, env_randomizer_mode="NONE",
        max_ep_len=4.0, settling_steps=settle), device=device)
    w = wr.LandingWrapper(env)
    W, on = convert.load_linear_policy(POLICY_DIR / "forward_ars.npz", device)
    gen = torch.Generator(device).manual_seed(seed)
    state, obs = env.reset(gen, lanes)
    x_start = state.robot.pos[:, 0]
    state, _ = bh.wrapper_episode(
        w, lambda o, armed: linear_policy_apply(W, vnorm.normalize(on, o)), state, obs, gen,
        max_steps)
    # forward distance is the base's x-displacement over the run: the
    # task's max_forward_distance is zeroed on grounded steps
    fwd = state.robot.pos[:, 0] - x_start
    apex, z = state.task.relative_max_height, state.robot.pos[:, 2]
    ok = (fwd >= FWD_BAR) & (apex >= APEX_BAR) & (z > Z_BAR)
    return {"behavior": "forward", "randomizer": "NONE", "lanes": lanes,
            "passed": int(ok.sum()),
            "bars": {"fwd_distance_m": FWD_BAR, "apex_rel_m": APEX_BAR, "final_z": Z_BAR},
            "fwd_distance_m": fwd.tolist(), "apex_rel_m": apex.tolist(),
            "final_z": z.tolist(), "ok": ok.tolist()}


@torch.no_grad()
def two_stage(lanes: int = 64, device=None, seed: int = 0, settle: int = 600,
              n_knots: int = FLIP_KNOTS) -> dict:
    """The two-stage-trained flip policy on the deployed surface: the policy
    launches, the flattened autopilot finishes; no read on the host inside
    the episode."""
    device = resolve_device(device)
    env = _flip_env(device, settle, obs_noise=False)
    net, on = convert.load_flat_mlp_policy(POLICY_DIR / "backflip_two_stage.npz", device)
    landing = env.get_landing_action()
    gen = torch.Generator(device).manual_seed(seed)
    state, obs = env.reset(gen, lanes)
    state, _, _ = fr.backflip_episode(
        env, lambda o: torch.clamp(net(vnorm.normalize(on, o))[0], -1.0, 1.0),
        lambda o: landing.expand(o.shape[0], -1), state, obs, n_knots, gen)
    return {"behavior": "two_stage", **_flip_result(state)}


@torch.no_grad()
def continuous(lanes: int = 64, device=None, seed: int = 0, settle: int = 600,
               n_steps: int = CONTINUOUS_STEPS, seconds: float = 4.0) -> dict:
    """The learned continuous-jumping policy through the per-jump autopilot
    adapter, scored by the task's own per-jump statistics; no read on the
    host inside the episode."""
    device = resolve_device(device)
    env = ContinuousAutopilotEnv(QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="CONTINUOUS_JUMPING_FORWARD3",
        observation_space_mode="PPO_CONTINUOUS_JUMPING_FORWARD",
        action_space_mode="SYMMETRIC", settling_steps=settle, max_ep_len=seconds),
        device=device))
    net, on = convert.load_flat_mlp_policy(POLICY_DIR / "continuous_policy.npz", device)
    gen = torch.Generator(device).manual_seed(seed)
    state, obs = env.reset(gen, lanes)
    state, done, _, _, _ = cont.masked_episode(env, cont.mlp_policy(net, on), state, obs,
                                               n_steps, gen)
    per_lane = [continuous_jump_stats(state.env.task, i) for i in range(lanes)]
    good = [s["good_jumps"] for s in per_lane]
    mean_perf = sum(s["mean_perf"] for s in per_lane) / lanes
    return {"behavior": "continuous", "lanes": lanes,
            "passed": sum(g >= GOOD_JUMPS_BAR for g in good),
            "bars": {"good_jumps_per_lane": GOOD_JUMPS_BAR, "mean_perf_mean": MEAN_PERF_BAR},
            "good_jumps": good, "good_jumps_min": min(good), "mean_perf_mean": mean_perf,
            "mean_perf": [s["mean_perf"] for s in per_lane],
            "n_jumps": [s["n_jumps"] for s in per_lane],
            # the episode ended, by its task's termination or by the timeout
            "done": done.tolist(),
            "ok": [g >= GOOD_JUMPS_BAR for g in good]}


BEHAVIORS = {
    "backflip": backflip,
    "backflip_robust": backflip_robust,
    "backflip_nominal": lambda **kw: backflip_robust(nominal=True, **kw),
    "forward": forward,
    "two_stage": two_stage,
    "continuous": continuous,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--behavior", default="all", choices=("all", *BEHAVIORS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--settle", type=int, default=None,
                    help="settling substeps (each behaviour's own by default)")
    a = ap.parse_args(argv)
    kw = {} if a.settle is None else {"settle": a.settle}
    records = []
    for name in (BEHAVIORS if a.behavior == "all" else (a.behavior,)):
        rec = BEHAVIORS[name](lanes=a.lanes, device=a.device, seed=a.seed, **kw)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
