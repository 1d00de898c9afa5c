#!/usr/bin/env python3
"""Where does `backflip_ars.npz` stop landing upright? The JAX side.

The JAX package gates its backflip launch policy on one scenario: the ground
friction that seed 0 draws (0.8758). The port replays the policy on a batch of
GROUND_RANDOMIZER frictions, so it needs to know which of them the policy can
be held to. This script runs the JAX package's own closed loop
(`examples/run_backflip_closed_loop.run(launch="policy")`: same environment,
same "hold" autopilot, same loop) on the CPU with the friction of seed 0's
scenario replaced by each value given, everything else as the gate has it,
and prints one JSON line per friction with the gate's KPIs. Given the record
that `python -m quadruped_springs_tpu_torch.policy_replay --behavior backflip`
printed for the port (a file with that JSON line), it runs the JAX package at
every lane's friction, prints the port's `up_z` and verdict beside its own,
and ends with the count of lanes on which the two verdicts agree.

    python tests/jax_backflip_friction_probe.py 0.55 0.60 0.62 0.70
    python tests/jax_backflip_friction_probe.py --replay replay.jsonl

About 3 minutes for the first friction (tracing and compiling reset and the
wrapper step on the CPU), seconds for each further one.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from examples.run_backflip_closed_loop import POLICY_PATH
from quadruped_springs_tpu.env import env as env_mod
from quadruped_springs_tpu.env import wrappers as wr
from quadruped_springs_tpu.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu.models import spatial as sp
from quadruped_springs_tpu.train import normalize as vnorm
from quadruped_springs_tpu.train.networks import linear_policy_apply


def port_record(path):
    """The port's backflip record: the first such JSON line of the file."""
    with open(path) as f:
        for line in f:
            if line.startswith("{") and json.loads(line).get("behavior") == "backflip":
                return json.loads(line)
    raise SystemExit(f"no backflip record in {path}")


def main(frictions, port=None, seed=0, max_steps=60):
    env = QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="BACKFLIP", observation_space_mode="ARS_BACKFLIP",
        action_space_mode="SYMMETRIC", obs_noise=False, max_ep_len=4.0))
    w = wr.LandingWrapperBackflip(env, variant="hold")
    d = np.load(POLICY_PATH)
    W = jnp.asarray(d["W"])
    on = vnorm.RunningNorm(mean=jnp.asarray(d["mean"]), var=jnp.asarray(d["var"]),
                           count=jnp.asarray(d["count"]))
    sample = env_mod.rnd.sample_scenario

    @jax.jit
    def reset_at(key, friction):
        # the env's own reset, traced with the drawn scenario's friction replaced
        env_mod.rnd.sample_scenario = lambda *a, **k: sample(*a, **k).replace(
            friction=friction)
        try:
            return QuadrupedEnv.reset.__wrapped__(env, key)
        finally:
            env_mod.rnd.sample_scenario = sample

    agree = 0
    for lane, f in enumerate(frictions):
        state, obs = reset_at(jax.random.PRNGKey(seed), jnp.float32(f))
        for i in range(max_steps):
            out = w.step(state, linear_policy_apply(W, vnorm.normalize(on, obs)))
            state, obs = out.state, out.obs
            if bool(out.done):
                break
        pitch = float(state.task.max_pitch_bf)
        up_z = float(sp.quat_to_mat(state.robot.quat)[2, 2])
        z = float(state.robot.pos[2])
        rec = {"friction": float(state.scenario.friction), "pitch_rad": pitch, "up_z": up_z,
               "final_z": z, "full_rotation": bool(pitch >= 2 * np.pi - 0.1),
               "upright": up_z > 0.85 and z > 0.15, "steps": i,
               "sim_s": float(env.sim_time(state))}
        if port is not None:
            rec.update(lane=lane, port_up_z=port["up_z"][lane], port_ok=port["ok"][lane])
            agree += port["ok"][lane] == (rec["full_rotation"] and rec["upright"])
        print(json.dumps(rec), flush=True)
    if port is not None:
        print(json.dumps({"lanes": len(frictions), "verdicts_agree": agree}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--replay"]:
        record = port_record(sys.argv[2])
        main(record["friction"], record)
    else:
        main([float(a) for a in sys.argv[1:]] or [0.8758191466331482])
