"""The JAX package's three MPC behaviour drivers over seeds, on the CPU: the
reference pass shares that the port's drivers
(quadruped_springs_tpu_torch/mpc_behaviours.py) are held to where one seed
lands on the other side of a gate's bar in one package and not the other
(their draws differ: jax.random against torch.Generator).

    python tests/jax_mpc_behaviours_probe.py backflip --seeds 0 1 2 3 4 5 6 7
    python tests/jax_mpc_behaviours_probe.py --frictions --seeds 0 1 2 3 4 5 6 7

Runs examples/run_jumping_forward_mpc.py run(driver="mpc"),
examples/run_backflip_closed_loop.py run(launch="mpc") and
examples/run_continuous_jumping_mpc.py run() at their full configurations
and prints one JSON line per seed: the example's record, the seed and
`passed` (the bars of tests/test_closed_loop_behaviors.py; the backflip's
full rotation, which its example documents), then one line with the pass
counts. --frictions prints the GROUND_RANDOMIZER friction each seed's
env.reset draws (chip_smoke.JAX_BACKFLIP_FRICTION). --execute-plans runs
the port's plans (tests/torch_mpc_behaviours_probe.py jumping_forward
--trace, on the card) open loop through the JAX example's env and
LandingWrapper; --port-with-jax-draws runs the port's jumping-forward
driver on the CPU with the JAX example's draws beside the example. The MPPI backflip
takes ~30 s a seed here, jumping forward ~1 min, continuous jumping several
minutes.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_cache")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

ROT_BAR = 2 * 3.141592653589793 - 0.1


def passed(name: str, rec: dict) -> bool:
    if name == "jumping_forward":
        return (rec["fwd_distance_m"] >= 0.30 and rec["apex_rel_m"] >= 0.10
                and rec["final_z"] > 0.15)
    if name == "continuous":
        perf = rec["per_jump_performance"]
        return (rec["sim_seconds"] >= 5.0 and rec["good_jumps"] >= 4
                and sum(p >= 0.85 for p in perf) >= 2 and rec["total_fwd_m"] > 4.0)
    return rec["full_rotation"]


def run(name: str, seed: int) -> dict:
    if name == "jumping_forward":
        from examples.run_jumping_forward_mpc import run as fwd
        return fwd(seed=seed, verbose=False, driver="mpc")[0]
    if name == "backflip":
        from examples.run_backflip_closed_loop import run as flip
        return flip(launch="mpc", seed=seed, verbose=False)[0]
    from examples.run_continuous_jumping_mpc import run as cont
    return cont(seed=seed, verbose=False)[0]


def forward_env():
    """examples/run_jumping_forward_mpc.py's env and LandingWrapper."""
    from quadruped_springs_tpu.env import wrappers as wr
    from quadruped_springs_tpu.env.env import EnvConfig, QuadrupedEnv

    env = QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="JUMPING_FORWARD", observation_space_mode="ARS_BASIC",
        action_space_mode="SYMMETRIC", obs_noise=False, env_randomizer_mode="NONE",
        max_ep_len=4.0))
    return env, wr.LandingWrapper(env)


def execute_plan(env, w, seed: int, plan) -> dict:
    """The example's execution of a given plan: its env reset with
    PRNGKey(seed), then the plan open loop through LandingWrapper for up to
    60 policy steps."""
    import jax.numpy as jnp

    state, _ = env.reset(jax.random.PRNGKey(seed))
    x_start = float(state.robot.pos[0])
    plan = jnp.asarray(plan, jnp.float32)
    for i in range(60):
        out = w.step(state, plan[min(i, plan.shape[0] - 1)])
        state = out.state
        if bool(out.done):
            break
    return {"fwd_distance_m": float(state.robot.pos[0]) - x_start,
            "apex_rel_m": float(state.task.relative_max_height),
            "final_z": float(state.robot.pos[2]), "steps": i,
            "sim_s": float(env.sim_time(state))}


def execute_plans(path):
    """Each plan of tests/torch_mpc_behaviours_probe.py jumping_forward
    --trace's records through the JAX example's env, beside the port's
    outcome of it."""
    env, w = forward_env()
    for line in open(path):
        rec = json.loads(line)
        if "plan" not in rec:
            continue
        out = execute_plan(env, w, rec["seed"], rec["plan"])
        print(json.dumps({"seed": rec["seed"], "port": {k: rec[k] for k in out},
                          "jax": out, "passed_port": rec["passed"],
                          "passed_jax": passed("jumping_forward", {**rec, **out})}), flush=True)


def port_with_jax_draws(seeds):
    """The port's jumping-forward driver on the CPU with the JAX example's
    draws injected (mppi.solve's split(PRNGKey(seed + 1), iterations) ->
    normal(k, (K, H, m))) beside the JAX example at the same seed."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from quadruped_springs_tpu_torch import mpc_behaviours

    p = mpc_behaviours.PLANNERS["jumping_forward"]
    for seed in seeds:
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), p.iterations)
        draws = jax.vmap(lambda k: jax.random.normal(
            k, (p.n_samples, p.horizon, 6), jnp.float32))(keys)
        port = mpc_behaviours.jumping_forward(
            seed=seed, device="cpu",
            draws=[torch.from_numpy(np.array(draws))[:, None].contiguous()])
        ref = run("jumping_forward", seed)
        print(json.dumps({"seed": seed, "port": port, "jax": ref,
                          "passed_port": passed("jumping_forward", port),
                          "passed_jax": passed("jumping_forward", ref)}), flush=True)
        jax.clear_caches()


def frictions(seeds):
    from quadruped_springs_tpu.env import randomizers as rnd
    from quadruped_springs_tpu.models.go1_params import go1_config

    cfg = go1_config(True)
    for seed in seeds:
        # QuadrupedEnv.reset: key, k_scen, k_obs = jax.random.split(key, 3)
        k_scen = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
        scen = rnd.sample_scenario(cfg, "GROUND_RANDOMIZER", k_scen)
        print(json.dumps({"seed": seed, "friction": float(scen.friction)}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("behaviours", nargs="*",
                    choices=("jumping_forward", "backflip", "continuous"),
                    help="default: backflip")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--frictions", action="store_true")
    ap.add_argument("--execute-plans", metavar="JSONL",
                    help="tests/torch_mpc_behaviours_probe.py jumping_forward --trace output")
    ap.add_argument("--port-with-jax-draws", action="store_true",
                    help="jumping forward: the port on the CPU with JAX's draws, beside JAX")
    a = ap.parse_args(argv)
    if a.frictions:
        frictions(a.seeds)
        return
    if a.execute_plans:
        execute_plans(a.execute_plans)
        return
    if a.port_with_jax_draws:
        port_with_jax_draws(a.seeds)
        return
    for name in a.behaviours or ["backflip"]:
        count = 0
        for seed in a.seeds:
            rec = run(name, seed)
            ok = passed(name, rec)
            count += ok
            print(json.dumps({"behaviour": name, "seed": seed, "passed": ok, **rec}),
                  flush=True)
            # each example run builds its own env, and jit compiles its step
            # again: drop the executables, which otherwise pile up until
            # XLA:CPU crashes after some tens of runs
            jax.clear_caches()
        print(json.dumps({"behaviour": name, "seeds": a.seeds, "passed": count}), flush=True)


if __name__ == "__main__":
    main()
