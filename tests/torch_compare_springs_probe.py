"""The port's planned springs-vs-rigid comparison at full size on the CPU,
with the JAX package's draws injected, against the committed JAX result.

    python tests/torch_compare_springs_probe.py [--out FILE]

runs quadruped_springs_tpu_torch.compare_springs.planned (both robots,
H = 50, K = 64, 10 iterations, 8 solves, the fidelity env's 2,500-substep
settle) on the CPU with the draws scripts/compare_springs.py makes from
split(PRNGKey(1), 8), and prints one JSON line: the port's rows (unrounded,
with every solve's cost and planned apex), docs/springs_vs_rigid.json's
rows, and per row the differences of the best and mean cost, the planned
apexes and the executed apex.

    python tests/torch_compare_springs_probe.py --jax-keys 1 2 3 4

instead runs the JAX script's planned rows (JAX on the CPU) at the given
PRNGKeys in place of 1 and reports each key's rows and whether the
mechanical bars of tests/test_artifacts.py hold (both upright, the peak
motor torque at the 33.55 N m limit, springs' executed apex above rigid's
by more than 0.15 m): how often the committed claim holds over the draws.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

H, K, ITERS, N = 50, 64, 10, 8
KEYS = ("planned_apex_best_m", "planned_apex_mean_m", "planned_apex_max_m", "best_cost",
        "mean_cost", "executed_apex_m", "peak_motor_torque_Nm", "motor_work_J", "upright")


def jax_draws(key: int, n: int = N, horizon: int = H, samples: int = K, iters: int = ITERS,
              m: int = 6) -> np.ndarray:
    """The standard normals scripts/compare_springs.py's solves draw from
    split(PRNGKey(key), n): (iters, n, K, H, m), mppi.solve's noise layout."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    keys = jax.random.split(jax.random.PRNGKey(key), n)
    per_solve = [jax.vmap(lambda k: jax.random.normal(k, (samples, horizon, m), jnp.float32))(
        jax.random.split(k, iters)) for k in keys]
    return np.stack([np.asarray(d) for d in per_solve], axis=1)


def bars(rows: dict) -> bool:
    """tests/test_artifacts.py's mechanical bars on the two rows."""
    from quadruped_springs_tpu_torch.compare_springs import bars as both

    return both(rows["springs"], rows["rigid"])


def port_with_jax_draws() -> dict:
    import torch

    from quadruped_springs_tpu_torch import compare_springs as cs

    draws = torch.from_numpy(jax_draws(1))
    with open(os.path.join(REPO, "docs/springs_vs_rigid.json")) as f:
        ref = json.load(f)
    out = {"device": "cpu", "draws": "JAX's, split(PRNGKey(1), 8)"}
    for label, springs in cs.CONFIGS.items():
        t0 = time.time()
        row, = cs.planned_rows(springs, torch.device("cpu"), draws=draws)
        out[label] = row
        out[f"{label}_minus_jax"] = {k: row[k] - ref[label][k] for k in KEYS
                                     if k != "upright"}
        out[f"{label}_seconds"] = time.time() - t0
        print(label, json.dumps(out[f"{label}_minus_jax"]), flush=True)
    out["jax"] = ref
    rounded = {lab: {k: (round(v, 3) if isinstance(v, float) else v)
                     for k, v in out[lab].items()} for lab in cs.CONFIGS}
    out["summary"] = cs.summary(rounded["springs"], rounded["rigid"])
    out["bars"] = bars(out)
    return out


def jax_rows(key: int) -> dict:
    """scripts/compare_springs.py's rows with PRNGKey(key) in place of 1."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from quadruped_springs_tpu.solver import mppi
    from quadruped_springs_tpu.solver.mpc import MPCConfig, MPCProblem, state_to_vec
    from quadruped_springs_tpu.utils import verification as V

    rows = {}
    for springs in (True, False):
        prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=H, iterations=ITERS,
                                    n_alphas=8, enable_springs=springs))
        env = V.fidelity_env("JUMPING_IN_PLACE", enable_springs=springs)
        state, _ = env.reset(jax.random.PRNGKey(0))
        x0, u0 = state_to_vec(state.robot), prob.task_warm_start()
        mcfg = mppi.MPPIConfig(horizon=H, iterations=ITERS)
        keys = jax.random.split(jax.random.PRNGKey(key), N)
        sols = jax.jit(jax.vmap(lambda k: prob.solve_mppi(x0, u0, k, mcfg)))(keys)
        z, vz = sols.xs[..., 2], sols.xs[..., 9]
        apexes = jnp.max(z + jnp.maximum(vz, 0.0) ** 2 / (2 * 9.81), axis=-1)
        best = int(jnp.argmin(sols.cost))
        land = env.get_landing_action()
        us = jnp.concatenate([sols.us[best], jnp.broadcast_to(land, (70,) + land.shape)])
        got = V.split_trace(np.asarray(V.record_golden_trace(env, us, jax.random.PRNGKey(2))),
                            env.action_dim)
        tau, qd = got["tau"], got["qd"]
        rows["springs" if springs else "rigid"] = {
            "planned_apex_best_m": float(apexes[best]),
            "planned_apex_mean_m": float(jnp.mean(apexes)),
            "best_cost": float(sols.cost[best]), "mean_cost": float(jnp.mean(sols.cost)),
            "executed_apex_m": float(got["pos"][:, 2].max()),
            "peak_motor_torque_Nm": round(float(np.abs(tau).max()), 2),
            "motor_work_J": float(np.maximum(np.sum(tau * qd, axis=1), 0.0).sum()) * 0.01,
            "upright": bool(abs(got["quat"][-1, 0]) + abs(got["quat"][-1, 1]) < 0.5)}
    return {"key": key, **rows, "bars": bars(rows)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jax-keys", type=int, nargs="*", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.jax_keys:
        recs = []
        for key in a.jax_keys:
            recs.append(jax_rows(key))
            print(json.dumps(recs[-1]), flush=True)
        rec = {"jax_keys": recs, "bars_hold": sum(r["bars"] for r in recs),
               "of": len(recs)}
    else:
        rec = port_with_jax_draws()
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rec, f, indent=2)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
