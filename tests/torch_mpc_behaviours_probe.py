"""The port's MPC behaviour drivers over many seeds, on the card: the pass
share that chip_smoke.py's phase 20 compares with the JAX package's
(tests/jax_mpc_behaviours_probe.py, the same drivers' bars on the CPU).

    python tests/torch_mpc_behaviours_probe.py jumping_forward --seeds $(seq 0 63)
    python tests/torch_mpc_behaviours_probe.py backflip --jax-ground --seeds 0 1 2 3 4 5 6 7

Runs quadruped_springs_tpu_torch.mpc_behaviours's driver at the JAX
example's full configuration for every seed, the seeds split over
--processes spawned processes on the one card, and prints one JSON line per
seed (the driver's record and `passed`: the bars of chip_smoke.py's
behaviour_passed), then one line with the count. --jax-ground runs the
backflip on the JAX example's ground of each seed 0-7
(chip_smoke.JAX_BACKFLIP_FRICTION). --trace adds to each record the
driver's first plan (`plan`, the us of its first solve), the base every 5
control steps (`trace_t_x_z_upz_feet`: sim time, x, z, the body z-axis's
vertical component, feet in contact) and the time spent upside down
(`upside_down_s`); tests/jax_mpc_behaviours_probe.py --execute-plans runs
the plans through the JAX example's env. No torch import at the top level:
the spawned processes import this file.
"""

import argparse
import json
import multiprocessing
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _run(job):
    """Run the driver over the job's seeds; with `trace`, record the base
    after every control step (QuadrupedEnv.step) and each plan (the first
    solve's us)."""
    import torch

    import chip_smoke
    from quadruped_springs_tpu_torch import mpc_behaviours
    from quadruped_springs_tpu_torch.env.env import QuadrupedEnv
    from quadruped_springs_tpu_torch.models import spatial as sp
    from quadruped_springs_tpu_torch.solver.mpc import MPCProblem

    name, seeds, device, jax_ground, trace = job
    torch.backends.cuda.matmul.allow_tf32 = False
    steps, plans = [], []
    if trace:
        env_step, solve = QuadrupedEnv.step, MPCProblem.solve_mppi

        def traced_step(self, state, *args, **kw):
            out = env_step(self, state, *args, **kw)
            r = out[0].robot
            steps.append(torch.stack([self.sim_time(out[0])[0], r.pos[0, 0], r.pos[0, 2],
                                      sp.quat_to_mat(r.quat)[0, 2, 2],
                                      out[0].feet_in_contact[0].sum().float()]))
            return out

        def traced_solve(self, *args, **kw):
            sol = solve(self, *args, **kw)
            plans.append(sol.us[0].cpu())
            return sol

        QuadrupedEnv.step, MPCProblem.solve_mppi = traced_step, traced_solve
    out = []
    for seed in seeds:
        steps.clear()
        plans.clear()
        kw = {"friction": chip_smoke.JAX_BACKFLIP_FRICTION[seed]} if jax_ground else {}
        rec = mpc_behaviours.DRIVERS[name](seed=seed, device=device, **kw)
        rec = {"behaviour": name, "seed": seed,
               "passed": chip_smoke.behaviour_passed(name, rec)[0], **rec}
        if trace:
            t = torch.stack(steps).cpu()
            rec["upside_down_s"] = round(float((t[:, 3] < 0).sum()) * 0.01, 2)
            rec["trace_t_x_z_upz_feet"] = [[round(v, 3) for v in row] for row in t[::5].tolist()]
            rec["plan"] = plans[0].tolist()
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("behaviour", choices=("jumping_forward", "backflip", "continuous"))
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--processes", type=int, default=4)
    ap.add_argument("--jax-ground", action="store_true",
                    help="backflip only: the JAX example's ground of each seed 0-7")
    ap.add_argument("--trace", action="store_true",
                    help="add each seed's first plan and the base every 5 control steps")
    a = ap.parse_args(argv)
    n = max(1, min(a.processes, len(a.seeds)))
    jobs = [(a.behaviour, a.seeds[i::n], a.device, a.jax_ground, a.trace) for i in range(n)]
    with multiprocessing.get_context("spawn").Pool(n) as pool:
        recs = sorted((r for rs in pool.map(_run, jobs) for r in rs), key=lambda r: r["seed"])
    for r in recs:
        print(json.dumps(r), flush=True)
    print(json.dumps({"behaviour": a.behaviour, "seeds": a.seeds,
                      "passed": sum(r["passed"] for r in recs)}), flush=True)


if __name__ == "__main__":
    main()
