"""`planner_rollout` at the springs-vs-rigid comparison's widths, on the card.

    python tests/torch_rollout_compare_probe.py [--problems 8 64 256] [--seeds 33 34 35]
    python tests/torch_rollout_compare_probe.py --pooled-lanes 4096 16384 [--seeds ...]

For the PEA robot and the rigid one, K = 64 candidates and R = 1, each
problem count and each seed of chip_smoke.rollout_problems' starts: the
outcome of chip_smoke.check_planner_rollout (phase 19's gate: the kernel's
distance to the float64 plain version against the plain version's, in
quantiles over the lanes, per field and knot; env_substeps's per-lane rule
at knot 1), and per problem the largest relative distance of the kernel and
of the plain version to the float64 run over its lanes and knots (lin_vel),
so a gate failure can be told apart: one problem whose lanes all part at a
contact event (the quantiles over few problems) or lanes across problems.
Then chip_smoke.one_knot_from_plain at each setting: one knot from the plain
version's state at every knot-lane, kernel and plain version against the
float64 knot (the gate of phase 19's headline). One JSON line per setting.

With --pooled-lanes, phase 19's own gate for the comparison instead
(chip_smoke.compare_rollout_gate: launches of 8 problems pooled over
independent draws to each lane count, the quantile gate and one knot from
the plain version's states over the pooled lanes), per robot, R, lane count
and seed: pass, or the gate's message.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from quadruped_springs_tpu_torch.control import interfaces as ci  # noqa: E402
from quadruped_springs_tpu_torch.solver import mppi  # noqa: E402
from quadruped_springs_tpu_torch.solver import rollout as ro  # noqa: E402
from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem, cast_floats  # noqa: E402


def per_problem(prob, x0, us, lanes, consts):
    """max over lanes and knots of the relative lin_vel distance to the
    float64 plain version, per problem, for the kernel and the plain one."""
    q_des = ci.action_to_command(prob.iface, us).contiguous()
    got = ro.planner_rollout(x0, q_des, lanes, consts)
    want = ro.planner_rollout_plain(x0, q_des, lanes, consts)
    f64 = lambda t: cast_floats(t, torch.float64)
    exact = ro.planner_rollout_plain(x0.double(), q_des.double(), f64(lanes), f64(consts))
    cols = chip_smoke.ROLLOUT_FIELDS["lin_vel"]
    d = lambda xs: ((xs[..., cols].double() - exact[..., cols]).abs()
                    / (1.0 + exact[..., cols].abs())).amax(-1).amax(-1).amax(-1)
    return d(got).tolist(), d(want).tolist()


def pooled(lane_counts, seeds):
    for robot, springs in (("springs", True), ("rigid", False)):
        prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=chip_smoke.HORIZON,
                                    enable_springs=springs), "cuda")
        for r in (chip_smoke.PLANNED_SAMPLES, 1):
            for lanes in lane_counts:
                for seed in seeds:
                    rec = {"robot": robot, "R": r, "lanes": lanes, "seed": seed}
                    try:
                        out = chip_smoke.compare_rollout_gate(torch, ro, mppi, prob, r, lanes,
                                                              seed)
                        rec.update(gate="pass", distance_used=out["distance_used"],
                                   lanes_outside_spread=out["lanes_outside_spread"],
                                   one_knot_far=out["one_knot"]["far"])
                    except AssertionError as e:
                        rec["gate"] = str(e)
                    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problems", type=int, nargs="*", default=[8, 64, 256])
    ap.add_argument("--seeds", type=int, nargs="*", default=[33, 34, 35])
    ap.add_argument("--pooled-lanes", type=int, nargs="*", default=[])
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    if a.pooled_lanes:
        pooled(a.pooled_lanes, a.seeds)
        return
    H = chip_smoke.HORIZON
    for robot, springs in (("springs", True), ("rigid", False)):
        prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=H,
                                    enable_springs=springs), "cuda")
        lanes, consts = prob.rollout_lanes(), prob.rollout_consts()
        for b in a.problems:
            for seed in a.seeds:
                x0, scen = chip_smoke.rollout_problems(torch, prob, b, seed)
                for r in (chip_smoke.PLANNED_SAMPLES, 1):
                    eps = 0.3 * torch.randn((b, r, H, prob.action_dim), device="cuda",
                                            generator=torch.Generator("cuda").manual_seed(34 + r))
                    us = torch.clamp(prob.task_warm_start()[None, None]
                                     + mppi._smooth_noise(eps), -1.0, 1.0)
                    rec = {"robot": robot, "problems": b, "R": r, "seed": seed}
                    try:
                        out = chip_smoke.check_planner_rollout(torch, ro, prob, x0, us, lanes,
                                                               consts, reps=1)
                        rec["gate"] = "pass"
                        rec["distance_used"] = out["distance_used"]
                        rec["lanes_outside_spread"] = out["lanes_outside_spread"]
                    except AssertionError as e:
                        rec["gate"] = str(e)
                    k, p = per_problem(prob, x0, us, lanes, consts)
                    rec["lin_vel_kernel_by_problem"] = [float(f"{v:.3e}") for v in k[:16]]
                    rec["lin_vel_plain_by_problem"] = [float(f"{v:.3e}") for v in p[:16]]
                    one = chip_smoke.one_knot_from_plain(torch, ro, prob, x0, us, scen)
                    qs = torch.tensor(chip_smoke.ONE_KNOT_QUANTILES, dtype=torch.float64,
                                      device="cuda")
                    ek, ep = one["e_kernel"], one["e_plain"]
                    rec["one_knot_quantiles_kernel"] = torch.quantile(ek, qs).tolist()
                    rec["one_knot_quantiles_plain"] = torch.quantile(ep, qs).tolist()
                    rec["one_knot_far"] = int((ek > 100.0 * ep + 1e-4).sum())
                    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
