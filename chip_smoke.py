#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):
  1. require a CUDA card (no CPU fallback); print its name and power limit;
  2. build the hand-written kernels of quadruped_springs_tpu_torch/csrc from
     the checkout and print the build time;
  3. hold each kernel against its plain PyTorch twin on the card at the
     planner's shape (32,768 lanes), on seeded inputs plus hand-placed edge
     cases, to |kernel - twin| <= 1e-5·(1 + |twin|) (FMA contraction is the
     only expected difference), and time both with CUDA events;
  4. drive the port's headline solve (quadruped_springs_tpu_torch.bench at
     full width: 1024 scenarios x 32 samples, H=50, 10 iterations, fused
     accept), check that every final cost is finite and that the mean lies
     within 3% of the JAX reference's -70.98, and that each kernel launched
     exactly once per planner substep the solves executed.
The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

REFERENCE_COST = -70.98          # JAX MPPI headline mean final cost (BENCH_r05.json)
COST_BAND = 0.03                 # ±3%: the bf16-sample path's -66.7 falls outside
BATCH, SAMPLES, HORIZON, ITERATIONS = 1024, 32, 50, 10
TIMED_RUNS = 3
LANES = BATCH * SAMPLES
REL_TOL = 1e-5
SOURCE = "quadruped_springs_tpu_torch/csrc/planner_ops.cu"


def cuda_time_ms(torch, fn, reps=30):
    """Median CUDA-event time of one call of fn, over reps calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(torch, got, want, name):
    """Max |got - want|; raises unless within REL_TOL·(1 + |want|) everywhere."""
    if got.dtype == torch.bool:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: boolean outputs differ")
        return 0.0
    err = (got - want).abs()
    bound = REL_TOL * (1.0 + want.abs())
    if not bool(torch.all(err <= bound)):
        raise AssertionError(f"{name}: max |kernel - twin| {float(err.max())} exceeds "
                             f"{REL_TOL}·(1+|twin|)")
    return float(err.max())


def check_actuation(torch, act, prob):
    cfg = prob.cfg
    gen = torch.Generator("cuda").manual_seed(11)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    rand = lambda *s: torch.rand(s, generator=gen, device="cuda")
    n = LANES
    lo, hi = prob.iface.lower_lim, prob.iface.upper_lim
    q_des = lo + rand(n, 12) * (hi - lo)
    q = cfg.init_joint_angles + 0.5 * randn(n, 12)
    qd = 3.0 * randn(n, 12)
    spring_k = cfg.spring_stiffness * (0.9 + 0.2 * rand(n, 3))
    spring_b = cfg.spring_damping * (0.9 + 0.2 * rand(n, 3))
    rest12 = torch.tile(cfg.spring_rest_angles, (4,))
    q[0] = rest12                      # sign·(q - rest) exactly 0: engaged
    q[1] = rest12
    qd[1] = 0.0
    q_des[2] = q[2] + 10.0             # saturate the torque clip
    args = (q_des, q, qd, cfg.motor_kp, cfg.motor_kd, cfg.torque_limits, spring_k,
            spring_b, cfg.spring_rest_angles, prob.engage_sign)

    def twin():
        tau_m = act.pd_torque(q_des, q, qd, cfg.motor_kp, cfg.motor_kd, cfg.torque_limits)
        return tau_m + act.spring_torque(q, qd, spring_k, spring_b,
                                         cfg.spring_rest_angles, prob.engage_sign), tau_m

    got, want = act.actuation_torque(*args), twin()
    torch.cuda.synchronize()
    err = max(max_err(torch, g, w, f"actuation {k}")
              for g, w, k in zip(got, want, ("tau", "tau_motor")))
    return {"max_abs_err": err,
            "ms": cuda_time_ms(torch, lambda: act.actuation_torque(*args)),
            "plain_ms": cuda_time_ms(torch, twin)}


def check_contact(torch, dyn, prob):
    gen = torch.Generator("cuda").manual_seed(12)
    n = LANES
    phi = 0.02 * torch.rand((n, 12), generator=gen, device="cuda") - 0.01
    v_w = torch.randn((n, 12, 3), generator=gen, device="cuda")
    mu = 0.5 + 0.5 * torch.rand((n,), generator=gen, device="cuda")
    phi[0] = 0.0                       # φ = 0: not in contact
    phi[1] = -1e-3
    phi[2:6] = 5e-3
    v_w[2, :, :2] = 3e-7               # |v_t|² = 1.8e-13, below the 1e-12 floor
    v_w[3, :, :2] = 0.0
    v_w[4, :, 0], v_w[4, :, 1] = 0.0199, 0.0   # just below v_tol = 0.02
    v_w[5, :, 0], v_w[5, :, 1] = 0.0, 0.0201   # just above
    # the wrapper takes site heights: with zero radii, φ = -z exactly
    p_w = torch.zeros_like(v_w)
    p_w[..., 2] = -phi
    radii = torch.zeros(12, device="cuda")
    model = prob.lane_params().model
    results = {}
    for clamp in (False, True):
        params = dyn.SimParams(dt=prob.sim_params.dt, contact_stiffness=4000.0,
                               contact_damping=40.0, friction=mu, clamp_damping=clamp)
        kernel = lambda: dyn.contact_forces(model, params, p_w, v_w, radii)[:3]
        twin = lambda: dyn.contact_forces_plain(phi, v_w, mu, 4000.0, 40.0,
                                                params.slip_vel_tol, clamp)
        got, want = kernel(), twin()
        torch.cuda.synchronize()
        if not bool(want[2][2:6].all()) or bool(want[2][0:2].any()):
            raise AssertionError("contact edge rows not in the intended regime")
        err = max(max_err(torch, g, w, f"contact clamp={clamp} {k}")
                  for g, w, k in zip(got, want, ("f_world", "fn", "in_contact")))
        results[clamp] = {"max_abs_err": err, "ms": cuda_time_ms(torch, kernel),
                          "plain_ms": cuda_time_ms(torch, twin)}
    # report the planner's setting (no clamp); the clamped run must agree too
    return {**results[False],
            "max_abs_err": max(results[False]["max_abs_err"], results[True]["max_abs_err"])}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card and has no CPU fallback")
    from quadruped_springs_tpu_torch import bench, kernels
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: {kind}; nvidia-smi name, power.limit:", flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    kernels.library()
    print(f"phase 2: built and loaded {kernels.build().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    prob = MPCProblem(MPCConfig(horizon=HORIZON, iterations=ITERATIONS), "cuda")
    checks = {"actuation": check_actuation(torch, act, prob),
              "contact": check_contact(torch, dyn, prob)}
    for name, r in checks.items():
        print(f"phase 3: {name} at {LANES} lanes: max_abs_err {r['max_abs_err']:.3e}, "
              f"kernel {r['ms']:.4f} ms, plain twin {r['plain_ms']:.4f} ms "
              "(CUDA events, median of 30)", flush=True)

    act.actuation_torque.launches = 0
    dyn.contact_forces.launches = 0
    rec = bench.run(batch=BATCH, horizon=HORIZON, iterations=ITERATIONS,
                    samples=SAMPLES, runs=TIMED_RUNS, device="cuda")
    torch.cuda.synchronize()
    launches = {"actuation": act.actuation_torque.launches,
                "contact": dyn.contact_forces.launches}
    costs = rec["costs"]
    if not bool(torch.isfinite(costs).all()):
        raise AssertionError("non-finite final costs in the full-width solve")
    mean_cost = rec["mean_final_cost"]
    lo, hi = sorted((REFERENCE_COST * (1 - COST_BAND), REFERENCE_COST * (1 + COST_BAND)))
    if not lo <= mean_cost <= hi:
        raise AssertionError(f"mean final cost {mean_cost} outside [{lo:.2f}, {hi:.2f}]")
    # fused accept: `iterations` K-wide rollouts plus one final rollout of
    # (proposal, best), each H knots of solver_substeps substeps
    substeps = rec["solves"] * (ITERATIONS + 1) * HORIZON * prob.config.solver_substeps
    for name, count in launches.items():
        if count != substeps:
            raise AssertionError(f"{name} kernel launched {count} times, expected "
                                 f"{substeps} (one per planner substep)")
    print(f"phase 4: {rec['solves']} full-width solves ran {substeps} planner substeps; "
          f"launches {launches}; mean final cost {mean_cost:.4f} "
          f"(band [{lo:.2f}, {hi:.2f}]); {rec['value']:.2f} solves/s on {kind}",
          flush=True)
    print(json.dumps({"bench": {k: rec[k] for k in
                                ("metric", "value", "unit", "mean_final_cost")}}))

    replaces = {"actuation": "scripts/pallas_microbench.py:96",
                "contact": "scripts/pallas_microbench.py:153"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces[name],
         "launches": launches[name], **checks[name]} for name in checks]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
