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
     exactly once per planner substep the solves executed;
  5. hold every kernel of the environment's path against its twin at the
     environment's shapes and constants, to the bound of phase 3, and time
     both: the anchored contact kernel at 1024 environments x 12 sites
     (seeded inputs plus hand-placed lanes: out of contact, φ = 0, inside
     the friction cone, on its boundary, |f_trial| = 0), with the damping
     clamp on and off; `actuation` at 1024 lanes with per-environment
     springs, under the motor gains and the landing wrapper's (kp 60,
     kd 1.5); the memoryless `contact` of reset's contact priming at 1024
     x 12 sites with the execution model's 180 kN/m and 100 N s/m, clamp on
     and off;
  6. drive the environment rollout bench (quadruped_springs_tpu_torch.
     env_bench: 1024 environments, settle 600 substeps, one warm-up and 3
     timed segments of T control steps x 10 substeps holding the init
     action): every environment stands after reset (height in (0.25, 0.36),
     four feet in contact, no other site) and stays upright and finite,
     no foot drifts more than CREEP_BOUND in world xy over a timed segment,
     `actuation` and `contact_anchored` launch once per substep, and
     env.step makes no host sync; then a torch.profiler breakdown of one
     substep (launches, device busy share, kernel classes);
  7. the examples/run_episode.py flow through LandingWrapper on 64
     GROUND_RANDOMIZER environments (default 2500-substep settle, crouch
     30 steps, then extend for up to 120): every environment jumps higher
     than 0.2 m and switches to its landing controller.
The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time
import warnings

REFERENCE_COST = -70.98          # JAX MPPI headline mean final cost (BENCH_r05.json)
COST_BAND = 0.03                 # ±3%: the bf16-sample path's -66.7 falls outside
BATCH, SAMPLES, HORIZON, ITERATIONS = 1024, 32, 50, 10
TIMED_RUNS = 3
LANES = BATCH * SAMPLES
REL_TOL = 1e-5
SOURCE = "quadruped_springs_tpu_torch/csrc/planner_ops.cu"
ENVS, ENV_STEPS, ENV_SEGMENTS, ENV_SETTLE = 1024, 100, 3, 600
# The anchor springs hold a static stance with ~1 mm of spring travel
# (quadruped_springs_tpu/models/dynamics.py:71-78); a stance held by them
# moves far less than that in a second, while the memoryless friction it
# replaced crept ~4 cm/s. 1 mm per 1 s segment separates the two 40-fold.
CREEP_BOUND = 1e-3
EPISODE_ENVS, EPISODE_LEN = 64, 3.0   # episode cut to 3 s (the jump ends by ~1 s)


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


def check_actuation(torch, act, owner, n, kp=None, kd=None):
    """The `actuation` kernel against its twin at n lanes with owner's (an
    MPCProblem's or a QuadrupedEnv's) config, limits and spring signs;
    kp, kd: (12,) gains, the motor gains by default."""
    cfg = owner.cfg
    kp = cfg.motor_kp if kp is None else kp
    kd = cfg.motor_kd if kd is None else kd
    gen = torch.Generator("cuda").manual_seed(11)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    rand = lambda *s: torch.rand(s, generator=gen, device="cuda")
    lo, hi = owner.iface.lower_lim, owner.iface.upper_lim
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
    args = (q_des, q, qd, kp, kd, cfg.torque_limits, spring_k, spring_b,
            cfg.spring_rest_angles, owner.engage_sign)

    def twin():
        tau_m = act.pd_torque(q_des, q, qd, kp, kd, cfg.torque_limits)
        return tau_m + act.spring_torque(q, qd, spring_k, spring_b,
                                         cfg.spring_rest_angles, owner.engage_sign), tau_m

    got, want = act.actuation_torque(*args), twin()
    torch.cuda.synchronize()
    err = max(max_err(torch, g, w, f"actuation {k}")
              for g, w, k in zip(got, want, ("tau", "tau_motor")))
    return {"max_abs_err": err,
            "ms": cuda_time_ms(torch, lambda: act.actuation_torque(*args)),
            "plain_ms": cuda_time_ms(torch, twin)}


def check_contact(torch, dyn, model, n, kn, dn):
    """The memoryless `contact` kernel against its twin at n lanes x 12
    sites with normal stiffness kn and damping dn, clamp on and off."""
    gen = torch.Generator("cuda").manual_seed(12)
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
    results = {}
    for clamp in (False, True):
        params = dyn.SimParams(contact_stiffness=kn, contact_damping=dn, friction=mu,
                               clamp_damping=clamp)
        kernel = lambda: dyn.contact_forces(model, params, p_w, v_w, radii)[:3]
        twin = lambda: dyn.contact_forces_plain(phi, v_w, mu, kn, dn,
                                                params.slip_vel_tol, clamp)
        got, want = kernel(), twin()
        torch.cuda.synchronize()
        if not bool(want[2][2:6].all()) or bool(want[2][0:2].any()):
            raise AssertionError("contact edge rows not in the intended regime")
        err = max(max_err(torch, g, w, f"contact clamp={clamp} {k}")
                  for g, w, k in zip(got, want, ("f_world", "fn", "in_contact")))
        results[clamp] = {"max_abs_err": err, "ms": cuda_time_ms(torch, kernel),
                          "plain_ms": cuda_time_ms(torch, twin)}
    return results


def report_checks(phase, checks, n, unit):
    for name, by_setting in checks.items():
        for setting, r in by_setting.items():
            print(f"phase {phase}: {name} ({setting}) at {n} {unit}: max_abs_err "
                  f"{r['max_abs_err']:.3e}, kernel {r['ms']:.4f} ms, plain twin "
                  f"{r['plain_ms']:.4f} ms (CUDA events, median of 30)", flush=True)


def check_anchored_contact(torch, dyn, model):
    """Phase 5: the `contact_anchored` kernel against its twin."""
    gen = torch.Generator("cuda").manual_seed(13)
    n = ENVS
    rand = lambda *s: torch.rand(s, generator=gen, device="cuda")
    radii = torch.tensor([0.02] * 4 + [0.008] * 4 + [0.055] * 4, device="cuda")
    p_w = 0.5 * (2 * rand(n, 12, 3) - 1)
    p_w[..., 2] = radii + 0.02 * rand(n, 12) - 0.01
    v_w = 0.3 * torch.randn((n, 12, 3), generator=gen, device="cuda")
    sign = torch.where(rand(n, 4, 2) < 0.5, -1.0, 1.0)
    anchor = p_w[:, :4, :2] + sign * 10.0 ** (-4.0 + 3.0 * rand(n, 4, 2))
    mu = 0.5 + 0.5 * rand(n)
    p_w[0, :, 2] = radii                       # φ = 0: not in contact, re-anchor
    p_w[1, :, 2] = radii + 0.01                # airborne
    p_w[2:5, :, 2] = radii - 0.004             # pressed 4 mm
    v_w[2:5] = 0.0
    anchor[2] = p_w[2, :4, :2] + 1e-5          # deep inside the cone
    anchor[3] = p_w[3, :4, :2] + 0.05          # far outside: slides on the cone
    anchor[4] = p_w[4, :4, :2]                 # |f_trial| = 0
    anchor = anchor.contiguous()
    results = {}
    for clamp in (False, True):
        params = dyn.SimParams(friction=mu, clamp_damping=clamp)
        kernel = lambda: dyn.contact_forces(model, params, p_w, v_w, radii, anchor)
        twin = lambda: dyn.contact_forces_anchored_plain(
            radii - p_w[..., 2], v_w, p_w[:, :4, :2], anchor, mu,
            params.contact_stiffness, params.contact_damping, params.tangential_stiffness,
            params.tangential_damping, params.slip_vel_tol, clamp)
        got, want = kernel(), twin()
        torch.cuda.synchronize()
        inc, new = want[2][:, :4], want[3]
        slid = (new != anchor).any(-1)
        if (inc[:2].any() or not inc[2:5].all() or slid[2].any() or slid[4].any()
                or not slid[3].all() or not (inc & slid)[5:].any()
                or not (inc & ~slid)[5:].any()):
            raise AssertionError("anchored contact lanes not in the intended regimes")
        err = max(max_err(torch, g, w, f"contact_anchored clamp={clamp} {k}")
                  for g, w, k in zip(got, want, ("f_world", "fn", "in_contact",
                                                  "new_anchor")))
        results[clamp] = {"max_abs_err": err, "ms": cuda_time_ms(torch, kernel),
                          "plain_ms": cuda_time_ms(torch, twin)}
    return results


def reset_counts(act, dyn):
    act.actuation_torque.launches = 0
    dyn.contact_forces.launches = 0
    dyn.contact_forces.anchored_launches = 0


def read_counts(act, dyn):
    return {"actuation": act.actuation_torque.launches,
            "contact": dyn.contact_forces.launches,
            "contact_anchored": dyn.contact_forces.anchored_launches}


def check_counts(counts, want, phase):
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"phase {phase}: {name} launched {counts[name]} times, "
                                 f"expected {n}")


def count_syncs(torch, fn):
    """Host synchronisations made by fn(), as torch's sync debug mode
    reports them, and the source lines that made them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{w.filename.split('/')[-1]}:{w.lineno}" for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    return len(where), sorted(set(where))


def run_env_bench(torch, env_bench, act, dyn, rnd, spatial, kind):
    """Phase 6: the environment rollout at full width."""
    drift = {}

    def feet_xy(s):
        return dyn.foot_state_world(rnd.model_from_params(s.scenario), s.robot)[0][..., :2]

    def on_segment(i, before, after):
        drift[i] = (feet_xy(after) - feet_xy(before)).norm(dim=-1).max()

    reset_counts(act, dyn)
    rec = env_bench.run(batch=ENVS, steps=ENV_STEPS, segments=ENV_SEGMENTS,
                        settle=ENV_SETTLE, device="cuda", on_segment=on_segment)
    torch.cuda.synchronize()
    counts = read_counts(act, dyn)
    substeps = ENV_SETTLE + (1 + ENV_SEGMENTS) * ENV_STEPS * 10
    check_counts(counts, {"actuation": substeps, "contact_anchored": substeps,
                          "contact": 1}, 6)
    r = rec["reset_state"]
    z = r.robot.pos[:, 2]
    if not (bool(((z > 0.25) & (z < 0.36)).all()) and bool(r.feet_in_contact.all())
            and not bool(r.invalid_contact.any())):
        raise AssertionError(f"phase 6: not every environment stands after reset: "
                             f"height in [{float(z.min()):.4f}, {float(z.max()):.4f}]")
    s = rec["state"]
    fields = [getattr(s.robot, f) for f in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")]
    if not all(bool(torch.isfinite(t).all()) for t in fields):
        raise AssertionError("phase 6: non-finite robot state")
    z = s.robot.pos[:, 2]
    up = spatial.quat_to_mat(s.robot.quat)[:, 2, 2]
    if not (bool(((z > 0.25) & (z < 0.4)).all()) and bool((up > 0.95).all())
            and not bool(s.invalid_contact.any())):
        raise AssertionError("phase 6: an environment holding the init action did not "
                             "stay upright")
    creep = max(float(drift[i]) for i in range(1, 1 + ENV_SEGMENTS))
    if creep > CREEP_BOUND:
        raise AssertionError(f"phase 6: a foot drifted {creep} m in a segment "
                             f"(bound {CREEP_BOUND})")
    env, gen = rec["env"], torch.Generator("cuda").manual_seed(2)
    actions = env.get_init_action().expand(ENVS, -1)
    step_syncs, step_where = count_syncs(torch, lambda: env.step(s, actions, gen))
    small = env_bench.QuadrupedEnv(env_bench.bench_config(10), device="cuda")
    reset_syncs, reset_where = count_syncs(torch, lambda: small.reset(gen, 8))
    breakdown = env_bench.profile_steps(env, s, actions, gen, steps=3)
    print(f"phase 6: {ENVS} environments settled in {rec['reset_s']:.2f} s (height "
          f"{float(r.robot.pos[:, 2].min()):.4f}-{float(r.robot.pos[:, 2].max()):.4f} m, all "
          f"feet in contact); {ENV_SEGMENTS} segments of {ENV_STEPS} steps: "
          f"{rec['sim_steps_per_s']:.1f} sim-steps/s, real-time factor "
          f"{rec['realtime_factor']:.1f}, segments {[round(t, 3) for t in rec['segment_s']]} s "
          f"on {kind}; max foot drift per segment {creep:.3e} m; launches {counts}; "
          f"host syncs: {step_syncs} per env.step {step_where}, {reset_syncs} per reset "
          f"{reset_where}", flush=True)
    print(json.dumps({"env_bench": {k: rec[k] for k in
                                    ("metric", "sim_steps_per_s", "realtime_factor")}}))
    print(json.dumps({"env_substep_breakdown": breakdown}))
    return counts, step_syncs


def run_landing_episode(torch, act, dyn, kind):
    """Phase 7: the examples/run_episode.py flow on a batch of environments."""
    from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv, select
    from quadruped_springs_tpu_torch.env.wrappers import LandingWrapper

    env = QuadrupedEnv(EnvConfig(enable_springs=True, motor_control_mode="PD",
                                 action_space_mode="SYMMETRIC", task_env="JUMPING_IN_PLACE",
                                 observation_space_mode="ARS_BASIC",
                                 env_randomizer_mode="GROUND_RANDOMIZER",
                                 max_ep_len=EPISODE_LEN), device="cuda")
    steps = [0]
    env_step = env.step

    def counted_step(*a, **k):
        steps[0] += 1
        return env_step(*a, **k)

    env.step = counted_step
    wrapper = LandingWrapper(env)
    gen = torch.Generator("cuda").manual_seed(1)
    crouch = torch.tensor([0.0, 0.4, -0.8, 0.0, 0.4, -0.8], device="cuda")
    extend = torch.tensor([0.0, -0.4, 1.0, 0.0, -0.4, 1.0], device="cuda")
    reset_counts(act, dyn)
    t0 = time.perf_counter()
    state, _ = env.reset(gen, EPISODE_ENVS)
    done = torch.zeros(EPISODE_ENVS, dtype=torch.bool, device="cuda")
    max_h = torch.zeros(EPISODE_ENVS, device="cuda")
    for t in range(120):
        a = (crouch if t < 30 else extend).expand(EPISODE_ENVS, -1)
        out = wrapper.step(state, a, gen)
        # a finished episode keeps its last state, as run_episode.py stops there
        state = select(~done, out.state, state)
        max_h = torch.where(done, max_h, torch.maximum(max_h, out.max_height))
        done = done | out.done
        if bool(done.all()):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(act, dyn)
    substeps = env.config.settling_steps + 10 * steps[0]
    check_counts(counts, {"actuation": substeps, "contact_anchored": substeps,
                          "contact": 1}, 7)
    switched = state.task.switched_controller
    if not (bool((max_h > 0.2).all()) and bool(switched.all())):
        raise AssertionError(f"phase 7: max relative height {float(max_h.min()):.3f} m "
                             f"(need > 0.2), switched {int(switched.sum())}/{EPISODE_ENVS}")
    print(f"phase 7: {EPISODE_ENVS} landing-wrapper episodes ended after {t + 1} wrapper "
          f"steps ({steps[0]} env steps; host syncs: {wrapper.syncs} in the wrapper, "
          f"{t + 1} in this loop) in {wall:.2f} s (settle included) on "
          f"{kind}; max relative height {float(max_h.min()):.3f}-{float(max_h.max()):.3f} m, "
          f"all switched; final height {float(state.robot.pos[:, 2].min()):.3f}-"
          f"{float(state.robot.pos[:, 2].max()):.3f} m; launches {counts}", flush=True)
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card and has no CPU fallback")
    from quadruped_springs_tpu_torch import bench, env_bench, kernels
    from quadruped_springs_tpu_torch.env import randomizers as rnd
    from quadruped_springs_tpu_torch.env.wrappers import LANDING_KD, LANDING_KP
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.models import spatial
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
    model = prob.lane_params().model
    # checks[kernel][setting] = {max_abs_err, ms, plain_ms}; the first
    # setting of each kernel is the one its JSON line's times report
    planner_contact = check_contact(torch, dyn, model, LANES, 4000.0, 40.0)
    checks = {"actuation": {"planner": check_actuation(torch, act, prob, LANES)},
              "contact": {"planner": planner_contact[False],
                          "planner_clamp": planner_contact[True]}}
    report_checks(3, checks, LANES, "lanes")

    reset_counts(act, dyn)
    rec = bench.run(batch=BATCH, horizon=HORIZON, iterations=ITERATIONS,
                    samples=SAMPLES, runs=TIMED_RUNS, device="cuda")
    torch.cuda.synchronize()
    by_path = {"mppi_solve": read_counts(act, dyn)}
    launches = {k: by_path["mppi_solve"][k] for k in ("actuation", "contact")}
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
    check_counts(by_path["mppi_solve"], {"contact_anchored": 0}, 4)
    print(f"phase 4: {rec['solves']} full-width solves ran {substeps} planner substeps; "
          f"launches {launches}; mean final cost {mean_cost:.4f} "
          f"(band [{lo:.2f}, {hi:.2f}]); {rec['value']:.2f} solves/s on {kind}",
          flush=True)
    print(json.dumps({"bench": {k: rec[k] for k in
                                ("metric", "value", "unit", "mean_final_cost")}}))

    # the environment's shapes and constants: 1024 lanes, the motor and the
    # landing wrapper's gains with per-environment springs, and reset's
    # contact priming at the execution model's 180 kN/m with the clamp on
    env = env_bench.QuadrupedEnv(env_bench.bench_config(ENV_SETTLE), device="cuda")
    sim = env.sim_params
    landing = [torch.full((12,), g, device="cuda") for g in (LANDING_KP, LANDING_KD)]
    env_contact = check_contact(torch, dyn, model, ENVS, sim.contact_stiffness,
                                sim.contact_damping)
    anchored = check_anchored_contact(torch, dyn, model)
    env_checks = {"actuation": {"env": check_actuation(torch, act, env, ENVS),
                                "env_landing": check_actuation(torch, act, env, ENVS,
                                                               *landing)},
                  "contact": {"env_clamp": env_contact[True], "env": env_contact[False]},
                  "contact_anchored": {"env_clamp": anchored[True], "env": anchored[False]}}
    report_checks(5, env_checks, ENVS, "environments")
    for name, by_setting in env_checks.items():
        checks.setdefault(name, {}).update(by_setting)

    by_path["env_rollout"], step_syncs = run_env_bench(torch, env_bench, act, dyn, rnd,
                                                       spatial, kind)
    by_path["landing_episode"] = run_landing_episode(torch, act, dyn, kind)
    if step_syncs:
        raise AssertionError(f"env.step synchronised the host {step_syncs} times")

    # the contact_anchored kernel extends the memoryless contact kernel
    # (the TPU kernel fused_contact) with the feet's anchor stiction
    replaces = {"actuation": "scripts/pallas_microbench.py:96",
                "contact": "scripts/pallas_microbench.py:153",
                "contact_anchored": "scripts/pallas_microbench.py:153"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces[name],
         "launches": sum(c[name] for c in by_path.values()),
         "launches_by_path": {p: c[name] for p, c in by_path.items()},
         "max_abs_err": max(r["max_abs_err"] for r in by_setting.values()),
         "ms": next(iter(by_setting.values()))["ms"],
         "plain_ms": next(iter(by_setting.values()))["plain_ms"],
         "checks": by_setting}
        for name, by_setting in checks.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
