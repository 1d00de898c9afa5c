"""Launches, device time and wall time of the port's hot paths on the card.

    python tests/torch_path_profile.py [--root DIR] [--label NAME] [--headline]
        [--paths knot,substep,lin_block,control_step,env_bench,train,oracle,mppi_rollout,
                 full_rate,closed_loop,examples,ars_step,ppo_polish_step,ppo_finetune_step]

Imports quadruped_springs_tpu_torch from DIR (default: this checkout), so that
one call to the card can profile two commits in turn (an unpacked
`git archive` of the other one as DIR): parent, change, change, parent.
Prints one JSON line per path:
  * knot: one planner knot (MPCProblem.dynamics, the relaxed 200 Hz model, 2
    substeps) at 32,768 lanes: 1024 TEST_RANDOMIZER scenarios x 32 samples,
    the MPPI headline's shape;
  * substep: one environment substep at 1024 environments
    (env_bench.profile_steps over 3 control steps after a 600-substep settle);
  * lin_block: one block of the iLQR linearization: vmap over the 43 basis
    tangents of torch.func.jvp of the knot at 5,120 lanes (1024 problems x 5
    knots);
  * control_step: one QuadrupedEnv.step of 1024 settled environments
    (env_bench's configuration, the init action held): launches, device and
    wall time of the whole control step, whatever runs its physics;
  * env_bench: env_bench.run at 1024 environments (settle 600, one warm-up
    and one timed segment of 100 control steps): sim-steps/s;
  * train: train_bench.run(steps=1): seconds per ARS and PPO train_step;
  * oracle: one oracle replay (JUMPING_IN_PLACE with springs through
    utils/verification.verify_against_trace on one lane): seconds;
  * mppi_rollout: one rollout of the MPPI headline (1024 TEST_RANDOMIZER
    scenarios x 32 candidates, H = 50, drawn as MPPI's first iteration
    draws them) and one whole MPPI solve of the headline's configuration
    (10 iterations, fused accept): through MPCProblem.cost_rollout (the
    `planner_rollout_cost` kernel, the task cost summed in it) where the
    package has it, else MPCProblem.lane_rollout (the `planner_rollout`
    kernel), else the knot loop over MPCProblem.lane_dynamics that MPPI ran
    before either; launches and device time by class of kernel;
  * full_rate: bench.run's full-rate row (MPPI, H = 25, 10 substeps a knot
    at 180 kN/m) at full width, one warm-up and one timed solve, and one
    such solve profiled as mppi_solve is;
  * closed_loop: closed_loop.run at its defaults (40 knots), the iLQR and
    the full-rate MPPI loop: wall seconds and the executed apex;
  * examples: each run of quadruped_springs_tpu_torch.examples at its
    default size (example_episode, example_cpg, example_cartesian_jump,
    example_mpc, example_mpc_mppi, example_mpc_batch (--batch 4),
    example_backflip, example_quickstart: each also a path of its own), the
    planned comparison of each robot at one seed (compare_planned:
    compare_springs.planned_rows) and one iteration of the learned one
    (compare_learned, springs): one untraced run for the wall, one traced
    (the traced runs of the CPG's and the iLQR examples' millions of
    launches take minutes each);
  * ars_step, ppo_polish_step, ppo_finetune_step: one train_step of each
    trainer of the two-stage pipeline at the JAX widths: ARS on the sparse
    jump (train_two_stage.JUMP_ARS: 256 lanes x 110 control steps and the
    bank's settle), the BC-anchored polish on JUMPING_IN_PLACE_DEMO
    (two_stage.POLISH_PPO from a 300-iteration BC fit on the
    committed demos), the dense fine-tune through RestTruncationWrapper
    (two_stage.FINETUNE_PPO); each also with its env_substeps
    launches a step;
  * headline (--headline): bench.run's MPPI solve at full width, one warm-up
    and one timed solve.
--paths picks the paths (default: knot, substep, lin_block).
Device time and launches come from torch.profiler (kernels on the card, per
call); wall time from the host clock around torch.cuda.synchronize(),
untraced, the median over repeats. The kernel classes split the device time
by name: cuBLAS's gemm/gemv, the hand-written kernels, elementwise, the rest.
"""

import argparse
import json
import os
import statistics
import sys
import time

CLASSES = (("gemm/gemv", ("gemm", "gemv", "cublas")),
           ("planner_rollout", ("planner_rollout",)), ("mppi_update", ("mppi_update",)),
           ("hand kernels", ("actuation_kernel", "contact_kernel", "actuation_jvp",
                             "contact_jvp", "contact_anchored", "env_substeps")),
           ("draws", ("normal", "philox")),
           ("elementwise", ("elementwise",)), ("reduce", ("reduce",)),
           ("cat/copy", ("Cat", "copy")))


def profile(torch, fn, calls, reps=5):
    """fn() `calls` times per repeat: wall ms per call (median of reps,
    untraced) and, over one traced repeat, launches and device ms per call."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / calls)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launches, busy_us, classes, class_launches = 0, 0.0, {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        launches += e.count
        busy_us += us
        cls = next((c for c, pats in CLASSES if any(p in e.key for p in pats)), "other")
        classes[cls] = classes.get(cls, 0.0) + us / 1e3 / calls
        class_launches[cls] = class_launches.get(cls, 0) + e.count / calls
    wall = statistics.median(walls)
    device = busy_us / 1e3 / calls
    return {"launches": launches / calls, "device_ms": device, "wall_ms": wall,
            "device_busy_share": device / wall,
            "classes_ms": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
            "classes_launches": class_launches}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--headline", action="store_true")
    ap.add_argument("--paths", default="knot,substep,lin_block")
    a = ap.parse_args(argv)
    paths = set(a.paths.split(","))
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    from quadruped_springs_tpu_torch import bench, env_bench
    from quadruped_springs_tpu_torch.env import randomizers as rnd
    from quadruped_springs_tpu_torch.solver import ilqr
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    if not torch.cuda.is_available():
        raise SystemExit("torch_path_profile: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import quadruped_springs_tpu_torch as pkg
    head = {"label": a.label, "package": os.path.dirname(pkg.__file__),
            "device": torch.cuda.get_device_name(0)}
    emit = lambda path, rec: print(json.dumps({**head, "path": path, **rec}), flush=True)

    prob = MPCProblem(MPCConfig(), "cuda")
    scen = rnd.sample_scenario(prob.cfg, "TEST_RANDOMIZER",
                               torch.Generator("cuda").manual_seed(0), n=1024)
    x = prob.default_x0().expand(1024 * 32, -1).contiguous()
    u = prob.task_warm_start()[0].expand(1024 * 32, -1).contiguous()
    if "knot" in paths:
        with torch.no_grad():
            lanes = prob.lane_params(scen, 32)
            emit("knot", {"lanes": 1024 * 32, **profile(
                torch, lambda: prob.dynamics(x, u, lanes), calls=5)})

    if paths & {"substep", "control_step"}:
        env = env_bench.QuadrupedEnv(env_bench.bench_config(600), device="cuda")
        gen = torch.Generator("cuda").manual_seed(0)
        state, _ = env.reset(gen, 1024)
        actions = env.get_init_action().expand(1024, -1)
        if "substep" in paths:
            emit("substep", {"envs": 1024, **env_bench.profile_steps(env, state, actions, gen,
                                                                     steps=3)})
        if "control_step" in paths:
            emit("control_step", {"envs": 1024, **profile(
                torch, lambda: env.step(state, actions, gen), calls=5)})

    if "lin_block" in paths:
        lanes5 = prob.lane_params(scen, 5)
        z = torch.cat([x[:5120], u[:5120]], dim=-1)
        block = lambda: ilqr._basis_jvp(lambda z: prob.dynamics(z[:, :37], z[:, 37:], lanes5),
                                        z)
        emit("lin_block", {"lanes": 5120, "tangents": 43, **profile(torch, block, calls=1,
                                                                    reps=3),
                           "peak_gib": torch.cuda.max_memory_allocated() / 2**30})

    if "env_bench" in paths:
        rec = env_bench.run(batch=1024, steps=100, segments=1, settle=600, device="cuda")
        emit("env_bench", {k: rec[k] for k in ("sim_steps_per_s", "reset_s", "segment_s")})

    if "train" in paths:
        from quadruped_springs_tpu_torch import train_bench

        rec = train_bench.run(steps=1, device="cuda")
        emit("train", {algo: {k: rec[algo][k] for k in ("seconds_per_step", "env_steps_per_s")}
                       for algo in ("ars", "ppo")})

    if "oracle" in paths:
        from quadruped_springs_tpu_torch.utils import verification as V

        oracle_env = V.fidelity_env("JUMPING_IN_PLACE", True, device="cuda")
        t0 = time.perf_counter()
        report = V.verify_against_trace(oracle_env, os.path.join(
            a.root, "tests/data/oracle_jumping_in_place.qsts"),
            torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("oracle", {"seconds": time.perf_counter() - t0, "pass": report["pass"],
                        "steps": report["steps"]})

    if "mppi_rollout" in paths:
        from quadruped_springs_tpu_torch.solver import mppi

        gen = torch.Generator("cuda").manual_seed(0)
        x0 = prob.default_x0().expand(1024, -1).contiguous()
        eps = 0.3 * torch.randn((1024, 32, 50, prob.action_dim), generator=gen, device="cuda")
        us = torch.clamp(prob.task_warm_start()[None, None] + mppi._smooth_noise(eps), -1.0, 1.0)
        if hasattr(prob, "cost_rollout"):
            how, rollout_cost = "planner_rollout_cost", prob.cost_rollout(scen)
            rollout = lambda x0, us: rollout_cost(x0, us, None, False)
        elif hasattr(prob, "lane_rollout"):
            how, rollout = "planner_rollout", prob.lane_rollout(scen)
        else:
            how, f = "knot loop", prob.lane_dynamics(scen)

            def rollout(x0, us):
                x, xs = x0[:, None].expand(1024, 32, 37), [x0[:, None].expand(1024, 32, 37)]
                for t in range(us.shape[2]):
                    x = f(x, us[:, :, t])
                    xs.append(x)
                return torch.stack(xs, dim=2)

        with torch.no_grad():
            emit("mppi_rollout", {"rollout": how, "lanes": 1024 * 32, "horizon": 50, **profile(
                torch, lambda: rollout(x0, us), calls=1, reps=3)})
            mcfg = mppi.MPPIConfig(horizon=50, iterations=10, n_samples=32, fused_accept=True)
            u0 = prob.task_warm_start().expand(1024, -1, -1)
            emit("mppi_solve", {"rollout": how, "problems": 1024, **profile(
                torch, lambda: prob.solve_mppi(x0, u0, gen, mcfg, scen), calls=1, reps=2)})

    if "full_rate" in paths:
        from quadruped_springs_tpu_torch.solver import mppi

        rec = bench.run(batch=1024, runs=1, device="cuda", full_rate=True, horizon=25)
        emit("full_rate", {"solves_per_s": rec["value"],
                           "mean_final_cost": rec["mean_final_cost"]})
        fprob = MPCProblem(MPCConfig.full_rate(horizon=25), "cuda")
        gen = torch.Generator("cuda").manual_seed(0)
        fscen = rnd.sample_scenario(fprob.cfg, "TEST_RANDOMIZER", gen, n=1024)
        fx0 = fprob.default_x0().expand(1024, -1).contiguous()
        fu0 = fprob.task_warm_start().expand(1024, -1, -1)
        fcfg = mppi.MPPIConfig(horizon=25, iterations=10, n_samples=32, fused_accept=True)
        with torch.no_grad():
            emit("full_rate_solve", {"problems": 1024, "horizon": 25, **profile(
                torch, lambda: fprob.solve_mppi(fx0, fu0, gen, fcfg, fscen), calls=1, reps=2)})

    if "closed_loop" in paths:
        from quadruped_springs_tpu_torch import closed_loop

        for full_rate in (False, True):
            t0 = time.perf_counter()
            out = closed_loop.run(device="cuda", full_rate=full_rate)
            torch.cuda.synchronize()
            emit("closed_loop", {"solver": out["solver"], "knots": out["knots"],
                                 "seconds": time.perf_counter() - t0,
                                 "executed_apex_m": out["executed_apex_m"],
                                 "planned_apex_max_m": out["planned_apex_max_m"]})

    example_runs = {"example_episode": ("episode", {}), "example_cpg": ("cpg", {}),
                    "example_cartesian_jump": ("cartesian_jump", {}),
                    "example_mpc": ("mpc", {}), "example_mpc_mppi": ("mpc", {"mppi": True}),
                    "example_mpc_batch": ("mpc", {"batch": 4}),
                    "example_backflip": ("backflip", {}),
                    "example_quickstart": ("quickstart", {})}
    pick = lambda path: path in paths or "examples" in paths
    if any(pick(p) for p in (*example_runs, "compare_planned", "compare_learned")):
        from quadruped_springs_tpu_torch import compare_springs, examples

        for path, (run, kw) in example_runs.items():
            if pick(path):
                emit(path, profile(torch, lambda run=run, kw=kw: examples.RUNS[run](
                    device="cuda", **kw), calls=1, reps=1))
        for label, springs in compare_springs.CONFIGS.items():
            if pick("compare_planned"):
                emit(f"compare_planned_{label}", profile(
                    torch, lambda springs=springs: compare_springs.planned_rows(
                        springs, torch.device("cuda")), calls=1, reps=1))
        if pick("compare_learned"):
            emit("compare_learned_iteration", profile(
                torch, lambda: compare_springs.run_config(True, 1, 0, "cuda"), calls=1,
                reps=1))

    if paths & {"ars_step", "ppo_polish_step", "ppo_finetune_step"}:
        from quadruped_springs_tpu_torch import train_bench, train_two_stage as tts
        from quadruped_springs_tpu_torch.env import substeps as ss
        from quadruped_springs_tpu_torch.env.env import QuadrupedEnv
        from quadruped_springs_tpu_torch.env.wrappers import RestTruncationWrapper
        from quadruped_springs_tpu_torch.train import bc, two_stage
        from quadruped_springs_tpu_torch.train.ars import ARSTrainer
        from quadruped_springs_tpu_torch.train.ppo import PPOTrainer

        def substeps_per_call(fn):
            n = ss.env_substeps.launches
            fn()
            torch.cuda.synchronize()
            return ss.env_substeps.launches - n

        gen = torch.Generator("cuda").manual_seed(0)
        steps = {}
        if "ars_step" in paths:
            ars = ARSTrainer(QuadrupedEnv(tts.env_config("JUMPING_IN_PLACE", 1.0), device="cuda"),
                             tts.JUMP_ARS)
            ts = ars.init(gen)
            steps["ars_step"] = (lambda: ars.train_step(ts), {"lanes": 256, "control_steps": 110})
        if "ppo_polish_step" in paths:
            trainer, obs, acts = train_bench.imitation_trainer("cuda")
            net, norm, _ = bc.fit(trainer.make_net(two_stage.BC_SEED), obs, acts, iters=300,
                                  log_std=two_stage.BC_LOG_STD)
            ps = train_bench.imitation_state(trainer, obs, acts, net, norm, gen)
            steps["ppo_polish_step"] = (lambda: trainer.train_step(ps),
                                        {"lanes": 32, "control_steps": 64})
        if "ppo_finetune_step" in paths:
            ft = PPOTrainer(RestTruncationWrapper(QuadrupedEnv(
                tts.env_config("JUMPING_IN_PLACE_PPO", 2.0), device="cuda")), two_stage.FINETUNE_PPO)
            fs = ft.init(gen)
            steps["ppo_finetune_step"] = (lambda: ft.train_step(fs),
                                          {"lanes": 32, "control_steps": 64})
        for path, (fn, shape) in steps.items():
            emit(path, {**shape, "env_substeps": substeps_per_call(fn),
                        **profile(torch, fn, calls=1, reps=2)})

    if a.headline:
        rec = bench.run(batch=1024, runs=1, device="cuda")
        emit("headline", {"solves_per_s": rec["value"],
                          "mean_final_cost": rec["mean_final_cost"]})


if __name__ == "__main__":
    main()
