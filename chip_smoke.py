#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):
  1. require a CUDA card (no CPU fallback); print its name and power limit;
  2. build the hand-written kernels of quadruped_springs_tpu_torch/csrc from
     the checkout (one nvcc per .cu, all at once) and print the build time
     and the registers and spills of env_substeps_kernel and
     planner_rollout_kernel (nvcc -Xptxas -v): neither may spill; and what
     the card makes of planner_rollout_kernel at its paths' R (its
     registers, the problems' staged models in shared memory, its warps an
     SM: solver/rollout.py occupancy);
  3. hold each kernel against its plain PyTorch twin on the card at the
     planner's shape (32,768 lanes), on seeded inputs plus hand-placed edge
     cases, to |kernel - twin| <= 1e-5·(1 + |twin|) (FMA contraction is the
     only expected difference), and time both with CUDA events; the bf16
     variants of `actuation` and `contact` (the latter at the relaxed
     model's constants and at the bf16 full-rate knot's 180,224 N/m) against
     their plain versions (the f32 twin on the upcast inputs, rounded) to
     that bound plus one bf16 ulp of |twin|;
  4. drive the port's headline solve (quadruped_springs_tpu_torch.bench at
     full width: 1024 scenarios x 32 samples, H=50, 10 iterations, fused
     accept), check that every final cost is finite and that the mean lies
     within 3% of the JAX reference's -70.98 (printed beside the parent
     commit's -71.2030, which this tree holds bitwise), and that
     `planner_rollout_cost` launched once per rollout and `mppi_update`
     once before each (11 of each per solve: `iterations` + 1 with fused
     accept), the xs-only `planner_rollout`, `actuation` and `contact`
     never; print bench.py's eight-key line; then the full-rate row (bench
     --full-rate --horizon 25 at the same width, 10 substeps per knot at
     180 kN/m): finite costs, the mean final cost within 3% of JAX's
     FULL_RATE_REFERENCE_COST (beside the parent's -64.2740), 11 launches
     of each per solve;
  5. hold every kernel of the environment's path against its twin at the
     environment's shapes and constants, to the bound of phase 3, and time
     both: the anchored contact kernel at 1024 environments x 12 sites
     (seeded inputs plus hand-placed lanes: out of contact, φ = 0, inside
     the friction cone, on its boundary, |f_trial| = 0), with the damping
     clamp on and off; `actuation` at 1024 lanes with per-environment
     springs, under the motor gains and the landing wrapper's (kp 60,
     kd 1.5); the memoryless `contact` of reset's contact priming at 1024
     x 12 sites with the execution model's 180 kN/m and 100 N s/m, clamp on
     and off; then the fused `env_substeps` (a control step's physics in one
     launch) against its plain version env_substeps_plain: 1,024 settled
     environments x 10 substeps with every 8th lane in flight, on the
     friction cone's boundary (anchors 5 cm off) and pushed at the trunk,
     the command interpolated over the substeps; the same in TORQUE mode
     and on the rack; 64 of them under the landing gains; each within
     REL_TOL·(1+|plain|) + ENV_SPREAD x the plain version's own spread under
     a one-ulp change of its start; rows 0-7 bitwise equal at 1,024, 8 and
     2 environments;
  6. drive the environment rollout bench (quadruped_springs_tpu_torch.
     env_bench: 1024 environments, settle 600 substeps, one warm-up and
     ENV_SEGMENTS timed segments of T control steps x 10 substeps holding the init
     action): every environment stands after reset (height in (0.25, 0.36),
     four feet in contact, no other site) and stays upright and finite,
     no foot drifts more than CREEP_BOUND in world xy over a timed segment,
     `env_substeps` launches once for the settle and once per control step
     (`actuation` and `contact_anchored` never), and env.step makes no host
     sync;
  7. the examples/run_episode.py flow through LandingWrapper on 64
     GROUND_RANDOMIZER environments (default 2500-substep settle, crouch
     30 steps, then extend for up to 120): every environment jumps higher
     than 0.2 m and switches to its landing controller;
  8. hold the two tangent kernels (`actuation_jvp`, `contact_jvp`) and
     their bf16 variants against torch.func.jvp of the plain versions at the
     shape of one block of the iLQR linearization (5,120 lanes, T = 43
     tangent directions), on seeded inputs plus hand-placed lanes on both
     sides of every branch, to the bound of phase 3 widened by CANCEL_TOL x
     the magnitude of the terms a tangent sums (they cancel; bf16: plus one
     bf16 ulp), `contact_jvp` with the damping clamp off and on, and time
     them; time an empty kernel (the card's launch floor);
  9. the 37x43 Jacobians of one planner knot at 64 states of a rollout
     (stance, push-off, flight), through the kernels on the card and through
     the plain versions on the CPU, to JAC_TOL of each knot's max |J|;
 10. drive both full-width iLQR rows (quadruped_springs_tpu_torch.bench
     --ilqr: 1024 scenarios, H=50, 10 iterations, 8 line-search candidates):
     --exact (float32 Jacobians every iteration) and the default (Jacobians
     of the bf16 knot, relinearized every 3rd iteration). Each: every final
     cost finite, every problem's cost trace non-increasing, the mean final
     cost at least ILQR_MARGIN below the warm start's mean cost, each kernel
     launched exactly as often as the solve's substeps say (the bf16 row's
     linearization through the four bf16 variants); the exact row makes no
     host sync in a full-width rollout plus iteration; print solves/s, the
     seconds per stage and the bf16 row's gap to the exact row's cost;
 11. closed-loop MPC (quadruped_springs_tpu_torch.closed_loop) at the JAX
     loop's defaults, LOOP_KNOTS knots, a solve every LOOP_REPLAN, executed
     by closed_loop.execute_knot (the JAX loop's 1 kHz executor, one
     planner_rollout launch per knot): iLQR on the relaxed model, then MPPI
     on the execution-rate model (--full-rate); each finite, airborne at
     some knot, launches exact;
 12. after every timed path (the profiler stays attached to the process once
     it has run): torch.profiler's time of each kernel on the card alone
     (`device_ms`, beside the CUDA-event time of a call through its Python
     wrapper) at every shape of phases 3, 5 and 8, and the breakdown of one
     environment substep (launches, device busy share, kernel classes);
     then one headline MPPI solve as bench solves it (its scenarios'
     models packed once): its launches on the card (fails at
     MAX_SOLVE_LAUNCHES or more) and card time by class of kernel, and the
     same solve with the models packed in it (PR 9 counted 3,831);
 13. hold `actuation`, `contact` and `contact_anchored` against their twins
     at every lane count the learning stack launches them at (8, 16, 32, 64
     and 256 lanes: 8 and 32 end in a partial thread block), with each path's
     task interface, the motor and the landing gains, the clamp on and off;
     then replay the committed policies (quadruped_springs_tpu_torch.
     policy_replay) on REPLAY_LANES lanes each, held to the bars of the JAX
     package's closed-loop gates: the backflip launch policy (full rotation
     and upright in the gate's scenario, lane 0, and in every lane whose
     friction is at or above policy_replay.UPRIGHT_FRICTION_EDGE; below it the
     policy falls over in the JAX package too, and those lanes are counted),
     the robust launch + landing
     pair (every nominal lane must pass; the TEST_RANDOMIZER lanes with
     observation noise are counted), forward_ars, the two-stage flip policy
     through the flattened autopilot, the continuous-jumping policy over 410
     steps; `env_substeps` launches once per settle and per env step of
     each replay, `contact` once per reset, `actuation` and
     `contact_anchored` never; and `env_substeps` against its plain version
     at the two-stage trainers' widths and interfaces (TWO_STAGE_WIDTHS:
     2-256 lanes, the BACKFLIP interface's commands) and at the behaviour
     trainers' (BEHAVIOUR_WIDTHS: 4-768 lanes and the touchdown bank's
     first chunk, the BACKFLIP interface under TEST_RANDOMIZER), to phase
     5's bound;
 14. two ARSTrainer.train_steps and two PPOTrainer.train_steps (one untimed
     warm-up, one timed) at the widths of the JAX package's training runs
     (quadruped_springs_tpu_torch.train_bench), and two of the imitation
     stage's (the BC-anchored polish on JUMPING_IN_PLACE_DEMO from the
     committed demos, after one timed bc.fit of 3,000 iterations): every
     metric finite; every PPO step changed the actor (the polish's kept its
     frozen statistics); every ARS step rolled live steps and changed
     W unless its top returns were all equal (the update is then 0 by the
     algorithm); the observation statistics grew by the live steps; launches
     exact (one env_substeps per settle and per control step); the host
     syncs of each step printed (the last of each must make none);
 15. one ContinuousAutopilotEnv.step and one flattened backflip episode
     with torch.cuda.set_sync_debug_mode("error"): no read on the host;
 16. first `actuation`, `contact` and `contact_anchored` against their twins
     launched on 1 and 2 lanes (12 and 24 threads) with fidelity_env's
     constants (motor gains with springs and without, 180 kN/m, the clamp on
     and off), and `env_substeps` at one lane against its plain version (a
     control step; the oracle replay's 2,500-substep settle; the CPG
     example's single TORQUE substep on the rigid robot); then the
     oracle-trace gate: the six committed traces
     tests/data/oracle_*.qsts through the port's
     utils/verification.verify_against_trace at their real size (the
     fidelity env, the 2,500-substep settle, 170 control steps), one lane
     each, held to the assertions of tests/test_golden_trace.py. The six
     replays are bound by the host's launches, so they run at once, one
     spawned process each, on the one card; launches exact per trace;
 17. first `actuation_jvp` and `contact_jvp` (clamp on and off) against
     torch.func.jvp of their twins at the transfer gate's linearization
     block (one problem, all 50 knots: 50 lanes x 43 tangents, a partial
     thread block), to the bound of phase 8; then the open-loop transfer
     gate of tests/test_transfer.py: one MPPI and one iLQR plan (H=50, 10
     iterations) on the relaxed model from the settled fidelity env,
     executed as two lanes of one record_golden_trace: planned and executed
     apexes above 0.45 m and within 25%, upright; launches exact;
 18. scale-out at world size 1: init_distributed (NCCL), sharded_solve of
     SHARDED_BATCH BACKFLIP TEST_RANDOMIZER scenarios (H=50, 10 iterations,
     8 alphas) inside profiling.annotate, checked with sanitize.finite_mask:
     0 diverged, finite costs, no scenario above its warm start's cost, the
     mean cost SHARDED_MARGIN below the warm start's, launches exact,
     solves/s printed; then the first GAP_ROWS scenarios solved again as one
     batch and as batches of GAP_BLOCK (one spawned process each: host-bound
     small solves), their cost traces non-increasing, and once more with the
     last row's start NaN, which must leave the other rows bitwise as they
     were; rows 0-GAP_ROWS-1 must be bitwise equal across
     the 1,024-row sharded solve, the 8-row solve and the 2-row solves
     (costs, us, cost traces), and every stage of the per-stage probe (the
     knot, the line search's knot, the knot's 43 tangents, the cost
     derivatives, the backward sweep, its Cholesky solve, the line search's
     feedback) must read 0 at 1,024 and 8 rows against 2; then the
     headline's MPPI solve (GAP_MPPI_ITERATIONS iterations) with its draws
     given, rows 0-GAP_ROWS-1 bitwise equal at 1,024, 8 and 2 rows (costs,
     us, states, cost traces), and the same for the full-rate row's MPPI
     solve (H=25, 10 substeps at 180 kN/m, the clamp on) and, at 64, 8 and 2
     rows, for the planned comparison's solve of each robot (K=64 without
     the fused accept, phase 21's batch and the entry point's); then
     sharded_lqt_backward on the Go1 sizes (H=50, n=37, m=6) against
     riccati_sequential and _parallel_lqt_backward at the tolerances of
     tests/test_riccati_sharded.py;
 19. (after phase 3) hold `planner_rollout` against planner_rollout_plain
     at its paths' shapes: the headline's rollout (1024 TEST_RANDOMIZER
     problems x 32 candidates, H=50, 2 relaxed substeps, every 8th problem
     in flight, every 8th on friction 0.3), the full-rate row's (H=25, 10
     substeps at 180 kN/m, clamp on), the executor's (1 lane, H=1, 10
     substeps) and the springs-vs-rigid comparison's (PLANNED_SOLVES problems
     x PLANNED_SAMPLES candidates and x 1, H=50, relaxed, on the nominal row
     of the PEA robot and of the rigid one; for the quantile gate its
     launches pooled over draws to COMPARE_POOLED_LANES lanes): the kernel
     as close to the plain version run in float64 as
     the plain version is (ROLLOUT_QUANTILES over the lanes, per field, knot
     and on the lanes' costs, within ROLLOUT_DIST), env_substeps's per-lane spread
     rule held on every lane at knot 1 (the executor at every knot) and
     counted past it; one knot from the plain version's state at each of the
     headline's 1.6 M knot-lanes, lane by lane against the float64 knot
     (ONE_KNOT_FAR, ONE_KNOT_TAIL); rows 0-7 bitwise at 1,024, 8
     and 2 problems; the kernel's map of a block's lanes to the problems
     whose models it stages (ROLLOUT_MAP_SHAPES: every problem's rows bitwise
     those of the problem launched alone, knot 1 within the spread rule);
     time both with CUDA events and (phase 12) the profiler, and print the
     kernel's time on the card, its share of the bound and its warps an SM
     at the headline and full-rate widths;
 20. (with the host-bound runs) the three MPC behaviours of
     quadruped_springs_tpu_torch.mpc_behaviours at the JAX examples' full
     configurations over seeds 0-7 (jumping forward 0-63: BEHAVIOUR_JOBS),
     each seed held to the JAX gates' bars and each driver to the JAX
     package's pass count over the same seeds (JAX_PASSES, less SHARE_SLACK
     for jumping forward; the backflip on the JAX example's ground of each
     seed, its run on the port's own draw reported);
     launches exact (planner_rollout once per rollout);
 21. (with the host-bound runs) the planned springs-vs-rigid comparison
     (quadruped_springs_tpu_torch.compare_springs.planned_rows at
     scripts/compare_springs.py's configuration) for both robots over
     PLANNED_SEEDS, the 8 solves of every seed as one batch of 64 rows
     (bitwise those of the entry point's batch of 8: phase 18): every row
     finite, the peak motor torque at the 33.55 N m limit on every row,
     springs' executed apex above rigid's at no fewer seeds than the JAX
     package's count less PLANNED_SLACK (JAX_PLANNED; tests/test_artifacts.py's
     three bars together counted and printed beside the JAX package's, not
     gated), seed 1's rows printed in the script's JSON beside the committed
     1.142 / 0.801 m;
     launches exact;
 22. (with the host-bound runs) the learned comparison
     (compare_springs.run_config, its ARS configuration) cut to LEARNED_ITERS
     iterations, one process a robot: metrics and W finite, W changed by
     every iteration whose top returns do not tie, the springs' evaluation
     apex at LEARNED_APEX within them, launches exact; the evaluation
     apexes printed beside the JAX curve's;
 23. first `actuation`, `contact` and their tangents against their twins at
     the iLQR examples' widths (EXAMPLE_ILQR); then (with the host-bound
     runs) every run of quadruped_springs_tpu_torch.examples at its default
     size (EXAMPLE_JOBS: episode, cpg, cartesian_jump, mpc, mpc --mppi, mpc
     --batch 4, backflip, quickstart), each held to its example's bars
     (example_passed), launches exact;
 24. (with the host-bound runs) the two-stage trainers
     (quadruped_springs_tpu_torch.train_two_stage --task in_place and
     forward, train_two_stage_backflip) at their --smoke budgets, one
     process each: every number of the results finite, their key set the
     JAX script's (TWO_STAGE_JOBS), the no-op flags consistent with their
     gates and the warm-start stage with the polish's flag; no learning
     bar; launches exact, env_substeps launched; each stage's seconds
     printed;
 25. (with the host-bound runs) the behaviour trainers at smoke budgets,
     one process each (BEHAVIOUR_TRAINERS: train_behavior_policies --task
     backflip, --robust and --task forward, train_backflip_landing_mlp and
     train_backflip_robust_joint from the committed lander at their full
     runs' ARS widths, 768 and 512 lanes,
     validate_backflip_robust --n 4 on the committed pair): every npz's
     key set the JAX artifact's, every number finite, launches exact,
     env_substeps launched, the committed pair's full rotation on all of
     its 4 seeds; and the observation-noise repair on the card: ARS's r+
     and r− bitwise equal per bank entry at δ = 0 on the noisy forward task
     at its 256 lanes, and one candidate's flattened-flip score bitwise the
     same alone as among 32;
 26. the env step's reverse mode: right after phase 5, `env_substeps_vjp`
     against autograd through env_substeps_plain on the card, on seeded
     cotangents of every float output, at BPTT's width (BPTT_STATES
     touchdown states of the lander's bank, BACKFLIP, TEST_RANDOMIZER),
     phase 5's 1,024 x 10 (command interpolated with every 8th lane pushed,
     held, TORQUE, on the rack, at the edges: lanes past their joint
     limits, on the trunk's corners, on the knees) and
     one environment: within phase 5's spread rule, by
     env/substeps.py check_vjp, where an environment outside it passes only
     within the same rule against the plain version taken along the
     kernel's own substep starts (those at a kink, a branch taken apart by
     the two forwards, are counted); rows 0-7 bitwise at
     1,024, 8 and 2 environments; env_substeps's outputs bitwise with and
     without requires_grad, autograd's backward one env_substeps_vjp launch
     giving its cotangents bitwise; then (with the host-bound runs)
     train_backflip_landing_mlp --optimizer bptt at its smoke budgets
     (BEHAVIOUR_TRAINERS["landing_bptt"]): losses and gradient norms
     finite, one env_substeps_vjp launch per control step of its
     iterations, the npz's key set the JAX artifact's.
 27. (with the host-bound runs) the learned continuous-jumping trainer,
     train_continuous_policy --smoke through its main (1.5 s episodes, 3
     ARS, 1 warm-up and 2 PPO iterations): every number of the results
     finite, their key set the committed JAX artifact's (each seed's entry
     with task_terminated and timeout in place of crashed), env_substeps
     once a control step and settle and contact once a reset (EnvCalls),
     every other kernel never, nothing written (neither under examples/
     nor its --out); and render_backflip's record mode at seed 0 through
     its main: a finite trace whose controller switched, its steps and
     maximum unwrapped pitch printed beside the JAX script's at its own
     seed 0 on the CPU (JAX_RENDER).
 28. (right after phase 19) the rest of the MPPI iteration: at every width
     an MPPI path launches (mppi_widths: the headline 1,024 x 32 x 50, the
     full-rate row x 25, the behaviours 1 x 64 x 30 / 1 x 64 x 24 / 1 x 32
     x 40, the comparison 8 x 64 x 50 without the fused accept, the
     full-rate loop 1 x 32 x 25 and the MPPI example 1 x 32 x 25) a
     solve's launches of `mppi_update` each against mppi_update_plain on
     the same inputs and of `planner_rollout_cost` against the plain cost
     (rollout.total_cost over make_cost) of its own states: bitwise, its
     states bitwise the xs-only `planner_rollout`'s, its costs without
     states the same; both kernels timed at the headline and full-rate
     widths against their plain versions and bounds; the cost
     instantiation's registers, local memory, shared memory and warps an
     SM (phase 2 prints both instantiations' and fails unless the xs-only
     one keeps 128 registers and 16 warps an SM).
Phase 11 also holds both loops to the transfer band of the JAX gate
(executed apex > 0.45 m, upright, within LOOP_BAND of the largest planned
apex; the JAX package's own loops meet 10% on the CPU).
Cuts of depth, against the first form of this script: phase 4 times 1
solve (was 3). Phase 6's 3 segments and phase 7's 2,500-substep settle,
cut while the environment ran ~500 launches a substep, are back since its
physics is one env_substeps launch a control step. The host-bound runs of phases 11, 13, 16 and 17
(the two loops, the six replays, the six oracle traces, the transfer gate),
phase 20's three drivers, phases 21-23's comparisons and examples and phases
24-25's and 27's trainers and the recorder go at once in HOST_PROCESSES spawned processes
on the one card, after the
kernel checks of phases 13, 16 and 17, and phase 18's six small solves one
process each. Phases 13-18 run before phase 12 (the profiler's). Most phases are bound by
the host's launches, so fewer lanes would save nothing; PERF.md section 5
gives each phase's time on the card.
The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import math
import multiprocessing
import re
import statistics
import subprocess
import sys
import time
import warnings

REFERENCE_COST = -70.98          # JAX MPPI headline mean final cost (BENCH_r05.json)
# JAX's mean final cost of the full-rate row (`python bench.py --cpu
# --full-rate --horizon 25 --batch 256`: 1,888 s on an 8-core CPU shared with
# other jobs; at the bench's 1024 scenarios the run would take about two
# hours there, so it was taken at 256)
FULL_RATE_REFERENCE_COST, FULL_RATE_HORIZON = -63.96, 25
COST_BAND = 0.03                 # ±3%: the bf16-sample path's -66.7 falls outside
BATCH, SAMPLES, HORIZON, ITERATIONS = 1024, 32, 50, 10
TIMED_RUNS = 1
LANES = BATCH * SAMPLES
REL_TOL = 1e-5
CANCEL_TOL = 1e-6                # ~8 ulp of f32, relative to cancelling terms
SOURCE = "quadruped_springs_tpu_torch/csrc/planner_ops.cu"
ENV_SOURCE = "quadruped_springs_tpu_torch/csrc/env_step.cu"
ROLLOUT_SOURCE = "quadruped_springs_tpu_torch/csrc/planner_rollout.cu"
MPPI_UPDATE_SOURCE = "quadruped_springs_tpu_torch/csrc/mppi_update.cu"
MPPI_UPDATE_REPLACES = "quadruped_springs_tpu/solver/mppi.py:141-183"
ENVS, ENV_STEPS, ENV_SEGMENTS, ENV_SETTLE = 1024, 100, 3, 600
# The anchor springs hold a static stance with ~1 mm of spring travel
# (quadruped_springs_tpu/models/dynamics.py:71-78); a stance held by them
# moves far less than that in a second, while the memoryless friction it
# replaced crept ~4 cm/s. 1 mm per 1 s segment separates the two 40-fold.
CREEP_BOUND = 1e-3
EPISODE_ENVS, EPISODE_LEN = 64, 3.0   # episode cut to 3 s (the jump ends by ~1 s)
# the settle before the episodes: the env's default 2,500 substeps (one
# env_substeps launch)
EPISODE_SETTLE = 2500
N_TANGENTS = 43                  # n + m basis tangents of the linearization
ILQR_ALPHAS, ILQR_TIMED_RUNS = 8, 1
JAC_STATES = 64
# card against CPU, relative to each knot's max |J|: FMA contraction and
# cuBLAS's summation order in f32, through two substeps of stiff contact
JAC_TOL = 3e-5
# least drop of the mean cost below the warm start's: the first run on an
# NVIDIA H100 80GB HBM3 (700 W) dropped it by ILQR_FIRST_DROP
ILQR_FIRST_DROP = 46.1808        # -17.7552 -> -63.9360
ILQR_MARGIN = 40.0
# the JAX loop's defaults (examples/run_closed_loop_mpc.py): 40 knots, a
# solve every 5; the band of tests/test_transfer.py's closed-loop gate on
# the executed against the largest planned apex, for both loops
LOOP_KNOTS, LOOP_REPLAN = 40, 5
LOOP_BAND = 0.10
REPLAY_LANES = 64
TRAIN_STEPS = 1                  # timed train_steps per trainer, after train_bench's warm-up
# lane counts at which the learning stack launches the env's kernels, and the
# task whose interface each path runs: the replays and adapters, the ARS
# bank's settle and rollout, the PPO bank's settle and segment
LEARNING_WIDTHS = {"replay": (64, "BACKFLIP"), "replay_forward": (64, "JUMPING_FORWARD"),
                   "ars_bank": (8, "JUMPING_IN_PLACE"), "ars": (256, "JUMPING_IN_PLACE"),
                   "ppo_bank": (16, "JUMPING_IN_PLACE_PPO"),
                   "ppo": (32, "JUMPING_IN_PLACE_PPO")}
ADAPTER_LANES, ADAPTER_KNOTS = 64, 20
# phase 13 holds env_substeps at the two-stage trainers' widths (lanes, the
# task whose interface turns actions into commands): the PPO segments (32;
# the *_DEMO and *_PPO tasks share the JUMPING_* interface, and the task
# changes nothing else the kernel reads), the landing and the jump ARS
# rollouts (128, 256), the dense probe and the wide evaluation (16), the demo
# evaluation (8), the jump demos (6), ARS's evaluation (4); the flip's demos
# (12), probe (8) and nominal gate (2) under the BACKFLIP interface, whose
# raised rear-thigh limits change the commands. Their settles (600 substeps
# at these widths) run the kernel's settle path, held at 1 x 2,500 in phase 16
TWO_STAGE_WIDTHS = {"ppo_segment": (32, "JUMPING_IN_PLACE"), "ars_land": (128, "JUMPING_IN_PLACE"),
                    "ars_jump": (256, "JUMPING_IN_PLACE"), "probe": (16, "JUMPING_IN_PLACE"),
                    "demo_eval": (8, "JUMPING_IN_PLACE"), "jump_demos": (6, "JUMPING_IN_PLACE"),
                    "ars_eval": (4, "JUMPING_IN_PLACE"), "flip_demos": (12, "BACKFLIP"),
                    "flip_probe": (8, "BACKFLIP"), "flip_nominal": (2, "BACKFLIP")}
# phase 13 also holds env_substeps at the behaviour trainers' widths, the
# BACKFLIP interface under TEST_RANDOMIZER: the flip's evaluation (4), the
# landing probe (10), the held-out seeds (12), ARS's ± episodes (24), the joint
# trainer's training scenarios (64), the landing bank's training split (72),
# the joint (512) and landing (768) ARS batches, the bank's first chunk (192)
BEHAVIOUR_WIDTHS = {"flip_eval": (4, "BACKFLIP"), "landing_probe": (10, "BACKFLIP"),
                    "held_out": (12, "BACKFLIP"), "flip_ars": (24, "BACKFLIP"),
                    "joint_train": (64, "BACKFLIP"), "landing_train": (72, "BACKFLIP"),
                    "bank_chunk": (192, "BACKFLIP"), "joint_ars": (512, "BACKFLIP"),
                    "landing_ars": (768, "BACKFLIP")}
# phase 25: the behaviour trainers at smoke budgets in the host-bound pool,
# each entry point's argv (besides --out) and the committed artifacts whose
# keys its npz files carry. Few iterations, a small bank and few probe
# seeds, but the lander's and the joint trainer's ARS batches at the widths
# of their full runs: 2 x 16 directions x 24 touchdown states = 768 lanes
# over a 100-step horizon (train-states at most 0.75 of the bank), and
# 2 x 16 x 16 scenarios = 512 lanes over 160 knots
BEHAVIOUR_TRAINERS = {
    "landing": ("train_backflip_landing_mlp",
                ["--iters", "1", "--bank", "32", "--train-states", "24", "--n-dir", "16",
                 "--probe-every", "1", "--n-probe", "2", "--horizon", "100",
                 "--no-save-gate"],
                {"backflip_landing_mlp.npz": "backflip_landing_mlp.npz"}),
    "robust": ("train_behavior_policies", ["--task", "backflip", "--robust", "--iters", "1"],
               {"backflip_ars_robust.npz": "backflip_ars.npz"}),
    "backflip": ("train_behavior_policies", ["--task", "backflip", "--iters", "1"],
                 {"backflip_ars.npz": "backflip_ars.npz"}),
    "joint": ("train_backflip_robust_joint",
              ["--iters", "1", "--n-train", "16", "--n-probe", "2", "--train-scen", "16",
               "--n-dir", "16", "--knots", "160", "--probe-every", "1", "--no-save-gate",
               "--lander-init", "examples/policies/backflip_landing_mlp.npz"],
              {"backflip_launch_robust.npz": "backflip_launch_robust.npz",
               "backflip_landing_mlp.npz": "backflip_landing_mlp.npz"}),
    "forward": ("train_behavior_policies", ["--task", "forward", "--iters", "1"],
                {"forward_ars.npz": "forward_ars.npz"}),
    "validate": ("validate_backflip_robust", ["--n", "4"], {}),
    # phase 26: the lander's --optimizer bptt at the smoke budgets
    "landing_bptt": ("train_backflip_landing_mlp",
                     ["--optimizer", "bptt", "--iters", "2", "--bank", "8", "--train-states",
                      "4", "--horizon", "20", "--probe-every", "1", "--n-probe", "2",
                      "--no-save-gate"],
                     {"backflip_landing_mlp.npz": "backflip_landing_mlp.npz"}),
}
REPAIR_KNOTS, REPAIR_CANDIDATES = 60, 32
# phase 24: the two-stage trainers at their --smoke budgets in the host-bound
# pool, the longest first, each results' key set held to the JAX artifact's
TWO_STAGE_JOBS = {"forward": "two_stage_forward_results.json",
                  "in_place": "two_stage_forward_results.json",
                  "backflip": "two_stage_backflip_results.json"}
# phase 27: the continuous-jumping trainer's committed JAX artifact (its key
# set) and the JAX script examples/render_backflip.py at its seed 0 on the
# CPU (`python examples/render_backflip.py --cpu --out <dir>/backflip.gif`,
# jax 0.9.0): 118 steps recorded, a maximum unwrapped pitch of 360 deg. The
# port's seed 0 draws another scenario, so its numbers are printed beside
# these, not held to them.
CONTINUOUS_RESULTS = "examples/out/continuous_policy_results.json"
JAX_RENDER = {"steps": 118, "max_pitch_deg": 360}
# phase 16 and 17 run the environment's kernels at 1 and 2 lanes; their
# checks build the hand-placed regimes on SMALL_INPUT_LANES lanes
FIDELITY_LANES, SMALL_INPUT_LANES = (1, 2), 8
# phases 11, 13, 16, 17, 20-25 and 27 run their host-bound paths in this many processes
HOST_PROCESSES = 8
# phase 21: the planned springs-vs-rigid comparison (compare_springs.planned_rows,
# scripts/compare_springs.py's configuration) over PLANNED_SEEDS, seed 1 the
# entry point's default. The JAX script's executed apexes are chaotic in its
# draws: on the CPU (`python tests/torch_compare_springs_probe.py --jax-keys 1
# 2 3 4 5 6 7 8`) springs land above rigid at 7 of its keys 1-8 (mean gain
# +0.1296 m) and meet all of tests/test_artifacts.py's mechanical bars at 2
# (keys 4 and 7; not at key 1, whose committed TPU run did). The port is held
# to the count above rigid less PLANNED_SLACK, tests/test_torch_transfer_share.py's
# rule (two binomial standard deviations at the JAX miss rate, rounded up).
PLANNED_SEEDS = tuple(range(1, 9))
# phase 19 holds the comparison's rollouts to the quantile gate over this many
# lanes: its launches of PLANNED_SOLVES problems pooled over draws
# (compare_rollout_gate)
COMPARE_POOLED_LANES = 16384
PLANNED_SOLVES, PLANNED_SAMPLES, PLANNED_ITERATIONS = 8, 64, 10
JAX_PLANNED = {"springs_higher": 7, "bars": 2, "mean_gain_m": 0.1296}
PLANNED_SLACK = math.ceil(2 * math.sqrt(len(PLANNED_SEEDS) * (7 / 8) * (1 / 8)))
# phase 22: the learned comparison (compare_springs.run_config) cut to
# LEARNED_ITERS iterations, one process a robot; a step whose returns all
# tie has sigma_r at its 1e-8 floor. Within those iterations the springs'
# evaluation apex reaches LEARNED_APEX: the JAX curve
# (docs/springs_vs_rigid_learned.json) at iteration 7, the port's 150-iteration
# run on an NVIDIA H100 80GB HBM3 (700 W) at 9
LEARNED_ITERS = 12
LEARNED_APEX = 0.5
SIGMA_TIE = 1e-6
# phase 23: each run of quadruped_springs_tpu_torch.examples at its default
# size, the longest first; the iLQR runs' widths (problems, horizon, line
# search candidates) for the kernel checks at the head of the phase
EXAMPLE_JOBS = (("backflip", {}), ("cpg", {}), ("mpc", {"batch": 4}), ("mpc", {}),
                ("quickstart", {}), ("mpc", {"mppi": True}), ("episode", {}),
                ("cartesian_jump", {}))
EXAMPLE_ILQR = {"mpc": (1, 25, 6), "mpc_batch4": (4, 25, 6), "backflip": (1, 60, 8)}
# phase 20: each MPC behaviour driver (mpc_behaviours.DRIVERS) at the JAX
# example's full configuration over its seeds, as (run, seeds) jobs of the
# host-bound pool, the longest first. The port's draws differ from the JAX
# package's, so a seed can fall on the other side of a bar in one package and
# not the other: every run is held to the JAX package's own pass count over
# the same seeds, JAX_PASSES (`python tests/jax_mpc_behaviours_probe.py
# jumping_forward backflip continuous --seeds ...` on the CPU), less
# SHARE_SLACK: tests/test_torch_transfer_share.py's rule, two binomial
# standard deviations at the JAX package's miss rate, rounded up. It applies
# to jumping forward, whose JAX share is measured over FORWARD_SEEDS (4
# misses in 64: seeds 20, 35, 49, 59; none in 0-7, so 8 seeds measure no
# rate); the other two are held to the JAX count itself over seeds 0-7. The
# backflip is held on the JAX example's scenario of each seed: the
# GROUND_RANDOMIZER friction its env.reset(PRNGKey(seed)) draws
# (`--frictions`), injected as the driver's `friction`; the run on the
# port's own draw of the ground ("backflip_drawn_ground") is reported beside
# it, with no bar.
BEHAVIOUR_SEEDS = tuple(range(8))
FORWARD_SEEDS = tuple(range(64))
JAX_BACKFLIP_FRICTION = (0.8758191466331482, 0.6319233775138855, 0.7557409405708313,
                         0.859541118144989, 0.8161233067512512, 0.7351763844490051,
                         0.7035908102989197, 0.9285371899604797)
BEHAVIOUR_JOBS = (("continuous", (0, 1)), ("continuous", (2, 3)), ("continuous", (4, 5)),
                  ("continuous", (6, 7))) + tuple(
    ("jumping_forward", FORWARD_SEEDS[i:i + 16]) for i in range(0, len(FORWARD_SEEDS), 16)) + (
    ("backflip", BEHAVIOUR_SEEDS), ("backflip_drawn_ground", BEHAVIOUR_SEEDS))
JAX_PASSES = {"jumping_forward": 60, "backflip": 1, "continuous": 6}
JAX_FORWARD_PASSES_0_7 = 8
_FORWARD_MISS = 1 - JAX_PASSES["jumping_forward"] / len(FORWARD_SEEDS)
SHARE_SLACK = {"jumping_forward": math.ceil(2 * math.sqrt(
    len(FORWARD_SEEDS) * _FORWARD_MISS * (1 - _FORWARD_MISS)))}
ORACLE_TRACES = [("JUMPING_IN_PLACE", True), ("JUMPING_FORWARD", True), ("BACKFLIP", True),
                 ("CONTINUOUS_JUMPING_FORWARD", True), ("JUMPING_IN_PLACE", False),
                 ("JUMPING_FORWARD", False)]
SHARDED_BATCH = 1024             # one card's share of BASELINE config 5 (4,096 over 4)
# least drop of the sharded BACKFLIP solve's mean cost below the warm start's:
# the first run on an NVIDIA H100 80GB HBM3 (700 W) dropped it by 2,241.6668
# (-424.6240 -> -2,666.2908)
SHARDED_MARGIN = 2000.0
# phase 18 solves the first GAP_ROWS scenarios again, as one batch and as
# batches of GAP_BLOCK, which must give the answers bitwise; and once more as
# one batch with the last row's start NaN, which must leave the others as
# they were. The MPPI batch check runs the headline's and the full-rate
# row's solves with GAP_MPPI_ITERATIONS iterations (10 in the headline: every
# op of the solve runs in each iteration, and the host's launches set the
# time), and the planned comparison's (non-fused accept, both robots) at its
# own iterations
GAP_ROWS, GAP_BLOCK, GAP_MPPI_ITERATIONS = 8, 2, 3
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
# float32 operations per (lane, motor or site[, tangent]), from the kernels' source
FLOPS_PER_ELEM = {"actuation": 10, "contact": 20, "contact_anchored": 30,
                  "actuation_jvp": 6, "contact_jvp": 25,
                  # per (environment, substep), counted by
                  # tests/torch_env_opcount.py (csrc/env_lane.cuh's body on
                  # the CPU with a counting float): the four legs' work (their
                  # kinematics, inertias, bias force, three sites' contact, 3x3
                  # block and share of the base's Schur system), the base's
                  # (the trunk's bias, the 6x6 solve, the Euler update) once,
                  # though the four threads each do it, and the sum over the
                  # legs once
                  "env_substeps": 10_110,
                  # per (lane, substep): the same substep with the memoryless
                  # foot (csrc/env_lane.cuh lane_substep)
                  "planner_rollout": 10_000,
                  # per (environment, substep) of env_substeps_vjp
                  # (csrc/env_lane_vjp.cuh), counted as env_substeps's: one
                  # forward and the adjoint; the kernel's second forward (its
                  # recompute of each substep before the sweep) is its
                  # design's choice, not work the function needs, and is not
                  # counted
                  "env_substeps_vjp": 34_152}
# env_substeps against its plain version: within ENV_SPREAD times the plain
# version's own spread, plus REL_TOL of 1 + |plain|. The spread, per
# environment and output field, is the larger of the plain version's change
# under a one-ulp change of its start (every joint angle one float32 ulp up)
# and its distance to itself run in float64. Stiff contact carries a
# rounding from substep to substep, so over a control step the kernel (soa's
# order of operations, FMA) and the plain version (ref's order) part as far
# as two starts one ulp apart do; where the motion is smooth (a leg swinging
# in flight) a start moved by one ulp moves the end by about one ulp, while
# two float32 implementations part by their roundings at every substep, which
# the plain version's distance to its float64 self measures. The kernel's
# body built for the CPU parts from the plain version by up to 2.4 one-ulp
# spreads (tests/test_torch_env_substeps.py's cases).
ENV_SPREAD = 10.0
ENV_GAP_ROWS, ENV_GAP_BLOCK = 8, 2
# env_substeps_kernel's local memory a thread: the stack of sinf's and cosf's
# reduction of huge arguments, off the common path; more is a spill
ENV_LOCAL_BYTES = 32
# env_substeps_vjp_kernel's: the stack of its stages' live sets beyond 255
# registers (measured on an NVIDIA H100 80GB HBM3 at 700 W; 1,528 bytes
# before its stages were spread over a block's warps); more is a new spill
VJP_LOCAL_BYTES = 112
# planner_rollout against its plain version, both against the plain version
# run in float64: per field and knot, and on the lanes' MPPI costs, these
# quantiles over the lanes of the kernel's relative distance within
# ROLLOUT_DIST x the plain version's (+ REL_TOL). env_substeps's per-lane rule
# (ROLLOUT_SPREAD x the plain version's own spread, as ENV_SPREAD) gates the
# one-lane executor; over the 32,768 lanes x 50 knots of a rollout it does
# not hold lane by lane: the relaxed contact's damping switches on at
# phi = 0 (dn·|vz|, 40 N at 1 m/s), and where the kernel's contracted
# (FMA) rounding puts a site on the other side of phi = 0 than the plain
# version, its one-ulp start and its float64 run, the lane parts from them
# by far more than they part from each other within one knot
# (tests/torch_rollout_lane_probe.py, PERF.md). Such lanes are counted and
# printed.
ROLLOUT_QUANTILES = (0.5, 0.9, 0.99)
ROLLOUT_DIST = 2.0
ROLLOUT_SPREAD = 10.0
# one knot from the plain version's state at each of the headline's 1.6 M
# knot-lanes: the kernel may be 100 x farther from the float64 knot than the
# plain version (a site put across phi = 0 by FMA rounding) at no more than
# ONE_KNOT_FAR of them (1 measured on an NVIDIA H100 80GB HBM3 at 700 W), and
# past the plain version's 0.999 quantile at no more than ONE_KNOT_TAIL x as
# many as the plain version itself; a fault on a branch few lanes take (a
# contact site, the friction cone) fails either
ONE_KNOT_QUANTILES = (0.5, 0.9, 0.99, 0.999)
ONE_KNOT_FAR = 8
ONE_KNOT_TAIL = 2.0
# the lane-to-problem map of planner_rollout's blocks (32 lanes each): (B, R,
# H, full rate, one scenario row for all); a block that ends early (5 x 3),
# problems that straddle two blocks (13 x 3, also on one row), R = 2 (the
# fused accept's settle), 64 (the jumping-forward and backflip behaviours: a
# problem over two blocks) and 1 (32 problems staged in one block; the
# executor's H = 1, S = 10)
ROLLOUT_MAP_SHAPES = ((5, 3, 4, False, False), (13, 3, 4, False, False),
                      (13, 3, 4, False, True), (17, 2, 4, False, False),
                      (2, 64, 2, False, False), (40, 1, 1, True, False))
ROLLOUT_FIELDS = {"pos": slice(0, 3), "quat": slice(3, 7), "lin_vel": slice(7, 10),
                  "ang_vel": slice(10, 13), "q": slice(13, 25), "qd": slice(25, 37)}


def cuda_time_ms(torch, fn, reps=30, inner=1):
    """Median CUDA-event time of one call of fn, over reps timings of
    `inner` back-to-back calls each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_time_ms(torch, fn, kernel, reps=20):
    """Mean time on the card of the CUDA kernel whose name contains `kernel`
    over reps calls of fn, from torch.profiler (no enqueue, no wrapper);
    None if the profiler recorded no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key:
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
            count += e.count
    return us / count / 1e3 if count else None


def roofline(name, elems, inputs, outputs):
    """The least time the card could take for one call on `elems` (lane,
    motor or site[, tangent]) elements: each input read once and each
    output written once at the HBM rate, or the kernel's float32 operations
    at the card's peak, whichever is larger."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    flops = FLOPS_PER_ELEM[name] * elems
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def bf16_ulp(torch, x):
    """One bfloat16 ulp at |x| (8 significant bits): 2^(e - 8) for
    |x| = m·2^e, 0.5 <= m < 1."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)


def max_err(torch, got, want, name, term_scale=None):
    """Max |got - want|; raises unless within REL_TOL·(1 + |want|) everywhere.
    `term_scale`, the summed magnitudes of the terms an output adds up, widens
    the bound by CANCEL_TOL·term_scale: where the terms cancel, kernel and
    plain version each carry the rounding of the terms, not of their sum.
    bfloat16 outputs (a bf16 variant against its plain version, both f32
    arithmetic rounded to bf16 once) get one bf16 ulp of |want| more: an f32
    difference within the bound can straddle a bf16 rounding boundary."""
    if got.dtype == torch.bool:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: boolean outputs differ")
        return 0.0
    bf16 = want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = REL_TOL * (1.0 + want.abs())
    if term_scale is not None:
        bound = bound + CANCEL_TOL * term_scale
    if bf16:
        bound = bound + bf16_ulp(torch, want.abs())
    if not bool(torch.all(err <= bound)):
        raise AssertionError(f"{name}: max |kernel - twin| {float(err.max())} exceeds "
                             f"{REL_TOL}·(1+|twin|)" + (" + 1 bf16 ulp" if bf16 else ""))
    return float(err.max())


def check_actuation(torch, act, owner, n, kp=None, kd=None, lanes=None,
                    dtype=None):
    """The `actuation` kernel against its twin at n lanes with owner's (an
    MPCProblem's or a QuadrupedEnv's) config, limits and spring signs;
    kp, kd: (12,) gains, the motor gains by default. `lanes` < n launches the
    kernel on consecutive blocks of that many lanes (times and bound: one
    launch). `dtype` bfloat16: every argument cast to it, the bf16 variant
    against act.actuation_plain (the f32 twin, rounded)."""
    cfg = owner.cfg
    kp = cfg.motor_kp if kp is None else kp
    kd = cfg.motor_kd if kd is None else kd
    lanes = n if lanes is None else lanes
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
    full = tuple(t.to(dtype or torch.float32).contiguous() for t in (
        q_des, q, qd, kp, kd, cfg.torque_limits, spring_k, spring_b,
        cfg.spring_rest_angles, owner.engage_sign))

    def args(i=0, m=n):
        s = slice(i, i + m)
        return tuple(t[s] if k in (0, 1, 2, 6, 7) else t for k, t in enumerate(full))

    twin = lambda: act.actuation_plain(*full)

    one = lambda: act.actuation_torque(*args(0, lanes))
    got, want = launch_blocks(torch, lambda i: act.actuation_torque(*args(i, lanes)), n,
                              lanes), twin()
    torch.cuda.synchronize()
    err = max(max_err(torch, g, w, f"actuation {k}")
              for g, w, k in zip(got, want, ("tau", "tau_motor")))
    return {"max_abs_err": err, "ms": cuda_time_ms(torch, one),
            "profile": (one, "actuation_kernel"), "plain_ms": cuda_time_ms(torch, twin),
            **roofline("actuation", lanes * 12, args(0, lanes), one())}


def launch_blocks(torch, launch, n, lanes):
    """The outputs of launch(i) for i = 0, lanes, 2·lanes, ... < n, joined
    along the lane axis."""
    outs = [launch(i) for i in range(0, n, lanes)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def check_contact(torch, dyn, model, n, kn, dn, lanes=None, dtype=None):
    """The memoryless `contact` kernel against its twin at n lanes x 12
    sites with normal stiffness kn and damping dn, clamp on and off;
    `lanes` and `dtype` as in check_actuation (bf16: the twin is
    contact_forces_plain on the bf16 inputs, the f32 law rounded)."""
    lanes = n if lanes is None else lanes
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
    phi, v_w, mu = (t.to(dtype or torch.float32) for t in (phi, v_w, mu))
    # the wrapper takes site heights: with zero radii, φ = -z exactly
    p_w = torch.zeros_like(v_w)
    p_w[..., 2] = -phi
    radii = torch.zeros(12, dtype=phi.dtype, device="cuda")
    results = {}
    for clamp in (False, True):
        params = dyn.SimParams(contact_stiffness=kn, contact_damping=dn, friction=mu,
                               clamp_damping=clamp)

        # (bound now: phase 12 calls it after the loop has moved on)
        def launch(i, params=params):
            s = slice(i, i + lanes)
            return dyn.contact_forces(model, dataclasses.replace(params, friction=mu[s]),
                                      p_w[s], v_w[s], radii)[:3]

        one = lambda launch=launch: launch(0)
        twin = lambda: dyn.contact_forces_plain(phi, v_w, mu, kn, dn,
                                                params.slip_vel_tol, clamp)
        got, want = launch_blocks(torch, launch, n, lanes), twin()
        torch.cuda.synchronize()
        if not bool(want[2][2:6].all()) or bool(want[2][0:2].any()):
            raise AssertionError("contact edge rows not in the intended regime")
        err = max(max_err(torch, g, w, f"contact clamp={clamp} {k}")
                  for g, w, k in zip(got, want, ("f_world", "fn", "in_contact")))
        results[clamp] = {"max_abs_err": err, "ms": cuda_time_ms(torch, one),
                          "profile": (one, "contact_kernel"),
                          "plain_ms": cuda_time_ms(torch, twin),
                          **roofline("contact", lanes * 12,
                                     (phi[:lanes], v_w[:lanes], mu[:lanes]), one())}
    return results


def report_checks(phase, checks, n, unit):
    for name, by_setting in checks.items():
        for setting, r in by_setting.items():
            print(f"phase {phase}: {name} ({setting}) at {n} {unit}: max_abs_err "
                  f"{r['max_abs_err']:.3e}, kernel {r['ms']:.4f} ms through its wrapper, "
                  f"plain twin {r['plain_ms']:.4f} ms (CUDA events, median of 30); bound "
                  f"{r['bound_ms'] * 1e3:.2f} µs ({r['bytes']} bytes)", flush=True)


def profile_kernels(torch, checks):
    """Phase 12: fill each check's `device_ms`, its kernel's time on the card
    alone. After every timed path: the profiler stays attached to the
    process once it has run and must not weigh on their launches."""
    for name, by_setting in checks.items():
        for setting, r in by_setting.items():
            if "profile" not in r:
                continue
            r["device_ms"] = device_time_ms(torch, *r.pop("profile"))
            device = ("not recorded" if r["device_ms"] is None
                      else f"{r['device_ms'] * 1e3:.2f} µs")
            print(f"phase 12: {name} ({setting}): {device} on the card alone "
                  f"(torch.profiler, mean of 20 launches); bound "
                  f"{r['bound_ms'] * 1e3:.2f} µs", flush=True)


def check_anchored_contact(torch, dyn, model, n, lanes=None):
    """The `contact_anchored` kernel against its twin at n lanes x 12 sites
    with the execution model's constants, clamp on and off; `lanes` as in
    check_actuation."""
    lanes = n if lanes is None else lanes
    gen = torch.Generator("cuda").manual_seed(13)
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

        def launch(i, params=params):
            s = slice(i, i + lanes)
            return dyn.contact_forces(model, dataclasses.replace(params, friction=mu[s]),
                                      p_w[s], v_w[s], radii, anchor[s])

        one = lambda launch=launch: launch(0)
        twin = lambda: dyn.contact_forces_anchored_plain(
            radii - p_w[..., 2], v_w, p_w[:, :4, :2], anchor, mu,
            params.contact_stiffness, params.contact_damping, params.tangential_stiffness,
            params.tangential_damping, params.slip_vel_tol, clamp)
        got, want = launch_blocks(torch, launch, n, lanes), twin()
        torch.cuda.synchronize()
        inc, new = want[2][:, :4], want[3]
        slid = (new != anchor).any(-1)
        # the hand-placed lanes sit in their regimes; of the seeded lanes, once
        # there are dozens, some feet stick and some slide
        regimes = {"lanes 0-1 out of contact": not inc[:2].any(),
                   "lanes 2-4 in contact": inc[2:5].all(),
                   "lanes 2 and 4 stick": not (slid[2].any() or slid[4].any()),
                   "lane 3 slides": slid[3].all(),
                   "seeded feet stick and slide": n < 64 or ((inc & slid)[5:].any()
                                                             and (inc & ~slid)[5:].any())}
        if not all(bool(ok) for ok in regimes.values()):
            raise AssertionError(f"anchored contact lanes not in the intended regimes at "
                                 f"{n} lanes: {[k for k, ok in regimes.items() if not ok]}")
        err = max(max_err(torch, g, w, f"contact_anchored clamp={clamp} {k}")
                  for g, w, k in zip(got, want, ("f_world", "fn", "in_contact",
                                                  "new_anchor")))
        results[clamp] = {"max_abs_err": err, "ms": cuda_time_ms(torch, one),
                          "profile": (one, "contact_anchored_kernel"),
                          "plain_ms": cuda_time_ms(torch, twin),
                          **roofline("contact_anchored", lanes * 12,
                                     (p_w[:lanes, :, 2], v_w[:lanes], p_w[:lanes],
                                      anchor[:lanes], mu[:lanes]), one())}
    return results


def env_substeps_args(env, state, q_des, substeps, kp=None, kd=None, ext=None,
                      torque_mode=False, on_rack=False):
    """env_substeps's arguments for the environments of `state` (an EnvState
    of `env`), as QuadrupedEnv.physics passes them."""
    from quadruped_springs_tpu_torch.env import randomizers as rnd

    params = env._scenario_sim_params(state.scenario)
    if on_rack:
        params = dataclasses.replace(params, on_rack=True)
    k, b = env._springs(state.scenario)
    cfg = env.cfg
    return (state.robot, state.foot_anchor.contiguous(), q_des,
            rnd.model_from_params(state.scenario), params,
            cfg.motor_kp if kp is None else kp, cfg.motor_kd if kd is None else kd,
            cfg.torque_limits, cfg.velocity_limits, k, b, cfg.spring_rest_angles,
            env.engage_sign, substeps, ext, torque_mode)


def substeps_rows(out):
    """A SubstepsOut's fields, each (N, k) in float64."""
    r = out.robot
    parts = {"pos": r.pos, "quat": r.quat, "lin_vel": r.lin_vel, "ang_vel": r.ang_vel,
             "q": r.q, "qd": r.qd, "anchor": out.anchor, "tau": out.tau, "tau_m": out.tau_m,
             "tau_m_sum": out.tau_m_sum, "foot_forces": out.foot_forces,
             "feet_in_contact": out.feet_in_contact, "invalid_contact": out.invalid_contact}
    return {k: v.reshape(v.shape[0], -1).double() for k, v in parts.items()}


def check_env_substeps(torch, ss, args, reps=30):
    """The `env_substeps` kernel against env_substeps_plain on the same
    arguments, within REL_TOL·(1 + |plain|) + ENV_SPREAD x the plain
    version's own spread, per environment and output field: the larger of
    its change under a one-ulp change of its start and its distance to
    itself in float64 (a boolean output may flip only where the spread flips
    it). Times the kernel through its wrapper (CUDA events, median of
    `reps`) and the plain version (its two float32 calls, the faster)."""
    robot = args[0]
    got = substeps_rows(ss.env_substeps(*args))
    torch.cuda.synchronize()
    moved = list(args)
    moved[0] = dataclasses.replace(robot, q=torch.nextafter(robot.q, robot.q + 1.0))
    timed = []

    def plain(a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rows = substeps_rows(ss.env_substeps_plain(*a))
        end.record()
        end.synchronize()
        timed.append(start.elapsed_time(end))
        return rows

    want, again = plain(args), plain(moved)
    exact = substeps_rows(ss.env_substeps_plain(*ss.float64_args(args)))
    err, used = 0.0, 0.0
    for k, w in want.items():
        d = (got[k] - w).abs()
        spread = torch.maximum((again[k] - w).abs(), (exact[k] - w).abs()).amax(
            dim=1, keepdim=True)
        slack = d - REL_TOL * (1.0 + w.abs())
        bad = slack > ENV_SPREAD * spread
        if bool(bad.any()):
            i, j = (int(x) for x in bad.nonzero()[0])
            raise AssertionError(
                f"env_substeps {k}: |kernel - plain| {float(d[i, j])} at environment {i}, "
                f"column {j} (plain {float(w[i, j])}, kernel {float(got[k][i, j])}; max "
                f"{float(d.max())}) exceeds {REL_TOL}·(1+|plain|) + {ENV_SPREAD} x the plain "
                f"version's spread {float(spread[i, 0])} (one ulp "
                f"{float((again[k] - w).abs()[i].max())}, float64 "
                f"{float((exact[k] - w).abs()[i].max())})")
        if k not in ("feet_in_contact", "invalid_contact"):
            err = max(err, float(d.max()))
        over = slack.clamp_min(0.0) / spread.clamp_min(1e-30)
        used = max(used, float(torch.where(slack > 0, over, torch.zeros_like(over)).max()))
    one = lambda: ss.env_substeps(*args)
    out = one()
    n, substeps, ext = robot.q.shape[0], args[13], args[14]
    friction = args[4].friction
    # the kernel alone: back-to-back launches of one argument list
    from quadruped_springs_tpu_torch import kernels

    launch, _ = ss.launch_args(robot, args[1], args[2], args[3], friction, *args[4:])
    run, stream = kernels.library().env_substeps, kernels.stream_handle(robot.q.device)
    inner = 2 if substeps > 100 else 20
    inputs = [robot.pos, robot.quat, robot.lin_vel, robot.ang_vel, robot.q, robot.qd,
              *args[1:3], *args[5:13], ss.pack_model(args[3]),
              *(t for t in (friction, ext) if torch.is_tensor(t))]
    r = out.robot
    outputs = [r.pos, r.quat, r.lin_vel, r.ang_vel, r.q, r.qd, out.anchor, out.tau, out.tau_m,
               out.tau_m_sum, out.foot_forces, out.feet_in_contact, out.invalid_contact]
    return {"max_abs_err": err, "spread_used": used,
            "ms": cuda_time_ms(torch, one, reps=reps), "profile": (one, "env_substeps_kernel"),
            "kernel_ms": cuda_time_ms(torch, lambda: run(*launch, stream), reps=reps,
                                      inner=inner),
            "plain_ms": min(timed), **roofline("env_substeps", n * substeps, inputs, outputs)}


def check_env_substeps_batching(torch, ss, env, state, q_des, ext):
    """Rows 0-ENV_GAP_ROWS-1 of one env_substeps launch at N environments,
    at ENV_GAP_ROWS and in blocks of ENV_GAP_BLOCK: bitwise equal. Returns
    max |d| per batching (0: bitwise)."""
    from quadruped_springs_tpu_torch.env.env import take

    def rows(a, b):
        idx = torch.arange(a, b, device="cuda")
        return substeps_rows(ss.env_substeps(*env_substeps_args(
            env, take(state, idx), q_des[idx].contiguous(), q_des.shape[1],
            ext=ext[idx].contiguous())))

    n = state.robot.q.shape[0]
    full, whole = rows(0, n), rows(0, ENV_GAP_ROWS)
    blocks = [rows(i, i + ENV_GAP_BLOCK) for i in range(0, ENV_GAP_ROWS, ENV_GAP_BLOCK)]
    gap = {}
    for name, sol in ((str(n), full), (f"{ENV_GAP_ROWS // ENV_GAP_BLOCK} x {ENV_GAP_BLOCK}",
                                       None)):
        gap[name] = max(float(((torch.cat([b[k] for b in blocks]) if sol is None
                                else sol[k][:ENV_GAP_ROWS]) - whole[k]).abs().max())
                        for k in whole)
    return gap


def env_substeps_settings(torch, env_bench, landing):
    """Phase 5's env_substeps settings: 1,024 settled environments x 10
    substeps with lanes moved into each regime (every 8th from lane 1 in
    flight, from lane 2 its anchors 5 cm off so the feet slide on the
    friction cone, from lane 3 pushed at the trunk) and the command
    interpolated from the last action to a random one ("env"); the same in
    TORQUE mode (random torques held) and on the rack; 64 of them under the
    landing gains. Returns ({setting: env_substeps's arguments}, (env, state,
    q_des, ext) of "env")."""
    from quadruped_springs_tpu_torch.control import interfaces as ci
    from quadruped_springs_tpu_torch.env.env import take

    env = env_bench.QuadrupedEnv(env_bench.bench_config(ENV_SETTLE), device="cuda")
    gen = torch.Generator("cuda").manual_seed(21)
    state, _ = env.reset(gen, ENVS)
    robot, anchor = state.robot, state.foot_anchor.clone()
    pos, lin_vel = robot.pos.clone(), robot.lin_vel.clone()
    pos[1::8, 2] += 0.15
    lin_vel[1::8, 2] = 1.0
    anchor[2::8] += 0.05
    state = dataclasses.replace(state, foot_anchor=anchor, robot=dataclasses.replace(
        robot, pos=pos, lin_vel=lin_vel))
    action = 2.0 * torch.rand((ENVS, env.action_dim), generator=gen, device="cuda") - 1.0
    prev = state.last_action
    command = lambda a: ci.action_to_command(env.iface, a).contiguous()
    q_des = torch.stack([command(prev + ((i + 1.0) / 10) * (action - prev))
                         for i in range(10)], dim=1)
    ext = torch.zeros(ENVS, 3, device="cuda")
    ext[3::8] = torch.tensor([30.0, -20.0, 10.0], device="cuda")
    torques = 16.0 * torch.rand((ENVS, 12), generator=gen, device="cuda") - 8.0
    held = command(action)
    few = take(state, torch.arange(64, device="cuda"))
    landing_q = command(env.get_landing_action().expand(64, -1))
    settings = {
        "env": env_substeps_args(env, state, q_des, 10, ext=ext),
        "env_torque": env_substeps_args(env, state, torques, 10, torque_mode=True),
        "env_on_rack": env_substeps_args(env, state, held, 10, on_rack=True),
        "env_landing_64": env_substeps_args(env, few, landing_q, 10, *landing)}
    return settings, (env, state, q_des, ext)


def check_env_substeps_shapes(torch, ss, env_bench, landing, kind):
    """Phase 5, last: env_substeps against its plain version at
    env_substeps_settings, then rows 0-7 bitwise at 1,024, 8 and 2
    environments."""
    settings, (env, state, q_des, ext) = env_substeps_settings(torch, env_bench, landing)
    checks = {setting: check_env_substeps(torch, ss, args) for setting, args in settings.items()}
    gap = check_env_substeps_batching(torch, ss, env, state, q_des, ext)
    for setting, r in checks.items():
        print(f"phase 5: env_substeps ({setting}) at {64 if '64' in setting else ENVS} "
              f"environments x 10 substeps: max_abs_err {r['max_abs_err']:.3e} (bound "
              f"{REL_TOL}·(1+|plain|) + {ENV_SPREAD} x the plain version's spread; "
              f"{r['spread_used']:.2f} spreads used), kernel {r['ms']:.4f} ms through its "
              f"wrapper, {r['kernel_ms'] * 1e3:.2f} µs on the card (back-to-back launches "
              f"between two CUDA events), plain {r['plain_ms']:.2f} ms; bound "
              f"{r['bound_ms'] * 1e3:.2f} µs ({r['bytes']} bytes, by {r['bound_by']}) on {kind}",
              flush=True)
    print(f"phase 5: env_substeps rows 0-{ENV_GAP_ROWS - 1} of {ENVS} environments against "
          f"the same rows launched as {ENV_GAP_ROWS} and in blocks of {ENV_GAP_BLOCK}: max |d| "
          f"{gap} (0: bitwise equal)", flush=True)
    if any(v != 0.0 for v in gap.values()):
        raise AssertionError(f"phase 5: env_substeps rows depend on the batch: {gap}")
    return checks, gap


def check_learning_widths(torch, act, dyn, model, landing_gains):
    """Phase 13, first: the environment's three kernels against their twins at
    every lane count the learning stack launches them at (LEARNING_WIDTHS),
    each with its path's task interface, under the motor gains and the landing
    wrappers', with the damping clamp on and off. 12 threads per lane: 8 and
    32 lanes end in a partial thread block, which the 1,024 and 32,768 lanes
    of phases 3 and 5 never launch."""
    from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv

    envs = {task: QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env=task, action_space_mode="SYMMETRIC",
        observation_space_mode="ARS_BACKFLIP" if task == "BACKFLIP" else "ARS_BASIC",
        settling_steps=0), device="cuda") for _, task in LEARNING_WIDTHS.values()}
    checks = {"actuation": {}, "contact": {}, "contact_anchored": {}}
    for path, (n, task) in LEARNING_WIDTHS.items():
        env = envs[task]
        sim = env.sim_params
        contact = check_contact(torch, dyn, model, n, sim.contact_stiffness,
                                sim.contact_damping)
        anchored = check_anchored_contact(torch, dyn, model, n)
        checks["actuation"][f"{path}_{n}"] = check_actuation(torch, act, env, n)
        checks["actuation"][f"{path}_{n}_landing"] = check_actuation(torch, act, env, n,
                                                                      *landing_gains)
        for clamp, tag in ((True, "_clamp"), (False, "")):
            checks["contact"][f"{path}_{n}{tag}"] = contact[clamp]
            checks["contact_anchored"][f"{path}_{n}{tag}"] = anchored[clamp]
    for name, by_setting in checks.items():
        for r in by_setting.values():
            del r["profile"]       # phase 12 profiles the shapes of phases 3, 5 and 8
        worst = max(by_setting.values(), key=lambda r: r["max_abs_err"])
        ms = [r["ms"] for r in by_setting.values()]
        print(f"phase 13: {name} against its twin at {len(by_setting)} settings of the "
              f"learning stack's widths {sorted({n for n, _ in LEARNING_WIDTHS.values()})} "
              f"lanes: max_abs_err {worst['max_abs_err']:.3e} (bound {REL_TOL}·(1+|twin|)), "
              f"kernel {min(ms):.4f}-{max(ms):.4f} ms through its wrapper", flush=True)
    return checks


def check_two_stage_substeps(torch, ss, kind, widths=TWO_STAGE_WIDTHS,
                             randomizer="GROUND_RANDOMIZER", tag="two_stage"):
    """Phase 13, after the per-substep kernels: env_substeps against its plain
    version at the two-stage trainers' widths (TWO_STAGE_WIDTHS), or at
    `widths` drawn under `randomizer`: settled environments of each
    interface, every 4th lane lifted 15 cm and rising at 1 m/s, under a
    random command held for a control step (10 substeps), to phase 5's
    bound."""
    from quadruped_springs_tpu_torch.control import interfaces as ci
    from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv, take

    gen = torch.Generator("cuda").manual_seed(24)
    starts = {}
    for task in sorted({task for _, task in widths.values()}):
        env = QuadrupedEnv(EnvConfig(
            enable_springs=True, task_env=task, action_space_mode="SYMMETRIC",
            observation_space_mode="ARS_BACKFLIP" if task == "BACKFLIP" else "ARS_BASIC",
            iface_task=task, settling_steps=ENV_SETTLE, env_randomizer_mode=randomizer),
            device="cuda")
        n = max(n for n, t in widths.values() if t == task)
        state, _ = env.reset(gen, n)
        pos, lin_vel = state.robot.pos.clone(), state.robot.lin_vel.clone()
        pos[::4, 2] += 0.15
        lin_vel[::4, 2] = 1.0
        state = dataclasses.replace(state, robot=dataclasses.replace(
            state.robot, pos=pos, lin_vel=lin_vel))
        action = 2.0 * torch.rand((n, env.action_dim), generator=gen, device="cuda") - 1.0
        starts[task] = (env, state, ci.action_to_command(env.iface, action).contiguous())
    checks = {}
    for path, (n, task) in widths.items():
        env, state, q_des = starts[task]
        idx = torch.arange(n, device="cuda")
        r = check_env_substeps(torch, ss, env_substeps_args(
            env, take(state, idx), q_des[:n].contiguous(), 10))
        checks[f"{tag}_{path}_{n}"] = r
        print(f"phase 13: env_substeps ({path}, {n} x 10, {task} interface, {randomizer}): "
              f"max_abs_err "
              f"{r['max_abs_err']:.3e} ({r['spread_used']:.2f} spreads used), kernel "
              f"{r['ms']:.4f} ms through its wrapper, {r['kernel_ms'] * 1e3:.2f} µs on the card, "
              f"plain {r['plain_ms']:.2f} ms; bound {r['bound_ms'] * 1e3:.3f} µs on {kind}",
              flush=True)
    return checks


def check_actuation_jvp(torch, act, prob, n, dtype=None):
    """Phase 8: the `actuation_jvp` kernel (the total torque's tangent)
    against torch.func.jvp of act.actuation_plain at n lanes x N_TANGENTS
    directions; `dtype` bfloat16: every argument cast to it (the branch
    lanes are checked on the f32 twin at the cast inputs)."""
    cfg = prob.cfg
    gen = torch.Generator("cuda").manual_seed(21)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    rand = lambda *s: torch.rand(s, generator=gen, device="cuda")
    lo, hi = prob.iface.lower_lim, prob.iface.upper_lim
    q_des = lo + rand(n, 12) * (hi - lo)
    q = cfg.init_joint_angles + 0.5 * randn(n, 12)
    qd = 3.0 * randn(n, 12)
    rest12 = torch.tile(cfg.spring_rest_angles, (4,))
    q[0], q[1] = rest12 + 0.05, rest12 - 0.05      # either side of the engagement
    q_des[2], q_des[3] = q[2] + 10.0, q[3] - 10.0  # clipped at either limit
    q_des[4], qd[4] = q[4] + 0.01, 0.0             # well inside the clip
    spring_k = cfg.spring_stiffness * (0.9 + 0.2 * rand(n, 3))
    spring_b = cfg.spring_damping * (0.9 + 0.2 * rand(n, 3))
    dt = dtype or torch.float32
    constants = tuple(t.to(dt).contiguous() for t in (
        cfg.motor_kp, cfg.motor_kd, cfg.torque_limits, spring_k, spring_b,
        cfg.spring_rest_angles, prob.engage_sign))
    primals = tuple(t.to(dt) for t in (q_des, q, qd))
    tangents = tuple(randn(N_TANGENTS, n, 12).to(dt) for _ in range(3))

    def jvp_of(fn, primals, tangents, constants):
        return torch.func.vmap(lambda a, b, c: torch.func.jvp(
            lambda *p: fn(*p, *constants), primals, (a, b, c))[1])(*tangents)

    kernel = lambda: act._launch_actuation_jvp(*primals, *constants, *tangents)
    # what the kernel computes: the total torque's tangent alone
    plain = lambda: jvp_of(lambda *a: act.actuation_plain(*a)[0], primals, tangents,
                           constants)
    got, want = kernel(), plain()
    up = lambda ts: tuple(t.float() for t in ts)
    regime = jvp_of(act.actuation_plain, up(primals), up(tangents), up(constants))
    torch.cuda.synchronize()
    if not (bool((regime[1][:, 2:4] == 0).all()) and bool((regime[1][:, 4] != 0).all())
            and bool(((regime[0] - regime[1])[:, :2] != 0).any())
            and bool(((regime[0] - regime[1])[:, :2] == 0).any())):
        raise AssertionError("actuation_jvp edge lanes not in the intended regimes")
    kp, kd, _, k3, b3 = (t.float() for t in constants[:5])
    k12, b12 = (torch.tile(t, (1, 4)) for t in (k3, b3))
    d_des, d_q, d_qd = (t.float().abs() for t in tangents)
    terms = kp * (d_q + d_des) + kd * d_qd + k12 * d_q + b12 * d_qd
    return {"max_abs_err": max_err(torch, got, want, "actuation_jvp dtau", terms),
            "ms": cuda_time_ms(torch, kernel),
            "profile": (kernel, "actuation_jvp_kernel"),
            "plain_ms": cuda_time_ms(torch, plain, reps=5),
            **roofline("actuation_jvp", tangents[0].numel(),
                       (*primals, *constants, *tangents), (got,))}


def check_contact_jvp(torch, dyn, n, dtype=None):
    """Phase 8: the `contact_jvp` kernel against torch.func.jvp of
    contact_forces_plain at n lanes x 12 sites x N_TANGENTS directions, at
    the planner's constants, with the damping clamp off and on; `dtype` as
    in check_actuation_jvp."""
    gen = torch.Generator("cuda").manual_seed(22)
    kn, dn, v_tol = 4000.0, 40.0, 0.02
    phi = 0.02 * torch.rand((n, 12), generator=gen, device="cuda") - 0.01
    v_w = torch.randn((n, 12, 3), generator=gen, device="cuda")
    mu = 0.5 + 0.5 * torch.rand((n,), generator=gen, device="cuda")
    phi[0] = -1e-3                         # out of contact
    phi[1:7] = 5e-3                        # elastic = 20 N
    v_w[1:7, :, 2] = 0.0
    v_w[1, :, 2] = 2.0                     # damping -80 N: clipped at -elastic
    v_w[2, :, 2] = -2.0                    # damping +80 N: clipped at +elastic
    v_w[3, :, 2] = 1.0                     # unclamped force -20 N: floored at 0
    v_w[4, :, :2] = 3e-7                   # |v_t|² under the 1e-12 floor
    v_w[5, :, 0], v_w[5, :, 1] = 0.012, 0.005    # |v_t| under v_tol
    v_w[6, :, 0], v_w[6, :, 1] = 0.03, -0.04     # above it
    phi[7:9] = 5e-3
    v_w[7:9, :, 0], v_w[7:9, :, 1], v_w[7:9, :, 2] = 3.0, -4.0, 0.0   # sliding fast
    dphi = torch.randn((N_TANGENTS, n, 12), generator=gen, device="cuda")
    dv = torch.randn((N_TANGENTS, n, 12, 3), generator=gen, device="cuda")
    # lane 7: dv_t tiny, so the friction tangent is the dscale·v_t term, driven
    # by dfn; lane 8: dfn = 0, so dscale is its -scale·dden/den part alone and
    # the tangent is -scale x (dv_t less its component along v_t)
    dv[:, 7, :, :2] *= 1e-4
    dphi[:, 8], dv[:, 8, :, 2] = 0.0, 0.0
    dt = dtype or torch.float32
    phi, v_w, mu, dphi, dv = (t.to(dt).float() for t in (phi, v_w, mu, dphi, dv))
    # in the storage type: what the kernel and its plain version take
    phi_s, v_s, mu_s, dphi_s, dv_s = (t.to(dt) for t in (phi, v_w, mu, dphi, dv))
    # the friction tangent is -(dscale·v_t + scale·dv_t) with scale = μ·fn/den
    # and dscale = (μ·dfn - scale·dden)/den: magnitudes of those terms
    vt = v_w[..., :2].norm(dim=-1)
    den = torch.clamp_min(vt, v_tol)
    dv_t = dv[..., :2].abs().amax(dim=-1)

    def friction_terms(f_world, df):
        scale = mu[:, None] * f_world[..., 2] / den
        dscale = (mu[:, None] * df[..., 2].abs() + scale * dv_t) / den
        return (dscale * vt + scale * dv_t)[..., None]

    results = {}
    for clamp in (False, True):
        consts = (kn, dn, v_tol, clamp)
        plain_fn = lambda p, v, mu=mu: dyn.contact_forces_plain(p, v, mu, *consts)[0]
        kernel = lambda consts=consts: dyn._launch_contact_jvp(phi_s, v_s, mu_s, dphi_s,
                                                               dv_s, *consts)
        jvp_of = lambda fn, p, v, dp, dv: torch.func.vmap(
            lambda a, b: torch.func.jvp(fn, (p, v), (a, b))[1])(dp, dv)
        plain = lambda plain_fn=plain_fn: jvp_of(lambda p, v: plain_fn(p, v, mu_s), phi_s,
                                                 v_s, dphi_s, dv_s)
        got, want_s = kernel(), plain()
        # the branch lanes, checked on the f32 twin at the (cast) inputs
        want = jvp_of(plain_fn, phi, v_w, dphi, dv)
        torch.cuda.synchronize()
        dead = 1 if clamp else 3           # the lane whose force stays 0
        scale_dv = (mu[:, None] * 5e-3 * kn / 5.0 * dv[..., :2].norm(dim=-1))[:, 7]
        along = (want[:, 8, :, :2] * v_w[8, :, :2]).sum(-1).abs() / 5.0
        if not (bool((want[:, 0] == 0).all()) and bool((want[:, dead] == 0).all())
                and bool((want[:, 4:7, :, :2] != 0).any())
                and (not clamp or bool((want[:, 2, :, 2] == 2 * kn * dphi[:, 2]).all()))
                and bool((want[:, 7, :, :2].norm(dim=-1) > 1e3 * scale_dv).float().mean()
                         > 0.9)
                and bool((along <= 1e-4 * (1.0 + want[:, 8, :, :2].norm(dim=-1))).all())
                and bool((want[:, 8, :, :2] != 0).any())):
            raise AssertionError("contact_jvp edge lanes not in the intended regimes")
        results[clamp] = {
            "max_abs_err": max_err(torch, got, want_s, f"contact_jvp clamp={clamp}",
                                   friction_terms(plain_fn(phi, v_w), want)),
            "ms": cuda_time_ms(torch, kernel),
            "profile": (kernel, "contact_jvp_kernel"),
            "plain_ms": cuda_time_ms(torch, plain, reps=5),
            **roofline("contact_jvp", dphi.numel(), (phi_s, v_s, mu_s, dphi_s, dv_s),
                       (got,))}
    return results


def check_linearization(torch, ilqr, MPCConfig, MPCProblem):
    """Phase 9: Jacobians of one planner knot at JAC_STATES rollout states,
    card (kernels) against CPU (plain versions)."""
    jac = {}
    for dev in ("cpu", "cuda"):
        prob = MPCProblem(MPCConfig(horizon=JAC_STATES), dev)
        if dev == "cpu":       # one rollout, so both linearize at the same states
            lanes = prob.lane_params()
            us = prob.task_warm_start(crouch_knots=6)   # its extend phase sits at u = ±1
            x, xs = prob.default_x0()[None], []
            for t in range(JAC_STATES):
                xs.append(x)
                x = prob.dynamics(x, us[t:t + 1], lanes)
            z_cpu = torch.cat([torch.cat(xs), us], dim=-1)
        z = z_cpu.to(dev)
        lanes = prob.lane_params(repeats=JAC_STATES)
        _, cols = ilqr._basis_jvp(lambda z: prob.dynamics(z[:, :37], z[:, 37:], lanes), z)
        jac[dev] = cols.permute(1, 2, 0).cpu()
    heights = z_cpu[:, 2]
    scale = jac["cpu"].abs().amax(dim=(1, 2))
    rel = (jac["cuda"] - jac["cpu"]).abs().amax(dim=(1, 2)) / scale
    if not bool(torch.isfinite(jac["cuda"]).all()) or float(rel.max()) > JAC_TOL:
        raise AssertionError(f"phase 9: card and CPU Jacobians differ by {float(rel.max())} "
                             f"of max |J| (bound {JAC_TOL})")
    print(f"phase 9: {JAC_STATES} Jacobians (37x{N_TANGENTS}) of a planner knot along a "
          f"rollout (base height {float(heights.min()):.3f}-{float(heights.max()):.3f} m), "
          f"card against CPU: max |dJ| / max |J| = {float(rel.max()):.3e} (bound {JAC_TOL}); "
          f"max |J| {float(scale.min()):.1f}-{float(scale.max()):.1f}", flush=True)


def run_full_rate(torch, bench, act, dyn, kind):
    """Phase 4, second row: bench --full-rate --horizon 25 at full width
    (1024 scenarios x 32 samples, 10 iterations) on the execution-rate model:
    finite costs, the mean final cost within COST_BAND of the JAX bench's at
    the same configuration, `planner_rollout` launched once per rollout: 11
    per solve (each 25 knots x 10 substeps), `actuation` and `contact`
    never."""
    reset_counts(act, dyn)
    rec = bench.run(batch=BATCH, horizon=FULL_RATE_HORIZON, iterations=ITERATIONS,
                    samples=SAMPLES, runs=TIMED_RUNS, device="cuda", full_rate=True)
    torch.cuda.synchronize()
    counts = read_counts(act, dyn)
    if not bool(torch.isfinite(rec["costs"]).all()):
        raise AssertionError("phase 4: non-finite final costs in the full-rate solve")
    per_solve = (ITERATIONS + 1) * FULL_RATE_HORIZON * 10
    check_counts(counts, {**mppi_launches(rec["solves"], ITERATIONS),
                          "actuation": 0, "contact": 0, "contact_anchored": 0,
                          "env_substeps": 0,
                          "actuation_jvp": 0, "contact_jvp": 0,
                          **dict.fromkeys(BF16_KERNELS, 0)}, 4)
    mean_cost = rec["mean_final_cost"]
    lo, hi = sorted((FULL_RATE_REFERENCE_COST * (1 - COST_BAND),
                     FULL_RATE_REFERENCE_COST * (1 + COST_BAND)))
    if not lo <= mean_cost <= hi:
        raise AssertionError(f"phase 4: full-rate mean final cost {mean_cost} outside "
                             f"[{lo:.2f}, {hi:.2f}]")
    print(f"phase 4: {rec['solves']} full-rate solves (H={FULL_RATE_HORIZON}, 10 substeps "
          f"per knot at 180 kN/m, clamp on) ran {per_solve} substeps each in "
          f"{ITERATIONS + 1} planner_rollout_cost launches; mean final cost "
          f"{mean_cost:.4f} (band [{lo:.2f}, {hi:.2f}]; JAX {FULL_RATE_REFERENCE_COST}, the "
          f"parent {PARENT_FULL_RATE_COST}); {rec['value']:.2f} solves/s on "
          f"{kind}; launches {counts}", flush=True)
    print(json.dumps({"bench_full_rate": bench.line(rec)}))
    return counts


def check_ilqr_record(rec, phase):
    """The guards of an iLQR row: finite final costs, non-increasing cost
    traces, the mean final cost ILQR_MARGIN below the warm start's."""
    sol = rec["solution"]
    if not bool(sol.cost.isfinite().all()):
        raise AssertionError(f"phase {phase}: non-finite final costs")
    if sol.cost_trace.shape != (BATCH, ITERATIONS) or bool(
            (sol.cost_trace[:, 1:] > sol.cost_trace[:, :-1]).any()):
        raise AssertionError(f"phase {phase}: a cost trace increases")
    drop = rec["warm_start_mean_cost"] - rec["mean_final_cost"]
    if not drop > ILQR_MARGIN:
        raise AssertionError(f"phase {phase}: mean final cost {rec['mean_final_cost']} is "
                             f"not {ILQR_MARGIN} below the warm start's "
                             f"{rec['warm_start_mean_cost']}")
    return drop


def run_ilqr_solve(torch, bench, ilqr, act, dyn, kind):
    """Phase 10: the full-width iLQR solve, exact float32 (bench --ilqr
    --exact). Returns the launches and the mean final cost."""
    reset_counts(act, dyn)
    rec = bench.run(batch=BATCH, horizon=HORIZON, iterations=ITERATIONS,
                    runs=ILQR_TIMED_RUNS, device="cuda", ilqr=True, exact=True)
    torch.cuda.synchronize()
    counts = read_counts(act, dyn)
    drop = check_ilqr_record(rec, 10)
    warm = rec["warm_start_mean_cost"]
    prob, x0, u0, scenarios = rec["problem"]
    S = prob.config.solver_substeps
    blocks = -(-HORIZON // ilqr.linearization_blocks(BATCH, HORIZON, N_TANGENTS))
    # the warm start's rollout, then per solve the initial rollout and, per
    # iteration, the linearization's blocks and the line search's knots
    primal = S * (HORIZON + rec["solves"] * (HORIZON + ITERATIONS * (blocks + HORIZON)))
    tangent = rec["solves"] * S * ITERATIONS * blocks
    check_counts(counts, {"actuation": primal, "contact": primal, "actuation_jvp": tangent,
                          "contact_jvp": tangent, "contact_anchored": 0, "env_substeps": 0,
                          "planner_rollout": 0, **dict.fromkeys(BF16_KERNELS, 0)}, 10)
    # the same full-width problem, its rollout and one whole iteration, under
    # the sync debug mode (no stage clock: reading its events is the one sync
    # a timed solve makes, after the last iteration)
    one = dataclasses.replace(prob.ilqr_config, iterations=1)
    syncs, where = count_syncs(torch, lambda: ilqr.solve_batched(
        prob.lane_dynamics(scenarios), prob.stage_cost, prob.terminal_cost, x0, u0, one))
    stages = rec["stage_times"]
    print(f"phase 10: {rec['solves']} full-width exact iLQR solves ({BATCH} scenarios, "
          f"H={HORIZON}, {ITERATIONS} iterations, {ILQR_ALPHAS} alphas, {blocks} "
          f"linearization blocks per iteration): {rec['value']:.3f} solves/s on {kind}; mean "
          f"cost {warm:.4f} -> {rec['mean_final_cost']:.4f} (drop {drop:.4f}, margin "
          f"{ILQR_MARGIN}, first run {ILQR_FIRST_DROP}); launches {counts}; host syncs in a "
          f"full-width rollout plus iteration: {syncs}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(json.dumps({"ilqr_bench": {**bench.line(rec), "warm_start_mean_cost": warm,
                                     "stage_seconds_last_solve": stages}}))
    if syncs:
        raise AssertionError(f"phase 10: an iteration synchronised the host {syncs} "
                             f"times: {where}")
    return counts, rec["mean_final_cost"]


def run_ilqr_bf16(torch, bench, ilqr, act, dyn, kind, exact_cost):
    """Phase 10, second row: the JAX bench's default iLQR row (bench --ilqr):
    Jacobians of the bf16 knot, relinearized every ILQR_RELIN_EVERY-th
    iteration, at full width; held to the guards of the exact row, the four
    bf16 variants launched once per substep of each linearization block."""
    reset_counts(act, dyn)
    rec = bench.run(batch=BATCH, horizon=HORIZON, iterations=ITERATIONS,
                    runs=ILQR_TIMED_RUNS, device="cuda", ilqr=True)
    torch.cuda.synchronize()
    counts = read_counts(act, dyn)
    drop = check_ilqr_record(rec, 10)
    prob = rec["problem"][0]
    S, relin = prob.config.solver_substeps, prob.config.relin_every
    blocks = -(-HORIZON // ilqr.linearization_blocks(BATCH, HORIZON, N_TANGENTS))
    primal = S * (HORIZON + rec["solves"] * (HORIZON + ITERATIONS * HORIZON))
    lin = rec["solves"] * S * blocks * -(-ITERATIONS // relin)
    check_counts(counts, {"actuation": primal, "contact": primal, "actuation_jvp": 0,
                          "contact_jvp": 0, "contact_anchored": 0, "env_substeps": 0,
                          "planner_rollout": 0, **dict.fromkeys(BF16_KERNELS, lin)}, 10)
    gap = (rec["mean_final_cost"] - exact_cost) / abs(exact_cost)
    print(f"phase 10: {rec['solves']} full-width iLQR solves, bf16 linearization "
          f"relinearized every {relin}: {rec['value']:.3f} solves/s on {kind}; mean cost "
          f"{rec['warm_start_mean_cost']:.4f} -> {rec['mean_final_cost']:.4f} (drop "
          f"{drop:.4f}, margin {ILQR_MARGIN}); {gap:+.2%} of the exact row's "
          f"{exact_cost:.4f}; launches {counts}", flush=True)
    print(json.dumps({"ilqr_bench_bf16": {
        **bench.line(rec), "warm_start_mean_cost": rec["warm_start_mean_cost"],
        "gap_to_exact": gap, "stage_seconds_last_solve": rec["stage_times"]}}))
    return counts


def _closed_loop_worker(full_rate):
    """Phase 11, in a process of its own: one closed loop on the card.
    Returns its record, the kernels' launches and the wall time."""
    import torch

    from quadruped_springs_tpu_torch import closed_loop
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts(act, dyn)
    t0 = time.perf_counter()
    out = closed_loop.run(LOOP_KNOTS, LOOP_REPLAN, device="cuda", full_rate=full_rate)
    torch.cuda.synchronize()
    return {"out": out, "launches": read_counts(act, dyn),
            "seconds": time.perf_counter() - t0}


def check_closed_loop(res, kind, full_rate):
    """Phase 11: receding-horizon MPC executed on the stiff 1 kHz simulator
    (closed_loop.execute_knot, the JAX loop's executor), at the JAX loop's
    defaults: iLQR on the relaxed model or, with full_rate, MPPI on the
    execution-rate model; held to the bars of tests/test_transfer.py's
    closed-loop gate."""
    from quadruped_springs_tpu_torch import closed_loop

    out, counts, wall = res["out"], res["launches"], res["seconds"]
    name = "full-rate MPPI" if full_rate else "iLQR"
    planned, executed = out["planned_apex_max_m"], out["executed_apex_m"]
    if not (out["finite"] and out["upright"] and out["airborne_knots"] > 0
            and executed > 0.45 and abs(planned - executed) < LOOP_BAND * planned):
        raise AssertionError(f"phase 11: the {name} loop misses the closed-loop gate "
                             f"(executed apex > 0.45 m, upright, within {LOOP_BAND:.0%} of the "
                             f"planned {planned} m): {out}")
    H, its = (closed_loop.FULL_RATE_HORIZON if full_rate else 20), 4
    # the executor: one planner_rollout launch per knot; MPPI's solves one
    # planner_rollout_cost per rollout, iLQR's substeps through `actuation`
    # and `contact`
    if full_rate:
        primal, tangent, mppi = 0, 0, mppi_launches(out["solves"], its)
    else:
        primal = out["solves"] * 2 * (H + its * (1 + H))
        tangent, mppi = out["solves"] * 2 * its, mppi_launches(0, its)
    check_counts(counts, {**mppi, "planner_rollout": LOOP_KNOTS, "actuation": primal,
                          "contact": primal, "actuation_jvp": tangent,
                          "contact_jvp": tangent, "contact_anchored": 0, "env_substeps": 0,
                          **dict.fromkeys(BF16_KERNELS, 0)}, 11)
    print(f"phase 11: {name} closed loop ({out['planner']}) of {LOOP_KNOTS} knots, "
          f"{out['solves']} solves (H={H}, {its} iterations) in {wall:.2f} s on {kind}: "
          f"planned apex {planned:.3f} m, executed {executed:.3f} m "
          f"({(executed - planned) / planned:+.1%}, band {LOOP_BAND:.0%}), final height "
          f"{out['final_z_m']:.3f} m, airborne for {out['airborne_knots']} knots; "
          f"launches {counts}", flush=True)
    print(json.dumps({"closed_loop_full_rate" if full_rate else "closed_loop": out}))
    return counts


def _replay_worker(name):
    """Phase 13, in a process of its own: one behaviour's replay on the card.
    Returns its record, the kernels' launches, the launches its resets and
    env steps call for, and the wall time."""
    import torch

    from quadruped_springs_tpu_torch import policy_replay
    from quadruped_springs_tpu_torch.env.env import QuadrupedEnv
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts(act, dyn)
    t0 = time.perf_counter()
    with EnvCalls(QuadrupedEnv) as calls:
        rec = policy_replay.BEHAVIORS[name](lanes=REPLAY_LANES, device="cuda")
    torch.cuda.synchronize()
    return {"record": rec, "launches": read_counts(act, dyn), "want": calls.launches(),
            "resets": calls.resets, "steps": calls.steps,
            "seconds": time.perf_counter() - t0}


def run_host_bound_paths(policy_replay, kind):
    """Phases 11, 13, 16, 17, 20-25 and 27 at once: the two closed loops, the
    replays of the committed policies, the six oracle traces, the transfer
    gate, the behaviours, comparisons, examples, two-stage, behaviour and
    continuous-jumping trainers and the backflip's recorder are
    bound by the host's launches, so they run as HOST_PROCESSES spawned
    processes on the one card, the longest first. Each process counts its
    own kernels' launches."""
    from quadruped_springs_tpu_torch.runtime import trajstore

    trajstore.library()              # build the store once, before the workers read it
    replays = list(policy_replay.BEHAVIORS)
    robots = ("springs", "rigid")
    added = ([(_learned_worker, r) for r in robots] + [(_example_worker, job)
                                                       for job in EXAMPLE_JOBS]
             + [(_planned_worker, r) for r in robots])
    jobs = ([(_continuous_trainer_worker, None)]
            + [(_two_stage_worker, job) for job in TWO_STAGE_JOBS]
            + [(_behaviour_trainer_worker, job) for job in BEHAVIOUR_TRAINERS]
            + [(_noise_repair_worker, None)]
            + [(_behaviour_worker, job) for job in BEHAVIOUR_JOBS]
            + [(_closed_loop_worker, True), (_transfer_gate_worker, None),
               (_closed_loop_worker, False)] + added[:2] + [(_replay_worker, n)
                                                           for n in replays]
            + [(_oracle_trace_worker, job) for job in ORACLE_TRACES] + added[2:]
            + [(_render_backflip_worker, None)])
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(HOST_PROCESSES) as pool:
        pending = [pool.apply_async(fn, (arg,)) for fn, arg in jobs]
        results = [r.get() for r in pending]
    wall = time.perf_counter() - t0
    print(f"phases 11, 13, 16, 17, 20-25 and 27: {len(jobs)} host-bound paths in {wall:.2f} s "
          f"({HOST_PROCESSES} processes on one card)", flush=True)
    by_fn = {}
    for (fn, arg), res in zip(jobs, results):
        by_fn.setdefault(fn, []).append((arg, res))
    results = [res for (fn, _), res in zip(jobs, results) if fn not in (
        _learned_worker, _example_worker, _planned_worker, _two_stage_worker,
        _behaviour_trainer_worker, _noise_repair_worker, _continuous_trainer_worker,
        _render_backflip_worker)]
    behaviours, results = results[:len(BEHAVIOUR_JOBS)], results[len(BEHAVIOUR_JOBS):]
    by_path = {"closed_loop_full_rate": check_closed_loop(results[0], kind, True),
               "closed_loop": check_closed_loop(results[2], kind, False)}
    k = 3 + len(replays)
    by_path.update(check_replays(dict(zip(replays, results[3:k])), policy_replay, kind))
    by_path["oracle_gate"] = check_oracle_gate(results[k:], kind)
    by_path["transfer_gate"] = check_transfer_gate(results[1], kind)
    by_path.update(check_behaviours(behaviours, kind))
    by_path.update(check_planned(dict(by_fn[_planned_worker]), kind))
    by_path.update(check_learned(dict(by_fn[_learned_worker]), kind))
    by_path.update(check_examples([res for _, res in by_fn[_example_worker]], kind))
    by_path.update(check_two_stage(dict(by_fn[_two_stage_worker]), kind))
    by_path.update(check_behaviour_trainers(dict(by_fn[_behaviour_trainer_worker]), kind))
    by_path.update(check_noise_repair(by_fn[_noise_repair_worker][0][1], kind))
    by_path["continuous_policy_smoke"] = check_continuous_trainer(
        by_fn[_continuous_trainer_worker][0][1], kind)
    by_path["render_backflip"] = check_render_backflip(by_fn[_render_backflip_worker][0][1],
                                                       kind)
    return by_path


# kernel name -> (wrapper, its launch counter)
COUNTERS = {"env_substeps": ("ss", "launches"), "planner_rollout": ("ro", "launches"),
            "actuation": ("act", "launches"), "contact": ("dyn", "launches"),
            "contact_anchored": ("dyn", "anchored_launches"),
            "actuation_jvp": ("act", "jvp_launches"), "contact_jvp": ("dyn", "jvp_launches"),
            "actuation_bf16": ("act", "bf16_launches"), "contact_bf16": ("dyn", "bf16_launches"),
            "actuation_jvp_bf16": ("act", "bf16_jvp_launches"),
            "contact_jvp_bf16": ("dyn", "bf16_jvp_launches"),
            "env_substeps_vjp": ("vjp", "launches"),
            "planner_rollout_cost": ("roc", "launches"), "mppi_update": ("upd", "launches")}
BF16_KERNELS = ("actuation_bf16", "contact_bf16", "actuation_jvp_bf16", "contact_jvp_bf16")


def _counter_owner(act, dyn, which):
    if which == "upd":
        from quadruped_springs_tpu_torch.solver import mppi_update

        return mppi_update.mppi_update
    if which == "roc":
        from quadruped_springs_tpu_torch.solver import rollout

        return rollout.planner_rollout_cost
    if which in ("ss", "vjp"):
        from quadruped_springs_tpu_torch.env import substeps

        return substeps.env_substeps if which == "ss" else substeps.env_substeps_vjp
    if which == "ro":
        from quadruped_springs_tpu_torch.solver import rollout

        return rollout.planner_rollout
    return act.actuation_torque if which == "act" else dyn.contact_forces


def reset_counts(act, dyn):
    for which, attr in COUNTERS.values():
        setattr(_counter_owner(act, dyn, which), attr, 0)


def read_counts(act, dyn):
    return {name: getattr(_counter_owner(act, dyn, which), attr)
            for name, (which, attr) in COUNTERS.items()}


def mppi_launches(solves, iterations, fused=True):
    """What an MPPI path launches for `solves` solves of `iterations`: one
    planner_rollout_cost a rollout and one mppi_update before each (the
    fused accept: iterations + 1 of each a solve; the accept rollout every
    iteration: 2 + 2 x iterations), the xs-only planner_rollout never."""
    n = solves * ((iterations + 1) if fused else (2 + 2 * iterations))
    return {"planner_rollout": 0, "planner_rollout_cost": n, "mppi_update": n}


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
    # one env_substeps for the settle, one per control step
    check_counts(counts, {"env_substeps": 1 + (1 + ENV_SEGMENTS) * ENV_STEPS,
                          "actuation": 0, "contact_anchored": 0, "contact": 1}, 6)
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
    breakdown = lambda: env_bench.profile_steps(env, s, actions, gen, steps=3)
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
    return counts, step_syncs, breakdown


def run_landing_episode(torch, act, dyn, kind):
    """Phase 7: the examples/run_episode.py flow on a batch of environments."""
    from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv, select
    from quadruped_springs_tpu_torch.env.wrappers import LandingWrapper

    env = QuadrupedEnv(EnvConfig(enable_springs=True, motor_control_mode="PD",
                                 action_space_mode="SYMMETRIC", task_env="JUMPING_IN_PLACE",
                                 observation_space_mode="ARS_BASIC",
                                 env_randomizer_mode="GROUND_RANDOMIZER",
                                 max_ep_len=EPISODE_LEN, settling_steps=EPISODE_SETTLE),
                       device="cuda")
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
    check_counts(counts, {"env_substeps": 1 + steps[0], "actuation": 0,
                          "contact_anchored": 0, "contact": 1}, 7)
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


class EnvCalls:
    """Counts QuadrupedEnv.reset and .step calls (and the resets that
    settled) while it is active, by wrapping the class's methods."""

    def __init__(self, env_cls):
        self.cls, self.resets, self.steps, self.settles = env_cls, 0, 0, 0

    def __enter__(self):
        self._reset, self._step = self.cls.reset, self.cls.step
        calls = self

        def reset(env, *a, **k):
            calls.resets += 1
            if k.get("desired_robot_state") is None and env.config.settling_steps:
                calls.settles += 1
            return calls._reset(env, *a, **k)

        def step(env, *a, **k):
            calls.steps += 1
            return calls._step(env, *a, **k)

        self.cls.reset, self.cls.step = reset, step
        return self

    def __exit__(self, *exc):
        self.cls.reset, self.cls.step = self._reset, self._step

    def launches(self):
        """One env_substeps per settle and per control step, one contact per
        reset (the contact priming), no per-substep kernel."""
        return {"env_substeps": self.settles + self.steps, "actuation": 0,
                "contact_anchored": 0, "contact": self.resets, "actuation_jvp": 0,
                "contact_jvp": 0}


def check_replays(results, policy_replay, kind):
    """Phase 13: the committed policies, held to the JAX gates' bars."""
    by_path, records = {}, {}
    for name, res in results.items():
        rec, counts, wall = res["record"], res["launches"], res["seconds"]
        check_counts(counts, res["want"], 13)
        by_path[f"replay_{name}"], records[name] = counts, rec
        lists = {k: v for k, v in rec.items() if isinstance(v, list) and k != "ok"}
        failing = [{"lane": i, **{k: v[i] for k, v in lists.items()}}
                   for i, ok in enumerate(rec["ok"]) if not ok]
        print(f"phase 13: {name}: {rec['passed']}/{rec['lanes']} lanes meet the bars "
              f"{rec['bars']} in {wall:.2f} s on {kind} ({res['resets']} resets, "
              f"{res['steps']} env steps; launches {counts})"
              + (f"; failing lanes: {failing}" if failing else ""), flush=True)
    # which lanes decide: for the launch policy that the JAX package gates on
    # one friction, the gate's own scenario (lane 0) and every lane whose
    # friction lies at or above the edge below which the JAX package's replay
    # falls over as well (policy_replay.UPRIGHT_FRICTION_EDGE); every lane of
    # the nominal replays; the TEST_RANDOMIZER lanes with observation noise
    # are reported
    flip = records["backflip"]
    if not (flip["gated"][0] and flip["gated_lanes"] > REPLAY_LANES // 2):
        raise AssertionError(f"phase 13: backflip gates {flip['gated_lanes']} lanes")
    print(f"phase 13: backflip: {flip['gated_passed']}/{flip['gated_lanes']} lanes at "
          f"friction >= {policy_replay.UPRIGHT_FRICTION_EDGE} (lane 0: the JAX gate's "
          f"{flip['friction'][0]:.4f}) meet the bars", flush=True)
    gates = {"backflip": [ok for ok, g in zip(flip["ok"], flip["gated"]) if g],
             **{k: records[k]["ok"] for k in ("backflip_nominal", "forward", "two_stage",
                                              "continuous")}}
    for name, ok in gates.items():
        if not all(ok):
            raise AssertionError(f"phase 13: {name}: {sum(ok)}/{len(ok)} gate lanes pass")
    cont = records["continuous"]
    if not (cont["good_jumps_min"] >= policy_replay.GOOD_JUMPS_BAR
            and cont["mean_perf_mean"] >= policy_replay.MEAN_PERF_BAR):
        raise AssertionError(f"phase 13: continuous: good jumps min {cont['good_jumps_min']}, "
                             f"mean performance {cont['mean_perf_mean']}")
    print(json.dumps({"replay": {
        name: {k: v for k, v in rec.items() if not isinstance(v, list)}
        for name, rec in records.items()}}))
    return by_path


def run_train(torch, train_bench, act, dyn, kind):
    """Phase 14: the two trainers at the widths of the JAX training runs."""
    reset_counts(act, dyn)
    rec = train_bench.run(steps=TRAIN_STEPS, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts(act, dyn)
    ars, ppo, im = rec["ars"], rec["ppo"], rec["imitation"]
    a_cfg, p_cfg = train_bench.ARS_CONFIG, train_bench.PPO_CONFIG
    i_cfg = train_bench.st.POLISH_PPO
    all_steps = train_bench.WARMUP_STEPS + TRAIN_STEPS
    # env_substeps launches: an ARS step settles its reset bank once and rolls
    # episode_steps control steps; a PPO step rolls segment_len
    ars_env, ppo_env = 1 + a_cfg.episode_steps, p_cfg.segment_len
    none = {"actuation": 0, "contact_anchored": 0}
    # `launches` are the timed steps'; the whole phase's follow below
    check_counts(ars["launches"], {"env_substeps": TRAIN_STEPS * ars_env,
                                   "contact": TRAIN_STEPS, **none}, 14)
    check_counts(ppo["launches"], {"env_substeps": TRAIN_STEPS * ppo_env, "contact": 0,
                                   **none}, 14)
    check_counts(ppo["init_launches"], {"env_substeps": 1, "contact": 1, **none}, 14)
    # the polish: its RSI bank's reset settles nothing
    check_counts(im["launches"], {"env_substeps": TRAIN_STEPS * i_cfg.segment_len,
                                  "contact": 0, **none}, 14)
    check_counts(im["init_launches"], {"env_substeps": 0, "contact": 1, **none}, 14)
    # the bench's last segment, rolled alone to time it, adds one segment; the
    # BC pairs of each demo take a settled reset and a reset at its rows
    n_demos = im["demos"]
    total = (all_steps * (ars_env + ppo_env + i_cfg.segment_len) + 1 + ppo_env + n_demos)
    check_counts(counts, {"env_substeps": total, "contact": all_steps + 2 + 2 * n_demos,
                          "actuation_jvp": 0, "contact_jvp": 0, **none}, 14)
    for algo in (ars, ppo, im):
        for m in algo["metrics"]:
            bad = {k: v for k, v in m.items() if v != v or abs(v) == float("inf")}
            if bad:
                raise AssertionError(f"phase 14: non-finite metrics {bad}")
    a0, a1 = ars["state0"], ars["state"]
    live = sum(m["live_steps"] for m in ars["metrics"])
    grew = float(a1.obs_norm.count - a0.obs_norm.count)
    lanes_steps = ars["lanes"] * a_cfg.episode_steps
    # every step is held alone: it rolled live steps, and it moved W unless
    # the top directions' returns were all equal (sigma_r is then its 1e-8
    # floor and the update is 0 by the algorithm: the sparse task pays nothing
    # to a policy that does not jump, and the JAX package's own run at this
    # width returned 0 in its steps 2 to 5, examples/out/two_stage_results.json)
    ars_dw = [m["max_weight_change"] for m in ars["metrics"]]
    for i, m in enumerate(ars["metrics"]):
        if not 0 < m["live_steps"] <= lanes_steps:
            raise AssertionError(f"phase 14: ARS step {i} had {m['live_steps']} live steps")
        if not (m["max_weight_change"] > 0 or m["sigma_r"] < 2e-8):
            raise AssertionError(f"phase 14: ARS step {i} left W unchanged at sigma_r "
                                 f"{m['sigma_r']}")
    if not (ars_dw[0] > 0 and bool(torch.isfinite(a1.W).all())):
        raise AssertionError("phase 14: ARS's first step left W unchanged, or W non-finite")
    if abs(grew - live) > 1e-3 * live:
        raise AssertionError(f"phase 14: the ARS statistics grew by {grew}, the rollouts "
                             f"had {live} live steps")
    p0, p1 = ppo["state0"], ppo["state"]
    ppo_dw = [m["max_weight_change"] for m in ppo["metrics"]]
    actor1 = [p for n, p in p1.net.named_parameters() if not n.startswith("vf_")]
    if not (all(d > 0 for d in ppo_dw) and all(bool(torch.isfinite(p).all()) for p in actor1)):
        raise AssertionError(f"phase 14: a PPO step left the actor unchanged ({ppo_dw}), or "
                             "a parameter non-finite")
    seg = all_steps * p_cfg.n_envs * p_cfg.segment_len
    grew = float(p1.obs_norm.count - p0.obs_norm.count)
    if abs(grew - seg) > 1e-3 * seg:
        raise AssertionError(f"phase 14: the PPO statistics grew by {grew}, expected {seg}")
    print(f"phase 14: {all_steps} ARS train_steps, the last {TRAIN_STEPS} timed "
          f"({ars['lanes']} lanes x {a_cfg.episode_steps} steps, bank "
          f"{a_cfg.reset_bank_size}): {ars['seconds_per_step']:.3f} s per step, "
          f"{ars['env_steps_per_s']:.1f} env steps/s, {live:.0f} live steps, max |dW| per "
          f"step {ars_dw} at sigma_r {[m['sigma_r'] for m in ars['metrics']]}, host syncs "
          f"per step {ars['host_syncs']} {ars['host_syncs_at']}; {all_steps} PPO "
          f"train_steps, the last {TRAIN_STEPS} timed ({p_cfg.n_envs} envs x "
          f"{p_cfg.segment_len} steps, {p_cfg.n_epochs} x {p_cfg.n_minibatches} minibatches): "
          f"{ppo['seconds_per_step']:.3f} s per step ({ppo['rollout_seconds']:.3f} s of it "
          f"the segment rollout), {ppo['env_steps_per_s']:.1f} env steps/s, max actor "
          f"change per step {ppo_dw}, host syncs per step {ppo['host_syncs']} "
          f"{ppo['host_syncs_at']}, on {kind}; launches {counts}", flush=True)
    im_dw = [m["max_weight_change"] for m in im["metrics"]]
    actor1 = [p for n, p in im["state"].net.named_parameters() if not n.startswith("vf_")]
    if not (all(d > 0 for d in im_dw) and all(bool(torch.isfinite(p).all()) for p in actor1)
            and im["state"].obs_norm is im["state0"].obs_norm):
        raise AssertionError(f"phase 14: a polish step left the actor unchanged ({im_dw}), a "
                             "parameter non-finite, or moved the frozen statistics")
    print(f"phase 14: the imitation stage (the BC-anchored polish, bc_coef "
          f"{i_cfg.bc_coef}): bc.fit of {im['bc_iters']} iterations on {im['bc_rows']} rows of "
          f"{im['demos']} demos in {im['bc_seconds']:.3f} s (mse {im['bc_mse']:.3e}); "
          f"{all_steps} PPO train_steps on JUMPING_IN_PLACE_DEMO, the last {TRAIN_STEPS} "
          f"timed ({i_cfg.n_envs} envs x {i_cfg.segment_len} steps from the RSI bank): "
          f"{im['steps_per_s']:.3f} steps/s ({im['seconds_per_step']:.3f} s per step), "
          f"{im['env_steps_per_s']:.1f} env steps/s, max actor change per step {im_dw}, "
          f"host syncs per step {im['host_syncs']} {im['host_syncs_at']} on {kind}",
          flush=True)
    print(json.dumps({"train_bench": train_bench.public(rec)}))
    if ars["host_syncs"][-1] or ppo["host_syncs"][-1] or im["host_syncs"][-1]:
        raise AssertionError("phase 14: a warm train_step synchronised the host: "
                             f"{ars['host_syncs_at']} {ppo['host_syncs_at']} "
                             f"{im['host_syncs_at']}")
    return counts


def run_adapters(torch, act, dyn, kind):
    """Phase 15: the two branch-free autopilot adapters read nothing on the
    host (any synchronisation raises in the "error" debug mode)."""
    from quadruped_springs_tpu_torch.env import flat_rollout
    from quadruped_springs_tpu_torch.env.continuous_autopilot import ContinuousAutopilotEnv
    from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv

    gen = torch.Generator("cuda").manual_seed(3)
    common = dict(enable_springs=True, action_space_mode="SYMMETRIC", settling_steps=100)
    aenv = ContinuousAutopilotEnv(QuadrupedEnv(EnvConfig(
        task_env="CONTINUOUS_JUMPING_FORWARD3",
        observation_space_mode="PPO_CONTINUOUS_JUMPING_FORWARD", **common), device="cuda"))
    fenv = QuadrupedEnv(EnvConfig(task_env="BACKFLIP", observation_space_mode="ARS_BACKFLIP",
                                  **common), device="cuda")
    reset_counts(act, dyn)
    astate, _ = aenv.reset(gen, ADAPTER_LANES)
    fstate, fobs = fenv.reset(gen, ADAPTER_LANES)
    action = aenv.get_init_action().expand(ADAPTER_LANES, -1)
    landing = fenv.get_landing_action().expand(ADAPTER_LANES, -1)
    # warm: each path's device constants are made once per device, by a copy
    # from the host that the debug mode would flag
    astate = aenv.step(astate, action, gen)[0]
    flat_rollout.backflip_episode(fenv, lambda o: landing, lambda o: landing, fstate, fobs,
                                  1, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        astate, _, _, _, info = aenv.step(astate, action, gen)
        fstate, phase, traj = flat_rollout.backflip_episode(
            fenv, lambda o: landing, lambda o: landing, fstate, fobs, ADAPTER_KNOTS, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = read_counts(act, dyn)
    # two settles, then 3 + ADAPTER_KNOTS control steps
    check_counts(counts, {"env_substeps": 2 + 3 + ADAPTER_KNOTS, "actuation": 0,
                          "contact_anchored": 0, "contact": 2, "actuation_jvp": 0,
                          "contact_jvp": 0}, 15)
    if not (bool(info["policy_in_control"].all()) and traj["phase"].shape ==
            (ADAPTER_KNOTS, ADAPTER_LANES) and bool(torch.isfinite(traj["z"]).all())):
        raise AssertionError("phase 15: the adapters' outputs are off")
    print(f"phase 15: ContinuousAutopilotEnv.step and a {ADAPTER_KNOTS}-step flattened "
          f"backflip episode at {ADAPTER_LANES} lanes on {kind}: no host sync (sync debug "
          f"mode \"error\"); launches {counts}", flush=True)
    return counts


def check_fidelity_widths(torch, act, dyn, model):
    """Before phase 16: the environment's three kernels against their twins
    at the fidelity gates' widths, one lane (phase 16) and two (phase 17),
    with fidelity_env's constants: the motor gains with springs and without,
    180 kN/m and 100 N s/m, the clamp on and off. The hand-placed regimes
    need 6 lanes, so each check launches its kernel on consecutive blocks of
    1 or 2 of SMALL_INPUT_LANES lanes: 12 and 24 threads, a partial block."""
    from quadruped_springs_tpu_torch.utils.verification import fidelity_env

    checks = {"actuation": {}, "contact": {}, "contact_anchored": {}}
    for springs in (True, False):
        env = fidelity_env("JUMPING_IN_PLACE", springs, device="cuda")
        sim = env.sim_params
        for lanes in FIDELITY_LANES:
            tag = f"fidelity_{lanes}" + ("" if springs else "_nospring")
            checks["actuation"][tag] = check_actuation(torch, act, env, SMALL_INPUT_LANES,
                                                       lanes=lanes)
            if not springs:
                continue      # the contact laws do not depend on the springs
            contact = check_contact(torch, dyn, model, SMALL_INPUT_LANES,
                                    sim.contact_stiffness, sim.contact_damping, lanes)
            anchored = check_anchored_contact(torch, dyn, model, SMALL_INPUT_LANES, lanes)
            for clamp, ctag in ((True, "_clamp"), (False, "")):
                checks["contact"][tag + ctag] = contact[clamp]
                checks["contact_anchored"][tag + ctag] = anchored[clamp]
    for name, by_setting in checks.items():
        for tag, r in by_setting.items():
            if not tag.startswith("fidelity_1"):
                del r["profile"]   # phase 12 profiles one launch at one lane
        worst = max(by_setting.values(), key=lambda r: r["max_abs_err"])
        ms = [r["ms"] for r in by_setting.values()]
        print(f"phase 16: {name} against its twin at {len(by_setting)} settings of "
              f"{FIDELITY_LANES} lanes per launch: max_abs_err {worst['max_abs_err']:.3e} "
              f"(bound {REL_TOL}·(1+|twin|)), kernel {min(ms):.4f}-{max(ms):.4f} ms through "
              f"its wrapper", flush=True)
    return checks


def fidelity_substeps_settings(torch):
    """env_substeps's settings at the fidelity gates' width, one lane: a
    control step (10 substeps) from the settled fidelity env under a random
    command, the oracle replay's settle (2,500 substeps from the initial
    pose, the command held), and the CPG example's control step (one
    substep of a held torque in TORQUE mode on the rigid robot). Returns
    {setting: env_substeps's arguments}."""
    from quadruped_springs_tpu_torch import examples
    from quadruped_springs_tpu_torch.control import interfaces as ci
    from quadruped_springs_tpu_torch.env import randomizers as rnd
    from quadruped_springs_tpu_torch.utils.verification import fidelity_env

    env = fidelity_env("JUMPING_IN_PLACE", True, device="cuda")
    gen = torch.Generator("cuda").manual_seed(22)
    state, _ = env.reset(gen, 1)
    action = 2.0 * torch.rand((1, env.action_dim), generator=gen, device="cuda") - 1.0
    command = lambda a: ci.action_to_command(env.iface, a).contiguous()
    q_des = torch.stack([command(state.last_action + ((i + 1.0) / 10)
                                 * (action - state.last_action)) for i in range(10)], dim=1)
    robot = env._init_robot_state(1)
    start = dataclasses.replace(state, robot=robot, foot_anchor=env._feet_anchor(
        rnd.model_from_params(state.scenario), robot))
    settle = env.config.settling_steps
    # the CPG example's environment: the rigid robot in TORQUE mode, one
    # substep a control step, a held torque
    cpg = examples.cpg_env("cuda")
    cpg_state, _ = cpg.reset(gen, 1)
    torques = 16.0 * torch.rand((1, 12), generator=gen, device="cuda") - 8.0
    return {"fidelity_1x10": env_substeps_args(env, state, q_des, 10),
            f"fidelity_1x{settle}_settle": env_substeps_args(
                env, start, env._settle_q_des.expand(1, 12).contiguous(), settle),
            "cpg_1x1_torque": env_substeps_args(cpg, cpg_state, torques, 1, torque_mode=True)}


def check_fidelity_substeps(torch, ss, kind):
    """Before phase 16: env_substeps against its plain version at
    fidelity_substeps_settings."""
    checks = {setting: check_env_substeps(torch, ss, args,
                                          reps=5 if setting.endswith("settle") else 30)
              for setting, args in fidelity_substeps_settings(torch).items()}
    for setting, r in checks.items():
        print(f"phase 16: env_substeps ({setting}): max_abs_err {r['max_abs_err']:.3e} "
              f"({r['spread_used']:.2f} spreads used), kernel {r['ms']:.4f} ms through its "
              f"wrapper, {r['kernel_ms'] * 1e3:.2f} µs on the card (back-to-back launches "
              f"between two CUDA events), plain {r['plain_ms']:.2f} ms; bound "
              f"{r['bound_ms'] * 1e3:.3f} µs on {kind}", flush=True)
    return checks


def _oracle_trace_worker(job):
    """Phase 16, in a process of its own: one committed oracle trace through
    the port's verify_against_trace on the card. Returns the report, the
    kernels' launches and the wall time."""
    import torch

    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act
    from quadruped_springs_tpu_torch.utils import verification as V

    task, springs = job
    torch.backends.cuda.matmul.allow_tf32 = False
    env = V.fidelity_env(task, springs, device="cuda")
    path = f"tests/data/oracle_{task.lower()}{'' if springs else '_nospring'}.qsts"
    reset_counts(act, dyn)
    t0 = time.perf_counter()
    report = V.verify_against_trace(env, path, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    return {"report": report, "launches": read_counts(act, dyn),
            "seconds": time.perf_counter() - t0,
            "substeps": env.config.settling_steps + env.config.action_repeat * report["steps"],
            "want": {"env_substeps": 1 + report["steps"], "actuation": 0,
                     "contact_anchored": 0, "contact": 1, "actuation_jvp": 0,
                     "contact_jvp": 0}}


def check_oracle_gate(results, kind):
    """Phase 16: the six committed oracle traces through the port, each at
    its real size (fidelity_env, the 2,500-substep settle, every control
    step), one lane each, held to the gate of tests/test_golden_trace.py.
    `results` are _oracle_trace_worker's, in the order of ORACLE_TRACES."""
    total = dict.fromkeys(COUNTERS, 0)
    failed = []
    for (task, springs), res in zip(ORACLE_TRACES, results):
        r, sub = res["report"], res["substeps"]
        check_counts(res["launches"], res["want"], 16)
        for k, v in res["launches"].items():
            total[k] += v
        ok = (r["steps"] >= 170 and r["pass"] and r["static_flight_max_dev_frac"] < 0.02
              and r["mean_torque_dev_frac_pre_touchdown"] < 0.02
              and r["max_height_dev_m_pre_touchdown"] < 0.03
              and r["gated_fraction_strict"] >= 0.15
              and r["ungated_fraction_post_touchdown"] <= 0.55)
        name = task.lower() + ("" if springs else "_nospring")
        if not ok:
            failed.append(name)
        print(f"phase 16: oracle_{name}: pass {r['pass']}, static/flight "
              f"{r['static_flight_max_dev_frac']:.5f}, mean pre-touchdown "
              f"{r['mean_torque_dev_frac_pre_touchdown']:.5f}, height "
              f"{r['max_height_dev_m_pre_touchdown']:.5f} m, strict share "
              f"{r['gated_fraction_strict']:.4f}, post-touchdown "
              f"{r['ungated_fraction_post_touchdown']:.4f}; dynamic "
              f"{r['dynamic_max_dev_frac']:.5f}, events {r['event_timing_max_offset_knots']}, "
              f"apex {r['apex_max_dev_m']:.5f} m; {sub} substeps in {res['seconds']:.2f} s on "
              f"{kind}", flush=True)
    print(json.dumps({"oracle_gate": {
        task.lower() + ("" if springs else "_nospring"): {
            k: v for k, v in res["report"].items() if k not in ("gate", "tolerances")}
        for (task, springs), res in zip(ORACLE_TRACES, results)}}))
    print(f"phase 16: {len(ORACLE_TRACES)} oracle traces; launches {total}", flush=True)
    if failed:
        raise AssertionError(f"phase 16: the oracle gate fails on {failed}")
    return total


def check_transfer_block(torch, act, dyn, ilqr, prob):
    """Head of phase 17: the two tangent kernels against torch.func.jvp of
    their twins at the shape of the transfer gate's linearization. Its iLQR
    plan is a batch of one, so one block holds all HORIZON knots: 50 lanes
    x N_TANGENTS, 600 threads, the last 256-thread block partial (88)."""
    n = ilqr.linearization_blocks(1, HORIZON, N_TANGENTS)
    contact_jvp = check_contact_jvp(torch, dyn, n)
    checks = {"actuation_jvp": {"transfer_block": check_actuation_jvp(torch, act, prob, n)},
              "contact_jvp": {"transfer_block": contact_jvp[False],
                              "transfer_block_clamp": contact_jvp[True]}}
    report_checks(17, checks, f"{n} x {N_TANGENTS}", "lanes x tangents")
    return checks


def _transfer_gate_worker(_):
    """Phase 17, in a process of its own: tests/test_transfer.py's open-loop
    gate. One MPPI plan and one iLQR plan (H = 50, 10 iterations; iLQR with 8
    alphas) on the relaxed planner model from the settled state of
    fidelity_env, executed through record_golden_trace as two lanes of one
    fidelity_env (one settle). Returns per plan the planned and executed
    apex, the final height and tilt; the kernels' launches and the launches
    the plans and the replay call for; the wall time."""
    import torch

    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act
    from quadruped_springs_tpu_torch.solver import ilqr, mppi
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem, state_to_vec
    from quadruped_springs_tpu_torch.utils import verification as V

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts(act, dyn)
    t0 = time.perf_counter()
    prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=HORIZON, iterations=ITERATIONS,
                                n_alphas=ILQR_ALPHAS), "cuda")
    env = V.fidelity_env("JUMPING_IN_PLACE", device="cuda")
    state, _ = env.reset(torch.Generator("cuda").manual_seed(0), 1)
    x0 = state_to_vec(state.robot)
    u0 = prob.task_warm_start()
    mppi_cfg = mppi.MPPIConfig(horizon=HORIZON, iterations=ITERATIONS)
    plans = {"mppi": prob.solve_mppi(x0, u0[None], torch.Generator("cuda").manual_seed(1),
                                     mppi_cfg),
             "ilqr": ilqr.first_problem(prob.solve_batch(x0, u0[None]))}
    actions = torch.stack([plans["mppi"].us[0], plans["ilqr"].us])
    rows = V.record_golden_trace(env, actions, torch.Generator("cuda").manual_seed(2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    S = prob.config.solver_substeps
    blocks = -(-HORIZON // ilqr.linearization_blocks(1, HORIZON, N_TANGENTS))
    ilqr_sub = S * (HORIZON + ITERATIONS * (blocks + HORIZON))
    # the env: two settles (the plans' start, the replay's), HORIZON steps;
    # MPPI (per-iteration accept): its first, 2 per iteration and its last
    # rollout, one planner_rollout_cost launch each, as many mppi_update
    want = {"env_substeps": 2 + HORIZON, **mppi_launches(1, ITERATIONS, fused=False),
            "actuation": ilqr_sub, "contact_anchored": 0, "contact": 2 + ilqr_sub,
            "actuation_jvp": S * ITERATIONS * blocks, "contact_jvp": S * ITERATIONS * blocks}
    out = {}
    for lane, (name, sol) in enumerate(plans.items()):
        xs = sol.xs[0] if name == "mppi" else sol.xs
        got = V.split_trace(rows[lane].cpu().numpy(), env.action_dim)
        out[name] = {"planned_apex_m": float(xs[:, 2].max()),
                     "executed_apex_m": float(got["pos"][:, 2].max()),
                     "final_z_m": float(got["pos"][-1, 2]),
                     "final_tilt": float(abs(got["quat"][-1, 0]) + abs(got["quat"][-1, 1]))}
    return {"out": out, "launches": read_counts(act, dyn), "want": want, "seconds": wall}


def check_transfer_gate(res, kind):
    """Phase 17: both planned and executed apexes above 0.45 m, within 25% of
    each other, the robot upright at the end; launches exact."""
    out, counts = res["out"], res["launches"]
    check_counts(counts, res["want"], 17)
    failed = []
    for name, r in out.items():
        planned, executed = r["planned_apex_m"], r["executed_apex_m"]
        z_end, tilt = r["final_z_m"], r["final_tilt"]
        if not (planned > 0.45 and executed > 0.45
                and abs(planned - executed) < 0.25 * planned and z_end > 0.15 and tilt < 0.5):
            failed.append(name)
        print(f"phase 17: {name} plan: planned apex {planned:.3f} m, executed {executed:.3f} m "
              f"({(executed - planned) / planned:+.1%}), final height {z_end:.3f} m, "
              f"|qx|+|qy| {tilt:.4f}", flush=True)
    print(f"phase 17: the transfer gate in {res['seconds']:.2f} s on {kind} (reset, both "
          f"plans, one 2-lane replay); launches {counts}", flush=True)
    print(json.dumps({"transfer_gate": out}))
    if failed:
        raise AssertionError(f"phase 17: the transfer gate fails for {failed}: {out}")
    return counts


def random_lq(torch, gen, H, n, m):
    """tests/test_riccati_sharded.py's random LQ problem, one problem, drawn
    on the card."""
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    eye = lambda k: torch.eye(k, device="cuda")
    W, V = r(1, H, n, n) / n, r(1, H, m, m) / (4 * m)
    return (0.9 * eye(n) + 0.1 * r(1, H, n, n) / n, r(1, H, n, m) / n, r(1, H, n), r(1, H, m),
            W @ W.transpose(-1, -2) + 0.5 * eye(n), V @ V.transpose(-1, -2) + eye(m),
            0.1 * r(1, H, m, n), r(1, n), 2.0 * eye(n)[None])


def batch_rounding_probe(torch, ilqr, prob, rows):
    """Phase 18: every stage of an iLQR solve, on identical inputs, in
    batches of SHARDED_BATCH, GAP_ROWS and GAP_BLOCK problems; per stage and
    batch size, max |d| against the smallest batch over its GAP_BLOCK
    problems (0: bitwise equal). rows(a, b) gives (x0s, u0s, scenarios) of
    problems a..b. The backward sweep and its Cholesky solve run on seeded
    inputs of the Go1 problem's shapes."""
    from quadruped_springs_tpu_torch.models import spatial as sp

    sizes = (SHARDED_BATCH, GAP_ROWS)
    n, m = 37, prob.action_dim

    def knot(x0, u0, scen, lanes=1):      # lanes per problem: 1 rollout, alphas search
        x = x0[:, None].expand(-1, lanes, -1).contiguous()
        u = u0[:, None, 0].expand(-1, lanes, -1).contiguous()
        return prob.lane_dynamics(scen)(x, u)

    def tangents(x0, u0, scen):          # the knot's basis tangents: one linearization
        f = prob.lane_dynamics(scen)
        z = torch.cat([x0, u0[:, 0]], dim=-1)[:, None]
        return ilqr._basis_jvp(lambda z: f(z[..., :n], z[..., n:]), z)[1].movedim(1, 0)

    def cost_derivatives(x0, u0, scen):  # the stage cost's gradient and Hessian
        z = torch.cat([knot(x0, u0, scen)[:, 0], u0[:, 0]], dim=-1)[:, None]
        t = torch.zeros(1, dtype=torch.long, device=z.device)
        g = lambda z: torch.func.grad(
            lambda z: prob.stage_cost(z[..., :n], z[..., n:], t).sum())(z)
        return torch.cat([a.reshape(z.shape[0], -1) for a in (
            g(z), ilqr._basis_jvp(g, z)[1].movedim(1, 0))], dim=-1)

    gen = torch.Generator("cuda").manual_seed(7)
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    P, H = SHARDED_BATCH, 8
    eye_n, eye_m = torch.eye(n, device="cuda"), torch.eye(m, device="cuda")
    W, V, Vt = r(P, H, m, m), r(P, H, n, n), r(P, n, n)
    lq = (0.9 * eye_n + 0.1 * r(P, H, n, n) / n, r(P, H, n, m) / n,   # A, B
          r(P, H, n), r(P, H, m),                                      # lx, lu
          V @ V.transpose(-1, -2) / n + eye_n,                         # lxx
          W @ W.transpose(-1, -2) + m * eye_m,                         # luu
          0.1 * r(P, H, m, n),                                         # lux
          r(P, n), Vt @ Vt.transpose(-1, -2) / n + eye_n,              # Vx, Vxx
          torch.full((P,), 1e-3, device="cuda"))                       # reg
    rhs, dX = r(P, m, n + 1), r(P, ILQR_ALPHAS, n)
    cfg = ilqr.ILQRConfig(H)
    sweep = lambda k: torch.cat([a.reshape(k, -1).float() for a in ilqr.riccati_sequential(
        *(a[:k] for a in lq), cfg)], dim=-1)
    chol = lambda k: ilqr._chol_solve(lq[5][:k, 0], rhs[:k])[0]
    feedback = lambda k: sp.mv(lq[6][:k, None, 0], dX[:k])
    stages = {"knot": lambda k: knot(*rows(0, k)),
              "knot_line_search": lambda k: knot(*rows(0, k), lanes=ILQR_ALPHAS),
              "knot_tangents": lambda k: tangents(*rows(0, k)),
              "cost_derivatives": lambda k: cost_derivatives(*rows(0, k)),
              "riccati_sequential": sweep, "cholesky_solve": chol,
              "line_search_feedback": feedback}
    out = {}
    for name, f in stages.items():
        ref = f(GAP_BLOCK)
        out[name] = {k: float((f(k)[:GAP_BLOCK] - ref).abs().max()) for k in sizes}
    return out


def check_mppi_batching(torch, setting="headline"):
    """Phase 18: an MPPI solve with its standard-normal draws given, then
    its first GAP_ROWS rows as one batch and in batches of GAP_BLOCK with
    the same rows' draws: costs, controls, states and cost traces must be
    bitwise equal. `setting` is the headline's solve (JUMPING_IN_PLACE on
    the relaxed model, BATCH TEST_RANDOMIZER scenarios, K = SAMPLES, H =
    HORIZON, fused accept; GAP_MPPI_ITERATIONS iterations), "full_rate" the
    full-rate row's (H = FULL_RATE_HORIZON, 10 substeps a knot at 180 kN/m,
    the clamp on), or "compare_springs" / "compare_rigid" the planned
    comparison's for that robot (compare_springs.planned_rows: the nominal
    robot, H = HORIZON, PLANNED_ITERATIONS iterations of K =
    PLANNED_SAMPLES without the fused accept, at phase 21's batch of
    PLANNED_SEEDS x PLANNED_SOLVES rows; its entry point solves
    PLANNED_SOLVES = GAP_ROWS). Returns max |d| per batching and field."""
    from quadruped_springs_tpu_torch.env import randomizers as rnd
    from quadruped_springs_tpu_torch.env.env import take
    from quadruped_springs_tpu_torch.solver.mppi import MPPIConfig
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    compare = setting.startswith("compare")
    horizon = FULL_RATE_HORIZON if setting == "full_rate" else HORIZON
    iterations = PLANNED_ITERATIONS if compare else GAP_MPPI_ITERATIONS
    if compare:
        prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=horizon,
                                    iterations=iterations, n_alphas=8,
                                    enable_springs=setting == "compare_springs"), "cuda")
        cfg = MPPIConfig(horizon=horizon, iterations=iterations)
        assert (cfg.n_samples, cfg.fused_accept) == (PLANNED_SAMPLES, False)
        rows, scen = len(PLANNED_SEEDS) * PLANNED_SOLVES, None
    else:
        prob = MPCProblem((MPCConfig.full_rate if setting == "full_rate" else MPCConfig)(
            task="JUMPING_IN_PLACE", horizon=horizon, iterations=iterations), "cuda")
        cfg = MPPIConfig(horizon=horizon, iterations=iterations, n_samples=SAMPLES,
                         fused_accept=True)
        rows = BATCH
        scen = rnd.sample_scenario(prob.cfg, "TEST_RANDOMIZER",
                                   torch.Generator("cuda").manual_seed(0), n=rows)
    x0 = prob.default_x0().expand(rows, -1)
    u0 = prob.task_warm_start().expand(rows, -1, -1)
    noise = torch.randn((iterations, rows, cfg.n_samples, horizon, prob.action_dim),
                        generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    row = {"headline": "headline's", "full_rate": "full-rate row's",
           "compare_springs": "planned comparison's PEA",
           "compare_rigid": "planned comparison's rigid"}[setting]
    tag = "mppi" if setting == "headline" else f"mppi {setting}"
    fields = ("cost", "us", "xs", "cost_trace")

    def solve(a, b):
        sol = prob.solve_mppi(x0[a:b], u0[a:b], config=cfg, noise=noise[:, a:b],
                              scenario=None if scen is None else
                              take(scen, torch.arange(a, b, device="cuda")))
        return {k: getattr(sol, k) for k in fields}

    t0 = time.perf_counter()
    full, whole = solve(0, rows), solve(0, GAP_ROWS)
    split = [solve(i, i + GAP_BLOCK) for i in range(0, GAP_ROWS, GAP_BLOCK)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(torch.isfinite(full["cost"]).all()):
        raise AssertionError("phase 18: a non-finite MPPI cost")
    gap = {}
    for name, sol in ((str(rows), full), (f"{GAP_ROWS // GAP_BLOCK} x {GAP_BLOCK}", None)):
        for k in fields:
            got = (torch.cat([b[k] for b in split]) if sol is None else sol[k][:GAP_ROWS])
            gap[f"{tag} {name} {k}"] = float((got - whole[k]).abs().max())
    print(f"phase 18: MPPI (the {row} problem, {iterations} iterations) rows "
          f"0-{GAP_ROWS - 1} solved in batches of {rows}, {GAP_ROWS} and {GAP_BLOCK} with "
          f"the same draws: max |d| against the {GAP_ROWS}-row solve {gap} (0: bitwise "
          f"equal; {wall:.2f} s)", flush=True)
    moved = [k for k, v in gap.items() if v != 0.0]
    if moved:
        raise AssertionError(f"phase 18: the MPPI answer depends on the batch size: {moved}")
    return gap


def _sharded_problem(torch):
    """Phase 18's problem and scenarios: BACKFLIP (H=50, 10 iterations, 8
    alphas) on SHARDED_BATCH TEST_RANDOMIZER scenarios drawn from seed 0,
    with their starts and warm starts."""
    from quadruped_springs_tpu_torch.parallel.scenarios import sample_scenario_batch
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    prob = MPCProblem(MPCConfig(task="BACKFLIP", horizon=HORIZON, iterations=ITERATIONS,
                                n_alphas=ILQR_ALPHAS), "cuda")
    scenarios = sample_scenario_batch(prob.cfg, "TEST_RANDOMIZER",
                                      torch.Generator("cuda").manual_seed(0), SHARDED_BATCH)
    x0s = prob.default_x0().expand(SHARDED_BATCH, -1)
    u0s = prob.task_warm_start().expand(SHARDED_BATCH, -1, -1)
    return prob, x0s, u0s, scenarios


def _small_solve_worker(job):
    """Phase 18, in a process of its own: rows a..b of phase 18's problem
    solved as one batch (with the last row's start NaN when asked). Returns
    the costs, controls and cost traces on the CPU."""
    import torch

    from quadruped_springs_tpu_torch.env.env import take

    torch.backends.cuda.matmul.allow_tf32 = False
    a, b, nan_last = job
    prob, x0s, u0s, scenarios = _sharded_problem(torch)
    x0 = x0s[a:b].clone()
    if nan_last:
        x0[-1] = float("nan")
    sol = prob.solve_batch(x0, u0s[a:b], take(scenarios, torch.arange(a, b, device="cuda")))
    return {k: getattr(sol, k).cpu() for k in ("cost", "us", "cost_trace")}


def run_sharded(torch, act, dyn, ilqr, kind):
    """Phase 18: the scale-out path at world size 1 over NCCL on the card.
    sharded_solve of SHARDED_BATCH BACKFLIP TEST_RANDOMIZER scenarios (H = 50,
    10 iterations, 8 alphas: one card's share of BASELINE config 5) and its
    global statistics; the first GAP_ROWS of them solved again as one batch
    and in batches of GAP_BLOCK, one process each, all three batchings
    bitwise equal, and the per-stage probe; then sharded_lqt_backward on the
    Go1 problem's sizes against the port's sequential and single-device
    parallel sweeps."""
    import torch.distributed as dist

    from quadruped_springs_tpu_torch.env.env import take
    from quadruped_springs_tpu_torch.parallel import mesh as pmesh
    from quadruped_springs_tpu_torch.parallel.riccati import sharded_lqt_backward
    from quadruped_springs_tpu_torch.parallel.scenarios import global_stats, sharded_solve
    from quadruped_springs_tpu_torch.utils import profiling, sanitize

    pmesh.init_distributed()
    backend, mesh = dist.get_backend(), pmesh.scenario_mesh("cuda")
    prob, x0s, u0s, scenarios = _sharded_problem(torch)
    warm = ilqr.solve_batched(prob.lane_dynamics(scenarios), prob.stage_cost,
                              prob.terminal_cost, x0s, u0s,
                              dataclasses.replace(prob.ilqr_config, iterations=0)).cost
    torch.cuda.synchronize()
    reset_counts(act, dyn)
    t0 = time.perf_counter()
    # keep the solution sharded_solve computes (its cost traces) for the
    # batch-size check below
    solved, solve_batch = [], prob.solve_batch
    prob.solve_batch = lambda *a, **k: solved.append(solve_batch(*a, **k)) or solved[-1]
    try:
        with profiling.annotate("sharded_solve"):
            us, costs, diverged = sharded_solve(prob, x0s, u0s, scenarios, mesh)
            stats = global_stats(costs, diverged, mesh)
    finally:
        del prob.solve_batch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(act, dyn)
    S = prob.config.solver_substeps
    blocks = -(-HORIZON // ilqr.linearization_blocks(SHARDED_BATCH, HORIZON, N_TANGENTS))
    primal = S * (HORIZON + ITERATIONS * (blocks + HORIZON))
    check_counts(counts, {"actuation": primal, "contact": primal, "contact_anchored": 0,
                          "env_substeps": 0, "planner_rollout": 0,
                          "actuation_jvp": S * ITERATIONS * blocks,
                          "contact_jvp": S * ITERATIONS * blocks}, 18)
    finite = sanitize.finite_mask((us, costs))
    ok = ~diverged
    n_div, mean = int(stats["n_diverged"]), float(stats["mean_cost"])
    drop = float(warm.mean()) - mean
    print(f"phase 18: sharded_solve over {backend} at world size {dist.get_world_size()} "
          f"(mesh {tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}): {SHARDED_BATCH} BACKFLIP "
          f"scenarios (H={HORIZON}, {ITERATIONS} iterations, {ILQR_ALPHAS} alphas) in "
          f"{wall:.2f} s = {SHARDED_BATCH / wall:.3f} solves/s on {kind}; n_diverged {n_div}; "
          f"mean cost {float(warm.mean()):.4f} -> {mean:.4f} (drop {drop:.4f}, margin "
          f"{SHARDED_MARGIN}), best {float(stats['best_cost']):.4f}; launches {counts}",
          flush=True)
    if not (n_div == 0 and bool(torch.equal(finite, ok)) and bool(torch.isfinite(costs).all())):
        raise AssertionError(f"phase 18: {n_div} scenarios diverged, or a cost is not finite")
    # a step is accepted only where it lowers the problem's cost
    if bool((costs > warm).any()):
        raise AssertionError("phase 18: a scenario ended above its warm start's cost")
    if not drop > SHARDED_MARGIN:
        raise AssertionError(f"phase 18: the mean cost dropped by {drop}, not {SHARDED_MARGIN}")

    # the first GAP_ROWS scenarios again, as one batch and as batches of
    # GAP_BLOCK: a problem's answer must not depend on its batch's size
    rows = lambda a, b: (x0s[a:b], u0s[a:b], take(scenarios, torch.arange(a, b, device="cuda")))
    # the small solves are bound by the host's launches: one process each
    # (the same problem and scenarios, rebuilt from the same seed), and once
    # more with the last row's start NaN, which must leave the others as they
    # were
    jobs = [(0, GAP_ROWS, False)] + [(i, i + GAP_BLOCK, False)
                                     for i in range(0, GAP_ROWS, GAP_BLOCK)]
    jobs.append((0, GAP_ROWS, True))
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        sols = pool.map(_small_solve_worker, jobs)
    gap_wall = time.perf_counter() - t0
    whole, split, probe = sols[0], sols[1:-1], sols[-1]
    full = {k: getattr(solved[0], k).cpu() for k in whole}
    batchings = {f"{SHARDED_BATCH} (sharded_solve)": full, str(GAP_ROWS): whole,
                 f"{GAP_ROWS // GAP_BLOCK} x {GAP_BLOCK}": None}
    gap = {}
    for name, sol in batchings.items():
        for field in ("cost", "us", "cost_trace"):
            got = (torch.cat([b[field] for b in split]) if sol is None
                   else sol[field][:GAP_ROWS])
            gap[f"{name} {field}"] = float((got - whole[field]).abs().max())
    probe_diverged = ~(torch.isfinite(probe["cost"]) & torch.isfinite(probe["us"]).all(dim=(1, 2)))
    isolated = (bool(torch.equal(probe["us"][:-1], whole["us"][:-1]))
                and bool(torch.equal(probe["cost"][:-1], whole["cost"][:-1])))
    print(f"phase 18: rows 0-{GAP_ROWS - 1} solved in batches of {SHARDED_BATCH}, {GAP_ROWS} "
          f"and {GAP_BLOCK}: max |d| against the {GAP_ROWS}-row solve {gap} (0: bitwise "
          f"equal); with row {GAP_ROWS - 1}'s start NaN: diverged {probe_diverged.tolist()}, "
          f"the other rows bitwise unchanged: {isolated} ({gap_wall:.2f} s)", flush=True)
    gap["stages"] = batch_rounding_probe(torch, ilqr, prob, rows)
    print(f"phase 18: per stage, max |d| of the first {GAP_BLOCK} problems in batches of "
          f"{SHARDED_BATCH} and {GAP_ROWS} against one of {GAP_BLOCK}, on identical inputs: "
          f"{gap['stages']}", flush=True)
    traces = torch.cat([whole["cost_trace"]] + [b["cost_trace"] for b in split])
    if bool((traces[:, 1:] > traces[:, :-1]).any()):
        raise AssertionError("phase 18: a cost trace increases")
    if not (isolated and probe_diverged.tolist() == [False] * (GAP_ROWS - 1) + [True]):
        raise AssertionError("phase 18: a NaN scenario was not flagged, or it moved another row")
    moved = [k for k, v in gap.items() if k != "stages" and v != 0.0]
    moved += [f"{stage} at {k}" for stage, by in gap["stages"].items()
              for k, v in by.items() if v != 0.0]
    if moved:
        raise AssertionError(f"phase 18: the answer depends on the batch size: {moved}")
    for setting in ("headline", "full_rate", "compare_springs", "compare_rigid"):
        gap.update(check_mppi_batching(torch, setting))

    args = random_lq(torch, torch.Generator("cuda").manual_seed(5), HORIZON, 37, 6)
    reg_seq, reg_par = torch.tensor([1e-5], device="cuda"), torch.tensor([1e-2], device="cuda")
    ks_s, Ks_s, _, ok_s = ilqr.riccati_sequential(*args, reg_seq, ilqr.ILQRConfig(HORIZON))
    ks_p, Ks_p, _, ok_p = ilqr._parallel_lqt_backward(*args, reg_par)
    gains = {"seq": (sharded_lqt_backward(*args, reg_seq, mesh), (ks_s, Ks_s), (2e-3, 2e-4)),
             "par": (sharded_lqt_backward(*args, reg_par, mesh), (ks_p, Ks_p), (1e-4, 1e-5))}
    errs = {}
    for name, (got, want, (rtol, atol)) in gains.items():
        for g, w, k in zip(got, want, ("ks", "Ks")):
            errs[f"{name}_{k}"] = float((g - w).abs().max())
            if not torch.allclose(g, w, rtol=rtol, atol=atol):
                raise AssertionError(f"phase 18: sharded_lqt_backward {k} differs from the "
                                     f"{name} sweep by {errs[f'{name}_{k}']}")
    if not (bool(ok_s.all()) and bool(ok_p.all())):
        raise AssertionError("phase 18: a reference sweep failed")
    print(f"phase 18: sharded_lqt_backward at world size 1 (H={HORIZON}, n=37, m=6) against "
          f"riccati_sequential (rtol 2e-3, atol 2e-4) and _parallel_lqt_backward (rtol 1e-4, "
          f"atol 1e-5): max |d| {errs}", flush=True)
    print(json.dumps({"sharded_solve": {"solves_per_s": SHARDED_BATCH / wall, "seconds": wall,
                                        "n_diverged": n_div, "warm_start_mean_cost":
                                        float(warm.mean()), "mean_cost": mean,
                                        "best_cost": float(stats["best_cost"]),
                                        "batch_gap": gap, "lqt_max_abs_diff": errs}}))
    dist.destroy_process_group()
    return counts


# -- phase 19: the planner's rollout kernel --------------------------------

def rollout_problems(torch, prob, n, seed):
    """n TEST_RANDOMIZER problems of `prob` for the rollout checks, from the
    settled standing start: every 8th from problem 1 starts 15 cm up at
    1 m/s (in flight), every 8th from problem 2 stands on friction 0.3 (its
    feet slide on the friction cone under the random candidates).
    Returns (x0 (n,37), scenarios)."""
    from quadruped_springs_tpu_torch.env import randomizers as rnd

    gen = torch.Generator("cuda").manual_seed(seed)
    scen = rnd.sample_scenario(prob.cfg, "TEST_RANDOMIZER", gen, n=n)
    friction = scen.friction.clone()
    friction[2::8] = 0.3
    scen = dataclasses.replace(scen, friction=friction)
    x0 = prob.default_x0().expand(n, -1).clone()
    x0[:, 13:25] += 0.02 * torch.randn((n, 12), generator=gen, device="cuda")
    x0[1::8, 2] += 0.15
    x0[1::8, 9] = 1.0
    return x0, scen


def _rollout_cost(torch, prob, xs, us):
    """MPPI's cost of each lane's rollout, (B,R)."""
    from quadruped_springs_tpu_torch.models import spatial as sp

    ts = torch.arange(us.shape[2], device=us.device)
    return sp.sum_fixed(prob.stage_cost(xs[:, :, :-1], us, ts)) + prob.terminal_cost(
        xs[:, :, -1])


def _lane_field_distance(torch, xs, exact, cols):
    """max over the field's columns of |xs - exact| / (1 + |exact|), per lane
    and knot (knots 1..H), as (lanes, H) float64."""
    d = ((xs[..., cols].double() - exact[..., cols]).abs()
         / (1.0 + exact[..., cols].abs())).amax(-1)
    return d.reshape(-1, d.shape[-1])[:, 1:]


def check_planner_rollout(torch, ro, prob, x0, us, lanes, consts, reps=10, strict=False):
    """The `planner_rollout` kernel against planner_rollout_plain on the same
    arguments, at every knot and on each lane's MPPI cost, both measured
    against the plain version run in float64 (`exact`):

    - gate: per field and knot, and on the costs, the ROLLOUT_QUANTILES of
      the kernel's relative distance to `exact` over the lanes lie within
      ROLLOUT_DIST x the same quantiles of the plain version's, plus REL_TOL
      (the kernel is as close to the float64 answer as the plain version);
    - per lane, env_substeps's rule (check_env_substeps): REL_TOL·(1 + |plain|) +
      ROLLOUT_SPREAD x the plain version's own spread (the larger of its
      change under a one-ulp change of the start and its distance to
      `exact`, the largest over the state): a gate on every lane at knot 1
      (from the same start), and at every knot and on the cost with
      `strict` (one lane, one knot: the executor's shape); past knot 1,
      the lanes outside it are counted and the spreads the others use
      printed.

    Times the kernel through its wrapper (CUDA events, median of `reps`),
    on the card alone (CUDA events around 10 back-to-back launches, median
    of 5) and the plain version (its two float32 calls, the faster)."""
    from quadruped_springs_tpu_torch.control import interfaces as ci

    q_des = ci.action_to_command(prob.iface, us).contiguous()
    got = ro.planner_rollout(x0, q_des, lanes, consts)
    res = rollout_gate(torch, ro, prob, x0, q_des, us, lanes, consts, got, strict)
    one = lambda: ro.planner_rollout(x0, q_des, lanes, consts)
    B, R, H, _ = q_des.shape
    occ = ro.occupancy(R, lanes.spring_k.shape[0] == 1)
    inputs = [x0, q_des, lanes.packed, lanes.spring_k, lanes.spring_b, lanes.friction,
              consts.kp, consts.kd, consts.torque_limits, consts.velocity_limits, consts.rest,
              consts.sign]
    return {**res, "ms": cuda_time_ms(torch, one, reps=reps),
            "card_ms": cuda_time_ms(torch, one, reps=5, inner=10),
            "profile": (one, "planner_rollout_kernel"),
            "lanes": B * R, "horizon": H, "substeps": consts.substeps,
            "warps_per_sm": occ["warps_per_sm"], "registers": occ["registers"],
            **roofline("planner_rollout", B * R * H * consts.substeps, inputs, [got])}


def rollout_gate(torch, ro, prob, x0, q_des, us, lanes, consts, got, strict=False):
    """check_planner_rollout's gates on the kernel's rollout `got` of the
    commands q_des (of `us`) from x0. Returns the errors, the distances and
    spreads used, the lanes outside the spread and the plain version's
    time (its two float32 calls, the faster)."""
    from quadruped_springs_tpu_torch.solver.mpc import cast_floats

    torch.cuda.synchronize()
    timed = []

    def plain(x):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        xs = ro.planner_rollout_plain(x, q_des, lanes, consts)
        end.record()
        end.synchronize()
        timed.append(start.elapsed_time(end))
        return xs

    want = plain(x0)
    moved_x0 = x0.clone()
    moved_x0[:, 13:25] = torch.nextafter(x0[:, 13:25], x0[:, 13:25] + 1.0)
    moved = plain(moved_x0)
    f64 = lambda t: cast_floats(t, torch.float64)
    exact = ro.planner_rollout_plain(x0.double(), q_des.double(), f64(lanes), f64(consts))
    spread = torch.maximum((moved - want).abs(), (exact - want).abs()).amax(-1, keepdim=True)
    qs = torch.tensor(ROLLOUT_QUANTILES, dtype=torch.float64, device=x0.device)

    def distribution(name, dk, dp):
        """The gate on the lanes' distances (lanes, knots) to `exact`:
        returns the largest (kernel quantile - REL_TOL) / plain quantile."""
        qk, qp = torch.quantile(dk, qs, dim=0), torch.quantile(dp, qs, dim=0)
        bad = qk > ROLLOUT_DIST * qp + REL_TOL
        if bool(bad.any()):
            i, k = (int(v) for v in bad.nonzero()[0])
            raise AssertionError(
                f"planner_rollout {name}: the kernel's {ROLLOUT_QUANTILES[i]} quantile of the "
                f"relative distance to the float64 plain version {float(qk[i, k]):.3e} at knot "
                f"{k + 1} exceeds {ROLLOUT_DIST} x the plain version's {float(qp[i, k]):.3e} + "
                f"{REL_TOL}")
        return float(((qk - REL_TOL).clamp_min(0.0) / qp.clamp_min(1e-30)).max())

    dist, used, outside, err = {}, {}, {}, 0.0
    for field, cols in ROLLOUT_FIELDS.items():
        w, g = want[..., cols], got[..., cols]
        d = (g - w).abs()
        err = max(err, float(d.max()))
        dist[field] = distribution(field, _lane_field_distance(torch, got, exact, cols),
                                   _lane_field_distance(torch, want, exact, cols))
        slack = d - REL_TOL * (1.0 + w.abs())
        over = torch.where(slack > 0, slack / spread.clamp_min(1e-30), torch.zeros_like(slack))
        lane_over = over.amax(-1) > ROLLOUT_SPREAD            # (B,R,H+1)
        outside[field] = int(lane_over.any(-1).sum())
        used[field] = float(torch.where(lane_over[..., None], torch.zeros_like(over),
                                        over).max())
        first = int(lane_over[..., 1].sum())
        if first or (strict and outside[field]):
            raise AssertionError(f"planner_rollout {field}: |kernel - plain| exceeds "
                                 f"{REL_TOL}·(1+|plain|) + {ROLLOUT_SPREAD} x the plain version's "
                                 f"spread at {first} lanes of knot 1 and at {outside[field]} "
                                 f"lanes in all (held at every knot: {strict})")
    costs = {k: _rollout_cost(torch, prob, xs.float(), us) for k, xs in
             (("got", got), ("want", want), ("moved", moved))}
    c_exact = _rollout_cost(torch, prob, exact, us.double())
    rel = lambda c: ((c.double() - c_exact).abs() / (1.0 + c_exact.abs())).reshape(-1, 1)
    dist["cost"] = distribution("cost", rel(costs["got"]), rel(costs["want"]))
    c_spread = torch.maximum((costs["moved"] - costs["want"]).abs(),
                             (c_exact.float() - costs["want"]).abs())
    d = (costs["got"] - costs["want"]).abs()
    slack = d - REL_TOL * (1.0 + costs["want"].abs())
    over = torch.where(slack > 0, slack / c_spread.clamp_min(1e-30), torch.zeros_like(slack))
    outside["cost"] = int((over > ROLLOUT_SPREAD).sum())
    used["cost"] = float(torch.where(over > ROLLOUT_SPREAD, torch.zeros_like(over), over).max())
    if strict and outside["cost"]:
        raise AssertionError(f"planner_rollout cost: |kernel - plain| {float(d.max())} exceeds "
                             f"{REL_TOL}·(1+|plain|) + {ROLLOUT_SPREAD} x the spread")
    return {"max_abs_err": err, "cost_max_abs_err": float(d.max()),
            "distance_used": dist, "lanes_outside_spread": outside, "spread_used": used,
            "plain_ms": min(timed)}


def one_knot_from_plain(torch, ro, prob, x0, us, scen):
    """From the plain version's state at every knot of the rollout of `us`
    (B problems x R candidates x H knots), one knot of the kernel, of the
    plain version and of the plain version in float64, each knot-lane on its
    problem's scenario row. Returns the states x (B·R,H,37), commands q
    (B·R,H,12), the lanes' scenarios, the three results (B·R,H,37) and the
    kernel's and the plain version's distance to the float64 knot, max over
    the state of |a - exact| / (1 + |exact|), (B·R,H) float64."""
    from quadruped_springs_tpu_torch.control import interfaces as ci
    from quadruped_springs_tpu_torch.env.env import take
    from quadruped_springs_tpu_torch.solver.mpc import cast_floats

    B, R, H, _ = us.shape
    q_des = ci.action_to_command(prob.iface, us).contiguous()
    consts = prob.rollout_consts()
    want = ro.planner_rollout_plain(x0, q_des, prob.rollout_lanes(scen), consts)
    lane_scen = take(scen, torch.arange(B, device=x0.device).repeat_interleave(R))
    lanes = prob.rollout_lanes(lane_scen)
    f64 = lambda t: cast_floats(t, torch.float64)
    lanes64, consts64 = f64(lanes), f64(consts)
    xs, qs = want[:, :, :H].reshape(B * R, H, 37), q_des.reshape(B * R, H, 12)
    out = []
    for k in range(H):
        x, q = xs[:, k].contiguous(), qs[:, k, None, None].contiguous()
        out.append((ro.planner_rollout(x, q, lanes, consts)[:, 0, 1],
                    ro.planner_rollout_plain(x, q, lanes, consts)[:, 0, 1],
                    ro.planner_rollout_plain(x.double(), q.double(), lanes64,
                                             consts64)[:, 0, 1]))
    kernel, plain, exact = (torch.stack(t, 1) for t in zip(*out))
    rel = lambda a: ((a.double() - exact).abs() / (1.0 + exact.abs())).amax(-1)
    return {"x": xs, "q": qs, "scenario": lane_scen, "kernel": kernel, "plain": plain,
            "exact": exact, "e_kernel": rel(kernel), "e_plain": rel(plain)}


def check_one_knot_lanes(torch, ro, prob, x0, us, scen, what="the headline's rollout"):
    """The kernel lane by lane over every knot of a rollout (the headline's),
    each knot from the plain version's state (one_knot_from_plain), against
    the float64 knot: at most ONE_KNOT_FAR knot-lanes where the kernel is
    100 x farther than the plain version (+ 1e-4), and at most ONE_KNOT_TAIL
    x as many knot-lanes as the plain version's own past the plain version's
    0.999 quantile. Returns the counts and quantiles."""
    r = one_knot_from_plain(torch, ro, prob, x0, us, scen)
    e_k, e_p = r["e_kernel"].flatten(), r["e_plain"].flatten()
    qs = torch.tensor(ONE_KNOT_QUANTILES, dtype=torch.float64, device=e_k.device)
    q_k, q_p = torch.quantile(e_k, qs).tolist(), torch.quantile(e_p, qs).tolist()
    far = int((e_k > 100.0 * e_p + 1e-4).sum())
    tail_k, tail_p = int((e_k > q_p[-1]).sum()), int((e_p > q_p[-1]).sum())
    res = {"knot_lanes": e_k.numel(), "kernel_quantiles": q_k, "plain_quantiles": q_p,
           "kernel_max": float(e_k.max()), "plain_max": float(e_p.max()), "far": far,
           "past_plain_0.999_kernel": tail_k, "past_plain_0.999_plain": tail_p}
    print(f"phase 19: planner_rollout, one knot from the plain version's state at each of "
          f"{res['knot_lanes']} knot-lanes of {what}, distance to the float64 "
          f"knot at the {ONE_KNOT_QUANTILES} quantiles: kernel {q_k}, plain {q_p}; max kernel "
          f"{res['kernel_max']:.3e}, plain {res['plain_max']:.3e}; knot-lanes where the kernel "
          f"is 100 x farther: {far} (bound {ONE_KNOT_FAR}); past the plain version's 0.999 "
          f"quantile: kernel {tail_k}, plain {tail_p} (bound {ONE_KNOT_TAIL} x)", flush=True)
    if far > ONE_KNOT_FAR or tail_k > ONE_KNOT_TAIL * tail_p:
        raise AssertionError(f"phase 19: planner_rollout parts from the float64 knot at more "
                             f"knot-lanes than the plain version: {res}")
    return res


def check_planner_rollout_batching(torch, ro, prob, x0, us, scen):
    """Rows 0-GAP_ROWS-1 (every candidate of problems 0-7) of one launch at
    the headline's problems, at GAP_ROWS problems and in blocks of
    GAP_BLOCK: bitwise equal. Returns max |d| per batching."""
    from quadruped_springs_tpu_torch.control import interfaces as ci
    from quadruped_springs_tpu_torch.env.env import take

    def rows(a, b):
        idx = torch.arange(a, b, device="cuda")
        return ro.planner_rollout(x0[a:b].contiguous(),
                                  ci.action_to_command(prob.iface, us[a:b]).contiguous(),
                                  prob.rollout_lanes(take(scen, idx)), prob.rollout_consts())

    full, whole = rows(0, x0.shape[0]), rows(0, GAP_ROWS)
    blocks = torch.cat([rows(i, i + GAP_BLOCK) for i in range(0, GAP_ROWS, GAP_BLOCK)])
    return {str(x0.shape[0]): float((full[:GAP_ROWS] - whole).abs().max()),
            f"{GAP_ROWS // GAP_BLOCK} x {GAP_BLOCK}": float((blocks - whole).abs().max())}


def check_planner_rollout_map(torch, ro, n, r, horizon, full_rate, one_row, springs=True):
    """`planner_rollout` at n problems x r candidates x `horizon` knots
    (rollout_problems' problems, candidates drawn as MPPI's first iteration
    draws them): every problem's rows bitwise equal to the same problem
    launched alone (where each block reads one scenario row), and every
    lane's first knot within REL_TOL·(1 + |plain|) + ROLLOUT_SPREAD x the
    plain version's spread (check_planner_rollout's rule). Returns the
    largest |d| against the lone launches and the largest spread used."""
    from quadruped_springs_tpu_torch.control import interfaces as ci
    from quadruped_springs_tpu_torch.env.env import take
    from quadruped_springs_tpu_torch.solver import mppi
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem, cast_floats

    prob = MPCProblem((MPCConfig.full_rate if full_rate else MPCConfig)(
        horizon=horizon, enable_springs=springs), "cuda")
    x0, scen = rollout_problems(torch, prob, n, 41)
    eps = 0.3 * torch.randn((n, r, horizon, prob.action_dim), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(42))
    us = torch.clamp(prob.task_warm_start()[None, None] + mppi._smooth_noise(eps), -1.0, 1.0)
    q_des = ci.action_to_command(prob.iface, us).contiguous()
    lanes, consts = prob.rollout_lanes(None if one_row else scen), prob.rollout_consts()
    got = ro.planner_rollout(x0, q_des, lanes, consts)
    alone = 0.0
    for p in range(n):
        lanes_p = lanes if one_row else prob.rollout_lanes(take(scen, torch.tensor(
            [p], device="cuda")))
        got_p = ro.planner_rollout(x0[p:p + 1].contiguous(), q_des[p:p + 1].contiguous(),
                                   lanes_p, consts)
        alone = max(alone, float((got_p[0] - got[p]).abs().max()))
    first = q_des[:, :, :1].contiguous()
    plain = lambda x, q, ln, cs: ro.planner_rollout_plain(x, q, ln, cs)[:, :, 1]
    want = plain(x0, first, lanes, consts)
    moved_x0 = x0.clone()
    moved_x0[:, 13:25] = torch.nextafter(x0[:, 13:25], x0[:, 13:25] + 1.0)
    f64 = lambda t: cast_floats(t, torch.float64)
    spread = torch.maximum(
        (plain(moved_x0, first, lanes, consts) - want).abs(),
        (plain(x0.double(), first.double(), f64(lanes), f64(consts)) - want).abs()).amax(
        -1, keepdim=True)
    slack = (got[:, :, 1] - want).abs() - REL_TOL * (1.0 + want.abs())
    used = float((slack / spread.clamp_min(1e-30)).max())
    if alone != 0.0 or used > ROLLOUT_SPREAD:
        raise AssertionError(f"phase 19: planner_rollout at {n} x {r} x {horizon} (one row: "
                             f"{one_row}): |d| {alone} against each problem launched alone, "
                             f"knot 1 uses {used:.2f} of {ROLLOUT_SPREAD} spreads")
    return {"alone_max_abs_diff": alone, "knot1_spreads_used": used}


def check_planner_rollout_shapes(torch, kind):
    """Phase 19: `planner_rollout` against planner_rollout_plain on the card
    at the shapes of its paths: the MPPI headline's rollout (BATCH
    TEST_RANDOMIZER problems x SAMPLES candidates, H = 50, 2 substeps of the
    relaxed model with springs), the full-rate row's (H = 25, 10 substeps at
    180 kN/m, the clamp on) and the closed loop's executor (1 lane, H = 1,
    10 substeps on the nominal row, held lane by lane); the candidates
    drawn as MPPI's first iteration draws them (the task's warm start plus
    low-passed noise of sigma 0.3, clipped), for the problems of
    rollout_problems (in stance, in flight, sliding); then rows 0-7 of the
    headline's launch bitwise equal at BATCH, 8 and 2 problems."""
    from quadruped_springs_tpu_torch import closed_loop
    from quadruped_springs_tpu_torch.solver import mppi
    from quadruped_springs_tpu_torch.solver import rollout as ro
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    checks = {}
    for setting, mk, horizon in (("headline", MPCConfig, HORIZON),
                                 ("full_rate", MPCConfig.full_rate, FULL_RATE_HORIZON)):
        prob = MPCProblem(mk(horizon=horizon), "cuda")
        x0, scen = rollout_problems(torch, prob, BATCH, 31)
        eps = 0.3 * torch.randn((BATCH, SAMPLES, horizon, prob.action_dim), device="cuda",
                                generator=torch.Generator("cuda").manual_seed(32))
        us = torch.clamp(prob.task_warm_start()[None, None] + mppi._smooth_noise(eps),
                         -1.0, 1.0)
        checks[setting] = check_planner_rollout(torch, ro, prob, x0, us,
                                                prob.rollout_lanes(scen), prob.rollout_consts())
        if setting == "headline":
            gap = check_planner_rollout_batching(torch, ro, prob, x0, us, scen)
            one_knot = check_one_knot_lanes(torch, ro, prob, x0, us, scen)
    prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE"), "cuda")
    lanes, consts = closed_loop.executor(prob)
    extend = prob.task_warm_start(crouch_knots=6)[-1]
    checks["executor"] = check_planner_rollout(
        torch, ro, prob, prob.default_x0()[None], extend.expand(1, 1, 1, -1).contiguous(),
        lanes, consts, reps=30, strict=True)
    compare = check_compare_rollouts(torch, ro, mppi, MPCConfig, MPCProblem)
    for shape in ROLLOUT_MAP_SHAPES:
        print(f"phase 19: planner_rollout's map of lanes to problems at (B, R, H, full rate, "
              f"one row) = {shape}: {check_planner_rollout_map(torch, ro, *shape)} (each "
              f"problem's rows bitwise those of the problem launched alone; knot 1 within "
              f"{ROLLOUT_SPREAD} spreads)", flush=True)
    for setting, r in checks.items():
        print(f"phase 19: planner_rollout ({setting}) at {r['lanes']} lanes x {r['horizon']} "
              f"knots x {r['substeps']} substeps: max_abs_err {r['max_abs_err']:.3e}, cost "
              f"{r['cost_max_abs_err']:.3e}; the kernel's distance to the float64 plain version "
              f"at the {ROLLOUT_QUANTILES} quantiles over its lanes, in units of the plain "
              f"version's (bound {ROLLOUT_DIST}): {r['distance_used']}; lanes outside "
              f"{REL_TOL}·(1+|plain|) + {ROLLOUT_SPREAD} x the plain version's spread: "
              f"{r['lanes_outside_spread']} of {r['lanes']}, spreads the others use: "
              f"{r['spread_used']}; kernel "
              f"{r['ms']:.4f} ms through its wrapper, plain {r['plain_ms']:.2f} ms; bound "
              f"{r['bound_ms'] * 1e3:.2f} µs ({r['bytes']} bytes, by {r['bound_by']}) on {kind}",
              flush=True)
    print(f"phase 19: planner_rollout rows 0-{GAP_ROWS - 1} of {BATCH} problems against the "
          f"same rows launched as {GAP_ROWS} and in blocks of {GAP_BLOCK}: max |d| {gap} "
          f"(0: bitwise equal)", flush=True)
    print("phase 19: planner_rollout on the card (CUDA events around 10 back-to-back "
          "launches, median of 5): " + "; ".join(
              f"{setting} {r['lanes']} x {r['horizon']} x {r['substeps']}: "
              f"{r['card_ms']:.4f} ms, {100 * r['bound_ms'] / r['card_ms']:.1f}% of its bound "
              f"{r['bound_ms']:.4f} ms, {r['warps_per_sm']} warps an SM at {r['registers']} "
              f"registers a thread"
              for setting, r in checks.items() if setting != "executor") + f" on {kind}",
          flush=True)
    if any(v != 0.0 for v in gap.values()):
        raise AssertionError(f"phase 19: planner_rollout rows depend on the batch: {gap}")
    checks.update(compare)
    return checks, gap, one_knot


def compare_rollout_gate(torch, ro, mppi, prob, r, lanes_total=COMPARE_POOLED_LANES,
                         seed=33):
    """The quantile gate (rollout_gate) at the springs-vs-rigid comparison's
    width: PLANNED_SOLVES problems x r candidates (MPPI's K or its accept
    rollout, R = 1) on the nominal robot's one row, H = HORIZON, relaxed,
    the kernel launched at that width lanes_total / (PLANNED_SOLVES x r)
    times on independent draws (rollout_problems' starts from `seed`,
    sigma-0.3 smoothed candidates about the task's warm start) and the
    lanes pooled, so that the quantiles rest on many lanes. Then one knot
    from the plain version's states at every pooled knot-lane
    (check_one_knot_lanes). Returns the gate's record."""
    from quadruped_springs_tpu_torch.control import interfaces as ci
    from quadruped_springs_tpu_torch.env import randomizers as rnd

    lanes, consts = prob.rollout_lanes(), prob.rollout_consts()
    n = lanes_total // r
    x0, _ = rollout_problems(torch, prob, n, seed)
    eps = 0.3 * torch.randn((n, r, HORIZON, prob.action_dim), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(seed + 1 + r))
    us = torch.clamp(prob.task_warm_start()[None, None] + mppi._smooth_noise(eps), -1.0, 1.0)
    q_des = ci.action_to_command(prob.iface, us).contiguous()
    got = torch.cat([ro.planner_rollout(x0[i:i + PLANNED_SOLVES].contiguous(),
                                        q_des[i:i + PLANNED_SOLVES].contiguous(), lanes, consts)
                     for i in range(0, n, PLANNED_SOLVES)])
    res = rollout_gate(torch, ro, prob, x0, q_des, us, lanes, consts, got)
    robot = "springs" if prob.config.enable_springs else "rigid"
    res["one_knot"] = check_one_knot_lanes(
        torch, ro, prob, x0, us, rnd.nominal_params(prob.cfg, n),
        what=f"the {robot} comparison's rollouts ({PLANNED_SOLVES} x {r}, "
             f"{n // PLANNED_SOLVES} launches)")
    return {**res, "lanes": n * r, "launches": n // PLANNED_SOLVES, "horizon": HORIZON,
            "substeps": consts.substeps}


def check_compare_rollouts(torch, ro, mppi, MPCConfig, MPCProblem):
    """Phase 19, the springs-vs-rigid comparison's rollouts (MPPI's K =
    PLANNED_SAMPLES candidates and its accept rollout, R = 1, on the nominal
    robot's one row, H = 50, relaxed) for the PEA robot and the rigid one
    (per-joint gains [55, 60, 60], no spring rows), at the comparison's
    width of PLANNED_SOLVES problems: every problem's rows bitwise the
    problem launched alone and knot 1 within the spread rule
    (check_planner_rollout_map), times at that width; and the gate on
    quantiles over lanes with the launches of that width pooled over
    independent draws to COMPARE_POOLED_LANES lanes (compare_rollout_gate:
    over one launch's 8-512 lanes a few lanes' contact events set the
    quantiles, the plain version's as much as the kernel's,
    tests/torch_rollout_compare_probe.py), with one knot from the plain
    version's states at every pooled knot-lane."""
    from quadruped_springs_tpu_torch.control import interfaces as ci

    checks = {}
    for robot, springs in (("springs", True), ("rigid", False)):
        prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=HORIZON,
                                    enable_springs=springs), "cuda")
        lanes, consts = prob.rollout_lanes(), prob.rollout_consts()
        n = PLANNED_SOLVES
        x0, _ = rollout_problems(torch, prob, n, 33)
        for r in (PLANNED_SAMPLES, 1):
            checks[f"compare_{robot}_{n}x{r}_pooled"] = compare_rollout_gate(
                torch, ro, mppi, prob, r)
            eps = 0.3 * torch.randn((n, r, HORIZON, prob.action_dim), device="cuda",
                                    generator=torch.Generator("cuda").manual_seed(34 + r))
            us = torch.clamp(prob.task_warm_start()[None, None] + mppi._smooth_noise(eps),
                             -1.0, 1.0)
            mapped = check_planner_rollout_map(torch, ro, n, r, HORIZON, False, True, springs)
            q_des = ci.action_to_command(prob.iface, us).contiguous()
            one = lambda: ro.planner_rollout(x0, q_des, lanes, consts)
            got = one()
            want = ro.planner_rollout_plain(x0, q_des[:, :, :1].contiguous(), lanes, consts)
            inputs = [x0, q_des, lanes.packed, lanes.spring_k, lanes.spring_b,
                      lanes.friction, consts.kp, consts.kd, consts.torque_limits,
                      consts.velocity_limits, consts.rest, consts.sign]
            checks[f"compare_{robot}_{n}x{r}"] = {
                "max_abs_err": float((got[:, :, 1] - want[:, :, 1]).abs().max()),
                **mapped, "lanes": n * r, "horizon": HORIZON, "substeps": consts.substeps,
                "ms": cuda_time_ms(torch, one), "card_ms": cuda_time_ms(
                    torch, one, reps=5, inner=10),
                "plain_ms": cuda_time_ms(torch, lambda: ro.planner_rollout_plain(
                    x0, q_des, lanes, consts), reps=3),
                **roofline("planner_rollout", n * r * HORIZON * consts.substeps, inputs,
                           [got])}
    for setting, r in checks.items():
        if "launches" in r:
            print(f"phase 19: planner_rollout ({setting}) at {r['lanes']} lanes x "
                  f"{r['horizon']} knots x {r['substeps']} substeps in {r['launches']} "
                  f"launches: max_abs_err {r['max_abs_err']:.3e}, distance to the float64 "
                  f"plain version in units of the plain version's {r['distance_used']}, "
                  f"lanes outside the spread {r['lanes_outside_spread']}", flush=True)
            continue
        extra = (f"knot 1 max_abs_err {r['max_abs_err']:.3e}, each problem's rows against the "
                 f"problem alone {r['alone_max_abs_diff']}, knot 1 {r['knot1_spreads_used']:.2f} "
                 f"spreads")
        print(f"phase 19: planner_rollout ({setting}) at {r['lanes']} lanes x {r['horizon']} "
              f"knots x {r['substeps']} substeps: {extra}; kernel {r['ms']:.4f} ms through its "
              f"wrapper, {r['card_ms']:.4f} ms on the card (10 back-to-back launches), plain "
              f"{r['plain_ms']:.2f} ms; bound {r['bound_ms'] * 1e3:.3f} µs (by "
              f"{r['bound_by']})", flush=True)
    return checks


# -- phase 20: the MPC behaviours -------------------------------------------

# phase 28: the MPPI iteration's two kernels, planner_rollout_cost (the task
# cost summed inside the rollout) and mppi_update, at every width an MPPI
# path launches: setting -> (task, full rate, problems, candidates, horizon,
# fused accept, one TEST_RANDOMIZER scenario a problem); the widths of the
# package's own modules are read from them in mppi_widths
# the parent's mean final costs of the headline and the full-rate row
# (PERF.md section 5, every chip run of PRs 9-16), which this PR's kernels
# hold bitwise
PARENT_HEADLINE_COST, PARENT_FULL_RATE_COST = -71.2030, -64.2740
# float32 operations of the cost a (lane, knot): the u² and qd² sums (~45),
# the family's terms (~40, asin and the quaternion's products included)
COST_FLOPS_PER_KNOT = 85
# a headline solve's launches (PR 9: 3,831): 11 rollouts, 11 updates, 10
# draws and the settle's and set-up's few
MAX_SOLVE_LAUNCHES = 100


def mppi_widths():
    from quadruped_springs_tpu_torch import closed_loop, examples, mpc_behaviours

    p = mpc_behaviours.PLANNERS
    return {"headline": ("JUMPING_IN_PLACE", False, BATCH, SAMPLES, HORIZON, True, True),
            "full_rate": ("JUMPING_IN_PLACE", True, BATCH, SAMPLES, FULL_RATE_HORIZON, True,
                          True),
            **{f"behaviour_{name}": (p[name].task, False, 1, p[name].n_samples,
                                     p[name].horizon, True, False) for name in p},
            "compare": ("JUMPING_IN_PLACE", False, PLANNED_SOLVES, PLANNED_SAMPLES, HORIZON,
                        False, False),
            "closed_loop": ("JUMPING_IN_PLACE", True, 1, closed_loop.FULL_RATE_SAMPLES,
                            closed_loop.FULL_RATE_HORIZON, True, False),
            "example_mppi": ("JUMPING_IN_PLACE", False, 1, examples.MPPI_SAMPLES,
                             examples.MPC_HORIZON, False, False)}


def _diff(torch, got, want):
    """max |got - want| over outputs that may hold inf or NaN: 0 where both
    are the same non-finite value, inf where only one is."""
    if got is None or want is None:
        return 0.0 if got is want else math.inf
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    d = torch.where(same, torch.zeros_like(got), (got - want).abs().nan_to_num(math.inf))
    return float(d.max()) if d.numel() else 0.0


def check_mppi_iteration(torch, setting, spec, kind, timed):
    """Phase 28, one width: a solve's sequence of launches (the fused
    accept: the candidates, two iterations' proposals with the next
    candidates, then the settle's rows; the accept rollout every iteration:
    the first row, the candidates, the proposal, the accept with the last
    rows), every update launched as mppi_update and as mppi_update_plain on
    the same inputs (every output bitwise), every rollout as
    planner_rollout_cost (its costs bitwise the plain cost,
    rollout.total_cost over make_cost, of its states; its states bitwise
    the xs-only planner_rollout's; its costs without states the same).
    For the kernels named in `timed`: their times through their wrappers
    and on the card, and their plain versions' (the iteration's update
    launch; the K-wide rollout without states against rollout_cost_plain)."""
    from quadruped_springs_tpu_torch.env import randomizers as rnd
    from quadruped_springs_tpu_torch.solver import mppi_update as mu
    from quadruped_springs_tpu_torch.solver import rollout as ro
    from quadruped_springs_tpu_torch.solver.mppi import MPPIConfig
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem
    from quadruped_springs_tpu_torch.tasks import costs as task_costs

    task, full_rate, B, K, H, fused, per_problem = spec
    prob = MPCProblem((MPCConfig.full_rate if full_rate else MPCConfig)(task=task, horizon=H),
                      "cuda")
    gen = torch.Generator("cuda").manual_seed(41)
    scen = (rnd.sample_scenario(prob.cfg, "TEST_RANDOMIZER", gen, n=B) if per_problem
            else None)
    lanes, consts = prob.rollout_lanes(scen), prob.rollout_consts()
    cost = ro.TaskCost(prob.stage_cost, prob.terminal_cost,
                       *task_costs.kernel_weights(task, H, {}))
    x0 = prob.default_x0().expand(B, -1).contiguous()
    cfg = MPPIConfig(horizon=H, n_samples=K, fused_accept=fused)
    s = mu.UpdateSettings(fused, cfg.smooth, max(int(K * cfg.elite_frac), 1), cfg.temperature,
                          cfg.u_min, cfg.u_max, prob.iface)
    norm = mu.lowpass_norm(H, device="cuda")
    sigma = torch.full((1,), cfg.sigma, device="cuda")
    u0 = torch.clamp(prob.task_warm_start().expand(B, -1, -1), cfg.u_min, cfg.u_max)
    err = {"mppi_update": 0.0, "planner_rollout_cost": 0.0}
    calls = {"mppi_update": [], "planner_rollout_cost": []}
    copy = lambda st: mu.UpdateState(*(t.clone() for t in (st.us, st.us_alt, st.cost,
                                                           st.trace)))

    def update(state, **kw):
        want = mu.mppi_update_plain(copy(state), s, **kw)
        got = mu.mppi_update(copy(state), s, **kw)
        pairs = [(got[0].us, want[0].us), (got[0].us_alt, want[0].us_alt),
                 (got[0].cost, want[0].cost), (got[0].trace, want[0].trace),
                 (got[1], want[1]), (got[2], want[2])]
        err["mppi_update"] = max(err["mppi_update"], *(_diff(torch, a, b) for a, b in pairs))
        calls["mppi_update"].append((copy(state), kw))
        return want

    def rollout(us, q_des):
        xs, c = ro.planner_rollout_cost(x0, us, q_des, lanes, consts, cost, states=True)
        none, c_only = ro.planner_rollout_cost(x0, us, q_des, lanes, consts, cost)
        if none is not None or not torch.equal(xs, ro.planner_rollout(x0, q_des, lanes,
                                                                       consts)):
            raise AssertionError(f"phase 28: planner_rollout_cost ({setting}): its states part "
                                 f"from the xs-only planner_rollout's")
        err["planner_rollout_cost"] = max(
            err["planner_rollout_cost"], _diff(torch, c, ro.total_cost(
                cost.stage, cost.terminal, xs, us)), _diff(torch, c_only, c))
        calls["planner_rollout_cost"].append((us, q_des))
        return c

    cand_kw = lambda: dict(rows=mu.ROWS_CANDIDATES, sigma=sigma, norm=norm,
                           draw=torch.randn(B, K, H, prob.action_dim, generator=gen,
                                            device="cuda"))
    if fused:
        state = mu.UpdateState(u0.clone(), u0.clone(),
                               torch.full((B,), math.inf, device="cuda"),
                               torch.zeros(B, 2, device="cuda"))
        state, cand, q = update(state, **cand_kw())
        for i in range(2):
            costs = rollout(cand, q)
            nxt = cand_kw() if i == 0 else dict(rows=mu.ROWS_BOTH)
            state, cand, q = update(state, costs=costs, cand=cand, trace_col=i, **nxt)
        rollout(cand, q)
    else:
        state = mu.UpdateState(u0.clone(), torch.empty_like(u0), torch.empty(B, device="cuda"),
                               torch.zeros(B, 1, device="cuda"))
        state, rows, q = update(state, rows=mu.ROWS_US)
        state.cost = rollout(rows, q)[:, 0].contiguous()
        state, cand, q = update(state, **cand_kw())
        costs = rollout(cand, q)
        state, prop, q_prop = update(state, costs=costs, cand=cand, rows=mu.ROWS_ALT)
        cost_new = rollout(prop, q_prop)[:, 0].contiguous()
        state, rows, q = update(state, cost_new=cost_new, trace_col=0, rows=mu.ROWS_US)
        rollout(rows, q)
    moved = [k for k, v in err.items() if v != 0.0]
    if moved:
        raise AssertionError(f"phase 28: {moved} part from their plain versions at {setting}: "
                             f"{err}")
    out = {}
    # the iteration's update (the proposal from K candidates and, fused,
    # the next candidates) and the K-wide rollout
    st, kw = next((st, kw) for st, kw in calls["mppi_update"] if kw.get("costs") is not None)
    us, q_des = next((u, q) for u, q in calls["planner_rollout_cost"] if u.shape[1] == K)
    upd = lambda: mu.mppi_update(copy(st), s, **kw)
    roll = lambda: ro.planner_rollout_cost(x0, us, q_des, lanes, consts, cost)
    E = H * prob.action_dim
    R = K if kw["rows"] == mu.ROWS_CANDIDATES else 2
    upd_bytes = 4 * (B * K + B * K * E + 4 * B * E + 2 * B + R * B * E + R * B * H * 12
                     + (B * K * E if R == K else 0))
    upd_ops = B * K * E * (2 + 8) + B * K * K * 2
    roll_bytes = sum(t.numel() * 4 for t in (x0, us, q_des, lanes.packed, lanes.spring_k,
                                             lanes.spring_b, lanes.friction)) + 4 * B * K
    roll_ops = B * K * H * (FLOPS_PER_ELEM["planner_rollout"] * consts.substeps
                            + COST_FLOPS_PER_KNOT)
    for name, fn, nbytes, ops, kernel in (
            ("mppi_update", upd, upd_bytes, upd_ops, "mppi_update_kernel"),
            ("planner_rollout_cost", roll, roll_bytes, roll_ops,
             "planner_rollout_cost_kernel")):
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
        r = {"max_abs_err": err[name], "launches_checked": len(calls[name]),
             "problems": B, "candidates": K, "horizon": H, "fused": fused, "task": task,
             "bytes": nbytes, "operations": ops, "bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations",
             "ms": None, "plain_ms": None, "card_ms": None}
        if name in timed:
            plain = ((lambda: mu.mppi_update_plain(copy(st), s, **kw)) if name == "mppi_update"
                     else (lambda: ro.rollout_cost_plain(x0, us, q_des, lanes, consts, cost,
                                                         False)))
            r.update(ms=cuda_time_ms(torch, fn, reps=10),
                     card_ms=cuda_time_ms(torch, fn, reps=5, inner=10),
                     plain_ms=cuda_time_ms(torch, plain, reps=1 if name != "mppi_update"
                                           else 5),
                     profile=(fn, kernel))
        out[name] = r
    print(f"phase 28: {setting} ({task}, {B} x {K} x {H}, "
          f"{'fused accept' if fused else 'accept rollout'}): mppi_update bitwise its plain "
          f"version over {len(calls['mppi_update'])} launches, planner_rollout_cost's costs "
          f"bitwise the plain cost of its states over {len(calls['planner_rollout_cost'])} "
          f"launches (states bitwise planner_rollout's)" + "".join(
              f"; {n} {r['ms']:.4f} ms through its wrapper, {r['card_ms']:.4f} ms on the card, "
              f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms'] * 1e3:.2f} µs (by "
              f"{r['bound_by']})" for n, r in out.items() if r["ms"] is not None)
          + f" on {kind}", flush=True)
    return out


def check_mppi_iteration_widths(torch, kind):
    """Phase 28: check_mppi_iteration at every width of mppi_widths
    (mppi_update timed at each, planner_rollout_cost at the headline and the
    full-rate row), and the occupancy of the cost instantiation. Returns
    checks by kernel and setting."""
    from quadruped_springs_tpu_torch.solver import rollout as ro

    checks = {"planner_rollout_cost": {}, "mppi_update": {}}
    for setting, spec in mppi_widths().items():
        res = check_mppi_iteration(
            torch, setting, spec, kind,
            timed=("mppi_update",) + (("planner_rollout_cost",)
                                      if setting in ("headline", "full_rate") else ()))
        for name, r in res.items():
            checks[name][setting] = r
    for repeats, one_row, horizon in ((SAMPLES, False, HORIZON), (2, False, HORIZON),
                                      (64, True, 24), (1, False, HORIZON)):
        occ = ro.occupancy(repeats, one_row, horizon=horizon)
        print(f"phase 28: planner_rollout_cost_kernel at R = {repeats}, H = {horizon}"
              f"{', one row' if one_row else ''}: {occ['registers']} registers and "
              f"{occ['local_bytes']} bytes of local memory a thread, {occ['shared_bytes']} "
              f"bytes of shared memory a block (staged models and stage costs), "
              f"{occ['blocks_per_sm']} blocks ({occ['warps_per_sm']} warps) an SM", flush=True)
    return checks


def profile_mppi_solve(torch, kind):
    """Phase 12: one headline MPPI solve as bench.run solves it (its
    scenarios' models packed once, rollout_lanes) under torch.profiler: its
    launches and card time by class of kernel; fails at MAX_SOLVE_LAUNCHES
    launches or more. Then the same solve from the scenarios themselves
    (their models packed in the solve, as PR 9's count of 3,831 was taken):
    its launches, reported."""
    from torch.profiler import ProfilerActivity, profile

    from quadruped_springs_tpu_torch.env import randomizers as rnd
    from quadruped_springs_tpu_torch.solver.mppi import MPPIConfig
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE", horizon=HORIZON,
                                iterations=ITERATIONS, n_alphas=8), "cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    scen = rnd.sample_scenario(prob.cfg, "TEST_RANDOMIZER", gen, n=BATCH)
    x0 = prob.default_x0().expand(BATCH, -1)
    u0 = prob.task_warm_start().expand(BATCH, -1, -1)
    mcfg = MPPIConfig(horizon=HORIZON, iterations=ITERATIONS, n_samples=SAMPLES,
                      fused_accept=True)
    classes = (("planner_rollout_cost", "planner_rollout"), ("mppi_update", "mppi_update"),
               ("draws", "normal"), ("elementwise", "elementwise"), ("reduce", "reduce"),
               ("cat/copy", "at::native"))

    def traced(solve):
        solve()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            solve()
            torch.cuda.synchronize()
        launches, ms = {}, {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            cls = next((c for c, pat in classes if pat in e.key), "other")
            launches[cls] = launches.get(cls, 0) + e.count
            ms[cls] = ms.get(cls, 0.0) + us / 1e3
        return {"launches": sum(launches.values()), "card_ms": sum(ms.values()),
                "wall_ms": wall, "launches_by_class": launches, "ms_by_class": ms}

    lanes = prob.rollout_lanes(scen)
    out = traced(lambda: prob.solve_mppi(x0, u0, gen, mcfg, lanes))
    packed = traced(lambda: prob.solve_mppi(x0, u0, gen, mcfg, scen))
    print(f"phase 12: a headline MPPI solve ({BATCH} x {SAMPLES} x {HORIZON}, {ITERATIONS} "
          f"iterations, fused accept, as bench.run solves it): {out['launches']} launches on "
          f"the card, {out['card_ms']:.3f} ms of card time, {out['wall_ms']:.3f} ms wall "
          f"untraced; by class: launches {out['launches_by_class']}, ms "
          f"{ {k: round(v, 4) for k, v in out['ms_by_class'].items()} } (torch.profiler); "
          f"with its scenarios' models packed in the solve: {packed['launches']} launches, "
          f"{packed['card_ms']:.3f} ms of card time, {packed['wall_ms']:.3f} ms wall, on {kind}",
          flush=True)
    if out["launches"] >= MAX_SOLVE_LAUNCHES:
        raise AssertionError(f"phase 12: a headline MPPI solve launched {out['launches']} "
                             f"kernels, {MAX_SOLVE_LAUNCHES} or more")
    return {**out, "with_model_packing": packed}


def _behaviour_worker(job):
    """Phase 20, in a process of its own: one MPC behaviour driver at the
    JAX example's full configuration on the card, job = (run, seeds), the
    run a driver's name or "backflip_drawn_ground". Returns its records,
    the kernels' launches and the wall time."""
    import torch

    from quadruped_springs_tpu_torch import mpc_behaviours
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts(act, dyn)
    t0 = time.perf_counter()
    run, seeds = job
    if run == "backflip":
        records = [mpc_behaviours.backflip(seed=seed, device="cuda",
                                           friction=JAX_BACKFLIP_FRICTION[seed])
                   for seed in seeds]
    else:
        driver = mpc_behaviours.DRIVERS[run.removesuffix("_drawn_ground")]
        records = [driver(seed=seed, device="cuda") for seed in seeds]
    torch.cuda.synchronize()
    return {"records": records, "launches": read_counts(act, dyn),
            "seconds": time.perf_counter() - t0}


def behaviour_passed(name, rec):
    """The bars of the JAX package's gate (tests/test_closed_loop_behaviors.py;
    the backflip launch: the full rotation its example documents) and the
    KPIs they read, as a line of text."""
    if name == "jumping_forward":
        ok = (rec["fwd_distance_m"] >= 0.30 and rec["apex_rel_m"] >= 0.10
              and rec["final_z"] > 0.15)
        return ok, (f"forward {rec['fwd_distance_m']:.3f} m (bar 0.30), apex "
                    f"{rec['apex_rel_m']:.3f} m (0.10), final z {rec['final_z']:.3f} m (0.15)")
    if name == "continuous":
        perf = rec["per_jump_performance"]
        high = sum(p >= 0.85 for p in perf)
        ok = (rec["sim_seconds"] >= 5.0 and rec["good_jumps"] >= 4 and high >= 2
              and rec["total_fwd_m"] > 4.0)
        return ok, (f"{rec['sim_seconds']} s (bar 5), {rec['good_jumps']} good jumps (4), "
                    f"{high} at >= 0.85 (2), forward {rec['total_fwd_m']} m (4.0)")
    return rec["full_rotation"], (
        f"pitch {rec['pitch_unwrapped_rad']:.4f} rad (full rotation {rec['full_rotation']}), "
        f"upright {rec['upright']} (up_z {rec['up_z']:.4f}, final z {rec['final_z']:.3f} m; "
        f"reported, no bar), friction {rec['friction']:.4f}")


def check_behaviours(results, kind):
    """Phase 20: the MPC behaviour runs of BEHAVIOUR_JOBS (`results` in its
    order), each held to the JAX package's pass count over the same seeds
    less SHARE_SLACK (JAX_PASSES; the run on the port's own draw of the
    backflip's ground is reported); every solve's rollouts one
    planner_rollout_cost launch each (iterations + 1) and as many mppi_update
    launches, `actuation` never, `contact` once per reset (its contact
    priming)."""
    from quadruped_springs_tpu_torch import mpc_behaviours

    by_run = {}
    for (run, _), res in zip(BEHAVIOUR_JOBS, results):
        acc = by_run.setdefault(run, {"records": [], "launches": {}, "seconds": 0.0})
        acc["records"] += res["records"]
        acc["seconds"] = max(acc["seconds"], res["seconds"])
        for k, v in res["launches"].items():
            acc["launches"][k] = acc["launches"].get(k, 0) + v
    by_path, failed = {}, []
    for run, res in by_run.items():
        records, counts = res["records"], res["launches"]
        name = run.removesuffix("_drawn_ground")
        its = mpc_behaviours.PLANNERS[name].iterations
        solves = sum(r["solves"] for r in records)
        check_counts(counts, {**mppi_launches(solves, its), "actuation": 0,
                              "contact": len(records), "contact_anchored": 0}, 20)
        passes = 0
        for rec in records:
            ok, kpis = behaviour_passed(name, rec)
            passes += ok
            print(f"phase 20: {run} (seed {rec['seed']}): {kpis}; {rec['solves']} solves",
                  flush=True)
            print(json.dumps({f"mpc_{run}": rec}))
        seeds = [rec["seed"] for rec in records]
        least = JAX_PASSES.get(run, 0) - SHARE_SLACK.get(run, 0)
        gate = (f"the gate: at least {least} (the JAX package {JAX_PASSES[run]}, less "
                f"{SHARE_SLACK.get(run, 0)})" if run in JAX_PASSES else "reported, no bar")
        if run == "jumping_forward":
            early = sum(behaviour_passed(name, r)[0] for r in records if r["seed"] < 8)
            gate += (f"; seeds 0-7: {early} of 8, the JAX package {JAX_FORWARD_PASSES_0_7} "
                     f"(reported)")
        print(f"phase 20: {run}: {passes} of {len(records)} seeds ({seeds[0]}-{seeds[-1]}) "
              f"meet the bars; {gate}; the longest process {res['seconds']:.2f} s on {kind}; "
              f"launches {counts}", flush=True)
        if run in JAX_PASSES and passes < least:
            failed.append(run)
        by_path[f"mpc_{run}"] = counts
    if failed:
        raise AssertionError(f"phase 20: {failed} pass fewer seeds than the JAX package")
    return by_path


# -- phases 21-23: the springs-vs-rigid comparisons and the examples ---------

def check_example_widths(torch, act, dyn, ilqr, model):
    """Head of phase 23: `actuation` and `contact` against their twins at the
    iLQR examples' lane counts (EXAMPLE_ILQR: B lanes a rollout, B x alphas a
    line search, each launch a block of SMALL_INPUT_LANES or more lanes) with
    the planner's constants, and `actuation_jvp`, `contact_jvp` against
    torch.func.jvp of theirs at one linearization block (B x knots lanes x
    N_TANGENTS), to the bounds of phases 3 and 8."""
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    checks = {k: {} for k in ("actuation", "contact", "actuation_jvp", "contact_jvp")}
    for path, (b, horizon, alphas) in EXAMPLE_ILQR.items():
        task = "BACKFLIP" if path == "backflip" else "JUMPING_IN_PLACE"
        prob = MPCProblem(MPCConfig(task=task, horizon=horizon), "cuda")
        sim = prob.sim_params
        for what, lanes in (("rollout", b), ("line_search", b * alphas)):
            n = lanes * math.ceil(SMALL_INPUT_LANES / lanes)
            tag = f"{path}_{what}_{lanes}"
            checks["actuation"][tag] = check_actuation(torch, act, prob, n, lanes=lanes)
            contact = check_contact(torch, dyn, model, n, sim.contact_stiffness,
                                    sim.contact_damping, lanes)
            checks["contact"][tag] = contact[False]
            checks["contact"][tag + "_clamp"] = contact[True]
        block = b * ilqr.linearization_blocks(b, horizon, N_TANGENTS)
        tag = f"{path}_block_{block}"
        checks["actuation_jvp"][tag] = check_actuation_jvp(torch, act, prob, block)
        jvp = check_contact_jvp(torch, dyn, block)
        checks["contact_jvp"][tag], checks["contact_jvp"][tag + "_clamp"] = jvp[False], jvp[True]
    for name, by_setting in checks.items():
        worst = max(by_setting.values(), key=lambda r: r["max_abs_err"])
        ms = [r["ms"] for r in by_setting.values()]
        print(f"phase 23: {name} against its twin at the iLQR examples' widths "
              f"({', '.join(by_setting)}): max_abs_err {worst['max_abs_err']:.3e}, kernel "
              f"{min(ms):.4f}-{max(ms):.4f} ms through its wrapper", flush=True)
    return checks


def _planned_worker(label):
    """Phase 21, in a process of its own: compare_springs.planned_rows of one
    robot over PLANNED_SEEDS on the card (the solves of all seeds one batch,
    the best plans one fidelity env). Returns the rows, the kernels' launches,
    those its resets and env steps call for, and the wall time."""
    import torch

    from quadruped_springs_tpu_torch import compare_springs as cs
    from quadruped_springs_tpu_torch.env.env import QuadrupedEnv
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts(act, dyn)
    t0 = time.perf_counter()
    with EnvCalls(QuadrupedEnv) as calls:
        rows = cs.planned_rows(cs.CONFIGS[label], torch.device("cuda"), PLANNED_SEEDS)
    torch.cuda.synchronize()
    return {"rows": rows, "launches": read_counts(act, dyn), "want": calls.launches(),
            "seconds": time.perf_counter() - t0}


def check_planned(results, kind):
    """Phase 21: the planned comparison (scripts/compare_springs.py's
    configuration: H = 50, K = 64, 10 iterations, the accept rollout every
    iteration, 8 solves, the best plan and 70 knots of the landing action on
    each robot's 1 kHz fidelity env) over PLANNED_SEEDS. Held: every row
    finite, the peak motor torque at the 33.55 N m limit on every row
    (JAX: 16 of 16), springs' executed apex above rigid's at no fewer seeds
    than the JAX package's JAX_PLANNED["springs_higher"] less PLANNED_SLACK;
    tests/test_artifacts.py's three bars together are counted beside
    JAX_PLANNED["bars"] (the share rule leaves them no bar); launches exact:
    one batched solve a robot, 2 + 2 x iterations planner_rollout_cost and
    mppi_update launches,
    env_substeps once per settle and control step, contact once per reset,
    actuation never."""
    from quadruped_springs_tpu_torch import compare_springs as cs

    by_path, failed = {}, []
    for label, res in results.items():
        check_counts(res["launches"], {**res["want"],
                                       **mppi_launches(1, PLANNED_ITERATIONS, fused=False),
                                       **dict.fromkeys(BF16_KERNELS, 0)}, 21)
        by_path[f"compare_planned_{label}"] = res["launches"]
        for row in res["rows"]:
            values = [v for k, v in row.items() if isinstance(v, float)] + row["costs"]
            if not all(math.isfinite(v) for v in values):
                failed.append(f"{label}: non-finite row {row}")
            if round(row["peak_motor_torque_Nm"], 2) != 33.55:
                failed.append(f"{label}: peak motor torque {row['peak_motor_torque_Nm']}")
    pairs = list(zip(PLANNED_SEEDS, results["springs"]["rows"], results["rigid"]["rows"]))
    higher = sum(s["executed_apex_m"] > g["executed_apex_m"] for _, s, g in pairs)
    bars = sum(cs.bars(s, g) for _, s, g in pairs)
    for seed, s, g in pairs:
        print(f"phase 21: planned seed {seed}: springs planned best "
              f"{s['planned_apex_best_m']:.3f} m (cost {s['best_cost']:.2f}, mean "
              f"{s['mean_cost']:.2f}), executed {s['executed_apex_m']:.3f} m, upright "
              f"{s['upright']}, work {s['motor_work_J']:.2f} J | rigid "
              f"{g['planned_apex_best_m']:.3f} m ({g['best_cost']:.2f}, {g['mean_cost']:.2f}), "
              f"executed {g['executed_apex_m']:.3f} m, upright {g['upright']}, work "
              f"{g['motor_work_J']:.2f} J | gain {s['executed_apex_m'] - g['executed_apex_m']:+.3f}"
              f" m; test_artifacts' bars {cs.bars(s, g)}", flush=True)
    gains = [s["executed_apex_m"] - g["executed_apex_m"] for _, s, g in pairs]
    least = JAX_PLANNED["springs_higher"] - PLANNED_SLACK
    first = {lab: cs.rounded(results[lab]["rows"][0]) for lab in results}
    print(json.dumps({"compare_springs_planned": {
        **first, "summary": cs.summary(first["springs"], first["rigid"]),
        "seed": PLANNED_SEEDS[0]}}))
    print(f"phase 21: planned comparison over seeds {PLANNED_SEEDS[0]}-{PLANNED_SEEDS[-1]}: "
          f"springs above rigid at {higher} (the gate: at least {least}, the JAX package "
          f"{JAX_PLANNED['springs_higher']} of its keys 1-8 on the CPU, less {PLANNED_SLACK}); "
          f"mean gain {statistics.mean(gains):+.4f} m (JAX {JAX_PLANNED['mean_gain_m']:+.4f}); "
          f"all of test_artifacts' bars at {bars} (JAX {JAX_PLANNED['bars']}; reported); the "
          f"committed JAX run (docs/springs_vs_rigid.json): executed 1.142 / 0.801 m; the "
          f"longest process {max(r['seconds'] for r in results.values()):.2f} s on {kind}; "
          f"launches {by_path}", flush=True)
    if higher < least:
        failed.append(f"springs above rigid at {higher} seeds, fewer than {least}")
    if failed:
        raise AssertionError(f"phase 21: {failed}")
    return by_path


def _learned_worker(label):
    """Phase 22, in a process of its own: compare_springs.run_config of one
    robot for LEARNED_ITERS iterations on the card. Returns the record (W's
    finiteness in place of W), the kernels' launches, those its resets and
    env steps call for, and the wall time."""
    import torch

    from quadruped_springs_tpu_torch import compare_springs as cs
    from quadruped_springs_tpu_torch.env.env import QuadrupedEnv
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts(act, dyn)
    t0 = time.perf_counter()
    with EnvCalls(QuadrupedEnv) as calls:
        rec = cs.run_config(cs.CONFIGS[label], LEARNED_ITERS, 0, "cuda")
    torch.cuda.synchronize()
    rec["W_finite"] = bool(torch.isfinite(rec.pop("W")).all())
    return {"record": rec, "launches": read_counts(act, dyn), "want": calls.launches(),
            "seconds": time.perf_counter() - t0}


def check_learned(results, kind):
    """Phase 22: the learned comparison at the cut depth LEARNED_ITERS (its
    full configuration otherwise), one process a robot. Held: every metric
    and W finite; every iteration changed W unless its top returns tied
    (sigma_r at its 1e-8 floor: the update is then 0 by the algorithm);
    launches exact (env_substeps once per settle and control step, contact
    once per reset); the springs' best evaluation apex at LEARNED_APEX or
    more. The evaluation apexes are printed beside the JAX curve's over the
    same iterations."""
    with open("docs/springs_vs_rigid_learned.json") as f:
        committed = json.load(f)
    by_path, failed = {}, []
    for label, res in results.items():
        rec, curve = res["record"], res["record"]["curve"]
        check_counts(res["launches"], {**res["want"], "planner_rollout": 0,
                                       **dict.fromkeys(BF16_KERNELS, 0)}, 22)
        by_path[f"compare_learned_{label}"] = res["launches"]
        values = [v for c in curve for v in c.values()]
        if not (rec["W_finite"] and all(math.isfinite(v) for v in values)):
            failed.append(f"{label}: a non-finite metric or W")
        stuck = [c["iter"] for c in curve if c["dW_max"] == 0.0 and c["sigma_r"] > SIGMA_TIE]
        if stuck:
            failed.append(f"{label}: W unchanged at iterations {stuck}")
        if label == "springs" and rec["best_apex_m"] < LEARNED_APEX:
            failed.append(f"springs: best evaluation apex {rec['best_apex_m']} below "
                          f"{LEARNED_APEX} m in {LEARNED_ITERS} iterations")
        jax_curve = committed[label]["curve"][:LEARNED_ITERS]
        print(f"phase 22: learned {label}, {LEARNED_ITERS} iterations in {res['seconds']:.2f} s "
              f"({res['seconds'] / LEARNED_ITERS:.3f} s an iteration) on {kind}: evaluation "
              f"apex {[round(c['eval_max_height'], 3) for c in curve]} (JAX "
              f"{[round(c['eval_max_height'], 3) for c in jax_curve]}); best "
              f"{rec['best_apex_m']:.3f} m, 0.5 m at iteration {rec['iters_to_0p5m']} (JAX "
              f"{committed[label]['iters_to_0p5m']}); ties "
              f"{sum(c['sigma_r'] <= SIGMA_TIE for c in curve)}; launches {res['launches']}",
              flush=True)
    if failed:
        raise AssertionError(f"phase 22: {failed}")
    return by_path


def _two_stage_worker(job):
    """Phase 24, in a process of its own: one two-stage trainer
    (train_two_stage --task job, or train_two_stage_backflip) at its --smoke
    budgets on the card, writing under runs/chip_smoke/. Returns its
    results and stage timing, the kernels' launches, those its resets and
    env steps call for, and the wall time."""
    import torch

    from quadruped_springs_tpu_torch import train_two_stage, train_two_stage_backflip
    from quadruped_springs_tpu_torch.env.env import QuadrupedEnv
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act

    torch.backends.cuda.matmul.allow_tf32 = False
    out = f"runs/chip_smoke/two_stage_{job}"
    reset_counts(act, dyn)
    t0 = time.perf_counter()
    with EnvCalls(QuadrupedEnv) as calls:
        if job == "backflip":
            results, timing = train_two_stage_backflip.run(
                "cuda", out, **train_two_stage_backflip.SMOKE)
        else:
            results, timing = train_two_stage.run(job, "cuda", out, **train_two_stage.SMOKE)
    torch.cuda.synchronize()
    return {"results": results, "timing": timing, "launches": read_counts(act, dyn),
            "want": calls.launches(), "seconds": time.perf_counter() - t0}


def _all_finite(x):
    if isinstance(x, dict):
        return all(_all_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_all_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def check_two_stage(results, kind):
    """Phase 24: each two-stage trainer at its smoke budgets. Held, with no
    learning bar: every number of its results finite; their key set the JAX
    script's (TWO_STAGE_JOBS' committed artifact); the consistency invariants
    of tests/test_artifacts.py that are no bar (the polish's no-op flag
    against its two gates and the warm-start stage, the fine-tune's no-op
    flag against its gate); launches exact, env_substeps launched."""
    by_path, failed = {}, []
    for job, res in results.items():
        r, timing = res["results"], res["timing"]
        check_counts(res["launches"], {**res["want"], "planner_rollout": 0,
                                       **dict.fromkeys(BF16_KERNELS, 0)}, 24)
        by_path[f"two_stage_{job}"] = res["launches"]
        with open(f"examples/out/{TWO_STAGE_JOBS[job]}") as f:
            keys = set(json.load(f))
        if set(r) != keys:
            failed.append(f"{job}: keys {sorted(set(r) ^ keys)} differ from the JAX script's")
        if not _all_finite(r):
            failed.append(f"{job}: a non-finite number in its results")
        if res["launches"]["env_substeps"] == 0:
            failed.append(f"{job}: env_substeps never launched")
        if r["finetune_is_noop"] != (not r["finetune_improves_on_initializer"]):
            failed.append(f"{job}: finetune_is_noop against finetune_improves_on_initializer")
        if job != "backflip":
            noop = not (r["ppo_imitate_demo_held"] and r["ppo_imitate_transfer_held"])
            if (r["ppo_imitate_is_noop"] != noop or r["warmstart_stage"]
                    != ("bc" if noop else "ppo_imitate")):
                failed.append(f"{job}: the polish's no-op flag or warm-start stage")
        stages = {k: round(v, 2) for k, v in timing["stage_seconds"].items()}
        print(f"phase 24: two-stage {job} at its smoke budgets in {res['seconds']:.2f} s on "
              f"{kind}: stages {stages} s, env_substeps by stage "
              f"{timing['env_substeps_launches']}; {len(r)} keys (the JAX script's: "
              f"{set(r) == keys}); launches {res['launches']}", flush=True)
    if failed:
        raise AssertionError(f"phase 24: {failed}")
    return by_path


def _behaviour_trainer_worker(job):
    """Phase 25, in a process of its own: one behaviour trainer entry point
    (BEHAVIOUR_TRAINERS[job]) at its smoke budgets on the card, writing
    under runs/chip_smoke/behaviour_<job>/. Returns its exit code, printed
    record, the key sets and finiteness of the npz files it wrote, the
    kernels' launches, those its resets and env steps call for, and the wall
    time."""
    import contextlib
    import importlib
    import io

    import numpy as np
    import torch

    from quadruped_springs_tpu_torch.env.env import QuadrupedEnv
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act

    torch.backends.cuda.matmul.allow_tf32 = False
    module, argv, files = BEHAVIOUR_TRAINERS[job]
    out = f"runs/chip_smoke/behaviour_{job}"
    entry = importlib.import_module(f"quadruped_springs_tpu_torch.{module}")
    reset_counts(act, dyn)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with EnvCalls(QuadrupedEnv) as calls, contextlib.redirect_stdout(printed):
        code = entry.main([*argv, "--out", out])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    written = {}
    for name in files:
        try:
            with np.load(f"{out}/{name}") as z:
                written[name] = {"keys": sorted(z.files), "finite": all(
                    bool(np.isfinite(z[k]).all()) for k in z.files if z[k].dtype.kind == "f")}
        except FileNotFoundError:
            written[name] = None
    if job == "validate":
        with open(f"{out}/backflip_robust_validation.json") as f:
            code, record = 0, json.load(f)
    else:
        record = json.loads(printed.getvalue().strip().splitlines()[-1])
    return {"code": code, "record": record, "written": written,
            "launches": read_counts(act, dyn), "want": calls.launches(), "seconds": seconds}


def check_behaviour_trainers(results, kind):
    """Phase 25: each behaviour trainer at its smoke budgets. Held, with no
    learning bar: every npz it wrote carries the JAX artifact's key set
    (BEHAVIOUR_TRAINERS) and finite numbers, its record is finite, its exit
    code the script's rule (1 when its gate fails; the robust fine-tune
    saves nothing then); launches exact, env_substeps launched; the
    committed robust pair completes the rotation on all of the validation's
    seeds (its rotation bar)."""
    import numpy as np

    by_path, failed = {}, []
    for job, res in results.items():
        rec, code = res["record"], res["code"]
        bptt = rec.get("bptt")
        vjp = 0 if bptt is None else bptt["control_steps"]
        check_counts(res["launches"], {**res["want"], "planner_rollout": 0,
                                       "env_substeps_vjp": vjp,
                                       **dict.fromkeys(BF16_KERNELS, 0)}, 25)
        if bptt is not None:
            if bptt["env_substeps_vjp_launches"] != vjp or vjp == 0:
                failed.append(f"{job}: {bptt['env_substeps_vjp_launches']} env_substeps_vjp "
                              f"launches for {vjp} control steps")
            print(f"phase 26: {BEHAVIOUR_TRAINERS[job][0]} --optimizer bptt at its smoke "
                  f"budgets in {res['seconds']:.2f} s on {kind}: losses {bptt['loss']}, "
                  f"gradient norms {bptt['grad_norm']}, {vjp} env_substeps_vjp launches for "
                  f"{vjp} control steps; stages {rec['stage_seconds']}", flush=True)
        by_path[f"behaviour_{job}"] = res["launches"]
        if res["launches"]["env_substeps"] == 0:
            failed.append(f"{job}: env_substeps never launched")
        if not _all_finite(rec):
            failed.append(f"{job}: a non-finite number in its record")
        for name, committed in BEHAVIOUR_TRAINERS[job][2].items():
            got = res["written"][name]
            if got is None:
                if not (job == "robust" and not rec["gate_ok"]):
                    failed.append(f"{job}: {name} not written")
                continue
            with np.load(f"examples/policies/{committed}") as z:
                keys = sorted(z.files)
            if got["keys"] != keys or not got["finite"]:
                failed.append(f"{job}: {name} keys {got['keys']} (JAX {keys}), finite "
                              f"{got['finite']}")
        if job == "validate":
            with open("examples/out/backflip_robust_validation.json") as f:
                jax_keys = set(json.load(f))
            if set(rec) != jax_keys or rec["full_rotation"] != rec["n"]:
                failed.append(f"validate: keys {sorted(set(rec) ^ jax_keys)} differ or "
                              f"rotation {rec['full_rotation']}/{rec['n']}")
            summary = (f"rotation {rec['full_rotation']}/{rec['n']}, strict upright "
                       f"{rec['strict_upright']}/{rec['n']}")
        else:
            if code != (0 if rec.get("gate_ok", True) else 1):
                failed.append(f"{job}: exit code {code} against gate_ok {rec.get('gate_ok')}")
            summary = {k: rec[k] for k in ("gate_ok", "stage_seconds", "env_substeps_launches",
                                           "nominal", "rotation", "upright", "ret")
                       if k in rec}
        print(f"phase 25: {BEHAVIOUR_TRAINERS[job][0]} ({job}) at its smoke budgets in "
              f"{res['seconds']:.2f} s on {kind}, exit {code}: {summary}; launches "
              f"{res['launches']}", flush=True)
    if failed:
        raise AssertionError(f"phase 25: {failed}")
    return by_path


def _noise_repair_worker(_):
    """Phase 25, in a process of its own: the observation-noise repair on the
    card. ARS's train_step at δ = 0 on the noisy JUMPING_FORWARD task at
    train_behavior_policies' forward width (16 directions x a bank of 8 x 2
    signs = 256 lanes, 200 steps): the per-lane returns, r+ against r−; and
    the joint trainer's flattened-flip score of one candidate alone against
    the same candidate among REPAIR_CANDIDATES (REPAIR_KNOTS control steps,
    two seeded TEST_RANDOMIZER scenarios with noise)."""
    import numpy as np
    import torch

    from quadruped_springs_tpu_torch import convert
    from quadruped_springs_tpu_torch import train_behavior_policies as tbp
    from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv, take
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act
    from quadruped_springs_tpu_torch.train import ars as tars
    from quadruped_springs_tpu_torch.train import behaviour as bh
    from quadruped_springs_tpu_torch.train import rollout as ro

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts(act, dyn)
    t0 = time.perf_counter()
    env = QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="JUMPING_FORWARD", observation_space_mode="ARS_BASIC",
        action_space_mode="SYMMETRIC", settling_steps=tbp.FORWARD_SETTLE,
        max_ep_len=tbp.FORWARD_EP_LEN), device="cuda")
    cfg = tbp.FORWARD_ARS
    trainer = tars.ARSTrainer(env, cfg)
    ts = trainer.init(torch.Generator("cuda").manual_seed(0))
    ts = dataclasses.replace(ts, W=0.3 * torch.randn(
        ts.W.shape, generator=torch.Generator("cuda").manual_seed(1), device="cuda"))
    seen = {}
    orig = ro.episode_returns

    def spy(*a, **k):
        seen["rets"], info = orig(*a, **k)
        return seen["rets"], info

    tars.ro.episode_returns = spy
    ts2, metrics = trainer.train_step(
        ts, deltas=torch.zeros(cfg.n_directions, *ts.W.shape, device="cuda"))
    tars.ro.episode_returns = orig
    r = seen["rets"].view(2, cfg.n_directions, cfg.reset_bank_size)
    ars = {"lanes": int(seen["rets"].numel()), "bitwise_equal": bool(torch.equal(r[0], r[1])),
           "max_abs_diff": float((r[0] - r[1]).abs().max()),
           "w_unchanged": bool(torch.equal(ts2.W, ts.W)),
           "entries_differ": bool(r[0, 0].unique().numel() > 1)}

    flip = bh.flip_env("cuda", "TEST_RANDOMIZER", obs_noise=True)
    state, obs, noise = ro.seeded_reset(flip, [0, 1])
    W, norm = convert.load_linear_policy("examples/policies/backflip_ars.npz", "cuda")
    lander = np.load("examples/policies/backflip_landing_mlp.npz")
    params = {"W": W.cpu().numpy(),
              "mlp": {k: np.asarray(lander[k], np.float32) for k in ("W1", "b1", "W2", "b2")}}
    layout = bh.FlatLayout(params)
    rng = np.random.default_rng(0)
    cand = (layout.ravel(params)[None] + 0.02 * rng.standard_normal(
        (REPAIR_CANDIDATES, layout.size))).astype(np.float32)

    def score(c_idx, ent):
        p = bh.lanes_params(cand, layout, torch.as_tensor(c_idx, device="cuda"), "cuda")
        ent = torch.as_tensor(ent, device="cuda")
        sc, _ = bh.episode_score(flip, bh.linear_act(p["W"], norm), bh.mlp_act(p["mlp"], norm),
                                 take(state, ent), obs[ent], noise.take(ent), REPAIR_KNOTS)
        return sc

    c = REPAIR_CANDIDATES // 2 + 1
    many = score(np.repeat(np.arange(REPAIR_CANDIDATES), 2), np.tile([0, 1], REPAIR_CANDIDATES))
    alone = score([c], [1])
    torch.cuda.synchronize()
    flat = {"lanes": int(many.numel()), "bitwise_equal": bool(torch.equal(alone[0],
                                                                          many[2 * c + 1])),
            "alone": float(alone[0]), "among": float(many[2 * c + 1])}
    return {"ars": ars, "flat": flat, "sigma_r": float(metrics["sigma_r"]),
            "launches": read_counts(act, dyn), "seconds": time.perf_counter() - t0}


def check_noise_repair(res, kind):
    """Phase 25: the repair holds on the card (see _noise_repair_worker)."""
    ars, flat = res["ars"], res["flat"]
    print(f"phase 25: observation noise per scenario on {kind}: ARS at delta = 0, "
          f"{ars['lanes']} lanes: r+ == r- bitwise {ars['bitwise_equal']} (max |r+ - r-| "
          f"{ars['max_abs_diff']:.3e}), W unchanged {ars['w_unchanged']}, sigma_r "
          f"{res['sigma_r']:.3e}, entries differ {ars['entries_differ']}; the flattened flip's "
          f"score alone {flat['alone']!r} and among {REPAIR_CANDIDATES} candidates "
          f"({flat['lanes']} lanes) {flat['among']!r}: bitwise {flat['bitwise_equal']}; "
          f"{res['seconds']:.2f} s", flush=True)
    if not (ars["bitwise_equal"] and ars["w_unchanged"] and ars["entries_differ"]
            and flat["bitwise_equal"]):
        raise AssertionError(f"phase 25: the noise repair does not hold: {ars}, {flat}")
    if res["launches"]["env_substeps"] == 0:
        raise AssertionError("phase 25: the repair's paths never launched env_substeps")
    return {"noise_repair": res["launches"]}


def _example_worker(job):
    """Phase 23, in a process of its own: one run of
    quadruped_springs_tpu_torch.examples at its default size on the card,
    job = (run, keyword arguments). Returns its record, the kernels'
    launches, those its resets and env steps call for, and the wall time."""
    import torch

    from quadruped_springs_tpu_torch import examples
    from quadruped_springs_tpu_torch.env.env import QuadrupedEnv
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts(act, dyn)
    t0 = time.perf_counter()
    run, kw = job
    with EnvCalls(QuadrupedEnv) as calls:
        rec = examples.RUNS[run](device="cuda", **kw)
    torch.cuda.synchronize()
    return {"record": rec, "launches": read_counts(act, dyn), "want": calls.launches(),
            "seconds": time.perf_counter() - t0}


def ilqr_launches(horizon, iterations, blocks=1, substeps=2):
    """`actuation` (and `contact`) and their tangents' launches of one iLQR
    solve: a substep's launch for every knot of the first rollout, of each
    iteration's line search (all candidates one launch) and of each
    linearization block's primal; the tangents once per block and substep."""
    return substeps * (horizon + iterations * (blocks + horizon)), substeps * iterations * blocks


def example_passed(run, kw, rec):
    """The bars of the verify skill's "Drive it" list (and
    tests/test_closed_loop_behaviors.py's for the Cartesian jump), and the
    KPIs they read, as a line of text."""
    if run == "episode":
        ok = (abs(rec["reset_height_m"] - 0.325) < 0.01 and all(rec["feet_in_contact"])
              and rec["max_height_m"] > 0.2 and rec["controller_switched"])
        return ok, (f"reset height {rec['reset_height_m']:.4f} m (~0.325), feet "
                    f"{rec['feet_in_contact']}, max relative height {rec['max_height_m']:.3f} m "
                    f"(bar 0.2), switched {rec['controller_switched']}, return "
                    f"{rec['return']:.4f}")
    if run == "cpg":
        ok = rec["forward_travel_m"] > 0.05 and rec["min_height_m"] > 0.12
        return ok, (f"forward travel {rec['forward_travel_m']:.4f} m (bar 0.05), least height "
                    f"{rec['min_height_m']:.4f} m (0.12), mean {rec['mean_height_m']:.4f} m")
    if run == "cartesian_jump":
        ok = rec["apex_rel_m"] >= 0.25 and rec["controller_switched"] and rec["upright"]
        return ok, (f"apex {rec['apex_rel_m']:.3f} m (bar 0.25), switched "
                    f"{rec['controller_switched']}, upright {rec['upright']} (up_z "
                    f"{rec['up_z']:.4f}, final z {rec['final_z']:.3f} m)")
    if run == "mpc":
        ok = rec["monotone"] and rec["controls_finite"] and rec["max_height_m"] > 0.33
        text = (f"cost {rec['initial_cost']:.4f} -> {rec['final_cost']:.4f} (monotone "
                f"{rec['monotone']}), max height {rec['max_height_m']:.4f} m (bar 0.33), "
                f"predicted apex {rec['predicted_apex_m']:.4f} m, |u| <= {rec['u_absmax']:.3f}")
        if kw.get("batch"):
            same = rec["batch_cost_min"] == rec["batch_cost_max"] == rec["final_cost"]
            ok = ok and same
            text += f"; {kw['batch']} copies as one batch: costs equal the single solve's {same}"
        return ok, text
    if run == "backflip":
        ok = rec["rotation_deg"] > 60.0 and rec["monotone"] and rec["controls_finite"]
        return ok, (f"rotation {rec['rotation_deg']:.1f} deg (bar 60), cost "
                    f"{rec['initial_cost']:.2f} -> {rec['final_cost']:.2f} (monotone "
                    f"{rec['monotone']}), apex {rec['apex_height_m']:.3f} m")
    values = [v for step in rec["steps"] for v in step.values()] + [
        rec[k] for k in ("eval_return_mean", "eval_return_std", "eval_max_height_m", "W_absmax")]
    return all(math.isfinite(v) for v in values), (
        f"train returns {[round(st['mean_return'], 4) for st in rec['steps']]}, evaluation "
        f"{rec['eval_return_mean']:.4f} +- {rec['eval_return_std']:.4f}, apex "
        f"{rec['eval_max_height_m']:.3f} m, max |W| {rec['W_absmax']:.4f}")


def check_examples(results, kind):
    """Phase 23: every run of EXAMPLE_JOBS at its default size, each held to
    its example's bars (example_passed) and to exact launches: the
    environment's runs one env_substeps per settle and control step and one
    contact per reset; the iLQR runs ilqr_launches of `actuation` and
    `contact` and their tangents a solve; MPPI one planner_rollout_cost per
    rollout and one mppi_update before each (2 + 2 x iterations of each
    without the fused accept)."""
    from quadruped_springs_tpu_torch import examples
    from quadruped_springs_tpu_torch.solver import ilqr

    by_path, failed = {}, []
    for (run, kw), res in zip(EXAMPLE_JOBS, results):
        rec = res["record"]
        name = run + "".join(f"_{k}" for k in kw)
        zero = dict.fromkeys(COUNTERS, 0)
        if run == "mpc" and kw.get("mppi"):
            want = {**zero, **mppi_launches(1, examples.MPPI_ITERATIONS, fused=False)}
        elif run in ("mpc", "backflip"):
            horizon, its = ((examples.MPC_HORIZON, examples.MPC_ITERATIONS) if run == "mpc"
                            else (examples.BACKFLIP_HORIZON, examples.BACKFLIP_ITERATIONS))
            want = {**zero}
            # the example's solve of one problem, and with --batch its batch
            for b in (1, kw["batch"]) if kw.get("batch") else (1,):
                blocks = math.ceil(horizon / ilqr.linearization_blocks(b, horizon, N_TANGENTS))
                primal, tangent = ilqr_launches(horizon, its, blocks)
                for k, v in (("actuation", primal), ("contact", primal),
                             ("actuation_jvp", tangent), ("contact_jvp", tangent)):
                    want[k] += v
        else:
            want = {**zero, **res["want"]}
        check_counts(res["launches"], want, 23)
        by_path[f"example_{name}"] = res["launches"]
        ok, kpis = example_passed(run, kw, rec)
        if not ok:
            failed.append(name)
        print(f"phase 23: example {name}: {kpis}; {res['seconds']:.2f} s on {kind}; launches "
              f"{ {k: v for k, v in res['launches'].items() if v} }", flush=True)
        print(json.dumps({f"example_{name}": rec}))
    if failed:
        raise AssertionError(f"phase 23: {failed} miss their examples' bars")
    return by_path


def _examples_stamp():
    """(path, size, mtime) of every file under examples/."""
    import os

    return sorted((os.path.join(d, f), os.stat(os.path.join(d, f)).st_size,
                   os.stat(os.path.join(d, f)).st_mtime_ns)
                  for d, _, files in os.walk("examples") for f in files)


def _continuous_trainer_worker(_):
    """Phase 27, in a process of its own: train_continuous_policy --smoke on
    the card through its main (stdout captured), --out under runs/chip_smoke/.
    Returns its results, printed lines, the kernels' launches, those its
    resets and env steps call for, whether examples/ and the --out directory
    were left untouched, and the wall time."""
    import contextlib
    import io
    import os

    import torch

    from quadruped_springs_tpu_torch import train_continuous_policy
    from quadruped_springs_tpu_torch.env.env import QuadrupedEnv
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act

    torch.backends.cuda.matmul.allow_tf32 = False
    out = "runs/chip_smoke/continuous_policy"
    examples = _examples_stamp()
    reset_counts(act, dyn)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with EnvCalls(QuadrupedEnv) as calls, contextlib.redirect_stdout(printed):
        results = train_continuous_policy.main(["--smoke", "--out", out])
    torch.cuda.synchronize()
    return {"results": results, "printed": printed.getvalue().strip().splitlines(),
            "launches": read_counts(act, dyn), "want": calls.launches(),
            "examples_untouched": _examples_stamp() == examples,
            "out_untouched": not os.path.exists(out),
            "seconds": time.perf_counter() - t0}


def check_continuous_trainer(res, kind):
    """Phase 27: the continuous-jumping trainer at --smoke. Held, with no
    learning bar: every number of its results finite; their key set the
    committed JAX artifact's, each seed's entry the JAX one's less crashed
    and with task_terminated and timeout; launches exact (env_substeps
    launched); the script's summary lines printed, the timing line last;
    nothing written."""
    r, failed = res["results"], []
    check_counts(res["launches"], {**res["want"], "planner_rollout": 0, "env_substeps_vjp": 0,
                                   **dict.fromkeys(BF16_KERNELS, 0)}, 27)
    with open(CONTINUOUS_RESULTS) as f:
        jax_results = json.load(f)
    if set(r) != set(jax_results):
        failed.append(f"keys {sorted(set(r) ^ set(jax_results))} differ from the JAX script's")
    seed_keys = (set(jax_results["gate_eval"]["per_seed"][0]) - {"crashed"}) | {
        "task_terminated", "timeout"}
    for stage in ("ars_eval", "bc_eval", "ppo_eval", "gate_eval"):
        if any(set(s) != seed_keys for s in r[stage]["per_seed"]):
            failed.append(f"{stage}: a seed's keys differ from {sorted(seed_keys)}")
    if not _all_finite(r):
        failed.append("a non-finite number in its results")
    if res["launches"]["env_substeps"] == 0:
        failed.append("env_substeps never launched")
    if r["finetune_is_noop"] != (not r["finetune_improves_on_initializer"]):
        failed.append("finetune_is_noop against finetune_improves_on_initializer")
    if not (res["examples_untouched"] and res["out_untouched"]):
        failed.append(f"wrote files: examples/ untouched {res['examples_untouched']}, --out "
                      f"absent {res['out_untouched']}")
    printed = res["printed"]
    timing = json.loads(printed[-1])
    if not (printed[-2].startswith("gate: ") and set(json.loads(printed[-3])) == {
            "bc_rows", "bc_mse", "selected_stage", "ppo_improves_on_bc", "finetune_is_noop",
            "policy_sustains_4_good_jumps", "wall_s"}):
        failed.append(f"the summary lines: {printed[-3:]}")
    stages = {k: round(v, 2) for k, v in timing["stage_seconds"].items()}
    print(f"phase 27: train_continuous_policy --smoke in {res['seconds']:.2f} s on {kind}: "
          f"stages {stages} s, env_substeps by stage {timing['env_substeps_launches']}; "
          f"{printed[-3]}; {printed[-2]}; launches {res['launches']}", flush=True)
    if failed:
        raise AssertionError(f"phase 27: {failed}")
    return res["launches"]


def _render_backflip_worker(_):
    """Phase 27, in a process of its own: render_backflip's record mode at
    seed 0 on the card through its main. Returns its printed lines, the
    trace, the kernels' launches, those its reset and env steps call for,
    and the wall time."""
    import contextlib
    import io

    import numpy as np
    import torch

    from quadruped_springs_tpu_torch import render_backflip
    from quadruped_springs_tpu_torch.env.env import QuadrupedEnv
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.ops import actuation as act

    out = "runs/chip_smoke/render_backflip/backflip.npz"
    reset_counts(act, dyn)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with EnvCalls(QuadrupedEnv) as calls, contextlib.redirect_stdout(printed):
        render_backflip.main(["--seed", "0", "--out", out])
    torch.cuda.synchronize()
    with np.load(out) as d:
        trace = {k: d[k] for k in d.files}
    return {"printed": printed.getvalue().strip().splitlines(), "trace": trace,
            "launches": read_counts(act, dyn), "want": calls.launches(),
            "seconds": time.perf_counter() - t0}


def check_render_backflip(res, kind):
    """Phase 27: the recorded backflip is finite and its controller
    switched; launches exact. Its steps and maximum unwrapped pitch are
    printed beside the JAX script's at its seed 0 (JAX_RENDER)."""
    import numpy as np

    check_counts(res["launches"], {**res["want"], "planner_rollout": 0, "env_substeps_vjp": 0,
                                   **dict.fromkeys(BF16_KERNELS, 0)}, 27)
    trace = res["trace"]
    steps = len(trace["q"])
    finite = all(bool(np.isfinite(trace[k]).all()) for k in ("q", "base_pos", "base_rpy"))
    switch = int(trace["switch_step"])
    pitch = next(line for line in res["printed"] if line.startswith("max unwrapped pitch"))
    print(f"phase 27: render_backflip record mode at seed 0 in {res['seconds']:.2f} s on "
          f"{kind}: {steps} steps recorded, the switch after {switch}, {pitch} (the JAX "
          f"script at its seed 0 on the CPU: {JAX_RENDER['steps']} steps, "
          f"{JAX_RENDER['max_pitch_deg']} deg); launches {res['launches']}", flush=True)
    if not finite or switch < 0 or steps != len(trace["valid"]):
        raise AssertionError(f"phase 27: render_backflip's trace: finite {finite}, switch "
                             f"step {switch}, {steps} steps")
    return res["launches"]


# ---------------------------------------------------------------------------
# Phase 26: the env step's reverse mode, env_substeps_vjp
# ---------------------------------------------------------------------------
VJP_SOURCE = "quadruped_springs_tpu_torch/csrc/env_step_vjp.cu"
# the TPU side: jax.value_and_grad through the control step (XLA's reverse
# mode of row 3's fusion) in the lander's --optimizer bptt
VJP_REPLACES = "scripts/train_backflip_landing_mlp.py:387"
BPTT_STATES = 24                  # the lander's --train-states: BPTT's width


def vjp_cotangents(torch, ss, args, seed):
    """Seeded standard-normal cotangents of env_substeps's float outputs on
    `args`, one tensor per ss.GRAD_OUTPUTS field."""
    out = ss.env_substeps(*args)
    gen = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(o.shape, generator=gen, device="cuda") for o in ss.output_fields(out)]


def check_env_substeps_vjp(torch, ss, args, seed, reps=10):
    """The `env_substeps_vjp` kernel against env_substeps_vjp_plain (autograd
    through env_substeps_plain) on the same arguments and seeded cotangents,
    by phase 5's rule (REL_TOL, ENV_SPREAD) as env/substeps.py check_vjp
    holds it; raises on a failure. Times the kernel through
    its wrapper and alone, and the plain version."""
    from quadruped_springs_tpu_torch import kernels

    cot = vjp_cotangents(torch, ss, args, seed)
    got = ss.env_substeps_vjp(*args, cot)
    torch.cuda.synchronize()
    r = ss.check_vjp(args, cot, got, REL_TOL, ENV_SPREAD)
    if r["failures"]:
        raise AssertionError(f"env_substeps_vjp: {len(r['failures'])} of {args[0].q.shape[0]} "
                             f"environments fail: {r['failures'][:3]}")
    one = lambda: ss.env_substeps_vjp(*args, cot)
    launch, grads, keep = ss.vjp_launch_args(*args, cot)
    robot = args[0]
    run, stream = kernels.library().env_substeps_vjp, kernels.stream_handle(robot.q.device)
    n, substeps, ext = robot.q.shape[0], args[13], args[14]
    friction = args[4].friction
    inputs = [robot.pos, robot.quat, robot.lin_vel, robot.ang_vel, robot.q, robot.qd,
              *args[1:3], *args[5:13], ss.pack_model(args[3]),
              *(t for t in (friction, ext) if torch.is_tensor(t)), *cot]
    return {**r, "ms": cuda_time_ms(torch, one, reps=reps),
            "profile": (one, "env_substeps_vjp_kernel"),
            "kernel_ms": cuda_time_ms(torch, lambda: run(*launch, stream), reps=reps, inner=5),
            "plain_ms": cuda_time_ms(torch, lambda: ss.env_substeps_vjp_plain(*args, cot),
                                     reps=2),
            **roofline("env_substeps_vjp", n * substeps, inputs, list(grads))}


def bptt_touchdown_states(torch, kind):
    """BPTT_STATES post-touchdown BACKFLIP states under TEST_RANDOMIZER with
    observation noise, as the lander's bank holds them: the committed launch
    through the "until_grounded" autopilot (train_backflip_landing_mlp
    collect_bank). Returns (env, states)."""
    from quadruped_springs_tpu_torch import convert
    from quadruped_springs_tpu_torch import train_backflip_landing_mlp as lander
    from quadruped_springs_tpu_torch.env import wrappers as wr
    from quadruped_springs_tpu_torch.policy_replay import POLICY_DIR
    from quadruped_springs_tpu_torch.train import behaviour as bh

    env = bh.flip_env("cuda", "TEST_RANDOMIZER", obs_noise=True, max_ep_len=lander.EP_LEN)
    w = wr.LandingWrapperBackflip(env, variant="until_grounded")
    W, on = convert.load_linear_policy(str(POLICY_DIR / "backflip_ars.npz"), "cuda")
    states, _, _, tries, rot = lander.collect_bank(env, w, bh.linear_act(W, on), BPTT_STATES,
                                                   lambda m: None)
    print(f"phase 26: {BPTT_STATES} touchdown states of the lander's bank ({tries} seeds, "
          f"{rot} full rotations) on {kind}", flush=True)
    return env, states


def env_substeps_vjp_settings(torch, env_bench, landing, kind):
    """Phase 26's settings: BPTT's width (BPTT_STATES touchdown states, the
    lander's random action held for 10 substeps); phase 5's 1,024
    environments x 10 substeps with the command interpolated and every 8th
    lane pushed ("env"), the same command held, TORQUE mode, on the rack and
    at the edges (ss.edge_states: every 4th lane past its joint limits,
    every 8th on its back on the trunk's corners and every 8th folded onto
    its knees); and one environment (lane 3 of "env": pushed, command
    interpolated).
    Returns ({setting: env_substeps's arguments}, (env, state, q_des, ext)
    of "env")."""
    from quadruped_springs_tpu_torch.control import interfaces as ci
    from quadruped_springs_tpu_torch.env import substeps as ss
    from quadruped_springs_tpu_torch.env.env import take

    settings5, (env, state, q_des, ext) = env_substeps_settings(torch, env_bench, landing)
    flip, bank = bptt_touchdown_states(torch, kind)
    gen = torch.Generator("cuda").manual_seed(26)
    action = 2.0 * torch.rand((BPTT_STATES, flip.action_dim), generator=gen,
                              device="cuda") - 1.0
    lane = torch.arange(3, 4, device="cuda")
    settings = {
        f"bptt_{BPTT_STATES}": env_substeps_args(
            flip, bank, ci.action_to_command(flip.iface, action).contiguous(), 10),
        "env": settings5["env"],
        "env_held": env_substeps_args(env, state, q_des[:, -1].contiguous(), 10),
        "env_torque": settings5["env_torque"],
        "env_on_rack": settings5["env_on_rack"],
        "env_edges": ss.edge_states(settings5["env"], limits=range(1, ENVS, 4),
                                    upside_down=range(6, ENVS, 8), folded=range(7, ENVS, 8)),
        "env_1": env_substeps_args(env, take(state, lane), q_des[lane].contiguous(), 10,
                                   ext=ext[lane].contiguous())}
    return settings, (env, state, q_des, ext)


def check_env_substeps_vjp_batching(torch, ss, env, state, q_des, ext):
    """Rows 0-ENV_GAP_ROWS-1 of one env_substeps_vjp launch at N
    environments, at ENV_GAP_ROWS and in blocks of ENV_GAP_BLOCK, on the same
    rows of the cotangents: bitwise equal. Returns max |d| per batching."""
    from quadruped_springs_tpu_torch.env.env import take

    n = state.robot.q.shape[0]
    full_args = env_substeps_args(env, state, q_des, 10, ext=ext)
    cot = vjp_cotangents(torch, ss, full_args, 27)

    def rows(a, b):
        idx = torch.arange(a, b, device="cuda")
        return ss.vjp_rows(ss.env_substeps_vjp(
            *env_substeps_args(env, take(state, idx), q_des[idx].contiguous(), 10,
                               ext=ext[idx].contiguous()),
            [c[idx].contiguous() for c in cot]))

    full, whole = rows(0, n), rows(0, ENV_GAP_ROWS)
    blocks = [rows(i, i + ENV_GAP_BLOCK) for i in range(0, ENV_GAP_ROWS, ENV_GAP_BLOCK)]
    gap = {}
    for name, sol in ((str(n), full), (f"{ENV_GAP_ROWS // ENV_GAP_BLOCK} x {ENV_GAP_BLOCK}",
                                       None)):
        gap[name] = max(float(((torch.cat([b[k] for b in blocks]) if sol is None
                                else sol[k][:ENV_GAP_ROWS]) - whole[k]).abs().max())
                        for k in whole)
    return gap


def check_forward_under_grad(torch, ss, args):
    """env_substeps's outputs on `args` with and without requires_grad on
    the state, anchors and command: bitwise equal (the forward kernel runs
    unchanged under _EnvSubsteps); the backward of those outputs through
    autograd launches env_substeps_vjp once and gives env_substeps_vjp's
    cotangents bitwise. Returns the launches of the backward."""
    plain_out = ss.env_substeps(*args)
    robot = args[0]
    leaves = [t.detach().clone().requires_grad_() for t in (
        *(getattr(robot, f) for f in ss.ROBOT_FIELDS), args[1], args[2])]
    grad_args = (dataclasses.replace(robot, **dict(zip(ss.ROBOT_FIELDS, leaves[:6]))),
                 leaves[6], leaves[7], *args[3:])
    with torch.enable_grad():
        out = ss.env_substeps(*grad_args)
        for a, b in zip(ss.output_fields(plain_out) + [plain_out.feet_in_contact,
                                                       plain_out.invalid_contact],
                        ss.output_fields(out) + [out.feet_in_contact, out.invalid_contact]):
            if not torch.equal(a, b.detach()):
                raise AssertionError("phase 26: env_substeps's outputs differ under grad")
        cot = vjp_cotangents(torch, ss, args, 28)
        before = ss.env_substeps_vjp.launches
        grads = torch.autograd.grad(ss.output_fields(out), leaves, cot)
        launches = ss.env_substeps_vjp.launches - before
    direct = ss.env_substeps_vjp(*args, cot)
    for k, a, b in zip(ss.VJP_FIELDS, grads, direct):
        if not torch.equal(a, b):
            raise AssertionError(f"phase 26: autograd's d_{k} differs from env_substeps_vjp's")
    if launches != 1:
        raise AssertionError(f"phase 26: the backward launched env_substeps_vjp {launches} "
                             f"times, expected 1")
    return launches


def check_env_substeps_vjp_shapes(torch, ss, env_bench, landing, kind):
    """Phase 26, kernel part: env_substeps_vjp against its plain version at
    env_substeps_vjp_settings; rows 0-7 bitwise at 1,024, 8 and 2
    environments; env_substeps's outputs bitwise with and without grad."""
    settings, (env, state, q_des, ext) = env_substeps_vjp_settings(torch, env_bench, landing,
                                                                   kind)
    checks = {}
    for i, (setting, args) in enumerate(settings.items()):
        r = checks[setting] = check_env_substeps_vjp(torch, ss, args, seed=260 + i)
        print(f"phase 26: env_substeps_vjp ({setting}) at {args[0].q.shape[0]} environments x "
              f"10 substeps: max_abs_err {r['max_abs_err']:.3e} (bound {REL_TOL}·(1+|plain|) + "
              f"{ENV_SPREAD} x the plain version's spread; {r['spread_used']:.2f} spreads "
              f"used; {len(r['along'])} environments held along the kernel's own substep "
              f"starts, of them at a proven kink {r['kinks']}), kernel "
              f"{r['ms']:.4f} ms through its wrapper, "
              f"{r['kernel_ms'] * 1e3:.2f} µs on the card (back-to-back launches between two "
              f"CUDA events), plain (autograd) {r['plain_ms']:.2f} ms; bound "
              f"{r['bound_ms'] * 1e3:.3f} µs ({r['bytes']} bytes, by {r['bound_by']}) on {kind}",
              flush=True)
    gap = check_env_substeps_vjp_batching(torch, ss, env, state, q_des, ext)
    print(f"phase 26: env_substeps_vjp rows 0-{ENV_GAP_ROWS - 1} of {ENVS} environments against "
          f"the same rows launched as {ENV_GAP_ROWS} and in blocks of {ENV_GAP_BLOCK}: max |d| "
          f"{gap} (0: bitwise equal)", flush=True)
    if any(v != 0.0 for v in gap.values()):
        raise AssertionError(f"phase 26: env_substeps_vjp rows depend on the batch: {gap}")
    for setting in (f"bptt_{BPTT_STATES}", "env", "env_torque", "env_on_rack"):
        check_forward_under_grad(torch, ss, settings[setting])
    print("phase 26: env_substeps's outputs bitwise equal with and without requires_grad "
          "(4 settings); autograd's backward launched env_substeps_vjp once each and gave its "
          "cotangents bitwise", flush=True)
    return checks, gap


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card and has no CPU fallback")
    from quadruped_springs_tpu_torch import (bench, env_bench, kernels, policy_replay,
                                             train_bench)
    from quadruped_springs_tpu_torch.env import randomizers as rnd
    from quadruped_springs_tpu_torch.env import substeps as ss
    from quadruped_springs_tpu_torch.env.wrappers import LANDING_KD, LANDING_KP
    from quadruped_springs_tpu_torch.models import dynamics as dyn
    from quadruped_springs_tpu_torch.models import spatial
    from quadruped_springs_tpu_torch.ops import actuation as act
    from quadruped_springs_tpu_torch.solver import ilqr
    from quadruped_springs_tpu_torch.solver import mppi_update as mu
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    started = time.perf_counter()
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
    log = kernels.build_log().splitlines()
    entries = [(kernel, i) for kernel in ("env_substeps_kernel", "planner_rollout_kernel",
                                          "env_substeps_vjp_kernel",
                                          "planner_rollout_cost_kernel")
               for i in [next(i for i, line in enumerate(log)
                              if "Compiling entry function" in line and kernel in line)]]
    # mppi_update's instantiations: <K (32, 64, 0: any other), threads a
    # block, blocks an SM of its launch bounds>
    entries += [("mppi_update_kernel<{}, {}, {}>".format(*inst.groups()), i)
                for i, line in enumerate(log) if "Compiling entry function" in line
                for inst in [re.search(r"mppi_update_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)]
                if inst]
    for kernel, i in entries:
        usage = " | ".join(x.strip() for x in log[i + 2:i + 4])
        print(f"phase 2: {kernel} (nvcc -Xptxas -v): {usage}", flush=True)
        # the two forward kernels must not spill; the adjoint's
        # intermediates outgrow 255 registers (its stack is gated below);
        # the cost instantiation's and mppi_update's are printed
        if ("0 bytes spill stores, 0 bytes spill loads" not in usage
                and kernel in ("env_substeps_kernel", "planner_rollout_kernel")):
            raise AssertionError(f"phase 2: {kernel} spills to local memory: {usage}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for setting, (task, full_rate, B, K, H, _, _) in mppi_widths().items():
        m = MPCProblem((MPCConfig.full_rate if full_rate else MPCConfig)(task=task, horizon=H),
                       "cuda").action_dim
        occ = mu.occupancy(K, H, m, B)
        print(f"phase 2: mppi_update_kernel at {setting} ({B} x {K} x {H}, m = {m}): "
              f"{occ['registers']} registers and {occ['local_bytes']} bytes of local memory a "
              f"thread, {occ['threads_per_block']} threads, {occ['shared_bytes']} bytes of "
              f"shared memory ({occ['groups_a_slot']} groups of 4 rows a slot) a block, "
              f"{occ['blocks_per_sm']} blocks ({occ['warps_per_sm']} warps) an SM: "
              f"{min(B, occ['blocks_per_sm'] * sms)} of {B} problems in flight on {sms} SMs",
              flush=True)
    occ = ss.occupancy()
    print(f"phase 2: env_substeps_kernel: {occ['registers']} registers and "
          f"{occ['local_bytes']} bytes of local memory a thread, {occ['threads_per_block']} "
          f"threads a block, {occ['blocks_per_sm']} blocks ({occ['warps_per_sm']} warps) an SM "
          f"(env_substeps_occupancy: cudaFuncGetAttributes, "
          f"cudaOccupancyMaxActiveBlocksPerMultiprocessor)", flush=True)
    vocc = ss.occupancy("env_substeps_vjp")
    print(f"phase 2: env_substeps_vjp_kernel: {vocc['registers']} registers and "
          f"{vocc['local_bytes']} bytes of local memory a thread, "
          f"{vocc['threads_per_block']} threads (8 environments) and {vocc['shared_bytes']} "
          f"bytes of shared memory a block ({vocc['chunk']} substeps' records, recomputed at "
          f"once), {vocc['blocks_per_sm']} blocks ({vocc['warps_per_sm']} warps) an SM: "
          f"{min(ENVS // 8, vocc['blocks_per_sm'] * sms)} of phase 26's {ENVS // 8} blocks "
          f"in flight on {sms} SMs", flush=True)
    if vocc["local_bytes"] > VJP_LOCAL_BYTES:
        raise AssertionError(f"phase 2: env_substeps_vjp_kernel holds {vocc['local_bytes']} "
                             f"bytes of local memory a thread, more than its "
                             f"{VJP_LOCAL_BYTES}")
    if occ["local_bytes"] > ENV_LOCAL_BYTES:
        raise AssertionError(f"phase 2: env_substeps_kernel holds {occ['local_bytes']} bytes of "
                             f"local memory a thread, more than the {ENV_LOCAL_BYTES} of "
                             f"sinf's and cosf's reduction of huge arguments")
    from quadruped_springs_tpu_torch.solver import rollout as ro
    for what, repeats, one_row in (("headline and full rate", SAMPLES, False),
                                   ("fused accept's settle", 2, False),
                                   ("behaviours' R = 64", 64, False),
                                   ("executor, one row", 1, True),
                                   ("R = 1, a row a lane", 1, False)):
        for horizon in (None, HORIZON):
            occ = ro.occupancy(repeats, one_row, horizon=horizon)
            name = ("planner_rollout_kernel" if horizon is None
                    else f"planner_rollout_cost_kernel (H = {horizon})")
            print(f"phase 2: {name} at R = {repeats} ({what}): {occ['registers']} registers "
                  f"and {occ['local_bytes']} bytes of local memory a thread, "
                  f"{occ['threads_per_block']} threads and {occ['shared_bytes']} bytes of "
                  f"shared memory a block, {occ['blocks_per_sm']} blocks "
                  f"({occ['warps_per_sm']} warps) an SM "
                  f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)", flush=True)
            # the xs-only instantiation as before the cost instantiation: 128
            # registers, 16 warps an SM at the headline's R
            if (horizon is None and repeats == SAMPLES
                    and (occ["registers"] > 128 or occ["warps_per_sm"] != 16)):
                raise AssertionError(f"phase 2: planner_rollout_kernel at {occ}, not 128 "
                                     f"registers and 16 warps an SM")

    prob = MPCProblem(MPCConfig(horizon=HORIZON, iterations=ITERATIONS), "cuda")
    model = prob.lane_params().model
    # checks[kernel][setting] = {max_abs_err, ms, plain_ms}; the first
    # setting of each kernel is the one its JSON line's times report
    planner_contact = check_contact(torch, dyn, model, LANES, 4000.0, 40.0)
    bf16 = torch.bfloat16
    contact_bf16 = check_contact(torch, dyn, model, LANES, 4000.0, 40.0, dtype=bf16)
    # the full-rate model's contact, as the bf16 knot rounds it: 180,224 N/m
    contact_bf16_stiff = check_contact(torch, dyn, model, LANES, 180224.0, 100.0,
                                       dtype=bf16)
    checks = {"actuation": {"planner": check_actuation(torch, act, prob, LANES)},
              "contact": {"planner": planner_contact[False],
                          "planner_clamp": planner_contact[True]},
              "actuation_bf16": {"planner": check_actuation(torch, act, prob, LANES,
                                                            dtype=bf16)},
              "contact_bf16": {"planner": contact_bf16[False],
                               "planner_clamp": contact_bf16[True],
                               "full_rate_clamp": contact_bf16_stiff[True]}}
    report_checks(3, checks, LANES, "lanes")
    checks["planner_rollout"], rollout_gap, _ = check_planner_rollout_shapes(torch, kind)
    checks.update(check_mppi_iteration_widths(torch, kind))

    reset_counts(act, dyn)
    rec = bench.run(batch=BATCH, horizon=HORIZON, iterations=ITERATIONS,
                    samples=SAMPLES, runs=TIMED_RUNS, device="cuda")
    torch.cuda.synchronize()
    by_path = {"mppi_solve": read_counts(act, dyn)}
    costs = rec["costs"]
    if not bool(torch.isfinite(costs).all()):
        raise AssertionError("non-finite final costs in the full-width solve")
    mean_cost = rec["mean_final_cost"]
    lo, hi = sorted((REFERENCE_COST * (1 - COST_BAND), REFERENCE_COST * (1 + COST_BAND)))
    if not lo <= mean_cost <= hi:
        raise AssertionError(f"mean final cost {mean_cost} outside [{lo:.2f}, {hi:.2f}]")
    # fused accept: `iterations` K-wide rollouts plus one final rollout of
    # (proposal, best), each one planner_rollout_cost launch of H knots, and
    # one mppi_update launch before each
    rollouts = rec["solves"] * (ITERATIONS + 1)
    check_counts(by_path["mppi_solve"], {**mppi_launches(rec["solves"], ITERATIONS),
                                         "actuation": 0, "contact": 0, "contact_anchored": 0,
                                         "env_substeps": 0, "actuation_jvp": 0,
                                         "contact_jvp": 0, **dict.fromkeys(BF16_KERNELS, 0)},
                 4)
    print(f"phase 4: {rec['solves']} full-width solves ran {rollouts} rollouts, one "
          f"planner_rollout_cost launch each and one mppi_update launch before each "
          f"({ITERATIONS + 1} of each a solve; planner_rollout, `actuation` and `contact` "
          f"0); mean final cost {mean_cost:.4f} (JAX {REFERENCE_COST}, the parent "
          f"{PARENT_HEADLINE_COST}) "
          f"(band [{lo:.2f}, {hi:.2f}]); {rec['value']:.2f} solves/s on {kind}",
          flush=True)
    print(json.dumps({"bench": bench.line(rec)}))
    by_path["full_rate_solve"] = run_full_rate(torch, bench, act, dyn, kind)

    # the environment's shapes and constants: 1024 lanes, the motor and the
    # landing wrapper's gains with per-environment springs, and reset's
    # contact priming at the execution model's 180 kN/m with the clamp on
    env = env_bench.QuadrupedEnv(env_bench.bench_config(ENV_SETTLE), device="cuda")
    sim = env.sim_params
    landing = [torch.full((12,), g, device="cuda") for g in (LANDING_KP, LANDING_KD)]
    env_contact = check_contact(torch, dyn, model, ENVS, sim.contact_stiffness,
                                sim.contact_damping)
    anchored = check_anchored_contact(torch, dyn, model, ENVS)
    env_checks = {"actuation": {"env": check_actuation(torch, act, env, ENVS),
                                "env_landing": check_actuation(torch, act, env, ENVS,
                                                               *landing)},
                  "contact": {"env_clamp": env_contact[True], "env": env_contact[False]},
                  "contact_anchored": {"env_clamp": anchored[True], "env": anchored[False]}}
    report_checks(5, env_checks, ENVS, "environments")
    for name, by_setting in env_checks.items():
        checks.setdefault(name, {}).update(by_setting)
    checks["env_substeps"], env_gap = check_env_substeps_shapes(torch, ss, env_bench, landing,
                                                                kind)
    checks["env_substeps_vjp"], vjp_gap = check_env_substeps_vjp_shapes(torch, ss, env_bench,
                                                                        landing, kind)

    by_path["env_rollout"], step_syncs, env_breakdown = run_env_bench(
        torch, env_bench, act, dyn, rnd, spatial, kind)
    by_path["landing_episode"] = run_landing_episode(torch, act, dyn, kind)
    if step_syncs:
        raise AssertionError(f"env.step synchronised the host {step_syncs} times")

    # one block of the full-width linearization: knots x problems lanes
    block_lanes = BATCH * ilqr.linearization_blocks(BATCH, HORIZON, N_TANGENTS)
    contact_jvp = check_contact_jvp(torch, dyn, block_lanes)
    contact_jvp_bf16 = check_contact_jvp(torch, dyn, block_lanes, dtype=bf16)
    jvp_checks = {"actuation_jvp": {"ilqr_block": check_actuation_jvp(torch, act, prob,
                                                                    block_lanes)},
                  "contact_jvp": {"ilqr_block": contact_jvp[False],
                                  "ilqr_block_clamp": contact_jvp[True]},
                  "actuation_jvp_bf16": {"ilqr_block": check_actuation_jvp(
                      torch, act, prob, block_lanes, dtype=bf16)},
                  "contact_jvp_bf16": {"ilqr_block": contact_jvp_bf16[False],
                                       "ilqr_block_clamp": contact_jvp_bf16[True]}}
    report_checks(8, jvp_checks, f"{block_lanes} x {N_TANGENTS}", "lanes x tangents")
    checks.update(jvp_checks)
    noop = kernels.library().planner_noop
    stream = kernels.stream_handle(torch.device("cuda"))
    floor_ms = cuda_time_ms(torch, lambda: noop(stream), reps=5, inner=200)
    print(f"phase 8: an empty kernel takes {floor_ms * 1e3:.2f} µs per launch (200 "
          f"back-to-back ctypes launches between two CUDA events) on {kind}", flush=True)

    check_linearization(torch, ilqr, MPCConfig, MPCProblem)
    by_path["ilqr_solve"], exact_cost = run_ilqr_solve(torch, bench, ilqr, act, dyn, kind)
    by_path["ilqr_solve_bf16"] = run_ilqr_bf16(torch, bench, ilqr, act, dyn, kind,
                                               exact_cost)
    width_checks = check_learning_widths(torch, act, dyn, model, landing)
    width_checks["env_substeps"] = check_two_stage_substeps(torch, ss, kind)
    width_checks["env_substeps"].update(check_two_stage_substeps(
        torch, ss, kind, BEHAVIOUR_WIDTHS, "TEST_RANDOMIZER", "behaviour"))
    fidelity_checks = check_fidelity_widths(torch, act, dyn, model)
    fidelity_checks["env_substeps"] = check_fidelity_substeps(torch, ss, kind)
    transfer_checks = check_transfer_block(torch, act, dyn, ilqr, prob)
    example_checks = check_example_widths(torch, act, dyn, ilqr, model)
    by_path.update(run_host_bound_paths(policy_replay, kind))
    by_path["train"] = run_train(torch, train_bench, act, dyn, kind)
    by_path["autopilot_adapters"] = run_adapters(torch, act, dyn, kind)
    by_path["sharded_solve"] = run_sharded(torch, act, dyn, ilqr, kind)
    for extra in (fidelity_checks, width_checks, transfer_checks, example_checks):
        for name, by_setting in extra.items():
            checks[name].update(by_setting)
    profile_kernels(torch, checks)
    print(json.dumps({"mppi_solve_profile": profile_mppi_solve(torch, kind)}))
    print(json.dumps({"env_control_step_breakdown": env_breakdown()}))
    print(f"chip_smoke: every phase in {time.perf_counter() - started:.1f} s on {kind}",
          flush=True)

    # the contact_anchored kernel extends the memoryless contact kernel
    # (the TPU kernel fused_contact) with the feet's anchor stiction
    # and the tangent kernels are the forward-mode derivatives of the two
    # and the bf16 variants are the same four kernels on bfloat16 storage;
    # env_substeps fuses both (actuation, anchored contact) into the env's
    # dynamics, planner_rollout (actuation, contact) into the planner's
    # rollout, as XLA fused them on the TPU
    replaces = {name: "scripts/pallas_microbench.py:" + ("96" if name.startswith("actuation")
                                                          else "153") for name in checks}
    replaces["env_substeps"] = replaces["planner_rollout"] = "scripts/pallas_microbench.py:96,153"
    replaces["env_substeps_vjp"] = VJP_REPLACES
    # the cost instantiation also runs the actuation and contact kernels'
    # math; mppi_update replaces no Pallas kernel: the rest of the body of the
    # TPU's lax.scan, which XLA fused around them
    replaces["planner_rollout_cost"] = "scripts/pallas_microbench.py:96,153"
    replaces["mppi_update"] = MPPI_UPDATE_REPLACES
    sources = {"env_substeps": ENV_SOURCE, "planner_rollout": ROLLOUT_SOURCE,
               "env_substeps_vjp": VJP_SOURCE, "planner_rollout_cost": ROLLOUT_SOURCE,
               "mppi_update": MPPI_UPDATE_SOURCE}
    gaps = {"env_substeps": env_gap, "planner_rollout": rollout_gap, "env_substeps_vjp": vjp_gap}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": sources.get(name, SOURCE),
         "replaces": replaces[name],
         "launches": sum(c.get(name, 0) for c in by_path.values()),
         "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()},
         "max_abs_err": max(r["max_abs_err"] for r in by_setting.values()),
         **{k: next(iter(by_setting.values()))[k]
            for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
         # no single PyTorch call computes any of these functions
         "library_ms": None, "launch_floor_ms": floor_ms, "checks": by_setting,
         **({"batch_gap": gaps[name]} if name in gaps else {})}
        for name, by_setting in checks.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
