"""The MPC behaviour drivers: trajectory optimisation drives the jumps on the
1 kHz environment.

The port of the JAX package's three MPC drivers, each in its example's
configuration (planner, sampler, warm start, wrappers, environment, loop):

  jumping_forward  examples/run_jumping_forward_mpc.py --driver mpc: MPPI on
                   the JUMPING_FORWARD cost (H = 30, K = 64, 8 iterations,
                   sigma 0.3) plans the launch from the settled state; the plan
                   executes open loop through LandingWrapper
  backflip         examples/run_backflip_closed_loop.py --launch mpc: MPPI on
                   the BACKFLIP cost (H = 24, K = 64, 8 iterations) plans the
                   launch; LandingWrapperBackflip ("hold") finishes it
  continuous       examples/run_continuous_jumping_mpc.py: receding-horizon
                   MPPI (H = 40, K = 32, 4 iterations, sigma 0.25, a solve
                   every 2 control steps, task_warm_start(crouch_knots=6)) on
                   the CONTINUOUS_JUMPING_FORWARD cost drives 6 s of
                   CONTINUOUS_JUMPING_FORWARD3 with PPO_CONTINUOUS_JUMPING_FORWARD
                   observations, scored by the task's per-jump statistics

Every rollout of every solve is one `planner_rollout` kernel launch on the
card. The solves' draws come from a torch.Generator seeded as the example
seeds its key (`seed + 1`); `draws`, a sequence of (iterations, 1, K, H, m)
standard-normal tensors, one per solve, replaces them (a test injects JAX's).
The JAX package's draws differ from the port's, so one seed of a driver can
land on the other side of a gate's bar in one package and not the other:
compare pass shares over seeds (PERF.md).

    python -m quadruped_springs_tpu_torch.mpc_behaviours jumping_forward
    python -m quadruped_springs_tpu_torch.mpc_behaviours continuous --seed 3
    python -m quadruped_springs_tpu_torch.mpc_behaviours backflip --device cpu \\
        --horizon 6 --samples 4 --iterations 1 --settle 100 --max-steps 4

prints one JSON line with the JAX example's keys (and `seed`, `device`,
`solves`). A CUDA device that is not available is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

from quadruped_springs_tpu_torch.env import randomizers as rnd
from quadruped_springs_tpu_torch.env import wrappers as wr
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.env_bench import device_name, resolve_device
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem, state_to_vec
from quadruped_springs_tpu_torch.solver.mppi import MPPIConfig
from quadruped_springs_tpu_torch.tasks.tasks import continuous_jump_stats

ROT_BAR = 2 * math.pi - 0.1      # full rotation: max unwrapped pitch
UP_Z_BAR, Z_BAR = 0.85, 0.15     # upright: R[2,2] and base height


@dataclasses.dataclass(frozen=True)
class Planner:
    """One driver's MPC problem and sampler (the JAX example's values)."""
    task: str
    horizon: int
    iterations: int
    n_samples: int
    sigma: float
    crouch_knots: int


PLANNERS = {
    "jumping_forward": Planner("JUMPING_FORWARD", 30, 8, 64, 0.3, 10),
    "backflip": Planner("BACKFLIP", 24, 8, 64, 0.3, 6),
    "continuous": Planner("CONTINUOUS_JUMPING_FORWARD", 40, 4, 32, 0.25, 6),
}


def planner(name: str, device, horizon=None, iterations=None, n_samples=None):
    """(MPCProblem, MPPIConfig, warm start (H,m)) of driver `name`, its sizes
    overridable. The MPC problem is the example's MPCConfig(task, horizon,
    iterations, n_alphas=4): the relaxed 200 Hz planner model."""
    p = PLANNERS[name]
    h = p.horizon if horizon is None else horizon
    it = p.iterations if iterations is None else iterations
    k = p.n_samples if n_samples is None else n_samples
    prob = MPCProblem(MPCConfig(task=p.task, horizon=h, iterations=it, n_alphas=4), device)
    mcfg = MPPIConfig(horizon=h, iterations=it, n_samples=k, sigma=p.sigma,
                      fused_accept=True)
    return prob, mcfg, prob.task_warm_start(crouch_knots=p.crouch_knots)[:h]


class _Solver:
    """The driver's solves: draws from `draws` in order where given, else
    from the generator seeded with seed + 1."""

    def __init__(self, prob, mcfg, device, seed, draws):
        self.prob, self.mcfg, self.draws, self.solves = prob, mcfg, draws, 0
        self.gen = torch.Generator(device).manual_seed(seed + 1)

    def __call__(self, x, u_warm):
        noise = None if self.draws is None else self.draws[self.solves]
        self.solves += 1
        return self.prob.solve_mppi(x, u_warm[None], self.gen, self.mcfg, noise=noise)


def _finish(rec: dict, device: torch.device, seed: int, solves: int) -> dict:
    name = device_name(device)
    return {**rec, "seed": seed, "device": name, "solves": solves}


@torch.no_grad()
def jumping_forward(seed: int = 0, device=None, draws=None, settle: int = 2500,
                    max_steps: int = 60, horizon=None, iterations=None,
                    n_samples=None) -> dict:
    """examples/run_jumping_forward_mpc.py run(driver="mpc"): the plan from the
    settled state, executed through LandingWrapper for up to max_steps policy
    steps. Gate (tests/test_closed_loop_behaviors.py): fwd_distance_m >= 0.30,
    apex_rel_m >= 0.10, final_z > 0.15."""
    device = resolve_device(device)
    env = QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="JUMPING_FORWARD", observation_space_mode="ARS_BASIC",
        action_space_mode="SYMMETRIC", obs_noise=False, env_randomizer_mode="NONE",
        max_ep_len=4.0, settling_steps=settle), device=device)
    w = wr.LandingWrapper(env)
    gen = torch.Generator(device).manual_seed(seed)
    state, _ = env.reset(gen)
    x_start = float(state.robot.pos[0, 0])
    prob, mcfg, warm = planner("jumping_forward", device, horizon, iterations, n_samples)
    solve = _Solver(prob, mcfg, device, seed, draws)
    sol = solve(state_to_vec(state.robot), warm)
    plan = sol.us[0]
    for i in range(max_steps):
        out = w.step(state, plan[min(i, plan.shape[0] - 1)][None], gen)
        state = out.state
        if bool(out.done[0]):
            break
    ts = state.task
    return _finish({
        "driver": "mpc",
        "planned_apex_m": float(sol.xs[0, :, 2].max()),
        "fwd_distance_m": float(state.robot.pos[0, 0]) - x_start,
        "task_fwd_peak_m": float(ts.max_forward_distance[0]),
        "apex_rel_m": float(ts.relative_max_height[0]),
        "final_z": float(state.robot.pos[0, 2]),
        "steps": i,
        "sim_s": float(env.sim_time(state)[0]),
    }, device, seed, solve.solves)


@torch.no_grad()
def backflip(seed: int = 0, device=None, draws=None, settle: int = 2500,
             max_steps: int = 60, horizon=None, iterations=None, n_samples=None,
             friction: float | None = None) -> dict:
    """examples/run_backflip_closed_loop.py run(launch="mpc"): the plan from
    the settled state, executed through LandingWrapperBackflip("hold") on
    the ground the env's GROUND_RANDOMIZER draws from the seed; `friction`,
    where given, replaces the drawn friction (a check injects the JAX
    example's scenario of a seed). The example's docstring: the plan
    completes the rotation but lands tilted (`upright` is reported)."""
    device = resolve_device(device)
    env = QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="BACKFLIP", observation_space_mode="ARS_BACKFLIP",
        action_space_mode="SYMMETRIC", obs_noise=False, max_ep_len=4.0,
        settling_steps=settle), device=device)
    w = wr.LandingWrapperBackflip(env, variant="hold")
    gen = torch.Generator(device).manual_seed(seed)
    scenario = rnd.sample_scenario(env.cfg, env.config.env_randomizer_mode, gen, 1)
    if friction is not None:
        scenario = dataclasses.replace(scenario, friction=torch.full_like(
            scenario.friction, friction))
    state, _ = env.reset(gen, scenario=scenario)
    prob, mcfg, warm = planner("backflip", device, horizon, iterations, n_samples)
    solve = _Solver(prob, mcfg, device, seed, draws)
    plan = solve(state_to_vec(state.robot), warm).us[0]
    for i in range(max_steps):
        out = w.step(state, plan[min(i, plan.shape[0] - 1)][None], gen)
        state = out.state
        if bool(out.done[0]):
            break
    pitch = float(state.task.max_pitch_bf[0])
    up_z = float(sp.quat_to_mat(state.robot.quat)[0, 2, 2])
    z = float(state.robot.pos[0, 2])
    return _finish({
        "launch": "mpc",
        "pitch_unwrapped_rad": pitch,
        "full_rotation": pitch >= ROT_BAR,
        "apex_rel_m": float(state.task.relative_max_height[0]),
        "final_z": z,
        "upright": up_z > UP_Z_BAR and z > Z_BAR,
        "steps": i,
        "sim_s": float(env.sim_time(state)[0]),
        "friction": float(scenario.friction[0]),
        "up_z": up_z,
    }, device, seed, solve.solves)


@torch.no_grad()
def continuous(seed: int = 0, device=None, draws=None, seconds: float = 6.0,
               replan_every: int = 2, settle: int = 2500, horizon=None,
               iterations=None, n_samples=None, max_steps: int | None = None) -> dict:
    """examples/run_continuous_jumping_mpc.py run(): a solve every
    replan_every control steps from the robot's state, warm-started from the
    shifted plan; the plan's first action is executed. Gate: sim_seconds >=
    5, good_jumps >= 4, at least 2 per-jump performances >= 0.85,
    total_fwd_m > 4.0. max_steps cuts the seconds * 100 control steps."""
    device = resolve_device(device)
    env = QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="CONTINUOUS_JUMPING_FORWARD3",
        observation_space_mode="PPO_CONTINUOUS_JUMPING_FORWARD",
        action_space_mode="SYMMETRIC", obs_noise=False, env_randomizer_mode="NONE",
        max_ep_len=float(seconds) + 1.0, settling_steps=settle), device=device)
    gen = torch.Generator(device).manual_seed(seed)
    state, _ = env.reset(gen)
    prob, mcfg, u_warm = planner("continuous", device, horizon, iterations, n_samples)
    solve = _Solver(prob, mcfg, device, seed, draws)
    n_steps = int(seconds * 100) if max_steps is None else max_steps
    zs, xs_track = [], []
    for t in range(n_steps):
        if t % replan_every == 0:
            u_warm = solve(state_to_vec(state.robot), u_warm).us[0]
        action = u_warm[0]
        u_warm = torch.cat([u_warm[1:], u_warm[-1:]], dim=0)
        state, _, _, done, _ = env.step(state, action[None], gen)
        zs.append(state.robot.pos[0, 2])
        xs_track.append(state.robot.pos[0, 0])
        if bool(done[0]):
            break
    zs, xs_track = torch.stack(zs).tolist(), torch.stack(xs_track).tolist()
    out = {"sim_seconds": round(float(env.sim_time(state)[0]), 2)}
    out.update(continuous_jump_stats(state.task))
    out.update({"total_fwd_m": round(xs_track[-1] - xs_track[0], 3),
                "final_z_m": round(zs[-1], 3), "max_z_m": round(max(zs), 3)})
    return _finish(out, device, seed, solve.solves)


DRIVERS = {"jumping_forward": jumping_forward, "backflip": backflip,
           "continuous": continuous}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("driver", choices=tuple(DRIVERS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--settle", type=int, default=2500, help="settling substeps")
    ap.add_argument("--horizon", type=int, default=None)
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="policy steps (continuous: control steps)")
    ap.add_argument("--seconds", type=float, default=6.0, help="continuous only")
    a = ap.parse_args(argv)
    kw = dict(seed=a.seed, device=a.device, settle=a.settle, horizon=a.horizon,
              iterations=a.iterations, n_samples=a.samples)
    if a.driver == "continuous":
        kw.update(seconds=a.seconds, max_steps=a.max_steps)
    elif a.max_steps is not None:
        kw["max_steps"] = a.max_steps
    rec = DRIVERS[a.driver](**kw)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
