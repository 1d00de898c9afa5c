"""Batched environment rollout throughput (the RL training axis) on one device.

The configuration of the JAX package's ``scripts/env_rollout_bench.py``:
JUMPING_IN_PLACE with springs, ARS_BASIC observations, SYMMETRIC actions,
GROUND_RANDOMIZER, settling_steps=600, 1024 environments holding the init
action for T=100 control steps of 10 x 1 kHz substeps per timed segment.
One untimed warm-up segment, then ``--segments`` timed ones, each bracketed
by ``torch.cuda.synchronize()``. Prints one JSON line: the metric (naming
the device), sim-steps/s and the real-time factor.

    python -m quadruped_springs_tpu_torch.env_bench                 # on the GPU
    python -m quadruped_springs_tpu_torch.env_bench --device cpu --batch 2 \\
        --settle 20 --steps 2 --segments 1                          # tiny CPU check

A CUDA device that is not available is an error, not a fallback.
``profile_steps`` breaks a control step down on the card (``chip_smoke.py``
prints it): kernel launches, device busy time and its share of the
untraced wall time, per control step and per substep, and the kernel
classes that take the device time: the fused ``env_substeps`` (the
physics) and what is left (the task, sensors, observation and model build).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv


def bench_config(settling_steps: int = 600) -> EnvConfig:
    return EnvConfig(enable_springs=True, task_env="JUMPING_IN_PLACE",
                     observation_space_mode="ARS_BASIC", action_space_mode="SYMMETRIC",
                     settling_steps=settling_steps)


def resolve_device(device) -> torch.device:
    """The entry points' device: `device`, CUDA when None; a CUDA device
    that is not available is an error, not a fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but torch.cuda.is_available() is False")
    return device


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run(batch: int = 1024, steps: int = 100, segments: int = 3, settle: int = 600,
        device="cuda", seed: int = 0, on_segment=None) -> dict:
    """Reset `batch` environments, then roll one warm-up and `segments`
    timed segments of `steps` control steps holding the init action.
    `on_segment(i, state_before, state_after)`, if given, is called after
    each segment outside the timed region (i = 0 is the warm-up). Returns the
    JSON record plus the reset state (`reset_state`), the last state
    (`state`) and the env (`env`)."""
    device = resolve_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    env = QuadrupedEnv(bench_config(settle), device=device)
    gen = torch.Generator(device).manual_seed(seed)
    t0 = time.perf_counter()
    state, _ = env.reset(gen, batch)
    sync()
    reset_s = time.perf_counter() - t0
    reset_state = state
    actions = env.get_init_action().expand(batch, -1)

    def segment(s):
        for _ in range(steps):
            s, _, _, _, _ = env.step(s, actions, gen)
        return s

    times = []
    for i in range(1 + segments):
        before = state
        t0 = time.perf_counter()
        state = segment(state)
        sync()
        if i:
            times.append(time.perf_counter() - t0)
        if on_segment is not None:
            on_segment(i, before, state)
    dt = sum(times) / len(times)
    sim_steps = batch * steps * env.config.action_repeat
    return {
        "metric": (f"env rollout sim-steps/s (batch {batch}, anchored stiction, "
                   f"torch port on {device_name(device)})"),
        "sim_steps_per_s": sim_steps / dt,
        "realtime_factor": sim_steps / dt * env.config.time_step,
        "reset_s": reset_s,
        "segment_s": times,
        "env": env,
        "reset_state": reset_state,
        "state": state,
    }


_KERNEL_CLASSES = (("env_substeps", "env_substeps_kernel"),
                   ("contact_anchored", "contact_anchored_kernel"),
                   ("actuation", "actuation_kernel"), ("contact", "contact_kernel"),
                   ("gemm/gemv", "gemm"), ("gemm/gemv", "gemv"), ("cat/stack", "Cat"),
                   ("copy", "copy"), ("reduce", "reduce"), ("elementwise", "elementwise"))


def profile_steps(env, state, actions, gen, steps: int) -> dict:
    """Launches, device busy time and wall time per control step and per
    substep over `steps` control steps (kernel times from torch.profiler,
    wall time untraced), and per control step the kernel classes' device
    time and launches."""
    from torch.profiler import ProfilerActivity, profile

    repeat = env.config.action_repeat
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = env.step(state, actions, gen)[0]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state = env.step(state, actions, gen)[0]
        torch.cuda.synchronize()
    classes, launches, busy_us = {}, 0, 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        launches += e.count
        busy_us += us
        cls = next((c for c, pat in _KERNEL_CLASSES if pat in e.key), "other")
        ms, n = classes.get(cls, (0.0, 0))
        classes[cls] = (ms + us / 1e3 / steps, n + e.count / steps)
    busy_ms = busy_us / 1e3 / steps
    return {"launches_per_control_step": launches / steps,
            "device_busy_ms_per_control_step": busy_ms,
            "wall_ms_per_control_step": wall_ms,
            "launches_per_substep": launches / steps / repeat,
            "device_busy_ms_per_substep": busy_ms / repeat,
            "wall_ms_per_substep": wall_ms / repeat,
            "device_busy_share": busy_ms / wall_ms,
            "kernel_classes_ms_and_launches_per_control_step": dict(
                sorted(classes.items(), key=lambda kv: -kv[1][0]))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=100, help="control steps per segment")
    ap.add_argument("--segments", type=int, default=3, help="timed segments")
    ap.add_argument("--settle", type=int, default=600, help="settling substeps")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    rec = run(a.batch, a.steps, a.segments, a.settle, a.device, a.seed)
    print(json.dumps({k: rec[k] for k in ("metric", "sim_steps_per_s", "realtime_factor",
                                          "reset_s")}))
    return rec


if __name__ == "__main__":
    main()
