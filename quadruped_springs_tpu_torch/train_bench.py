"""Learner-step throughput of the two trainers on one device.

The widths of the JAX package's own training runs
(``examples/train_two_stage.py``): ARS on the sparse JUMPING_IN_PLACE task
with springs, ARS_BASIC observations, SYMMETRIC actions, settle 600,
max_ep_len 1.0, 16 directions (top 8), 110 episode steps, bank 8: 256
episode lanes x 110 control steps x 10 substeps per ``train_step``, plus
the bank's reset; PPO on the dense JUMPING_IN_PLACE_PPO task (max_ep_len
2.0) with 32 environments x 64-step segments, bank 16, a 64-64 MLP and
4 epochs x 4 minibatches; and PPO's imitation stage, the BC-anchored polish
of ``examples/train_two_stage.py`` (``:264-353``): the JUMPING_IN_PLACE_DEMO
task (max_ep_len 2.5, demo_norm "full") on the committed
``examples/out/demo_jip_0.qsts`` as its demo actions and its RSI reset bank,
gamma 0.3, lambda 0.9, kl_stop 0.03, frozen statistics, white noise,
bc_coef 300, warm-started from one ``bc.fit`` (3,000 iterations, timed) on
the BC pairs of the six committed ``demo_jip_*.qsts``, which anchor the
polish. Each trainer takes one untimed warm-up step (the
first step of a process makes the device constants, a host copy each), then
the timed ones. Prints one JSON record: learner steps/s and env steps/s of
each trainer, the time of one PPO segment rollout alone (what is left of a
step is GAE and the minibatch updates), the launches of the environment's
kernels (the fused env_substeps and the per-substep ones it replaced), the
largest change of a policy weight in each step, and the
host synchronisations each step made (torch's sync debug mode counts them
on the card); the imitation record also the seconds of the BC fit.

    python -m quadruped_springs_tpu_torch.train_bench                  # on the GPU

A CUDA device that is not available is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import warnings
from pathlib import Path

import torch

from quadruped_springs_tpu_torch.env import demo_pipeline as dp
from quadruped_springs_tpu_torch.env import substeps as ss
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.env_bench import device_name, resolve_device
from quadruped_springs_tpu_torch.models import dynamics as dyn
from quadruped_springs_tpu_torch.ops import actuation as act
from quadruped_springs_tpu_torch.train import normalize as vnorm
from quadruped_springs_tpu_torch.train import rollout as ro
from quadruped_springs_tpu_torch.train import two_stage as st
from quadruped_springs_tpu_torch.train.ars import ARSConfig, ARSTrainer
from quadruped_springs_tpu_torch.train.ppo import PPOConfig, PPOTrainer
from quadruped_springs_tpu_torch.utils import demo as demo_util

ARS_CONFIG = ARSConfig(n_directions=16, top_directions=8, episode_steps=110,
                       reset_bank_size=8, step_size=0.02, delta_std=0.03)
PPO_CONFIG = PPOConfig(n_envs=32, segment_len=64, reset_bank_size=16, kl_stop=0.03)
DEMOS = sorted((Path(__file__).resolve().parents[1] / "examples" / "out").glob(
    "demo_jip_*.qsts"))
WARMUP_STEPS = 1                 # untimed train_steps of each trainer before the clock


def env_config(task: str, max_ep_len: float, settle: int = 600, **kw) -> EnvConfig:
    return EnvConfig(enable_springs=True, task_env=task, observation_space_mode="ARS_BASIC",
                     action_space_mode="SYMMETRIC", settling_steps=settle,
                     max_ep_len=max_ep_len, **kw)


def kernel_launches() -> dict:
    """The running launch counts of the environment's kernels: the fused
    `env_substeps` (the physics of a settle or a control step) and the
    per-substep kernels it replaced on the environment's paths."""
    return {"env_substeps": ss.env_substeps.launches,
            "actuation": act.actuation_torque.launches,
            "contact_anchored": dyn.contact_forces.anchored_launches,
            "contact": dyn.contact_forces.launches}


def count_syncs(fn):
    """(fn's result, the host synchronisations it made as torch's sync debug
    mode reports them, the source lines that made them). On a CPU device
    nothing is counted."""
    if not torch.cuda.is_available():
        return fn(), 0, []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{w.filename.split('/')[-1]}:{w.lineno}" for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    return out, len(where), sorted(set(where))


def _timed_steps(trainer, ts, steps: int, weights, sync):
    """WARMUP_STEPS untimed train_steps from ts, then `steps` timed ones: (last
    state, metrics of every step as floats, the warm-up's first, seconds of
    the timed steps, their launches, host syncs of every step, where they
    were made). `weights(ts)` lists the policy's tensors; each step's metrics
    gain `max_weight_change`, the largest |change| of one of their entries
    in that step. The metrics are read after the clock stops."""
    metrics, syncs, where = [], [], set()
    for i in range(WARMUP_STEPS + steps):
        if i == WARMUP_STEPS:
            before = kernel_launches()
            sync()
            t0 = time.perf_counter()
        old = [w.detach().clone() for w in weights(ts)]
        (ts, m), n, at = count_syncs(lambda: trainer.train_step(ts))
        m["max_weight_change"] = torch.stack(
            [(w.detach() - o).abs().max() for w, o in zip(weights(ts), old)]).max()
        metrics.append(m)
        syncs.append(n)
        where.update(at)
    sync()
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    return ts, metrics, seconds, launches, syncs, sorted(where)


def _actor(ps):
    return [p for n, p in ps.net.named_parameters() if not n.startswith("vf_")]


def run(steps: int = 2, device="cuda", seed: int = 0, settle: int = 600,
        ars_config: ARSConfig = ARS_CONFIG, ppo_config: PPOConfig = PPO_CONFIG) -> dict:
    """Time `steps` train_steps of each trainer after its init and WARMUP_STEPS
    untimed steps. Returns the JSON record plus, under "ars", "ppo" and
    "imitation", the trainer states before and after (`state0`, `state`) and
    the metrics of every step, the warm-up's first (`metrics`)."""
    device = resolve_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gen = torch.Generator(device).manual_seed(seed)
    rec = {"metric": f"trainer steps/s (torch port on {device_name(device)})",
           "device": device_name(device), "steps": steps, "warmup_steps": WARMUP_STEPS}

    ars = ARSTrainer(QuadrupedEnv(env_config("JUMPING_IN_PLACE", 1.0, settle), device=device),
                     ars_config)
    ts0 = ars.init(gen)
    ts, metrics, seconds, launches, syncs, where = _timed_steps(
        ars, ts0, steps, lambda ts: [ts.W], sync)
    lanes = 2 * ars_config.n_directions * ars_config.reset_bank_size
    rec["ars"] = {"lanes": lanes, "episode_steps": ars_config.episode_steps,
                  "steps_per_s": steps / seconds, "seconds_per_step": seconds / steps,
                  "env_steps_per_s": steps * lanes * ars_config.episode_steps / seconds,
                  "launches": launches, "host_syncs": syncs, "host_syncs_at": where,
                  "state0": ts0, "state": ts, "metrics": metrics}

    ppo = PPOTrainer(QuadrupedEnv(env_config("JUMPING_IN_PLACE_PPO", 2.0, settle),
                                  device=device), ppo_config)
    before = kernel_launches()
    ps0 = ppo.init(gen)
    init_launches = {k: v - before[k] for k, v in kernel_launches().items()}
    ps, metrics, seconds, launches, syncs, where = _timed_steps(
        ppo, ps0, steps, _actor, sync)
    # one more segment alone, from the last state: what of a step is the
    # rollout, the rest being GAE and the minibatch updates
    t0 = time.perf_counter()
    ro.segment_rollout(ppo.env, ppo._action_fn(ps.net, ps.obs_norm), ps.env_states, ps.obs,
                       ps.bank, gen, ppo_config.segment_len)
    sync()
    rollout_seconds = time.perf_counter() - t0
    rec["ppo"] = {"lanes": ppo_config.n_envs, "segment_len": ppo_config.segment_len,
                  "steps_per_s": steps / seconds, "seconds_per_step": seconds / steps,
                  "env_steps_per_s": (steps * ppo_config.n_envs * ppo_config.segment_len
                                      / seconds),
                  "rollout_seconds": rollout_seconds,
                  "update_share": 1.0 - rollout_seconds / (seconds / steps),
                  "launches": launches, "init_launches": init_launches,
                  "host_syncs": syncs, "host_syncs_at": where,
                  "state0": ps0, "state": ps, "metrics": metrics}
    rec["imitation"] = imitation(steps, device, sync, gen, settle)
    return rec


def imitation_trainer(device, settle: int = 600):
    """The in-place polish's trainer (two_stage.POLISH_PPO) on the committed
    demos, before BC: (trainer, the BC pairs' observations and actions of
    every demo)."""
    demos = [dp.load_demo_library(str(p), device) for p in DEMOS]
    env = QuadrupedEnv(env_config("JUMPING_IN_PLACE_DEMO", 2.5, settle, demo_norm="full"),
                       demo_actions=demo_util.demo_actions(demos[0], 6), device=device)
    trainer = PPOTrainer(env, st.POLISH_PPO, demo=demos[0])
    obs, acts = (torch.cat(x) for x in st.bc_dataset(env, demos))
    return trainer, obs, acts


def imitation_state(trainer, obs, acts, net, norm, gen):
    """The polish's state from a BC network and its statistics, anchored."""
    trainer.set_bc_anchor(vnorm.normalize(norm, obs), acts)
    return dataclasses.replace(trainer.init(gen, net=net), obs_norm=norm)


def imitation(steps: int, device, sync, gen, settle: int) -> dict:
    """The polish's record: the BC fit on the committed demos (two_stage.BC_ITERS
    iterations, timed), then `steps` timed train_steps of the BC-anchored PPO
    after WARMUP_STEPS."""
    trainer, obs, acts = imitation_trainer(device, settle)
    config = trainer.config
    net = trainer.make_net(st.BC_SEED)
    sync()
    t0 = time.perf_counter()
    net, norm, mse = st.bc.fit(net, obs, acts, iters=st.BC_ITERS, log_std=st.BC_LOG_STD)
    sync()
    bc_seconds = time.perf_counter() - t0
    before = kernel_launches()
    ps0 = imitation_state(trainer, obs, acts, net, norm, gen)
    init_launches = {k: v - before[k] for k, v in kernel_launches().items()}
    ps, metrics, seconds, launches, syncs, where = _timed_steps(
        trainer, ps0, steps, _actor, sync)
    return {"lanes": config.n_envs, "segment_len": config.segment_len,
            "demos": len(DEMOS), "bc_rows": int(obs.shape[0]), "bc_iters": st.BC_ITERS,
            "bc_seconds": bc_seconds, "bc_mse": float(mse),
            "steps_per_s": steps / seconds, "seconds_per_step": seconds / steps,
            "env_steps_per_s": steps * config.n_envs * config.segment_len / seconds,
            "launches": launches, "init_launches": init_launches,
            "host_syncs": syncs, "host_syncs_at": where, "state0": ps0, "state": ps,
            "metrics": metrics}


def public(rec: dict) -> dict:
    """The record without the trainer states: what `main` prints."""
    hide = ("state0", "state")
    return {k: ({kk: vv for kk, vv in v.items() if kk not in hide}
                if isinstance(v, dict) else v) for k, v in rec.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=2, help="timed train_steps per trainer")
    ap.add_argument("--settle", type=int, default=600, help="settling substeps")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    rec = run(a.steps, a.device, a.seed, a.settle)
    print(json.dumps(public(rec)))
    return rec


if __name__ == "__main__":
    main()
