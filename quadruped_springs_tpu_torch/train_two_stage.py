"""The two-stage learning pipeline on the jumps, end to end.

Port of ``examples/train_two_stage.py`` (JUMPING_IN_PLACE, or
JUMPING_FORWARD with ``--task forward``): ARS learns an explosive jump on
the sparse task (stopped early at ``--ars-target-apex``), a continuation
with 1.9 s episodes teaches it to land, its episodes become
demonstrations, behaviour cloning fits them and a BC-anchored PPO polish
(``bc_coef=300``) on the *_DEMO reward with reference-state initialisation
improves the clone, then PPO fine-tunes on the dense *_PPO reward through
RestTruncationWrapper, warm-started from the polish when its gates hold and
from BC otherwise. The stages, gates and selections are
``train/two_stage.py``; the script's configurations are below. Each
``jax.random.PRNGKey(n)`` of the script is a ``torch.Generator`` seeded n,
so the port's draws differ from the JAX package's.

    python -m quadruped_springs_tpu_torch.train_two_stage [--task forward] [--out DIR]
    python -m quadruped_springs_tpu_torch.train_two_stage --smoke --device cpu

writes ``<out>/two_stage[_forward]_results.json`` with the JAX script's keys
(curves included), ``<out>/demo_<tag>_<i>.qsts`` and
``<out>/two_stage[_forward]_timing.json`` (seconds and env_substeps launches
per stage), prints a JSON line with the timing and then the script's
summary line last. ``--out`` defaults to ``runs/two_stage_<task>`` of the
checkout and never takes a path under ``examples/``, whose files are the
JAX package's. The script's reward-curve plots are left out (the curves are
in the JSON). ``--smoke`` cuts every budget (the backflip script's cut,
ARS to a few iterations). A CUDA device that is not available is an error,
not a fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from quadruped_springs_tpu_torch.env import substeps as ss
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.env.wrappers import RestTruncationWrapper
from quadruped_springs_tpu_torch.env_bench import device_name, resolve_device
from quadruped_springs_tpu_torch.train import rollout as ro
from quadruped_springs_tpu_torch.train import two_stage as st
from quadruped_springs_tpu_torch.train.ars import ARSConfig, ARSTrainer
from quadruped_springs_tpu_torch.train.ppo import PPOTrainer
from quadruped_springs_tpu_torch.utils import demo as demo_util

ROOT = Path(__file__).resolve().parents[1]
TASKS = {
    "in_place": dict(sparse="JUMPING_IN_PLACE", demo="JUMPING_IN_PLACE_DEMO",
                     dense="JUMPING_IN_PLACE_PPO", tag="jip",
                     results="two_stage_results.json"),
    "forward": dict(sparse="JUMPING_FORWARD", demo="JUMPING_FORWARD_DEMO",
                    dense="JUMPING_FORWARD_PPO", tag="jf",
                    results="two_stage_forward_results.json"),
}
SETTLE = 600
JUMP_ARS = ARSConfig(n_directions=16, top_directions=8, episode_steps=110,
                     reset_bank_size=8, step_size=0.02, delta_std=0.03)
LAND_ARS = ARSConfig(n_directions=8, top_directions=4, episode_steps=200,
                     reset_bank_size=8, step_size=0.02, delta_std=0.03)
WIDE_EVAL_LANES, PROBE_LANES = 16, 16
# the script's generator seeds: ARS jump / land, the wide evaluation's bank,
# the demos, the probe's and demo evaluation's banks, the polish's and the
# fine-tune's init, the fine-tune's fresh critic
SEEDS = dict(ars=0, land=10, wide_eval=55, demos=7, probe=5, demo_eval=77, polish=1,
             finetune=2, critic=3)
DEFAULTS = dict(ars_iters=250, ars_target_apex=0.75, ars_land_iters=150, n_demos=6,
                ppo_imitate_iters=100, ppo_finetune_iters=120, ppo_critic_warmup_iters=30)
SMOKE = dict(ars_iters=2, ars_land_iters=10, n_demos=2, ppo_imitate_iters=2,
             ppo_finetune_iters=2, ppo_critic_warmup_iters=1)
SUMMARY = ("ars_jump_best_apex_m", "ars_best_apex_m", "bc_apex_m", "bc_demo_return",
           "ppo_imitate_apex_m", "ppo_imitate_apex_mean_m", "ppo_imitate_demo_return",
           "ppo_imitate_demo_held", "ppo_imitate_is_noop", "warmstart_stage",
           "ppo_imitate_improved", "ppo_finetune_final_apex_m",
           "ppo_finetune_final_apex_mean_m", "ppo_finetune_final_fwd_m",
           "ppo_finetune_last_iter_apex_m", "finetune_matches_ars",
           "finetune_improves_on_initializer", "finetune_is_noop", "wall_s")


def out_dir(path, default: str, create: bool = True) -> Path:
    """The output directory: `path`, or runs/<default> of the checkout,
    made unless `create` is False. A path under examples/ is refused: its
    files are the JAX package's committed results and policies."""
    out = (ROOT / "runs" / default) if path is None else Path(path)
    examples = (ROOT / "examples").resolve()
    resolved = out.resolve()
    if resolved == examples or examples in resolved.parents:
        raise SystemExit(f"--out {path}: examples/ holds the JAX package's committed "
                         "results; write the port's elsewhere")
    if create:
        out.mkdir(parents=True, exist_ok=True)
    return out


class StageClock:
    """Seconds and env_substeps launches of each stage (the device
    synchronised at each boundary)."""

    def __init__(self, device):
        self.device, self.seconds, self.launches = device, {}, {}
        self._sync()
        self._t, self._n = time.perf_counter(), ss.env_substeps.launches

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lap(self, stage: str):
        self._sync()
        t, n = time.perf_counter(), ss.env_substeps.launches
        self.seconds[stage] = t - self._t
        self.launches[stage] = n - self._n
        self._t, self._n = t, n

    def record(self) -> dict:
        return {"stage_seconds": self.seconds, "env_substeps_launches": self.launches}


def env_config(task: str, max_ep_len: float, **kw) -> EnvConfig:
    return EnvConfig(enable_springs=True, task_env=task, observation_space_mode="ARS_BASIC",
                     action_space_mode="SYMMETRIC", settling_steps=SETTLE,
                     max_ep_len=max_ep_len, **kw)


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def run(task: str = "in_place", device="cuda", out=None, verbose: bool = False,
        **budgets) -> tuple[dict, dict]:
    """The pipeline at the script's configuration with `budgets` (keys of
    DEFAULTS) replacing its defaults. Returns (results, timing)."""
    device = resolve_device(device)
    b = {**DEFAULTS, **budgets}
    T = TASKS[task]
    out = out_dir(out, f"two_stage_{task}")
    log = (lambda *a: print(*a, flush=True)) if verbose else st.log_none
    results = {"task": T["sparse"]}
    t_start = time.time()
    clock = StageClock(device)

    # ---- stage 1a: ARS on the sparse jump -------------------------------
    jump_env = QuadrupedEnv(env_config(T["sparse"], 1.0), device=device)
    ars = ARSTrainer(jump_env, JUMP_ARS)
    best_W, best_on, entries = st.ars_jump_stage(
        ars, ars.init(_gen(device, SEEDS["ars"])), b["ars_iters"], b["ars_target_apex"],
        log=log)
    results.update(entries)
    clock.lap("ars_jump")

    # ---- stage 1b: the landing continuation -----------------------------
    land_env = QuadrupedEnv(env_config(T["sparse"], 1.9), device=device)
    ars_l = ARSTrainer(land_env, LAND_ARS)
    tsl = dataclasses.replace(ars_l.init(_gen(device, SEEDS["land"])), W=best_W,
                              obs_norm=best_on)
    wide_eval = st.EpisodeProbe(land_env, ro.make_reset_bank(
        land_env, _gen(device, SEEDS["wide_eval"]), WIDE_EVAL_LANES), SEEDS["wide_eval"])
    best_W, best_on, entries = st.ars_land_stage(ars_l, tsl, b["ars_land_iters"], wide_eval,
                                                 log=log)
    results.update(entries)
    clock.lap("ars_land")

    # ---- stage 2: demonstrations ----------------------------------------
    kept, entries = st.collect_jump_demos(
        land_env, st.linear_policy(best_W, best_on), b["n_demos"], _gen(device, SEEDS["demos"]),
        lambda i: str(out / f"demo_{T['tag']}_{i}.qsts"), log=log)
    results.update(entries)
    clock.lap("demos")

    # the dense env and its probe, the demo env and its evaluation
    ft_env = QuadrupedEnv(env_config(T["dense"], 2.0), device=device)
    demo_env = QuadrupedEnv(env_config(T["demo"], 2.5, demo_norm="full"),
                            demo_actions=demo_util.demo_actions(kept[0], jump_env.action_dim),
                            device=device)
    ppo_cfg = dataclasses.replace(st.POLISH_PPO, lr=st.POLISH_LR[task])
    ppo_im = PPOTrainer(demo_env, ppo_cfg, demo=kept[0])
    ppo_im_warm = PPOTrainer(demo_env, dataclasses.replace(ppo_cfg, freeze_actor=True),
                             demo=kept[0])
    probe = st.EpisodeProbe(ft_env, ro.make_reset_bank(
        ft_env, _gen(device, SEEDS["probe"]), PROBE_LANES), SEEDS["probe"])
    demo_eval = st.EpisodeProbe(demo_env, ro.make_reset_bank(
        demo_env, _gen(device, SEEDS["demo_eval"]), st.DEMO_EVAL_LANES), SEEDS["demo_eval"])

    # ---- stage 3: BC, then the BC-anchored polish -----------------------
    obs_list, act_list = st.bc_dataset(demo_env, kept)
    bc_net, bc_norm, entries = st.bc_stage(ppo_im.make_net(st.BC_SEED), obs_list, act_list)
    results.update(entries)
    bc_pol = st.mlp_policy(bc_net, bc_norm)
    r, ln, am, ax, fw = probe.summary(bc_pol)
    results.update(bc_apex_m=ax, bc_apex_mean_m=am, bc_fwd_m=fw,
                   bc_demo_return=demo_eval.mean_return(bc_pol))
    log(f"[BC] mse {results['bc_mse']:.6f}  ret {r:+.3f} len {ln:5.1f} apex mean {am:.3f} "
        f"max {ax:.3f} fwd {fw:.3f} demo_ret {results['bc_demo_return']:+.3f}")
    clock.lap("bc")
    ps = st.polish_init(ppo_im, ppo_im_warm, _gen(device, SEEDS["polish"]), bc_net, bc_norm,
                        st.bc_anchor(task, obs_list, act_list))
    ps, entries = st.polish_stage(ppo_im, ppo_im_warm, ps, b["ppo_critic_warmup_iters"],
                                  b["ppo_imitate_iters"], st.jump_polish_score(probe, demo_eval),
                                  log=log)
    results.update(entries)
    results.update(st.polish_gates(results["bc_demo_return"], results["ppo_imitate_demo_return"],
                                   results["bc_apex_mean_m"], results["ppo_imitate_apex_mean_m"]))
    warm = st.select_warm_start(
        results, (results["ppo_imitate_apex_mean_m"], results["ppo_imitate_fwd_m"]),
        (results["bc_apex_mean_m"], results["bc_fwd_m"]))
    results.update(warm)
    warm_net, warm_norm = ((bc_net, bc_norm) if results["ppo_imitate_is_noop"]
                           else (ps.net, ps.obs_norm))
    if results["ppo_imitate_is_noop"]:
        log("[PPO-imitate] polish gates failed -> recorded as no-op; fine-tune warm-starts "
            "from BC")
    clock.lap("polish")

    # ---- stage 4: PPO fine-tune on the dense task -----------------------
    ft_train_env = RestTruncationWrapper(ft_env)
    ppo_ft = PPOTrainer(ft_train_env, st.FINETUNE_PPO)
    ppo_warm = PPOTrainer(ft_train_env, dataclasses.replace(
        st.FINETUNE_PPO, lr=st.CRITIC_WARMUP_LR, freeze_actor=True))
    fs = st.finetune_init(ppo_ft, _gen(device, SEEDS["finetune"]), warm_net, warm_norm,
                          SEEDS["critic"])
    bar = st.finetune_bar(results["ars_best_apex_m"])
    fs, best_net, _, entries = st.finetune_stage(
        ppo_ft, ppo_warm, fs, b["ppo_critic_warmup_iters"], b["ppo_finetune_iters"],
        st.jump_finetune_eval(task, probe, bar, warm), log=log)
    results.update(entries)
    results.update(st.jump_finetune_entries(task, probe, fs, best_net, bar, warm))
    clock.lap("finetune")
    results["wall_s"] = round(time.time() - t_start, 1)

    with open(out / T["results"], "w") as f:
        json.dump(results, f, indent=2)
    timing = {**clock.record(), "wall_s": results["wall_s"], "device": device_name(device)}
    with open(out / T["results"].replace("_results", "_timing"), "w") as f:
        json.dump(timing, f, indent=2)
    log(f"wrote {out / T['results']}")
    return results, timing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--task", choices=tuple(TASKS), default="in_place")
    for k, v in DEFAULTS.items():
        ap.add_argument("--" + k.replace("_", "-"), type=type(v), default=v)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    a = ap.parse_args(argv)
    budgets = {k: getattr(a, k) for k in DEFAULTS}
    if a.smoke:
        budgets.update(SMOKE)
    results, timing = run(a.task, a.device, a.out, verbose=True, **budgets)
    print(json.dumps(timing))
    print(json.dumps({k: results[k] for k in SUMMARY}))
    return results


if __name__ == "__main__":
    main()
