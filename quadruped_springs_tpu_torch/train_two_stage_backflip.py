"""The two-stage learning pipeline on the backflip, end to end.

Port of ``examples/train_two_stage_backflip.py``: flip demonstrations are
collected from the committed stage-1 expert (``examples/policies/
backflip_ars.npz`` launching, the flattened LandingWrapperBackflip
autopilot finishing, ``env/flat_rollout.py``) on the noisy BACKFLIP env,
behaviour cloning fits them, a BC-anchored PPO polish (lr 1e-4, demo 0's
rows as the anchor) runs on BACKFLIP_DEMO and PPO fine-tunes on the raw
BACKFLIP_PPO env (no RestTruncationWrapper), warm-started from the
polish's final iterate. The demo and dense envs pass
``iface_task="BACKFLIP"`` (the rear thighs' raised limits) so a recorded
action means the same joint targets in every stage. Every stage is scored
on the deployed surface: the policy launches, the autopilot finishes, over
8 probe lanes (seeds 5000-5007); the fine-tune is selected by upright
flips + 0.1 x apex and gated against the expert and its own initializer;
the selected stage is held to the nominal surface (seeds 0 and 1, no
randomizer). The stages, gates and selections are ``train/two_stage.py``.

    python -m quadruped_springs_tpu_torch.train_two_stage_backflip [--out DIR]
    python -m quadruped_springs_tpu_torch.train_two_stage_backflip --smoke --device cpu

writes ``<out>/two_stage_backflip_results.json`` with the JAX script's keys,
``<out>/demo_bf_<i>.qsts``, the selected policy as
``<out>/backflip_two_stage.npz`` (the flattened flax leaves
``convert.load_flat_mlp_policy`` reads) and
``<out>/two_stage_backflip_timing.json``; prints a JSON line with the
timing, then the script's summary line last. ``--out`` defaults to
``runs/two_stage_backflip`` of the checkout and never takes a path under
``examples/``. A CUDA device that is not available is an error, not a
fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.env_bench import device_name, resolve_device
from quadruped_springs_tpu_torch.train import rollout as ro
from quadruped_springs_tpu_torch.train import two_stage as st
from quadruped_springs_tpu_torch.train.ppo import PPOTrainer
from quadruped_springs_tpu_torch.train_two_stage import ROOT, StageClock, _gen, out_dir
from quadruped_springs_tpu_torch.utils import demo as demo_util

EXPERT_PATH = ROOT / "examples" / "policies" / "backflip_ars.npz"
EXPERT = ("examples/policies/backflip_ars.npz + LandingWrapperBackflip autopilot "
          "(scripts/train_behavior_policies.py)")
SETTLE = 600
PROBE_SEEDS = tuple(5000 + i for i in range(8))
NOMINAL_SEEDS = (0, 1)
SEEDS = dict(demos=7, demo_eval=77, polish=1, finetune=2, critic=3)
DEFAULTS = dict(n_demos=12, ppo_imitate_iters=100, ppo_finetune_iters=120,
                ppo_critic_warmup_iters=30)
SMOKE = dict(n_demos=2, ppo_imitate_iters=2, ppo_finetune_iters=2, ppo_critic_warmup_iters=1)
RESULTS, POLICY = "two_stage_backflip_results.json", "backflip_two_stage.npz"
SUMMARY = ("demo_episodes_complete", "bc_mse", "bc_demo_return", "ppo_imitate_demo_return",
           "ppo_imitate_demo_held", "ppo_imitate_transfer_held", "finetune_flip_ok",
           "finetune_improves_on_initializer", "finetune_is_noop", "selected_stage",
           "nominal_flip_ok", "wall_s")


def make_env(task: str, device, iface_task: str | None = None, demo_actions=None,
             **kw) -> QuadrupedEnv:
    return QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env=task, observation_space_mode="ARS_BACKFLIP",
        action_space_mode="SYMMETRIC", iface_task=iface_task, settling_steps=SETTLE, **kw),
        demo_actions=demo_actions, device=device)


def run(device="cuda", out=None, verbose: bool = False, **budgets) -> tuple[dict, dict]:
    """The pipeline at the script's configuration with `budgets` (keys of
    DEFAULTS) replacing its defaults. Returns (results, timing)."""
    device = resolve_device(device)
    b = {**DEFAULTS, **budgets}
    out = out_dir(out, "two_stage_backflip")
    log = (lambda *a: print(*a, flush=True)) if verbose else st.log_none
    t0 = time.time()
    clock = StageClock(device)
    results = {"task": "BACKFLIP", "expert": EXPERT}

    # ---- stage 1: the committed expert ----------------------------------
    W, on = convert.load_linear_policy(EXPERT_PATH, device)
    # the deployed nominal surface carries no observation noise; the
    # training envs keep it
    flip_env = make_env("BACKFLIP", device, max_ep_len=4.0, obs_noise=False)
    expert = st.linear_policy(W, on)

    # ---- stage 2: flip demonstrations on the noisy env ------------------
    demo_src_env = make_env("BACKFLIP", device, max_ep_len=4.0)
    kept, entries = st.collect_flip_demos(
        demo_src_env, expert, b["n_demos"], _gen(device, SEEDS["demos"]),
        lambda i: str(out / f"demo_bf_{i}.qsts"), log=log)
    results.update(entries)
    clock.lap("demos")

    demo_env = make_env("BACKFLIP_DEMO", device, iface_task="BACKFLIP", max_ep_len=2.5,
                        demo_norm="full",
                        demo_actions=demo_util.demo_actions(kept[0], flip_env.action_dim))
    ft_env = make_env("BACKFLIP_PPO", device, iface_task="BACKFLIP", max_ep_len=2.0)
    probe = st.FlipProbe(flip_env, st.seeded_bank(flip_env, PROBE_SEEDS, device))
    expert_probe = probe(lambda o: torch.clamp(expert(o), -1.0, 1.0))
    results["expert_probe"] = expert_probe
    log(f"[expert] {expert_probe}")
    clock.lap("expert_probe")

    # ---- stage 3: BC, then the BC-anchored polish -----------------------
    obs_list, act_list = st.bc_dataset(demo_env, kept)
    polish_cfg = dataclasses.replace(st.POLISH_PPO, lr=st.POLISH_LR["backflip"])
    ppo_im = PPOTrainer(demo_env, polish_cfg, demo=kept[0])
    ppo_im_warm = PPOTrainer(demo_env, dataclasses.replace(polish_cfg, freeze_actor=True),
                             demo=kept[0])
    bc_net, bc_norm, entries = st.bc_stage(ppo_im.make_net(st.BC_SEED), obs_list, act_list)
    results.update(entries)
    demo_eval = st.EpisodeProbe(demo_env, ro.make_reset_bank(
        demo_env, _gen(device, SEEDS["demo_eval"]), st.DEMO_EVAL_LANES), SEEDS["demo_eval"])
    bc_pol = st.mlp_policy(bc_net, bc_norm)
    results["bc_probe"] = bc_probe = probe(bc_pol)
    results["bc_demo_return"] = demo_eval.mean_return(bc_pol)
    log(f"[BC] mse {results['bc_mse']:.6f} demo_ret {results['bc_demo_return']:+.3f} "
        f"probe {bc_probe}")
    clock.lap("bc")
    ps = st.polish_init(ppo_im, ppo_im_warm, _gen(device, SEEDS["polish"]), bc_net, bc_norm,
                        st.bc_anchor("backflip", obs_list, act_list))
    ps, entries = st.polish_stage(ppo_im, ppo_im_warm, ps, b["ppo_critic_warmup_iters"],
                                  b["ppo_imitate_iters"], st.flip_polish_score(probe, demo_eval),
                                  log=log)
    results.update(entries)
    im_probe = results["ppo_imitate_probe"]
    results.update(st.flip_polish_gates(results["bc_demo_return"],
                                        results["ppo_imitate_demo_return"], bc_probe, im_probe))
    clock.lap("polish")

    # ---- stage 4: PPO fine-tune on the raw dense env --------------------
    ppo_ft = PPOTrainer(ft_env, st.FINETUNE_PPO)
    ppo_ft_warm = PPOTrainer(ft_env, dataclasses.replace(
        st.FINETUNE_PPO, lr=st.CRITIC_WARMUP_LR, freeze_actor=True))
    fs = st.finetune_init(ppo_ft, _gen(device, SEEDS["finetune"]), ps.net, ps.obs_norm,
                          SEEDS["critic"])
    fs, best_net, best_probe, entries = st.finetune_stage(
        ppo_ft, ppo_ft_warm, fs, b["ppo_critic_warmup_iters"], b["ppo_finetune_iters"],
        st.flip_finetune_eval(probe), log=log)
    results.update(entries)
    results.update(st.flip_finetune_entries(probe, fs, best_probe, expert_probe, im_probe))
    results["wall_s"] = round(time.time() - t0, 1)
    results["selected_stage"] = st.flip_selected_stage(results)
    sel_net, sel_norm = ((best_net, fs.obs_norm) if results["selected_stage"] == "ppo_finetune"
                         else (ps.net, ps.obs_norm))
    clock.lap("finetune")

    # ---- the nominal surface: the selected flip, deployed ---------------
    nominal_env = make_env("BACKFLIP", device, max_ep_len=4.0, obs_noise=False,
                           env_randomizer_mode="NONE")
    nominal = st.FlipProbe(nominal_env, st.seeded_bank(nominal_env, NOMINAL_SEEDS, device))
    results["nominal_probe"] = nom = nominal(st.mlp_policy(sel_net, sel_norm))
    results["nominal_flip_ok"] = st.nominal_flip_ok(nom)
    clock.lap("nominal")

    convert.save_flat_mlp_policy(out / POLICY, sel_net, sel_norm)
    with open(out / RESULTS, "w") as f:
        json.dump(results, f, indent=2)
    timing = {**clock.record(), "wall_s": round(time.time() - t0, 1),
              "device": device_name(device)}
    with open(out / RESULTS.replace("_results", "_timing"), "w") as f:
        json.dump(timing, f, indent=2)
    log("probes: " + json.dumps({"expert": expert_probe, "bc": bc_probe, "imitate": im_probe,
                                 "finetune": results["ppo_finetune_probe"]}))
    log(f"wrote {out / POLICY} + {RESULTS}")
    return results, timing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for k, v in DEFAULTS.items():
        ap.add_argument("--" + k.replace("_", "-"), type=type(v), default=v)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    a = ap.parse_args(argv)
    budgets = {k: getattr(a, k) for k in DEFAULTS}
    if a.smoke:
        budgets.update(SMOKE)
    results, timing = run(a.device, a.out, verbose=True, **budgets)
    print(json.dumps(timing))
    print(json.dumps({k: results[k] for k in SUMMARY}))
    return results


if __name__ == "__main__":
    main()
