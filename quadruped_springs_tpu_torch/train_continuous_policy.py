"""The learned continuous-jumping policy, end to end.

Port of ``examples/train_continuous_policy.py``: ARS (linear) on
CONTINUOUS_JUMPING_FORWARD3, behaviour cloning of it into the PPO network on
its own on-policy states, then masked PPO on CONTINUOUS_JUMPING_FORWARD_PPO,
all through the per-jump landing autopilot; the better of BC and PPO is
gated on four fresh seeds (``policy_sustains_4_good_jumps``). The stages,
comparisons and gates are ``train/continuous.py``. Each
``jax.random.PRNGKey(n)`` of the script is a ``torch.Generator`` seeded n
(the evaluations: one generator a seed and lane), so the port's draws
differ from the JAX package's.

    python -m quadruped_springs_tpu_torch.train_continuous_policy [--out DIR]
    python -m quadruped_springs_tpu_torch.train_continuous_policy --smoke --device cpu

prints the script's two summary lines, then one JSON line with each stage's
seconds and env_substeps launches. A full run writes, under ``--out``
(default ``runs/continuous_policy`` of the checkout, never a path under
``examples/``, whose files are the JAX package's): ``continuous_policy.npz``
(the selected network in the flattened-leaf layout that both packages'
loaders read), ``continuous_policy_kpis.json`` (one 6 s episode of seed 0),
``continuous_policy_results.json`` with the script's keys, and
``continuous_policy_timing.json``. ``--smoke`` (1.5 s episodes, 3 ARS, 2
PPO and 1 warm-up iterations) writes nothing, as the script's. A CUDA device
that is not available is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from quadruped_springs_tpu_torch.convert import save_flat_mlp_policy
from quadruped_springs_tpu_torch.env_bench import device_name, resolve_device
from quadruped_springs_tpu_torch.train import continuous as cont
from quadruped_springs_tpu_torch.train.ars import ARSTrainer
from quadruped_springs_tpu_torch.train.ppo import PPOTrainer
from quadruped_springs_tpu_torch.train.two_stage import log_none
from quadruped_springs_tpu_torch.train_two_stage import StageClock, out_dir

DEFAULTS = dict(seconds=4.0, ars_iters=400, ppo_iters=150, ppo_critic_warmup_iters=20)
SMOKE = dict(seconds=1.5, ars_iters=3, ppo_iters=2, ppo_critic_warmup_iters=1)
ARCHITECTURE = ("ARS -> BC -> masked PPO through the per-jump landing autopilot "
                "(env/continuous_autopilot.py)")
SUMMARY = ("bc_rows", "bc_mse", "selected_stage", "ppo_improves_on_bc", "finetune_is_noop",
           "policy_sustains_4_good_jumps", "wall_s")
GATE_SUMMARY = ("good_jumps_per_seed", "good_jumps_mean", "mean_perf_mean")


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def run(device="cuda", out=None, write: bool = True, verbose: bool = False,
        **budgets) -> tuple[dict, dict]:
    """The pipeline at the script's configuration with `budgets` (keys of
    DEFAULTS) replacing its defaults; writes its files under `out` when
    `write`. Returns (results, timing)."""
    device = resolve_device(device)
    b = {**DEFAULTS, **budgets}
    out = out_dir(out, "continuous_policy", create=write)
    log = (lambda *a: print(*a, flush=True)) if verbose else log_none
    results = {"task": cont.PPO_TASK, "architecture": ARCHITECTURE}
    t_start = time.time()
    clock = StageClock(device)
    n_steps = cont.episode_steps(b["seconds"])
    score_env = cont.make_env(cont.SCORE_TASK, b["seconds"], device)
    evaluate = cont.Evaluator(score_env, cont.EVAL_SEEDS, n_steps)

    # ---- stage 1: ARS (linear) on the task's own terminal scoring ---------
    ars = ARSTrainer(score_env, dataclasses.replace(cont.ARS, episode_steps=n_steps))
    W, on, entries = cont.ars_stage(ars, ars.init(_gen(device, cont.SEEDS["ars"])),
                                    b["ars_iters"], evaluate, log=log)
    results.update(entries)
    clock.lap("ars")

    # ---- stage 2: clone the expert into the PPO network --------------------
    gen = _gen(device, cont.SEEDS["collect"])
    state, obs = score_env.reset(gen, cont.COLLECT_LANES)
    rows = cont.masked_episode(score_env, cont.linear_policy(W, on), state, obs, n_steps, gen,
                               record=True)[4]
    obs_d, act_d = cont.keep_rows(rows)
    bc_net, bc_norm, entries = cont.bc_stage(
        PPOTrainer(score_env).make_net(cont.SEEDS["bc"]), obs_d, act_d)
    results.update(entries)
    bc_eval = results["bc_eval"] = evaluate(cont.mlp_policy(bc_net, bc_norm))
    log(f"[BC] rows {results['bc_rows']} mse {results['bc_mse']:.5f} good/seed "
        f"{bc_eval['good_jumps_per_seed']} perf {bc_eval['mean_perf_mean']:.3f}")
    clock.lap("bc")

    # ---- stage 3: masked PPO fine-tune on the dense continuous reward ------
    ppo_env = cont.make_env(cont.PPO_TASK, b["seconds"], device)
    ppo = PPOTrainer(ppo_env, cont.PPO)
    ppo_warm = PPOTrainer(ppo_env, dataclasses.replace(cont.PPO, lr=cont.CRITIC_WARMUP_LR,
                                                       freeze_actor=True))
    ps = cont.ppo_init(ppo, ppo_warm, _gen(device, cont.SEEDS["ppo"]), bc_net, bc_norm, obs_d,
                       act_d)
    _, ppo_net, ppo_norm, entries = cont.ppo_stage(
        ppo, ppo_warm, ps, b["ppo_critic_warmup_iters"], b["ppo_iters"], evaluate, log=log)
    results.update(entries)
    clock.lap("ppo")

    # ---- stage comparison, selection, and the gate on fresh seeds ----------
    results.update(cont.stage_comparison(bc_eval, results["ppo_eval"]))
    sel = results["selected_stage"] = cont.selected_stage(bc_eval, results["ppo_eval"])
    sel_net, sel_norm = (ppo_net, ppo_norm) if sel == "ppo" else (bc_net, bc_norm)
    gate = cont.Evaluator(score_env, cont.GATE_SEEDS, n_steps)(cont.mlp_policy(sel_net, sel_norm))
    results.update(cont.gate_entries(gate))
    results["wall_s"] = round(time.time() - t_start, 1)
    clock.lap("gate")

    if write:
        save_flat_mlp_policy(out / "continuous_policy.npz", sel_net, sel_norm)
        # one deterministic 6 s episode of seed 0
        kpi_env = cont.make_env(cont.SCORE_TASK, cont.KPI_SECONDS, device)
        kpi = cont.Evaluator(kpi_env, (cont.KPI_SEED,), cont.KPI_STEPS)(
            cont.mlp_policy(sel_net, sel_norm))["per_seed"][0]
        kpi["driver"] = f"policy ({sel}) through the per-jump landing autopilot"
        kpi["sim_seconds"] = cont.KPI_SECONDS
        with open(out / "continuous_policy_kpis.json", "w") as f:
            json.dump(kpi, f, indent=2)
        with open(out / "continuous_policy_results.json", "w") as f:
            json.dump(results, f, indent=2)
        clock.lap("kpi")
    timing = {**clock.record(), "wall_s": round(time.time() - t_start, 1),
              "device": device_name(device)}
    if write:
        with open(out / "continuous_policy_timing.json", "w") as f:
            json.dump(timing, f, indent=2)
        log(f"wrote {out}/continuous_policy.npz + KPI/results/timing JSONs")
    return results, timing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for k, v in DEFAULTS.items():
        ap.add_argument("--" + k.replace("_", "-"), type=type(v), default=v)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny budgets, no file written")
    a = ap.parse_args(argv)
    budgets = {k: getattr(a, k) for k in DEFAULTS}
    if a.smoke:
        budgets.update(SMOKE)
    results, timing = run(a.device, a.out, write=not a.smoke, verbose=True, **budgets)
    print(json.dumps({k: results[k] for k in SUMMARY}))
    print("gate:", json.dumps({k: results["gate_eval"][k] for k in GATE_SUMMARY}))
    print(json.dumps(timing))
    return results


if __name__ == "__main__":
    main()
