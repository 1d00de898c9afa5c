"""The small linear ARS policies of the closed-loop behaviour demos.

Port of ``scripts/train_behavior_policies.py``:

  --task backflip   the scripted crouch-and-launch schedule rolled out with
                    observation noise on seeds 0-7 gives (obs, action) pairs
                    up to two steps past the take-off switch; a ridge fit
                    clones it; ARS then fine-tunes it on the true sparse
                    BACKFLIP reward through the LandingWrapperBackflip
                    autopilot ("hold"), the observation statistics frozen:
                    6 directions x 2 seeds a iteration, the ± episodes of a
                    direction on the same two scenarios and noise streams,
                    all 24 as one batch of lanes. Selection on the fixed
                    seeds 1000+ by (full gate count, mean reward); the run
                    stops once all pass at iteration 4 or later.
  --robust          the fine-tune continued from the committed
                    backflip_ars.npz under TEST_RANDOMIZER with noise,
                    through the "until_grounded" autopilot, then the
                    nominal check and the held-out seeds 77000-77011; it
                    saves only at nominal 4/4 and rotation 12/12.
  --task forward    ARSTrainer on the sparse JUMPING_FORWARD task (16
                    directions, a bank of 8, 200-step episodes), the best
                    iterate by a 4-episode evaluation.

    python -m quadruped_springs_tpu_torch.train_behavior_policies --task backflip
    python -m quadruped_springs_tpu_torch.train_behavior_policies --task forward --device cpu

writes ``<out>/backflip_ars.npz`` (``backflip_ars_robust.npz``,
``forward_ars.npz``) with the JAX script's keys and prints a JSON line of
the run's numbers (seconds and env_substeps launches a stage included).
The exit code is the script's: 1 when the backflip gate fails. ``--out``
defaults to ``runs/behavior_policies`` and never takes a path under
``examples/``. Each ``jax.random.PRNGKey(seed)`` of the script is the seed's
own generator (``rollout.seeded_reset``), so the scenarios differ from the
JAX package's; the ARS draws are the script's numpy ones. A CUDA device
that is not available is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import sys

import numpy as np
import torch

from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.env_bench import device_name, resolve_device
from quadruped_springs_tpu_torch.policy_replay import POLICY_DIR
from quadruped_springs_tpu_torch.train import behaviour as bh
from quadruped_springs_tpu_torch.train import normalize as vnorm
from quadruped_springs_tpu_torch.train.ars import ARSConfig, ARSTrainer
from quadruped_springs_tpu_torch.train_two_stage import StageClock, out_dir

N_DIR, TOP_B, STEP_SIZE, DELTA_STD = 6, 3, 0.01, 0.015
TRAIN_SEEDS = 2          # scenarios per ARS iteration
DEMO_SEEDS, DEMO_STEPS = 8, 40
EVAL_SEED0, VAL_SEED0 = 1000, 77000
N_VAL = 12
FORWARD_ARS = ARSConfig(n_directions=16, top_directions=8, episode_steps=200,
                        reset_bank_size=8, step_size=0.02, delta_std=0.03)
FORWARD_SETTLE = 600
FORWARD_EVAL_EPISODES = 4
# the backflip's episodes in control steps: training (robust), the
# evaluation, the initial printout's; the episodes' length in seconds (the
# nominal check's)
TRAIN_STEPS, TRAIN_STEPS_ROBUST, EVAL_STEPS, INIT_STEPS = 40, 120, 120, 80
EP_LEN, NOM_EP_LEN, FORWARD_EP_LEN = 2.5, 4.0, 1.9


def score(rows) -> tuple:
    """The selection metric: (scenarios passing the full gate, mean reward)."""
    n_ok = sum(r["rotation"] and r["upright"] for r in rows)
    return n_ok, float(np.mean([r["reward"] for r in rows]))


def ars_loop(W0: np.ndarray, returns_fn, eval_fn, iters: int, n_eval: int, log):
    """The script's fine-tune loop. returns_fn(W (D, A, d) float64 of the
    2·D ± candidates, seeds) -> each candidate's mean return over the
    seeds; eval_fn(W) -> the evaluation rows. Returns (best (score, W),
    the curve)."""
    rng = np.random.default_rng(0)
    W_cur = np.asarray(W0)
    best = (score(eval_fn(W_cur)), W_cur.copy())
    log(f"[finetune init] gate={best[0][0]}/{n_eval} reward {best[0][1]:+.3f}")
    curve = []
    for i in range(iters):
        seeds = [int(rng.integers(1 << 30)) for _ in range(TRAIN_SEEDS)]
        deltas = rng.normal(size=(N_DIR,) + W_cur.shape) * DELTA_STD
        r = returns_fn(np.concatenate([W_cur + deltas, W_cur - deltas]), seeds)
        rp, rm = r[:N_DIR], r[N_DIR:]
        W_cur = bh.behaviour_update(W_cur, rp, rm, deltas, TOP_B, STEP_SIZE, DELTA_STD)
        sc = score(eval_fn(W_cur))
        if sc > best[0]:
            best = (sc, W_cur.copy())
        curve.append({"iter": i, "train_plus": float(rp.mean()),
                      "train_minus": float(rm.mean()), "gate": sc[0], "reward": sc[1]})
        log(f"[backflip-ft {i:03d}] train +/- {rp.mean():+.3f}/{rm.mean():+.3f} "
            f"gate={sc[0]}/{n_eval} reward {sc[1]:+.3f} (best {best[0]})")
        if best[0][0] == n_eval and i >= 4:
            log("[backflip-ft] gate satisfied on all scenarios, stopping")
            break
    return best, curve


def backflip(device, iters: int, robust: bool, out, log, clock: StageClock):
    randomizer = "TEST_RANDOMIZER" if robust else "GROUND_RANDOMIZER"
    env_t = bh.flip_env(device, randomizer, obs_noise=True, max_ep_len=EP_LEN)
    if robust:
        # the script's jnp.asarray: the committed float64 W as float32
        W, on = convert.load_linear_policy(POLICY_DIR / "backflip_ars.npz", device)
        W0 = W.cpu().numpy()
        n_pairs = None
    else:
        O, A = bh.collect_script_demo(env_t, DEMO_SEEDS, DEMO_STEPS)
        log(f"demo dataset: {O.shape[0]} pairs")
        W, mean, var = bh.ridge_fit(O, A)
        on = vnorm.RunningNorm(torch.tensor(mean, device=device),
                               torch.tensor(var, device=device),
                               torch.tensor(float(len(O)), dtype=torch.float32,
                                            device=device))
        W0, n_pairs = W, int(O.shape[0])
    clock.lap("demos_and_fit")
    eval_env = bh.flip_env(device, randomizer, obs_noise=robust, max_ep_len=EP_LEN)
    variant = "until_grounded" if robust else "hold"
    n_eval = 8 if robust else 4

    def policy(W):
        act = bh.linear_act(torch.as_tensor(W, dtype=torch.float32, device=device), on)
        return lambda o, armed: act(o)

    def eval_rows(W, env=eval_env, seed0=EVAL_SEED0, n=n_eval, steps=EVAL_STEPS):
        st, total = bh.seeded_episodes(env, policy(W), range(seed0, seed0 + n), variant,
                                       steps)
        return [dict(r, reward=t) for r, t in zip(bh.flip_rows(st), total.tolist())]

    for r in eval_rows(W0, steps=INIT_STEPS):
        log(f"[init] pitch {math.degrees(r['pitch_rad']):.0f} deg apex {r['apex']:.3f} "
            f"up_z {r['up_z']:+.3f} reward {r['reward']:+.3f}")

    def returns_fn(W_cand, seeds):
        # lanes ordered (candidate, seed): each candidate replays both seeds
        C, S = W_cand.shape[0], len(seeds)
        lanes = torch.arange(S, device=device).repeat(C)
        W_l = torch.as_tensor(W_cand, dtype=torch.float32,
                              device=device).repeat_interleave(S, dim=0)
        act = bh.linear_act(W_l, on)
        _, total = bh.seeded_episodes(env_t, lambda o, armed: act(o), seeds, variant,
                                      TRAIN_STEPS_ROBUST if robust else TRAIN_STEPS, lanes)
        # the script's float mean over the seeds, per candidate
        return total.view(C, S).mean(1).cpu().numpy()

    (best_sc, W_best), curve = ars_loop(W0, returns_fn, eval_rows, iters, n_eval, log)
    clock.lap("ars")
    n_ok_best, ret = best_sc
    gate_ok = n_ok_best == n_eval
    rec = {"task": "backflip", "robust": robust, "demo_pairs": n_pairs,
           "iterations": len(curve), "gate": n_ok_best, "n_eval": n_eval,
           "ret": ret, "curve": curve}
    if robust:
        nom_env = bh.flip_env(device, "GROUND_RANDOMIZER", obs_noise=False,
                              max_ep_len=NOM_EP_LEN)
        nom = eval_rows(W_best, nom_env, EVAL_SEED0, 4, INIT_STEPS)
        nom_ok = sum(r["rotation"] and r["upright"] for r in nom)
        val = eval_rows(W_best, eval_env, VAL_SEED0, N_VAL, EVAL_STEPS)
        rot_ok = sum(r["rotation"] for r in val)
        up_ok = sum(r["upright"] for r in val)
        log(f"[validation] nominal {nom_ok}/4, fresh rotation {rot_ok}/{N_VAL}, "
            f"fresh upright {up_ok}/{N_VAL}")
        clock.lap("validation")
        gate_ok = nom_ok == 4 and rot_ok == N_VAL
        rec.update(nominal_ok=nom_ok, rot_ok=rot_ok, upright_ok=up_ok)
    rec["gate_ok"] = gate_ok
    if robust and not gate_ok:
        log("[validation] FAILED save bars (nominal 4/4 + rotation 12/12) — not saving")
        return rec, 1
    path = out / ("backflip_ars_robust.npz" if robust else "backflip_ars.npz")
    np.savez(path, W=np.asarray(W_best), mean=on.mean.cpu().numpy(),
             var=on.var.cpu().numpy(), count=on.count.cpu().numpy(), ret=ret,
             gate_ok=gate_ok)
    rec["saved"] = str(path)
    return rec, 0 if gate_ok else 1


def forward(device, iters: int, out, log, clock: StageClock):
    env = QuadrupedEnv(EnvConfig(
        enable_springs=True, task_env="JUMPING_FORWARD", observation_space_mode="ARS_BASIC",
        action_space_mode="SYMMETRIC", settling_steps=FORWARD_SETTLE, max_ep_len=FORWARD_EP_LEN),
        device=device)
    ars = ARSTrainer(env, FORWARD_ARS)
    ts = ars.init(torch.Generator(device).manual_seed(0))
    best = (-9.9, ts.W, ts.obs_norm)
    curve = []
    for i in range(iters):
        ts, _ = ars.train_step(ts)
        ev = ars.evaluate(ts, n_episodes=FORWARD_EVAL_EPISODES)
        r = float(ev["return_mean"])
        if r > best[0]:
            best = (r, ts.W, ts.obs_norm)
        curve.append({"iter": i, "eval_return": r, "max_height": float(ev["max_height"]),
                      "max_fwd": float(ev["max_fwd"])})
        if i % 10 == 9:
            log(f"[forward {i:03d}] eval {r:+.3f} apex {float(ev['max_height']):.3f} "
                f"fwd {float(ev['max_fwd']):.3f} (best ret {best[0]:+.3f})")
    clock.lap("ars")
    r, W, on = best
    path = out / "forward_ars.npz"
    np.savez(path, W=W.cpu().numpy(), mean=on.mean.cpu().numpy(), var=on.var.cpu().numpy(),
             count=on.count.cpu().numpy(), ret=r)
    return {"task": "forward", "iterations": iters, "ret": r, "curve": curve,
            "saved": str(path)}, 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--task", choices=("backflip", "forward"), required=True)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--robust", action="store_true",
                    help="backflip: continue the fine-tune from the committed policy under "
                         "TEST_RANDOMIZER with observation noise")
    ap.add_argument("--out", default=None, help="output directory (default "
                    "runs/behavior_policies; never under examples/)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    out = out_dir(a.out, "behavior_policies")
    log = functools.partial(print, flush=True)
    clock = StageClock(device)
    if a.task == "backflip":
        rec, code = backflip(device, a.iters, a.robust, out, log, clock)
    else:
        rec, code = forward(device, a.iters, out, log, clock)
    rec.update(clock.record(), device=device_name(device))
    print(json.dumps(rec), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
