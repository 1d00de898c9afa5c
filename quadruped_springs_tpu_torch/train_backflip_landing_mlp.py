"""A small-MLP landing policy under the committed linear backflip launch.

Port of ``scripts/train_backflip_landing_mlp.py``:

  phase 1  the touchdown bank: the frozen launch (``--launch``, the
           committed backflip_ars.npz by default) through the
           "until_grounded" autopilot under TEST_RANDOMIZER with observation
           noise, seeds 0, 1, ... in order, each run until control returns
           at touchdown; the states of those that did not crash are kept
           until ``--bank`` are, out of at most 4 x bank seeds. The seeds run
           batched in chunks, kept in the script's order; each bank entry
           carries its seed's noise stream on (``rollout.seeded_reset``).
  phase 2  ARS on the MLP's flat parameters (``jax.flatten_util``'s layout)
           with the shaped stabilisation return (`behaviour.stab_score`)
           over 2·n_dir candidates x ``--train-states`` bank entries, all
           as one batch of lanes; every ``--probe-every`` iterations the
           bank's train/validation split and the deployed probes (nominal
           seeds 1000+, randomized 55000+) select the running best, saved
           as ``<out>/backflip_landing_mlp.npz.cand.npz``.
  phase 3  the held-out check at seeds 77000-77011 through launch,
           autopilot and lander; saved at nominal 4/4, rotation 12/12,
           upright >= 10/12 (``--no-save-gate``: always).

    python -m quadruped_springs_tpu_torch.train_backflip_landing_mlp [--iters 300]

writes ``<out>/backflip_landing_mlp.npz`` (and ``.cand.npz``) with the JAX
script's keys and prints a JSON line with the script's keys (nominal,
rotation, upright, bank_strict_val) and the run's seconds and env_substeps
launches a phase; the exit code is the script's. ``--out`` is a directory
(default ``runs/backflip_landing_mlp``), never under ``examples/``.
``--optimizer bptt`` is refused: it differentiates through ``env.step``,
and the card's ``env_substeps`` kernel has no reverse mode (ROADMAP queue
1). The MLP's initial W1 is drawn by a torch generator seeded 3, not by
``jax.random``; the ARS draws are the script's numpy ones.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch.env import wrappers as wr
from quadruped_springs_tpu_torch.env.env import NoiseStreams, take
from quadruped_springs_tpu_torch.env_bench import device_name, resolve_device
from quadruped_springs_tpu_torch.policy_replay import POLICY_DIR
from quadruped_springs_tpu_torch.train import behaviour as bh
from quadruped_springs_tpu_torch.train import rollout as ro
from quadruped_springs_tpu_torch.train_two_stage import StageClock, out_dir

EP_LEN = 4.0
TOUCHDOWN_STEPS, FULL_STEPS = 40, 120
NOM_SEED0, PROBE_SEED0, VAL_SEED0 = 1000, 55000, 77000
N_NOM, N_VAL, UPRIGHT_BAR = 4, 12, 10
EARLY_STOP_ITER = 40
MLP_KEYS = ("W1", "b1", "W2", "b2")
BPTT_REFUSED = ("--optimizer bptt differentiates the shaped return through env.step; the "
                "card's env_substeps kernel has no reverse mode, and this port runs no "
                "path on the plain version in its place. See ROADMAP.md, queue 1: the env "
                "step's reverse-mode kernel.")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--bank", type=int, default=96)
    ap.add_argument("--train-states", type=int, default=24)
    ap.add_argument("--probe-every", type=int, default=10)
    ap.add_argument("--n-probe", type=int, default=10)
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--n-dir", type=int, default=16)
    ap.add_argument("--step-size", type=float, default=0.02)
    ap.add_argument("--delta-std", type=float, default=0.03)
    ap.add_argument("--hard-frac", type=float, default=0.0)
    ap.add_argument("--init-from", default="")
    ap.add_argument("--bank-cache", default="",
                    help="file caching the touchdown bank (made by the port)")
    ap.add_argument("--no-save-gate", action="store_true")
    ap.add_argument("--optimizer", choices=("ars", "bptt"), default="ars")
    ap.add_argument("--launch", default=str(POLICY_DIR / "backflip_ars.npz"),
                    help="the frozen linear launch policy")
    ap.add_argument("--out", default=None, help="output directory (default "
                    "runs/backflip_landing_mlp; never under examples/)")
    ap.add_argument("--device", default="cuda")
    return ap


def mlp_init(obs_dim: int, hidden: int, landing_action) -> dict:
    """The script's init: W1 ~ 0.1 N(0, 1) (a torch generator seeded 3), zero
    b1 and W2, b2 the landing action (hold the landing action)."""
    g = torch.Generator().manual_seed(3)
    return {"W1": (0.1 * torch.randn((hidden, obs_dim), generator=g)).numpy(),
            "b1": np.zeros((hidden,), np.float32),
            "W2": np.zeros((6, hidden), np.float32),
            "b2": np.asarray(landing_action.cpu(), np.float32)}


def collect_bank(env, w, launch, n_bank: int, log):
    """Seeds 0, 1, ... to touchdown in chunks; the non-crashed ones kept in
    seed order until n_bank, out of at most 4 x n_bank. Returns (states,
    obs, noise streams, tries, full rotations)."""
    kept, n_try, n_rot, seed = [], 0, 0, 0
    limit = 4 * n_bank
    while len(kept) < n_bank and n_try < limit:
        chunk = min(max(2 * (n_bank - len(kept)), 8), limit - seed)
        seeds = list(range(seed, seed + chunk))
        seed += chunk
        state, obs, noise = ro.seeded_reset(env, seeds)
        st, ob, rot, crashed = bh.run_to_touchdown(w, launch, state, obs, noise,
                                                   TOUCHDOWN_STEPS)
        crashed, rot = crashed.tolist(), rot.tolist()
        for i in range(chunk):
            if len(kept) == n_bank or n_try == limit:
                break
            n_try += 1
            if not crashed[i]:
                kept.append((take(st, torch.tensor([i], device=obs.device)), ob[i:i + 1],
                             None if noise is None else noise.draws[i:i + 1]))
                n_rot += int(rot[i])
    if not kept:
        raise RuntimeError(f"no touchdown in {n_try} seeds: the bank is empty")
    states = bh.cat_tree([k[0] for k in kept])
    obs = torch.cat([k[1] for k in kept])
    noise = (None if kept[0][2] is None else
             NoiseStreams(torch.cat([k[2] for k in kept]),
                          torch.arange(len(kept), device=obs.device)))
    log(f"bank: {len(kept)}/{n_try} touchdowns kept ({n_rot} full rotations)")
    return states, obs, noise, n_try, n_rot


def sample_minibatch(rng_s, fail_idx, n_train: int, train_states: int, hard_frac: float):
    """The script's minibatch: uniform, with hard_frac of it drawn from the
    current failure set when one exists."""
    n_hard = int(round(hard_frac * train_states))
    if n_hard == 0 or len(fail_idx) == 0:
        return rng_s.choice(n_train, train_states, replace=False)
    n_hard = min(n_hard, train_states)
    hard = rng_s.choice(fail_idx, n_hard, replace=len(fail_idx) < n_hard)
    rest = rng_s.choice(n_train, train_states - n_hard, replace=False)
    return np.concatenate([hard, rest])


def ars_loop(flat0, a, n_train: int, returns_fn, probe_fn, failures_fn, save_fn, log):
    """The script's phase 2 with its scorers given: returns_fn(cand (C, P),
    idx) -> each candidate's mean shaped return; probe_fn(flat) -> the
    selection key (nominal, probe, validation strict); failures_fn(flat) ->
    the failing training entries; save_fn(flat) keeps the running best.
    Returns (best (key, flat), iterations run)."""
    rng = np.random.default_rng(0)
    flat = np.asarray(flat0)
    fail_idx = failures_fn(flat) if a.hard_frac > 0 else np.array([], int)
    best = (probe_fn(flat), flat.copy())
    it = 0
    for i in range(a.iters):
        it = i + 1
        idx = sample_minibatch(rng, fail_idx, n_train, a.train_states, a.hard_frac)
        deltas = rng.normal(size=(a.n_dir, flat.size)).astype(np.float32)
        cand = np.concatenate([flat[None] + a.delta_std * deltas,
                               flat[None] - a.delta_std * deltas])
        rets = returns_fn(cand, idx)
        flat = bh.flat_update(flat, rets[:a.n_dir], rets[a.n_dir:], deltas, a.step_size)
        if (i + 1) % a.probe_every == 0:
            key = probe_fn(flat)
            if key > best[0]:
                best = (key, flat.copy())
                save_fn(best[1])
            if a.hard_frac > 0:
                fail_idx = failures_fn(flat)
            log(f"[ars {i:03d}] probe nom {key[0]}/{N_NOM} e2e {key[1]}/{a.n_probe} "
                f"val strict {key[2]:.2f} (best {best[0]})")
            if key[0] == N_NOM and key[1] == a.n_probe and i >= EARLY_STOP_ITER:
                log("[ars] probes saturated, stopping early")
                break
    return best, it


def main(argv=None) -> int:
    ap = parser()
    a = ap.parse_args(argv)
    if a.optimizer == "bptt":
        ap.error(BPTT_REFUSED)
    device = resolve_device(a.device)
    out = out_dir(a.out, "backflip_landing_mlp")
    log = functools.partial(print, flush=True)
    clock = StageClock(device)

    env = bh.flip_env(device, "TEST_RANDOMIZER", obs_noise=True, max_ep_len=EP_LEN)
    nom_env = bh.flip_env(device, "GROUND_RANDOMIZER", obs_noise=False, max_ep_len=EP_LEN)
    w = wr.LandingWrapperBackflip(env, variant="until_grounded")
    W_launch, on = convert.load_linear_policy(a.launch, device)
    launch = bh.linear_act(W_launch, on)

    if a.bank_cache and Path(a.bank_cache).exists():
        z = torch.load(a.bank_cache, map_location=device, weights_only=False)
        bank, bank_obs, bank_noise = z["state"], z["obs"], z["noise"]
        log(f"bank: loaded {bank_obs.shape[0]} cached touchdowns from {a.bank_cache}")
        n_try = n_rot = None
    else:
        bank, bank_obs, bank_noise, n_try, n_rot = collect_bank(env, w, launch, a.bank, log)
        if a.bank_cache:
            torch.save({"state": bank, "obs": bank_obs, "noise": bank_noise}, a.bank_cache)
    clock.lap("bank")
    n_bank = int(bank_obs.shape[0])
    n_train = int(0.75 * n_bank)
    idx_train, idx_val = np.arange(n_train), np.arange(n_train, n_bank)

    params = mlp_init(env.obs_dim, a.hidden, env.get_landing_action())
    if a.init_from:
        z = np.load(a.init_from)
        params = {k: np.asarray(z[k], np.float32) for k in MLP_KEYS}
        log(f"warm-started MLP from {a.init_from}")
    layout = bh.FlatLayout(params)
    flat0 = layout.ravel(params)
    log(f"MLP: obs {env.obs_dim} -> {a.hidden} -> 6 ({layout.size} params)")

    def bank_scores(cand, idx):
        """Candidates (C, P) on bank entries idx, lanes (candidate, entry)."""
        C, ent = cand.shape[0], torch.as_tensor(np.asarray(idx), device=device)
        lanes = ent.repeat(C)
        p = bh.lanes_params(cand, layout,
                            torch.arange(C, device=device).repeat_interleave(len(ent)), device)
        return bh.stab_score(env, bh.mlp_act(p, on), take(bank, lanes), bank_obs[lanes],
                             None if bank_noise is None else bank_noise.take(lanes),
                             a.horizon)

    def returns_fn(cand, idx):
        tot, _ = bank_scores(cand, idx)
        return bh.candidate_means(tot, cand.shape[0])

    def eval_params(flat, idx):
        tot, strict = bank_scores(flat[None], idx)
        return (float(bh.candidate_means(tot, 1)[0]),
                float(bh.candidate_means(strict.to(torch.float32), 1)[0]))

    def deployed(flat, e, seeds):
        lander = bh.mlp_act(layout.unravel(torch.as_tensor(flat, device=device)), on)
        st, _ = bh.seeded_episodes(e, bh.launch_then_lander(launch, lander), seeds,
                                   "until_grounded", FULL_STEPS)
        return bh.flip_rows(st)

    def probe_fn(flat):
        nom = deployed(flat, nom_env, range(NOM_SEED0, NOM_SEED0 + N_NOM))
        pr = deployed(flat, env, range(PROBE_SEED0, PROBE_SEED0 + a.n_probe))
        vs = eval_params(flat, idx_val)[1] if len(idx_val) else 0.0
        return (sum(r["rotation"] and r["upright"] for r in nom),
                sum(r["rotation"] and r["upright"] for r in pr), vs)

    def failures_fn(flat):
        _, strict = bank_scores(flat[None], idx_train)
        return np.flatnonzero(~strict.cpu().numpy())

    def save_candidate(flat, path):
        p = layout.unravel(np.asarray(flat))
        np.savez(path, **{k: np.asarray(p[k]) for k in MLP_KEYS},
                 mean=on.mean.cpu().numpy(), var=on.var.cpu().numpy(),
                 count=on.count.cpu().numpy())

    cand_path = out / "backflip_landing_mlp.npz.cand.npz"
    best, iters = ars_loop(flat0, a, n_train, returns_fn, probe_fn, failures_fn,
                           lambda f: save_candidate(f, cand_path), log)
    clock.lap("ars")
    flat_best = best[1]
    save_candidate(flat_best, cand_path)

    nom = deployed(flat_best, nom_env, range(NOM_SEED0, NOM_SEED0 + N_NOM))
    nom_ok = sum(r["rotation"] and r["upright"] for r in nom)
    val = deployed(flat_best, env, range(VAL_SEED0, VAL_SEED0 + N_VAL))
    rot_ok = sum(r["rotation"] for r in val)
    up_ok = sum(r["rotation"] and r["upright"] for r in val)
    for r in val:
        log(f"  pitch {math.degrees(r['pitch_rad']):.0f} up_z {r['up_z']:+.2f} z {r['z']:.2f}")
    log(f"[validation] nominal {nom_ok}/{N_NOM}, fresh rotation {rot_ok}/{N_VAL}, "
        f"fresh strict upright {up_ok}/{N_VAL}")
    clock.lap("validation")
    gate_ok = nom_ok == N_NOM and rot_ok == N_VAL and up_ok >= UPRIGHT_BAR
    path = out / "backflip_landing_mlp.npz"
    if gate_ok or a.no_save_gate:
        p = layout.unravel(np.asarray(flat_best))
        np.savez(path, **{k: np.asarray(p[k]) for k in MLP_KEYS},
                 mean=on.mean.cpu().numpy(), var=on.var.cpu().numpy(),
                 count=on.count.cpu().numpy(), nominal_ok=nom_ok, rot_ok=rot_ok,
                 upright_ok=up_ok, gate_ok=gate_ok)
        log(f"saved {path} (gate_ok={gate_ok})")
    else:
        log("[validation] FAILED save bars (nominal 4/4 + rotation 12/12 + "
            "upright >= 10/12) — not saving")
    print(json.dumps({"nominal": nom_ok, "rotation": rot_ok, "upright": up_ok,
                      "bank_strict_val": list(best[0]), "gate_ok": gate_ok,
                      "saved": str(path) if (gate_ok or a.no_save_gate) else None,
                      "bank": n_bank, "bank_tries": n_try, "bank_full_rotations": n_rot,
                      "iterations": iters, **clock.record(),
                      "device": device_name(device)}), flush=True)
    return 0 if gate_ok else 1


if __name__ == "__main__":
    sys.exit(main())
