"""The robust backflip: the linear launch and the MLP lander trained jointly.

Port of ``scripts/train_backflip_robust_joint.py``: ARS over the joint flat
parameters ``{"W": launch, "mlp": lander}`` (``jax.flatten_util``'s layout)
on the flattened autopilot episode (``env/flat_rollout.py``, ``--knots``
control steps), scored by the smoothed gate (`behaviour.episode_score`).
One iteration evaluates 2·n_dir candidates x ``--train-scen`` of the
``--n-train`` fixed training scenarios (seeds 0+) as one batch of lanes (512
at the defaults), each lane with its candidate's parameters. Every
``--probe-every`` iterations the training set, the held-out probe
(seeds 20000+) and the nominal scenarios (1000+) score the iterate; the best
by (nominal strict, probe strict, probe score) is kept in
``<out>/*.cand.npz``. The selected pair is then checked on the real wrapper
loop: nominal seeds 1000+ (4), fresh randomized seeds 77000+ (12); saved at
nominal 4/4, rotation 12/12, upright >= 10/12 (``--no-save-gate``:
always).

    python -m quadruped_springs_tpu_torch.train_backflip_robust_joint [--iters 150]

starts from ``--launch-init`` (the committed backflip_ars.npz) and
``--lander-init``: the JAX script's start, the landing trainer's running
best, is not committed, so the default is the port landing trainer's own
``runs/backflip_landing_mlp/backflip_landing_mlp.npz.cand.npz`` (an error
when missing). Writes ``<out>/backflip_launch_robust.npz`` and
``backflip_landing_mlp.npz`` (and their ``.cand.npz``) with the JAX
script's keys, prints a JSON line with the script's keys and the run's
seconds and env_substeps launches a phase; the exit code is the script's.
``--out`` (default ``runs/backflip_robust_joint``) is never under
``examples/``. Each scenario is its seed's own draw
(``rollout.seeded_reset``); the ARS draws are the script's numpy ones.
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
from quadruped_springs_tpu_torch.env.env import take
from quadruped_springs_tpu_torch.env_bench import device_name, resolve_device
from quadruped_springs_tpu_torch.policy_replay import POLICY_DIR
from quadruped_springs_tpu_torch.train import behaviour as bh
from quadruped_springs_tpu_torch.train import rollout as ro
from quadruped_springs_tpu_torch.train_two_stage import ROOT, StageClock, out_dir

EP_LEN = 4.0
FULL_STEPS = 120
TRAIN_SEED0, PROBE_SEED0, NOM_SEED0, VAL_SEED0 = 0, 20000, 1000, 77000
N_NOM, N_VAL, UPRIGHT_BAR = 4, 12, 10
LANDER_INIT = ROOT / "runs" / "backflip_landing_mlp" / "backflip_landing_mlp.npz.cand.npz"
MLP_KEYS = ("W1", "b1", "W2", "b2")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--n-train", type=int, default=64)
    ap.add_argument("--n-probe", type=int, default=24)
    ap.add_argument("--train-scen", type=int, default=16)
    ap.add_argument("--n-dir", type=int, default=16)
    ap.add_argument("--step-size", type=float, default=0.015)
    ap.add_argument("--delta-std", type=float, default=0.02)
    ap.add_argument("--knots", type=int, default=160)
    ap.add_argument("--probe-every", type=int, default=10)
    ap.add_argument("--launch-init", default=str(POLICY_DIR / "backflip_ars.npz"))
    ap.add_argument("--lander-init", default=str(LANDER_INIT),
                    help="the lander's start (default: the port landing trainer's "
                         "running best)")
    ap.add_argument("--no-save-gate", action="store_true")
    ap.add_argument("--out", default=None, help="output directory (default "
                    "runs/backflip_robust_joint; never under examples/)")
    ap.add_argument("--device", default="cuda")
    return ap


def ars_loop(flat0, a, returns_fn, probe_fn, save_fn, log):
    """The script's loop with its scorers given: returns_fn(cand (C, P),
    idx) -> each candidate's mean score; probe_fn(flat) -> the selection
    key (nominal strict, probe strict, probe score); save_fn(flat) keeps
    the running best. Returns (best (key, flat))."""
    rng = np.random.default_rng(0)
    flat = np.asarray(flat0)
    best = (probe_fn(flat), flat.copy())
    for i in range(a.iters):
        idx = rng.choice(a.n_train, a.train_scen, replace=False)
        deltas = rng.normal(size=(a.n_dir, flat.size)).astype(np.float32)
        cand = np.concatenate([flat[None] + a.delta_std * deltas,
                               flat[None] - a.delta_std * deltas])
        rets = returns_fn(cand, idx)
        flat = bh.flat_update(flat, rets[:a.n_dir], rets[a.n_dir:], deltas, a.step_size)
        if (i + 1) % a.probe_every == 0:
            key = probe_fn(flat)
            if key > best[0]:
                best = (key, flat.copy())
                save_fn(flat)
            log(f"[ars {i:03d}] probe strict {key[1]}/{a.n_probe} nom {key[0]}/{N_NOM} "
                f"(best {best[0]})")
    return best


def main(argv=None) -> int:
    a = parser().parse_args(argv)
    device = resolve_device(a.device)
    out = out_dir(a.out, "backflip_robust_joint")
    log = functools.partial(print, flush=True)
    clock = StageClock(device)
    try:
        m = np.load(a.lander_init)
    except FileNotFoundError:
        raise SystemExit(f"--lander-init {a.lander_init}: no such file; run "
                         "quadruped_springs_tpu_torch.train_backflip_landing_mlp first, or "
                         "pass a lander (e.g. examples/policies/backflip_landing_mlp.npz)")
    W, on = convert.load_linear_policy(a.launch_init, device)
    # the script's jnp.asarray: float32 leaves
    params0 = {"W": W.cpu().numpy(), "mlp": {k: np.asarray(m[k], np.float32) for k in MLP_KEYS}}
    layout = bh.FlatLayout(params0)
    flat0 = layout.ravel(params0)
    log(f"joint params: launch {params0['W'].size} + lander "
        f"{layout.size - params0['W'].size} = {layout.size}")

    env = bh.flip_env(device, "TEST_RANDOMIZER", obs_noise=True, max_ep_len=EP_LEN)
    nom_env = bh.flip_env(device, "GROUND_RANDOMIZER", obs_noise=False, max_ep_len=EP_LEN)
    banks = {"train": (env, ro.seeded_reset(env, range(TRAIN_SEED0, TRAIN_SEED0 + a.n_train))),
             "probe": (env, ro.seeded_reset(env, range(PROBE_SEED0, PROBE_SEED0 + a.n_probe))),
             "nom": (nom_env, ro.seeded_reset(nom_env, range(NOM_SEED0, NOM_SEED0 + N_NOM)))}
    clock.lap("resets")

    def scores(cand, name, idx=None):
        """Candidates (C, P) on a bank's scenarios (all, or idx), lanes
        ordered (candidate, scenario)."""
        e, (state, obs, noise) = banks[name]
        ent = torch.arange(obs.shape[0], device=device) if idx is None else \
            torch.as_tensor(np.asarray(idx), device=device)
        C = cand.shape[0]
        lanes = ent.repeat(C)
        p = bh.lanes_params(cand, layout,
                            torch.arange(C, device=device).repeat_interleave(len(ent)), device)
        return bh.episode_score(e, bh.linear_act(p["W"], on), bh.mlp_act(p["mlp"], on),
                                take(state, lanes), obs[lanes],
                                None if noise is None else noise.take(lanes), a.knots)

    def returns_fn(cand, idx):
        sc, _ = scores(cand, "train", idx)
        return bh.candidate_means(sc, cand.shape[0])

    def evaluate(flat, name):
        sc, strict = scores(flat[None], name)
        return float(bh.candidate_means(sc, 1)[0]), int(strict.sum())

    def probe_fn(flat):
        pv, ps = evaluate(flat, "probe")
        _, ns = evaluate(flat, "nom")
        return ns, ps, pv

    def save_params(flat, suffix=".cand.npz", **extra):
        p = layout.unravel(np.asarray(flat))
        stats = dict(mean=on.mean.cpu().numpy(), var=on.var.cpu().numpy(),
                     count=on.count.cpu().numpy())
        np.savez(str(out / "backflip_launch_robust.npz") + suffix, W=p["W"], **stats,
                 **extra)
        np.savez(str(out / "backflip_landing_mlp.npz") + suffix,
                 **{k: p["mlp"][k] for k in MLP_KEYS}, **stats, **extra)

    tr0, ts0 = evaluate(flat0, "train")
    log(f"[init] train {tr0:.3f} strict {ts0}/{a.n_train}")
    best = ars_loop(flat0, a, returns_fn, probe_fn, save_params, log)
    clock.lap("ars")
    flat_best = best[1]
    save_params(flat_best)

    p = layout.unravel(torch.as_tensor(flat_best, device=device))
    act = bh.launch_then_lander(bh.linear_act(p["W"], on), bh.mlp_act(p["mlp"], on))

    def deployed(e, seed0, n):
        st, _ = bh.seeded_episodes(e, act, range(seed0, seed0 + n), "until_grounded",
                                   FULL_STEPS)
        return bh.flip_rows(st)

    nom = deployed(nom_env, NOM_SEED0, N_NOM)
    nom_ok = sum(r["rotation"] and r["upright"] for r in nom)
    val = deployed(env, VAL_SEED0, N_VAL)
    rot_ok = sum(r["rotation"] for r in val)
    up_ok = sum(r["rotation"] and r["upright"] for r in val)
    for r in val:
        log(f"  pitch {math.degrees(r['pitch_rad']):.0f} up_z {r['up_z']:+.2f} z {r['z']:.2f}")
    log(f"[validation] nominal {nom_ok}/{N_NOM}, fresh rotation {rot_ok}/{N_VAL}, "
        f"fresh strict upright {up_ok}/{N_VAL}")
    clock.lap("validation")
    gate_ok = nom_ok == N_NOM and rot_ok == N_VAL and up_ok >= UPRIGHT_BAR
    saved = gate_ok or a.no_save_gate
    if saved:
        save_params(flat_best, "", nominal_ok=nom_ok, rot_ok=rot_ok, upright_ok=up_ok,
                    gate_ok=gate_ok)
        log(f"saved {out}/backflip_launch_robust.npz + backflip_landing_mlp.npz "
            f"(gate_ok={gate_ok})")
    else:
        log("[validation] FAILED save bars (nominal 4/4 + rotation 12/12 + "
            "upright >= 10/12) — not saving")
    print(json.dumps({"nominal": nom_ok, "rotation": rot_ok, "upright": up_ok,
                      "probe_best": list(best[0]), "gate_ok": gate_ok,
                      "saved": str(out) if saved else None, "init_train_score": tr0,
                      "init_train_strict": ts0, **clock.record(),
                      "device": device_name(device)}), flush=True)
    return 0 if gate_ok else 1


if __name__ == "__main__":
    sys.exit(main())
