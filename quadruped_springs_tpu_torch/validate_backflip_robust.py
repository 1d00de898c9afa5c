"""Fresh-seed validation of a robust-backflip pair.

Port of ``scripts/validate_backflip_robust.py``: the linear launch and the
MLP lander (the committed ``backflip_launch_robust.npz`` and
``backflip_landing_mlp.npz`` by default; ``--launch``/``--lander`` take the
port's own pair) under TEST_RANDOMIZER with observation noise through the
"until_grounded" autopilot, one lane per seed (``--seed0`` .. ``+ --n``), each
with its seed's own scenario and noise stream, in one batch
(``policy_replay.backflip_robust``'s episode: ``run_robust`` of
``examples/run_backflip_closed_loop.py``).

    python -m quadruped_springs_tpu_torch.validate_backflip_robust [--n 24]

writes ``<out>/backflip_robust_validation.json`` with the JAX JSON's keys
(``--out`` a directory, default ``runs/backflip_robust_validation``, never
under ``examples/``: ``examples/out/backflip_robust_validation.json`` is the
JAX package's) and prints its counts as one JSON line. The seeds'
scenarios are the port's draws, not JAX's. A CUDA device that is not
available is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import json
import math
import time

from quadruped_springs_tpu_torch import policy_replay
from quadruped_springs_tpu_torch.env import substeps as ss
from quadruped_springs_tpu_torch.env_bench import device_name
from quadruped_springs_tpu_torch.train_two_stage import out_dir

SETTLE, MAX_STEPS = 2500, 120   # the JAX env's settle; run_robust's policy steps
PROVENANCE = ("never used by any trainer/probe/save gate (train 0-63, probes 20000+, "
              "nominal 1000+, save gate 77000-77011)")


def validate(seeds, launch, lander, device="cuda") -> dict:
    """The JAX JSON's record for the pair on `seeds` (one lane each)."""
    t0 = time.time()
    rec = policy_replay.backflip_robust(seeds=list(seeds), launch=launch, lander=lander,
                                        device=device, settle=SETTLE, max_steps=MAX_STEPS)
    # run_robust's record: "upright" is the pose alone, strict upright is
    # counted over it
    per_seed = [{"seed": s, "full_rotation": rot, "upright": up, "pitch_deg": math.degrees(p),
                 "up_z": u, "final_z": z}
                for s, rot, up, p, u, z in zip(seeds, rec["rotation"], rec["upright"],
                                               rec["pitch_rad"], rec["up_z"], rec["final_z"])]
    return {"seeds": list(seeds), "seed_provenance": PROVENANCE,
            "randomizer": "TEST_RANDOMIZER + obs noise", "n": len(per_seed),
            "full_rotation": sum(r["full_rotation"] for r in per_seed),
            "strict_upright": sum(r["upright"] for r in per_seed),
            "per_seed": per_seed, "wall_s": round(time.time() - t0, 1)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--seed0", type=int, default=88000)
    ap.add_argument("--launch", default=str(policy_replay.POLICY_DIR /
                                            "backflip_launch_robust.npz"))
    ap.add_argument("--lander", default=str(policy_replay.POLICY_DIR /
                                            "backflip_landing_mlp.npz"))
    ap.add_argument("--out", default=None, help="output directory (default "
                    "runs/backflip_robust_validation; never under examples/)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = out_dir(a.out, "backflip_robust_validation")
    n0 = ss.env_substeps.launches
    rec = validate(range(a.seed0, a.seed0 + a.n), a.launch, a.lander, a.device)
    path = out / "backflip_robust_validation.json"
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps({**{k: rec[k] for k in ("n", "full_rotation", "strict_upright",
                                              "wall_s")},
                      "env_substeps_launches": ss.env_substeps.launches - n0,
                      "launch": a.launch, "lander": a.lander, "wrote": str(path),
                      "device": device_name(policy_replay.resolve_device(a.device))}),
          flush=True)
    return rec


if __name__ == "__main__":
    main()
