"""Is a late growth of the BPTT lander's gradient the dynamics' or the
env_substeps_vjp kernel's? Run on a CUDA card, after a BPTT run that kept
its iterates:

    python -m quadruped_springs_tpu_torch.train_backflip_landing_mlp \\
        --optimizer bptt --save-every 1 --bank-cache D/bank.pt --out D > D/run.log
    python tests/torch_bptt_grad_probe.py --run D [--at 100 117]

Reads the run's JSON line (its gradient norm at every update) and its kept
iterates and minibatches (backflip_landing_mlp.iterates.npz), and picks the
first update whose gradient norm is over GROWTH x the median of those
before it, the update before that one and the update of the largest norm,
or the updates of --at where given. At each
picked update, from its starting iterate on its minibatch (the run's bank,
from --bank-cache, and the run's --horizon and --hidden):

  kernel  the loss and its gradient through the kernels, as the run took
          them (env_substeps forward, one env_substeps_vjp a control step);
  plain   the same through the plain version on the card (env_substeps_plain
          under autograd for every control step);
  moved   each of the two again from the iterate moved one float32 ulp up
          (every parameter): how far the gradient itself moves under a
          rounding-sized change, against how far the two part;
  steps   at each control step of the kernel's backward, the kernel's input
          cotangents against the plain version's on the same inputs and
          output cotangents, by env/substeps.py check_vjp (chip_smoke.py
          phase 26's rule, kinks held along the kernel's own substep starts).

With --dump DIR the inputs, output cotangents and kernel results of the
environments that fail check_vjp are saved there, one file a control step;

    python tests/torch_bptt_grad_probe.py --check-dump DIR

then holds each saved kernel result, on the CPU, to the kernel's body run
in float64 (tests/env_substeps_vjp_host64.cpp), beside the plain version's
float32 distance to it and its float64 autograd's: whether the kernel's
arithmetic is right there and only its float32 rounding parts it from the
plain version's.

Prints one JSON line per picked update: the run's gradient norm there, both
losses and gradient norms, the relative distance and cosine of the kernel's
gradient to the plain version's and of each to itself moved, the control
steps that fail check_vjp, the largest share of the spread allowance used,
the proven kinks (all, and within one substep), the seconds each part took,
and the largest input cotangent at each control step (from the last step
back to the first).
"""

import argparse
import dataclasses
import json
import tempfile
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from quadruped_springs_tpu_torch import convert  # noqa: E402
from quadruped_springs_tpu_torch import train_backflip_landing_mlp as lm  # noqa: E402
from quadruped_springs_tpu_torch.env import substeps as ss  # noqa: E402
from quadruped_springs_tpu_torch.train import behaviour as bh  # noqa: E402

GROWTH = 100.0                   # a jump of the gradient norm over its past median
REL_TOL, SPREAD = 1e-5, 10.0     # chip_smoke.py's REL_TOL and ENV_SPREAD


def run_record(run: Path) -> dict:
    """The last JSON line of the run's log holding a "bptt" record."""
    for line in reversed((run / "run.log").read_text().splitlines()):
        if line.startswith("{") and '"bptt"' in line:
            return json.loads(line)
    raise SystemExit(f"no BPTT JSON line in {run / 'run.log'}")


def picked_updates(norms, at) -> list:
    """`at` where given, else the first update (from 1) over GROWTH x the
    median of the norms before it, the one before it and the one with the
    largest norm."""
    first = next((n for n in range(21, len(norms) + 1)
                  if norms[n - 1] > GROWTH * statistics.median(norms[:n - 1])), None)
    picks = set(at) or ({first - 1, first} if first else set()) | {int(np.argmax(norms)) + 1}
    return sorted(n for n in picks if 1 <= n <= len(norms))


def to_cpu(x):
    """Tensors, and the dataclasses and sequences holding them, on the CPU."""
    if torch.is_tensor(x):
        return x.cpu()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: to_cpu(getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(v) for v in x)
    return x


def check_dumps(directory: Path):
    """--check-dump: each saved step against the kernel's body in float64."""
    from tests import torch_env_vjp_host64 as h64

    with tempfile.TemporaryDirectory() as tmp:
        fn = h64.build(tmp)
        for path in sorted(directory.glob("update*_step*.pt")):
            z = torch.load(path, weights_only=False)
            args, cot = z["args"], z["cot"]
            exact = ss.vjp_rows(h64.run(fn, args, cot))
            sides = {"kernel": ss.vjp_rows(z["got"]),
                     "plain": ss.vjp_rows(ss.env_substeps_vjp_plain(*args, cot)),
                     "plain_float64": ss.vjp_rows(ss.env_substeps_vjp_plain(
                         *ss.float64_args(args), ss._double(cot)))}
            rel = {side: {k: float((v[k] - exact[k]).abs().max()
                                   / (1.0 + exact[k].abs().max())) for k in exact}
                   for side, v in sides.items()}
            worst = {side: max(r, key=r.get) for side, r in rel.items()}
            print(json.dumps({"update": z["update"], "step_back": z["step_back"],
                              "environments": z["envs"],
                              "distance_to_float64_body": {
                                  side: {"field": worst[side], "relative": rel[side][worst[side]]}
                                  for side in rel},
                              "kernel_by_field": rel["kernel"]}), flush=True)


def apart(a, b) -> dict:
    """|a - b| / |b| and the cosine of two gradients."""
    return {"rel_distance": float((a - b).norm() / b.norm().clamp_min(1e-30)),
            "cosine": float(torch.nn.functional.cosine_similarity(a, b, dim=0))}


def gradient(loss_fn, flat, idx, device):
    """The loss and its gradient at flat on minibatch idx."""
    p = torch.tensor(flat, dtype=torch.float32, device=device, requires_grad=True)
    loss = loss_fn(p, idx)
    (g,) = torch.autograd.grad(loss, p)
    return float(loss.detach()), g.double()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", help="the BPTT run's --out directory")
    ap.add_argument("--dump", default="", help="save the failing steps here")
    ap.add_argument("--check-dump", default="", help="check saved steps (CPU)")
    ap.add_argument("--bank-cache", default="", help="default: <run>/bank.pt")
    ap.add_argument("--at", type=int, nargs="*", default=[])
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cpu: the plumbing only (no kernel: both sides are the plain version)")
    a = ap.parse_args(argv)
    if a.check_dump:
        return check_dumps(Path(a.check_dump))
    run, device = Path(a.run), a.device
    norms = run_record(run)["bptt"]["grad_norm"]
    kept = np.load(run / "backflip_landing_mlp.iterates.npz")
    z = torch.load(a.bank_cache or run / "bank.pt", map_location=device, weights_only=False)
    env = bh.flip_env(device, "TEST_RANDOMIZER", obs_noise=True, max_ep_len=lm.EP_LEN)
    _, on = convert.load_linear_policy(str(lm.POLICY_DIR / "backflip_ars.npz"), device)
    layout = bh.FlatLayout(lm.mlp_init(env.obs_dim, a.hidden, env.get_landing_action()))
    loss_fn = lm.bptt_loss(env, on, layout, z["state"], z["obs"], z["noise"], a.horizon)
    kernel_vjp, kernel_fwd = ss.env_substeps_vjp, ss.env_substeps
    picks = picked_updates(norms, a.at)
    print(f"gradient norms: median {statistics.median(norms)}, max {max(norms)} at update "
          f"{int(np.argmax(norms)) + 1}; probing updates {picks}", flush=True)
    for n in picks:
        flat, idx = kept[f"flat_{n}"], kept[f"idx_{n}"]
        moved = np.nextafter(flat, np.float32(np.inf))
        calls, seconds = [], {}

        def recording(*args):
            got = kernel_vjp(*args)
            calls.append((args[:-1], args[-1], got))
            return got

        def timed(what, fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize() if device == "cuda" else None
            seconds[what] = time.perf_counter() - t0
            return out

        recording.launches = kernel_vjp.launches
        ss.env_substeps_vjp = recording      # _EnvSubsteps.backward's launch, recorded
        try:
            loss_k, g_k = timed("kernel", lambda: gradient(loss_fn, flat, idx, device))
        finally:
            ss.env_substeps_vjp = kernel_vjp
        _, g_km = timed("kernel_moved", lambda: gradient(loss_fn, moved, idx, device))
        ss.env_substeps = ss.env_substeps_plain
        try:
            loss_p, g_p = timed("plain", lambda: gradient(loss_fn, flat, idx, device))
            _, g_pm = timed("plain_moved", lambda: gradient(loss_fn, moved, idx, device))
        finally:
            ss.env_substeps = kernel_fwd
        failing, used, kinks, within, scale = [], 0.0, 0, 0, []
        t0 = time.perf_counter()
        for t, (args, cot, got) in enumerate(calls):
            r = ss.check_vjp(args, cot, got, REL_TOL, SPREAD)
            if r["failures"]:
                failing.append({"step_back": t, "failures": r["failures"][:2]})
            if r["failures"] and a.dump:
                idx = torch.as_tensor(r["failed"], device=device)
                Path(a.dump).mkdir(parents=True, exist_ok=True)
                torch.save({"update": n, "step_back": t, "envs": r["failed"],
                            "args": to_cpu(ss._take_args(args, idx)),
                            "cot": [None if c is None else c[idx].cpu() for c in cot],
                            "got": [g[idx].cpu() for g in got]},
                           Path(a.dump) / f"update{n}_step{t}.pt")
            used, kinks = max(used, r["spread_used"]), kinks + len(r["kinks"])
            within += len(r["within"])
            scale.append(max(float(g.abs().max()) for g in got))
        seconds["steps"] = time.perf_counter() - t0
        print(json.dumps({
            "update": n, "run_grad_norm": norms[n - 1], "loss_kernel": loss_k,
            "loss_plain": loss_p, "norm_kernel": float(g_k.norm()),
            "norm_plain": float(g_p.norm()), "kernel_vs_plain": apart(g_k, g_p),
            "kernel_vs_kernel_moved": apart(g_k, g_km), "plain_vs_plain_moved": apart(g_p, g_pm),
            "control_steps": len(calls), "steps_failing": failing,
            "max_spread_used": used, "kinks": kinks, "kinks_within_a_substep": within,
            "seconds": seconds, "max_input_cotangent_by_step_back": scale}), flush=True)


if __name__ == "__main__":
    main()
