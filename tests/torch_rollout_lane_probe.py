"""Where `planner_rollout` parts from its plain version within one knot.

    python tests/torch_rollout_lane_probe.py --save rollout_lanes.pt     # on the card
    python tests/torch_rollout_lane_probe.py --replay rollout_lanes.pt   # on the CPU

--save (on the card): the MPPI headline's rollout (chip_smoke.py phase 19's
problems and candidates, 1024 x 32 lanes, H = 50) through the plain version;
from the plain version's state at every knot, one knot of the kernel, of the
plain version and of the plain version in float64
(chip_smoke.one_knot_from_plain, which phase 19 gates). Prints, per path, the
quantiles over the 1.6 M knot-lanes of the relative distance to the
float64 knot, and the knot-lanes where the kernel is 100 times farther from
it than the plain version; saves the 16 worst of those (state, command,
scenario and the three results).

--replay (on the CPU, needs g++): the saved knot-lanes through the kernel's
body built with g++ (tests/planner_rollout_host.cpp: the same code without
FMA contraction), the plain version in float32 and in float64, each one's
distance printed beside the card's kernel's. One JSON line per knot-lane.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from quadruped_springs_tpu_torch.env import randomizers as rnd  # noqa: E402
from quadruped_springs_tpu_torch.solver import mppi  # noqa: E402
from quadruped_springs_tpu_torch.solver import rollout as ro  # noqa: E402
from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem, cast_floats  # noqa: E402

B, R, H, WORST = 1024, 32, 50, 16


def rel(a, ref):
    """max over the state of |a - ref| / (1 + |ref|), per lane (float64)."""
    return ((a.double() - ref).abs() / (1.0 + ref.abs())).amax(-1)


def save(path):
    import chip_smoke

    prob = MPCProblem(MPCConfig(horizon=H), "cuda")
    x0, scen = chip_smoke.rollout_problems(torch, prob, B, 31)
    eps = 0.3 * torch.randn((B, R, H, prob.action_dim), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(32))
    us = torch.clamp(prob.task_warm_start()[None, None] + mppi._smooth_noise(eps), -1.0, 1.0)
    r = chip_smoke.one_knot_from_plain(torch, ro, prob, x0, us, scen)
    e_k, e_p = r["e_kernel"], r["e_plain"]
    qs_ = torch.tensor([0.5, 0.9, 0.99, 0.999], dtype=torch.float64, device="cuda")
    far = e_k > 100.0 * e_p + 1e-4
    print(json.dumps({"device": torch.cuda.get_device_name(0), "knot_lanes": far.numel(),
                      "kernel_quantiles": torch.quantile(e_k.flatten(), qs_).tolist(),
                      "plain_quantiles": torch.quantile(e_p.flatten(), qs_).tolist(),
                      "kernel_max": float(e_k.max()), "plain_max": float(e_p.max()),
                      "kernel_100x_farther": int(far.sum())}), flush=True)
    flat = torch.argsort((e_k - e_p).flatten(), descending=True)[:WORST]
    n, k = flat // H, flat % H
    cpu = lambda t: t.cpu()
    lane_scen = r["scenario"]
    torch.save({"x": cpu(r["x"][n, k]), "q": cpu(r["q"][n, k]), "lane": cpu(n),
                "knot": cpu(k), "kernel": cpu(r["kernel"][n, k]),
                "plain": cpu(r["plain"][n, k]), "exact": cpu(r["exact"][n, k]),
                "scenario": {f: cpu(getattr(lane_scen, f)[n])
                             for f in lane_scen.__dataclass_fields__}}, path)


def replay(path):
    from quadruped_springs_tpu_torch import kernels

    if shutil.which("g++") is None:
        raise SystemExit("--replay needs g++ to build the kernel's body for the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "libplanner_rollout_host.so")
        subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-o", lib,
                        os.path.join(ROOT, "tests", "planner_rollout_host.cpp")], check=True)
        host = ctypes.CDLL(lib).planner_rollout_host
        host.argtypes = kernels.PLANNER_ROLLOUT_ARGTYPES
        host.restype = ctypes.c_int
        d = torch.load(path, weights_only=False)
        prob = MPCProblem(MPCConfig(horizon=H), "cpu")
        lanes = prob.rollout_lanes(rnd.ScenarioParams(**d["scenario"]))
        consts = prob.rollout_consts()
        x, q = d["x"].contiguous(), d["q"][:, None, None].contiguous()
        args, xs = ro.launch_args(x, q, lanes, consts)
        assert host(*args, None) == 0
        f64 = lambda t: cast_floats(t, torch.float64)
        exact = ro.planner_rollout_plain(x.double(), q.double(), f64(lanes), f64(consts))[:, 0, 1]
        plain = ro.planner_rollout_plain(x, q, lanes, consts)[:, 0, 1]
        for i in range(x.shape[0]):
            r = lambda t: float(rel(t[i:i + 1], exact[i:i + 1]))
            print(json.dumps({"lane": int(d["lane"][i]), "knot": int(d["knot"][i]),
                              "card_kernel": r(d["kernel"]), "card_plain": r(d["plain"]),
                              "cpu_plain": r(plain), "host_body": r(xs[:, 0, 1])}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--save")
    group.add_argument("--replay")
    a = ap.parse_args(argv)
    if a.save:
        if not torch.cuda.is_available():
            raise SystemExit("--save needs a CUDA card")
        save(a.save)
    else:
        replay(a.replay)


if __name__ == "__main__":
    main()
