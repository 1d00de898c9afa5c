"""Count the float operations of the env_substeps and env_substeps_vjp
kernels' bodies per (environment, substep).

    python tests/torch_env_opcount.py [--n 8]

Builds tests/env_substeps_opcount.cpp with g++ (the bodies with every float
a counting type) and runs it on n settled backflip environments (every
other one lifted 15 cm and rising), a random command held for 10 substeps,
every output's cotangent given. Prints one JSON line: the forward's and
the adjoint's operations per (environment, substep), the function's and not
the threads': the base's work, which the four leg threads do alike, and each
sum over the legs count once, and the adjoint's count is one forward plus
the adjoint proper (its recompute of each substep in the sweep is not
counted). chip_smoke.py's FLOPS_PER_ELEM["env_substeps"] and
["env_substeps_vjp"] are these counts.
"""

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from quadruped_springs_tpu_torch import kernels  # noqa: E402
from quadruped_springs_tpu_torch.control import interfaces as ci  # noqa: E402
from quadruped_springs_tpu_torch.env import substeps as ss  # noqa: E402
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv  # noqa: E402
from quadruped_springs_tpu_torch.env import randomizers as rnd  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8)
    a = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        lib = Path(tmp) / "libopcount.so"
        subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-o",
                        str(lib), str(Path(__file__).with_name("env_substeps_opcount.cpp"))],
                       check=True)
        fn = ctypes.CDLL(str(lib)).env_opcount
        fn.argtypes = kernels.ENV_SUBSTEPS_VJP_ARGTYPES + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        env = QuadrupedEnv(EnvConfig(enable_springs=True, task_env="BACKFLIP",
                                     observation_space_mode="ARS_BACKFLIP",
                                     action_space_mode="SYMMETRIC", settling_steps=200,
                                     env_randomizer_mode="TEST_RANDOMIZER"), device="cpu")
        gen = torch.Generator().manual_seed(0)
        state, _ = env.reset(gen, a.n)
        robot = state.robot
        pos, lin_vel = robot.pos.clone(), robot.lin_vel.clone()
        pos[1::2, 2] += 0.15
        lin_vel[1::2, 2] = 1.0
        robot = dataclasses.replace(robot, pos=pos, lin_vel=lin_vel)
        action = 2.0 * torch.rand((a.n, env.action_dim), generator=gen) - 1.0
        k, b = env._springs(state.scenario)
        cfg = env.cfg
        args = (robot, state.foot_anchor.contiguous(),
                ci.action_to_command(env.iface, action).contiguous(),
                rnd.model_from_params(state.scenario), env._scenario_sim_params(state.scenario),
                cfg.motor_kp, cfg.motor_kd, cfg.torque_limits, cfg.velocity_limits, k, b,
                cfg.spring_rest_angles, env.engage_sign, 10, None, False)
        out = ss.env_substeps(*args)
        cot = [torch.randn(o.shape, generator=gen) for o in ss.output_fields(out)]
        launch, _, keep = ss.vjp_launch_args(*args, cot)
        counts = (ctypes.c_int64 * 2)()
        assert fn(*launch, None, counts) == 0
    per = a.n * 10
    print(json.dumps({"environments": a.n, "substeps": 10,
                      "forward_ops_per_env_substep": counts[0] / per,
                      "vjp_ops_per_env_substep": counts[1] / per}))


if __name__ == "__main__":
    main()
