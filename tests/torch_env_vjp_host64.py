"""The env_substeps_vjp kernel's body in float64 on the CPU
(tests/env_substeps_vjp_host64.cpp, built with g++), for
tests/test_torch_env_vjp.py and tests/torch_bptt_grad_probe.py.

    fn = build(directory)
    rows = run(fn, args, cotangents)

`run` takes env_substeps's float32 CPU arguments and the output cotangents
(float32 tensors or None) and returns the input cotangents as float64
tensors, from the body run in double on the same inputs. Its constants are
those the plain version holds in float64 (env/substeps.py
env_substeps_plain on float64_args): the Go1's geometry rounded to float32,
as the float32 Go1Model holds it, the rest (radii, corners, joint limits,
dt and the contact and joint-limit constants) in double.
"""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from quadruped_springs_tpu_torch import kernels
from quadruped_springs_tpu_torch.env import substeps as ss

# EnvConsts' parts the model holds in float32 (the first of CONSTS_LAYOUT)
MODEL_PARTS = ("hip", "thigh", "calf", "foot", "gravity")


def build(directory) -> ctypes._CFuncPtr:
    """g++ the float64 body into `directory`; its entry point, typed."""
    lib = Path(directory) / "libenv_substeps_vjp_host64.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-o", str(lib),
                    str(Path(__file__).with_name("env_substeps_vjp_host64.cpp"))],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).env_substeps_vjp_host64
    fn.argtypes = kernels.ENV_SUBSTEPS_VJP_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def consts64(params) -> ctypes.Array:
    """EnvConsts in double as the plain version holds them in float64."""
    values = np.asarray(ss.consts_values(ss._params_key(params)))
    model = sum(count for name, count in ss.CONSTS_LAYOUT if name in MODEL_PARTS)
    values[:model] = values[:model].astype(np.float32)
    return (ctypes.c_double * values.size)(*values.tolist())


def run(fn, args, cotangents) -> tuple:
    """The float64 body's input cotangents (pos, quat, lin_vel, ang_vel, q,
    qd, anchor, q_des) on env_substeps's float32 CPU arguments `args`."""
    launch, grads, keep = ss.vjp_launch_args(*args, cotangents)
    out = [torch.zeros(g.shape, dtype=torch.float64) for g in grads]
    base = len(kernels.ENV_SUBSTEPS_ARGTYPES) - 1      # then 11 g_*, 8 d_*
    launch = list(launch)
    launch[0] = consts = consts64(args[4])
    launch[base + 11:base + 19] = [t.data_ptr() for t in out]
    if fn(*launch, None) != 0:
        raise RuntimeError("env_substeps_vjp_host64: bad constants")
    del keep, consts
    return tuple(out)
