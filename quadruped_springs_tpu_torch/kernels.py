"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``.cu`` file under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) to an object, all at once in parallel, and the objects are
linked into one library in ``_build/`` beside this file. The library is
named by a hash of every ``.cu`` and ``.cuh`` source, so an edited source or
header is never served by a stale build; ``-Xptxas -v`` (each kernel's
registers, shared memory and spills) goes into a log beside it
(``build_log()``). The library is bound through a plain C interface with
ctypes. The last section holds what the ``torch.autograd.Function``s around
a kernel and its tangent kernel share. Nothing here runs at import time: a
machine without nvcc or a card imports the package and uses the kernels'
plain PyTorch twins on CPU tensors.

No ``--use_fast_math``: the twins' ``sqrtf`` and divisions are IEEE, and
the kernels must agree with them to rounding.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
ENV_SUBSTEPS_ARGTYPES = ([_P, ctypes.c_int] + [_P] * 8 + [_I64, _I64] + [_P] * 14
                         + [_I64, _P, _I64] + [_P] * 13
                         + [_I64] + [ctypes.c_int] * 4 + [_P])
# env_substeps's arguments but the stream, then the 11 output cotangents
# (null: zero), the 8 input cotangents, the scratch and the stream
ENV_SUBSTEPS_VJP_ARGTYPES = ENV_SUBSTEPS_ARGTYPES[:-1] + [_P] * 20 + [_P]
PLANNER_ROLLOUT_ARGTYPES = ([_P, ctypes.c_int] + [_P] * 12 + [_I64, _P, _I64]
                            + [ctypes.c_int] * 4 + [_P])
# planner_rollout's arguments but the stream, then us, costs, family,
# action_dim, the family's constants (a host float array) and the stream
PLANNER_ROLLOUT_COST_ARGTYPES = (PLANNER_ROLLOUT_ARGTYPES[:-1]
                                 + [_P, _P, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_float), _P])
# costs, cand, cost_new, draw, sigma, norm, lower, upper, us, us_alt, cost,
# trace, rows, q_des, n_problems, samples, horizon, actions, n_elite,
# trace_col, iterations, out_rows, fused, smooth, rcp_temperature, u_min,
# u_max, lp_a, lp_b, joint_src, joint_sign (host arrays), stream
# (csrc/mppi_update.cuh)
MPPI_UPDATE_ARGTYPES = ([_P] * 14 + [_I64] + [ctypes.c_int] * 9 + [ctypes.c_float] * 5
                        + [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float), _P])
_SIGNATURES = {
    # q_des, q, qd, kp, kd, limits, spring_k, spring_b, rest, sign,
    # tau, tau_motor, n_lanes, stream
    "planner_actuation": [_P] * 12 + [ctypes.c_int64, _P],
    # phi, v_w, mu, kn, dn, v_tol, clamp_damping, f_world, fn, in_contact,
    # n_lanes, stream
    "planner_contact": [_P, _P, _P, ctypes.c_float, ctypes.c_float,
                        ctypes.c_float, ctypes.c_int, _P, _P, _P,
                        ctypes.c_int64, _P],
    # phi, v_w, p_w, anchor, mu, kn, dn, kt, ct, v_tol, clamp_damping,
    # f_world, fn, in_contact, new_anchor, n_lanes, stream
    "planner_contact_anchored": [_P] * 5 + [ctypes.c_float] * 5 + [ctypes.c_int]
                                + [_P] * 4 + [ctypes.c_int64, _P],
    # the ten primal arguments of planner_actuation, dq_des, dq, dqd, dtau,
    # n_lanes, n_tangents, stream
    "planner_actuation_jvp": [_P] * 14 + [ctypes.c_int64, ctypes.c_int, _P],
    # phi, v_w, mu, kn, dn, v_tol, clamp_damping, dphi, dv_w, df_world,
    # n_lanes, n_tangents, stream
    "planner_contact_jvp": [_P, _P, _P, ctypes.c_float, ctypes.c_float,
                            ctypes.c_float, ctypes.c_int, _P, _P, _P,
                            ctypes.c_int64, ctypes.c_int, _P],
    # stream; launches an empty kernel (the launch floor of the card)
    "planner_noop": [_P],
    # consts (host float array), n_consts, pos, quat, lin_vel, ang_vel, q, qd,
    # anchor, q_des, q_des_env, q_des_step, kp, kd, torque_limits,
    # velocity_limits, rest, sign, spring_k, spring_b, friction, the model's
    # trunk_inertia6, trunk_mass, leg_masses, leg_coms, leg_inertias6,
    # model_step, ext_force, ext_stride, the 13 outputs, n, substeps, on_rack,
    # clamp_damping, torque_mode, stream (csrc/env_lane.cuh)
    "env_substeps": ENV_SUBSTEPS_ARGTYPES,
    # out (5 ints): env_substeps's blocks an SM, threads a block, registers
    # and local bytes a thread, shared bytes a block
    "env_substeps_occupancy": [_P],
    # env_substeps's arguments but the stream; the cotangents of pos, quat,
    # lin_vel, ang_vel, q, qd, anchor, tau, tau_m, tau_m_sum, foot_forces
    # (each may be null); the results d_pos .. d_anchor, d_q_des; the scratch
    # (4N, substeps, 21); stream (csrc/env_lane_vjp.cuh)
    "env_substeps_vjp": ENV_SUBSTEPS_VJP_ARGTYPES,
    # out (6 ints): as env_substeps_occupancy, of env_substeps_vjp's kernel, and its chunk
    "env_substeps_vjp_occupancy": [_P],
    # consts (host float array), n_consts, x0, q_des, kp, kd, torque_limits,
    # velocity_limits, rest, sign, spring_k, spring_b, friction, model,
    # scenario_stride, xs, n_problems, repeats, horizon, substeps,
    # clamp_damping, stream (csrc/planner_lane.cuh)
    "planner_rollout": PLANNER_ROLLOUT_ARGTYPES,
    # repeats, scenario_stride, out (5 ints): planner_rollout's blocks an SM,
    # threads a block, registers and local bytes a thread, shared bytes a block
    "planner_rollout_occupancy": [ctypes.c_int, _I64, _P],
    # planner_rollout's arguments (xs may be null), us, costs, family,
    # action_dim, weights, stream (csrc/planner_lane.cuh, task_cost.cuh)
    "planner_rollout_cost": PLANNER_ROLLOUT_COST_ARGTYPES,
    # repeats, scenario_stride, horizon, out (5 ints): as
    # planner_rollout_occupancy, of the cost instantiation
    "planner_rollout_cost_occupancy": [ctypes.c_int, _I64, ctypes.c_int, _P],
    # csrc/mppi_update.cuh
    "mppi_update": MPPI_UPDATE_ARGTYPES,
    # samples, horizon, actions, n_problems, out (6 ints): as
    # planner_rollout_occupancy, of mppi_update's instantiation for K =
    # samples at H, m and B, and its groups a slot
    "mppi_update_occupancy": [ctypes.c_int] * 3 + [_I64, _P],
}
# the planner's four kernels also take bfloat16 arrays, under <name>_bf16
for _name in ("planner_actuation", "planner_contact", "planner_actuation_jvp",
              "planner_contact_jvp"):
    _SIGNATURES[_name + "_bf16"] = _SIGNATURES[_name]

# storage types of the planner's kernels: the entry point's suffix
STORAGE = {torch.float32: "", torch.bfloat16: "_bf16"}


def sources() -> list[Path]:
    """Every CUDA source and header of csrc/, in a fixed order."""
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                           f"{CSRC} cannot be built")
    return found


def _library_path() -> Path:
    digest = hashlib.sha256()
    for p in sources():
        digest.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    return BUILD_DIR / f"libcsrc_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library if no build of these sources exists;
    return its path. Each .cu compiles to an object in its own nvcc, all
    started together; one more links them. The finished file is moved into
    place atomically, so concurrent processes never load a half-written
    library."""
    lib = _library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = [p for p in sources() if p.suffix == ".cu"]
        objects = [Path(tmp) / (p.stem + ".o") for p in units]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for p, o in zip(units, objects)]
        logs = [(p, proc.communicate()[0], proc.returncode) for p, proc in zip(units, procs)]
        for p, log, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {p}:\n{log}")
        out = Path(tmp) / "lib.so"
        proc = subprocess.run([nvcc, "-shared", "-o", str(out), *map(str, objects)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {lib.name}:\n{proc.stderr}")
        lib.with_suffix(".log").write_text("".join(
            f"== {p.name}\n{log}" for p, log, _ in logs))
        os.replace(out, lib)
    return lib


def build_log() -> str:
    """nvcc's output of the build (-Xptxas -v: registers, shared memory and
    spills of every kernel), building first if needed."""
    return build().with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")


def entry(name: str, dtype: torch.dtype):
    """The library's launcher of kernel `name` for arrays of `dtype`
    (float32, or bfloat16 for the planner's four kernels); raises for any
    other type."""
    if dtype not in STORAGE:
        raise TypeError(f"{name}: no kernel for dtype {dtype}")
    return getattr(library(), name + STORAGE[dtype])


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
                 dtype=torch.float32) -> None:
    """Validate one kernel argument: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_tensors(checks, device: torch.device, dtype=torch.float32) -> None:
    """check_tensor over (name, tensor, shape) triples, each tensor's four
    properties read once; check_tensor names what fails."""
    for name, t, shape in checks:
        if (t.device != device or t.dtype != dtype or t.shape != shape
                or not t.is_contiguous()):
            check_tensor(name, t, shape, device, dtype)


def stream_handle(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device` (read
    without making a torch.cuda.Stream)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def launch(device: torch.device, name: str, fn, args) -> None:
    """fn(*args, stream) on PyTorch's current stream of `device`, made the
    current device where it is not; raises on a launch error."""
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream_handle(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream_handle(device))
    check_launch(name, err)


# -- shared by the autograd Functions that bind a kernel and its tangent kernel --

def stack_tangents(info, in_dims, tangents, n_primals: int):
    """The vmap rule shared by the tangent kernels' Functions: the mapped
    axis of every tangent (T0,N,...) joins its direction axis, giving
    (B·T0,N,...) contiguous slabs for one launch. The primals must not be
    mapped: many tangents of ONE primal is what the kernels compute."""
    if any(d is not None for d in in_dims[:n_primals]):
        raise NotImplementedError(
            "vmap over the primal arguments of a tangent kernel is not supported; "
            "fold that batch into the lane axis")
    out = []
    for t, d in zip(tangents, in_dims[n_primals:n_primals + len(tangents)]):
        t = (t[None].expand(info.batch_size, *t.shape) if d is None
             else t.movedim(d, 0))
        out.append(t.reshape(-1, *t.shape[2:]).contiguous())
    return out


def no_backward(name: str):
    raise NotImplementedError(
        f"{name}: reverse-mode differentiation through the CUDA kernel is not "
        "implemented (only forward mode, for the iLQR linearization)")


def no_primal_vmap(name: str):
    raise NotImplementedError(
        f"{name}: vmap over the kernel's arguments is not supported; fold the batch "
        "into the lane axis (vmap over tangents of torch.func.jvp is supported)")


def tangent_or_zeros(tangent, primal):
    """A missing forward-mode tangent is a zero tangent."""
    return torch.zeros_like(primal) if tangent is None else tangent
