"""Build and load the hand-written CUDA kernels of ``csrc/planner_ops.cu``.

The library is compiled by ``nvcc`` for Hopper (``sm_90a``) at first use
into ``_build/`` beside this file, named by a hash of the source so an
edited source is never served by a stale build, and bound through a plain
C interface with ctypes. The last section holds what the
``torch.autograd.Function``s around a kernel and its tangent kernel share.
Nothing here runs at import time: a machine without nvcc or a card imports
the package and uses the kernels' plain PyTorch twins on CPU tensors.

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
SOURCE = _HERE / "csrc" / "planner_ops.cu"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
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
}
# the planner's four kernels also take bfloat16 arrays, under <name>_bf16
for _name in ("planner_actuation", "planner_contact", "planner_actuation_jvp",
              "planner_contact_jvp"):
    _SIGNATURES[_name + "_bf16"] = _SIGNATURES[_name]

# storage types of the planner's kernels: the entry point's suffix
STORAGE = {torch.float32: "", torch.bfloat16: "_bf16"}


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
                           f"{SOURCE.name} cannot be built")
    return found


def build() -> Path:
    """Compile the kernel library if no build of this source exists; return
    its path. The finished file is moved into place atomically, so
    concurrent processes never load a half-written library."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libplanner_ops_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


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


def stream_handle(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


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
