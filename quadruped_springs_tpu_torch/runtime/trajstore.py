"""ctypes binding of the trajectory store (``runtime/trajstore.cpp`` at the
repository root): fixed-width float32 rows in ``.qsts`` files with a
CRC-checked header.

The port's own binding of the shared C++ source. The library is compiled
with ``g++`` at first use into ``_build/`` beside the kernels' build, named
by a hash of the source. There is no fallback format: a machine without a
C++ compiler raises.
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

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "runtime" / "trajstore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_P, _F = ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "ts_writer_open": (_P, [ctypes.c_char_p, ctypes.c_uint32]),
    "ts_writer_append_batch": (ctypes.c_int, [_P, _F, ctypes.c_uint64]),
    "ts_writer_close": (ctypes.c_int, [_P]),
    "ts_reader_open": (_P, [ctypes.c_char_p]),
    "ts_reader_rows": (ctypes.c_uint64, [_P]),
    "ts_reader_cols": (ctypes.c_uint32, [_P]),
    "ts_reader_data": (_F, [_P]),
    "ts_reader_verify": (ctypes.c_int, [_P]),
    "ts_reader_close": (ctypes.c_int, [_P]),
}


def build() -> Path:
    """Compile the store if no build of this source exists; return its path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libtrajstore_{digest}.so"
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler found to build {SOURCE.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def write(path: str, rows: np.ndarray) -> None:
    """Write a (T, C) float32 trajectory."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    if rows.ndim != 2:
        raise ValueError("rows must be (T, C)")
    lib = library()
    h = lib.ts_writer_open(os.fsencode(path), rows.shape[1])
    if not h:
        raise IOError(f"cannot open {path} for writing")
    rc = lib.ts_writer_append_batch(h, rows.ctypes.data_as(_F), rows.shape[0])
    rc |= lib.ts_writer_close(h)
    if rc != 0:
        raise IOError(f"write to {path} failed")


def read(path: str, verify: bool = True) -> np.ndarray:
    """Read a trajectory back as a (T, C) float32 array (a copy of the
    memory-mapped file)."""
    lib = library()
    h = lib.ts_reader_open(os.fsencode(path))
    if not h:
        raise IOError(f"cannot open {path} as a trajectory store")
    try:
        if verify and lib.ts_reader_verify(h) != 1:
            raise IOError(f"CRC mismatch in {path}")
        shape = (lib.ts_reader_rows(h), lib.ts_reader_cols(h))
        return np.ctypeslib.as_array(lib.ts_reader_data(h), shape=shape).copy()
    finally:
        lib.ts_reader_close(h)
