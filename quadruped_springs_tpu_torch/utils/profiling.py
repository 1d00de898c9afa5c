"""Tracing and profiling utilities: the port of
``quadruped_springs_tpu.utils.profiling``.

  * ``trace(dir)``: context manager around ``torch.profiler`` writing a
    TensorBoard / Perfetto trace (host and, on the card, device activity)
    of everything run inside it.
  * ``time_fn``: wall-clock seconds per call of a callable, warm-up
    excluded, the card synchronised after each call (the work, not its
    enqueue).
  * ``solve_throughput``: the solves/s counter of the bench harnesses.
  * ``annotate``: a named ``record_function`` scope, so that solver phases
    are labelled in traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

from quadruped_springs_tpu_torch.utils.sanitize import _leaves


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Capture a trace of the host and, when `device` (the card unless the
    caller names another) is a CUDA device, of the card, into `log_dir`."""
    device = torch.device(device if device is not None else "cuda")
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace: no CUDA card (pass device='cpu' to trace the host)")
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Label a region in the trace (nested scopes supported)."""
    return record_function(name)


def _block(out) -> None:
    """Wait for the card(s) holding any tensor of `out`."""
    for dev in {t.device for t in _leaves(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Mean wall seconds per call of fn(*args), after `warmup` calls."""
    for _ in range(warmup):
        _block(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        _block(fn(*args))
    return (time.perf_counter() - t0) / iters


def solve_throughput(solve_fn: Callable, batch: int, *args, iters: int = 3) -> dict:
    """Solves/s of a batched solve callable (the bench metric)."""
    dt = time_fn(solve_fn, *args, iters=iters)
    return {"batch": batch, "seconds_per_batch": dt, "solves_per_second": batch / dt}
