"""Numeric sanitizers: the port of ``quadruped_springs_tpu.utils.sanitize``.

In a batched numeric framework the failure modes are NaN/Inf contamination
and silently diverged scenarios; these helpers surface them without killing
a batch:

  * ``checked(fn)``: run fn and record the first operation that generated a
    NaN from NaN-free inputs (JAX's checkify float checks), returned as an
    inspectable error instead of silent garbage. It reads every result on
    the host, so it is a debugging tool, not a hot path.
  * ``finite_mask(tree)``: per-batch-element all-finite mask over the
    tensors of a nested structure (the divergence mask of
    parallel/scenarios.sharded_solve).
  * ``assert_finite(tree)``: host-side hard assert for tests and debugging.
  * ``debug_nans()``: torch.autograd.detect_anomaly, which raises where a
    backward pass produces a NaN (JAX's jax_debug_nans).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _leaves(tree) -> list:
    """The tensors of a tensor, dataclass, dict, list or tuple, nested."""
    if torch.is_tensor(tree):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _has_nan(tensors) -> bool:
    return any(t.is_floating_point() and bool(torch.isnan(t).any()) for t in tensors)


class CheckError:
    """The outcome of a checked call: `throw()` raises FloatingPointError if
    an operation generated a NaN; `get()` returns the message or None."""

    def __init__(self, message: str | None = None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


class _NanWatch(TorchDispatchMode):
    """Records the first operation whose result holds a NaN that none of its
    inputs held."""

    def __init__(self):
        super().__init__()
        self.message = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.message is None and _has_nan(
                [t for t in tree_leaves(out) if torch.is_tensor(t)]):
            if not _has_nan([t for t in tree_leaves((args, kwargs)) if torch.is_tensor(t)]):
                self.message = f"nan generated by {func}"
        return out


def checked(fn: Callable) -> Callable:
    """fn wrapped to return (CheckError, value)."""
    def wrapper(*args, **kwargs):
        with _NanWatch() as watch:
            value = fn(*args, **kwargs)
        return CheckError(watch.message), value
    return wrapper


def finite_mask(tree, batch_axis: int = 0) -> torch.Tensor:
    """(B,) bool: True where every element of batch member b of every tensor
    in `tree` is finite."""
    masks = []
    for leaf in _leaves(tree):
        axes = tuple(i for i in range(leaf.dim()) if i != batch_axis)
        fin = torch.isfinite(leaf)
        masks.append(fin.all(dim=axes) if axes else fin)
    return torch.stack(masks, dim=0).all(dim=0)


def assert_finite(tree, name: str = "tree") -> None:
    bad = [str(i) for i, leaf in enumerate(_leaves(tree))
           if not bool(torch.isfinite(leaf).all())]
    if bad:
        raise FloatingPointError(
            f"{name}: non-finite values in leaves {', '.join(bad)}")


@contextlib.contextmanager
def debug_nans():
    """Raise where a backward pass inside the scope produces a NaN
    (debugging only: it slows every operation)."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield
