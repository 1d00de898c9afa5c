"""Checkpoint and resume: a nested dict / list of tensors and Python
values in one file, through ``torch.save`` and ``torch.load``."""

from __future__ import annotations

import dataclasses
import os

import torch


def _plain(tree):
    """Dataclasses become dicts and tensors move to the CPU."""
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def save(path: str, tree) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(_plain(tree), path + ".pt")


def restore(path: str, device=None):
    """The saved tree, its tensors on `device`."""
    return torch.load(os.path.abspath(path) + ".pt", map_location=device, weights_only=True)
