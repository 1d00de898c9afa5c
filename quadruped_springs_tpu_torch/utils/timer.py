"""Sim-time countdown timer, the port's own copy of
``quadruped_springs_tpu.utils.timer``.

The reference Timer is a mutable object the landing wrappers use to wait
until the jump apex (start_timer(timer_time=vz/g), time_up()). Here it is
an immutable dataclass of tensors with pure transitions (a tensor of
lanes as `now` gives a timer per lane); the landing wrappers in env/wrappers.py inline the same
arithmetic, and this class serves external control code.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Timer:
    start_time: torch.Tensor   # sim seconds
    end_time: torch.Tensor
    running: torch.Tensor      # bool


def timer_init(device=None) -> Timer:
    """A stopped timer on `device` (the card unless the caller names
    another)."""
    device = torch.device(device if device is not None else "cuda")
    z = torch.zeros((), dtype=torch.float32, device=device)
    return Timer(start_time=z, end_time=z, running=torch.zeros((), dtype=torch.bool,
                                                               device=device))


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def start_timer(t: Timer, now, duration) -> Timer:
    """Arm the countdown at sim time `now` (a number or a tensor of lanes)
    for `duration` seconds."""
    now = _f32(now, t.start_time)
    return Timer(start_time=now, end_time=now + _f32(duration, now),
                 running=torch.ones_like(now, dtype=torch.bool))


def time_up(t: Timer, now) -> torch.Tensor:
    """True once the armed countdown has elapsed."""
    return t.running & (_f32(now, t.end_time) >= t.end_time)


def reset_timer(t: Timer) -> Timer:
    return timer_init(t.running.device)
