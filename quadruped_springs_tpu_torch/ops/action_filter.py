"""Butterworth action low-pass filter, batched over environments.

Port of ``quadruped_springs_tpu.ops.action_filter``: an order-2 low-pass at
3 Hz for the 100 Hz control rate, per action component, with its history
primed by the first action after reset. The IIR update

    y[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2] - a1 y[n-1] - a2 y[n-2]

runs on an explicit state of two (N, 2, d) histories, index 0 the newest.
The coefficients come from scipy in float64 once per filter and are kept as
float32 tensors on the filter's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.signal import butter

ACTION_FILTER_ORDER = 2
ACTION_FILTER_HIGH_CUT = 3.0  # Hz


@dataclasses.dataclass(frozen=True)
class ButterFilterState:
    xhist: torch.Tensor  # (N, order, d), index 0 = newest
    yhist: torch.Tensor  # (N, order, d)


@dataclasses.dataclass(frozen=True)
class ButterFilterCoeffs:
    b: torch.Tensor  # (order+1,)
    a: torch.Tensor  # (order+1,), a[0] normalised to 1


def butter_coeffs(sampling_rate: float, highcut: float = ACTION_FILTER_HIGH_CUT,
                  order: int = ACTION_FILTER_ORDER, device=None) -> ButterFilterCoeffs:
    b, a = butter(order, highcut / (0.5 * sampling_rate), btype="low")
    f32 = lambda x: torch.as_tensor(np.asarray(x) / a[0], dtype=torch.float32,
                                    device=device)
    return ButterFilterCoeffs(b=f32(b), a=f32(a))


def filter_reset(init_action: torch.Tensor) -> ButterFilterState:
    """History primed with the first action (N, d) of every environment."""
    h = init_action[:, None, :].expand(-1, ACTION_FILTER_ORDER, -1).clone()
    return ButterFilterState(xhist=h, yhist=h.clone())


def filter_step(coeffs: ButterFilterCoeffs, state: ButterFilterState, x):
    """One filter step on x (N, d); returns (new_state, y)."""
    y = (coeffs.b[0] * x
         + (coeffs.b[1:, None] * state.xhist).sum(1)
         - (coeffs.a[1:, None] * state.yhist).sum(1))
    new = ButterFilterState(
        xhist=torch.cat([x[:, None], state.xhist[:, :-1]], dim=1),
        yhist=torch.cat([y[:, None], state.yhist[:, :-1]], dim=1))
    return new, y
