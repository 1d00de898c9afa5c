"""Carry the JAX package's parameter objects into the port's dataclasses.

Every field is read with ``np.asarray(getattr(obj, name))``, which works on
JAX arrays without importing jax, and lands on the given device as a
tensor; Python scalars, strings and flags stay Python values. The tests use
these converters so that both implementations compute on identical
parameters (e.g. scenarios sampled by jax.random).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quadruped_springs_tpu_torch.control.interfaces import ControlInterface
from quadruped_springs_tpu_torch.env.randomizers import ScenarioParams
from quadruped_springs_tpu_torch.models.dynamics import SimParams
from quadruped_springs_tpu_torch.models.go1_params import (
    SCENARIO_FIELDS,
    Go1Config,
    Go1Model,
)
from quadruped_springs_tpu_torch.solver.ilqr import ILQRConfig, ILQRSolution
from quadruped_springs_tpu_torch.solver.mpc import MPCConfig


def _tensor(obj, name, device):
    return torch.tensor(np.asarray(getattr(obj, name)), device=device)


def _convert(obj, cls, device, python_fields=()):
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        kw[f.name] = v if f.name in python_fields else _tensor(obj, f.name, device)
    return cls(**kw)


def go1_config(cfg, device=None) -> Go1Config:
    return _convert(cfg, Go1Config, device, python_fields=(
        "enable_springs", "is_fallen_height", "init_height",
        "max_motor_angle_change_per_step"))


def go1_model(model, device=None) -> Go1Model:
    """A JAX Go1Model, single (trunk_mass of shape ()) or vmapped over
    scenarios, as the port's batched model (batch 1 for a single one)."""
    out = _convert(model, Go1Model, device, python_fields=("foot_radius",))
    batched = out.trunk_mass.dim() == 1
    shared = {f.name: getattr(out, f.name)[0] for f in dataclasses.fields(Go1Model)
              if batched and f.name not in SCENARIO_FIELDS and f.name != "foot_radius"}
    per_scenario = {} if batched else {
        f: getattr(out, f)[None] for f in SCENARIO_FIELDS}
    return dataclasses.replace(out, **shared, **per_scenario)


def scenario_params(scenario, device=None) -> ScenarioParams:
    """A JAX ScenarioParams, single or vmapped, as a batch of scenarios."""
    out = _convert(scenario, ScenarioParams, device)
    if out.base_mass.dim() == 0:
        out = ScenarioParams(**{f.name: getattr(out, f.name)[None]
                                for f in dataclasses.fields(ScenarioParams)})
    return out


def sim_params(params, device=None) -> SimParams:
    """A JAX SimParams; a per-scenario friction array stays a tensor."""
    kw = {}
    for f in dataclasses.fields(SimParams):
        v = np.asarray(getattr(params, f.name))
        if f.name in ("on_rack", "clamp_damping"):
            kw[f.name] = bool(v)
        elif f.name == "friction" and v.ndim > 0:
            kw[f.name] = torch.tensor(v, device=device)
        else:
            kw[f.name] = float(v)
    return SimParams(**kw)


def control_interface(iface, device=None) -> ControlInterface:
    return _convert(iface, ControlInterface, device, python_fields=(
        "motor_control_mode", "action_space_mode", "action_dim", "symm_idx"))


def _shared_fields(obj, cls):
    """The fields of the port's config dataclass `cls`, read from the JAX
    package's config of the same name (which may hold more)."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def ilqr_config(config) -> ILQRConfig:
    """A JAX ILQRConfig; its scan `unroll` has no counterpart."""
    return _shared_fields(config, ILQRConfig)


def mpc_config(config) -> MPCConfig:
    """A JAX MPCConfig. The bfloat16 linearization is not ported, and the
    scan unroll factors have no counterpart."""
    if config.lin_dtype != "f32":
        raise ValueError(f"lin_dtype {config.lin_dtype!r}: the port linearizes in f32")
    return _shared_fields(config, MPCConfig)


def ilqr_solution(sol, device=None) -> ILQRSolution:
    """A JAX ILQRSolution, single or batched, with a leading batch axis."""
    out = _convert(sol, ILQRSolution, device)
    if out.cost.dim() == 0:
        out = ILQRSolution(**{f.name: getattr(out, f.name)[None]
                              for f in dataclasses.fields(ILQRSolution)})
    return out
