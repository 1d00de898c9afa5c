"""Carry the JAX package's parameter objects into the port's dataclasses.

Every field is read with ``np.asarray(getattr(obj, name))``, which works on
JAX arrays without importing jax, and lands on the given device as a
tensor; Python scalars, strings and flags stay Python values. The tests use
these converters so that both implementations compute on identical
parameters (e.g. scenarios sampled by jax.random).

The learning stack's state crosses the same way: running observation
statistics, a flax parameter tree of ``MLPPolicy`` (as numpy) into the
module's ``state_dict``, a whole ``EnvState``; and the loaders of the
committed policy files under ``examples/policies/`` read numpy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quadruped_springs_tpu_torch.control.interfaces import ControlInterface
from quadruped_springs_tpu_torch.env.env import EnvState
from quadruped_springs_tpu_torch.env.randomizers import ScenarioParams
from quadruped_springs_tpu_torch.models.dynamics import RobotState, SimParams
from quadruped_springs_tpu_torch.models.go1_params import (
    SCENARIO_FIELDS,
    Go1Config,
    Go1Model,
)
from quadruped_springs_tpu_torch.solver.ilqr import ILQRConfig, ILQRSolution
from quadruped_springs_tpu_torch.ops.action_filter import ButterFilterState
from quadruped_springs_tpu_torch.solver.mpc import MPCConfig
from quadruped_springs_tpu_torch.tasks.tasks import TaskState
from quadruped_springs_tpu_torch.train.networks import MLPPolicy
from quadruped_springs_tpu_torch.train.normalize import RunningNorm
from quadruped_springs_tpu_torch.utils.lcp_oracle import OracleState


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
    """A JAX MPCConfig; its scan unroll factors have no counterpart."""
    return _shared_fields(config, MPCConfig)


def ilqr_solution(sol, device=None) -> ILQRSolution:
    """A JAX ILQRSolution, single or batched, with a leading batch axis."""
    out = _convert(sol, ILQRSolution, device)
    if out.cost.dim() == 0:
        out = ILQRSolution(**{f.name: getattr(out, f.name)[None]
                              for f in dataclasses.fields(ILQRSolution)})
    return out


def lq_problem(args, device=None, dtype=torch.float32) -> tuple:
    """The LQ subproblem of one JAX problem, (A (H,n,n), B, lx, lu, lxx, luu,
    lux, VxT (n,), VxxT (n,n)), as the port's batch of one: (A (1,H,n,n),
    ..., VxxT (1,n,n)), so that both packages sweep the same arrays."""
    return tuple(torch.tensor(np.asarray(a), dtype=dtype, device=device)[None]
                 for a in args)


def oracle_state(st) -> OracleState:
    """A JAX OracleState (float64 NumPy fields) as the port's, copied."""
    return OracleState(**{f.name: np.array(getattr(st, f.name), np.float64)
                          for f in dataclasses.fields(OracleState)})


# -- the learning stack ------------------------------------------------------

def running_norm(rn, device=None) -> RunningNorm:
    return _convert(rn, RunningNorm, device)


_ENV_STATE_NESTED = {"robot": RobotState, "task": TaskState, "scenario": ScenarioParams,
                     "filter_state": ButterFilterState}


def env_state(state, device=None) -> EnvState:
    """A JAX EnvState, single or stacked by `vmap`, as the port's batched
    EnvState (batch 1 for a single one), every field; the JAX state's PRNG
    key has no counterpart (the port draws from a torch.Generator)."""
    single = np.asarray(state.sim_step_counter).ndim == 0

    def leaf(x):
        t = torch.tensor(np.asarray(x), device=device)
        return t[None] if single else t

    def tree(obj, cls):
        return cls(**{f.name: (tree(getattr(obj, f.name), _ENV_STATE_NESTED[f.name])
                               if cls is EnvState and f.name in _ENV_STATE_NESTED
                               else leaf(getattr(obj, f.name)))
                      for f in dataclasses.fields(cls)})

    return tree(state, EnvState)


def mlp_policy_params(params, device=None) -> dict:
    """A flax parameter tree of MLPPolicy, `{"params": {"pi_0": {"kernel",
    "bias"}, ..., "log_std"}}` of arrays, as the `state_dict` of the port's
    module. A flax Dense kernel is (in, out), an nn.Linear weight (out, in)."""
    tree = params["params"] if "params" in params else params
    out = {}
    for name, leaf in tree.items():
        if name == "log_std":
            out[name] = torch.tensor(np.asarray(leaf), device=device)
        else:
            out[f"{name}.weight"] = torch.tensor(np.asarray(leaf["kernel"]).T.copy(),
                                                 device=device)
            out[f"{name}.bias"] = torch.tensor(np.asarray(leaf["bias"]), device=device)
    return out


def mlp_policy(params, device=None) -> MLPPolicy:
    """The port's module holding a flax parameter tree's values; widths are
    read from the tree."""
    sd = mlp_policy_params(params, device)
    n_hidden = sum(1 for k in sd if k.startswith("pi_") and k.endswith(".bias")) - 1
    hidden = tuple(sd[f"pi_{i}.bias"].shape[0] for i in range(n_hidden))
    net = MLPPolicy(sd["pi_0.weight"].shape[1], sd["log_std"].shape[0], hidden).to(device)
    net.load_state_dict(sd)
    return net


def _norm_from(d, prefix, device):
    return RunningNorm(*(torch.tensor(np.asarray(d[prefix + k], np.float32), device=device)
                         for k in ("mean", "var", "count")))


def load_linear_policy(path, device=None):
    """A committed linear policy (`W`, `mean`, `var`, `count`): (W (A, obs_dim),
    its observation statistics)."""
    d = np.load(path)
    return (torch.tensor(np.asarray(d["W"], np.float32), device=device),
            _norm_from(d, "", device))


def load_small_mlp(path, device=None):
    """A committed one-hidden-layer policy (`W1`, `b1`, `W2`, `b2`): a function
    of normalised observations (N, obs_dim) -> actions (N, A) in [-1, 1], and
    the file's observation statistics."""
    d = np.load(path)
    W1, b1, W2, b2 = (torch.tensor(np.asarray(d[k], np.float32), device=device)
                      for k in ("W1", "b1", "W2", "b2"))

    def apply(o):
        return torch.clamp(torch.tanh(o @ W1.T + b1) @ W2.T + b2, -1.0, 1.0)

    return apply, _norm_from(d, "", device)


# flax flattens a parameter dict by sorted key: `log_std`, then `bias` and
# `kernel` of each Dense
_FLAT_LEAVES = ("log_std",) + tuple(
    (m, leaf) for m in ("pi_0", "pi_1", "pi_out", "vf_0", "vf_1", "vf_out")
    for leaf in ("bias", "kernel"))


def load_flat_mlp_policy(path, device=None):
    """A committed MLPPolicy saved as flattened flax leaves (`n_leaves`,
    `leaf_0..12`, `on_mean`, `on_var`, `on_count`): (module, statistics)."""
    d = np.load(path)
    if int(d["n_leaves"]) != len(_FLAT_LEAVES):
        raise ValueError(f"{path}: {int(d['n_leaves'])} leaves, expected "
                         f"{len(_FLAT_LEAVES)} (a 2-hidden-layer MLPPolicy)")
    tree = {}
    for i, key in enumerate(_FLAT_LEAVES):
        if key == "log_std":
            tree[key] = d[f"leaf_{i}"]
        else:
            tree.setdefault(key[0], {})[key[1]] = d[f"leaf_{i}"]
    return mlp_policy({"params": tree}, device), _norm_from(d, "on_", device)


def save_flat_mlp_policy(path, net: MLPPolicy, obs_norm: RunningNorm) -> None:
    """Write an MLPPolicy and its statistics as flattened flax leaves, the
    layout `load_flat_mlp_policy` (and the JAX package's loader) reads."""
    sd = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    leaves = [sd["log_std"] if key == "log_std" else
              (sd[f"{key[0]}.bias"] if key[1] == "bias" else sd[f"{key[0]}.weight"].T)
              for key in _FLAT_LEAVES]
    np.savez(path, n_leaves=np.asarray(len(leaves)),
             **{f"leaf_{i}": np.ascontiguousarray(x) for i, x in enumerate(leaves)},
             on_mean=obs_norm.mean.cpu().numpy(), on_var=obs_norm.var.cpu().numpy(),
             on_count=obs_norm.count.cpu().numpy())
