"""Domain randomization as samplers: torch.Generator -> batched ScenarioParams.

Port of ``quadruped_springs_tpu.env.randomizers`` (ranges and sources are
documented there). Where the JAX sampler draws one scenario per key and is
vmapped, ``sample_scenario`` draws a batch of n scenarios from an explicit
``torch.Generator`` on that generator's device. The draws differ from
jax.random's; parity tests feed JAX-sampled scenarios through convert.py.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from quadruped_springs_tpu_torch.models.go1_params import (
    FOOT_MASS,
    LEG_MASSES,
    NUM_LEGS,
    TRUNK_MASS,
    Go1Config,
    build_model,
)

LEG_MASS_ERR = 0.1
SPRING_ERR = (0.1, 0.1, 0.1)
MAX_MASS_OFFSET = 1.0
MAX_POS_MASS_OFFSET = (0.1, 0.0, 0.1)
CURRICULUM_MAX_MASS_OFFSET = 4.0
CURRICULUM_SPRING_ERR = 0.3
FRICTION_RANGE = (0.5, 1.0)


@dataclasses.dataclass(frozen=True)
class ScenarioParams:
    """Everything a scenario can randomize, for a batch of B scenarios."""
    leg_masses: torch.Tensor        # (B,3) hip/thigh/calf (same all legs)
    foot_masses: torch.Tensor       # (B,4)
    base_mass: torch.Tensor         # (B,)
    offset_mass: torch.Tensor       # (B,)
    offset_pos: torch.Tensor        # (B,3)
    spring_stiffness: torch.Tensor  # (B,3)
    spring_damping: torch.Tensor    # (B,3)
    friction: torch.Tensor          # (B,)


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device) -> dict:
    """Range constants on a device, made once (a host copy per reset would
    synchronise the stream)."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float32,
                                  device=device)
    return {"leg_masses": t(LEG_MASSES), "max_pos_offset": t(MAX_POS_MASS_OFFSET),
            "spring_err": t(SPRING_ERR)}


def nominal_params(cfg: Go1Config, n: int = 1) -> ScenarioParams:
    dev = cfg.spring_stiffness.device
    full = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=dev)
    return ScenarioParams(
        leg_masses=_constants(dev)["leg_masses"].expand(n, 3).clone(),
        foot_masses=full((n, NUM_LEGS), FOOT_MASS),
        base_mass=full((n,), TRUNK_MASS),
        offset_mass=full((n,), 0.0),
        offset_pos=full((n, 3), 0.0),
        spring_stiffness=cfg.spring_stiffness.expand(n, 3).clone(),
        spring_damping=cfg.spring_damping.expand(n, 3).clone(),
        friction=full((n,), 1.0),
    )


def _uniform(gen: torch.Generator, shape, lo, hi):
    """U[lo, hi) with lo/hi scalars or tensors broadcasting against shape."""
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return lo + u * (hi - lo)


def _sample_masses(gen, n, level):
    c = _constants(gen.device)
    leg = c["leg_masses"] * _uniform(gen, (n, 3), 1.0 - LEG_MASS_ERR, 1.0 + LEG_MASS_ERR)
    max_offset = MAX_MASS_OFFSET + level * (CURRICULUM_MAX_MASS_OFFSET - MAX_MASS_OFFSET)
    offset_mass = _uniform(gen, (n,), 0.0, max_offset)
    hi = c["max_pos_offset"]
    offset_pos = _uniform(gen, (n, 3), -hi, hi)
    # keep the total mass constant
    total = TRUNK_MASS + 4 * (float(np.sum(LEG_MASSES)) + FOOT_MASS)
    base_mass = total - offset_mass - 4 * leg.sum(-1) - 4 * FOOT_MASS
    return leg, offset_mass, offset_pos, base_mass


def _sample_springs(cfg: Go1Config, gen, n, level):
    e = _constants(gen.device)["spring_err"]
    err = e + level * (CURRICULUM_SPRING_ERR - e)
    k = cfg.spring_stiffness * _uniform(gen, (n, 3), 1 - err, 1 + err)
    d = cfg.spring_damping * _uniform(gen, (n, 3), 1 - err, 1 + err)
    return k, d


RANDOMIZER_MODES = {
    # every mode includes the ground randomizer
    "GROUND_RANDOMIZER": ("ground",),
    "MASS_RANDOMIZER": ("mass", "ground"),
    "SPRING_RANDOMIZER": ("spring", "ground"),
    "TEST_RANDOMIZER": ("mass", "spring", "ground"),
    "TEST_RANDOMIZER_CURRICULUM": ("mass_curriculum", "spring_curriculum", "ground"),
    "NONE": (),
}


def is_curriculum(mode: str) -> bool:
    return any("curriculum" in ax for ax in RANDOMIZER_MODES[mode])


def sample_scenario(cfg: Go1Config, mode: str, generator: torch.Generator,
                    n: int = 1, curriculum_level: float = 0.0) -> ScenarioParams:
    """Sample n scenarios on the generator's device (which must be cfg's)."""
    axes = RANDOMIZER_MODES[mode]
    p = nominal_params(cfg, n)
    level = float(curriculum_level)
    if "mass" in axes or "mass_curriculum" in axes:
        lvl = level if "mass_curriculum" in axes else 0.0
        leg, off_m, off_p, base = _sample_masses(generator, n, lvl)
        p = dataclasses.replace(p, leg_masses=leg, offset_mass=off_m,
                                offset_pos=off_p, base_mass=base)
    if ("spring" in axes or "spring_curriculum" in axes) and cfg.enable_springs:
        lvl = level if "spring_curriculum" in axes else 0.0
        k, d = _sample_springs(cfg, generator, n, lvl)
        p = dataclasses.replace(p, spring_stiffness=k, spring_damping=d)
    if "ground" in axes:
        p = dataclasses.replace(p, friction=_uniform(generator, (n,), *FRICTION_RANGE))
    return p


def model_from_params(p: ScenarioParams):
    """Build the batched dynamics model of a batch of scenarios."""
    return build_model(
        leg_masses=p.leg_masses,
        foot_masses=p.foot_masses,
        base_mass=p.base_mass,
        offset_mass=p.offset_mass,
        offset_pos=p.offset_pos,
    )
