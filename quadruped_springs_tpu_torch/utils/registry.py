"""String-keyed registries: the reference's config vocabulary in one place.

Port of ``quadruped_springs_tpu.utils.registry`` over the port's own
registries (task, sensor suite, motor mode, action space, randomizer,
camera), with the same lookup: an unknown key raises a KeyError that lists
the options."""

from __future__ import annotations

from quadruped_springs_tpu_torch.control.interfaces import ACTION_MODES, MOTOR_MODES
from quadruped_springs_tpu_torch.env.randomizers import RANDOMIZER_MODES
from quadruped_springs_tpu_torch.sensors.sensors import SUITES
from quadruped_springs_tpu_torch.tasks.tasks import TASKS
from quadruped_springs_tpu_torch.utils.camera import CAMERA_MODES

REGISTRIES = {
    "task_env": sorted(TASKS),
    "observation_space_mode": sorted(SUITES),
    "motor_control_mode": list(MOTOR_MODES),
    "action_space_mode": list(ACTION_MODES),
    "env_randomizer_mode": sorted(RANDOMIZER_MODES),
    "camera_mode": sorted(CAMERA_MODES),
}


def validate(axis: str, key: str) -> str:
    options = REGISTRIES.get(axis)
    if options is None:
        raise KeyError(f"unknown config axis {axis!r}; axes: {sorted(REGISTRIES)}")
    if key not in options:
        raise KeyError(f"{key!r} is not a registered {axis}; options: {options}")
    return key
