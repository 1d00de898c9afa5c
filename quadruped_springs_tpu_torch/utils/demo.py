"""Demonstration rows and reference-state initialisation (RSI).

Port of ``quadruped_springs_tpu.utils.demo``. One row per control step:
[action (filtered), q(12), qd(12), base pos(3), base quat(4), lin vel(3),
ang vel(3), landing flag(1)]. Every function takes a leading axis: rows are
(..., row_dim), and ``demo_robot_state`` gathers N rows of a (T, row_dim)
demo by an index tensor (N,), which gives the batched RobotState that
``QuadrupedEnv.reset(desired_robot_state=...)`` spawns N robots in.
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_springs_tpu_torch.models.dynamics import RobotState


def demo_row(action, robot: RobotState, is_landing) -> torch.Tensor:
    """(N, action_dim + 38) recorded rows; is_landing (N,) bool or float."""
    return torch.cat([action, robot.q, robot.qd, robot.pos, robot.quat, robot.lin_vel,
                      robot.ang_vel, is_landing.to(torch.float32)[..., None]], dim=-1)


def read_demo(row: torch.Tensor, action_dim: int):
    """Split rows (..., row_dim) back into their parts."""
    sizes = [action_dim, 12, 12, 3, 4, 3, 3, 1]
    a, q, qd, pos, quat, lin, ang, landing = torch.split(row, sizes, dim=-1)
    return a, q, qd, pos, quat, lin, ang, landing[..., 0]


def demo_actions(demo: torch.Tensor, action_dim: int) -> torch.Tensor:
    """(T, row) -> (T, action_dim) action matrix for the imitation rewards."""
    return demo[:, :action_dim]


def demo_robot_state(demo: torch.Tensor, idx, action_dim: int) -> RobotState:
    """Robot states at the demo rows idx (N,) (or one int: N = 1)."""
    if not torch.is_tensor(idx):
        idx = torch.tensor([int(idx)], device=demo.device)
    _, q, qd, pos, quat, lin, ang, _ = read_demo(demo[idx.long()], action_dim)
    return RobotState(pos=pos, quat=quat, lin_vel=lin, ang_vel=ang, q=q, qd=qd)


def rsi_index(generator: torch.Generator, demo_len: int, n: int = 1) -> torch.Tensor:
    """RSI sampling for n resets, (n,) int64 on the generator's device: one
    reset in five (p = 0.2) starts within the first 20% of the trajectory,
    the others anywhere in it."""
    dev = generator.device
    early = torch.rand(n, generator=generator, device=dev) < 0.2
    hi = torch.where(early, max(int(demo_len * 0.2), 1), demo_len)
    u = torch.rand(n, generator=generator, device=dev)
    return torch.minimum((u * hi).long(), hi - 1)


def save_demo(path: str, rows) -> None:
    np.save(path, rows.cpu().numpy() if torch.is_tensor(rows) else np.asarray(rows))


def load_demo(path: str) -> np.ndarray:
    return np.load(path)
