"""Offline trajectory renderer: the port of ``quadruped_springs_tpu.utils.render``.

Draws a stick-figure animation of the Go1 (trunk outline and four
three-link legs from the dynamics tree's FK) from one environment of a
recorded rollout (utils/monitor.record_rollout) through a camera track
(utils/camera.py). The skeleton and the projection are tensor functions;
``render_rollout`` imports matplotlib when it is called and writes .mp4
when an ffmpeg binary is available, else .gif (Pillow), else per-frame
PNGs.
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_springs_tpu_torch.models import dynamics as dyn
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.models.go1_params import build_model
from quadruped_springs_tpu_torch.utils import camera as cam

TRUNK_BOX = np.array([  # trunk outline, base frame (x fwd, z up)
    [0.19, 0.0, 0.05], [0.19, 0.0, -0.05],
    [-0.19, 0.0, -0.05], [-0.19, 0.0, 0.05], [0.19, 0.0, 0.05]])


def skeleton_points(q: torch.Tensor, base_pos: torch.Tensor, base_rpy: torch.Tensor):
    """World positions of the drawable skeleton per frame.

    q: (T, 12), base_pos: (T, 3), base_rpy: (T, 3), frames as lanes.
    Returns legs (T, 4, 4, 3), the hip/thigh/calf/foot chain, and trunk
    (T, 5, 3), the trunk outline polyline, in the world frame.
    """
    model = build_model(dtype=q.dtype, device=q.device)
    R = sp.quat_to_mat(sp.rpy_to_quat(base_rpy))
    Rt = R.transpose(-1, -2)
    fk = dyn.leg_fk_base(model, q)
    chain = torch.cat([fk["o"], fk["foot"][:, :, None]], dim=2)       # (T,4,4,3)
    legs = base_pos[:, None, None] + chain @ Rt[:, None]
    box = torch.as_tensor(TRUNK_BOX, dtype=q.dtype, device=q.device)
    trunk = base_pos[:, None] + box @ Rt
    return legs, trunk


def _project(points_w: torch.Tensor, eye: torch.Tensor, target: torch.Tensor):
    """Project world points (..., 3) to 2D image coordinates (..., 2)
    through a look-at camera (weak perspective)."""
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, torch.tensor([0.0, 0.0, 1.0], dtype=fwd.dtype,
                                                  device=fwd.device))
    nr = torch.linalg.norm(right)
    right = right / torch.where(nr > 1e-9, nr, torch.ones_like(nr))
    up = torch.linalg.cross(right, fwd)
    rel = points_w - eye
    x = rel @ right
    y = rel @ up
    z = torch.clamp_min(rel @ fwd, 1e-3)
    return torch.stack([x / z, y / z], dim=-1)


def render_rollout(recs, path: str, camera_mode: str = "CLASSIC",
                   fps: int = 25, stride: int = 2, lane: int = 0) -> str:
    """Render one environment of a recorded rollout to video; returns the
    file written."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as anim
    import matplotlib.pyplot as plt

    valid = recs["valid"][:, lane]
    q = recs["q"][:, lane][valid][::stride].double()
    pos = recs["base_pos"][:, lane][valid][::stride].double()
    rpy = recs["base_rpy"][:, lane][valid][::stride].double()
    if len(q) == 0:
        raise ValueError("empty rollout (no valid steps)")

    legs, trunk = skeleton_points(q, pos, rpy)
    pos_np = pos.cpu().numpy()
    track = cam.make_camera(camera_mode, pos_np)
    eyes = torch.as_tensor(track.eye(), device=q.device)
    targets = torch.as_tensor(track.target, device=q.device)

    T = len(q)
    fig, ax = plt.subplots(figsize=(6, 4.5))
    ax.set_aspect("equal")
    ax.axis("off")

    lines = [ax.plot([], [], "-o", ms=2, lw=2)[0] for _ in range(4)]
    trunk_line, = ax.plot([], [], "k-", lw=2)
    ground_line, = ax.plot([], [], color="0.6", lw=1)

    def draw(i):
        eye, tgt = eyes[i], targets[i]
        # ground reference segment under the robot
        gx = np.linspace(pos_np[i, 0] - 1.2, pos_np[i, 0] + 1.2, 8)
        ground = torch.as_tensor(np.stack([gx, np.full_like(gx, pos_np[i, 1]),
                                           np.zeros_like(gx)], axis=-1), device=q.device)
        pts = [_project(legs[i, l], eye, tgt).cpu().numpy() for l in range(4)]
        ptr = _project(trunk[i], eye, tgt).cpu().numpy()
        ptg = _project(ground, eye, tgt).cpu().numpy()
        for l, line in enumerate(lines):
            line.set_data(pts[l][:, 0], pts[l][:, 1])
        trunk_line.set_data(ptr[:, 0], ptr[:, 1])
        ground_line.set_data(ptg[:, 0], ptg[:, 1])
        allp = np.concatenate(pts + [ptr, ptg])
        ax.set_xlim(allp[:, 0].min() - 0.05, allp[:, 0].max() + 0.05)
        ax.set_ylim(allp[:, 1].min() - 0.05, allp[:, 1].max() + 0.05)
        return lines + [trunk_line, ground_line]

    a = anim.FuncAnimation(fig, draw, frames=T, blit=False)
    try:
        if path.endswith(".mp4") and anim.FFMpegWriter.isAvailable():
            a.save(path, writer=anim.FFMpegWriter(fps=fps))
        else:
            if path.endswith(".mp4"):
                path = path[:-4] + ".gif"
            a.save(path, writer=anim.PillowWriter(fps=fps))
    except (ValueError, RuntimeError, ImportError):
        # last resort: per-frame PNGs next to the requested path
        base = path.rsplit(".", 1)[0]
        for i in range(T):
            draw(i)
            fig.savefig(f"{base}_{i:04d}.png", dpi=80)
        path = f"{base}_0000.png"
    finally:
        plt.close(fig)
    return path
