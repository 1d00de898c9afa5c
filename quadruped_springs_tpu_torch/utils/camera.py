"""Camera trajectory computation: the port's own copy of
``quadruped_springs_tpu.utils.camera`` (NumPy only, no change).

Each camera mode of the reference GUI (utils/camera.py:7-122 there: Camera
follow, FixedCamera, BackFlipCamera, ContinuousJumpingForwardCamera) is a
pure function mapping a recorded base-position trajectory (T,3) to
per-frame camera poses (eye, target, distance/yaw/pitch), for offline
rendering of exported trajectories (utils/render.py). The string registry
keeps the ``camera_mode`` config axis ("CLASSIC", "FIXED", "BACKFLIP",
"CONTINUOUS_JUMPING_FORWARD").
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraTrack:
    """Per-frame camera pose: spherical pose around a target point."""
    target: np.ndarray      # (T, 3)
    distance: np.ndarray    # (T,)
    yaw: np.ndarray         # (T,) degrees
    pitch: np.ndarray       # (T,) degrees

    def eye(self) -> np.ndarray:
        """(T,3) camera eye positions from the spherical pose.

        PyBullet convention: negative pitch looks DOWN at the target, so the
        eye must sit above it. The offset is the camera's forward vector
        off = d*[cos(p)cos(y), cos(p)sin(y), sin(p)] and eye = target - off;
        for p<0 this gives eye_z = target_z - d*sin(p) > target_z.
        """
        yaw = np.deg2rad(self.yaw)
        pitch = np.deg2rad(self.pitch)
        d = self.distance
        off = np.stack([
            d * np.cos(pitch) * np.cos(yaw),
            d * np.cos(pitch) * np.sin(yaw),
            d * np.sin(pitch)], axis=-1)
        return self.target - off


def _smooth(x: np.ndarray, alpha: float) -> np.ndarray:
    """First-order lag y[t] = (1-a) y[t-1] + a x[t] (the follow-cam easing)."""
    y = np.array(x, dtype=np.float64, copy=True)
    for t in range(1, len(y)):
        y[t] = (1.0 - alpha) * y[t - 1] + alpha * y[t]
    return y


def classic_camera(base_pos: np.ndarray, distance: float = 1.0,
                   yaw: float = 30.0, pitch: float = -30.0,
                   smoothing: float = 0.15) -> CameraTrack:
    """Follow camera: eased tracking of the base (reference Camera :7-63)."""
    T = len(base_pos)
    target = _smooth(np.asarray(base_pos, np.float64), smoothing)
    return CameraTrack(target=target,
                       distance=np.full(T, distance),
                       yaw=np.full(T, yaw), pitch=np.full(T, pitch))


def fixed_camera(base_pos: np.ndarray, distance: float = 1.5,
                 yaw: float = 30.0, pitch: float = -20.0) -> CameraTrack:
    """Static camera at the episode's initial base position (FixedCamera)."""
    T = len(base_pos)
    target = np.broadcast_to(np.asarray(base_pos[0], np.float64),
                             (T, 3)).copy()
    return CameraTrack(target=target, distance=np.full(T, distance),
                       yaw=np.full(T, yaw), pitch=np.full(T, pitch))


def backflip_camera(base_pos: np.ndarray, distance: float = 1.6,
                    pitch: float = -12.0) -> CameraTrack:
    """Side-on view that keeps the full rotation in frame (BackFlipCamera):
    fixed y-side yaw, target follows x/z but holds the initial height
    midpoint so the flip apex stays visible."""
    p = np.asarray(base_pos, np.float64)
    T = len(p)
    target = p.copy()
    target[:, 2] = 0.5 * (p[:, 2] + np.maximum.accumulate(p[:, 2]))
    return CameraTrack(target=_smooth(target, 0.2),
                       distance=np.full(T, distance),
                       yaw=np.full(T, 90.0), pitch=np.full(T, pitch))


def continuous_jumping_camera(base_pos: np.ndarray, distance: float = 2.0,
                              pitch: float = -15.0) -> CameraTrack:
    """Side-tracking camera that pans with accumulated forward distance
    (ContinuousJumpingForwardCamera)."""
    p = np.asarray(base_pos, np.float64)
    T = len(p)
    target = p.copy()
    target[:, 0] = _smooth(p[:, 0], 0.08)
    target[:, 2] = 0.35
    return CameraTrack(target=target, distance=np.full(T, distance),
                       yaw=np.full(T, 90.0), pitch=np.full(T, pitch))


CAMERA_MODES = {
    "CLASSIC": classic_camera,
    "FIXED": fixed_camera,
    "BACKFLIP": backflip_camera,
    "CONTINUOUS_JUMPING_FORWARD": continuous_jumping_camera,
}


def make_camera(mode: str, base_pos: np.ndarray, **kw) -> CameraTrack:
    """Factory mirroring utils/camera.py make_camera (:100-122)."""
    try:
        fn = CAMERA_MODES[mode]
    except KeyError:
        raise KeyError(
            f"{mode!r} is not a camera mode; options: {sorted(CAMERA_MODES)}"
        ) from None
    return fn(base_pos, **kw)
