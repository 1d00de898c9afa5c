"""Quaternion / SO(3) / spatial (6D) algebra on batch-first tensors.

Port of ``quadruped_springs_tpu.models.spatial`` (what the planner and the
environment use). Same conventions: quaternions xyzw, spatial vectors [angular; linear],
rotation matrices map body to world coordinates. Every function broadcasts
over leading dimensions and keeps the JAX version's operation order, so f32
results agree to rounding.

Small products and sums go through ``mm``, ``mv`` and ``sum_fixed``:
elementwise multiplies and adds in a fixed order. A batched gemm or a
library reduction picks its kernel, and with it its order of summation, by
the number of problems in the batch, so one lane's result would depend in
the last bits on how many lanes share the batch. An elementwise op computes
every element alone, so a sum of elementwise adds in an order fixed by the
code is the same whatever the batch. The order is pairwise (halves added
while the length is even and above 4, then a chain), which takes about
log2(k) launches where a chain takes k - 1: eager PyTorch pays the host's
time per launch, and a 37-term chain would be 36 launches.
"""

from __future__ import annotations

import math

import torch


def sum_fixed(x, dim: int = -1):
    """x summed over `dim` in a fixed order, elementwise adds only (see the
    module docstring): while the length n is even and above 4 the two halves
    are added; an odd length above 4 adds its last term to the sum of the
    rest; 4 or fewer terms are a chain in index order. `dim` is dropped."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n <= 4:
        out = x[0]
        for k in range(1, n):
            out = out + x[k]
        return out
    if n % 2:
        return sum_fixed(x[:n - 1], 0) + x[n - 1]
    return sum_fixed(x[:n // 2] + x[n // 2:], 0)


def mm(A, B):
    """A @ B for small (..., i, k) and (..., k, j), broadcast over leading
    dimensions: the products A[..., i, k] B[..., k, j] in one elementwise
    multiply, summed over k by sum_fixed."""
    return sum_fixed(A[..., :, :, None] * B[..., None, :, :], -2)


def mv(M, v):
    """M @ v for small (..., i, k) and (..., k), as mm does it."""
    return sum_fixed(M * v[..., None, :], -1)


def quat_normalize(q):
    return q / torch.sqrt(sum_fixed(q * q))[..., None]


def quat_conj(q):
    """Conjugate (= inverse for unit quaternions)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_mul(q1, q2):
    """Hamilton product, xyzw layout (q = q1 ⊗ q2)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_rotate(q, v):
    """Rotate v (..., 3) by the unit quaternion q (body -> world for the base)."""
    qv, qw = q[..., :3], q[..., 3:4]
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + qw * t + torch.linalg.cross(qv, t)


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q):
    """(..., 4) xyzw quaternion -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_integrate(q, omega_body, dt: float):
    """q_{t+1} = q_t ⊗ exp(dt·ω_b/2), with the small-angle series below
    |ω|² < 1e-14 (its input sanitised so the unused branch stays finite)."""
    n2 = sum_fixed(omega_body * omega_body)[..., None]
    small = n2 < 1e-14
    angle = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    half = 0.5 * dt * angle
    h2 = (0.5 * dt) ** 2 * n2
    k = torch.where(small, 0.5 * dt * (1.0 - h2 / 6.0), torch.sin(half) / angle)
    c = torch.where(small, 1.0 - h2 / 2.0, torch.cos(half))
    dq = torch.cat([omega_body * k, c], dim=-1)
    return quat_normalize(quat_mul(q, dq))


def quat_to_rpy(q):
    """PyBullet-convention euler angles: R = Rz(yaw) Ry(pitch) Rx(roll)."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def rpy_to_quat(rpy):
    """Inverse of quat_to_rpy."""
    half = 0.5 * rpy
    cr, cp, cy = torch.cos(half).unbind(-1)
    sr, sp, sy = torch.sin(half).unbind(-1)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], dim=-1)


def pitch_unwrapped_yxz(q, switched):
    """Backflip pitch: minus the innermost angle a of R = Rz(c) Rx(b) Ry(a),
    read from the matrix's last row; once the landing controller has
    switched, a negative pitch is unwrapped by +2π."""
    m = quat_to_mat(q)
    pitch = -torch.atan2(-m[..., 2, 0], m[..., 2, 2])
    return torch.where(switched & (pitch < 0), 2 * math.pi + pitch, pitch)


def safe_norm(v, dim: int = -1, eps: float = 1e-12):
    """Euclidean norm with |v|² floored at eps (sqrt(eps) at v = 0)."""
    n2 = sum_fixed(v * v, dim)
    return torch.sqrt(torch.where(n2 < eps, torch.full_like(n2, eps), n2))


def skew(v):
    """(..., 3) -> (..., 3, 3) with skew(a) @ b = a × b."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def spatial_inertia(mass, com, inertia_at_com):
    """6x6 spatial inertia about the frame origin, given the COM offset:
    [[I_com + m c× c×ᵀ, m c×], [m c×ᵀ, m 1]]."""
    c = skew(com)
    mcx = mass[..., None, None] * c
    top_left = inertia_at_com + mm(mcx, c.transpose(-1, -2))
    eye = torch.eye(3, dtype=c.dtype, device=c.device).expand(c.shape)
    m_eye = mass[..., None, None] * eye
    top = torch.cat([top_left, mcx], dim=-1)
    bot = torch.cat([mcx.transpose(-1, -2), m_eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def transform_spatial_inertia(I6, R, p):
    """Express a local spatial inertia in a frame where the local frame sits
    at rotation R, origin p: X I6 Xᵀ with X = [[R, p× R], [0, R]]."""
    top = torch.cat([R, mm(skew(p), R)], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    X = torch.cat([top, bot], dim=-2)
    return mm(mm(X, I6), X.transpose(-1, -2))


def spatial_cross_motion(v, m):
    """v ×ₘ m for motion vector m."""
    w, vo = v[..., :3], v[..., 3:]
    mw, mv = m[..., :3], m[..., 3:]
    return torch.cat([torch.linalg.cross(w, mw),
                      torch.linalg.cross(vo, mw) + torch.linalg.cross(w, mv)],
                     dim=-1)


def spatial_cross_force(v, f):
    """v ×f* f for force vector f."""
    w, vo = v[..., :3], v[..., 3:]
    fw, fv = f[..., :3], f[..., 3:]
    return torch.cat([torch.linalg.cross(w, fw) + torch.linalg.cross(vo, fv),
                      torch.linalg.cross(w, fv)], dim=-1)
