"""Floating-base rigid-body dynamics for Go1, batched over a leading lane axis.

Port of the structured ("ref") path of ``quadruped_springs_tpu.models.dynamics``:
CRBA mass-matrix blocks and RNEA bias forces in base coordinates, the
star-topology Schur solve (four 3x3 leg blocks + one 6x6 base block), 12-site
compliant contact with regularized Coulomb friction and, for the feet,
anchor-spring stiction, joint-limit penalty torques and the semi-implicit
Euler step. Shapes keep the JAX layout with a
lane axis N in front, e.g. body inertias are (N,4,3,6,6). Model fields in
``go1_params.SCENARIO_FIELDS`` carry N lanes or 1 (broadcast).

The memoryless contact law (the planner's) runs as the CUDA kernel
``contact`` of ``csrc/planner_ops.cu`` on CUDA tensors (with the kernel
``contact_jvp`` as its forward-mode tangent) and as ``contact_forces_plain``
on CPU tensors; the environment's law with
foot-anchor stiction runs as the kernel ``contact_anchored`` and as
``contact_forces_anchored_plain``. The 3x3 and 6x6 solves are closed form
(adjugate and unrolled Cholesky, as in ``dynamics_soa.py``), which keeps them
free of library calls and host synchronisation.

Conventions: quaternions xyzw; spatial vectors [angular; linear]; the
generalized velocity is u = [ω_b(3); v_b(3); qd(12)] in the base frame.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from quadruped_springs_tpu_torch import kernels
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.models.go1_params import Go1Model

# Real actuator joint limits used for the limit penalties.
REAL_LOWER = np.array([-1.0471975512, -0.663225115758, -2.72271363311] * 4)
REAL_UPPER = np.array([1.0471975512, 2.96705972839, -0.837758040957] * 4)

KNEE_RADIUS = 0.008
TRUNK_RADIUS = 0.055
TRUNK_CORNERS = np.array([
    [0.18, 0.065, 0.0], [0.18, -0.065, 0.0],
    [-0.18, 0.065, 0.0], [-0.18, -0.065, 0.0],
])
N_SITES = 12  # 4 feet + 4 knees + 4 trunk corners


@dataclasses.dataclass(frozen=True)
class RobotState:
    """Dynamic state of N robots (world-frame quantities)."""
    pos: torch.Tensor        # (N,3) base origin
    quat: torch.Tensor       # (N,4) xyzw, base->world
    lin_vel: torch.Tensor    # (N,3) base origin velocity
    ang_vel: torch.Tensor    # (N,3) angular velocity
    q: torch.Tensor          # (N,12) joint angles
    qd: torch.Tensor         # (N,12) joint velocities


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Contact / integration parameters. `friction` is a float or an (N,)
    tensor of per-lane friction coefficients."""
    dt: float = 0.001
    contact_stiffness: float = 180000.0   # N/m
    contact_damping: float = 100.0        # N s/m
    friction: float | torch.Tensor = 1.0
    slip_vel_tol: float = 0.02
    joint_limit_stiffness: float = 300.0
    joint_limit_damping: float = 3.0
    on_rack: bool = False
    # clamp |d·φ̇| <= k·φ in the normal force (stiff execution model only)
    clamp_damping: bool = True
    # tangential anchor springs of the feet (stiction); read only when a
    # foot_anchor state is passed to step()
    tangential_stiffness: float = 120000.0  # N/m
    tangential_damping: float = 60.0        # N s/m


def default_sim_params(dt: float = 0.001, on_rack: bool = False) -> SimParams:
    """The 1 kHz simulator's contact constants (tuning notes in the JAX module)."""
    return SimParams(dt=dt, on_rack=on_rack)


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device, dtype: torch.dtype, foot_radius: float):
    """Constant tensors on a device, made once: building them per call would
    copy from the host, which synchronises a CUDA stream."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
    return {
        "real_lower": t(REAL_LOWER),
        "real_upper": t(REAL_UPPER),
        "trunk_corners": t(TRUNK_CORNERS),
        "radii": t([foot_radius] * 4 + [KNEE_RADIUS] * 4 + [TRUNK_RADIUS] * 4),
        "x_axis": t([1.0, 0.0, 0.0]),
        "triu3": torch.ones(3, 3, dtype=torch.bool, device=device).triu(),
    }


def _consts(model: Go1Model, like: torch.Tensor):
    return _constants(like.device, like.dtype, model.foot_radius)


def _rmatvec(M, v):
    """Mᵀ v."""
    return sp.mv(M.transpose(-1, -2), v)


# ---------------------------------------------------------------------------
# Forward kinematics of the dynamics tree (base frame)
# ---------------------------------------------------------------------------

def _rot_x(t):
    c, s = torch.cos(t), torch.sin(t)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    return torch.stack([one, zero, zero, zero, c, -s, zero, s, c],
                       dim=-1).reshape(t.shape + (3, 3))


def _rot_y(t):
    c, s = torch.cos(t), torch.sin(t)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    return torch.stack([c, zero, s, zero, one, zero, -s, zero, c],
                       dim=-1).reshape(t.shape + (3, 3))


def leg_fk_base(model: Go1Model, q: torch.Tensor):
    """FK of all legs in the base frame for q (N,12).

    Returns dict with R (N,4,3,3,3) body rotations (hip, thigh, calf),
    o (N,4,3,3) body origins, axes (N,4,3,3) joint axes, foot (N,4,3).
    """
    ql = q.reshape(q.shape[0], 4, 3)
    R1 = _rot_x(ql[..., 0])                    # (N,4,3,3)
    R2 = sp.mm(R1, _rot_y(ql[..., 1]))
    R3 = sp.mm(R2, _rot_y(ql[..., 2]))
    o1 = model.hip_origins.expand(q.shape[0], 4, 3)
    o2 = o1 + sp.mv(R1, model.thigh_origins)
    o3 = o2 + sp.mv(R2, model.calf_origin)
    foot = o3 + sp.mv(R3, model.foot_origin)
    a1 = _consts(model, q)["x_axis"].expand(q.shape[0], 4, 3)
    a2 = R1[..., :, 1]                         # thigh axis: y of the hip frame
    a3 = R2[..., :, 1]                         # calf axis: y of the thigh frame
    return {"R": torch.stack([R1, R2, R3], dim=2),
            "o": torch.stack([o1, o2, o3], dim=2),
            "axes": torch.stack([a1, a2, a3], dim=2),
            "foot": foot}


def _motion_subspaces(fk):
    """Plücker motion axes s = [a; o × a] per joint, base coords. (N,4,3,6)."""
    a, o = fk["axes"], fk["o"]
    return torch.cat([a, torch.linalg.cross(o, a)], dim=-1)


def mass_matrix_blocks(model: Go1Model, q: torch.Tensor, fk=None):
    """CRBA in base coordinates, in star-topology block form.

    Returns A (N,6,6) base block, B (N,4,6,3) base-leg coupling, D (N,4,3,3)
    leg blocks, and fk/s for reuse; fk gains "I", the body inertias about
    the base origin (N,4,3,6,6), which bias_forces reads.
    """
    if fk is None:
        fk = leg_fk_base(model, q)
    s = _motion_subspaces(fk)
    I_b = sp.transform_spatial_inertia(model.leg_inertias6, fk["R"], fk["o"])
    fk = dict(fk, I=I_b)
    Ic2 = I_b[:, :, 2]
    Ic1 = I_b[:, :, 1] + Ic2
    Ic0 = I_b[:, :, 0] + Ic1
    Ic = torch.stack([Ic0, Ic1, Ic2], dim=2)
    F = sp.mv(Ic, s)                         # F[j] = Ic[j] s[j], (N,4,3,6)
    B = F.transpose(-1, -2)                    # (N,4,6,3)
    D = sp.mm(s, F.transpose(-1, -2))          # D[i,j] = s_i . F_j, valid j >= i
    D = torch.where(_consts(model, q)["triu3"], D, D.transpose(-1, -2))
    A = model.trunk_inertia6 + sp.sum_fixed(Ic0, 1)
    return A, B, D, fk, s


def bias_forces(model: Go1Model, state_rot, u, fk, s):
    """RNEA with qdd=0 and the gravity trick (a_root = [0; -Rᵀg]).

    state_rot: (N,3,3) base rotation. u: (N,18) generalized velocity.
    fk and s come from mass_matrix_blocks (fk["I"]: body inertias in base
    coordinates). Returns h: (N,18) bias force (Coriolis + centrifugal +
    gravity).
    """
    n = u.shape[0]
    v0 = u[:, :6]
    qd = u[:, 6:].reshape(n, 4, 3)
    I_legs = fk["I"]

    v1 = v0[:, None] + s[:, :, 0] * qd[:, :, 0:1]
    v2 = v1 + s[:, :, 1] * qd[:, :, 1:2]
    v3 = v2 + s[:, :, 2] * qd[:, :, 2:3]
    v = torch.stack([v1, v2, v3], dim=2)       # (N,4,3,6)

    g_base = _rmatvec(state_rot, model.gravity)
    a0 = torch.cat([torch.zeros_like(g_base), -g_base], dim=-1)
    a1 = a0[:, None] + sp.spatial_cross_motion(v1, s[:, :, 0]) * qd[:, :, 0:1]
    a2 = a1 + sp.spatial_cross_motion(v2, s[:, :, 1]) * qd[:, :, 1:2]
    a3 = a2 + sp.spatial_cross_motion(v3, s[:, :, 2]) * qd[:, :, 2:3]
    a = torch.stack([a1, a2, a3], dim=2)

    Iv = sp.mv(I_legs, v)
    f = sp.mv(I_legs, a) + sp.spatial_cross_force(v, Iv)
    f2 = f[:, :, 2]
    f1 = f[:, :, 1] + f2
    f0 = f[:, :, 0] + f1
    f_acc = torch.stack([f0, f1, f2], dim=2)
    h_joints = sp.sum_fixed(s * f_acc).reshape(n, 12)

    Itv = sp.mv(model.trunk_inertia6, v0)
    f_trunk = sp.mv(model.trunk_inertia6, a0) + sp.spatial_cross_force(v0, Itv)
    h_base = f_trunk + sp.sum_fixed(f0, 1)
    return torch.cat([h_base, h_joints], dim=-1)


def _inv3(M):
    """Inverse of (...,3,3) M: the columns are cross products of its rows
    over the determinant (the adjugate)."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = torch.linalg.cross(r1, r2)
    det = sp.sum_fixed(r0 * c0)
    adj = torch.stack([c0, torch.linalg.cross(r2, r0), torch.linalg.cross(r0, r1)],
                      dim=-1)
    return adj / det[..., None, None]


def _chol6_solve(S, b):
    """Solve S x = b for symmetric (N,6,6) S by an unrolled Cholesky whose
    pivots are floored at 1e-12, as dynamics_soa.chol6_solve does."""
    n = S.shape[-1]
    cols = []                                  # cols[j] = L[j:, j], (N, n-j)
    M = S
    for j in range(n):
        d = torch.sqrt(torch.clamp_min(M[:, 0, 0], 1e-12))
        col = torch.cat([d[:, None], M[:, 1:, 0] * (1.0 / d)[:, None]], dim=-1)
        cols.append(col)
        if j < n - 1:
            M = M[:, 1:, 1:] - col[:, 1:, None] * col[:, None, 1:]
    y = b
    ys = []
    for j in range(n):                         # forward: L y = b
        yj = y[:, 0] / cols[j][:, 0]
        ys.append(yj)
        y = y[:, 1:] - cols[j][:, 1:] * yj[:, None]
    xs = [None] * n
    for i in reversed(range(n)):               # back: Lᵀ x = y
        acc = ys[i]
        for k in range(i + 1, n):
            acc = acc - cols[i][:, k - i] * xs[k]
        xs[i] = acc / cols[i][:, 0]
    return torch.stack(xs, dim=-1)


def solve_star(A, B, D, rhs_base, rhs_joints, eps: float = 1e-9):
    """Solve [[A, B],[Bᵀ, D]] [a0; qdd] = [rhs_base; rhs_joints] with D
    block-diagonal per leg. A (N,6,6), B (N,4,6,3), D (N,4,3,3)."""
    n = A.shape[0]
    eye3 = torch.eye(3, dtype=A.dtype, device=A.device)
    eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
    Dinv = _inv3(D + eps * eye3)                         # (N,4,3,3)
    rj = rhs_joints.reshape(n, 4, 3)
    BDinv = sp.mm(B, Dinv)                               # (N,4,6,3)
    S = A - sp.sum_fixed(sp.mm(BDinv, B.transpose(-1, -2)), 1)   # 6x6 Schur complement
    t = rhs_base - sp.sum_fixed(sp.mv(BDinv, rj), 1)
    a0 = _chol6_solve(S + eps * eye6, t)
    qdd = sp.mv(Dinv, rj - _rmatvec(B, a0[:, None]))
    return a0, qdd.reshape(n, 12)


# ---------------------------------------------------------------------------
# Contact: 4 foot spheres, 4 knee spheres, 4 trunk corners
# ---------------------------------------------------------------------------

def contact_sites(model: Go1Model, fk):
    """Base-frame positions (N,12,3) and radii (12,) of the collision sites."""
    feet = fk["foot"]
    c = _consts(model, feet)
    trunk = c["trunk_corners"].expand(feet.shape[0], 4, 3)
    return torch.cat([feet, fk["o"][:, :, 2], trunk], dim=1), c["radii"]


def site_state_world(model: Go1Model, state: RobotState, fk=None, R=None):
    """World positions and velocities (N,12,3) of the 12 collision sites."""
    if fk is None:
        fk = leg_fk_base(model, state.q)
    if R is None:
        R = sp.quat_to_mat(state.quat)
    n = state.q.shape[0]
    pts_b, radii = contact_sites(model, fk)
    Rt = R.transpose(-1, -2)
    p_w = state.pos[:, None] + sp.mm(pts_b, Rt)
    w_b = _rmatvec(R, state.ang_vel)
    v_b = _rmatvec(R, state.lin_vel)
    qd = state.qd.reshape(n, 4, 3)
    # joint contribution Σ_i a_i × (p - o_i) qd_i for the feet and knees of
    # each leg; zero for the trunk corners
    leg_pts = pts_b[:, :8].reshape(n, 2, 4, 3)
    arm = leg_pts[:, :, :, None, :] - fk["o"][:, None]           # (N,2,4,3,3)
    Jqd = sp.sum_fixed(torch.linalg.cross(fk["axes"][:, None].expand_as(arm), arm)
                       * qd[:, None, :, :, None], 3).reshape(n, 8, 3)
    Jqd = torch.cat([Jqd, torch.zeros_like(Jqd[:, :4])], dim=1)
    v_pt_b = v_b[:, None] + torch.linalg.cross(w_b[:, None].expand_as(pts_b), pts_b) + Jqd
    return p_w, sp.mm(v_pt_b, Rt), radii, fk


def foot_state_world(model: Go1Model, state: RobotState, fk=None):
    """World positions and velocities (N,4,3) of the 4 foot centres."""
    p_w, v_w, _, fk = site_state_world(model, state, fk)
    return p_w[:, :4], v_w[:, :4], fk


def contact_forces_plain(phi, v_w, mu, kn: float, dn: float, v_tol: float,
                         clamp_damping: bool):
    """Compliant normal force + viscous-regularized Coulomb friction.

    phi: (N,12) penetration depth. v_w: (N,12,3) world site velocities.
    mu: float or (N,) per lane. Returns f_world (N,12,3), fn (N,12),
    in_contact (N,12). The plain twin of the `contact` CUDA kernel;
    bfloat16 phi, v_w and mu are upcast, run through the f32 law and the
    forces rounded to bf16, as the kernel's bf16 variant computes.
    """
    if phi.dtype == torch.bfloat16:
        f_world, fn, in_contact = contact_forces_plain(
            phi.float(), v_w.float(), mu.float() if torch.is_tensor(mu) else mu, kn, dn,
            v_tol, clamp_damping)
        return f_world.to(phi.dtype), fn.to(phi.dtype), in_contact
    in_contact = phi > 0.0
    elastic = kn * phi
    damping = dn * (-v_w[..., 2])
    if clamp_damping:
        damping = torch.clamp(damping, -elastic, elastic)
    fn = torch.where(in_contact, torch.clamp_min(elastic + damping, 0.0),
                     torch.zeros_like(phi))
    vt = v_w[..., :2]
    n2 = sp.sum_fixed(vt * vt)
    vt_norm = torch.sqrt(torch.where(n2 < 1e-12, torch.full_like(n2, 1e-12), n2))
    if torch.is_tensor(mu):
        mu = mu[..., None]
    scale = mu * fn / torch.clamp_min(vt_norm, v_tol)
    f_world = torch.cat([-scale[..., None] * vt, fn[..., None]], dim=-1)
    return f_world, fn, in_contact


def contact_forces_anchored_plain(phi, v_w, foot_xy, foot_anchor, mu, kn: float,
                                  dn: float, kt: float, ct: float, v_tol: float,
                                  clamp_damping: bool):
    """The environment's contact law: contact_forces_plain at every site,
    then anchor-spring stiction (Cundall / bristle) at the feet 0-3.

    foot_xy, foot_anchor: (N,4,2) world xy of the feet and their anchors.
    A foot's trial force -kt (p - a) - ct v is clipped to the cone μ·fn;
    inside the cone the anchor stays, on its boundary the anchor slides so
    that the spring term alone gives the clipped force, and out of contact
    the foot re-anchors where it is. Returns (f_world (N,12,3), fn (N,12),
    in_contact (N,12), new_anchor (N,4,2)). |f_trial|² is floored at 1e-12
    as in the JAX structured ("ref") path. The plain twin of the
    `contact_anchored` CUDA kernel.
    """
    f_world, fn, in_contact = contact_forces_plain(phi, v_w, mu, kn, dn, v_tol,
                                                   clamp_damping)
    f_trial = -kt * (foot_xy - foot_anchor) - ct * v_w[:, :4, :2]
    f_norm = sp.safe_norm(f_trial)        # >= 1e-6 through the floor
    fmax = (mu[..., None] if torch.is_tensor(mu) else mu) * fn[:, :4]
    # min, not clamp_max: its derivative at a tie is one half, as
    # jnp.minimum(1.0, ...)'s is (quadruped_springs_tpu/models/dynamics.py:364)
    ratio = fmax / f_norm
    clip_scale = torch.minimum(ratio, torch.ones_like(ratio))
    f_foot = f_trial * clip_scale[..., None]
    a_slid = foot_xy + f_foot / kt
    new_anchor = torch.where((clip_scale < 1.0)[..., None], a_slid, foot_anchor)
    inc = in_contact[:, :4, None]
    new_anchor = torch.where(inc, new_anchor, foot_xy)
    f_foot = torch.where(inc, f_foot, torch.zeros_like(f_foot))
    f_world = torch.cat([torch.cat([f_foot, f_world[:, :4, 2:]], dim=-1),
                         f_world[:, 4:]], dim=1)
    return f_world, fn, in_contact, new_anchor


def _check_contact_primals(phi, v_w, mu):
    n, dev = phi.shape[0], phi.device
    for name, t, shape in (("phi", phi, (n, N_SITES)), ("v_w", v_w, (n, N_SITES, 3)),
                           ("friction", mu, (n,))):
        kernels.check_tensor(name, t, shape, dev, phi.dtype)
    return n, dev


def _launch_contact(phi, v_w, mu, kn: float, dn: float, v_tol: float,
                    clamp_damping: bool):
    """Launch the `contact` kernel: (f_world (N,12,3), fn (N,12),
    in_contact (N,12))."""
    n, dev = _check_contact_primals(phi, v_w, mu)
    f_world = torch.empty_like(v_w)
    fn = torch.empty_like(phi)
    in_contact = torch.empty(phi.shape, dtype=torch.bool, device=dev)
    if n == 0:
        return f_world, fn, in_contact
    with torch.cuda.device(dev):
        err = kernels.entry("planner_contact", phi.dtype)(
            phi.data_ptr(), v_w.data_ptr(), mu.data_ptr(), float(kn), float(dn),
            float(v_tol), int(clamp_damping), f_world.data_ptr(), fn.data_ptr(),
            in_contact.data_ptr(), n, kernels.stream_handle(dev))
    kernels.check_launch("planner_contact", err)
    if phi.dtype == torch.float32:
        contact_forces.launches += 1
    else:
        contact_forces.bf16_launches += 1
    return f_world, fn, in_contact


def _launch_contact_jvp(phi, v_w, mu, dphi, dv_w, kn: float, dn: float, v_tol: float,
                        clamp_damping: bool):
    """Launch the `contact_jvp` kernel on the primals of `contact` and the
    tangents dphi (T,N,12), dv_w (T,N,12,3): df_world (T,N,12,3)."""
    n, dev = _check_contact_primals(phi, v_w, mu)
    n_tangents = dphi.shape[0]
    kernels.check_tensor("dphi", dphi, (n_tangents, n, N_SITES), dev, phi.dtype)
    kernels.check_tensor("dv_w", dv_w, (n_tangents, n, N_SITES, 3), dev, phi.dtype)
    df_world = torch.empty_like(dv_w)
    if n == 0 or n_tangents == 0:
        return df_world
    with torch.cuda.device(dev):
        err = kernels.entry("planner_contact_jvp", phi.dtype)(
            phi.data_ptr(), v_w.data_ptr(), mu.data_ptr(), float(kn), float(dn),
            float(v_tol), int(clamp_damping), dphi.data_ptr(), dv_w.data_ptr(),
            df_world.data_ptr(), n, n_tangents, kernels.stream_handle(dev))
    kernels.check_launch("planner_contact_jvp", err)
    if phi.dtype == torch.float32:
        contact_forces.jvp_launches += 1
    else:
        contact_forces.bf16_jvp_launches += 1
    return df_world


class _ContactJvp(torch.autograd.Function):
    """The `contact_jvp` kernel: phi, v_w, mu, then dphi, dv_w with the
    tangent directions leading, then the contact constants."""

    @staticmethod
    def forward(phi, v_w, mu, dphi, dv_w, kn, dn, v_tol, clamp_damping):
        return _launch_contact_jvp(phi, v_w, mu, dphi, dv_w, kn, dn, v_tol, clamp_damping)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, phi, v_w, mu, dphi, dv_w, *constants):
        tangents = kernels.stack_tangents(info, in_dims, (dphi, dv_w), 3)
        df = _ContactJvp.apply(phi, v_w, mu, *tangents, *constants)
        return df.reshape(info.batch_size, -1, *df.shape[1:]), 0

    @staticmethod
    def backward(ctx, *grads):
        kernels.no_backward("contact_jvp")


class _Contact(torch.autograd.Function):
    """The `contact` kernel with its forward-mode rule."""

    @staticmethod
    def forward(phi, v_w, mu, kn, dn, v_tol, clamp_damping):
        return _launch_contact(phi, v_w, mu, kn, dn, v_tol, clamp_damping)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:3])
        ctx.set_materialize_grads(False)   # a missing tangent stays None
        ctx.constants = inputs[3:]
        ctx.mark_non_differentiable(output[2])

    @staticmethod
    def jvp(ctx, dphi, dv_w, dmu, *constants):
        if dmu is not None:
            raise NotImplementedError("contact_forces: the tangent of the friction "
                                      "coefficient is not implemented")
        phi, v_w, mu = ctx.saved_tensors
        df = _ContactJvp.apply(
            phi, v_w, mu, kernels.tangent_or_zeros(dphi, phi)[None].contiguous(),
            kernels.tangent_or_zeros(dv_w, v_w)[None].contiguous(), *ctx.constants)[0]
        return df, df[..., 2], None

    @staticmethod
    def vmap(info, in_dims, *args):
        kernels.no_primal_vmap("contact_forces")

    @staticmethod
    def backward(ctx, *grads):
        kernels.no_backward("contact_forces")


def _contact_forces_plain(params: SimParams, p_w, v_w, radii, foot_anchor=None):
    """contact_forces through the plain twins, on any device."""
    phi = radii - p_w[..., 2]
    mu, kn, dn = params.friction, params.contact_stiffness, params.contact_damping
    if foot_anchor is None:
        return (*contact_forces_plain(phi, v_w, mu, kn, dn, params.slip_vel_tol,
                                      params.clamp_damping), None)
    return contact_forces_anchored_plain(
        phi, v_w, p_w[:, :4, :2], foot_anchor, mu, kn, dn, params.tangential_stiffness,
        params.tangential_damping, params.slip_vel_tol, params.clamp_damping)


def contact_forces(model: Go1Model, params: SimParams, p_w, v_w, radii,
                   foot_anchor=None):
    """Compliant contact at the 12 sites.

    p_w, v_w: (N,12,3); radii: (12,). Without foot_anchor: the memoryless
    law of the planner, returning (f_world (N,12,3), fn (N,12), in_contact
    (N,12), None). With foot_anchor (N,4,2) world-xy anchors: the feet get
    anchor stiction and the fourth result is the new anchors (N,4,2). CUDA
    tensors launch the `contact` or `contact_anchored` kernel; CPU tensors
    take the plain twins. The memoryless law is differentiable in forward
    mode (on the card through the `contact_jvp` kernel); reverse mode
    through the kernel raises.
    """
    if p_w.device.type == "cpu":
        return _contact_forces_plain(params, p_w, v_w, radii, foot_anchor)
    phi = radii - p_w[..., 2]
    mu, kn, dn = params.friction, params.contact_stiffness, params.contact_damping
    if phi.device.type != "cuda":
        raise ValueError(f"contact_forces: no kernel for device {phi.device}")
    n = phi.shape[0]
    dev = phi.device
    if not torch.is_tensor(mu):
        mu = torch.full((n,), float(mu), dtype=phi.dtype, device=dev)
    if foot_anchor is None:
        return (*_Contact.apply(phi, v_w, mu, float(kn), float(dn),
                                float(params.slip_vel_tol), bool(params.clamp_damping)),
                None)
    _check_contact_primals(phi, v_w, mu)
    f_world = torch.empty_like(v_w)
    fn = torch.empty_like(phi)
    in_contact = torch.empty(phi.shape, dtype=torch.bool, device=dev)
    kernels.check_tensor("p_w", p_w, (n, N_SITES, 3), dev)
    kernels.check_tensor("foot_anchor", foot_anchor, (n, 4, 2), dev)
    new_anchor = torch.empty_like(foot_anchor)
    if n == 0:
        return f_world, fn, in_contact, new_anchor
    with torch.cuda.device(dev):
        err = kernels.library().planner_contact_anchored(
            phi.data_ptr(), v_w.data_ptr(), p_w.data_ptr(), foot_anchor.data_ptr(),
            mu.data_ptr(), float(kn), float(dn), float(params.tangential_stiffness),
            float(params.tangential_damping), float(params.slip_vel_tol),
            int(params.clamp_damping), f_world.data_ptr(), fn.data_ptr(),
            in_contact.data_ptr(), new_anchor.data_ptr(), n, kernels.stream_handle(dev))
    kernels.check_launch("planner_contact_anchored", err)
    contact_forces.anchored_launches += 1
    return f_world, fn, in_contact, new_anchor


contact_forces.launches = 0            # `contact` kernel
contact_forces.jvp_launches = 0        # `contact_jvp` kernel
contact_forces.bf16_launches = 0       # their bf16 storage variants
contact_forces.bf16_jvp_launches = 0
contact_forces.anchored_launches = 0   # `contact_anchored` kernel


def _generalized_contact_force(model: Go1Model, fk, s, R, f_world):
    """Map world site forces (N,12,3) to generalized forces in base coords.

    Feet (0-3) and knees (4-7) ride on the calf bodies, so all three joints
    of their leg receive s_iᵀ f; trunk corners (8-11) give a base wrench only.
    """
    f_b = sp.mm(f_world, R)                              # world -> base
    pts, _ = contact_sites(model, fk)
    f_spatial = torch.cat([torch.linalg.cross(pts, f_b), f_b], dim=-1)  # (N,12,6)
    f_legs = f_spatial[:, :4] + f_spatial[:, 4:8]
    tau_joints = sp.mv(s, f_legs).reshape(f_world.shape[0], 12)
    return sp.sum_fixed(f_spatial, 1), tau_joints


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def _forward(model, params, state, tau, R, ext_force_world=None, foot_anchor=None,
             plain=False):
    """forward_dynamics with the base rotation given; also returns w_b, v_b."""
    w_b = _rmatvec(R, state.ang_vel)
    v_b = _rmatvec(R, state.lin_vel)
    u = torch.cat([w_b, v_b, state.qd], dim=-1)

    A, B, D, fk, s = mass_matrix_blocks(model, state.q)
    h = bias_forces(model, R, u, fk, s)

    p_w, v_w, radii, _ = site_state_world(model, state, fk, R)
    if plain:   # the plain version of a fused kernel that contains this law
        f_world, fn, in_contact, new_anchor = _contact_forces_plain(params, p_w, v_w, radii,
                                                                    foot_anchor)
    else:
        f_world, fn, in_contact, new_anchor = contact_forces(model, params, p_w, v_w, radii,
                                                            foot_anchor)
    f_base_c, tau_c = _generalized_contact_force(model, fk, s, R, f_world)

    # joint-limit penalty torques
    c = _consts(model, state.q)
    over = torch.clamp_min(state.q - c["real_upper"], 0.0)
    under = torch.clamp_min(c["real_lower"] - state.q, 0.0)
    tau_lim = (-params.joint_limit_stiffness * over
               + params.joint_limit_stiffness * under
               - params.joint_limit_damping * state.qd * ((over > 0) | (under > 0)))

    rhs_base = -h[:, :6] + f_base_c
    if ext_force_world is not None:
        f_ext_b = _rmatvec(R, ext_force_world)
        rhs_base = rhs_base + torch.cat([torch.zeros_like(f_ext_b), f_ext_b], dim=-1)
    rhs_joints = tau + tau_c + tau_lim - h[:, 6:]
    n = state.q.shape[0]
    if params.on_rack:
        # base welded in the air: a0 ≡ 0 and the legs decouple
        a0 = torch.zeros_like(rhs_base)
        eye3 = torch.eye(3, dtype=D.dtype, device=D.device)
        qdd = sp.mv(_inv3(D + 1e-9 * eye3), rhs_joints.reshape(n, 4, 3))
        qdd = qdd.reshape(n, 12)
    else:
        a0, qdd = solve_star(A, B, D, rhs_base, rhs_joints)
    info = {
        "foot_pos_world": p_w[:, :4],
        "foot_vel_world": v_w[:, :4],
        "foot_forces": fn[:, :4],
        "feet_in_contact": in_contact[:, :4],
        "contact_force_world": f_world[:, :4],
        # non-foot ground contact = the invalid-contact termination surface
        "invalid_contact": in_contact[:, 4:].any(dim=-1),
    }
    if new_anchor is not None:
        info["new_anchor"] = new_anchor
    return a0, qdd, info, w_b, v_b


def forward_dynamics(model: Go1Model, params: SimParams, state: RobotState,
                     tau, ext_force_world=None, foot_anchor=None):
    """One evaluation of the equations of motion for N lanes.

    tau: (N,12) joint torques (motor + spring). ext_force_world: optional
    (N,3) force at the trunk origin. foot_anchor: optional (N,4,2) world-xy
    stiction anchors of the feet (see contact_forces); with it, info carries
    "new_anchor". Returns (a0 (N,6), qdd (N,12), info).
    """
    R = sp.quat_to_mat(state.quat)
    a0, qdd, info, _, _ = _forward(model, params, state, tau, R,
                                   ext_force_world, foot_anchor)
    return a0, qdd, info


def step(model: Go1Model, params: SimParams, state: RobotState, tau,
         velocity_limits, ext_force_world=None, foot_anchor=None, plain: bool = False):
    """Semi-implicit Euler step at params.dt, joint velocities clamped to
    ±velocity_limits. With foot_anchor (N,4,2) the feet use anchor stiction
    and info["new_anchor"] carries the updated anchors. `plain`: the contact
    law's plain twin on any device (env_substeps_plain). Returns
    (new_state, info)."""
    R = sp.quat_to_mat(state.quat)
    a0, qdd, info, w_b, v_b = _forward(model, params, state, tau, R,
                                       ext_force_world, foot_anchor, plain)
    dt = params.dt
    w_b = w_b + dt * a0[:, :3]
    v_b = v_b + dt * a0[:, 3:]
    # min(max()), not clamp: jnp.clip's derivative at a tie, one half
    qd = torch.minimum(torch.maximum(state.qd + dt * qdd, -velocity_limits), velocity_limits)
    if params.on_rack:
        w_b = torch.zeros_like(w_b)
        v_b = torch.zeros_like(v_b)
    quat = sp.quat_integrate(state.quat, w_b, dt)
    lin_vel = sp.mv(R, v_b)
    new_state = RobotState(
        pos=state.pos + dt * lin_vel,
        quat=quat,
        lin_vel=lin_vel,
        ang_vel=sp.mv(R, w_b),
        q=state.q + dt * qd,
        qd=qd,
    )
    return new_state, info


# ---------------------------------------------------------------------------
# Diagnostics used by tests and the contact oracle (energy / momentum audits)
# ---------------------------------------------------------------------------

def _generalized_velocity(state: RobotState):
    """(R (N,3,3), u = [ω_b; v_b; qd] (N,18))."""
    R = sp.quat_to_mat(state.quat)
    return R, torch.cat([_rmatvec(R, state.ang_vel), _rmatvec(R, state.lin_vel),
                         state.qd], dim=-1)


def _dense_mass_matrix(A, B, D):
    n = A.shape[0]
    top = torch.cat([A, B.permute(0, 2, 1, 3).reshape(n, 6, 12)], dim=-1)
    eye4 = torch.eye(4, dtype=D.dtype, device=D.device)
    D_full = (D[:, :, :, None, :] * eye4[:, None, :, None]).reshape(n, 12, 12)
    bottom = torch.cat([B.transpose(-1, -2).reshape(n, 12, 6), D_full], dim=-1)
    return torch.cat([top, bottom], dim=1)


def mass_matrix(model: Go1Model, q: torch.Tensor) -> torch.Tensor:
    """Dense (N,18,18) M(q) assembled from the star-topology blocks (for
    tests and the contact oracle; the dynamics solve with the blocks)."""
    return _dense_mass_matrix(*mass_matrix_blocks(model, q)[:3])


def kinetic_energy(model: Go1Model, state: RobotState) -> torch.Tensor:
    """½ uᵀ M(q) u per lane, (N,)."""
    _, u = _generalized_velocity(state)
    return 0.5 * sp.sum_fixed(u * sp.mv(mass_matrix(model, state.q), u))


def potential_energy(model: Go1Model, state: RobotState) -> torch.Tensor:
    """-m g · com_world summed over the bodies, (N,)."""
    fk = leg_fk_base(model, state.q)
    R = sp.quat_to_mat(state.quat)
    # trunk COM from its spatial inertia: I[0:3,3:6] = m c×
    mcx = model.trunk_inertia6[:, :3, 3:]
    c_trunk = torch.stack([mcx[:, 2, 1], mcx[:, 0, 2], mcx[:, 1, 0]],
                          dim=-1) / model.trunk_mass[:, None]
    coms_b = fk["o"] + sp.mv(fk["R"], model.leg_coms)           # (N,4,3,3)
    coms_w = state.pos[:, None, None] + sp.mm(coms_b, R.transpose(-1, -2)[:, None])
    trunk_w = state.pos + sp.mv(R, c_trunk)
    pe = -model.trunk_mass * sp.sum_fixed(trunk_w * model.gravity)
    legs = model.leg_masses * sp.mv(coms_w, model.gravity)
    return pe - sp.sum_fixed(sp.sum_fixed(legs, 2), 1)


def inverse_dynamics(model: Go1Model, state: RobotState, a0: torch.Tensor,
                     qdd: torch.Tensor) -> torch.Tensor:
    """Generalized forces M [a0; qdd] + h for given accelerations (RNEA,
    full), (N,18). Test oracle: ID(FD(tau)) == tau_gen."""
    R, u = _generalized_velocity(state)
    A, B, D, fk, s = mass_matrix_blocks(model, state.q)
    h = bias_forces(model, R, u, fk, s)
    return sp.mv(_dense_mass_matrix(A, B, D), torch.cat([a0, qdd], dim=-1)) + h
