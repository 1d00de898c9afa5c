"""Independent rigid-contact oracle: velocity-level LCP via projected
Gauss-Seidel (sequential impulses), PyBullet's algorithm.

The port's own copy of ``quadruped_springs_tpu.utils.lcp_oracle``, which
documents the algorithm and its sources: per 1 ms step an unconstrained
velocity update, one normal and two friction rows per site near the plane
and one unilateral row per violated URDF joint limit, 30 PGS sweeps on the
velocity problem, a split-impulse position pass, then a semi-implicit Euler
step with the joint velocities clamped. The contact resolution is float64
NumPy and shares nothing with the compliant simulator it gates
(``utils/verification.py``). The smooth rigid-body terms (mass matrix, bias
forces, site kinematics) come from the port's ``models/dynamics.py`` in
``torch.float64`` on one lane, on the device the caller names (the card by
default): the oracle is a reference tool, not a hot path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quadruped_springs_tpu_torch.models import dynamics as dyn
from quadruped_springs_tpu_torch.models.go1_params import build_model


@dataclasses.dataclass
class OracleParams:
    dt: float = 0.001
    n_iterations: int = 30      # 300/action_repeat of the reference env
    friction: float = 1.0
    erp: float = 0.2            # Bullet btContactSolverInfo m_erp2 default
    contact_slop: float = 0.0   # allowed penetration
    n_position_iterations: int = 10


@dataclasses.dataclass
class OracleState:
    """float64 NumPy state of one robot (the fields of dyn.RobotState)."""
    pos: np.ndarray
    quat: np.ndarray
    lin_vel: np.ndarray
    ang_vel: np.ndarray
    q: np.ndarray
    qd: np.ndarray

    @classmethod
    def from_robot_state(cls, s: dyn.RobotState, lane: int = 0) -> "OracleState":
        """One lane of a batched RobotState."""
        return cls(*(np.asarray(x[lane].detach().cpu(), np.float64) for x in
                     (s.pos, s.quat, s.lin_vel, s.ang_vel, s.q, s.qd)))

    def to_robot_state(self, device=None, dtype=torch.float32) -> dyn.RobotState:
        """A RobotState of one lane on `device` (the card by default)."""
        device = torch.device(device if device is not None else "cuda")
        t = lambda x: torch.as_tensor(np.asarray(x, np.float64)[None], dtype=dtype,
                                      device=device)
        return dyn.RobotState(pos=t(self.pos), quat=t(self.quat), lin_vel=t(self.lin_vel),
                              ang_vel=t(self.ang_vel), q=t(self.q), qd=t(self.qd))


def _smooth_terms(model, state: dyn.RobotState) -> dict:
    """M(q), h(q,u), site kinematics of one lane from the analytic model, as
    float64 NumPy arrays without the lane axis."""
    R, u = dyn._generalized_velocity(state)
    A, B, D, fk, s = dyn.mass_matrix_blocks(model, state.q)
    h = dyn.bias_forces(model, R, u, fk, s)
    M = dyn._dense_mass_matrix(A, B, D)
    pts_b, radii = dyn.contact_sites(model, fk)
    p_w = state.pos[:, None] + pts_b @ R.transpose(-1, -2)
    out = {"M": M, "h": h, "u": u, "R": R, "pts_b": pts_b, "p_w": p_w,
           "axes": fk["axes"], "o": fk["o"]}
    out = {k: v[0].cpu().numpy().astype(np.float64) for k, v in out.items()}
    out["radii"] = radii.cpu().numpy().astype(np.float64)
    return out


class LCPOracle:
    """Rigid-contact simulator. The contact math is float64 NumPy; the
    smooth terms are evaluated by the port's dynamics in float64 on
    `device` (the card unless the caller names another)."""

    def __init__(self, enable_springs: bool = True,
                 params: OracleParams = OracleParams(), device=None):
        self.device = torch.device(device if device is not None else "cuda")
        self.model = build_model(dtype=torch.float64, device=self.device)
        self.params = params
        self._vel_lim = None  # set by callers that clamp (env parity)

    def _terms(self, st: OracleState) -> dict:
        return _smooth_terms(self.model, st.to_robot_state(self.device, torch.float64))

    # -- jacobians -------------------------------------------------------
    @staticmethod
    def _site_jacobians(R, pts_b, axes, origins):
        """(12, 3, 18) world point-velocity Jacobians wrt u=[w_b,v_b,qd].

        v_w = R (v_b + w_b x p_b + sum_j a_j x (p_b - o_j) qd_j): columns
        are -hat(p_b) for w_b, I for v_b, a_j x (p_b - o_j) for the three
        joints of the site's leg (trunk sites: joint columns zero).
        """
        J = np.zeros((12, 3, 18))
        for i in range(12):
            p = pts_b[i]
            J[i, :, 0:3] = -_hat(p)
            J[i, :, 3:6] = np.eye(3)
            if i < 8:                      # feet 0-3 / knees 4-7 on leg i%4
                leg = i % 4
                for j in range(3):
                    col = np.cross(axes[leg, j], p - origins[leg, j])
                    J[i, :, 6 + 3 * leg + j] = col
        return np.einsum("ab,ibk->iak", R, J)

    # -- one step --------------------------------------------------------
    def step(self, st: OracleState, tau: np.ndarray) -> OracleState:
        prm = self.params
        dt = prm.dt
        t = self._terms(st)
        M, h, R, p_w, radii = t["M"], t["h"], t["R"], t["p_w"], t["radii"]
        Minv = np.linalg.inv(M)

        u = t["u"]
        tau_gen = np.concatenate([np.zeros(6), np.asarray(tau, np.float64)])
        u_free = u + dt * (Minv @ (tau_gen - h))

        # ---- constraint rows ----
        phi = radii - p_w[:, 2]                      # penetration depth
        active = np.where(phi > -1e-4)[0]            # near/under the plane
        Jsites = self._site_jacobians(R, t["pts_b"], t["axes"], t["o"])

        rows = []        # (J_row (18,), kind, site_or_joint, pos_bias)
        for i in active:
            Ji = Jsites[i]
            rows.append((Ji[2], "n", i,
                         (prm.erp / dt) * max(phi[i] - prm.contact_slop, 0.0)))
            rows.append((Ji[0], "t", i, 0.0))
            rows.append((Ji[1], "t", i, 0.0))
        lower = np.asarray(dyn.REAL_LOWER, np.float64)
        upper = np.asarray(dyn.REAL_UPPER, np.float64)
        for j in range(12):
            if st.q[j] < lower[j]:
                e = np.zeros(18); e[6 + j] = 1.0     # qd_j >= 0 pushes out
                rows.append((e, "n", None,
                             (prm.erp / dt) * (lower[j] - st.q[j])))
            elif st.q[j] > upper[j]:
                e = np.zeros(18); e[6 + j] = -1.0
                rows.append((e, "n", None,
                             (prm.erp / dt) * (st.q[j] - upper[j])))

        if rows:
            J = np.stack([r[0] for r in rows])                 # (m, 18)
            MinvJT = Minv @ J.T                                # (18, m)
            diag = np.einsum("ma,am->m", J, MinvJT)
            diag = np.maximum(diag, 1e-12)
            kinds = [r[1] for r in rows]
            sites = [r[2] for r in rows]
            pos_bias = np.array([r[3] for r in rows])

            # normal-impulse index per friction row (Bullet couples the
            # friction bound to the CURRENT normal impulse each sweep)
            n_of_site = {}
            for m, (k, sblock) in enumerate(zip(kinds, sites)):
                if k == "n" and sblock is not None:
                    n_of_site[sblock] = m

            # ---- velocity PGS (zero restitution, no position bias) ----
            lam = np.zeros(len(rows))
            v = J @ u_free                                     # row velocities
            for _ in range(prm.n_iterations):
                for m in range(len(rows)):
                    if kinds[m] == "n":
                        new = max(lam[m] - v[m] / diag[m], 0.0)
                    else:
                        lim = prm.friction * lam[n_of_site[sites[m]]]
                        new = np.clip(lam[m] - v[m] / diag[m], -lim, lim)
                    dl = new - lam[m]
                    if dl != 0.0:
                        lam[m] = new
                        v += dl * (J @ MinvJT[:, m])
            u_new = u_free + MinvJT @ lam

            # ---- split-impulse position pass (normal rows only) ----
            lam_p = np.zeros(len(rows))
            u_pseudo = np.zeros(18)
            for _ in range(prm.n_position_iterations):
                for m in range(len(rows)):
                    if kinds[m] != "n" or pos_bias[m] == 0.0:
                        continue
                    res = J[m] @ u_pseudo - pos_bias[m]
                    new = max(lam_p[m] - res / diag[m], 0.0)
                    dl = new - lam_p[m]
                    if dl != 0.0:
                        lam_p[m] = new
                        u_pseudo += dl * MinvJT[:, m]
        else:
            u_new = u_free
            u_pseudo = np.zeros(18)

        # ---- integrate (semi-implicit Euler, pseudo-vel on positions) ----
        w_b = u_new[0:3]
        v_b = u_new[3:6]
        qd = u_new[6:18]
        if self._vel_lim is not None:
            qd = np.clip(qd, -self._vel_lim, self._vel_lim)
        w_int = w_b + u_pseudo[0:3]
        v_int = v_b + u_pseudo[3:6]
        qd_int = qd + u_pseudo[6:18]

        pos = st.pos + dt * (R @ v_int)
        quat = _quat_integrate(st.quat, w_int, dt)
        q = st.q + dt * qd_int
        return OracleState(pos=pos, quat=quat, lin_vel=R @ v_b,
                           ang_vel=R @ w_b, q=q, qd=qd)

    # -- contact info (GetContactInfo surface parity) --------------------
    def feet_in_contact(self, st: OracleState) -> np.ndarray:
        t = self._terms(st)
        phi = t["radii"] - t["p_w"][:, 2]
        return phi[:4] > -1e-4


def _hat(v):
    return np.array([[0.0, -v[2], v[1]],
                     [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def _quat_integrate(quat_xyzw, w_body, dt):
    """Exact exponential-map quaternion step (matches spatial.quat_integrate)."""
    th = np.linalg.norm(w_body) * dt
    if th < 1e-12:
        dq = np.array([0.5 * dt * w_body[0], 0.5 * dt * w_body[1],
                       0.5 * dt * w_body[2], 1.0])
    else:
        axis = w_body / np.linalg.norm(w_body)
        dq = np.concatenate([np.sin(th / 2) * axis, [np.cos(th / 2)]])
    x1, y1, z1, w1 = quat_xyzw
    x2, y2, z2, w2 = dq
    # body-frame increment: q' = q * dq
    out = np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])
    return out / np.linalg.norm(out)
