"""iLQR trajectory optimizer, batched over problems.

Port of ``quadruped_springs_tpu.solver.ilqr``. ``solve_batched`` is the one
implementation; ``solve`` is it with a batch of one. B problems carry an
explicit leading axis everywhere: x0s (B,n), u_inits (B,H,m), the
linearization A (B,H,n,n), B (B,H,n,m), the gains ks (B,H,m), Ks (B,H,m,n).

``dynamics(x, u)`` and the costs are batched over leading dimensions, as in
``solver/mppi.py``: the solver calls dynamics with x (B,R,n), u (B,R,m) for
R lanes per problem (R = 1 for the nominal rollout, n_alphas for the
parallel line search, a block of knots for the linearization) and expects
(B,R,n); ``stage_cost(x (...,n), u (...,m), t)`` and ``terminal_cost(x)``
return (...).

Stages of one iteration:
  * linearization: forward-mode AD, ``vmap`` over the n+m basis tangents of
    ``torch.func.jvp`` of the dynamics, so the primal is evaluated once and
    every op sees (n+m, lanes, ...) tangents. Blocks of knots bound the
    working set (LIN_TANGENT_LANES);
  * cost gradients and Hessians: forward-over-reverse AD of the cost
    functions alone;
  * backward Riccati sweep: a Python loop over the horizon of batched small
    matrix products with Levenberg-Marquardt regularization of Q_uu
    ("sequential"), or an associative scan of log2(H+1) rounds ("parallel",
    Särkkä & García-Fernández 2021);
  * forward pass: a parallel line search, all n_alphas step sizes of all
    problems rolled out as one batch, the best accepted per problem.
Accept, reject and the regularization update are masked selects per
problem; nothing in an iteration reads a device value on the host. The
small products, sums and the Cholesky solve of the sequential sweep, the
line search and the costs are elementwise ops summed in a fixed order
(``models/spatial.py``), so a problem's solution does not depend on how
many problems share its batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import torch
from torch.func import grad, jvp, vmap

from quadruped_springs_tpu_torch.models import spatial as sp

# Upper bound on tangent lanes (basis tangents x primal lanes) of one
# linearization block. The widest intermediates of the Go1 dynamics are the
# products of spatial.mm on (lanes,4,3,6,6) blocks, (lanes,4,3,6,6,6) float32,
# 10 KB per lane, so 2^18 tangent lanes keep a block's working set at a few
# GB (a full-width exact solve peaks at 9.13 GiB on an NVIDIA H100 80GB
# HBM3 at 700 W).
LIN_TANGENT_LANES = 1 << 18

V_CLAMP = 1e7      # f32 safety clamp on the value function's derivatives


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    horizon: int = 50
    iterations: int = 10
    n_alphas: int = 8           # parallel line-search candidates
    reg_init: float = 1.0
    reg_min: float = 1e-6
    reg_max: float = 1e8
    reg_factor: float = 2.0
    u_min: float = -1.0
    u_max: float = 1.0
    # Per-knot PD shift for Q_uu: "gershgorin" (elementwise lower bound on
    # λ_min) or "eig" (exact shift by the most negative eigenvalue).
    pd_shift: str = "gershgorin"
    # Regularization: "control" (LM shift on Q_uu) or "tassa" (state-space:
    # μ through the dynamics, for bounded gains where Vxx blows up).
    reg_mode: str = "control"
    # Riccati sweep: "sequential" (per-knot adaptive LM, the robust default)
    # or "parallel" (associative scan, O(log H) depth, a control-cost LM
    # shift instead of the per-knot adaptive one).
    backward: str = "sequential"
    # Relinearize the dynamics every k-th iteration (lagged Gauss-Newton);
    # cost derivatives are always fresh. k=1 is classic iLQR.
    relin_every: int = 1


@dataclasses.dataclass(frozen=True)
class ILQRSolution:
    us: torch.Tensor          # (B,H,m) optimal controls
    xs: torch.Tensor          # (B,H+1,n) state trajectories
    cost: torch.Tensor        # (B,) final costs
    cost_trace: torch.Tensor  # (B,iterations) cost per iteration
    reg: torch.Tensor         # (B,) final regularization


def _t(M):
    return M.transpose(-1, -2)


def _chol_solve(M, rhs):
    """Solve M X = rhs for symmetric (P,m,m) M and (P,m,r) rhs by an
    unrolled Cholesky factorization of M's lower triangle, in elementwise
    ops (a batched library factorization picks its kernel by batch size).
    Returns (X, ok): ok (P,) is False where a pivot is not positive or the
    factor is not finite, as torch.linalg.cholesky_ex's info would say."""
    m = M.shape[-1]
    ok = torch.ones(M.shape[:-2], dtype=torch.bool, device=M.device)
    cols = []                                  # cols[j] = L[j:, j], (P, m-j)
    S = M
    for j in range(m):
        d2 = S[:, 0, 0]
        d = torch.sqrt(d2)
        col = torch.cat([d[:, None], S[:, 1:, 0] / d[:, None]], dim=-1)
        ok = ok & (d2 > 0) & torch.isfinite(col).all(dim=-1)
        cols.append(col)
        if j < m - 1:
            S = S[:, 1:, 1:] - col[:, 1:, None] * col[:, None, 1:]
    y, ys = rhs, []
    for j in range(m):                         # forward: L y = rhs
        yj = y[:, 0] / cols[j][:, 0, None]
        ys.append(yj)
        y = y[:, 1:] - cols[j][:, 1:, None] * yj[:, None]
    xs = [None] * m
    for i in reversed(range(m)):               # back: Lᵀ x = y
        acc = ys[i]
        for k in range(i + 1, m):
            acc = acc - cols[i][:, k - i, None] * xs[k]
        xs[i] = acc / cols[i][:, 0, None]
    return torch.stack(xs, dim=1), ok


def _solve(A, rhs):
    """A⁻¹ rhs without the host synchronisation of torch.linalg.solve's
    error check; a singular A gives non-finite values, which the callers'
    `ok` flags catch."""
    return torch.linalg.solve_ex(A, rhs, check_errors=False).result


def _gershgorin_min(M):
    """Gershgorin lower bound on the smallest eigenvalue of (...,m,m) M.

    The row sums run in a fixed order (spatial.sum_fixed): a library
    reduction sums in an order set by the strides and the batch size."""
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    offdiag = sp.sum_fixed(M.abs()) - diag.abs()
    return (diag - offdiag).min(dim=-1).values


# ---------------------------------------------------------------------------
# Parallel-in-time backward pass
# ---------------------------------------------------------------------------

def lqt_elements(A, B, lx, lu, lxx, luu, lux, VxT, VxxT, reg):
    """Conditional-value-function elements of the LQ subproblems: per-knot
    tuples (a, b, C, η, J) for steps 0..H-1 plus the terminal element. Cross
    terms are removed by u = v − R⁻¹(lux δx + lu); regularization is an LM
    shift on the control Hessian (reg + Gershgorin(luu)).

    A (P,H,n,n), B (P,H,n,m), ..., VxT (P,n), VxxT (P,n,n), reg (P,).
    Returns (elems: 5 tensors with H+1 along dim 1, R (P,H,m,m))."""
    m = B.shape[-1]
    eye_m = torch.eye(m, dtype=A.dtype, device=A.device)
    mu = reg[:, None] + torch.clamp_min(-_gershgorin_min(luu), 0.0) + 1e-6
    R = luu + mu[..., None, None] * eye_m

    Rinv_N = _solve(R, lux)                          # (P,H,m,n)
    Rinv_r = _solve(R, lu[..., None])[..., 0]        # (P,H,m)
    At = A - sp.mm(B, Rinv_N)                        # Ã = A − B R⁻¹ N
    ct = -sp.mv(B, Rinv_r)                           # c̃ = −B R⁻¹ r
    Qt = lxx - sp.mm(_t(lux), Rinv_N)                # Q̃ = Q − NᵀR⁻¹N
    qt = lx - sp.mv(_t(lux), Rinv_r)                 # q̃ = q − NᵀR⁻¹r
    Ct = sp.mm(B, _solve(R, _t(B)))                  # C = B R⁻¹ Bᵀ

    z_nn = torch.zeros_like(A[:, :1])
    z_n = torch.zeros_like(lx[:, :1])
    elems = (torch.cat([At, z_nn], 1), torch.cat([ct, z_n], 1), torch.cat([Ct, z_nn], 1),
             torch.cat([-qt, -VxT[:, None]], 1), torch.cat([Qt, VxxT[:, None]], 1))
    return elems, R


def lqt_identity_element(n, dtype, batch_shape=(), device=None):
    """Neutral element of lqt_combine (covers an empty interval)."""
    eye = torch.eye(n, dtype=dtype, device=device).expand(*batch_shape, n, n)
    z_nn = torch.zeros(*batch_shape, n, n, dtype=dtype, device=device)
    z_n = torch.zeros(*batch_shape, n, dtype=dtype, device=device)
    return (eye, z_n, z_nn, z_n, z_nn)


def lqt_combine(e_later, e_earlier):
    """Compose element i = e_earlier (covers [k,l)) with j = e_later (covers
    [l,r)), batched over leading dimensions."""
    Ai, bi, Ci, etai, Ji = e_earlier
    Aj, bj, Cj, etaj, Jj = e_later
    eye_n = torch.eye(Ai.shape[-1], dtype=Ai.dtype, device=Ai.device).expand_as(Ai)
    AjX = sp.mm(Aj, _solve(eye_n + sp.mm(Ci, Jj), eye_n))      # A_j (I + C_i J_j)⁻¹
    AiT_Y = sp.mm(_t(Ai), _solve(eye_n + sp.mm(Jj, Ci), eye_n))  # A_iᵀ (I + J_j C_i)⁻¹
    A_new = sp.mm(AjX, Ai)
    b_new = sp.mv(AjX, bi + sp.mv(Ci, etaj)) + bj
    C_new = sp.mm(sp.mm(AjX, Ci), _t(Aj)) + Cj
    eta_new = sp.mv(AiT_Y, etaj - sp.mv(Jj, bi)) + etai
    J_new = sp.mm(sp.mm(AiT_Y, Jj), Ai) + Ji
    return (A_new, b_new, C_new, eta_new, J_new)


def lqt_gains(S1, s1, A, B, R, lu, lux):
    """Per-knot gains from the NEXT knot's value function (S_{k+1}, s_{k+1})
    in the original (u, A) coordinates: Qu = lu + Bᵀs', Qux = lux + BᵀS'A,
    Quu = R + BᵀS'B. All knots at once."""
    BtS = sp.mm(_t(B), S1)
    Quu = R + sp.mm(BtS, B)
    rhs_k = sp.mv(_t(B), s1) + lu
    rhs_K = sp.mm(BtS, A) + lux
    sol = _solve(Quu, torch.cat([rhs_k[..., None], rhs_K], dim=-1))
    return -sol[..., 0], -sol[..., 1:]


def _reverse_scan(elems):
    """Reverse inclusive scan of lqt_combine along dim 1: entry k becomes
    the composition of entries k..L-1. Recursive doubling: after the round
    with stride d entry k covers [k, k+2d), so ceil(log2 L) rounds of one
    batched lqt_combine each."""
    L = elems[0].shape[1]
    d = 1
    while d < L:
        combined = lqt_combine(tuple(e[:, d:] for e in elems),
                               tuple(e[:, :L - d] for e in elems))
        elems = tuple(torch.cat([c, e[:, L - d:]], dim=1)
                      for c, e in zip(combined, elems))
        d *= 2
    return elems


def _parallel_lqt_backward(A, B, lx, lu, lxx, luu, lux, VxT, VxxT, reg):
    """Parallel-in-time Riccati sweep for P problems.
    Returns (ks (P,H,m), Ks (P,H,m,n), dV = 0 (P,), ok (P,))."""
    elems, R = lqt_elements(A, B, lx, lu, lxx, luu, lux, VxT, VxxT, reg)
    composed = _reverse_scan(elems)
    S = composed[4]          # (P,H+1,n,n) value Hessians S_k
    s_lin = -composed[3]     # (P,H+1,n) value linear terms
    ks, Ks = lqt_gains(S[:, 1:], s_lin[:, 1:], A, B, R, lu, lux)
    ok = torch.isfinite(ks).all(dim=(1, 2)) & torch.isfinite(Ks).all(dim=(1, 2, 3))
    return ks, Ks, torch.zeros_like(reg), ok


# ---------------------------------------------------------------------------
# Sequential backward pass
# ---------------------------------------------------------------------------

def riccati_sequential(A, B, lx, lu, lxx, luu, lux, Vx, Vxx, reg, config: ILQRConfig):
    """The sequential backward Riccati sweep for P problems at once.

    A (P,H,n,n), B (P,H,n,m), lx (P,H,n), lu (P,H,m), lxx (P,H,n,n), luu
    (P,H,m,m), lux (P,H,m,n), Vx (P,n), Vxx (P,n,n), reg (P,). Returns
    (ks (P,H,m), Ks (P,H,m,n), dV (P,), ok (P,)); ok is False where a
    regularized Q_uu was not positive definite or not finite."""
    H, n, m = A.shape[1], A.shape[-1], B.shape[-1]
    eye_n = torch.eye(n, dtype=A.dtype, device=A.device)
    eye_m = torch.eye(m, dtype=A.dtype, device=A.device)
    dV = torch.zeros_like(reg)
    ok = torch.ones_like(reg, dtype=torch.bool)
    ks, Ks = [None] * H, [None] * H
    for t in reversed(range(H)):
        A_t, B_t = A[:, t], B[:, t]
        At_T, Bt_T = _t(A_t), _t(B_t)
        Qx = lx[:, t] + sp.mv(At_T, Vx)
        Qu = lu[:, t] + sp.mv(Bt_T, Vx)
        BtV = sp.mm(Bt_T, Vxx)
        Qxx = lxx[:, t] + sp.mm(sp.mm(At_T, Vxx), A_t)
        Quu = luu[:, t] + sp.mm(BtV, B_t)
        Qux = lux[:, t] + sp.mm(BtV, A_t)
        if config.reg_mode == "tassa":
            BtVr = sp.mm(Bt_T, Vxx + reg[:, None, None] * eye_n)
            Quu_r = luu[:, t] + sp.mm(BtVr, B_t)
            Qux_r = lux[:, t] + sp.mm(BtVr, A_t)
        else:
            Quu_r, Qux_r = Quu, Qux
        if config.pd_shift == "eig":
            lam_min = torch.linalg.eigvalsh(Quu_r)[..., 0]
        else:
            lam_min = _gershgorin_min(Quu_r)
        mu_t = reg + torch.clamp_min(-lam_min, 0.0) + 1e-6
        Quu_reg = Quu_r + mu_t[:, None, None] * eye_m
        # neither raises nor synchronises on a non-PD matrix
        sol, pd = _chol_solve(Quu_reg, torch.cat([Qu[..., None], Qux_r], dim=-1))
        ok = ok & pd
        k, K = -sol[..., 0], -sol[..., 1:]
        Kt = _t(K)
        KtQuu = sp.mm(Kt, Quu)
        Vx = Qx + sp.mv(KtQuu, k) + sp.mv(Kt, Qu) + sp.mv(_t(Qux), k)
        Vxx = Qxx + sp.mm(KtQuu, K) + sp.mm(Kt, Qux) + sp.mm(_t(Qux), K)
        Vxx = 0.5 * (Vxx + _t(Vxx))
        Vx = torch.clamp(Vx, -V_CLAMP, V_CLAMP)
        Vxx = torch.clamp(Vxx, -V_CLAMP, V_CLAMP)
        dV = dV + sp.sum_fixed(k * Qu) + 0.5 * sp.sum_fixed(k * sp.mv(Quu, k))
        ks[t], Ks[t] = k, K
    return torch.stack(ks, dim=1), torch.stack(Ks, dim=1), dV, ok


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

class _StageClock:
    """Accumulates the time of named stages into `out` (seconds): CUDA
    events on a card, read once at the end so that timing adds no host
    synchronisation to an iteration; the host clock on the CPU."""

    def __init__(self, out: dict | None, device: torch.device):
        self.out, self.cuda, self.events = out, device.type == "cuda", []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.out is None:
            yield
        elif self.cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self.events.append((name, start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.out[name] = self.out.get(name, 0.0) + time.perf_counter() - t0

    def finish(self):
        if self.events:
            torch.cuda.synchronize()
            for name, start, end in self.events:
                self.out[name] = self.out.get(name, 0.0) + start.elapsed_time(end) / 1e3


def _basis_jvp(fn, z):
    """fn(z) and its Jacobian columns: vmap over the basis tangents of z's
    last axis of jvp(fn). Returns (fn(z), cols (z.shape[-1], *fn(z).shape))."""
    d = z.shape[-1]
    basis = torch.eye(d, dtype=z.dtype, device=z.device).reshape(
        (d,) + (1,) * (z.dim() - 1) + (d,)).expand(d, *z.shape)
    return vmap(lambda e: jvp(fn, (z,), (e,)), out_dims=(None, 0))(basis)


def linearization_blocks(batch: int, horizon: int, n_tangents: int) -> int:
    """Knots per linearization block: as many as keep n_tangents x batch x
    knots within LIN_TANGENT_LANES, at least one."""
    return max(1, min(horizon, LIN_TANGENT_LANES // (batch * n_tangents)))


def solve_batched(dynamics: Callable, stage_cost: Callable, terminal_cost: Callable,
                  x0s: torch.Tensor, u_inits: torch.Tensor,
                  config: ILQRConfig = ILQRConfig(),
                  stage_times: dict | None = None,
                  dynamics_lin: Callable | None = None) -> ILQRSolution:
    """Minimize Σ_t l(x_t, u_t, t) + lf(x_H) s.t. x_{t+1} = f(x_t, u_t) for B
    problems: x0s (B,n), u_inits (B,H,m) warm starts. A dict passed as
    `stage_times` receives the seconds spent per stage ("rollout",
    "linearize", "cost_derivatives", "backward", "line_search").
    `dynamics_lin`, batched like `dynamics`, is used for the A/B Jacobians
    alone (e.g. a bfloat16 knot); rollouts, costs and the Riccati sweep use
    `dynamics`."""
    Bsz, H, m = u_inits.shape
    n = x0s.shape[1]
    dev, dtype = x0s.device, x0s.dtype
    clip_u = lambda u: torch.clamp(u, config.u_min, config.u_max)
    ts = torch.arange(H, device=dev)
    clock = _StageClock(stage_times, dev)
    alphas = 1.1 ** (-torch.arange(config.n_alphas, dtype=dtype, device=dev) ** 2)
    rows = torch.arange(Bsz, device=dev)
    knots_per_block = linearization_blocks(Bsz, H, n + m)

    def total_cost(xs, us):
        return (sp.sum_fixed(stage_cost(xs[..., :-1, :], us, ts))
                + terminal_cost(xs[..., -1, :]))

    def linearize(Xs, Us):
        Z = torch.cat([Xs[:, :-1], Us], dim=-1)               # (B,H,n+m)
        dyn_jac = dynamics if dynamics_lin is None else dynamics_lin
        f = lambda z: dyn_jac(z[..., :n], z[..., n:])
        cols = [_basis_jvp(f, Z[:, h:h + knots_per_block])[1]
                for h in range(0, H, knots_per_block)]        # (n+m,B,knots,n) each
        J = torch.cat(cols, dim=2).permute(1, 2, 3, 0)        # (B,H,n,n+m)
        return J[..., :n], J[..., n:]

    def stage_grad(Z):
        return grad(lambda z: stage_cost(z[..., :n], z[..., n:], ts).sum())(Z)

    def terminal_grad(X):
        return grad(lambda x: terminal_cost(x).sum())(X)

    def backward(Xs, Us, regs, AB):
        with clock("cost_derivatives"):
            g, cols = _basis_jvp(stage_grad, torch.cat([Xs[:, :-1], Us], dim=-1))
            hess = cols.permute(1, 2, 3, 0)                   # (B,H,n+m,n+m)
            lxx, lux, luu = hess[..., :n, :n], hess[..., n:, :n], hess[..., n:, n:]
            lx, lu = g[..., :n], g[..., n:]
            Vx, cols = _basis_jvp(terminal_grad, Xs[:, -1])
            Vxx = cols.permute(1, 2, 0)
        with clock("backward"):
            if config.backward == "parallel":
                return _parallel_lqt_backward(*AB, lx, lu, lxx, luu, lux, Vx, Vxx, regs)
            return riccati_sequential(*AB, lx, lu, lxx, luu, lux, Vx, Vxx, regs, config)

    def line_search(Xs, Us, ks, Ks):
        """All alphas of all problems as (B,n_alphas) lanes:
        xs (B,A,H+1,n), us (B,A,H,m), costs (B,A)."""
        X = x0s[:, None].expand(Bsz, config.n_alphas, n)
        xs, us = [X], []
        for t in range(H):
            fb = sp.mv(Ks[:, None, t], X - Xs[:, None, t])
            U = clip_u(Us[:, None, t] + alphas[None, :, None] * ks[:, None, t] + fb)
            X = dynamics(X, U)
            xs.append(X)
            us.append(U)
        xs, us = torch.stack(xs, dim=2), torch.stack(us, dim=2)
        return xs, us, total_cost(xs, us)

    Us = clip_u(u_inits)
    with clock("rollout"):
        X = x0s[:, None]
        xs = [X]
        for t in range(H):
            X = dynamics(X, Us[:, None, t])
            xs.append(X)
        Xs = torch.cat(xs, dim=1)                             # (B,H+1,n)
        cost = total_cost(Xs, Us)
    regs = torch.full((Bsz,), config.reg_init, dtype=dtype, device=dev)
    lin = None
    trace = []
    for i in range(config.iterations):
        if i % max(config.relin_every, 1) == 0:
            with clock("linearize"):
                lin = linearize(Xs, Us)
        ks, Ks, _, ok = backward(Xs, Us, regs, lin)
        with clock("line_search"):
            Xs_c, Us_c, costs = line_search(Xs, Us, ks, Ks)
            best = torch.argmin(costs, dim=1)
            new_cost = costs[rows, best]
            improved = ok & (new_cost < cost) & torch.isfinite(new_cost)
            imp_x = improved[:, None, None]
            Xs = torch.where(imp_x, Xs_c[rows, best], Xs)
            Us = torch.where(imp_x, Us_c[rows, best], Us)
            cost = torch.where(improved, new_cost, cost)
            regs = torch.where(
                improved,
                torch.clamp_min(regs / config.reg_factor, config.reg_min),
                torch.clamp_max(regs * config.reg_factor * config.reg_factor,
                                config.reg_max))
        trace.append(cost)
    clock.finish()
    # no iteration: the warm start's rollout and cost, an empty trace
    cost_trace = torch.stack(trace, dim=-1) if trace else cost.new_zeros(Bsz, 0)
    return ILQRSolution(us=Us, xs=Xs, cost=cost, cost_trace=cost_trace, reg=regs)


def solve(dynamics: Callable, stage_cost: Callable, terminal_cost: Callable,
          x0: torch.Tensor, u_init: torch.Tensor,
          config: ILQRConfig = ILQRConfig()) -> ILQRSolution:
    """One problem: x0 (n,), u_init (H,m). `dynamics(x, u)` and the costs
    broadcast over leading dimensions (see the module docstring). Returns an
    ILQRSolution without the batch axis."""
    return first_problem(solve_batched(dynamics, stage_cost, terminal_cost, x0[None],
                                       u_init[None], config))


def first_problem(sol: ILQRSolution) -> ILQRSolution:
    """The first problem of a batched solution, without the batch axis."""
    return ILQRSolution(**{f.name: getattr(sol, f.name)[0]
                           for f in dataclasses.fields(ILQRSolution)})
