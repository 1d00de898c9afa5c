"""The MPPI update between two rollouts, in one call.

``mppi_update`` takes a solve's state (the controls, the running best or
the last proposal, their costs, the cost trace) and what the last rollout
gave, and returns the new state and the rows of the next rollout with their
joint targets. On CUDA tensors it launches the CUDA kernel ``mppi_update``
of ``csrc/mppi_update.cu`` once (the kernel or an error: there is no
fallback), updating the state's tensors in place; on CPU tensors it runs
``mppi_update_plain``, the PyTorch code of ``solver/mppi.py`` that did the
update before the kernel, in the same order of operations. A call does, in
order, what its arguments ask for:

1. ``costs`` and ``cand`` given: the proposal, the elite-truncated
   importance-weighted mean of the candidates (``us`` with the fused
   accept, which also tracks the best candidate in ``us_alt`` and its cost
   in ``cost`` and writes the trace; else ``us_alt``);
2. ``cost_new`` given (the plain branch): the proposal ``us_alt`` replaces
   ``us`` where its cost is below ``cost``; the trace;
3. ``rows``: ROWS_CANDIDATES, the K candidates from the standard-normal
   ``draw`` (scaled by σ_i, low-passed along H and renormalised per knot,
   row 0 zero with the fused accept, added to ``us``, clipped); ROWS_US,
   ROWS_ALT, ROWS_BOTH: rows of the state. With a PD interface in the
   settings the rows' joint targets (``action_to_command``) come too.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct

import torch

from quadruped_springs_tpu_torch import kernels
from quadruped_springs_tpu_torch.control import interfaces as ci
from quadruped_springs_tpu_torch.models import spatial as sp

ROWS_CANDIDATES, ROWS_US, ROWS_ALT, ROWS_BOTH = range(4)
LOWPASS_A, LOWPASS_B = 0.7, 0.3      # first-order low-pass of the exploration noise
# csrc/mppi_update.cuh: kUpdateThreads, kGroupRows, kDrawSlots
THREADS, GROUP_ROWS, SLOTS = 128, 4, 4
MAX_SHARED_BYTES = 227 * 1024        # an H100 block's shared memory
_NO_MAP = ((ctypes.c_int * 12)(*[-1] * 12), (ctypes.c_float * 12)(*[1.0] * 12))


@dataclasses.dataclass
class UpdateState:
    """A solve's state between rollouts, B problems."""
    us: torch.Tensor       # (B,H,m) fused accept: the proposal; plain: the accepted controls
    us_alt: torch.Tensor   # (B,H,m) fused accept: the best candidate; plain: the proposal
    cost: torch.Tensor     # (B,) fused accept: the best cost; plain: the accepted cost
    trace: torch.Tensor    # (B,iterations)


@dataclasses.dataclass(frozen=True)
class UpdateSettings:
    fused: bool
    smooth: bool
    n_elite: int
    temperature: float
    u_min: float
    u_max: float
    # a PD interface: the rows' joint targets come with them; None: none
    iface: ci.ControlInterface | None = None


def mppi_update_plain(state: UpdateState, settings: UpdateSettings, *, costs=None, cand=None,
                      cost_new=None, trace_col: int = 0, rows: int = ROWS_CANDIDATES,
                      draw=None, sigma=None, norm=None):
    """The plain PyTorch version of the `mppi_update` kernel: arguments and
    results as mppi_update, on any device; returns a new state."""
    s = settings
    clip_u = lambda u: torch.clamp(u, s.u_min, s.u_max)
    us, us_alt, cost, trace = state.us, state.us_alt, state.cost, state.trace
    if costs is not None:
        costs = torch.where(torch.isfinite(costs), costs,
                            torch.full((), float("inf"), dtype=costs.dtype, device=costs.device))
        if s.fused:
            ib = torch.argmin(costs, dim=-1)
            idx = torch.arange(costs.shape[0], device=costs.device)
            c_ib = costs[idx, ib]
            better = c_ib < cost
            us_alt = torch.where(better[:, None, None], cand[idx, ib], us_alt)
            cost = torch.where(better, c_ib, cost)
            trace = trace.clone()
            trace[:, trace_col] = cost
        kth = torch.sort(costs, dim=-1).values[:, s.n_elite - 1:s.n_elite]
        beta = costs.min(dim=-1, keepdim=True).values
        w = torch.exp(-(costs - beta) / s.temperature)
        w = torch.where(costs <= kth, w, torch.zeros_like(w))
        w = w / torch.clamp_min(sp.sum_fixed(w), 1e-12)[:, None]
        prop = clip_u(sp.sum_fixed(w[:, :, None, None] * cand, 1))
        if s.fused:
            us = prop
        else:
            us_alt = prop
    if cost_new is not None:
        better = cost_new < cost
        us = torch.where(better[:, None, None], us_alt, us)
        cost = torch.where(better, cost_new, cost)
        trace = trace.clone()
        trace[:, trace_col] = cost
    if rows == ROWS_CANDIDATES:
        eps = sigma * draw
        if s.smooth:
            eps = lowpass(eps, norm)
        if s.fused:
            eps = torch.cat([torch.zeros_like(eps[:, :1]), eps[:, 1:]], dim=1)
        out = clip_u(us[:, None] + eps)
    else:
        out = {ROWS_US: lambda: us[:, None], ROWS_ALT: lambda: us_alt[:, None],
               ROWS_BOTH: lambda: torch.stack([us, us_alt], dim=1)}[rows]()
    q_des = None if s.iface is None else ci.action_to_command(s.iface, out).contiguous()
    return UpdateState(us, us_alt, cost, trace), out.contiguous(), q_des


def lowpass(eps, norm):
    """(B,K,H,m) noise low-passed along H (c = a·c + b·e from c = 0) and
    divided by norm (H,) knot by knot."""
    c = torch.zeros_like(eps[:, :, 0])
    steps = []
    for t in range(eps.shape[2]):
        c = LOWPASS_A * c + LOWPASS_B * eps[:, :, t]
        steps.append(c)
    return torch.stack(steps, dim=2) / norm[:, None]


def lowpass_norm(horizon: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H,) the low-pass's per-knot renormalisation: Var(c_t) =
    b²(1 - a^{2(t+1)})/(1 - a²)·σ², so dividing by its square root restores
    the marginal std at every knot."""
    a, b = LOWPASS_A, LOWPASS_B
    t = torch.arange(horizon, dtype=dtype, device=device)
    return b * torch.sqrt((1.0 - a ** (2.0 * (t + 1.0))) / (1.0 - a * a))


def pd_command_map(iface: ci.ControlInterface):
    """(joint_src, joint_sign) of a PD interface's action_to_command: joint
    i's target is scale_action_to_command of action joint_src[i] times
    joint_sign[i] (expand_action's mirror), or of 0 where joint_src[i] is
    -1. Read off expand_action itself on the actions 1..m."""
    return _command_map(iface.action_space_mode, iface.symm_idx, iface.action_dim)


@functools.lru_cache(maxsize=None)
def _command_map(action_space_mode: str, symm_idx: int, action_dim: int):
    iface = ci.ControlInterface("PD", action_space_mode, action_dim, symm_idx,
                                *([None] * 5))
    v = ci.expand_action(iface, torch.arange(1, action_dim + 1, dtype=torch.float64)).tolist()
    return ((ctypes.c_int * 12)(*(int(abs(x)) - 1 for x in v)),
            (ctypes.c_float * 12)(*(-1.0 if x < 0 else 1.0 for x in v)))


def shared_bytes(samples: int, horizon: int, actions: int) -> int:
    """The kernel's dynamic shared memory a block at K, H and m with THREADS
    threads and one group (GROUP_ROWS rows) a slot, its least, as
    csrc/mppi_update.cuh update_smem_bytes lays it out, each region rounded
    up to 16 bytes: costs and weights (K each), the norm and the tile (H·m
    each), the mean's partial sums (3 H·m), the slots (SLOTS x GROUP_ROWS
    rows of H·m + 3 rounded up to 4), and for K outside {32, 64} the
    products' columns (K x THREADS); bytes."""
    E = horizon * actions
    up = lambda n: -(-n // 4) * 4
    cols = 0 if samples in (32, 64) else samples * THREADS
    return 4 * (2 * up(samples) + 2 * up(E) + up(3 * E) + SLOTS * GROUP_ROWS * up(E + 3) + cols)


@functools.lru_cache(maxsize=None)
def float32_constants(temperature: float) -> tuple[float, float, float]:
    """λ⁻¹, the low-pass's a and b, each rounded to float32 (round to
    nearest even, as torch.tensor(x, dtype=torch.float32)), once a
    temperature. λ's division as PyTorch's CUDA kernels divide by a Python
    number: a product with its reciprocal, taken in double and rounded."""
    f32 = lambda x: struct.unpack("f", struct.pack("f", x))[0]
    return f32(1.0 / temperature), f32(LOWPASS_A), f32(LOWPASS_B)


def occupancy(samples: int, horizon: int, actions: int, problems: int, device=None) -> dict:
    """What the card makes of the `mppi_update` kernel (the instantiation
    for K = samples) at horizon H, m actions and B problems: its blocks and
    warps an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the
    launch's shared memory), threads a block, registers and local memory
    bytes a thread, shared memory bytes a block, groups a slot. Builds the
    library if needed; needs a card."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = kernels.library().mppi_update_occupancy(samples, horizon, actions, problems, out)
    kernels.check_launch("mppi_update_occupancy", err)
    return {"blocks_per_sm": out[0], "warps_per_sm": out[0] * out[1] // 32,
            "threads_per_block": out[1], "registers": out[2], "local_bytes": out[3],
            "shared_bytes": out[4], "groups_a_slot": out[5]}


def _launch(state: UpdateState, s: UpdateSettings, costs, cand, cost_new, trace_col, rows,
            draw, sigma, norm):
    B, H, m = state.us.shape
    K = next((t.shape[1] for t in (cand, draw) if t is not None), 0)
    dev = state.us.device
    if shared_bytes(K, H, m) > MAX_SHARED_BYTES:
        raise ValueError(f"mppi_update: {K} candidates of {H} x {m} do not fit a block's "
                         "shared memory")
    checks = [("us", state.us, (B, H, m)), ("us_alt", state.us_alt, (B, H, m)),
              ("cost", state.cost, (B,)), ("trace", state.trace, (B, state.trace.shape[1]))]
    if costs is not None:
        checks += [("costs", costs, (B, K)), ("cand", cand, (B, K, H, m))]
    if cost_new is not None:
        checks.append(("cost_new", cost_new, (B,)))
    if rows == ROWS_CANDIDATES:
        checks += [("draw", draw, (B, K, H, m)), ("sigma", sigma, (1,)), ("norm", norm, (H,))]
    kernels.check_tensors(checks, dev)
    writes_trace = costs is not None and s.fused or cost_new is not None
    if writes_trace and not 0 <= trace_col < state.trace.shape[1]:
        raise ValueError(f"mppi_update: trace column {trace_col} of {state.trace.shape[1]}")
    R = {ROWS_CANDIDATES: K, ROWS_US: 1, ROWS_ALT: 1, ROWS_BOTH: 2}[rows]
    out = torch.empty(B, R, H, m, dtype=torch.float32, device=dev)
    q_des = lower = upper = None
    src, sign = _NO_MAP
    if s.iface is not None:
        if s.iface.motor_control_mode != "PD":
            raise ValueError("mppi_update: joint targets only through a PD interface")
        kernels.check_tensors([("lower_lim", s.iface.lower_lim, (12,)),
                               ("upper_lim", s.iface.upper_lim, (12,))], dev)
        q_des = torch.empty(B, R, H, 12, dtype=torch.float32, device=dev)
        src, sign = pd_command_map(s.iface)
        lower, upper = s.iface.lower_lim, s.iface.upper_lim
    if B == 0:
        return state, out, q_des
    ptr = lambda t: None if t is None else t.data_ptr()
    rcp, lp_a, lp_b = float32_constants(s.temperature)
    args = [ptr(costs), ptr(cand), ptr(cost_new), ptr(draw), ptr(sigma), ptr(norm), ptr(lower),
            ptr(upper), ptr(state.us), ptr(state.us_alt), ptr(state.cost), ptr(state.trace),
            ptr(out), ptr(q_des), B, K, H, m, s.n_elite, trace_col, state.trace.shape[1], rows,
            int(s.fused), int(s.smooth), rcp, s.u_min, s.u_max, lp_a, lp_b, src, sign]
    kernels.launch(dev, "mppi_update", kernels.library().mppi_update, args)
    mppi_update.launches += 1
    return state, out, q_des


def mppi_update(state: UpdateState, settings: UpdateSettings, *, costs=None, cand=None,
                cost_new=None, trace_col: int = 0, rows: int = ROWS_CANDIDATES, draw=None,
                sigma=None, norm=None):
    """One MPPI update of B problems (see the module docstring).

    state: UpdateState. costs (B,K) and cand (B,K,H,m): the last rollout's
    candidates and their costs (proposal); cost_new (B,): the proposal's
    cost (the plain branch's accept); trace_col: the trace's column either
    writes; rows: which rows to return; draw (B,K,H,m) standard-normal,
    sigma (1,) σ_i and norm (H,) lowpass_norm for ROWS_CANDIDATES. float32
    and contiguous; on CUDA tensors the `mppi_update` kernel launches once
    (an error raises) and updates the state's tensors in place, on CPU
    tensors mppi_update_plain runs. Returns (state, rows (B,R,H,m), their
    joint targets (B,R,H,12) or None).
    """
    if state.us.device.type == "cpu":
        return mppi_update_plain(state, settings, costs=costs, cand=cand, cost_new=cost_new,
                                 trace_col=trace_col, rows=rows, draw=draw, sigma=sigma,
                                 norm=norm)
    if state.us.device.type != "cuda":
        raise ValueError(f"mppi_update: no kernel for device {state.us.device}")
    return _launch(state, settings, costs, cand, cost_new, trace_col, rows, draw, sigma, norm)


mppi_update.launches = 0   # `mppi_update` kernel
