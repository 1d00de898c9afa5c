"""Rank-sharded parallel-in-time Riccati: the time axis over the ranks.

Port of ``quadruped_springs_tpu.parallel.riccati``. The within-device
parallel sweep (``solver/ilqr._parallel_lqt_backward``) composes
conditional-value-function elements with a reverse associative scan. Here
the H+1 elements, padded with identity elements to a multiple of the world
size D, split into D contiguous blocks, one per rank. Each rank runs the
local reverse scan of its block (the recursive doubling of
``ilqr._reverse_scan``), the D block totals are exchanged with one
``all_gather``, each rank folds the suffix of the later blocks locally,
and the next-knot value function crosses each block boundary through a
second ``all_gather`` of every block's first element (the halo; with one
rank it wraps onto the rank's own block, and only the padded tail reads it,
as the JAX ``ppermute`` does). A last ``all_gather`` assembles the value
functions, and every rank computes all gains.

As in the JAX module: at this problem's scale (n=37, H=50) the scan is
slower than the sequential sweep; time-axis sharding is for long horizons.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from quadruped_springs_tpu_torch.parallel.mesh import _position
from quadruped_springs_tpu_torch.solver.ilqr import (
    _reverse_scan,
    lqt_combine,
    lqt_elements,
    lqt_gains,
    lqt_identity_element,
)


def _all_gather(t: torch.Tensor, world: int) -> list:
    """Every rank's `t` in rank order (the tensor itself on one rank
    without a process group)."""
    if not dist.is_initialized():
        return [t]
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t.contiguous())
    return out


def sharded_lqt_backward(A, B, lx, lu, lxx, luu, lux, VxT, VxxT, reg, mesh=None):
    """Backward LQ sweep for P problems with the time axis split over the
    ranks of `mesh` (of the default group when None).

    Arguments as ilqr.lqt_elements: A (P,H,n,n), ..., VxT (P,n), VxxT
    (P,n,n), reg (P,), the whole horizon on every rank. Returns (ks (P,H,m),
    Ks (P,H,m,n)) on every rank.
    """
    P, H, n = A.shape[0], A.shape[1], A.shape[-1]
    idx, D = _position(mesh)
    elems, R = lqt_elements(A, B, lx, lu, lxx, luu, lux, VxT, VxxT, reg)

    # pad the H+1 elements to a multiple of D with identity elements (they
    # compose neutrally, so the composites of real indices are unaffected)
    L = -(-(H + 1) // D)
    ident = lqt_identity_element(n, A.dtype, (P, L * D - (H + 1)), A.device)
    block = tuple(torch.cat([e, i], dim=1)[:, idx * L:(idx + 1) * L]
                  for e, i in zip(elems, ident))

    # local reverse scan: comp[:, j] covers [j .. block end]
    comp = _reverse_scan(block)
    totals = [_all_gather(c[:, 0], D) for c in comp]       # block k's composite
    # suffix = composite of the blocks after this one (none for the last)
    if idx < D - 1:
        suffix = tuple(t[D - 1] for t in totals)
        for k in range(D - 2, idx, -1):
            suffix = lqt_combine(suffix, tuple(t[k] for t in totals))
        comp = lqt_combine(tuple(s[:, None].expand_as(c) for s, c in zip(suffix, comp)),
                           comp)
    S_loc, s_loc = comp[4], -comp[3]                       # (P,L,n,n), (P,L,n)

    # halo: the next knot's value function for the block's last element is
    # the next block's first (wrapping onto block 0 from the last block)
    S_first, s_first = _all_gather(S_loc[:, 0], D), _all_gather(s_loc[:, 0], D)
    nxt = (idx + 1) % D
    S1 = torch.cat([S_loc[:, 1:], S_first[nxt][:, None]], dim=1)
    s1 = torch.cat([s_loc[:, 1:], s_first[nxt][:, None]], dim=1)
    # S1[:, k] = value at knot k+1; the gains need knots 0..H-1
    S1 = torch.cat(_all_gather(S1, D), dim=1)[:, :H]
    s1 = torch.cat(_all_gather(s1, D), dim=1)[:, :H]
    return lqt_gains(S1, s1, A, B, R, lu, lux)
