"""The MPPI update between two rollouts (quadruped_springs_tpu_torch/solver/
mppi_update.py) on the CPU: its plain version against the steps of JAX's
``iteration`` and ``iteration_fused`` (taken from mppi.solve's source with
ast, the costs injected where their rollouts would be, JAX's draws given to
the port); the CUDA kernel's body (csrc/mppi_update.cuh), built for the CPU
with g++ by tests/mppi_update_host.cpp, against the plain version over a
solve's sequence of launches, each problem also launched alone (bitwise).
The kernel itself runs on the card in tests/test_torch_kernels.py and
chip_smoke.py."""

import ast
import ctypes
import functools
import inspect
import shutil
import subprocess
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.solver import mppi as jmppi
from quadruped_springs_tpu_torch import kernels
from quadruped_springs_tpu_torch.control import interfaces as ci
from quadruped_springs_tpu_torch.models import spatial as sp
from quadruped_springs_tpu_torch.models.go1_params import go1_config
from quadruped_springs_tpu_torch.solver import mppi_update as mu

INF, NAN = float("inf"), float("nan")


def _jax_iterations(config, K, H, m, costs, cost_new):
    """JAX's `iteration` and `iteration_fused`, exec'd from mppi.solve's
    source with the costs of their rollouts injected: `jax.vmap` of the
    candidates' rollout returns `costs`, the accept rollout `cost_new`."""
    fn = ast.parse(textwrap.dedent(inspect.getsource(jmppi.solve))).body[0]
    bodies = [n for n in fn.body if isinstance(n, ast.FunctionDef)
              and n.name in ("iteration", "iteration_fused")]
    ns = dict(jnp=jnp, jax=types.SimpleNamespace(vmap=lambda f: f, random=jax.random,
                                                 lax=jax.lax),
              K=K, H=H, m=m, config=config, n_elite=max(int(K * config.elite_frac), 1),
              clip_u=lambda u: jnp.clip(u, config.u_min, config.u_max),
              rollout_sample=lambda cand: (None, jnp.asarray(costs)),
              rollout=lambda us: (None, jnp.asarray(cost_new)))
    exec(compile(ast.Module(body=bodies, type_ignores=[]), "<jax mppi.solve>", "exec"), ns)
    return ns["iteration"], ns["iteration_fused"]


def _costs(case: str, K: int, seed: int):
    """The candidates' costs of a case: "random"; "tie_at_kth" (the
    n_elite-th and the next smallest equal); "nonfinite" (inf, -inf, NaN);
    "one_finite" (all but the first inf); "k2" (K = 2: n_elite 1). A
    fixed index past K wraps."""
    rng = np.random.default_rng(seed)
    c = (-60.0 + rng.standard_normal(K)).astype(np.float32)
    if case == "tie_at_kth":
        order = np.argsort(c)
        c[order[K // 2]] = c[order[K // 2 - 1]]
    elif case == "nonfinite":
        for i, v in ((1, INF), (4, -INF), (6, NAN)):
            c[i % K] = v
    elif case == "one_finite":
        c[1:] = INF
    return c


CASES = {"random": 16, "tie_at_kth": 16, "nonfinite": 16, "one_finite": 16, "k2": 2}
H, M = 6, 6


@functools.lru_cache(maxsize=None)
def _iface():
    return ci.make_interface(go1_config(True, "cpu"), "PD", "SYMMETRIC", "JUMPING_IN_PLACE")


@pytest.mark.parametrize("fused", [False, True], ids=["accept", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_iteration(case, fused):
    """One iteration: the candidates from JAX's draws of one key, their
    injected costs, the proposal and (fused) the best tracking or (accept)
    the accept test, against JAX's iteration_fused / iteration on the same
    state. Costs, the trace and the best candidate (a candidate itself:
    clip(us + eps)) to 1e-6 (the two packages' low-pass and renormalisation
    round alike but for their pow and sqrt); the proposal, a weighted mean
    summed in another order (einsum against sum_fixed) after exp, to
    1e-5, as tests/test_torch_mppi.py holds the whole solve."""
    K = CASES[case]
    cfg = jmppi.MPPIConfig(horizon=H, iterations=2, n_samples=K, fused_accept=fused)
    tcfg = dict(fused=fused, smooth=True, n_elite=max(int(K * cfg.elite_frac), 1),
                temperature=cfg.temperature, u_min=cfg.u_min, u_max=cfg.u_max)
    rng = np.random.default_rng(len(case) + 10 * fused)
    us = np.clip(0.4 * rng.standard_normal((H, M)), -1, 1).astype(np.float32)
    us_best = np.clip(0.4 * rng.standard_normal((H, M)), -1, 1).astype(np.float32)
    costs = _costs(case, K, 3)
    cost0, cost_new = np.float32(-59.5), np.float32(-60.5 if case == "random" else -58.0)
    key = jax.random.PRNGKey(len(case))
    sigma = np.float32(0.3 * 0.93)
    draw = np.asarray(jax.random.normal(key, (K, H, M), jnp.float32))
    iteration, iteration_fused = _jax_iterations(cfg, K, H, M, costs, cost_new)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))[None]
    state = mu.UpdateState(t(us), t(us_best), t(cost0), torch.zeros(1, 2))
    s = mu.UpdateSettings(**tcfg, iface=_iface())
    kw = dict(sigma=torch.tensor([sigma]), norm=mu.lowpass_norm(H))
    state, cand, q_des = mu.mppi_update_plain(state, s, draw=t(draw), **kw)
    np.testing.assert_array_equal(q_des.numpy(), ci.action_to_command(_iface(), cand).numpy())
    if fused:
        (j_prop, j_best, j_cost), j_trace = iteration_fused(
            (jnp.asarray(us), jnp.asarray(us_best), jnp.float32(cost0)), (key, sigma))
        state, rows, _ = mu.mppi_update_plain(state, s, costs=t(costs), cand=cand,
                                              trace_col=1, rows=mu.ROWS_BOTH, **kw)
        got_prop, got_best = state.us, state.us_alt
        np.testing.assert_array_equal(rows[:, 0].numpy(), state.us.numpy())
        np.testing.assert_array_equal(rows[:, 1].numpy(), state.us_alt.numpy())
    else:
        (j_prop, j_cost), j_trace = iteration((jnp.asarray(us), jnp.float32(cost0)),
                                              (key, sigma))
        state, prop, _ = mu.mppi_update_plain(state, s, costs=t(costs), cand=cand,
                                              rows=mu.ROWS_ALT, **kw)
        np.testing.assert_array_equal(prop[:, 0].numpy(), state.us_alt.numpy())
        state, _, _ = mu.mppi_update_plain(state, s, cost_new=t(cost_new), trace_col=1,
                                           rows=mu.ROWS_US)
        got_prop, got_best = state.us, None
    np.testing.assert_array_equal(state.cost.numpy(), [j_cost])
    np.testing.assert_array_equal(state.trace[0, 1].numpy(), j_trace)
    np.testing.assert_allclose(got_prop[0].numpy(), j_prop, rtol=1e-5, atol=1e-5)
    if got_best is not None:
        np.testing.assert_allclose(got_best[0].numpy(), j_best, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got_prop.numpy()).all()


# --- the kernel's body, built for the CPU ------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel's body built with g++ (tests/mppi_update_host.cpp), once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's body for the CPU")
    src = Path(__file__).with_name("mppi_update_host.cpp")
    lib = tmp_path_factory.mktemp("host_build") / "libmppi_update_host.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    lib.mppi_update_host.argtypes = kernels.MPPI_UPDATE_ARGTYPES
    lib.mppi_update_host.restype = ctypes.c_int
    lib.mppi_update_host_sum.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    lib.mppi_update_host_sum.restype = ctypes.c_int
    lib.mppi_update_host_smem.argtypes = [ctypes.c_int] * 3
    lib.mppi_update_host_smem.restype = ctypes.c_int64
    lib.mppi_update_host_shape.argtypes = ([ctypes.c_int] * 3
                                           + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    lib.mppi_update_host_shape.restype = None
    lib.mppi_update_host_set_shape.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mppi_update_host_set_shape.restype = None
    return lib


def _shaped(host_lib, threads, group):
    """The host build's launcher with `threads` threads a block and `group`
    groups of 4 rows a slot (0, 0: update_shape's for an H100, as the
    card's launcher picks them)."""
    def fn(*args):
        host_lib.mppi_update_host_set_shape(threads, group)
        try:
            return host_lib.mppi_update_host(*args)
        finally:
            host_lib.mppi_update_host_set_shape(0, 0)
    return fn


def _host_update(host, state, settings, **kw):
    """mppi_update's launch with the host build as its kernel, on copies of
    the state's tensors."""
    state = mu.UpdateState(*(t.clone() for t in (state.us, state.us_alt, state.cost,
                                                   state.trace)))
    lib = types.SimpleNamespace(mppi_update=host)
    launch = lambda dev, name, fn, args: kernels.check_launch(name, fn(*args, None))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "library", lambda: lib)
        mp.setattr(kernels, "launch", launch)
        return mu._launch(state, settings, kw.get("costs"), kw.get("cand"),
                          kw.get("cost_new"), kw.get("trace_col", 0),
                          kw.get("rows", mu.ROWS_CANDIDATES), kw.get("draw"),
                          kw.get("sigma"), kw.get("norm"))


def _solve_sequence(update, B, K, H, m, fused, iface, seed):
    """A solve's launches (solver/mppi.py solve_costed) through `update`,
    with seeded costs in place of the rollouts': the costs of problem b
    follow case b % 4 of _costs (ties, non-finite, all but one inf)."""
    g = torch.Generator().manual_seed(seed)
    s = mu.UpdateSettings(fused=fused, smooth=True, n_elite=max(K // 2, 1), temperature=0.05,
                          u_min=-1.0, u_max=1.0, iface=iface)
    norm, sigmas = mu.lowpass_norm(H), torch.tensor([0.3, 0.279, 0.259])
    us0 = torch.clamp(0.6 * torch.randn(B, H, m, generator=g), -1, 1)
    draw = lambda i: dict(rows=mu.ROWS_CANDIDATES, sigma=sigmas[i:i + 1], norm=norm,
                          draw=torch.randn(B, K, H, m, generator=g))
    names = ("random", "tie_at_kth", "nonfinite", "one_finite")

    def costs(i):
        c = np.stack([_costs(names[b % 4], K, seed + 7 * b + i) for b in range(B)])
        return torch.from_numpy(c)

    if fused:
        state = mu.UpdateState(us0, us0.clone(), torch.full((B,), INF), torch.zeros(B, 2))
        state, cand, _ = update(state, s, **draw(0))
        for i in range(2):
            nxt = dict(rows=mu.ROWS_BOTH) if i == 1 else draw(i + 1)
            state, cand, _ = update(state, s, costs=costs(i), cand=cand, trace_col=i, **nxt)
        return s
    state = mu.UpdateState(us0, torch.zeros_like(us0), torch.full((B,), -60.0),
                           torch.zeros(B, 2))
    state, cand, _ = update(state, s, **draw(0))
    for i in range(2):
        state, _, _ = update(state, s, costs=costs(i), cand=cand, rows=mu.ROWS_ALT)
        cost_new = -60.0 + torch.randn(B, generator=g)
        nxt = dict(rows=mu.ROWS_US) if i == 1 else draw(i + 1)
        state, cand, _ = update(state, s, cost_new=cost_new, trace_col=i, **nxt)
    return s


def _fields(step):
    state, rows, q = step
    return [state.us, state.us_alt, state.cost, state.trace, rows] + ([] if q is None else [q])


# (B, K, H, m, fused, PD joint targets): 17 problems (every cost case); K =
# 32 and 64, the compiled instantiations (the mean's chunks in sum_fixed's
# order), in both accept branches, with and without targets; K = 48, 5, 3
# and 2 the general one (the products' columns); H·m = 288 (the weighted
# mean over more elements than threads); H·m = 30, 150 and 28 (rows that
# start off a 16-byte boundary: 4-byte copies at their ends, scalar stores;
# K = 5 at H·m = 30: chunks of draws that start off one)
BODY_CASES = {"B17_K5-fused": (17, 5, 4, 6, True, True),
              "B17_K5-accept": (17, 5, 4, 6, False, True),
              "B3_K64_m12-fused": (3, 64, 8, 12, True, True),
              "B2_K3_H24_m12-accept": (2, 3, 24, 12, False, False),
              "B4_K2-fused": (4, 2, 8, 6, True, True),
              "B9_K32-fused": (9, 32, 6, 6, True, True),
              "B9_K32-accept": (9, 32, 6, 6, False, True),
              "B4_K32_H25-fused-no_targets": (4, 32, 25, 6, True, False),
              "B5_K64_H5-accept": (5, 64, 5, 6, False, True),
              "B4_K64-fused-no_targets": (4, 64, 4, 6, True, False),
              "B5_K48-fused": (5, 48, 6, 6, True, True),
              "B4_K48_m4-accept-no_targets": (4, 48, 7, 4, False, False),
              "B3_K5_H5-fused": (3, 5, 5, 6, True, True)}


@pytest.mark.parametrize("body_case", list(BODY_CASES))
def test_kernel_body_on_the_host_matches_plain(body_case, host_lib):
    """The kernel's body built with g++ against mppi_update_plain over a
    solve's sequence of launches (the candidates, then per iteration the
    proposal with the fused accept's best tracking, or the proposal and the
    accept, then the settle's or the final rows), each launch on the plain
    version's inputs: every output bitwise, the costs, trace and rows, the
    joint targets through the PD map (`pd_command_map`). The batch runs
    as the headline's launch does (128 threads a block, one group of 4 rows
    a slot: a ring of chunks); each problem also launched alone as an
    H100's launch of one problem runs (512 threads, its rows in one or two
    chunks): bitwise the same."""
    B, K, H_, m, fused, pd = BODY_CASES[body_case]
    iface = None
    if pd:
        iface = _iface() if m == 6 else ci.make_interface(
            go1_config(True, "cpu"), "PD", {12: "DEFAULT", 4: "SYMMETRIC_NO_HIP"}[m], "BACKFLIP")
    calls = []

    def plain(state, s, **kw):
        out = mu.mppi_update_plain(state, s, **kw)
        calls.append((state, kw, out))
        return out

    s = _solve_sequence(plain, B, K, H_, m, fused, iface, seed=B + K)
    for i, (state, kw, want) in enumerate(calls):
        got = _fields(_host_update(_shaped(host_lib, 128, 1), state, s, **kw))
        for j, (x, y) in enumerate(zip(_fields(want), got)):
            np.testing.assert_array_equal(y.numpy(), x.numpy(), err_msg=f"call {i} field {j}")
        for p in range(B):
            one = lambda t: t[p:p + 1].contiguous()
            st = mu.UpdateState(*(one(t) for t in (state.us, state.us_alt, state.cost,
                                                   state.trace)))
            kw_p = {k: (one(v) if k in ("costs", "cand", "cost_new", "draw") else v)
                    for k, v in kw.items()}
            for x, y in zip(got, _fields(_host_update(_shaped(host_lib, 0, 0), st, s, **kw_p))):
                np.testing.assert_array_equal(x[p:p + 1].numpy(), y.numpy())


def test_pd_command_map_matches_action_to_command():
    """The kernel's joint map, for each action space and both mirror
    indices: action_to_command of a random action equals the map's scaled
    command."""
    cfg = go1_config(True, "cpu")
    rng = np.random.default_rng(0)
    for mode in ci.ACTION_MODES:
        for task in ("JUMPING_IN_PLACE", "BACKFLIP"):
            iface = ci.make_interface(cfg, "PD", mode, task)
            a = torch.from_numpy(rng.uniform(-1.2, 1.2, (5, iface.action_dim)).astype(
                np.float32))
            src, sign = mu.pd_command_map(iface)
            full = torch.stack([a[:, s] * g if s >= 0 else torch.zeros(5)
                                for s, g in zip(src, sign)], dim=-1)
            np.testing.assert_array_equal(ci.action_to_command(iface, a).numpy(),
                                          ci.scale_action_to_command(iface, full).numpy())


@pytest.mark.parametrize("K", [32, 64])
def test_warp_sum_fixed_on_the_host_matches_sum_fixed(K, host_lib):
    """The scalars' sum_fixed over warp 0 (csrc/mppi_update.cuh
    warp_sum_fixed: the halves at 16, 8 and 4 by shuffles, lanes 0-3
    chained; K = 64 its lanes' two halves first), built with g++ and its
    shuffles on 32 host threads, against models/spatial.sum_fixed: bitwise
    over weights spanning 40 binades, zeros, inf and NaN."""
    rng = np.random.default_rng(K)
    w = (rng.standard_normal((24, K)) * 10.0 ** rng.uniform(-20, 20, (24, K))).astype(np.float32)
    w[1, ::3] = 0.0
    w[2, 5], w[3, 9], w[4, K - 1] = INF, NAN, -INF
    w = np.ascontiguousarray(w)
    out = np.zeros(len(w), np.float32)
    assert host_lib.mppi_update_host_sum(w.ctypes.data, K, len(w), out.ctypes.data) == 0
    want = sp.sum_fixed(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(out, want)


def test_wrapper_constants_and_shared_bytes(host_lib):
    """The wrapper's float32 λ⁻¹ and low-pass constants, rounded once a
    temperature, equal torch.tensor(x, dtype=torch.float32)'s; its shared
    memory check mirrors the kernel's layout (update_smem_bytes) at every
    width an MPPI path launches and at K outside the compiled set; the
    launch's shape (threads a block, groups a slot) at the headline, full
    rate, a behaviour and the comparison."""
    for temperature in (0.05, 0.1, 0.07, 1.0 / 3.0):
        want = [float(torch.tensor(v, dtype=torch.float32))
                for v in (1.0 / temperature, mu.LOWPASS_A, mu.LOWPASS_B)]
        assert mu.float32_constants(temperature) == tuple(want)
    for K, H, m in ((32, 50, 6), (32, 25, 6), (64, 30, 6), (64, 24, 12), (32, 40, 6),
                    (64, 50, 6), (48, 6, 6), (5, 4, 6), (2, 8, 6), (3, 7, 4), (300, 200, 12)):
        assert mu.shared_bytes(K, H, m) == host_lib.mppi_update_host_smem(K, H, m), (K, H, m)
    # 8 blocks an SM at the headline, one group a slot; one problem takes
    # all its rows in one chunk
    assert mu.shared_bytes(32, 50, 6) <= 27 * 1024
    shape = (ctypes.c_int * 2)()
    for (K, H, m, B), want in (((32, 50, 6, 1024), (128, 1)), ((32, 25, 6, 1024), (128, 2)),
                               ((64, 30, 6, 1), (512, 16)), ((64, 50, 6, 8), (512, 8))):
        host_lib.mppi_update_host_shape(K, H, m, B, 132, shape)
        assert tuple(shape) == want, (K, H, m, B)
