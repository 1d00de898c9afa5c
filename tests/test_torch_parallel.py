"""The port's scale-out (parallel/mesh.py, scenarios.py, riccati.py and
graft_entry.dryrun_multichip) on gloo ranks on the CPU, against the JAX
package.

One spawn of ranks per world size (2 and 4) runs every sharded path once
(tests/torch_parallel_worker.check_ranks); the tests below read its results:
the time-sharded Riccati sweep against JAX's sequential and single-device
parallel sweeps on tests/test_riccati_sharded.py's random LQ problems at
that test's tolerances, the scenario-sharded solve against the port's
unsharded solve_batch of the whole batch (bitwise), a NaN scenario flagged without
touching the other rows, and the global statistics against JAX's. Ranks are
joined with a timeout and killed on expiry; each spawn takes a free port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadruped_springs_tpu.parallel import scenarios as jscen
from quadruped_springs_tpu.solver import ilqr as jilqr
from quadruped_springs_tpu_torch import convert, graft_entry
from quadruped_springs_tpu_torch.parallel import mesh as pmesh
from quadruped_springs_tpu_torch.parallel.riccati import sharded_lqt_backward
from quadruped_springs_tpu_torch.solver import ilqr as tilqr
from tests import torch_parallel_worker as worker

RANK_TIMEOUT = 300.0   # seconds for a whole spawn; the ranks take ~20 s here


def _random_lq(key, H=50, n=7, m=3):
    """tests/test_riccati_sharded.py's LQ problem (JAX draws, float32)."""
    ks = jax.random.split(key, 8)
    A = 0.9 * jnp.eye(n) + 0.1 * jax.random.normal(ks[0], (H, n, n)) / n
    B = jax.random.normal(ks[1], (H, n, m)) / n
    lx = jax.random.normal(ks[2], (H, n))
    lu = jax.random.normal(ks[3], (H, m))
    W = jax.random.normal(ks[4], (H, n, n)) / n
    lxx = W @ W.swapaxes(-1, -2) + 0.5 * jnp.eye(n)
    V = jax.random.normal(ks[5], (H, m, m)) / (4 * m)
    luu = V @ V.swapaxes(-1, -2) + 1.0 * jnp.eye(m)
    lux = 0.1 * jax.random.normal(ks[6], (H, m, n))
    VxT = jax.random.normal(ks[7], (n,))
    VxxT = 2.0 * jnp.eye(n)
    return A, B, lx, lu, lxx, luu, lux, VxT, VxxT


@pytest.fixture(scope="module")
def lq():
    """The two LQ problems of tests/test_riccati_sharded.py with JAX's
    gains: "seq" (H=50, reg 1e-5) against the sequential sweep, "par"
    (H=37: H+1 divides over neither 2 nor 4 ranks, reg 1e-2) against the
    single-device parallel sweep."""
    seq = _random_lq(jax.random.PRNGKey(0))
    cfg = jilqr.ILQRConfig(horizon=50, reg_mode="control", pd_shift="gershgorin")
    ks_s, Ks_s, _, ok = jilqr.riccati_sequential(*seq[:7], seq[7], seq[8],
                                                 jnp.asarray(1e-5), cfg)
    assert bool(ok)
    par = _random_lq(jax.random.PRNGKey(1), H=37)
    ks_p, Ks_p, _, _ = jilqr._parallel_lqt_backward(*par, jnp.asarray(1e-2))
    return {"problems": {"seq": ([t.numpy() for t in convert.lq_problem(seq)], 1e-5),
                         "par": ([t.numpy() for t in convert.lq_problem(par)], 1e-2)},
            "want": {"seq": (np.asarray(ks_s), np.asarray(Ks_s)),
                     "par": (np.asarray(ks_p), np.asarray(Ks_p))}}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, lq):
    world = request.param
    outs = pmesh.launch(worker.check_ranks, world, (lq["problems"],), device="cpu",
                        timeout=RANK_TIMEOUT)
    return world, outs


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded solve_batch of the whole batch, in one call."""
    return {w: worker.unsharded_reference(2 * w) for w in (2, 4)}


# tests/test_riccati_sharded.py's tolerances
LQ_TOL = {"seq": dict(rtol=2e-3, atol=2e-4), "par": dict(rtol=1e-4, atol=1e-5)}


@pytest.mark.parametrize("name", ["seq", "par"])
def test_sharded_lqt_backward_matches_jax_sweeps(ranks, lq, name):
    world, outs = ranks
    ks_want, Ks_want = lq["want"][name]
    for out in outs:        # every rank returns every gain
        np.testing.assert_allclose(out[f"{name}_ks"][0], ks_want, **LQ_TOL[name])
        np.testing.assert_allclose(out[f"{name}_Ks"][0], Ks_want, **LQ_TOL[name])
    assert outs[0]["mesh_shape"] == (1, world)


def _gather(outs, tag, key):
    return np.concatenate([o[tag][key] for o in outs])


def test_sharded_solve_matches_unsharded_solve_batch(ranks, unsharded):
    """Each rank solves its rows [r·N/W, (r+1)·N/W) of the same N = 2W
    scenarios; together they equal one solve_batch of all N rows, bitwise:
    no step of a batched solve depends on the other problems of its batch
    or on its size (ROADMAP section 3)."""
    world, outs = ranks
    want = unsharded[world]
    assert [o["rows"] for o in outs] == [slice(2 * r, 2 * r + 2) for r in range(world)]
    np.testing.assert_array_equal(_gather(outs, "clean", "costs"), want["costs"])
    np.testing.assert_array_equal(_gather(outs, "clean", "us"), want["us"])
    assert not _gather(outs, "clean", "diverged").any()


def test_nan_scenario_is_flagged_and_isolated(ranks):
    """A NaN start in one row: that row is diverged; every other row's
    controls and cost are bitwise those of the clean batch."""
    _, outs = ranks
    diverged = _gather(outs, "nan", "diverged")
    assert diverged[worker.NAN_ROW] and diverged.sum() == 1
    keep = np.arange(len(diverged)) != worker.NAN_ROW
    for key in ("us", "costs"):
        np.testing.assert_array_equal(_gather(outs, "nan", key)[keep],
                                      _gather(outs, "clean", key)[keep])


def test_global_stats_match_jax(ranks):
    """The all-reduced mean / best / count on every rank equal JAX's
    global_stats of the whole batch (same NumPy inputs), with and without
    the NaN row."""
    _, outs = ranks
    for tag in ("clean", "nan"):
        want = jscen.global_stats(jnp.asarray(_gather(outs, tag, "costs")),
                                  jnp.asarray(_gather(outs, tag, "diverged")))
        for out in outs:
            np.testing.assert_allclose(out[tag]["mean_cost"], want["mean_cost"], rtol=1e-6)
            np.testing.assert_allclose(out[tag]["best_cost"], want["best_cost"], rtol=0)
            assert int(out[tag]["n_diverged"]) == int(want["n_diverged"])


def test_sharded_lqt_backward_on_one_rank_without_a_group(lq):
    """D = 1 with no process group: the halo wraps onto the rank's own
    block and only the padded tail reads it; the gains equal the port's
    single-device parallel sweep bitwise (the same elements, the same
    scan), and JAX's sequential sweep at its tolerance."""
    args, reg = lq["problems"]["seq"]
    t = [torch.from_numpy(a) for a in args]
    reg = torch.tensor([reg])
    ks, Ks = sharded_lqt_backward(*t, reg)
    ks_p, Ks_p, _, ok = tilqr._parallel_lqt_backward(*t, reg)
    assert bool(ok.all())
    np.testing.assert_array_equal(ks.numpy(), ks_p.numpy())
    np.testing.assert_array_equal(Ks.numpy(), Ks_p.numpy())
    np.testing.assert_allclose(ks[0].numpy(), lq["want"]["seq"][0], **LQ_TOL["seq"])


def test_scenario_rows_and_init_without_a_card():
    assert pmesh.scenario_rows(6) == slice(0, 6)
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.scenario_rows(3, _FakeMesh())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.init_distributed()
        with pytest.raises(RuntimeError, match="CUDA"):
            graft_entry.dryrun_multichip(2)


def test_launch_raises_for_a_failed_rank_and_kills_on_timeout():
    """A rank that raises fails the launch with its traceback; ranks still
    running at the timeout are killed and TimeoutError raised."""
    with pytest.raises(Exception, match="rank one fails on purpose"):
        pmesh.launch(worker.fail_on_rank_one, 2, (), "cpu", RANK_TIMEOUT)
    with pytest.raises(TimeoutError):
        pmesh.launch(worker.sleep_long, 2, (), "cpu", 20.0)


class _FakeMesh:
    """Two ranks, this one the second."""
    mesh = np.zeros((1, 2))

    def get_coordinate(self):
        return [0, 1]

    def size(self):
        return 2


def test_dryrun_multichip_on_two_gloo_ranks(capfd):
    """dryrun_multichip's rank function on two gloo ranks at a tiny size
    (batch 4, H = 4, 2 iterations): the same report line, statistics from
    the collectives."""
    stats = pmesh.launch(graft_entry._dryrun_rank, 2, (4, 4, 2), "cpu", RANK_TIMEOUT)
    assert stats[0] == stats[1]
    assert np.isfinite(stats[0]["mean_cost"]) and stats[0]["n_diverged"] == 0
    assert stats[0]["best_cost"] <= stats[0]["mean_cost"]
    assert "dryrun_multichip ok: 2 devices, batch 4" in capfd.readouterr().out
