"""The committed policies and the port's entry points on the CPU.

Each of the six files under examples/policies/ is loaded into the port
through numpy (``convert.load_*``) and gives the JAX package's action on the
same observations to 1e-5; the replay and the trainer bench run at a tiny
size; the new entry points raise without a CUDA card unless asked for the
CPU; and no module of the port imports jax, flax, optax, orbax or the JAX
package.
"""

import ast
import dataclasses
import importlib
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.train import networks as jnets
from quadruped_springs_tpu.train import normalize as jnorm
from quadruped_springs_tpu_torch import convert, policy_replay, train_bench
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.train import normalize as tnorm
from quadruped_springs_tpu_torch.train.ars import ARSConfig, ARSTrainer
from quadruped_springs_tpu_torch.train.networks import linear_policy_apply
from quadruped_springs_tpu_torch.train.ppo import PPOConfig, PPOTrainer

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ROOT / "examples" / "policies"


def _obs(dim, n=7, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, dim)) * rng.uniform(0.1, 5.0, dim)).astype(np.float32)


def _jax_norm(d, prefix=""):
    return jnorm.RunningNorm(*(jnp.asarray(d[prefix + k]) for k in ("mean", "var", "count")))


def test_every_committed_policy_file_is_covered():
    assert sorted(p.name for p in POLICIES.glob("*.npz")) == [
        "backflip_ars.npz", "backflip_landing_mlp.npz", "backflip_launch_robust.npz",
        "backflip_two_stage.npz", "continuous_policy.npz", "forward_ars.npz"]


@pytest.mark.parametrize("name", ["backflip_ars", "backflip_launch_robust", "forward_ars"])
def test_linear_policy_file_gives_the_jax_action(name):
    d = np.load(POLICIES / f"{name}.npz")
    W, on = convert.load_linear_policy(POLICIES / f"{name}.npz", "cpu")
    assert W.dtype == on.mean.dtype == on.count.dtype == torch.float32
    obs = _obs(W.shape[1])
    jon = _jax_norm(d)
    want = jax.vmap(jnets.linear_policy_apply, (None, 0))(
        jnp.asarray(d["W"], jnp.float32), jnorm.normalize(jon, jnp.asarray(obs)))
    got = linear_policy_apply(W, tnorm.normalize(on, torch.from_numpy(obs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert 0.0 < float(np.abs(np.asarray(want)).mean()) < 1.0


def test_small_mlp_file_gives_the_jax_action():
    """backflip_landing_mlp.npz as examples/run_backflip_closed_loop.py
    applies it: on observations normalised by the launch policy's statistics."""
    m = np.load(POLICIES / "backflip_landing_mlp.npz")
    d = np.load(POLICIES / "backflip_launch_robust.npz")
    apply, own = convert.load_small_mlp(POLICIES / "backflip_landing_mlp.npz", "cpu")
    _, on = convert.load_linear_policy(POLICIES / "backflip_launch_robust.npz", "cpu")
    np.testing.assert_allclose(own.mean, m["mean"], rtol=1e-6)
    obs = _obs(27, seed=1)
    o = jnorm.normalize(_jax_norm(d), jnp.asarray(obs))
    mlp = {k: jnp.asarray(m[k], jnp.float32) for k in ("W1", "b1", "W2", "b2")}
    want = jax.vmap(lambda x: jnp.clip(
        mlp["W2"] @ jnp.tanh(mlp["W1"] @ x + mlp["b1"]) + mlp["b2"], -1.0, 1.0))(o)
    got = apply(tnorm.normalize(on, torch.from_numpy(obs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,obs_dim", [("backflip_two_stage", 27), ("continuous_policy", 29)])
def test_flat_flax_policy_file_gives_the_jax_action(name, obs_dim):
    """The flattened-leaves layout, read back on the JAX side by the loader
    of examples/train_continuous_policy.py."""
    from examples.train_continuous_policy import load_policy

    path = str(POLICIES / f"{name}.npz")
    jnet = jnets.MLPPolicy(6, (64, 64))
    params, jon = load_policy(path, jnet, obs_dim)
    net, on = convert.load_flat_mlp_policy(path, "cpu")
    assert net.hidden == (64, 64) and net.pi_0.in_features == obs_dim
    obs = _obs(obs_dim, seed=2)
    jm, jls, jv = jnet.apply(params, jnorm.normalize(jon, jnp.asarray(obs)))
    with torch.no_grad():
        tm, tls, tv = net(tnorm.normalize(on, torch.from_numpy(obs)))
    np.testing.assert_allclose(torch.clamp(tm, -1, 1), jnp.clip(jm, -1.0, 1.0), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tls.detach(), jls, rtol=0, atol=0)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)


def test_flat_loader_rejects_another_leaf_count(tmp_path):
    path = tmp_path / "short.npz"
    np.savez(path, n_leaves=np.asarray(3), leaf_0=np.zeros(6), on_mean=np.zeros(2),
             on_var=np.ones(2), on_count=np.asarray(1.0))
    with pytest.raises(ValueError, match="3 leaves"):
        convert.load_flat_mlp_policy(path, "cpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_port_imports_nothing_of_jax_or_the_jax_package():
    """Every import statement of the port's package and of chip_smoke.py
    (comments and docstrings do not count)."""
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "quadruped_springs_tpu"}
    files = sorted((ROOT / "quadruped_springs_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 40
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in banned]
    assert not bad, bad
    # the walk covers the scale-out and utility modules, and they import
    walked = {str(f.relative_to(ROOT / "quadruped_springs_tpu_torch")) for f in files[:-1]}
    for name in ("graft_entry", "parallel/mesh", "parallel/scenarios", "parallel/riccati",
                 "utils/verification", "utils/lcp_oracle", "utils/monitor", "utils/render",
                 "utils/camera", "utils/profiling", "utils/sanitize", "utils/timer",
                 "utils/registry"):
        assert f"{name}.py" in walked, name
        importlib.import_module("quadruped_springs_tpu_torch." + name.replace("/", "."))
    # the check sees an import where there is one
    assert "jax" in set(_imports(Path(__file__)))


def test_new_entry_points_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        QuadrupedEnv(EnvConfig(settling_steps=0))
    for fn in (policy_replay.backflip, policy_replay.backflip_robust, policy_replay.forward,
               policy_replay.two_stage, policy_replay.continuous):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(lanes=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_bench.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        policy_replay.main(["--behavior", "forward", "--lanes", "1"])
    # the trainers run where their env lives
    env = QuadrupedEnv(EnvConfig(settling_steps=0, max_ep_len=0.05), device="cpu")
    gen = torch.Generator().manual_seed(0)
    assert ARSTrainer(env).init(gen).W.device.type == "cpu"
    assert PPOTrainer(env).make_net(0).log_std.device.type == "cpu"


def test_forward_replay_on_cpu_meets_the_gate(capsys):
    """`policy_replay --behavior forward` on one nominal lane with the
    600-substep settle: the jumping-forward gate's bars (forward >= 0.30 m,
    apex >= 0.10 m, final z > 0.15), and one JSON record."""
    recs = policy_replay.main(["--device", "cpu", "--behavior", "forward", "--lanes", "2",
                               "--settle", "600"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["behavior"] == "forward" and line["passed"] == line["lanes"] == 2
    assert line == json.loads(json.dumps(recs[0]))
    assert min(line["fwd_distance_m"]) >= 0.30 and min(line["apex_rel_m"]) >= 0.10
    assert min(line["final_z"]) > 0.15
    assert line["bars"] == {"fwd_distance_m": 0.30, "apex_rel_m": 0.10, "final_z": 0.15}


def test_backflip_replay_sets_the_gate_lane_and_scores_by_the_bars():
    """A cut backflip replay (settle 100, 3 policy steps): lane 0 carries the
    gate's friction, the others their draws; a robot that has not flipped
    fails the rotation bar."""
    rec = policy_replay.backflip(lanes=3, device="cpu", settle=100, max_steps=3)
    assert rec["friction"][0] == pytest.approx(policy_replay.GATE_FRICTION)
    assert all(0.5 <= f <= 1.0 for f in rec["friction"])
    assert rec["passed"] == 0 and rec["full_rotation"] == 0 and rec["ok"] == [False] * 3
    assert rec["bars"]["pitch_rad"] == pytest.approx(2 * np.pi - 0.1)
    # the lanes the policy is held to: the gate's, and every draw from the edge up
    assert rec["gated"] == [f >= policy_replay.UPRIGHT_FRICTION_EDGE for f in rec["friction"]]
    assert rec["gated"][0] and rec["gated_lanes"] == sum(rec["gated"])
    assert rec["gated_passed"] == 0


def test_train_bench_main_tiny_on_cpu(monkeypatch):
    """`train_bench.run` at a few lanes and steps with narrow nets, one
    warm-up and two timed steps, printed as `main` prints it; the polish's
    config and BC fit cut by the constants the bench reads."""
    monkeypatch.setattr(train_bench.st, "POLISH_PPO", dataclasses.replace(
        train_bench.st.POLISH_PPO, n_envs=3, segment_len=4, reset_bank_size=2))
    monkeypatch.setattr(train_bench.st, "BC_ITERS", 20)
    rec = train_bench.run(
        steps=2, device="cpu", settle=20,
        ars_config=ARSConfig(n_directions=2, top_directions=1, episode_steps=4,
                             reset_bank_size=2),
        ppo_config=PPOConfig(n_envs=3, segment_len=4, reset_bank_size=2, hidden=(8, 8),
                             kl_stop=0.03))
    line = json.loads(json.dumps(train_bench.public(rec)))
    assert line["device"] == "cpu" and "on cpu" in line["metric"]
    assert line["steps"] == 2 and line["warmup_steps"] == 1
    for algo in ("ars", "ppo", "imitation"):
        r = line[algo]
        assert r["steps_per_s"] > 0 and r["env_steps_per_s"] > 0
        assert r["launches"] == {"env_substeps": 0, "actuation": 0, "contact_anchored": 0,
                                 "contact": 0}
        assert r["host_syncs"] == [0, 0, 0] and len(r["metrics"]) == 3
        assert all(np.isfinite(v) for m in r["metrics"] for v in m.values())
        assert "state" not in r
    assert line["ars"]["lanes"] == 8 and line["ppo"]["lanes"] == 3
    assert 0 < line["ppo"]["rollout_seconds"] and line["ppo"]["update_share"] < 1
    assert rec["ars"]["state"].iteration == rec["ppo"]["state"].iteration == 3
    # ARS moves W in a step unless its top returns are all equal; PPO moves the actor
    assert all(m["max_weight_change"] > 0 or m["sigma_r"] < 1e-7
               for m in rec["ars"]["metrics"])
    assert all(m["max_weight_change"] > 0 for m in rec["ppo"]["metrics"])
    # the polish: the BC fit on the six committed demos, its frozen statistics
    # and anchor; every step moves the actor and keeps the statistics
    im = rec["imitation"]
    assert im["demos"] == 6 and im["bc_rows"] == 6 * 185 and im["bc_iters"] == 20
    assert im["bc_seconds"] > 0 and np.isfinite(im["bc_mse"]) and im["lanes"] == 3
    assert all(m["max_weight_change"] > 0 and m["bc_mse"] > 0 for m in im["metrics"])
    assert im["state"].obs_norm is im["state0"].obs_norm and im["state"].iteration == 3
    assert os.environ.get("JAX_PLATFORMS") == "cpu"
