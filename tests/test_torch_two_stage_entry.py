"""The two-stage trainers' entry points on the CPU at a cut size: the real
stages with every width, episode and budget cut (module constants patched,
so a run takes seconds), through `main --smoke --device cpu`. The results
carry exactly the key set the JAX scripts write (the forward artifact's for
both jumps: the older in-place artifact's keys are a subset; the backflip
artifact's for the flip), every number finite and the artifacts'
consistency invariants; the last printed line is the script's summary.
Then the exported flip policy read back by the port's loader and by the
JAX package's (examples/train_continuous_policy.load_policy), and the
refusals: no write under examples/, no card without --device cpu.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.train import networks as jnets
from quadruped_springs_tpu.train import normalize as jnorm
from quadruped_springs_tpu_torch import convert
from quadruped_springs_tpu_torch import train_two_stage as tts
from quadruped_springs_tpu_torch import train_two_stage_backflip as tbf
from quadruped_springs_tpu_torch.env import demo_pipeline as tdp
from quadruped_springs_tpu_torch.train import normalize as tnorm
from quadruped_springs_tpu_torch.train import two_stage as st
from quadruped_springs_tpu_torch.train.networks import MLPPolicy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_PPO = dict(n_envs=2, segment_len=4, reset_bank_size=2, n_epochs=1, n_minibatches=2)
SMALL_ARS = dict(n_directions=2, top_directions=1, episode_steps=3, reset_bank_size=2)


def _artifact(name):
    with open(os.path.join(ROOT, "examples", "out", name)) as f:
        return json.load(f)


@pytest.fixture
def cut(monkeypatch):
    """Every width and episode of both entry points cut: settle 20
    substeps, 3-step episodes, 2 lanes, 5 demo rows / flip knots, 5 BC
    iterations."""
    for mod in (tts, tbf):
        monkeypatch.setattr(mod, "SETTLE", 20)
    monkeypatch.setattr(st, "BC_ITERS", 5)
    monkeypatch.setattr(st, "DEMO_EVAL_LANES", 2)
    for name in ("POLISH_PPO", "FINETUNE_PPO"):
        monkeypatch.setattr(st, name, dataclasses.replace(getattr(st, name), **SMALL_PPO))
    for name in ("JUMP_ARS", "LAND_ARS"):
        monkeypatch.setattr(tts, name, dataclasses.replace(getattr(tts, name), **SMALL_ARS))
    monkeypatch.setattr(tts, "WIDE_EVAL_LANES", 2)
    monkeypatch.setattr(tts, "PROBE_LANES", 2)
    monkeypatch.setattr(tbf, "PROBE_SEEDS", (5000, 5001))
    monkeypatch.setattr(st, "PROBE_STEPS", 3)
    monkeypatch.setattr(st, "N_ROWS", 5)
    monkeypatch.setattr(st, "N_KNOTS", 5)


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("task", ["in_place", "forward"])
def test_jump_entry_point_writes_the_jax_scripts_keys(task, cut, tmp_path, capsys):
    out = tmp_path / task
    tts.main(["--task", task, "--smoke", "--device", "cpu", "--out", str(out)])
    summary = _summary(capsys)
    results = json.loads((out / tts.TASKS[task]["results"]).read_text())
    forward = _artifact("two_stage_forward_results.json")
    assert list(results) == list(forward)
    assert set(_artifact("two_stage_results.json")) < set(results)
    assert results["task"] == tts.TASKS[task]["sparse"] and _finite(results)
    assert list(summary) == list(tts.SUMMARY)
    assert summary == {k: results[k] for k in tts.SUMMARY}
    # the smoke budgets, and the invariants of tests/test_artifacts.py that are no bar
    assert len(results["ars_curve"]) == 2 and len(results["ars_land_curve"]) == 1
    assert len(results["ppo_imitate_curve"]) == len(results["ppo_finetune_curve"]) == 2
    assert results["ppo_imitate_is_noop"] == (not (results["ppo_imitate_demo_held"]
                                                   and results["ppo_imitate_transfer_held"]))
    assert results["warmstart_stage"] == ("bc" if results["ppo_imitate_is_noop"]
                                          else "ppo_imitate")
    assert results["finetune_is_noop"] == (not results["finetune_improves_on_initializer"])
    assert results["demo_steps"] == sum(
        tdp.load_demo_library(str(out / f"demo_{tts.TASKS[task]['tag']}_{i}.qsts")).shape[0]
        for i in range(results["demo_episodes"]))
    timing = json.loads((out / tts.TASKS[task]["results"].replace("_results", "_timing"))
                        .read_text())
    assert set(timing["stage_seconds"]) == {"ars_jump", "ars_land", "demos", "bc", "polish",
                                            "finetune"}


def test_backflip_entry_point_writes_the_jax_scripts_keys_and_policy(cut, tmp_path, capsys):
    out = tmp_path / "bf"
    tbf.main(["--smoke", "--device", "cpu", "--out", str(out)])
    summary = _summary(capsys)
    results = json.loads((out / tbf.RESULTS).read_text())
    assert list(results) == list(_artifact("two_stage_backflip_results.json"))
    assert _finite(results) and summary == {k: results[k] for k in tbf.SUMMARY}
    assert results["demo_episodes"] == 2 and results["expert_probe"]["n"] == 2
    assert results["nominal_probe"]["n"] == 2
    assert results["finetune_is_noop"] == (not results["finetune_improves_on_initializer"])
    assert results["selected_stage"] == st.flip_selected_stage(results)
    net, on = convert.load_flat_mlp_policy(out / tbf.POLICY, "cpu")
    assert net.pi_0.in_features == 27 and net.hidden == (64, 64)


def test_exported_policy_round_trips_through_both_loaders(tmp_path):
    """save_flat_mlp_policy's file: the port's loader gives back every
    parameter and statistic bitwise; the JAX package's loader (the flax
    tree flattened in sorted-key order, read with numpy) gives the same
    actions and values."""
    from examples.train_continuous_policy import load_policy

    net = MLPPolicy(27, 6, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(5)))
    obs = torch.randn(9, 27, generator=torch.Generator().manual_seed(6))
    on = tnorm.update(tnorm.RunningNorm.create(27), obs)
    path = tmp_path / "policy.npz"
    convert.save_flat_mlp_policy(path, net, on)
    back, on2 = convert.load_flat_mlp_policy(path, "cpu")
    for (k, v), w in zip(net.state_dict().items(), back.state_dict().values()):
        assert torch.equal(v, w), k
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(on, f), getattr(on2, f))
    d = np.load(path)
    jnet = jnets.MLPPolicy(6, (64, 64))
    template = jax.tree_util.tree_leaves(jnet.init(jax.random.PRNGKey(0), jnp.zeros(27)))
    assert int(d["n_leaves"]) == len(template)
    assert [d[f"leaf_{i}"].shape for i in range(len(template))] == [x.shape for x in template]
    params, jon = load_policy(str(path), jnet, 27)
    jm, jls, jv = jnet.apply(params, jnorm.normalize(jon, jnp.asarray(obs.numpy())))
    with torch.no_grad():
        tm, tls, tv = net(tnorm.normalize(on, obs))
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tls.detach(), jls)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("where", ["examples/out", "examples/policies", "examples"])
def test_entry_points_refuse_to_write_under_examples(where):
    before = sorted(os.listdir(os.path.join(ROOT, "examples", "out")))
    for argv, main in ((["--task", "forward"], tts.main), ([], tbf.main)):
        with pytest.raises(SystemExit, match="examples/ holds the JAX package"):
            main(argv + ["--smoke", "--device", "cpu", "--out", os.path.join(ROOT, where)])
        with pytest.raises(SystemExit, match="examples/ holds the JAX package"):
            tts.out_dir(os.path.join(ROOT, where, "sub", ".."), "x")
    assert sorted(os.listdir(os.path.join(ROOT, "examples", "out"))) == before


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (tts.main, tbf.main):
        with pytest.raises(RuntimeError, match="CUDA requested"):
            main(["--smoke", "--out", str(tmp_path)])
