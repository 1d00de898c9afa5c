"""The four behaviour entry points on the CPU at a cut size.

Each runs through its ``main`` with every width, episode and budget cut
(module constants patched and the smallest flags, so a run takes seconds):
its npz and JSON key sets are the JAX artifacts' (the committed
``examples/policies/*.npz`` and ``examples/out/backflip_robust_validation.json``),
its numbers finite, its exit code the script's. The landing trainer's
touchdown bank is held to the script's ``collect_bank`` keep order with a
stub episode; the trainer itself runs on a cached bank. Then the refusals:
no write under ``examples/``, no card without ``--device cpu``, and
``--optimizer bptt`` with its pointer to ROADMAP.
"""

import json
import math
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu_torch import train_backflip_landing_mlp as lm
from quadruped_springs_tpu_torch import train_backflip_robust_joint as rj
from quadruped_springs_tpu_torch import train_behavior_policies as tbp
from quadruped_springs_tpu_torch import validate_backflip_robust as vb
from quadruped_springs_tpu_torch.env.env import NoiseStreams
from quadruped_springs_tpu_torch.train import behaviour as bh
from quadruped_springs_tpu_torch.train import rollout as ro
from tests.test_torch_behaviour_scripts import LANDING, _function, _quiet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICIES = os.path.join(ROOT, "examples", "policies")
CPU = ["--device", "cpu"]


@pytest.fixture
def cut(monkeypatch):
    """Settle 20 substeps, 0.1 s episodes, 3 policy steps, 2 demo seeds,
    one nominal and two held-out seeds."""
    monkeypatch.setattr(bh, "SETTLE", 20)
    for name, value in dict(DEMO_SEEDS=2, DEMO_STEPS=8, TRAIN_STEPS=3, TRAIN_STEPS_ROBUST=3,
                            EVAL_STEPS=3, INIT_STEPS=3, EP_LEN=0.1, NOM_EP_LEN=0.1,
                            N_VAL=2, FORWARD_SETTLE=20, FORWARD_EP_LEN=0.03,
                            FORWARD_EVAL_EPISODES=2).items():
        monkeypatch.setattr(tbp, name, value)
    monkeypatch.setattr(tbp, "FORWARD_ARS", tbp.ARSConfig(
        n_directions=2, top_directions=1, episode_steps=3, reset_bank_size=2))
    for mod in (lm, rj):
        for name, value in dict(EP_LEN=0.1, FULL_STEPS=3, N_NOM=1, N_VAL=2).items():
            monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(vb, "SETTLE", 20)
    monkeypatch.setattr(vb, "MAX_STEPS", 3)


def _keys(name):
    with np.load(os.path.join(POLICIES, name)) as z:
        return set(z.files)


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    if isinstance(x, np.ndarray):
        return bool(np.isfinite(x).all()) if x.dtype.kind == "f" else True
    return not isinstance(x, float) or math.isfinite(x)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _record(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("robust", [False, True])
def test_behaviour_backflip_writes_the_jax_keys(robust, cut, tmp_path, capsys):
    code = tbp.main(["--task", "backflip", "--iters", "1", "--out", str(tmp_path),
                     *(["--robust"] if robust else []), *CPU])
    rec = _record(capsys)
    assert _finite(rec) and rec["iterations"] == 1 and rec["n_eval"] == (8 if robust else 4)
    assert code == (0 if rec["gate_ok"] else 1)
    path = tmp_path / ("backflip_ars_robust.npz" if robust else "backflip_ars.npz")
    if robust and not rec["gate_ok"]:
        # the script saves a robust policy only past its bars
        assert not path.exists() and {"nominal_ok", "rot_ok", "upright_ok"} <= set(rec)
        return
    z = _npz(path)
    assert set(z) == _keys("backflip_ars.npz") and _finite(z)
    assert z["W"].dtype == np.float64 and z["W"].shape == (6, 27)
    if not robust:
        assert rec["demo_pairs"] > 0 and float(z["count"]) == rec["demo_pairs"]


def test_behaviour_forward_writes_the_jax_keys(cut, tmp_path, capsys):
    assert tbp.main(["--task", "forward", "--iters", "1", "--out", str(tmp_path),
                     *CPU]) == 0
    rec = _record(capsys)
    z = _npz(tmp_path / "forward_ars.npz")
    assert set(z) == _keys("forward_ars.npz") and _finite(z) and _finite(rec)
    assert float(z["ret"]) == rec["ret"]


def test_touchdown_bank_keeps_the_scripts_order(monkeypatch):
    """The bank's seeds kept as the script's serial loop keeps them (a stub
    episode crashes at given seeds), with chunks of batched seeds; each
    entry keeps its seed's noise stream."""
    crash = {1, 2, 5, 6, 7, 9, 10, 11, 12, 13}
    rot = {0, 4, 8}

    def episode(seed):
        return np.float32(seed), np.full(3, seed, np.float32), seed in rot, seed in crash

    want = _function(LANDING, "collect_bank", jax=jax, jnp=jnp, time=time, print=_quiet,
                     run_to_touchdown=episode, args=types.SimpleNamespace(bank=4))()

    def seeded_reset(env, seeds):
        s = torch.tensor(list(seeds), dtype=torch.float32)
        draws = s[:, None, None].expand(-1, 2, 3).clone()
        return s, s[:, None].expand(-1, 3).clone(), NoiseStreams(draws, torch.arange(len(s)))

    def run_to_touchdown(w, launch, state, obs, noise, steps):
        seeds = state.tolist()
        return (state, obs, torch.tensor([s in rot for s in seeds]),
                torch.tensor([s in crash for s in seeds]))

    monkeypatch.setattr(lm.ro, "seeded_reset", seeded_reset)
    monkeypatch.setattr(lm.bh, "run_to_touchdown", run_to_touchdown)
    states, obs, noise, n_try, n_rot = lm.collect_bank(None, None, None, 4, _quiet)
    np.testing.assert_array_equal(states, np.asarray(want[0]))
    np.testing.assert_array_equal(obs, np.asarray(want[1]))
    assert want[2] == 4 and n_try == 9 and n_rot == 3
    np.testing.assert_array_equal(noise.draws[noise.rows, 0, 0], states)


def test_landing_trainer_writes_the_jax_keys(cut, tmp_path, capsys):
    env = bh.flip_env("cpu", "TEST_RANDOMIZER", obs_noise=True, max_ep_len=lm.EP_LEN)
    state, obs, noise = ro.seeded_reset(env, range(4))
    cache = tmp_path / "bank.pt"
    torch.save({"state": state, "obs": obs, "noise": noise}, cache)
    out = tmp_path / "out"
    code = lm.main(["--iters", "2", "--bank", "4", "--train-states", "2", "--probe-every", "1",
                    "--n-probe", "1", "--horizon", "2", "--hidden", "4", "--n-dir", "2",
                    "--bank-cache", str(cache), "--no-save-gate", "--out", str(out),
                    *CPU])
    rec = _record(capsys)
    assert {"nominal", "rotation", "upright", "bank_strict_val"} <= set(rec) and _finite(rec)
    assert code == (0 if rec["gate_ok"] else 1) and rec["bank"] == 4
    z = _npz(out / "backflip_landing_mlp.npz")
    assert set(z) == _keys("backflip_landing_mlp.npz") and _finite(z)
    assert z["W1"].shape == (4, 27) and z["W1"].dtype == np.float32
    cand = _npz(out / "backflip_landing_mlp.npz.cand.npz")
    assert set(cand) == {"W1", "b1", "W2", "b2", "mean", "var", "count"}


def test_joint_trainer_writes_the_jax_keys(cut, tmp_path, capsys):
    code = rj.main(["--iters", "1", "--n-train", "2", "--n-probe", "1", "--train-scen", "1",
                    "--n-dir", "2", "--knots", "3", "--probe-every", "1", "--no-save-gate",
                    "--lander-init", os.path.join(POLICIES, "backflip_landing_mlp.npz"),
                    "--out", str(tmp_path), *CPU])
    rec = _record(capsys)
    assert {"nominal", "rotation", "upright", "probe_best"} <= set(rec) and _finite(rec)
    assert code == (0 if rec["gate_ok"] else 1)
    for name in ("backflip_launch_robust.npz", "backflip_landing_mlp.npz"):
        z = _npz(tmp_path / name)
        assert set(z) == _keys(name) and _finite(z)
        assert set(_npz(tmp_path / (name + ".cand.npz"))) == _keys(name) - {
            "nominal_ok", "rot_ok", "upright_ok", "gate_ok"}


def test_joint_trainer_needs_its_lander(tmp_path):
    with pytest.raises(SystemExit, match="train_backflip_landing_mlp"):
        rj.main(["--lander-init", str(tmp_path / "missing.npz"), "--out", str(tmp_path),
                 *CPU])


def test_validation_writes_the_jax_json(cut, tmp_path, capsys):
    rec = vb.main(["--n", "2", "--out", str(tmp_path), *CPU])
    with open(os.path.join(ROOT, "examples", "out", "backflip_robust_validation.json")) as f:
        jax_rec = json.load(f)
    with open(tmp_path / "backflip_robust_validation.json") as f:
        got = json.load(f)
    assert got == rec and set(got) == set(jax_rec) and _finite(got)
    assert set(got["per_seed"][0]) == set(jax_rec["per_seed"][0])
    assert got["seeds"] == [88000, 88001] and got["n"] == 2
    line = _record(capsys)
    assert line["full_rotation"] == got["full_rotation"]


@pytest.mark.parametrize("module,argv", [
    (tbp, ["--task", "backflip"]), (lm, []), (rj, []), (vb, [])])
@pytest.mark.parametrize("out", ["examples", "examples/policies", "examples/out"])
def test_entry_points_refuse_to_write_under_examples(module, argv, out):
    with pytest.raises(SystemExit, match="examples/"):
        module.main([*argv, "--out", os.path.join(ROOT, out), *CPU])


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for module, argv in ((tbp, ["--task", "forward"]), (lm, []), (rj, []), (vb, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            module.main([*argv, "--out", str(tmp_path)])


def test_landing_trainer_refuses_bptt(capsys):
    with pytest.raises(SystemExit) as e:
        lm.main(["--optimizer", "bptt", *CPU])
    assert e.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err
