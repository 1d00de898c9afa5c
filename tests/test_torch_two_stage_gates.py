"""The two-stage trainers' gates and selections (train/two_stage.py) against
the JAX package's committed results: fed the stage numbers each artifact
stores, the port's pure functions reproduce every boolean it holds, its
warm-start stage, selected stage, fine-tune bar and the iterates the
stages kept, exactly. The in-place artifact predates the polish's no-op
machinery, so its older gates are held. Then each inequality at its
boundary on synthetic numbers. Pure JSON reads and arithmetic: no
simulator.
"""

import json
import math
import os

import numpy as np
import pytest

from quadruped_springs_tpu_torch.train import two_stage as st

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JUMPS = {"in_place": "two_stage_results.json", "forward": "two_stage_forward_results.json"}
TARGET_APEX = 0.75     # examples/train_two_stage.py --ars-target-apex


def _load(name):
    with open(os.path.join(ROOT, "examples", "out", name)) as f:
        return json.load(f)


def first_best(scores, floor: float):
    """The iterate the stages keep (their `if score > best` from floor): the
    first of the highest scores above floor; None if none is above it."""
    best, at = floor, None
    for i, s in enumerate(scores):
        if s > best:
            best, at = s, i
    return at


def _below(x):
    return float(np.nextafter(x, -np.inf))


def _held(got: dict, r: dict):
    """Every key the artifact holds equals the port's value."""
    common = [k for k in got if k in r]
    assert common
    assert {k: got[k] for k in common} == {k: r[k] for k in common}
    return common


@pytest.mark.parametrize("task", sorted(JUMPS))
def test_jump_artifact_stage_selections(task):
    """ARS: the improvement flag, the best evaluation apex and the early
    stop (the curve ends at the first iteration whose best reaches 0.75 m,
    or runs all 250); the landing stage's best iterate by evaluation
    return gives the three ARS expert numbers."""
    r = _load(JUMPS[task])
    curve = r["ars_curve"]
    assert st.ars_improved(curve) == r["ars_improved"]
    best = np.maximum.accumulate([c["eval_max_height"] for c in curve])
    assert best[-1] == r["ars_jump_best_apex_m"]
    reached = [i for i, b in enumerate(best) if b >= TARGET_APEX]
    assert reached == ([len(curve) - 1] if reached else [])
    assert len(curve) == (67 if task == "in_place" else 250)
    land = r["ars_land_curve"]
    i = first_best([c["eval_return"] for c in land], -9.9)
    assert (land[i]["apex_max"], land[i]["apex_mean"], land[i]["fwd_max"]) == (
        r["ars_best_apex_m"], r["ars_apex_mean_m"], r["ars_best_fwd_m"])


@pytest.mark.parametrize("task", sorted(JUMPS))
def test_jump_artifact_polish_gates_and_warm_start(task):
    """The polish's final-iterate gates from BC's and the polish's demo
    return and probe apex mean (the in-place artifact holds
    `ppo_imitate_demo_improved` and the legacy `ppo_imitate_improved`);
    the final curve record is the final iterate's evaluation; forward: the
    no-op flag, the warm-start stage and its apex mean and distance."""
    r = _load(JUMPS[task])
    gates = st.polish_gates(r["bc_demo_return"], r["ppo_imitate_demo_return"],
                            r["bc_apex_mean_m"], r["ppo_imitate_apex_mean_m"])
    held = _held(gates, r)
    assert held == (["ppo_imitate_demo_improved", "ppo_imitate_improved"] if task == "in_place"
                    else list(gates))
    last = r["ppo_imitate_curve"][-1]
    assert (last["eval_apex_mean"], last["eval_apex_max"], last["demo_return"]) == (
        r["ppo_imitate_apex_mean_m"], r["ppo_imitate_apex_m"], r["ppo_imitate_demo_return"])
    if task == "forward":
        warm = st.select_warm_start(gates, (r["ppo_imitate_apex_mean_m"], r["ppo_imitate_fwd_m"]),
                                    (r["bc_apex_mean_m"], r["bc_fwd_m"]))
        assert _held(warm, r) == list(warm)
        assert warm["warmstart_stage"] == "bc" and warm["ppo_imitate_is_noop"]


@pytest.mark.parametrize("task", sorted(JUMPS))
def test_jump_artifact_finetune_selection_and_gates(task):
    """The fine-tune's bar (0.95 x min(ARS apex, 0.68)), its best iterate
    by the task's criterion over the curve's probes (in place the apex
    mean: iteration 4; forward the least gate margin: iteration 9, as the
    script's comment records), whose probe is the artifact's final one, the
    last probe the last iterate's, the reward flag and the gates."""
    r = _load(JUMPS[task])
    bar = st.finetune_bar(r["ars_best_apex_m"])
    assert bar == r["finetune_gate_bar_m"] == 0.646
    ws = ((r["warmstart_apex_mean_m"], r["warmstart_fwd_m"]) if task == "forward"
          else (math.nan, math.nan))
    probes = [c for c in r["ppo_finetune_curve"] if "eval_apex_mean" in c]
    assert [c["iter"] for c in probes] == list(range(4, 120, 5))
    i = first_best([st.finetune_score(task, c["eval_apex_max"], c["eval_apex_mean"],
                                      c["eval_fwd_max"], bar, *ws) for c in probes], -9.9)
    sel = probes[i]
    assert sel["iter"] == (4 if task == "in_place" else 9)
    assert (sel["eval_apex_max"], sel["eval_apex_mean"], sel["eval_fwd_max"],
            sel["eval_return"]) == (r["ppo_finetune_final_apex_m"],
                                    r["ppo_finetune_final_apex_mean_m"],
                                    r["ppo_finetune_final_fwd_m"],
                                    r["ppo_finetune_final_return"])
    assert (probes[-1]["eval_apex_max"], probes[-1]["eval_apex_mean"],
            probes[-1]["eval_return"]) == (r["ppo_finetune_last_iter_apex_m"],
                                           r["ppo_finetune_last_iter_apex_mean_m"],
                                           r["ppo_finetune_last_iter_return"])
    assert st.reward_improved(r["ppo_finetune_curve"]) == r["ppo_finetune_reward_improved"]
    gates = st.finetune_gates(task, sel["eval_apex_max"], sel["eval_apex_mean"],
                              sel["eval_fwd_max"], bar, *ws)
    held = _held(gates, r)
    assert held == (["finetune_matches_ars", "finetune_gate_bar_m"] if task == "in_place"
                    else list(gates))


def test_backflip_artifact_gates_and_selection():
    """The flip: the polish's gates from the stored BC and polish probes and
    demo returns, the fine-tune's best probe (iteration 109: 8 upright at
    apex 0.147), the flip gates against the expert's and the polish's
    probes, the selected stage, the nominal gate, the reward flag; the
    curve's last records are the final probes'."""
    r = _load("two_stage_backflip_results.json")
    gates = st.flip_polish_gates(r["bc_demo_return"], r["ppo_imitate_demo_return"],
                                 r["bc_probe"], r["ppo_imitate_probe"])
    assert _held(gates, r) == list(gates)
    last = r["ppo_imitate_curve"][-1]
    assert (last["demo_return"], last["upright_count"]) == (
        r["ppo_imitate_demo_return"], r["ppo_imitate_probe"]["upright_count"])
    probes = [c for c in r["ppo_finetune_curve"] if "upright_count" in c]
    as_probe = [{"upright_count": c["upright_count"], "rotation_count": c["rotation_count"],
                 "apex_mean_m": c["apex_mean"]} for c in probes]
    i = first_best([st.flip_score(p) for p in as_probe], -1.0)
    assert probes[i]["iter"] == 109
    ft = r["ppo_finetune_probe"]
    assert as_probe[i] == {k: ft[k] for k in as_probe[i]}
    last = r["ppo_finetune_last_iter_probe"]
    assert as_probe[-1] == {k: last[k] for k in as_probe[-1]}
    ft_gates = st.flip_finetune_gates(ft, r["expert_probe"], r["ppo_imitate_probe"])
    assert _held(ft_gates, r) == list(ft_gates)
    assert st.flip_selected_stage(ft_gates) == r["selected_stage"] == "ppo_finetune"
    assert st.nominal_flip_ok(r["nominal_probe"]) == r["nominal_flip_ok"] is True
    assert st.reward_improved(r["ppo_finetune_curve"]) == r["ppo_finetune_reward_improved"]


# -- each inequality at its boundary ---------------------------------------------

def test_polish_gates_at_their_boundaries():
    bc, am = 0.5, 0.9
    edge = st.polish_gates(bc, bc - st.DEMO_HOLD, am, am - st.APEX_HOLD)
    assert edge == {"ppo_imitate_demo_held": True, "ppo_imitate_demo_improved": False,
                    "ppo_imitate_transfer_held": True, "ppo_imitate_improved": True}
    past = st.polish_gates(bc, _below(bc - st.DEMO_HOLD), am, _below(am - st.APEX_HOLD))
    assert not any(past.values())
    assert st.polish_gates(bc, bc, am, am)["ppo_imitate_demo_improved"] is False
    assert st.polish_gates(bc, np.nextafter(bc, 1.0), am, am)["ppo_imitate_demo_improved"]


@pytest.mark.parametrize("held,transfer", [(True, True), (True, False), (False, True),
                                           (False, False)])
def test_select_warm_start_takes_the_polish_only_when_both_gates_hold(held, transfer):
    gates = {"ppo_imitate_demo_held": held, "ppo_imitate_transfer_held": transfer}
    got = st.select_warm_start(gates, (0.7, 1.2), (0.6, 2.0))
    ok = held and transfer
    assert got == {"ppo_imitate_is_noop": not ok,
                   "warmstart_stage": "ppo_imitate" if ok else "bc",
                   "warmstart_apex_mean_m": 0.7 if ok else 0.6,
                   "warmstart_fwd_m": 1.2 if ok else 2.0}


def test_finetune_bar_score_and_gates_at_their_boundaries():
    assert st.finetune_bar(0.6) == 0.95 * 0.6 and st.finetune_bar(1.2) == 0.95 * 0.68
    bar, ws_am, ws_fw = st.finetune_bar(1.2), 0.55, 2.1
    # in place: the apex mean; forward: the least of the three margins
    assert st.finetune_score("in_place", 0.7, 0.61, 3.0, bar, ws_am, ws_fw) == 0.61
    assert st.finetune_score("forward", 0.7, 0.61, 3.0, bar, ws_am, ws_fw) == min(
        0.7 - bar, 0.61 - (ws_am - 0.02), 3.0 - (ws_fw - 0.05))
    assert st.finetune_score("forward", 0.7, 0.61, 2.06, bar, ws_am, ws_fw) == 2.06 - (
        ws_fw - 0.05)
    for task in ("in_place", "forward"):
        g = st.finetune_gates(task, bar, ws_am - st.APEX_HOLD, ws_fw - st.FWD_HOLD, bar,
                              ws_am, ws_fw)
        assert g == {"finetune_matches_ars": True, "finetune_gate_bar_m": bar,
                     "finetune_improves_on_initializer": True, "finetune_is_noop": False}
        g = st.finetune_gates(task, _below(bar), _below(ws_am - st.APEX_HOLD), ws_fw, bar,
                              ws_am, ws_fw)
        assert not g["finetune_matches_ars"] and g["finetune_is_noop"]
    # the distance counts forward only
    assert st.finetune_gates("in_place", 0.7, ws_am, _below(ws_fw - st.FWD_HOLD), bar,
                             ws_am, ws_fw)["finetune_improves_on_initializer"]
    assert not st.finetune_gates("forward", 0.7, ws_am, _below(ws_fw - st.FWD_HOLD), bar,
                                 ws_am, ws_fw)["finetune_improves_on_initializer"]
    # the 0.5 m floor binds below the bar's own floor
    low = st.finetune_bar(0.4)
    assert st.finetune_gates("in_place", 0.5, 1, 1, low, 0, 0)["finetune_matches_ars"]
    assert not st.finetune_gates("in_place", _below(0.5), 1, 1, low, 0, 0)[
        "finetune_matches_ars"]


def _probe(rot, up, n=8, apex=0.2):
    return {"rotation_count": rot, "upright_count": up, "n": n, "pitch_mean_rad": 6.28,
            "apex_mean_m": apex}


def test_flip_gates_at_their_boundaries():
    bc = _probe(8, 5)
    g = st.flip_polish_gates(0.6, 0.6 - st.DEMO_HOLD, bc, _probe(7, 4))
    assert g == {"ppo_imitate_demo_held": True, "ppo_imitate_demo_improved": False,
                 "ppo_imitate_transfer_held": True}
    assert not st.flip_polish_gates(0.6, 0.6, bc, _probe(6, 5))["ppo_imitate_transfer_held"]
    assert not st.flip_polish_gates(0.6, 0.6, bc, _probe(8, 3))["ppo_imitate_transfer_held"]
    expert, im = _probe(8, 3), _probe(8, 6)
    g = st.flip_finetune_gates(_probe(8, 5), expert, im)
    assert g == {"finetune_flip_ok": True, "finetune_improves_on_initializer": True,
                 "finetune_is_noop": False}
    assert st.flip_selected_stage(g) == "ppo_finetune"
    g = st.flip_finetune_gates(_probe(8, 4), expert, im)
    assert g["finetune_flip_ok"] and g["finetune_is_noop"]
    assert st.flip_selected_stage(g) == "ppo_imitate"
    g = st.flip_finetune_gates(_probe(7, 7), expert, im)
    assert not g["finetune_flip_ok"] and st.flip_selected_stage(g) == "ppo_imitate"
    assert not st.flip_finetune_gates(_probe(8, 2), expert, _probe(8, 2))["finetune_flip_ok"]
    assert st.flip_score(_probe(8, 5, apex=0.3)) == 5 + 0.1 * 0.3
    assert st.nominal_flip_ok(_probe(2, 2, n=2))
    assert not st.nominal_flip_ok(_probe(2, 1, n=2))
    assert not st.nominal_flip_ok(_probe(1, 1, n=2))


def test_curve_flags_and_best_iterate_rules():
    flat = [{"eval_return": 0.3, "mean_reward": 0.1}] * 12
    assert not st.ars_improved(flat) and not st.reward_improved(flat)
    up = [{"eval_return": 0.3 + 1e-9 * i, "mean_reward": 0.1 + 1e-9 * i} for i in range(12)]
    assert st.ars_improved(up) and st.reward_improved(up)
    # fewer than 10 records: both windows are the whole curve
    assert not st.reward_improved(up[:5])
