"""The two-stage trainers' demo-keep rules (train/two_stage.keep_demos,
keep_flip_demos, save_demos) against the JAX scripts' own rules
(examples/train_two_stage.py:224-247, train_two_stage_backflip.py:193-206,
transcribed below line for line), on synthetic (rows, valid, ok): complete
and landed, complete and not landed, landed and cut short, the trimmed
fallback and its 20-row floor, the flip's longest-episode fallback. The
rows written through the trajectory store are the ones the JAX script
writes, bitwise.
"""

import numpy as np
import pytest

from quadruped_springs_tpu_torch.env import demo_pipeline as tdp
from quadruped_springs_tpu_torch.train import two_stage as st

N_ROWS, C = st.N_ROWS, 44


def jax_jump_rule(rows_np, valid_np):
    """examples/train_two_stage.py:224-247: the (rows, valid) it saves, and
    its complete count."""
    kept, complete = [], 0
    for d in range(rows_np.shape[0]):
        n_valid = int(valid_np[d].sum())
        landed = bool(rows_np[d, :n_valid, -1].any())
        if n_valid == N_ROWS and landed:
            complete += 1
            kept.append((rows_np[d], valid_np[d]))
    if not kept:
        d = int(np.argmax(valid_np.sum(axis=1)))
        n_valid = max(int(valid_np[d].sum()) - 10, 20)
        kept.append((rows_np[d][:n_valid], valid_np[d][:n_valid]))
    return kept, complete


def jax_flip_rule(rows, valid, ok):
    """examples/train_two_stage_backflip.py:193-206."""
    kept = [(rows[i], valid[i]) for i in range(rows.shape[0]) if bool(ok[i])]
    complete = len(kept)
    if not kept:
        i = int(valid.sum(axis=1).argmax())
        kept.append((rows[i], valid[i]))
    return kept, complete


def _episodes(lengths, landed_at, seed=0, T=N_ROWS):
    """Episodes with their first `lengths[d]` rows valid and the landing
    flag raised from row `landed_at[d]` on (None: never)."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((len(lengths), T, C)).astype(np.float32)
    rows[..., -1] = 0.0
    valid = np.zeros((len(lengths), T), bool)
    for d, (n, at) in enumerate(zip(lengths, landed_at)):
        valid[d, :n] = True
        if at is not None:
            rows[d, at:, -1] = 1.0
    return rows, valid


JUMP_CASES = {
    # complete and landed; complete, never landed; landed but cut short
    "complete": ([185, 185, 120, 185], [60, None, 40, 150]),
    # the flag only past the valid rows does not count as landed
    "flag_after_valid": ([185, 140], [100, 150]),
    # no complete episode: the longest (the first of ties), trimmed by 10
    "fallback_trim": ([150, 170, 170, 30], [None, 60, 60, None]),
    # the trim's floor: 20 rows, of which the valid ones are written
    "fallback_floor": ([12, 25, 8], [None, None, 5]),
}


@pytest.mark.parametrize("case", sorted(JUMP_CASES))
def test_jump_keep_rule_matches_the_jax_script(case, tmp_path):
    rows, valid = _episodes(*JUMP_CASES[case])
    want, want_complete = jax_jump_rule(rows, valid)
    picks, complete = st.keep_demos(rows, valid)
    assert complete == want_complete
    kept = st.save_demos(rows, valid, picks, lambda i: str(tmp_path / f"demo_jip_{i}.qsts"),
                         "cpu")
    assert len(kept) == len(want)
    for i, (got, (r, v)) in enumerate(zip(kept, want)):
        np.testing.assert_array_equal(got.numpy(), r[v])
        tdp.save_demo_library(str(tmp_path / "jax.qsts"), r, v)
        assert open(tmp_path / "jax.qsts", "rb").read() == open(
            tmp_path / f"demo_jip_{i}.qsts", "rb").read()
    if case == "complete":
        assert [d for d, _ in picks] == [0, 3] and complete == 2
    if case == "fallback_trim":
        assert picks == [(1, 160)] and complete == 0
    if case == "fallback_floor":
        assert picks == [(1, 20)] and kept[0].shape[0] == 20


FLIP_CASES = {"some_ok": ([140, 90, 140, 60], [True, False, True, False]),
              "none_ok": ([70, 110, 110, 60], [False] * 4)}


@pytest.mark.parametrize("case", sorted(FLIP_CASES))
def test_flip_keep_rule_matches_the_jax_script(case, tmp_path):
    lengths, ok = FLIP_CASES[case]
    rows, valid = _episodes(lengths, [None] * len(lengths), seed=1, T=st.N_KNOTS)
    want, want_complete = jax_flip_rule(rows, valid, np.array(ok))
    picks, complete = st.keep_flip_demos(valid, np.array(ok))
    assert complete == want_complete == sum(ok)
    kept = st.save_demos(rows, valid, picks, lambda i: str(tmp_path / f"demo_bf_{i}.qsts"),
                         "cpu")
    assert len(kept) == len(want)
    for got, (r, v) in zip(kept, want):
        np.testing.assert_array_equal(got.numpy(), r[v])
    if case == "none_ok":
        assert picks == [(1, st.N_KNOTS)] and kept[0].shape[0] == 110
