"""The planned springs-vs-rigid comparison at its full size on the CPU
(compare_springs.planned_rows: H = 50, K = 64, 10 iterations, 8 solves,
the fidelity env's 2,500-substep settle, 120 control steps executed) with the
draws scripts/compare_springs.py makes from split(PRNGKey(1), 8), against the
JAX package's own rows at that key on the CPU (JAX_KEY1, from `python
tests/torch_compare_springs_probe.py --jax-keys 1`; about 2 min).

Which of the 8 solves is best, and so the executed plan, is chaotic in the
last bits in both packages (the committed docs/springs_vs_rigid.json, a TPU
run, is not what the JAX package gives on the CPU either: PERF.md, section 6),
so a row is held where 8 solves average the chaos out: each robot's mean
cost within 2% of JAX's (measured 0.01% springs, 0.72% rigid), the peak
motor torque at the 33.55 N m limit, and the comparison's claim, springs'
executed apex above rigid's, which JAX's rows at this key also show.
"""

import numpy as np
import torch

from quadruped_springs_tpu_torch import compare_springs as cs
from tests.torch_compare_springs_probe import jax_draws

JAX_KEY1 = {"springs": {"mean_cost": -73.5731201171875, "executed_apex_m": 1.091529369354248},
            "rigid": {"mean_cost": -63.79597473144531, "executed_apex_m": 0.9290247559547424}}


def test_planned_at_full_size_with_jax_draws():
    draws = torch.from_numpy(jax_draws(1))
    rows = {label: cs.planned_rows(springs, torch.device("cpu"), draws=draws)[0]
            for label, springs in cs.CONFIGS.items()}
    for label, row in rows.items():
        assert row["n_solves"] == 8 and len(row["costs"]) == 8
        assert np.isfinite([v for v in row.values() if isinstance(v, float)]).all()
        assert round(row["peak_motor_torque_Nm"], 2) == 33.55, label
        np.testing.assert_allclose(row["mean_cost"], JAX_KEY1[label]["mean_cost"], rtol=0.02)
        assert row["best_cost"] == min(row["costs"]) <= row["mean_cost"]
    assert rows["springs"]["executed_apex_m"] > rows["rigid"]["executed_apex_m"]
    assert JAX_KEY1["springs"]["executed_apex_m"] > JAX_KEY1["rigid"]["executed_apex_m"]
