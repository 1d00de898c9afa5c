"""The hand-written CUDA kernels of quadruped_springs_tpu_torch/csrc against
their plain PyTorch twins on the card. Marked `gpu`: without a CUDA card they
skip. On a card (torch only, no jax needed):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import pytest
import torch

from quadruped_springs_tpu_torch.models import dynamics as dyn
from quadruped_springs_tpu_torch.models.go1_params import build_model, go1_config
from quadruped_springs_tpu_torch.ops import actuation as act

pytestmark = pytest.mark.gpu

N = 1000            # not a multiple of the 256-thread block: the ragged edge
REL_TOL = 1e-5      # FMA contraction is the only difference from the twins


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_close(got, want):
    assert torch.all((got - want).abs() <= REL_TOL * (1 + want.abs()))


def _actuation_args(dev, n=N):
    cfg = go1_config(True, dev)
    gen = torch.Generator(dev).manual_seed(0)
    q = cfg.init_joint_angles + 0.5 * torch.randn(n, 12, generator=gen, device=dev)
    q[0] = torch.tile(cfg.spring_rest_angles, (4,))
    q_des = cfg.init_joint_angles + 0.5 * torch.randn(n, 12, generator=gen, device=dev)
    qd = 3 * torch.randn(n, 12, generator=gen, device=dev)
    k = cfg.spring_stiffness * (0.9 + 0.2 * torch.rand(n, 3, generator=gen, device=dev))
    b = cfg.spring_damping * (0.9 + 0.2 * torch.rand(n, 3, generator=gen, device=dev))
    sign = torch.as_tensor(act.SPRING_ENGAGE_SIGN, dtype=torch.float32, device=dev)
    return (q_des, q, qd, cfg.motor_kp, cfg.motor_kd, cfg.torque_limits, k, b,
            cfg.spring_rest_angles, sign)


def test_actuation_kernel_matches_twin(cuda):
    args = _actuation_args(cuda)
    before = act.actuation_torque.launches
    tau, tau_m = act.actuation_torque(*args)
    torch.cuda.synchronize()
    assert act.actuation_torque.launches == before + 1
    want_m = act.pd_torque(*args[:6])
    want = want_m + act.spring_torque(args[1], args[2], *args[6:])
    _assert_close(tau_m, want_m)
    _assert_close(tau, want)


@pytest.mark.parametrize("clamp", [False, True])
def test_contact_kernel_matches_twin(cuda, clamp):
    gen = torch.Generator(cuda).manual_seed(1)
    p_w = 0.05 * torch.randn(N, 12, 3, generator=gen, device=cuda)
    v_w = torch.randn(N, 12, 3, generator=gen, device=cuda)
    v_w[0, :, :2] = 0.0
    mu = 0.5 + 0.5 * torch.rand(N, generator=gen, device=cuda)
    radii = torch.full((12,), 0.02, device=cuda)
    params = dyn.SimParams(contact_stiffness=4000.0, contact_damping=40.0, friction=mu,
                           clamp_damping=clamp)
    model = build_model(device=cuda)
    before = dyn.contact_forces.launches
    f, fn, inc, _ = dyn.contact_forces(model, params, p_w, v_w, radii)
    torch.cuda.synchronize()
    assert dyn.contact_forces.launches == before + 1
    wf, wfn, winc = dyn.contact_forces_plain(radii - p_w[..., 2], v_w, mu, 4000.0, 40.0,
                                             params.slip_vel_tol, clamp)
    _assert_close(f, wf)
    _assert_close(fn, wfn)
    assert torch.equal(inc, winc) and inc.any() and not inc.all()


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    args = list(_actuation_args(cuda))
    bad_layout = list(args)
    bad_layout[1] = args[1].t().contiguous().t()          # (N,12) view, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        act.actuation_torque(*bad_layout)
    bad_dtype = list(args)
    bad_dtype[2] = args[2].double()
    with pytest.raises(TypeError, match="dtype"):
        act.actuation_torque(*bad_dtype)
    bad_shape = list(args)
    bad_shape[6] = args[6][:, :2].contiguous()
    with pytest.raises(ValueError, match="shape"):
        act.actuation_torque(*bad_shape)
    p_w = torch.zeros(N, 12, 3, device=cuda)
    v_w = torch.zeros(3, 12, N, device=cuda).permute(2, 1, 0)   # (N,12,3) view
    params = dyn.SimParams(friction=torch.ones(N, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        dyn.contact_forces(build_model(device=cuda), params, p_w, v_w,
                           torch.zeros(12, device=cuda))
