"""The hand-written CUDA kernels of quadruped_springs_tpu_torch/csrc against
their plain PyTorch twins on the card, and the env step's launch count. Marked `gpu`: without a CUDA card they
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


def _anchored_inputs(dev, n=N):
    """Feet within ±1 cm of the ground, anchors 0.1 mm to 10 cm away (log
    scale) so that feet sit inside and on the friction cone; lane 0 has its
    anchors under still feet (|f_trial| = 0), lane 1 φ = 0 exactly."""
    gen = torch.Generator(dev).manual_seed(2)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    radii = torch.tensor([0.02] * 4 + [0.008] * 4 + [0.055] * 4, device=dev)
    p_w = 0.5 * (2 * rand(n, 12, 3) - 1)
    p_w[..., 2] = radii + 0.02 * rand(n, 12) - 0.01
    v_w = 0.3 * torch.randn(n, 12, 3, generator=gen, device=dev)
    sign = torch.where(rand(n, 4, 2) < 0.5, -1.0, 1.0)
    anchor = p_w[:, :4, :2] + sign * 10.0 ** (-4.0 + 3.0 * rand(n, 4, 2))
    v_w[0] = 0.0
    p_w[0, :, 2] = radii - 0.004
    anchor[0] = p_w[0, :4, :2]
    p_w[1, :, 2] = radii
    mu = 0.5 + 0.5 * rand(n)
    return p_w, v_w, anchor.contiguous(), mu, radii


@pytest.mark.parametrize("clamp", [False, True])
def test_anchored_contact_kernel_matches_twin(cuda, clamp):
    p_w, v_w, anchor, mu, radii = _anchored_inputs(cuda)
    params = dyn.SimParams(friction=mu, clamp_damping=clamp)
    before = dyn.contact_forces.anchored_launches
    got = dyn.contact_forces(build_model(device=cuda), params, p_w, v_w, radii, anchor)
    torch.cuda.synchronize()
    assert dyn.contact_forces.anchored_launches == before + 1
    want = dyn.contact_forces_anchored_plain(
        radii - p_w[..., 2], v_w, p_w[:, :4, :2], anchor, mu, params.contact_stiffness,
        params.contact_damping, params.tangential_stiffness, params.tangential_damping,
        params.slip_vel_tol, clamp)
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            assert torch.equal(g, w)
        else:
            _assert_close(g, w)
    inc = want[2][:, :4]
    slid = (want[3] != anchor).any(-1)
    assert (inc & slid).any() and (inc & ~slid).any() and (~inc).any()


def test_env_step_launches_the_kernels_once_per_substep(cuda):
    """A short reset and two control steps of 64 environments on the card:
    `actuation` and `contact_anchored` launch once per substep, `contact`
    once per reset (the contact priming), the robots stay finite, and a
    further step makes no host synchronisation."""
    from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv

    env = QuadrupedEnv(EnvConfig(enable_springs=True, task_env="JUMPING_IN_PLACE",
                                 observation_space_mode="ARS_BASIC", settling_steps=20),
                       device=cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    counts = (act.actuation_torque.launches, dyn.contact_forces.anchored_launches,
              dyn.contact_forces.launches)
    state, _ = env.reset(gen, 64)
    for _ in range(2):
        state, obs, *_ = env.step(state, env.get_init_action().expand(64, -1), gen)
    torch.cuda.synchronize()
    assert act.actuation_torque.launches - counts[0] == 20 + 2 * 10
    assert dyn.contact_forces.anchored_launches - counts[1] == 20 + 2 * 10
    assert dyn.contact_forces.launches - counts[2] == 1
    assert torch.isfinite(obs).all() and torch.isfinite(state.robot.pos).all()
    torch.cuda.set_sync_debug_mode("error")
    try:
        env.step(state, env.get_init_action().expand(64, -1), gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")


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
    anchor = torch.zeros(N, 2, 4, device=cuda).transpose(1, 2)  # (N,4,2) view
    with pytest.raises(ValueError, match="contiguous"):
        dyn.contact_forces(build_model(device=cuda), params, p_w, torch.zeros_like(p_w),
                           torch.zeros(12, device=cuda), anchor)
