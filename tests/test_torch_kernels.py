"""The hand-written CUDA kernels of quadruped_springs_tpu_torch/csrc against
their plain PyTorch twins on the card (the tangent kernels against
torch.func.jvp of the twins), the env step's launch count (the fused
`env_substeps`, held to its plain version in tests/test_torch_env_substeps.py),
the planner's linearization through the kernels, the env step's reverse
mode (`env_substeps_vjp` against autograd of its plain version) and the
planner's rollout (`planner_rollout`; its CPU side is
tests/test_torch_planner_rollout.py). Marked `gpu`: without a CUDA card they
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
# planner_rollout against its plain version, as chip_smoke.py phase 19 holds it
ROLLOUT_SPREAD, ROLLOUT_DIST = 10.0, 2.0


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


T_DIRS = 5          # tangent directions per launch


def _plain_actuation(q_des, q, qd, kp, kd, limits, k, b, rest, sign):
    tau_m = act.pd_torque(q_des, q, qd, kp, kd, limits)
    return tau_m + act.spring_torque(q, qd, k, b, rest, sign), tau_m


def test_actuation_jvp_kernel_matches_jvp_of_twin(cuda):
    """Lanes 1-2 saturate the torque clip on either side, lane 3 sits well
    inside it; the seeded lanes fall on both sides of the spring's
    engagement. No lane sits on a branch point. The kernel writes the total
    torque's tangent only; the wrapper's tau_motor carries none on the card."""
    args = list(_actuation_args(cuda))
    args[1][0] += 0.05                      # off the spring's engagement point
    args[0][1] = args[1][1] + 10.0
    args[0][2] = args[1][2] - 10.0
    args[0][3], args[2][3] = args[1][3] + 0.01, 0.0
    gen = torch.Generator(cuda).manual_seed(3)
    tangents = [torch.randn(T_DIRS, N, 12, generator=gen, device=cuda) for _ in range(3)]
    before = act.actuation_torque.jvp_launches
    dtau = act._launch_actuation_jvp(*args, *tangents)
    torch.cuda.synchronize()
    assert act.actuation_torque.jvp_launches == before + 1
    f = lambda a, b, c: _plain_actuation(a, b, c, *args[3:])
    for t in range(T_DIRS):
        _, (want, want_m) = torch.func.jvp(f, tuple(args[:3]),
                                           tuple(d[t] for d in tangents))
        _assert_close(dtau[t], want)
        assert (want_m[1:3] == 0).all() and (want_m[3] != 0).all()   # the clip's regimes
    # the same through torch.func.jvp of the wrapper: one launch of each kernel
    counts = (act.actuation_torque.launches, act.actuation_torque.jvp_launches)
    primal, tangent = torch.func.jvp(lambda a, b, c: act.actuation_torque(a, b, c, *args[3:]),
                                     tuple(args[:3]), tuple(d[0] for d in tangents))
    assert (act.actuation_torque.launches, act.actuation_torque.jvp_launches) == (
        counts[0] + 1, counts[1] + 1)
    assert torch.equal(tangent[0], dtau[0]) and not tangent[1].any()
    _assert_close(primal[0], f(*args[:3])[0])


def _assert_close_bf16(got, want):
    """A bf16 variant against its plain version (both f32 arithmetic rounded
    to bf16 once): the f32 bound plus one bf16 ulp of |want|."""
    got, want = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want.abs())[1] - 8)
    assert torch.all((got - want).abs() <= REL_TOL * (1 + want.abs()) + ulp)


def test_bf16_variants_match_their_plain_versions(cuda):
    """The four planner kernels on bfloat16 storage (the bf16 linearization
    knot) against their plain versions on the same bf16 inputs: the f32
    twin on the upcast inputs, rounded. Each launch counts on the bf16
    counter and leaves the f32 one alone."""
    bf16 = torch.bfloat16
    args = [a.to(bf16) for a in _actuation_args(cuda)]
    counts = (act.actuation_torque.launches, act.actuation_torque.bf16_launches)
    tau, tau_m = act.actuation_torque(*args)
    want, want_m = act.actuation_plain(*args)
    assert tau.dtype == bf16
    _assert_close_bf16(tau, want)
    _assert_close_bf16(tau_m, want_m)
    gen = torch.Generator(cuda).manual_seed(5)
    tangents = [torch.randn(T_DIRS, N, 12, generator=gen, device=cuda).to(bf16)
                for _ in range(3)]
    dtau = act._launch_actuation_jvp(*args, *tangents)
    f = lambda a, b, c: act.actuation_plain(a, b, c, *args[3:])[0]
    for t in range(T_DIRS):
        _assert_close_bf16(dtau[t], torch.func.jvp(f, tuple(args[:3]),
                                                   tuple(d[t] for d in tangents))[1])
    assert (act.actuation_torque.launches, act.actuation_torque.bf16_launches) == (
        counts[0], counts[1] + 1)
    phi, v_w, mu, dphi, dv = (t.to(bf16) for t in _contact_jvp_inputs(cuda))
    for clamp in (False, True):
        consts = (4000.0, 40.0, 0.02, clamp)
        got = dyn._launch_contact(phi, v_w, mu, *consts)
        want = dyn.contact_forces_plain(phi, v_w, mu, *consts)
        for g, w in zip(got[:2], want[:2]):
            _assert_close_bf16(g, w)
        assert torch.equal(got[2], want[2])
        df = dyn._launch_contact_jvp(phi, v_w, mu, dphi, dv, *consts)
        fc = lambda p, v: dyn.contact_forces_plain(p, v, mu, *consts)[0]
        for t in range(T_DIRS):
            _assert_close_bf16(df[t], torch.func.jvp(fc, (phi, v_w), (dphi[t], dv[t]))[1])
    torch.cuda.synchronize()
    assert dyn.contact_forces.bf16_launches >= 2 and dyn.contact_forces.bf16_jvp_launches >= 2


def _contact_jvp_inputs(dev):
    """Seeded sites within ±1 cm of the ground, then hand-placed lanes:
    0 out of contact; 1-2 damping clipped at ∓elastic when the clamp is on;
    3 pulled apart hard enough that the force floors at 0 (clamp off);
    4 |v_t|² under its 1e-12 floor; 5 v_t under v_tol, 6 above it."""
    gen = torch.Generator(dev).manual_seed(4)
    phi = 0.02 * torch.rand(N, 12, generator=gen, device=dev) - 0.01
    v_w = torch.randn(N, 12, 3, generator=gen, device=dev)
    mu = 0.5 + 0.5 * torch.rand(N, generator=gen, device=dev)
    phi[0] = -1e-3
    phi[1:7] = 5e-3                       # elastic = 20 N at 4 kN/m
    v_w[1:7, :, 2] = 0.0
    v_w[1, :, 2] = 2.0                    # damping -80 N < -elastic
    v_w[2, :, 2] = -2.0                   # damping +80 N > elastic
    v_w[3, :, 2] = 1.0                    # elastic + damping = -20 N
    v_w[4, :, :2] = 3e-7
    v_w[5, :, 0], v_w[5, :, 1] = 0.012, 0.005
    v_w[6, :, 0], v_w[6, :, 1] = 0.03, -0.04
    dphi = torch.randn(T_DIRS, N, 12, generator=gen, device=dev)
    dv = torch.randn(T_DIRS, N, 12, 3, generator=gen, device=dev)
    return phi, v_w, mu, dphi, dv


@pytest.mark.parametrize("clamp", [False, True])
def test_contact_jvp_kernel_matches_jvp_of_twin(cuda, clamp):
    phi, v_w, mu, dphi, dv = _contact_jvp_inputs(cuda)
    consts = (4000.0, 40.0, 0.02, clamp)
    before = dyn.contact_forces.jvp_launches
    df = dyn._launch_contact_jvp(phi, v_w, mu, dphi, dv, *consts)
    torch.cuda.synchronize()
    assert dyn.contact_forces.jvp_launches == before + 1
    f = lambda p, v: dyn.contact_forces_plain(p, v, mu, *consts)[:2]
    for t in range(T_DIRS):
        _, (want, want_fn) = torch.func.jvp(f, (phi, v_w), (dphi[t], dv[t]))
        _assert_close(df[t], want)
        _assert_close(df[t, ..., 2], want_fn)
    assert (df[:, 0] == 0).all() and df[:, 4:7].abs().sum() > 0
    if clamp:      # clipped at -elastic the normal force is 0 and stays 0
        assert (df[:, 1] == 0).all() and (df[:, 2, :, 2] != 0).all()
    else:
        assert (df[:, 3] == 0).all()
    # through torch.func.jvp of the wrapper (site heights with zero radii)
    p_w = torch.zeros_like(v_w)
    p_w[..., 2] = -phi
    dp = torch.zeros_like(dv)
    dp[..., 2] = -dphi
    params = dyn.SimParams(contact_stiffness=4000.0, contact_damping=40.0, friction=mu,
                           clamp_damping=clamp)
    wrapper = lambda p, v: dyn.contact_forces(build_model(device=cuda), params, p, v,
                                              torch.zeros(12, device=cuda))[:2]
    _, (got, got_fn) = torch.func.jvp(wrapper, (p_w, v_w), (dp[0], dv[0]))
    assert torch.equal(got, df[0]) and torch.equal(got_fn, df[0, ..., 2])



def _flat(tree):
    return [t for x in tree for t in (_flat(x) if isinstance(x, tuple) else (x,))]


def test_tangent_kernels_at_ties_match_the_plain_versions(cuda):
    """actuation_jvp and contact_jvp with every clip exactly at its bound
    (values exact in float32: tests/test_torch_clip_ties.py's cases, where
    the plain versions are held to jax.jacfwd): every basis tangent equal to
    torch.func.jacfwd of the plain versions on the CPU, bitwise. PD torques
    at +limit, -limit and inside; the damping clip at +elastic and at
    -elastic (the floor's tie too), inside and above, the floor's tie
    without the clip."""
    kp, kd, limit, kn, dn, phi0 = 32.0, 0.5, 8.0, 4096.0, 32.0, 2.0 ** -10

    def actuation(dev):
        q = torch.full((1, 12), 0.25, device=dev)
        q_des = torch.tensor([[0.5, 0.0, 0.3] * 4], device=dev)
        qd = torch.tensor([[0.0, 0.0, 0.5] * 4], device=dev)
        full = lambda v: torch.full((12,), v, device=dev)
        rest = (full(kp), full(kd), full(limit), torch.zeros(1, 3, device=dev),
                torch.zeros(1, 3, device=dev), torch.zeros(3, device=dev),
                torch.tensor(act.SPRING_ENGAGE_SIGN, dtype=torch.float32, device=dev))
        return torch.func.jacfwd(lambda a, b, c: act.actuation_torque(a, b, c, *rest)[0],
                                 argnums=(0, 1, 2))(q_des, q, qd)

    def contact(dev, clamp):
        p_w = torch.zeros(1, 12, 3, device=dev)
        p_w[0, :5, 2], p_w[0, 5:, 2] = -phi0, phi0
        v_w = torch.zeros(1, 12, 3, device=dev)
        v_w[0, :, 0] = 0.5
        v_w[0, :5, 2] = torch.tensor([-0.125, 0.125, 0.0625, -0.25, 0.25], device=dev)
        params = dyn.SimParams(contact_stiffness=kn, contact_damping=dn, friction=0.75,
                               clamp_damping=clamp)
        radii = torch.zeros(12, device=dev)
        return torch.func.jacfwd(
            lambda p, v: dyn.contact_forces(None, params, p, v, radii)[:2],
            argnums=(0, 1))(p_w, v_w)

    cases = [actuation] + [lambda dev, c=c: contact(dev, c) for c in (True, False)]
    for case in cases:
        want, got = _flat(case("cpu")), _flat(case(cuda))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    ties = _flat(actuation("cpu"))[0][0, :3, 0, :3].diagonal()
    assert ties.tolist() == [0.5 * kp, 0.5 * kp, kp]

def test_reverse_mode_through_the_kernels_raises(cuda):
    args = list(_actuation_args(cuda))
    args[1] = args[1].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="reverse-mode"):
        act.actuation_torque(*args)[0].sum().backward()
    phi, v_w, mu, _, _ = _contact_jvp_inputs(cuda)
    p_w = torch.zeros_like(v_w)
    p_w[..., 2] = -phi
    p_w.requires_grad_()
    params = dyn.SimParams(friction=mu)
    with pytest.raises(NotImplementedError, match="reverse-mode"):
        dyn.contact_forces(build_model(device=cuda), params, p_w, v_w,
                           torch.zeros(12, device=cuda))[0].sum().backward()


def test_linearization_launches_the_tangent_kernels_and_matches_the_cpu(cuda):
    """The 37x43 Jacobians of one planner knot at 16 rollout states, through
    the kernels on the card and through the plain versions on the CPU. Each
    of the four kernels launches once per substep, for all 43 tangents."""
    from quadruped_springs_tpu_torch.solver import ilqr
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    jac = {}
    for dev in ("cpu", cuda):
        prob = MPCProblem(MPCConfig(horizon=16), dev)
        if dev == "cpu":       # one rollout, so both linearize at the same states
            lanes = prob.lane_params()
            us = prob.task_warm_start()
            x, xs = prob.default_x0()[None], []
            for t in range(16):
                xs.append(x)
                x = prob.dynamics(x, us[t:t + 1], lanes)
            z_cpu = torch.cat([torch.cat(xs), us], dim=-1)
        z = z_cpu.to(dev)
        lanes = prob.lane_params(repeats=16)
        counts = (act.actuation_torque.launches, act.actuation_torque.jvp_launches,
                  dyn.contact_forces.launches, dyn.contact_forces.jvp_launches)
        _, cols = ilqr._basis_jvp(lambda z: prob.dynamics(z[:, :37], z[:, 37:], lanes), z)
        if dev != "cpu":
            torch.cuda.synchronize()
            now = (act.actuation_torque.launches, act.actuation_torque.jvp_launches,
                   dyn.contact_forces.launches, dyn.contact_forces.jvp_launches)
            assert [b - a for a, b in zip(counts, now)] == [2, 2, 2, 2]
        jac[str(dev)] = cols.permute(1, 2, 0).cpu()
    scale = jac["cpu"].abs().amax(dim=(1, 2), keepdim=True)
    assert ((jac["cuda"] - jac["cpu"]).abs() <= 1e-4 * scale).all()


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
    the fused `env_substeps` kernel launches once per control step and once
    for reset's settle, and the per-substep `actuation` and
    `contact_anchored` no more; `contact` once per reset (the contact
    priming); the robots stay finite, and a further step makes no host
    synchronisation."""
    from quadruped_springs_tpu_torch.env import substeps as ss
    from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv

    env = QuadrupedEnv(EnvConfig(enable_springs=True, task_env="JUMPING_IN_PLACE",
                                 observation_space_mode="ARS_BASIC", settling_steps=20),
                       device=cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    counts = (act.actuation_torque.launches, dyn.contact_forces.anchored_launches,
              dyn.contact_forces.launches, ss.env_substeps.launches)
    state, _ = env.reset(gen, 64)
    for _ in range(2):
        state, obs, *_ = env.step(state, env.get_init_action().expand(64, -1), gen)
    torch.cuda.synchronize()
    assert act.actuation_torque.launches - counts[0] == 0
    assert dyn.contact_forces.anchored_launches - counts[1] == 0
    assert dyn.contact_forces.launches - counts[2] == 1
    assert ss.env_substeps.launches - counts[3] == 1 + 2
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


# --- env_substeps: the environment's control step in one launch ---------------

def _env_substeps_args(dev, n, case="pd"):
    """env_substeps's arguments for n settled environments with lanes moved
    into each regime: every 8th from lane 1 in flight, from lane 2 its
    anchors 5 cm off (the feet slide on the friction cone), from lane 3
    pushed at the trunk; "pd": the command interpolated from the last action
    to a random one over 10 substeps; "torque": random torques held;
    "on_rack": the command held, the base welded; "edges": as "pd", with
    every 8th from lane 5 lifted past its joint limits, from lane 6 on its
    back on the trunk's corners and from lane 7 folded onto its knees
    (env/substeps.py edge_states)."""
    import dataclasses

    from quadruped_springs_tpu_torch.control import interfaces as ci
    from quadruped_springs_tpu_torch.env import randomizers as rnd
    from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv

    env = QuadrupedEnv(EnvConfig(enable_springs=True, task_env="JUMPING_IN_PLACE",
                                 observation_space_mode="ARS_BASIC", settling_steps=300),
                       device=dev)
    gen = torch.Generator(dev).manual_seed(4)
    state, _ = env.reset(gen, n)
    pos, lin_vel = state.robot.pos.clone(), state.robot.lin_vel.clone()
    pos[1::8, 2] += 0.15
    lin_vel[1::8, 2] = 1.0
    anchor = state.foot_anchor.clone()
    anchor[2::8] += 0.05
    robot = dataclasses.replace(state.robot, pos=pos, lin_vel=lin_vel)
    action = 2.0 * torch.rand((n, env.action_dim), generator=gen, device=dev) - 1.0
    command = lambda a: ci.action_to_command(env.iface, a).contiguous()
    if case in ("pd", "edges"):
        prev = state.last_action
        q_des = torch.stack([command(prev + ((i + 1.0) / 10) * (action - prev))
                             for i in range(10)], dim=1)
    elif case == "torque":
        q_des = 16.0 * torch.rand((n, 12), generator=gen, device=dev) - 8.0
    else:
        q_des = command(action)
    ext = torch.zeros(n, 3, device=dev)
    ext[3::8] = torch.tensor([30.0, -20.0, 10.0], device=dev)
    params = env._scenario_sim_params(state.scenario)
    params = dataclasses.replace(params, on_rack=case == "on_rack")
    k, b = env._springs(state.scenario)
    cfg = env.cfg
    args = (robot, anchor, q_des, rnd.model_from_params(state.scenario), params, cfg.motor_kp,
            cfg.motor_kd, cfg.torque_limits, cfg.velocity_limits, k, b,
            cfg.spring_rest_angles, env.engage_sign, 10, ext, case == "torque")
    if case == "edges":
        from quadruped_springs_tpu_torch.env import substeps as ss

        args = ss.edge_states(args, limits=range(5, n, 8), upside_down=range(6, n, 8),
                              folded=range(7, n, 8))
    return args


def _substeps_rows(out):
    """Every output of env_substeps as (N, k) float64."""
    r = out.robot
    parts = (r.pos, r.quat, r.lin_vel, r.ang_vel, r.q, r.qd, out.anchor, out.tau, out.tau_m,
             out.tau_m_sum, out.foot_forces, out.feet_in_contact, out.invalid_contact)
    return [t.reshape(t.shape[0], -1).double() for t in parts]


def _float64(args):
    """The arguments with every float32 tensor in float64 (the model's too)."""
    import dataclasses

    up = lambda t: t.double() if torch.is_tensor(t) and t.dtype == torch.float32 else t
    robot, anchor, q_des, model, params, *rest = args
    return [dataclasses.replace(robot, **{f.name: up(getattr(robot, f.name))
                                          for f in dataclasses.fields(robot)}),
            up(anchor), up(q_des),
            dataclasses.replace(model, **{f.name: up(getattr(model, f.name))
                                          for f in dataclasses.fields(model)}),
            dataclasses.replace(params, friction=up(params.friction)), *map(up, rest)]


# env_substeps against its plain version: within ENV_SPREAD times the plain
# version's own spread per environment and output field (the larger of its
# change under a one-ulp change of its start and its distance to itself in
# float64), plus REL_TOL of 1 + |plain|, as chip_smoke.py holds it (on an
# NVIDIA H100 80GB HBM3 the kernel used up to 6.73 such spreads there, at
# 1,024 environments)
ENV_SPREAD = 10.0


@pytest.mark.parametrize("case", ["pd", "torque", "on_rack"])
def test_env_substeps_kernel_matches_plain(cuda, case):
    import dataclasses

    from quadruped_springs_tpu_torch.env import substeps as ss

    args = _env_substeps_args(cuda, 256, case)
    before = ss.env_substeps.launches
    got = _substeps_rows(ss.env_substeps(*args))
    torch.cuda.synchronize()
    assert ss.env_substeps.launches == before + 1
    want = _substeps_rows(ss.env_substeps_plain(*args))
    robot = args[0]
    moved = list(args)
    moved[0] = dataclasses.replace(robot, q=torch.nextafter(robot.q, robot.q + 1.0))
    moved = _substeps_rows(ss.env_substeps_plain(*moved))
    exact = _substeps_rows(ss.env_substeps_plain(*_float64(args)))
    for g, w, m, e in zip(got, want, moved, exact):
        spread = torch.maximum((m - w).abs(), (e - w).abs()).amax(dim=1, keepdim=True)
        assert torch.all((g - w).abs() <= REL_TOL * (1 + w.abs()) + ENV_SPREAD * spread)


def test_env_substeps_rows_do_not_depend_on_the_batch(cuda):
    """Rows 0-7 of one launch at 1,024 environments, at 8, and in blocks of
    2: bitwise equal."""
    import dataclasses

    from quadruped_springs_tpu_torch.env import substeps as ss

    args = _env_substeps_args(cuda, 1024)
    rows_of = (1, 2, 9, 10, 14)      # anchor, q_des, springs, push: a leading N
    model_fields = ("trunk_inertia6", "trunk_mass", "leg_masses", "leg_coms",
                    "leg_inertias6")

    def launch(a, b):
        cut = lambda t: t[a:b].contiguous()
        sub = list(args)
        sub[0] = dataclasses.replace(args[0], **{f.name: cut(getattr(args[0], f.name))
                                                 for f in dataclasses.fields(args[0])})
        for i in rows_of:
            sub[i] = cut(args[i])
        sub[3] = dataclasses.replace(args[3], **{f: cut(getattr(args[3], f))
                                                 for f in model_fields})
        sub[4] = dataclasses.replace(args[4], friction=cut(args[4].friction))
        return torch.cat(_substeps_rows(ss.env_substeps(*sub)), dim=1)

    full, eight = launch(0, 1024)[:8], launch(0, 8)
    pairs = torch.cat([launch(i, i + 2) for i in range(0, 8, 2)])
    assert torch.equal(full, eight) and torch.equal(eight, pairs)


@pytest.mark.parametrize("case", ["pd", "torque", "on_rack", "edges"])
def test_env_substeps_vjp_kernel_matches_plain_autograd(cuda, case):
    """env_substeps_vjp against autograd of the plain version by
    env/substeps.py check_vjp (chip_smoke.py phase 26's rule): the rule
    above per environment and input cotangent, and an environment outside
    it held to the same rule against the plain version taken along the
    kernel's own substep starts."""
    from quadruped_springs_tpu_torch.env import substeps as ss

    args = _env_substeps_args(cuda, 256, case)
    gen = torch.Generator(cuda).manual_seed(14)
    cot = [torch.randn(o.shape, generator=gen, device=cuda)
           for o in ss.output_fields(ss.env_substeps(*args))]
    before = ss.env_substeps_vjp.launches
    got = ss.env_substeps_vjp(*args, cot)
    torch.cuda.synchronize()
    assert ss.env_substeps_vjp.launches == before + 1
    report = ss.check_vjp(args, cot, got, REL_TOL, ENV_SPREAD)
    assert not report["failures"], report["failures"]


def test_env_substeps_backward_launches_the_vjp_kernel_once(cuda):
    """Under grad the forward is the same kernel (outputs bitwise); the
    backward is one env_substeps_vjp launch, its cotangents bitwise the
    wrapper's."""
    import dataclasses

    from quadruped_springs_tpu_torch.env import substeps as ss

    args = _env_substeps_args(cuda, 64, "pd")
    plain_out = ss.env_substeps(*args)
    leaves = [t.detach().clone().requires_grad_() for t in (
        *(getattr(args[0], f) for f in ss.ROBOT_FIELDS), args[1], args[2])]
    grad_args = (dataclasses.replace(args[0], **dict(zip(ss.ROBOT_FIELDS, leaves[:6]))),
                 leaves[6], leaves[7], *args[3:])
    out = ss.env_substeps(*grad_args)
    for a, b in zip(ss.output_fields(plain_out), ss.output_fields(out)):
        assert torch.equal(a, b.detach())
    cot = [torch.ones_like(o) for o in ss.output_fields(out)]
    before = ss.env_substeps_vjp.launches
    grads = torch.autograd.grad(ss.output_fields(out), leaves, cot)
    assert ss.env_substeps_vjp.launches == before + 1
    for a, b in zip(grads, ss.env_substeps_vjp(*args, cot)):
        assert torch.equal(a, b)


# --- planner_rollout: the MPPI rollout's knots and substeps in one launch -----

def _rollout_case(dev, full_rate=False, n=64, r=8, horizon=8):
    """planner_rollout's arguments for n TEST_RANDOMIZER problems x r
    candidates drawn as MPPI's first iteration draws them, every 8th problem
    from 1 in flight, every 8th from 2 on friction 0.3."""
    import dataclasses

    from quadruped_springs_tpu_torch.control import interfaces as ci
    from quadruped_springs_tpu_torch.env import randomizers as rnd
    from quadruped_springs_tpu_torch.solver import mppi
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem

    prob = MPCProblem((MPCConfig.full_rate if full_rate else MPCConfig)(horizon=horizon), dev)
    gen = torch.Generator(dev).manual_seed(3)
    scen = rnd.sample_scenario(prob.cfg, "TEST_RANDOMIZER", gen, n=n)
    friction = scen.friction.clone()
    friction[2::8] = 0.3
    scen = dataclasses.replace(scen, friction=friction)
    x0 = prob.default_x0().expand(n, -1).clone()
    x0[1::8, 2] += 0.15
    x0[1::8, 9] = 1.0
    eps = 0.3 * torch.randn((n, r, horizon, prob.action_dim), generator=gen, device=dev)
    us = torch.clamp(prob.task_warm_start()[None, None] + mppi._smooth_noise(eps), -1.0, 1.0)
    q_des = ci.action_to_command(prob.iface, us).contiguous()
    return prob, scen, (x0, q_des, prob.rollout_lanes(scen), prob.rollout_consts())


@pytest.mark.parametrize("full_rate", [False, True], ids=["relaxed", "full_rate"])
def test_planner_rollout_kernel_matches_plain(cuda, full_rate):
    """One launch against planner_rollout_plain over 8 knots of 64 problems
    x 8 candidates: the first knot lane by lane within REL_TOL·(1+|plain|)
    + ROLLOUT_SPREAD x the plain version's own spread (its one-ulp start,
    its float64 run), every knot in distribution as chip_smoke.py phase 19
    holds it (the 0.5 and 0.9 quantiles over the lanes of the kernel's
    distance to the float64 run within ROLLOUT_DIST x the plain version's
    + REL_TOL)."""
    from quadruped_springs_tpu_torch.solver import rollout as ro
    from quadruped_springs_tpu_torch.solver.mpc import cast_floats

    _, _, (x0, q_des, lanes, consts) = _rollout_case(cuda, full_rate)
    before = ro.planner_rollout.launches
    got = ro.planner_rollout(x0, q_des, lanes, consts)
    torch.cuda.synchronize()
    assert ro.planner_rollout.launches == before + 1
    assert torch.equal(got[:, :, 0], x0[:, None].expand(-1, got.shape[1], -1))
    want = ro.planner_rollout_plain(x0, q_des, lanes, consts)
    moved_x0 = x0.clone()
    moved_x0[:, 13:25] = torch.nextafter(x0[:, 13:25], x0[:, 13:25] + 1.0)
    moved = ro.planner_rollout_plain(moved_x0, q_des, lanes, consts)
    f64 = lambda t: cast_floats(t, torch.float64)
    exact = ro.planner_rollout_plain(x0.double(), q_des.double(), f64(lanes), f64(consts))
    k1 = slice(1, 2)
    spread = torch.maximum((moved - want).abs(), (exact - want).abs())[:, :, k1].amax(
        -1, keepdim=True)
    w = want[:, :, k1]
    assert torch.all((got[:, :, k1] - w).abs() <= REL_TOL * (1 + w.abs()) + ROLLOUT_SPREAD
                     * spread)
    rel = lambda xs: ((xs.double() - exact).abs() / (1 + exact.abs())).amax(-1).reshape(
        -1, xs.shape[2])[:, 1:]
    qs = torch.tensor([0.5, 0.9], dtype=torch.float64, device=cuda)
    qk, qp = torch.quantile(rel(got), qs, dim=0), torch.quantile(rel(want), qs, dim=0)
    assert torch.all(qk <= ROLLOUT_DIST * qp + REL_TOL)


def _one_command(prob, action):
    """The (1, 1, 12) command of one action (one candidate, one knot)."""
    from quadruped_springs_tpu_torch.control import interfaces as ci

    return ci.action_to_command(prob.iface, action).reshape(1, 1, 12).contiguous()


def test_planner_rollout_executor_matches_plain(cuda):
    """The closed loop's executor (1 lane, H = 1, 10 substeps at 180 kN/m):
    within REL_TOL·(1+|plain|) + ROLLOUT_SPREAD x the plain version's spread."""
    from quadruped_springs_tpu_torch import closed_loop
    from quadruped_springs_tpu_torch.solver import rollout as ro
    from quadruped_springs_tpu_torch.solver.mpc import MPCConfig, MPCProblem, cast_floats

    prob = MPCProblem(MPCConfig(task="JUMPING_IN_PLACE"), cuda)
    lanes, consts = closed_loop.executor(prob)
    x0 = prob.default_x0()[None]
    q_des = _one_command(prob, prob.task_warm_start(crouch_knots=6)[-1])[None]
    got = ro.planner_rollout(x0, q_des, lanes, consts)
    want = ro.planner_rollout_plain(x0, q_des, lanes, consts)
    moved_x0 = x0.clone()
    moved_x0[:, 13:25] = torch.nextafter(x0[:, 13:25], x0[:, 13:25] + 1.0)
    moved = ro.planner_rollout_plain(moved_x0, q_des, lanes, consts)
    f64 = lambda t: cast_floats(t, torch.float64)
    exact = ro.planner_rollout_plain(x0.double(), q_des.double(), f64(lanes), f64(consts))
    spread = torch.maximum((moved - want).abs(), (exact - want).abs()).amax(-1, keepdim=True)
    assert torch.all((got - want).abs() <= REL_TOL * (1 + want.abs()) + ROLLOUT_SPREAD * spread)


def test_planner_rollout_rows_do_not_depend_on_the_batch(cuda):
    """Rows 0-7 (every candidate of problems 0-7) of one launch at 64
    problems, at 8, and in blocks of 2: bitwise equal."""
    from quadruped_springs_tpu_torch.env.env import take
    from quadruped_springs_tpu_torch.solver import rollout as ro

    prob, scen, (x0, q_des, _, consts) = _rollout_case(cuda)

    def launch(a, b):
        idx = torch.arange(a, b, device=cuda)
        return ro.planner_rollout(x0[a:b].contiguous(), q_des[a:b].contiguous(),
                                  prob.rollout_lanes(take(scen, idx)), consts)

    full, eight = launch(0, 64)[:8], launch(0, 8)
    pairs = torch.cat([launch(i, i + 2) for i in range(0, 8, 2)])
    assert torch.equal(full, eight) and torch.equal(eight, pairs)


@pytest.mark.parametrize("n, r, horizon, full_rate, one_row", [
    (5, 3, 4, False, False), (13, 3, 4, False, False), (13, 3, 4, False, True),
    (17, 2, 4, False, False), (2, 64, 2, False, False), (40, 1, 1, True, False)])
def test_planner_rollout_lane_map(cuda, n, r, horizon, full_rate, one_row):
    """The kernel's map of a block's lanes (32) to the problems whose models
    the block stages: a block that ends early, problems across two blocks
    (also on one scenario row), R = 2, 64 and 1. Every problem's rows
    bitwise those of the problem launched alone; the first knot within
    REL_TOL·(1+|plain|) + ROLLOUT_SPREAD x the plain version's spread."""
    from quadruped_springs_tpu_torch.env.env import take
    from quadruped_springs_tpu_torch.solver import rollout as ro
    from quadruped_springs_tpu_torch.solver.mpc import cast_floats

    prob, scen, (x0, q_des, lanes, consts) = _rollout_case(cuda, full_rate, n, r, horizon)
    if one_row:
        lanes = prob.rollout_lanes(None)
    got = ro.planner_rollout(x0, q_des, lanes, consts)
    for p in range(n):
        lanes_p = lanes if one_row else prob.rollout_lanes(take(scen, torch.tensor(
            [p], device=cuda)))
        alone = ro.planner_rollout(x0[p:p + 1].contiguous(), q_des[p:p + 1].contiguous(),
                                   lanes_p, consts)
        assert torch.equal(alone[0], got[p])
    first = q_des[:, :, :1].contiguous()
    plain = lambda x, q, ln, cs: ro.planner_rollout_plain(x, q, ln, cs)[:, :, 1]
    want = plain(x0, first, lanes, consts)
    moved_x0 = x0.clone()
    moved_x0[:, 13:25] = torch.nextafter(x0[:, 13:25], x0[:, 13:25] + 1.0)
    f64 = lambda t: cast_floats(t, torch.float64)
    spread = torch.maximum(
        (plain(moved_x0, first, lanes, consts) - want).abs(),
        (plain(x0.double(), first.double(), f64(lanes), f64(consts)) - want).abs()).amax(
        -1, keepdim=True)
    assert torch.all((got[:, :, 1] - want).abs() <= REL_TOL * (1 + want.abs())
                     + ROLLOUT_SPREAD * spread)


def test_planner_rollout_rejects_what_the_kernel_does_not_take(cuda):
    from quadruped_springs_tpu_torch.solver import rollout as ro

    _, _, (x0, q_des, lanes, consts) = _rollout_case(cuda, n=8)
    with pytest.raises(TypeError):
        ro.planner_rollout(x0, q_des.bfloat16(), lanes, consts)
    with pytest.raises(ValueError, match="contiguous"):
        ro.planner_rollout(x0, q_des.transpose(1, 2).contiguous().transpose(1, 2), lanes,
                           consts)
    with pytest.raises(ValueError, match="on cpu"):
        ro.planner_rollout(x0, q_des.cpu(), lanes, consts)


# --- the rest of the MPPI iteration: the cost instantiation, mppi_update -----

@pytest.mark.parametrize("task", ["JUMPING_IN_PLACE", "JUMPING_FORWARD",
                                  "CONTINUOUS_JUMPING_FORWARD", "BACKFLIP"])
def test_planner_rollout_cost_matches_the_plain_cost(cuda, task):
    """The cost instantiation on _rollout_case's lanes (64 problems x 8
    candidates, H = 8): its states bitwise the xs-only kernel's, its costs
    bitwise the plain cost (rollout.total_cost over make_cost) of those
    states; without states the same costs; one launch each."""
    from quadruped_springs_tpu_torch.solver import rollout as ro
    from quadruped_springs_tpu_torch.tasks import costs as task_costs

    prob, _, (x0, q_des, lanes, consts) = _rollout_case(cuda)
    us = torch.randn(*q_des.shape[:3], prob.action_dim, device=cuda).clamp(-1.0, 1.0)
    ov = {"v_ref": 1.8} if task.startswith("CONTINUOUS") else {}
    stage, terminal = task_costs.make_cost(task, prob.cfg, prob.action_dim, 8, ov)
    cost = ro.TaskCost(stage, terminal, *task_costs.kernel_weights(task, 8, ov))
    before = ro.planner_rollout_cost.launches
    xs, costs = ro.planner_rollout_cost(x0, us, q_des, lanes, consts, cost, states=True)
    none, costs_only = ro.planner_rollout_cost(x0, us, q_des, lanes, consts, cost)
    assert ro.planner_rollout_cost.launches == before + 2 and none is None
    assert torch.equal(xs, ro.planner_rollout(x0, q_des, lanes, consts))
    assert torch.equal(costs, ro.total_cost(stage, terminal, xs, us))
    assert torch.equal(costs_only, costs)


@pytest.mark.parametrize("K", [32, 64, 48])
@pytest.mark.parametrize("fused", [False, True], ids=["accept", "fused"])
def test_mppi_update_matches_plain(cuda, fused, K):
    """mppi_update against mppi_update_plain on the same inputs over a
    solve's launches (64 problems x K candidates, H = 50, the PD map; K =
    32 and 64 the compiled instantiations, 48 the general one), costs with
    ties, inf and NaN: every output bitwise; problems 0-7 of each launch
    bitwise those of the launch at 8 problems."""
    from quadruped_springs_tpu_torch.control import interfaces as ci
    from quadruped_springs_tpu_torch.solver import mppi_update as mu

    B, H, m = 64, 50, 6
    iface = ci.make_interface(go1_config(True, cuda), "PD", "SYMMETRIC", "JUMPING_IN_PLACE")
    s = mu.UpdateSettings(fused=fused, smooth=True, n_elite=K // 2, temperature=0.05, u_min=-1.0,
                          u_max=1.0, iface=iface)
    gen = torch.Generator(cuda).manual_seed(5)
    norm, sigma = mu.lowpass_norm(H, device=cuda), torch.full((1,), 0.3, device=cuda)
    us0 = torch.clamp(0.5 * torch.randn(B, H, m, generator=gen, device=cuda), -1, 1)
    state = mu.UpdateState(us0, us0.clone(), torch.full((B,), float("inf") if fused else -60.0,
                                                        device=cuda), torch.zeros(B, 2, device=cuda))
    costs = -60.0 + torch.randn(B, K, generator=gen, device=cuda)
    costs[1::4, 3], costs[2::4, 5], costs[3::4, 1:] = float("inf"), float("nan"), float("inf")
    costs[0::4, 7] = costs[0::4, 6]
    draw = lambda: torch.randn(B, K, H, m, generator=gen, device=cuda)
    cand_kw = dict(rows=mu.ROWS_CANDIDATES, sigma=sigma, norm=norm)
    steps = [dict(draw=draw(), **cand_kw)]
    cand = mu.mppi_update_plain(state, s, **steps[0])[1]
    if fused:
        steps.append(dict(costs=costs, cand=cand, trace_col=0, draw=draw(), **cand_kw))
        steps.append(dict(costs=costs, cand=cand, trace_col=1, rows=mu.ROWS_BOTH))
    else:
        steps.append(dict(costs=costs, cand=cand, rows=mu.ROWS_ALT))
        steps.append(dict(cost_new=costs[:, 7].contiguous(), trace_col=0, draw=draw(),
                          **cand_kw))
        steps.append(dict(cost_new=costs[:, 9].contiguous(), trace_col=1, rows=mu.ROWS_US))
    copy = lambda st, n=B: mu.UpdateState(*(t[:n].clone() for t in (st.us, st.us_alt,
                                                                   st.cost, st.trace)))
    for kw in steps:
        want_state, want_rows, want_q = mu.mppi_update_plain(copy(state), s, **kw)
        before = mu.mppi_update.launches
        got_state, got_rows, got_q = mu.mppi_update(copy(state), s, **kw)
        assert mu.mppi_update.launches == before + 1
        for a, b in ((got_state.us, want_state.us), (got_state.us_alt, want_state.us_alt),
                     (got_state.cost, want_state.cost), (got_state.trace, want_state.trace),
                     (got_rows, want_rows), (got_q, want_q)):
            assert torch.equal(a, b)
        kw8 = {k: (v[:8].contiguous() if k in ("costs", "cand", "cost_new", "draw") else v)
               for k, v in kw.items()}
        eight = mu.mppi_update(copy(state, 8), s, **kw8)
        assert torch.equal(eight[1], got_rows[:8]) and torch.equal(eight[0].us, got_state.us[:8])
        state = want_state
