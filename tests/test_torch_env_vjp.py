"""The reverse mode of the environment's control step on the CPU.

Held here, from inputs made with numpy seeds and handed to every side:

  * autograd through env/substeps.py env_substeps_plain against jax.vjp of
    the JAX package's anchored control step (the lax.scan of dyn.step that
    tests/test_torch_env_substeps.py runs), ref path, at N = 8 and R = 10,
    cotangents of every float output drawn from a seed;
  * the env_substeps_vjp kernel's body (csrc/env_lane_vjp.cuh) built for the
    CPU with g++ by tests/env_substeps_vjp_host.cpp, against that autograd;
  * one QuadrupedEnv.step (BACKFLIP, ARS_BACKFLIP, SYMMETRIC) against jax.vjp
    of the JAX env.step, from the action and the state to the next state
    and the observation;
  * the tie rules: min(max()) clips whose derivative at a tie is one half,
    as jnp.clip's and jnp.minimum's are, with the forward values of the
    clamps they replace.

The rule, per environment and field (chip_smoke.py phase 26 holds the
kernel on the card to it): |got - want| <= 1e-5·(1+|want|) + SPREAD x the
spread, the largest over the field's columns of the reference's own
float32 rounding: the plain version's distance to itself run in float64
and, for the host build, its change under a one-ulp change of its start.
Stiff contact (180 kN/m) makes the cotangents large (|d pos| ~ 3e5 over a
control step) and carries each rounding through the ten substeps; the
spreads are of the same order as the differences measured.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_springs_tpu.env.env import EnvConfig as JEnvConfig
from quadruped_springs_tpu.env.env import QuadrupedEnv as JQuadrupedEnv
from quadruped_springs_tpu.models import dynamics as jdyn
from quadruped_springs_tpu_torch import convert, kernels
from quadruped_springs_tpu_torch.env import substeps as ss
from quadruped_springs_tpu_torch.env.env import EnvConfig, QuadrupedEnv
from quadruped_springs_tpu_torch.models import dynamics as tdyn
from quadruped_springs_tpu_torch.train import behaviour as bh
from tests import test_torch_env_substeps as es
from tests import torch_env_vjp_host64 as h64

FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd", "anchor", "q_des")
SPREAD = 10.0
REL = 1e-5


def _cotangents(case: str, seed: int):
    """Standard-normal cotangents of env_substeps's float outputs
    (ss.GRAD_OUTPUTS) for a case, float32 numpy."""
    out = ss.env_substeps_plain(*es._torch_args(case))
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tuple(o.shape)).astype(np.float32)
            for o in ss.output_fields(out)]


def _rows(grads):
    return {k: np.asarray(g.detach() if torch.is_tensor(g) else g, np.float64).reshape(
        g.shape[0], -1) for k, g in zip(FIELDS, grads)}


def _plain(args, cot, moved=False):
    """Autograd through env_substeps_plain: _rows of the input cotangents
    (float64 arguments where the cotangents are float64; the joint angles
    one float32 ulp up where moved)."""
    if moved:
        robot, args = args[0], list(args)
        args[0] = dataclasses.replace(robot, q=torch.nextafter(robot.q, robot.q + 1.0))
    cot = [None if c is None else torch.as_tensor(c) for c in cot]
    return _rows(ss.env_substeps_vjp_plain(*args, cot))


def _check(got, want, spread, what):
    """The rule of the module docstring; returns the spreads used."""
    used = 0.0
    for k in want:
        s = spread[k].max(axis=1, keepdims=True)
        slack = np.abs(got[k] - want[k]) - REL * (1.0 + np.abs(want[k]))
        assert np.all(np.isfinite(got[k])), f"{what} d_{k}: not finite"
        bad = slack > SPREAD * s
        assert not bad.any(), (
            f"{what} d_{k}: |got - want| {np.abs(got[k] - want[k])[bad].max()} over the "
            f"bound at environments {np.nonzero(bad.any(1))[0].tolist()} (spread "
            f"{s[bad.any(1)].ravel()})")
        used = max(used, float((np.maximum(slack, 0.0) / np.maximum(s, 1e-30)).max()))
    return used


# --- the plain version against the JAX package ----------------------------------

def _jax_vjp(case: str, seed: int):
    """jax.vjp of JAX's control step (es._jax_control_step, ref) on a case, with
    _cotangents(case, seed) (the total torque, which JAX's scan does not
    return, gets none): _rows of the cotangents of (the state, anchor,
    q_des), q_des (N,R,12) summed over R where the port holds it."""
    d, anchor, q_des, ext, scen = es._case(case)
    f = es._jax_control_step("ref", case == "on_rack")
    flags = jnp.full(es.N, case == "torque")

    def step(state, anc, cmds):
        r, anc2, tau_m, tau_m_sum, fn, _, _ = f(scen, state, anc, cmds, jnp.asarray(ext), flags)
        return r, anc2, tau_m, tau_m_sum, fn

    state = jdyn.RobotState(**{k: jnp.asarray(v) for k, v in d.items()})
    _, pull = jax.vjp(step, state, jnp.asarray(anchor), jnp.asarray(q_des))
    c = [jnp.asarray(x) for x in _cotangents(case, seed)]
    g_state, g_anchor, g_q_des = pull((jdyn.RobotState(*c[:6]), c[6], c[8], c[9], c[10]))
    if case == "torque":
        g_q_des = g_q_des.sum(axis=1)
    return _rows([*(getattr(g_state, f) for f in ss.ROBOT_FIELDS), g_anchor, g_q_des])


@pytest.mark.parametrize("case", ["pd", "torque", "on_rack"])
def test_plain_control_step_vjp_matches_jax(case):
    """Autograd of env_substeps_plain over R = 10 substeps against jax.vjp of
    JAX's scan (ref path) on the same inputs and cotangents, within the
    module's rule, the spread the plain version's float32-vs-float64
    distance. (JAX's own ref-vs-soa distance of the same vjp is not taken:
    the reverse mode of the soa path's scan did not compile within eight
    minutes on the CPU.)"""
    args = es._torch_args(case)
    cot = _cotangents(case, 0)
    cot[7] = None                    # JAX's scan returns no total torque
    got = _plain(args, cot)
    exact = _plain(ss.float64_args(args),
                   [None if c is None else c.astype(np.float64) for c in cot])
    want = _jax_vjp(case, 0)
    spread = {k: np.abs(got[k] - exact[k]) for k in got}
    _check(got, want, spread, f"plain vs JAX ({case})")


# --- the kernel's body, built for the CPU -----------------------------------------

@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """The adjoint's body built with g++ (tests/env_substeps_vjp_host.cpp), once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's body for the CPU")
    src = Path(__file__).with_name("env_substeps_vjp_host.cpp")
    lib = tmp_path_factory.mktemp("vjp_host_build") / "libenv_substeps_vjp_host.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-o",
                    str(lib), str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).env_substeps_vjp_host
    fn.argtypes = kernels.ENV_SUBSTEPS_VJP_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


# "pd_edges": the pd case with lanes 3 and 6 lifted and past their joint
# limits, lane 1 on its back on the trunk's corners and lane 7 folded onto
# its knees (ss.edge_states): the joint-limit torque and the knee and
# trunk-corner contact act
EDGES = dict(limits=[es.FLIGHT, 6], upside_down=[1], folded=[7])


def _base(case: str) -> str:
    """The case of tests/test_torch_env_substeps.py a host case starts from."""
    return case.removesuffix("_shared").removesuffix("_edges")


def _host_args(case: str):
    args = list(es._torch_args(_base(case)))
    if case == "pd_shared":     # one model row and one (3,) force for every lane
        m = args[3]
        args[3] = dataclasses.replace(m, **{f: getattr(m, f)[:1] for f in (
            "trunk_inertia6", "trunk_mass", "leg_masses", "leg_coms", "leg_inertias6")})
        args[14] = args[14][es.PUSHED].contiguous()
    if case == "pd_edges":
        args = list(ss.edge_states(args, **EDGES))
    return tuple(args)


@pytest.mark.parametrize("case", ["pd", "torque", "on_rack", "pd_shared", "pd_edges"])
def test_kernel_body_on_the_host_matches_plain_autograd(case, host_build):
    """The adjoint's body (the four legs as four threads, the R substeps
    re-run with lane_substep, then swept back) against autograd of
    env_substeps_plain on the same cotangents, every one given, within the
    module's rule: the spread the plain version's float32-vs-float64
    distance and its change under a one-ulp change of its start."""
    args = _host_args(case)
    cot = _cotangents(_base(case), 1)
    launch, grads, keep = ss.vjp_launch_args(*args, [torch.as_tensor(c) for c in cot])
    assert host_build(*launch, None) == 0
    got = _rows(grads)
    want = _plain(args, cot)
    exact = _plain(ss.float64_args(args), [c.astype(np.float64) for c in cot])
    again = _plain(args, cot, moved=True)
    spread = {k: np.maximum(np.abs(exact[k] - want[k]), np.abs(again[k] - want[k]))
              for k in want}
    _check(got, want, spread, f"host build vs plain ({case})")
    if case == "on_rack":        # the base is welded: no cotangent reaches the anchors
        assert not got["anchor"].any()


@pytest.fixture(scope="module")
def host64_build(tmp_path_factory):
    """The adjoint's body in float64 (tests/env_substeps_vjp_host64.cpp), once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's body for the CPU")
    return h64.build(tmp_path_factory.mktemp("vjp_host64_build"))


# the float64 body against the plain version's float64 autograd: within
# F64_TOL of 1 + the field's largest magnitude (measured: 3.5e-8 at most, the
# plain version's float32 distance to its float64 self 3e-8 to 1e-4; a
# missing term shows at its own size, e.g. 1e-3 for the joint-limit torque's)
F64_TOL = 1e-6


@pytest.mark.parametrize("case", ["pd", "torque", "on_rack", "pd_shared", "pd_edges"])
def test_kernel_body_in_float64_matches_plain_autograd_in_float64(case, host64_build):
    """The adjoint's body built in double (every float of the bodies a
    double) against autograd of env_substeps_plain in float64, on the same
    inputs and cotangents: the adjoint's arithmetic term by term, without
    the float32 spread the kernel is otherwise held to."""
    args = _host_args(case)
    cot = _cotangents(_base(case), 1)
    got = _rows(h64.run(host64_build, args, [torch.as_tensor(c) for c in cot]))
    want = _plain(ss.float64_args(args), [c.astype(np.float64) for c in cot])
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=F64_TOL * (1.0 + np.abs(w).max()),
                                   err_msg=f"d_{k}")


def test_kernel_body_with_no_cotangents_gives_zeros(host_build):
    """A cotangent of None counts as zero: all None gives zero everywhere;
    only the summed motor torque's gives that of q_des and the state."""
    args = _host_args("pd")
    launch, grads, keep = ss.vjp_launch_args(*args, [None] * len(ss.GRAD_OUTPUTS))
    assert host_build(*launch, None) == 0
    assert not any(bool(g.any()) for g in grads)
    cot = [None] * len(ss.GRAD_OUTPUTS)
    cot[ss.GRAD_OUTPUTS.index("tau_m_sum")] = torch.ones(es.N, 12)
    launch, grads, keep = ss.vjp_launch_args(*args, cot)
    assert host_build(*launch, None) == 0
    want = _plain(args, [None if c is None else c.numpy() for c in cot])
    _check(_rows(grads), want, {k: np.abs(v) * 1e-3 for k, v in want.items()}, "tau_m_sum")


@pytest.mark.parametrize("case", ["pd", "torque"])
def test_vjp_along_the_plain_starts_is_the_plain_vjp(case):
    """ss.vjp_along (check_vjp's reference at a kink: each substep's
    autograd from given starts, chained back) taken along the plain
    version's own substep starts gives the plain version's cotangents: the
    same arithmetic, the held command's sum over the substeps in another
    order."""
    args = es._torch_args(case)
    cot = [torch.as_tensor(c) for c in _cotangents(case, 2)]
    want = _rows(ss.env_substeps_vjp_plain(*args, cot))
    got = _rows(ss.vjp_along(args, cot, ss.substep_starts(args)))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_check_vjp_passes_the_host_build_and_rejects_a_planted_fault(host_build):
    """ss.check_vjp, the rule chip_smoke.py phase 26 and the card's test hold
    the kernel to: the host build of the adjoint passes on the pd_edges
    case; the same cotangents with one environment's d_qd moved by 1e-3 of
    the field's scale fail, also against the plain version along the
    substep starts, and as no kink (on the CPU env_substeps is the plain
    version, so no branch parts)."""
    args = _host_args("pd_edges")
    cot = [torch.as_tensor(c) for c in _cotangents("pd", 1)]
    launch, grads, keep = ss.vjp_launch_args(*args, cot)
    assert host_build(*launch, None) == 0
    report = ss.check_vjp(args, cot, grads, REL, SPREAD)
    assert not report["failures"] and not report["kinks"], report["failures"]
    bad = list(grads)
    bad[5] = bad[5].clone()
    bad[5][es.FLIGHT, 1] += 1e-3 * float(bad[5].abs().max())
    report = ss.check_vjp(args, cot, bad, REL, SPREAD)
    assert report["along"] == [es.FLIGHT] and report["kinks"] == []
    assert len(report["failures"]) == 1 and "along the kernel's" in report["failures"][0]


def test_wrapper_keeps_refusing_what_is_not_differentiated():
    """The state, anchors and commands may require grad (autograd runs
    through the plain version on the CPU); a model field, the gains or the
    friction requiring grad raises."""
    args = list(_host_args("pd"))
    args[2] = args[2].clone().requires_grad_()
    out = ss.env_substeps(*args)
    assert out.robot.q.requires_grad
    for i, make in ((5, lambda a: a.clone().requires_grad_()),
                    (4, lambda p: dataclasses.replace(
                        p, friction=p.friction.clone().requires_grad_())),
                    (3, lambda m: dataclasses.replace(
                        m, leg_masses=m.leg_masses.clone().requires_grad_()))):
        bad = list(args)
        bad[i] = make(args[i])
        with pytest.raises(ValueError, match="must not require grad"):
            ss.env_substeps(*bad)


# --- one env step against the JAX env.step ---------------------------------------

FLIP = dict(enable_springs=True, task_env="BACKFLIP", observation_space_mode="ARS_BACKFLIP",
            action_space_mode="SYMMETRIC", obs_noise=False, max_ep_len=4.0,
            settling_steps=200, env_randomizer_mode="TEST_RANDOMIZER")
ENV_TOL = 1e-3


@pytest.fixture(scope="module")
def flip_step():
    """Two JAX reset states of the backflip env, a third lifted 10 cm and
    tipped, random actions, cotangents of the next state's robot fields and
    observation; JAX's vjp of env.step on them."""
    jenv = JQuadrupedEnv(JEnvConfig(**FLIP))
    js, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(5), 3))
    r = js.robot
    js = js.replace(robot=r.replace(pos=r.pos.at[2, 2].add(0.1),
                                    ang_vel=r.ang_vel.at[2].set(jnp.array([0.3, -2.0, 0.1]))))
    rng = np.random.default_rng(11)
    action = rng.uniform(-1.0, 1.0, (3, 6)).astype(np.float32)

    def step(robot, a):
        s2, obs, *_ = jax.vmap(jenv.step)(js.replace(robot=robot), a)
        return s2.robot, obs

    (robot2, obs2), pull = jax.vjp(step, js.robot, jnp.asarray(action))
    cot = [rng.standard_normal(np.shape(getattr(robot2, f))).astype(np.float32)
           for f in ss.ROBOT_FIELDS] + [rng.standard_normal(np.shape(obs2)).astype(np.float32)]
    g_robot, g_action = pull((jdyn.RobotState(*map(jnp.asarray, cot[:6])), jnp.asarray(cot[6])))
    want = {f: np.asarray(getattr(g_robot, f), np.float64) for f in ss.ROBOT_FIELDS}
    want["action"] = np.asarray(g_action, np.float64)
    return js, action, cot, want


def _port_step_grads(js, action, cot):
    """Autograd of the port's QuadrupedEnv.step from (robot, action) to (the
    next robot fields, obs) with cotangents cot."""
    env = QuadrupedEnv(EnvConfig(**FLIP), device="cpu")
    state = convert.env_state(js)
    leaves = [getattr(state.robot, f).detach().clone().requires_grad_() for f in ss.ROBOT_FIELDS]
    act = torch.as_tensor(action).requires_grad_()
    state = dataclasses.replace(state, robot=tdyn.RobotState(*leaves))
    s2, obs, *_ = env.step(state, act)
    outs = [getattr(s2.robot, f) for f in ss.ROBOT_FIELDS] + [obs]
    grads = torch.autograd.grad(outs, leaves + [act], [torch.as_tensor(c) for c in cot])
    return {k: g.detach().double().numpy() for k, g in zip((*ss.ROBOT_FIELDS, "action"), grads)}


def test_env_step_vjp_matches_jax(flip_step):
    """QuadrupedEnv.step's reverse mode (interface, substeps, task, sensors)
    against jax.vjp of the JAX env.step: every cotangent finite and within
    ENV_TOL of the field's largest JAX magnitude (the control step's ten
    stiff substeps part the float32 paths by ~1e-4 of it, the JAX step's
    soa path against the port's ref order)."""
    js, action, cot, want = flip_step
    got = _port_step_grads(js, action, cot)
    for k, w in want.items():
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=ENV_TOL * (1.0 + np.abs(w).max()),
                                   err_msg=k)
    assert np.abs(want["action"]).max() > 1.0    # the actions do move the state


# --- ties: one half, as JAX ----------------------------------------------------

@pytest.mark.parametrize("x,lo,hi", [(1.0, -1.0, 1.0), (-1.0, -1.0, 1.0), (0.0, 0.0, 1.0),
                                     (1.0, 0.0, 1.0)])
def test_behaviour_clip_halves_at_a_tie(x, lo, hi):
    """bh.clip (mlp_act's action clip, stab_score's two clips of up_z): the
    value of torch.clamp and jnp.clip, the derivative of jnp.clip: one half
    at a tie, one inside."""
    t = torch.tensor([x, 0.5 * (lo + hi)], requires_grad=True)
    y = bh.clip(t, lo, hi)
    assert torch.equal(y, torch.clamp(t, lo, hi))
    (g,) = torch.autograd.grad(y.sum(), t)
    jg = jax.grad(lambda v: jnp.clip(v, lo, hi).sum())(jnp.asarray([x, 0.5 * (lo + hi)]))
    assert g.tolist() == [0.5, 1.0] == np.asarray(jg).tolist()


def test_mlp_act_at_the_landing_action_halves_at_a_tie():
    """The lander's init, W2 = 0 and b2 = the landing action with a component
    at exactly ±1: d action / d b2 is one half there, as the script's
    mlp_apply (jnp.clip) gives."""
    on = bh.vnorm.RunningNorm(torch.zeros(4), torch.ones(4), torch.ones(()))
    b2 = torch.tensor([1.0, -1.0, 0.25], requires_grad=True)
    p = {"W1": torch.ones(2, 4), "b1": torch.zeros(2), "W2": torch.zeros(3, 2), "b2": b2}
    a = bh.mlp_act(p, on)(torch.ones(1, 4))
    (g,) = torch.autograd.grad(a.sum(), b2)
    assert a.tolist() == [[1.0, -1.0, 0.25]] and g.tolist() == [0.5, 0.5, 1.0]


def _velocity_tie():
    """dyn.step on the pd case's lane 0 for one substep, with the velocity
    limits set to |qd + dt qdd| of the first run: every joint at its clip."""
    args = es._torch_args("pd")
    robot, anchor, q_des, model, params = args[:5]
    cut = lambda t: t[:1]
    robot = tdyn.RobotState(*(cut(getattr(robot, f)) for f in ss.ROBOT_FIELDS))
    params = dataclasses.replace(params, friction=params.friction[:1])
    model = dataclasses.replace(model, **{f: getattr(model, f)[:1] for f in (
        "trunk_inertia6", "trunk_mass", "leg_masses", "leg_coms", "leg_inertias6")})
    tau = torch.zeros(1, 12)
    free, _ = tdyn.step(model, params, robot, tau, torch.full((12,), 1e3), foot_anchor=anchor[:1])
    return model, params, robot, tau, anchor[:1], free.qd[0].abs()


def test_velocity_clip_halves_at_a_tie():
    """dyn.step's joint-velocity clip (jnp.clip in JAX's dyn.step): with every
    joint exactly at its limit the new qd is unchanged in value and d qd' /
    d qd is half of what it is with the limits 1 rad/s wider."""
    model, params, robot, tau, anchor, vlim = _velocity_tie()

    def dqd(limit):
        qd = robot.qd.clone().requires_grad_()
        new, _ = tdyn.step(model, params, dataclasses.replace(robot, qd=qd), tau, limit,
                           foot_anchor=anchor)
        return new.qd, torch.autograd.grad(new.qd.sum(), qd)[0]

    at, g_at = dqd(vlim)
    inside, g_in = dqd(vlim + 1.0)
    assert torch.equal(at, inside)
    torch.testing.assert_close(g_at, 0.5 * g_in, rtol=1e-6, atol=0)


def test_cone_clip_halves_at_a_tie():
    """The feet's cone clip min(μ fn / |f_trial|, 1) (jnp.minimum(1.0, ...) in
    JAX): at a trial force exactly on the cone the force is unchanged in
    value and its derivative in the anchor is half the inside one (the
    anchor does not slide at the tie)."""
    kn = kt = 1024.0
    phi = 2.0 ** -10

    def force(ax):
        ax = torch.tensor([ax], dtype=torch.float32, requires_grad=True)
        p_w = torch.zeros(1, 12, 3)
        p_w[0, :, 2] = 1.0
        p_w[0, 0, 2] = -phi                            # foot 0 pressed phi deep
        anchor = torch.zeros(1, 4, 2)
        anchor = anchor + torch.nn.functional.pad(ax, (0, 7)).view(1, 4, 2)
        f, fn, inc, new = tdyn.contact_forces_anchored_plain(
            -p_w[..., 2], torch.zeros(1, 12, 3), p_w[:, :4, :2], anchor, 1.0, kn, 0.0, kt, 0.0,
            0.02, True)
        return f[0, 0, 0], torch.autograd.grad(f[0, 0, 0], ax)[0], fn[0, 0]

    at, g_at, fn = force(phi)           # kt·phi == μ·kn·phi: on the cone
    assert float(fn.detach()) == kn * phi and float(at.detach()) == kt * phi
    _, g_in, _ = force(phi / 2)         # inside the cone
    assert float(g_in) == kt and float(g_at) == 0.5 * kt
