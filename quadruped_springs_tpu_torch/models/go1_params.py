"""Unitree Go1 model data: URDF-derived rigid-body constants + robot config.

Port of ``quadruped_springs_tpu.models.go1_params``; the literals and their
sources are documented there. ``Go1Config`` holds per-motor tensors on one
device; ``Go1Model`` carries a leading scenario axis on every field that
randomization touches, so a batch of scenarios is one model.

Leg order everywhere: FR, FL, RR, RL. Joint order per leg: hip(x), thigh(y),
calf(y).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from quadruped_springs_tpu_torch.models import spatial

# ---------------------------------------------------------------------------
# Structure constants
# ---------------------------------------------------------------------------
NUM_MOTORS = 12
NUM_LEGS = 4
SIDE_SIGN = np.array([-1.0, 1.0, -1.0, 1.0])   # +1 left legs, -1 right legs
FRONT_SIGN = np.array([1.0, 1.0, -1.0, -1.0])  # +1 front, -1 rear

GRAVITY = 9.8

# Kinematic constants
HIP_LINK_LENGTH = 0.0847
THIGH_LINK_LENGTH = 0.213
CALF_LINK_LENGTH = 0.213
X_OFFSET = 0.1881
Y_OFFSET = 0.04675
THIGH_Y_OFFSET = 0.08
FOOT_RADIUS = 0.02

# URDF inertial literals. COM and inertia in the link's own frame.
BASE_MASS = 1e-5
BASE_INERTIA_DIAG = 1e-5
TRUNK_MASS = 5.204
TRUNK_COM = (0.0223, 0.000, -0.0005)
TRUNK_INERTIA = (0.0168352186, 0.0004636141, 0.0002367952,
                 0.0656071082, 3.6671e-05, 0.0742720659)  # ixx ixy ixz iyy iyz izz
IMU_MASS = 0.001
IMU_OFFSET = (-0.01592, -0.06659, -0.00617)
IMU_INERTIA_DIAG = 0.0001

HIP_MASS = 0.591
HIP_COM_ABS = (0.00541, 0.00074, 6e-06)
HIP_INERTIA_ABS = (0.000374268192, 3.6844422e-05, 9.86754e-07,
                   0.000635923669, 1.172894e-06, 0.000457647394)

THIGH_MASS = 0.92
THIGH_COM_ABS = (-0.003468, 0.018947, -0.032736)
THIGH_INERTIA_ABS = (0.005851561134, 1.783284e-06, 0.000328291374,
                     0.005596155105, 2.1430713e-05, 0.00107157026)

CALF_MASS = 0.131
CALF_COM = (0.006286, 0.001307, -0.122269)
CALF_INERTIA = (0.002939186297, 1.440899e-06, -0.00010535955,
                0.00295576935, -2.4397752e-05, 3.0273372e-05)

FOOT_MASS = 0.06
FOOT_INERTIA_DIAG = 9.6e-06
FOOT_OFFSET_IN_CALF = (0.0, 0.0, -0.213)


def _inertia_mat(ixx, ixy, ixz, iyy, iyz, izz):
    return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


def _mirror(inertia6, com, sx, sy):
    """Mirror an inertial block across x (sx=-1) and/or y (sy=-1) planes."""
    ixx, ixy, ixz, iyy, iyz, izz = inertia6
    cx, cy, cz = com
    return ((ixx, sx * sy * ixy, sx * ixz, iyy, sy * iyz, izz),
            (sx * cx, sy * cy, cz))


_FR_HIP_COM = (-HIP_COM_ABS[0], +HIP_COM_ABS[1], HIP_COM_ABS[2])
_FR_HIP_I = (HIP_INERTIA_ABS[0], -HIP_INERTIA_ABS[1], -HIP_INERTIA_ABS[2],
             HIP_INERTIA_ABS[3], +HIP_INERTIA_ABS[4], HIP_INERTIA_ABS[5])
_FR_THIGH_COM = THIGH_COM_ABS
_FR_THIGH_I = (THIGH_INERTIA_ABS[0], -THIGH_INERTIA_ABS[1], +THIGH_INERTIA_ABS[2],
               THIGH_INERTIA_ABS[3], -THIGH_INERTIA_ABS[4], THIGH_INERTIA_ABS[5])


def _leg_inertials():
    """(coms, inertias) shaped (4 legs, 3 bodies, ...)."""
    coms = np.zeros((NUM_LEGS, 3, 3))
    inertias = np.zeros((NUM_LEGS, 3, 3, 3))
    for leg in range(NUM_LEGS):
        sx = FRONT_SIGN[leg]
        sy = -SIDE_SIGN[leg]
        hip_i, hip_c = _mirror(_FR_HIP_I, _FR_HIP_COM, sx, sy)
        thigh_i, thigh_c = _mirror(_FR_THIGH_I, _FR_THIGH_COM, 1.0, sy)
        coms[leg] = (hip_c, thigh_c, CALF_COM)
        inertias[leg] = (_inertia_mat(*hip_i), _inertia_mat(*thigh_i),
                         _inertia_mat(*CALF_INERTIA))
    return coms, inertias


LEG_COMS, LEG_INERTIAS = _leg_inertials()
LEG_MASSES = np.array([HIP_MASS, THIGH_MASS, CALF_MASS])

HIP_ORIGINS = np.stack(
    [FRONT_SIGN * X_OFFSET, SIDE_SIGN * Y_OFFSET, np.zeros(4)], axis=-1)
THIGH_ORIGINS = np.stack(
    [np.zeros(4), SIDE_SIGN * THIGH_Y_OFFSET, np.zeros(4)], axis=-1)
CALF_ORIGIN = np.array([0.0, 0.0, -THIGH_LINK_LENGTH])
FOOT_ORIGIN = np.array(FOOT_OFFSET_IN_CALF)
JOINT_AXES = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])


# ---------------------------------------------------------------------------
# Robot configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Go1Config:
    """Robot-level constants; per-motor fields are (12,) tensors."""
    enable_springs: bool
    init_position: torch.Tensor          # (3,)
    init_joint_angles: torch.Tensor      # (12,)
    angle_settling_pose: torch.Tensor    # (12,)
    angle_landing_pose: torch.Tensor     # (12,)
    nominal_foot_pos: torch.Tensor       # (12,) leg frame
    cartesian_settling_pose: torch.Tensor
    cartesian_landing_pose: torch.Tensor
    is_fallen_height: float
    init_height: float
    rl_upper_angle_joint: torch.Tensor   # (12,)
    rl_lower_angle_joint: torch.Tensor
    rl_upper_cartesian_pos: torch.Tensor
    rl_lower_cartesian_pos: torch.Tensor
    torque_limits: torch.Tensor          # (12,)
    velocity_limits: torch.Tensor        # (12,)
    rl_velocity_limits: torch.Tensor     # (12,)
    motor_kp: torch.Tensor               # (12,)
    motor_kd: torch.Tensor               # (12,)
    kp_cartesian: torch.Tensor           # (3,3)
    kd_cartesian: torch.Tensor           # (3,3)
    spring_stiffness: torch.Tensor       # (3,) hip/thigh/calf; zeros without springs
    spring_damping: torch.Tensor         # (3,)
    spring_rest_angles: torch.Tensor     # (3,)
    max_motor_angle_change_per_step: float
    max_cartesian_change_per_step: torch.Tensor  # (3,)


_DEFAULT_HIP = 0.0
_DEFAULT_THIGH = np.pi / 4
_DEFAULT_CALF = -np.pi / 2
_INIT_ANGLES = np.array([_DEFAULT_HIP, _DEFAULT_THIGH, _DEFAULT_CALF] * NUM_LEGS)
_DEFAULT_Y = HIP_LINK_LENGTH
_NOMINAL_FOOT = np.array([[0.0, s * _DEFAULT_Y, -0.32] for s in SIDE_SIGN]).flatten()
_CART_LANDING = np.array([[0.0, s * _DEFAULT_Y, -0.29] for s in SIDE_SIGN]).flatten()
_CART_SETTLING = np.array([[-0.02, s * _DEFAULT_Y, -0.15] for s in SIDE_SIGN]).flatten()


def go1_config(enable_springs: bool = True, device=None) -> Go1Config:
    """Build the robot config (with or without the parallel springs) on
    `device`: the CUDA card unless the caller names another (without a card
    the default raises; there is no fallback to the CPU)."""
    device = torch.device(device if device is not None else "cuda")
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float32,
                                    device=device)
    if enable_springs:
        calf_lower = -2.5
        kp = [75.0, 75.0, 75.0]
        kd = [0.8, 1.0, 1.0]
        kp_cart = np.diag([1200.0, 2000.0, 2000.0])
        kd_cart = np.diag([13.0, 15.0, 15.0])
        settling = np.array([0.0, 1.14, -2.5] * NUM_LEGS)
        is_fallen_h = 0.10
        cart_up_z = 0.18
        spring_k = [20.0, 20.0, 30.0]
        spring_d = [0.3, 0.3, 0.3]
    else:
        calf_lower = -2.12
        kp = [55.0, 60.0, 60.0]
        kd = [0.8, 1.0, 1.0]
        kp_cart = np.diag([500.0, 500.0, 500.0])
        kd_cart = np.diag([10.0, 10.0, 10.0])
        settling = np.array([0.0, 1.14, -2.19] * NUM_LEGS)
        is_fallen_h = 0.12
        cart_up_z = 0.11
        spring_k = [0.0, 0.0, 0.0]
        spring_d = [0.0, 0.0, 0.0]
    spring_rest = [_DEFAULT_HIP, _DEFAULT_THIGH, _DEFAULT_CALF + 0.3]

    rl_upper = np.array([0.2, _DEFAULT_THIGH + 0.5, -0.95] * NUM_LEGS)
    rl_lower = np.array([-0.2, _DEFAULT_THIGH - 0.5, calf_lower] * NUM_LEGS)
    cart_delta_up = np.array([0.2, 0.05, cart_up_z] * NUM_LEGS)
    cart_delta_lo = np.array([0.2, 0.05, 0.07] * NUM_LEGS)

    return Go1Config(
        enable_springs=enable_springs,
        init_position=f32([0.0, 0.0, 0.32]),
        init_joint_angles=f32(_INIT_ANGLES),
        angle_settling_pose=f32(settling),
        angle_landing_pose=f32(_INIT_ANGLES),
        nominal_foot_pos=f32(_NOMINAL_FOOT),
        cartesian_settling_pose=f32(_CART_SETTLING),
        cartesian_landing_pose=f32(_CART_LANDING),
        is_fallen_height=is_fallen_h,
        init_height=0.35,
        rl_upper_angle_joint=f32(rl_upper),
        rl_lower_angle_joint=f32(rl_lower),
        rl_upper_cartesian_pos=f32(_NOMINAL_FOOT + cart_delta_up),
        rl_lower_cartesian_pos=f32(_NOMINAL_FOOT - cart_delta_lo),
        torque_limits=f32([23.7, 23.7, 33.55] * NUM_LEGS),
        velocity_limits=f32([30.1] * NUM_MOTORS),
        rl_velocity_limits=f32([10.0] * NUM_MOTORS),
        motor_kp=f32(kp * NUM_LEGS),
        motor_kd=f32(kd * NUM_LEGS),
        kp_cartesian=f32(kp_cart),
        kd_cartesian=f32(kd_cart),
        spring_stiffness=f32(spring_k),
        spring_damping=f32(spring_d),
        spring_rest_angles=f32(spring_rest),
        max_motor_angle_change_per_step=0.2,
        max_cartesian_change_per_step=f32([0.1, 0.02, 0.08]),
    )


# ---------------------------------------------------------------------------
# Dynamics model assembly
# ---------------------------------------------------------------------------

# Fields of Go1Model that carry the leading scenario axis.
SCENARIO_FIELDS = ("trunk_inertia6", "trunk_mass", "leg_masses", "leg_coms",
                   "leg_inertias6")


@dataclasses.dataclass(frozen=True)
class Go1Model:
    """Rigid-body model consumed by dynamics.py, batched over scenarios.

    The trunk merges base + trunk + imu (+ offset mass); each leg is a
    3-body chain (hip, thigh, calf+foot merged). Fields in SCENARIO_FIELDS
    carry a leading axis of B scenarios (or lanes); the geometry is shared.
    """
    trunk_inertia6: torch.Tensor   # (B,6,6) spatial inertia about the base origin
    trunk_mass: torch.Tensor       # (B,)
    leg_masses: torch.Tensor       # (B,4,3)
    leg_coms: torch.Tensor         # (B,4,3,3) COM in own link frame
    leg_inertias6: torch.Tensor    # (B,4,3,6,6) spatial inertia about link frame
    hip_origins: torch.Tensor      # (4,3)
    thigh_origins: torch.Tensor    # (4,3)
    calf_origin: torch.Tensor      # (3,)
    foot_origin: torch.Tensor      # (3,) in calf frame
    joint_axes: torch.Tensor       # (3,3)
    gravity: torch.Tensor          # (3,)
    foot_radius: float

    def repeat_lanes(self, repeats: int) -> "Go1Model":
        """Repeat each scenario `repeats` times along the leading axis
        (scenario-major), e.g. B scenarios -> B·K sample lanes."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).repeat_interleave(repeats, dim=0)
            for f in SCENARIO_FIELDS})


@functools.lru_cache(maxsize=None)
def _model_constants(device: torch.device, dtype: torch.dtype) -> dict:
    """The URDF constants of build_model as tensors on a device, made once:
    copying them from the host at every call would synchronise a CUDA
    stream, and the environment builds its model every control step."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
    return {
        "leg_masses": t(LEG_MASSES), "trunk_mass": t(TRUNK_MASS),
        "trunk_com": t(TRUNK_COM), "trunk_inertia": t(_inertia_mat(*TRUNK_INERTIA)),
        "base_mass": t(BASE_MASS), "imu_mass": t(IMU_MASS), "imu_offset": t(IMU_OFFSET),
        "leg_coms": t(LEG_COMS), "leg_inertias": t(LEG_INERTIAS),
        "foot_origin": t(FOOT_ORIGIN), "hip_origins": t(HIP_ORIGINS),
        "thigh_origins": t(THIGH_ORIGINS), "calf_origin": t(CALF_ORIGIN),
        "joint_axes": t(JOINT_AXES), "gravity": t([0.0, 0.0, -GRAVITY]),
        "eye3": torch.eye(3, dtype=dtype, device=device),
        "zero3": torch.zeros(3, dtype=dtype, device=device),
        "zero33": torch.zeros(3, 3, dtype=dtype, device=device),
    }


def build_model(leg_masses=None, foot_masses=None, base_mass=None,
                offset_mass=None, offset_pos=None, dtype=torch.float32,
                device=None) -> Go1Model:
    """Assemble a batched Go1Model, optionally with randomized masses.

    Every given argument carries a leading batch axis B: leg_masses (B,3)
    or (B,4,3), foot_masses (B,4), base_mass (B,), offset_mass (B,),
    offset_pos (B,3). Omitted ones take the URDF values; with none given
    the batch is 1.
    """
    given = [a for a in (leg_masses, foot_masses, base_mass, offset_mass,
                         offset_pos) if a is not None]
    if device is None and given:
        device = given[0].device
    device = torch.device(device if device is not None else "cpu")
    c = _model_constants(device, dtype)
    B = max([a.shape[0] for a in given], default=1)
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    if leg_masses is None:
        leg_masses = c["leg_masses"].expand(B, NUM_LEGS, 3)
    else:
        leg_masses = f(leg_masses)
        if leg_masses.dim() == 2:
            leg_masses = leg_masses[:, None, :]
        leg_masses = leg_masses.expand(B, NUM_LEGS, 3)
    foot_masses = (torch.full((B, NUM_LEGS), FOOT_MASS, dtype=dtype, device=device)
                   if foot_masses is None else f(foot_masses).expand(B, NUM_LEGS))
    base_mass = (c["trunk_mass"].expand(B) if base_mass is None
                 else f(base_mass).expand(B))
    offset_mass = (torch.zeros(B, dtype=dtype, device=device) if offset_mass is None
                   else f(offset_mass).expand(B))
    offset_pos = (torch.zeros(B, 3, dtype=dtype, device=device) if offset_pos is None
                  else f(offset_pos).expand(B, 3))
    eye3 = c["eye3"]

    # trunk = base + trunk + imu (+ offset mass), about the base origin
    trunk_I = spatial.spatial_inertia(base_mass, c["trunk_com"].expand(B, 3),
                                      c["trunk_inertia"])
    base_I = spatial.spatial_inertia(c["base_mass"], c["zero3"], BASE_INERTIA_DIAG * eye3)
    imu_I = spatial.spatial_inertia(c["imu_mass"], c["imu_offset"], IMU_INERTIA_DIAG * eye3)
    off_I = spatial.spatial_inertia(offset_mass, offset_pos, c["zero33"])
    trunk_inertia6 = trunk_I + base_I + imu_I + off_I
    trunk_mass = base_mass + BASE_MASS + IMU_MASS + offset_mass

    # legs: merge the foot (point mass + tiny sphere inertia) into the calf
    leg_coms = c["leg_coms"].expand(B, NUM_LEGS, 3, 3)
    leg_I6 = spatial.spatial_inertia(leg_masses, leg_coms, c["leg_inertias"])
    foot_I6 = spatial.spatial_inertia(
        foot_masses, c["foot_origin"].expand(B, NUM_LEGS, 3),
        FOOT_INERTIA_DIAG * eye3.expand(B, NUM_LEGS, 3, 3))
    calf_mass = leg_masses[:, :, 2] + foot_masses
    leg_inertias6 = torch.stack(
        [leg_I6[:, :, 0], leg_I6[:, :, 1], leg_I6[:, :, 2] + foot_I6], dim=2)
    leg_masses_merged = torch.stack(
        [leg_masses[:, :, 0], leg_masses[:, :, 1], calf_mass], dim=2)
    calf_com = ((leg_masses[:, :, 2:3] * leg_coms[:, :, 2]
                 + foot_masses[..., None] * c["foot_origin"])
                / leg_masses_merged[:, :, 2:3])
    leg_coms = torch.stack([leg_coms[:, :, 0], leg_coms[:, :, 1], calf_com], dim=2)

    return Go1Model(
        trunk_inertia6=trunk_inertia6,
        trunk_mass=trunk_mass,
        leg_masses=leg_masses_merged,
        leg_coms=leg_coms,
        leg_inertias6=leg_inertias6,
        hip_origins=c["hip_origins"],
        thigh_origins=c["thigh_origins"],
        calf_origin=c["calf_origin"],
        foot_origin=c["foot_origin"],
        joint_axes=c["joint_axes"],
        gravity=c["gravity"],
        foot_radius=FOOT_RADIUS,
    )
