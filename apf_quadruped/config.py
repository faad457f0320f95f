"""Typed, hashable configuration tree for the whole engine.

The reference scatters every gain/constant inline in C++ (see
reference main.cpp: K_com=3000, D_com=50, tau_max=60, mu=0.5, APF gains
0.01..0.4 in compute_Kpa, thresholds 0.34/0.07/0.06/2.0) plus compile-time
#defines (REP_FIELD / MIN_EXIT, main.cpp:62-64).  Here they live in one
frozen dataclass tree: every field is a float/int/bool/tuple so configs are
hashable and can be passed as jit static arguments.

All values are documented with their reference provenance (file:line in
/root/reference) so parity can be audited.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _d(**kwargs):
    return dataclasses.field(default_factory=lambda: kwargs)


@dataclasses.dataclass(frozen=True)
class RobotConfig:
    """DogBot v4 constants.

    Provenance: towr dogbot model (include/towr/models/examples/dogbot_model.h:55-94),
    dogbot.xacro:18-26 (geometry), main.cpp:493-494 (joint limits).
    Leg order convention everywhere in this package: (BR, BL, FL, FR) —
    matching the reference's Jacobian row stacking (main.cpp ctrl_loop:
    swing rows 0-2=BR, 3-5=BL, 6-8=FL, 9-11=FR).
    The body's long axis is +y (forward); x is lateral (dogbot.xacro:23-24).
    """

    mass: float = 21.261                       # dogbot_model.h:91
    # Rotational inertia about CoM (Ixx, Iyy, Izz, Ixy, Ixz, Iyz), dogbot_model.h:92
    inertia: Tuple[float, ...] = (1.6375, 0.7098, 2.0399, -2.9e-4, -1.8e-4, 0.0738)
    # Nominal stance in base frame, per leg (x lateral, y longitudinal), dogbot_model.h:55-81
    # and the APF per-foot goal offsets (main.cpp:1171-1174).
    stance_x: float = 0.186571
    stance_y: float = 0.289186
    stance_z: float = -0.402                   # dogbot_model.h (nominal height ~0.4)
    max_dev: Tuple[float, float, float] = (0.1, 0.15, 0.06)  # dogbot_model.h:80
    # Leg geometry (dogbot.xacro:22-27)
    hip_offset_side: float = 0.088             # body centreline -> hip roll axis (x)
    hip_offset: float = 0.2875                 # body midpoint -> hip (y)
    leg_offset_side: float = 0.18675           # centreline -> upper-leg origin (x)
    upper_leg_len: float = 0.315
    lower_leg_len: float = 0.3
    foot_radius: float = 0.028                 # dogbot.xacro:355-372
    # Actuation limits (dogbot.xacro:242-251)
    tau_max: float = 60.0
    qd_max: float = 6.0
    # Joint limits, 12 joints in reference order (4 roll, then pitch/knee pairs),
    # main.cpp:493-494.
    q_min: Tuple[float, ...] = (-1.75, -1.75, -1.75, -1.75, -1.58, -2.62,
                                -3.15, -0.02, -1.58, -2.62, -3.15, -0.02)
    q_max: Tuple[float, ...] = (1.75, 1.75, 1.75, 1.75, 3.15, 0.02,
                                1.58, 2.62, 3.15, 0.02, 1.58, 2.62)
    # Standing height used by the navigation layer (main.cpp:1183 / 1415)
    com_height: float = 0.4
    f_normal_max: float = 1000.0               # towr parameters.cc:48
    # --- per-link inertial constants of the leg chains ----------------
    # (dogbot.xacro:142 body, :237 hip, :282 upper leg, :325 lower leg,
    # :366 foot).  These feed models/rbd.py's energy-based mass matrix;
    # non-DogBot robots (models/zoo.py) override them so the WHOLE stack
    # — kinematics, rigid-body dynamics, WBC, closed loop — serves any
    # roll-pitch-knee quadruped, not just DogBot.
    body_mass: float = 9.3
    body_inertia: Tuple[float, float, float] = (0.41, 0.091, 0.482)
    hip_mass: float = 0.836
    hip_com_x: float = 0.0074                  # * sigma_x
    hip_inertia: Tuple[float, float, float] = (0.00213, 0.00147, 0.00172)
    upper_mass: float = 1.851
    upper_com: Tuple[float, float, float] = (0.0418, 0.0, -0.0517)
    upper_inertia: Tuple[float, float, float] = (0.0238, 0.0252, 0.0044)
    lower_mass: float = 0.302
    lower_com: Tuple[float, float, float] = (0.0, -0.029, -0.1439)
    lower_inertia: Tuple[float, float, float] = (0.00527, 0.00509, 0.0008)
    foot_mass: float = 0.001
    # foot joint origin y-offset in the lower-leg frame (its z-offset is
    # -lower_leg_len), dogbot.xacro:366
    foot_y_offset: float = -0.035
    # Optional leg-major (roll, pitch, knee)x4 joint-limit override; None
    # reproduces DogBot's side-mirrored xacro limit formulas
    # (models/dogbot.py::joint_limits).
    q_min_leg: Tuple[float, ...] | None = None
    q_max_leg: Tuple[float, ...] | None = None


@dataclasses.dataclass(frozen=True)
class GaitConfig:
    """Gait timing. Provenance: towr quadruped_gait_generator.cc:278-311
    (trot t_step 0.3 / t_stand 0.2), main.cpp:1424/1438 (replan horizons
    0.5 s trot, 1.0 s crawl)."""

    t_step: float = 0.3
    t_stand: float = 0.2
    trot_cycle: float = 0.5                    # one replan horizon (stand+step)
    crawl_cycle: float = 1.0
    # closed-loop gait mode: "trot" alternates pair order per cycle
    # (reference combos C1/C5); "crawl" walks one leg at a time per 1 s
    # cycle (combos C7-C10 — present but never enabled in the reference,
    # main.cpp:489); "adaptive" switches trot <-> crawl in-loop from the
    # robustness EWMA (completing the reference's abandoned crawl path —
    # set MpcConfig.horizon=40 to cover the shared 1 s cycle).  Any name
    # in gait.NAMED_MODE_FLAGS (walk_overlap, trot_fly, pace, bound,
    # pronk, gallop, limp — the rest of the transcribed stride library,
    # quadruped_gait_generator.cc:153-456) runs that stride every cycle
    # with period `fixed_cycle`; the flight-phase strides exercise the
    # MPC's all-swing knots.
    mode: str = "trot"
    fixed_cycle: float = 0.5                   # NAMED_MODE_FLAGS cycle period
    control_dt: float = 0.0025                 # 400 Hz tracking (main.cpp:1107)
    plan_dt: float = 0.025                     # MPC discretization (10 knots / 0.25 s phase)
    # early touch-down handling (main.cpp:2027-2028, 3249-3264): a swing
    # foot that makes MEASURED contact within the last early_td_window
    # seconds of its swing phase freezes its swing ref at the contact
    # point and is treated as stance by the WBC until its scheduled
    # stance begins — per-leg data (jnp.where), never a shape change
    early_td: bool = True
    early_td_window: float = 0.05              # t > dur - 0.05 (main.cpp:2027)


@dataclasses.dataclass(frozen=True)
class ApfConfig:
    """Artificial-potential-field navigation gains.

    Provenance: compute_Kpa (main.cpp:2803-2845), repulsive fields
    (main.cpp:1283-1296), saturations (main.cpp:2756-2800), robustness
    EWMA (main.cpp:1273-1277), thresholds (main.cpp:1320, compute_fr 2745-2754).
    """

    kpa_x_near: float = 0.3        # |e_x| < 0.4 and trotting
    kpa_x_far: float = 0.3
    kpa_x_crawl: float = 0.01      # fake_crawl (slow-down) gain
    kpa_x_far_minexit: float = 0.1
    kpa_y_near: float = 0.4
    kpa_y_far: float = 0.4
    kpa_y_crawl: float = 0.01
    kpa_y_far_minexit: float = 0.2
    e_near_threshold: float = 0.4
    rep_gain: float = 5.0          # f_r = 5 * rob_foot * versor (main.cpp:1292-1295)
    rep_gain_minexit: float = 9.0  # main.cpp:1285-1288
    lat_gain_minexit: float = 2.2
    step_gain: float = 0.5         # p_des = p + 0.5 * f (main.cpp:1396-1407)
    err_sat: float = 2.0           # saturate_x/y (main.cpp:2756-2800)
    step_sat: float = 0.06         # saturate_xstep/ystep (main.cpp:2767-2789)
    ewma_old: float = 0.35         # rob EWMA (main.cpp:1273-1276)
    ewma_new: float = 0.65
    comb_deadband: float = 0.07    # compute_fr (main.cpp:2745-2754)
    crawl_threshold: float = 0.34  # mean robustness -> fake_crawl (main.cpp:1320)
    # hysteresis band for the ADAPTIVE gait switch (our extension — the
    # reference's crawl path is abandoned upstream, main.cpp:489, so it
    # provides no tuning).  The measured index is gait-dependent: crawl on
    # good ground saturates near 0.30, below the 0.34 gain threshold, so
    # the switch needs its own band: enter crawl when rob < enter, return
    # to trot when rob > exit (enter < exit < crawl ceiling).
    crawl_enter_threshold: float = 0.20
    crawl_exit_threshold: float = 0.28
    rob_floor: float = 0.01        # 1/h > 0.01 gate on the margin integral (main.cpp:1539)
    min_exit: bool = False         # #define MIN_EXIT 0 (main.cpp:63)
    rep_field_in_step: bool = False  # #define REP_FIELD 0 (main.cpp:62)
    # per-cycle FOOT step-length limit (metres; 0 = off).  The reference
    # saturates only the CoM step (saturate_x/ystep, main.cpp:2767-2789)
    # because TOWR's EndeffectorRom ties footholds to the jointly-
    # OPTIMIZED base path; our convex MPC keeps the base near the
    # (saturated) APF CoM goal, so a large RoM box (hyq max_dev y=0.25)
    # otherwise lets the attractive field command footholds that outrun
    # the base by the full box each cycle — permanent rear-loading that
    # topples heavy robots.  DogBot's 0.15 box never exposed this; the
    # parity default stays off.
    step_reach: float = 0.0


def apf_fast() -> "ApfConfig":
    """Goal-reaching APF preset (the benchmarks/goal_study.py recalibration).

    The parity default above ships the reference's own gains, and the
    reference's brake design NEVER arrives: with crawl_threshold=0.34 the
    fake-crawl gain cut (K_pa -> 0.01, compute_Kpa main.cpp:2803-2845)
    latches on ANY trot — the robustness EWMA's flat-ground steady state
    sits near the threshold — leaving the robot 0.66-0.94 m short of a
    1.5 m goal after 120 s on every case world (CASES.md goal study).
    This preset keeps every reference formula but recalibrates the
    trigger so the brake fires only on genuine margin loss:

      * crawl_threshold 0.2 (vs 0.34): below the measured flat-ground
        steady state (~0.3-0.5), above the hard-patch dips;
      * rep_field_in_step True (#define REP_FIELD 1, main.cpp:62): the
        repulsive field steers step targets off slippery patches, which
        the foothold optimizer (FootholdConfig.enabled) then refines.

    Measured (CASES.md `fh_fast` rows): reaches the goal on all four
    case worlds with 0 falls where the parity default stalls.
    """
    return ApfConfig(crawl_threshold=0.2, rep_field_in_step=True)


@dataclasses.dataclass(frozen=True)
class WbcConfig:
    """Whole-body tracking QP weights. Provenance: main.cpp:1477-1647."""

    q1: float = 50.0               # CoM wrench tracking weight (main.cpp:1478)
    k_com: float = 3000.0          # main.cpp:1499
    d_com: float = 50.0
    kp_swing: float = 300.0        # main.cpp:1984-1987
    kd_swing: float = 20.0
    # reference uses 1e8 (main.cpp:1751) — infeasible for f32 Cholesky;
    # 1e6 is still an effectively-hard soft constraint
    slack_weight_trot: float = 1e6
    slack_weight_crawl: float = 1e4  # main.cpp:2976
    mu: float = 0.5                # friction coefficient (main.cpp:1511)
    joint_dt: float = 0.025        # joint-limit lookahead (main.cpp:1638)
    # Fold joint VELOCITY limits (RobotConfig.qd_max, xacro vel 6 rad/s,
    # dogbot.xacro:242-251) into the joint-acceleration rows as
    # qdd <= (qd_max - qd)/qd_dt (and the mirrored lower bound) — the
    # same one-step-lookahead construction the reference applies to the
    # POSITION limits (main.cpp:1638-1647).  OPT-IN, default off, for two
    # measured reasons: (a) the reference has no velocity rows (parity);
    # (b) this control design — the reference's — tracks swing splines
    # with a 1e6..1e8 soft weight and kp=300, which commands |qdd| spikes
    # of ~1100 rad/s^2 at phase transitions in a HEALTHY flat-ground trot;
    # hard velocity rows clip those spikes, the soft-tracking gap can no
    # longer close, and the closed loop degrades from qp_converged 0.96 /
    # walking to 0.06-0.25 / falling (even at qd_max = 12, twice the
    # xacro limit).  Use for robots/gaits tuned with gentler tracking.
    qd_limit: bool = False
    qd_dt: float = 0.0025      # one control tick (velocity integrates per tick)
    # Build the QP with the reference's EXACT formulation quirks (used by
    # the parity tests; off by default because both quirks are physically
    # wrong-or-arbitrary choices the reference makes, not features):
    #  (a) the ||x||^2 regularizer is taken over CoM-FRAME accelerations
    #      [udot_com(6); qdd(12)] (eigenR identity over the reference's
    #      decision vector, main.cpp:1478-1483) instead of our
    #      mixed-coordinate udot — the tie-break direction differs;
    #  (b) the trot-swing QP's known term is ZERO (eigenb = 0,
    #      main.cpp:1849-1853): gravity/bias and Jdot*qd are dropped from
    #      the equalities whenever two legs swing outside crawl.
    # Verified: with ref_exact=True our solution matches the reference's
    # QP bit-for-bit at rest states (tests/test_reference_parity_dyn.py).
    ref_exact: bool = False
    # Sub-flag of ref_exact: apply quirk (b), the trot-swing ZERO known
    # term.  The quirk's rows are zero-rhs in the reference's CoM
    # COORDINATES; the equivalent mixed-coordinate rows differ by affine
    # Tdot-scale terms that grow with speed (measured 1-10 N over a
    # dynamic gait cycle), so the full-cycle sequence-parity test
    # disables it and compares the full-bias formulation the reference
    # itself uses in its stance and crawl QPs; the single-state tests
    # pin the quirk itself.
    ref_exact_swing_b0: bool = True


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Batched interior-point solver settings.

    Replaces qpSWIFT's settings struct (reference Auxilary.h:90-103;
    runtime tolerances reltol=abstol=1e-2 at main.cpp:1651-1652).  The
    batched solvers run a FIXED number of Mehrotra predictor-corrector
    iterations with per-lane convergence masks: converged lanes freeze
    (no data-dependent early exit under jit).
    """

    iters: int = 15
    reltol: float = 1e-2
    abstol: float = 1e-2
    frac_to_boundary: float = 0.99   # qpSWIFT.c:588-590
    sigma_pow: float = 3.0           # sigma = min(1, rho)^3 (qpSWIFT.c:567)
    # f32-safe defaults: 1e-8 regs work only in f64 (the f32 WBC Cholesky
    # fails and lanes NaN-quarantine to zero torque); golden f64 tests pin
    # tighter values explicitly
    static_reg: float = 1e-7         # diagonal regularization of H and Schur
    eq_reg: float = 1e-7             # regularization making masked eq rows benign
    refine_steps: int = 1            # iterative refinement of KKT solves
    min_slack: float = 1e-10
    w_clip: float = 1e6              # clamp on the z/s scaling (conditioning)
    # warm starting (ops.riccati.WarmStart): floor applied to a previous
    # solve's z/s so the start point sits strictly in the interior
    warm_floor: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MpcConfig:
    """SRB MPC over the gait horizon (the TOWR+IPOPT replacement)."""

    horizon: int = 20
    dt: float = 0.025              # knot spacing: horizon*dt = 0.5 s trot cycle
    # "auto" resolves from the platform (planner.effective_backend) to
    # "riccati" (lax.scan banded LQR IPM) on the GPU and the CPU;
    # "condensed" (dense QP in stacked forces) kept for cross-validation
    backend: str = "auto"
    # SQP outer iterations (SURVEY.md §7.4: the fallback for towr's
    # NONCONVEX orientation/foothold coupling that IPOPT searched).  1 =
    # single convex solve around the reference trajectory (the round-1
    # behavior).  >1: after each solve, re-linearize the SRB dynamics
    # around the PREDICTED trajectory and fold the exact nonlinear
    # one-step defect (gyroscopic term, attitude coupling, true lever
    # arms) into the affine carrier column, then re-solve — Gauss-Newton
    # on the SRB NLP, every iteration the same fixed-shape QP.  Applies to
    # the riccati backend; the condensed
    # cross-validation backend ignores it.
    # DEFAULT 1, by an earlier closed-loop measurement (flat + case-2
    # worlds, B=32 x 10 cycles): sqp_iters=2 left tracking error, slip
    # fraction, convergence, and fall rate unchanged — at trot speeds and
    # 0.5 s replans the single convex solve around the reference
    # trajectory is already at the closed loop's noise floor (test_planner pins the OPEN-loop dynamic-
    # consistency gain that iteration 2 does deliver).  Turn up for
    # faster/more aggressive gaits.
    sqp_iters: int = 1
    # Thread each replan's solution into the next solve as a warm start
    # (ops.riccati.WarmStart; fewer IPM iterations per replan, PERF.md).
    # The loop leg-permutes it for the mirrored trot pair; crawl cycles
    # reuse it unpermuted.
    warm_start: bool = True
    w_pos: float = 400.0
    w_att: float = 150.0
    w_vel: float = 10.0
    w_omega: float = 2.0
    w_force: float = 1e-5          # force magnitude regularizer
    swing_height: float = 0.1      # apex of swing-foot spline
    mu: float = 0.5
    fz_max: float = 1000.0         # towr parameters.cc:48
    fz_min: float = 0.0
    # Optional base-motion box (towr BaseMotionConstraint,
    # base_motion_constraint.cc:46-55: roll/pitch in +-dev_rad, base z in
    # [z0 - z_below, z0 + z_above]; x/y/yaw unbounded).  OPT-IN like
    # upstream: BaseRom is NOT in the reference's default constraint set
    # (parameters.cc:55-61), so this is off by default.  The box is STATE
    # rows on the Riccati IPM (StageQP.Cx) and hard rows on the condensed
    # prediction matrix — both backends enforce it exactly.
    base_box: bool = False
    base_dev_rad: float = 0.05     # base_motion_constraint.cc:46
    base_z_below: float = 0.02     # base_motion_constraint.cc:55
    base_z_above: float = 0.10
    # Optional base-ACCELERATION bounds — the convex analogue of towr's
    # BaseAcc constraint (parameters.cc:57 "so accelerations don't jump
    # between polynomials"; spline_acc_constraint.cc): per-knot rows
    # |(x_{k+1} - x_k)/dt| <= acc_max on the omega and v state dims.
    # The SRB accelerations are AFFINE IN THE CONTACT FORCES — the rows
    # are (+-B_k[6:12,:]/dt) u_k <= acc_max -+ A_k[6:12,12]/dt — so
    # both backends realize them as per-knot input rows.
    # OPT-IN like base_box (towr defaults BaseAcc ON; here the 400 Hz
    # WBC retracks between knots, so knot-accel smoothing is a shaping
    # tool, not a requirement).
    base_acc: bool = False
    acc_lin_max: float = 8.0       # m/s^2 bound on |dv/dt| per axis
    acc_ang_max: float = 20.0      # rad/s^2 bound on |domega/dt| per axis


@dataclasses.dataclass(frozen=True)
class FootholdConfig:
    """Decision-influenced foothold selection (foothold.py) — the towr
    foothold-optimization role (nlp_formulation.cc:128-158,
    range_of_motion_constraint.cc:45-78) as a branch-free K-candidate
    search over the terrain mu map.  On uniform friction the zero offset
    wins exactly, so flat-ground behavior is unchanged."""

    enabled: bool = True
    grid_n: int = 3            # n x n candidate grid (K = n^2)
    spread: float = 1.0        # grid half-width as a fraction of max_dev xy
    # score weights.  Scales: the mu term spans ~0.65 across the reference
    # worlds (mu_hi 0.8 vs hard patches 0.15); the distance term at the
    # RoM box edge is w_dist * max_dev^2 ~ 20 * 0.0225 = 0.45 < 0.65, so
    # escaping a hard patch is always worth the full box but a mild
    # mu difference is not worth a large step perturbation.
    w_mu: float = 1.0
    w_dist: float = 20.0
    w_slope: float = 1.0       # height-map steepness penalty (1 - n_z)
    mu_hi: float = 0.8         # "good ground" mu (the easy-patch value)


@dataclasses.dataclass(frozen=True)
class ObserverConfig:
    """Momentum-based external-wrench observer (runtime.observer), run
    INSIDE the 400 Hz tracking tick against the WBC's own dynamics
    evaluation.

    The reference implements the observer (main.cpp:843-930) with gain
    0.5 but never starts the thread (main.cpp:2909), so its published
    estimate stays 0 — it provides no tuning.  Gain has units 1/s: the
    estimate tracks a step wrench with time constant 1/gain, so the
    reference's 0.5 (tau = 2 s) could never resolve a sub-second push.
    The live default 10.0 (tau = 0.1 s) detects the force_plugin-style
    pushes (sim.disturbance) within their window, which is the point of
    running it (tests/test_leg_disturbance.py pins the recovery).
    """

    gain: float = 10.0


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Pure-JAX simulation harness (the Gazebo replacement)."""

    dt: float = 0.0025             # control-rate step (400 Hz)
    substeps: int = 4              # physics substeps per control step
    ground_kp: float = 20000.0     # contact spring (scaled from dogbot.xacro:28-29 kp=1e6)
    ground_kd: float = 200.0       # normal damping
    tangent_kp: float = 20000.0    # tangential anchor-spring stiffness
    tangent_kd: float = 100.0      # tangential damping
    mu_default: float = 0.8
    terrain_extent: float = 6.0    # metres, mu-map half-size
    terrain_res: int = 128         # mu-map grid resolution


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    robot: RobotConfig = dataclasses.field(default_factory=RobotConfig)
    gait: GaitConfig = dataclasses.field(default_factory=GaitConfig)
    apf: ApfConfig = dataclasses.field(default_factory=ApfConfig)
    wbc: WbcConfig = dataclasses.field(default_factory=WbcConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    mpc: MpcConfig = dataclasses.field(default_factory=MpcConfig)
    foothold: FootholdConfig = dataclasses.field(
        default_factory=FootholdConfig)
    observer: ObserverConfig = dataclasses.field(
        default_factory=ObserverConfig)
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)

    def replace(self, **kwargs) -> "EngineConfig":
        return dataclasses.replace(self, **kwargs)


def default_config() -> EngineConfig:
    return EngineConfig()
