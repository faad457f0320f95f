"""Whole-body tracking QP (L4) — one mask-parameterized formulation.

The reference inlines FIVE nearly-identical 400 Hz QP formulations (full
stance A/B, trot swing BR+FL / BL+FR, crawl — reference main.cpp:1470-1693,
1716-2053, 2201-2453, 2476-2738, qpproblemcrawl 2915-3266), differing only
in which legs are stance vs swing.  Here there is ONE formulation whose
shapes never change; the stance mask is data:

decision x in R^30 = [udot(18); f(12)]   (mixed-coordinate accelerations +
                                          all four contact forces)
cost (reference main.cpp:1477-1573):
    || W(x) - W_com_des ||^2_Q1 + ||x||^2 + w_sw * || a_sw(x) - a_sw_des ||^2
  where W(x) = base rows of J_c' f (the CoM wrench the forces produce),
  W_com_des = K_com dx + D_com dv + m g + M_bb a_des  (main.cpp:1572),
  and the swing-foot tracking term replaces the reference's 1e8-weighted
  slack variables (main.cpp:1751, 1864-1875) by an equivalent soft cost —
  no variable-layout switching between gait phases.
equalities (masked):
    6   floating-base dynamics  (M udot + h - J_c' f)[0:6] = 0
        (the centroidal rows, main.cpp:1579-1582)
    12  stance no-slip  J_c udot = -Jdot u        [stance rows only]
    12  swing force zero  f_i = 0                 [swing rows only]
inequalities (fixed 68 rows, masked):
    20  friction pyramid (t +- mu n)'f <= 0, -f_z <= 0 per stance foot
        (cfr block, main.cpp:1601-1625)
    24  torque limits  |(M udot + h - J_c' f)[6:18]| <= tau_max
        (main.cpp:1630-1635)
    24  joint acceleration limits from position limits:
        qdd in [2/dt^2 (q_min - q - dt qd), 2/dt^2 (q_max - q - dt qd)]
        (main.cpp:1638-1647)

Outputs torques tau = (M udot + h - J_c' f)[6:18] (main.cpp:1667).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as _np

from .config import EngineConfig
from .models import rbd
from .ops.qpsolve import QPData, QPSolution, solve_qp

NX = 30      # 18 accelerations + 12 forces
NEQ = 30     # 6 dynamics + 12 no-slip + 12 swing-force-zero
NINEQ = 68   # 20 pyramid + 24 torque + 24 joint-accel


class WbcState(NamedTuple):
    """Robot state snapshot feeding one WBC solve (single sample;
    vmap over leading axes for batches)."""

    p_base: jnp.ndarray      # (3,) world base position
    R_wb: jnp.ndarray        # (3,3) world_R_base
    q: jnp.ndarray           # (12,) joint angles (leg-major)
    u: jnp.ndarray           # (18,) mixed generalized velocity
    contact: jnp.ndarray     # (4,) stance mask (1 = stance)
    # () crawl-phase flag: selects the crawl swing-tracking weight
    # (reference 1e4, main.cpp:2976) instead of the trot weight
    # (reference 1e8, main.cpp:1751) — data, not shape, so the in-loop
    # gait switch stays branch-free.  (numpy scalar default so tree ops
    # like stacking/vmapping WbcState pytrees see an array leaf)
    crawl: jnp.ndarray = _np.bool_(False)
    # (4, 3, 3) terrain-aligned friction-cone basis per foot (columns
    # t1, t2, n; terrain.cone_basis) — the pyramid rows are built on it,
    # matching towr's ForceConstraint basis (force_constraint.cc:72-83).
    # Identity = world-z cones (flat ground, the reference's only case).
    cone_rot: jnp.ndarray = _np.ascontiguousarray(
        _np.broadcast_to(_np.eye(3), (4, 3, 3)))


class WbcRefs(NamedTuple):
    """Tracking references at the current tick (from the MPC plan +
    swing splines)."""

    com_pos: jnp.ndarray     # (3,) desired CoM position
    com_vel: jnp.ndarray     # (3,)
    com_acc: jnp.ndarray     # (3,)
    rpy: jnp.ndarray         # (3,) desired base orientation
    omega: jnp.ndarray       # (3,) desired angular velocity (world)
    omega_dot: jnp.ndarray   # (3,)
    swing_pos: jnp.ndarray   # (4,3) desired swing-foot positions (world)
    swing_vel: jnp.ndarray   # (4,3)
    swing_acc: jnp.ndarray   # (4,3)


class WbcOutput(NamedTuple):
    tau: jnp.ndarray         # (12,) joint torques
    udot: jnp.ndarray        # (18,)
    forces: jnp.ndarray      # (4,3)
    sol: QPSolution
    # the tick's dynamics evaluation (M (18,18), bias h (18,), contact
    # Jacobian Jc (12,18)) — exposed so the in-loop momentum observer
    # (runtime.observer.update_from_dyn) reuses it instead of
    # re-evaluating the model like the reference's estimate_loop thread
    M: jnp.ndarray | None = None
    h_bias: jnp.ndarray | None = None
    Jc: jnp.ndarray | None = None


def _build_qp(cfg: EngineConfig, st: WbcState,
              ref: WbcRefs) -> tuple[QPData, tuple]:
    """Build the QP; also returns (M, h, Jc) so solve() maps torques
    without re-evaluating the dynamics (one rbd evaluation per tick —
    this is the 400 Hz hot path)."""
    w = cfg.wbc
    dtype = st.q.dtype
    c4 = st.contact

    M = rbd.mass_matrix(cfg.robot, st.R_wb, st.q)
    h = rbd.bias_forces(cfg.robot, st.p_base, st.R_wb, st.q, st.u)
    Jc = rbd.contact_jacobian_mixed(cfg.robot, st.p_base, st.R_wb, st.q)
    jdu = rbd.contact_bias_mixed(cfg.robot, st.p_base, st.R_wb, st.q,
                                 st.u).reshape(12)
    com = rbd.com_position(cfg.robot, st.p_base, st.R_wb, st.q)
    Jcom = rbd.com_jacobian(cfg.robot, st.R_wb, st.q)
    feet = rbd.foot_positions_world(cfg.robot, st.p_base, st.R_wb, st.q)

    # ---- cost -------------------------------------------------------
    # Force -> wrench ABOUT THE CoM (the reference works in CoM coordinates
    # throughout, main.cpp:795, so its gravity wrench has no moment term;
    # levers here are p_foot - com accordingly).
    from .ops.rotations import skew
    lever = feet - com[None, :]                          # (4, 3)
    Tf = jnp.zeros((6, 12), dtype)
    for i in range(4):
        Tf = Tf.at[0:3, 3 * i:3 * i + 3].set(jnp.eye(3, dtype=dtype))
        Tf = Tf.at[3:6, 3 * i:3 * i + 3].set(skew(lever[i]))
    Ts = jnp.concatenate([jnp.zeros((6, 18), dtype), Tf], axis=1)  # (6,30)

    from .ops.rotations import rot_to_rpy
    rpy_now = rot_to_rpy(st.R_wb)
    dx = jnp.concatenate([ref.com_pos - com, ref.rpy - rpy_now])
    v_com = Jcom @ st.u
    dv = jnp.concatenate([ref.com_vel - v_com, ref.omega - st.u[3:6]])
    a_des = jnp.concatenate([ref.com_acc, ref.omega_dot])
    g6 = jnp.zeros(6, dtype).at[2].set(rbd.GRAVITY)
    I_com = rbd.composite_inertia_com(cfg.robot, st.p_base, st.R_wb, st.q)
    M_c = jnp.zeros((6, 6), dtype)
    m_tot = rbd.total_mass(cfg.robot)
    M_c = M_c.at[0:3, 0:3].set(m_tot * jnp.eye(3, dtype=dtype))
    M_c = M_c.at[3:6, 3:6].set(I_com)
    Wdes = (w.k_com * dx + w.d_com * dv + m_tot * g6
            + M_c @ a_des)                                # main.cpp:1572

    if w.ref_exact:
        # Reference-exact ||x||^2 regularizer: the reference's decision
        # vector holds CoM-FRAME accelerations [udot_com(6); qdd(12)]
        # (main.cpp:1478-1483), so its identity regularizer tie-breaks in
        # a different direction than ours over mixed-coordinate udot.
        # udot_com = d/dt(T nu)[0:6] = Cmap nudot + dCmap nu with the
        # centroidal transform T = [[I, S(x_bc)', Js],[0, I, 0],[0,0,I]]
        # and Js = X Mb^{-1} Mbj (computeTransformation,
        # main.cpp:643-687); dCmap carries the reference's OWN Tdot
        # construction (main.cpp:690-720: dJs = dX Mb^{-1}Mbj
        # - X Mb^{-1} dMb Mb^{-1} Mbj with dMb from the CoM-offset
        # motion).  The affine term dCmap nu enters the unit-weight
        # regularizer as a LINEAR cost term — zero at rest, but a
        # measured ~2 N tangential-force tie-break shift at trot-swing
        # speeds (the full-gait-cycle parity test pins it).
        xbc = com - st.p_base
        X6 = jnp.block([[jnp.eye(3, dtype=dtype), skew(xbc).T],
                        [jnp.zeros((3, 3), dtype), jnp.eye(3, dtype=dtype)]])
        Mb = M[0:6, 0:6]
        Mbj = M[0:6, 6:18]
        MbMj = jnp.linalg.solve(Mb, Mbj)
        Js6 = X6 @ MbMj
        Cmap = jnp.zeros((6, 18), dtype)
        Cmap = Cmap.at[0:3, 0:3].set(jnp.eye(3, dtype=dtype))
        Cmap = Cmap.at[0:3, 3:6].set(skew(xbc).T)
        Cmap = Cmap.at[3:6, 3:6].set(jnp.eye(3, dtype=dtype))
        Cmap = Cmap.at[:, 6:18].set(Js6)
        # dCmap nu: the affine CoM-acceleration offset (Tdot terms)
        xbc_dot = v_com - st.u[0:3]
        m_tot_ = rbd.total_mass(cfg.robot)
        dX6 = jnp.zeros((6, 6), dtype).at[0:3, 3:6].set(skew(xbc_dot).T)
        mdr_hat = skew(m_tot_ * xbc_dot)
        dMb = jnp.zeros((6, 6), dtype)
        dMb = dMb.at[0:3, 3:6].set(mdr_hat.T)
        dMb = dMb.at[3:6, 0:3].set(mdr_hat)
        dJs6 = dX6 @ MbMj - X6 @ jnp.linalg.solve(
            Mb, dMb @ MbMj)                       # main.cpp:702-708
        dCmap = jnp.zeros((6, 18), dtype)
        dCmap = dCmap.at[0:3, 3:6].set(skew(xbc_dot).T)
        dCmap = dCmap.at[:, 6:18].set(dJs6)
        c6 = dCmap @ st.u                         # (6,)
        reg = jnp.zeros((NX, NX), dtype)
        reg = reg.at[0:18, 0:18].set(
            Cmap.T @ Cmap
            + jnp.diag(jnp.concatenate([jnp.zeros(6, dtype),
                                        jnp.ones(12, dtype)])))
        reg = reg.at[18:30, 18:30].set(jnp.eye(12, dtype=dtype))
        reg_lin = jnp.concatenate([Cmap.T @ c6, jnp.zeros(12, dtype)])
    else:
        reg = jnp.eye(NX, dtype=dtype)
        reg_lin = jnp.zeros(NX, dtype)
    P = w.q1 * (Ts.T @ Ts) + reg
    qv = -w.q1 * (Ts.T @ Wdes) + reg_lin

    # swing-foot tracking as soft cost (replaces the 1e8 slack variables):
    # rows J_c udot = a_sw_des - jdu  weighted per swing leg
    a_sw_des = (ref.swing_acc
                + w.kd_swing * (ref.swing_vel
                                - (Jc @ st.u).reshape(4, 3))
                + w.kp_swing * (ref.swing_pos - feet))    # main.cpp:1988
    sw_mask = (1.0 - c4)[:, None].repeat(3, 1).reshape(12)
    A_sw = jnp.concatenate([Jc, jnp.zeros((12, 12), dtype)], axis=1)
    b_sw = a_sw_des.reshape(12) - jdu
    wsw = jnp.where(st.crawl, w.slack_weight_crawl, w.slack_weight_trot)
    P = P + wsw * (A_sw.T @ (sw_mask[:, None] * A_sw))
    qv = qv - wsw * (A_sw.T @ (sw_mask * b_sw))

    # ---- equalities -------------------------------------------------
    A = jnp.zeros((NEQ, NX), dtype)
    b = jnp.zeros(NEQ, dtype)
    # 6 floating-base dynamics rows
    A = A.at[0:6, 0:18].set(M[0:6, :])
    A = A.at[0:6, 18:30].set(-Jc[:, 0:6].T)
    b = b.at[0:6].set(-h[0:6])
    # 12 stance no-slip rows
    A = A.at[6:18, 0:18].set(Jc)
    b = b.at[6:18].set(-jdu)
    if w.ref_exact and w.ref_exact_swing_b0:
        # Reference-exact trot-swing quirk: the swing QP's known term is
        # ZERO (eigenb = 0, main.cpp:1849-1853) — gravity/bias and Jdot qd
        # are silently dropped from the equalities whenever legs swing
        # outside crawl (the full-stance and crawl QPs keep them,
        # main.cpp:1586-1587, 3037-3040).  Data, not shape: a scalar gate.
        trot_swing = jnp.logical_and(jnp.min(c4) < 0.5,
                                     jnp.logical_not(st.crawl))
        b = jnp.where(trot_swing, jnp.zeros_like(b), b)
    # 12 swing force-zero rows
    A = A.at[18:30, 18:30].set(jnp.eye(12, dtype=dtype))
    st_mask = c4[:, None].repeat(3, 1).reshape(12)
    eq_mask = jnp.concatenate([jnp.ones(6, dtype), st_mask, 1.0 - st_mask])

    # ---- inequalities ----------------------------------------------
    G = jnp.zeros((NINEQ, NX), dtype)
    hvec = jnp.zeros(NINEQ, dtype)
    mu = w.mu
    # friction pyramid rows (5 per foot), main.cpp:1601-1625, built on the
    # per-foot terrain basis: a world-z row [c1 c2 c3] generalizes to
    # c1 t1 + c2 t2 + c3 n = [c1 c2 c3] @ C_i' (identity C_i reproduces
    # the reference's flat-ground rows bit-for-bit)
    cfr = jnp.asarray([[1.0, 0.0, -mu],
                       [0.0, 1.0, -mu],
                       [-1.0, 0.0, -mu],
                       [0.0, -1.0, -mu],
                       [0.0, 0.0, -1.0]], dtype)
    cone = st.cone_rot.astype(dtype)                  # (4, 3, 3)
    for i in range(4):
        G = G.at[5 * i:5 * i + 5, 18 + 3 * i:21 + 3 * i].set(
            cfr @ cone[i].T)
    pyr_mask = c4[:, None].repeat(5, 1).reshape(20)
    # torque rows: tau = (M udot + h - Jc' f)[6:18]
    tau_rows_u = M[6:18, :]
    tau_rows_f = -Jc[:, 6:18].T
    G = G.at[20:32, 0:18].set(tau_rows_u)
    G = G.at[20:32, 18:30].set(tau_rows_f)
    hvec = hvec.at[20:32].set(cfg.robot.tau_max - h[6:18])
    G = G.at[32:44, 0:18].set(-tau_rows_u)
    G = G.at[32:44, 18:30].set(-tau_rows_f)
    hvec = hvec.at[32:44].set(cfg.robot.tau_max + h[6:18])
    # joint acceleration limits, main.cpp:1638-1647
    dt2 = 2.0 / (w.joint_dt ** 2)
    from .models.dogbot import joint_limits
    qmin_np, qmax_np = joint_limits(cfg.robot)   # leg-major, from the xacro
    qmin = jnp.asarray(qmin_np, dtype)
    qmax = jnp.asarray(qmax_np, dtype)
    ddqmax = dt2 * (qmax - st.q - w.joint_dt * st.u[6:18])
    ddqmin = dt2 * (qmin - st.q - w.joint_dt * st.u[6:18])
    if w.qd_limit and not w.ref_exact:
        # joint VELOCITY limits (xacro vel 6 rad/s) as acceleration bounds
        # over ONE control tick: qd + qd_dt qdd in [-qd_max, qd_max]
        inv_dt = 1.0 / w.qd_dt
        ddqmax = jnp.minimum(ddqmax,
                             (cfg.robot.qd_max - st.u[6:18]) * inv_dt)
        ddqmin = jnp.maximum(ddqmin,
                             (-cfg.robot.qd_max - st.u[6:18]) * inv_dt)
        # a joint already outside a limit can cross the bounds; keep the
        # row pair feasible (max braking) instead of poisoning the QP
        ddqmax = jnp.maximum(ddqmax, ddqmin)
    G = G.at[44:56, 6:18].set(jnp.eye(12, dtype=dtype))
    hvec = hvec.at[44:56].set(ddqmax)
    G = G.at[56:68, 6:18].set(-jnp.eye(12, dtype=dtype))
    hvec = hvec.at[56:68].set(-ddqmin)
    ineq_mask = jnp.concatenate([pyr_mask, jnp.ones(48, dtype)])

    return (QPData(P=P, q=qv, A=A, b=b, G=G, h=hvec,
                   eq_mask=eq_mask, ineq_mask=ineq_mask), (M, h, Jc, com))


@partial(jax.jit, static_argnames=("cfg",))
def solve(cfg: EngineConfig, st: WbcState, ref: WbcRefs) -> WbcOutput:
    """One WBC tick (single sample — vmap for batches; everything inside
    is shape-static).

    The WHOLE tick runs at HIGHEST matmul precision, not just the IPM:
    a reduced-precision matmul mantissa (bf16: ~3 decimal digits; TF32 on
    the GPU: ~3-4) corrupts the autodiff mass matrix/Jacobians and the
    1e6-weighted swing-cost Grams BEFORE the solver ever sees them — the
    QP data itself is wrong.  F32_HEALTH.md records the closed-loop
    failure this caused and the check that guards it on the card.  (CPU
    tests can't catch this: CPU matmuls are always full-precision.)
    """
    with jax.default_matmul_precision("highest"):
        return _solve_impl(cfg, st, ref)


def _solve_impl(cfg: EngineConfig, st: WbcState, ref: WbcRefs) -> WbcOutput:
    qp, (M, h, Jc, com) = _build_qp(cfg, st, ref)
    sol = solve_qp(qp, cfg.solver)
    udot = sol.x[0:18]
    f = sol.x[18:30]
    r = M @ udot + h - Jc.T @ f
    tau = r[6:18]                                         # main.cpp:1667
    if cfg.wbc.ref_exact:
        # The reference maps torques in CoM coordinates
        # (tau = M_COM(6:,6:) qdd + BiasCOM(6:) - Jstcom(:,6:)' f,
        # main.cpp:2023): tau_com = (Tinv' r)[6:18] = r[6:18]
        # + Tinv[0:6,6:18]' r[0:6].  With the full-bias equalities the
        # base residual r[0:6] is zero and the maps coincide; under the
        # trot-swing b=0 quirk r[0:6] = h[0:6] and they differ by the
        # centroidal coupling pullback below (exact at rest states —
        # Tdot terms excluded).
        from .ops.rotations import skew as _skew
        xbc = com - st.p_base
        xh = _skew(xbc)
        X6 = jnp.block([[jnp.eye(3, dtype=r.dtype), xh.T],
                        [jnp.zeros((3, 3), r.dtype),
                         jnp.eye(3, dtype=r.dtype)]])
        Js6 = X6 @ jnp.linalg.solve(M[0:6, 0:6], M[0:6, 6:18])
        Tinv_bj = jnp.concatenate([xh.T @ Js6[3:6] - Js6[0:3],
                                   -Js6[3:6]], axis=0)    # (6, 12)
        tau = tau + Tinv_bj.T @ r[0:6]
    tau = jnp.clip(tau, -cfg.robot.tau_max, cfg.robot.tau_max)
    return WbcOutput(tau=tau, udot=udot, forces=f.reshape(4, 3), sol=sol,
                     M=M, h_bias=h, Jc=Jc)
