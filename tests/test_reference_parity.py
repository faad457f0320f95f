"""Control parity vs the reference formulation (BASELINE: control error
< 1e-3 relative over the same problem).

The reference solves its whole-body QP in CoM coordinates with
x = [com_acc(6); qdd(12); f(12)] (main.cpp:1470-1693).  This test
reconstructs THAT exact QP — same cost (||J_stcom' Sigma x - W_des||^2_Q1
+ ||x||^2, Q1 = 50 I), same equalities (centroidal dynamics + no-slip),
same inequalities (pyramid mu=0.5, torque +-60, joint-accel bounds,
dt=0.025) — from our dynamics quantities transformed to CoM coordinates,
solves it with our IPM, and compares the physical outputs (contact forces,
joint torques) against our mixed-coordinate wbc.solve at the same state.

At a static state the CoM-coordinate transform is algebraically exact
(the Tdot terms of main.cpp:643-720 vanish at u = 0), so agreement here
is agreement with the reference controller's math, not a tautology: the
two QPs live in different coordinates with different decision variables.
"""

import jax.numpy as jnp
import numpy as np

from apf_quadruped import wbc
from apf_quadruped.config import EngineConfig, SolverConfig, WbcConfig
from apf_quadruped.models import rbd
from apf_quadruped.models.dogbot import joint_limits, nominal_stance
from apf_quadruped.models.kinematics import stance_ik
from apf_quadruped.ops.qpsolve import QPData, solve_qp

CFG = EngineConfig(
    solver=SolverConfig(iters=30, reltol=1e-8, abstol=1e-6,
                        static_reg=1e-9, eq_reg=1e-9, w_clip=1e9),
    wbc=WbcConfig(slack_weight_trot=1e6))


def build_reference_qp(st):
    """The reference full-stance QP (main.cpp:1470-1647) from our model."""
    robot = CFG.robot
    M = rbd.mass_matrix(robot, st.R_wb, st.q)
    h = rbd.bias_forces(robot, st.p_base, st.R_wb, st.q, st.u)
    Jc = rbd.contact_jacobian_mixed(robot, st.p_base, st.R_wb, st.q)
    Jcom = rbd.com_jacobian(robot, st.R_wb, st.q)

    # CoM-coordinate velocity transform u_com = T u  (computeTransformation
    # role, main.cpp:643-720): rows = [v_com; omega; qd]
    T = jnp.zeros((18, 18))
    T = T.at[0:3, :].set(Jcom)
    T = T.at[3:6, 3:6].set(jnp.eye(3))
    T = T.at[6:18, 6:18].set(jnp.eye(12))
    Tinv = jnp.linalg.inv(T)
    M_com = Tinv.T @ M @ Tinv                 # main.cpp:795
    h_com = Tinv.T @ h                        # exact at u = 0
    J_com = Jc @ Tinv                         # 12x18 linear contact Jacobian

    Jstcom = J_com[:, 0:6]                    # (12, 6)
    Jstj = J_com[:, 6:18]                     # (12, 12)

    mg = rbd.TOTAL_MASS * rbd.GRAVITY
    Wdes = jnp.zeros(6).at[2].set(mg)         # static: K dx = D dv = 0

    # cost (main.cpp:1477-1604): T_s = Jstcom' Sigma_st maps x -> CoM wrench
    Ts = jnp.zeros((6, 30))
    Ts = Ts.at[:, 18:30].set(Jstcom.T)
    P = 50.0 * (Ts.T @ Ts) + jnp.eye(30)
    qv = -50.0 * (Ts.T @ Wdes)

    # equalities (main.cpp:1579-1588)
    A = jnp.zeros((18, 30))
    b = jnp.zeros(18)
    A = A.at[0:6, 0:6].set(M_com[0:6, 0:6])
    A = A.at[0:6, 18:30].set(-Jstcom.T)
    b = b.at[0:6].set(-h_com[0:6])
    A = A.at[6:18, 0:6].set(Jstcom)
    A = A.at[6:18, 6:18].set(Jstj)
    # b[6:18] = -Jdot qd = 0 at rest

    # inequalities (main.cpp:1591-1647): 20 pyramid + 24 torque + 24 qdd
    G = jnp.zeros((68, 30))
    hv = jnp.zeros(68)
    mu = 0.5
    cfr = jnp.asarray([[1.0, 0.0, -mu],
                       [0.0, 1.0, -mu],
                       [-1.0, 0.0, -mu],
                       [0.0, -1.0, -mu],
                       [0.0, 0.0, -1.0]])
    for i in range(4):
        G = G.at[5 * i:5 * i + 5, 18 + 3 * i:21 + 3 * i].set(cfr)
    Mj = M_com[6:18, 6:18]
    G = G.at[20:32, 6:18].set(Mj)
    G = G.at[20:32, 18:30].set(-Jstj.T)
    hv = hv.at[20:32].set(60.0 - h_com[6:18])
    G = G.at[32:44, 6:18].set(-Mj)
    G = G.at[32:44, 18:30].set(Jstj.T)
    hv = hv.at[32:44].set(60.0 + h_com[6:18])
    qmin, qmax = joint_limits(CFG.robot)
    dt2 = 2.0 / 0.025 ** 2
    G = G.at[44:56, 6:18].set(jnp.eye(12))
    hv = hv.at[44:56].set(dt2 * (jnp.asarray(qmax) - st.q))
    G = G.at[56:68, 6:18].set(-jnp.eye(12))
    hv = hv.at[56:68].set(-dt2 * (jnp.asarray(qmin) - st.q))

    qp = QPData(P=P, q=qv, A=A, b=b, G=G, h=hv,
                eq_mask=jnp.ones(18), ineq_mask=jnp.ones(68))
    return qp, (M_com, h_com, Jstj)


def test_reference_full_stance_qp_parity():
    q = jnp.asarray(stance_ik(CFG.robot, nominal_stance(CFG.robot)))
    st = wbc.WbcState(p_base=jnp.asarray([0.0, 0.0, 0.42]),
                      R_wb=jnp.eye(3), q=q, u=jnp.zeros(18),
                      contact=jnp.ones(4))

    # reference-formulation solve
    qp, (M_com, h_com, Jstj) = build_reference_qp(st)
    sol = solve_qp(qp, CFG.solver)
    assert bool(sol.converged), f"gap={sol.gap}, res={sol.res_norm}"
    f_ref = np.asarray(sol.x[18:30]).reshape(4, 3)
    qdd_ref = sol.x[6:18]
    tau_ref = np.asarray(M_com[6:18, 6:18] @ qdd_ref + h_com[6:18]
                         - Jstj.T @ sol.x[18:30])        # main.cpp:1667

    # our mixed-coordinate WBC at the same state/references
    com = rbd.com_position(CFG.robot, st.p_base, st.R_wb, st.q)
    feet = rbd.foot_positions_world(CFG.robot, st.p_base, st.R_wb, st.q)
    z3 = jnp.zeros(3)
    ref = wbc.WbcRefs(com_pos=com, com_vel=z3, com_acc=z3, rpy=z3,
                      omega=z3, omega_dot=z3, swing_pos=feet,
                      swing_vel=jnp.zeros((4, 3)),
                      swing_acc=jnp.zeros((4, 3)))
    out = wbc.solve(CFG, st, ref)
    assert bool(out.sol.converged)
    f_ours = np.asarray(out.forces)
    tau_ours = np.asarray(out.tau)

    # physical outputs agree: < 1e-3 relative to the weight / torque scale
    mg = rbd.TOTAL_MASS * rbd.GRAVITY
    df = np.abs(f_ours - f_ref).max()
    assert df < 1e-3 * mg, f"force mismatch {df} N (f_ref {f_ref[:, 2]})"
    dtau = np.abs(tau_ours - tau_ref).max()
    assert dtau < 0.1, f"torque mismatch {dtau} Nm"
