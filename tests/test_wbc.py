"""Whole-body tracking QP tests.

Checks the physics the reference formulation encodes (main.cpp:1470-1693):
standing equilibrium, friction-cone feasibility, torque limits, PD recovery
response, and the swing-tracking path of the unified mask formulation.
"""

import jax
import jax.numpy as jnp
import numpy as np

from apf_quadruped import wbc
from apf_quadruped.config import EngineConfig, SolverConfig, WbcConfig
from apf_quadruped.models import rbd
from apf_quadruped.models.dogbot import nominal_stance
from apf_quadruped.models.kinematics import stance_ik

CFG = EngineConfig(
    solver=SolverConfig(iters=25, reltol=1e-6, abstol=1e-4),
    wbc=WbcConfig(slack_weight_trot=1e6),
)
ROBOT = CFG.robot


def standing_state(dtype=jnp.float64):
    q = jnp.asarray(stance_ik(ROBOT, nominal_stance(ROBOT)), dtype)
    p = jnp.asarray([0.0, 0.0, 0.42], dtype)
    R = jnp.eye(3, dtype=dtype)
    u = jnp.zeros(18, dtype)
    return wbc.WbcState(p_base=p, R_wb=R, q=q, u=u,
                        contact=jnp.ones(4, dtype))


def hold_refs(st, dtype=jnp.float64):
    com = rbd.com_position(ROBOT, st.p_base, st.R_wb, st.q)
    feet = rbd.foot_positions_world(ROBOT, st.p_base, st.R_wb, st.q)
    z = jnp.zeros(3, dtype)
    return wbc.WbcRefs(com_pos=com, com_vel=z, com_acc=z,
                       rpy=z, omega=z, omega_dot=z,
                       swing_pos=feet, swing_vel=jnp.zeros((4, 3), dtype),
                       swing_acc=jnp.zeros((4, 3), dtype))


def test_standing_equilibrium():
    """At the reference: udot ~ 0, forces sum to weight, torques modest."""
    st = standing_state()
    out = wbc.solve(CFG, st, hold_refs(st))
    assert bool(out.sol.converged)
    f = np.asarray(out.forces)
    np.testing.assert_allclose(f[:, 2].sum(), rbd.TOTAL_MASS * rbd.GRAVITY,
                               rtol=0.02)
    assert np.abs(np.asarray(out.udot)).max() < 0.5
    assert np.abs(np.asarray(out.tau)).max() < 60.0
    # friction cone (mu = 0.5)
    assert (np.abs(f[:, 0:2]) <= 0.5 * f[:, 2:3] + 1e-6).all()


def test_pd_recovery_pushes_com():
    """CoM displaced backward: the QP must accelerate it forward.
    (0.01 m -> K_com demand of 30 N, well inside the friction cone.)"""
    st = standing_state()
    ref = hold_refs(st)
    ref = ref._replace(com_pos=ref.com_pos + jnp.asarray([0.01, 0.0, 0.0]))
    out = wbc.solve(CFG, st, ref)
    assert bool(out.sol.converged)
    # com acceleration = (d/dt) Jcom u -> approximately udot[0:2] here
    assert float(out.udot[0]) > 0.3, f"udot_x = {float(out.udot[0])}"
    f = np.asarray(out.forces)
    assert f[:, 0].sum() > 20.0          # net forward push


def test_cone_saturation_when_demand_infeasible():
    """A 150 N lateral demand exceeds mu * m * g = 104 N: forces must pin
    to the cone edge (fx = mu fz), never exceed it, and stay finite."""
    st = standing_state()
    ref = hold_refs(st)
    ref = ref._replace(com_pos=ref.com_pos + jnp.asarray([0.05, 0.0, 0.0]))
    out = wbc.solve(CFG, st, ref)
    f = np.asarray(out.forces)
    assert np.isfinite(f).all()
    assert (f[:, 0] <= 0.5 * f[:, 2] + 1e-5).all()
    loaded = f[:, 2] > 50.0
    # the w_clip conditioning guard caps how exactly the boundary is
    # attained on an infeasible-demand problem: within ~10% of the edge
    np.testing.assert_allclose(f[loaded, 0], 0.5 * f[loaded, 2], rtol=0.1)


def test_torque_limits_respected():
    """Huge tracking error: torques must saturate at +-60, not exceed."""
    st = standing_state()
    ref = hold_refs(st)
    ref = ref._replace(com_pos=ref.com_pos + jnp.asarray([1.0, 1.0, 0.5]))
    out = wbc.solve(CFG, st, ref)
    tau = np.asarray(out.tau)
    assert np.abs(tau).max() <= 60.0 + 1e-6


def test_swing_tracking():
    """Trot phase (BR+FL swing): swing feet get commanded acceleration
    toward their targets; stance feet stay no-slip."""
    st = standing_state()._replace(contact=jnp.asarray([0.0, 1.0, 1.0, 0.0]))
    ref = hold_refs(st)
    feet = rbd.foot_positions_world(ROBOT, st.p_base, st.R_wb, st.q)
    tgt = feet + jnp.asarray([[0.0, 0.05, 0.05]]) * jnp.asarray(
        [[1.0], [0.0], [0.0], [1.0]])
    ref = ref._replace(swing_pos=tgt)
    out = wbc.solve(CFG, st, ref)
    assert bool(out.sol.converged)
    f = np.asarray(out.forces)
    # swing feet (BR=0, FR=3) carry no force
    np.testing.assert_allclose(f[0], 0.0, atol=1e-6)
    np.testing.assert_allclose(f[3], 0.0, atol=1e-6)
    # stance carries the weight
    assert f[1, 2] + f[2, 2] > 0.8 * rbd.TOTAL_MASS * rbd.GRAVITY
    # swing feet accelerate upward/forward toward targets
    Jc = rbd.contact_jacobian_mixed(ROBOT, st.p_base, st.R_wb, st.q)
    jdu = rbd.contact_bias_mixed(ROBOT, st.p_base, st.R_wb, st.q,
                                 st.u).reshape(12)
    a_feet = (np.asarray(Jc) @ np.asarray(out.udot) + jdu).reshape(4, 3)
    assert a_feet[0, 2] > 1.0
    assert a_feet[3, 2] > 1.0


def test_joint_velocity_limit_rows():
    """A joint already at the velocity limit (qd_max = 6 rad/s,
    dogbot.xacro:242-251) may not be commanded to accelerate further:
    qdd <= (qd_max - qd)/qd_dt (WbcConfig.qd_limit folding, opt-in).  A
    huge swing-tracking demand drives the swing knees hard; at qd = qd_max
    the admissible qdd upper bound is exactly 0."""
    import dataclasses
    cfg = dataclasses.replace(
        CFG, wbc=dataclasses.replace(CFG.wbc, qd_limit=True))
    st = standing_state()._replace(contact=jnp.asarray([0.0, 1.0, 1.0, 0.0]))
    # swing legs BR (joints 0-2) and FR (joints 9-11, leg-major) already
    # at the velocity limit; stance legs at rest so no-slip stays feasible
    u = jnp.zeros(18).at[6:18].set(
        jnp.asarray([0.0, ROBOT.qd_max, ROBOT.qd_max, 0.0, 0.0, 0.0,
                     0.0, 0.0, 0.0, 0.0, ROBOT.qd_max, ROBOT.qd_max]))
    st = st._replace(u=u)
    ref = hold_refs(st)
    feet = rbd.foot_positions_world(ROBOT, st.p_base, st.R_wb, st.q)
    tgt = feet + jnp.asarray([[0.0, 0.1, 0.1]]) * jnp.asarray(
        [[1.0], [0.0], [0.0], [1.0]])
    ref = ref._replace(swing_pos=tgt,
                       swing_vel=jnp.zeros((4, 3)))
    out = wbc.solve(cfg, st, ref)
    # the 1e6-weighted soft swing cost against a hard ZERO qdd bound keeps
    # the ABSOLUTE duality gap large (weight x violation^2), so the
    # abstol-based converged flag cannot fire; the primal residual is the
    # meaningful health signal here
    assert float(out.sol.res_norm) < 1e-2
    qdd = np.asarray(out.udot)[6:18]
    dt = cfg.wbc.qd_dt
    qd = np.asarray(u[6:18])
    ub = (ROBOT.qd_max - qd) / dt
    assert (qdd <= ub + 1e-6).all(), f"qdd={qdd}, ub={ub}"
    # the limited joints sit AT (or below) the zero bound
    lim = qd >= ROBOT.qd_max - 1e-9
    assert (qdd[lim] <= 1e-6).all()


def test_batched_vmap():
    st = standing_state()
    ref = hold_refs(st)
    B = 4
    sts = jax.tree.map(lambda x: jnp.tile(x, (B,) + (1,) * x.ndim), st)
    refs = jax.tree.map(lambda x: jnp.tile(x, (B,) + (1,) * x.ndim), ref)
    out = jax.vmap(lambda s, r: wbc.solve(CFG, s, r))(sts, refs)
    assert out.tau.shape == (B, 12)
    assert bool(np.all(out.sol.converged))
