"""Whole-body dynamics tests: structural identities + energy conservation.

The reference trusts iDynTree for these quantities (main.cpp:723-812); here
they are validated against mechanics first principles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apf_quadruped.config import RobotConfig
from apf_quadruped.models import rbd
from apf_quadruped.models.dogbot import nominal_stance
from apf_quadruped.models.kinematics import stance_ik
from apf_quadruped.ops.rotations import rpy_to_rot, skew

CFG = RobotConfig()
RNG = np.random.default_rng(7)


def rand_state(vel_scale=1.0):
    q = jnp.asarray(RNG.uniform(-0.5, 0.5, 12))
    rpy = jnp.asarray(RNG.uniform(-0.3, 0.3, 3))
    R = rpy_to_rot(rpy)
    p = jnp.asarray(RNG.normal(size=3))
    u = jnp.asarray(RNG.normal(size=18) * vel_scale)
    return p, R, q, u


def test_total_mass_matches_towr_model():
    assert abs(rbd.TOTAL_MASS - 21.261) < 0.01


def test_mass_matrix_structure():
    p, R, q, u = rand_state()
    M = np.asarray(rbd.mass_matrix(CFG, R, q))
    np.testing.assert_allclose(M, M.T, atol=1e-10)
    w = np.linalg.eigvalsh(M)
    assert w.min() > 0, f"M not PD: min eig {w.min()}"
    # linear-linear block of the mixed-coords mass matrix = total mass * I
    np.testing.assert_allclose(M[:3, :3], rbd.TOTAL_MASS * np.eye(3),
                               atol=1e-9)


def test_static_gravity_bias():
    """u = 0: h = generalized gravity; its base-linear rows = (0,0,mg)."""
    p, R, q, _ = rand_state()
    h = np.asarray(rbd.bias_forces(CFG, p, R, q, jnp.zeros(18)))
    np.testing.assert_allclose(
        h[:3], [0.0, 0.0, rbd.TOTAL_MASS * rbd.GRAVITY], atol=1e-8)


def test_com_jacobian_vs_momentum():
    """J_com u must equal (linear momentum)/m for any u: cross-check the
    jacfwd path against the explicit velocity recursion."""
    p, R, q, u = rand_state()
    Jc = rbd.com_jacobian(CFG, R, q)
    v_com = np.asarray(Jc @ u)
    v, w = rbd._link_velocities(CFG, p, R, q, u)
    masses, _, _ = rbd._link_constants(CFG, q.dtype)
    v_expected = np.asarray(
        jnp.einsum("b,bi->i", masses, v) / rbd.TOTAL_MASS)
    np.testing.assert_allclose(v_com, v_expected, atol=1e-10)


def test_contact_jacobian_vs_fd():
    """J_c u equals the time derivative of world foot positions."""
    p, R, q, u = rand_state()
    J = rbd.contact_jacobian_mixed(CFG, p, R, q)
    v_feet = np.asarray(J @ u).reshape(4, 3)
    eps = 1e-6
    v_b, om, qd = u[0:3], u[3:6], u[6:18]
    p2 = p + eps * v_b
    R2 = R + eps * skew(om) @ R
    q2 = q + eps * qd
    f1 = np.asarray(rbd.foot_positions_world(CFG, p, R, q))
    f2 = np.asarray(rbd.foot_positions_world(CFG, p2, R2, q2))
    np.testing.assert_allclose(v_feet, (f2 - f1) / eps, atol=1e-5)


def test_contact_bias_vs_fd():
    """Jdot u from jvp equals finite-difference along the flow."""
    p, R, q, u = rand_state()
    a = np.asarray(rbd.contact_bias_mixed(CFG, p, R, q, u)).reshape(12)
    eps = 1e-6
    v_b, om, qd = u[0:3], u[3:6], u[6:18]

    def Ju(pp, RR, qq):
        return np.asarray(
            rbd.contact_jacobian_mixed(CFG, pp, RR, qq) @ u)

    a_fd = (Ju(p + eps * v_b, R + eps * skew(om) @ R, q + eps * qd)
            - Ju(p, R, q)) / eps
    np.testing.assert_allclose(a, a_fd, atol=1e-4)


@pytest.mark.slow
def test_energy_conservation_free_fall():
    """Unactuated, contact-free flight: E = T + V conserved under RK4.

    This exercises M(q), h(q,u) and their mutual consistency (a wrong
    Coriolis term shows up as secular energy drift).
    """
    p, R, q, u = rand_state(vel_scale=0.5)

    def energy(p, R, q, u):
        M = rbd.mass_matrix(CFG, R, q)
        T = 0.5 * u @ M @ u
        V = rbd.TOTAL_MASS * rbd.GRAVITY * rbd.com_position(CFG, p, R, q)[2]
        return float(T + V)

    def deriv(state):
        p, R, q, u = state
        M = rbd.mass_matrix(CFG, R, q)
        h = rbd.bias_forces(CFG, p, R, q, u)
        du = jnp.linalg.solve(M, -h)
        return (u[0:3], skew(u[3:6]) @ R, u[6:18], du)

    dt = 1e-3

    @jax.jit
    def rk4(state):
        k1 = deriv(state)
        add = lambda s, k, a: tuple(si + a * ki for si, ki in zip(s, k))
        k2 = deriv(add(state, k1, dt / 2))
        k3 = deriv(add(state, k2, dt / 2))
        k4 = deriv(add(state, k3, dt))
        return tuple(
            si + dt / 6 * (a + 2 * b + 2 * c + d)
            for si, a, b, c, d in zip(state, k1, k2, k3, k4))

    state = (p, R, q, u)
    e0 = energy(*state)
    for _ in range(50):
        state = rk4(state)
    e1 = energy(*state)
    assert abs(e1 - e0) < 1e-4 * max(1.0, abs(e0)), f"dE = {e1 - e0}"


def test_static_stance_torques_reasonable():
    """Standing with fz = mg/4 per foot: required joint torques are within
    the 60 Nm actuator limit (dogbot.xacro:242-251) and nontrivial."""
    feet_b = nominal_stance(CFG)
    q = jnp.asarray(stance_ik(CFG, feet_b))
    p = jnp.array([0.0, 0.0, 0.42])
    R = jnp.eye(3)
    h = rbd.bias_forces(CFG, p, R, q, jnp.zeros(18))
    J = rbd.contact_jacobian_mixed(CFG, p, R, q)
    # distribute vertical forces so force AND moment balance about the base
    # (equal mg/4 split leaves a residual moment: the legs shift the CoM)
    feet_w = np.asarray(rbd.foot_positions_world(CFG, p, R, q))
    com = np.asarray(rbd.com_position(CFG, p, R, q))
    A = np.stack([np.ones(4), feet_w[:, 1] - com[1], feet_w[:, 0] - com[0]])
    rhs = np.array([rbd.TOTAL_MASS * rbd.GRAVITY, 0.0, 0.0])
    fz = np.linalg.lstsq(A, rhs, rcond=None)[0]
    f = jnp.asarray(np.stack([np.zeros(4), np.zeros(4), fz], -1).reshape(12))
    resid = np.asarray(h - J.T @ f)
    # floating-base rows must balance exactly (no actuation there)
    np.testing.assert_allclose(resid[:6], 0.0, atol=1e-6)
    tau = resid[6:]
    assert np.abs(tau).max() < 60.0
    assert np.abs(tau).max() > 1.0


def test_batched_via_vmap():
    ps, Rs, qs, us = [], [], [], []
    for _ in range(4):
        p, R, q, u = rand_state()
        ps.append(p); Rs.append(R); qs.append(q); us.append(u)
    stack = lambda xs: jnp.stack(xs)
    M = jax.vmap(lambda R, q: rbd.mass_matrix(CFG, R, q))(stack(Rs), stack(qs))
    assert M.shape == (4, 18, 18)
    h = jax.vmap(lambda p, R, q, u: rbd.bias_forces(CFG, p, R, q, u))(
        stack(ps), stack(Rs), stack(qs), stack(us))
    assert h.shape == (4, 18)
    for i in range(4):
        np.testing.assert_allclose(
            M[i], rbd.mass_matrix(CFG, Rs[i], qs[i]), atol=1e-10)
