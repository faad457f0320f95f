"""SRB dynamics + linearization tests against analytic mechanics."""

import jax.numpy as jnp
import numpy as np

from apf_quadruped.config import RobotConfig
from apf_quadruped.models import srb
from apf_quadruped.models.dogbot import nominal_stance

CFG = RobotConfig()


def test_static_equilibrium():
    """mg/4 on each foot at the nominal stance -> zero acceleration."""
    rpy = jnp.zeros(3)
    r = jnp.array([0.0, 0.0, 0.4])
    omega = jnp.zeros(3)
    v = jnp.zeros(3)
    feet = jnp.asarray(nominal_stance(CFG)) + jnp.array([0.0, 0.0, 0.4])
    fz = CFG.mass * srb.GRAVITY / 4.0
    forces = jnp.tile(jnp.array([0.0, 0.0, fz]), (4, 1))
    rpy_d, r_d, om_d, v_d = srb.srb_derivative(CFG, rpy, r, omega, v, feet, forces)
    np.testing.assert_allclose(v_d, 0.0, atol=1e-10)
    np.testing.assert_allclose(om_d, 0.0, atol=1e-9)
    np.testing.assert_allclose(r_d, 0.0, atol=1e-12)
    np.testing.assert_allclose(rpy_d, 0.0, atol=1e-12)


def test_free_fall():
    rpy = jnp.zeros(3)
    r = jnp.array([0.0, 0.0, 1.0])
    feet = jnp.zeros((4, 3))
    forces = jnp.zeros((4, 3))
    _, _, om_d, v_d = srb.srb_derivative(
        CFG, rpy, r, jnp.zeros(3), jnp.zeros(3), feet, forces)
    np.testing.assert_allclose(v_d, [0.0, 0.0, -srb.GRAVITY], atol=1e-12)
    np.testing.assert_allclose(om_d, 0.0, atol=1e-12)


def test_pure_torque_angular_acceleration():
    """A force couple produces omega_dot = I^{-1} tau."""
    rpy = jnp.zeros(3)
    r = jnp.zeros(3)
    # two feet at +-x with +-z forces: torque about y
    feet = jnp.array([[0.5, 0.0, 0.0], [-0.5, 0.0, 0.0],
                      [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    f = 10.0
    forces = jnp.array([[0.0, 0.0, f], [0.0, 0.0, -f],
                        [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    # gravity compensation irrelevant for omega
    _, _, om_d, _ = srb.srb_derivative(
        CFG, rpy, r, jnp.zeros(3), jnp.zeros(3), feet, forces)
    tau = np.cross([0.5, 0, 0], [0, 0, f]) + np.cross([-0.5, 0, 0], [0, 0, -f])
    from apf_quadruped.models.dogbot import inertia_matrix
    expected = np.linalg.solve(inertia_matrix(CFG), tau)
    np.testing.assert_allclose(om_d, expected, atol=1e-9)


def test_linearization_matches_nonlinear_small_step():
    """One discrete step of (A, B) matches the nonlinear integrator to
    O(dt^2) + linearization error at a generic stance state."""
    rng = np.random.default_rng(3)
    dt = 0.01
    rpy = jnp.array([0.0, 0.0, 0.3])        # yaw only: linearization point
    r = jnp.array([0.1, -0.2, 0.42])
    omega = jnp.asarray(rng.normal(size=3) * 0.1)
    v = jnp.asarray(rng.normal(size=3) * 0.1)
    feet = jnp.asarray(nominal_stance(CFG)) + r
    contact = jnp.ones(4)
    forces = jnp.asarray(
        rng.normal(size=(4, 3)) * 5 + np.array([0, 0, CFG.mass * 9.81 / 4]))

    A, B = srb.linearize_discrete(CFG, rpy[2], r, feet, contact, dt)
    x0 = srb.pack_state(rpy, r, omega, v)
    x1_lin = A @ x0 + B @ forces.reshape(-1)

    rpy_d, r_d, om_d, v_d = srb.srb_derivative(CFG, rpy, r, omega, v, feet, forces)
    x1_nl = srb.pack_state(rpy + dt * rpy_d, r + dt * r_d,
                           omega + dt * om_d, v + dt * v_d)
    # errors: gyroscopic term ~ |I w| |w| ~ 1e-2*|w|^2, euler-rate at yaw-only
    np.testing.assert_allclose(x1_lin, x1_nl, atol=2e-4)


def test_linearize_batch_shapes():
    B_ = 5
    yaw = jnp.zeros(B_)
    r = jnp.tile(jnp.array([0.0, 0.0, 0.4]), (B_, 1))
    feet = jnp.tile(jnp.asarray(nominal_stance(CFG)), (B_, 1, 1))
    A, Bm = srb.linearize_discrete(CFG, yaw, r, feet, jnp.ones((B_, 4)), 0.025)
    assert A.shape == (B_, srb.NX, srb.NX)
    assert Bm.shape == (B_, srb.NX, srb.NU)
