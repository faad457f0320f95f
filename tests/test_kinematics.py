import jax
import jax.numpy as jnp
import numpy as np

from apf_quadruped.config import RobotConfig
from apf_quadruped.models import dogbot, kinematics as kin


CFG = RobotConfig()


def test_fk_zero_pose_geometry():
    """Straight legs: feet under the upper-leg origin, z = -(L_up + L_low)."""
    feet = kin.fk(CFG, jnp.zeros(12))
    feet = np.asarray(feet)
    np.testing.assert_allclose(
        feet[:, 0], dogbot.LEG_SIGNS[:, 0] * CFG.leg_offset_side, atol=1e-12)
    np.testing.assert_allclose(
        feet[:, 1], dogbot.LEG_SIGNS[:, 1] * CFG.hip_offset - 0.035, atol=1e-12)
    np.testing.assert_allclose(
        feet[:, 2], -(CFG.upper_leg_len + CFG.lower_leg_len), atol=1e-12)


def test_jacobian_matches_autodiff_fk(rng):
    q = jnp.asarray(rng.uniform(-0.5, 0.5, size=(12,)))
    J = kin.jacobians(CFG, q)                 # (4,3,3)
    Jfull = jax.jacfwd(lambda z: kin.fk(CFG, z))(q)  # (4,3,12)
    for i in range(4):
        np.testing.assert_allclose(J[i], Jfull[i, :, 3 * i:3 * i + 3], atol=1e-10)
        # feet depend only on their own leg's joints
        mask = np.ones(12, bool)
        mask[3 * i:3 * i + 3] = False
        np.testing.assert_allclose(np.asarray(Jfull)[i][:, mask], 0.0, atol=1e-12)


def test_jdot_qd_matches_finite_difference(rng):
    q = jnp.asarray(rng.uniform(-0.5, 0.5, size=(12,)))
    qd = jnp.asarray(rng.normal(size=(12,)))
    eps = 1e-6
    Jp = kin.jacobians(CFG, q + eps * qd)
    Jm = kin.jacobians(CFG, q - eps * qd)
    Jdot_fd = (Jp - Jm) / (2 * eps)           # (4,3,3)
    expected = np.einsum("lij,lj->li", np.asarray(Jdot_fd), np.asarray(qd).reshape(4, 3))
    got = kin.jdot_qd(CFG, q, qd)
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_stance_ik_hits_nominal_stance():
    targets = dogbot.nominal_stance(CFG)
    q = kin.stance_ik(CFG, targets)
    feet = np.asarray(kin.fk(CFG, jnp.asarray(q)))
    np.testing.assert_allclose(feet, targets, atol=1e-6)
    qmin, qmax = dogbot.joint_limits(CFG)
    assert np.all(q >= qmin - 1e-9) and np.all(q <= qmax + 1e-9)


def test_contact_jacobian_structure(rng):
    q = jnp.asarray(rng.uniform(-0.4, 0.4, size=(12,)))
    R = jnp.eye(3)
    com = jnp.asarray([0.1, 0.2, 0.4])
    base = jnp.asarray([0.1, 0.2, 0.45])
    J = np.asarray(kin.contact_jacobian(CFG, q, R, com, base))
    assert J.shape == (12, 18)
    # base-velocity columns are identity blocks
    for i in range(4):
        np.testing.assert_allclose(J[3 * i:3 * i + 3, 0:3], np.eye(3), atol=1e-12)
    # foot velocity from pure joint motion matches leg jacobian
    Jl = np.asarray(kin.jacobians(CFG, q))
    for i in range(4):
        np.testing.assert_allclose(
            J[3 * i:3 * i + 3, 6 + 3 * i:9 + 3 * i], Jl[i], atol=1e-10)


def test_batched_fk_shapes(rng):
    q = jnp.asarray(rng.uniform(-0.3, 0.3, size=(7, 12)))
    feet = kin.fk(CFG, q)
    assert feet.shape == (7, 4, 3)
    single = kin.fk(CFG, q[0])
    np.testing.assert_allclose(feet[0], single, atol=1e-12)
