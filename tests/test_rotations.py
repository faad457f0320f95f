import jax
import jax.numpy as jnp
import numpy as np

from apf_quadruped.ops import rotations as rot


def test_rpy_roundtrip(rng):
    rpy = jnp.asarray(rng.uniform(-1.2, 1.2, size=(32, 3)))
    R = rot.rpy_to_rot(rpy)
    # orthonormal, det 1
    eye = jnp.einsum("...ij,...kj->...ik", R, R)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(np.asarray(R)), 1.0, atol=1e-12)
    back = rot.rot_to_rpy(R)
    np.testing.assert_allclose(back, rpy, atol=1e-10)


def test_skew_cross(rng):
    v = jnp.asarray(rng.normal(size=(5, 3)))
    u = jnp.asarray(rng.normal(size=(5, 3)))
    np.testing.assert_allclose(
        jnp.einsum("...ij,...j->...i", rot.skew(v), u), jnp.cross(v, u), atol=1e-12)


def test_euler_rate_maps_are_inverse(rng):
    rpy = jnp.asarray(rng.uniform(-1.0, 1.0, size=(16, 3)))
    E = rot.euler_rate_to_omega_world(rpy)
    Einv = rot.omega_world_to_euler_rate(rpy)
    eye = jnp.einsum("...ij,...jk->...ik", Einv, E)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-10)


def test_euler_rate_matches_finite_difference(rng):
    """omega = E(rpy) rpy_dot must match d/dt of R via Rdot = skew(omega) R."""
    rpy = jnp.asarray(rng.uniform(-0.8, 0.8, size=(3,)))
    rpyd = jnp.asarray(rng.normal(size=(3,)))
    Rdot = jax.jvp(rot.rpy_to_rot, (rpy,), (rpyd,))[1]
    omega = rot.euler_rate_to_omega_world(rpy) @ rpyd
    R = rot.rpy_to_rot(rpy)
    np.testing.assert_allclose(Rdot, rot.skew(omega) @ R, atol=1e-10)


def test_inertia_tensor():
    I6 = jnp.asarray([1.6375, 0.7098, 2.0399, -2.9e-4, -1.8e-4, 0.0738])
    I = rot.inertia_tensor(I6)
    np.testing.assert_allclose(I, I.T)
    assert np.all(np.linalg.eigvalsh(np.asarray(I)) > 0)
