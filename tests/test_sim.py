"""Simulation harness tests: contact physics sanity + terrain mu-maps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apf_quadruped.config import EngineConfig
from apf_quadruped.models import rbd
from apf_quadruped.sim import disturbance, physics, terrain

CFG = EngineConfig()
DT = jnp.float64


def gravity_torques(st):
    """Static gravity-compensating torques for the spawn stance (exact
    moment balance, cf. tests/test_rbd.py)."""
    h = rbd.bias_forces(CFG.robot, st.p_base, st.R_wb, st.q, jnp.zeros(18, DT))
    J = rbd.contact_jacobian_mixed(CFG.robot, st.p_base, st.R_wb, st.q)
    feet = np.asarray(rbd.foot_positions_world(CFG.robot, st.p_base, st.R_wb,
                                               st.q))
    com = np.asarray(rbd.com_position(CFG.robot, st.p_base, st.R_wb, st.q))
    A = np.stack([np.ones(4), feet[:, 1] - com[1], feet[:, 0] - com[0]])
    rhs = np.array([rbd.TOTAL_MASS * rbd.GRAVITY, 0.0, 0.0])
    fz = np.linalg.lstsq(A, rhs, rcond=None)[0]
    f = jnp.asarray(np.stack([np.zeros(4), np.zeros(4), fz], -1).reshape(12),
                    DT)
    return (h - J.T @ f)[6:18]


@pytest.mark.slow
def test_standing_with_gravity_compensation():
    """With static torques, the robot must stay up for 0.5 s of sim."""
    st = physics.initial_state(CFG, dtype=DT)
    terr = terrain.flat(CFG.sim, dtype=DT)
    tau = gravity_torques(st)

    @jax.jit
    def roll(st):
        def body(s, _):
            s, info = physics.step(CFG, s, tau, terr)
            return s, (s.p_base[2], info.in_contact)
        return jax.lax.scan(body, st, None, length=200)

    st2, (zs, contacts) = roll(st)
    z0 = float(st.p_base[2])
    assert abs(float(st2.p_base[2]) - z0) < 0.05, f"base z drifted: {zs[-1]}"
    assert np.asarray(contacts)[-1].all(), "feet left the ground"
    # orientation stays upright
    assert float(st2.R_wb[2, 2]) > 0.95


def test_collapse_without_torques():
    """Zero torques: the body must drop (knees buckle)."""
    st = physics.initial_state(CFG, dtype=DT)
    terr = terrain.flat(CFG.sim, dtype=DT)

    @jax.jit
    def roll(st):
        def body(s, _):
            s, _ = physics.step(CFG, s, jnp.zeros(12, DT), terr)
            return s, None
        return jax.lax.scan(body, st, None, length=400)[0]

    st2 = roll(st)
    assert float(st2.p_base[2]) < float(st.p_base[2]) - 0.1


def test_ballistic_flight():
    """Spawned high with no contact: CoM follows projectile motion."""
    st = physics.initial_state(CFG, dtype=DT)
    st = st._replace(p_base=st.p_base + jnp.asarray([0.0, 0.0, 1.0], DT))
    terr = terrain.flat(CFG.sim, dtype=DT)

    @jax.jit
    def roll(st):
        def body(s, _):
            s, _ = physics.step(CFG, s, jnp.zeros(12, DT), terr)
            return s, None
        return jax.lax.scan(body, st, None, length=80)[0]

    st2 = roll(st)
    t = float(st2.t)
    com0 = rbd.com_position(CFG.robot, st.p_base, st.R_wb, st.q)
    com1 = rbd.com_position(CFG.robot, st2.p_base, st2.R_wb, st2.q)
    dz_expected = -0.5 * rbd.GRAVITY * t * t
    np.testing.assert_allclose(float(com1[2] - com0[2]), dz_expected,
                               rtol=0.02)


@pytest.mark.slow
def test_slippery_patch_slips():
    """Gentle lateral push: feet slip on mu=0.05 ice (feet translate under
    the body) but hold on mu=0.8 ground."""
    results = {}
    for mu in (0.05, 0.8):
        st = physics.initial_state(CFG, dtype=DT)
        terr = terrain.flat(CFG.sim, mu=mu, dtype=DT)
        tau = gravity_torques(st)
        push = jnp.asarray([40.0, 0.0, 0.0], DT)
        feet0 = rbd.foot_positions_world(CFG.robot, st.p_base, st.R_wb, st.q)

        # 0.35 s window: long enough for ice to slide, short enough that the
        # uncontrolled (constant-torque) posture has not yet degraded into
        # genuine slip on grippy ground
        @jax.jit
        def roll(st, terr=terr, tau=tau):
            def body(s, _):
                s, info = physics.step(CFG, s, tau, terr, f_dist=push)
                return s, info.slipping
            return jax.lax.scan(body, st, None, length=140)

        st2, slipping = roll(st)
        feet1 = rbd.foot_positions_world(CFG.robot, st2.p_base, st2.R_wb,
                                         st2.q)
        foot_travel = float(jnp.abs(feet1[:, 0] - feet0[:, 0]).max())
        results[mu] = (foot_travel, bool(np.asarray(slipping).any()))
    travel_ice, slip_ice = results[0.05]
    travel_grip, slip_grip = results[0.8]
    assert slip_ice, "no slip detected on ice"
    assert not slip_grip, "Coulomb clamp engaged on grippy ground"
    # posture sag moves feet a little in both cases; ice must slide farther
    assert travel_ice > travel_grip + 0.03, \
        f"ice {travel_ice} vs grip {travel_grip}"


def test_terrain_sampling():
    m = terrain.case_world(CFG.sim, 1, dtype=DT)
    mu_patch = float(terrain.sample_mu(m, jnp.asarray([-0.4, 1.0], DT)))
    mu_clear = float(terrain.sample_mu(m, jnp.asarray([2.0, -2.0], DT)))
    assert mu_patch == 0.2
    assert mu_clear == CFG.sim.mu_default


def test_disturbance_schedule():
    sched = disturbance.impulses([(1.0, 1.3, 50.0, 0.0, 0.0),
                                  (2.0, 2.1, 0.0, -30.0, 0.0)], dtype=DT)
    f = disturbance.eval_at(sched, jnp.asarray(1.1, DT))
    np.testing.assert_allclose(f, [50.0, 0.0, 0.0])
    f = disturbance.eval_at(sched, jnp.asarray(1.5, DT))
    np.testing.assert_allclose(f, [0.0, 0.0, 0.0])
    f = disturbance.eval_at(sched, jnp.asarray(2.05, DT))
    np.testing.assert_allclose(f, [0.0, -30.0, 0.0])


def test_disturbance_sinusoidal():
    # force_plugin case-1 block: x push = 20*sin(t) (force_plugin.cpp:132-139)
    sched = disturbance.sinusoidal((20.0, 0.0, 0.0), omega=1.0, dtype=DT)
    for t in (0.3, 1.1, 2.7):
        f = np.asarray(disturbance.eval_at(sched, jnp.asarray(t, DT)))
        np.testing.assert_allclose(f, [20.0 * np.sin(t), 0.0, 0.0],
                                   rtol=1e-5, atol=1e-6)
    # windowing still applies
    sched = disturbance.sinusoidal((20.0, 0.0, 0.0), omega=1.0,
                                   t0=1.0, t1=2.0, dtype=DT)
    f = np.asarray(disturbance.eval_at(sched, jnp.asarray(0.5, DT)))
    np.testing.assert_allclose(f, [0.0, 0.0, 0.0])
    # constant rows (omega == 0) are unchanged by the modulation path
    mixed = jnp.concatenate([
        disturbance.impulses([(0.0, 1.0, 5.0, 0.0, 0.0)], dtype=DT),
        disturbance.sinusoidal((0.0, 3.0, 0.0), omega=2.0, dtype=DT)])
    f = np.asarray(disturbance.eval_at(mixed, jnp.asarray(0.25, DT)))
    np.testing.assert_allclose(f, [5.0, 3.0 * np.sin(0.5), 0.0],
                               rtol=1e-5, atol=1e-6)
