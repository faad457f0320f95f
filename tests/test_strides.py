"""Schedule-level tests for the full transcribed stride library behind
gait flags 16-22 (reference quadruped_gait_generator.cc:153-456: pronk,
walk_overlap, trot_fly, pace, bound, gallop, limp — strides the
reference ships but never wires to a combo; here each is executable).

The flight-phase strides (trot_fly, pace, bound, pronk, gallop) are the
MPC's all-swing-knot case, which trot never produces — the open-loop
planner test pins that the Riccati IPM handles zero-contact knots.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from apf_quadruped import gait


def _sample_cycle(flag, n=221, cycle=1.0):
    ts = jnp.linspace(0.0, cycle * (1 - 1e-6), n)
    return np.asarray(gait.contact_state(
        jnp.full(ts.shape, flag, dtype=jnp.int32), ts,
        jnp.full(ts.shape, cycle)))


def test_named_mode_flags_consistent():
    """Every named mode's flag resolves to a combo containing the stride
    of the same name, and all new flags are inside the table."""
    for name, flag in gait.NAMED_MODE_FLAGS.items():
        assert flag in gait.GAIT_FLAG_COMBOS
        assert name in gait.GAIT_FLAG_COMBOS[flag]
        assert flag < gait.NUM_GAITS


def test_all_new_flags_start_standing():
    for flag in gait.NAMED_MODE_FLAGS.values():
        c = gait.contact_state(jnp.asarray(flag), jnp.asarray(0.01),
                               jnp.asarray(1.0))
        np.testing.assert_allclose(c, [1, 1, 1, 1])


def test_swing_coverage_per_leg():
    """Every leg swings at least once per cycle in every new stride
    except pronk (all legs leave TOGETHER — covered below)."""
    for name, flag in gait.NAMED_MODE_FLAGS.items():
        c = _sample_cycle(flag)
        swings = (c == 0).any(axis=0)               # (4,) per leg
        assert swings.all(), f"{name}: some leg never swings ({swings})"


def test_pace_lateral_pairs():
    """pace (GetStridePace :347-363): left pair stance (PP) -> flight ->
    right pair stance (bb) -> flight.  Leg order (BR, BL, FL, FR)."""
    total = 0.3 + 0.8                                # stand + pace
    sc = 1.0 / total
    flag = jnp.asarray(18)
    cyc = jnp.asarray(1.0)
    c = gait.contact_state(flag, jnp.asarray((0.3 + 0.15) * sc), cyc)
    np.testing.assert_allclose(c, [0, 1, 1, 0])      # PP: stance {BL, FL}
    c = gait.contact_state(flag, jnp.asarray((0.3 + 0.35) * sc), cyc)
    np.testing.assert_allclose(c, [0, 0, 0, 0])      # flight
    c = gait.contact_state(flag, jnp.asarray((0.3 + 0.55) * sc), cyc)
    np.testing.assert_allclose(c, [1, 0, 0, 1])      # bb: stance {BR, FR}


def test_bound_front_back_pairs():
    """bound (GetStrideBound :380-396): front stance (BI) -> flight ->
    back stance (IB) -> flight."""
    total = 0.3 + 0.8
    sc = 1.0 / total
    flag = jnp.asarray(19)
    cyc = jnp.asarray(1.0)
    c = gait.contact_state(flag, jnp.asarray((0.3 + 0.15) * sc), cyc)
    np.testing.assert_allclose(c, [0, 0, 1, 1])      # BI: stance {FL, FR}
    c = gait.contact_state(flag, jnp.asarray((0.3 + 0.55) * sc), cyc)
    np.testing.assert_allclose(c, [1, 1, 0, 0])      # IB: stance {BR, BL}


def test_pronk_all_or_nothing():
    """pronk (GetStridePronk :153-170): stance counts are only 4 or 0,
    and a genuine flight phase exists."""
    c = _sample_cycle(20)
    counts = c.sum(axis=-1)
    assert set(np.unique(counts)) <= {0.0, 4.0}
    assert (counts == 0).any()


def test_trot_fly_diagonal_pairs_with_flight():
    """trot_fly (GetStrideTrotFly :313-330): diagonal pairs separated by
    flight phases."""
    total = 0.3 + 1.0
    sc = 1.0 / total
    flag = jnp.asarray(17)
    cyc = jnp.asarray(1.0)
    c = gait.contact_state(flag, jnp.asarray((0.3 + 0.2) * sc), cyc)
    np.testing.assert_allclose(c, [0, 1, 0, 1])      # bP: stance {BL, FR}
    c = gait.contact_state(flag, jnp.asarray((0.3 + 0.45) * sc), cyc)
    np.testing.assert_allclose(c, [0, 0, 0, 0])      # flight
    c = gait.contact_state(flag, jnp.asarray((0.3 + 0.7) * sc), cyc)
    np.testing.assert_allclose(c, [1, 0, 1, 0])      # Pb: stance {BR, FL}


def test_gallop_phase_sequence():
    """gallop (GetStrideGallop :413-437): spot-check the 8-phase contact
    sequence at phase midpoints (Bb BI BP bP bB IB PB Pb)."""
    durs = [0.2, 0.3, 0.2, 0.2, 0.2, 0.3, 0.2, 0.2]
    seq = [(1, 0, 1, 1), (0, 0, 1, 1), (0, 1, 1, 1), (0, 1, 0, 1),
           (1, 1, 0, 1), (1, 1, 0, 0), (1, 1, 1, 0), (1, 0, 1, 0)]
    total = 0.3 + sum(durs)
    sc = 1.0 / total
    flag = jnp.asarray(21)
    cyc = jnp.asarray(1.0)
    t = 0.3
    for d, expect in zip(durs, seq):
        c = gait.contact_state(flag, jnp.asarray((t + d / 2) * sc), cyc)
        np.testing.assert_allclose(c, expect)
        t += d


def test_limp_three_stance_min():
    """limp (GetStrideLimp :439-456): the lame leg (BL) swings alone
    (IP phases); at least 2 feet always planted, no flight."""
    c = _sample_cycle(22)
    assert c.sum(axis=-1).min() >= 1.0
    # the IP phase: only BL in stance
    total = 0.3 + 0.8
    sc = 1.0 / total
    c1 = gait.contact_state(jnp.asarray(22),
                            jnp.asarray((0.3 + 0.1 + 0.2 + 0.05) * sc),
                            jnp.asarray(1.0))
    np.testing.assert_allclose(c1, [0, 1, 0, 0])


def test_horizon_contacts_all_swing_knots():
    """pace's horizon schedule contains all-zero knot rows — the MPC's
    zero-contact case."""
    m = np.asarray(gait.horizon_contacts(
        jnp.asarray(18), jnp.asarray(0.0), 0.025, 20, jnp.asarray(0.5)))
    assert (m.sum(axis=-1) == 0).any()
    assert (m[0] == 1).all()                         # stand prefix


def test_planner_all_swing_knots_converges():
    """Open-loop MPC solve on the pace schedule (flight knots present):
    the Riccati IPM must converge, pin flight-knot forces to ~0, and
    predict ballistic vertical motion across the flight window."""
    from apf_quadruped import planner
    from apf_quadruped.config import EngineConfig, MpcConfig
    from apf_quadruped.models import srb

    dtype = jnp.float64
    cfg = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025,
                                     backend="riccati"))
    robot = cfg.robot
    contacts = gait.horizon_contacts(jnp.asarray(18), jnp.asarray(0.0, dtype),
                                     cfg.mpc.dt, 20, jnp.asarray(0.5, dtype),
                                     dtype=dtype)
    feet0 = jnp.asarray(
        np.array([[+0.1866, -0.2892, 0.0], [-0.1866, -0.2892, 0.0],
                  [-0.1866, +0.2892, 0.0], [+0.1866, +0.2892, 0.0]]), dtype)
    feet_sched = jnp.broadcast_to(feet0, (20, 4, 3))
    com0 = jnp.asarray([0.0, 0.0, 0.4], dtype)
    x0 = srb.pack_state(jnp.zeros(3, dtype), com0, jnp.zeros(3, dtype),
                        jnp.zeros(3, dtype))
    x_ref = planner.reference_trajectory(
        cfg, jnp.zeros(3, dtype), com0, com0, jnp.asarray(0.0, dtype),
        jnp.asarray(0.5, dtype))
    plan = planner.plan(cfg, x0, planner.MpcRefs(
        contacts=contacts, feet_w=feet_sched, x_ref=x_ref,
        yaw_ref=jnp.asarray(0.0, dtype)))
    assert bool(plan.sol.converged)
    forces = np.asarray(plan.forces)                 # (20, 4, 3)
    cn = np.asarray(contacts)
    flight = cn.sum(axis=-1) == 0
    assert flight.any()
    # flight knots carry (regularized-to-)zero forces
    assert np.abs(forces[flight]).max() < 1e-6
    # vertical dynamics across a flight knot are ballistic: dv_z = -g dt
    states = np.asarray(plan.states)                 # (20, NX)
    k = int(np.argmax(flight))                       # first flight knot
    dvz = states[k, 11] - (states[k - 1, 11] if k > 0 else 0.0)
    np.testing.assert_allclose(dvz, -9.81 * cfg.mpc.dt, rtol=1e-6)


@pytest.mark.slow
def test_pace_closed_loop_smoke():
    """Closed-loop smoke of a flight-phase gait: 2 pace cycles on flat
    ground survive (finite states, no fall) — the full stack (planner
    all-swing knots, WBC zero-stance ticks, ballistic physics, early
    touch-down) under a gait with genuine flight windows."""
    from apf_quadruped.config import (EngineConfig, GaitConfig,
                                          MpcConfig, SimConfig,
                                          SolverConfig)
    from apf_quadruped.runtime import loop
    from apf_quadruped.sim import disturbance, terrain

    dtype = jnp.float32
    cfg = EngineConfig(
        gait=GaitConfig(mode="pace", fixed_cycle=0.5),
        mpc=MpcConfig(horizon=20, dt=0.025),
        sim=SimConfig(terrain_res=32),
        solver=SolverConfig(iters=12))
    st = loop.init(cfg, dtype=dtype)
    terr = terrain.flat(cfg.sim, dtype=dtype)
    st2, m = loop.run(cfg, st, terr, jnp.asarray([0.0, 0.5], dtype),
                      disturbance.empty(dtype), n_cycles=2)
    assert np.isfinite(np.asarray(st2.sim.q)).all()
    assert np.isfinite(np.asarray(m.com)).all()
    # did not fall during either cycle
    assert float(st2.sim.R_wb[2, 2]) > 0.7
    assert float(np.asarray(m.mpc_converged).min()) > 0.5
