import jax.numpy as jnp
import numpy as np

from apf_quadruped import gait


def test_table_shapes():
    t = gait.build_gait_table()
    assert t.durations.shape == (gait.NUM_GAITS, gait.MAX_PHASES)
    assert t.contacts.shape == (gait.NUM_GAITS, gait.MAX_PHASES, 4)
    np.testing.assert_allclose(t.durations.sum(axis=1), 1.0, atol=1e-12)


def test_trot_phases_reference_timing():
    """gait_flag 1 = stand + trot (bP BB Pb BB), scaled to a 0.5 s cycle.

    Unscaled total 1.3 s -> stand prefix 0.3/1.3*0.5 = 0.11538 s, then the
    (BR, FL) pair swings (towr C1; reference ctrl_loop phase B swings BR+FL).
    """
    flag = jnp.asarray(1)
    cyc = jnp.asarray(0.5)
    scale = 0.5 / 1.3
    # During the stand prefix: all stance.
    c = gait.contact_state(flag, jnp.asarray(0.3 * scale * 0.5), cyc)
    np.testing.assert_allclose(c, [1, 1, 1, 1])
    # First swing phase: BR and FL in the air (bP: stance {FR, BL}).
    t_mid = (0.3 + 0.15) * scale
    c = gait.contact_state(flag, jnp.asarray(t_mid), cyc)
    np.testing.assert_allclose(c, [0, 1, 0, 1])
    # Stand between steps.
    t_mid = (0.3 + 0.3 + 0.1) * scale
    c = gait.contact_state(flag, jnp.asarray(t_mid), cyc)
    np.testing.assert_allclose(c, [1, 1, 1, 1])
    # Second swing phase: BL and FR in the air (Pb: stance {BR, FL}).
    t_mid = (0.3 + 0.5 + 0.15) * scale
    c = gait.contact_state(flag, jnp.asarray(t_mid), cyc)
    np.testing.assert_allclose(c, [1, 0, 1, 0])
    # Past the cycle: stand.
    c = gait.contact_state(flag, jnp.asarray(0.7), cyc)
    np.testing.assert_allclose(c, [1, 1, 1, 1])


def test_crawl_single_swing_legs():
    """Crawl flags 4..7 always have >= 3 feet in stance."""
    cyc = jnp.asarray(1.0)
    ts = jnp.linspace(0.0, 0.999, 97)
    for flag in (4, 5, 6, 7):
        c = gait.contact_state(jnp.full(ts.shape, flag, dtype=jnp.int32), ts,
                               jnp.full(ts.shape, 1.0))
        assert np.all(np.asarray(c).sum(axis=-1) >= 3)


def test_phase_info_swing_window():
    flag = jnp.asarray(1)
    cyc = jnp.asarray(0.5)
    scale = 0.5 / 1.3
    t = jnp.asarray((0.3 + 0.1) * scale)  # inside first swing (BR)
    info = gait.phase_info(flag, t, cyc)
    np.testing.assert_allclose(info["contact"], [0, 1, 0, 1])
    # BR swing window = [0.3, 0.6) * scale
    np.testing.assert_allclose(info["t_start"][0], 0.3 * scale, atol=1e-6)
    np.testing.assert_allclose(info["t_end"][0], 0.6 * scale, atol=1e-6)
    # BL is mid-stance: its merged stance run spans [0, 0.8) * scale
    np.testing.assert_allclose(info["t_start"][1], 0.0, atol=1e-6)
    np.testing.assert_allclose(info["t_end"][1], 0.8 * scale, atol=1e-6)


def test_horizon_contacts_shape():
    flags = jnp.asarray([1, 4])
    t0 = jnp.zeros(2)
    cyc = jnp.asarray([0.5, 1.0])
    m = gait.horizon_contacts(flags, t0, 0.025, 20, cyc)
    assert m.shape == (2, 20, 4)
    # first knots are stand prefix
    np.testing.assert_allclose(m[:, 0, :], 1.0)


def test_biped_walk_alternates_feet():
    """Flag 8 (biped C0): stand prefix then swing L (stance b = slot 0)
    then swing R (stance P = slot 1); front slots never touch."""
    flag = jnp.asarray(8)
    cyc = jnp.asarray(1.0)
    total = 0.2 + 0.3 + 0.05 + 0.3 + 0.05   # biped_stand + biped_walk
    sc = 1.0 / total
    c = gait.contact_state(flag, jnp.asarray(0.1 * sc), cyc)
    np.testing.assert_allclose(c, [1, 1, 0, 0])          # stand
    c = gait.contact_state(flag, jnp.asarray((0.2 + 0.15) * sc), cyc)
    np.testing.assert_allclose(c, [1, 0, 0, 0])          # swing left
    c = gait.contact_state(flag, jnp.asarray((0.2 + 0.35 + 0.15) * sc), cyc)
    np.testing.assert_allclose(c, [0, 1, 0, 0])          # swing right


def test_monoped_hop_duty_cycle():
    """Flag 13 (monoped hop): only slot 0 ever in stance; flight phases
    exist (monoped_gait_generator.cc:92-106)."""
    cyc = jnp.asarray(1.0)
    ts = jnp.linspace(0.0, 0.999, 199)
    c = np.asarray(gait.contact_state(
        jnp.full(ts.shape, 13, dtype=jnp.int32), ts, jnp.full(ts.shape, 1.0)))
    assert (c[:, 1:] == 0).all()          # masked slots never in stance
    # slot 0: both stance and flight occur
    assert 0.2 < c[:, 0].mean() < 0.95


def test_biped_run_has_flight():
    flag = jnp.asarray(9)
    cyc = jnp.asarray(1.0)
    ts = jnp.linspace(0.0, 0.999, 199)
    c = np.asarray(gait.contact_state(
        jnp.full(ts.shape, 9, dtype=jnp.int32), ts, jnp.full(ts.shape, 1.0)))
    airborne = (c.sum(axis=-1) == 0)
    assert airborne.any(), "run stride must contain flight phases"
