"""APF navigation layer tests: field math, robustness index, gait adaptation.

Golden values derived from the reference formulas (main.cpp:1171-1422,
1515-1565, 2745-2845) — see each test for the file:line it checks against.
"""

import jax.numpy as jnp
import numpy as np

from apf_quadruped import apf
from apf_quadruped.config import ApfConfig

CFG = ApfConfig()


def test_cone_margin_vertical_force():
    """Pure vertical force: alpha=0 -> margin = atan(0.5)."""
    f = jnp.array([[[0.0, 0.0, 100.0]] * 4])
    m = apf.cone_margin(f)
    np.testing.assert_allclose(m, np.arctan(0.5), atol=1e-7)


def test_cone_margin_at_cone_edge():
    """Tangential/normal = 0.5 (the mu in theta = atan 0.5) -> margin 0."""
    f = jnp.array([[50.0, 0.0, 100.0]]).repeat(4, 0)
    m = apf.cone_margin(f)
    np.testing.assert_allclose(m, 0.0, atol=1e-7)


def test_cone_margin_zero_force_no_nan():
    m = apf.cone_margin(jnp.zeros((4, 3)))
    assert np.all(np.isfinite(np.asarray(m)))
    np.testing.assert_allclose(m, 0.0)


def test_robustness_ewma():
    """rob' = 0.35 rob + 0.65 h_int/period (main.cpp:1273-1276), then
    integrator reset (main.cpp:1445-1453)."""
    st = apf.ApfState(rob_foot=jnp.full((4,), 0.2),
                      h_int=jnp.full((4,), 0.15),
                      period_st=jnp.asarray(0.5))
    st2 = apf.update_robustness(CFG, st)
    np.testing.assert_allclose(st2.rob_foot, 0.35 * 0.2 + 0.65 * 0.3,
                               atol=1e-7)
    np.testing.assert_allclose(st2.h_int, 0.0)
    np.testing.assert_allclose(st2.period_st, 0.0)


def test_margin_accumulation_gate():
    """Margins below the 0.01 floor are NOT integrated (main.cpp:1539)."""
    st = apf.init_state()
    # foot 0 at cone edge (margin 0), others vertical (margin atan .5)
    f = jnp.array([[50.0, 0.0, 100.0],
                   [0.0, 0.0, 100.0],
                   [0.0, 0.0, 100.0],
                   [0.0, 0.0, 100.0]])
    st2 = apf.accumulate_margin(CFG, st, f, jnp.asarray(0.0025))
    assert float(st2.h_int[0]) == float(st.h_int[0])
    np.testing.assert_allclose(
        np.asarray(st2.h_int[1:]),
        np.asarray(st.h_int[1:]) + 0.0025 * np.arctan(0.5), atol=1e-9)
    np.testing.assert_allclose(float(st2.period_st), 0.0125, atol=1e-9)


def test_combined_asymmetry_deadband():
    """compute_fr: |v| < 0.07 -> 0 (main.cpp:2745-2754)."""
    rob = jnp.array([0.30, 0.25, 0.25, 0.30])  # (BR, BL, FL, FR)
    c = apf.combined_asymmetry(CFG, rob)
    # br-bl = .05 (deadbanded), fr-fl = .05 (deadbanded),
    # |br-fr| = 0, |bl-fl| = 0 -> total 0
    np.testing.assert_allclose(c, 0.0, atol=1e-9)
    rob = jnp.array([0.40, 0.25, 0.25, 0.40])
    c = apf.combined_asymmetry(CFG, rob)
    np.testing.assert_allclose(c, 0.15 + 0.15, atol=1e-7)


def test_attractive_field_direction_and_gain():
    """f_a = -K_pa e_a pulls feet toward goals; near gains (0.3, 0.4)
    (compute_Kpa main.cpp:2803-2845)."""
    st = apf.init_state()
    st = st._replace(rob_foot=jnp.full((4,), 0.5))      # healthy -> trot
    feet = apf.foot_goals(jnp.zeros(2)) + jnp.asarray([0.1, -0.2])
    out = apf.navigate(CFG, st, feet, jnp.zeros(2), jnp.zeros(2))
    assert not bool(out.fake_crawl)
    np.testing.assert_allclose(out.f_att[..., 0], -0.3 * 0.1, atol=1e-7)
    np.testing.assert_allclose(out.f_att[..., 1], -0.4 * (-0.2), atol=1e-7)
    # step = foot + 0.5 f_a (main.cpp:1396-1407)
    np.testing.assert_allclose(out.step_targets,
                               np.asarray(feet) + 0.5 * np.asarray(out.f_att),
                               atol=1e-7)


def test_error_saturation():
    """|e| saturates at 2 m per component (saturate_x/y, main.cpp:2756-2800)."""
    st = apf.init_state()._replace(rob_foot=jnp.full((4,), 0.5))
    feet = apf.foot_goals(jnp.zeros(2)) + jnp.asarray([5.0, -7.0])
    out = apf.navigate(CFG, st, feet, jnp.zeros(2), jnp.zeros(2))
    np.testing.assert_allclose(out.f_att[..., 0], -0.3 * 2.0, atol=1e-7)
    np.testing.assert_allclose(out.f_att[..., 1], 0.4 * 2.0, atol=1e-7)


def test_fake_crawl_threshold_and_gain_drop():
    """mean rob < 0.34 -> fake_crawl, K_pa -> 0.01 (main.cpp:1320, 2803)."""
    st = apf.init_state()._replace(rob_foot=jnp.full((4,), 0.2))
    feet = apf.foot_goals(jnp.zeros(2)) + jnp.asarray([0.1, 0.1])
    out = apf.navigate(CFG, st, feet, jnp.zeros(2), jnp.zeros(2))
    assert bool(out.fake_crawl)
    np.testing.assert_allclose(out.f_att, -0.01 * 0.1, atol=1e-7)


def test_repulsive_field_outward():
    """f_r = 5 rob versor pushes outward (main.cpp:1292-1295)."""
    st = apf.init_state()._replace(rob_foot=jnp.full((4,), 0.4))
    feet = apf.foot_goals(jnp.zeros(2))
    out = apf.navigate(CFG, st, feet, jnp.zeros(2), jnp.zeros(2))
    vers = np.asarray(apf.repulsive_versors())
    np.testing.assert_allclose(out.f_rep, 5.0 * 0.4 * vers, atol=1e-6)
    # REP_FIELD=0 (main.cpp:62): repulsive field NOT folded into steps
    np.testing.assert_allclose(out.step_targets, np.asarray(feet), atol=1e-6)


def test_com_step_saturation():
    """com_des clamps to +-0.06 m of current CoM (saturate_xstep,
    main.cpp:2767-2789)."""
    st = apf.init_state()._replace(rob_foot=jnp.full((4,), 0.5))
    feet = apf.foot_goals(jnp.asarray([3.0, 0.0]))       # feet at x ~ 3
    out = apf.navigate(CFG, st, feet, jnp.zeros(2), jnp.asarray([10.0, 0.0]))
    assert abs(float(out.com_des[0])) <= 0.06 + 1e-9
    assert abs(float(out.com_des[1])) <= 0.06 + 1e-9


def test_batched_shapes():
    B = 7
    st = apf.init_state((B,))
    feet = jnp.tile(apf.foot_goals(jnp.zeros(2)), (B, 1, 1))
    out = apf.navigate(CFG, st, feet, jnp.zeros((B, 2)), jnp.ones((B, 2)))
    assert out.step_targets.shape == (B, 4, 2)
    assert out.fake_crawl.shape == (B,)


def test_range_of_motion_clamp():
    """With a RobotConfig, step targets are clamped to the kinematic box
    nominal_stance +- max_dev around the CoM goal (towr
    range_of_motion_constraint.cc:60-84, max_dev dogbot_model.h:80) —
    an adversarial 5 m target must not command unreachable footholds."""
    from apf_quadruped.config import RobotConfig
    from apf_quadruped.models.dogbot import LEG_SIGNS

    robot = RobotConfig()
    st = apf.init_state()._replace(rob_foot=jnp.full((4,), 0.5))
    feet = apf.foot_goals(jnp.zeros(2))
    out = apf.navigate(CFG, st, feet, jnp.zeros(2), jnp.asarray([5.0, 5.0]),
                       robot=robot)
    off = np.asarray(LEG_SIGNS) * np.asarray([robot.stance_x, robot.stance_y])
    nominal = np.asarray(out.com_des)[None, :] + off
    dev = np.asarray(robot.max_dev[:2])
    viol = np.abs(np.asarray(out.step_targets) - nominal) - dev
    assert viol.max() <= 1e-6, f"foothold outside RoM box by {viol.max()}"
    # and without the robot arg the same targets are NOT clamped
    out_raw = apf.navigate(CFG, st, feet, jnp.zeros(2),
                           jnp.asarray([5.0, 5.0]))
    raw_viol = np.abs(np.asarray(out_raw.step_targets) - nominal) - dev
    assert raw_viol.max() > 0.1
