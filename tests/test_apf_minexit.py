"""MIN_EXIT compile-time variant of the APF layer (reference main.cpp:63,
1283-1288, 2811-2816): stronger repulsion (9x) + lateral escape channel
(2.2 * comb_rob) + lowered far-field attractive gains."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from apf_quadruped import apf
from apf_quadruped.config import ApfConfig

CFG = ApfConfig(min_exit=True)


def test_minexit_repulsive_gain_and_lateral_channel():
    rob = jnp.asarray([0.5, 0.2, 0.2, 0.5])     # BR/FR slippery-asymmetric
    st = apf.init_state()._replace(rob_foot=rob)
    feet = apf.foot_goals(jnp.zeros(2))
    out = apf.navigate(CFG, st, feet, jnp.zeros(2), jnp.zeros(2))
    vers = np.asarray(apf.repulsive_versors())
    comb = float(apf.combined_asymmetry(CFG, rob))
    assert comb > 0.0
    expected = (9.0 * np.asarray(rob)[:, None] * vers
                + 2.2 * comb * np.asarray([1.0, 0.0]))
    np.testing.assert_allclose(np.asarray(out.f_rep), expected, atol=1e-6)


def test_minexit_far_field_gains():
    """|e| >= 0.4: K_pa drops to (0.1, 0.2) under MIN_EXIT
    (main.cpp:2814, 2832)."""
    st = apf.init_state()._replace(rob_foot=jnp.full((4,), 0.5))
    feet = apf.foot_goals(jnp.zeros(2)) + jnp.asarray([1.0, -1.0])
    out = apf.navigate(CFG, st, feet, jnp.zeros(2), jnp.zeros(2))
    np.testing.assert_allclose(out.f_att[..., 0], -0.1 * 1.0, atol=1e-7)
    np.testing.assert_allclose(out.f_att[..., 1], 0.2 * 1.0, atol=1e-7)


def test_minexit_near_field_matches_default():
    st = apf.init_state()._replace(rob_foot=jnp.full((4,), 0.5))
    feet = apf.foot_goals(jnp.zeros(2)) + jnp.asarray([0.1, -0.1])
    out = apf.navigate(CFG, st, feet, jnp.zeros(2), jnp.zeros(2))
    np.testing.assert_allclose(out.f_att[..., 0], -0.3 * 0.1, atol=1e-7)
    np.testing.assert_allclose(out.f_att[..., 1], 0.4 * 0.1, atol=1e-7)
