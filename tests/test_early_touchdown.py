"""Early touch-down swing exit (reference main.cpp:2027-2028, 3249-3264:
contact && t > dur - 0.05 -> flag_exit cuts the swing phase short).

Here the same semantics are per-leg DATA inside the scanned tracking loop
(runtime/loop.py): a swing foot with measured contact inside the last
early_td_window of its swing freezes its ref at the touch-down point and
is treated as stance by the WBC.  Tested on a rising ramp where swing
feet contact the ground before their splines end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apf_quadruped.config import EngineConfig, GaitConfig, SimConfig
from apf_quadruped.runtime import loop
from apf_quadruped.sim import disturbance, terrain

pytestmark = pytest.mark.slow  # f64 closed-loop scans (see pytest.ini tiering)

DT = jnp.float64
SIMC = SimConfig(terrain_res=128)


def _ramp_terrain(rise=0.04):
    """Ground rising `rise` meters between y=0.05 and y=0.45."""
    res, ext = SIMC.terrain_res, SIMC.terrain_extent
    xs = np.linspace(-ext / 2, ext / 2, res)
    _, Y = np.meshgrid(xs, xs, indexing="ij")
    h = np.clip((Y - 0.05) / 0.40, 0.0, 1.0) * rise
    return terrain.Terrain(mu_map=jnp.full((res, res), SIMC.mu_default, DT),
                           extent=ext, res=res, h_map=jnp.asarray(h, DT))


def _walk(early_td: bool, terr):
    cfg = EngineConfig(sim=SIMC, gait=GaitConfig(early_td=early_td))
    st = loop.init(cfg, dtype=DT)
    st2, m = loop.run(cfg, st, terr, jnp.asarray([0.0, 1.0], DT),
                      disturbance.empty(DT), n_cycles=4)
    return st2, jax.tree.map(np.asarray, m)


@pytest.fixture(scope="module")
def ramp_results():
    terr = _ramp_terrain()
    return {early: _walk(early, terr) for early in (True, False)}


def test_latch_engages_on_ramp(ramp_results):
    """Swing feet touching the rising ground early must latch td_flag."""
    _, m = ramp_results[True]
    assert (m.early_td_frac[1:] > 0).all(), m.early_td_frac


def test_disabled_never_latches(ramp_results):
    _, m = ramp_results[False]
    assert (m.early_td_frac == 0).all()


def test_no_post_contact_tracking_degradation(ramp_results):
    """Cutting the swing short must not hurt solver health or walking:
    the latched legs stop being driven along a ground-penetrating swing
    ref (the post-contact force-spike mechanism), so WBC convergence must
    be at least as good as with the feature off, and the walk healthy."""
    st_on, m_on = ramp_results[True]
    _, m_off = ramp_results[False]
    assert m_on.qp_converged.mean() >= m_off.qp_converged.mean() - 0.01
    assert m_on.qp_converged.mean() > 0.9
    assert float(st_on.sim.R_wb[2, 2]) > 0.98
    assert m_on.com[-1, 1] > 0.15            # still walks forward
    assert (m_on.tau_max <= 60.0 + 1e-6).all()


def test_flat_ground_unaffected():
    """On flat ground feet land essentially on schedule: the latch may
    fire in the final window but must not change the walk outcome."""
    terr = terrain.flat(SIMC, dtype=DT)
    st2, m = _walk(True, terr)
    assert m.qp_converged.mean() > 0.9
    assert m.com[-1, 1] > 0.15
    assert float(st2.sim.R_wb[2, 2]) > 0.98
